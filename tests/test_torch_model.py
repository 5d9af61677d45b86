"""The port's GQA decoder (reduced internlm2-1.8b) against the JAX model,
with the JAX-initialised weights carried over through
``repro_torch.bridge``.  f32: logits within 1e-4 (different reduction
order across frameworks) and greedy tokens EQUAL for 16 decode steps,
dense and paged.  bf16 is held to a tolerance only."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget
from repro_torch.models import transformer as TT
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def configs(dtype="float32"):
    return (dc.replace(get_reduced("internlm2-1.8b"), dtype=dtype),
            dc.replace(tget("internlm2-1.8b"), dtype=dtype))


@pytest.fixture(scope="module")
def f32_pair():
    cfg, tcfg = configs()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def prompts(vocab, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def test_configs_match_the_jax_package():
    """All ten architectures, each equal to JAX's field for field and in
    ``n_params``, full and reduced; an unknown name raises."""
    from repro.configs import CANONICAL, get_config
    from repro_torch.configs import CANONICAL as TCANONICAL

    assert sorted(TCANONICAL) == sorted(CANONICAL) and len(CANONICAL) == 10
    for arch in CANONICAL:
        assert dc.asdict(tget_config(arch)) == dc.asdict(get_config(arch))
        assert tget_config(arch).n_params() == get_config(arch).n_params()
        assert dc.asdict(tget(arch)) == dc.asdict(get_reduced(arch))
    with pytest.raises(ValueError, match="unknown arch"):
        tget("gpt-2")


def test_forward_logits_within_1e4_of_jax(f32_pair):
    cfg, tcfg, params, tparams = f32_pair
    toks = prompts(cfg.vocab_size)
    jl, _, _ = JT.forward(cfg, params, jnp.asarray(toks))
    tl, _ = TT.forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("prompt_len", [None, 7])
def test_filled_cache_matches_jax(f32_pair, prompt_len):
    """The prefill cache fill, including the bucket-padding scrub."""
    cfg, tcfg, params, tparams = f32_pair
    toks = prompts(cfg.vocab_size, B=1)
    _, jc, _ = JT.forward(cfg, params, jnp.asarray(toks), fill_cache=True,
                          prompt_len=prompt_len)
    _, tc = TT.forward(tcfg, tparams, torch.from_numpy(toks), fill_cache=True,
                       prompt_len=prompt_len)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc["segments"][0][key].numpy(),
                                   np.asarray(jc["segments"][0][key]), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tc["segments"][0]["slot_pos"].numpy(),
                                  np.asarray(jc["segments"][0]["slot_pos"]))


def greedy_jax(cfg, params, toks, steps, paged):
    B, S = toks.shape
    max_len = 32
    _, filled, _ = JT.forward(cfg, params, jnp.asarray(toks), fill_cache=True)
    from repro.models.lm_cells import install_prefill

    cache = install_prefill(cfg, JT.init_cache(cfg, B, max_len), filled, S)
    pages = None
    if paged:
        from repro.serving.paging import dense_to_pool

        ps, P = 8, max_len // 8
        pool = JT.init_paged_cache(cfg, B, B * P, ps)
        pages = jnp.asarray(np.random.default_rng(1).permutation(B * P).reshape(B, P)
                            .astype(np.int32))
        segs = []
        for dseg, pseg in zip(cache["segments"], pool["segments"]):
            seg = {}
            for k in ("k", "v"):
                p = pseg[k]
                for b in range(B):
                    p = dense_to_pool(p, dseg[k][:, b:b + 1], pages[b])
                seg[k] = p
            segs.append(seg)
        cache = {"segments": segs, "pos": cache["pos"]}
    logits, _, _ = JT.forward(cfg, params, jnp.asarray(toks))
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    step = jax.jit(lambda p, c, t, pg: JT.decode_step(cfg, p, c, t, pages=pg))
    out = []
    for _ in range(steps):
        out.append(np.asarray(tok)[:, 0])
        logits, cache = step(params, cache, tok, pages)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.stack(out, 1), pages, cache


def greedy_torch(tcfg, tparams, toks, steps, pages):
    from repro_torch.models.lm_cells import install_prefill
    from repro_torch.serving.paging import dense_to_pool

    B, S = toks.shape
    max_len = 32
    t = torch.from_numpy(toks)
    logits, filled = TT.forward(tcfg, tparams, t, fill_cache=True)
    cache = install_prefill(tcfg, TT.init_cache(tcfg, B, max_len, "cpu"), filled, S)
    tpages = None
    if pages is not None:
        pages = np.array(pages)
        ps, P = 8, max_len // 8
        pool = TT.init_paged_cache(tcfg, B, B * P, ps, "cpu")
        segs = []
        for dseg, pseg in zip(cache["segments"], pool["segments"]):
            seg = {}
            for k in ("k", "v"):
                p = pseg[k]
                for b in range(B):
                    p = dense_to_pool(p, dseg[k][:, b:b + 1], pages[b])
                seg[k] = p
            segs.append(seg)
        cache = {"segments": segs, "pos": cache["pos"]}
        tpages = torch.from_numpy(pages)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    out = []
    for _ in range(steps):
        out.append(tok[:, 0].numpy())
        prev = cache
        logits, cache = TT.decode_step(tcfg, tparams, cache, tok, pages=tpages)
        assert cache["segments"][0]["k"] is not prev["segments"][0]["k"]  # out of place
        tok = torch.argmax(logits, -1).to(torch.int32)
    return np.stack(out, 1), cache


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_16_greedy_steps_equal_jax_tokens(f32_pair, paged):
    cfg, tcfg, params, tparams = f32_pair
    toks = prompts(cfg.vocab_size, B=2, S=9, seed=3)
    jtok, pages, jcache = greedy_jax(cfg, params, toks, 16, paged)
    ttok, tcache = greedy_torch(tcfg, tparams, toks, 16, pages)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    np.testing.assert_allclose(tcache["segments"][0]["k"].numpy(),
                               np.asarray(jcache["segments"][0]["k"]), atol=1e-4, rtol=1e-4)


def test_bf16_forward_within_tolerance_and_bits_cross_the_bridge():
    cfg, tcfg = configs("bfloat16")
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, params)
    tparams = bridge.params_from_numpy(tcfg, np_params, device="cpu")
    back = bridge.tree_to_numpy(tparams)
    np.testing.assert_array_equal(back["embed"], np_params["embed"].view(np.uint16))
    toks = prompts(cfg.vocab_size, B=1, S=8)
    jl, _, _ = JT.forward(cfg, params, jnp.asarray(toks))
    tl, _ = TT.forward(tcfg, tparams, torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16
    # bf16 rounds at different places in the two frameworks (T4): hold
    # the logits to a few bf16 ulps of their O(1) scale
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl).astype(np.float32),
                               atol=6e-2, rtol=6e-2)


def test_init_params_layout_matches_jax():
    """Generator-made weights have the JAX tree's keys, shapes, dtypes."""
    cfg, tcfg = configs("bfloat16")
    jp = jax.eval_shape(lambda k: JT.init_params(cfg, k), jax.random.PRNGKey(0))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jflat, jdef = jax.tree.flatten(jp)
    from repro_torch.tree import tree_leaves

    tflat = tree_leaves(tp)
    assert len(jflat) == len(tflat)
    for a, b in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.bfloat16
