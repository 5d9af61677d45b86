"""The port's MLA decoder (deepseek-v3-671b's dense prefix, reduced, two
layers) against the JAX model, with the JAX-initialised weights carried
over through ``repro_torch.bridge``.  f32: logits within 1e-4 (different
reduction order across frameworks), the filled latent cache equal to
JAX's within 1e-4 (slot positions exactly), and greedy tokens EQUAL for
16 decode steps, dense and paged (the paged decode runs K6's plain
version here, JAX's K6 in interpret mode)."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_reduced
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import deepseek_v3_671b as tds
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget
from repro_torch.kernels import paged_decode as pd
from repro_torch.models import transformer as TT
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCH = "deepseek-v3-671b"
MAX_LEN, PS = 32, 8


def configs(dtype="float32"):
    """The reduced dense prefix in both packages: 2 MLA layers with a dense
    MLP (the reduced config keeps 1 dense layer; 2 exercise the stacking)."""
    cut = dict(n_layers=2, mixer_type="mlp", moe=None, dtype=dtype)
    return (dc.replace(get_reduced(ARCH), **cut),
            dc.replace(tds.dense_prefix(tget(ARCH)), n_layers=2, dtype=dtype))


@pytest.fixture(scope="module")
def f32_pair():
    cfg, tcfg = configs()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return cfg, tcfg, params, tparams


def prompts(vocab, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def test_dense_prefix_is_the_three_dense_layers_at_full_width():
    full = tds.dense_prefix(tget_config(ARCH))
    jfull = dc.replace(get_config(ARCH), n_layers=3, mixer_type="mlp", moe=None)
    assert dc.asdict(full) == dc.asdict(jfull)
    assert TT.segment_plan(full) == [TT.Segment("attn_mlp", 3)]
    assert full.n_params() == jfull.n_params()
    assert round(full.n_params() / 1e9, 3) == 3.604
    mtp = 2 * full.d_model * full.d_model + full.d_model
    assert round((full.n_params() + mtp) / 1e9, 3) == 3.707
    # the MoE layers are ported now: the full plan, and the served cut of
    # the 3 dense layers and the first MoE layer
    assert TT.segment_plan(tget_config(ARCH)) == [TT.Segment("attn_mlp", 3),
                                                  TT.Segment("attn_moe", 58)]
    assert round(tds.moe_prefix(tget_config(ARCH), 1).n_params() / 1e9, 3) == 15.111


def test_init_params_layout_matches_jax_with_the_mtp_head():
    cfg, tcfg = configs("bfloat16")
    jp = jax.eval_shape(lambda k: JT.init_params(cfg, k), jax.random.PRNGKey(0))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {"mtp_proj", "mtp_norm", "lm_head"} <= set(tp)
    from repro_torch.tree import tree_leaves, tree_paths

    jflat, _ = jax.tree.flatten_with_path(jp)
    assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path) for path, _ in jflat] \
        == [tuple(p) for p in tree_paths(tp)]
    for (_, a), b in zip(jflat, tree_leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.bfloat16


def test_forward_logits_within_1e4_of_jax(f32_pair):
    cfg, tcfg, params, tparams = f32_pair
    toks = prompts(cfg.vocab_size)
    jl, _, _ = JT.forward(cfg, params, jnp.asarray(toks))
    tl, _ = TT.forward(tcfg, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("prompt_len", [None, 7])
def test_filled_latent_cache_matches_jax(f32_pair, prompt_len):
    """The prefill's latent cache fill, including the bucket-padding scrub."""
    cfg, tcfg, params, tparams = f32_pair
    toks = prompts(cfg.vocab_size, B=1)
    _, jc, _ = JT.forward(cfg, params, jnp.asarray(toks), fill_cache=True,
                          prompt_len=prompt_len)
    _, tc = TT.forward(tcfg, tparams, torch.from_numpy(toks), fill_cache=True,
                       prompt_len=prompt_len)
    assert sorted(tc["segments"][0]) == ["ckv", "krope", "slot_pos"]
    for key in ("ckv", "krope"):
        np.testing.assert_allclose(tc["segments"][0][key].numpy(),
                                   np.asarray(jc["segments"][0][key]), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tc["segments"][0]["slot_pos"].numpy(),
                                  np.asarray(jc["segments"][0]["slot_pos"]))


def _pooled(init_paged, dense_to_pool, cache, pages, B):
    """The dense caches of ``B`` slots installed into page pools."""
    pool = init_paged
    segs = []
    for dseg, pseg in zip(cache["segments"], pool["segments"]):
        seg = {}
        for k in ("ckv", "krope"):
            p = pseg[k]
            for b in range(B):
                p = dense_to_pool(p, dseg[k][:, b:b + 1], pages[b])
            seg[k] = p
        segs.append(seg)
    return {"segments": segs, "pos": cache["pos"]}


def greedy_jax(cfg, params, toks, steps, paged):
    from repro.models.lm_cells import install_prefill
    from repro.serving.paging import dense_to_pool

    B, S = toks.shape
    _, filled, _ = JT.forward(cfg, params, jnp.asarray(toks), fill_cache=True)
    cache = install_prefill(cfg, JT.init_cache(cfg, B, MAX_LEN), filled, S)
    pages = None
    if paged:
        P = MAX_LEN // PS
        pages = jnp.asarray(np.random.default_rng(1).permutation(B * P).reshape(B, P)
                            .astype(np.int32))
        cache = _pooled(JT.init_paged_cache(cfg, B, B * P, PS), dense_to_pool, cache, pages, B)
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
    logits, filled = TT.forward(tcfg, tparams, torch.from_numpy(toks), fill_cache=True)
    cache = install_prefill(tcfg, TT.init_cache(tcfg, B, MAX_LEN, "cpu"), filled, S)
    tpages = None
    if pages is not None:
        pages = np.array(pages)
        P = MAX_LEN // PS
        cache = _pooled(TT.init_paged_cache(tcfg, B, B * P, PS, "cpu"), dense_to_pool, cache,
                        pages, B)
        tpages = torch.from_numpy(pages)
    tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    out = []
    for _ in range(steps):
        out.append(tok[:, 0].numpy())
        prev = cache
        logits, cache = TT.decode_step(tcfg, tparams, cache, tok, pages=tpages)
        assert cache["segments"][0]["ckv"] is not prev["segments"][0]["ckv"]  # out of place
        tok = torch.argmax(logits, -1).to(torch.int32)
    return np.stack(out, 1), cache


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_16_greedy_steps_equal_jax_tokens(f32_pair, paged):
    cfg, tcfg, params, tparams = f32_pair
    toks = prompts(cfg.vocab_size, B=2, S=9, seed=3)
    pd.paged_mla_attention.launches = 0
    jtok, pages, jcache = greedy_jax(cfg, params, toks, 16, paged)
    ttok, tcache = greedy_torch(tcfg, tparams, toks, 16, pages)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    np.testing.assert_allclose(tcache["segments"][0]["ckv"].numpy(),
                               np.asarray(jcache["segments"][0]["ckv"]), atol=1e-4, rtol=1e-4)
    assert pd.paged_mla_attention.launches == 0  # CPU tensors: the plain version ran


def test_paged_decode_step_equals_dense_bitwise(f32_pair):
    """Within the port a paged MLA decode step gives the dense step's
    logits bit for bit: both reduce through ``attend_mla``."""
    cfg, tcfg, params, tparams = f32_pair
    toks = prompts(cfg.vocab_size, B=2, S=9, seed=5)
    pages = np.random.default_rng(2).permutation(2 * MAX_LEN // PS).reshape(2, -1).astype(np.int32)
    dense_tok, dense_cache = greedy_torch(tcfg, tparams, toks, 6, None)
    paged_tok, paged_cache = greedy_torch(tcfg, tparams, toks, 6, pages)
    np.testing.assert_array_equal(paged_tok, dense_tok)
    from repro_torch.serving.paging import pool_slot_view

    view = pool_slot_view(paged_cache["segments"][0]["ckv"], torch.from_numpy(pages))
    assert torch.equal(view, dense_cache["segments"][0]["ckv"])


def test_bf16_forward_within_tolerance_and_bits_cross_the_bridge():
    cfg, tcfg = configs("bfloat16")
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, params)
    tparams = bridge.params_from_numpy(tcfg, np_params, device="cpu")
    back = bridge.tree_to_numpy(tparams)
    np.testing.assert_array_equal(back["mtp_proj"], np_params["mtp_proj"].view(np.uint16))
    toks = prompts(cfg.vocab_size, B=1, S=8)
    jl, _, _ = JT.forward(cfg, params, jnp.asarray(toks))
    tl, _ = TT.forward(tcfg, tparams, torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16
    # bf16 rounds at different places in the two frameworks: hold the
    # logits to a few bf16 ulps of their O(1) scale
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl).astype(np.float32),
                               atol=6e-2, rtol=6e-2)


def test_bridge_refuses_a_tree_without_the_mtp_head(f32_pair):
    cfg, tcfg, params, _ = f32_pair
    tree = {k: v for k, v in jax.tree.map(np.asarray, params).items() if k != "mtp_proj"}
    with pytest.raises(ValueError, match="params keys"):
        bridge.params_from_numpy(tcfg, tree, device="cpu")
