"""Five more decoders against the JAX package, reduced and in f32, on
JAX-initialised weights carried over through ``repro_torch.bridge``:
granite-20b (MQA, biases, GELU),
command-r-plus-104b (tied embeddings), zamba2-2.7b (Mamba2 layers and a
weight-shared attention block over concat(h, e0)), granite-moe-1b-a400m
(softmax top-k MoE) and deepseek-v3-671b with its MoE layers (sigmoid
top-k, a shared expert, MLA).

For all five: the configs, ``n_params`` and the segment plan equal
JAX's, and the ``init_params`` tree has JAX's paths, shapes and dtypes.
For the three GQA decoders here (zamba2 and deepseek in
``tests/test_torch_archs_zamba_deepseek.py``, through the same checks):
forward logits within 1e-4 (different reduction orders) and the filled
cache too (slot positions exactly); 16 greedy decode steps give JAX's
tokens, dense and, where the arch can page, paged.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_reduced
from repro.models import transformer as JT
from repro.models.lm_cells import install_prefill as jinstall
from repro.serving.paging import dense_to_pool as jdense_to_pool
from repro_torch import bridge
from repro_torch.configs import command_r_plus_104b as tcr
from repro_torch.configs import deepseek_v3_671b as tds
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget
from repro_torch.models import transformer as TT
from repro_torch.models.lm_cells import install_prefill as tinstall
from repro_torch.models.lm_cells import paged_serving_supported
from repro_torch.serving.paging import dense_to_pool as tdense_to_pool
from repro_torch.tree import tree_leaves, tree_paths
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCHS = ["granite-20b", "command-r-plus-104b", "zamba2-2.7b", "granite-moe-1b-a400m",
         "deepseek-v3-671b"]
HERE = ["granite-20b", "command-r-plus-104b", "granite-moe-1b-a400m"]
B, S, MAX_LEN, PS, STEPS = 2, 9, 32, 8, 16
TOL = dict(atol=1e-4, rtol=1e-4)


def configs(arch, dtype="float32"):
    return dc.replace(get_reduced(arch), dtype=dtype), dc.replace(tget(arch), dtype=dtype)


def make_runs():
    """Per arch, once: the JAX weights, bridged; the prompt; both
    packages' prefill (logits and the filled cache)."""
    memo = {}

    def get(arch):
        if arch not in memo:
            cfg, tcfg = configs(arch)
            params = JT.init_params(cfg, jax.random.PRNGKey(0))
            tparams = bridge.params_from_numpy(tcfg, jax.tree.map(np.asarray, params), device="cpu")
            toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            jfwd = jax.jit(lambda p, t: JT.forward(cfg, p, t, fill_cache=True)[:2])
            jl, jc = jfwd(params, jnp.asarray(toks))
            tl, tc = TT.forward(tcfg, tparams, torch.from_numpy(toks), fill_cache=True)
            memo[arch] = dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams, toks=toks,
                              jax=(jl, jc), torch=(tl, tc))
        return memo[arch]

    return get


@pytest.fixture(scope="module")
def runs():
    return make_runs()


def close(t, j):
    t, j = t.detach().numpy(), np.asarray(j)
    if np.issubdtype(j.dtype, np.integer):
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, **TOL)


def plan(segs):
    return [(s.kind, s.count, s.sub) for s in segs]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_n_params_and_segment_plan_match_jax(arch):
    assert dc.asdict(tget_config(arch)) == dc.asdict(get_config(arch))
    assert dc.asdict(tget(arch)) == dc.asdict(get_reduced(arch))
    for get_t, get_j in ((tget_config, get_config), (tget, get_reduced)):
        assert get_t(arch).n_params() == get_j(arch).n_params()
        assert plan(TT.segment_plan(get_t(arch))) == plan(JT.segment_plan(get_j(arch)))


def test_the_served_cuts_at_full_width():
    """The cuts the card serves: command-r's first 8 layers, deepseek's
    3 dense layers and its first MoE layer (the MTP head kept)."""
    cr = tcr.layer_prefix(tget_config("command-r-plus-104b"), 8)
    assert (cr.n_layers, cr.d_model, cr.vocab_size, cr.tie_embeddings) == (8, 12288, 256000, True)
    assert round(cr.n_params() / 1e9, 2) == 15.73
    ds = tds.moe_prefix(tget_config("deepseek-v3-671b"), 1)
    assert plan(TT.segment_plan(ds)) == [("attn_mlp", 3, 1), ("attn_moe", 1, 1)]
    assert ds.mtp and ds.moe == tget_config("deepseek-v3-671b").moe
    assert round(ds.n_params() / 1e9, 3) == 15.111
    assert round((ds.n_params() + 2 * 7168**2 + 7168) / 1e9, 2) == 15.21
    assert round(tget_config("granite-20b").n_params() / 1e9, 2) == 20.01
    assert round(tget_config("zamba2-2.7b").n_params() / 1e9, 2) == 2.46
    assert round(tget_config("granite-moe-1b-a400m").n_params() / 1e9, 2) == 1.33
    for bad in (0, 65):
        with pytest.raises(ValueError, match="layer_prefix"):
            tcr.layer_prefix(tget_config("command-r-plus-104b"), bad)
    with pytest.raises(ValueError, match="moe_prefix"):
        tds.moe_prefix(tget_config("deepseek-v3-671b"), 59)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """Paths, shapes and dtypes of generator-made bf16 weights (the MoE
    router and the mamba decay, step bias and skip stay f32)."""
    cfg, tcfg = configs(arch, "bfloat16")
    jp = jax.eval_shape(lambda k: JT.init_params(cfg, k), jax.random.PRNGKey(0))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jflat, _ = jax.tree.flatten_with_path(jp)
    assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jflat] == [tuple(p) for p in tree_paths(tp)]
    for (_, a), b in zip(jflat, tree_leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")


def check_forward_and_filled_cache(r):
    """Logits, and every leaf of the prefill's cache fill: KV or latent
    lanes, slot positions, and for zamba2 each unit's mamba states beside
    its attention cache."""
    close(r["torch"][0], r["jax"][0])
    jc, tc = r["jax"][1], r["torch"][1]
    jflat, _ = jax.tree.flatten_with_path(jc)
    assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jflat] == [tuple(p) for p in tree_paths(tc)]
    for (_, j), t in zip(jflat, tree_leaves(tc)):
        close(t, j)


def pooled(cache, pool, pages, dense_to_pool):
    """Dense caches of ``B`` slots installed into page pools."""
    segs = []
    for dseg, pseg in zip(cache["segments"], pool["segments"]):
        seg = {}
        for k, p in pseg.items():
            for b in range(B):
                p = dense_to_pool(p, dseg[k][:, b:b + 1], pages[b])
            seg[k] = p
        segs.append(seg)
    return {"segments": segs, "pos": cache["pos"]}


def greedy_jax(r, pages):
    cfg, params = r["cfg"], r["params"]
    jl, jc = r["jax"]
    cache = jinstall(cfg, JT.init_cache(cfg, B, MAX_LEN), jc, S)
    if pages is not None:
        cache = pooled(cache, JT.init_paged_cache(cfg, B, B * MAX_LEN // PS, PS),
                       jnp.asarray(pages), jdense_to_pool)
        pages = jnp.asarray(pages)
    tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    step = jax.jit(lambda p, c, t, pg: JT.decode_step(cfg, p, c, t, pages=pg))
    out = []
    for _ in range(STEPS):
        out.append(np.asarray(tok)[:, 0])
        logits, cache = step(params, cache, tok, pages)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.stack(out, 1), cache


def greedy_torch(r, pages):
    tcfg, tparams = r["tcfg"], r["tparams"]
    tl, tc = r["torch"]
    cache = tinstall(tcfg, TT.init_cache(tcfg, B, MAX_LEN, "cpu"), tc, S)
    if pages is not None:
        cache = pooled(cache, TT.init_paged_cache(tcfg, B, B * MAX_LEN // PS, PS, "cpu"), pages,
                       tdense_to_pool)
        pages = torch.from_numpy(pages)
    tok = torch.argmax(tl[:, -1:], -1).to(torch.int32)
    out = []
    for _ in range(STEPS):
        out.append(tok[:, 0].numpy())
        before = tree_leaves(cache)
        copies = [x.clone() for x in before]
        logits, cache = TT.decode_step(tcfg, tparams, cache, tok, pages=pages)
        assert all(torch.equal(x, c) for x, c in zip(before, copies))  # out of place
        tok = torch.argmax(logits, -1).to(torch.int32)
    return np.stack(out, 1), cache


def check_greedy(r, paged):
    """16 greedy steps from the prefill: tokens equal JAX's, the caches
    within 1e-4 (positions exactly); the paged run through a shuffled
    page table."""
    assert paged_serving_supported(r["tcfg"]) or not paged
    pages = None
    if paged:
        pages = np.random.default_rng(1).permutation(B * MAX_LEN // PS).reshape(B, -1)
        pages = pages.astype(np.int32)
    jtok, jcache = greedy_jax(r, pages)
    ttok, tcache = greedy_torch(r, pages)
    np.testing.assert_array_equal(ttok, jtok)
    jflat = jax.tree.leaves(jcache)
    assert len(jflat) == len(tree_leaves(tcache))
    for t, j in zip(tree_leaves(tcache), jflat):
        close(t, j)


@pytest.mark.parametrize("arch", HERE)
def test_forward_logits_and_filled_cache_within_1e4_of_jax(runs, arch):
    check_forward_and_filled_cache(runs(arch))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", HERE)
def test_decode_16_greedy_steps_equal_jax_tokens(runs, arch, paged):
    check_greedy(runs(arch), paged)


def test_bridge_keeps_the_f32_router_bits_and_expects_shared_attn():
    """A bf16 config: the router crosses the bridge as JAX's f32 bits (a
    bf16 router would route differently); the experts as bf16 bits.  The
    key check wants zamba2's ``shared_attn``."""
    cfg, tcfg = configs("granite-moe-1b-a400m", "bfloat16")
    params = JT.init_params(cfg, jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, params)
    tparams = bridge.params_from_numpy(tcfg, np_params, device="cpu")
    moe, jmoe = tparams["segments"][0]["moe"], np_params["segments"][0]["moe"]
    assert moe["router"].dtype == torch.float32 and jmoe["router"].dtype == np.float32
    np.testing.assert_array_equal(moe["router"].numpy().view(np.uint32),
                                  jmoe["router"].view(np.uint32))
    np.testing.assert_array_equal(bridge.tree_to_numpy(moe)["w1"], jmoe["w1"].view(np.uint16))
    zcfg, ztcfg = configs("zamba2-2.7b", "bfloat16")
    zp = jax.tree.map(np.asarray, JT.init_params(zcfg, jax.random.PRNGKey(2)))
    assert "shared_attn" in bridge.params_from_numpy(ztcfg, zp, device="cpu")
    del zp["shared_attn"]
    with pytest.raises(ValueError, match="shared_attn"):
        bridge.params_from_numpy(ztcfg, zp, device="cpu")
