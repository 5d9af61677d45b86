"""musicgen-large, the multi-codebook decoder, against the JAX package:
reduced (3 layers, 2 codebooks of 64) and in f32, on JAX-initialised
weights carried over through ``repro_torch.bridge``.

  * the parameter tree (``embed`` (K, V, d), untied ``lm_head`` (K, d, V))
    has JAX's paths, shapes and dtypes, and the bridge checks both;
  * ``embed_tokens`` (the K codebooks' rows summed) and ``unembed``
    ((B, S, K, V) logits) within 1e-4 of JAX's, the forward and its
    filled cache too;
  * 16 greedy decode steps of (B, 1, K) tokens give JAX's, dense and
    through a shuffled page table;
  * the served none/DMR/TMR stream of (P, K) prompts, dense and paged,
    gives JAX's tokens and FaultLedger with a strike into a replica
    slot's (B, 1, K) ``tokens`` leaf, and the paged stream equals the
    dense one; asked to speculate, it decodes plainly as JAX does.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jmiso
from repro.configs import get_config, get_reduced
from repro.models import transformer as JT
from repro.models.lm_cells import ServeConfig as JServeConfig
from repro.models.lm_cells import install_prefill as jinstall
from repro.serving import DONE
from repro.serving import Request as JRequest
from repro.serving.lm import lm_engine_parts as jax_parts
from repro.serving.paging import dense_to_pool as jdense_to_pool
from repro_torch import api as tmiso
from repro_torch import bridge, tree
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget
from repro_torch.models import transformer as TT
from repro_torch.models.lm_cells import ServeConfig as TServeConfig
from repro_torch.models.lm_cells import SpecConfig
from repro_torch.models.lm_cells import install_prefill as tinstall
from repro_torch.models.lm_cells import paged_serving_supported, spec_serving_supported
from repro_torch.serving import Request as TRequest
from repro_torch.serving.lm import lm_engine_parts as torch_parts
from repro_torch.serving.paging import dense_to_pool as tdense_to_pool
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCH = "musicgen-large"
CFG = dc.replace(get_reduced(ARCH), dtype="float32")
TCFG = dc.replace(tget(ARCH), dtype="float32")
K = CFG.n_codebooks  # 2
B, S, MAX_LEN, PS = 2, 9, 32, 8
TOL = dict(atol=1e-4, rtol=1e-4)


def close(t, j):
    t, j = t.detach().numpy(), np.asarray(j)
    if np.issubdtype(j.dtype, np.integer):
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, **TOL)


@pytest.fixture(scope="module")
def pair():
    params = JT.init_params(CFG, jax.random.PRNGKey(0))
    return params, bridge.params_from_numpy(TCFG, jax.tree.map(np.asarray, params), device="cpu")


def tokens(n_b, n_s, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (n_b, n_s, K)).astype(np.int32)


def test_config_and_n_params_match_jax():
    assert dc.asdict(tget_config(ARCH)) == dc.asdict(get_config(ARCH))
    assert dc.asdict(tget(ARCH)) == dc.asdict(get_reduced(ARCH))
    assert tget_config(ARCH).n_params() == get_config(ARCH).n_params()
    assert round(tget_config(ARCH).n_params() / 1e9, 3) == 2.450
    full = tget_config(ARCH)
    assert (full.n_codebooks, full.head_dim, full.n_heads, full.n_kv_heads) == (4, 64, 32, 32)
    assert paged_serving_supported(TCFG) and not spec_serving_supported(TCFG)


def test_init_params_tree_matches_jax_and_the_bridge_checks_the_heads():
    cfg, tcfg = dc.replace(CFG, dtype="bfloat16"), dc.replace(TCFG, dtype="bfloat16")
    jp = jax.eval_shape(lambda k: JT.init_params(cfg, k), jax.random.PRNGKey(0))
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jflat, _ = jax.tree.flatten_with_path(jp)
    assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
            for path, _ in jflat] == [tuple(p) for p in tree.tree_paths(tp)]
    for (_, a), b in zip(jflat, tree.tree_leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == str(b.dtype).removeprefix("torch.")
    d, V = CFG.d_model, CFG.vocab_size
    assert tuple(tp["embed"].shape) == (K, V, d) and tuple(tp["lm_head"].shape) == (K, d, V)
    np_params = jax.tree.map(np.asarray, JT.init_params(CFG, jax.random.PRNGKey(1)))
    np_params["lm_head"] = np_params["lm_head"][0]
    with pytest.raises(ValueError, match="lm_head shape"):
        bridge.params_from_numpy(TCFG, np_params, device="cpu")


def test_embed_and_unembed_within_1e4_of_jax(pair):
    params, tparams = pair
    toks = tokens(B, S, seed=1)
    je = JT.embed_tokens(params, jnp.asarray(toks), CFG, JT.LOCAL)
    te = TT.embed_tokens(tparams, torch.from_numpy(toks), TCFG)
    close(te, je)
    h = np.random.default_rng(2).normal(size=(B, S, CFG.d_model)).astype(np.float32)
    ju = JT.unembed(params, jnp.asarray(h), CFG, JT.LOCAL)
    tu = TT.unembed(tparams, torch.from_numpy(h), TCFG)
    assert tuple(tu.shape) == (B, S, K, CFG.vocab_size)
    close(tu, ju)
    # the sum of the codebooks' rows
    want = sum(tparams["embed"][k][torch.from_numpy(toks[..., k]).long()] for k in range(K))
    assert torch.equal(te, want)


@pytest.fixture(scope="module")
def prefill(pair):
    params, tparams = pair
    toks = tokens(B, S, seed=3)
    jl, jc, _ = JT.forward(CFG, params, jnp.asarray(toks), fill_cache=True)
    tl, tc = TT.forward(TCFG, tparams, torch.from_numpy(toks), fill_cache=True)
    return (jl, jc), (tl, tc)


def test_forward_logits_and_filled_cache_within_1e4_of_jax(prefill):
    (jl, jc), (tl, tc) = prefill
    assert tuple(tl.shape) == (B, S, K, CFG.vocab_size)
    close(tl, jl)
    for t, j in zip(tree.tree_leaves(tc), jax.tree.leaves(jc)):
        close(t, j)


def pooled(cache, pool, pages, dense_to_pool):
    segs = []
    for dseg, pseg in zip(cache["segments"], pool["segments"]):
        seg = {}
        for key, p in pseg.items():
            for b in range(B):
                p = dense_to_pool(p, dseg[key][:, b:b + 1], pages[b])
            seg[key] = p
        segs.append(seg)
    return {"segments": segs, "pos": cache["pos"]}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_16_greedy_steps_equal_jax_tokens(pair, prefill, paged):
    params, tparams = pair
    (jl, jc), (tl, tc) = prefill
    jcache = jinstall(CFG, JT.init_cache(CFG, B, MAX_LEN), jc, S)
    tcache = tinstall(TCFG, TT.init_cache(TCFG, B, MAX_LEN, "cpu"), tc, S)
    jpages = tpages = None
    if paged:
        pages = np.random.default_rng(1).permutation(B * MAX_LEN // PS).reshape(B, -1).astype(np.int32)
        jpages, tpages = jnp.asarray(pages), torch.from_numpy(pages)
        jcache = pooled(jcache, JT.init_paged_cache(CFG, B, B * MAX_LEN // PS, PS), jpages,
                        jdense_to_pool)
        tcache = pooled(tcache, TT.init_paged_cache(TCFG, B, B * MAX_LEN // PS, PS, "cpu"),
                        pages, tdense_to_pool)
    jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)  # (B, 1, K)
    ttok = torch.argmax(tl[:, -1:], -1).to(torch.int32)
    step = jax.jit(lambda p, c, t, pg: JT.decode_step(CFG, p, c, t, pages=pg))
    for _ in range(16):
        assert tuple(ttok.shape) == (B, 1, K)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlog, jcache = step(params, jcache, jtok, jpages)
        tlog, tcache = TT.decode_step(TCFG, tparams, tcache, ttok, pages=tpages)
        close(tlog, jlog)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
    for t, j in zip(tree.tree_leaves(tcache), jax.tree.leaves(jcache)):
        close(t, j)


# ---------------------------------------------------------------------------
# served
# ---------------------------------------------------------------------------
LENGTHS, LEVELS = [5, 9, 3, 12, 7], [1, 2, 3, 1, 2]


def serve_kw(paged):
    return dict(batch=4, max_len=MAX_LEN, paged=paged, page_size=PS)


def prompts():
    return [np.random.default_rng(i).integers(0, CFG.vocab_size, size=(n, K)).astype(np.int32)
            for i, n in enumerate(LENGTHS)]


def staggered(eng, R, Pol):
    reqs = [R(prompt=p, max_new_tokens=6, policy=Pol(level=lv), id=f"c{i}")
            for i, (p, lv) in enumerate(zip(prompts(), LEVELS))]
    for r in reqs[:2]:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    for r in reqs[2:]:
        assert eng.submit(r)
    eng.pump()
    return [eng.result(r.id) for r in reqs]


def stream(res):
    """A request's emitted tokens: one (K,) row a step."""
    return np.stack(res["tokens"])


@pytest.fixture(scope="module")
def served():
    out = {}
    for paged in (False, True):
        jeng = jmiso.serve(*jax_parts(CFG, JServeConfig(**serve_kw(paged))))
        jeng.start(jax.random.PRNGKey(0))
        states = bridge.states_from_numpy(jax.tree.map(np.asarray, jeng._states), device="cpu")
        teng = tmiso.serve(*torch_parts(TCFG, TServeConfig(**serve_kw(paged)), device="cpu"),
                           device="cpu")
        teng.start(states=states)
        out[paged] = {"jax": staggered(jeng, JRequest, jmiso.RedundancyPolicy),
                      "torch": staggered(teng, TRequest, tmiso.RedundancyPolicy),
                      "metrics": (jeng.metrics(), teng.metrics()), "engines": (jeng, teng)}
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_tokens_and_counters_equal_jax(served, paged):
    run = served[paged]
    for j, t in zip(run["jax"], run["torch"]):
        assert t["status"] == j["status"] == DONE
        assert t["n_tokens"] == j["n_tokens"] == 6
        assert stream(t).shape == (6, K)
        np.testing.assert_array_equal(stream(t), stream(j))
        assert t["faults"] == j["faults"] == 0
    jm, tm = run["metrics"]
    for key in ("ticks", "done", "tokens_out", "paged", "prefill_buckets", "request_faults"):
        assert tm[key] == jm[key], key
    assert tm["paged"] == paged


def test_paged_tokens_equal_dense_within_port(served):
    for d, p in zip(served[False]["torch"], served[True]["torch"]):
        np.testing.assert_array_equal(stream(p), stream(d))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_dmr_strike_detected_attributed_repaired_like_jax(served, paged):
    """A bit flip into the second codebook of the victim's second replica
    slot's (B, 1, K) ``tokens`` leaf."""
    jeng, teng = served[paged]["engines"]
    ps = prompts()

    def strike_run(eng, R, Pol, FaultSpec):
        victim = R(prompt=ps[1], max_new_tokens=6, policy=Pol(level=2), id="cv")
        bystander = R(prompt=ps[0], max_new_tokens=6, id="cb")
        assert eng.submit(victim) and eng.submit(bystander)
        eng.pump(max_ticks=1)
        fault = FaultSpec.at(step=eng.exe.metrics()["steps"] + 1,
                             cell_id=eng.exe.program.cell_id("decoder"),
                             leaf=tree.leaf_index(teng._states["decoder"], "tokens"),
                             index=eng.requests[victim.id].slots[1] * K + 1, bit=4)
        eng.pump(faults=fault)
        return eng.result(victim.id), eng.result(bystander.id), eng.ledger.totals[victim.id]

    replays = teng.metrics()["replays"]
    jv, jb, jled = strike_run(jeng, JRequest, jmiso.RedundancyPolicy, jmiso.FaultSpec)
    tv, tb, tled = strike_run(teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec)
    assert tv["status"] == DONE and tv["faults"] == jv["faults"] == 1 and tb["faults"] == 0
    assert tled == jled and tled["per_replica"][1] == 1.0
    assert teng.metrics()["replays"] == replays + 1
    clean = served[paged]["torch"]
    np.testing.assert_array_equal(stream(tv), stream(jv))
    np.testing.assert_array_equal(stream(tv), stream(clean[1]))
    np.testing.assert_array_equal(stream(tb), stream(clean[0]))


def test_speculation_falls_back_to_plain_decode_like_jax():
    """Multi-codebook tokens cannot be compared as one draft token: asked
    to speculate, the engine keeps no spec leaves and emits the plain
    stream."""
    out = []
    for spec in (SpecConfig(draft_len=3), None):
        scfg = TServeConfig(**serve_kw(True), spec=spec)
        eng = tmiso.serve(*torch_parts(TCFG, scfg, device="cpu"), device="cpu")
        eng.start(0)
        req = TRequest(prompt=prompts()[1], max_new_tokens=6, spec=SpecConfig(draft_len=3))
        assert eng.submit(req)
        eng.pump()
        assert "spec_out" not in eng._states["decoder"]
        assert eng.adapter.stats()["spec_draft_len"] == 0
        out.append(stream(eng.result(req.id)))
    np.testing.assert_array_equal(out[0], out[1])
