"""qwen2-vl-7b, M-RoPE and the vision stub, against the JAX package:
reduced (3 layers, sections (4, 2, 2), 8 vision rows) and in f32, on
JAX-initialised weights carried over through ``repro_torch.bridge``.

  * ``rope_cos_sin`` over distinct t/h/w position streams within 1e-6 of
    JAX's, and not the single-stream table;
  * forward logits with precomputed vision embeddings spliced over the
    first rows (and with distinct M-RoPE positions) within 1e-4, the
    filled cache too (``slot_pos`` from the t stream, exactly);
  * 16 greedy decode steps (positions broadcast to the three streams)
    give JAX's tokens;
  * the served none/DMR/TMR stream (zero vision rows, prompts longer and
    shorter than the splice, a DMR strike) gives JAX's tokens and
    FaultLedger.
"""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jmiso
from repro.configs import get_config, get_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.lm_cells import ServeConfig as JServeConfig
from repro.models.lm_cells import install_prefill as jinstall
from repro.serving import DONE
from repro.serving import Request as JRequest
from repro.serving.lm import lm_engine_parts as jax_parts
from repro_torch import api as tmiso
from repro_torch import bridge, tree
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.lm_cells import ServeConfig as TServeConfig
from repro_torch.models.lm_cells import SpecConfig
from repro_torch.models.lm_cells import install_prefill as tinstall
from repro_torch.models.lm_cells import paged_serving_supported, spec_serving_supported
from repro_torch.serving import Request as TRequest
from repro_torch.serving.lm import lm_engine_parts as torch_parts
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCH = "qwen2-vl-7b"
CFG = dc.replace(get_reduced(ARCH), dtype="float32")
TCFG = dc.replace(tget(ARCH), dtype="float32")
NV = CFG.n_vision_tokens  # 8
TOL = dict(atol=1e-4, rtol=1e-4)


def close(t, j, tol=TOL):
    t, j = t.detach().numpy(), np.asarray(j)
    if np.issubdtype(j.dtype, np.integer):
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, **tol)


@pytest.fixture(scope="module")
def pair():
    params = JT.init_params(CFG, jax.random.PRNGKey(0))
    return params, bridge.params_from_numpy(TCFG, jax.tree.map(np.asarray, params), device="cpu")


def tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


def mrope_positions(B, S, seed=0):
    """Distinct t/h/w streams: t counts up, h and w walk a 4-wide patch
    grid over the vision rows."""
    t = np.broadcast_to(np.arange(S), (B, S))
    grid = np.random.default_rng(seed).integers(0, 4, (2, B, S))
    return np.stack([t, t + grid[0], t + 2 * grid[1]]).astype(np.int32)


def test_config_and_n_params_match_jax():
    assert dc.asdict(tget_config(ARCH)) == dc.asdict(get_config(ARCH))
    assert dc.asdict(tget(ARCH)) == dc.asdict(get_reduced(ARCH))
    assert tget_config(ARCH).n_params() == get_config(ARCH).n_params()
    assert round(tget_config(ARCH).n_params() / 1e9, 3) == 7.070
    full = tget_config(ARCH)
    assert (full.head_dim, full.n_heads // full.n_kv_heads, full.n_vision_tokens) == (128, 7, 256)
    assert not paged_serving_supported(TCFG) and not spec_serving_supported(TCFG)


@pytest.mark.parametrize("sections,dim", [((4, 2, 2), 16), ((16, 24, 24), 128)],
                         ids=["reduced", "full"])
def test_rope_cos_sin_streams_equal_jax(sections, dim):
    pos = mrope_positions(2, 11, seed=dim)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), dim, 1e6, sections)
    tc, ts = L.rope_cos_sin(torch.from_numpy(pos), dim, 1e6, sections)
    assert tuple(tc.shape) == (2, 11, dim // 2)
    close(tc, jc, dict(atol=1e-6, rtol=1e-6))
    close(ts, js, dict(atol=1e-6, rtol=1e-6))
    # the h/w streams matter: the t stream alone gives another table
    c1, _ = L.rope_cos_sin(torch.from_numpy(pos[0]), dim, 1e6)
    assert not torch.allclose(c1, tc)
    # three equal streams are the single-stream table
    same = torch.from_numpy(np.stack([pos[0]] * 3))
    assert torch.equal(L.rope_cos_sin(same, dim, 1e6, sections)[0], c1)
    with pytest.raises(ValueError, match="sum"):
        L.rope_cos_sin(torch.from_numpy(pos), dim + 2, 1e6, sections)


@pytest.mark.parametrize("S,streams", [(12, False), (20, True), (5, False)],
                         ids=["splice", "splice_mrope_streams", "shorter_than_splice"])
def test_forward_with_vision_embeds_within_1e4_of_jax(pair, S, streams):
    params, tparams = pair
    toks = tokens(2, S, seed=S)
    vis = np.random.default_rng(S).normal(size=(2, min(NV, S), CFG.d_model)).astype(np.float32)
    pos = mrope_positions(2, S, seed=S) if streams else None
    jl, jc, _ = JT.forward(CFG, params, jnp.asarray(toks), vision_embeds=jnp.asarray(vis),
                           positions=None if pos is None else jnp.asarray(pos), fill_cache=True)
    tl, tc = TT.forward(TCFG, tparams, torch.from_numpy(toks), vision_embeds=torch.from_numpy(vis),
                        positions=None if pos is None else torch.from_numpy(pos), fill_cache=True)
    close(tl, jl)
    for t, j in zip(tree.tree_leaves(tc), jax.tree.leaves(jc)):
        close(t, j)
    # the splice replaced the first rows: the text-only forward differs there
    plain, _ = TT.forward(TCFG, tparams, torch.from_numpy(toks))
    assert not torch.allclose(plain[:, 0], tl[:, 0], **TOL)
    with pytest.raises(ValueError, match="vision splice"):
        TT.forward(TCFG, tparams, torch.from_numpy(toks), prompt_len=S)


def test_decode_16_greedy_steps_equal_jax(pair):
    params, tparams = pair
    S, max_len = 12, 32
    toks = tokens(2, S, seed=3)
    vis = np.zeros((2, NV, CFG.d_model), np.float32)
    jl, jc, _ = JT.forward(CFG, params, jnp.asarray(toks), vision_embeds=jnp.asarray(vis),
                           fill_cache=True)
    tl, tc = TT.forward(TCFG, tparams, torch.from_numpy(toks), vision_embeds=torch.from_numpy(vis),
                        fill_cache=True)
    jcache = jinstall(CFG, JT.init_cache(CFG, 2, max_len), jc, S)
    tcache = tinstall(TCFG, TT.init_cache(TCFG, 2, max_len, "cpu"), tc, S)
    jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], -1).to(torch.int32)
    step = jax.jit(lambda p, c, t: JT.decode_step(CFG, p, c, t))
    for _ in range(16):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlog, jcache = step(params, jcache, jtok)
        tlog, tcache = TT.decode_step(TCFG, tparams, tcache, ttok)
        close(tlog, jlog)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
    for t, j in zip(tree.tree_leaves(tcache), jax.tree.leaves(jcache)):
        close(t, j)


# ---------------------------------------------------------------------------
# served
# ---------------------------------------------------------------------------
#: longer than the 8-row splice, and one shorter (the splice covers it all)
LENGTHS, LEVELS = [14, 20, 5, 14, 20], [1, 2, 3, 1, 2]
SERVE = dict(batch=4, max_len=32)


def prompts():
    return [np.random.default_rng(i).integers(0, CFG.vocab_size, size=n).astype(np.int32)
            for i, n in enumerate(LENGTHS)]


def staggered(eng, R, Pol):
    reqs = [R(prompt=p, max_new_tokens=6, policy=Pol(level=lv), id=f"q{i}")
            for i, (p, lv) in enumerate(zip(prompts(), LEVELS))]
    for r in reqs[:2]:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    for r in reqs[2:]:
        assert eng.submit(r)
    eng.pump()
    return [eng.result(r.id) for r in reqs]


@pytest.fixture(scope="module")
def served():
    jeng = jmiso.serve(*jax_parts(CFG, JServeConfig(**SERVE)))
    jeng.start(jax.random.PRNGKey(0))
    states = bridge.states_from_numpy(jax.tree.map(np.asarray, jeng._states), device="cpu")
    teng = tmiso.serve(*torch_parts(TCFG, TServeConfig(**SERVE), device="cpu"), device="cpu")
    teng.start(states=states)
    return {"jax": staggered(jeng, JRequest, jmiso.RedundancyPolicy),
            "torch": staggered(teng, TRequest, tmiso.RedundancyPolicy),
            "metrics": (jeng.metrics(), teng.metrics()), "engines": (jeng, teng)}


def test_engine_tokens_and_counters_equal_jax(served):
    for j, t in zip(served["jax"], served["torch"]):
        assert t["status"] == j["status"] == DONE
        assert t["tokens"] == j["tokens"] and len(t["tokens"]) == 6
        assert t["faults"] == j["faults"] == 0
    jm, tm = served["metrics"]
    for key in ("ticks", "done", "tokens_out", "paged", "prefill_buckets", "prefill_chunk",
                "request_faults"):
        assert tm[key] == jm[key], key
    assert tm["prefill_buckets"] is None and tm["prefill_chunk"] == 0


def test_dmr_strike_detected_attributed_repaired_like_jax(served):
    jeng, teng = served["engines"]
    ps = prompts()

    def strike_run(eng, R, Pol, FaultSpec):
        victim = R(prompt=ps[1], max_new_tokens=6, policy=Pol(level=2), id="qv")
        bystander = R(prompt=ps[0], max_new_tokens=6, id="qb")
        assert eng.submit(victim) and eng.submit(bystander)
        eng.pump(max_ticks=1)
        fault = FaultSpec.at(step=eng.exe.metrics()["steps"] + 1,
                             cell_id=eng.exe.program.cell_id("decoder"),
                             leaf=tree.leaf_index(teng._states["decoder"], "tokens"),
                             index=eng.requests[victim.id].slots[1], bit=4)
        eng.pump(faults=fault)
        return eng.result(victim.id), eng.result(bystander.id), eng.ledger.totals[victim.id]

    replays = teng.metrics()["replays"]
    jv, jb, jled = strike_run(jeng, JRequest, jmiso.RedundancyPolicy, jmiso.FaultSpec)
    tv, tb, tled = strike_run(teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec)
    assert tv["status"] == DONE and tv["faults"] == jv["faults"] == 1 and tb["faults"] == 0
    assert tled == jled and tled["per_replica"][1] == 1.0
    assert teng.metrics()["replays"] == replays + 1
    assert tv["tokens"] == jv["tokens"] == served["torch"][1]["tokens"]
    assert tb["tokens"] == jb["tokens"] == served["torch"][0]["tokens"]


def test_vision_arch_takes_no_chunk_and_no_speculation():
    """As in JAX: the splice pins the prompt layout, so a vision arch
    prefills its whole prompt (``prefill_chunk`` ignored) and decodes
    plainly when asked to speculate."""
    scfg = TServeConfig(**SERVE, prefill_chunk=4, spec=SpecConfig(draft_len=3))
    eng = tmiso.serve(*torch_parts(TCFG, scfg, device="cpu"), device="cpu")
    eng.start(0)
    req = TRequest(prompt=prompts()[1], max_new_tokens=4, spec=SpecConfig(draft_len=3))
    assert eng.submit(req)
    eng.pump()
    assert eng.result(req.id)["n_tokens"] == 4
    stats = eng.adapter.stats()
    assert stats["prefill_chunk"] == 0 and stats["spec_draft_len"] == 0
    assert "spec_out" not in eng._states["decoder"]
