"""h2o-danube-3-4b, the sliding-window decoder, against the JAX package:
reduced (3 layers, window 32) and in f32, on JAX-initialised weights
carried over through ``repro_torch.bridge``.

  * forward logits of prompts longer than the window within 1e-4, and
    the filled ring cache (the trailing window at slot ``pos % W``):
    ``slot_pos`` exactly, K/V within 1e-4;
  * greedy decode steps across the ring's wrap give JAX's tokens;
  * the served none/DMR/TMR stream (a prompt longer than ``max_len``, a
    decode that wraps the ring, a DMR strike) gives JAX's tokens and
    FaultLedger;
  * the ring-mask proof: on every tick of a served run across a wrap,
    for S = window and for S = max_len < window, every active slot's
    JAX mask (``slot_pos`` filled, at most ``pos``, inside the window)
    is the lane mask ``lane <= min(pos, S-1)`` the card's kernel
    applies; and the engine's tokens through that lane-masked route
    (K5's plain version here) equal the ``slot_pos`` route's.
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
from repro_torch import api as tmiso
from repro_torch import bridge, tree
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import get_reduced as tget
from repro_torch.kernels import paged_decode as pd
from repro_torch.models import layers as L
from repro_torch.models import transformer as TT
from repro_torch.models.lm_cells import ServeConfig as TServeConfig
from repro_torch.models.lm_cells import install_prefill as tinstall
from repro_torch.models.lm_cells import paged_serving_supported, spec_serving_supported
from repro_torch.serving import Request as TRequest
from repro_torch.serving.lm import lm_engine_parts as torch_parts
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCH = "h2o-danube-3-4b"
CFG = dc.replace(get_reduced(ARCH), dtype="float32")
TCFG = dc.replace(tget(ARCH), dtype="float32")
W = CFG.window  # 32
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


def tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (B, S)).astype(np.int32)


def test_config_and_n_params_match_jax():
    assert dc.asdict(tget_config(ARCH)) == dc.asdict(get_config(ARCH))
    assert dc.asdict(tget(ARCH)) == dc.asdict(get_reduced(ARCH))
    assert tget_config(ARCH).n_params() == get_config(ARCH).n_params()
    assert round(tget_config(ARCH).n_params() / 1e9, 3) == 3.839
    assert (tget_config(ARCH).window, tget_config(ARCH).head_dim) == (4096, 120)
    assert not paged_serving_supported(TCFG) and not spec_serving_supported(TCFG)


@pytest.mark.parametrize("S", [20, W, 45], ids=["shorter", "window", "longer"])
def test_forward_logits_and_filled_ring_within_1e4_of_jax(pair, S):
    """Below the window the cache is the prompt's lanes; at and past it,
    the ring: position p at slot p % W, the trailing W positions only."""
    params, tparams = pair
    toks = tokens(2, S, seed=S)
    jl, jc, _ = JT.forward(CFG, params, jnp.asarray(toks), fill_cache=True)
    tl, tc = TT.forward(TCFG, tparams, torch.from_numpy(toks), fill_cache=True)
    close(tl, jl)
    seg, jseg = tc["segments"][0], jc["segments"][0]
    for key in ("k", "v", "slot_pos"):
        close(seg[key], jseg[key])
    sp = seg["slot_pos"][0, 0]
    assert sp.shape[-1] == min(S, W)
    if S >= W:
        assert sorted(sp.tolist()) == list(range(S - W, S))
        assert all(int(p) % W == lane for lane, p in enumerate(sp))
    with pytest.raises(ValueError, match="sliding-window"):
        TT.forward(TCFG, tparams, torch.from_numpy(toks), prompt_len=S - 1)


@pytest.mark.parametrize("S,max_len", [(28, 40), (45, 40), (14, 24)],
                         ids=["wrap_at_window", "ring_filled", "wrap_at_max_len"])
def test_decode_across_the_wrap_equals_jax(pair, S, max_len):
    """Greedy steps from the prefill, past the ring's wrap (a ring of S =
    min(max_len, W) lanes): tokens equal JAX's, caches within 1e-4
    (positions exactly)."""
    params, tparams = pair
    toks, steps = tokens(2, S, seed=7), 16
    jl, jc, _ = JT.forward(CFG, params, jnp.asarray(toks), fill_cache=True)
    tl, tc = TT.forward(TCFG, tparams, torch.from_numpy(toks), fill_cache=True)
    jcache = jinstall(CFG, JT.init_cache(CFG, 2, max_len), jc, S)
    tcache = tinstall(TCFG, TT.init_cache(TCFG, 2, max_len, "cpu"), tc, S)
    assert tcache["segments"][0]["k"].shape[3] == min(max_len, W)
    jtok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], -1).to(torch.int32)
    step = jax.jit(lambda p, c, t: JT.decode_step(CFG, p, c, t))
    for _ in range(steps):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlog, jcache = step(params, jcache, jtok)
        tlog, tcache = TT.decode_step(TCFG, tparams, tcache, ttok)
        close(tlog, jlog)
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
    assert int(tcache["pos"][0]) == S + steps > min(max_len, W)  # the ring wrapped
    for t, j in zip(tree.tree_leaves(tcache), jax.tree.leaves(jcache)):
        close(t, j)


# ---------------------------------------------------------------------------
# served
# ---------------------------------------------------------------------------
#: a prompt past max_len (the ring fill), decodes that wrap the 32-lane
#: ring (29 + 6), and prompts that stay inside it
LENGTHS, LEVELS = [40, 29, 12, 29, 40], [1, 2, 3, 1, 2]
SERVE = dict(batch=4, max_len=32)


def prompts():
    return [np.random.default_rng(i).integers(0, CFG.vocab_size, size=n).astype(np.int32)
            for i, n in enumerate(LENGTHS)]


def engines():
    jeng = jmiso.serve(*jax_parts(CFG, JServeConfig(**SERVE)))
    jeng.start(jax.random.PRNGKey(0))
    states = bridge.states_from_numpy(jax.tree.map(np.asarray, jeng._states), device="cpu")
    teng = tmiso.serve(*torch_parts(TCFG, TServeConfig(**SERVE), device="cpu"), device="cpu")
    teng.start(states=states)
    return jeng, teng


def staggered(eng, R, Pol, tag=""):
    reqs = [R(prompt=p, max_new_tokens=6, policy=Pol(level=lv), id=f"w{tag}{i}")
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
    jeng, teng = engines()
    return {"jax": staggered(jeng, JRequest, jmiso.RedundancyPolicy),
            "torch": staggered(teng, TRequest, tmiso.RedundancyPolicy),
            "metrics": (jeng.metrics(), teng.metrics()), "engines": (jeng, teng)}


def test_engine_tokens_and_counters_equal_jax(served):
    for j, t in zip(served["jax"], served["torch"]):
        assert t["status"] == j["status"] == DONE
        assert t["tokens"] == j["tokens"] and len(t["tokens"]) == 6
        assert t["faults"] == j["faults"] == 0
    jm, tm = served["metrics"]
    for key in ("ticks", "done", "tokens_out", "paged", "prefill_buckets", "request_faults"):
        assert tm[key] == jm[key], key
    assert tm["prefill_buckets"] is None and not tm["paged"]


@pytest.mark.parametrize("key", ["tokens", "k"], ids=["tokens", "ring-k-lane"])
def test_dmr_strike_detected_attributed_repaired_like_jax(served, key):
    """A bit flip into the second replica slot of a DMR request whose
    decode wraps the ring: its ``tokens`` leaf, or a lane of layer 0's
    ring."""
    jeng, teng = served["engines"]
    ps = prompts()

    def strike_run(eng, R, Pol, FaultSpec):
        victim = R(prompt=ps[1], max_new_tokens=6, policy=Pol(level=2), id=f"{key}v")
        bystander = R(prompt=ps[0], max_new_tokens=6, id=f"{key}b")
        assert eng.submit(victim) and eng.submit(bystander)
        eng.pump(max_ticks=1)
        dec = teng._states["decoder"]
        leaf = tree.leaf_index(dec, key)
        slot = eng.requests[victim.id].slots[1]
        per_slot = 1 if key == "tokens" else int(np.prod(tree.tree_leaves(dec)[leaf].shape[2:]))
        fault = FaultSpec.at(step=eng.exe.metrics()["steps"] + 1,
                             cell_id=eng.exe.program.cell_id("decoder"), leaf=leaf,
                             index=slot * per_slot + (0 if key == "tokens" else 3),
                             bit=4 if key == "tokens" else 20)
        eng.pump(faults=fault)
        return eng.result(victim.id), eng.result(bystander.id), eng.ledger.totals[victim.id]

    replays = teng.metrics()["replays"]
    jv, jb, jled = strike_run(jeng, JRequest, jmiso.RedundancyPolicy, jmiso.FaultSpec)
    tv, tb, tled = strike_run(teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec)
    assert tv["status"] == DONE and tv["faults"] == jv["faults"] == 1 and tb["faults"] == 0
    assert tled == jled and tled["per_replica"][1] == 1.0
    assert teng.metrics()["replays"] == replays + 1
    clean = served["torch"]
    assert tv["tokens"] == jv["tokens"] == clean[1]["tokens"]
    assert tb["tokens"] == jb["tokens"] == clean[0]["tokens"]


# ---------------------------------------------------------------------------
# the ring-mask proof
# ---------------------------------------------------------------------------
def jax_mask(slot_pos, pos, window):
    """``decode_attention``'s mask in the JAX package (layers.py)."""
    return (slot_pos >= 0) & (slot_pos <= pos[:, None]) & (slot_pos > pos[:, None] - window)


@pytest.mark.parametrize("max_len,lengths", [(32, [40, 29, 12, 29, 40, 31]),
                                             (24, [20, 23, 9, 18, 22, 20])],
                         ids=["S=window", "S=max_len<window"])
def test_jax_window_mask_equals_ring_lane_mask_on_every_tick(monkeypatch, max_len, lengths):
    """A served none/DMR/TMR run whose decodes wrap the ring (slots freed
    and reused): after every decode write, every active slot's JAX mask
    is ``lane <= ring_lane_pos(pos, S)``, the bound the card's K5 masks
    the dense view by."""
    original = L.gqa_attention
    seen = {"slots": 0, "wrapped": 0}

    def checking(p, x, cfg, *, positions, cache=None, active=None, pages=None, **kw):
        out, cout = original(p, x, cfg, positions=positions, cache=cache, active=active,
                             pages=pages, **kw)
        if cache is not None:
            pos, sp = positions[:, 0], cout["slot_pos"]
            S = sp.shape[1]
            assert S == min(max_len, W)
            lanes = torch.arange(S)[None, :] <= L.ring_lane_pos(pos, S)[:, None]
            rows = active.nonzero()[:, 0]
            assert torch.equal(jax_mask(sp, pos, W)[rows], lanes[rows]), (pos.tolist(), sp.tolist())
            seen["slots"] += len(rows)
            seen["wrapped"] += int((pos[rows] >= S).sum())
        return out, cout

    monkeypatch.setattr(L, "gqa_attention", checking)
    eng = tmiso.serve(*torch_parts(TCFG, TServeConfig(batch=4, max_len=max_len), device="cpu"),
                      device="cpu")
    eng.start(0)
    rng = np.random.default_rng(max_len)
    reqs = [TRequest(prompt=rng.integers(0, CFG.vocab_size, size=n).astype(np.int32),
                     max_new_tokens=8, policy=tmiso.RedundancyPolicy(level=1 + i % 3), id=f"m{i}")
            for i, n in enumerate(lengths)]
    for r in reqs[:3]:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    for r in reqs[3:]:
        assert eng.submit(r)
    eng.pump()
    assert all(eng.result(r.id)["status"] == DONE for r in reqs)
    assert seen["wrapped"] > 0 and seen["slots"] > seen["wrapped"]


def test_windowed_engine_through_the_lane_masked_route_equals_slot_pos_route(monkeypatch):
    """The card's route on the CPU: dense decode forced onto K5 (its plain
    version here, masked by lane at ``ring_lane_pos``) serves the same
    tokens as the ``slot_pos`` route across the wraps, and reaches K5
    once a layer a decode step."""
    def run():
        eng = tmiso.serve(*torch_parts(TCFG, TServeConfig(**SERVE), device="cpu"), device="cpu")
        eng.start(0)
        out = staggered(eng, TRequest, tmiso.RedundancyPolicy, tag="r")
        return [r["tokens"] for r in out], eng.metrics()["ticks"]

    want, _ = run()
    calls = []
    plain = pd.paged_gqa_attention

    def counted(*a, **k):
        calls.append(a[-1])
        return plain(*a, **k)

    monkeypatch.setattr(L, "dense_decode_on_card", lambda device: True)
    monkeypatch.setattr(L, "paged_gqa_attention", counted)
    got, ticks = run()
    assert got == want
    assert len(calls) == CFG.n_layers * ticks
    assert max(int(p.max()) for p in calls) == W - 1  # clamped past the wrap
