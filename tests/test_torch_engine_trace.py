"""The serving engine's trace spans: the port's traced engine against the
JAX package's (tests/test_obs.py's engine gates).

The same deterministic stream (tiny_lm in f32, speculation on, paged KV,
a DMR and a TMR strike) is served by both engines, each with a
``Tracer``.  The ordered ``(ph, name, track, args)`` lists are EQUAL once
every field that carries a time is left out (``ts``, ``dur``, ``*_us``,
``ttft_s``), and both exports pass ``tools/validate_trace.py``.
"""

import dataclasses as dc
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest

from repro import api as jmiso
from repro.configs import get_reduced
from repro.models import lm_cells as jlc
from repro.obs import Tracer as JTracer
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro.serving.lm import lm_engine_parts as jax_parts
from repro_torch import api as tmiso
from repro_torch import bridge, tree
from repro_torch.configs import get_reduced as tget
from repro_torch.models import lm_cells as tlc
from repro_torch.obs import Tracer as TTracer
from repro_torch.serving import DONE, EXPIRED
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TEngine
from repro_torch.serving import engine as tengine_mod
from repro_torch.serving.lm import lm_engine_parts as torch_parts
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("validate_trace", ROOT / "tools" / "validate_trace.py")
validate_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(validate_trace)

TINY = dict(d_model=32, n_layers=2, d_ff=64, n_heads=2, n_kv_heads=1, vocab_size=128,
            dtype="float32")
CFG = dc.replace(get_reduced("internlm2-1.8b"), **TINY)
TCFG = dc.replace(tget("internlm2-1.8b"), **TINY)
K = 2
PROMPTS = [np.random.default_rng(20 + i).integers(0, 128, size=n).astype(np.int32)
           for i, n in enumerate([6, 4, 9, 5])]
LEVELS = [1, 2, 3, 1]
SERVE = dict(batch=8, max_len=32, paged=True, page_size=4)


def serve_config(lc, **over):
    return lc.ServeConfig(**{**SERVE, **over}, spec=lc.SpecConfig(draft_len=K))


def clock():
    """A deterministic engine clock: each reading advances 0.125 s."""
    t = [0.0]

    def now():
        t[0] += 0.125
        return t[0]

    return now


def untimed(tracer) -> list:
    """The exported events as ``(ph, name, track, args)``, every field
    that carries a time left out."""
    events = tracer.events()
    names = {e["tid"]: e["args"]["name"] for e in events if e["name"] == "thread_name"}
    out = []
    for e in events:
        if e["ph"] == "M":
            continue
        args = {k: v for k, v in (e.get("args") or {}).items()
                if not k.endswith("_us") and k != "ttft_s"}
        out.append((e["ph"], e["name"], names[e["tid"]], json.dumps(args, sort_keys=True)))
    return out


def stream(eng, R, Pol, F, leaf):
    """Four staggered requests asking for speculation; a bit flip into the
    DMR request's replica 1 and one into the TMR request's replica 2,
    each landing mid-verify."""
    reqs = [R(prompt=p, max_new_tokens=9, policy=Pol(level=lv), id=f"t{i}",
              spec=(jlc if R is JRequest else tlc).SpecConfig(draft_len=K))
            for i, (p, lv) in enumerate(zip(PROMPTS, LEVELS))]
    for r in reqs[:3]:
        assert eng.submit(r)
    eng.pump(max_ticks=1)
    assert eng.submit(reqs[3])
    cell = eng.exe.program.cell_id("decoder")
    step = eng.exe.metrics()["steps"]
    faults = [F.at(step=step, cell_id=cell, leaf=leaf, index=eng.requests["t2"].slots[2], bit=5),
              F.at(step=step + 1, cell_id=cell, leaf=leaf, index=eng.requests["t1"].slots[1], bit=3)]
    eng.pump(faults=faults)
    return [eng.result(r.id) for r in reqs], eng.ledger.totals


@pytest.fixture(scope="module")
def traced():
    jeng = jmiso.serve(*jax_parts(CFG, serve_config(jlc)), jmiso.EngineConfig(tracer=JTracer()))
    jeng.start(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jeng._states)
    flat, _ = jax.tree_util.tree_flatten_with_path(init["decoder"])
    leaf = next(i for i, (p, _) in enumerate(flat) if getattr(p[0], "key", None) == "tokens")
    jres = stream(jeng, JRequest, jmiso.RedundancyPolicy, jmiso.FaultSpec, leaf)

    def port(tracer):
        parts = torch_parts(TCFG, serve_config(tlc), device="cpu")
        eng = tmiso.serve(*parts, tmiso.EngineConfig(tracer=tracer), device="cpu")
        eng.start(states=bridge.states_from_numpy(init, device="cpu"))
        assert tree.leaf_index(eng._states["decoder"], "tokens") == leaf
        return eng

    ttr = TTracer()
    teng = port(ttr)
    tres = stream(teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec, leaf)
    plain = port(None)
    fences = []
    real = tengine_mod._fence
    tengine_mod._fence = lambda x: (fences.append(1), real(x))
    try:
        pres = stream(plain, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec, leaf)
    finally:
        tengine_mod._fence = real
    return {"jax": (jeng, jres), "torch": (teng, tres), "plain": (plain, pres),
            "untraced_fences": len(fences)}


def test_traced_events_equal_jax_without_times(traced):
    jeng, _ = traced["jax"]
    teng, _ = traced["torch"]
    jev, tev = untimed(jeng.tracer), untimed(teng.tracer)
    assert tev == jev
    names = {n for _, n, _, _ in tev}
    for expected in ("request", "queued", "prefill", "admitted", "first_token", "done", "tick",
                     "verify_walk", "page_fault", "dmr_replay", "strike_detected",
                     "strike_attributed", "strike_repaired", "strike"):
        assert expected in names, expected


def test_both_exports_pass_validate_trace(traced, tmp_path):
    for side in ("jax", "torch"):
        path = tmp_path / f"{side}.json"
        traced[side][0].tracer.export(path)
        assert validate_trace.validate_file(str(path)) == []


def test_tokens_and_ledger_equal_jax_with_and_without_tracer(traced):
    jres, jled = traced["jax"][1]
    tres, tled = traced["torch"][1]
    pres, pled = traced["plain"][1]
    assert [r["tokens"] for r in tres] == [r["tokens"] for r in jres]
    assert [r["tokens"] for r in pres] == [r["tokens"] for r in tres]
    assert tled == jled == pled and set(tled) == {"t1", "t2"}
    assert all(r["status"] == DONE for r in tres)


def test_untraced_engine_never_fences(traced):
    assert traced["untraced_fences"] == 0


def test_span_counts_match_engine_counters(traced):
    teng, _ = traced["torch"]
    evs = teng.tracer.events()
    m = teng.metrics()
    xs = [e for e in evs if e["ph"] == "X"]
    assert sum(e["name"] == "tick" for e in xs) == m["ticks"]
    assert sum(e["name"] == "verify_walk" for e in xs) == m["spec_ticks"]
    assert sum(e["name"] == "dmr_replay" for e in xs) == m["replays"] == 1
    begins = [e for e in evs if e["ph"] == "B" and e["name"] == "request"]
    assert len(begins) == m["submitted"] == 4
    for e in xs:
        if e["name"] == "tick":
            a = e["args"]
            assert min(a["dispatch_us"], a["device_us"], a["harvest_us"]) >= 0
            assert e["dur"] >= a["dispatch_us"] + a["device_us"] - 1e-3
    for rid, repair in (("t1", "dmr_replay"), ("t2", "tmr_vote")):
        tid = teng.tracer.tid(rid)
        line = [e for e in evs if e["tid"] == tid and e["name"].startswith("strike_")]
        assert [e["name"] for e in line] == ["strike_detected", "strike_attributed",
                                             "strike_repaired"]
        assert line[2]["args"]["repair"] == repair


def test_eviction_mid_walk_and_queued_expiry_like_jax():
    """A request evicted mid-prefill-walk (deadline) still exports a
    balanced trace: the walk span closes before the lifecycle span; a
    queued request past its deadline emits ``request_expired``.  The
    same clock drives both engines, so the traces are equal too."""
    over = dict(batch=2, prefill_chunk=2, prefill_bucket_min=2)
    jtr, ttr = JTracer(), TTracer()
    jeng = JEngine(*jax_parts(CFG, serve_config(jlc, **over)), jmiso.EngineConfig(tracer=jtr),
                   time_fn=clock())
    jeng.start(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, jeng._states)
    teng = TEngine(*torch_parts(TCFG, serve_config(tlc, **over), device="cpu"),
                   tmiso.EngineConfig(tracer=ttr), device="cpu", time_fn=clock())
    teng.start(states=bridge.states_from_numpy(init, device="cpu"))
    out = []
    for eng, R, Pol in ((jeng, JRequest, jmiso.RedundancyPolicy),
                        (teng, TRequest, tmiso.RedundancyPolicy)):
        walker = R(prompt=PROMPTS[2], max_new_tokens=4, deadline=2.0, id="w")
        queued = R(prompt=PROMPTS[0], max_new_tokens=4, deadline=2.5, id="q",
                   policy=Pol(level=2))
        assert eng.submit(walker) and eng.submit(queued)
        eng.pump(max_ticks=3)
        out.append((eng.result("w")["status"], eng.result("q")["status"]))
    assert out[0] == out[1] == (EXPIRED, EXPIRED)
    assert untimed(ttr) == untimed(jtr)
    evs = ttr.events()
    assert validate_trace.validate_events(evs) == []
    walk = [e for e in evs if e["tid"] == ttr.tid("w") and e["name"] == "prefill_walk"]
    assert [e["ph"] for e in walk] == ["B", "E"]
    assert [e["name"] for e in evs if e["tid"] == ttr.tid("q") and e["ph"] == "i"] == [
        "queued", "request_expired", "expired"]
