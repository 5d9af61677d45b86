"""The port's serving engine under slot churn: host-side slot ownership
decisions and dense-cache defragmentation (relocating a running tenant
bitwise) held equal to the JAX package, and the request lifecycle
(cancel, deadline expiry).  Shares the configuration and engine pairing
of tests/test_torch_serving.py."""

import numpy as np
from test_torch_serving import PROMPTS, TCFG, engines, serve_kw

from repro import api as jmiso
from repro.serving import Request as JRequest
from repro_torch import api as tmiso
from repro_torch.serving import Request as TRequest
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def test_slot_manager_decisions_equal_jax_under_churn():
    """Host-side slot ownership (alloc / contiguous runs / defrag plans /
    relocation / release) makes the same decisions as the JAX package's
    SlotManager on a random churn sequence."""
    from repro.serving.slots import SlotManager as JSlots
    from repro_torch.serving.slots import SlotManager as TSlots

    rng = np.random.default_rng(3)
    j, t = JSlots(8), TSlots(8)
    live = []
    for step in range(300):
        op = int(rng.integers(0, 3))
        if op == 0:
            n = int(rng.integers(1, 4))
            contig = bool(rng.integers(0, 2))
            rid = f"q{step}"
            if contig and n > 1 and j.find_run(n) is None:
                plan = j.defrag_plan(n)
                assert t.defrag_plan(n) == plan
                for src, dst in plan or ():
                    assert t.relocate(src, dst) == j.relocate(src, dst)
            got = j.alloc(rid, n, contiguous=contig)
            assert t.alloc(rid, n, contiguous=contig) == got
            if got is not None:
                live.append(rid)
        elif live:
            rid = live.pop(int(rng.integers(0, len(live))))
            assert t.release(rid) == j.release(rid)
        assert t.free == j.free and t._free == j._free


def test_dense_defrag_under_churn_matches_jax():
    """Short single-slot tenants leave holes; a DMR request then needs two
    ADJACENT slots, so the dense engine relocates a running tenant
    (bitwise copy + scrub).  Tokens and moves equal JAX's."""
    jeng, teng = engines(paged=False)
    out = {}
    for name, eng, R, Pol in (("jax", jeng, JRequest, jmiso.RedundancyPolicy),
                              ("torch", teng, TRequest, tmiso.RedundancyPolicy)):
        budgets = [8, 2, 8, 3]
        reqs = [R(prompt=PROMPTS[i], max_new_tokens=b, id=f"f{i}")
                for i, b in enumerate(budgets)]
        reqs.append(R(prompt=PROMPTS[4], max_new_tokens=5, policy=Pol(level=2), id="f4"))
        for r in reqs:
            assert eng.submit(r)
        eng.pump()
        out[name] = ([eng.result(r.id)["tokens"] for r in reqs],
                     eng.metrics()["defrag_moves"])
    assert out["torch"] == out["jax"]
    assert out["torch"][1] > 0


def test_cancel_and_deadline_lifecycle():
    """Queued and running requests cancel; a queued request whose deadline
    passes expires unstarted; the slots and pages come back."""
    from repro_torch.models.lm_cells import ServeConfig as TServeConfig
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.lm import lm_engine_parts as torch_parts
    from repro_torch.serving.request import CANCELLED, EXPIRED

    now = [0.0]
    eng = ServingEngine(*torch_parts(TCFG, TServeConfig(**serve_kw(True)), device="cpu"),
                        device="cpu", time_fn=lambda: now[0])
    eng.start(0)
    a = TRequest(prompt=PROMPTS[0], max_new_tokens=20, policy=tmiso.RedundancyPolicy(level=3))
    b = TRequest(prompt=PROMPTS[1], max_new_tokens=4, policy=tmiso.RedundancyPolicy(level=2))
    c = TRequest(prompt=PROMPTS[2], max_new_tokens=4, deadline=5.0,
                 policy=tmiso.RedundancyPolicy(level=2))
    for r in (a, b, c):
        assert eng.submit(r)
    eng.pump(max_ticks=1)  # a runs (3 slots); b and c wait for 2 free slots
    assert eng.cancel(b.id) and eng.result(b.id)["status"] == CANCELLED
    now[0] = 10.0
    assert eng.cancel(a.id)  # running: leaves at the next tick boundary
    eng.pump()
    assert eng.result(a.id)["status"] == CANCELLED
    assert eng.result(c.id)["status"] == EXPIRED and eng.result(c.id)["n_tokens"] == 0
    m = eng.metrics()
    assert m["free_slots"] == 4 and m["pages_free"] == m["pages_total"]
    assert m["cancelled"] == 2 and m["expired"] == 1
