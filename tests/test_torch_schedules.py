"""The port's other schedules on the CPU, held BITWISE against the JAX
package: ``host`` (the paper's §IV tie-break in the loop), ``wavefront``
(§III: no global barrier), ``run_campaign``, ``on_event`` and
``backend="auto"``, replaying the rows of ``tests/test_executor.py`` that
concern them.  Each JAX program has a torch twin; the port starts from the
JAX program's initial states, carried over through ``repro_torch.bridge``.
States, summed reports, ``ledger.recent`` and totals, ``recoveries``, the
wavefront's ``trace`` and ``max_lead`` are compared bitwise, and so are
error texts.  The port's ``lockstep_cuda`` (its kernels' plain versions
here) stands beside JAX's ``lockstep_pallas`` (interpret mode).

``on_event``: JAX's ``lockstep.run`` is one in-graph scan and emits a
``scan_segment`` per segment; the port's is a host loop and emits a
``step`` per step.  Those two are left out of the lock-step comparison;
every other event, and every event of ``host`` and ``wavefront``, is
compared by name and non-timing attributes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jmiso
from repro_torch import api as tmiso
from repro_torch import bridge, tree
from repro_torch.core.fault import bitcast_int
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

JAX_NAME = {"lockstep": "lockstep", "lockstep_cuda": "lockstep_pallas",
            "host": "host", "wavefront": "wavefront"}
ALL_BACKENDS = tuple(JAX_NAME)
REPLAY_BACKENDS = ("lockstep", "lockstep_cuda", "host")  # those with pure_step
TIMING = ("dur_us", "dispatch_us", "device_us", "ts_us")


# ---------------------------------------------------------------------------
# the programs of tests/test_executor.py, in both packages
# ---------------------------------------------------------------------------
def three_cell(m, xp):
    """A self-coupled cell, a reader, and an independent cell: two
    weakly-connected components, so two wavefront units."""
    p = m.MisoProgram()
    p.add(m.CellType("a", None, lambda prev: {"x": prev["a"]["x"] * 1.25 + 0.125}))
    p.add(m.CellType("b", None, lambda prev: {"x": prev["b"]["x"] * 0.5 + prev["a"]["x"] * 2.0},
                     reads=("a",)))
    p.add(m.CellType("c", None, lambda prev: {"x": prev["c"]["x"] * 1.000001 + 0.5}))
    return p


def chain(m, xp):
    """One weakly-connected component (a -> b): auto picks lock-step."""
    p = m.MisoProgram()
    p.add(m.CellType("a", None, lambda prev: {"x": prev["a"]["x"] + 1.0}))
    p.add(m.CellType("b", None, lambda prev: {"x": prev["b"]["x"] + prev["a"]["x"]},
                     reads=("a",)))
    return p


def dmr(m, xp):
    p = m.MisoProgram()
    p.add(m.CellType("a", None,
                     lambda prev: {"x": prev["a"]["x"] * 0.5 + xp.roll(prev["a"]["x"], 1) * 0.25},
                     redundancy=m.RedundancyPolicy(level=2)))
    p.add(m.CellType("c", None, lambda prev: {"x": prev["c"]["x"] * 0.5 + 0.5}))
    return p


def mixed(m, xp):
    """An unreplicated source, a DMR cell reading it, and a TMR cell
    reading the DMR cell (canonicalized across levels): the tie-break's
    third transition reads both kinds."""
    p = m.MisoProgram()
    p.add(m.CellType("src", None, lambda prev: {"x": prev["src"]["x"] * 0.5 + 1.0}))
    p.add(m.CellType("d", None,
                     lambda prev: {"x": prev["d"]["x"] * 0.5 + xp.roll(prev["src"]["x"], 1) * 0.25,
                                   "n": prev["d"]["n"] + 1},
                     reads=("src",), redundancy=m.RedundancyPolicy(level=2)))
    p.add(m.CellType("t", None, lambda prev: {"x": prev["t"]["x"] * 0.25 + prev["d"]["x"]},
                     reads=("d",), redundancy=m.RedundancyPolicy(level=3)))
    return p


INITS = {
    "three_cell": lambda: {"a": {"x": jnp.linspace(0.0, 1.0, 8, dtype=jnp.float32)},
                           "b": {"x": jnp.ones((8,), jnp.float32)},
                           "c": {"x": jnp.float32(1.0)}},
    "chain": lambda: {"a": {"x": jnp.float32(1.0)}, "b": {"x": jnp.float32(0.0)}},
    "dmr": lambda: {"a": {"x": jnp.linspace(0.0, 1.0, 8, dtype=jnp.float32)},
                    "c": {"x": jnp.float32(1.0)}},
    "mixed": lambda: {"src": {"x": jnp.arange(16, dtype=jnp.float32)},
                      "d": {"x": jnp.linspace(0.0, 1.0, 16, dtype=jnp.float32),
                            "n": jnp.zeros((4,), jnp.int32)},
                      "t": {"x": jnp.ones((16,), jnp.float32)}},
}
PROGRAM_FNS = {"three_cell": three_cell, "chain": chain, "dmr": dmr, "mixed": mixed}


def programs(name, key=0):
    """(JAX program, port program); the JAX cells' inits give the states
    of ``INITS`` (plus ``key`` in every leaf, so two keys differ)."""
    jp, tp = PROGRAM_FNS[name](jmiso, jnp), PROGRAM_FNS[name](tmiso, torch)
    init = INITS[name]()
    for cname, cell in list(jp.cells.items()):
        state = jax.tree.map(lambda x: x + key, init[cname])
        jp.cells[cname] = dataclasses.replace(cell, init=lambda k, s=state: s)
    return jp, tp


def policies(m, levels):
    return {k: m.RedundancyPolicy(level=v) for k, v in (levels or {}).items()}


class Pair:
    """A JAX executor and the port's, on the same program, states and
    options; the port's initial states are the JAX program's."""

    def __init__(self, name, backend, levels=None, key=0, **kw):
        jp, tp = programs(name, key)
        self.jexe = jmiso.compile(jp, backend=JAX_NAME[backend], donate=False,
                                  policies=policies(jmiso, levels), **kw)
        self.texe = tmiso.compile(tp, backend=backend, device="cpu",
                                  policies=policies(tmiso, levels), **kw)
        self.js = self.jexe.init(jax.random.PRNGKey(key))
        self.ts = to_torch(self.js)


def to_torch(jtree):
    return bridge.states_from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def fault(m, **kw):
    return m.FaultSpec.at(**kw)


def assert_states(jstates, tstates):
    jl, tl = jax.tree.leaves(jstates), tree.tree_leaves(tstates)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        ref = to_torch({"x": np.asarray(a)})["x"]
        assert ref.shape == b.shape and ref.dtype == b.dtype
        assert torch.equal(bitcast_int(ref), bitcast_int(b))


def assert_reports(jrep, trep):
    assert set(jrep) == set(trep)
    for cell in jrep:
        for key in ("mismatch_elems", "events", "per_replica"):
            np.testing.assert_array_equal(np.asarray(jrep[cell][key], np.float32),
                                          np.asarray(trep[cell][key], np.float32))


def assert_ledgers(jexe, texe):
    assert texe.ledger.recent == jexe.ledger.recent
    jm, tm = jexe.metrics(), texe.metrics()
    for key in ("steps", "fault_totals", "flagged", "suspects", "recoveries"):
        assert tm[key] == jm[key], key
    if texe.name == "wavefront":
        assert texe.trace == jexe.trace
        assert [tm[k] for k in ("units", "max_lead", "window")] == [
            jm[k] for k in ("units", "max_lead", "window")]


def raised(fn, exc):
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


# ---------------------------------------------------------------------------
# parity and the uniform protocol (test_executor.py:52, :75)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_backend_parity_bitwise(backend):
    """stream (every tick) and run (the final state) of 7 steps."""
    pair = Pair("three_cell", backend)
    jticks = [s for s, _ in pair.jexe.stream(pair.js, 7)]
    tticks = [s for s, _ in pair.texe.stream(pair.ts, 7)]
    for j, t in zip(jticks, tticks, strict=True):
        assert_states(j, t)
    run = Pair("three_cell", backend)
    jres, tres = run.jexe.run(run.js, 7), run.texe.run(run.ts, 7)
    assert_states(jres.states, tres.states)
    assert_states(jticks[-1], tres.states)
    assert_ledgers(run.jexe, run.texe)


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_run_reports_and_metrics_uniform(backend):
    pair = Pair("three_cell", backend, key=1)
    jres, tres = pair.jexe.run(pair.js, 4), pair.texe.run(pair.ts, 4)
    assert isinstance(tres, tmiso.RunResult) and set(tres.reports) == {"a", "b", "c"}
    assert_states(jres.states, tres.states)
    assert_reports(jres.reports, tres.reports)
    m = pair.texe.metrics()
    assert m["backend"] == backend and m["steps"] == 4 and m["recoveries"] == []
    assert_ledgers(pair.jexe, pair.texe)


# ---------------------------------------------------------------------------
# compile() options and auto (test_executor.py:203-233, :264, :332)
# ---------------------------------------------------------------------------
def test_policies_option_applies_selective_replication():
    pair = Pair("three_cell", "host", levels={"a": 2})
    assert tuple(pair.ts["a"]["x"].shape) == (2, 8)  # replica axis
    cid = pair.texe.program.cell_id("a")
    strike = dict(step=2, cell_id=cid, replica=0, index=3, bit=20)
    jres = pair.jexe.run(pair.js, 5, faults=[fault(jmiso, **strike)])
    tres = pair.texe.run(pair.ts, 5, faults=[fault(tmiso, **strike)])
    assert_states(jres.states, tres.states)
    assert_reports(jres.reports, tres.reports)
    m = pair.texe.metrics()
    assert m["fault_totals"]["a"]["events"] == 1.0 and m["recoveries"] == [(2, "a")]
    assert_ledgers(pair.jexe, pair.texe)


def test_auto_resolves_like_jax():
    cases = [("three_cell", {}, "wavefront"), ("chain", {}, "lockstep"),
             ("three_cell", {"compare_every": 4}, "lockstep"),  # wavefront can't amortize
             ("chain", {"window": 8}, "lockstep"),  # a foreign hint is dropped
             ("three_cell", {"compare_every": 4, "window": 8}, "lockstep"),
             ("three_cell", {"window": 8}, "wavefront")]
    for name, kw, want in cases:
        jp, tp = programs(name)
        jexe = jmiso.compile(jp, backend="auto", **kw)
        texe = tmiso.compile(tp, backend="auto", device="cpu", **kw)
        assert texe.name == jexe.name == want, (name, kw)
        if want == "wavefront":
            assert texe.window == jexe.window == kw.get("window", 4)
            assert len(texe.program.graph().independent_groups()) == 2
    assert tmiso.available_backends() == ["host", "lockstep", "lockstep_cuda", "wavefront"]
    # named explicitly, a foreign option is an error, as in JAX
    jp, tp = programs("chain")
    with pytest.raises(TypeError):
        jmiso.compile(jp, backend="lockstep", window=8)
    with pytest.raises(TypeError):
        tmiso.compile(tp, backend="lockstep", device="cpu", window=8)
    # JAX's jit= has no meaning for eager torch: the port's host takes none
    with pytest.raises(TypeError):
        tmiso.compile(tp, backend="host", device="cpu", jit=False)


def test_host_takes_a_ledger():
    ledger = tmiso.FaultLedger(threshold=1)
    pair = Pair("dmr", "host")
    texe = tmiso.compile(programs("dmr")[1], backend="host", device="cpu", ledger=ledger)
    texe.run(pair.ts, 4, faults=[fault(tmiso, step=1, cell_id=0, replica=1, index=2, bit=21)])
    assert texe.ledger is ledger and ledger.flagged == {"a"}


# ---------------------------------------------------------------------------
# stream on every back-end (test_executor.py:374-515)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_stream_resumes_midway_on_every_backend(backend):
    pair = Pair("three_cell", backend)
    states, texe = pair.ts, pair.texe
    it = texe.stream(states)
    for _ in range(3):
        states, _ = next(it)
    it.close()
    it2 = texe.stream(states)  # resumes at the executor's internal step counter
    for _ in range(4):
        states, _ = next(it2)
    it2.close()
    assert_states(pair.jexe.run(pair.js, 7).states, states)
    assert texe.metrics()["steps"] == 7


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_stream_ledger_attribution_parity(backend):
    """A DMR strike observed through stream lands on JAX's ledger step with
    JAX's totals; host also recovers, as JAX's does."""
    pair = Pair("dmr", backend)
    strike = dict(step=2, cell_id=0, replica=1, index=3, bit=21)
    for jstates, _ in pair.jexe.stream(pair.js, 5, start_step=0, faults=fault(jmiso, **strike)):
        pass
    for tstates, _ in pair.texe.stream(pair.ts, 5, start_step=0, faults=fault(tmiso, **strike)):
        pass
    assert_states(jstates, tstates)
    assert_ledgers(pair.jexe, pair.texe)
    assert pair.texe.ledger.recent["a"][0] == 2
    if backend == "host":
        assert pair.texe.recoveries == [(2, "a")]  # §IV tie-break ran
        assert pair.texe.ledger.totals["a"]["events"] == 1.0  # and re-synced


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_stream_compare_every_contract(backend):
    jp, tp = programs("chain")
    if backend in ("host", "wavefront"):
        jmsg = raised(lambda: jmiso.compile(jp, backend=backend, compare_every=4), ValueError)
        tmsg = raised(lambda: tmiso.compile(tp, backend=backend, device="cpu", compare_every=4),
                      ValueError)
        assert tmsg == jmsg and "compare_every" in tmsg
        return
    pair = Pair("chain", backend, compare_every=4)
    ticks = [s for s, _ in pair.texe.stream(pair.ts, 8, start_step=0)]
    assert len(ticks) == 2 and pair.texe.metrics()["steps"] == 8
    assert_states(pair.jexe.run(pair.js, 8, start_step=0).states, ticks[-1])


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_stream_swap_hook_swaps_state_between_ticks(backend):
    pair = Pair("chain", backend)
    seen = []

    def swap(m, t, st):
        seen.append(t)
        if t == 1:  # swap-in: overwrite cell a's state before tick 1
            st = dict(st)
            st["a"] = {"x": jnp.float32(100.0) if m is jmiso else torch.tensor(100.0)}
            return st
        return None

    jout = [s for s, _ in pair.jexe.stream(pair.js, 3, start_step=0,
                                           swap=lambda t, st: swap(jmiso, t, st))]
    tout = [s for s, _ in pair.texe.stream(pair.ts, 3, start_step=0,
                                           swap=lambda t, st: swap(tmiso, t, st))]
    assert seen == [0, 1, 2, 0, 1, 2]
    for j, t in zip(jout, tout, strict=True):
        assert_states(j, t)
    assert float(tout[1]["a"]["x"]) == 101.0


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_stream_checkpoints_on_every_backend(backend):
    snaps = {"jax": [], "torch": []}
    pair = Pair("three_cell", backend, checkpoint_every=2)
    pair.jexe.checkpoint_cb = lambda t, st: snaps["jax"].append((t, float(st["c"]["x"])))
    pair.texe.checkpoint_cb = lambda t, st: snaps["torch"].append((t, float(st["c"]["x"])))
    for _ in pair.jexe.stream(pair.js, 4, start_step=0):
        pass
    for _ in pair.texe.stream(pair.ts, 4, start_step=0):
        pass
    assert snaps["torch"] == snaps["jax"]
    assert [t for t, _ in snaps["torch"]] == [0, 2] and snaps["torch"][0][1] == 1.0


# ---------------------------------------------------------------------------
# what the wavefront refuses (test_executor.py:517, :549, :600)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("call", ["run_checkpointed", "run_collect", "pure_step",
                                  "run_campaign", "run_two_faults"])
def test_wavefront_refuses_with_jax_reasons(call):
    kw = {"checkpoint_every": 2} if call == "run_checkpointed" else {}
    pair = Pair("three_cell", "wavefront", **kw)
    msgs = []
    for m, exe, states in ((jmiso, pair.jexe, pair.js), (tmiso, pair.texe, pair.ts)):
        exe.checkpoint_cb = (lambda t, st: None) if kw else None
        calls = {
            "run_checkpointed": (lambda: exe.run(states, 4), ValueError),
            "run_collect": (lambda: exe.run(states, 4, collect=lambda st: st), ValueError),
            "pure_step": (lambda: exe.pure_step(states, 0), NotImplementedError),
            "run_campaign": (lambda: exe.run_campaign(states, 2, [fault(m, step=0, cell_id=0)]),
                             NotImplementedError),
            "run_two_faults": (lambda: exe.run(states, 4, faults=[fault(m, step=0, cell_id=0),
                                                                  fault(m, step=1, cell_id=0)]),
                               ValueError),
        }
        msgs.append(raised(*calls[call]))
    assert msgs[1] == msgs[0]
    assert {"run_checkpointed": "consistent cut", "run_collect": "collect", "pure_step": "replay",
            "run_campaign": "replay", "run_two_faults": "single FaultSpec"}[call] in msgs[1]


def test_ledger_step_attribution_on_wavefront():
    pair = Pair("three_cell", "wavefront", levels={"a": 3})
    strike = dict(step=2, cell_id=0, replica=0, bit=20)
    jres = pair.jexe.run(pair.js, 5, faults=fault(jmiso, **strike))
    tres = pair.texe.run(pair.ts, 5, faults=fault(tmiso, **strike))
    assert_states(jres.states, tres.states)
    assert_reports(jres.reports, tres.reports)
    assert pair.texe.metrics()["fault_totals"]["a"]["events"] == 1.0
    assert pair.texe.ledger.recent["a"] == [2]
    assert_ledgers(pair.jexe, pair.texe)
    # a resumed run counts steps on from the executor's counter
    strike["step"] = 7
    jres = pair.jexe.run(jres.states, 4, faults=fault(jmiso, **strike))
    tres = pair.texe.run(tres.states, 4, faults=fault(tmiso, **strike))
    assert_states(jres.states, tres.states)
    assert pair.texe.ledger.recent["a"] == [2, 7]
    assert_ledgers(pair.jexe, pair.texe)


def test_wavefront_window_bounds_the_lead_of_a_producer():
    """A chain (a -> b) is one independent group but two SCC units: the
    producer runs ahead of its consumer by at most ``window`` steps."""
    for window in (1, 3):
        pair = Pair("chain", "wavefront", window=window)
        jres, tres = pair.jexe.run(pair.js, 9), pair.texe.run(pair.ts, 9)
        assert_states(jres.states, tres.states)
        assert_ledgers(pair.jexe, pair.texe)
        assert 0 < pair.texe.max_lead() <= window


# ---------------------------------------------------------------------------
# pure_step and run_campaign (test_executor.py:526, :558-607)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", REPLAY_BACKENDS)
def test_pure_step_replays_without_side_effects(backend):
    pair = Pair("dmr", backend)
    texe, states = pair.texe, pair.ts
    strike = dict(step=0, cell_id=0, replica=1, index=3, bit=21)
    replay, rep = texe.pure_step(states, 0, fault(tmiso, **strike))
    jreplay, jrep = pair.jexe.pure_step(pair.js, 0, fault(jmiso, **strike))
    assert_states(jreplay, replay)
    assert_reports(jrep, rep)
    assert texe.metrics()["steps"] == 0 and texe.ledger.totals == {}
    replay, _ = texe.pure_step(states, 0)
    stepped, _ = texe.step(states, step_idx=0)
    assert_states(jax.tree.map(np.asarray, pair.jexe.pure_step(pair.js, 0)[0]), replay)
    assert all(torch.equal(a, b) for a, b in zip(tree.tree_leaves(replay), tree.tree_leaves(stepped)))
    assert texe.metrics()["steps"] == 1  # only step() advanced
    nocmp, rep = texe.pure_step(states, 0, fault(tmiso, **strike), compare=False)
    assert float(rep["a"]["events"]) == 0.0  # compare elided, reports zero


@pytest.mark.parametrize("backend", REPLAY_BACKENDS)
def test_run_campaign_matches_jax_and_sequential_runs(backend):
    """N FaultSpecs -> a leading campaign axis, bitwise JAX's campaign
    (vmapped on its lock-step flavours, a pure_step loop on host) and the
    port's N sequential runs, with no ledger entries and no counter
    advance."""
    pair = Pair("dmr", backend)
    specs = [dict(step=s, cell_id=0, replica=r, index=3, bit=21)
             for s, r in ((1, 0), (3, 1), (9, 0))]  # the last never fires
    jcamp = pair.jexe.run_campaign(pair.js, 6, [fault(jmiso, **f) for f in specs], start_step=0)
    camp = pair.texe.run_campaign(pair.ts, 6, [fault(tmiso, **f) for f in specs], start_step=0)
    assert pair.texe.metrics()["steps"] == 0 and pair.texe.ledger.totals == {}
    assert_states(jcamp.states, camp.states)
    assert_reports(jcamp.reports, camp.reports)
    seq = []
    for f in specs:
        ref = tmiso.compile(programs("dmr")[1], backend="lockstep", device="cpu")
        seq.append(ref.run(pair.ts, 6, start_step=0, faults=fault(tmiso, **f)).states)
    stacked = tree.tree_map(lambda *xs: torch.stack(xs), *seq)
    assert all(torch.equal(a, b) for a, b in
               zip(tree.tree_leaves(camp.states), tree.tree_leaves(stacked)))
    assert camp.reports["a"]["events"].tolist() == [5.0, 3.0, 0.0]  # divergence persists (DMR)


def test_run_campaign_collect_and_errors():
    pair = Pair("dmr", "lockstep")
    specs = [dict(step=0, cell_id=0, bit=20), dict(step=2, cell_id=0, bit=20)]
    jres = pair.jexe.run_campaign(pair.js, 4, [fault(jmiso, **f) for f in specs], start_step=0,
                                  collect=lambda st: st["c"]["x"])
    res = pair.texe.run_campaign(pair.ts, 4, [fault(tmiso, **f) for f in specs], start_step=0,
                                 collect=lambda st: st["c"]["x"])
    assert tuple(res.collected.shape) == (2, 4)  # (campaign, step)
    assert_states(jres.collected, res.collected)
    msgs = [raised(lambda: e.run_campaign(s, 4, [], start_step=0), ValueError)
            for e, s in ((pair.jexe, pair.js), (pair.texe, pair.ts))]
    assert msgs[1] == msgs[0] and "at least one" in msgs[1]
    e4 = tmiso.compile(programs("dmr")[1], device="cpu", compare_every=4)
    with pytest.raises(ValueError, match="multiple of compare_every"):
        e4.run_campaign(pair.ts, 6, [fault(tmiso, **specs[0])], start_step=0)


# ---------------------------------------------------------------------------
# the §IV tie-break
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 3])
def test_host_tiebreak_recovers_jax_states(step):
    """A DMR strike under host: the third transition reads the unreplicated
    source and its own replicas' canonical view; the repaired states,
    reports, recoveries and ledger equal JAX's, and the final states equal
    an unstruck run's."""
    pair = Pair("mixed", "host")
    strike = dict(step=step, cell_id=1, replica=1, leaf=0, index=5, bit=30)
    jres = pair.jexe.run(pair.js, 6, start_step=0, faults=[fault(jmiso, **strike)])
    tres = pair.texe.run(pair.ts, 6, start_step=0, faults=[fault(tmiso, **strike)])
    assert_states(jres.states, tres.states)
    assert_reports(jres.reports, tres.reports)
    assert pair.texe.recoveries == pair.jexe.recoveries == [(step, "d")]
    assert_ledgers(pair.jexe, pair.texe)
    clean = tmiso.compile(programs("mixed")[1], backend="host", device="cpu")
    cres = clean.run(pair.ts, 6, start_step=0)
    assert all(torch.equal(bitcast_int(a), bitcast_int(b)) for a, b in
               zip(tree.tree_leaves(cres.states), tree.tree_leaves(tres.states)))


def test_make_tiebreak_outvotes_the_struck_replica_like_jax():
    from repro.core.redundancy import make_tiebreak as jax_tiebreak
    from repro_torch.core.redundancy import make_tiebreak

    jp, tp = programs("mixed")
    pair = Pair("mixed", "host")
    jnew = pair.jexe.pure_step(pair.js, 0)[0]
    bad = tree.tree_map(lambda x: x.clone(), to_torch(jnew)["d"])
    bad["x"][1, 7] = -bad["x"][1, 7]
    bad["n"][0, 2] ^= 1 << 9  # the struck replica may be either one
    jbad = jax.tree.map(jnp.asarray, bridge.tree_to_numpy(bad))
    jfix = jax_tiebreak(jp.cells["d"], jp.levels())(pair.js, jbad)
    fix = make_tiebreak(tp.cells["d"], tp.levels())(pair.ts, bad)
    assert_states(jfix, fix)
    assert_states(jnew["d"], fix)


# ---------------------------------------------------------------------------
# on_event (executor.py:174-198, 282-298, 440-470 of the JAX package)
# ---------------------------------------------------------------------------
def events_of(backend, m, exe, states, strike, **kw):
    log = []
    exe.on_event = lambda name, attrs: log.append(
        (name, {k: v for k, v in attrs.items() if k not in TIMING}))
    exe.run(states, 6, start_step=0, faults=[fault(m, **strike)] if backend == "host"
            else fault(m, **strike), **kw)
    return log


@pytest.mark.parametrize("backend", ["host", "wavefront", "lockstep"])
def test_on_event_sequence_matches_jax(backend):
    ckpt = {} if backend == "wavefront" else {"checkpoint_every": 2}
    pair = Pair("dmr", backend, **ckpt)
    if ckpt:
        pair.jexe.checkpoint_cb = pair.texe.checkpoint_cb = lambda t, st: None
    strike = dict(step=2, cell_id=0, replica=1, index=3, bit=21)
    jlog = events_of(backend, jmiso, pair.jexe, pair.js, strike)
    tlog = events_of(backend, tmiso, pair.texe, pair.ts, strike)
    if backend == "lockstep":
        jlog = [e for e in jlog if e[0] != "scan_segment"]
        steps = [e for e in tlog if e[0] == "step"]
        assert [e[1]["step"] for e in steps] == list(range(6))
        tlog = [e for e in tlog if e[0] != "step"]
    assert tlog == jlog
    names = {e[0] for e in tlog}
    assert "compare_mismatch" in names
    assert ("dmr_recovery" in names) == (backend == "host")
    assert ("unit_step" in names) == (backend == "wavefront")


def test_on_event_none_is_free_and_events_carry_timings():
    """With no hook the run reads no clock; with one, a step's duration is
    its dispatch plus its device time, and a Tracer records the events."""
    import time as _time

    pair = Pair("dmr", "host")
    calls = [0]
    real = _time.perf_counter

    def counting():
        calls[0] += 1
        return real()

    _time.perf_counter = counting
    try:
        pair.texe.run(pair.ts, 3, start_step=0)
    finally:
        _time.perf_counter = real
    assert calls[0] == 0
    tracer = tmiso.Tracer()
    exe = tmiso.compile(programs("dmr")[1], backend="host", device="cpu",
                        on_event=tracer.executor_hook())
    exe.run(pair.ts, 3, start_step=0,
            faults=[fault(tmiso, step=1, cell_id=0, replica=1, index=3, bit=21)])
    evs = [e for e in tracer.events() if e["ph"] != "M"]
    assert [e["name"] for e in evs] == ["step", "compare_mismatch", "dmr_recovery", "step", "step"]
    step = evs[0]
    assert step["ph"] == "X" and step["args"]["dispatch_us"] + step["args"]["device_us"] == \
        pytest.approx(step["dur"])
