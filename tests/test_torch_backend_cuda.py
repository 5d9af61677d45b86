"""The port's fused lock-step back-end ``lockstep_cuda`` on the CPU (its
kernels' plain versions) held BITWISE against the JAX package's
``lockstep_pallas`` (Pallas kernels in interpret mode): the same
program, the same initial states (carried over through
``repro_torch.bridge``) and the same armed strike give the same states,
summed reports, ``ledger.recent`` and fault totals.  Transitions scale
by powers of two only, so XLA's fused multiply-add and torch's separate
ops round alike.  Also: the word-granular counts on packed leaves, the
paper's image blend (Listing 1) as the slice as a whole, and
``backend="auto"``."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import api as jmiso
from repro_torch import api as tmiso
from repro_torch import bridge, tree
from repro_torch.core.fault import bitcast_int
from repro_torch.kernels import fused_step as tfs
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def pol(m, level, compare):
    return m.RedundancyPolicy(level=level, compare=compare)


def jax_replicated(level, compare):
    """The program of ``tests/test_executor.py::replicated_program``."""
    p = jmiso.MisoProgram()
    p.add(jmiso.CellType(
        "a", lambda k: {"x": jnp.linspace(0.0, 1.0, 8, dtype=jnp.float32)},
        lambda prev: {"x": prev["a"]["x"] * 0.5 + jnp.roll(prev["a"]["x"], 1) * 0.25},
        redundancy=pol(jmiso, level, compare)))
    p.add(jmiso.CellType(
        "b", lambda k: {"x": jnp.ones((8,), jnp.float32)},
        lambda prev: {"x": prev["b"]["x"] * 0.5 + prev["a"]["x"] * 2.0},
        reads=("a",)))
    return p


def torch_replicated(level, compare):
    p = tmiso.MisoProgram()
    p.add(tmiso.CellType(
        "a", lambda g, d: {"x": torch.linspace(0.0, 1.0, 8, device=d)},
        lambda prev: {"x": prev["a"]["x"] * 0.5 + torch.roll(prev["a"]["x"], 1) * 0.25},
        redundancy=pol(tmiso, level, compare)))
    p.add(tmiso.CellType(
        "b", lambda g, d: {"x": torch.ones(8, device=d)},
        lambda prev: {"x": prev["b"]["x"] * 0.5 + prev["a"]["x"] * 2.0},
        reads=("a",)))
    return p


class Pair:
    """A JAX ``lockstep_pallas`` executor and a port executor with the same
    initial states (the JAX program's, carried over)."""

    def __init__(self, jprog, tprog, compare_every=None, backend="lockstep_cuda"):
        self.jexe = jmiso.compile(jprog, backend="lockstep_pallas", donate=False,
                                  compare_every=compare_every)
        self.texe = tmiso.compile(tprog, backend=backend, device="cpu", compare_every=compare_every)
        self.jstates = self.jexe.init(jax.random.PRNGKey(0))
        self.tstates = bridge.states_from_numpy(jax.tree.map(np.asarray, self.jstates), device="cpu")

    def run(self, steps, fault=None):
        """Both executors from the initial states; (JAX result, port result)."""
        jf = None if fault is None else jmiso.FaultSpec.at(**fault)
        tf = None if fault is None else tmiso.FaultSpec.at(**fault)
        return (self.jexe.run(self.jstates, steps, start_step=0, faults=jf),
                self.texe.run(self.tstates, steps, start_step=0, faults=tf))


def run_pair(jprog, tprog, steps, fault=None, compare_every=None, backend="lockstep_cuda"):
    pair = Pair(jprog, tprog, compare_every, backend)
    jres, tres = pair.run(steps, fault)
    return jres, pair.jexe, tres, pair.texe


def assert_same_states(jstates, tstates):
    jl, tl = jax.tree.leaves(jstates), tree.tree_leaves(tstates)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        ref = bridge.states_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]
        assert ref.shape == b.shape and ref.dtype == b.dtype
        assert torch.equal(bitcast_int(ref), bitcast_int(b))


def assert_same_reports_and_ledger(jres, jexe, tres, texe):
    assert set(jres.reports) == set(tres.reports)
    for cell in jres.reports:
        for key in ("mismatch_elems", "events", "per_replica"):
            np.testing.assert_array_equal(np.asarray(jres.reports[cell][key], np.float32),
                                          np.asarray(tres.reports[cell][key], np.float32))
    assert texe.ledger.recent == jexe.ledger.recent
    assert texe.metrics()["fault_totals"] == jexe.metrics()["fault_totals"]


STRIKE = dict(step=2, cell_id=0, replica=1, index=3, bit=21)


@pytest.mark.parametrize("compare_every", [1, 4])
@pytest.mark.parametrize("compare", ["bitwise", "hash"])
@pytest.mark.parametrize("level", [2, 3], ids=["dmr", "tmr"])
def test_lockstep_cuda_bitwise_equals_lockstep_pallas(level, compare, compare_every):
    """8 steps clean, then 8 steps with the strike, on the same executors."""
    pair = Pair(jax_replicated(level, compare), torch_replicated(level, compare), compare_every)
    jexe, texe = pair.jexe, pair.texe
    jres, tres = pair.run(8)
    assert_same_states(jres.states, tres.states)
    assert_same_reports_and_ledger(jres, jexe, tres, texe)
    assert texe.metrics()["fault_totals"]["a"]["events"] == 0
    jres, tres = pair.run(8, STRIKE)
    assert_same_states(jres.states, tres.states)
    assert_same_reports_and_ledger(jres, jexe, tres, texe)
    m = texe.metrics()
    assert m["backend"] == "lockstep_cuda" and m["interpret"] is True and m["steps"] == 8
    events = m["fault_totals"]["a"]["events"]
    if level == 2:  # DMR: the replicas stay apart from the window of the strike on
        assert events == 8 // compare_every - (2 // compare_every)
    elif compare_every == 1:  # TMR: voted away at once
        assert events == 1 and m["fault_totals"]["a"]["per_replica"] == [0.0, 1.0, 0.0]
    else:  # ... on a sub-step without a compare, where the counters are zeroed
        assert events == 0


def packed_programs():
    """One DMR cell of bf16, int8 and bool leaves whose transitions spread a
    difference to the next element each step, so several differing
    elements come to share a u32 word."""
    rng = np.random.default_rng(11)
    h = rng.normal(size=(6,)).astype(ml_dtypes.bfloat16)
    i = rng.integers(-100, 100, size=(9,)).astype(np.int8)
    q = rng.integers(0, 2, size=(7,)).astype(bool)
    dmr = dict(redundancy=pol(jmiso, 2, "bitwise"))
    jp = jmiso.MisoProgram().add(jmiso.CellType(
        "m", lambda k: {"h": jnp.asarray(h), "i": jnp.asarray(i), "q": jnp.asarray(q)},
        lambda prev: {"h": prev["m"]["h"] * 0.5 + jnp.roll(prev["m"]["h"], 1) * 0.25,
                      "i": prev["m"]["i"] + jnp.roll(prev["m"]["i"], 1),
                      "q": prev["m"]["q"] ^ jnp.roll(prev["m"]["q"], 1)}, **dmr))
    tp = tmiso.MisoProgram().add(tmiso.CellType(
        "m", lambda g, d: None,
        lambda prev: {"h": prev["m"]["h"] * 0.5 + torch.roll(prev["m"]["h"], 1) * 0.25,
                      "i": prev["m"]["i"] + torch.roll(prev["m"]["i"], 1),
                      "q": prev["m"]["q"] ^ torch.roll(prev["m"]["q"], 1)},
        redundancy=pol(tmiso, 2, "bitwise")))
    return jp, tp


def test_packed_leaves_count_words_like_lockstep_pallas():
    """Leaf 1 (int8, keys sorted) is struck; the difference spreads to the
    neighbouring bytes of the same words.  lockstep_cuda counts the words,
    as lockstep_pallas does; the port's lockstep counts elements; all
    three see the same events."""
    jp, tp = packed_programs()
    fault = dict(step=1, cell_id=0, replica=1, leaf=1, index=2, bit=3)
    jres, jexe, tres, texe = run_pair(jp, tp, 6, fault)
    assert_same_states(jres.states, tres.states)
    assert_same_reports_and_ledger(jres, jexe, tres, texe)
    _, _, eres, eexe = run_pair(jp, tp, 6, fault, backend="lockstep")
    words, elems = (e.metrics()["fault_totals"]["m"] for e in (texe, eexe))
    assert words["events"] == elems["events"] == 5
    assert words["elems"] < elems["elems"]


def blend_programs(level, compare="bitwise", W=64, H=32):
    """Paper Listing 1 at a small size: ImageBlend {r, g, b} reads the
    unreplicated StaticImage; c = 0.5 c + 0.25 StaticImage.c (power-of-two
    coefficients for a bitwise cross-framework check)."""
    rng = np.random.default_rng(12)
    img1 = {k: (rng.random(W * H) * 255).astype(np.float32) for k in "rgb"}
    img2 = {k: (rng.random(W * H) * 255).astype(np.float32) for k in "rgb"}
    jp = jmiso.MisoProgram()
    jp.add(jmiso.CellType(
        "ImageBlend", lambda k: {c: jnp.asarray(v) for c, v in img1.items()},
        lambda prev: {c: prev["ImageBlend"][c] * 0.5 + prev["StaticImage"][c] * 0.25 for c in "rgb"},
        reads=("StaticImage",), redundancy=pol(jmiso, level, compare)))
    jp.add(jmiso.CellType("StaticImage", lambda k: {c: jnp.asarray(v) for c, v in img2.items()},
                          lambda prev: prev["StaticImage"]))
    tp = tmiso.MisoProgram()
    tp.add(tmiso.CellType(
        "ImageBlend", lambda g, d: None,
        lambda prev: {c: prev["ImageBlend"][c] * 0.5 + prev["StaticImage"][c] * 0.25 for c in "rgb"},
        reads=("StaticImage",), redundancy=pol(tmiso, level, compare)))
    tp.add(tmiso.CellType("StaticImage", lambda g, d: None, lambda prev: prev["StaticImage"]))
    return jp, tp


@pytest.mark.parametrize("compare", ["bitwise", "hash"])
@pytest.mark.parametrize("level", [2, 3], ids=["dmr", "tmr"])
def test_image_blend_under_dmr_tmr_equals_jax(level, compare):
    jp, tp = blend_programs(level, compare)
    # replica 1, leaf 0 ("b": keys sorted), a mid-image pixel, bit 30
    fault = dict(step=3, cell_id=0, replica=1, leaf=0, index=64 * 16 + 32, bit=30)
    tfs.dmr_compare.launches = tfs.tmr_step.launches = 0
    pair = Pair(jp, tp)
    jres, tres = pair.run(8, fault)
    assert tfs.dmr_compare.launches == tfs.tmr_step.launches == 0  # plain versions on the CPU
    assert_same_states(jres.states, tres.states)
    assert_same_reports_and_ledger(jres, pair.jexe, tres, pair.texe)
    assert pair.texe.ledger.recent["ImageBlend"][0] == 3
    if level == 3:  # corrected: the final states are the unstruck run's
        assert pair.texe.metrics()["fault_totals"]["ImageBlend"]["per_replica"] == [0.0, 1.0, 0.0]
        clean, tclean = pair.run(8)
        assert_same_states(clean.states, tres.states)
        assert_same_states(clean.states, tclean.states)


def test_auto_resolves_like_jax_off_the_card():
    jp, tp = blend_programs(2)
    jexe = jmiso.compile(jp, backend="auto")
    texe = tmiso.compile(tp, backend="auto", device="cpu")
    assert texe.name == jexe.name == "lockstep"


def two_unit_programs():
    """Two cells that read nothing of each other: two independent units."""
    progs = []
    for m, zeros in ((jmiso, lambda k: {"x": jnp.float32(0)}), (tmiso, lambda g, d: None)):
        p = m.MisoProgram()
        for name in ("u", "v"):
            p.add(m.CellType(name, zeros, lambda prev, n=name: {"x": prev[n]["x"] + 1}))
        progs.append(p)
    return progs


def test_auto_resolves_like_jax_on_two_units():
    jp, tp = two_unit_programs()
    assert jmiso.compile(jp, backend="auto").name == "wavefront"
    assert tmiso.compile(tp, backend="auto", device="cpu").name == "wavefront"
    # compare_every > 1: JAX keeps a lock-step back-end, and so does the port
    assert jmiso.compile(jp, backend="auto", compare_every=2).name == "lockstep"
    assert tmiso.compile(tp, backend="auto", device="cpu", compare_every=2).name == "lockstep"


def test_auto_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        assert tmiso.compile(blend_programs(2)[1], backend="auto").name == "lockstep_cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            tmiso.compile(blend_programs(2)[1], backend="auto")
