"""The port's MISO language front end (``repro_torch.core.ir``) on the CPU,
held BITWISE against the JAX package's ``repro.core.ir``: the cases of
``tests/test_ir.py`` (parse, dependencies, stencil, MIMD, the three
rejections, read-prev, int truncation), then the paper's Listing 1 at
300 x 200 with seeded integer images for 40 steps under none, DMR and TMR
(a strike in the protected image).  Both packages build their initial
states from the same numpy inputs, so the states are compared from step 0
on.  XLA may fuse a multiply-add into one rounding where torch rounds
twice; no case here shows a difference, so none is held at a tolerance."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as jmiso
from repro.core import MisoSemanticsError as JaxSemanticsError
from repro.core import ir as jir
from repro_torch import api as tmiso
from repro_torch import tree
from repro_torch.core import ir as tir
from repro_torch.core.cell import MisoSemanticsError
from repro_torch.core.fault import bitcast_int
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ROD = """
cell Rod {
  var t: Float = 0;
  transition {
    let left = rod(this.pos - 1).t;
    let right = rod(this.pos + 1).t;
    t = t + 0.25 * (left - 2*t + right);
  }
}
rod = new Rod(64)
"""

PING_PONG = """
cell Ping {
  var v: Float = 1;
  transition { v = pong(this.pos).v + 1; }
}
cell Pong {
  var v: Float = 0;
  transition { v = ping(this.pos).v * 2; }
}
ping = new Ping(4)
pong = new Pong(4)
"""

READ_PREV = """
cell A { var x: Float = 0; transition { x = x + 1; } }
cell B { var y: Float = 0; transition { y = a(this.pos).x; } }
a = new A(1)
b = new B(1)
"""

TRUNCATE = "cell C { var x: Int = 0; transition { x = x + 1.9; } }\nc = new C(1)"


def compile_both(src, inputs=None, backend="lockstep", policies=None, **kw):
    """(JAX executor, JAX initial states, port executor, port initial states)."""
    jprog, tprog = jir.compile_source(src, inputs), tir.compile_source(src, inputs)
    jpol = {k: jmiso.RedundancyPolicy(level=v) for k, v in (policies or {}).items()}
    tpol = {k: tmiso.RedundancyPolicy(level=v) for k, v in (policies or {}).items()}
    jexe = jmiso.compile(jprog, backend="lockstep", donate=False, policies=jpol, **kw)
    texe = tmiso.compile(tprog, backend=backend, device="cpu", policies=tpol, **kw)
    return jexe, jexe.init(jax.random.PRNGKey(0)), texe, texe.init(0)


def assert_bitwise(jstates, tstates):
    jl, tl = jax.tree.leaves(jstates), tree.tree_leaves(tstates)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert tuple(a.shape) == tuple(b.shape) and str(a.dtype) == str(b.dtype).removeprefix("torch.")
        diff = np.flatnonzero(a.reshape(-1) != b.numpy().reshape(-1))
        assert diff.size == 0, (f"{diff.size} elements differ, first at {diff[0]}: "
                                f"JAX {a.reshape(-1)[diff[0]]!r}, port {b.reshape(-1)[diff[0]]!r}")


def run_both(src, steps, inputs=None, **kw):
    jexe, js, texe, ts = compile_both(src, inputs, **kw)
    assert_bitwise(js, ts)  # the initial states too
    jres, tres = jexe.run(js, steps, start_step=0), texe.run(ts, steps, start_step=0)
    assert_bitwise(jres.states, tres.states)
    return tres.states


def asdict(node):
    return dataclasses.asdict(node) if dataclasses.is_dataclass(node) else node


def test_parse_listing1():
    cells, insts = tir.parse(tir.LISTING_1)
    assert [c.name for c in cells] == ["ImageBlend", "StaticImage"]
    assert {i.name: i.cell for i in insts} == {"image1": "ImageBlend", "image2": "StaticImage"}
    assert [v.name for v in cells[0].slots] == ["r", "g", "b"] and len(cells[0].body) == 3
    # the same AST as the JAX package's, node for node
    jcells, jinsts = jir.parse(jir.LISTING_1)
    assert [asdict(c) for c in cells] == [asdict(c) for c in jcells]
    assert [asdict(i) for i in insts] == [asdict(i) for i in jinsts]
    assert tir.LISTING_1 == jir.LISTING_1


def test_dependencies_extracted_from_transition_expressions():
    prog = tir.compile_source(tir.LISTING_1)
    assert prog.cells["image1"].reads == ("image2",)
    assert prog.cells["image2"].reads == ()
    jprog = jir.compile_source(jir.LISTING_1)
    for src in (tir.LISTING_1, ROD, PING_PONG, READ_PREV):
        jp, tp = jir.compile_source(src), tir.compile_source(src)
        assert {n: c.reads for n, c in tp.cells.items()} == {n: c.reads for n, c in jp.cells.items()}
        assert {n: c.instances for n, c in tp.cells.items()} == {
            n: c.instances for n, c in jp.cells.items()}
    assert prog.graph().independent_groups() == jprog.graph().independent_groups()


def test_stencil_heat_diffusion():
    init = np.zeros(64, np.float32)
    init[32] = 100.0
    t = run_both(ROD, 200, inputs={"rod": {"t": init}})["rod"]["t"].numpy()
    assert t[32] < 100.0 and t[20] > 0.0  # heat spread
    assert abs(t.sum() - 100.0) < 1.0  # conserved (clip edges ok)
    assert np.all(np.diff(t[32:50]) <= 1e-4)  # monotone away from peak


def test_stencil_at_4096_random_cells_bitwise():
    init = np.random.default_rng(0).random(4096).astype(np.float32)
    src = ROD.replace("Rod(64)", "Rod(4096)")
    run_both(src, 50, inputs={"rod": {"t": init}})


def test_two_cell_types_mimd():
    prog = tir.compile_source(PING_PONG)
    assert set(prog.graph().sccs()[0]) == {"ping", "pong"}  # mutual reads -> one SCC
    final = run_both(PING_PONG, 3)
    assert final["ping"]["v"][0] == 3.0 and final["pong"]["v"][0] == 6.0


def port_error(src):
    """The port raises a transition's semantics error when it runs (it has
    no ``validate()`` yet); JAX's ``validate()`` raises the same text."""
    exe = tmiso.compile(tir.compile_source(src), device="cpu")
    with pytest.raises(MisoSemanticsError) as err:
        exe.step(exe.init(0))
    return str(err.value)


@pytest.mark.parametrize("src", [
    "cell C { var x: Float = 0; transition { x = 1; x = 2; } }\nc = new C(2)",
    "cell C { var x: Float = 0; transition { y = 1; } }\nc = new C(2)",
], ids=["double_write", "write_to_undeclared_slot"])
def test_bad_writes_rejected_with_jax_text(src):
    with pytest.raises(JaxSemanticsError) as jerr:
        jir.compile_source(src).validate()
    assert port_error(src) == str(jerr.value)


def test_read_of_unknown_instance_rejected():
    src = "cell C { var x: Float=0; transition { x = ghost(this.pos).x; } }\nc = new C(2)"
    with pytest.raises(JaxSemanticsError) as jerr:
        jir.compile_source(src)
    with pytest.raises(MisoSemanticsError) as err:
        tir.compile_source(src)
    assert str(err.value) == str(jerr.value)


def test_bound_input_of_the_wrong_shape_rejected():
    inputs = {"rod": {"t": np.zeros(63, np.float32)}}
    with pytest.raises(ValueError) as jerr:
        jir.compile_source(ROD, inputs).init_states(jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as err:
        tmiso.compile(tir.compile_source(ROD, inputs), device="cpu").init(0)
    assert str(err.value) == str(jerr.value)


def test_reads_are_previous_state_in_dsl():
    s1 = run_both(READ_PREV, 1)
    assert s1["a"]["x"][0] == 1.0 and s1["b"]["y"][0] == 0.0
    assert run_both(READ_PREV, 2)["b"]["y"][0] == 1.0


def test_int_truncation_semantics():
    final = run_both(TRUNCATE, 3)
    assert final["c"]["x"].dtype == torch.int32
    assert int(final["c"]["x"][0]) == 3  # 0->1->2->3 (truncating adds)


def listing1_inputs(W=300, H=200):
    rng = np.random.default_rng(0)
    return {img: {c: rng.integers(0, 256, W * H).astype(np.int32) for c in "rgb"}
            for img in ("image1", "image2")}


@pytest.mark.parametrize("level", [1, 2, 3], ids=["none", "dmr", "tmr"])
def test_listing1_300x200_int_slots_bitwise(level):
    """40 steps of Listing 1 with Int slots, as declared; under DMR and TMR
    a bit of image1.r in replica 1 flips at step 20 (the centre pixel).
    The port runs ``lockstep_cuda`` (the kernels' plain versions here),
    the back-end ``auto`` picks on a card."""
    policies = {"image1": level} if level > 1 else None
    jexe, js, texe, ts = compile_both(tir.LISTING_1, listing1_inputs(), backend="lockstep_cuda",
                                      policies=policies)
    assert_bitwise(js, ts)
    strike = dict(step=20, cell_id=0, replica=1, leaf=2, index=100 * 300 + 150, bit=3)
    faults = (jmiso.FaultSpec.at(**strike), tmiso.FaultSpec.at(**strike)) if level > 1 else (None, None)
    jres = jexe.run(js, 40, start_step=0, faults=faults[0])
    tres = texe.run(ts, 40, start_step=0, faults=faults[1])
    assert_bitwise(jres.states, tres.states)
    assert texe.ledger.recent == jexe.ledger.recent
    assert texe.metrics()["fault_totals"] == jexe.metrics()["fault_totals"]
    r = tres.states["image1"]["r"]
    assert r.dtype == torch.int32 and int(r.min()) >= 0 and int(r.max()) <= 255
    if level == 2:
        assert texe.ledger.recent["image1"][0] == 20
    if level == 3:
        assert texe.ledger.recent["image1"] == [20]
        assert texe.metrics()["fault_totals"]["image1"]["per_replica"] == [0.0, 1.0, 0.0]
        clean = texe.run(ts, 40, start_step=0).states
        assert all(torch.equal(bitcast_int(a), bitcast_int(b)) for a, b in
                   zip(tree.tree_leaves(clean), tree.tree_leaves(tres.states)))
