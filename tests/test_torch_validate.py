"""``MisoProgram.validate`` / ``state_specs`` / ``unreplicated_specs`` and
``cell.check_single_output`` / ``state_spec`` against the JAX package:
the specs leaf for leaf (a DMR and a TMR program); ``validate`` raises
``MisoSemanticsError`` where JAX's raises, naming the same cell (and leaf
index), on the programs of ``tests/test_system.py`` and
``tests/test_ir.py``, and passes where JAX's passes; it passes on the
reduced train program of every arch and on a paged slot serve program
whose decode step reaches ``paged_write_rows``' ``nonzero``; and it runs
nothing for real (fake tensors in, a 4 TB state validated, a write into
a real tensor refused and the tensor unchanged)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_reduced as jax_reduced
from repro.core import ir as jir
from repro.data.pipeline import DataConfig as JDataConfig
from repro.models import lm_cells as jlc
from repro.optim.adamw import OptConfig as JOptConfig
from repro_torch import api as miso
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.core import ir
from repro_torch.core.cell import ShapeDtype, check_single_output, state_spec
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import layers
from repro_torch.models import lm_cells as lc
from repro_torch.optim.adamw import OptConfig
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves

cap_threads_for_xdist()


def jax_specs(tree) -> list:
    return [(tuple(x.shape), np.dtype(x.dtype).name) for x in jax.tree.leaves(tree)]


def port_specs(tree) -> list:
    out = []
    for x in tree_leaves(tree):
        assert isinstance(x, ShapeDtype)
        out.append((tuple(x.shape), str(x.dtype).removeprefix("torch.")))
    return out


def train_programs(arch: str):
    """The reduced train program of ``arch`` in both packages, trainer
    under DMR."""
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    jt = jlc.TrainConfig(data=JDataConfig(batch=2, seq_len=8, vocab=jcfg.vocab_size,
                                          n_codebooks=jcfg.n_codebooks),
                         opt=JOptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=8))
    pt = lc.TrainConfig(data=DataConfig(batch=2, seq_len=8, vocab=cfg.vocab_size,
                                        n_codebooks=cfg.n_codebooks),
                        opt=OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=8))
    dmr = {"trainer": jcore.RedundancyPolicy(level=2)}
    return (jlc.make_train_program(jcfg, jt).with_policies(dmr),
            lc.make_train_program(cfg, pt).with_policies(
                {"trainer": miso.RedundancyPolicy(level=2)}))


def static_programs(level: int):
    """The fixed-batch serve program of reduced internlm2, decoder under
    ``level``."""
    scfg_j = jlc.ServeConfig(batch=2, max_len=16)
    scfg_p = lc.ServeConfig(batch=2, max_len=16)
    return (jlc.make_serve_program(jax_reduced("internlm2-1.8b"), scfg_j).with_policies(
                {"decoder": jcore.RedundancyPolicy(level=level)}),
            lc.make_serve_program(get_reduced("internlm2-1.8b"), scfg_p).with_policies(
                {"decoder": miso.RedundancyPolicy(level=level)}))


@pytest.mark.parametrize("which", ["train_dmr", "static_tmr"])
def test_state_specs_equal_jax(which):
    jp, pp = train_programs("internlm2-1.8b") if which == "train_dmr" else static_programs(3)
    js, ps = jp.state_specs(), pp.state_specs()
    assert sorted(js) == sorted(ps)
    for name in js:
        assert port_specs(ps[name]) == jax_specs(js[name]), name


@pytest.mark.parametrize("level", [2, 3], ids=["static_dmr", "static_tmr"])
def test_unreplicated_specs_equal_jax(level):
    """From real (replicated) init states: the replica axis stripped."""
    jp, pp = static_programs(level)
    jst = jp.init_states(jax.random.PRNGKey(0))
    pst = pp.init_states(torch.Generator().manual_seed(0), "cpu")
    js, ps = jp.unreplicated_specs(jst), pp.unreplicated_specs(pst)
    for name in js:
        assert port_specs(ps[name]) == jax_specs(js[name]), name
    # the replicated cell's real states carry the replica axis the specs drop
    assert [s[0] for s in port_specs(state_spec(pst["decoder"]))] == [
        (level, *s[0]) for s in port_specs(ps["decoder"])]


# ---------------------------------------------------------------------------
# the §II contract: the programs of tests/test_system.py and tests/test_ir.py
# ---------------------------------------------------------------------------
CAPTURED = {
    "captured_constant": np.arange(3, dtype=np.float32),
    "captured_drift": np.ones((2, 3), np.float32),  # broadcasts the state to (2, 3)
}


def _jax_cells(case):
    z = lambda k: {"x": jnp.zeros(3)}  # noqa: E731
    if case == "undeclared_read":
        return [jcore.CellType("other", z, lambda prev: prev["other"]),
                jcore.CellType("c", z, lambda prev: {"x": prev["other"]["x"]})]
    if case == "shape_drift":
        return [jcore.CellType("c", z, lambda prev: {
            "x": jnp.concatenate([prev["c"]["x"], prev["c"]["x"]])})]
    if case == "dtype_drift":
        return [jcore.CellType("a", z, lambda prev: prev["a"]),
                jcore.CellType("c", lambda k: {"w": jnp.zeros(2), "x": jnp.zeros(3)},
                               lambda prev: {"w": prev["c"]["w"],
                                             "x": prev["c"]["x"].astype(jnp.int32)})]
    if case == "structure_drift":
        return [jcore.CellType("c", z, lambda prev: {"x": prev["c"]["x"], "y": prev["c"]["x"]})]
    if case in CAPTURED:  # a constant the transition closes over and reads
        w = jnp.asarray(CAPTURED[case])
        return [jcore.CellType("c", z, lambda prev: {"x": prev["c"]["x"] * w})]
    assert case == "valid"
    return [jcore.CellType("a", z, lambda prev: {"x": prev["a"]["x"] * 2}),
            jcore.CellType("c", z, lambda prev: {"x": prev["c"]["x"] + prev["a"]["x"]},
                           reads=("a",))]


def _port_cells(case):
    def z(gen, device):
        return {"x": torch.zeros(3, device=device)}

    if case == "undeclared_read":
        return [miso.CellType("other", z, lambda prev: prev["other"]),
                miso.CellType("c", z, lambda prev: {"x": prev["other"]["x"]})]
    if case == "shape_drift":
        return [miso.CellType("c", z, lambda prev: {
            "x": torch.cat([prev["c"]["x"], prev["c"]["x"]])})]
    if case == "dtype_drift":
        return [miso.CellType("a", z, lambda prev: prev["a"]),
                miso.CellType("c", lambda g, d: {"w": torch.zeros(2, device=d),
                                                 "x": torch.zeros(3, device=d)},
                              lambda prev: {"w": prev["c"]["w"],
                                            "x": prev["c"]["x"].to(torch.int32)})]
    if case == "structure_drift":
        return [miso.CellType("c", z, lambda prev: {"x": prev["c"]["x"], "y": prev["c"]["x"]})]
    if case in CAPTURED:
        w = torch.from_numpy(CAPTURED[case])
        return [miso.CellType("c", z, lambda prev: {"x": prev["c"]["x"] * w})]
    return [miso.CellType("a", z, lambda prev: {"x": prev["a"]["x"] * 2}),
            miso.CellType("c", z, lambda prev: {"x": prev["c"]["x"] + prev["a"]["x"]},
                          reads=("a",))]


IR_CASES = {
    "double_write": "cell C { var x: Float = 0; transition { x = 1; x = 2; } }\nc = new C(2)",
    "undeclared_slot": "cell C { var x: Float = 0; transition { y = 1; } }\nc = new C(2)",
    "stencil": """
    cell Rod {
      var t: Float = 0;
      transition {
        let left = rod(this.pos - 1).t;
        let right = rod(this.pos + 1).t;
        t = t + 0.25 * (left - 2*t + right);
      }
    }
    rod = new Rod(64)
    """,
}


def _outcome(prog, semantics_error):
    """(raised, cell named, leaf index named) of ``prog.validate()``."""
    try:
        prog.validate()
    except semantics_error as e:
        cell = re.search(r"cell '(\w+)'", str(e))
        leaf = re.search(r"state leaf (\d+)", str(e))
        return True, cell and cell.group(1), leaf and int(leaf.group(1))
    return False, None, None


@pytest.mark.parametrize("case", ["undeclared_read", "shape_drift", "dtype_drift",
                                  "structure_drift", "valid", *CAPTURED])
def test_validate_outcome_equals_jax(case):
    jp, pp = jcore.MisoProgram(), miso.MisoProgram()
    for c in _jax_cells(case):
        jp.add(c)
    for c in _port_cells(case):
        pp.add(c)
    want = _outcome(jp, jcore.MisoSemanticsError)
    assert want[0] == (case not in ("valid", "captured_constant"))
    assert _outcome(pp, miso.MisoSemanticsError) == want


@pytest.mark.parametrize("case", sorted(IR_CASES))
def test_validate_ir_outcome_equals_jax(case):
    src = IR_CASES[case]
    inputs = None
    if case == "stencil":
        init = np.zeros(64, np.float32)
        init[32] = 100.0
        inputs = {"rod": {"t": init}}
    want = _outcome(jir.compile_source(src, inputs=inputs), jcore.MisoSemanticsError)
    assert want[0] == (case != "stencil")
    got = _outcome(ir.compile_source(src, inputs=inputs), miso.MisoSemanticsError)
    assert got[:2] == want[:2]


def test_drift_message_spells_shapes_and_dtypes():
    pp = miso.MisoProgram()
    for c in _port_cells("dtype_drift"):
        pp.add(c)
    with pytest.raises(miso.MisoSemanticsError,
                       match=r"cell 'c': state leaf 1 drifts across the transition: "
                             r"\(3,\)/torch.float32 -> \(3,\)/torch.int32"):
        pp.validate()
    pp = miso.MisoProgram()
    for c in _port_cells("structure_drift"):
        pp.add(c)
    with pytest.raises(miso.MisoSemanticsError,
                       match=r"output structure \{'x': \*, 'y': \*\} != state structure "
                             r"\{'x': \*\}"):
        pp.validate()


# ---------------------------------------------------------------------------
# real programs of the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_validate_passes_on_reduced_train_program(arch):
    _, pp = train_programs(arch)
    pp.validate()


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_validate_paged_slot_program_reaches_nonzero(monkeypatch, spec):
    """The paged decode step's ``nonzero`` gets a symbolic size on fake
    tensors; it is traced, not refused, and not run."""
    seen = []
    real = layers.paged_write_rows

    def spy(*a, **k):
        rows, lanes, sel = real(*a, **k)
        seen.append(sel.shape[0])
        return rows, lanes, sel

    monkeypatch.setattr(layers, "paged_write_rows", spy)
    scfg = lc.ServeConfig(batch=4, max_len=32, paged=True, page_size=8,
                          spec=lc.SpecConfig(draft_len=2) if spec else None)
    prog = lc.make_slot_serve_program(get_reduced("internlm2-1.8b"), scfg).with_policies(
        {"decoder": miso.RedundancyPolicy(level=2)})
    prog.validate()
    assert seen and all(isinstance(n, torch.SymInt) for n in seen)


def test_validate_runs_nothing_for_real():
    """The transition sees fake tensors only; a 4 TB state validates; a
    transition writing into a real tensor it closes over is refused,
    naming its cell and the operator, and the tensor keeps its data and
    its version; one reading it validates and leaves it as it was."""
    kinds = []

    def counted(prev):
        kinds.append(type(prev["c"]["x"]).__name__)
        return {"x": prev["c"]["x"] + 1}

    p = miso.MisoProgram()
    p.add(miso.CellType("c", lambda g, d: {"x": torch.zeros(1 << 40, device=d)}, counted))
    p.validate()
    assert kinds == ["FakeTensor"]
    assert p.state_specs()["c"] == {"x": ShapeDtype((1 << 40,), torch.float32)}

    buf = torch.zeros(3)

    def writes(prev):
        buf.copy_(prev["c"]["x"] + 1)
        return prev["c"]

    p = miso.MisoProgram()
    p.add(miso.CellType("c", lambda g, d: {"x": torch.zeros(3, device=d)}, writes))
    with pytest.raises(RuntimeError, match=r"cell 'c'.*operator aten\.copy_"):
        p.validate()
    assert torch.equal(buf, torch.zeros(3)) and buf._version == 0

    def adds(prev):
        buf.add_(1)
        return prev["c"]

    p = miso.MisoProgram()
    p.add(miso.CellType("c", lambda g, d: {"x": torch.zeros(3, device=d)}, adds))
    with pytest.raises(RuntimeError, match=r"cell 'c'.*operator aten\.add_"):
        p.validate()
    assert torch.equal(buf, torch.zeros(3)) and buf._version == 0

    def reads(prev):
        return {"x": prev["c"]["x"] + buf.sum()}

    p = miso.MisoProgram()
    p.add(miso.CellType("c", lambda g, d: {"x": torch.zeros(3, device=d)}, reads))
    p.validate()
    assert torch.equal(buf, torch.zeros(3)) and buf._version == 0


def test_check_single_output_takes_specs():
    cell = miso.CellType("c", lambda g, d: {"x": torch.zeros(3)},
                         lambda prev: {"x": prev["c"]["x"][:2]})
    with pytest.raises(miso.MisoSemanticsError, match="state leaf 0 drifts"):
        check_single_output(cell, {"c": {"x": ShapeDtype((3,), torch.float32)}})
