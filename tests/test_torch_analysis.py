"""The port's static analyzer (``repro_torch.analysis``) against the JAX
analyzer (``repro.analysis``): every hazard fixture of
``tests/test_analysis.py`` gives JAX's codes (and JAX's messages, where
they name no operator), the IR lints, the output-leaf kinds of constant,
reshaped and copied outputs, trace failures naming the same cell, the
DAG export (JSON and DOT equal to JAX's, accepted by
``tools/validate_dag.py``, a corrupted one refused), the CLI's exit
statuses and JSON document, and the code taxonomy of ``docs/analysis.md``.

The registry programs are compared in ``test_torch_analysis_train_{a..e}.py``
and ``test_torch_analysis_serve_{a,b,paged}.py``, the random programs in
``test_torch_analysis_random.py``; they share the helpers, the
``jax_analysis`` fixture and the ``DIFFERENCES`` table here.

The reference analyzer reaches ``jax.core.Var``/``Literal``/``Jaxpr``/
``ClosedJaxpr`` at call time; jax 0.9 moved them to ``jax.extend.core``.
The ``jax_analysis`` fixture sets the four names on ``jax.core`` through
``monkeypatch`` (``raising=False``), so pytest deletes them again after
each test: nothing leaks to the reference's own ``tests/test_analysis.py``
in the same worker (the last test of this file checks it)."""

import importlib.util
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import CellType as JCell
from repro.core import MisoProgram as JProgram
from repro.core import RedundancyPolicy as JPolicy
from repro_torch import prng
from repro_torch.analysis import CODES, analyze_program, lint_source, registry, trace_cell
from repro_torch.analysis.cli import main as cli_main
from repro_torch.core import CellType, MisoProgram, RedundancyPolicy
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
_MOVED = ("Var", "Literal", "Jaxpr", "ClosedJaxpr")
_AT_IMPORT = {name: hasattr(jax.core, name) for name in _MOVED}


@pytest.fixture
def jax_analysis(monkeypatch):
    """``repro.analysis`` with the four names it reaches on ``jax.core``
    set for this test only."""
    import jax.extend.core as xc

    for name in _MOVED:
        monkeypatch.setattr(jax.core, name, getattr(xc, name), raising=False)
    import repro.analysis as ra

    return ra


# ---------------------------------------------------------------------------
# where the port differs from the JAX analyzer, and why
# ---------------------------------------------------------------------------

_JIT = (
    "jax 0.9 names the call primitive `jit` (it was `pjit`), and the reference's "
    "taint walk (parity._TAINT_HANDLERS) enters only `pjit`: it never visits the "
    "scatter-add of the embedding and cross-entropy gathers' backward inside the "
    "jitted jnp.take/take_along_axis.  The FX graph is flat, so the port sees the "
    "aten.index_put(accumulate=True)/aten.scatter_add they lower to.  With `jit` "
    "entered, the reference raises MISO102 on all eight trainers too"
)
_INDEX_COPY = (
    "JAX's MoE _dispatch (src/repro/models/moe.py:103) scatter-adds the routed "
    "rows; the port writes each unique slot once with index_copy_ "
    "(src/repro_torch/models/moe.py), so replicas stay bitwise on the card"
)
_REPEAT = (
    "JAX's M-RoPE stream map, jnp.repeat(..., total_repeat_length=), lowers to an "
    "int32 scatter-add over constant indices; the port's torch.repeat_interleave "
    "accumulates nothing (and integer addition cannot diverge replicas)"
)

#: (program, policy, cell, code) -> (raised by JAX, raised by the port, why).
#: Under default policies nothing differs; under "dmr" every cell is level 2.
DIFFERENCES = {
    **{(f"train:{fam}", "dmr", "trainer", "MISO102"): (False, True, _JIT)
       for fam in ("gqa", "mamba", "zamba", "windowed", "codebook")},
    **{(p, "dmr", "decoder", "MISO102"): (True, False, _INDEX_COPY)
       for p in ("serve:mla", "serve-paged:mla", "serve:moe", "serve-paged:moe")},
    ("serve:vision", "dmr", "decoder", "MISO102"): (True, False, _REPEAT),
}

#: codes whose message names each package's own operators: JAX's
#: primitives (random_seed, scatter-add) against aten's and
#: repro_torch::threefry2x32; the rest of the text is equal
OPERATOR_MESSAGES = {"MISO101", "MISO102"}


def _without_ops(msg: str) -> str:
    return re.sub(r"\[[^\]]*\]", "[...]", msg)


def compare_diagnostics(jax_diags, port_diags, program="", policy="default"):
    """JAX's and the port's diagnostics (``to_dict`` form) equal in order,
    code, cell, severity and message, after the listed differences."""

    def keep(d, side):
        diff = DIFFERENCES.get((program, policy, d["cell"], d["code"]))
        return diff is None or not diff[side]

    for (prog, pol, cell, code), (in_jax, in_port, _) in DIFFERENCES.items():
        if (prog, pol) == (program, policy):
            assert any(d["cell"] == cell and d["code"] == code for d in jax_diags) == in_jax
            assert any(d["cell"] == cell and d["code"] == code for d in port_diags) == in_port
    jd = [d for d in jax_diags if keep(d, 0)]
    pd = [d for d in port_diags if keep(d, 1)]
    assert [(d["code"], d["cell"], d["severity"], d["slug"]) for d in pd] == [
        (d["code"], d["cell"], d["severity"], d["slug"]) for d in jd]
    for a, b in zip(jd, pd):
        if a["code"] in OPERATOR_MESSAGES:
            assert _without_ops(b["message"]) == _without_ops(a["message"])
        else:
            assert b["message"] == a["message"]
            assert b["notes"] == a["notes"] and b["data"] == a["data"]


def _all_dmr(prog, policy_cls):
    return prog.with_policies({c: policy_cls(level=2) for c in prog.cells})


def check_registry_program(ra, name: str, policy: str):
    """One registry program, analysed by both packages: cells (reads per
    leaf, dead and undeclared reads, output-leaf kinds, shapes and
    dtypes) and the DAG (JSON and DOT) bitwise, diagnostics per
    ``compare_diagnostics``."""
    jspec, pspec = ra.registry()[name], registry()[name]
    jprog, pprog = jspec.build(), pspec.build()
    if policy == "dmr":
        jprog, pprog = _all_dmr(jprog, JPolicy), _all_dmr(pprog, RedundancyPolicy)
    jr = ra.analyze_program(jprog, name=name)
    pr = analyze_program(pprog, name=name)
    if jspec.kind == "ir":
        # the CLI lints the source first; the lint is held here too
        jl = [d.to_dict() for d in ra.lint_source(jspec.source, program=name)]
        assert [d.to_dict() for d in lint_source(pspec.source, program=name)] == jl
    jd, pd = jr.to_dict(), pr.to_dict()
    assert set(pd["cells"]) == set(jd["cells"])
    for cell in jd["cells"]:
        assert pd["cells"][cell] == jd["cells"][cell], (name, cell)
    assert pr.dag.to_json() == jr.dag.to_json()
    assert pr.dag.to_dot() == jr.dag.to_dot()
    compare_diagnostics(jd["diagnostics"], pd["diagnostics"], name, policy)
    return jr, pr


# ---------------------------------------------------------------------------
# hazard fixtures: tests/test_analysis.py's, and their port counterparts
# ---------------------------------------------------------------------------


def undeclared_prog():
    a = CellType("a", init=lambda g, d: {"x": torch.zeros(3, device=d)},
                 transition=lambda p: {"x": p["a"]["x"] + 1})
    b = CellType("b", init=lambda g, d: {"y": torch.zeros(3, device=d)},
                 transition=lambda p: {"y": p["a"]["x"] * 2})
    return MisoProgram().add(a).add(b)


def const_key_dmr_prog():
    c = CellType(
        "noisy",
        init=lambda g, d: {"x": torch.zeros(4, device=d)},
        transition=lambda p: {"x": p["noisy"]["x"] + prng.normal(prng.PRNGKey(0), (4,))},
        redundancy=RedundancyPolicy(level=2),
    )
    return MisoProgram().add(c)


def _threaded_key_prog(level):
    def transition(p):
        ks = prng.split(p["noisy"]["key"])
        return {"x": p["noisy"]["x"] + prng.normal(ks[1], (4,)), "key": ks[0]}

    c = CellType("noisy",
                 init=lambda g, d: {"x": torch.zeros(4, device=d), "key": prng.PRNGKey(0, d)},
                 transition=transition, redundancy=RedundancyPolicy(level=level))
    return MisoProgram().add(c)


def _jax_threaded_key_prog(level):
    def transition(p):
        k0, k1 = jax.random.split(p["noisy"]["key"])
        return {"x": p["noisy"]["x"] + jax.random.normal(k1, (4,)), "key": k0}

    c = JCell("noisy", init=lambda k: {"x": jnp.zeros(4), "key": jax.random.PRNGKey(0)},
              transition=transition, redundancy=JPolicy(level=level))
    return JProgram().add(c)


def _one_cell(transition, init, level=1, name="acc"):
    return MisoProgram().add(CellType(name, init=init, transition=transition,
                                      redundancy=RedundancyPolicy(level=level)))


def _zeros4(g, d):
    return {"x": torch.zeros(4, device=d)}


_COLLIDE = torch.zeros(4, dtype=torch.long)

#: port spellings of ``x.at[zeros].add(1.0)``: every aten accumulation
#: MISO102 names
ACCUMULATIONS = {
    "index_add": lambda x: x.index_add(0, _COLLIDE, torch.ones(4)),
    "index_add_": lambda x: x.clone().index_add_(0, _COLLIDE, torch.ones(4)),
    "scatter_add": lambda x: x.scatter_add(0, _COLLIDE, torch.ones(4)),
    "scatter_reduce_sum": lambda x: x.scatter_reduce(0, _COLLIDE, torch.ones(4), "sum"),
    "index_put_accumulate": lambda x: x.index_put((_COLLIDE,), torch.ones(4), accumulate=True),
    "setitem_add": lambda x: torch.ops.aten.index_put(x, [_COLLIDE], torch.ones(4), True),
}

#: the same writes without accumulation: no MISO102 (nor in JAX's .at[].set)
NON_ACCUMULATIONS = {
    "index_copy": lambda x: x.index_copy(0, torch.arange(4), x * 2),
    "index_put": lambda x: x.index_put((_COLLIDE,), torch.ones(4)),
    "scatter_reduce_amax": lambda x: x.scatter_reduce(0, _COLLIDE, torch.ones(4), "amax"),
}


def _jax_codes(ra, prog, name="bad"):
    return [d.code for d in ra.analyze_program(prog, name=name).diagnostics]


def _codes(prog, name="bad"):
    return [d.code for d in analyze_program(prog, name=name).diagnostics]


def test_undeclared_read_is_miso001(jax_analysis):
    from test_analysis import _undeclared_prog

    jr = jax_analysis.analyze_program(_undeclared_prog(), name="bad")
    pr = analyze_program(undeclared_prog(), name="bad")
    d = next(d for d in pr.diagnostics if d.code == "MISO001")
    assert d.cell == "b" and d.severity == "error"
    compare_diagnostics([x.to_dict() for x in jr.diagnostics], [x.to_dict() for x in pr.diagnostics])
    assert pr.to_dict()["cells"] == jr.to_dict()["cells"]


def test_const_key_replicated_is_miso101(jax_analysis):
    from test_analysis import _const_key_dmr_prog

    jr = jax_analysis.analyze_program(_const_key_dmr_prog(), name="bad")
    pr = analyze_program(const_key_dmr_prog(), name="bad")
    assert [d.code for d in pr.diagnostics] == [d.code for d in jr.diagnostics] == ["MISO101"]
    assert pr.diagnostics[0].severity == "error"
    assert pr.diagnostics[0].data == {"draws": ["threefry2x32"]}
    compare_diagnostics([x.to_dict() for x in jr.diagnostics], [x.to_dict() for x in pr.diagnostics])


@pytest.mark.parametrize("level", [1, 2, 3])
def test_threaded_key_is_clean(jax_analysis, level):
    jc = _jax_codes(jax_analysis, _jax_threaded_key_prog(level), "ok")
    assert _codes(_threaded_key_prog(level), "ok") == jc
    assert "MISO101" not in jc


def test_const_key_unreplicated_is_allowed(jax_analysis):
    jprog = JProgram().add(JCell(
        "table", init=lambda k: {"x": jnp.zeros(4)},
        transition=lambda p: {"x": p["table"]["x"] + jax.random.normal(jax.random.PRNGKey(7), (4,))}))
    prog = _one_cell(lambda p: {"x": p["table"]["x"] + prng.normal(prng.PRNGKey(7), (4,))},
                     _zeros4, name="table")
    assert _codes(prog, "ok") == _jax_codes(jax_analysis, jprog, "ok") == []


@pytest.mark.parametrize("draw", ["rand", "randn_like", "bernoulli"])
def test_torch_random_in_replicated_cell_is_miso101(draw):
    """torch's generator-backed draws have no key in any state: in a
    replicated cell each is the constant-key hazard (JAX has no such
    operator, so there is no reference to hold it to)."""
    f = {"rand": lambda x: x + torch.rand(4),
         "randn_like": lambda x: x + torch.randn_like(x),
         "bernoulli": lambda x: x * torch.bernoulli(torch.full((4,), 0.5))}[draw]
    prog = _one_cell(lambda p: {"x": f(p["acc"]["x"])}, _zeros4, level=2)
    r = analyze_program(prog, name="bad")
    assert [d.code for d in r.diagnostics] == ["MISO101"]
    assert r.diagnostics[0].data["draws"][0].startswith("aten.")
    assert _codes(_one_cell(lambda p: {"x": f(p["acc"]["x"])}, _zeros4, level=1)) == []


def _jax_scatter_add_prog(level=2):
    def transition(p):
        idx = jnp.zeros((4, 1), jnp.int32)  # all collide on index 0
        return {"x": p["acc"]["x"].at[idx[:, 0]].add(1.0)}

    return JProgram().add(JCell("acc", init=lambda k: {"x": jnp.zeros(4)},
                                transition=transition, redundancy=JPolicy(level=level)))


@pytest.mark.parametrize("op", sorted(ACCUMULATIONS))
def test_accumulation_in_replicated_cell_is_miso102(jax_analysis, op):
    jc = _jax_codes(jax_analysis, _jax_scatter_add_prog())
    f = ACCUMULATIONS[op]
    pc = _codes(_one_cell(lambda p: {"x": f(p["acc"]["x"])}, _zeros4, level=2))
    assert pc == jc == ["MISO102"]
    # unreplicated: no hazard, in either package
    assert _codes(_one_cell(lambda p: {"x": f(p["acc"]["x"])}, _zeros4)) == _jax_codes(
        jax_analysis, _jax_scatter_add_prog(level=1)) == []


@pytest.mark.parametrize("op", sorted(NON_ACCUMULATIONS))
def test_write_without_accumulation_is_not_miso102(op):
    f = NON_ACCUMULATIONS[op]
    assert _codes(_one_cell(lambda p: {"x": f(p["acc"]["x"])}, _zeros4, level=2)) == []


def test_dtype_drift_is_miso103(jax_analysis):
    jprog = JProgram().add(JCell(
        "drift", init=lambda k: {"x": jnp.zeros(3, jnp.float32)},
        transition=lambda p: {"x": p["drift"]["x"].astype(jnp.bfloat16).astype(jnp.float16)}))
    prog = _one_cell(lambda p: {"x": p["drift"]["x"].to(torch.bfloat16).to(torch.float16)},
                     lambda g, d: {"x": torch.zeros(3, device=d)}, name="drift")
    jr, pr = jax_analysis.analyze_program(jprog, name="bad"), analyze_program(prog, name="bad")
    assert "MISO103" in [d.code for d in pr.diagnostics]
    compare_diagnostics([x.to_dict() for x in jr.diagnostics], [x.to_dict() for x in pr.diagnostics])


def test_output_structure_mismatch_is_miso104(jax_analysis):
    jprog = JProgram().add(JCell("s", init=lambda k: {"x": jnp.zeros(3)},
                                 transition=lambda p: {"x": p["s"]["x"], "y": p["s"]["x"]}))
    prog = _one_cell(lambda p: {"x": p["s"]["x"], "y": p["s"]["x"]},
                     lambda g, d: {"x": torch.zeros(3, device=d)}, name="s")
    jr, pr = jax_analysis.analyze_program(jprog, name="bad"), analyze_program(prog, name="bad")
    assert "MISO104" in [d.code for d in pr.diagnostics]
    compare_diagnostics([x.to_dict() for x in jr.diagnostics], [x.to_dict() for x in pr.diagnostics])


def test_data_dependent_control_flow_is_miso004_in_the_same_cell(jax_analysis):
    """Python control flow on a tensor's value: JAX's
    ConcretizationTypeError, a data-dependent guard on the fakes here."""

    def jt(p):
        return {"x": p["a"]["x"] + 1 if p["a"]["x"].sum() > 0 else p["a"]["x"]}

    def pt(p):
        return {"x": p["a"]["x"] + 1 if p["a"]["x"].sum() > 0 else p["a"]["x"]}

    jprog = (JProgram().add(JCell("a", init=lambda k: {"x": jnp.zeros(3)}, transition=jt))
             .add(JCell("b", init=lambda k: {"x": jnp.zeros(3)}, transition=lambda p: p["b"])))
    prog = (MisoProgram().add(CellType("a", init=lambda g, d: {"x": torch.zeros(3, device=d)},
                                       transition=pt))
            .add(CellType("b", init=lambda g, d: {"x": torch.zeros(3, device=d)},
                          transition=lambda p: p["b"])))
    jr, pr = jax_analysis.analyze_program(jprog, name="bad"), analyze_program(prog, name="bad")
    jd = [(d.code, d.cell) for d in jr.diagnostics]
    assert [(d.code, d.cell) for d in pr.diagnostics] == jd == [("MISO004", "a"), ("MISO003", "b")]
    assert pr.diagnostics[0].message.startswith("cell 'a' failed abstract eval: ")
    assert pr.dag is None and jr.dag is None


def test_carried_leaf_is_miso003_info():
    result = analyze_program(registry()["serve:gqa"].build(), name="serve")
    carried = [d for d in result.diagnostics if d.code == "MISO003"]
    assert carried and carried[0].cell == "weights"
    assert carried[0].severity == "info"


#: outputs whose kind depends on how each package records them: a 0-d
#: constant is a jaxpr literal ("const"), a shaped one an equation
#: ("written"); a same-shape reshape and a same-dtype cast are elided
#: ("carried"), a copy is not; zeros_like reads no value
KIND_CASES = {
    "zeros4": ((4,), lambda x: jnp.zeros(4), lambda x: torch.zeros(4)),
    "zeros0": ((), lambda x: jnp.zeros(()), lambda x: torch.zeros(())),
    "scalar": ((), lambda x: jnp.float32(1.0), lambda x: torch.tensor(1.0)),
    "reshape": ((4,), lambda x: x.reshape(4), lambda x: x.reshape(4)),
    "astype": ((4,), lambda x: x.astype(jnp.float32), lambda x: x.to(torch.float32)),
    "view": ((4,), lambda x: x.reshape(2, 2).reshape(4), lambda x: x.view(2, 2).view(4)),
    "detach": ((4,), lambda x: jax.lax.stop_gradient(x), lambda x: x.detach()),
    "copy": ((4,), lambda x: jnp.copy(x), lambda x: x.clone()),
    "zeros_like": ((4,), lambda x: jnp.zeros_like(x) + 1, lambda x: torch.zeros_like(x) + 1),
    "zeros_like0": ((), lambda x: jnp.zeros_like(x), lambda x: torch.zeros_like(x)),
    "mul0": ((4,), lambda x: x * 0, lambda x: x * 0),
    "full": ((4,), lambda x: jnp.full((4,), 2.0), lambda x: torch.full((4,), 2.0)),
}


@pytest.mark.parametrize("case", sorted(KIND_CASES))
def test_output_leaf_kinds_and_reads_match_jax(jax_analysis, case):
    shape, jf, pf = KIND_CASES[case]
    jc = JCell("a", init=lambda k: {"x": jnp.zeros(shape)}, transition=lambda p: {"x": jf(p["a"]["x"])})
    pc = CellType("a", init=lambda g, d: {"x": torch.zeros(shape, device=d)},
                  transition=lambda p: {"x": pf(p["a"]["x"])})
    ja = jax_analysis.trace_cell(jc, JProgram().add(jc).state_specs())
    pa = trace_cell(pc, MisoProgram().add(pc).state_specs())
    assert pa.to_dict() == ja.to_dict()


def test_in_place_write_of_the_previous_state_is_never_carried():
    """A transition that writes its input in place and returns it: the
    placeholder is the output, but its value changed (JAX cannot express
    the case)."""
    pc = CellType("a", init=lambda g, d: {"x": torch.zeros(4, device=d)},
                  transition=lambda p: {"x": p["a"]["x"].mul_(2)})
    pa = trace_cell(pc, MisoProgram().add(pc).state_specs())
    assert [o.kind for o in pa.out_leaves] == ["written"]
    assert pa.reads == {"a": ("['x']",)}


def test_state_written_into_a_constant_in_place_is_not_constant():
    """A constant buffer overwritten in place by state is state: a key
    made that way is threaded (no MISO101), a 0-d output made that way is
    written, not const."""

    def transition(p):
        key = prng.PRNGKey(0)
        key.copy_(p["noisy"]["key"])
        ks = prng.split(key)
        return {"x": p["noisy"]["x"] + prng.normal(ks[1], (4,)), "key": ks[0],
                "s": torch.zeros(()).copy_(p["noisy"]["s"])}

    c = CellType("noisy", init=lambda g, d: {"x": torch.zeros(4, device=d), "key": prng.PRNGKey(0, d),
                                             "s": torch.zeros((), device=d)},
                 transition=transition, redundancy=RedundancyPolicy(level=2))
    r = analyze_program(MisoProgram().add(c), name="ok")
    assert [d.code for d in r.diagnostics] == []
    assert [(o.path, o.kind) for o in r.accesses["noisy"].out_leaves] == [
        ("['key']", "written"), ("['s']", "written"), ("['x']", "written")]


def test_metadata_only_use_is_not_a_read():
    """``new_zeros``/``empty_like``/a shape read of another cell's leaf do
    not read it: the declared read is dead (MISO002), as in JAX."""
    a = CellType("a", init=lambda g, d: {"x": torch.zeros(4, device=d)},
                 transition=lambda p: {"x": p["a"]["x"] + 1})
    b = CellType("b", init=lambda g, d: {"y": torch.zeros(4, device=d)}, reads=("a",),
                 transition=lambda p: {"y": p["b"]["y"] + p["a"]["x"].new_zeros(4)
                                       + torch.empty_like(p["a"]["x"]).fill_(1.0)
                                       + p["a"]["x"].shape[0]})
    r = analyze_program(MisoProgram().add(a).add(b), name="meta")
    assert r.accesses["b"].dead_reads == ("a",)
    assert [d.code for d in r.diagnostics] == ["MISO002"]


def test_in_place_write_into_a_read_is_live():
    """A value written in place after the read it depends on: the write
    (and what it reads) reaches the output through the storage."""
    a = CellType("a", init=lambda g, d: {"x": torch.zeros(4, device=d)},
                 transition=lambda p: {"x": p["a"]["x"] + 1})

    def transition(p):
        buf = torch.zeros(4)
        view = buf[:2]
        view.copy_(p["a"]["x"][:2])  # written through a view
        return {"y": p["b"]["y"] + buf}

    b = CellType("b", init=lambda g, d: {"y": torch.zeros(4, device=d)}, reads=("a",),
                 transition=transition)
    r = analyze_program(MisoProgram().add(a).add(b), name="inplace")
    assert r.accesses["b"].reads == {"a": ("['x']",), "b": ("['y']",)}
    assert r.accesses["b"].dead_reads == ()


# ---------------------------------------------------------------------------
# textual IR
# ---------------------------------------------------------------------------

UNDECLARED_SLOT = """
cell C {
  var s: Float = 0;
  transition { q = s + 1; }
}
c = new C(2)
"""

UNKNOWN_INSTANCE = """
cell C {
  var s: Float = 0;
  transition { s = s + ghost(this.pos).s; }
}
c = new C(2)
"""

UNKNOWN_CELL = """
cell C {
  var s: Float = 0;
  transition { s = s + 1; }
}
c = new D(2)
"""


@pytest.mark.parametrize("case,codes", [
    ("double_write", ["MISO110"]), ("undeclared_slot", ["MISO111"]),
    ("unknown_instance", ["MISO112"]), ("unknown_cell", ["MISO112"]),
    ("parse_error", ["MISO004"]),
])
def test_ir_lints_match_jax(jax_analysis, case, codes):
    from test_analysis import DOUBLE_WRITE

    src = {"double_write": DOUBLE_WRITE, "undeclared_slot": UNDECLARED_SLOT,
           "unknown_instance": UNKNOWN_INSTANCE, "unknown_cell": UNKNOWN_CELL,
           "parse_error": "cell C { var s: Float = ; }"}[case]
    pd = [d.to_dict() for d in lint_source(src, program="t")]
    assert [d["code"] for d in pd] == codes
    assert pd == [d.to_dict() for d in jax_analysis.lint_source(src, program="t")]


def test_all_codes_documented_in_taxonomy(jax_analysis):
    doc = (ROOT / "docs" / "analysis.md").read_text()
    assert CODES == jax_analysis.CODES
    for code, (slug, severity, title) in CODES.items():
        assert code.startswith("MISO") and len(code) == 7
        assert severity in ("info", "warning", "error")
        assert slug and title
        assert f"| {code} | {severity} | `{slug}`" in doc


# ---------------------------------------------------------------------------
# DAG export
# ---------------------------------------------------------------------------


def diamond_prog():
    def c(name, reads=()):
        def transition(prev, _n=name, _r=tuple(reads)):
            out = prev[_n]["x"] + 1.0
            for d in _r:
                out = out + prev[d]["x"]
            return {"x": out}

        return CellType(name, init=lambda g, d: {"x": torch.zeros(2, device=d)},
                        transition=transition, reads=tuple(reads))

    return (MisoProgram().add(c("src")).add(c("left", reads=("src",)))
            .add(c("right", reads=("src",))).add(c("sink", reads=("left", "right"))))


def test_diamond_dag_equals_jax(jax_analysis):
    from test_analysis import _diamond_prog

    jr = jax_analysis.analyze_program(_diamond_prog(), name="diamond")
    pr = analyze_program(diamond_prog(), name="diamond")
    m = pr.dag.metrics()
    assert m["critical_path"] == 3 and m["width"] == 2 and m["n_cells"] == 4
    assert m["n_cell_edges"] == 4 and m["n_dead_edges"] == 0
    assert pr.dag.to_json() == jr.dag.to_json()
    assert pr.dag.to_dot() == jr.dag.to_dot()
    doc = json.loads(pr.dag.to_json())
    assert doc["schema"] == "miso-analysis-dag/v1"
    sccs, edges = diamond_prog().graph().condensation()
    assert doc["condensation"]["sccs"] == [list(c) for c in sccs]
    assert doc["condensation"]["edges"] == {str(i): sorted(js) for i, js in edges.items()}


@pytest.mark.parametrize("name", ["serve:gqa", "ir:pingpong", "ir:heat"])
def test_dag_condensation_matches_core_on_registry_programs(name):
    prog = registry()[name].build()
    doc = json.loads(analyze_program(prog, name=name).dag.to_json())
    sccs, edges = prog.graph().condensation()
    assert doc["condensation"]["sccs"] == [list(c) for c in sccs]
    assert doc["condensation"]["edges"] == {str(i): sorted(js) for i, js in edges.items()}


def _validate_dag_tool():
    tool = ROOT / "tools" / "validate_dag.py"
    spec = importlib.util.spec_from_file_location("validate_dag", tool)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["diamond", "ir:pingpong", "serve-paged:gqa"])
def test_validate_dag_tool_accepts_exports_and_rejects_corruption(name):
    mod = _validate_dag_tool()
    prog = diamond_prog() if name == "diamond" else registry()[name].build()
    text = analyze_program(prog, name=name).dag.to_json()
    assert mod.validate_doc(json.loads(text)) == []
    broken = json.loads(text)
    reader = next(c for c, r in broken["refined_reads"].items() if r) if any(
        broken["refined_reads"].values()) else next(iter(broken["refined_reads"]))
    broken["refined_reads"][reader].append("ghost")
    assert mod.validate_doc(broken)
    broken2 = json.loads(text)
    broken2["metrics"]["critical_path"] = 7
    assert any("critical_path" in e for e in mod.validate_doc(broken2))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def dead_read_prog():
    a = CellType("a", init=lambda g, d: {"x": torch.zeros(2, device=d)},
                 transition=lambda p: {"x": p["a"]["x"] + 1})
    b = CellType("b", init=lambda g, d: {"x": torch.zeros(2, device=d)}, reads=("a",),
                 transition=lambda p: {"x": p["b"]["x"] * 2})
    return MisoProgram().add(a).add(b)


def test_cli_exit_nonzero_on_undeclared_read():
    assert cli_main(["test_torch_analysis:undeclared_prog"]) == 1


def test_cli_exit_nonzero_on_const_key_dmr():
    assert cli_main(["test_torch_analysis:const_key_dmr_prog"]) == 1


def test_cli_exit_on_dead_read_follows_fail_on():
    assert cli_main(["test_torch_analysis:dead_read_prog"]) == 0
    assert cli_main(["test_torch_analysis:dead_read_prog", "--fail-on", "warning"]) == 1


def test_cli_exit_nonzero_on_ir_double_write(tmp_path):
    from test_analysis import DOUBLE_WRITE

    p = tmp_path / "dw.miso"
    p.write_text(DOUBLE_WRITE)
    assert cli_main([str(p)]) == 1


def test_cli_json_and_exports_equal_jax(jax_analysis, tmp_path, capsys):
    from repro.analysis.cli import main as jax_cli

    argv = ["serve:gqa", "ir:listing1", "--json", "--fail-on", "warning", "--dag-out"]
    assert jax_cli(argv + [str(tmp_path / "jax")]) == 0
    jax_out = capsys.readouterr().out
    assert cli_main(argv + [str(tmp_path / "port")]) == 0
    assert capsys.readouterr().out == jax_out
    for f in ("serve_gqa.json", "serve_gqa.dot", "ir_listing1.json", "ir_listing1.dot"):
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text()
    doc = json.loads((tmp_path / "port" / "serve_gqa.json").read_text())
    assert doc["schema"] == "miso-analysis-dag/v1"


def test_cli_list_text_and_usage_equal_jax(jax_analysis, capsys):
    from repro.analysis.cli import main as jax_cli

    assert jax_cli(["--list"]) == 0
    jl = capsys.readouterr().out
    assert cli_main(["--list"]) == 0
    assert capsys.readouterr().out == jl
    assert len(jl.splitlines()) == 23
    assert jax_cli([]) == cli_main([]) == 2
    assert jax_cli(["ir:heat", "ir:pingpong"]) == 0
    jt = capsys.readouterr().out
    assert cli_main(["ir:heat", "ir:pingpong"]) == 0
    assert capsys.readouterr().out == jt


def test_cli_unknown_program_errors():
    with pytest.raises(SystemExit):
        cli_main(["no-such-program"])


def test_cli_help_says_no_device_is_needed(capsys):
    with pytest.raises(SystemExit):
        cli_main(["--help"])
    out = capsys.readouterr().out
    assert "--device" in out and "fake CPU" in out


@pytest.mark.parametrize("name", ["serve:gqa", "serve:mamba", "ir:listing1", "ir:heat"])
def test_registry_program_has_no_dead_reads(name):
    result = analyze_program(registry()[name].build(), name=name)
    assert not [d for d in result.diagnostics if d.code == "MISO002"]
    assert not [d for d in result.diagnostics if d.severity == "error"]


def test_jax_core_names_do_not_leak():
    """The last test of the file: after every parity test above, jax.core
    holds what it held at import (the fixture's monkeypatch undid its
    setattr), so the reference's own tests see jax as installed."""
    assert {name: hasattr(jax.core, name) for name in _MOVED} == _AT_IMPORT
