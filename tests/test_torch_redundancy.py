"""The port's lock-step executor under DMR/TMR, held BITWISE against the
JAX package: the same program, the same initial states (carried over
through ``repro_torch.bridge``) and the same armed strike give the same
final states, the same summed reports and the same FaultLedger.  The toy
transitions only scale by powers of two, so XLA's fused multiply-add and
torch's separate ops round alike."""

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


def jax_program():
    prog = jmiso.MisoProgram()
    prog.add(jmiso.CellType(
        "src",
        lambda key: {"x": jax.random.normal(key, (4,)), "k": jnp.int32(1)},
        lambda prev: {"x": prev["src"]["x"] * 0.5 + prev["src"]["k"].astype(jnp.float32),
                      "k": prev["src"]["k"] + 1},
    ))
    prog.add(jmiso.CellType(
        "acc",
        lambda key: {"s": jnp.zeros((4,)), "b": jnp.zeros((4,), bool),
                     "h": jnp.ones((2, 3), jnp.bfloat16)},
        lambda prev: {"s": prev["acc"]["s"] + prev["src"]["x"],
                      "b": prev["acc"]["s"] > 0,
                      "h": prev["acc"]["h"] * jnp.bfloat16(0.5) + jnp.bfloat16(1)},
        reads=("src",),
    ))
    return prog


def torch_program():
    prog = tmiso.MisoProgram()
    prog.add(tmiso.CellType(
        "src",
        lambda gen, dev: {"x": torch.randn(4, generator=gen, device=dev),
                          "k": torch.ones((), dtype=torch.int32, device=dev)},
        lambda prev: {"x": prev["src"]["x"] * 0.5 + prev["src"]["k"].float(),
                      "k": prev["src"]["k"] + 1},
    ))
    prog.add(tmiso.CellType(
        "acc",
        lambda gen, dev: {"s": torch.zeros(4, device=dev),
                          "b": torch.zeros(4, dtype=torch.bool, device=dev),
                          "h": torch.ones((2, 3), dtype=torch.bfloat16, device=dev)},
        lambda prev: {"s": prev["acc"]["s"] + prev["src"]["x"],
                      "b": prev["acc"]["s"] > 0,
                      "h": prev["acc"]["h"] * 0.5 + 1},
        reads=("src",),
    ))
    return prog


def run_both(level, compare, strike, compare_every=1, n_steps=4):
    jpol = jmiso.RedundancyPolicy(level=level, compare=compare)
    tpol = tmiso.RedundancyPolicy(level=level, compare=compare)
    jprog, tprog = jax_program(), torch_program()
    jexe = jmiso.compile(jprog, policies={"acc": jpol}, compare_every=compare_every)
    texe = tmiso.compile(tprog, policies={"acc": tpol}, compare_every=compare_every,
                         device="cpu")
    jstates = jexe.init(jax.random.PRNGKey(0))
    tstates = bridge.states_from_numpy(jax.tree.map(np.asarray, jstates), device="cpu")
    jf = tf = None
    if strike is not None:
        leaf, bit = strike
        cid = jprog.cell_id("acc")
        jf = jmiso.FaultSpec.at(step=1, cell_id=cid, replica=1, leaf=leaf, index=2, bit=bit)
        tf = tmiso.FaultSpec.at(step=1, cell_id=cid, replica=1, leaf=leaf, index=2, bit=bit)
    jres = jexe.run(jstates, n_steps, faults=jf)
    tres = texe.run(tstates, n_steps, faults=tf)
    return jexe, texe, jres, tres


def assert_same_states(jstates, tstates):
    jl, tl = jax.tree.leaves(jstates), tree.tree_leaves(tstates)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        ref = bridge.states_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]
        assert ref.shape == b.shape and ref.dtype == b.dtype
        assert torch.equal(bitcast_int(ref), bitcast_int(b))


@pytest.mark.parametrize("level", [2, 3], ids=["dmr", "tmr"])
@pytest.mark.parametrize("compare", ["bitwise", "hash"])
@pytest.mark.parametrize("strike", [None, (0, 30), (1, 4), (2, 0)],
                         ids=["clean", "bool_leaf", "bf16_leaf", "f32_leaf"])
def test_lockstep_reports_and_ledger_bitwise_equal_jax(level, compare, strike):
    jexe, texe, jres, tres = run_both(level, compare, strike)
    assert_same_states(jres.states, tres.states)
    for cell in ("src", "acc"):
        for key in ("mismatch_elems", "events", "per_replica"):
            np.testing.assert_array_equal(
                np.asarray(jres.reports[cell][key], np.float32),
                np.asarray(tres.reports[cell][key], np.float32))
    assert texe.ledger.totals == jexe.ledger.totals
    assert texe.metrics()["steps"] == jexe.metrics()["steps"]


@pytest.mark.parametrize("level", [2, 3], ids=["dmr", "tmr"])
def test_compare_every_window_matches_jax(level):
    jexe, texe, jres, tres = run_both(level, "bitwise", (2, 7), compare_every=2)
    assert_same_states(jres.states, tres.states)
    assert texe.ledger.totals == jexe.ledger.totals


def test_pure_step_replays_without_side_effects():
    texe = tmiso.compile(torch_program(), policies={"acc": tmiso.RedundancyPolicy(level=2)},
                         device="cpu")
    st = texe.init(0)
    a, _ = texe.pure_step(st, 0)
    b, _ = texe.pure_step(st, 0)
    assert texe.metrics()["steps"] == 0 and texe.ledger.totals == {}
    for x, y in zip(tree.tree_leaves(a), tree.tree_leaves(b)):
        assert torch.equal(bitcast_int(x), bitcast_int(y))


def test_unknown_backend_and_missing_cuda_raise():
    with pytest.raises(ValueError, match="unknown backend"):
        tmiso.compile(torch_program(), backend="quantum", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            tmiso.compile(torch_program())  # the default device is cuda


def test_checkpoint_cb_fires_on_the_same_steps_as_jax():
    seen = {"jax": [], "torch": []}
    jexe = jmiso.compile(jax_program(), checkpoint_every=2,
                         checkpoint_cb=lambda t, st: seen["jax"].append(t))
    texe = tmiso.compile(torch_program(), checkpoint_every=2, device="cpu",
                         checkpoint_cb=lambda t, st: seen["torch"].append(t))
    jstates = jexe.init(jax.random.PRNGKey(0))
    jexe.run(jstates, 6)
    texe.run(bridge.states_from_numpy(jax.tree.map(np.asarray, jstates), device="cpu"), 6)
    assert seen["torch"] == seen["jax"] == [0, 2, 4]
