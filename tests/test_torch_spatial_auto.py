"""``spatial_lockstep``'s error paths, ``auto``'s choice and the
placement itself, in process on ``["cpu"] * n`` meshes.

The error paths of ``tests/test_spatial.py`` (any device count) run in
the JAX package beside the port's, and the messages must be equal; the
``auto`` cases JAX runs only under 8 forced devices (skipped in tier 1)
run here on CPU meshes: a fitting mesh selects the spatial back-end,
mixed spatial levels fall back to temporal (and run), no mesh or a pod
count that does not fit keeps the temporal choice."""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import api as jmiso
from repro_torch import api as miso
from repro_torch.core.executor import _wants_spatial
from repro_torch.distributed import make_mesh
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves

cap_threads_for_xdist()


def cpu_mesh(shape, axes):
    n = 1
    for d in shape:
        n *= d
    return make_mesh(shape, axes, devices=["cpu"] * n)


def torch_program(level=2, placement="spatial", compare="bitwise", empty=False):
    p = miso.MisoProgram()
    p.add(miso.CellType(
        "a", lambda g, d: {} if empty else {"x": torch.ones(4, device=d)},
        lambda prev: {} if empty else {"x": prev["a"]["x"] * 0.5},
        redundancy=miso.RedundancyPolicy(level=level, placement=placement, compare=compare)))
    return p


def jax_program(level=2, placement="spatial", empty=False):
    p = jmiso.MisoProgram()
    p.add(jmiso.CellType(
        "a", lambda k: {} if empty else {"x": jnp.ones((4,), jnp.float32)},
        lambda prev: {} if empty else {"x": prev["a"]["x"] * 0.5},
        redundancy=jmiso.RedundancyPolicy(level=level, placement=placement)))
    return p


def messages(jax_call, torch_call) -> tuple:
    with pytest.raises(ValueError) as je:
        jax_call()
    with pytest.raises(ValueError) as te:
        torch_call()
    return str(je.value), str(te.value)


@pytest.mark.parametrize("case", ["no_mesh", "no_pod_axis", "pod_count", "temporal_cells",
                                  "empty_state"])
def test_error_messages_equal_jax(case):
    if case == "no_mesh":
        j, t = messages(lambda: jmiso.compile(jax_program(), backend="spatial_lockstep"),
                        lambda: miso.compile(torch_program(), backend="spatial_lockstep",
                                             device="cpu"))
        assert "mesh=...) is required" in t
    elif case == "no_pod_axis":
        j, t = messages(
            lambda: jmiso.compile(jax_program(), backend="spatial_lockstep",
                                  mesh=jax.make_mesh((1,), ("data",))),
            lambda: miso.compile(torch_program(), backend="spatial_lockstep",
                                 mesh=cpu_mesh((1,), ("data",))))
        assert "no 'pod' axis" in t
    elif case == "pod_count":
        j, t = messages(
            lambda: jmiso.compile(jax_program(2), backend="spatial_lockstep",
                                  mesh=jax.make_mesh((1,), ("pod",))),
            lambda: miso.compile(torch_program(2), backend="spatial_lockstep",
                                 mesh=cpu_mesh((1,), ("pod",))))
        assert "must match" in t
    elif case == "temporal_cells":
        j, t = messages(
            lambda: jmiso.compile(jax_program(placement="temporal"), backend="spatial_lockstep",
                                  mesh=jax.make_mesh((1,), ("pod",))),
            lambda: miso.compile(torch_program(placement="temporal"), backend="spatial_lockstep",
                                 mesh=cpu_mesh((1,), ("pod",))))
        assert "no placement='spatial'" in t
    else:
        # JAX's own mesh would need 2 devices here: the port's message is
        # held to the text of src/repro/core/backend_spatial.py
        with pytest.raises(ValueError) as te:
            miso.compile(torch_program(2, empty=True), backend="spatial_lockstep",
                         mesh=cpu_mesh((2,), ("pod",)))
        j = t = str(te.value)
        assert t == ("cell 'a' has an empty state; spatial replication has nothing to place "
                     "across pods")
    assert t == j


def test_auto_keeps_temporal_without_a_fitting_mesh():
    """auto resolves to the spatial back-end only when the mesh can place
    one replica a pod; otherwise the policy stays a temporal request, as
    in JAX (same choice on the same inputs)."""
    one = cpu_mesh((1,), ("pod",))
    assert miso.compile(torch_program(2), backend="auto", mesh=one).name == "lockstep"
    assert jmiso.compile(jax_program(2), backend="auto",
                         mesh=jax.make_mesh((1,), ("pod",))).name == "lockstep"
    assert miso.compile(torch_program(2), backend="auto", device="cpu").name == "lockstep"
    assert miso.compile(torch_program(2), backend="auto",
                        mesh=cpu_mesh((2,), ("data",))).name == "lockstep"
    assert not _wants_spatial(torch_program(2, empty=True), cpu_mesh((2,), ("pod",)), "pod")


def test_auto_mixed_spatial_levels_fall_back_to_temporal():
    """A level-3 spatial cell on a 2-pod axis keeps the whole program on
    the temporal fallback, and that executor runs."""
    p = miso.MisoProgram()
    p.add(miso.CellType("a", lambda g, d: {"x": torch.ones(8, device=d)},
                        lambda prev: {"x": prev["a"]["x"] * 0.5},
                        redundancy=miso.RedundancyPolicy(level=2, placement="spatial")))
    p.add(miso.CellType("b", lambda g, d: {"x": torch.ones(8, device=d)},
                        lambda prev: {"x": prev["b"]["x"] * 0.5 + prev["a"]["x"] * 0.25},
                        reads=("a",),
                        redundancy=miso.RedundancyPolicy(level=3, placement="spatial")))
    mesh = cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    exe = miso.compile(p, backend="auto", mesh=mesh)
    assert exe.name == "lockstep" and exe.device == torch.device("cpu")
    exe.run(exe.init(0), 2)


@pytest.mark.parametrize("level", [2, 3])
def test_auto_resolves_spatial_on_a_pod_mesh(level):
    mesh = cpu_mesh((level, 2, 2), ("pod", "data", "model"))
    exe = miso.compile(torch_program(level, compare="hash"), backend="auto", mesh=mesh,
                       window=4)  # a wavefront hint auto drops
    assert exe.name == "spatial_lockstep"
    res = exe.run(exe.init(0), 3, start_step=0)
    assert float(res.reports["a"]["events"]) == 0.0


def test_init_places_one_replica_a_pod():
    """init lays the replica axis over the pods, one allocation a pod;
    gather gives the lockstep layout back and place inverts it."""
    p = miso.MisoProgram()
    p.add(miso.CellType("a", lambda g, d: {"x": torch.arange(8.0, device=d)},
                        lambda prev: {"x": prev["a"]["x"] * 0.5},
                        redundancy=miso.RedundancyPolicy(level=2, placement="spatial")))
    p.add(miso.CellType("b", lambda g, d: {"x": torch.ones(8, device=d)},
                        lambda prev: {"x": prev["b"]["x"] * 0.5 + prev["a"]["x"]},
                        reads=("a",)))
    mesh = cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    exe = miso.compile(p, backend="spatial_lockstep", mesh=mesh)
    states = exe.init(0)
    parts = states["a"]
    assert isinstance(parts, list) and len(parts) == 2
    assert all(part["x"].shape == (8,) for part in parts)
    assert parts[0]["x"].data_ptr() != parts[1]["x"].data_ptr()
    assert states["b"]["x"].shape == (8,)
    g = exe.gather(states)
    assert g["a"]["x"].shape == (2, 8) and torch.equal(g["a"]["x"][1], torch.arange(8.0))
    again = exe.place(g)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(again), tree_leaves(states)))
    m = exe.metrics()
    assert (m["placement"], m["pod_axis"], m["n_pods"], m["host_syncs"]) == ("spatial", "pod", 2, 0)


def test_custom_pod_axis_and_tmr_hash_syncs():
    """``pod_axis=`` names the replica axis; a TMR hash step reads its
    majority flags on the host once (counted)."""
    mesh = cpu_mesh((3, 1), ("replica", "data"))
    exe = miso.compile(torch_program(3, compare="hash"), backend="spatial_lockstep", mesh=mesh,
                       pod_axis="replica")
    exe.run(exe.init(0), 4)
    assert exe.metrics()["pod_axis"] == "replica" and exe.metrics()["host_syncs"] == 4
    with pytest.raises(ValueError, match="no 'pod' axis"):
        miso.compile(torch_program(3), backend="spatial_lockstep", mesh=mesh)
