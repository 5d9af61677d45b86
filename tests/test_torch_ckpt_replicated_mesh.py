"""Checkpoint and resume of a replicated trainer whose state is laid out on
a mesh (``Sharded`` leaves with a replica axis): ``ckpt.save``,
``elastic_resume``, reduced mamba2 in f32 under DMR with FSDP on meshes
of CPU devices (``test_torch_train_ssm_dmr_mesh.setup``).

  * a replicated sharded save writes the files of the same state
    unsharded, names, treedef, bytes and CRCs (every file byte for byte),
    and those of the JAX package's ``ckpt.save`` of the same state;
  * a (2, 4) run checkpointed every 2 steps and crashed after 5 (the
    uninterrupted run's checkpoints up to step 5) resumes from its last
    checkpoint (the buffer before step 4) with
    ``elastic_resume``: onto the same (2, 4) mesh it ends step 8 bitwise
    where the uninterrupted run ends; onto (4, 2) it ends bitwise where a
    run ends that moved the uninterrupted run's state after 4 steps onto
    (4, 2) in memory (``place_train_state``), so the files lose nothing,
    and its losses are within 1e-5 of the uninterrupted (2, 4) run's (a
    mesh of another shape sums in another order); no resumed step has a
    DMR event."""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch import api as tmiso
from repro_torch.checkpoint import ckpt
from repro_torch.distributed.sharding import Sharded, unshard
from repro_torch.ft import elastic
from repro_torch.models import lm_cells as TL
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves, tree_map
from test_torch_train_ssm_dmr_mesh import bits, setup

cap_threads_for_xdist()

TOTAL, CRASH, EVERY = 8, 5, 2


def executor(shape, **kw):
    cfg, ctx, prog = setup(shape)
    return cfg, ctx, tmiso.compile(prog, backend="host", device="cpu", **kw)


def losses(exe, states, start, stop, at=None):
    out = []
    for t in range(start, stop):
        states = exe.run(states, 1, start_step=t).states
        out.append(float(states["trainer"]["metrics"]["loss"][0]))  # replica 0
        if at is not None:
            at(t + 1, states)
    return states, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted (2, 4) run, checkpointing every ``EVERY`` steps
    as long as a run that crashes after step ``CRASH`` would: its
    checkpoint directory is the crashed run's."""
    d = tmp_path_factory.mktemp("ckpt")
    save = ckpt.callback(d / "run", blocking=True)
    _, _, exe = executor((2, 4), checkpoint_cb=lambda t, st: save(t, st) if t <= CRASH else None,
                         checkpoint_every=EVERY)
    mid = {}
    want, straight = losses(exe, exe.init(0), 0, TOTAL,
                            at=lambda t, st: mid.setdefault(t, st) if t == 4 else None)
    return {"dir": d, "straight": straight, "want": want, "mid": mid[4],
            "events": exe.metrics()["fault_totals"]["trainer"]["events"]}


def test_replicated_sharded_save_writes_the_unsharded_and_jax_files(runs):
    d, st = runs["dir"], runs["mid"]
    assert isinstance(st["trainer"]["params"]["embed"], Sharded)
    assert st["trainer"]["params"]["embed"].shape[0] == 2  # the replica axis
    ckpt.save(d / "sharded", 4, st)
    host = tree_map(lambda x: x.clone(), unshard(st))
    ckpt.save(d / "unsharded", 4, host)
    jckpt.save(d / "jax", 4, jax.tree.map(jnp.asarray, tree_map(lambda x: x.numpy(), host)))
    a = d / "sharded" / "step_00000004"
    names = sorted(p.name for p in a.iterdir())
    assert "manifest.json" in names and len(names) > 20
    for other in ("unsharded", "jax"):
        b = d / other / "step_00000004"
        assert names == sorted(p.name for p in b.iterdir()), other
        for n in names:
            assert filecmp.cmp(a / n, b / n, shallow=False), (other, n)


def test_resumed_onto_the_same_mesh_ends_bitwise(runs):
    _, _, exe = executor((2, 4))
    states, step = elastic.elastic_resume(str(runs["dir"] / "run"), exe)
    assert step == 4  # the checkpoint of the buffer before step 4
    assert all(torch.equal(a, b) for a, b in zip(bits(states), bits(runs["mid"])))
    final, got = losses(exe, states, step, TOTAL)
    assert got == runs["straight"][step:]
    assert all(torch.equal(a, b) for a, b in zip(bits(final), bits(runs["want"])))
    assert exe.metrics()["fault_totals"]["trainer"]["events"] == 0 == runs["events"]


def test_resumed_onto_another_mesh(runs):
    cfg, ctx, exe = executor((4, 2))
    states, step = elastic.elastic_resume(str(runs["dir"] / "run"), exe, ctx)
    assert step == 4
    emb = states["trainer"]["params"]["embed"]
    assert isinstance(emb, Sharded) and emb.mesh is ctx.mesh and tuple(emb.spec)[0] is None
    final, got = losses(exe, states, step, TOTAL)
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, runs["straight"][step:]))
    assert exe.metrics()["fault_totals"]["trainer"]["events"] == 0
    # the same state moved onto (4, 2) in memory
    moved = tree_map(lambda x: x.clone(), unshard(runs["mid"]))
    moved["trainer"] = TL.place_train_state(cfg, ctx, moved["trainer"], level=2)
    _, _, twin = executor((4, 2))
    twin_final, twin_losses = losses(twin, moved, step, TOTAL)
    assert got == twin_losses
    assert all(torch.equal(a, b) for a, b in zip(bits(final), bits(twin_final)))
    assert int(np.asarray(unshard(final["trainer"])["opt"]["step"])[0]) == TOTAL
