"""Checkpoints of a trainer laid out on a device mesh, and their restore
onto a mesh of another shape (``ckpt.save`` / ``ckpt.restore(...,
shardings=)`` / ``elastic_restore`` / ``elastic_resume`` with a
``new_ctx``), reduced internlm2 in f32 on meshes of CPU devices.

  * a (2, 4) ZeRO-1 and an FSDP trainer's state after 2 steps, saved:
    its files are byte for byte those of the same state unsharded;
    restored onto (4, 2) and (1, 8) by the new mesh's layout (through
    ``pspec_fn``, and through an executor compiled for the new mesh),
    every leaf bitwise the saved one and laid out by the new mesh's
    specs;
  * a checkpoint written by the JAX package's ``ckpt.save`` (bf16
    params, f32 master and moments) restored onto the port's (2, 4)
    mesh, every leaf bitwise JAX's;
  * the ``int8_ef`` trainer's EF buffer is saved as data member 0's (JAX's
    host view) and restored to every data member;
  * a fail-stop: a (2, 4) run checkpointed every 2 steps, its state
    dropped, resumed from its last checkpoint (the buffer before step
    6) onto (4, 2) to step 8: its losses within 1e-5 of the
    uninterrupted (2, 4) run's."""

import dataclasses
import filecmp
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_reduced as jget
from repro.data.pipeline import DataConfig as JData
from repro.models import lm_cells as JL
from repro.optim.adamw import OptConfig as JOpt
from repro_torch import api as tmiso
from repro_torch import bridge
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_reduced as tget
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import Sharded, unshard
from repro_torch.ft import elastic
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import lm_cells as TL
from repro_torch.optim.adamw import OptConfig
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves, tree_map, tree_paths

cap_threads_for_xdist()

OPT = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)


def setup(shape, fsdp=False, comp="none", dtype="float32"):
    cfg = dataclasses.replace(tget("internlm2-1.8b"), dtype=dtype)
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, fsdp=fsdp)
    tcfg = TL.TrainConfig(data=DataConfig(batch=8, seq_len=16, vocab=cfg.vocab_size),
                          opt=OptConfig(**OPT), grad_compression=comp)
    return cfg, tcfg, ctx


def executor(shape, fsdp=False, comp="none", **kw):
    cfg, tcfg, ctx = setup(shape, fsdp, comp)
    return tmiso.compile(TL.make_train_program(cfg, tcfg, ctx), backend="host", device="cpu", **kw), ctx


def train_pspecs(cfg):
    """``pspec_fn`` laying a program state out as the JAX dry-run does."""
    def fn(ctx, like):
        from repro_torch.distributed.sharding import P

        return {"data": tree_map(lambda _: P(), like["data"]),
                "trainer": TL.train_state_pspecs(cfg, ctx, unshard(like["trainer"]))}
    return fn


def bits_equal(a, b) -> bool:
    la, lb = tree_leaves(unshard(a)), tree_leaves(unshard(b))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture(scope="module", params=[False, True], ids=["zero1", "fsdp"])
def saved(request, tmp_path_factory):
    """A (2, 4) trainer's state after 2 steps, saved sharded and
    unsharded."""
    exe, ctx = executor((2, 4), fsdp=request.param)
    states = exe.run(exe.init(0), 2).states
    d = tmp_path_factory.mktemp("ckpt")
    ckpt.save(d / "sharded", 2, states)
    ckpt.save(d / "unsharded", 2, unshard(states))
    return request.param, d, states


def test_sharded_save_writes_the_unsharded_files(saved):
    _, d, _ = saved
    a, b = d / "sharded" / "step_00000002", d / "unsharded" / "step_00000002"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and len(names) > 20
    for n in names:
        assert filecmp.cmp(a / n, b / n, shallow=False), n


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_restore_onto_another_mesh_through_pspec_fn(saved, shape):
    fsdp, d, states = saved
    cfg, _, ctx = setup(shape, fsdp)
    got, step = elastic.elastic_restore(str(d / "sharded"), states, ctx, train_pspecs(cfg))
    assert step == 2 and bits_equal(got, states)
    want = TL.train_state_pspecs(cfg, ctx, unshard(states["trainer"]))
    for spec, leaf in zip(tree_leaves(want), tree_leaves(got["trainer"])):
        if isinstance(leaf, Sharded):
            assert leaf.mesh is ctx.mesh and leaf.spec == spec
    wq = got["trainer"]["params"]["segments"][0]["attn"]["wq"]
    assert wq.local((shape[0] - 1, shape[1] - 1)).shape[-1] == wq.shape[-1] // shape[1]


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_resume_onto_another_mesh_through_its_executor(saved, shape):
    fsdp, d, states = saved
    exe, ctx = executor(shape, fsdp)
    got, step = elastic.elastic_resume(str(d / "sharded"), exe, ctx)
    assert step == 2 and bits_equal(got, states)
    assert all(leaf.mesh is ctx.mesh for leaf in tree_leaves(got["trainer"]["opt"])
               if isinstance(leaf, Sharded))


def test_a_jax_checkpoint_restores_onto_the_mesh_bitwise(tmp_path):
    """JAX's bf16 trainer state, saved by JAX's ``ckpt.save``, restored
    onto the port's (2, 4) mesh: every leaf JAX's bits."""
    jc = jget("internlm2-1.8b")
    jt = JL.TrainConfig(data=JData(batch=8, seq_len=16, vocab=jc.vocab_size), opt=JOpt(**OPT))
    js = JL.make_train_program(jc, jt).init_states(jax.random.PRNGKey(3))
    jckpt.save(tmp_path, 7, js)
    _, ctx = executor((2, 4))
    cfg = tget("internlm2-1.8b")
    like = TL.make_train_program(cfg, TL.TrainConfig(
        data=DataConfig(batch=8, seq_len=16, vocab=cfg.vocab_size), opt=OptConfig(**OPT)),
        ctx).init_states(torch.Generator().manual_seed(0), "cpu")
    got, step = elastic.elastic_restore(str(tmp_path), like, ctx, train_pspecs(cfg))
    assert step == 7
    want = bridge.states_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert tree_paths(want) == tree_paths(got)
    assert bits_equal(got, want)
    assert isinstance(got["trainer"]["params"]["segments"][0]["attn"]["wq"], Sharded)
    assert got["trainer"]["params"]["segments"][0]["attn"]["wq"].dtype == torch.bfloat16


def test_int8_ef_saves_member0_and_restores_to_every_member(tmp_path):
    exe, ctx = executor((2, 4), comp="int8_ef")
    states = exe.run(exe.init(0), 2).states
    ef = states["trainer"]["ef"]
    assert not torch.equal(ef.local((0, 0)), ef.local((1, 0)))
    ckpt.save(tmp_path, 2, states)
    saved = np.load(tmp_path / "step_00000002" / "trainer_ef.npy")
    assert np.array_equal(saved, ef.local((0, 0)).numpy())
    got, _ = ckpt.restore(tmp_path, states)
    for d in range(2):
        assert torch.equal(got["trainer"]["ef"].local((d, 0)), ef.local((0, 0)))


def test_fail_stop_resumed_onto_another_mesh(tmp_path):
    exe, _ = executor((2, 4), checkpoint_cb=ckpt.callback(tmp_path, blocking=True),
                      checkpoint_every=2)
    straight = []
    st = exe.init(0)
    for _ in range(8):
        st = exe.run(st, 1).states
        straight.append(float(st["trainer"]["metrics"]["loss"]))
    exe2, ctx2 = executor((4, 2))
    states, step = elastic.elastic_resume(str(tmp_path), exe2, ctx2)
    assert step == 6  # the checkpoint of the buffer before step 6
    resumed = []
    for t in range(step, 8):
        states = exe2.run(states, 1, start_step=t).states
        resumed.append(float(states["trainer"]["metrics"]["loss"]))
    assert all(abs(a - b) <= 1e-5 * abs(a) for a, b in zip(straight[step:], resumed))
    assert int(unshard(states["trainer"])["opt"]["step"]) == 8


def test_paths_of_a_mesh_checkpoint_are_jax_names(saved):
    _, d, states = saved
    names = {p.name for p in pathlib.Path(d / "sharded" / "step_00000002").iterdir()}
    assert "trainer_params_segments_0_attn_wq.npy" in names and "manifest.json" in names
