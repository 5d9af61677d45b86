"""Checkpoints (``repro_torch.checkpoint.ckpt``) and fail-stop resume
(``repro_torch.ft.elastic``): a round trip of every leaf type; the SAME
on-disk format as the JAX package's, so a checkpoint written by either
package restores bitwise in the other (bf16 included) and both write the
same manifest; a corrupted leaf is detected by its CRC; and a train run
that crashes and resumes from its latest checkpoint ends bitwise equal
to an uninterrupted one."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch import api as tmiso
from repro_torch import bridge
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_reduced
from repro_torch.core.fault import bitcast_int
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft import elastic
from repro_torch.models.lm_cells import TrainConfig, make_train_program
from repro_torch.optim.adamw import OptConfig
from repro_torch.tree import tree_leaves
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def numpy_state(seed=0):
    """A program-state-like tree of every leaf type the trainer holds."""
    rng = np.random.default_rng(seed)
    return {
        "data": {"key": rng.integers(0, 2**32, (2,), dtype=np.uint64).astype(np.uint32),
                 "tokens": rng.integers(0, 256, (2, 8)).astype(np.int32)},
        "trainer": {
            "metrics": {"loss": np.float32(rng.standard_normal())},
            "params": {"embed": rng.standard_normal((16, 8)).astype(np.float32),
                       "segments": [{"w": rng.standard_normal((2, 8, 8)).astype(np.float32)}]},
            "opt": {"step": np.int32(7), "q": rng.integers(-127, 128, (4, 256)).astype(np.int8),
                    "flags": rng.integers(0, 2, (3,)).astype(bool)},
        },
    }


def bf16_state(seed=0):
    st = numpy_state(seed)
    st["trainer"]["params"]["embed"] = np.asarray(
        jnp.asarray(st["trainer"]["params"]["embed"], jnp.bfloat16))
    return st


def bits_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(bitcast_int(x.cpu()), bitcast_int(y.cpu())) for x, y in zip(la, lb))


def test_round_trip_every_leaf_type(tmp_path):
    st = bridge.states_from_numpy(bf16_state(), device="cpu")
    assert st["trainer"]["params"]["embed"].dtype == torch.bfloat16
    assert st["data"]["key"].dtype == torch.uint32
    ckpt.save(tmp_path, 4, st)
    assert ckpt.latest_step(tmp_path) == 4
    got, step = ckpt.restore(tmp_path, st)
    assert step == 4 and bits_equal(got, st)


def test_jax_writes_the_port_restores_bitwise(tmp_path):
    jst = jax.tree.map(jnp.asarray, bf16_state(1))
    jckpt.save(tmp_path, 3, jst)
    like = bridge.states_from_numpy(bf16_state(2), device="cpu")
    got, step = ckpt.restore(tmp_path, like)
    assert step == 3
    assert bits_equal(got, bridge.states_from_numpy(jax.tree.map(np.asarray, jst), device="cpu"))


def test_the_port_writes_jax_restores_bitwise(tmp_path):
    st = bridge.states_from_numpy(bf16_state(3), device="cpu")
    ckpt.save(tmp_path, 6, st)
    jlike = jax.tree.map(jnp.asarray, bf16_state(4))
    got, step = jckpt.restore(tmp_path, jlike)
    assert step == 6
    assert got["trainer"]["params"]["embed"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree.leaves(got), tree_leaves(st)):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert (a.view(f"u{a.dtype.itemsize}") if a.dtype != bool else a).tobytes() == \
            bitcast_int(b).numpy().tobytes()


def test_both_packages_write_the_same_manifest(tmp_path):
    ckpt.save(tmp_path / "t", 2, bridge.states_from_numpy(bf16_state(5), device="cpu"))
    jckpt.save(tmp_path / "j", 2, jax.tree.map(jnp.asarray, bf16_state(5)))
    mt = json.loads((tmp_path / "t" / "step_00000002" / "manifest.json").read_text())
    mj = json.loads((tmp_path / "j" / "step_00000002" / "manifest.json").read_text())
    assert mt == mj
    for f in (tmp_path / "j" / "step_00000002").glob("*.npy"):
        assert f.read_bytes() == (tmp_path / "t" / "step_00000002" / f.name).read_bytes(), f.name


def test_a_corrupted_leaf_is_detected(tmp_path):
    st = bridge.states_from_numpy(numpy_state(), device="cpu")
    ckpt.save(tmp_path, 1, st)
    f = tmp_path / "step_00000001" / "trainer_params_embed.npy"
    raw = bytearray(f.read_bytes())
    raw[-5] ^= 0x10  # one bit of the data, past the header
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corrupted"):
        ckpt.restore(tmp_path, st)
    got, _ = ckpt.restore(tmp_path, st, verify=False)
    assert not bits_equal(got, st)


def test_only_committed_checkpoints_count(tmp_path):
    st = bridge.states_from_numpy(numpy_state(), device="cpu")
    assert ckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", st)
    ckpt.save(tmp_path, 2, st)
    (tmp_path / "step_00000009").mkdir()  # a write that never committed
    assert ckpt.latest_step(tmp_path) == 2
    t = ckpt.save(tmp_path, 4, st, blocking=False)
    t.join()
    assert ckpt.latest_step(tmp_path) == 4


def test_restore_lays_leaves_out_on_a_mesh(tmp_path):
    """``restore(shardings=)`` lays each leaf out by its NamedSharding (a
    None leaves it as ``like``'s), bitwise; ``elastic_restore`` with a
    ``ShardCtx`` and ``pspec_fn`` does the same on the ctx's mesh, and a
    sharded state saves the unsharded files.  (Whole trainers on meshes:
    ``tests/test_torch_elastic_mesh.py``.)"""
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import P, NamedSharding, ShardCtx, Sharded, unshard
    from repro_torch.tree import tree_map

    st = bridge.states_from_numpy(numpy_state(), device="cpu")
    ckpt.save(tmp_path, 0, st)
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    specs = tree_map(lambda _: None, st)
    specs["trainer"]["params"]["embed"] = NamedSharding(mesh, P("data", "model"))
    specs["trainer"]["opt"]["q"] = NamedSharding(mesh, P(None, ("data", "model")))
    got, _ = ckpt.restore(tmp_path, st, shardings=specs)
    emb = got["trainer"]["params"]["embed"]
    assert isinstance(emb, Sharded) and tuple(emb.local((1, 3)).shape) == (8, 2)
    assert got["trainer"]["opt"]["q"].local((1, 3)).shape == (4, 32)
    assert not isinstance(got["trainer"]["opt"]["step"], Sharded)
    assert bits_equal(unshard(got), st)
    ctx = ShardCtx(mesh=mesh)
    got2, _ = elastic.elastic_restore(str(tmp_path), st, ctx,
                                      lambda c, like: tree_map(
                                          lambda x: P("data") if x.dim() and x.shape[0] % 2 == 0
                                          else P(), like))
    assert bits_equal(unshard(got2), st) and got2["data"]["tokens"].spec == P("data")
    ckpt.save(tmp_path / "again", 0, got2)
    for leaf in (tmp_path / "step_00000000").iterdir():
        assert leaf.read_bytes() == (tmp_path / "again" / "step_00000000" / leaf.name).read_bytes()


def train_program():
    cfg = get_reduced("internlm2-1.8b")  # bf16 params, f32 master and moments
    tcfg = TrainConfig(data=DataConfig(batch=2, seq_len=16, vocab=cfg.vocab_size),
                       opt=OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10))
    return make_train_program(cfg, tcfg)


def test_fail_stop_resume_is_bitwise_an_uninterrupted_run(tmp_path):
    """Checkpoint every 2 steps, crash after step 5 (states dropped),
    restore the latest intact checkpoint through ``elastic_resume`` and
    run to step 8: bitwise the uninterrupted 8-step run."""
    prog = train_program()
    exe = tmiso.compile(prog, backend="host", device="cpu",
                        checkpoint_cb=ckpt.callback(tmp_path, blocking=True), checkpoint_every=2)
    states = exe.run(exe.init(0), 6, start_step=0).states
    del states  # the fail-stop
    assert ckpt.latest_step(tmp_path) == 4
    log = elastic.FailureLog()
    log.record(6, "fail-stop", "simulated")
    states, step = elastic.elastic_resume(str(tmp_path), exe)
    assert step == 4 and log.events[0]["kind"] == "fail-stop"
    resumed = exe.run(states, 8 - step, start_step=step).states
    straight = tmiso.compile(prog, backend="host", device="cpu").run(
        tmiso.compile(prog, backend="host", device="cpu").init(0), 8).states
    assert bits_equal(resumed, straight)
    assert int(resumed["trainer"]["opt"]["step"]) == 8


def test_elastic_restore_places_on_a_device(tmp_path):
    st = bridge.states_from_numpy(numpy_state(), device="cpu")
    ckpt.save(tmp_path, 5, st)
    got, step = elastic.elastic_restore(str(tmp_path), st, "cpu")
    assert step == 5 and bits_equal(got, st)
    assert pathlib.Path(tmp_path, "step_00000005", "manifest.json").exists()
