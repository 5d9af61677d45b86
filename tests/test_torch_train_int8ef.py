"""``grad_compression="int8_ef"`` on a (2, 4) data x model mesh against
the JAX package's trainer (the child and helpers of
``test_torch_train_spmd.py``), reduced internlm2 in f32, 3 steps.

At each step the child records JAX's compressed reduction of the step's
input state (``lm_cells._compressed_grads`` under its ``shard_map``):
each data member's grads on its rows, the mean, and both data members'
EF buffers before and after (read from their devices' shards; JAX
declares ``ef`` replicated while every data member writes its own, and
its host view, ``np.asarray``, is data member 0's).  Gates:

  * the trainer's reduction (``TL._compressed_grads``: flatten order,
    padding to ``512 x dp``, each data member's EF buffer, the new
    buffers) given the per-member grads JAX computed and JAX's EF
    buffers, against JAX's ``_compressed_grads`` given the same grads
    (handed to its ``shard_map`` with each member's rows): the mean
    within 1e-6 of JAX's and each member's new EF within 1e-6 of the
    norm of ``flat + ef``, the value it is the rounding residual of
    (XLA may fuse ``x - q * s`` into one rounding or not; the port
    rounds once, and the elements that differ differ by one rounding
    of ``x``, 2e-8 of its norm, while the residual is 1e-2 of it); JAX's
    host view of its trainer's ``ef`` is data member 0's;
  * each data member's grads, the port's own at JAX's state, within
    1e-5 of JAX's (the grads bound);
  * the port's own 3-step run from JAX's initial state: losses within
    1e-5; the two data members' EF buffers non-zero and different, one
    tensor a data member; the mean within the two hops' int8 rounding of
    the exact mean of ``flat + ef``;
  * without a mesh the trainer refuses ``int8_ef``.

Why both reductions take the same grads: int8 rounding has ties.  Grads
that agree to 1e-6 put a few of 127424 values on the other side of a
rounding tie (3 at step 0 here, the port's grads against JAX's; JAX's
grads compiled alone against those inside its trainer's ``shard_map``
too), each one quantization step (3e-5) apart; an EF buffer is the
rounding residual, whose relative error is the grads' absolute noise
over at most half a step; and once the EF buffers differ, the runs'
later means differ more.  So the 1e-6 bound holds the reduction on
equal inputs, the 1e-5 bound the grads, and the losses the run."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api as tmiso
from repro_torch import bridge
from repro_torch.distributed import collectives as C
from repro_torch.models import lm_cells as TL
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves

import test_torch_train_spmd as S

cap_threads_for_xdist()

STEPS = S.CASES["int8_ef"][4]


def member_flats(cfg, ctx, st):
    """Each data member's padded f32 grads and EF buffer for the state
    ``st``: the inputs of the trainer's compressed reduction."""
    loss_ctx = dataclasses.replace(ctx, manual_axes=tuple(ctx.data_axes))
    ef = st["trainer"]["ef"]
    flats, _ = TL.member_flats(lambda p, b: TL._value_and_grad(cfg, p, b, loss_ctx),
                               st["trainer"]["params"], {"tokens": st["data"]["tokens"]},
                               ef.shape[0], ctx)
    return flats, [ef.local((d, 0)) for d in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jres = S.run_child("int8_ef", tmp_path_factory)
    cfg, tcfg, ctx = S.port_setup("int8_ef")
    exe = tmiso.compile(TL.make_train_program(cfg, tcfg, ctx), backend="host", device="cpu")
    st = S.placed(cfg, ctx, jres["init"])
    out = {"efs": [], "losses": [], "hops": [], "forced": []}
    for step in range(STEPS):
        out["hops"].append(member_flats(cfg, ctx, st))
        st = exe.run(st, 1).states
        out["efs"].append(st["trainer"]["ef"])
        out["losses"].append(st["trainer"]["metrics"]["loss"])
    # JAX's input state of each step through the trainer's reduction
    for step in range(STEPS):
        rec = jres["means"][step]
        src = jres["init"]["trainer"] if step == 0 else jres["states"][step - 1]
        params = TL.place_train_state(
            cfg, ctx, bridge.states_from_numpy(
                {k: v for k, v in src.items() if k != "ef"}, device="cpu"))["params"]
        grads = iter([bridge.states_from_numpy(g, device="cpu") for g in rec["grads"]])
        zero = {"loss": torch.zeros(())}
        ef_in = TL.per_data_member([torch.from_numpy(e) for e in rec["ef_in"]], ctx)
        toks = torch.zeros((S.BATCH, S.SEQ), dtype=torch.int32)
        g, _, new_ef = TL._compressed_grads(lambda p, b: (zero, next(grads)), params,
                                            {"tokens": toks}, ef_in, ctx)
        out["forced"].append((torch.cat([x.reshape(-1) for x in tree_leaves(g)]), new_ef))
    return jres, out


@pytest.mark.parametrize("step", range(STEPS))
def test_reduction_within_1e6_of_jax(runs, step):
    jres, port = runs
    rec = jres["means"][step]
    mean, new_ef = port["forced"][step]
    S.close(rec["forced_mean"], mean, 1e-6, f"mean, step {step}")
    for d in range(2):
        # the residual's error is a rounding of the value it was cut
        # from, flat + ef, so it is held against that value's norm
        flat = np.concatenate([np.asarray(x, np.float64).ravel() for x in tree_leaves(rec["grads"][d])])
        x = np.asarray(rec["ef_in"][d], np.float64)
        x[:flat.size] += flat
        err = float(np.linalg.norm(new_ef.local((d, 0)).double().numpy() - rec["forced_ef"][d]))
        assert err <= 1e-6 * float(np.linalg.norm(x)), (d, step, err)
    assert np.array_equal(jres["efs"][step], rec["ef_out"][0])  # JAX's host view: member 0's
    assert torch.equal(new_ef.full(), new_ef.local((0, 0)))


@pytest.mark.parametrize("step", range(STEPS))
def test_member_grads_within_1e5_of_jax(runs, step):
    jres, port = runs
    cfg, _, ctx = S.port_setup("int8_ef")
    src = jres["init"]["trainer"] if step == 0 else jres["states"][step - 1]
    st = {"trainer": TL.place_train_state(cfg, ctx, bridge.states_from_numpy(src, device="cpu")),
          "data": {"tokens": batch_of(jres, step)}}
    flats, _ = member_flats(cfg, ctx, st)
    for d in range(2):
        want = np.concatenate([np.asarray(x, np.float32).ravel()
                               for x in tree_leaves(jres["means"][step]["grads"][d])])
        S.close(want, flats[d][:want.size], 1e-5, f"grads of data member {d}, step {step}")


def batch_of(jres, step) -> torch.Tensor:
    """The batch the trainer reads at ``step``: the data cell's state
    before it."""
    if step == 0:
        return torch.from_numpy(np.asarray(jres["init"]["data"]["tokens"]))
    return torch.from_numpy(np.asarray(jres["data_tokens"][step - 1]))


def test_losses_within_1e5_of_jax(runs):
    jres, port = runs
    for step in range(STEPS):
        S.close(jres["metrics"][step]["loss"], port["losses"][step], 1e-5, f"loss, step {step}")


def test_each_data_member_keeps_its_own_ef(runs):
    _, port = runs
    ef = port["efs"][-1]
    bufs = [ef.local((d, 0)) for d in range(2)]
    assert all(float(b.abs().sum()) > 0 for b in bufs)
    assert not torch.equal(bufs[0], bufs[1])
    for d in range(2):  # the model members of a data member share its buffer
        assert len({ef.local((d, m)).data_ptr() for m in range(4)}) == 1


@pytest.mark.parametrize("step", range(STEPS))
def test_mean_within_the_int8_rounding_of_the_exact_mean(runs, step):
    """|mean - exact| <= (the members' mean hop-1 scale + the hop-2
    scale) / 2 of each 512-element block, plus f32 slop."""
    _, port = runs
    flats, efs = port["hops"][step]
    got = C.compressed_psum_int8(flats, efs)[0][0]
    assert (flats[0].shape[0] // 2) % C._QBLOCK == 0  # member i quantizes chunk i of every x
    assert C.int8_mean_error(flats, efs, got) <= 1.0


def test_without_a_mesh_int8_ef_needs_a_data_mesh():
    cfg, tcfg, _ = S.port_setup("int8_ef")
    with pytest.raises(ValueError, match="data mesh"):
        TL.make_trainer_cell(cfg, tcfg)
