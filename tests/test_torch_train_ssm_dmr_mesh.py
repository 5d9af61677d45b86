"""A DMR mamba2 trainer whose state is laid out on a mesh, port only:
reduced mamba2 in f32, FSDP on a (2, 4) data x model mesh of CPU
devices, the ``host`` back-end, the launcher's strike
(``launch.train.strike``: trainer leaf 5, element 11, bit 19) at step 3.

Each member runs the scan and its backward on its own rows and heads,
the members' cotangents of a shared input summed in member order
(``models.ssm._Fanout``: the B/C group over the model members, a head's
``a_log`` and ``d_skip`` over the data members), so the two replicas'
bits agree: no event on a clean run's steps.  The strike gives one §IV
recovery at (3, trainer); the tie-break goes through K4's wrapper as on
the card (``ops.tiebreak_vote``, K4's plain version here, which the
executor's CPU path replaces by ``majority_vote``): one K4 call a device
holding the state (one on this mesh of CPU members) a tie-break.  The
repaired run's final state is bitwise the unstruck run's."""

import dataclasses

import pytest
import torch

from repro_torch import api as tmiso
from repro_torch.configs import get_reduced as tget
from repro_torch.core import RedundancyPolicy
from repro_torch.core import redundancy as R
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharding as S
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_ctx
from repro_torch.launch.train import strike
from repro_torch.models import lm_cells as TL
from repro_torch.optim.adamw import OptConfig
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

cap_threads_for_xdist()

ARCH = "mamba2-2.7b"
STEPS, STRIKE = 4, 3


def setup(shape=(2, 4)):
    cfg = dataclasses.replace(tget(ARCH), dtype="float32")
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, fsdp=True)
    tcfg = TL.TrainConfig(data=DataConfig(batch=8, seq_len=32, vocab=cfg.vocab_size),
                          opt=OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10))
    prog = TL.make_train_program(cfg, tcfg, ctx).with_policies(
        {"trainer": RedundancyPolicy(level=2)})
    return cfg, ctx, prog


def bits(tree) -> list:
    return [x.view(torch.int32) if x.dtype == torch.float32 else x
            for x in tree_leaves(S.unshard(tree))]


@pytest.fixture(scope="module")
def runs():
    """(struck executor, its final states, K4 calls; the clean ones)."""
    out = {}
    for struck in (True, False):
        _, _, prog = setup()
        exe = tmiso.compile(prog, backend="host", device="cpu")
        calls = []
        real_vote, real_k4 = R.majority_vote, ops.tmr_vote

        def via_k4(r0, r1, third):
            # the card's tie-break: both replicas packed, then K4 by device
            td = tree_flatten(r0)[1]
            box = [tree_unflatten(td, R.stack_replicas([tree_leaves(r0), tree_leaves(r1)]))]
            return ops.tiebreak_vote(box, lambda: third)[0]

        def k4(*a, **k):
            calls.append(a[0].device)
            return real_k4(*a, **k)

        R.majority_vote, ops.tmr_vote = via_k4, k4
        try:
            res = exe.run(exe.init(0), STEPS, faults=[strike(prog, STRIKE)] if struck else [])
        finally:
            R.majority_vote, ops.tmr_vote = real_vote, real_k4
        out[struck] = (exe, res.states, calls)
    return out


def test_clean_run_has_no_event(runs):
    exe, states, calls = runs[False]
    assert exe.metrics()["fault_totals"]["trainer"]["events"] == 0
    assert exe.recoveries == [] and calls == []
    tr = states["trainer"]
    assert all(torch.equal(a, b) for a, b in zip(bits(tr_rep(tr, 0)), bits(tr_rep(tr, 1))))


def tr_rep(tr, r):
    """Replica ``r`` of a replicated trainer state."""
    from repro_torch.tree import tree_map

    return tree_map(lambda x: x[r], tr)


def test_strike_recovers_once_through_k4_by_device(runs):
    exe, states, calls = runs[True]
    assert exe.recoveries == [(STRIKE, "trainer")]
    tot = exe.metrics()["fault_totals"]["trainer"]
    assert tot["events"] == 1.0
    devices = {str(t.device) for x in tree_leaves(states["trainer"])
               for t in ([b for _, b in x.distinct()] if isinstance(x, S.Sharded) else [x])}
    assert len(calls) == len(devices) * len(exe.recoveries) == 1


def test_repaired_state_is_bitwise_the_unstruck_one(runs):
    _, struck, _ = runs[True]
    _, clean, _ = runs[False]
    tr = struck["trainer"]
    assert all(isinstance(x, S.Sharded) for x in tree_leaves(tr["params"]))
    a_log = tr["params"]["segments"][0]["mamba"]["a_log"]
    assert tuple(a_log.spec)[0] is None  # the temporal replica entry
    assert all(torch.equal(a, b) for a, b in zip(bits(tr), bits(clean["trainer"])))
    assert all(torch.equal(a, b) for a, b in zip(bits(tr_rep(tr, 0)), bits(tr_rep(tr, 1))))
    assert torch.equal(R.fingerprint(tr), R.fingerprint(S.unshard(tr)))
