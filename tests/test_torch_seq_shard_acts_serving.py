"""Sequence-parallel activations (``ShardCtx.seq_shard_acts``) where the
port serves and where it replicates, port only, on a (2, 4) data x model
mesh of CPU devices with reduced internlm2 in f32.

Serving: a mesh engine (``lm_engine_parts(cfg, scfg, ctx)``,
``decode_shardmap=True``) whose prefill lays each attention layer's
residual out over the sequence (one prompt: the batch entry None) emits
the tokens of the same mesh's engine without the flag, bitwise, and
keeps the same ledger, with and without a strike on a replica slot;
decode (S = 1) lays nothing out.  Replication: a DMR trainer with the
flag on ``host`` (``.with_policies``, FSDP) has no event on a clean run,
and its two replicas end bitwise equal."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api as miso
from repro_torch.configs import get_reduced
from repro_torch.core import RedundancyPolicy
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import unshard
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import layers as L
from repro_torch.models import lm_cells as TL
from repro_torch.models.lm_cells import ServeConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.serving import DONE, Request
from repro_torch.serving.lm import lm_engine_parts
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import leaf_index, tree_leaves

cap_threads_for_xdist()

CFG = dataclasses.replace(get_reduced("internlm2-1.8b"), dtype="float32")
LEVELS = [1, 2, 3, 1, 2]
MESH = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)


def ctx_of(sp, **kw):
    return make_ctx(MESH, vocab_size=CFG.vocab_size, d_model=CFG.d_model, seq_shard_acts=sp, **kw)


def stream(sp, strike):
    """A staggered stream of none/DMR/TMR requests on a mesh engine;
    ``strike``: the request whose replica slot 1 takes a bit flip in its
    first decoded token.  Returns (results, ledger, the row-parallel
    products that reduce-scattered into a sequence-parallel residual)."""
    scattered = [0]
    matmul = L.matmul

    def counted(x, w, **kw):
        scattered[0] += kw.get("scatter") is not None
        return matmul(x, w, **kw)

    L.matmul = counted
    try:
        eng = miso.serve(*lm_engine_parts(CFG, ServeConfig(batch=8, max_len=32),
                                          ctx_of(sp, decode_shardmap=True), device="cpu"),
                         device="cpu")
        eng.start(0)
        ps = [np.random.default_rng(i).integers(0, CFG.vocab_size, size=k).astype(np.int32)
              for i, k in enumerate([5, 9, 3, 12, 7])]
        reqs = [Request(prompt=p, max_new_tokens=6, policy=miso.RedundancyPolicy(level=lv),
                        id=f"r{i}") for i, (p, lv) in enumerate(zip(ps, LEVELS))]
        for r in reqs[:3]:
            assert eng.submit(r)
        eng.pump(max_ticks=2)
        for r in reqs[3:]:
            assert eng.submit(r)
        fault = None
        if strike:
            rec = eng.requests[strike]
            while rec.status != "running":
                eng.pump(max_ticks=1)
            fault = miso.FaultSpec.at(step=eng.exe.metrics()["steps"] + 1,
                                      cell_id=eng.exe.program.cell_id("decoder"),
                                      leaf=leaf_index(eng._states["decoder"], "tokens"),
                                      index=rec.slots[1], bit=4)
        eng.pump(faults=fault)
        m = eng.metrics()
        return ([eng.result(r.id) for r in reqs],
                {"totals": m["fault_totals"], "recent": eng.ledger.recent,
                 "request_faults": m["request_faults"], "replays": m["replays"]}, scattered[0])
    finally:
        L.matmul = matmul


@pytest.fixture(scope="module")
def runs():
    return {strike: {sp: stream(sp, strike) for sp in (False, True)} for strike in (None, "r4")}


@pytest.mark.parametrize("strike", [None, "r4"])
def test_sp_engine_tokens_bitwise_the_mesh_engine_without_it(runs, strike):
    plain, sp = runs[strike][False], runs[strike][True]
    for a, b in zip(plain[0], sp[0]):
        assert a["status"] == b["status"] == DONE
        assert a["tokens"] == b["tokens"] and len(a["tokens"]) == 6
    assert plain[2] == 0 and sp[2] > 0  # the prefills reduce-scattered


@pytest.mark.parametrize("strike", [None, "r4"])
def test_sp_engine_ledger_bitwise_the_mesh_engine_without_it(runs, strike):
    plain, sp = runs[strike][False][1], runs[strike][True][1]
    assert sp == plain
    if strike is None:
        assert sp["totals"] == {} and sp["replays"] == 0
    else:
        assert sp["request_faults"] == {strike: 1}
        assert sp["totals"][strike]["per_replica"][1] == 1.0


def test_dmr_sp_trainer_has_no_clean_event_and_equal_replicas():
    tcfg = TL.TrainConfig(data=DataConfig(batch=8, seq_len=32, vocab=CFG.vocab_size),
                          opt=OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10))
    prog = TL.make_train_program(CFG, tcfg, ctx_of(True, fsdp=True)).with_policies(
        {"trainer": RedundancyPolicy(level=2)})
    exe = miso.compile(prog, backend="host", device="cpu")
    res = exe.run(exe.init(0), 3)
    assert exe.recoveries == [] and exe.metrics()["fault_totals"]["trainer"]["events"] == 0
    tr = unshard(res.states["trainer"])
    for x in tree_leaves({"params": tr["params"], "opt": tr["opt"]}):
        assert x.shape[0] == 2 and torch.equal(x[0], x[1])
