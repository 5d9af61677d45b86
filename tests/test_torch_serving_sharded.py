"""Serving under a ``ShardCtx``: the reduced f32 internlm2 engine with its
weights and dense cache sharded over a (2, 4) data x model mesh of CPU
devices (``lm_engine_parts(cfg, scfg, ctx)``, ``make_ctx(...,
decode_shardmap=True)``) against the port's unsharded engine from the
same seed.

A staggered stream of none/DMR/TMR requests must emit the unsharded
engine's tokens bitwise; a strike on one replica slot of a DMR and of a
TMR request must be detected, charged to the same request and replica
with the same ledger entry (totals and recent steps), and repaired; no
replica event on a clean run.  The decoder's cache leaves are sharded
(a slot's rows on its data member), every replicated weight leaf is one
tensor for the whole mesh, and the fixed-batch program
(``make_serve_program(cfg, scfg, ctx)``) decodes the unsharded one's
tokens."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api as miso
from repro_torch.configs import get_reduced
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import LOCAL, Sharded, param_pspecs
from repro_torch.launch.mesh import make_ctx
from repro_torch.models.lm_cells import ServeConfig, make_serve_program
from repro_torch.serving import DONE, Request
from repro_torch.serving.lm import lm_engine_parts
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import leaf_index, tree_leaves

cap_threads_for_xdist()

CFG = dataclasses.replace(get_reduced("internlm2-1.8b"), dtype="float32")
LEVELS = [1, 2, 3, 1, 2, 1, 3]
MESH = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
CTX = make_ctx(MESH, vocab_size=CFG.vocab_size, d_model=CFG.d_model, decode_shardmap=True)


def engine(ctx):
    eng = miso.serve(*lm_engine_parts(CFG, ServeConfig(batch=8, max_len=32), ctx, device="cpu"),
                     device="cpu")
    eng.start(0)
    return eng


def stream(eng, strike):
    """The staggered stream; ``strike``: the victim's request id, whose
    replica slot 1 takes a bit flip in its first decoded token."""
    ps = [np.random.default_rng(i).integers(0, CFG.vocab_size, size=k).astype(np.int32)
          for i, k in enumerate([5, 9, 3, 12, 7, 4, 6])]
    reqs = [Request(prompt=p, max_new_tokens=8, policy=miso.RedundancyPolicy(level=lv),
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
        dec = eng._states["decoder"]
        fault = miso.FaultSpec.at(step=eng.exe.metrics()["steps"] + 1,
                                  cell_id=eng.exe.program.cell_id("decoder"),
                                  leaf=leaf_index(dec, "tokens"), index=rec.slots[1], bit=4)
    eng.pump(faults=fault)
    m = eng.metrics()
    return ([eng.result(r.id) for r in reqs],
            {"totals": m["fault_totals"], "recent": eng.ledger.recent,
             "request_faults": m["request_faults"], "replays": m["replays"]})


@pytest.fixture(scope="module")
def runs():
    out = {}
    for strike in (None, "r4", "r6"):
        out[strike] = {name: stream(engine(ctx), strike)
                       for name, ctx in (("local", LOCAL), ("sharded", CTX))}
    return out


@pytest.mark.parametrize("strike", [None, "r4", "r6"])
def test_sharded_engine_tokens_equal_unsharded(runs, strike):
    local, sharded = runs[strike]["local"][0], runs[strike]["sharded"][0]
    for a, b in zip(local, sharded):
        assert a["status"] == b["status"] == DONE
        assert a["tokens"] == b["tokens"] and len(a["tokens"]) == 8
        assert a["faults"] == b["faults"]


@pytest.mark.parametrize("strike", [None, "r4", "r6"])
def test_sharded_engine_ledger_equals_unsharded(runs, strike):
    local, sharded = runs[strike]["local"][1], runs[strike]["sharded"][1]
    assert sharded == local
    if strike is None:
        assert sharded["totals"] == {} and sharded["replays"] == 0
    else:
        assert sharded["request_faults"] == {strike: 1}
        assert sharded["totals"][strike]["events"] == 1.0
        assert sharded["totals"][strike]["per_replica"][1] == 1.0


def test_sharded_engine_state_layout():
    eng = engine(CTX)
    st = eng._states
    k = st["decoder"]["cache"]["segments"][0]["k"]
    assert isinstance(k, Sharded) and k.local((1, 0)).shape[1] == 4  # 8 slots, 4 a data member
    assert not isinstance(st["decoder"]["tokens"], Sharded)
    specs = param_pspecs(CTX, st["weights"]["params"], CFG)
    n_rep = 0
    for x, spec in zip(tree_leaves(st["weights"]["params"]), tree_leaves(specs)):
        assert isinstance(x, Sharded) and x.spec == spec
        ptrs = {x.local(c).data_ptr() for c in x.coords()}
        if all(e is None for e in spec):
            assert len(ptrs) == 1  # one tensor for the whole mesh
            n_rep += 1
        else:
            assert len(ptrs) == len({tuple((s.start, s.stop) for s in x.block(c))
                                     for c in x.coords()})
    assert n_rep > 0


def test_static_program_with_ctx_equals_unsharded():
    toks = {}
    for name, ctx in (("local", LOCAL), ("sharded", CTX)):
        exe = miso.compile(make_serve_program(CFG, ServeConfig(batch=4, max_len=16), ctx),
                           backend="lockstep", device="cpu")
        st = exe.init(0)
        st["decoder"]["tokens"] = torch.arange(4, dtype=torch.int32).reshape(4, 1) + 7
        out = []
        for _ in range(6):
            st, _ = exe.step(st)
            out.append(st["decoder"]["tokens"].clone())
        toks[name] = torch.cat(out, dim=1)
    assert torch.equal(toks["local"], toks["sharded"])
