"""The dry-run's counts (``launch/dryrun.py``, ``distributed/wire.py``),
port only.

  * FLOPs: a reduced train step on a (2, 4) FSDP mesh counts exactly the
    FLOPs of the unsharded step (every member's products once), with
    ``remat`` none or dots (see the test for full);
  * wire: the meter's totals equal hand counts from the ring-model
    factors for a column- and a row-parallel ``layers.matmul`` (NVLink:
    the model axis), an FSDP all-gather and the local half of a
    reduce-scatter (``sharding.reshard``; network: the data axis), an
    FSDP weight's all-gather in ``layers.matmul`` and its gradient's
    reduce-scatter (network), and a
    ZeRO-1 step's two movements: the gradient all-reduce over the members
    that hold each block, and the all-gather of the new params from the
    moments' layout;
  * the records (``run_cell``, the CLI) in ``test_torch_dryrun_cli.py``."""

import dataclasses
import math

import pytest
import torch

from repro_torch import api as tmiso
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import make_mesh, wire
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import layers as L
from repro_torch.models import lm_cells as TL
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves

cap_threads_for_xdist()



def mesh24():
    return make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)


def step_flops(cfg, ctx):
    tcfg = TL.TrainConfig(data=DataConfig(batch=8, seq_len=32, vocab=cfg.vocab_size))
    prog = TL.make_train_program(cfg, tcfg, ctx)
    states = D.abstract_states(prog)
    exe = tmiso.compile(prog, backend="lockstep", device="cpu")
    return D.abstract_step(lambda: exe.pure_step(states, 0))


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_a_sharded_step_counts_the_unsharded_flops(remat):
    """Exactly, where the backward recomputes all of a layer's products or
    none.  (Under ``"full"`` the recomputation stops as soon as it has
    made what the backward reads, torch's early stop, and a sharded
    layer's last product is split into parts whose inputs the backward
    reads, so it recomputes more of them: held as at least.)"""
    cfg = dataclasses.replace(get_reduced("internlm2-1.8b"), dtype="float32")
    ctx = make_ctx(mesh24(), fsdp=True, vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                   remat=remat)
    sharded = step_flops(cfg, ctx)
    local = step_flops(cfg, dataclasses.replace(S.LOCAL, remat=remat))
    assert sharded["flops"] == local["flops"] > 0
    assert local["wire"] == 0 and sharded["wire"] > 0
    if remat == "none":
        ctx = dataclasses.replace(ctx, remat="full")
        full = step_flops(cfg, ctx)["flops"]
        assert full >= step_flops(cfg, S.LOCAL)["flops"] > local["flops"]


def test_column_and_row_parallel_matmul_wire():
    mesh = mesh24()
    x = torch.randn(4, 8, 64)
    col = S.shard_leaf(torch.randn(64, 128), S.P(None, "model"), mesh)
    row = S.shard_leaf(torch.randn(128, 64), S.P("model", None), mesh)
    with wire.meter() as m:
        y = L.matmul(x, col)
    out = y.numel() * 4                       # the gathered output, every range
    assert m.total == 4 * out * 3 / 4 == m.by_link["nvlink"] == m.by_op["all-gather"]
    with wire.meter() as m:
        z = L.matmul(y, row)
    part = z.numel() * 4                      # each part's f32 product
    assert m.total == 4 * 2 * part * 3 / 4 == m.by_link["nvlink"] == m.by_op["all-reduce"]
    assert m.by_site == {"matmul": m.total}


def test_fsdp_all_gather_and_reduce_scatter_wire():
    mesh = mesh24()
    x = S.shard_leaf(torch.randn(16, 64), S.P("data", None), mesh)
    with wire.meter() as m:
        full = S.reshard(x, S.P())
    # each of 8 members receives the half it does not hold
    assert m.total == 8 * (8 * 64 * 4) == m.by_link["network"]
    with wire.meter() as m:
        S.reshard(full, S.P("data", None))
    assert m.total == 0  # the local half of a reduce-scatter: a slice


def test_fsdp_matmul_gathers_the_weight_wire():
    mesh = mesh24()
    x = torch.randn(4, 8, 64)
    w = S.shard_leaf(torch.randn(64, 128), S.P("data", "model"), mesh)
    with wire.meter() as m:
        y = L.matmul(x, w)
    # every member gathers, over the 2 data members, the (64, 32) block
    # that the model axis leaves it; the output ranges joined over model
    gathered = 64 * 32 * 4
    assert m.by_site["fsdp"] == 8 * gathered * 1 / 2 == m.by_link["network"]
    assert m.by_site["matmul"] == 4 * y.numel() * 4 * 3 / 4 == m.by_link["nvlink"]
    assert m.by_op["all-reduce"] == 0.0  # no partial sums over the data axis


@pytest.mark.parametrize("shape,axes,k", [((2, 4), ("data", "model"), 1),
                                          ((2, 2, 2), ("pod", "data", "model"), 2)])
def test_fsdp_grad_reduce_scatter_wire(shape, axes, k):
    mesh = make_mesh(shape, axes, devices=["cpu"] * 8)
    w = S.shard_leaf(torch.randn(64, 128), S.P("data", "model"), mesh)
    with wire.meter() as m:
        TL._record_grad_sums(w)
    # each distinct (32, 128 / model) block is held by k members (the pod
    # axis): a reduce-scatter over the 2 data members, then an all-reduce
    # over k
    n = 32 * (128 // shape[-1]) * 4
    blocks = 8 // k
    assert m.by_op["reduce-scatter"] == blocks * k * n * (2 - 1) == m.by_site["fsdp"]
    assert m.by_op["all-reduce"] == blocks * k * 2 * n * (k - 1) / k == m.by_site.get("grad", 0.0)
    assert m.by_link == {"nvlink": 0.0, "network": m.total}


def test_zero1_step_wire():
    cfg = dataclasses.replace(get_reduced("internlm2-1.8b"), dtype="float32")
    mesh = mesh24()
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt_cfg = OptConfig()
    st = TL.place_train_state(cfg, ctx, {"params": params, "opt": init_opt_state(params, opt_cfg),
                                         "metrics": {}})
    toks = torch.randint(0, cfg.vocab_size, (8, 16), generator=torch.Generator().manual_seed(1))
    with wire.meter() as m:
        _, grads = TL._value_and_grad(cfg, st["params"], {"tokens": toks}, ctx)
    # the gradient of each block, summed over the members that hold it
    hand = 0.0
    for p in tree_leaves(st["params"]):
        held: dict = {}
        for c in p.coords():
            held[S._key(p.block(c))] = held.get(S._key(p.block(c)), 0) + 1
        for key, k in held.items():
            n = math.prod(b - a for a, b in key) * p.dtype.itemsize
            hand += k * 2 * n * (k - 1) / k
    assert m.by_site["grad"] == hand > 0
    with wire.meter() as m:
        apply_updates(st["params"], grads, st["opt"], opt_cfg)
    # each member receives the part of its param block that its moment
    # block (param spec + the data axis) does not hold
    hand = 0.0
    for p, mo in zip(tree_leaves(st["params"]), tree_leaves(st["opt"]["m"])):
        for c in p.coords():
            hand += S._foreign(p.block(c), mo.block(c)) * p.dtype.itemsize
    assert m.by_site.get("reshard", 0.0) == hand > 0
    assert "region" not in m.by_site and m.by_link["nvlink"] == 0
