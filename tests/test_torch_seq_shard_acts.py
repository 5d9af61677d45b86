"""Sequence-parallel activations (``ShardCtx.seq_shard_acts``, Megatron-SP),
port only: reduced configs in f32 on a (2, 4) data x model mesh of CPU
devices, FSDP.

With the flag, the residual between the sub-blocks of every attention
layer is a ``Sharded`` leaf laid out (data, model, None): each member
holds its rows of the batch and its block of the sequence, its own
allocation.  The normed activation is gathered before the
column-parallel products, and ``wo`` and ``w2`` reduce-scatter their
f32 partials into that layout (``layers.matmul(..., scatter=)``).
Without the flag the same mesh norms the same row tiles of a whole
residual (``layers.norm_gather``), so the two runs are held bitwise:
the loss and every grad leaf (``lm_cells._value_and_grad``, what the
trainer differentiates) under ``remat`` full and none, for internlm2,
granite-moe, deepseek-v3 (its dense MLA layers, then MoE layers with a
shared expert) and mamba2 (no attention layer: nothing is laid out, as
JAX's ``mamba`` layers return before its constraint); two steps of the
trainer program give the same losses and params bitwise.  A sequence of 30 on a
model axis of 4 lays nothing out and falls back bitwise; a batch the
data axis does not divide keeps the sequence split, its batch entry
None."""

import dataclasses

import pytest
import torch

from repro_torch import api as tmiso
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import LOCAL, P, ShardCtx, Sharded, unshard
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import lm_cells as TL
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves, tree_paths

cap_threads_for_xdist()

MESH = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
BATCH, SEQ = 8, 32


def config(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def ctx_of(cfg, sp, remat="full", mesh=MESH):
    return make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, fsdp=True,
                    seq_shard_acts=sp, remat=remat)


def tokens_of(cfg, batch=BATCH, seq=SEQ):
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=torch.Generator().manual_seed(1))


def value_and_grad(cfg, sp, remat, tokens, watch=None):
    """``_value_and_grad`` on the mesh from seed 0's params; ``watch``
    (a list) receives every layer's output residual."""
    ctx = ctx_of(cfg, sp, remat)
    params = TL.place_params(cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), ctx)
    if watch is None:
        return TL._value_and_grad(cfg, params, {"tokens": tokens}, ctx)
    layer = T._layer_apply

    def watched(*a, **k):
        out = layer(*a, **k)
        watch.append(out[0])
        return out

    T._layer_apply = watched
    try:
        return TL._value_and_grad(cfg, params, {"tokens": tokens}, ctx)
    finally:
        T._layer_apply = layer


def assert_bitwise(a, b, what):
    (ma, ga), (mb, gb) = a, b
    assert torch.equal(ma["loss"], mb["loss"]), what
    paths = tree_paths(ga)
    assert paths == tree_paths(gb)
    bad = [p for p, x, y in zip(paths, tree_leaves(unshard(ga)), tree_leaves(unshard(gb)))
           if not torch.equal(x, y)]
    assert not bad, f"{what}: grads differ at {bad}"


def check_arch_bitwise(arch, remat):
    """(cfg, the SP run's layer outputs) of an arch held bitwise."""
    cfg = config(arch)
    toks = tokens_of(cfg)
    plain = value_and_grad(cfg, False, remat, toks)
    watch: list = []
    sp = value_and_grad(cfg, True, remat, toks, watch)
    assert_bitwise(plain, sp, f"{arch} remat={remat}")
    return cfg, watch


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m", "deepseek-v3-671b",
                                  "mamba2-2.7b"])
def test_sp_loss_and_grads_bitwise_the_mesh_run_without_it(arch, remat):
    cfg, watch = check_arch_bitwise(arch, remat)
    assert len(watch) >= cfg.n_layers
    attention = arch != "mamba2-2.7b"  # JAX's mamba layers return before the constraint
    assert all(isinstance(h, Sharded) == attention for h in watch)


def test_residual_is_laid_out_by_members_between_layers():
    cfg = config("internlm2-1.8b")
    watch: list = []
    value_and_grad(cfg, True, "none", tokens_of(cfg), watch)
    assert len(watch) == cfg.n_layers
    for h in watch:
        assert isinstance(h, Sharded) and tuple(h.spec) == ("data", "model", None)
        assert tuple(h.shape) == (BATCH, SEQ, cfg.d_model)
        ptrs = set()
        for c in h.coords():
            t = h.local(c)
            assert t.device == MESH.devices[c] and t.is_contiguous()
            assert tuple(t.shape) == (BATCH // 2, SEQ // 4, cfg.d_model)
            blk = h.block(c)
            assert (blk[0].start, blk[1].start) == (c[0] * BATCH // 2, c[1] * SEQ // 4)
            ptrs.add(t.data_ptr())
        assert len(ptrs) == 8  # each member's block its own allocation


def test_a_sequence_the_model_axis_does_not_divide_falls_back_bitwise():
    cfg = config("internlm2-1.8b")
    toks = tokens_of(cfg, seq=30)
    plain = value_and_grad(cfg, False, "full", toks)
    watch: list = []
    sp = value_and_grad(cfg, True, "full", toks, watch)
    assert_bitwise(plain, sp, "S = 30")
    assert watch and not any(isinstance(h, Sharded) for h in watch)


def test_a_batch_the_data_axis_does_not_divide_keeps_the_sequence_split():
    cfg = config("internlm2-1.8b")
    toks = tokens_of(cfg, batch=3)
    plain = value_and_grad(cfg, False, "none", toks)
    watch: list = []
    sp = value_and_grad(cfg, True, "none", toks, watch)
    assert_bitwise(plain, sp, "B = 3")
    assert all(tuple(h.spec) == (None, "model", None) for h in watch)
    assert all(len({h.local(c).data_ptr() for c in h.coords()}) == 4 for h in watch)


def test_seq_spec_rules():
    ctx = ShardCtx(mesh=MESH)
    assert ctx.seq_spec((8, 32, 4)) == P("data", "model", None)
    assert ctx.seq_spec((3, 32, 4)) == P(None, "model", None)
    assert ctx.seq_spec((8, 30, 4)) is None and ctx.seq_spec((8, 1, 4)) is None
    assert ShardCtx(mesh=MESH, tp_off=True).seq_spec((8, 32, 4)) is None
    assert ShardCtx(mesh=MESH, manual_axes=("data",)).seq_spec((8, 32, 4)) == P(None, "model", None)
    assert ShardCtx(mesh=MESH, manual_axes=("data", "model")).seq_spec((8, 32, 4)) is None
    assert LOCAL.seq_spec((8, 32, 4)) is None
    assert ShardCtx(seq_shard_acts=True).seq_shard_acts


def test_trainer_program_losses_and_params_bitwise():
    cfg = config("internlm2-1.8b")
    tcfg = TL.TrainConfig(data=DataConfig(batch=BATCH, seq_len=SEQ, vocab=cfg.vocab_size),
                          opt=OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10))
    runs = []
    for sp in (False, True):
        exe = tmiso.compile(TL.make_train_program(cfg, tcfg, ctx_of(cfg, sp)), backend="host",
                            device="cpu")
        st, losses = exe.init(0), []
        for t in range(2):
            st = exe.run(st, 1, start_step=t).states
            losses.append(st["trainer"]["metrics"]["loss"])
        runs.append((losses, unshard(st["trainer"]["params"])))
    (la, pa), (lb, pb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pa), tree_leaves(pb)))
