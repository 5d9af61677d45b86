"""``ShardCtx.remat`` in the port's training forward against JAX's
per-layer ``jax.checkpoint`` (``src/repro/models/transformer.py``).

For a reduced f32 internlm2 and a reduced MoE arch: the loss and every
grad are bitwise equal across ``remat`` none / full / dots (the
recomputation runs the same operators on the same inputs), and within
1e-5 of JAX's ``loss_fn`` grads under the same ``remat``.  That the
policy really applies is seen in what autograd keeps and in what the
backward recomputes: ``"full"`` and ``"dots"`` keep only each layer's
inputs outside the checkpoint, ``"none"`` everything; ``"full"``
recomputes every product, ``"dots"`` no unbatched one; a member's FSDP
block is kept once, never copied.  On a (2, 4) FSDP mesh
the grads are bitwise equal across the modes too, and a forward with
grad disabled (serving) saves nothing under any mode."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_reduced as jget
from repro.distributed import sharding as JS
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_reduced as tget
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import lm_cells as TL
from repro_torch.models import transformer as T
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves

cap_threads_for_xdist()

ARCHS = ["internlm2-1.8b", "granite-moe-1b-a400m"]
MODES = ["none", "full", "dots"]


def configs(arch):
    jc, tc = jget(arch), tget(arch)
    return dc.replace(jc, dtype="float32", n_layers=2), dc.replace(tc, dtype="float32", n_layers=2)


def inputs(arch):
    jc, tc = configs(arch)
    params = JT.init_params(jc, jax.random.PRNGKey(3))
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    return jc, tc, params, toks


def port_grads(tc, tparams, toks, remat, ctx=S.LOCAL):
    ctx = dc.replace(ctx, remat=remat)
    m, g = TL._value_and_grad(tc, tparams, {"tokens": torch.from_numpy(toks)}, ctx)
    return m, [x.full() if isinstance(x, S.Sharded) else x for x in tree_leaves(g)]


def bits(x):
    return x.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_bitwise_across_modes_and_within_1e5_of_jax(arch):
    jc, tc, params, toks = inputs(arch)
    tparams = bridge.params_from_numpy(tc, jax.tree.map(np.asarray, params), device="cpu")
    runs = {r: port_grads(tc, tparams, toks, r) for r in MODES}
    m0, g0 = runs["none"]
    for r in ("full", "dots"):
        m, g = runs[r]
        assert torch.equal(bits(m["loss"]), bits(m0["loss"])), r
        assert all(torch.equal(bits(a), bits(b)) for a, b in zip(g, g0)), r
    for r in MODES:
        jctx = dc.replace(JS.LOCAL, remat=r)
        (jloss, _), jg = jax.value_and_grad(
            lambda p: JT.loss_fn(jc, p, {"tokens": jnp.asarray(toks)}, ctx=jctx),
            has_aux=True)(params)
        m, g = runs[r]
        assert abs(float(jloss) - float(m["loss"])) <= 1e-5 * abs(float(jloss))
        for a, b in zip(jax.tree.leaves(jg), g):
            a = np.asarray(a, np.float64)
            err = np.linalg.norm(a - b.double().numpy())
            assert err <= 1e-5 * max(np.linalg.norm(a), 1e-30), r


class Ops(TorchDispatchMode):
    """Counts the products with no batch dimension (``mm``/``addmm``)
    and every operator dispatched."""

    def __init__(self):
        super().__init__()
        self.mm = self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))




@pytest.mark.parametrize("arch", ARCHS)
def test_the_policy_decides_what_the_backward_keeps(arch):
    """``"none"`` keeps every activation; ``"full"`` and ``"dots"`` keep
    only each layer's inputs outside the checkpoint.  In the backward
    ``"full"`` recomputes every product of a layer, ``"dots"`` none of
    the unbatched ones (their saved outputs are reused) but the rest."""
    _, tc, params, toks = inputs(arch)
    tparams = bridge.params_from_numpy(tc, jax.tree.map(np.asarray, params), device="cpu")
    kept = {r: sum(saved_storages(tc, tparams, toks, r).values()) for r in MODES}
    assert kept["full"] == kept["dots"] < kept["none"] / 4, kept
    count = {}
    for r in MODES:
        with Ops() as c:
            port_grads(tc, tparams, toks, r)
        count[r] = (c.mm, c.ops)
    assert count["none"][0] == count["dots"][0] < count["full"][0], count
    assert count["none"][1] < min(count["dots"][1], count["full"][1]), count


def test_fsdp_mesh_grads_bitwise_across_modes():
    _, tc, params, toks = inputs("internlm2-1.8b")
    tparams = bridge.params_from_numpy(tc, jax.tree.map(np.asarray, params), device="cpu")
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh, fsdp=True, vocab_size=tc.vocab_size, d_model=tc.d_model)
    sp = S.shard(tparams, S.param_pspecs(ctx, tparams, tc), mesh)
    runs = {r: port_grads(tc, sp, toks, r, ctx) for r in MODES}
    _, g0 = runs["none"]
    for r in ("full", "dots"):
        assert all(torch.equal(bits(a), bits(b)) for a, b in zip(runs[r][1], g0)), r
    _, gl = port_grads(tc, tparams, toks, "none")
    for a, b in zip(g0, gl):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)


def saved_storages(tc, params, toks, remat, ctx=S.LOCAL) -> dict:
    """data_ptr -> bytes of every storage autograd keeps outside a
    checkpoint."""
    seen: dict = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        port_grads(tc, params, toks, remat, ctx)
    return seen


def test_an_fsdp_block_is_kept_once():
    """Sharded weights reach ``layers.matmul`` through the checkpointed
    closure: under ``"full"`` the backward keeps what the unsharded
    model keeps (within 1 %: the members' masks of the vocab-sharded
    embedding), and under ``"none"`` each member's FSDP block is kept as
    the block itself, never a copy."""
    _, tc, params, toks = inputs("internlm2-1.8b")
    tparams = bridge.params_from_numpy(tc, jax.tree.map(np.asarray, params), device="cpu")
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh, fsdp=True, vocab_size=tc.vocab_size, d_model=tc.d_model)
    sp = S.shard(tparams, S.param_pspecs(ctx, tparams, tc), mesh)
    blocks = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
              for x in tree_leaves(sp) for _, t in x.distinct()}
    full = saved_storages(tc, sp, toks, "full", ctx)
    local = saved_storages(tc, tparams, toks, "full")
    assert sum(full.values()) <= 1.01 * sum(local.values())
    none = saved_storages(tc, sp, toks, "none", ctx)
    assert sum(n for k, n in none.items() if k in blocks) == sum(blocks.values())


@pytest.mark.parametrize("remat", MODES)
def test_a_forward_without_grad_saves_nothing(remat):
    _, tc, params, toks = inputs("internlm2-1.8b")
    tparams = bridge.params_from_numpy(tc, jax.tree.map(np.asarray, params), device="cpu")
    saved = []
    with torch.no_grad(), torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        logits, _ = T.forward(tc, tparams, torch.from_numpy(toks),
                              ctx=dc.replace(S.LOCAL, remat=remat))
    ref, _ = T.forward(tc, tparams, torch.from_numpy(toks), ctx=dc.replace(S.LOCAL, remat="none"))
    assert not saved and torch.equal(bits(logits), bits(ref))
