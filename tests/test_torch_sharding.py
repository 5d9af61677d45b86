"""The sharding rules (``repro_torch.distributed.sharding``) against the
JAX package's, and the port's sharded leaf.

JAX's spec functions read only ``mesh.shape`` and ``mesh.axis_names``,
so they run here in process on a duck-typed mesh (no devices are
forced): every leaf's spec from ``param_pspecs`` and ``cache_pspecs``
must equal JAX's as a tuple, on the reduced params and caches of all ten
archs (JAX's trees from ``jax.eval_shape``, the port's on the ``meta``
device), on a (2, 4) data x model mesh and a (2, 2, 2) pod x data x
model mesh, with the pod axis carrying data or the replicas, FSDP on and
off, ``tp_off`` and ``serve_ep2d``; ``zero_pspecs`` on the AdamW state
of one arch (plain and quantized moments).  Then ``make_ctx``'s
embedding choice, ``shard``/``unshard`` round trips (bitwise, and one
allocation a member except where a replicated block is shared on one
device), the mesh's member addressing, the model-axis collectives, the
refusals (a mesh under mamba2, a paged MLA or a spatial engine, the
``ShardCtx`` fields the port does not honour, a sharded decode cache
without ``decode_shardmap``), ``constrain``'s assertion and ``block_k``
reaching the prefill, and the fallback of a layout that neither
divides."""

import dataclasses
import functools

import jax
import pytest
import torch

from repro.configs import get_reduced as jget
from repro.distributed import sharding as JS
from repro.launch.mesh import make_ctx as jmake_ctx
from repro.models import transformer as JT
from repro.optim.adamw import OptConfig as JOpt
from repro.optim.adamw import init_opt_state as jinit_opt
from repro_torch.configs import CANONICAL
from repro_torch.configs import get_reduced as tget
from repro_torch.distributed import collectives as C
from repro_torch.distributed import decode as DD
from repro_torch.distributed import make_mesh
from repro_torch.distributed import sharding as S
from repro_torch.launch.mesh import ONEHOT_EMBED_BYTES, make_ctx, make_production_mesh
from repro_torch.launch.mesh import make_spatial_ctx
from repro_torch.models import transformer as T
from repro_torch.models.lm_cells import (ServeConfig, SpecConfig, paged_serving_supported,
                                         place_cache, place_params)
from repro_torch.optim.adamw import OptConfig, init_opt_state
from repro_torch.serving.lm import lm_engine_parts
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

cap_threads_for_xdist()

MESHES = {"2x4": ((2, 4), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: (mesh, make_ctx keywords)
CTXS = {
    "2x4": ("2x4", {}),
    "2x4-fsdp": ("2x4", {"fsdp": True}),
    "2x4-tp_off": ("2x4", {"tp_off": True}),
    "2x4-ep2d": ("2x4", {"serve_ep2d": True}),
    "pod-data-fsdp": ("2x2x2", {"pod_role": "data", "fsdp": True}),
    "pod-replica": ("2x2x2", {"pod_role": "replica"}),
    "pod-replica-ep2d": ("2x2x2", {"pod_role": "replica", "serve_ep2d": True}),
}


class DuckMesh:
    """What JAX's spec functions read of a mesh."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def ctxs(name, cfg):
    mesh, kw = CTXS[name]
    shape, axes = MESHES[mesh]
    j = jmake_ctx(DuckMesh(shape, axes), vocab_size=cfg.vocab_size, d_model=cfg.d_model, **kw)
    t = make_ctx(make_mesh(shape, axes, devices=["cpu"] * 8), vocab_size=cfg.vocab_size,
                 d_model=cfg.d_model, **kw)
    return j, t


def jax_specs(tree):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JS.P))]


@functools.cache
def trees(arch):
    """JAX's and the port's reduced params and caches (shapes only)."""
    jcfg, tcfg = jget(arch), tget(arch)
    jp = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.PRNGKey(0)))
    jc = jax.eval_shape(lambda: JT.init_cache(jcfg, 4, 32))
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "meta")
    tc = T.init_cache(tcfg, 4, 32, "meta")
    return jcfg, tcfg, jp, jc, tp, tc


@pytest.mark.parametrize("ctx_name", sorted(CTXS))
@pytest.mark.parametrize("arch", CANONICAL)
def test_param_and_cache_specs_equal_jax(arch, ctx_name):
    jcfg, tcfg, jp, jc, tp, tc = trees(arch)
    jctx, tctx = ctxs(ctx_name, tcfg)
    got = [tuple(s) for s in tree_leaves(S.param_pspecs(tctx, tp, tcfg))]
    assert got == jax_specs(JS.param_pspecs(jctx, jp, jcfg))
    assert len(got) == len(tree_leaves(tp))
    got_c = [tuple(s) for s in tree_leaves(S.cache_pspecs(tctx, tc, tcfg))]
    assert got_c == jax_specs(JS.cache_pspecs(jctx, jc, jcfg))
    # a model axis shards something somewhere unless it is folded away
    sharded = {a for s in got for e in s for a in (e if isinstance(e, tuple) else (e,)) if a}
    assert ("model" in sharded) != tctx.tp_off


#: paged pools of 12 pages (a multiple of the data axes) of 8 lanes, and
#: of 9 pages (divisible by no data axis: the pages stay whole)
PAGED_POOLS = {"12x8": (12, 8), "9x8": (9, 8)}


@pytest.mark.parametrize("pool", sorted(PAGED_POOLS))
@pytest.mark.parametrize("ctx_name", sorted(CTXS))
@pytest.mark.parametrize("arch", [a for a in CANONICAL if paged_serving_supported(tget(a))])
def test_paged_cache_specs_equal_jax(arch, ctx_name, pool):
    """``cache_pspecs`` on a paged pool (L, N, Hkv, ps, D) (MLA's (L, N,
    ps, r)): JAX's entry for entry, pages over the data axes and kv
    heads, or each page's lanes, over the model axis."""
    n_pages, ps = PAGED_POOLS[pool]
    jcfg, tcfg = jget(arch), tget(arch)
    jc = jax.eval_shape(lambda: JT.init_paged_cache(jcfg, 4, n_pages, ps))
    tc = T.init_paged_cache(tcfg, 4, n_pages, ps, "meta")
    jctx, tctx = ctxs(ctx_name, tcfg)
    got = [tuple(s) for s in tree_leaves(S.cache_pspecs(tctx, tc, tcfg))]
    assert got == jax_specs(JS.cache_pspecs(jctx, jc, jcfg))
    assert len(got) == len(tree_leaves(tc))


@pytest.mark.parametrize("quantized", [False, True])
def test_zero_specs_equal_jax(quantized):
    arch = "granite-moe-1b-a400m"
    jcfg, tcfg, jp, _, tp, _ = trees(arch)
    jctx, tctx = ctxs("2x4-fsdp", tcfg)
    jopt = jax.eval_shape(lambda p: jinit_opt(p, JOpt(quantized_state=quantized)), jp)
    topt = init_opt_state(tp, OptConfig(quantized_state=quantized))
    want = JS.zero_pspecs(jctx, JS.param_pspecs(jctx, jp, jcfg), jopt, jp)
    got = S.zero_pspecs(tctx, S.param_pspecs(tctx, tp, tcfg), topt, tp)
    assert [tuple(s) for s in tree_leaves(got)] == jax_specs(want)
    assert set(got) == set(want)


def test_shard_ctx_and_named():
    cfg = tget("internlm2-1.8b")
    jctx, tctx = ctxs("pod-data-fsdp", cfg)
    for logical in (("dp", None), ("tp",), ("fsdp", "tp"), ("dp", "tp", None)):
        assert tuple(tctx.pspec(*logical)) == tuple(jctx.pspec(*logical))
    for ax in ("dp", "tp", "fsdp"):
        assert tctx.axis_size(ax) == jctx.axis_size(ax)
    assert dataclasses.asdict(S.LOCAL) == dataclasses.asdict(JS.LOCAL)
    x = torch.ones(3)
    assert tctx.constrain(x, "dp") is x and S.LOCAL.sharding("dp") is None
    named = S.named(tctx, {"a": S.P("data"), "b": [S.P()]})
    assert named["a"] == S.NamedSharding(tctx.mesh, S.P("data")) and named["b"][0].spec == ()
    sp = make_spatial_ctx(tctx.mesh)
    assert sp.data_axes == ("data",) and sp.manual_axes == ("pod", "data", "model")


@pytest.mark.parametrize("arch", CANONICAL)
def test_make_ctx_embed_strategy_equals_jax(arch):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    got = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model).embed_strategy
    want = jmake_ctx(DuckMesh((2, 4), ("data", "model")), vocab_size=cfg.vocab_size,
                     d_model=cfg.d_model).embed_strategy
    assert got == want
    assert got == ("onehot" if cfg.vocab_size * cfg.d_model * 2 > ONEHOT_EMBED_BYTES
                   else "gather")


def test_production_mesh_model_axis():
    m = make_production_mesh(devices=["cpu"] * 8, model=4)
    assert m.shape == {"data": 2, "model": 4}
    m = make_production_mesh(multi_pod=True, devices=["cpu"] * 8, model=2)
    assert m.shape == {"pod": 2, "data": 2, "model": 2}
    assert make_production_mesh(devices=["cpu"] * 2).shape == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="model groups"):
        make_production_mesh(devices=["cpu"] * 6, model=4)


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-v3-671b", "granite-moe-1b-a400m"])
def test_shard_unshard_round_trip_is_bitwise(arch, mesh_name):
    cfg = tget(arch)
    shape, axes = MESHES[mesh_name]
    mesh = make_mesh(shape, axes, devices=["cpu"] * 8)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, serve_ep2d=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    cache = T.init_cache(cfg, 4, 32, "cpu")
    cache = tree_map(lambda x: torch.randint(-5, 5, x.shape).to(x.dtype), cache)
    for tree, specs in ((params, S.param_pspecs(ctx, params, cfg)),
                        (cache, S.cache_pspecs(ctx, cache, cfg))):
        sh = S.shard(tree, specs, mesh)
        back = S.unshard(sh)
        for a, b in zip(tree_leaves(tree), tree_leaves(back)):
            assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))
        for x, spec, orig in zip(tree_leaves(sh), tree_leaves(specs), tree_leaves(tree)):
            assert isinstance(x, S.Sharded) and x.spec == spec
            ptrs = {}
            for c in x.coords():
                t = x.local(c)
                assert t.is_contiguous() and tuple(t.shape) == tuple(
                    s.stop - s.start for s in x.block(c))
                ptrs.setdefault(S._key(x.block(c)), set()).add(t.data_ptr())
            # one allocation a distinct block; members with equal blocks
            # on one device share it; a replicated leaf is the tree's own
            assert all(len(p) == 1 for p in ptrs.values())
            assert len({next(iter(p)) for p in ptrs.values()}) == len(ptrs)
            if len(ptrs) == 1:
                assert next(iter(ptrs.values())) == {orig.data_ptr()}


def test_shard_release_lets_the_tree_go():
    tree = {"a": torch.arange(8.0).reshape(4, 2), "b": [torch.ones(4)]}
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    sh = S.shard(tree, {"a": S.P("data", "model"), "b": [S.P()]}, mesh, release=True)
    assert tree == {} and torch.equal(S.unshard(sh)["a"], torch.arange(8.0).reshape(4, 2))
    assert sh["a"].local((1, 1)).tolist() == [[5.0], [7.0]]
    # a sharded leading axis indexes too (a replica axis on "pod"): every
    # member takes the view held by the member of its model column that
    # holds the row
    row = sh["a"][1]
    assert tuple(row.spec) == ("model",) and row.full().tolist() == [2.0, 3.0]
    assert all(row.local(c).data_ptr() == sh["a"].local((0, c[1]))[1].data_ptr()
               for c in row.coords())


def test_region_and_indexing():
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    x = torch.arange(2 * 4 * 6.0).reshape(2, 4, 6)
    s = S.shard_leaf(x, S.P(None, ("data", "model"), None), mesh)
    assert [s.block(c)[1] for c in s.coords()] == [slice(0, 1), slice(1, 2), slice(2, 3),
                                                    slice(3, 4)]
    assert torch.equal(s[1].full(), x[1]) and s[1].local((0, 1)).data_ptr() == \
        s.local((0, 1))[1].data_ptr()
    own = s.region((slice(None), slice(2, 3), slice(None)))
    assert own.data_ptr() == s.local((1, 0)).data_ptr()
    assert torch.equal(s.region((slice(None), slice(1, 4), slice(2, 5))), x[:, 1:4, 2:5])
    cl = s.clone()
    assert torch.equal(cl.full(), x) and cl.local((0, 0)).data_ptr() != s.local((0, 0)).data_ptr()


def test_mesh_member_addressing():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=["cpu"] * 8)
    assert mesh.axis_index((1, 0, 1), "pod") == 1 and mesh.axis_index((1, 0, 1), "model") == 1
    assert mesh.members((1, 0, 1), "model") == [(1, 0, 0), (1, 0, 1)]
    assert mesh.members((0, 1, 1), ("pod", "data")) == [(0, 0, 1), (0, 1, 1), (1, 0, 1),
                                                         (1, 1, 1)]
    assert mesh.device_at((1, 1, 1)) == torch.device("cpu")


def test_model_axis_collectives():
    xs = [torch.tensor([1.0, -2.0]) * (i + 1) for i in range(4)]
    assert all(torch.equal(s, torch.tensor([10.0, -20.0])) for s in C.psum(xs))
    assert torch.equal(C.pmax(xs)[0], torch.tensor([4.0, -2.0]))
    assert torch.equal(C.pmean(xs)[2], torch.tensor([2.5, -5.0]))
    assert C.all_gather(xs, tiled=True)[1].shape == (8,) and C.all_gather(xs)[0].shape == (4, 2)
    sends = [torch.arange(4 * 3).reshape(4, 3) + 100 * j for j in range(4)]
    recv = C.all_to_all(sends)
    for i in range(4):
        assert torch.equal(recv[i], torch.stack([sends[j][i] for j in range(4)]))
    back = C.all_to_all(recv)
    assert all(torch.equal(a, b) for a, b in zip(back, sends))


def f32(arch, **over):
    return dataclasses.replace(tget(arch), dtype="float32", **over)


def test_mamba_under_a_mesh_runs_and_its_decode_stays_sharded():
    """A mamba2 forward under a mesh gives the unsharded logits (1e-4);
    a decode step keeps every cache leaf ``Sharded`` in its layout.
    (Against JAX's sharded decode: ``tests/test_torch_decode_spmd_ssm.py``.)"""
    cfg = f32("mamba2-2.7b")
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, decode_shardmap=True)
    local = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 4), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    want, _ = T.forward(cfg, local, toks)
    params = place_params(cfg, tree_map(lambda x: x, local), ctx)
    got, _ = T.forward(cfg, params, toks, ctx=ctx)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    cache = place_cache(cfg, T.init_cache(cfg, 2, 8, "cpu"), ctx)
    _, new = T.decode_step(cfg, params, cache, toks[:, :1], ctx=ctx)
    for a, b in zip(tree_leaves(cache), tree_leaves(new)):
        assert isinstance(b, S.Sharded) and b.spec == a.spec and b.shape == a.shape


def test_engine_options_not_sharded_refuse():
    """Under a mesh, paged pools (a paged MLA latent pool too) and
    speculation serve; spatial placement under ``make_ctx``'s ctx still
    refuses, saying why."""
    cfg = f32("internlm2-1.8b")
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, decode_shardmap=True)
    mla = f32("deepseek-v3-671b")
    for c, scfg in ((cfg, ServeConfig(batch=4, max_len=32, paged=True, page_size=8)),
                    (cfg, ServeConfig(batch=4, max_len=32, spec=SpecConfig(draft_len=2))),
                    (mla, ServeConfig(batch=4, max_len=32, paged=True, page_size=8))):
        lm_engine_parts(c, scfg, ctx, device="cpu")
    with pytest.raises(NotImplementedError, match="spatial"):
        lm_engine_parts(cfg, ServeConfig(batch=4, max_len=32, placement="spatial"), ctx,
                        device="cpu")


def test_layout_that_neither_divides_takes_the_unsharded_path():
    # 2 kv heads and 30 lanes over a model axis of 4: no layout divides
    cfg = f32("internlm2-1.8b")
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, decode_shardmap=True)
    g = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, g, "cpu")
    B, cap = 4, 30
    toks = torch.randint(0, cfg.vocab_size, (B, 6), generator=g)
    cache = T.init_cache(cfg, B, cap, "cpu")
    cache["pos"] = torch.zeros(B, dtype=torch.int32)
    specs = S.cache_pspecs(ctx, cache, cfg)
    assert all("model" not in tuple(s) for s in tree_leaves(specs))
    layer = S.shard(tree_map(lambda x: x[0], cache["segments"][0]),
                    S.cache_pspecs(ctx, tree_map(lambda x: x[0], cache["segments"][0]), cfg), mesh)
    q = torch.randn(B, cfg.n_heads, 1, cfg.head_dim, generator=g)
    kv = torch.randn(B, cfg.n_kv_heads, cfg.head_dim, generator=g)
    assert DD.gqa_decode(q, kv, kv, layer, torch.zeros(B, dtype=torch.int32), cfg=cfg,
                         ctx=ctx) is None
    sp = place_params(cfg, tree_map(lambda x: x, params), ctx)
    sc = place_cache(cfg, cache, ctx)
    for t in range(6):
        want, cache = T.decode_step(cfg, params, cache, toks[:, t:t + 1])
        got, sc = T.decode_step(cfg, sp, sc, toks[:, t:t + 1], ctx=ctx)
        assert (want - got).abs().max() <= 1e-5 * want.abs().max()
    for a, b in zip(tree_leaves(cache), tree_leaves(S.unshard(sc))):
        if a.is_floating_point():
            assert (a - b).abs().max() <= 1e-5
        else:
            assert torch.equal(a, b)


def test_replicated_weights_are_one_tensor_on_one_device():
    cfg = tget("internlm2-1.8b")
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = S.param_pspecs(ctx, params, cfg)
    full_ptrs = [x.data_ptr() for x in tree_leaves(params)]
    sh = place_params(cfg, params, ctx)
    assert params == {}
    for x, spec, ptr in zip(tree_leaves(sh), tree_leaves(specs), full_ptrs):
        ptrs = {x.local(c).data_ptr() for c in x.coords()}
        if all(e is None for e in spec):
            assert ptrs == {ptr}
        else:
            n_blocks = len({S._key(x.block(c)) for c in x.coords()})
            assert len(ptrs) == n_blocks > 1 and ptr not in ptrs
    flat, _ = tree_flatten(sh)
    assert sum(len(x.distinct()) for x in flat) < 8 * len(flat)


@pytest.mark.parametrize("field,value", [("pallas", True), ("unroll", True)])
def test_shard_ctx_refuses_fields_it_does_not_honour(field, value):
    JS.ShardCtx(**{field: value})  # JAX's knobs for its compiler
    with pytest.raises(NotImplementedError, match=f"ShardCtx.{field}"):
        S.ShardCtx(**{field: value})


def test_shard_ctx_builds_with_seq_shard_acts():
    """``seq_shard_acts`` is honoured (``ShardCtx.seq_spec``,
    ``models/layers.py``): it builds as JAX's does, on a mesh too."""
    assert JS.ShardCtx(seq_shard_acts=True).seq_shard_acts is True
    assert S.ShardCtx(seq_shard_acts=True).seq_shard_acts is True
    assert S.LOCAL.seq_shard_acts is JS.LOCAL.seq_shard_acts is False
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh, seq_shard_acts=True)
    assert ctx.seq_shard_acts and ctx.seq_spec((8, 32, 16)) == S.P("data", "model", None)


@pytest.mark.parametrize("value", ["full", "dots", "none"])
def test_shard_ctx_honours_remat(value):
    """``remat`` is honoured (``transformer._remat``); LOCAL keeps JAX's
    default, and a value JAX's forward would not know raises."""
    assert JS.ShardCtx(remat=value).remat == S.ShardCtx(remat=value).remat == value
    assert S.LOCAL.remat == JS.LOCAL.remat == "full"
    with pytest.raises(ValueError, match="remat"):
        S.ShardCtx(remat="all")


def test_constrain_asserts_a_sharded_layout():
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh)
    x = S.shard_leaf(torch.arange(32.0).reshape(4, 8), S.P("data", "model"), mesh)
    assert ctx.constrain(x, "dp", "tp") is x
    with pytest.raises(ValueError, match="constraint says"):
        ctx.constrain(x, "dp", None)
    y = S.shard_leaf(torch.arange(32.0).reshape(4, 8), S.P(None, "model"), mesh)
    inner = dataclasses.replace(ctx, manual_axes=("data",))  # JAX drops manual axes
    assert inner.constrain(y, "dp", "tp") is y
    assert make_spatial_ctx(mesh).constrain(x, "tp", None) is x  # every axis manual


def test_sharded_decode_needs_decode_shardmap():
    cfg = f32("internlm2-1.8b")
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model)
    params = place_params(cfg, T.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), ctx)
    cache = place_cache(cfg, T.init_cache(cfg, 4, 32, "cpu"), ctx)
    with pytest.raises(ValueError, match="decode_shardmap=True"):
        T.decode_step(cfg, params, cache, torch.zeros((4, 1), dtype=torch.int32), ctx=ctx)


def test_block_k_reaches_the_prefill(monkeypatch):
    from repro_torch.models import layers as L

    cfg = f32("internlm2-1.8b")
    seen = []
    plain = L.blockwise_attention

    def spy(*a, block_k=1024, **k):
        seen.append(block_k)
        return plain(*a, block_k=block_k, **k)

    monkeypatch.setattr(L, "blockwise_attention", spy)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((2, 8), dtype=torch.int32)
    want, _ = T.forward(cfg, params, toks)
    got, _ = T.forward(cfg, params, toks, ctx=S.ShardCtx(block_k=4))
    assert seen == [1024] * cfg.n_layers + [4] * cfg.n_layers
    assert torch.allclose(got, want, atol=1e-5)
