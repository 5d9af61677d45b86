"""The LM training and serving stack as a MISO program (a port of
``repro/models/lm_cells.py``).

Training:
    cell data     -- source cell (deterministic batches made on the device)
    cell trainer  -- state = (params, optimizer state, metrics);
                     transition = forward + backward + AdamW, reading the
                     data cell's *previous* batch (a double-buffered input
                     pipeline)

Serving:
    cell weights  -- static cell (identity transition) holding the params
    cell decoder  -- slot-masked state (KV cache or page pools + page
                     table, last tokens, prompt-walk cursor); transition =
                     one greedy decode step for every active slot
                     (``make_slot_serve_program``, the engine's); or the
                     fixed batch's cache, last tokens and step count
                     (``make_serve_program``, the static reference path)

Replication (paper §IV) applies to the trainer through the generic MISO
machinery (``program.with_policies({"trainer": DMR})``); per-request
replication of serving happens on replica *slots* of the decoder batch
(``repro_torch.serving``), not on the cells.  Speculative decoding
(``SpecConfig``) fuses a draft model and the verify walk into the
decoder's transition.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import prng
from ..core import CellType, MisoProgram
from ..data.pipeline import DataConfig, data_cell
from ..distributed import wire
from ..distributed.collectives import compressed_psum_int8, psum_mean
from ..distributed.sharding import (LOCAL, P, ShardCtx, Sharded, cache_pspecs, map_blocks,
                                    param_pspecs, shard, shard_leaf, zero_pspecs)
from ..optim.adamw import OptConfig, apply_updates, init_opt_state
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from . import transformer as T
from .config import ModelConfig
from .layers import value


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TrainConfig:
    data: DataConfig
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    grad_compression: str = "none"  # none | int8_ef (needs a data mesh)
    param_seed: int = 0


def _make_batch(cfg: ModelConfig, data_state: dict) -> dict:
    batch = {"tokens": data_state["tokens"]}
    if cfg.n_vision_tokens:
        batch["vision_embeds"] = data_state["vision_embeds"]
    return batch


def make_data_cell(cfg: ModelConfig, tcfg: TrainConfig) -> CellType:
    """The data source cell; a vision arch's also carries the vision
    stub's output, drawn under ``fold_in(key, 77)`` as in JAX."""
    base = data_cell(tcfg.data)
    if not cfg.n_vision_tokens:
        return base

    def with_vision(st):
        st["vision_embeds"] = (0.02 * prng.normal(
            prng.fold_in(st["key"], 77),
            (tcfg.data.batch, cfg.n_vision_tokens, cfg.d_model))).to(cfg.compute_dtype)
        return st

    return CellType(name=base.name, init=lambda gen, device: with_vision(base.init(gen, device)),
                    transition=lambda prev: with_vision(base.transition(prev)),
                    instances=base.instances)


def _value_and_grad(cfg: ModelConfig, params: dict, batch: dict, ctx: ShardCtx = LOCAL):
    """(metrics, grads) of ``T.loss_fn`` by ``torch.autograd.grad`` over
    the params tree.  The leaves are detached aliases: ``params`` (the
    previous buffer) is neither written nor marked.  A ``Sharded`` leaf's
    gradient is taken over its distinct block tensors and comes back in
    its layout (a block that several members share on one device is one
    tensor, so it receives their cotangents summed, once; copies of a
    block on several devices each receive the sum of their gradients)."""
    leaves, treedef = tree_flatten(params)
    xs, targets = [], []
    for p in leaves:
        if isinstance(p, Sharded):
            a = p.map(lambda t: t.detach().requires_grad_())
            targets.extend(t for _, t in a.distinct())
        else:
            a = p.detach().requires_grad_()
            targets.append(a)
        xs.append(a)
    with torch.enable_grad():
        loss, metrics = T.loss_fn(cfg, tree_unflatten(treedef, xs), batch, ctx=ctx)
        gs = torch.autograd.grad(loss, targets, allow_unused=True)
    got = {id(t): torch.zeros_like(t) if g is None else g for t, g in zip(targets, gs)}
    if wire.active() and not ctx.manual_axes:  # int8_ef reduces through its collectives
        for x in xs:
            if isinstance(x, Sharded):
                _record_grad_sums(x)
    grads = [_sum_copies(x.map(lambda t: got[id(t)])) if isinstance(x, Sharded) else got[id(x)]
             for x in xs]
    metrics = tree_map(lambda m: m.detach() if isinstance(m, torch.Tensor) else m, metrics)
    return metrics, tree_unflatten(treedef, grads)


def _record_grad_sums(x: Sharded) -> None:
    """The data-parallel reduction in a ``wire`` meter: each block's
    gradient is the sum over the members that hold the block (one tensor
    when they share it on a device, whose autograd sums their
    cotangents; ``_sum_copies`` across devices), an all-reduce in a
    group of those members.  A leaf split over axes other than the model
    axis (FSDP) first has its gathered gradient reduce-scattered over
    them, as ``layers.matmul`` gathered the weight (site ``fsdp``)."""
    holders: dict = {}
    for c in x.coords():
        blk = x.block(c)
        holders.setdefault(tuple((s.start, s.stop) for s in blk), [blk, 0])[1] += 1
    used = wire.spec_axes(*x.spec)
    axes = tuple(a for a in x.mesh.axis_names if a not in used)
    fsdp = tuple(a for a in used if a != wire.MODEL_AXIS)
    ways = math.prod(x.mesh.shape[a] for a in fsdp)
    for blk, k in holders.values():
        n = math.prod(s.stop - s.start for s in blk)
        wire.record("reduce-scatter", n * x.dtype.itemsize, ways, members=k, site="fsdp",
                    axes=fsdp)
        wire.record("all-reduce", n * x.dtype.itemsize, k, members=k, site="grad", axes=axes)


def _sum_copies(g: Sharded) -> Sharded:
    """Each block's gradient summed over the block's copies on distinct
    devices (what an all-reduce over a replicated weight gives); a block
    held once is left as it is."""
    copies: dict = {}
    for c, t in g.distinct():
        copies.setdefault(tuple((s.start, s.stop) for s in g.block(c)), []).append(t)
    if all(len(ts) == 1 for ts in copies.values()):
        return g
    summed = {}
    for ts in copies.values():
        total = ts[0]
        for t in ts[1:]:
            total = total + t.to(total.device)
        for t in ts:
            summed[id(t)] = total.to(t.device)
    return g.map(lambda t: summed[id(t)])


def _lmap(fn, *xs):
    """``fn`` over one leaf of each tree: member by member on
    ``Sharded`` leaves of one layout."""
    if isinstance(xs[0], Sharded):
        return map_blocks(lambda _, *ts: fn(*ts), *xs)
    return fn(*xs)


def _dp_size(ctx: ShardCtx) -> int:
    n = 1
    if ctx.mesh is not None:
        for a in ctx.data_axes:
            n *= ctx.mesh.shape[a]
    return n


def _data_index(ctx: ShardCtx, coord) -> int:
    """The data member of mesh member ``coord``: its index over the data
    axes, first axis major (JAX's order for ``P(dp)``)."""
    names = ctx.mesh.axis_names
    d = 0
    for a in ctx.data_axes:
        d = d * ctx.mesh.shape[a] + coord[names.index(a)]
    return d


def _data_homes(ctx: ShardCtx) -> list:
    """The first mesh member of each data member, in data order."""
    homes: dict = {}
    for c in np.ndindex(*ctx.mesh.devices.shape):
        homes.setdefault(_data_index(ctx, c), c)
    return [homes[d] for d in range(len(homes))]


def per_data_member(bufs: list, ctx: ShardCtx) -> Sharded:
    """One buffer a data member as a replicated-spec (``P()``) leaf whose
    members hold their data member's buffer: the error-feedback state.
    JAX declares it ``P()`` with ``check_vma=False`` while every data
    member writes its own send error into it, so its host view (and a
    checkpoint) is data member 0's buffer; here ``full()`` reads the
    first member's, data member 0's, too."""
    out, made = np.empty(ctx.mesh.devices.shape, dtype=object), {}
    for c in np.ndindex(*ctx.mesh.devices.shape):
        dev = ctx.mesh.devices[c]
        d = _data_index(ctx, c)
        if (d, str(dev)) not in made:
            made[(d, str(dev))] = bufs[d] if bufs[d].device == dev else bufs[d].to(dev)
        out[c] = made[(d, str(dev))]
    b = bufs[0]
    return Sharded(ctx.mesh, P(), b.shape, b.dtype, out)


def _meta(x) -> torch.Tensor:
    return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")


def train_state_pspecs(cfg: ModelConfig, ctx: ShardCtx, trainer: dict, level: int = 1,
                       placement: str = "temporal") -> dict:
    """The trainer state's layout, as the JAX dry-run lays it out: params
    by ``param_pspecs``, ``opt`` by ``zero_pspecs`` (ZeRO-1; FSDP too
    with ``ctx.fsdp_axes``), metrics and ``ef`` replicated (``ef`` holds
    one buffer a data member, ``per_data_member``; JAX's dry-run declares
    ``P(dp)``).  A replicated trainer (``level > 1``; ``trainer``'s
    leaves lead with the replica axis) takes the specs of one replica
    with the replica entry prepended: None under temporal placement,
    ``"pod"`` under spatial (``dryrun.py::train_state_specs``)."""
    if level > 1:
        trainer = tree_map(lambda x: torch.empty(tuple(x.shape)[1:], dtype=x.dtype,
                                                 device="meta"), trainer)
    pspec = param_pspecs(ctx, trainer["params"], cfg)
    out = {"params": pspec, "opt": zero_pspecs(ctx, pspec, trainer["opt"], trainer["params"]),
           "metrics": tree_map(lambda _: P(), trainer["metrics"])}
    if "ef" in trainer:
        out["ef"] = P()
    if level > 1:
        entry = "pod" if placement == "spatial" else None
        out = tree_map(lambda sp: P(entry, *tuple(sp)), out)
    return out


def place_train_state(cfg: ModelConfig, ctx: ShardCtx, trainer: dict, level: int = 1,
                      placement: str = "temporal") -> dict:
    """A trainer state laid out on ``ctx.mesh`` by ``train_state_pspecs``
    (each data member's ``ef`` a copy of the given buffer), or as it is
    without a mesh.  Consumes ``trainer``'s params and optimizer state:
    each full leaf can be freed once it is sharded.  A replicated trainer
    (``level > 1``, leaves leading with the replica axis: a carried-over
    JAX state) is laid out replica by replica and stacked into the
    replicated layout (``redundancy.stack_replicas``)."""
    if ctx.mesh is None:
        return trainer
    if level > 1:
        from ..core.redundancy import stack_replicas

        leaves, treedef = tree_flatten(trainer)
        reps = [tree_flatten(place_train_state(
            cfg, ctx, tree_unflatten(treedef, [x[r] for x in leaves])))[0] for r in range(level)]
        del leaves
        return tree_unflatten(treedef, stack_replicas(reps, placement))
    specs = train_state_pspecs(cfg, ctx, trainer)
    out = {"opt": shard(trainer["opt"], specs["opt"], ctx.mesh, release=True),
           "params": shard(trainer["params"], specs["params"], ctx.mesh, release=True),
           "metrics": trainer["metrics"]}  # on the controller, as every activation
    if "ef" in trainer:
        ef = trainer["ef"]
        out["ef"] = per_data_member(
            [ef.to(ctx.mesh.devices[h], copy=True) for h in _data_homes(ctx)], ctx)
    return out


def member_flats(gfn, params, batch, n: int, ctx: ShardCtx) -> tuple[list, list]:
    """Each data member's metrics and grads on its own rows of ``batch``
    (JAX's ``P(dp, None)``), the grads flattened to f32 and padded to
    ``n`` elements on the member's first device: (flats, metrics), in
    data order.  The inputs of the int8 reduction."""
    homes = _data_homes(ctx)
    B = batch["tokens"].shape[0]
    if B % len(homes):
        raise ValueError(f"batch {B} does not split over {len(homes)} data members")
    rows = B // len(homes)
    flats, mets = [], []
    for d, home in enumerate(homes):
        m, g = gfn(params, {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()})
        flat = torch.cat([value(x).to(torch.float32).reshape(-1) for x in tree_leaves(g)])
        pad = n - flat.shape[0]
        flats.append(F.pad(flat, (0, pad)).to(ctx.mesh.devices[home]) if pad else
                     flat.to(ctx.mesh.devices[home]))
        mets.append(m)
        del g
    return flats, mets


def _compressed_grads(gfn, params, batch, ef: Sharded, ctx: ShardCtx):
    """Each data member's grads on its own rows (``member_flats``),
    reduced through ``compressed_psum_int8`` with the member's
    error-feedback buffer; the metrics ``pmean``ed over the data members.
    Returns (grads as the mean's slices, metrics, new ``ef``: each data
    member's own send error)."""
    leaves, treedef = tree_flatten(params)
    flats, mets = member_flats(gfn, params, batch, ef.shape[0], ctx)
    with wire.over(ctx.data_axes):
        outs = compressed_psum_int8(flats, [ef.local(h) for h in _data_homes(ctx)])
        metrics = tree_map(lambda *xs: psum_mean(list(xs))[0], *mets)
    mean = outs[0][0]
    grads, off = [], 0
    for x in leaves:
        grads.append(mean[off:off + x.numel()].reshape(x.shape))
        off += x.numel()
    return tree_unflatten(treedef, grads), metrics, per_data_member([o[1] for o in outs], ctx)


def make_trainer_cell(cfg: ModelConfig, tcfg: TrainConfig, ctx: ShardCtx = LOCAL, *,
                      data_name: str = "data") -> CellType:
    """The trainer cell: forward, backward and AdamW over the data cell's
    previous batch.  ``microbatches > 1`` accumulates f32 grads over row
    slices of the batch (the metrics are their mean), as JAX's scan.

    Under a ``ctx`` with a mesh, ``init`` lays the state out as
    ``train_state_pspecs`` says (``Sharded`` leaves: one allocation a
    distinct block), the loss runs under ``ctx`` (activations on the
    controller's device, every product by its weight's spec) and AdamW
    updates block by block.  ``grad_compression="int8_ef"`` needs a data
    mesh: each data member's grads on its rows of the batch (JAX's
    ``P(dp, None)``) are reduced with an int8 wire format and error
    feedback (``ef``: one buffer a data member)."""
    if tcfg.grad_compression not in ("none", "int8_ef"):
        raise ValueError(f"grad_compression={tcfg.grad_compression!r}: none | int8_ef")
    if tcfg.grad_compression == "int8_ef" and ctx.mesh is None:
        raise ValueError("grad_compression='int8_ef' reduces each data member's grads over "
                         "a data mesh; give make_trainer_cell a ShardCtx with a mesh")
    loss_ctx = ctx
    if tcfg.grad_compression == "int8_ef":
        # JAX runs this loss inside a shard_map over the data axes
        loss_ctx = dataclasses.replace(ctx, manual_axes=tuple(ctx.data_axes))

    def init(gen, device):
        g = torch.Generator(device=device).manual_seed(gen.initial_seed() + tcfg.param_seed)
        params = T.init_params(cfg, g, device)
        z = torch.zeros((), dtype=torch.float32, device=device)
        st = {"params": params, "opt": init_opt_state(params, tcfg.opt),
              "metrics": {"loss": z, "grad_norm": z.clone(), "lr": z.clone()}}
        del params
        if tcfg.grad_compression == "int8_ef":
            n = sum(x.numel() for x in tree_leaves(st["params"]))
            pad = (-n) % (512 * _dp_size(ctx))
            st["ef"] = torch.zeros((n + pad,), dtype=torch.float32, device=device)
        return place_train_state(cfg, ctx, st)

    def grads_plain(params, batch):
        return _value_and_grad(cfg, params, batch, loss_ctx)

    def grads_microbatched(params, batch):
        mb = tcfg.microbatches
        B = batch["tokens"].shape[0]
        if B % mb:
            raise ValueError(f"batch {B} is not a multiple of microbatches {mb}")
        n = B // mb
        acc, ms = None, []
        for i in range(mb):
            m, g = _value_and_grad(cfg, params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()},
                                   loss_ctx)
            g = tree_map(lambda x: _lmap(lambda t: t.to(torch.float32) / mb, x), g)
            acc = g if acc is None else tree_map(lambda a, b: _lmap(torch.add, a, b), acc, g)
            ms.append(m)
        metrics = tree_map(lambda *xs: torch.mean(torch.stack(
            [torch.as_tensor(x, dtype=torch.float32) for x in xs])), *ms)
        return metrics, acc

    gfn = grads_microbatched if tcfg.microbatches > 1 else grads_plain

    def transition(prev):
        st = prev["trainer"]
        batch = _make_batch(cfg, prev[data_name])
        new_ef = None
        if tcfg.grad_compression == "int8_ef":
            grads, metrics, new_ef = _compressed_grads(gfn, st["params"], batch, st["ef"], ctx)
        else:
            metrics, grads = gfn(st["params"], batch)
        new_params, new_opt, info = apply_updates(st["params"], grads, st["opt"], tcfg.opt)
        out = {
            "params": new_params,
            "opt": new_opt,
            "metrics": {"loss": metrics["loss"].to(torch.float32),
                        "grad_norm": info["grad_norm"], "lr": info["lr"]},
        }
        if new_ef is not None:
            out["ef"] = new_ef
        return out

    return CellType(name="trainer", init=init, transition=transition, reads=(data_name,))


def make_train_program(cfg: ModelConfig, tcfg: TrainConfig, ctx: ShardCtx = LOCAL) -> MisoProgram:
    prog = MisoProgram()
    prog.add(make_data_cell(cfg, tcfg))
    prog.add(make_trainer_cell(cfg, tcfg, ctx))
    return prog


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding: a DRAFT model proposes up to ``draft_len``
    tokens a tick and the resident decoder verifies them in one walk; the
    accepted prefix commits and the first rejection rolls the position
    back.  Verification is greedy, so the emitted stream is bitwise the
    plain greedy decode's.

    On ``ServeConfig.spec`` it sizes the resident draft (the engine-wide
    verify-walk width K); on ``Request.spec`` it picks the request's draft
    length (clamped to K).

    draft_arch       -- reduced-config name of the draft model; "" = the
                        target itself (self-speculation).
    draft_param_seed -- the draft's parameter seed; None = the serve
                        config's ``param_seed`` (self-speculation: the
                        draft IS the target).  Any other value draws a
                        different draft, which brings real rejections.
    """

    draft_len: int = 4
    draft_arch: str = ""
    draft_param_seed: int | None = None

    def __post_init__(self):
        if self.draft_len < 1:
            raise ValueError("draft_len must be >= 1")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The JAX package's ``ServeConfig`` (see there), field for field."""

    batch: int
    max_len: int  # cache capacity
    param_seed: int = 0
    #: > 0: the fixed-batch program's cache starts at this position (the
    #: dry-run's warm decode cell, ``make_serve_program``)
    prefill_len: int = 0
    #: the out-of-band prefill forward covers at most this many prompt
    #: tokens; the tail is walked inside the resident transition (0 =
    #: whole prompt)
    prefill_chunk: int = 0
    #: smallest prefill bucket of the geometric ladder (0 = no bucketing)
    prefill_bucket_min: int = 16
    #: explicit bucket ladder override (sorted lengths); () = geometric
    prefill_buckets: tuple = ()
    #: paged KV cache: slot KV lives in fixed-size pages of one shared pool
    paged: bool = False
    #: tokens per KV page; ``max_len`` must be a multiple of it
    page_size: int = 16
    #: total pages in the pool; 0 = batch * (max_len / page_size)
    page_budget: int = 0
    #: speculative decoding; archs that cannot roll the cache position
    #: back (``spec_serving_supported``) fall back to plain decode
    spec: SpecConfig | None = None
    #: "spatial": the engine places replica slots one a pod of a mesh
    #: (``make_slot_serve_program`` stamps ``prog.spatial_serve``)
    placement: str = "temporal"

    def __post_init__(self):
        if self.placement not in ("temporal", "spatial"):
            raise ValueError(f"placement={self.placement!r}: must be 'temporal' or 'spatial'")


def prefill_bucket_ladder(scfg: ServeConfig) -> tuple:
    """The prefill bucket ladder: explicit override, or geometric doubling
    from ``prefill_bucket_min`` capped at ``max_len``; () when disabled."""
    if scfg.prefill_buckets:
        return tuple(
            sorted({min(b, scfg.max_len) for b in scfg.prefill_buckets if b > 0} | {scfg.max_len})
        )
    if scfg.prefill_bucket_min <= 0:
        return ()
    ladder, b = [], min(scfg.prefill_bucket_min, scfg.max_len)
    while b < scfg.max_len:
        ladder.append(b)
        b *= 2
    ladder.append(scfg.max_len)
    return tuple(ladder)


def place_params(cfg: ModelConfig, params: dict, ctx: ShardCtx) -> dict:
    """``params`` laid out on ``ctx.mesh`` by ``param_pspecs``, or as they
    are without a mesh.  Consumes ``params``: its containers are emptied
    as the leaves are sharded, so each full leaf can be freed on the way
    (the peak is the model and one leaf's shards)."""
    if ctx.mesh is None:
        return params
    return shard(params, param_pspecs(ctx, params, cfg), ctx.mesh, release=True)


def place_cache(cfg: ModelConfig, cache: dict, ctx: ShardCtx) -> dict:
    """A decode cache laid out on ``ctx.mesh`` by ``cache_pspecs``."""
    if ctx.mesh is None:
        return cache
    return shard(cache, cache_pspecs(ctx, cache, cfg), ctx.mesh)


def make_serve_program(cfg: ModelConfig, scfg: ServeConfig, ctx: ShardCtx = LOCAL) -> MisoProgram:
    """The fixed-batch serve program (``launch/serve.py --static``): a
    static ``weights`` cell and a ``decoder`` cell holding the whole
    batch's cache, its last tokens ((B, 1), or (B, 1, K) for K codebooks)
    and the step count; one greedy ``T.decode_step`` of every row a
    transition.  The weights draw from their own generator seeded from
    the program's seed and ``param_seed``, as the slot program's do.
    With ``prefill_len`` the cache starts at that position (JAX's warm
    decode cell).  Under a ``ctx`` with a mesh the weights and the cache
    are sharded leaves (``place_params`` / ``place_cache``)."""

    def w_init(gen, device):
        g = torch.Generator(device=device).manual_seed(gen.initial_seed() + scfg.param_seed)
        return {"params": place_params(cfg, T.init_params(cfg, g, device), ctx)}

    weights = CellType(name="weights", init=w_init, transition=lambda prev: prev["weights"])

    def d_init(gen, device):
        cache = T.init_cache(cfg, scfg.batch, scfg.max_len, device)
        if scfg.prefill_len:
            cache["pos"] = torch.full((scfg.batch,), scfg.prefill_len, dtype=torch.int32,
                                      device=device)
        return {
            "cache": place_cache(cfg, cache, ctx),
            "tokens": torch.zeros((scfg.batch, 1, *token_dims(cfg)), dtype=torch.int32,
                                  device=device),
            "n_decoded": torch.zeros((), dtype=torch.int32, device=device),
        }

    def d_transition(prev):
        st = prev["decoder"]
        logits, cache = T.decode_step(cfg, prev["weights"]["params"], st["cache"], st["tokens"],
                                      ctx=ctx)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).reshape(st["tokens"].shape)  # greedy
        return {"cache": cache, "tokens": nxt, "n_decoded": st["n_decoded"] + 1}

    decoder = CellType(name="decoder", init=d_init, transition=d_transition, reads=("weights",),
                       instances=scfg.batch)
    prog = MisoProgram()
    prog.add(weights)
    prog.add(decoder)
    return prog


def token_dims(cfg: ModelConfig) -> tuple:
    """The trailing axes of a token array: ``(K,)`` for a model of K > 1
    codebooks (one token a codebook a position), else ``()``."""
    return (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()


def _slot_leaves(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """The per-slot leaves beside the cache (``tokens`` and ``pending``
    with ``token_dims``)."""
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    tail = token_dims(cfg)
    return {
        "tokens": z(batch, 1, *tail),
        "active": z(batch, dtype=torch.bool),
        "n_decoded": z(batch),
        "pending": z(batch, max_len, *tail),
        "p_head": z(batch),
        "p_len": z(batch),
    }


def spec_state_leaves(draft_cfg: ModelConfig | None, batch: int, max_len: int,
                      draft_len: int, device) -> dict:
    """The extra per-slot decoder leaves of a speculating engine:

    draft_cache -- the draft model's own KV cache, always DENSE, even on a
                   paged engine; absent under true self-speculation
                   (``draft_cfg is None``: the draft is the target's pass).
    spec_out    -- (B, K+1) tokens committed this tick, in emission order.
    spec_n      -- committed count: a+1 for a slot that verified this tick
                   (a = accepted draft prefix), 0 otherwise.
    spec_k      -- the slot's requested draft length (0 = no speculation).
    budget      -- the request's ``max_new_tokens`` (the in-graph clamp
                   stops speculation where plain decode would stop).
    """
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    st = {"spec_out": z(batch, draft_len + 1), "spec_n": z(batch), "spec_k": z(batch),
          "budget": z(batch)}
    if draft_cfg is not None:
        st["draft_cache"] = T.init_cache(draft_cfg, batch, max_len, device)
    return st


def slot_decoder_init(cfg: ModelConfig, batch: int, max_len: int, device,
                      draft_cfg: ModelConfig | None = None, draft_len: int = 0) -> dict:
    """Decoder-cell state for the continuous batcher: every leaf is
    per-slot, so requests can join/leave individual slots between ticks.
    ``active`` is the slot mask; ``pending``/``p_head``/``p_len`` hold the
    prompt tail the transition walks one token per sub-step.
    ``draft_cfg``/``draft_len`` (speculating engines) add the
    ``spec_state_leaves``."""
    st = {"cache": T.init_cache(cfg, batch, max_len, device),
          **_slot_leaves(cfg, batch, max_len, device)}
    if draft_len > 0:
        st.update(spec_state_leaves(draft_cfg, batch, max_len, draft_len, device))
    return st


def paged_serving_supported(cfg: ModelConfig) -> bool:
    """Archs whose serve cache can live in pages: pure-attention text
    models (callers fall back to the dense cache for the others)."""
    return cfg.mixer_type != "mamba2" and not cfg.window and not cfg.n_vision_tokens


def spec_serving_supported(cfg: ModelConfig) -> bool:
    """Archs whose slots can speculate: full-attention single-codebook
    text models.  A rejection rolls back by resetting ``pos``, sound only
    because every decode read masks the lanes past ``pos`` and the next
    write overwrites a lane before it is read.  Recurrent state cannot be
    rewound and a sliding window would evict real KV."""
    return (cfg.mixer_type != "mamba2" and not cfg.window and not cfg.n_vision_tokens
            and cfg.n_codebooks == 1)


def resolve_draft_config(cfg: ModelConfig, spec: SpecConfig) -> ModelConfig | None:
    """The draft model's config: ``spec.draft_arch`` as a reduced config;
    the target's own config for ``draft_arch=""`` with a divergent
    ``draft_param_seed``; or None for TRUE self-speculation (the draft
    would be the target bit for bit, so the target's pass is shared).  A
    real draft must share the target's token space and be able to roll
    back itself."""
    if not spec.draft_arch:
        return None if spec.draft_param_seed is None else cfg
    from ..configs import get_reduced

    dcfg = get_reduced(spec.draft_arch)
    if dcfg.vocab_size != cfg.vocab_size or dcfg.n_codebooks != 1:
        raise ValueError(
            f"draft arch {spec.draft_arch!r} vocab "
            f"{dcfg.vocab_size} does not match target {cfg.vocab_size}")
    if not spec_serving_supported(dcfg):
        raise ValueError(
            f"draft arch {spec.draft_arch!r} cannot speculate (recurrent/"
            "windowed/vision drafts cannot roll back)")
    return dcfg


def paged_pool_pages(scfg: ServeConfig) -> int:
    """Total pages in the shared pool (``page_budget`` override, else
    capacity-equivalent to the dense cache)."""
    return scfg.page_budget or scfg.batch * (scfg.max_len // scfg.page_size)


def paged_slot_decoder_init(cfg: ModelConfig, batch: int, max_len: int, page_size: int,
                            n_pages: int, device, draft_cfg: ModelConfig | None = None,
                            draft_len: int = 0) -> dict:
    """Paged variant of ``slot_decoder_init``: shared page POOLS plus a
    per-slot page table ``pages`` ((batch, max_len/page_size) int32 pool
    rows, -1 = unmapped).  Pool leaves carry no slot axis; the speculative
    leaves stay dense and per-slot."""
    if max_len % page_size:
        raise ValueError(
            f"max_len ({max_len}) must be a multiple of page_size ({page_size}): "
            "the paged-decode kernel gathers whole pages"
        )
    st = {
        "cache": T.init_paged_cache(cfg, batch, n_pages, page_size, device),
        **_slot_leaves(cfg, batch, max_len, device),
        "pages": torch.full((batch, max_len // page_size), -1, dtype=torch.int32, device=device),
    }
    if draft_len > 0:
        st.update(spec_state_leaves(draft_cfg, batch, max_len, draft_len, device))
    return st


def spec_k_eff(spec_k, budget, n_decoded, pos, max_len: int, draft_len: int):
    """Per-slot EFFECTIVE draft length of one tick, the clamp that keeps
    speculation observationally plain decode: ``budget - n_decoded - 2``
    (the host has emitted ``n_decoded + 1`` tokens and a tick commits at
    most k_eff + 1, so the request ends on the token plain decode ends
    on) and ``max_len - 1 - pos`` (the walk writes positions
    ``pos .. pos + k_eff``).  ``serving.paging.host_k_eff`` applies the
    same formula on the host to map pages ahead of the walk; the two must
    agree, or a verify sub-step writes an unmapped page."""
    room = torch.minimum(budget - n_decoded - 2, max_len - 1 - pos)
    return torch.clamp(torch.minimum(spec_k, room), 0, draft_len)


def place_decoder(cfg: ModelConfig, dcfg: ModelConfig | None, st: dict, ctx: ShardCtx) -> dict:
    """A slot decoder state with its ``cache`` (dense or paged) and a
    draft's dense ``draft_cache`` laid out on ``ctx.mesh`` by
    ``cache_pspecs``; the per-slot leaves stay tensors on the controller's
    device."""
    st["cache"] = place_cache(cfg, st["cache"], ctx)
    if "draft_cache" in st:
        st["draft_cache"] = place_cache(dcfg, st["draft_cache"], ctx)
    return st


def _roll_back(verifying, commit_pos, pos_leaf):
    """The verify walk's rollback of a cache's ``pos`` leaf: verifiers to
    ``commit_pos``, the others kept; a ``Sharded`` leaf keeps its layout."""
    pos = value(pos_leaf)
    new = torch.where(verifying, commit_pos.to(pos.dtype), pos)
    return shard_leaf(new, pos_leaf.spec, pos_leaf.mesh) if isinstance(pos_leaf, Sharded) else new


def serve_ctx(ctx: ShardCtx, scfg: ServeConfig) -> ShardCtx:
    """The ``ShardCtx`` a serve program of ``scfg`` runs under.  Spatial
    placement on a mesh takes ``launch.mesh.make_spatial_ctx``'s: every
    mesh axis manual and ``decode_shardmap`` off.  The pod axis then
    carries the replica slots, and inside a pod the weights and the cache
    stay replicated over the data and model members, as the JAX package's
    spatial executor places them (``repro/core/backend_spatial.py``:
    everything but the slot columns replicated): the program runs as the
    temporal one (``LOCAL``'s layout, the ctx's embedding strategy and
    KV block kept), and the spatial executor puts the slot columns on
    the pods.  A spatial program under ``make_ctx``'s ctx, or with
    ``decode_shardmap``, raises ``NotImplementedError``, as the JAX
    package raises there."""
    if ctx.mesh is None or scfg.placement == "temporal":
        return ctx
    if set(ctx.mesh.axis_names) <= set(ctx.manual_axes) and not ctx.decode_shardmap:
        return dataclasses.replace(LOCAL, embed_strategy=ctx.embed_strategy, block_k=ctx.block_k)
    raise NotImplementedError(
        "placement='spatial' under a ShardCtx with a mesh runs under "
        "launch.mesh.make_spatial_ctx (every mesh axis manual, decode_shardmap off): the pods "
        "carry the replica slots and each pod holds the weights and the cache whole.  Under "
        "make_ctx's ctx, or with decode_shardmap=True, the mesh would also lay out a decoder "
        "whose slot axis the pods split; the JAX package raises there too")


def make_slot_serve_program(cfg: ModelConfig, scfg: ServeConfig,
                            ctx: ShardCtx = LOCAL) -> MisoProgram:
    """The serving engine's resident program: a static ``weights`` cell
    plus a *slot-masked* ``decoder`` cell.  The decoder gates every state
    write on the per-slot ``active`` mask, and each batch row's math is
    row-independent, so an active slot's trajectory does not depend on
    which other slots are occupied — the isolation invariant the
    continuous batcher is built on.

    With ``scfg.spec`` the transition also runs the verify walk, for every
    slot with ``spec_k > 0``:

      sub-step 0      feeds the last committed token; the target emits
                      g1, the draft proposes d1 (both read the same input);
      sub-step j>=1   feeds d_j to BOTH models: the target emits g_{j+1},
                      the draft chains d_{j+1};
      commit          a = longest prefix with d_j == g_j; g_1..g_{a+1}
                      commit, and both cache positions roll back to
                      pos0 + a + 1 (the lanes past it are masked on every
                      later read and overwritten before use).

    Everything is inside the transition, so a §IV replay of the tick
    reproduces the accept and the rollback bit for bit.

    Under a ``ctx`` with a mesh the weights are laid out by
    ``param_pspecs`` and the cache by ``cache_pspecs``: the dense cache a
    slot's rows on its data member, a paged pool its pages over the data
    axes and its kv heads (or each page's lanes) over the model axis,
    read through the one global page table, and ``pos`` over the data
    axes.  A draft with its own params (``draft_arch``, or
    ``draft_param_seed``) is laid out the same way, with its dense cache.
    Every sub-step of the walk runs the target's and the draft's
    ``T.decode_step(..., ctx=ctx)``; a paged MLA latent pool is laid
    out and read the same way (pages over the data axes, each page's
    lanes over the model axis).  Spatial placement takes the ctx of
    ``launch.mesh.make_spatial_ctx`` (``serve_ctx``)."""
    from ..serving.slots import infer_slot_axes, mask_slots

    ctx = serve_ctx(ctx, scfg)
    spec = scfg.spec if scfg.spec is not None and spec_serving_supported(cfg) else None
    dcfg = resolve_draft_config(cfg, spec) if spec else None
    K = spec.draft_len if spec else 0
    d_seed = (scfg.param_seed if spec is None or spec.draft_param_seed is None
              else spec.draft_param_seed)

    def w_init(gen, device):
        # the weights draw from their own generator, seeded from the
        # program's seed and ``param_seed``; the draft from another, drawn
        # after, so the target's weights are a plain engine's
        g = torch.Generator(device=device).manual_seed(gen.initial_seed() + scfg.param_seed)
        st = {"params": place_params(cfg, T.init_params(cfg, g, device), ctx)}
        if dcfg is not None:
            gd = torch.Generator(device=device).manual_seed(gen.initial_seed() + d_seed)
            st["draft"] = place_params(dcfg, T.init_params(dcfg, gd, device), ctx)
        return st

    weights = CellType(name="weights", init=w_init, transition=lambda prev: prev["weights"])

    paged = scfg.paged and paged_serving_supported(cfg)
    if paged:
        from ..serving.paging import infer_paged_axes, mask_slots_paged

        n_pages = paged_pool_pages(scfg)
        axes = infer_paged_axes(
            lambda b: paged_slot_decoder_init(cfg, b, scfg.max_len, scfg.page_size, n_pages,
                                              "meta", dcfg, K)
        )
        mask_fn = mask_slots_paged

        def d_init(gen, device):
            return place_decoder(cfg, dcfg, paged_slot_decoder_init(
                cfg, scfg.batch, scfg.max_len, scfg.page_size, n_pages, device, dcfg, K), ctx)

    else:
        axes = infer_slot_axes(lambda b: slot_decoder_init(cfg, b, scfg.max_len, "meta", dcfg, K))
        mask_fn = mask_slots

        def d_init(gen, device):
            return place_decoder(cfg, dcfg, slot_decoder_init(cfg, scfg.batch, scfg.max_len,
                                                              device, dcfg, K), ctx)

    # bounded k-token prefill walk: prefill_chunk > 1 drains up to k
    # pending prompt tokens per tick (k sub-steps; non-walking slots step
    # once, in the first).  The verify walk needs K+1 sub-steps: walkers
    # still stop at k_walk, verifiers at their own k_eff
    k_walk = max(1, scfg.prefill_chunk if not cfg.n_vision_tokens else 0)
    n_sub = max(k_walk, K + 1) if spec else k_walk

    def sub_step(st, weights_params, j: int, draft_params=None, verifying=None, k_eff=None):
        act = st["active"]
        walking = act & (st["p_head"] < st["p_len"])
        if j == 0:
            elig = act
        elif spec:
            elig = (walking & (j < k_walk)) | (verifying & (j <= k_eff))
        else:
            elig = walking
        pend = st["pending"]  # (B, max_len), or (B, max_len, K) for K codebooks
        idx = st["p_head"].clamp(0, scfg.max_len - 1).long()[:, None]
        if pend.dim() == 3:
            idx = idx[:, :, None].expand(-1, 1, pend.shape[2])
        nxt_p = pend.gather(1, idx)  # (B, 1[, K])
        wmask = walking.reshape(-1, *(1,) * (nxt_p.dim() - 1))
        # walkers feed their next prompt token; verifiers the draft's
        # proposal, stashed in ``tokens`` below; the others their last argmax
        tok_in = torch.where(wmask, nxt_p, st["tokens"])
        logits, cache = T.decode_step(
            cfg, weights_params, st["cache"], tok_in, ctx=ctx, active=elig, pages=st.get("pages")
        )
        # (B, 1, V) -> (B, 1); (B, 1, K, V) -> (B, 1, K)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).reshape(st["tokens"].shape)
        new = {
            "cache": cache,
            "tokens": nxt,
            "active": act,
            "n_decoded": st["n_decoded"] + (elig & ~walking).to(torch.int32),
            "pending": st["pending"],
            "p_head": st["p_head"] + (elig & walking).to(torch.int32),
            "p_len": st["p_len"],
        }
        if paged:
            new["pages"] = st["pages"]
        d_raw = None
        if spec:
            if dcfg is None:
                # true self-speculation: the proposal IS the target's argmax
                d_raw = nxt
            else:
                # the draft steps on the input the target just read: while
                # walking it ingests prompt tokens, while verifying it
                # chains its own proposal
                d_logits, d_cache = T.decode_step(
                    dcfg, draft_params, st["draft_cache"], tok_in, ctx=ctx,
                    active=elig & (st["spec_k"] > 0),
                )
                d_raw = torch.argmax(d_logits, dim=-1).to(torch.int32).reshape(st["tokens"].shape)
                new["draft_cache"] = d_cache
            new["tokens"] = torch.where(verifying[:, None], d_raw, nxt)
            for k in ("spec_out", "spec_n", "spec_k", "budget"):
                new[k] = st[k]
        # gate the whole writeback on the eligibility mask
        return mask_fn(elig, new, st, axes), nxt, d_raw

    def d_transition(prev):
        st = prev["decoder"]
        wp = prev["weights"]["params"]
        if not spec:
            for j in range(n_sub):
                st, _, _ = sub_step(st, wp, j)
            return st
        dwp = prev["weights"]["draft"] if dcfg is not None else None
        act = st["active"]
        walking0 = act & (st["p_head"] < st["p_len"])
        pos0 = value(st["cache"]["pos"])
        nd0 = st["n_decoded"]
        k_eff = spec_k_eff(st["spec_k"], st["budget"], nd0, pos0, scfg.max_len, K)
        verifying = act & ~walking0 & (k_eff > 0)
        gs, ds = [], []
        for j in range(n_sub):
            st, g, d = sub_step(st, wp, j, dwp, verifying, k_eff)
            gs.append(g)
            ds.append(d)
        g_stack = torch.cat(gs, dim=1)  # (B, n_sub): g_{j+1}
        d_stack = torch.cat(ds, dim=1)  # (B, n_sub): d_{j+1}
        # accepted prefix: the raw argmaxes compared, positions past k_eff void
        m = (d_stack[:, :K] == g_stack[:, :K]) & (
            torch.arange(K, device=k_eff.device)[None, :] < k_eff[:, None])
        a = torch.cumprod(m.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)  # (B,)
        # commit g_1..g_{a+1}; the next tick re-anchors on g_{a+1}
        last = g_stack.gather(1, a.long()[:, None])
        commit_pos = (pos0 + a + 1).to(pos0.dtype)
        st = dict(st)
        st["tokens"] = torch.where(verifying[:, None], last, st["tokens"])
        st["cache"] = {**st["cache"], "pos": _roll_back(verifying, commit_pos, st["cache"]["pos"])}
        if dcfg is not None:
            st["draft_cache"] = {**st["draft_cache"], "pos": _roll_back(
                verifying, commit_pos, st["draft_cache"]["pos"])}
        st["n_decoded"] = torch.where(verifying, nd0 + a + 1, st["n_decoded"])
        st["spec_out"] = torch.where(act[:, None], g_stack[:, : K + 1], st["spec_out"])
        st["spec_n"] = torch.where(act, torch.where(verifying, a + 1, torch.zeros_like(a)),
                                   st["spec_n"])
        return st

    decoder = CellType(
        name="decoder", init=d_init, transition=d_transition, reads=("weights",),
        instances=scfg.batch,
    )
    prog = MisoProgram()
    prog.add(weights)
    prog.add(decoder)
    if scfg.placement == "spatial":
        if paged:
            # the paged pool is one shared global table; splitting it
            # across pods needs per-pod page accounting
            raise ValueError(
                "placement='spatial' does not support paged=True yet; "
                "use the dense cache for spatial serving")
        # the marker ``spatial_lockstep``'s serve mode keys on: the program
        # is the temporal one, only the executor splits the slot axis
        prog.spatial_serve = {"cell": "decoder", "axes": axes, "n_slots": scfg.batch}
    return prog


def install_prefill(cfg: ModelConfig, full: dict, filled: dict, plen) -> dict:
    """Copy a prefill cache into a max_len-capacity cache: every leaf whose
    length differs is padded (``slot_pos`` with -1 so padded lanes read as
    empty) and ``pos = plen``."""

    def leaf(d, s):
        if d.shape == s.shape:
            return s.to(d.dtype)
        ax = next(i for i in range(d.dim()) if d.shape[i] != s.shape[i])
        fill = 0 if s.is_floating_point() else -1
        out = torch.full(d.shape, fill, dtype=d.dtype, device=d.device)
        out.narrow(ax, 0, s.shape[ax]).copy_(s)
        return out

    # a zamba unit's segment nests its mamba states and its attention cache
    segs = [tree_map(leaf, d, s) for d, s in zip(full["segments"], filled["segments"])]
    return {"segments": segs, "pos": torch.full_like(full["pos"], int(plen))}


def prefill_slot_state(
    cfg: ModelConfig,
    scfg: ServeConfig,
    params,
    prompt: torch.Tensor,
    *,
    ctx: ShardCtx = LOCAL,
    prompt_len=None,
    pending=None,
    n_pending=None,
    spec_k=None,
    budget=None,
    draft_cfg: ModelConfig | None = None,
    draft_params=None,
) -> tuple[dict, torch.Tensor]:
    """Run the prefill for ONE prompt (head chunk) and package it as a
    width-1 dense decoder slot state, ready to join a free slot.

    prompt: (P,) int32, or (P, K) for K codebooks; P may be a bucket,
    with ``prompt_len`` the true head length (padded cache positions are
    masked and the first token is read at ``prompt_len - 1``).  A vision
    arch's stub splices zero embeddings over the first rows.
    ``pending``/``n_pending``: the uncovered prompt tail, (max_len[, K])
    zero-padded + its length.  ``spec_k``/
    ``budget`` (speculating engines; not None = speculating) land in the
    spec leaves, and a real draft (``draft_cfg``/``draft_params``) runs
    its own prefill of the same head into its own dense cache.  Under a
    ``ctx`` with a mesh the prefill reads the sharded weights, and the
    slot state comes back unsharded (joining it places it).  Returns
    ``(slot_state, first_token)``."""
    dev = prompt.device
    tokens = prompt[None]
    plen = tokens.shape[1] if prompt_len is None else int(prompt_len)
    vision = None
    if cfg.n_vision_tokens:
        vision = torch.zeros((1, min(cfg.n_vision_tokens, tokens.shape[1]), cfg.d_model),
                             dtype=cfg.compute_dtype, device=dev)
    logits, cache = T.forward(cfg, params, tokens, ctx=ctx, vision_embeds=vision,
                              fill_cache=True, prompt_len=prompt_len)
    full = T.init_cache(cfg, 1, scfg.max_len, dev)
    tail = token_dims(cfg)
    # (1, 1), or (1, 1, K)
    first = torch.argmax(logits[:, plen - 1 : plen], dim=-1).to(torch.int32).reshape(1, 1, *tail)
    if pending is None:
        pending = torch.zeros((1, scfg.max_len, *tail), dtype=torch.int32, device=dev)
        n_pending = 0
    st = {
        "cache": install_prefill(cfg, full, cache, plen),
        "tokens": first,
        "active": torch.ones((1,), dtype=torch.bool, device=dev),
        "n_decoded": torch.zeros((1,), dtype=torch.int32, device=dev),
        "pending": pending.to(torch.int32).reshape(1, scfg.max_len, *tail),
        "p_head": torch.zeros((1,), dtype=torch.int32, device=dev),
        "p_len": torch.full((1,), int(n_pending), dtype=torch.int32, device=dev),
    }
    if spec_k is not None:
        def one(v):
            return torch.full((1,), int(v), dtype=torch.int32, device=dev)

        st["spec_out"] = torch.zeros((1, scfg.spec.draft_len + 1), dtype=torch.int32, device=dev)
        st["spec_n"] = one(0)
        st["spec_k"] = one(spec_k)
        st["budget"] = one(budget)
        if draft_cfg is not None:
            _, d_cache = T.forward(draft_cfg, draft_params, tokens, ctx=ctx, fill_cache=True,
                                   prompt_len=prompt_len)
            st["draft_cache"] = install_prefill(
                draft_cfg, T.init_cache(draft_cfg, 1, scfg.max_len, dev), d_cache, plen)
    return st, first
