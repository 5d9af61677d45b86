"""Model building blocks: norms, RoPE and M-RoPE, GQA and MLA attention, MLPs.

A port of the GQA/MLA/MLP subset of ``repro/models/layers.py``: plain
functions on tensors, parameters in plain dicts with the JAX package's
keys and layouts.  Attention has three execution paths:

  * ``blockwise_attention`` — online-softmax attention over KV blocks
    (prefill; MLA's expanded path too), plain torch as in the JAX package;
  * the paged branches of ``gqa_attention`` and ``mla_attention`` —
    single-query attention through a page table, the hand-written CUDA
    kernels ``kernels.paged_decode.paged_gqa_attention`` and
    ``paged_mla_attention``;
  * ``decode_attention`` / the dense branch of ``mla_attention`` —
    single-query attention over a dense cache.  On the CPU, plain torch
    as in the JAX package (``attend`` / ``attend_mla``, masked by
    ``slot_pos``).  On the card, the same kernels as paged decode over
    the dense cache seen as one page a slot (``dense_gqa_view`` /
    ``dense_mla_view``), masked by lane: the two masks agree on every
    active slot (a full cache holds ``slot_pos[b, s] = s`` for every
    ``s <= pos``; a sliding window's ring is full once it wraps, so the
    lane bound is ``min(pos, S-1)``, ``ring_lane_pos``), and the kernels
    reduce a dense view and a paged pool in the same order, so paged and
    dense decode give the same bits.

Under a ``ShardCtx`` with a mesh the weights are ``Sharded`` leaves
(``distributed/sharding.py``) and every product with one goes through
``matmul``: column-parallel where the output dimension is sharded (the
members' outputs concatenated), row-parallel where the input dimension
is (the members' partial products summed in member order), both for a
weight sharded two ways.  Activations are ordinary tensors on the
controller's device, but for the residual of an attention layer under
``ShardCtx.seq_shard_acts``: a ``Sharded`` leaf laid out by
``ShardCtx.seq_spec`` (``seq_scatter``), normed member by member
(``rmsnorm_blocks``), gathered before the column-parallel products
(``seq_gather``), and written by the row-parallel ones straight into that
layout (``matmul(..., scatter=)``: the reduce-scatter).  The same row
tiles norm a whole residual under a mesh without it (``norm_gather``),
so the layout moves bytes, never bits.  Decode over a sharded dense
cache goes through ``distributed/decode.py`` (after the paged branch,
as in JAX, and only under ``ctx.decode_shardmap``: the port has no
partitioner for JAX's other route).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed import decode as DD
from ..distributed import wire
from ..distributed.sharding import Sharded, map_blocks, spec_block
from ..kernels.paged_decode import NEG_INF, attend, dense_decode_on_card, dense_gqa_view, dense_mla_decode
from ..kernels.paged_decode import gate as _gate
from ..kernels.paged_decode import paged_gqa_attention, paged_mla_attention, ring_lane_pos
from .config import MLAConfig, ModelConfig

Params = dict


# --------------------------------------------------------------------------
# sharded weights
# --------------------------------------------------------------------------
def value(w):
    """A parameter leaf as a tensor: a ``Sharded`` leaf's global value
    (a replicated one read in place; a sharded bias or norm gathered)."""
    return w.full() if isinstance(w, Sharded) else w


def matmul(x: torch.Tensor, w, *, transpose: bool = False, scatter=None):
    """``x @ w`` (``x @ w.T`` with ``transpose``) for a plain or a
    ``Sharded`` 2-D weight.  Sharded: each distinct block of ``w`` (its
    rows over the contraction, its columns over the output) multiplies
    the matching columns of ``x`` on its member's device; the blocks of
    one output range are summed in member order in f32 and cast once
    (row-parallel: ``wo``, ``w2``, an FSDP-sharded input dimension), and
    the output ranges are concatenated (column-parallel: ``wq``, ``w1``,
    the vocab-sharded ``lm_head``).  A replicated weight is one
    product.  An active ``wire`` meter records what a deployment moves
    for it (``_record_matmul``).

    ``scatter=(mesh, spec)`` returns the product as a ``Sharded`` leaf of
    that layout (a (B, S, d) residual's ``ShardCtx.seq_spec``): the same
    partials summed in the same order and cast once, each member's block
    of the sum handed to its device (``seq_scatter``): the reduce-scatter of
    a row-parallel product, recorded so, every block the bits of the
    same rows of the whole product, and its cotangent the whole one."""
    kdim, ndim_ = (1, 0) if transpose else (0, 1)
    if scatter is not None:
        if wire.active() and isinstance(w, Sharded):
            _record_matmul(x, w, kdim, ndim_, scatter=True)
        with wire.paused():
            y = matmul(x, w, transpose=transpose)
        return seq_scatter(y, *scatter)
    if not isinstance(w, Sharded):
        return x @ (w.T if transpose else w)
    if wire.active():
        _record_matmul(x, w, kdim, ndim_)
    cols: dict = {}
    for c in w.coords():
        blk = w.block(c)
        ks, ns = blk[kdim], blk[ndim_]
        parts = cols.setdefault((ns.start, ns.stop), {})
        parts.setdefault((ks.start, ks.stop), w.local(c))
    outs = []
    for (n0, n1), parts in sorted(cols.items()):
        acc = None
        for (k0, k1), t in sorted(parts.items()):
            xk = x if len(parts) == 1 else x[..., k0:k1]
            y = xk.to(t.device) @ (t.T if transpose else t)
            if len(parts) == 1:
                acc = y.to(x.device)
            else:
                acc = y.float().to(x.device) if acc is None else acc + y.float().to(x.device)
        outs.append(acc.to(x.dtype))
    if len(outs) == 1:
        return outs[0]
    return torch.cat(outs, dim=-1)


def _record_matmul(x: torch.Tensor, w: Sharded, kdim: int, ndim_: int,
                   scatter: bool = False) -> None:
    """The movements of ``matmul``'s product with ``w`` as an FSDP and
    tensor-parallel deployment makes them, by the axes of ``w``'s spec:

      * the axes other than the model axis (FSDP): every member gathers
        the weight block that the model axis leaves it, in the weight's
        dtype (an all-gather over those axes, site ``fsdp``);
      * the model axis on the contraction (row-parallel): the f32
        partial products summed over it (an all-reduce, site ``matmul``;
        with ``scatter``, a reduce-scatter whose result is the member's
        sequence block of the partials);
      * the model axis on the output (column-parallel): the output
        ranges joined as the controller joins them (an all-gather, site
        ``matmul``; a deployment that keeps them split into the next
        row-parallel product moves nothing here).

    Activations are the whole batch's (see ``wire``)."""
    axes = [wire.spec_axes(w.spec[d] if len(w.spec) > d else None) for d in (kdim, ndim_)]
    ways = lambda names: math.prod(w.mesh.shape[a] for a in names)
    km, nm = (ways([a for a in ax if a == wire.MODEL_AXIS]) for ax in axes)
    fsdp = tuple(a for ax in axes for a in ax if a != wire.MODEL_AXIS)
    if fsdp:
        gathered = w.shape[kdim] * w.shape[ndim_] / (km * nm) * w.dtype.itemsize
        wire.record("all-gather", gathered, ways(fsdp), members=w.mesh.devices.size, site="fsdp",
                    axes=fsdp)
    out = (x.numel() // x.shape[-1]) * w.shape[ndim_]
    model = (wire.MODEL_AXIS,)
    if km > 1 and scatter:
        wire.record("reduce-scatter", 4 * out / km, km, members=km, site="matmul", axes=model)
    elif km > 1:
        wire.record("all-reduce", 4 * out, km, members=km, site="matmul", axes=model)
    if nm > 1:
        wire.record("all-gather", out * x.element_size(), nm, members=nm, site="matmul",
                    axes=model)


# --------------------------------------------------------------------------
# sequence-parallel activations (``ShardCtx.seq_shard_acts``)
# --------------------------------------------------------------------------
def _layout_plan(mesh, spec, shape) -> list:
    """``[(block, device, coords)]``: each distinct block of a global
    ``shape`` laid out by ``spec`` on each device that holds it, with the
    members that hold it there, first member first."""
    made: dict = {}
    for c in np.ndindex(*mesh.devices.shape):
        blk = spec_block(mesh, spec, shape, c)
        dev = mesh.devices[c]
        made.setdefault((tuple((s.start, s.stop) for s in blk), str(dev)), (blk, dev, []))[2].append(c)
    return list(made.values())


def _wrap(mesh, spec, shape, plan: list, tensors) -> Sharded:
    """The ``Sharded`` leaf of global ``shape`` of a plan's tensors (one
    an entry)."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for (_, _, coords), t in zip(plan, tensors):
        for c in coords:
            out[c] = t
    return Sharded(mesh, spec, shape, tensors[0].dtype, out)


class _Scatter(torch.autograd.Function):
    """A whole tensor cut into a plan's blocks, each its own allocation on
    its member's device (the local half of a reduce-scatter: nothing
    moves).  The backward joins the blocks' cotangents into the whole
    one (copies of one block on several devices summed, in member
    order): the all-gather that is a reduce-scatter's adjoint."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.shape, ctx.dtype, ctx.device = plan, x.shape, x.dtype, x.device
        return tuple(x[blk].to(dev, copy=True, memory_format=torch.contiguous_format)
                     for blk, dev, _ in plan)

    @staticmethod
    def backward(ctx, *grads):
        seen: dict = {}
        for (blk, _, _), g in zip(ctx.plan, grads):
            if g is None:
                continue
            key = tuple((s.start, s.stop) for s in blk)
            seen[key] = (blk, g.to(ctx.device) if key not in seen else seen[key][1] + g.to(ctx.device))
        n_blocks = len({tuple((s.start, s.stop) for s in blk) for blk, _, _ in ctx.plan})
        make = torch.empty if len(seen) == n_blocks else torch.zeros
        out = make(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        for blk, g in seen.values():
            out[blk] = g
        return out, None


class _Gather(torch.autograd.Function):
    """A plan's blocks joined into the whole tensor on ``device``, each
    block read from its first holder.  The backward hands each first
    holder its block of the cotangent on its device."""

    @staticmethod
    def forward(ctx, plan, shape, device, *tensors):
        ctx.plan, ctx.firsts = plan, []
        out = torch.empty(shape, dtype=tensors[0].dtype, device=device)
        seen = set()
        for (blk, _, _), t in zip(plan, tensors):
            key = tuple((s.start, s.stop) for s in blk)
            ctx.firsts.append(key not in seen)
            if key not in seen:
                seen.add(key)
                out[blk] = t.to(device)
        return out

    @staticmethod
    def backward(ctx, g):
        return (None, None, None) + tuple(
            g[blk].to(dev, memory_format=torch.contiguous_format) if first else None
            for (blk, dev, _), first in zip(ctx.plan, ctx.firsts))


def seq_scatter(x: torch.Tensor, mesh, spec) -> Sharded:
    """``x`` laid out by ``spec`` on ``mesh``, differentiably, each
    member's block its own allocation on its device (``_Scatter``):
    the local half of a reduce-scatter, which moves nothing."""
    plan = _layout_plan(mesh, spec, tuple(x.shape))
    return _wrap(mesh, spec, tuple(x.shape), plan, _Scatter.apply(x, plan))


def _plan_of(h: Sharded) -> tuple:
    """``(plan, tensors)`` of a leaf laid out as ``_layout_plan`` lays it."""
    plan = _layout_plan(h.mesh, h.spec, tuple(h.shape))
    return plan, [h.local(coords[0]) for _, _, coords in plan]


def seq_gather(h: Sharded, *, record: bool = True) -> torch.Tensor:
    """The whole of a sequence-parallel residual on the mesh's first
    device, differentiably (``_Gather``).  With ``record``, an active
    ``wire`` meter records the all-gather over the model axis in the
    activation's dtype (site ``seq``): every model member receives the
    whole sequence of its rows (the whole batch's bytes, see ``wire``)."""
    plan, tensors = _plan_of(h)
    if record and wire.active():
        tp = wire.spec_axes(h.spec[1])
        n = math.prod(h.mesh.shape[a] for a in tp)
        wire.record("all-gather", h.numel() * h.dtype.itemsize, n, members=n, site="seq", axes=tp)
    return _Gather.apply(plan, tuple(h.shape), h.device, *tensors)


class _Scale(torch.autograd.Function):
    """``n_t * w`` for each block's normalised rows ``n_t``.  The weight's
    cotangent is summed over each block's rows as one contiguous (rows,
    d) sum, then over the blocks in their order, so row tiles of one
    layout give it the same bits whether they are the members' own
    blocks or cut from a whole tensor (autograd's sum over a whole
    tensor's rows is another order)."""

    @staticmethod
    def forward(ctx, w, *ns):
        ctx.save_for_backward(w, *ns)
        return tuple(n * w.to(n.device) for n in ns)

    @staticmethod
    def backward(ctx, *grads):
        w, *ns = ctx.saved_tensors
        dw = None
        for n, g in zip(ns, grads):
            if g is not None:
                part = (g * n).reshape(-1, n.shape[-1]).sum(0).to(w.device)
                dw = part if dw is None else dw + part
        return (dw,) + tuple(None if g is None else g * w.to(g.device) for g in grads)


def rmsnorm_blocks(h: Sharded, w, eps: float = 1e-5) -> Sharded:
    """``rmsnorm`` of every member's block of ``h`` on its device, laid
    out as ``h``: each row's bits are those of the same row normed in any
    other tile of the same shape (the tiles of one layout all have one)."""
    plan, tensors = _plan_of(h)
    ns = []
    for t in tensors:
        # one node (a view) between the block and the norm's three reads,
        # so the block receives their cotangents summed, as one term: a
        # residual block that is also added to keeps a sum of two
        xf = t.float().view_as(t)
        ns.append(xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps))
    ys = _Scale.apply(value(w).float(), *ns)
    return _wrap(h.mesh, h.spec, tuple(h.shape), plan, [y.to(t.dtype) for y, t in zip(ys, tensors)])


def norm_gather(h, w, eps: float, mesh, spec) -> torch.Tensor:
    """An attention layer's ``rmsnorm`` before its column-parallel
    products, under a mesh whose model axis splits the sequence: over the
    row tiles of ``spec`` (``rmsnorm_blocks``), gathered whole.  A
    sequence-parallel residual (``Sharded``) is normed member by member
    and its all-gather recorded; a whole one is cut into the same tiles
    and joined back, which moves nothing, so the two give the same bits."""
    sp = isinstance(h, Sharded)
    return seq_gather(rmsnorm_blocks(h if sp else seq_scatter(h, mesh, spec), w, eps), record=sp)


def add(h, y):
    """``h + y`` of two tensors, or member by member of two ``Sharded``
    leaves of one layout (a sequence-parallel residual)."""
    if isinstance(h, Sharded):
        return map_blocks(lambda _, a, b: a + b, h, y)
    return h + y


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def dense_init(gen, d_in: int, d_out: int, dtype, device, scale=None):
    scale = (d_in**-0.5) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)  # in place: one f32 temporary, not two


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * value(w).float()).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float, sections=None):
    """cos/sin tables -> (..., S, dim/2).  positions: (..., S) for
    standard RoPE, or (3, ..., S) with ``sections`` for M-RoPE (qwen2-vl's
    t/h/w streams: frequency i reads the stream its section names)."""
    half = dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / (theta**exponent)
    if sections is None:
        freqs = positions[..., None].float() * inv
    else:
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to {half}")
        stream = torch.repeat_interleave(torch.arange(len(sections), device=positions.device),
                                         torch.tensor(sections, device=positions.device))
        freqs = positions[stream].movedim(0, -1).float() * inv  # (..., S, half)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D/2) or (S, D/2)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def blockwise_attention(
    q: torch.Tensor,  # (B, Hq, Sq, Dk)
    k: torch.Tensor,  # (B, Hkv, Sk, Dk)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
    block_k: int = 1024,
) -> torch.Tensor:
    B, Hq, Sq, Dk = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = (Dk**-0.5) if scale is None else scale
    block_k = min(block_k, Sk)
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    dev = q.device
    qf = q.float() * scale
    qpos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hq, Sq, v.shape[-1]), dtype=torch.float32, device=dev)
    # the last block is ragged where block_k does not divide Sk (JAX
    # asserts it does; an exact-length windowed prefill of 4000 tokens
    # does not)
    for k0 in range(0, Sk, block_k):
        kblk = k[:, :, k0 : k0 + block_k].float()
        vblk = v[:, :, k0 : k0 + block_k].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kblk)
        kpos = k0 + torch.arange(kblk.shape[2], device=dev)
        mask = torch.ones((Sq, kblk.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vblk)
        m = m_new
    out = torch.where(l[..., None] > 0, acc / torch.clamp(l, min=1e-30)[..., None], 0.0)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, Hq, 1, Dk)
    k_cache: torch.Tensor,  # (B, Hkv, S, Dk)
    v_cache: torch.Tensor,  # (B, Hkv, S, Dv)
    slot_pos: torch.Tensor,  # (B, S) absolute position in each slot, -1 = empty
    pos: torch.Tensor,  # (B,) current absolute position of the query
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    Dk = q.shape[-1]
    scale = (Dk**-0.5) if scale is None else scale
    if dense_decode_on_card(q.device):
        out = paged_gqa_attention(q[:, :, 0].contiguous(), *dense_gqa_view(k_cache, v_cache),
                                  ring_lane_pos(pos, k_cache.shape[2]).contiguous(), scale=scale)
        return out[:, :, None]
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window is not None:
        valid &= slot_pos > (pos[:, None] - window)
    return attend(q[:, :, 0], k_cache, v_cache, valid, scale)[:, :, None]


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------
def gqa_init(gen, cfg: ModelConfig, device) -> Params:
    d, dh, dt = cfg.d_model, cfg.head_dim, cfg.compute_dtype
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * dh, dt, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * dh, dt, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * dh, dt, device),
        "wo": dense_init(gen, cfg.n_heads * dh, d, dt, device),
    }
    if cfg.use_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * dh,), dtype=dt, device=device)
    return p


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Dense KV cache for one layer.  SWA archs only keep `window` slots."""
    S = min(max_len, cfg.window) if cfg.window else max_len
    shape = (batch, cfg.n_kv_heads, S, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "slot_pos": torch.full((batch, S), -1, dtype=torch.int32, device=device),
    }


def gqa_paged_cache_init(cfg: ModelConfig, n_pages: int, page_size: int, device) -> dict:
    """Paged KV pool for one layer: ``n_pages`` fixed-size pages shared by
    every slot; the per-slot page table maps logical page -> pool row."""
    shape = (n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
    }


def gqa_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (B, S), or (3, B, S) under M-RoPE
    cache: Optional[dict] = None,  # decode when present
    block_k: int = 1024,
    active: Optional[torch.Tensor] = None,  # (B,) serving slot mask (decode)
    pages: Optional[torch.Tensor] = None,  # (B, P) page table -> paged decode
    rows_lanes: Optional[tuple] = None,  # paged: precomputed paged_write_rows
    ctx=None,  # ShardCtx: a mesh -> sharded weights and cache
    scatter=None,  # prefill: (mesh, spec) of a sequence-parallel output
) -> tuple[torch.Tensor, Optional[dict]]:
    """GQA attention.  Decode (``cache`` given) writes the new K/V lane
    INTO ``cache`` in place and returns it: ``decode_step`` hands every
    layer views of a fresh copy of the stacked cache, so the caller's
    previous buffer (kept for the §IV replay) is never written.  Under
    a ``ctx`` with a mesh the dense-cache decode, and the paged decode
    over a ``Sharded`` pool, run through ``distributed/decode.py``.
    ``scatter`` reduce-scatters the prefill's ``wo`` product into a
    sequence-parallel residual's layout (``matmul``)."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    q, k, v = matmul(x, p["wq"]), matmul(x, p["wk"]), matmul(x, p["wv"])
    if cfg.use_bias:
        q, k, v = q + value(p["bq"]), k + value(p["bk"]), v + value(p["bv"])
    q = q.reshape(B, S, cfg.n_heads, dh)
    k = k.reshape(B, S, cfg.n_kv_heads, dh)
    v = v.reshape(B, S, cfg.n_kv_heads, dh)
    cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta, cfg.mrope_sections)
    q = apply_rope(q, cos, sin).transpose(1, 2)  # (B, H, S, D)
    k = apply_rope(k, cos, sin).transpose(1, 2)
    v = v.transpose(1, 2)

    if cache is None:
        out = blockwise_attention(q, k, v, causal=True, window=cfg.window, block_k=block_k)
        return matmul(out.transpose(1, 2).reshape(B, S, cfg.n_heads * dh), p["wo"],
                      scatter=scatter), None
    if S != 1:
        raise ValueError("decode path handles one token at a time")
    pos = (positions[0] if cfg.mrope_sections else positions)[:, 0]
    if pages is not None:
        if cfg.window:
            raise ValueError("paged decode excludes windowed archs")
        if isinstance(cache["k"], Sharded):
            # a pool laid out by ``cache_pspecs``: each member writes and
            # attends over its own block (``distributed/decode.py``);
            # ``decode_step`` hands every layer the step's member plan
            plan = rows_lanes if isinstance(rows_lanes, DD.PagedPlan) else DD.paged_plan(
                cache["k"], pages, pos,
                paged_write_rows(pages, pos, active, cache["k"].shape[0], cache["k"].shape[2]))
            out = DD.paged_gqa_decode(q[:, :, 0], k[:, :, 0], v[:, :, 0], cache, plan)
            return matmul(out.reshape(B, S, cfg.n_heads * dh), p["wo"]), cache
        # the write lands at (row, lane) through the page table.  JAX drops
        # the scatter to an out-of-range row for inactive slots and
        # unmapped pages; torch would raise, so those rows are left out
        if rows_lanes is None:
            rows_lanes = paged_write_rows(pages, pos, active, cache["k"].shape[0], cache["k"].shape[2])
        rows, lanes, sel = rows_lanes
        cache["k"][rows, :, lanes] = k[sel, :, 0].to(cache["k"].dtype)
        cache["v"][rows, :, lanes] = v[sel, :, 0].to(cache["v"].dtype)
        out = paged_gqa_attention(
            q[:, :, 0].contiguous(), cache["k"], cache["v"], pages, pos.contiguous()
        )
        return matmul(out.reshape(B, S, cfg.n_heads * dh), p["wo"]), cache
    if isinstance(cache["k"], Sharded):
        _require_decode_shardmap(ctx)
        res = DD.gqa_decode(q, k[:, :, 0], v[:, :, 0], cache, pos, cfg=cfg, ctx=ctx,
                            active=active)
        if res is None:  # no layout divides: each data member's rows on their own
            act = torch.ones((B,), dtype=torch.bool, device=x.device) if active is None else active
            res = DD.local_decode(q, k[:, :, 0], v[:, :, 0], cache, pos, cfg=cfg, active=act), cache
        out, cache = res
        return matmul(out.transpose(1, 2).reshape(B, S, cfg.n_heads * dh), p["wo"]), cache
    Sc = cache["k"].shape[2]
    slot = pos % Sc
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, :, slot] = _gate(active, k[:, :, 0].to(cache["k"].dtype), cache["k"][bidx, :, slot])
    cache["v"][bidx, :, slot] = _gate(active, v[:, :, 0].to(cache["v"].dtype), cache["v"][bidx, :, slot])
    cache["slot_pos"][bidx, slot] = _gate(active, pos.to(torch.int32), cache["slot_pos"][bidx, slot])
    out = decode_attention(q, cache["k"], cache["v"], cache["slot_pos"], pos, window=cfg.window)
    return matmul(out.transpose(1, 2).reshape(B, S, cfg.n_heads * dh), p["wo"]), cache


def _require_decode_shardmap(ctx) -> None:
    """A sharded decode cache is decoded through ``distributed/decode.py``
    only: JAX's other route (``decode_shardmap`` False) is its
    partitioner, which the port does not have."""
    if ctx is None or not ctx.decode_shardmap or ctx.mesh is None:
        raise ValueError("decode over a sharded cache needs a ShardCtx with a mesh and "
                         "decode_shardmap=True (the flash-decoding layout); the port has no "
                         "partitioner to take JAX's other route")


def paged_write_rows(pages, pos, active, n_pages: int, page_size: int):
    """``(rows, lanes, sel)`` of one decode step's paged write into a pool
    of ``n_pages`` pages of ``page_size`` lanes (GQA's (N, Hkv, ps, D) or
    MLA's (N, ps, d)): the slots ``sel`` that write (active, with a pool
    row in [0, N) — the rows JAX's scatter does not drop) and their row
    and lane.  The same for every layer, so ``decode_step`` computes it
    once (the selection is a host round trip)."""
    P = pages.shape[1]
    pidx = torch.div(pos, page_size, rounding_mode="floor").long()
    row = pages.gather(1, pidx.clamp(0, P - 1)[:, None])[:, 0]
    ok = (row >= 0) & (row < n_pages) & (pidx < P)
    if active is not None:
        ok = ok & active
    sel = ok.nonzero()[:, 0]
    return row[sel].long(), (pos[sel] % page_size).long(), sel


# --------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V3)
# --------------------------------------------------------------------------
def mla_init(gen, cfg: ModelConfig, device) -> Params:
    m = cfg.mla or MLAConfig()
    d, h, dt = cfg.d_model, cfg.n_heads, cfg.compute_dtype
    return {
        "wq_a": dense_init(gen, d, m.q_lora_rank, dt, device),
        "q_norm": torch.ones((m.q_lora_rank,), dtype=dt, device=device),
        "wq_b": dense_init(gen, m.q_lora_rank, h * (m.qk_nope_dim + m.qk_rope_dim), dt, device),
        "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_dim, dt, device),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dt, device=device),
        "wkv_b": dense_init(gen, m.kv_lora_rank, h * (m.qk_nope_dim + m.v_head_dim), dt, device),
        "wo": dense_init(gen, h * m.v_head_dim, d, dt, device),
    }


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Dense latent cache for one layer: one ``ckv``/``krope`` row per
    token, shared by every head."""
    m = cfg.mla or MLAConfig()
    dt = cfg.compute_dtype
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dt, device=device),
        "krope": torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dt, device=device),
        "slot_pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def mla_paged_cache_init(cfg: ModelConfig, n_pages: int, page_size: int, device) -> dict:
    """Paged latent pool for one layer (see ``gqa_paged_cache_init``)."""
    m = cfg.mla or MLAConfig()
    dt = cfg.compute_dtype
    return {
        "ckv": torch.zeros((n_pages, page_size, m.kv_lora_rank), dtype=dt, device=device),
        "krope": torch.zeros((n_pages, page_size, m.qk_rope_dim), dtype=dt, device=device),
    }


def mla_latent(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The latent cache rows of ``x``: the normalised ``ckv`` (B, S, lora)
    and the RoPE'd shared key ``krope`` (B, S, rope)."""
    m = cfg.mla or MLAConfig()
    ckv, k_rope = matmul(x, p["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    cos, sin = rope_cos_sin(positions, m.qk_rope_dim, cfg.rope_theta)
    return rmsnorm(ckv, p["kv_norm"], cfg.rms_eps), apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0]


def mla_attention(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (B, S)
    cache: Optional[dict] = None,  # decode when present
    block_k: int = 1024,
    active: Optional[torch.Tensor] = None,  # (B,) serving slot mask (decode)
    pages: Optional[torch.Tensor] = None,  # (B, P) page table -> paged decode
    rows_lanes: Optional[tuple] = None,  # paged: precomputed paged_write_rows
    ctx=None,  # ShardCtx: a mesh -> sharded weights and latent cache
    scatter=None,  # prefill: (mesh, spec) of a sequence-parallel output
) -> tuple[torch.Tensor, Optional[dict]]:
    """MLA.  Prefill (no cache) expands per-head keys (width qk_nope +
    qk_rope) and values (width v_head) from the latent and runs
    ``blockwise_attention``.  Decode absorbs ``w_uk`` into the query and
    attends in the latent space, writing the new ``ckv``/``krope`` lane
    INTO ``cache`` in place (views of ``decode_step``'s copy, as in
    ``gqa_attention``); ``w_uv`` is applied to the f32 latent context
    after it is cast to the compute dtype.  ``scatter`` as in
    ``gqa_attention``."""
    m = cfg.mla or MLAConfig()
    B, S, _ = x.shape
    h = cfg.n_heads
    nope, rope, lora, dv = m.qk_nope_dim, m.qk_rope_dim, m.kv_lora_rank, m.v_head_dim
    scale = (nope + rope) ** -0.5

    q = matmul(rmsnorm(matmul(x, p["wq_a"]), p["q_norm"], cfg.rms_eps), p["wq_b"])
    q_nope, q_rope = q.reshape(B, S, h, nope + rope).split([nope, rope], dim=-1)
    cos, sin = rope_cos_sin(positions, rope, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    ckv, k_rope = mla_latent(p, x, cfg, positions)  # (B, S, lora) / (B, S, rope)
    wkv_b = value(p["wkv_b"]).reshape(lora, h, nope + dv)
    w_uk, w_uv = wkv_b[:, :, :nope], wkv_b[:, :, nope:]  # (lora, h, nope) / (lora, h, v)

    if cache is None:
        # expanded path (prefill): per-head k, v from the latent
        k_nope = torch.einsum("bsl,lhn->bshn", ckv, w_uk)
        v = torch.einsum("bsl,lhv->bshv", ckv, w_uv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, rope)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = blockwise_attention(qfull.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=True, scale=scale, block_k=block_k)  # (B, h, S, v)
        return matmul(out.transpose(1, 2).reshape(B, S, h * dv), p["wo"], scatter=scatter), None
    if S != 1:
        raise ValueError("decode path handles one token at a time")
    # absorbed path (decode): attend in the latent space
    pos = positions[:, 0]
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope[:, 0], w_uk)  # (B, h, lora)
    if pages is None and isinstance(cache["ckv"], Sharded):
        _require_decode_shardmap(ctx)
        res = DD.mla_decode(q_lat[:, None], q_rope, ckv[:, 0], k_rope[:, 0], cache, pos,
                            cfg=cfg, ctx=ctx, active=active)
        if res is None:  # no model axis divides the lanes: each data member's rows on their own
            act = torch.ones((B,), dtype=torch.bool, device=x.device) if active is None else active
            res = DD.local_mla_decode(q_lat[:, None], q_rope, ckv[:, 0], k_rope[:, 0], cache,
                                      pos, cfg=cfg, active=act), cache
        ctx_lat, cache = res
        out = torch.einsum("bhl,lhv->bhv", ctx_lat[:, 0].to(x.dtype), w_uv)
        return matmul(out.reshape(B, S, h * dv), p["wo"]), cache
    if pages is not None and isinstance(cache["ckv"], Sharded):
        # a latent pool laid out by ``cache_pspecs``: each member writes and
        # attends over its own block (``distributed/decode.py``);
        # ``decode_step`` hands every layer the step's member plan
        plan = rows_lanes if isinstance(rows_lanes, DD.PagedPlan) else DD.paged_plan(
            cache["ckv"], pages, pos,
            paged_write_rows(pages, pos, active, cache["ckv"].shape[0], cache["ckv"].shape[1]),
            latent=True)
        lat = DD.paged_mla_decode(q_lat, q_rope[:, 0], ckv[:, 0], k_rope[:, 0], cache, plan,
                                  scale=scale)
    elif pages is not None:
        if rows_lanes is None:
            rows_lanes = paged_write_rows(pages, pos, active, cache["ckv"].shape[0], cache["ckv"].shape[1])
        rows, lanes, sel = rows_lanes
        cache["ckv"][rows, lanes] = ckv[sel, 0].to(cache["ckv"].dtype)
        cache["krope"][rows, lanes] = k_rope[sel, 0].to(cache["krope"].dtype)
        lat = paged_mla_attention(q_lat.contiguous(), q_rope[:, 0].contiguous(), cache["ckv"],
                                  cache["krope"], pages, pos.contiguous(), scale=scale)
    else:
        lat = dense_mla_decode(q_lat, q_rope[:, 0], ckv[:, 0], k_rope[:, 0], cache, pos,
                               active=active, scale=scale)
    out = torch.einsum("bhl,lhv->bhv", lat.to(x.dtype), w_uv)
    return matmul(out.reshape(B, S, h * dv), p["wo"]), cache


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def mlp_init(gen, d_model: int, d_ff: int, act: str, dtype, device) -> Params:
    p = {
        "w1": dense_init(gen, d_model, d_ff, dtype, device),
        "w2": dense_init(gen, d_ff, d_model, dtype, device),
    }
    if act == "swiglu":
        p["w3"] = dense_init(gen, d_model, d_ff, dtype, device)
    return p


def mlp(p: Params, x: torch.Tensor, act: str, scatter=None):
    """The MLP; ``scatter`` reduce-scatters its ``w2`` product into a
    sequence-parallel residual's layout (``matmul``)."""
    h = matmul(x, p["w1"])
    if act == "swiglu":
        h = F.silu(h) * matmul(x, p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return matmul(h, p["w2"], scatter=scatter)
