"""Mixture-of-Experts: top-k token-choice routing with capacity-based
dispatch and expert parallelism (a port of ``repro/models/moe.py``).

Two implementations of the same math:

  * ``_moe_local`` scatters the routed tokens into (E, C, d) capacity
    buffers, runs every expert's FFN over its buffer as a batched GEMM,
    and gathers and combines the results.  One device, and the oracle.
  * ``_moe_spmd``, the expert-parallel path over a mesh's members
    (JAX's ``shard_map`` bodies, run member by member by one controller
    with ``distributed/collectives.py``), in three layouts: tokens over
    (data x seq over model) and an all-to-all of the capacity buffers
    (``local_fn``); decode's replicated tokens, each model member's
    experts and a sum over the model axis (``local_fn_ar``); the serve
    layout, one expert slice a member with the tokens gathered over
    the data axes (``local_fn_ep2d``).

``moe_block`` takes the expert-parallel path when its ``ctx`` has a
mesh, and adds the shared experts.  The JAX package computes these
products outside any Pallas kernel, and so does this port
(``torch.bmm``).

Routing: softmax top-k (granite) or sigmoid with normalized top-k gates
(deepseek-v3), plus the standard load-balance auxiliary loss.  The
router is f32 whatever the compute dtype, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import math

import numpy as np

from ..distributed import collectives as coll
from ..distributed import wire
from ..distributed.sharding import Sharded
from .config import ModelConfig, MoEConfig
from .layers import add, dense_init, mlp, mlp_init, seq_scatter, value

Params = dict


def moe_init(gen, cfg: ModelConfig, device) -> Params:
    moe = cfg.moe
    d, dt = cfg.d_model, cfg.compute_dtype
    p = {
        "router": dense_init(gen, d, moe.n_experts, torch.float32, device, scale=0.02),
        "w1": _experts_init(gen, moe.n_experts, d, moe.d_ff_expert, dt, device),
        "w2": _experts_init(gen, moe.n_experts, moe.d_ff_expert, d, dt, device),
    }
    if cfg.mlp_act == "swiglu":
        p["w3"] = _experts_init(gen, moe.n_experts, d, moe.d_ff_expert, dt, device)
    if moe.n_shared_experts:
        p["shared"] = mlp_init(gen, d, moe.d_ff_expert * moe.n_shared_experts, cfg.mlp_act, dt,
                               device)
    return p


def _experts_init(gen, e: int, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    """(e, d_in, d_out) weights, N(0, 1/d_in), drawn one expert at a time
    in f32 and cast: deepseek's 256 x 7168 x 2048 in one f32 draw would be
    a 15 GB temporary."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
    for i in range(e):
        w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
        out[i] = w.mul_(d_in**-0.5)
    return out


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (a stable descending sort; ``torch.topk``
    does not promise that order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits: torch.Tensor, moe: MoEConfig):
    """logits (T, E) f32 -> (gates (T, k), idx (T, k) int64, aux loss)."""
    k = moe.top_k
    if moe.router_act == "sigmoid":
        scores = torch.sigmoid(logits)
        gates, idx = _top_k(scores, k)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = _top_k(probs, k)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    # load-balance aux (the local view)
    E = logits.shape[-1]
    me = probs.mean(dim=0)  # (E,)
    ce = F.one_hot(idx, E).to(torch.float32).sum(dim=1).mean(dim=0)
    aux = E * (me * ce).sum() * moe.aux_coef
    return gates, idx, aux


def _capacity(n_tokens: int, moe: MoEConfig) -> int:
    c = int(n_tokens * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


# --------------------------------------------------------------------------
# dispatch/combine via scatter into capacity buffers
# --------------------------------------------------------------------------
def _dispatch(xf: torch.Tensor, idx: torch.Tensor, E: int, C: int):
    """xf (T, d) -> (buffers (E*C, d), slot (T*k,), keep (T*k,)).

    The (token, choice) pairs take the places of each expert's buffer in
    flattened token-major order (a running count); a pair past the
    capacity C is dropped to slot ``E*C``.  Kept slots are unique, so the
    copy below writes each kept row once: the drop row, the only one
    written several times, is cut off.  (JAX adds into the buffer; an
    add with duplicate indices is not deterministic in float on the card,
    a copy to unique rows is.)"""
    T, d = xf.shape
    k = idx.shape[1]
    flat_e = idx.reshape(T * k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)  # (T*k, E)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1  # running count
    my_pos = pos.gather(1, flat_e[:, None])[:, 0]
    keep = my_pos < C
    slot = torch.where(keep, flat_e * C + my_pos, E * C)  # drop slot
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, slot, xf.repeat_interleave(k, dim=0))
    return buf[: E * C], slot, keep


def _combine(h_flat: torch.Tensor, slot, keep, gates, T: int, k: int) -> torch.Tensor:
    """h_flat (E*C, d) -> (T, d) weighted by gates."""
    d = h_flat.shape[-1]
    padded = torch.cat([h_flat, h_flat.new_zeros((1, d))])
    y = padded[torch.where(keep, slot, h_flat.shape[0])]  # (T*k, d)
    y = y * gates.reshape(T * k, 1).to(y.dtype)
    return y.reshape(T, k, d).sum(dim=1)


def _expert_ffn(p: Params, buf_e: torch.Tensor, act: str) -> torch.Tensor:
    """buf_e (E, C, d) -> (E, C, d) through each expert's FFN."""
    h = torch.bmm(buf_e, p["w1"])
    if act == "swiglu":
        h = F.silu(h) * torch.bmm(buf_e, p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return torch.bmm(h, p["w2"])


# --------------------------------------------------------------------------
# single-shard path
# --------------------------------------------------------------------------
def _router_logits(xf: torch.Tensor, router) -> torch.Tensor:
    """Router logits in f32: the activations upcast, the f32 router.
    (JAX's ``_moe_spmd`` rounds the router to the activations' dtype
    instead, to keep its wire transfers in bf16; in bf16 that routes some
    tokens differently from its own ``_moe_local``.  Here both paths use
    this one product, so the sharded routing is the unsharded routing,
    and in f32 the two packages' products agree.)"""
    return xf.float() @ value(router)


def _moe_local(p: Params, x: torch.Tensor, cfg: ModelConfig, *, with_idx: bool = False):
    """Returns (y, aux), and with ``with_idx`` the routing (B, S, k)."""
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    gates, idx, aux = _route(_router_logits(xf, p["router"]), moe)
    C = _capacity(T, moe)
    buf, slot, keep = _dispatch(xf, idx, moe.n_experts, C)
    h = _expert_ffn(p, buf.reshape(moe.n_experts, C, d), cfg.mlp_act)
    y = _combine(h.reshape(-1, d), slot, keep, gates, T, moe.top_k)
    out = (y.reshape(B, S, d), aux)
    return out + (idx.reshape(B, S, -1),) if with_idx else out


# --------------------------------------------------------------------------
# expert-parallel path
# --------------------------------------------------------------------------
def _moe_spmd(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx, *, with_idx: bool = False):
    """Expert parallelism over ``ctx.mesh``'s members, JAX's three
    ``shard_map`` layouts:

      local_fn       seq % |model| == 0 (prefill, training): member
                     (data d, model m) routes its tokens (batch block d,
                     sequence block m), an all-to-all over the model axis
                     sends each member its E/|model| experts' buffers
                     from every source, and another brings them back;
                     aux is the pmean over every member;
      local_fn_ar    decode (S = 1), ``serve_ep2d`` off: the data block's
                     tokens are routed once, member m runs its experts on
                     them and the combine is summed over the model axis;
                     aux is the pmean over the data axes;
      local_fn_ep2d  decode with ``serve_ep2d``: the tokens are gathered
                     over the data axes, the member of EP rank r =
                     axis_index(model) + sum axis_index(a) * stride (data
                     axes, the first major) runs its E/(|data| |model|)
                     experts on all of them, and the combine is summed
                     over every member in rank order.

    The expert weights a member needs are its own shard when the leaf is
    laid out for the path (``param_pspecs``), else gathered from the
    members that hold them.  Sums run in member order.  Returns (y,
    aux), and with ``with_idx`` the routing (B, S, k) in token order."""
    moe = cfg.moe
    mesh = ctx.mesh
    ma = ctx.model_axis
    dp = tuple(ctx.data_axes)
    nm = mesh.shape[ma]
    E, k = moe.n_experts, moe.top_k
    if E % nm:
        raise ValueError(f"{E} experts do not divide over the {nm} members of {ma!r}")
    E_l = E // nm
    dp_shape = [mesh.shape[a] for a in dp]
    dp_size = math.prod(dp_shape)
    n_ep = dp_size * nm
    E_l2 = E // n_ep if E % n_ep == 0 else 0
    B, S, d = x.shape
    if B % dp_size:
        raise ValueError(f"batch {B} does not divide over the data axes {dp} ({dp_size})")
    B_l = B // dp_size
    seq_shardable = S % nm == 0
    use_ep2d = not seq_shardable and ctx.serve_ep2d and E_l2 > 0

    def coord(rd: int, m: int) -> tuple:
        """The member of data rank ``rd`` (first data axis major) and
        model index ``m``; 0 on any other axis."""
        idx = dict(zip(dp, np.unravel_index(rd, dp_shape)))
        idx[ma] = m
        return tuple(int(idx.get(a, 0)) for a in mesh.axis_names)

    def experts(c, lo: int, hi: int) -> dict:
        out = {}
        for name in ("w1", "w2", "w3"):
            if name in p:
                w = p[name]
                out[name] = (w.region((slice(lo, hi), slice(None), slice(None)), coord=c)
                             if isinstance(w, Sharded) else w[lo:hi])
        return out

    def ffn(c, lo: int, hi: int, tok):
        pl = experts(c, lo, hi)
        dev = pl["w1"].device
        return _expert_ffn(pl, tok.to(dev), cfg.mlp_act).to(x.device)

    y = torch.empty_like(x)
    idx_all = torch.empty((B, S, k), dtype=torch.int64, device=x.device)
    if use_ep2d:
        with wire.over(tuple(dp)):
            xf = coll.all_gather([x[rd * B_l:(rd + 1) * B_l].reshape(B_l * S, d)
                                  for rd in range(dp_size)], tiled=True)[0]  # (T, d)
        T = xf.shape[0]
        gates, idx, aux = _route(_router_logits(xf, p["router"]), moe)
        C = _capacity(T, moe)
        buf, slot, keep = _dispatch(xf, idx, E, C)
        parts = []
        for r in range(n_ep):  # rank order: data ranks major, model minor
            lo = r * E_l2
            h_full = torch.zeros((E, C, d), dtype=buf.dtype, device=x.device)
            h_full[lo:lo + E_l2] = ffn(coord(r // nm, r % nm), lo, lo + E_l2,
                                       buf.reshape(E, C, d)[lo:lo + E_l2])
            parts.append(_combine(h_full.reshape(E * C, d), slot, keep, gates, T, k))
        with wire.over(tuple(dp) + (ma,)):
            y = coll.psum(parts)[0].reshape(B, S, d)
        idx_all = idx.reshape(B, S, k)
    elif seq_shardable:
        S_l = S // nm
        auxes = []
        for rd in range(dp_size):
            rows = slice(rd * B_l, (rd + 1) * B_l)
            sends, metas = [], []
            for m in range(nm):
                xf = x[rows, m * S_l:(m + 1) * S_l].reshape(B_l * S_l, d)
                gates, idx, aux = _route(_router_logits(xf, p["router"]), moe)
                auxes.append(aux)
                C = _capacity(B_l * S_l, moe)
                buf, slot, keep = _dispatch(xf, idx, E, C)
                # member m sends expert block j's buffers to member j
                sends.append(buf.reshape(nm, E_l * C, d))
                metas.append((slot, keep, gates))
                idx_all[rows, m * S_l:(m + 1) * S_l] = idx.reshape(B_l, S_l, k)
            with wire.over((ma,)):
                recv = coll.all_to_all(sends)
            backs = []
            for m in range(nm):
                # (nm src, E_l, C, d) -> (E_l, nm * C, d)
                tok = recv[m].reshape(nm, E_l, C, d).transpose(0, 1).reshape(E_l, nm * C, d)
                h = ffn(coord(rd, m), m * E_l, (m + 1) * E_l, tok)
                backs.append(h.reshape(E_l, nm, C, d).transpose(0, 1).reshape(nm, E_l * C, d))
            with wire.over((ma,)):
                ret = coll.all_to_all(backs)
            for m in range(nm):
                slot, keep, gates = metas[m]
                ym = _combine(ret[m].reshape(E * C, d), slot, keep, gates, B_l * S_l, k)
                y[rows, m * S_l:(m + 1) * S_l] = ym.reshape(B_l, S_l, d)
        with wire.over(tuple(dp)):
            aux = coll.pmean(auxes)[0]
    else:
        auxes = []
        for rd in range(dp_size):
            rows = slice(rd * B_l, (rd + 1) * B_l)
            xf = x[rows].reshape(B_l * S, d)
            gates, idx, aux = _route(_router_logits(xf, p["router"]), moe)
            auxes.append(aux)
            C = _capacity(B_l * S, moe)
            buf, slot, keep = _dispatch(xf, idx, E, C)
            parts = []
            for m in range(nm):
                lo = m * E_l
                h_full = torch.zeros((E, C, d), dtype=buf.dtype, device=x.device)
                h_full[lo:lo + E_l] = ffn(coord(rd, m), lo, lo + E_l,
                                          buf.reshape(E, C, d)[lo:lo + E_l])
                parts.append(_combine(h_full.reshape(E * C, d), slot, keep, gates, B_l * S, k))
            with wire.over((ma,)):
                y[rows] = coll.psum(parts)[0].reshape(B_l, S, d)
            idx_all[rows] = idx.reshape(B_l, S, k)
        with wire.over(tuple(dp)):
            aux = coll.pmean(auxes)[0]
    return (y, aux, idx_all) if with_idx else (y, aux)


def moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig, ctx=None, scatter=None):
    """Returns (y, aux_loss).  Expert-parallel when ``ctx`` has a mesh.
    Adds the shared-expert path if configured.  ``scatter=(mesh, spec)``
    lays ``y`` out as a sequence-parallel residual: the routed experts'
    whole output sliced (the local half of a reduce-scatter; JAX's
    ``local_fn`` returns it so split), the shared experts' ``w2``
    reduce-scattered (``layers.matmul``), summed member by member."""
    if ctx is not None and ctx.mesh is not None:
        y, aux = _moe_spmd(p, x, cfg, ctx)
    else:
        y, aux = _moe_local(p, x, cfg)
    if scatter is not None:
        y = seq_scatter(y, *scatter)
    if cfg.moe.n_shared_experts:
        y = add(y, mlp(p["shared"], x, cfg.mlp_act, scatter=scatter))
    return y, aux
