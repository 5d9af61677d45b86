"""Mixture-of-Experts: top-k token-choice routing with capacity-based
dispatch (a port of the single-shard path of ``repro/models/moe.py``).

``_moe_local`` scatters the routed tokens into (E, C, d) capacity
buffers, runs every expert's FFN over its buffer as a batched GEMM, and
gathers and combines the results; ``moe_block`` adds the shared experts.
The JAX package computes these products outside any Pallas kernel, and
so does this port (``torch.bmm``).  The expert-parallel ``_moe_spmd``
waits for the model-parallel half of the mesh work (ROADMAP item 7b).

Routing: softmax top-k (granite) or sigmoid with normalized top-k gates
(deepseek-v3), plus the standard load-balance auxiliary loss.  The
router is f32 whatever the compute dtype, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig, MoEConfig
from .layers import dense_init, mlp, mlp_init

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
def _moe_local(p: Params, x: torch.Tensor, cfg: ModelConfig):
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    logits = xf.float() @ p["router"]
    gates, idx, aux = _route(logits, moe)
    C = _capacity(T, moe)
    buf, slot, keep = _dispatch(xf, idx, moe.n_experts, C)
    h = _expert_ffn(p, buf.reshape(moe.n_experts, C, d), cfg.mlp_act)
    y = _combine(h.reshape(-1, d), slot, keep, gates, T, moe.top_k)
    return y.reshape(B, S, d), aux


def moe_block(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Returns (y, aux_loss).  Adds the shared-expert path if configured."""
    y, aux = _moe_local(p, x, cfg)
    if cfg.moe.n_shared_experts:
        y = y + mlp(p["shared"], x, cfg.mlp_act)
    return y, aux
