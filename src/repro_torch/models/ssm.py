"""Mamba2 (SSD) block (a port of ``repro/models/ssm.py``): in-proj ->
causal depthwise conv -> selective SSM -> gated norm -> out-proj, with a
chunked-scan prefill through ``kernels.ops.ssd`` (K8 on the card) and an
O(1)-state recurrent decode step in plain torch (JAX leaves it to XLA).

Projections and depthwise convs are stored per component (z, x, BC, dt),
as in the JAX package, so the parameter trees match leaf for leaf.
``a_log``, ``dt_bias`` and ``d_skip`` are f32; every other leaf is in the
compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .config import ModelConfig, SSMConfig
from .layers import dense_init, rmsnorm

Params = dict


def _dims(cfg: ModelConfig):
    s = cfg.ssm or SSMConfig()
    d_inner = s.expand * cfg.d_model
    return s, d_inner, d_inner // s.headdim


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s form, log1p(exp(-|x|)) + max(x, 0): exact for
    every x, with no switch to the identity above a threshold as
    ``torch.nn.functional.softplus`` has."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0)


def mamba_init(gen, cfg: ModelConfig, device) -> Params:
    """Random weights from ``gen`` in the JAX package's layout (every
    leaf its own draw)."""
    s, d_inner, H = _dims(cfg)
    d, dt = cfg.d_model, cfg.compute_dtype
    gn = 2 * s.ngroups * s.state
    u = torch.rand((H,), generator=gen, dtype=torch.float32, device=device)
    dt_init = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus

    def conv(width):
        w = torch.randn((s.conv_kernel, width), generator=gen, dtype=torch.float32, device=device)
        return (w * 0.1).to(dt)

    return {
        "w_z": dense_init(gen, d, d_inner, dt, device),
        "w_x": dense_init(gen, d, d_inner, dt, device),
        "w_bc": dense_init(gen, d, gn, dt, device),
        "w_dt": dense_init(gen, d, H, dt, device),
        "conv_x": conv(d_inner),
        "conv_x_b": torch.zeros((d_inner,), dtype=dt, device=device),
        "conv_bc": conv(gn),
        "conv_bc_b": torch.zeros((gn,), dtype=dt, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=device)),
        "dt_bias": dt_bias,
        "d_skip": torch.ones((H,), dtype=torch.float32, device=device),
        "norm": torch.ones((d_inner,), dtype=dt, device=device),
        "out_proj": dense_init(gen, d_inner, d, dt, device),
    }


def mamba_cache_init(cfg: ModelConfig, batch: int, device) -> dict:
    s, d_inner, H = _dims(cfg)
    gn = 2 * s.ngroups * s.state
    dt = cfg.compute_dtype
    return {
        "conv_x": torch.zeros((batch, s.conv_kernel - 1, d_inner), dtype=dt, device=device),
        "conv_bc": torch.zeros((batch, s.conv_kernel - 1, gn), dtype=dt, device=device),
        "ssm": torch.zeros((batch, H, s.state, s.headdim), dtype=torch.float32, device=device),
    }


def _causal_dwconv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor, kernel: int) -> torch.Tensor:
    """seq (B, S, C), w (k, C): per-channel causal conv in f32, silu'd."""
    B, S, C = seq.shape
    ext = torch.cat([torch.zeros((B, kernel - 1, C), dtype=seq.dtype, device=seq.device), seq], dim=1)
    acc = torch.zeros((B, S, C), dtype=torch.float32, device=seq.device)
    for i in range(kernel):
        acc = acc + ext[:, i : i + S].float() * w[i].float()
    return F.silu(acc + b.float()).to(seq.dtype)


def _dwconv_step(hist: torch.Tensor, new: torch.Tensor, w, b):
    """hist (B, k-1, C) + new (B, 1, C) -> (out (B, 1, C), new hist)."""
    full = torch.cat([hist, new], dim=1)  # (B, k, C)
    out = torch.einsum("bkc,kc->bc", full.float(), w.float())
    out = F.silu(out + b.float()).to(new.dtype)[:, None]
    return out, full[:, 1:]


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[dict] = None, fill_cache: bool = False):
    """x (B, S, d) -> (y, new_cache).  new_cache is None unless decoding
    (``cache`` given, S == 1) or prefilling with ``fill_cache``.  The
    recurrence writes nothing into ``cache``: every new state is a new
    tensor."""
    s, d_inner, H = _dims(cfg)
    B, S, _ = x.shape
    k = s.conv_kernel
    z = x @ p["w_z"]
    xc = x @ p["w_x"]
    bcc = x @ p["w_bc"]
    dtr = x @ p["w_dt"]

    if cache is None:
        xs = _causal_dwconv(xc, p["conv_x"], p["conv_x_b"], k)
        bcs = _causal_dwconv(bcc, p["conv_bc"], p["conv_bc_b"], k)
        # a prompt shorter than k - 1 keeps fewer rows than the cache leaf;
        # install_prefill pads them at the end, as the JAX package does
        new_conv_x = xc[:, -(k - 1):] if fill_cache else None
        new_conv_bc = bcc[:, -(k - 1):] if fill_cache else None
    else:
        if S != 1:
            raise ValueError(f"a decode step takes one token, not {S}")
        xs, new_conv_x = _dwconv_step(cache["conv_x"], xc, p["conv_x"], p["conv_x_b"])
        bcs, new_conv_bc = _dwconv_step(cache["conv_bc"], bcc, p["conv_bc"], p["conv_bc_b"])

    xh = xs.reshape(B, S, H, s.headdim)
    bh, ch = torch.chunk(bcs, 2, dim=-1)
    bh = bh.reshape(B, S, s.ngroups, s.state)
    ch = ch.reshape(B, S, s.ngroups, s.state)
    dt = softplus(dtr.float() + p["dt_bias"])  # (B, S, H)
    a = -torch.exp(p["a_log"])  # (H,)

    if cache is None:
        y, h_final = kops.ssd(xh, dt, a, bh.contiguous(), ch.contiguous(), chunk=s.chunk)
        new_ssm = h_final if fill_cache else None
    else:
        h0 = cache["ssm"]  # (B, H, N, P)
        rep = H // s.ngroups
        bhh = bh[:, 0].repeat_interleave(rep, dim=1)  # (B, H, N)
        chh = ch[:, 0].repeat_interleave(rep, dim=1)
        da = torch.exp(dt[:, 0] * a[None, :])  # (B, H)
        upd = dt[:, 0][..., None, None] * bhh[..., :, None] * xh[:, 0][..., None, :].float()
        h1 = h0 * da[..., None, None] + upd
        y = torch.einsum("bhn,bhnp->bhp", chh.float(), h1)[:, None].to(x.dtype)
        new_ssm = h1

    y = y + xh * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(y * F.silu(z.float()).to(x.dtype), p["norm"], cfg.rms_eps)
    out = y @ p["out_proj"]
    if cache is None and not fill_cache:
        return out, None
    return out, {"conv_x": new_conv_x, "conv_bc": new_conv_bc, "ssm": new_ssm}
