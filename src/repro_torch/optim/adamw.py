"""AdamW with cosine schedule, global-norm clipping, optional fp32 master
weights, and optional 8-bit (blockwise-quantized) first/second moments
(a port of ``repro/optim/adamw.py``).

Plain functions on tensor trees, leaves in ``repro_torch.tree`` order
(dict keys sorted, as JAX).  In the 8-bit mode m/v are stored int8 with
one fp32 scale per 256-element block along the last axis (Dettmers-style
dynamic blockwise quantization), dequantized, updated and requantized
inside the step.  Every function returns new tensors: the optimizer
state it reads is the trainer's immutable previous buffer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

Tree = Any

_QBLOCK = 256


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_fp32: bool = True  # keep an fp32 master copy of bf16 params
    quantized_state: bool = False  # 8-bit m/v (deepseek-v3-671b)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then cosine decay to ``min_lr``."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


# --------------------------------------------------------------------------
# blockwise int8 quantization of optimizer moments: blocks run along the
# LAST axis and the int8 tensor keeps the parameter's shape
# --------------------------------------------------------------------------
def _quantizable(p: torch.Tensor) -> bool:
    return p.dim() > 0 and p.shape[-1] % _QBLOCK == 0


def _quantize(x: torch.Tensor) -> dict:
    blocks = x.reshape(*x.shape[:-1], -1, _QBLOCK)
    scale = blocks.abs().amax(dim=-1) / 127.0  # (..., nb)
    q = torch.round(blocks / torch.clamp(scale[..., None], min=1e-20)).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale.to(torch.float32)}


def _dequantize(qs: dict, shape) -> torch.Tensor:
    blocks = qs["q"].to(torch.float32).reshape(*shape[:-1], -1, _QBLOCK)
    return (blocks * qs["scale"][..., None]).reshape(shape)


def _moment_init(p: torch.Tensor, quantized: bool):
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return _quantize(z) if quantized and _quantizable(p) else z


def _moment_read(m, shape, quantized: bool) -> torch.Tensor:
    return _dequantize(m, shape) if quantized and isinstance(m, dict) else m


def _moment_write(val: torch.Tensor, quantized: bool):
    return _quantize(val) if quantized and _quantizable(val) else val


def _up_to(tree: Tree, like: Tree) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``like`` (JAX's
    ``treedef.flatten_up_to``): a quantized moment is one {q, scale}
    dict where its parameter is one leaf."""
    if isinstance(like, dict):
        if set(like) != set(tree):
            raise ValueError("moment tree does not match the params tree")
        return [s for k in sorted(like) for s in _up_to(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [s for t, l in zip(tree, like) for s in _up_to(t, l)]
    return [] if like is None else [tree]


# --------------------------------------------------------------------------
# state / step
# --------------------------------------------------------------------------
def init_opt_state(params: Tree, cfg: OptConfig) -> dict:
    q = cfg.quantized_state
    leaves = tree_leaves(params)
    state = {
        "m": tree_map(lambda p: _moment_init(p, q), params),
        "v": tree_map(lambda p: _moment_init(p, q), params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }
    if cfg.master_fp32:
        state["master"] = tree_map(lambda p: p.to(torch.float32), params)
    return state


def global_norm(grads: Tree) -> torch.Tensor:
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def apply_updates(params: Tree, grads: Tree, state: dict, cfg: OptConfig):
    """Returns (new_params, new_state, info)."""
    q = cfg.quantized_state
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, stepf)
    c2 = 1.0 - torch.pow(cfg.b2, stepf)

    def upd(p, master, g, m, v):
        gf = g.to(torch.float32) * scale
        mf = _moment_read(m, p.shape, q)
        vf = _moment_read(v, p.shape, q)
        mf = cfg.b1 * mf + (1 - cfg.b1) * gf
        vf = cfg.b2 * vf + (1 - cfg.b2) * gf * gf
        mhat = mf / c1
        vhat = vf / c2
        base = master.to(torch.float32)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        newf = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + wd * base)
        return (newf.to(p.dtype), newf if cfg.master_fp32 else None,
                _moment_write(mf, q), _moment_write(vf, q))

    flat_p, tdef = tree_flatten(params)
    flat_master = tree_leaves(state["master"]) if cfg.master_fp32 else flat_p
    outs = [upd(*xs) for xs in zip(flat_p, flat_master, tree_leaves(grads),
                                    _up_to(state["m"], params), _up_to(state["v"], params))]
    new_state = {
        "m": tree_unflatten(tdef, [o[2] for o in outs]),
        "v": tree_unflatten(tdef, [o[3] for o in outs]),
        "step": step,
    }
    if cfg.master_fp32:
        new_state["master"] = tree_unflatten(tdef, [o[1] for o in outs])
    info = {"grad_norm": gn, "lr": lr}
    return tree_unflatten(tdef, [o[0] for o in outs]), new_state, info
