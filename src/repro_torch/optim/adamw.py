"""AdamW with cosine schedule, global-norm clipping, optional fp32 master
weights, and optional 8-bit (blockwise-quantized) first/second moments
(a port of ``repro/optim/adamw.py``).

Plain functions on tensor trees, leaves in ``repro_torch.tree`` order
(dict keys sorted, as JAX).  In the 8-bit mode m/v are stored int8 with
one fp32 scale per 256-element block along the last axis (Dettmers-style
dynamic blockwise quantization), dequantized, updated and requantized
inside the step.  Every function returns new tensors: the optimizer
state it reads is the trainer's immutable previous buffer.

On a device mesh the leaves are ``Sharded`` (``distributed/sharding.py``):
params by ``param_pspecs``, moments and the f32 master by
``zero_pspecs`` (ZeRO-1: the param's layout plus the data axes; FSDP
shards the params over the data axes too).  The update is elementwise,
so it runs block by block on the moments' layout: each gradient block is
the moment block's region of the gradient (the reduce-scatter), and the
new params are gathered back from the updated blocks into their own
layout (the all-gather).  A quantized moment's blocks run along the last
axis, which tensor parallelism may cut below one 256-element block: its
update runs over whole rows (the scale's layout, which ``zero_pspecs``
leaves unsharded on its last axis) and each member keeps its slice.
Every element is computed as the unsharded update computes it, so the
bits are the unsharded step's; ``global_norm`` sums each distinct block
once, in another order than one tensor's sum.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..distributed.sharding import P, Sharded, reshard, shard_leaf, spec_block
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
    """The L2 norm of every gradient element; a ``Sharded`` leaf's
    distinct blocks each once, summed on the mesh's first device."""
    total = 0
    for g in tree_leaves(grads):
        if isinstance(g, Sharded):
            for _, t in g.blocks():
                total = total + torch.sum(torch.square(t.to(torch.float32))).to(g.device)
        else:
            total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _region(x, blk, coord, device) -> torch.Tensor:
    """``x``'s region ``blk`` on ``device``: a ``Sharded`` leaf's (its
    member's own tensor where the blocks agree), or a plain tensor's
    slice (the int8 path's gradients are whole tensors)."""
    if isinstance(x, Sharded):
        return x.region(blk, coord=coord, device=device)
    return x[blk].to(device)


def _sharded_update(p, master, g, m, v, step_fn, cfg: OptConfig):
    """One leaf's update on a mesh.  ``step_fn(gf, mf, vf, base) ->
    (newf, mf, vf)`` is the elementwise AdamW step of ``apply_updates``.
    Returns (new param, new master or None, new m, new v), each laid
    out as its input."""
    q = cfg.quantized_state and isinstance(m, dict)
    lead = m["scale"] if q else m  # the layout the update runs on
    mesh = lead.mesh
    made, out_f = {}, np.empty(mesh.devices.shape, dtype=object)
    for c in lead.coords():
        dev = mesh.devices[c]
        blk = lead.block(c)
        if q:  # whole rows: the scale's rows, every column
            blk = blk[:-1] + (slice(0, p.shape[-1]),)
        key = (tuple((s.start, s.stop) for s in blk), str(dev))
        if key not in made:
            gf = _region(g, blk, c, dev)
            base = _region(master, blk, c, dev)
            if q:
                mf = _dequantize({"q": m["q"].region(blk, device=dev), "scale": m["scale"].local(c)},
                                 gf.shape)
                vf = _dequantize({"q": v["q"].region(blk, device=dev), "scale": v["scale"].local(c)},
                                 gf.shape)
            else:
                mf, vf = m.local(c), v.local(c)
            made[key] = step_fn(gf, mf, vf, base)
        out_f[c] = made[key]
    spec = lead.spec if not q else P(*(tuple(lead.spec)[:-1] + (None,)))
    # the f32 results on the update's layout, then each output in its own
    newf = Sharded(mesh, spec, p.shape, torch.float32, _pick(out_f, 0))
    new_p = reshard(newf.map(lambda t: t.to(p.dtype)), p.spec, mesh)
    new_master = reshard(newf, master.spec, mesh) if cfg.master_fp32 else None
    if q:
        new_m = _requantize(Sharded(mesh, spec, p.shape, torch.float32, _pick(out_f, 1)), m)
        new_v = _requantize(Sharded(mesh, spec, p.shape, torch.float32, _pick(out_f, 2)), v)
    else:
        new_m = Sharded(mesh, m.spec, m.shape, torch.float32, _pick(out_f, 1))
        new_v = Sharded(mesh, v.spec, v.shape, torch.float32, _pick(out_f, 2))
    return new_p, new_master, new_m, new_v


def _pick(grid: np.ndarray, i: int) -> np.ndarray:
    """The ``i``-th item of each member's result tuple (sharing kept)."""
    out = np.empty(grid.shape, dtype=object)
    for c in np.ndindex(*grid.shape):
        out[c] = grid[c][i]
    return out


def _requantize(rows: Sharded, like: dict) -> dict:
    """A moment updated over whole rows, quantized and laid out as
    ``like`` (``{"q", "scale"}``): the scale on its rows' layout, each
    member's ``q`` the slice of its rows' int8 tensor that its block
    names."""
    qs = rows.map(_quantize).shards  # a {"q", "scale"} dict a member, shared as rows is
    mesh, qspec = rows.mesh, like["q"].spec
    scales = np.empty(mesh.devices.shape, dtype=object)
    out, made = np.empty(mesh.devices.shape, dtype=object), {}
    for c in np.ndindex(*mesh.devices.shape):
        scales[c] = qs[c]["scale"]
        blk = spec_block(mesh, qspec, rows.shape, c)
        row_q = qs[c]["q"]
        key = (id(row_q), blk[-1].start, blk[-1].stop)
        if key not in made:
            whole = blk[-1].start == 0 and blk[-1].stop == rows.shape[-1]
            made[key] = row_q if whole else row_q[..., blk[-1]].contiguous()
        out[c] = made[key]
    scale = Sharded(mesh, like["scale"].spec, like["scale"].shape, torch.float32, scales)
    return {"q": Sharded(mesh, qspec, rows.shape, torch.int8, out), "scale": scale}


def apply_updates(params: Tree, grads: Tree, state: dict, cfg: OptConfig):
    """Returns (new_params, new_state, info)."""
    q = cfg.quantized_state
    st = state["step"]
    step = (st.full() if isinstance(st, Sharded) else st) + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, stepf)
    c2 = 1.0 - torch.pow(cfg.b2, stepf)

    def step_fn(g, mf, vf, base, wd):
        dev = g.device
        gf = g.to(torch.float32) * scale.to(dev)
        mf = cfg.b1 * mf + (1 - cfg.b1) * gf
        vf = cfg.b2 * vf + (1 - cfg.b2) * gf * gf
        mhat = mf / c1.to(dev)
        vhat = vf / c2.to(dev)
        base = base.to(torch.float32)
        newf = base - lr.to(dev) * (mhat / (torch.sqrt(vhat) + cfg.eps) + wd * base)
        return newf, mf, vf

    def upd(p, master, g, m, v):
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        if isinstance(p, Sharded):
            return _sharded_update(p, master, g, m, v,
                                   lambda *xs: step_fn(*xs, wd), cfg)
        newf, mf, vf = step_fn(g, _moment_read(m, p.shape, q), _moment_read(v, p.shape, q),
                               master, wd)
        return (newf.to(p.dtype), newf if cfg.master_fp32 else None,
                _moment_write(mf, q), _moment_write(vf, q))

    flat_p, tdef = tree_flatten(params)
    flat_master = tree_leaves(state["master"]) if cfg.master_fp32 else flat_p
    outs = [upd(*xs) for xs in zip(flat_p, flat_master, tree_leaves(grads),
                                    _up_to(state["m"], params), _up_to(state["v"], params))]
    new_state = {
        "m": tree_unflatten(tdef, [o[2] for o in outs]),
        "v": tree_unflatten(tdef, [o[3] for o in outs]),
        "step": shard_leaf(step, st.spec, st.mesh) if isinstance(st, Sharded) else step,
    }
    if cfg.master_fp32:
        new_state["master"] = tree_unflatten(tdef, [o[1] for o in outs])
    info = {"grad_norm": gn, "lr": lr}
    return tree_unflatten(tdef, [o[0] for o in outs]), new_state, info
