"""Mamba2 (SSD) block (a port of ``repro/models/ssm.py``): in-proj ->
causal depthwise conv -> selective SSM -> gated norm -> out-proj, with a
chunked-scan prefill through ``kernels.ops.ssd`` (K8 on the card) and an
O(1)-state recurrent decode step in plain torch (JAX leaves it to XLA).

Projections and depthwise convs are stored per component (z, x, BC, dt),
as in the JAX package, so the parameter trees match leaf for leaf.
``a_log``, ``dt_bias`` and ``d_skip`` are f32; every other leaf is in the
compute dtype.

Under a ``ShardCtx`` with a mesh (``mamba_block(..., ctx=)``) the layout
is the JAX package's rules: ``w_z``/``w_x`` column-parallel over the
model axis, ``conv_x``/``conv_x_b`` channels and the SSM state's heads
over it, ``out_proj`` row-parallel, ``w_bc``/``w_dt``/``conv_bc`` and the
f32 leaves replicated; the decode cache's rows over the data axes
(``cache_pspecs``).  Activations stay on the controller's device, as
everywhere in the port: the projections are ``layers.matmul``'s, and the
convs and the recurrence run once for each distinct block of their
state's layout, the member's rows and channels or heads: in prefill one
K8 launch a member (a member's heads hold whole B/C groups), in decode
the step recurrence on the member's state block, written out as its new
block.  The gated norm reads the whole ``d_inner`` width, so it runs on
the members' outputs put together, as JAX's partitioner gathers them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

import numpy as np

from ..core.cell import count_add, count_snapshot, counts_active, quiet_counts
from ..distributed.sharding import LOCAL, ShardCtx, Sharded, cache_pspecs, spec_block
from ..kernels import ops as kops
from . import layers as L
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


def _conv(seq: torch.Tensor, w, b, k: int, hist: Optional[torch.Tensor]):
    """The depthwise conv of ``seq`` (B, S, C): causal over a prompt
    (``hist`` None) -> (out, None), or one decode step after ``hist``
    (B, k-1, C) -> (out, new hist)."""
    if hist is None:
        return _causal_dwconv(seq, w, b, k), None
    return _dwconv_step(hist, seq, w, b)


def _ssm(xh, dt, a, bh, ch, d_skip, group, h0, chunk: int):
    """The selective SSM of some heads: xh (B, S, h, P), dt (B, S, h) f32,
    a and d_skip (h,), bh/ch (B, S, g, N) the B/C groups those heads
    read, ``group`` (h,) each head's group among them.  A prompt (``h0``
    None) in one K8 launch -> (y, final state, None); a decode step from
    ``h0`` (B, h, N, P) -> (y, None, new state).  y (B, S, h, P), in xh's
    dtype, includes the d_skip term.  With grad the prompt's scan goes
    through ``SSDScan``, whose backward is K8's backward kernel on the
    card; it takes the contiguous copies made here."""
    if h0 is None:
        y, h_final = kops.ssd(xh.contiguous(), dt.contiguous(), a.contiguous(),
                              bh.contiguous(), ch.contiguous(), chunk=chunk)
        h1 = None
    else:
        bhh, chh = bh[:, 0][:, group], ch[:, 0][:, group]  # (B, h, N)
        da = torch.exp(dt[:, 0] * a[None, :])  # (B, h)
        upd = dt[:, 0][..., None, None] * bhh[..., :, None] * xh[:, 0][..., None, :].float()
        h1 = h0 * da[..., None, None] + upd
        y = torch.einsum("bhn,bhnp->bhp", chh.float(), h1)[:, None].to(xh.dtype)
        h_final = None
    return y + xh * d_skip[None, None, :, None].to(xh.dtype), h_final, h1


def _gated_out(y: torch.Tensor, z: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """The gated norm over the whole ``d_inner`` width, then out_proj."""
    y = rmsnorm(y * F.silu(z.float()).to(z.dtype), p["norm"], cfg.rms_eps)
    return L.matmul(y, p["out_proj"])


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[dict] = None, fill_cache: bool = False,
                ctx: ShardCtx = LOCAL):
    """x (B, S, d) -> (y, new_cache).  new_cache is None unless decoding
    (``cache`` given, S == 1) or prefilling with ``fill_cache``.  The
    recurrence writes nothing into ``cache``: every new state is a new
    tensor.  Under a ``ctx`` with a mesh it runs member by member
    (``_mamba_sharded``, on the same convs and recurrence): a decode
    cache is then ``Sharded`` and comes back so, a prefill's filled cache
    whole, as an unsharded one."""
    s, d_inner, H = _dims(cfg)
    B, S, _ = x.shape
    if cache is not None and S != 1:
        raise ValueError(f"a decode step takes one token, not {S}")
    if ctx.mesh is not None:
        return _mamba_sharded(p, x, cfg, cache, fill_cache, ctx)
    k = s.conv_kernel
    z = x @ p["w_z"]
    xc = x @ p["w_x"]
    bcc = x @ p["w_bc"]
    dtr = x @ p["w_dt"]
    hist = (None, None) if cache is None else (cache["conv_x"], cache["conv_bc"])
    xs, new_conv_x = _conv(xc, p["conv_x"], p["conv_x_b"], k, hist[0])
    bcs, new_conv_bc = _conv(bcc, p["conv_bc"], p["conv_bc_b"], k, hist[1])
    if cache is None and fill_cache:
        # a prompt shorter than k - 1 keeps fewer rows than the cache leaf;
        # install_prefill pads them at the end, as the JAX package does
        new_conv_x, new_conv_bc = xc[:, -(k - 1):], bcc[:, -(k - 1):]

    xh = xs.reshape(B, S, H, s.headdim)
    bh, ch = torch.chunk(bcs, 2, dim=-1)
    bh = bh.reshape(B, S, s.ngroups, s.state)
    ch = ch.reshape(B, S, s.ngroups, s.state)
    dt = softplus(dtr.float() + p["dt_bias"])  # (B, S, H)
    a = -torch.exp(p["a_log"])  # (H,)
    group = torch.arange(H, device=x.device) // (H // s.ngroups)
    y, h_final, h1 = _ssm(xh, dt, a, bh, ch, p["d_skip"], group,
                          None if cache is None else cache["ssm"], s.chunk)
    out = _gated_out(y.reshape(B, S, d_inner), z, p, cfg)
    if cache is None and not fill_cache:
        return out, None
    return out, {"conv_x": new_conv_x, "conv_bc": new_conv_bc,
                 "ssm": h1 if cache is not None else h_final}


# --------------------------------------------------------------------------
# under a mesh
# --------------------------------------------------------------------------
def _layout(ctx: ShardCtx, cache, name: str, shape) -> tuple:
    """(mesh, spec, shape) of the recurrence's ``name`` state: the cache
    leaf's when it is ``Sharded``, else the decode cache's rule
    (``cache_pspecs``) for a leaf of ``shape``, which lays out a
    prefill's convs and recurrence too."""
    leaf = cache[name] if cache is not None else None
    if isinstance(leaf, Sharded):
        return leaf.mesh, leaf.spec, tuple(leaf.shape)
    spec = cache_pspecs(ctx, {name: torch.empty(shape, device="meta")})[name]
    return ctx.mesh, spec, tuple(shape)


def _calls(layout) -> list:
    """``(coord, block)`` of each distinct block of ``layout`` on each
    device, on its first member there, in member order: the calls that
    ``_per_block`` makes."""
    mesh, spec, shape = layout
    seen, out = set(), []
    for c in np.ndindex(*mesh.devices.shape):
        blk = spec_block(mesh, spec, shape, c)
        key = (tuple((b.start, b.stop) for b in blk), str(mesh.devices[c]))
        if key not in seen:
            seen.add(key)
            out.append((c, blk))
    return out


def _per_block(layout, fn) -> tuple[list, Optional[Sharded]]:
    """``fn(i, coord, block) -> (out, new_state)`` for each of
    ``_calls(layout)`` (``i`` its place there).  Returns ([(block, out)],
    a block once; the new states as a ``Sharded`` leaf of ``layout``, or
    None when ``fn`` gives none)."""
    mesh, spec, shape = layout
    done, seen, parts = {}, set(), []
    for i, (c, blk) in enumerate(_calls(layout)):
        bkey = tuple((b.start, b.stop) for b in blk)
        out, done[(bkey, str(mesh.devices[c]))] = fn(i, c, blk)
        if bkey not in seen:
            seen.add(bkey)
            parts.append((blk, out))
    grid = np.empty(mesh.devices.shape, dtype=object)
    for c in np.ndindex(*mesh.devices.shape):
        blk = spec_block(mesh, spec, shape, c)
        grid[c] = done[(tuple((b.start, b.stop) for b in blk), str(mesh.devices[c]))]
    first = grid.flat[0]
    if first is None:
        return parts, None
    return parts, Sharded(mesh, spec, shape, first.dtype, grid)


class _Fanout(torch.autograd.Function):
    """The members' reads of one tensor: ``t[index]`` on each read's
    device (a view of ``t`` on its own device).  The backward sums the reads' cotangents into
    ``t``'s gradient in the order of the reads (member order), in f32
    for a lower-precision tensor read more than once, so a sum over
    members (the B/C group that the model members share, a head's
    ``a_log`` and ``d_skip`` over the data members, a conv weight's
    block over the members that share it) has one order whatever the
    placement and whatever order autograd's device threads finish in:
    DMR replicas compare its bits."""

    @staticmethod
    def forward(ctx, t, reads):
        ctx.reads, ctx.shape, ctx.dtype, ctx.device = reads, t.shape, t.dtype, t.device
        return tuple(t[index].to(dev) for index, dev in reads)

    @staticmethod
    def backward(ctx, *gs):
        keys = [tuple((s.start, s.stop) for s in index) for index, _ in ctx.reads]
        wide = ctx.dtype.itemsize < 4 and len(set(keys)) < len(keys)
        total = torch.zeros(ctx.shape, dtype=torch.float32 if wide else ctx.dtype,
                            device=ctx.device)
        for (index, _), g in zip(ctx.reads, gs):
            if g is not None:
                total[index] += g.to(total.device, total.dtype)
        return total.to(ctx.dtype), None


def _fanout(reads: list) -> list:
    """``t[index]`` on ``device`` for each ``(t, index, device)`` of
    ``reads`` (``index`` a tuple of slices), the reads of one tensor
    through one ``_Fanout``."""
    groups: dict = {}
    for i, (t, index, dev) in enumerate(reads):
        groups.setdefault(id(t), (t, []))[1].append((i, (index, dev)))
    out = [None] * len(reads)
    for t, items in groups.values():
        for (i, _), o in zip(items, _Fanout.apply(t, [r for _, r in items])):
            out[i] = o
    return out


def _assemble(parts, shape, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor of ``shape`` on ``like``'s device and of its
    dtype from the members' ``(index, piece)``s, which tile it."""
    full = torch.empty(shape, dtype=like.dtype, device=like.device)
    for idx, piece in parts:
        full[idx] = piece.to(like.device)
    return full


def _cols(w, cols: slice, device) -> torch.Tensor:
    """Channels ``cols`` (the last axis) of a (k, C) or (C,) weight on
    ``device``: a member's own block where it is exactly those."""
    index = (slice(None),) * (w.dim() - 1) + (cols,)
    if isinstance(w, Sharded):
        return w.region(index, device=device)
    return w[index].to(device)


def _groups(heads: slice, rep: int) -> slice:
    """The B/C groups that the heads ``heads`` read (``rep`` heads a
    group): a member holds whole groups, or heads of one group."""
    g0, g1 = heads.start // rep, (heads.stop - 1) // rep + 1
    if g1 - g0 > 1 and (heads.start % rep or heads.stop % rep):
        raise ValueError(f"heads {heads.start}:{heads.stop} cut a group of {rep} heads")
    return slice(g0, g1)


#: in a counting abstract evaluation (the dry-run's), a prompt's convs
#: and scan run once for each block shape and stand for every member of
#: that shape (``_repeated_members``); the equality tests switch it off
#: to count every member
REPEAT_ON_FAKES = True


class _CountIn(torch.autograd.Function):
    """The representative member's inputs, unchanged; its backward ends the
    member's counted backward: what was counted since ``_CountOut``'s
    backward is counted ``times - 1`` more times."""

    @staticmethod
    def forward(ctx, box, times, *ts):
        ctx.box, ctx.times = box, times
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        count_add(ctx.box.pop("snap"), ctx.times - 1)
        return (None, None, *gs)


class _CountOut(torch.autograd.Function):
    """The representative member's output, unchanged; its backward starts
    the member's counted backward."""

    @staticmethod
    def forward(ctx, box, t):
        ctx.box = box
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.box["snap"] = count_snapshot()
        return None, g


class _Stand(torch.autograd.Function):
    """A member that the representative of its block shape stands for:
    its outputs are uncounted placeholders made before the representative
    ran, its backward gives uncounted placeholders of its inputs'
    gradients, and until then it keeps what the member's own graph would
    keep for its backward (``kept``)."""

    @staticmethod
    def forward(ctx, n_outs, n_kept, *ts):
        outs, kept, ins = ts[:n_outs], ts[n_outs:n_outs + n_kept], ts[n_outs + n_kept:]
        ctx.save_for_backward(*kept)
        ctx.n_outs, ctx.n_kept = n_outs, n_kept
        ctx.ins = [(t.shape, t.dtype, t.device) for t in ins]
        ctx.set_materialize_grads(False)  # an unused output's gradient stays None
        return tuple(t.view_as(t) for t in outs)

    @staticmethod
    def backward(ctx, *gs):
        with quiet_counts():
            grads = [torch.empty(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.ins]
        return (None, None, *([None] * (ctx.n_outs + ctx.n_kept)), *grads)


def _repeated_members(n_calls: int, ins: list, run, stand) -> list:
    """``run(i, mine)`` (a tuple of outputs, the first the one a gradient
    reaches) for every one of ``n_calls`` calls in a counting abstract
    evaluation, call i's inputs ``ins[w * i:w * (i + 1)]`` (``w`` =
    ``len(ins) // n_calls``): the calls whose inputs have one shape share
    one evaluated ``run``, of the first of them, whose forward and
    backward count as all of theirs (``core.cell.count_add``).  The
    others' outputs are placeholders made first (so the representative
    runs with them live, as the last member would), ``stand(theirs) ->
    (placeholder outputs, what their graph keeps for the backward)``, and
    joined to their inputs after it (so their backward runs before its,
    and it runs with their gradients live, as the first member's
    would)."""
    w = len(ins) // n_calls
    classes: dict = {}
    outs = [None] * n_calls
    held = {}
    with quiet_counts():  # a fake's device is an operator too
        for i in range(n_calls):
            key = tuple((tuple(t.shape), t.dtype, str(t.device)) for t in ins[w * i:w * i + w])
            classes.setdefault(key, []).append(i)
        for idx in classes.values():
            for i in idx[1:]:
                held[i] = stand(ins[w * i:w * i + w])
    for idx in classes.values():
        i, n = idx[0], len(idx)
        box: dict = {}
        with quiet_counts():  # a Function's apply reads its inputs' devices
            mine = _CountIn.apply(box, n, *ins[w * i:w * i + w])
        snap = count_snapshot()
        first, *rest = run(i, mine)
        count_add(snap, n - 1)
        with quiet_counts():
            outs[i] = (_CountOut.apply(box, first), *rest)
    with quiet_counts():
        for i, (placeholders, kept) in held.items():
            outs[i] = _Stand.apply(len(placeholders), len(kept), *placeholders, *kept,
                                   *ins[w * i:w * i + w])
    return outs


def _scan_stand(ins) -> tuple:
    """A member's prompt scan as ``_repeated_members`` stands it in: the
    outputs y (b, S, h P) and the final state (b, h, N, P) f32; kept, the
    scan's five inputs as ``_ssm`` hands them to ``SSDScan`` (contiguous:
    a copy of a strided read) and d_skip cast to x's dtype (the skip
    term's product)."""
    xh, _, _, bh, _, d = ins
    b, S, h, P = xh.shape
    outs = (torch.empty((b, S, h * P), dtype=xh.dtype, device=xh.device),
            torch.empty((b, h, bh.shape[-1], P), dtype=torch.float32, device=xh.device))
    kept = [t if t.is_contiguous() else torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in ins[:5]]
    return outs, (*kept, d.to(xh.dtype))


def _conv_stand(k: int):
    """A member's prompt conv (``_causal_dwconv``) as ``_repeated_members``
    stands it in: the output, of the input's shape and dtype; kept, each
    tap's product operands (the f32 copies of its rows of the padded input
    and of its weight row, or, in f32, the padded input once and the
    weight itself) and the silu's input."""

    def stand(ins) -> tuple:
        seq, w, _ = ins
        B, S, C = seq.shape
        f32 = dict(dtype=torch.float32, device=seq.device)
        if seq.dtype == torch.float32:
            kept = [torch.empty((B, S + k - 1, C), **f32)]
        else:
            kept = [torch.empty((B, S, C), **f32) for _ in range(k)]
        kept += [w] if w.dtype == torch.float32 else [torch.empty((C,), **f32)
                                                        for _ in range(k)]
        return (torch.empty_like(seq),), (*kept, torch.empty((B, S, C), **f32))

    return stand


def _mamba_sharded(p: Params, x: torch.Tensor, cfg: ModelConfig, cache, fill_cache: bool,
                   ctx: ShardCtx):
    s, d_inner, H = _dims(cfg)
    B, S, _ = x.shape
    k, Pd, G = s.conv_kernel, s.headdim, s.ngroups
    gn = 2 * G * s.state
    z = L.matmul(x, p["w_z"])
    xc = L.matmul(x, p["w_x"])
    bcc = L.matmul(x, p["w_bc"])
    dtr = L.matmul(x, p["w_dt"])
    wbc, bbc = L.value(p["conv_bc"]), L.value(p["conv_bc_b"])
    a = -torch.exp(L.value(p["a_log"]))
    dt_bias, d_skip = L.value(p["dt_bias"]), L.value(p["d_skip"])
    every = slice(None)

    def local(name, c):
        return None if cache is None else cache[name].local(c)

    def dev(c):
        return ctx.mesh.devices[c]

    # the depthwise convs: a member's rows (and channels) at a time
    lay_x = _layout(ctx, cache, "conv_x", (B, k - 1, d_inner))
    calls = _calls(lay_x)
    ins = _fanout([r for c, blk in calls for r in (
        (xc, (blk[0], every, blk[2]), dev(c)),
        (_cols(p["conv_x"], blk[2], dev(c)), (every, every), dev(c)),
        (_cols(p["conv_x_b"], blk[2], dev(c)), (every,), dev(c)))])

    def conv_x(i, c, blk):
        return _conv(*ins[3 * i:3 * i + 3], k, local("conv_x", c))

    repeat = cache is None and REPEAT_ON_FAKES and counts_active()
    if repeat:
        outs_x = _repeated_members(len(calls), ins, lambda i, mine: _conv(*mine, k, None)[:1],
                                   _conv_stand(k))
        conv_x = lambda i, c, blk: (outs_x[i][0], None)  # noqa: E731

    lay_bc = _layout(ctx, cache, "conv_bc", (B, k - 1, gn))
    calls = _calls(lay_bc)
    ins_bc = _fanout([r for c, blk in calls for r in (
        (bcc, (blk[0], every, every), dev(c)), (wbc, (every, every), dev(c)),
        (bbc, (every,), dev(c)))])

    def conv_bc(i, c, blk):
        return _conv(*ins_bc[3 * i:3 * i + 3], k, local("conv_bc", c))

    if repeat:
        outs_bc = _repeated_members(len(calls), ins_bc,
                                    lambda i, mine: _conv(*mine, k, None)[:1], _conv_stand(k))
        conv_bc = lambda i, c, blk: (outs_bc[i][0], None)  # noqa: E731

    xparts, new_cx = _per_block(lay_x, conv_x)
    bparts, new_cb = _per_block(lay_bc, conv_bc)
    xs = _assemble([((b[0], every, b[2]), o) for b, o in xparts], (B, S, d_inner), xc)
    bcs = _assemble([((b[0], every, every), o) for b, o in bparts], (B, S, gn), bcc)
    xh = xs.reshape(B, S, H, Pd)
    bh, ch = torch.chunk(bcs, 2, dim=-1)
    bh = bh.reshape(B, S, G, s.state)
    ch = ch.reshape(B, S, G, s.state)
    dt = softplus(dtr.float() + dt_bias)  # (B, S, H)
    rep = H // G

    # the recurrence: a member's rows and heads at a time, its inputs read
    # through one fan-out a tensor (the sums over members in member order)
    lay_ssm = _layout(ctx, cache, "ssm", (B, H, s.state, Pd))
    calls = _calls(lay_ssm)
    ins_r = _fanout([r for c, (rows, heads, *_) in calls for r in (
        (xh, (rows, every, heads), dev(c)), (dt, (rows, every, heads), dev(c)),
        (a, (heads,), dev(c)), (bh, (rows, every, _groups(heads, rep)), dev(c)),
        (ch, (rows, every, _groups(heads, rep)), dev(c)), (d_skip, (heads,), dev(c)))])

    def recur(i, mine):
        c, (_, heads, *_) = calls[i]
        group = (torch.arange(heads.start, heads.stop, device=dev(c)) // rep
                 - _groups(heads, rep).start)
        y, h_final, h1 = _ssm(*mine, group, local("ssm", c), s.chunk)
        return (y.reshape(y.shape[0], S, -1), h_final), h1

    if repeat:
        outs = _repeated_members(len(calls), ins_r, lambda i, mine: recur(i, mine)[0],
                                 _scan_stand)
        rparts, new_ssm = _per_block(lay_ssm, lambda i, c, blk: (outs[i], None))
    else:
        rparts, new_ssm = _per_block(lay_ssm, lambda i, c, blk: recur(i, ins_r[6 * i:6 * i + 6]))
    # a member's heads are d_inner's channels heads.start * Pd onwards
    y = _assemble([((b[0], every, slice(b[1].start * Pd, b[1].stop * Pd)), o[0])
                   for b, o in rparts], (B, S, d_inner), x)
    out = _gated_out(y, z, p, cfg)
    if cache is not None:
        return out, {"conv_x": new_cx, "conv_bc": new_cb, "ssm": new_ssm}
    if not fill_cache:
        return out, None
    h_final = _assemble([(b, o[1]) for b, o in rparts], (B, H, s.state, Pd),
                        torch.empty((), dtype=torch.float32, device=x.device))
    return out, {"conv_x": xc[:, -(k - 1):], "conv_bc": bcc[:, -(k - 1):], "ssm": h_final}
