"""Cross-pod collectives (a port of ``repro/distributed/collectives.py``).

In the JAX package these are ``shard_map`` bodies over one mesh axis.
Here one controller holds every member's value, so each function takes
the per-member values of one mesh axis (``xs[p]`` lives on member p's
device) and returns the per-member results, each on its member's device.
On one card the "wire" is a copy between two allocations.

Spatial replica primitives (``core/backend_spatial.py``): state moves as
the ``kernels.ops`` u32 word stream, so every dtype (bool, bf16, f32,
i64) travels bit-exactly in one array:

  * ``psum_delta``      -- the DMR fingerprint compare: ``psum(h) - 2h``
    is nonzero exactly where the two members' words differ (u32
    wraparound: a + b == 2a <=> a == b); 16 bytes a member.
  * ``bcast_pytree``    -- a tree from member ``src`` to every member;
    ``src`` may be a 0-d tensor on the device (TMR majority adoption),
    and then the transport is a masked sum of the word streams, with no
    host synchronisation.
  * ``exchange_pytree`` -- the two members of a DMR pair swap their
    trees (the O(state) bitwise compare).
  * ``gather_replicas`` -- every member receives all R trees, stacked on
    a leading replica axis (the TMR bitwise vote; temporal readers of a
    spatial cell).

Model-axis collectives (``distributed/decode.py``, ``models/moe.py``'s
expert-parallel paths): ``psum``, ``pmax``, ``pmean``, ``all_gather``
(stacked, or ``tiled``), ``all_to_all`` (split 0 / concat 0, untiled);
a member's ``axis_index`` is ``Mesh.axis_index``.  They reduce in member
order, so two runs of one layout compute the same bits.

Gradient collectives: ``compressed_psum_int8`` (the two-hop int8 mean
with error feedback) and ``psum_mean``.  Their trainer user
(``grad_compression="int8_ef"``) comes with the training half of the
model-parallel port (ROADMAP item 7b-ii).

Every function records its movement in an active ``wire`` meter (the
dry-run's collective term; ``wire.py``).

Words are held as the port holds them everywhere: fingerprints as u32
values in ``int64`` masked with ``M32``, streams as ``int32`` bits.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ..kernels import ops
from ..kernels.state_hash import M32
from ..tree import tree_leaves, tree_map
from . import wire

Tree = Any


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if x.device == dev else x.to(dev)


def _device(tree: Tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _per_device(values: Sequence[Tree], make) -> list:
    """``make(dev)`` once per distinct device of ``values``' members, the
    result handed to every member on that device (an immutable value
    received by several members of one card needs one copy there)."""
    made: dict = {}
    out = []
    for v in values:
        dev = _device(v)
        if dev not in made:
            made[dev] = make(dev)
        out.append(made[dev])
    return out


# --------------------------------------------------------------------------
# spatial replica primitives
# --------------------------------------------------------------------------
def psum_delta(hs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Over a 2-member axis, ``psum(h) - 2h`` per member: nonzero exactly
    at the words where the two members' values differ.  ``hs[p]`` holds
    u32 words in ``int64`` (``redundancy.fingerprint``); the result too."""
    if wire.active():
        wire.record("all-reduce", wire.nbytes(hs[0]), len(hs), members=len(hs),
                    site="collectives")
    home = hs[0].device
    total = hs[0]
    for h in hs[1:]:
        total = total + _to(h, home)
    return [(_to(total, h.device) - 2 * h) & M32 for h in hs]


def all_gather(xs: Sequence[torch.Tensor], *, tiled: bool = False) -> list[torch.Tensor]:
    """Every member receives all members' tensors stacked on a new leading
    axis (``jax.lax.all_gather``), or with ``tiled`` concatenated along
    axis 0 (``tiled=True``)."""
    join = torch.cat if tiled else torch.stack
    if wire.active():
        wire.record("all-gather", wire.nbytes(list(xs)), len(xs), members=len(xs),
                    site="collectives")
    return _per_device(xs, lambda dev: join([_to(x, dev) for x in xs]))


# --------------------------------------------------------------------------
# model-axis collectives
# --------------------------------------------------------------------------
def _reduce(xs: Sequence[torch.Tensor], op) -> list[torch.Tensor]:
    if wire.active():
        wire.record("all-reduce", wire.nbytes(xs[0]), len(xs), members=len(xs),
                    site="collectives")
    home = xs[0].device
    total = xs[0]
    for x in xs[1:]:
        total = op(total, _to(x, home))
    return _per_device(xs, lambda dev: _to(total, dev))


def psum(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The members' sum (``jax.lax.psum``), member by member in order."""
    return _reduce(xs, torch.add)


def pmax(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The members' elementwise maximum (``jax.lax.pmax``)."""
    return _reduce(xs, torch.maximum)


def pmean(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The members' mean (``jax.lax.pmean``): their ordered sum over their
    count."""
    return [x / len(xs) for x in psum(xs)]


def all_to_all(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)`` over n members: member j's (n, ...) tensor is split
    along axis 0 and piece i goes to member i, which stacks what it
    receives in source order, (n src, ...)."""
    if wire.active():
        wire.record("all-to-all", wire.nbytes(xs[0]), len(xs), members=len(xs),
                    site="collectives")
    return [torch.stack([_to(x[i], dst.device) for x in xs]) for i, dst in enumerate(xs)]


def bcast_pytree(trees: Sequence[Tree], src) -> list[Tree]:
    """Bit-exact broadcast of member ``src``'s tree to every member.

    ``src`` an int: the source's word stream goes to each device.  ``src``
    a 0-d tensor (decided on the device): a masked sum of every member's
    word stream, which moves any dtype's bits exactly (a float sum would
    lose -0.0 signs and NaN payloads) and needs no host synchronisation.
    Each member gets its own copy, also on a shared card."""
    layout = ops.word_layout(trees[0])
    wire.record("collective-permute", 4 * layout.total, len(trees), members=len(trees) - 1,
                site="collectives")
    if isinstance(src, torch.Tensor):
        flats = [ops.flatten_to_u32(t, layout=layout) for t in trees]
        home = flats[0].device
        src = _to(src, home)
        acc = torch.zeros_like(flats[0])
        for p, f in enumerate(flats):
            acc = acc + torch.where(src == p, _to(f, home), torch.zeros_like(acc))
    else:
        acc = ops.flatten_to_u32(trees[int(src)], layout=layout)
    return [ops.unflatten_from_u32(acc.to(_device(t), copy=True), t, layout=layout)
            for t in trees]


def exchange_pytree(trees: Sequence[Tree]) -> list[Tree]:
    """Each of the TWO members receives the other's tree (one word stream
    each way): the O(state) wire cost of the bitwise DMR compare."""
    if len(trees) != 2:
        raise ValueError(f"exchange_pytree swaps a pair; got {len(trees)} members")
    layout = ops.word_layout(trees[0])
    wire.record("collective-permute", 4 * layout.total, 2, members=2, site="collectives")
    flats = [ops.flatten_to_u32(t, layout=layout) for t in trees]
    return [ops.unflatten_from_u32(_to(flats[1 - p], _device(t)), t, layout=layout)
            for p, t in enumerate(trees)]


def gather_words(trees: Sequence[Tree], dev: torch.device) -> torch.Tensor:
    """(R, words) int32 on ``dev``: row r is member r's word stream.  The
    received streams of ``gather_replicas``, before they are unpacked;
    the spatial TMR vote reads them as they are."""
    layout = ops.word_layout(trees[0])
    wire.record("all-gather", 4 * layout.total * len(trees), len(trees), site="collectives")
    return torch.stack([_to(ops.flatten_to_u32(t, layout=layout), dev) for t in trees])


def gather_replicas(trees: Sequence[Tree]) -> list[Tree]:
    """All R members' trees re-stacked on a leading replica axis, on every
    member's device: the spatial counterpart of a temporal replicated
    state's layout."""
    layout = ops.word_layout(trees[0])

    def make(dev):
        g = gather_words(trees, dev)
        reps = [ops.unflatten_from_u32(g[r], trees[0], layout=layout) for r in range(len(trees))]
        return tree_map(lambda *xs: torch.stack(xs), *reps)

    wire.record("all-gather", 4 * layout.total * len(trees), len(trees), members=len(trees),
                site="collectives")
    with wire.paused():
        return _per_device(trees, make)


# --------------------------------------------------------------------------
# gradient collectives
# --------------------------------------------------------------------------
_QBLOCK = 512


def _quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (n,) f32 -> (int8 (n,), scales (n / _QBLOCK,))."""
    blocks = x.reshape(-1, _QBLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return q.reshape(-1), scale[:, 0]


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.reshape(-1, _QBLOCK).to(torch.float32) * scale[:, None]).reshape(-1)


def compressed_psum_int8(
    flats: Sequence[torch.Tensor], efs: Sequence[torch.Tensor]
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The mean over the members with an int8 wire format and error
    feedback: ``(mean, new_ef)`` per member.

      1. x = flat + ef, cut into one chunk a member, quantized blockwise;
      2. all-to-all: member i receives every member's chunk i;
      3. dequantize, sum in f32, divide, requantize;
      4. all-gather of the reduced chunks.

    ``new_ef`` is the error of the member's own send, so the accumulated
    gradient is unbiased over steps (EF-SGD)."""
    n_dev = len(flats)
    n = flats[0].shape[0]
    if n % (n_dev * _QBLOCK):
        raise ValueError(f"gradient of {n} elements is not a multiple of {n_dev} x {_QBLOCK}")
    c = n // n_dev
    # each hop moves the int8 codes and one f32 scale a block
    hop = n + 4 * (n // _QBLOCK)
    wire.record("all-to-all", hop, n_dev, members=n_dev, site="collectives")
    wire.record("all-gather", hop, n_dev, members=n_dev, site="collectives")
    sends, errs = [], []
    for flat, ef in zip(flats, efs):
        x = flat + ef
        qs = [_quant(ch) for ch in x.reshape(n_dev, c)]
        sends.append(qs)
        # x - q * scale rounded once, as the reference's fused
        # multiply-add gives it (the f64 product of two f32 is exact)
        q = torch.cat([q for q, _ in qs]).to(torch.float64).reshape(-1, _QBLOCK)
        s = torch.cat([s for _, s in qs]).to(torch.float64)[:, None]
        errs.append((x.to(torch.float64).reshape(-1, _QBLOCK) - q * s).reshape(-1)
                    .to(torch.float32))
    # hop 1 (all-to-all) and the reduction: member i sums chunk i
    reduced = []
    for i, flat in enumerate(flats):
        dev = flat.device
        parts = torch.stack([_dequant(_to(sends[j][i][0], dev), _to(sends[j][i][1], dev))
                             for j in range(n_dev)])
        reduced.append(_quant(parts.sum(dim=0) / n_dev))
    # hop 2 (all-gather of the reduced chunks)
    out = []
    for flat, err in zip(flats, errs):
        dev = flat.device
        q_all = torch.cat([_to(q, dev) for q, _ in reduced])
        s_all = torch.cat([_to(s, dev) for _, s in reduced])
        out.append((_dequant(q_all, s_all), err))
    return out


def int8_mean_error(flats: Sequence[torch.Tensor], efs: Sequence[torch.Tensor],
                    mean: torch.Tensor) -> float:
    """How far ``mean``, ``compressed_psum_int8``'s for the members'
    ``flats`` and ``efs``, lies from the exact mean of their ``flat +
    ef``: the worst 512-element block's error over the bound its two
    roundings give, half the members' mean hop-1 scale plus half the
    hop-2 scale (hop 2 rounds the hop-1 mean, whose block maximum is at
    most half a hop-1 scale past the exact one's), plus f32 slop.  At
    most 1 for a sound reduction."""
    x = [f + e for f, e in zip(flats, efs)]
    exact = sum(x) / len(x)
    blocks = lambda t: t.reshape(-1, _QBLOCK)
    s1 = sum(blocks(xi).abs().amax(1) / 127 for xi in x) / len(x)
    s2 = (blocks(exact).abs().amax(1) + s1 / 2) / 127
    bound = (s1 + s2) / 2 + 1e-6 * float(exact.abs().max())
    return float((blocks(mean.to(exact.device) - exact).abs().amax(1) / bound).max())


def psum_mean(flats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The members' mean (``jax.lax.pmean``): their sum, member by member
    in order, divided by their count."""
    if wire.active():
        wire.record("all-reduce", wire.nbytes(flats[0]), len(flats), members=len(flats),
                    site="collectives")
    home = flats[0].device
    total = flats[0]
    for f in flats[1:]:
        total = total + _to(f, home)
    mean = total / len(flats)
    return [mean.to(f.device, copy=True) for f in flats]
