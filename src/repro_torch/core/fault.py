"""Soft-error injection (to test paper §IV's detection/correction claims).

Transitions are pure, so two replica executions are bit-identical unless
the hardware misbehaves.  To *test* the dependability machinery we emulate
a particle strike: flip one bit of one replica's freshly computed state.
The fault is a ``FaultSpec`` of plain ints; ``step == -1`` disarms it.
Leaves are addressed in ``repro_torch.tree`` order (JAX's leaf order), so
a spec aimed at the JAX package's state hits the same element here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributed.sharding import Sharded, map_blocks
from ..tree import tree_flatten, tree_unflatten

_UINT = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32, 8: torch.uint64}
_SINT = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bitcast_uint(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret any tensor as an unsigned integer tensor of equal width
    (``bool`` becomes ``uint8`` 0/1, as in the JAX package)."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    return x.view(_UINT[x.element_size()])


def bitcast_back(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bool:
        return u.to(torch.bool)
    return u.view(dtype)


def bitcast_int(x: torch.Tensor) -> torch.Tensor:
    """Signed view of the same bits.  Bitwise ops on the unsigned views
    are incomplete on the CPU build; on signed views they are the same
    bit operations and work everywhere."""
    if x.dtype == torch.bool:
        return x.to(torch.int8)
    return x.view(_SINT[x.element_size()])


@dataclasses.dataclass
class FaultSpec:
    """One armed bit-flip.  ``step == -1`` disarms (the common case)."""

    step: int  # transition step at which to strike
    cell_id: int  # index of the target cell in program order
    replica: int  # which replica's output to corrupt
    leaf: int  # which state leaf (flatten order)
    index: int  # flat element index within the leaf
    bit: int  # bit position (mod leaf bit-width)

    @staticmethod
    def none() -> "FaultSpec":
        return FaultSpec(step=-1, cell_id=-1, replica=-1, leaf=-1, index=-1, bit=-1)

    @staticmethod
    def at(step, cell_id, replica=0, leaf=0, index=0, bit=0) -> "FaultSpec":
        return FaultSpec(
            step=int(step),
            cell_id=int(cell_id),
            replica=int(replica),
            leaf=int(leaf),
            index=int(index),
            bit=int(bit),
        )


def _c_divmod(a: int, b: int) -> tuple[int, int]:
    """Truncating division and C remainder (``lax.div``/``lax.rem``)."""
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    return q, a - q * b


def inject(spec: FaultSpec, *, cell_id: int, step: int, replicated_state):
    """Flip ``spec``'s bit in the replica outputs when (step, cell) match.

    ``replicated_state``: tree whose leaves have a leading replica axis R.
    Out of place: the struck leaf is copied, every other leaf is passed
    through; of a ``Sharded`` leaf, every member tensor that holds the
    element is copied and flipped (as a global array element changes in
    every device copy of it), the others are passed through.  Element addressing matches the JAX package exactly: the flat
    index is split into per-dimension coordinates with C-style div/rem,
    so an index past the leaf's end wraps and a negative one hits nothing.
    """
    if spec.cell_id != cell_id or spec.step != step:
        return replicated_state
    leaves, treedef = tree_flatten(replicated_state)
    if not 0 <= spec.leaf < len(leaves):
        return replicated_state
    leaf = leaves[spec.leaf]
    R = leaf.shape[0]
    rep = min(max(spec.replica, 0), R - 1)
    coords, idx = [], spec.index
    for d in reversed(leaf.shape[1:]):
        idx, c = _c_divmod(idx, d)
        coords.append(c)
    coords.reverse()
    if any(c < 0 for c in coords):
        return replicated_state
    nbits = (1 if leaf.dtype == torch.bool else leaf.dtype.itemsize) * 8
    bit = spec.bit % nbits
    mask = 1 << bit
    if mask >= 1 << (nbits - 1):
        mask -= 1 << nbits  # the same bit in the signed view

    def flip(t: torch.Tensor, at: tuple) -> torch.Tensor:
        flipped = bitcast_int(t).clone()
        flipped[at] ^= mask
        return flipped.to(torch.bool) if t.dtype == torch.bool else flipped.view(t.dtype)

    at = (rep, *coords)
    if isinstance(leaf, Sharded):
        # the global element changes once, in every member copy of it:
        # each distinct tensor whose block holds it is copied and flipped
        def member(block, t):
            if all(b.start <= g < b.stop for b, g in zip(block, at)):
                return flip(t, tuple(g - b.start for b, g in zip(block, at)))
            return t

        leaves[spec.leaf] = map_blocks(member, leaf)
    else:
        leaves[spec.leaf] = flip(leaf, at)
    return tree_unflatten(treedef, leaves)


def random_fault_campaign(
    rng: np.random.Generator,
    *,
    n: int,
    steps: int,
    cell_id: int,
    replicas: int,
    leaf_sizes: list[int],
    bits: int = 32,
) -> list[FaultSpec]:
    """Sample a campaign of n single-bit faults (host-side, numpy only —
    the same generator state gives the same specs as the JAX package)."""
    out = []
    for _ in range(n):
        leaf = int(rng.integers(len(leaf_sizes)))
        out.append(
            FaultSpec.at(
                step=int(rng.integers(steps)),
                cell_id=cell_id,
                replica=int(rng.integers(replicas)),
                leaf=leaf,
                index=int(rng.integers(max(1, leaf_sizes[leaf]))),
                bit=int(rng.integers(bits)),
            )
        )
    return out
