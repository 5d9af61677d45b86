"""Slot bookkeeping + slot surgery for the continuous batcher (a port of
``repro/serving/slots.py``).

The resident decoder cell has a fixed batch of ``n_slots``; the engine
multiplexes requests onto it by scattering prompt caches into free slots
between ticks and evicting finished ones:

  * ``SlotManager`` — host-side ownership (which request holds which
    slots; per-request *replica* slots for DMR/TMR policies, placed on
    one pod's rows or, spatially, at one column across pods).
  * slot surgery — ``join_slot`` / ``read_slot`` / ``copy_slot`` /
    ``slot_fingerprints`` / ``mask_slots``, driven by a per-leaf
    *slot-axis* tree (``infer_slot_axes``), because the batch axis is not
    in the same position on every leaf.  Writes are out of place: the
    engine keeps the tick's input buffer for the §IV replay.

A decoder served under a ``ShardCtx`` with a mesh holds ``Sharded``
cache leaves (``distributed/sharding.py``), a slot's rows on its data
member: surgery then writes only the members whose block holds the
slot (the others keep their tensors), reads a slot back as one full
width-1 tensor, and fingerprints the gathered rows, so a slot's 128-bit
fingerprint is the one the unsharded engine computes for the same
bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..core.redundancy import bit_mismatch_elems, fingerprint_rows
from ..distributed.sharding import Sharded, map_blocks
from ..tree import tree_leaves, tree_map

Tree = Any


# --------------------------------------------------------------------------
# slot-axis inference
# --------------------------------------------------------------------------
def _width_axes(a: torch.Tensor, b: torch.Tensor) -> list[int]:
    return [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]


def infer_slot_axes(make_state: Callable[[int], Tree], w1: int = 2, w2: int = 3) -> Tree:
    """Per-leaf slot (batch) axis of a slotted cell state, found
    structurally: build the state at two widths (callers build on the
    ``meta`` device, so nothing is allocated) and locate the single axis
    that scales with the width."""

    def ax(a, b):
        diffs = _width_axes(a, b)
        if len(diffs) != 1:
            raise ValueError(
                f"leaf {tuple(a.shape)}/{tuple(b.shape)} has {len(diffs)} width-dependent "
                "axes; a slotted cell state needs exactly one slot axis per leaf"
            )
        return diffs[0]

    return tree_map(ax, make_state(w1), make_state(w2))


def _bcast(mask: torch.Tensor, ndim: int, ax: int) -> torch.Tensor:
    """Reshape a (B,) mask to broadcast against a rank-``ndim`` leaf whose
    slot axis is ``ax``."""
    return mask.reshape((1,) * ax + (-1,) + (1,) * (ndim - ax - 1))


# --------------------------------------------------------------------------
# slot surgery (pure: every result is a new tensor)
# --------------------------------------------------------------------------
def _mask_leaf(active: torch.Tensor, n, o, ax: int):
    if isinstance(n, Sharded):
        return map_blocks(lambda blk, nt, ot: torch.where(
            _bcast(active[blk[ax]].to(nt.device), nt.dim(), ax), nt, ot), n, o)
    return torch.where(_bcast(active, n.dim(), ax), n, o)


def mask_slots(active: torch.Tensor, new: Tree, old: Tree, axes: Tree) -> Tree:
    """Per-slot select: active slots take ``new``, inactive keep ``old``
    bit-for-bit.  The writeback gate of the slot-masked decoder."""
    return tree_map(lambda n, o, ax: _mask_leaf(active, n, o, ax), new, old, axes)


def put_slot(dst, src: torch.Tensor, slot: int, ax: int):
    """A copy of ``dst`` with its width-1 slice at ``slot`` along ``ax``
    replaced by ``src``.  A ``Sharded`` ``dst`` copies only the members
    whose block holds the slot, each taking its part of ``src``."""
    if isinstance(dst, Sharded):
        def put(blk, t):
            if not blk[ax].start <= slot < blk[ax].stop:
                return t
            part = src[tuple(slice(None) if i == ax else s for i, s in enumerate(blk))]
            return put_slot(t, part.to(t.device), slot - blk[ax].start, ax)

        return map_blocks(put, dst)
    out = dst.clone()
    out.narrow(ax, slot, 1).copy_(src.to(dst.dtype))
    return out


def join_slot(state: Tree, slot_state: Tree, slot: int, axes: Tree) -> Tree:
    """Scatter a width-1 slot state into batch slot ``slot``."""
    return tree_map(lambda d, s, ax: put_slot(d, s, slot, ax), state, slot_state, axes)


def _read_leaf(x, slot: int, ax: int):
    if isinstance(x, Sharded):
        return x.region(tuple(slice(slot, slot + 1) if i == ax else slice(None)
                              for i in range(x.dim())))
    return x.narrow(ax, slot, 1)


def read_slot(state: Tree, slot: int, axes: Tree) -> Tree:
    """The width-1 view of batch slot ``slot`` (inverse of ``join_slot``);
    a ``Sharded`` leaf's slot comes back as one gathered tensor."""
    return tree_map(lambda x, ax: _read_leaf(x, slot, ax), state, axes)


def copy_slot(state: Tree, src: int, dst: int, axes: Tree) -> Tree:
    """Copy slot ``src`` over slot ``dst`` — TMR repair (exact, bitwise)."""
    return join_slot(state, read_slot(state, src, axes), dst, axes)


def slot_fingerprints(state: Tree, axes: Tree) -> torch.Tensor:
    """(B, 4) int64 of uint32 words: the 128-bit state fingerprint of every
    slot's view of the state (the JAX package's ``vmap(fingerprint)``).
    Replica slots of one request are bitwise-equal by construction, so
    equal fingerprints <=> healthy."""
    moved = tree_map(lambda x, ax: (x.full() if isinstance(x, Sharded) else x).movedim(ax, 0),
                     state, axes)
    return fingerprint_rows(moved, tree_leaves(moved)[0].shape[0])


# --------------------------------------------------------------------------
# the surgery protocol: how the engine cuts state in and out of slots
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SlotSurgery:
    """The engine's slot-state operations, bundled so a state layout can
    swap in its own (``serving/paging.py`` routes them through a page
    table; ``default_surgery`` is the dense whole-leaf layout).

      join(states, slot_state, slot, req=None)  scatter a width-1 state in
      scrub(states, slot)                       evict: slot back to empty
      copy(states, src, dst)                    bitwise slot copy (repair)
      adopt(states, other, slot)                take ``other``'s slot view
      fingerprints(cell_state) -> (B, 4)        per-slot 128-bit fps
      damage(states, a, b) -> float             mismatch between two slots
      damage_vs(states, other, slot) -> float   mismatch vs another state
    """

    join: Callable[..., dict]
    scrub: Callable[[dict, int], dict]
    copy: Callable[[dict, int, int], dict]
    adopt: Callable[[dict, dict, int], dict]
    fingerprints: Callable[[Tree], torch.Tensor]
    damage: Callable[[dict, int, int], float]
    damage_vs: Callable[[dict, dict, int], float]


def default_surgery(cell: str, axes: Tree, make_empty: Callable[[], Tree]) -> SlotSurgery:
    """Dense-layout surgery: every leaf is whole-per-slot."""
    empty = make_empty()

    def join(st, ss, slot, req=None):
        return {**st, cell: join_slot(st[cell], ss, slot, axes)}

    def adopt(st, other, slot):
        return {**st, cell: join_slot(st[cell], read_slot(other[cell], slot, axes), slot, axes)}

    # real damage accounting: mismatched ELEMENTS between two replica
    # slots (temporal lockstep's bitwise-compare unit)
    def damage(st, a, b):
        return float(bit_mismatch_elems(read_slot(st[cell], a, axes), read_slot(st[cell], b, axes)))

    def damage_vs(st, other, slot):
        return float(
            bit_mismatch_elems(read_slot(st[cell], slot, axes), read_slot(other[cell], slot, axes))
        )

    return SlotSurgery(
        join=join,
        scrub=lambda st, slot: join(st, empty, slot),
        copy=lambda st, src, dst: {**st, cell: copy_slot(st[cell], src, dst, axes)},
        adopt=adopt,
        fingerprints=lambda dec: slot_fingerprints(dec, axes),
        damage=damage,
        damage_vs=damage_vs,
    )


# --------------------------------------------------------------------------
# host-side ownership
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SlotManager:
    """Ownership of the resident batch's slots.

    A request occupies ``policy.level`` slots (1 = none, 2 = DMR, 3 =
    TMR): replication maps onto *extra batch rows* of the decoder, per
    request, so unprotected requests pay nothing for their neighbors'
    protection.  Replica slots may be allocated CONTIGUOUS; when churn
    fragments the free list, ``defrag_plan``/``relocate`` compact it by
    moving running requests' slots (bitwise-transparent to their owners).

    SPATIAL placement (``pods > 1``): the global slot space is the
    concatenation of ``pods`` per-pod row blocks -- pod ``p`` owns global
    slots ``[p*spp, (p+1)*spp)`` where ``spp = n_slots // pods`` (the
    spatial back-end splits the decoder's slot axis in exactly this
    blocked layout).  ``alloc(..., spatial=True)`` reserves the SAME
    column on pods ``0..n-1`` -- one replica slot a pod, so a strike on
    one pod hits exactly one replica -- with no adjacency requirement:
    spatial admissions never defragment, and spatial tenants are pinned
    (``defrag_plan`` never relocates them, which would tear a replica
    off its pod).  Temporal runs and defrag windows stay inside one
    pod's block, and unreplicated requests fill from the HIGHEST pod
    down so low-pod columns stay clear for spatial groups.
    """

    n_slots: int
    pods: int = 1

    def __post_init__(self):
        if self.pods < 1 or self.n_slots < 1 or self.n_slots % self.pods:
            raise ValueError(
                f"n_slots={self.n_slots} must be a positive multiple of "
                f"pods={self.pods} (the mesh splits the slot axis evenly)"
            )
        self.per_pod = self.n_slots // self.pods
        self._free: list[int] = list(range(self.n_slots))
        self._slots_of: dict[str, list[int]] = {}
        self._owner: dict[int, str] = {}
        self._pinned: set[int] = set()  # spatial tenants: never relocated

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def active(self) -> int:
        return self.n_slots - len(self._free)

    def slots_of(self, rid: str) -> list[int]:
        return list(self._slots_of.get(rid, ()))

    def owner(self, slot: int) -> Optional[str]:
        return self._owner.get(slot)

    def alloc(self, rid: str, n: int, contiguous: bool = False,
              spatial: bool = False) -> Optional[list[int]]:
        """n free slots for request ``rid``; None if the batch can't fit it
        right now.  ``contiguous=True`` requires one adjacent run.
        ``spatial=True`` instead reserves one slot a pod at a shared
        column (``find_column``); the list is ordered by pod, so replica
        i lives on pod i."""
        if rid in self._slots_of:
            raise ValueError(f"request {rid!r} already holds slots")
        if n > len(self._free):
            return None
        if spatial and n > 1:
            if n > self.pods:
                return None
            col = self.find_column(n)
            if col is None:
                return None
            got = [p * self.per_pod + col for p in range(n)]
            for s in got:
                self._free.remove(s)
            self._pinned.update(got)
        elif contiguous and n > 1:
            start = self.find_run(n)
            if start is None:
                return None
            got = list(range(start, start + n))
            for s in got:
                self._free.remove(s)
        elif self.pods > 1:
            # unreplicated: fill from the highest pod down, keeping
            # low-pod columns open for spatial groups
            got = [self._free.pop() for _ in range(n)]
        else:
            got = [self._free.pop(0) for _ in range(n)]
        self._slots_of[rid] = got
        for s in got:
            self._owner[s] = rid
        return list(got)

    def find_run(self, n: int) -> Optional[int]:
        """Start index of the leftmost run of ``n`` adjacent free slots
        inside one pod's block."""
        free = set(self._free)
        for start in range(self.n_slots - n + 1):
            if start // self.per_pod != (start + n - 1) // self.per_pod:
                continue
            if all(start + i in free for i in range(n)):
                return start
        return None

    def find_column(self, n: int) -> Optional[int]:
        """Lowest column ``c`` whose slot is free on pods ``0..n-1``: the
        spatial allocation unit."""
        free = set(self._free)
        for c in range(self.per_pod):
            if all(p * self.per_pod + c in free for p in range(n)):
                return c
        return None

    def defrag_plan(self, n: int) -> Optional[list[tuple[int, int]]]:
        """Relocations ``[(src, dst), ...]`` that open an n-slot adjacent
        free run: pick the window holding the fewest REPLICA slots, then
        the fewest tenants overall, and evacuate them into free slots
        outside it.  None if total free capacity < n, or if every window
        crosses a pod boundary or holds a pinned (spatial) tenant; [] if
        a run exists.  Without pinned tenants always satisfiable when
        ``free >= n``."""
        if n > len(self._free):
            return None
        free = set(self._free)

        def cost(start):
            occ = [s for s in range(start, start + n) if s not in free]
            repl = sum(1 for s in occ if len(self._slots_of[self._owner[s]]) > 1)
            return (repl, len(occ)), occ

        best_cost, best_start, best_occ = None, None, None
        for start in range(self.n_slots - n + 1):
            if start // self.per_pod != (start + n - 1) // self.per_pod:
                continue
            if any(s in self._pinned for s in range(start, start + n)):
                continue
            c, occ = cost(start)
            if best_cost is None or c < best_cost:
                best_cost, best_start, best_occ = c, start, occ
        if best_start is None:
            return None
        dsts = [s for s in sorted(free)
                if (s < best_start or s >= best_start + n) and s not in self._pinned]
        return list(zip(best_occ, dsts))

    def relocate(self, src: int, dst: int) -> str:
        """Move the tenant of slot ``src`` to free slot ``dst`` (ownership
        only — the engine performs the matching state copy + scrub)."""
        rid = self._owner.pop(src)
        self._free.remove(dst)
        self._free.append(src)
        self._free.sort()
        self._owner[dst] = rid
        sl = self._slots_of[rid]
        sl[sl.index(src)] = dst
        return rid

    def release(self, rid: str) -> list[int]:
        got = self._slots_of.pop(rid, [])
        for s in got:
            del self._owner[s]
            self._pinned.discard(s)
            self._free.append(s)
        self._free.sort()  # deterministic reuse order
        return got
