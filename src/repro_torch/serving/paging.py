"""Paged KV cache for the continuous batcher (a port of
``repro/serving/paging.py``).

The cache is ONE shared pool of fixed-size pages per layer; each slot
owns a *page table* ((P,) int32 pool rows, -1 = unmapped):

  * ``PageTable`` — the host-side manager: free list, per-slot page rows,
    admission *reservations* (a slot reserves its worst-case page count
    up front, so growth mid-decode never finds the pool empty).
  * transforms between the dense slot layout and the pool
    (``dense_to_pool`` install scatter, ``pool_slot_view`` gather), used
    by the paged ``SlotSurgery``: fingerprints, damage and repair run on
    the GATHERED dense-layout view, so replica slots holding different
    pool rows but the same page contents fingerprint equal.
  * ``paged_surgery`` / ``make_pre_tick`` — join installs a dense prefill
    into fresh pages, scrub releases them, the pre-tick hook maps pages
    ahead of the positions the next tick writes and zeroes them
    (clean-on-map).

Layout (the decoder state of ``models/lm_cells.py``): pool leaves are
(L, N, Hkv, ps, d); the matching dense leaves are (L, B, Hkv, S, d) with
S = P * ps.  Every operation writes out of place.  Under a ``ShardCtx``
with a mesh the pools are ``Sharded`` (pages over the data axes, kv
heads or each page's lanes over the model axis) and the page table stays
the one host table: installs, zeroing and replica copies write only the
members holding the rows (a replica's source row may lie on another
data member), and the dense view is assembled from every member's
blocks, so fingerprints are the unsharded view's.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..core.redundancy import bit_mismatch_elems
from ..distributed.sharding import Sharded, _key, map_blocks
from ..tree import tree_map
from .slots import (SlotSurgery, _mask_leaf, _read_leaf, _width_axes, put_slot, read_slot,
                    slot_fingerprints)

Tree = Any

#: slot-axis sentinel for pool leaves: shared by every slot through the
#: page table
POOL = "pool"


# --------------------------------------------------------------------------
# slot-axis inference with pool leaves
# --------------------------------------------------------------------------
def infer_paged_axes(make_state: Callable[[int], Tree], w1: int = 2, w2: int = 3) -> Tree:
    """Like ``slots.infer_slot_axes`` but pool leaves (no width-dependent
    axis) map to ``POOL``."""

    def ax(a, b):
        diffs = _width_axes(a, b)
        if not diffs:
            return POOL
        if len(diffs) != 1:
            raise ValueError(
                f"leaf {tuple(a.shape)}/{tuple(b.shape)} has {len(diffs)} width-dependent "
                "axes; a paged slot state needs at most one slot axis per leaf"
            )
        return diffs[0]

    return tree_map(ax, make_state(w1), make_state(w2))


def mask_slots_paged(active: torch.Tensor, new: Tree, old: Tree, axes: Tree) -> Tree:
    """``slots.mask_slots`` for a paged state: pool leaves pass through —
    their writes are already gated per slot at the scatter."""

    def sel(n, o, ax):
        if ax == POOL:
            return n
        return _mask_leaf(active, n, o, ax)

    return tree_map(sel, new, old, axes)


# --------------------------------------------------------------------------
# the host-side page-table manager
# --------------------------------------------------------------------------
class PageTable:
    """Fixed-size KV pages in one shared pool; per-slot page rows.

    Reservation discipline: ``assign(slot, reserve)`` at admission claims
    the slot's worst-case page count against ``available``; every page
    the slot later maps (``grow_to``) is drawn from its own reservation.
    """

    def __init__(self, n_pages: int, page_size: int, pages_per_slot: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError((n_pages, page_size))
        self.n_pages = n_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self._free: list[int] = list(range(n_pages))
        self._rows: dict[int, list[int]] = {}
        self._reserved: dict[int, int] = {}
        #: pages demand-mapped by the pre-tick hook
        self.page_faults = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available(self) -> int:
        """Free pages not spoken for by outstanding reservations."""
        return len(self._free) - sum(self._reserved.values())

    def can_admit(self, n: int) -> bool:
        return n <= self.available

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.page_size)

    def assign(self, slot: int, reserve: int) -> None:
        """Open a slot's (empty) page row and reserve its worst-case page
        count.  ``can_admit(reserve)`` must have been checked."""
        if slot in self._rows:
            raise ValueError(f"slot {slot} already assigned")
        if reserve > self.available:
            raise RuntimeError(
                f"reservation of {reserve} pages exceeds available {self.available} "
                "(admission must check can_admit)"
            )
        self._rows[slot] = []
        self._reserved[slot] = reserve

    def grow_to(self, slot: int, n_tokens: int, demand: bool = False) -> list[int]:
        """Map pages until the slot covers positions [0, n_tokens); returns
        the newly mapped rows (callers zero them).  ``demand=True`` counts
        the growth as page faults."""
        rows = self._rows[slot]
        need = self.pages_for(n_tokens)
        if need > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens needs {need} pages > "
                f"pages_per_slot {self.pages_per_slot}"
            )
        new = []
        while len(rows) < need:
            if not self._free:
                raise RuntimeError(
                    "page pool exhausted despite reservations — reservation accounting is broken"
                )
            rows.append(self._free.pop(0))
            new.append(rows[-1])
            self._reserved[slot] = max(0, self._reserved[slot] - 1)
        if demand and new:
            self.page_faults += len(new)
        return new

    def rows_of(self, slot: int) -> list[int]:
        return list(self._rows.get(slot, ()))

    def row_array(self, slot: int) -> np.ndarray:
        """(pages_per_slot,) int32 page row of a slot, -1-padded."""
        out = np.full((self.pages_per_slot,), -1, np.int32)
        rows = self._rows.get(slot, ())
        out[: len(rows)] = rows
        return out

    def release(self, slot: int) -> list[int]:
        """Evict: the slot's pages go back to the free list (sorted, for
        deterministic reuse) and its reservation is dropped."""
        rows = self._rows.pop(slot, [])
        self._reserved.pop(slot, None)
        self._free.extend(rows)
        self._free.sort()
        return rows


# --------------------------------------------------------------------------
# layout transforms: dense slot leaves <-> page pools
# --------------------------------------------------------------------------
def _mapped(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(logical page indices, pool rows) of the mapped entries of a host
    page row."""
    idx = np.nonzero(rows >= 0)[0]
    return idx, rows[idx]


def _put_rows(pool, dst: np.ndarray, values):
    """A copy of pool (L, N, ...) with page rows ``dst`` (host) set to
    ``values(keep, block)``: the values (L, n, ...) of the rows
    ``dst[keep]`` restricted to ``block``'s other dimensions, on any
    device.  A ``Sharded`` pool copies only the members whose block holds
    one of the rows (each taking its part); the others keep their
    tensors."""
    def put(block, t):
        rs = block[1]
        keep = (dst >= rs.start) & (dst < rs.stop)
        if not keep.any():
            return t
        out = t.clone()
        idx = torch.from_numpy(dst[keep] - rs.start).long().to(t.device)
        out[:, idx] = values(keep, block).to(t.device, t.dtype)
        return out

    if isinstance(pool, Sharded):
        return map_blocks(put, pool)
    return put(tuple(slice(0, n) for n in pool.shape), pool)


def _rows_of(pool, rows: np.ndarray, block: tuple) -> torch.Tensor:
    """Page rows ``rows`` (host) of pool (L, N, ...), restricted to
    ``block``'s dimensions past the rows: (L, len(rows), ...).  From a
    ``Sharded`` pool, each row from the block of the same other
    dimensions that holds it (a replica slot's rows may lie on another
    data member)."""
    rest = tuple(block[2:])
    if not isinstance(pool, Sharded):
        return pool[:, torch.from_numpy(rows).long().to(pool.device)][(slice(None),) * 2 + rest]
    out = None
    for blk, t in pool.blocks():
        if _key(blk[2:]) != _key(rest):
            continue
        rs = blk[1]
        hit = (rows >= rs.start) & (rows < rs.stop)
        if not hit.any():
            continue
        if out is None:
            out = torch.empty((t.shape[0], len(rows)) + tuple(t.shape[2:]), dtype=t.dtype,
                              device=t.device)
        out[:, torch.from_numpy(np.nonzero(hit)[0]).to(t.device)] = t[
            :, torch.from_numpy(rows[hit] - rs.start).long().to(t.device)].to(out.device)
    return out


def dense_to_pool(pool, dense: torch.Tensor, rows: np.ndarray):
    """A copy of pool (L, N, ..., ps, d) with a width-1 dense leaf
    (L, 1, ..., S, d) written into page rows ``rows`` ((P,) host int32,
    -1 = skip).  Whole pages are written, the zero tail past the filled
    prefix included, so freshly mapped install pages come out clean.  A
    ``Sharded`` pool takes each page's part on the members holding its
    row (their kv heads, or their lanes of the page)."""
    ps = pool.shape[-2]
    x = dense.squeeze(1)
    x = x.reshape(x.shape[:-2] + (x.shape[-2] // ps, ps) + x.shape[-1:])
    x = x.movedim(-3, 1)  # (L, P, ..., ps, d)
    idx, dst = _mapped(rows)
    return _put_rows(pool, dst, lambda keep, block: x[:, torch.from_numpy(idx[keep]).to(x.device)][
        (slice(None),) * 2 + tuple(block[2:])])


def pool_slot_view(pool, pages: torch.Tensor) -> torch.Tensor:
    """The dense-layout view (L, B, ..., S, d) of every slot, gathered from
    the pool through the page tables (B, P); unmapped pages read as
    zeros.  Fingerprints, damage and repair reads run on this view.  A
    ``Sharded`` pool's view is assembled on the mesh's first device from
    each block's pages through its member-local table, so it is the
    unsharded pool's view bit for bit."""
    n = pool.shape[1]
    if isinstance(pool, Sharded):
        dev = pool.device
        table = torch.where(pages >= 0, pages.clamp(max=n - 1), -1).to(dev)
        g = torch.zeros((pool.shape[0],) + tuple(pages.shape) + tuple(pool.shape[2:]),
                        dtype=pool.dtype, device=dev)  # (L, B, P, ..., ps, d)
        for blk, t in pool.blocks():
            rs = blk[1]
            held = (table >= rs.start) & (table < rs.stop)
            local = (table - rs.start).clamp(0, rs.stop - rs.start - 1).to(t.device).long()
            part = g[(slice(None),) * 3 + tuple(blk[2:])]
            mask = held.reshape((1,) + tuple(held.shape) + (1,) * (part.dim() - 3))
            part.copy_(torch.where(mask, t[:, local].to(dev), part))
    else:
        g = pool[:, pages.clamp(0, n - 1).long()]  # (L, B, P, ..., ps, d)
        mapped = (pages >= 0).reshape((1,) + tuple(pages.shape) + (1,) * (g.dim() - 3))
        g = torch.where(mapped, g, torch.zeros((), dtype=g.dtype, device=g.device))
    g = g.movedim(2, -3)  # (L, B, ..., P, ps, d)
    return g.reshape(g.shape[:-3] + (-1,) + g.shape[-1:])


def paged_view(dec: dict, pages=None) -> dict:
    """The dense-layout view of a paged decoder state: pool leaves
    gathered per slot, the raw ``pages`` leaf dropped (replica slots hold
    different rows by construction).  A strike on ``pages`` still shows:
    the gather then reads the wrong (or no) page."""
    pages = dec["pages"] if pages is None else pages
    view = {k: v for k, v in dec.items() if k not in ("cache", "pages")}
    view["cache"] = {
        "segments": [
            {k: pool_slot_view(v, pages) for k, v in seg.items()} for seg in dec["cache"]["segments"]
        ],
        "pos": dec["cache"]["pos"],
    }
    return view


def view_axes_of(axes: Tree) -> Tree:
    """Slot axes of ``paged_view``'s output: gathered cache leaves carry
    the slot axis at 1; everything else keeps its inferred axis."""
    va = {k: v for k, v in axes.items() if k not in ("cache", "pages")}
    va["cache"] = {
        "segments": [tree_map(lambda a: 1, seg) for seg in axes["cache"]["segments"]],
        "pos": axes["cache"]["pos"],
    }
    return va


# --------------------------------------------------------------------------
# paged SlotSurgery
# --------------------------------------------------------------------------
def _copy_pages(pool, src_pool, src_rows: np.ndarray, dst_rows: np.ndarray):
    """A copy of ``pool`` with pages ``src_rows`` of ``src_pool`` written
    at ``dst_rows`` (entries with dst -1 skipped).  ``Sharded`` pools of
    one layout: each member holding a destination row takes the source
    row from the member that holds it (the same kv heads or lanes)."""
    keep = dst_rows >= 0
    src, dst = src_rows[keep], dst_rows[keep]
    return _put_rows(pool, dst, lambda k, block: _rows_of(src_pool, src[k], block))


def paged_surgery(
    table: PageTable,
    cell: str,
    axes: Tree,
    empty: Tree,
    *,
    reserve_fn: Callable[[Any], int],
) -> SlotSurgery:
    """The engine's slot operations routed through ``table``.

    ``axes``: the paged state's axis tree (``infer_paged_axes``);
    ``empty``: a width-1 paged slot state (its non-pool leaves scrub
    evicted slots; pool bytes stay and are cleaned on the next map);
    ``reserve_fn(request)``: the worst-case page count of one replica
    slot.  Join receives the DENSE width-1 prefill state."""
    vaxes = view_axes_of(axes)

    def _put(dst, src, slot, ax):
        return tree_map(lambda d, s, a: put_slot(d, s, slot, a), dst, src, ax)

    def _rows_leaf(v, slot, rows: np.ndarray):
        return put_slot(v, torch.from_numpy(rows)[None], slot, 0)

    def join(st, ss, slot, req=None):
        if req is None:
            raise ValueError("paged join needs the admitting request (page reservation sizing)")
        table.assign(slot, reserve_fn(req))
        table.grow_to(slot, int(ss["cache"]["pos"][0]))  # admission, not faults
        rows = table.row_array(slot)
        dec = st[cell]
        new = {}
        for k, v in dec.items():
            if k == "cache":
                segs = [
                    {kk: dense_to_pool(pseg[kk], dseg[kk], rows) for kk in pseg}
                    for pseg, dseg in zip(v["segments"], ss["cache"]["segments"])
                ]
                new[k] = {"segments": segs, "pos": put_slot(v["pos"], ss["cache"]["pos"], slot, 0)}
            elif k == "pages":
                new[k] = _rows_leaf(v, slot, rows)
            else:
                new[k] = _put(v, ss[k], slot, axes[k])
        return {**st, cell: new}

    def scrub(st, slot):
        table.release(slot)
        dec = st[cell]
        new = {}
        for k, v in dec.items():
            if k == "cache":
                pos = put_slot(v["pos"], empty["cache"]["pos"], slot, 0)
                new[k] = {"segments": v["segments"], "pos": pos}
            elif k == "pages":
                new[k] = _rows_leaf(v, slot, np.full((table.pages_per_slot,), -1, np.int32))
            else:
                new[k] = _put(v, empty[k], slot, axes[k])
        return {**st, cell: new}

    def copy(st, src, dst):
        """Replica repair src -> dst: per-slot leaves copied, page CONTENTS
        copied row by row; the dst pages leaf is restored from the host
        rows, so a strike on the pages leaf itself is repaired too."""
        src_rows, dst_rows = table.row_array(src), table.row_array(dst)
        if (src_rows >= 0).sum() != (dst_rows >= 0).sum():
            raise RuntimeError(f"replica slots {src}/{dst} page counts differ")
        dec = st[cell]
        new = {}
        for k, v in dec.items():
            if k == "cache":
                segs = [
                    {kk: _copy_pages(pseg[kk], pseg[kk], src_rows, dst_rows) for kk in pseg}
                    for pseg in v["segments"]
                ]
                pos = put_slot(v["pos"], _read_leaf(v["pos"], src, 0), dst, 0)
                new[k] = {"segments": segs, "pos": pos}
            elif k == "pages":
                new[k] = _rows_leaf(v, dst, dst_rows)
            else:
                new[k] = _put(v, read_slot(v, src, axes[k]), dst, axes[k])
        return {**st, cell: new}

    def adopt(st, other, slot):
        """DMR §IV adoption: per-slot leaves and the slot's page CONTENTS
        (at the same host rows — a replay never remaps pages) come from
        ``other``; the pages leaf is restored from the host rows."""
        rows = table.row_array(slot)
        dec, odec = st[cell], other[cell]
        new = {}
        for k, v in dec.items():
            if k == "cache":
                segs = [
                    {kk: _copy_pages(pseg[kk], oseg[kk], rows, rows) for kk in pseg}
                    for pseg, oseg in zip(v["segments"], odec["cache"]["segments"])
                ]
                pos = put_slot(v["pos"], _read_leaf(odec["cache"]["pos"], slot, 0), slot, 0)
                new[k] = {"segments": segs, "pos": pos}
            elif k == "pages":
                new[k] = _rows_leaf(v, slot, rows)
            else:
                new[k] = _put(v, read_slot(odec[k], slot, axes[k]), slot, axes[k])
        return {**st, cell: new}

    def damage(st, a, b):
        view = paged_view(st[cell])
        return float(bit_mismatch_elems(read_slot(view, a, vaxes), read_slot(view, b, vaxes)))

    def damage_vs(st, other, slot):
        mine = read_slot(paged_view(st[cell]), slot, vaxes)
        theirs = read_slot(paged_view(other[cell]), slot, vaxes)
        return float(bit_mismatch_elems(mine, theirs))

    return SlotSurgery(
        join=join,
        scrub=scrub,
        copy=copy,
        adopt=adopt,
        fingerprints=lambda dec: slot_fingerprints(paged_view(dec), vaxes),
        damage=damage,
        damage_vs=damage_vs,
    )


# --------------------------------------------------------------------------
# pre-tick demand growth
# --------------------------------------------------------------------------
def host_k_eff(spec_k: int, budget: int, n_decoded: int, pos: int, max_len: int,
               draft_len: int) -> int:
    """The host mirror of ``models.lm_cells.spec_k_eff`` for one slot: how
    many draft tokens the tick's verify walk takes.  The two clamps must
    agree, or the walk writes a position the pre-tick hook never mapped."""
    room = min(budget - n_decoded - 2, max_len - 1 - pos)
    return max(0, min(spec_k, room, draft_len))


def make_pre_tick(table: PageTable, cell: str, batch: int, walk_chunk: int = 1,
                  draft_len: int = 0):
    """The engine's pre-tick hook for a paged program: before each tick,
    map pages covering every position the tick will write (the decode
    append, up to ``walk_chunk`` prefill-walk tokens, or a ``k_eff + 1``
    verify walk when ``draft_len`` > 0), count them as page faults, and
    ZERO the newly mapped pool rows (clean-on-map: page reuse between
    requests leaves no stale bytes, so replica fingerprints and
    paged-vs-dense parity hold).  A rejected speculation rolls ``pos``
    back but unmaps nothing: the pages are inside the slot's reservation.
    Runs BEFORE the engine snapshots the tick's input buffer, so a §IV
    replay sees the same page tables.  ``pre_tick.tracer`` (set by the
    adapter's ``attach_tracer``) receives one ``page_fault`` instant per
    faulting slot."""
    max_len = table.pages_per_slot * table.page_size

    def pre_tick(states):
        dec = states[cell]
        names = ["active", "p_head", "p_len"] + (["spec_k", "budget", "n_decoded"] if draft_len else [])
        host = {k: dec[k].cpu().numpy() for k in names}
        act, p_head, p_len = host["active"], host["p_head"], host["p_len"]
        pos_leaf = dec["cache"]["pos"]
        pos = (pos_leaf.full() if isinstance(pos_leaf, Sharded) else pos_leaf).cpu().numpy()
        grew = np.zeros((batch,), bool)
        clean: list[int] = []
        for s in range(batch):
            if not act[s]:
                continue
            r = int(p_len[s] - p_head[s])
            if r > 0:
                step = min(walk_chunk, r)
            elif draft_len:
                step = 1 + host_k_eff(int(host["spec_k"][s]), int(host["budget"][s]),
                                      int(host["n_decoded"][s]), int(pos[s]), max_len, draft_len)
            else:
                step = 1
            new = table.grow_to(s, int(pos[s]) + step, demand=True)
            if new:
                clean.extend(new)
                grew[s] = True
                if pre_tick.tracer is not None:
                    pre_tick.tracer.instant("page_fault", "engine", slot=s,
                                            pages=[int(p) for p in new], pos=int(pos[s]) + step)
        if not grew.any():
            return states
        new = dict(dec)
        dev = dec["pages"].device
        rows = torch.from_numpy(np.stack([table.row_array(s) for s in range(batch)])).to(dev)
        new["pages"] = torch.where(torch.from_numpy(grew).to(dev)[:, None], rows, dec["pages"])
        rows_clean = np.asarray(clean, np.int64)

        def zeroed(pool):
            return _put_rows(pool, rows_clean, lambda keep, block: torch.zeros(()))

        new["cache"] = {
            "segments": [{k: zeroed(v) for k, v in seg.items()} for seg in dec["cache"]["segments"]],
            "pos": dec["cache"]["pos"],
        }
        return {**states, cell: new}

    pre_tick.tracer = None
    return pre_tick
