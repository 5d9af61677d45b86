"""Spatial serving: cross-pod strike detection and pod-local slot surgery
(a port of ``repro/serving/spatial.py``).

With ``placement="spatial"`` a DMR/TMR request's replica slots sit at the
same slot COLUMN on different mesh pods (pod ``p`` owns global slots
``[p*spp, (p+1)*spp)``), so replica ``r`` of the group anchored at column
``c`` is global slot ``r*spp + c``: the replica index IS the pod index.
Detection is then one collective a tick over the per-pod slot
fingerprints (``distributed/collectives.py``) instead of the host walk:

  DMR -- each pod fingerprints its own slots (128 bits each) and the
         member pods compare them through ``psum_delta``: nonzero exactly
         where the two members disagree, 16 bytes an active column.
  TMR -- one all-gather of the (spp, 4) fingerprint blocks; the majority
         pick runs on the gathered block, so the struck pod is named with
         the temporal engine's [(0,1), (0,2), (1,2)] precedence.

Both compare the same per-slot fingerprints the temporal engine fetches
(``slots.slot_fingerprints``), so spatial and temporal detection agree
event for event.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.redundancy import bit_mismatch_elems
from ..distributed.collectives import all_gather, psum_delta
from ..tree import tree_leaves, tree_map
from .slots import SlotSurgery, read_slot, slot_fingerprints

Tree = Any


def make_detect(mesh, axes: Tree, *, pod_axis: str = "pod", tmr: bool):
    """-> ``detect(dec_parts, lvl) -> (events, struck)``.

    ``dec_parts[p]`` is pod p's slots of the decoder state; ``lvl`` an
    (spp,) int array: the redundancy level of the spatial group anchored
    at each column (0 = none there this tick).  ``events[c]`` is 1 where
    the group at column c diverged; ``struck[c]`` the struck pod for a
    TMR majority verdict, -1 when healthy or not localizable (DMR), -2
    on a TMR triple divergence (all three differ: the replay decides).
    Both are int32 tensors on the controller's device.  The DMR-only
    variant (``tmr=False``) never gathers; the ``tmr=True`` one serves
    mixed DMR+TMR ticks from its one all-gather."""
    home = mesh.home(pod_axis)

    def fingerprints(parts):
        hs = []
        for p, part in enumerate(parts):
            with mesh.on_pod(p, reads=part, axis=pod_axis):
                hs.append(slot_fingerprints(part, axes))  # (spp, 4), pod-local
            mesh.collect(p, hs[-1], pod_axis)
        return hs

    def detect(parts, lvl):
        lvl = torch.as_tensor(np.asarray(lvl, np.int32), device=home)
        hs = fingerprints(parts)
        if tmr:
            g = all_gather(hs)[0]  # (n_pods, spp, 4)
            eq01 = torch.all(g[0] == g[1], dim=-1)
            eq02 = torch.all(g[0] == g[2], dim=-1)
            eq12 = torch.all(g[1] == g[2], dim=-1)
            healthy3 = eq01 & eq02
            # first agreeing pair wins; no pair -> -2 (replay)
            i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=home)  # noqa: E731
            struck3 = torch.where(eq12, i32(0), i32(-2))
            struck3 = torch.where(eq02, i32(1), struck3)
            struck3 = torch.where(eq01, i32(2), struck3)
            struck3 = torch.where(healthy3, i32(-1), struck3)
            ev3 = (lvl == 3) & ~healthy3
            ev2 = (lvl == 2) & ~eq01
            events = (ev2 | ev3).to(torch.int32)
            struck = torch.where(ev3, struck3, i32(-1))
            return events, struck
        # DMR: members 0 and 1 of each group; psum(h) - 2h over the pods
        m2 = [((lvl == 2) & (p < 2)).to(h.device) for p, h in enumerate(hs)]
        hm = [torch.where(m[:, None], h, torch.zeros_like(h)) for m, h in zip(m2, hs)]
        delta = psum_delta(hm)
        # pod 0's verdict is the psum of (mismatch & pod == 0) over the pods
        events = (m2[0] & torch.any(delta[0] != 0, dim=-1)).to(torch.int32).to(home)
        return events, torch.full(lvl.shape, -1, dtype=torch.int32, device=home)

    return detect


def detect_wire_bytes(n_pods: int, spp: int, tmr: bool) -> int:
    """Per-pod per-tick cross-pod payload of one detect call (analytic).
    DMR: the 16-byte-a-column fingerprint psum plus the 4-byte event
    count psum.  TMR: the all-gather delivers every pod's (spp, 4) u32
    block.  On one card nothing crosses a wire: the count is the bytes a
    multi-card mesh would move."""
    if tmr:
        return n_pods * spp * 16
    return spp * 16 + spp * 4


def pod_surgery(base: SlotSurgery, cell: str, mesh, *, spp: int,
                pod_axis: str = "pod", axes: Tree = None) -> SlotSurgery:
    """The engine's slot surgery over a decoder state split across pods
    (``states[cell][p]`` holds pod p's ``spp`` slots): every operation
    runs ``base`` on the owning pod's part with the local slot index,
    issued on that pod's stream, and its result is a new allocation on
    the pod's device (the counterpart of the JAX package's
    ``pin_surgery``, which puts every result back on its sharding).  A
    repair across pods moves one slot between the pods' parts."""
    home = mesh.home(pod_axis)

    def where(slot):
        p, c = divmod(slot, spp)
        return p, c, mesh.pod_device(p, pod_axis)

    def on(st, p, fn, reads=()):
        with mesh.on_pod(p, reads=(reads, st[cell][p]), axis=pod_axis):
            new = fn({**st, cell: st[cell][p]})[cell]
        parts = list(st[cell])
        parts[p] = mesh.collect(p, new, pod_axis)
        return {**st, cell: parts}

    def to(tree, dev):
        return tree_map(lambda x: x if x.device == dev else x.to(dev), tree)

    def join(st, ss, slot, req=None):
        p, c, dev = where(slot)
        return on(st, p, lambda s: base.join(s, to(ss, dev), c, req=req), reads=ss)

    def scrub(st, slot):
        p, c, _ = where(slot)
        return on(st, p, lambda s: base.scrub(s, c))

    def copy(st, src, dst):
        ps, cs, _ = where(src)
        pd, cd, dev = where(dst)
        if ps == pd:
            return on(st, ps, lambda s: base.copy(s, cs, cd))
        moved = read_slot(st[cell][ps], cs, axes)
        return on(st, pd, lambda s: base.join(s, to(moved, dev), cd), reads=moved)

    def adopt(st, other, slot):
        p, c, _ = where(slot)
        return on(st, p, lambda s: base.adopt(s, {cell: other[cell][p]}, c))

    def fingerprints(parts):
        hs = []
        for p, part in enumerate(parts):
            with mesh.on_pod(p, reads=part, axis=pod_axis):
                hs.append(base.fingerprints(part))
            mesh.collect(p, hs[-1], pod_axis)
        return torch.cat([h.to(home) for h in hs])

    def damage(st, a, b):
        pa, ca, _ = where(a)
        pb, cb, _ = where(b)
        if pa == pb:
            return base.damage({**st, cell: st[cell][pa]}, ca, cb)
        sa = read_slot(st[cell][pa], ca, axes)
        sb = to(read_slot(st[cell][pb], cb, axes), tree_leaves(sa)[0].device)
        return float(bit_mismatch_elems(sa, sb))

    def damage_vs(st, other, slot):
        p, c, _ = where(slot)
        return base.damage_vs({**st, cell: st[cell][p]}, {**other, cell: other[cell][p]}, c)

    return dataclasses.replace(base, join=join, scrub=scrub, copy=copy, adopt=adopt,
                               fingerprints=fingerprints, damage=damage, damage_vs=damage_vs)
