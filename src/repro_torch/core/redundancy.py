"""Dependability primitives (paper §IV).

Because a cell's state is written by exactly one transition and read
states are immutable (double buffering), replication is mechanically
identical to data parallelism: give the state a leading *replica axis* R
and run the transition once per replica.

  DMR (level 2): compare the two new states; a mismatch is reported (the
      caller decides between them with a third execution).
  TMR (level 3): bitwise majority vote; mismatching replicas are
      re-synchronized to the voted value, and per-replica mismatch
      counters feed permanent-fault localization.

Every integer result here (mismatch counts, votes, fingerprints, ledger
entries) equals the JAX package's bit for bit.  uint32 wraparound math is
done in int64 with an explicit ``& 0xFFFFFFFF`` because the CPU build of
torch has no uint32 ``+``/``>>``; the same code runs on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import torch

from ..distributed.sharding import Sharded, map_blocks, stack
from ..kernels import ops
from ..kernels.state_hash import M32, MIX, PHI, mul32
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .cell import CellType, restrict_reads, undeclared_read_error
from .fault import FaultSpec, bitcast_back, bitcast_int, inject

Tree = Any

MAX_REPLICAS = 3


# --------------------------------------------------------------------------
# comparison primitives
# --------------------------------------------------------------------------
def _blocks(*xs) -> list:
    """``(block, tensors)`` of ``Sharded`` leaves: each distinct block of
    the first once, with the same member's tensor of the others (or the
    region they hold of it, when their layout differs), so a block that
    several members share is read once."""
    x0 = xs[0]
    out = []
    for blk, t in x0.blocks():
        c = next(c for c in x0.coords() if x0.local(c) is t)
        out.append((blk, (t,) + tuple(
            x.local(c) if tuple(x.spec) == tuple(x0.spec) else x.region(blk, coord=c)
            for x in xs[1:])))
    return out


def bit_mismatch_elems(a: Tree, b: Tree) -> torch.Tensor:
    """Number of elements whose bit patterns differ (float32 scalar).  On
    ``Sharded`` leaves each distinct block is compared once."""
    total = None
    for la, lb in zip(tree_leaves(a), tree_leaves(b)):
        if isinstance(la, Sharded):
            n = None
            for _, (ta, tb) in _blocks(la, lb):
                k = (bitcast_int(ta) != bitcast_int(tb)).sum()
                n = k if n is None else n + k.to(n.device)
            n = n.to(torch.float32)
        else:
            n = (bitcast_int(la) != bitcast_int(lb)).sum(dtype=torch.float32)
        total = n if total is None else total + n.to(total.device)
    return total if total is not None else torch.zeros((), dtype=torch.float32)


def majority_vote(a: Tree, b: Tree, c: Tree) -> Tree:
    """Elementwise bitwise 2-of-3 majority (exact for replicated
    transitions); member by member on ``Sharded`` leaves of one layout."""

    def vote(x, y, z):
        ux, uy, uz = bitcast_int(x), bitcast_int(y), bitcast_int(z)
        v = (ux & uy) | (ux & uz) | (uy & uz)
        return v.to(torch.bool) if x.dtype == torch.bool else bitcast_back(v, x.dtype)

    def leaf(x, y, z):
        if isinstance(x, Sharded):
            return map_blocks(lambda _, *ts: vote(*ts), x, y, z)
        return vote(x, y, z)

    return tree_map(leaf, a, b, c)


_FNV = 16777619


def _words(leaf: torch.Tensor) -> torch.Tensor:
    """int64 of ``leaf``'s shape holding each element's bits as a uint32
    word: narrow types zero-extend, 64-bit types keep their low word (the
    JAX package's ``bitcast_uint(x).astype(uint32)``)."""
    s = bitcast_int(leaf)
    nbytes = s.element_size()
    mask = M32 if nbytes >= 4 else (1 << (8 * nbytes)) - 1
    return s.to(torch.int64) & mask


def _leaf_sums(v: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, 4) int64: the four accumulators' wraparound sums over each
    row of ``v`` (words) weighted by ``idx`` (each word's position in its
    row, broadcast to ``v``), not yet masked."""
    w = (mul32(idx, MIX) + PHI) & M32
    wphi = mul32(w, PHI)
    parts = [mul32(v, w), mul32(v ^ w, MIX), mul32(v ^ wphi, _FNV), ((v + w) & M32) ^ (v >> 7)]
    return torch.stack([x.expand(v.shape).reshape(rows, -1).sum(dim=1) for x in parts], dim=1)


def _sharded_sums(x: Sharded, rows: int, lead: int) -> torch.Tensor:
    """``_leaf_sums`` of a ``Sharded`` leaf from its distinct blocks, each
    word weighted by its *global* position (per-dimension iotas, as the
    JAX package's ``fingerprint`` weights a leaf it never flattens): the
    sums are those of the unsharded leaf, since wraparound sums do not
    depend on order.  ``lead`` is 1 when the leaf leads with ``rows``."""
    inner = tuple(x.shape)[lead:]
    strides = [math.prod(inner[d + 1:]) for d in range(len(inner))]
    acc = torch.zeros((rows, 4), dtype=torch.int64, device=x.device)
    for blk, (t,) in _blocks(x):
        idx = torch.zeros((), dtype=torch.int64, device=t.device)
        for d, (sl, st) in enumerate(zip(blk[lead:], strides)):
            a = torch.arange(sl.start, sl.stop, dtype=torch.int64, device=t.device) * st
            idx = idx + a.reshape([-1 if j == d else 1 for j in range(len(inner))])
        r = blk[0] if lead else slice(0, 1)
        v = _words(t).reshape(r.stop - r.start, *t.shape[lead:])
        acc[r] += _leaf_sums(v, idx & M32, r.stop - r.start).to(acc.device)
    return acc


def _fingerprint(state: Tree, rows: int, lead: int) -> torch.Tensor:
    h = None
    for k, leaf in enumerate(tree_leaves(state)):
        if isinstance(leaf, Sharded):
            sums = _sharded_sums(leaf, rows, lead)
        else:
            v = _words(leaf).reshape(rows, -1)
            idx = torch.arange(v.shape[1], dtype=torch.int64, device=v.device) & M32
            sums = _leaf_sums(v, idx, rows)
        leaf_h = sums & M32
        if h is None:
            h = torch.zeros_like(leaf_h)
        h = mul32(h, _FNV) ^ ((leaf_h.to(h.device) + (k + 1)) & M32)
    if h is None:
        return torch.zeros((rows, 4), dtype=torch.int64)
    return h


def fingerprint_rows(state: Tree, rows: int) -> torch.Tensor:
    """(rows, 4) int64 of uint32 words: the 128-bit ``fingerprint`` of
    each row's view of ``state``, whose leaves all lead with a ``rows``
    axis.  Row r's result equals ``fingerprint`` of the state sliced at
    r (the JAX package's ``vmap(fingerprint)``).  A ``Sharded`` leaf is
    read block by block, each distinct block once, and gives the bits of
    its unsharded value."""
    return _fingerprint(state, rows, 1)


def fingerprint(state: Tree) -> torch.Tensor:
    """128-bit (4 uint32 words, held in int64) order-sensitive fingerprint
    of a state tree: four modular accumulators over position-weighted
    words, chained over leaves with the leaf index as salt.  Bitwise equal
    to ``repro.core.redundancy.fingerprint`` (the per-leaf definition, not
    the flat-stream ``state_hash``); a ``Sharded`` leaf gives the
    fingerprint of its unsharded value."""
    return _fingerprint(state, 1, 0)[0]


# --------------------------------------------------------------------------
# reports
# --------------------------------------------------------------------------
def fingerprint_majority(hs: torch.Tensor):
    """Majority relation over a (3, 4) stack of replica fingerprints.

    Returns ``((eq01, eq02, eq12), idx, per)``: the pairwise equality
    flags, the index of a replica belonging to the majority, and the
    per-replica mismatch indicators (float32)."""
    eq01 = torch.all(hs[0] == hs[1])
    eq02 = torch.all(hs[0] == hs[2])
    eq12 = torch.all(hs[1] == hs[2])
    idx = torch.where(eq01 | eq02, 0, torch.where(eq12, 1, 0))
    per = torch.stack(
        [
            (~(eq01 | eq02)).to(torch.float32),
            (~(eq01 | eq12)).to(torch.float32),
            (~(eq02 | eq12)).to(torch.float32),
        ]
    )
    return (eq01, eq02, eq12), idx, per


def zero_report(device=None) -> dict:
    """A clean report, made where it is to live.  The default is host (CPU)
    tensors, so an unreplicated cell's report never forces a device
    synchronisation in the ledger; a replicated cell's report is made on
    its device directly (a blocking host-to-device copy would be one)."""
    return {
        "mismatch_elems": torch.zeros((), dtype=torch.float32, device=device),
        "events": torch.zeros((), dtype=torch.float32, device=device),
        "per_replica": torch.zeros((MAX_REPLICAS,), dtype=torch.float32, device=device),
    }


# --------------------------------------------------------------------------
# replication helpers
# --------------------------------------------------------------------------
def replica_entry(x, level: int, placement: str = "temporal"):
    """The spec entry of a replicated ``Sharded`` leaf's replica axis, as
    the JAX dry-run lays it (``launch/dryrun.py::train_state_specs``):
    None under temporal placement (each member holds every replica of
    its block), ``"pod"`` under spatial placement (pod p's members hold
    replica p's blocks), which needs a ``pod`` axis whose size divides
    ``level``."""
    if placement != "spatial":
        return None
    pods = x.mesh.shape.get("pod")
    if pods is None or level % pods:
        raise ValueError(
            f"a spatially placed level-{level} state on {x.mesh!r} needs a 'pod' axis "
            f"whose size divides {level}")
    return "pod"


def stack_replicas(reps: list, placement: str = "temporal", *, copy: bool = True) -> Tree:
    """The replicas' trees stacked on a leading replica axis, leaf by
    leaf, each replica's leaf let go once stacked (``reps`` is a list of
    flat leaf lists, emptied as it goes): the peak is the replicas and
    one stacked leaf, not twice the replicas.  A ``Sharded`` leaf keeps
    its layout with the replica entry prepended (``replica_entry``);
    with ``copy=False`` a member that holds one replica takes a view of
    it."""
    stacked = []
    for i in range(len(reps[0])):
        xs = [r[i] for r in reps]
        if isinstance(xs[0], Sharded):
            stacked.append(stack(xs, replica_entry(xs[0], len(xs), placement), copy=copy))
        else:
            stacked.append(torch.stack(xs))
        del xs
        for r in reps:
            r[i] = None
    return stacked


def replicate_state(state: Tree, level: int, placement: str = "temporal") -> Tree:
    """Duplicate the memory contents -> leading replica axis of size
    ``level`` (real copies: replicas are written independently).  A
    ``Sharded`` leaf is copied member by member into its replicated
    layout (``replica_entry``)."""
    if level == 1:
        return state
    leaves, treedef = tree_flatten(state)
    return tree_unflatten(treedef, stack_replicas([list(leaves) for _ in range(level)], placement))


def canonical_state(state: Tree, level: int) -> Tree:
    """The agreed single view of a replicated state (replica 0)."""
    if level == 1:
        return state
    return tree_map(lambda x: x[0], state)


def _canonical_reads(
    cell: CellType, prevs: Mapping[str, Tree], levels: Mapping[str, int]
) -> dict:
    """Reads with cells replicated at a *different* level canonicalized."""
    R = cell.redundancy.level
    canon = {}
    for name, val in restrict_reads(cell, prevs).items():
        lr = levels.get(name, 1)
        canon[name] = canonical_state(val, lr) if lr not in (1, R) else val
    return canon


def _call(cell: CellType, reads: dict) -> Tree:
    try:
        return cell.transition(reads)
    except KeyError as e:  # read of an undeclared cell
        raise undeclared_read_error(
            cell, e.args[0] if e.args else e, tuple(reads)
        ) from None


def replicated_transition(
    cell: CellType,
    prevs: Mapping[str, Tree],
    levels: Mapping[str, int],
    *,
    cell_id: int,
    step: int,
    fault: Optional[FaultSpec] = None,
) -> Tree:
    """The replicated front half of ``run_transition`` (R > 1): one
    transition per replica, reading replica r of every read cell that is
    replicated at the same level (broadcast otherwise), then the armed
    fault.  (The JAX package vmaps over the replica axis; a loop gives
    the same per-replica results.)  ``Sharded`` leaves are laid out with
    the replica entry prepended (``replica_entry``)."""
    R = cell.redundancy.level
    canon = _canonical_reads(cell, prevs, levels)
    outs = []
    for r in range(R):
        reads = {
            name: tree_map(lambda x, r=r: x[r], val) if levels.get(name, 1) == R else val
            for name, val in canon.items()
        }
        leaves, treedef = tree_flatten(_call(cell, reads))
        outs.append(leaves)
    # a Sharded replica is handed to its pod as a view under spatial
    # placement (it is a fresh allocation), stacked member by member else
    new = tree_unflatten(treedef, stack_replicas(outs, cell.redundancy.placement, copy=False))
    if fault is not None:
        new = inject(fault, cell_id=cell_id, step=step, replicated_state=new)
    return new


def run_transition(
    cell: CellType,
    prevs: Mapping[str, Tree],
    levels: Mapping[str, int],
    *,
    cell_id: int,
    step: int,
    fault: Optional[FaultSpec] = None,
    compare_now: bool = True,
) -> tuple[Tree, dict]:
    """Execute one cell transition under its redundancy policy.

    prevs: full program state (replicated cells carry their replica axis).
    Returns (new state for this cell — with replica axis if level>1,
    report)."""
    policy = cell.redundancy
    R = policy.level

    if R == 1:
        new = _call(cell, _canonical_reads(cell, prevs, levels))
        if fault is not None:
            # unprotected cells are still physically strikeable — the flip
            # simply goes undetected (the paper's motivating failure mode).
            # Only the struck leaf takes the replica axis: the others pass
            # through as they are (a sharded cache leaf among them)
            leaves, treedef = tree_flatten(new)
            if (fault.cell_id, fault.step) == (cell_id, step) and 0 <= fault.leaf < len(leaves):
                one = dataclasses.replace(fault, leaf=0)
                x = leaves[fault.leaf]
                lead = stack([x], copy=False) if isinstance(x, Sharded) else x.unsqueeze(0)
                hit = inject(one, cell_id=cell_id, step=step, replicated_state=[lead])
                leaves[fault.leaf] = hit[0][0]
                new = tree_unflatten(treedef, leaves)
        return new, zero_report()

    new = replicated_transition(
        cell, prevs, levels, cell_id=cell_id, step=step, fault=fault
    )
    reps = [tree_map(lambda x, i=i: x[i], new) for i in range(R)]
    device = tree_leaves(new)[0].device
    report = zero_report(device)

    if R == 2:
        if policy.compare == "hash":
            h = torch.stack([fingerprint(r) for r in reps])
            diff = (h[0] != h[1]).sum(dtype=torch.float32)
        else:
            diff = bit_mismatch_elems(reps[0], reps[1])
        if not compare_now:
            diff = torch.zeros_like(diff)
        report["mismatch_elems"] = diff
        report["events"] = (diff > 0).to(torch.float32)
        return new, report

    # R == 3: correction by vote; the replicas are re-synchronized to the
    # voted value (prevents divergence)
    if policy.compare == "hash":
        h = torch.stack([fingerprint(r) for r in reps])
        _, idx, per = fingerprint_majority(h)
        out = replicate_state(tree_map(lambda x: x[idx], new), R, policy.placement)
    else:
        # leaf by leaf, each replicated leaf let go once voted and
        # re-replicated: the peak is the replicas and one leaf's vote, not
        # the replicas, the whole vote and its replicas (a TMR trainer's
        # state is tens of GB); the counts add up in leaf order, as
        # bit_mismatch_elems over the whole tree adds them
        del reps
        leaves, treedef = tree_flatten(new)
        del new
        per = torch.zeros((R,), dtype=torch.float32, device=device)
        voted = []
        for i in range(len(leaves)):
            rs = [leaves[i][r] for r in range(R)]
            leaves[i] = None
            v = majority_vote(*rs)
            n = torch.stack([bit_mismatch_elems([r], [v]) for r in rs])
            per = n.to(device) if i == 0 else per + n.to(device)
            del rs
            voted.append(replicate_state(v, R, policy.placement))
            del v
        out = tree_unflatten(treedef, voted)
    if not compare_now:
        per = torch.zeros_like(per)
    report["per_replica"] = (per > 0).to(torch.float32) * torch.clamp(per, min=1.0)
    report["mismatch_elems"] = per.sum()
    report["events"] = (per.sum() > 0).to(torch.float32)
    return out, report


def make_tiebreak(cell: CellType, levels: Mapping[str, int]):
    """Paper §IV DMR recovery: "a third equal transition should be
    executed to decide between the two possible outcomes."  The host calls
    the returned ``tiebreak(prevs, disagreeing)`` with the immutable
    previous program state (double buffering keeps it) and the two
    disagreeing replicas; it returns the repaired replicated state.

    The third transition reads the canonical view of every read cell and
    has no replica axis.  On a CUDA state the 2-of-3 vote over (r0, r1,
    third) is one K4 launch (``kernels.ops.tiebreak_vote``, which lets the
    replicas go once packed, before the third transition runs: a trainer
    state is tens of GB); on the CPU it is ``majority_vote``.  The two are
    bitwise equal.  ``disagreeing`` may be passed as a one-element list,
    which the tie-break empties, to hand over the last reference."""
    def third(prevs):
        canon = {
            name: canonical_state(val, levels.get(name, 1))
            for name, val in restrict_reads(cell, prevs).items()
        }
        return _call(cell, canon)

    def tiebreak(prevs: Mapping[str, Tree], disagreeing) -> Tree:
        box = disagreeing if isinstance(disagreeing, list) else [disagreeing]
        del disagreeing
        if tree_leaves(box[0])[0].device.type == "cuda":
            voted, _counts = ops.tiebreak_vote(box, lambda: third(prevs))
        else:
            pair = box.pop()
            voted = majority_vote(tree_map(lambda x: x[0], pair), tree_map(lambda x: x[1], pair),
                                  third(prevs))
        return replicate_state(voted, cell.redundancy.level, cell.redundancy.placement)

    return tiebreak


# --------------------------------------------------------------------------
# permanent-fault localization (paper: "By identifying MISO cells that are
# frequently erroneous, it is possible to detect permanent failures")
# --------------------------------------------------------------------------
@dataclasses.dataclass
class FaultLedger:
    """Host-side accumulator of per-cell mismatch reports."""

    window: int = 100
    threshold: int = 3
    totals: dict = dataclasses.field(default_factory=dict)
    recent: dict = dataclasses.field(default_factory=dict)
    flagged: set = dataclasses.field(default_factory=set)

    def update(self, step: int, reports: Mapping[str, dict]) -> None:
        for name, rep in reports.items():
            ev = float(rep["events"])
            t = self.totals.setdefault(
                name, {"events": 0.0, "elems": 0.0, "per_replica": [0.0] * 3}
            )
            t["events"] += ev
            t["elems"] += float(rep["mismatch_elems"])
            # per_replica may be shorter than MAX_REPLICAS: the serving
            # engine sizes it to the request's actual level (DMR -> 2)
            pr = [float(x) for x in rep["per_replica"]]
            for i, x in enumerate(pr[:MAX_REPLICAS]):
                t["per_replica"][i] += 1.0 if x > 0 else 0.0
            if ev > 0:
                self.recent.setdefault(name, []).append(step)
                self.recent[name] = [
                    s for s in self.recent[name] if s > step - self.window
                ]
                if len(self.recent[name]) >= self.threshold:
                    self.flagged.add(name)

    def permanent_fault_suspects(self) -> dict:
        """cells (and, under TMR, which replica slot) needing maintenance."""
        out = {}
        for name in self.flagged:
            pr = self.totals[name]["per_replica"]
            # DMR cannot attribute the faulty replica (a two-way
            # disagreement is symmetric); TMR majority voting can.
            worst = (
                max(range(3), key=lambda i: pr[i]) if any(p > 0 for p in pr) else None
            )
            out[name] = {"replica": worst, "events": self.totals[name]["events"]}
        return out
