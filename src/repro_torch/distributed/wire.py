"""Cross-member byte accounting: what the port's dry-run reads as the
collective term of its roofline (``launch/dryrun.py``).

The JAX package parses the partitioned HLO for its collectives
(``repro/launch/analysis.py::collective_bytes``).  The port has no HLO:
its model code moves blocks between mesh members itself, so the places
that do so record each movement here, while a ``WireMeter`` is active,
as an operation, the bytes of its result on one member, the size of the
group it runs in and the number of members that receive it.  Each
member's wire bytes are the ring-model factors of ``collective_bytes``'s
docstring (``wire_bytes``); a meter sums them over the members.

The recording sites (each named by ``site``):

  * ``collectives``  -- every function of ``distributed/collectives.py``;
  * ``reshard``      -- ``sharding.reshard``: each member receives the
    part of its new block that its own old block does not hold (an
    all-gather where the new layout joins blocks; nothing where it only
    slices, the local half of a reduce-scatter);
  * ``region``       -- ``Sharded.region``: the bytes assembled from
    blocks other than the asking member's own;
  * ``full``         -- ``Sharded.full``: the controller gathers a leaf
    held as several blocks;
  * ``matmul``       -- ``layers.matmul`` on a weight split over the
    model axis: the output ranges of a column-split weight concatenated
    (an all-gather over the model axis), the f32 partial products of a
    row-split weight summed (an all-reduce over it; a reduce-scatter
    over it into a sequence-parallel residual's layout, whose result is
    the member's sequence block of the partials);
  * ``seq``          -- ``layers.gather``: a sequence-parallel residual
    (``ShardCtx.seq_shard_acts``), normed member by member, gathered
    whole over the model axis in its dtype before the column-parallel
    products of an attention layer, and before a recurrent layer and
    the final norm (an all-gather over the model axis);
  * ``fsdp``         -- a weight split over other axes (FSDP): its block
    gathered over them before ``layers.matmul`` multiplies it (an
    all-gather of the weight, every member), and its gradient
    reduce-scattered over them (``lm_cells._value_and_grad``);
  * ``grad``         -- ``lm_cells._value_and_grad``: the gradient of a
    block that several members hold is the sum of their contributions
    (the data-parallel all-reduce over the members holding it).

Each movement also names the mesh axes its group spans, when the site
knows them: the blocks' spec entries for the ``Sharded`` sites, and the
axes a caller of ``collectives.py`` declares with ``over``.  A group
within the ``model`` axis (at most 8 cards on the production meshes: one
NVLink domain) is ``"nvlink"`` traffic; every other group, and one whose
axes are not known, is ``"network"`` traffic.

Activations live on the controller with the whole batch, so an
activation movement is recorded at the global batch's bytes: summed over
the members, that is the total the same movement moves when the batch
is split over the members that hold the weight, and the dry-run's per
chip figure is the total over the chips (an even split).
"""

from __future__ import annotations

import contextlib
from typing import Optional

#: the ring-model operations of ``collective_bytes``
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

_ACTIVE: list = []
_PAUSED = [0]
_OVER: list = []
MODEL_AXIS = "model"


def wire_bytes(op: str, result_bytes: float, group: int) -> float:
    """One member's wire bytes for ``op`` whose result on the member is
    ``result_bytes``, in a group of ``group`` members (the factors of
    ``repro/launch/analysis.py::collective_bytes``):

      all-reduce         2 x bytes x (S-1)/S
      all-gather         bytes x (S-1)/S      (result is the gathered)
      reduce-scatter     bytes x (S-1)        (result is the shard)
      all-to-all         bytes x (S-1)/S
      collective-permute bytes

    A group of one moves nothing."""
    s = int(group)
    if s <= 1:
        return 0.0
    res = float(result_bytes)
    frac = (s - 1) / s
    if op == "all-reduce":
        return 2.0 * res * frac
    if op == "all-gather":
        return res * frac
    if op == "reduce-scatter":
        return res * (s - 1)
    if op == "all-to-all":
        return res * frac
    if op == "collective-permute":
        return res
    raise ValueError(f"unknown collective {op!r}: one of {OPS}")


class WireMeter:
    """Wire bytes summed over every member, by operation and by site."""

    def __init__(self):
        self.by_op = {op: 0.0 for op in OPS}
        self.by_site: dict = {}
        self.by_link = {"nvlink": 0.0, "network": 0.0}
        self.ops = 0

    @property
    def total(self) -> float:
        return sum(self.by_op.values())

    def add(self, op: str, result_bytes: float, group: int, members: int, site: str,
            axes) -> None:
        w = wire_bytes(op, result_bytes, group) * members
        if w == 0.0:
            return
        self.by_op[op] += w
        self.by_site[site] = self.by_site.get(site, 0.0) + w
        self.by_link[link(axes)] += w
        self.ops += 1

    def to_dict(self) -> dict:
        return {**self.by_op, "ops": self.ops, "total": self.total, "by_site": dict(self.by_site),
                "by_link": dict(self.by_link)}


def link(axes) -> str:
    """``"nvlink"`` for a group within the model axis, else
    ``"network"`` (also when the axes are not known)."""
    if axes is not None and set(axes) <= {MODEL_AXIS}:
        return "nvlink"
    return "network"


@contextlib.contextmanager
def meter(m: Optional[WireMeter] = None):
    """Record every movement made in the block into ``m`` (a new meter
    by default), which the block receives."""
    m = WireMeter() if m is None else m
    _ACTIVE.append(m)
    try:
        yield m
    finally:
        _ACTIVE.remove(m)


@contextlib.contextmanager
def paused():
    """No recording in the block: a site that records its movement as a
    whole calls the sites it is built from in here."""
    _PAUSED[0] += 1
    try:
        yield
    finally:
        _PAUSED[0] -= 1


@contextlib.contextmanager
def over(axes):
    """The mesh axes that the collectives called in the block run over
    (their callers know them; ``collectives.py`` takes member lists)."""
    _OVER.append(tuple(axes) if axes is not None else None)
    try:
        yield
    finally:
        _OVER.pop()


def active() -> bool:
    return bool(_ACTIVE) and not _PAUSED[0]


def record(op: str, result_bytes: float, group: int, *, members: int = 1, site: str,
           axes=()) -> None:
    """One movement: ``members`` members each receive ``op``'s result of
    ``result_bytes`` in a group of ``group`` spanning mesh ``axes``
    (default: the innermost ``over``, else unknown).  Free when no meter
    is active."""
    if not active():
        return
    if axes == ():
        axes = _OVER[-1] if _OVER else None
    for m in _ACTIVE:
        m.add(op, result_bytes, group, members, site, axes)


def spec_axes(*entries) -> tuple:
    """The mesh axes named by spec entries (each None, a name or a tuple)."""
    out = []
    for e in entries:
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            if a not in out:
                out.append(a)
    return tuple(out)


def nbytes(x) -> int:
    """A tensor's (or a tree of tensors') bytes."""
    from ..tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(x))
