"""MISO cells: state + transition function (paper §II).

A *cell* is the unit of the MISO intermediate language: a named, typed
state and a transition function from the previous program state to the
cell's next state.  The semantic contract from the paper:

    "there can be only writes to the current state, or local variables.
     Reads can be performed from the previous state of either the current
     cell or any other cell."

A transition is a function ``(prev_states: dict[str, tree]) -> new own
state`` that receives only the states it declared in ``reads`` (plus its
own) and must not write into them: the previous buffer is kept intact
for the §IV replay.  States are nested dicts/lists of tensors with the
same keys, shapes and dtypes as in the JAX package.  (The structural
check of ``repro.core.cell.check_single_output`` comes with the analyzer
port.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

Tree = Any
Transition = Callable[[Mapping[str, Tree]], Tree]


class MisoSemanticsError(Exception):
    """A cell violates the MISO §II contract (reads/shape/single-output)."""


@dataclasses.dataclass(frozen=True)
class RedundancyPolicy:
    """Paper §IV: runtime-selected replication level for a cell.

    level      -- 1 = none, 2 = DMR (detect + tie-break), 3 = TMR
                  (detect + majority-vote correction).
    placement  -- "temporal": replicas computed on the same device
                  (cost = level x compute).  "spatial" (replicas on
                  distinct devices) is accepted here for parity with the
                  JAX package; no executor of this package places it yet.
    compare    -- "bitwise": full-state bitwise comparison;
                  "hash": 128-bit fingerprint comparison.
    compare_every -- compare replicas every k-th transition.
    """

    level: int = 1
    placement: str = "temporal"
    compare: str = "bitwise"
    compare_every: int = 1

    def __post_init__(self):
        if self.level not in (1, 2, 3):
            raise ValueError(f"redundancy level must be 1|2|3, got {self.level}")
        if self.placement not in ("temporal", "spatial"):
            raise ValueError(f"bad placement {self.placement!r}")
        if self.compare not in ("bitwise", "hash"):
            raise ValueError(f"bad compare mode {self.compare!r}")
        if self.compare_every < 1:
            raise ValueError("compare_every must be >= 1")


NO_REDUNDANCY = RedundancyPolicy(level=1)


@dataclasses.dataclass(frozen=True)
class CellType:
    """One MISO cell type (paper §II).

    name       -- unique cell name within a program.
    init       -- ``(generator: torch.Generator, device) -> state tree``.
    transition -- ``(prev: dict[name, state]) -> new own state``.  ``prev``
                  contains exactly ``{self.name} | set(reads)``.
    reads      -- names of other cells whose *previous* state the
                  transition may read (self-reads are implicit).
    instances  -- informational SIMD width.
    redundancy -- RedundancyPolicy (paper §IV).
    critical   -- marks the cell for selective replication sweeps.
    """

    name: str
    init: Callable[..., Tree]
    transition: Transition
    reads: tuple[str, ...] = ()
    instances: int = 1
    redundancy: RedundancyPolicy = NO_REDUNDANCY
    critical: bool = False

    def __post_init__(self):
        if not self.name.isidentifier():
            raise ValueError(f"cell name {self.name!r} must be an identifier")
        if self.name in self.reads:
            object.__setattr__(
                self, "reads", tuple(r for r in self.reads if r != self.name)
            )

    def with_redundancy(self, policy: RedundancyPolicy) -> "CellType":
        """Selective replication: same cell, different runtime policy (§IV)."""
        return dataclasses.replace(self, redundancy=policy)


def undeclared_read_error(
    cell: CellType, key: object, available: tuple[str, ...]
) -> MisoSemanticsError:
    """The diagnostic for a transition touching a state it never declared:
    names the offending cell, the undeclared read, and the declared +
    available set."""
    return MisoSemanticsError(
        f"cell {cell.name!r}: transition reads undeclared cell {key!r}.\n"
        f"  declared reads: {list(cell.reads)} (self-reads are implicit)\n"
        f"  available states: {sorted(available)}\n"
        f"  fix: add {key!r} to CellType(name={cell.name!r}, reads=...), or "
        f"delete the access."
    )


def restrict_reads(cell: CellType, states: Mapping[str, Tree]) -> dict:
    """The view of the program state a transition is allowed to see."""
    allowed = {cell.name, *cell.reads}
    return {k: states[k] for k in allowed if k in states}
