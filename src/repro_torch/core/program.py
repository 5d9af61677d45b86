"""MisoProgram: a set of cells + the program-level operations of the paper.

The program object is the intermediate representation proper: front-ends
construct a MisoProgram, back-ends (``core/executor.py``) run it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from .cell import CellType, RedundancyPolicy
from .graph import DependencyGraph
from .redundancy import replicate_state

Tree = Any


@dataclasses.dataclass
class MisoProgram:
    cells: dict[str, CellType] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._ids = {n: i for i, n in enumerate(self.cells)}

    # -- construction ------------------------------------------------------
    def add(self, cell: CellType) -> "MisoProgram":
        if cell.name in self.cells:
            raise ValueError(f"duplicate cell {cell.name!r}")
        self.cells[cell.name] = cell
        self._ids[cell.name] = len(self._ids)
        return self

    def with_policies(self, policies: Mapping[str, RedundancyPolicy]) -> "MisoProgram":
        """Selective replication (§IV): the *same* program under different
        runtime redundancy decisions."""
        out = MisoProgram()
        for name, cell in self.cells.items():
            out.add(cell.with_redundancy(policies.get(name, cell.redundancy)))
        return out

    # -- queries -----------------------------------------------------------
    def cell_id(self, name: str) -> int:
        try:
            return self._ids[name]
        except KeyError:
            raise ValueError(f"{name!r} is not a cell of this program") from None

    def levels(self) -> dict[str, int]:
        return {n: c.redundancy.level for n, c in self.cells.items()}

    def graph(self) -> DependencyGraph:
        return DependencyGraph.from_cells(self.cells)

    # -- state management ---------------------------------------------------
    def init_states(self, generator: torch.Generator, device) -> dict[str, Tree]:
        """Initialize all cell states on ``device``, in program order, from
        one generator; replicated cells get their replica axis here.  (The
        JAX package splits one PRNG key per cell; torch's generator cannot
        reproduce ``jax.random`` bits, so parity tests carry JAX-made
        states over through ``repro_torch.bridge``.)"""
        states = {}
        for name, cell in self.cells.items():
            base = cell.init(generator, device)
            states[name] = replicate_state(base, cell.redundancy.level)
        return states
