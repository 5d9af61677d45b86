"""MisoProgram: a set of cells + the program-level operations of the paper.

The program object is the intermediate representation proper: front-ends
construct a MisoProgram, back-ends (``core/executor.py``) run it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from ..tree import tree_map
from .cell import (
    CellType,
    RedundancyPolicy,
    ShapeDtype,
    abstract_error,
    abstract_eval,
    check_single_output,
    state_spec,
)
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
            states[name] = replicate_state(base, cell.redundancy.level, cell.redundancy.placement)
        return states

    def unreplicated_specs(self, states: Mapping[str, Tree]) -> dict:
        """``ShapeDtype`` skeletons of ``states`` as a transition sees them:
        a replicated cell's leading replica axis stripped."""
        specs = {}
        for name, cell in self.cells.items():
            s = state_spec(states[name])
            if cell.redundancy.level > 1:
                s = tree_map(lambda x: ShapeDtype(x.shape[1:], x.dtype), s)
            specs[name] = s
        return specs

    def state_specs(self, seed: Optional[int] = None) -> dict:
        """Abstract per-transition state specs: ``ShapeDtype`` skeletons of
        every cell's state as a *transition* sees it (replica axes
        stripped).  Each cell's ``init`` runs on fake CPU tensors
        (``cell.abstract_eval``): no FLOPs, no device memory.  This is the
        view the static checks trace transitions against."""
        gen = torch.Generator().manual_seed(0 if seed is None else seed)
        with abstract_eval():
            states = {}
            for name, cell in self.cells.items():
                try:
                    states[name] = state_spec(cell.init(gen, "cpu"))
                except Exception as e:  # noqa: BLE001 -- named and re-raised
                    raise abstract_error(cell, e) from e
        return states

    # -- validation ----------------------------------------------------------
    def validate(self, seed: Optional[int] = None) -> None:
        """Check the MISO §II contract for every cell, abstractly:
        * declared reads exist (graph construction checks this),
        * transitions touch only declared states (KeyError -> semantics error),
        * single-output invariant: state structure is transition-invariant.

        Everything runs on fake CPU tensors, so only the plain branches
        are traced: a kernel wrapper's CUDA branch and the data cell's
        graphed walk are not.  ``chip_smoke.py`` holds each kernel
        against its plain version at the shapes of the main path.
        """
        self.graph()  # validates read targets
        specs = self.state_specs(seed)
        for cell in self.cells.values():
            check_single_output(cell, specs)
