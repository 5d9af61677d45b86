"""Contract checking: declared reads sound and minimal (MISO00x/MISO10x).

``analyze_program`` is the analyzer's main entry point for in-memory
:class:`~repro_torch.core.program.MisoProgram` objects: it traces every
cell (:mod:`repro_torch.analysis.access`), derives contract diagnostics,
runs the parity lints (:mod:`repro_torch.analysis.parity`), and builds
the refined DAG (:mod:`repro_torch.analysis.dag`).

Soundness direction: the liveness analysis over-approximates "used", so

  * MISO001 (undeclared read) can never be *missed* — any leaf the
    transition could touch is marked read;
  * MISO002 (dead read) can never be *false* — a read is reported dead
    only when no leaf of it can reach any output, hence deleting it from
    ``reads`` is always behavior-preserving (tested bitwise in
    ``tests/test_torch_analysis_random.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.program import MisoProgram
from ..tree import tree_leaves
from .access import CellAccess, TraceFailure, dtype_name, trace_cell
from .dag import RefinedDag, build_dag
from .diagnostics import Diagnostic
from .parity import lint_cell


@dataclasses.dataclass
class ProgramAnalysis:
    """Everything the analyzer knows about one program."""

    program: str
    accesses: dict[str, CellAccess]
    diagnostics: list[Diagnostic]
    dag: Optional[RefinedDag]

    def to_dict(self) -> dict:
        return {
            "program": self.program,
            "cells": {n: a.to_dict() for n, a in self.accesses.items()},
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "dag": self.dag.to_dict() if self.dag is not None else None,
        }


def check_cell(cell, access: CellAccess, program: str = "") -> list[Diagnostic]:
    """Contract diagnostics for one traced cell (MISO001/002/003/103/104)."""
    diags: list[Diagnostic] = []
    for read in access.undeclared:
        diags.append(
            Diagnostic(
                code="MISO001",
                program=program,
                cell=cell.name,
                message=(
                    f"cell {cell.name!r} reads cell {read!r} "
                    f"({len(access.reads[read])} leaf/leaves) but does not "
                    f"declare it"
                ),
                notes=(
                    f"declared reads: {list(access.declared)} (self-reads "
                    f"are implicit)",
                    f"fix: CellType(name={cell.name!r}, reads=(..., "
                    f"{read!r}))",
                ),
                data={"read": read, "leaves": list(access.reads[read])},
            )
        )
    for read in access.dead_reads:
        diags.append(
            Diagnostic(
                code="MISO002",
                program=program,
                cell=cell.name,
                message=(
                    f"cell {cell.name!r} declares reads={read!r} but "
                    f"consumes none of its leaves"
                ),
                notes=(
                    "a dead read is a false serialization edge: the "
                    "wavefront/taskgraph schedulers order this cell after "
                    f"{read!r} for nothing",
                    f"fix: drop {read!r} from reads — deletion is bitwise "
                    f"behavior-preserving",
                ),
                data={"read": read},
            )
        )
    carried = access.carried_leaves
    if carried:
        n_out = len(access.out_leaves)
        diags.append(
            Diagnostic(
                code="MISO003",
                program=program,
                cell=cell.name,
                message=(
                    f"cell {cell.name!r} carries {len(carried)}/{n_out} "
                    f"output leaf/leaves over unchanged"
                ),
                notes=(
                    "carried leaves are double-buffer copies the taskgraph "
                    "backend can elide (static cells like frozen weights "
                    "are the expected case)",
                ),
                data={"carried": list(carried)},
            )
        )
    return diags


def _structure_diags(cell, access: CellAccess, specs, program: str):
    """MISO103/104: transition output vs own state spec, leafwise."""
    own_flat = tree_leaves(specs[cell.name])
    out = access.out_leaves
    if len(own_flat) != len(out):
        return [
            Diagnostic(
                code="MISO104",
                program=program,
                cell=cell.name,
                message=(
                    f"cell {cell.name!r} transition returns "
                    f"{len(out)} leaves but its state has "
                    f"{len(own_flat)}"
                ),
                data={"state_leaves": len(own_flat), "out_leaves": len(out)},
            )
        ]
    diags = []
    for spec, leaf in zip(own_flat, out):
        if tuple(spec.shape) != leaf.shape or dtype_name(spec.dtype) != leaf.dtype:
            diags.append(
                Diagnostic(
                    code="MISO103",
                    program=program,
                    cell=cell.name,
                    message=(
                        f"cell {cell.name!r} leaf {leaf.path} drifts: "
                        f"state {tuple(spec.shape)}/{dtype_name(spec.dtype)} -> "
                        f"transition {leaf.shape}/{leaf.dtype}"
                    ),
                    notes=(
                        "drift breaks state_hash fingerprints, replica "
                        "comparison, and checkpoint round-trips",
                    ),
                    data={
                        "leaf": leaf.path,
                        "state": [list(spec.shape), dtype_name(spec.dtype)],
                        "out": [list(leaf.shape), leaf.dtype],
                    },
                )
            )
    return diags


def analyze_program(program: MisoProgram, name: str = "") -> ProgramAnalysis:
    """Trace + lint every cell; build the refined DAG when contract-clean."""
    accesses: dict[str, CellAccess] = {}
    diagnostics: list[Diagnostic] = []
    specs = program.state_specs()
    for cname, cell in program.cells.items():
        try:
            access = trace_cell(cell, specs)
        except TraceFailure as e:
            diagnostics.append(
                Diagnostic(
                    code="MISO004",
                    program=name,
                    cell=cname,
                    message=f"cell {cname!r} failed abstract eval: {e}",
                )
            )
            continue
        accesses[cname] = access
        diagnostics.extend(check_cell(cell, access, program=name))
        diagnostics.extend(_structure_diags(cell, access, specs, name))
        diagnostics.extend(lint_cell(cell, access, program=name))

    dag = None
    if len(accesses) == len(program.cells):
        dag = build_dag(program, accesses, name=name)
    return ProgramAnalysis(
        program=name, accesses=accesses, diagnostics=diagnostics, dag=dag
    )
