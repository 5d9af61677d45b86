"""Refined dependency DAG: leaf-level edges, cell condensation, metrics.

The declared ``CellType.reads`` give the *coarse* graph the wavefront
scheduler runs today.  The analyzer's leaf-granular access sets refine
it: an edge ``reader -> read`` survives only when at least one leaf of
``read``'s state is actually consumed, and each surviving edge carries
the exact leaf list.  Dead declared reads disappear — they were false
serialization edges.

The export (JSON schema ``miso-analysis-dag/v1`` + Graphviz DOT) is the
input contract for the ROADMAP's ``taskgraph`` executor: per-cell task
nodes, leaf-level data edges for buffer-precise hazard tracking, and the
condensation/critical-path metrics that bound achievable parallelism.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Mapping

from ..core.graph import DependencyGraph
from ..core.program import MisoProgram
from ..tree import tree_leaves
from .access import CellAccess

SCHEMA = "miso-analysis-dag/v1"


@dataclasses.dataclass(frozen=True)
class LeafEdge:
    reader: str  # consuming cell
    cell: str  # produced cell
    leaf: str  # leaf path within the produced cell's state


@dataclasses.dataclass
class RefinedDag:
    """The analyzer's refined data-flow graph for one program."""

    program: str
    #: name -> (instances, redundancy level, #state leaves, state bytes)
    cells: dict[str, dict]
    leaf_edges: tuple[LeafEdge, ...]
    #: refined cell-level reads: only edges with >= 1 consumed leaf
    refined_reads: dict[str, tuple[str, ...]]
    declared_reads: dict[str, tuple[str, ...]]
    dead_reads: dict[str, tuple[str, ...]]

    def graph(self) -> DependencyGraph:
        """The refined graph as a core DependencyGraph (condensation,
        stages, and the schedulers' queries come for free)."""
        return DependencyGraph(nodes=tuple(self.cells), reads=dict(self.refined_reads))

    def metrics(self) -> dict:
        """Parallelism metrics of the refined graph.

        critical_path -- wavefront depth (number of topo stages);
        width         -- widest stage (max cells runnable concurrently);
        mean_parallelism -- cells / critical_path (average concurrency a
                            perfect scheduler sustains).
        """
        g = self.graph()
        stages = g.topo_stages()
        n = len(self.cells)
        depth = max(len(stages), 1) if n else 0
        width = max((len(s) for s in stages), default=0)
        return {
            "n_cells": n,
            "n_leaf_edges": len(self.leaf_edges),
            "n_cell_edges": sum(len(r) for r in self.refined_reads.values()),
            "n_dead_edges": sum(len(r) for r in self.dead_reads.values()),
            "critical_path": depth if n else 0,
            "width": width,
            "mean_parallelism": (n / depth) if n else 0.0,
        }

    def to_dict(self) -> dict:
        sccs, edges = self.graph().condensation()
        return {
            "schema": SCHEMA,
            "program": self.program,
            "cells": [{"name": name, **info} for name, info in self.cells.items()],
            "leaf_edges": [dataclasses.asdict(e) for e in self.leaf_edges],
            "refined_reads": {c: list(r) for c, r in self.refined_reads.items()},
            "declared_reads": {c: list(r) for c, r in self.declared_reads.items()},
            "dead_reads": {c: list(r) for c, r in self.dead_reads.items()},
            "condensation": {
                "sccs": [list(c) for c in sccs],
                "edges": {str(i): sorted(js) for i, js in edges.items()},
            },
            "metrics": self.metrics(),
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def to_dot(self) -> str:
        """Graphviz DOT: solid edges = refined (leaf-count labelled),
        dashed grey edges = declared-but-dead."""
        lines = [
            "digraph miso {",
            "  rankdir=LR;",
            '  node [shape=box, fontname="monospace"];',
        ]
        for name, info in self.cells.items():
            label = (
                f"{name}\\n{info['n_state_leaves']} leaves, "
                f"{_human_bytes(info['state_bytes'])}"
            )
            extra = ""
            if info["redundancy_level"] > 1:
                extra = ", peripheries=2"
                label += f"\\nx{info['redundancy_level']} replicas"
            lines.append(f'  "{name}" [label="{label}"{extra}];')
        n_by_edge: dict[tuple[str, str], int] = {}
        for e in self.leaf_edges:
            if e.reader != e.cell:
                n_by_edge[(e.cell, e.reader)] = (
                    n_by_edge.get((e.cell, e.reader), 0) + 1
                )
        for (src, dst), n in sorted(n_by_edge.items()):
            lines.append(f'  "{src}" -> "{dst}" [label="{n}"];')
        for reader, deads in sorted(self.dead_reads.items()):
            for dead in deads:
                lines.append(
                    f'  "{dead}" -> "{reader}" '
                    f'[style=dashed, color=grey, label="dead"];'
                )
        lines.append("}")
        return "\n".join(lines) + "\n"


def _human_bytes(n: int) -> str:
    if n <= 0:
        return "0B"
    units = ["B", "KiB", "MiB", "GiB"]
    i = min(int(math.log(n, 1024)), len(units) - 1)
    val = n / 1024**i
    return f"{val:.0f}{units[i]}" if i == 0 else f"{val:.1f}{units[i]}"


def build_dag(
    program: MisoProgram,
    accesses: Mapping[str, CellAccess],
    name: str = "",
) -> RefinedDag:
    """Condense leaf-granular access sets into the refined program DAG.

    Refined edges are intersected with the *declared* reads: an
    undeclared read (MISO001, an error elsewhere) must not leak into the
    graph handed to schedulers as if it were a sanctioned dependency.
    """
    specs = program.state_specs()
    cells: dict[str, dict] = {}
    for cname, cell in program.cells.items():
        leaves = tree_leaves(specs[cname])
        nbytes = sum(math.prod(x.shape) * x.dtype.itemsize for x in leaves)
        cells[cname] = {
            "instances": cell.instances,
            "redundancy_level": cell.redundancy.level,
            "n_state_leaves": len(leaves),
            "state_bytes": nbytes,
        }

    leaf_edges: list[LeafEdge] = []
    refined: dict[str, tuple[str, ...]] = {}
    declared: dict[str, tuple[str, ...]] = {}
    dead: dict[str, tuple[str, ...]] = {}
    for cname, access in accesses.items():
        allowed = set(access.declared)
        for read_cell, paths in sorted(access.reads.items()):
            if read_cell == cname or read_cell not in allowed:
                continue
            for p in paths:
                leaf_edges.append(LeafEdge(reader=cname, cell=read_cell, leaf=p))
        refined[cname] = tuple(c for c in access.declared if c in access.reads)
        declared[cname] = access.declared
        dead[cname] = access.dead_reads

    return RefinedDag(
        program=name,
        cells=cells,
        leaf_edges=tuple(leaf_edges),
        refined_reads=refined,
        declared_reads=declared,
        dead_reads=dead,
    )
