"""Dependency analysis of a MISO program (paper §III).

The read sets of the transition functions *are* the data-flow graph — MISO
makes dependencies explicit, so no pointer/alias analysis is needed.  From
the read graph we derive:

  * strongly connected components (SCCs): cells that (transitively) read each
    other must advance in lock-step with one another;
  * the condensation DAG: SCC -> SCC edges give a producer/consumer partial
    order, i.e. which groups may run ahead of which (wavefront execution,
    "removing the need for a global barrier per transition step");
  * independent components: cells with no direct or indirect dependency in
    either direction — these can run fully asynchronously.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class DependencyGraph:
    """reads[c] = cells whose previous state c's transition consumes."""

    nodes: tuple[str, ...]
    reads: Mapping[str, tuple[str, ...]]

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_cells(cells: Mapping[str, "CellType"]) -> "DependencyGraph":
        nodes = tuple(cells)
        reads = {}
        for name, cell in cells.items():
            missing = [r for r in cell.reads if r not in cells]
            if missing:
                raise ValueError(f"cell {name!r} reads unknown cells {missing}")
            reads[name] = tuple(r for r in cell.reads if r != name)
        return DependencyGraph(nodes=nodes, reads=reads)

    # -- queries -----------------------------------------------------------
    def readers_of(self, name: str) -> tuple[str, ...]:
        return tuple(n for n in self.nodes if name in self.reads[n])

    def sccs(self) -> list[tuple[str, ...]]:
        """Tarjan SCCs in reverse-topological order of the condensation."""
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        out: list[tuple[str, ...]] = []
        counter = [0]

        def strongconnect(v: str):
            # Iterative Tarjan to survive deep graphs.
            work = [(v, 0)]
            while work:
                node, pi = work[-1]
                if pi == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack.add(node)
                recurse = False
                succs = self.reads[node]
                for i in range(pi, len(succs)):
                    w = succs[i]
                    if w not in index:
                        work[-1] = (node, i + 1)
                        work.append((w, 0))
                        recurse = True
                        break
                    elif w in on_stack:
                        low[node] = min(low[node], index[w])
                if recurse:
                    continue
                if low[node] == index[node]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    out.append(tuple(sorted(comp)))
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])

        for v in self.nodes:
            if v not in index:
                strongconnect(v)
        return out

    def condensation(self) -> tuple[list[tuple[str, ...]], dict[int, set[int]]]:
        """(scc_list topo-ordered producers-first, edges scc->sccs it reads)."""
        sccs = self.sccs()  # reverse topological: dependencies come first
        comp_of = {}
        for i, comp in enumerate(sccs):
            for n in comp:
                comp_of[n] = i
        edges: dict[int, set[int]] = {i: set() for i in range(len(sccs))}
        for n in self.nodes:
            for r in self.reads[n]:
                if comp_of[n] != comp_of[r]:
                    edges[comp_of[n]].add(comp_of[r])
        return sccs, edges

    def independent_groups(self) -> list[tuple[str, ...]]:
        """Weakly-connected components: groups with *no* mutual dependency in
        either direction.  Paper §III: these need no synchronization at all."""
        parent = {n: n for n in self.nodes}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        for n in self.nodes:
            for r in self.reads[n]:
                union(n, r)
        groups: dict[str, list[str]] = {}
        for n in self.nodes:
            groups.setdefault(find(n), []).append(n)
        return [tuple(sorted(g)) for g in sorted(groups.values())]

    def topo_stages(self) -> list[tuple[str, ...]]:
        """Stage i may start step t once stages < i finished step t-1 wavefront;
        cells inside a stage are mutually independent *within* the stage.
        (Cycles collapse into a single stage via the condensation.)"""
        sccs, edges = self.condensation()
        depth = {}
        for i, _ in enumerate(sccs):  # reverse-topo: reads come earlier
            depth[i] = 1 + max((depth[j] for j in edges[i]), default=-1)
        stages: dict[int, list[str]] = {}
        for i, comp in enumerate(sccs):
            stages.setdefault(depth[i], []).extend(comp)
        return [tuple(sorted(stages[d])) for d in sorted(stages)]
