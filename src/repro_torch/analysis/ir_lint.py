"""Static lints for textual-MISO sources (MISO11x).

The IR runtime enforces §II's write-at-most-once and slot discipline
*during* tracing (``core/ir.py`` raises ``MisoSemanticsError`` from
inside the generated transition).  These lints prove the same properties
on the parsed AST — before any instance exists or any trace runs — so a
bad listing is a compile-time diagnostic, not a buried runtime error:

  * MISO110 — a slot assigned more than once in a transition body;
  * MISO111 — a non-``let`` assignment to a name that is not a declared
    slot (including re-assigning a ``let`` local without ``let``);
  * MISO112 — a transition reads an instance the program never creates.
"""

from __future__ import annotations

from ..core import ir
from .diagnostics import Diagnostic


def lint_source(src: str, program: str = "") -> list[Diagnostic]:
    """Parse ``src`` and lint every cell/instance.  Parse failures are
    reported as MISO004 (the source cannot even be analyzed)."""
    try:
        cells, insts = ir.parse(src)
    except SyntaxError as e:
        return [
            Diagnostic(
                code="MISO004",
                program=program,
                message=f"MISO source failed to parse: {e}",
            )
        ]

    diags: list[Diagnostic] = []
    inst_names = {i.name for i in insts}

    for cdef in cells:
        slots = {v.name for v in cdef.slots}
        written: dict[str, int] = {}
        for stmt in cdef.body:
            if stmt.local:
                continue
            if stmt.target not in slots:
                diags.append(
                    Diagnostic(
                        code="MISO111",
                        program=program,
                        cell=cdef.name,
                        message=(
                            f"cell {cdef.name!r} writes to "
                            f"{stmt.target!r}, which is not a declared "
                            f"slot"
                        ),
                        notes=(
                            f"declared slots: {sorted(slots)}",
                            "use `let` for transition-local variables "
                            "(§II allows them); slots must be declared "
                            "with `var`",
                        ),
                        data={"target": stmt.target},
                    )
                )
                continue
            written[stmt.target] = written.get(stmt.target, 0) + 1
        for slot, n in written.items():
            if n > 1:
                diags.append(
                    Diagnostic(
                        code="MISO110",
                        program=program,
                        cell=cdef.name,
                        message=(
                            f"cell {cdef.name!r} writes slot {slot!r} "
                            f"{n} times in one transition"
                        ),
                        notes=(
                            "§II: all writes go to the *next* state — a "
                            "slot is written at most once per transition",
                            "fold the updates into one assignment (use "
                            "`let` intermediates)",
                        ),
                        data={"slot": slot, "writes": n},
                    )
                )

    celldefs = {c.name: c for c in cells}
    for inst in insts:
        cdef = celldefs.get(inst.cell)
        if cdef is None:
            diags.append(
                Diagnostic(
                    code="MISO112",
                    program=program,
                    cell=inst.name,
                    message=(
                        f"instance {inst.name!r} instantiates unknown "
                        f"cell type {inst.cell!r}"
                    ),
                    data={"cell_type": inst.cell},
                )
            )
            continue
        slots = {v.name for v in cdef.slots}
        reads = ir._extract_reads(cdef.body, slots)
        for read in sorted(reads - inst_names):
            diags.append(
                Diagnostic(
                    code="MISO112",
                    program=program,
                    cell=inst.name,
                    message=(
                        f"instance {inst.name!r} (cell {inst.cell!r}) "
                        f"reads instance {read!r}, which the program "
                        f"never creates"
                    ),
                    notes=(f"known instances: {sorted(inst_names)}",),
                    data={"read": read},
                )
            )
    return diags
