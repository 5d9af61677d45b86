"""Coded diagnostics for the MISO static analyzer (rustc-style).

Every finding the analyzer can produce has a stable ``MISOxxx`` code, a
fixed severity, and a one-line title.  The code taxonomy (see
``docs/analysis.md``):

  * ``MISO0xx`` — read/write contract (§II/§III): undeclared reads, dead
    reads, carried-over leaves, trace failures.
  * ``MISO1xx`` — dependability hazards (§IV): replica-variant PRNG,
    order-sensitive accumulation, state-leaf drift.
  * ``MISO11x`` — textual-IR violations (§II): write-at-most-once and
    friends, caught on the AST before anything traces.

Severities gate the CI lane: ``error`` findings make the analyzer exit
nonzero; ``warning``/``info`` never do (unless ``--fail-on warning``).
"""

from __future__ import annotations

import dataclasses

SEVERITY_ORDER = {"info": 0, "warning": 1, "error": 2}

#: code -> (slug, severity, title)
CODES: dict[str, tuple[str, str, str]] = {
    "MISO001": (
        "undeclared-read",
        "error",
        "transition reads a cell missing from its declared reads",
    ),
    "MISO002": (
        "dead-read",
        "warning",
        "declared read never consumed — a false serialization edge",
    ),
    "MISO003": (
        "carried-leaf",
        "info",
        "output leaves carried over bit-for-bit from the previous state",
    ),
    "MISO004": (
        "trace-failure",
        "error",
        "transition failed abstract evaluation",
    ),
    "MISO101": (
        "replica-variant-prng",
        "error",
        "PRNG stream not threaded through replicated state",
    ),
    "MISO102": (
        "order-sensitive-accumulation",
        "warning",
        "accumulation whose order the backend does not fix",
    ),
    "MISO103": (
        "state-leaf-drift",
        "error",
        "state leaf changes shape/dtype across the transition",
    ),
    "MISO104": (
        "output-structure-mismatch",
        "error",
        "transition output structure differs from the cell state",
    ),
    "MISO110": (
        "ir-double-write",
        "error",
        "slot written more than once in a transition (§II: write-at-most-once)",
    ),
    "MISO111": (
        "ir-undeclared-slot-write",
        "error",
        "write to a slot the cell never declared",
    ),
    "MISO112": (
        "ir-unknown-instance-read",
        "error",
        "transition reads an instance the program never created",
    ),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One analyzer finding, renderable as text or JSON."""

    code: str
    message: str
    program: str = ""
    cell: str = ""
    notes: tuple[str, ...] = ()
    data: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")

    @property
    def severity(self) -> str:
        return CODES[self.code][1]

    @property
    def slug(self) -> str:
        return CODES[self.code][0]

    def render(self) -> str:
        """rustc-style rendering::

        error[MISO001]: cell 'trainer' reads undeclared cell 'weights'
          --> serve:gqa::trainer
          = note: declared reads: ['data']
        """
        where = "::".join(p for p in (self.program, self.cell) if p)
        lines = [f"{self.severity}[{self.code}]: {self.message}"]
        if where:
            lines.append(f"  --> {where}")
        for note in self.notes:
            lines.append(f"  = note: {note}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "slug": self.slug,
            "severity": self.severity,
            "program": self.program,
            "cell": self.cell,
            "message": self.message,
            "notes": list(self.notes),
            "data": dict(self.data),
        }


def max_severity(diags) -> str:
    """Highest severity present ('info' when empty)."""
    level = 0
    for d in diags:
        level = max(level, SEVERITY_ORDER[d.severity])
    return {v: k for k, v in SEVERITY_ORDER.items()}[level]


def count_by_severity(diags) -> dict[str, int]:
    out = {"error": 0, "warning": 0, "info": 0}
    for d in diags:
        out[d.severity] += 1
    return out
