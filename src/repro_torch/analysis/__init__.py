"""Static analysis of MISO programs (FX-graph-level, no FLOPs): a port of
``repro.analysis``.

The analyzer traces every cell transition to an FX graph of aten
operators (``make_fx`` over fake tensors made from the ``ShapeDtype``
state specs) and derives:

  * exact read/write sets at pytree-leaf granularity (``access``),
  * contract diagnostics — declared reads sound *and* minimal
    (``contracts``: MISO001 undeclared-read, MISO002 dead-read, ...),
  * parity-hazard lints for the §IV dependability story (``parity``:
    MISO101 replica-variant PRNG, MISO102 order-sensitive accumulation),
  * textual-IR lints on the parsed AST (``ir_lint``: MISO110
    write-at-most-once and friends),
  * a refined dependency DAG with critical-path/width metrics, exported
    as JSON + DOT for the future taskgraph backend (``dag``).

CLI: ``python -m repro_torch.analysis <program> [--json] [--dag-out DIR]``.
See ``docs/analysis.md`` for the code taxonomy and the DAG JSON schema;
the port's codes, messages and exports are the JAX package's.
"""

from .access import CellAccess, OutLeaf, TraceFailure, live_nodes, trace_cell
from .contracts import ProgramAnalysis, analyze_program, check_cell
from .dag import SCHEMA, LeafEdge, RefinedDag, build_dag
from .diagnostics import CODES, Diagnostic, count_by_severity, max_severity
from .ir_lint import lint_source
from .parity import lint_cell
from .registry import FAMILIES, IR_SOURCES, ProgramSpec, registry

__all__ = [
    "CODES",
    "FAMILIES",
    "IR_SOURCES",
    "SCHEMA",
    "CellAccess",
    "Diagnostic",
    "LeafEdge",
    "OutLeaf",
    "ProgramAnalysis",
    "ProgramSpec",
    "RefinedDag",
    "TraceFailure",
    "analyze_program",
    "build_dag",
    "check_cell",
    "count_by_severity",
    "lint_cell",
    "lint_source",
    "live_nodes",
    "max_severity",
    "registry",
    "trace_cell",
]
