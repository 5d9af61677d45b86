"""MISO core in PyTorch: cells (paper §II), the textual language and the
dependency graph (§III), runtime-managed replication for dependability
(§IV), and the executors that run a program (lock-step, fused, host,
wavefront, spatial)."""

from .cell import (  # noqa: F401
    NO_REDUNDANCY,
    CellType,
    MisoSemanticsError,
    RedundancyPolicy,
)
from .executor import (  # noqa: F401
    Executor,
    RunResult,
    available_backends,
    compile,
    register_backend,
)
from .fault import FaultSpec, random_fault_campaign  # noqa: F401
from .graph import DependencyGraph  # noqa: F401
from .program import MisoProgram  # noqa: F401
from .redundancy import (  # noqa: F401
    FaultLedger,
    bit_mismatch_elems,
    canonical_state,
    fingerprint,
    majority_vote,
    replicate_state,
)

# registers the fused ``lockstep_cuda`` and the ``spatial_lockstep`` back-ends
from . import backend_cuda  # noqa: F401
from . import backend_spatial  # noqa: F401
from . import ir  # noqa: F401
