"""MISO front door in PyTorch: ``compile()``, ``compile_source()`` and
``serve()``.

    from repro_torch import api as miso

    prog = miso.MisoProgram()
    prog.add(miso.CellType("rod", init, transition))
    exe = miso.compile(prog)                  # runs on cuda; device="cpu"
    result = exe.run(exe.init(0), 100)        # -> RunResult

    prog = miso.compile_source(src)           # the textual MISO language

The same protocol as ``repro.api`` (the JAX reference).  Back-ends:
``lockstep``, ``lockstep_cuda`` (the replicated cells' compare or vote
fused into one CUDA kernel per step), ``host`` (the §IV DMR tie-break in
the loop), ``wavefront`` (§III: independent units advance without a
global barrier), ``spatial_lockstep`` (the replicas of
``placement="spatial"`` cells one a pod of ``compile(..., mesh=...)``'s
mesh, ``distributed.make_mesh``) and ``auto`` (``spatial_lockstep`` when
the mesh can place every spatial cell, else ``wavefront`` for a program
of more than one independent unit, else ``lockstep_cuda`` on a card and
``lockstep`` on the CPU); and the serving engine, its replica slots
temporal or spatial (``EngineConfig(placement="spatial", mesh=...)``),
speculating with ``ServeConfig(spec=SpecConfig(...))``.  ``on_event=`` with
``Tracer().executor_hook()`` traces any executor, and
``EngineConfig(tracer=Tracer())`` the engine.

    exe = miso.compile(prog, backend="auto")  # -> lockstep_cuda on cuda
"""

from .core.backend_cuda import LockstepCudaExecutor  # noqa: F401
from .core.backend_spatial import SpatialLockstepExecutor  # noqa: F401
from .core.cell import NO_REDUNDANCY, CellType, MisoSemanticsError, RedundancyPolicy  # noqa: F401
from .core.executor import (  # noqa: F401
    BACKENDS,
    Executor,
    RunResult,
    available_backends,
    compile,
    register_backend,
)
from .core.fault import FaultSpec, random_fault_campaign  # noqa: F401
from .core.graph import DependencyGraph  # noqa: F401
from .core.ir import compile_source  # noqa: F401
from .core.program import MisoProgram  # noqa: F401
from .core.redundancy import FaultLedger  # noqa: F401
from .models.lm_cells import ServeConfig, SpecConfig  # noqa: F401
from .obs import MetricsRegistry, Tracer  # noqa: F401
from .serving.engine import EngineConfig, EngineParts, ServingEngine


def serve(program, adapter, config=None, *, device="cuda") -> ServingEngine:
    """Compile ``program`` into a continuous-batching ``ServingEngine`` on
    ``device`` (cuda unless the caller asks for the CPU).

    program -- a MisoProgram with a slot-masked decoder cell (the LM:
               ``serving.lm.lm_engine_parts`` returns ``EngineParts``).
    adapter -- the ``SlotAdapter`` describing the slotted cell.
    config  -- an ``EngineConfig`` (backend, queue depth, compare
               cadence, checkpointing, tracer, registry).

    Returns the engine; call ``.start(seed)`` before submitting."""
    return ServingEngine(program, adapter, config, device=device)


__all__ = [
    "BACKENDS",
    "CellType",
    "DependencyGraph",
    "EngineConfig",
    "EngineParts",
    "Executor",
    "FaultLedger",
    "FaultSpec",
    "LockstepCudaExecutor",
    "MetricsRegistry",
    "MisoProgram",
    "MisoSemanticsError",
    "NO_REDUNDANCY",
    "RedundancyPolicy",
    "RunResult",
    "ServeConfig",
    "SpatialLockstepExecutor",
    "SpecConfig",
    "Tracer",
    "available_backends",
    "compile",
    "compile_source",
    "random_fault_campaign",
    "register_backend",
    "serve",
]
