"""The executor layer: one ``compile()`` over the registered back-ends.

    exe = miso.compile(program, backend="lockstep")     # device="cuda"
    states = exe.init(0)                                 # seed or Generator
    result = exe.run(states, n_steps)                    # -> RunResult

Every executor speaks the same protocol as the JAX package's:

    init(generator)              -> states        (replica axes included)
    step(states, ...)            -> (states', reports)
    pure_step(states, t, ...)    -> (states', reports), no side effects
    run(states, n_steps, ...)    -> RunResult(states, reports, collected)
    stream(states[, n_steps])    -> generator of (states', reports)
    metrics()                    -> dict (FaultLedger / compare statistics)

Back-ends: ``lockstep`` (every cell's transition computed from the
previous program state, double-buffered, one Python-level step after
another) and ``lockstep_cuda`` (``core/backend_cuda.py``: the same
schedule with each replicated cell's compare or vote fused into one
kernel).  ``backend="auto"`` picks between them by device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Mapping, Optional

import torch

from ..tree import tree_map
from .fault import FaultSpec
from .program import MisoProgram
from .redundancy import FaultLedger, run_transition

Tree = Any


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; asking for CUDA where there is none raises — nothing falls
    back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


# --------------------------------------------------------------------------
# lock-step step compilation
# --------------------------------------------------------------------------
def compile_step(program: MisoProgram, *, with_compare: bool = True):
    """program -> step(states, step_idx, fault) -> (states', reports).

    Reads always come from the *input* ``states`` (never from the dict
    being built): the paper's read-prev/write-next semantics."""
    levels = program.levels()
    names = list(program.cells)

    def step(states: dict, step_idx: int, fault: Optional[FaultSpec]):
        new_states, reports = {}, {}
        for cid, name in enumerate(names):
            new_states[name], reports[name] = run_transition(
                program.cells[name],
                states,
                levels,
                cell_id=cid,
                step=step_idx,
                fault=fault,
                compare_now=with_compare,
            )
        return new_states, reports

    return step


# --------------------------------------------------------------------------
# fault-argument plumbing
# --------------------------------------------------------------------------
def _as_fault_list(faults) -> list[FaultSpec]:
    if faults is None:
        return []
    if isinstance(faults, FaultSpec):
        return [faults]
    return list(faults)


def _fault_in_window(faults: list, t: int, stride: int):
    """The armed fault whose step falls in [t, t + stride).  A step()
    call threads one FaultSpec, so two strikes in the same window cannot
    both fire."""
    hits = [f for f in faults if t <= int(f.step) < t + stride]
    if len(hits) > 1:
        raise ValueError(
            f"{len(hits)} faults fall in the step window [{t}, {t + stride})"
            " but one step() threads a single FaultSpec; split the campaign"
            " across runs or steps"
        )
    return hits[0] if hits else None


def _to_host(reports: dict) -> dict:
    return tree_map(
        lambda x: x.tolist() if isinstance(x, torch.Tensor) else x, reports
    )


# --------------------------------------------------------------------------
# result type + protocol base
# --------------------------------------------------------------------------
@dataclasses.dataclass
class RunResult:
    """Uniform return of ``Executor.run``.

    states    -- final program state (replica axes included).
    reports   -- per-cell redundancy reports summed over the run.
    collected -- per-step stack of ``collect(states)`` (None if no collect).
    """

    states: dict
    reports: dict
    collected: Any = None


class Executor:
    """Uniform execution protocol over a compiled MISO program.  Construct
    through ``compile(program, backend=...)``, not directly."""

    name: str = "base"

    def __init__(
        self,
        program: MisoProgram,
        *,
        device="cuda",
        compare_every: Optional[int] = None,
        checkpoint_cb: Optional[Callable[[int, dict], None]] = None,
        checkpoint_every: int = 0,
    ):
        self.program = program
        self.device = resolve_device(device)
        self.compare_every = compare_every or 1
        #: ``run``/``stream`` hand the cb the consistent pre-step buffer
        #: every ``checkpoint_every`` steps (double buffering makes the
        #: previous state a snapshot for free)
        self.checkpoint_cb = checkpoint_cb
        self.checkpoint_every = checkpoint_every
        if checkpoint_every and checkpoint_every % self.compare_every != 0:
            raise ValueError(
                "checkpoint_every must be a multiple of compare_every "
                f"(got {checkpoint_every} vs {self.compare_every})"
            )
        self.ledger = FaultLedger()
        self.recoveries: list[tuple[int, str]] = []
        self._t = 0

    # -- state ----------------------------------------------------------
    def init(self, generator: torch.Generator | int = 0) -> dict:
        """Initialize all cell states on the executor's device from a
        ``torch.Generator`` (on that device) or an integer seed."""
        if isinstance(generator, int):
            generator = torch.Generator(device=self.device).manual_seed(generator)
        if generator.device.type != self.device.type:
            raise ValueError(
                f"generator lives on {generator.device}, executor on {self.device}"
            )
        states = self.program.init_states(generator, self.device)
        self._t = 0
        return states

    # -- single transition ----------------------------------------------
    @property
    def step_stride(self) -> int:
        """Transitions one ``step()`` call advances."""
        return self.compare_every

    def step(self, states, *, step_idx=None, fault=None):
        raise NotImplementedError

    def pure_step(self, states, step_idx, fault=None, *, compare=True):
        """Side-effect-free re-execution of one step window from the
        immutable input buffer: no ledger update, no counter advance.
        The paper's §IV "third equal transition"."""
        raise NotImplementedError(f"backend {self.name!r} has no side-effect-free replay")

    # -- n-step execution ------------------------------------------------
    def run(
        self,
        states: dict,
        n_steps: int,
        *,
        start_step: Optional[int] = None,
        faults=None,
        collect: Optional[Callable[[dict], Tree]] = None,
    ) -> RunResult:
        stride = self.step_stride
        if n_steps % stride != 0:
            raise ValueError("n_steps must be a multiple of compare_every")
        start = self._t if start_step is None else int(start_step)
        flist = _as_fault_list(faults)
        totals = None
        collected = [] if collect is not None else None
        for t in range(start, start + n_steps, stride):
            self._maybe_checkpoint(t, states)
            states, rep = self.step(
                states, step_idx=t, fault=_fault_in_window(flist, t, stride)
            )
            totals = rep if totals is None else tree_map(lambda a, b: a + b, totals, rep)
            if collect is not None:
                collected.append(collect(states))
        if collected:
            collected = tree_map(lambda *xs: torch.stack(xs), *collected)
        return RunResult(
            states=states, reports=totals if totals is not None else {}, collected=collected
        )

    # -- serving stream ---------------------------------------------------
    def stream(
        self,
        states: dict,
        n_steps: Optional[int] = None,
        *,
        start_step: Optional[int] = None,
        faults=None,
        swap: Optional[Callable[[int, dict], Optional[dict]]] = None,
    ) -> Iterator[tuple[dict, dict]]:
        """Generator of per-step ``(states, reports)`` — the serving loop.
        ``swap`` is called before every tick with ``(step_idx, states)``; a
        non-None return replaces the resident states from that tick on
        (how the continuous batcher joins/leaves requests between ticks).
        ``n_steps=None`` streams forever (caller breaks)."""
        stride = self.step_stride
        if n_steps is not None and n_steps % stride != 0:
            raise ValueError("n_steps must be a multiple of compare_every")
        start = self._t if start_step is None else int(start_step)
        flist = _as_fault_list(faults)
        t = start
        while n_steps is None or t < start + n_steps:
            if swap is not None:
                swapped = swap(t, states)
                if swapped is not None:
                    states = swapped
            self._maybe_checkpoint(t, states)
            states, rep = self.step(
                states, step_idx=t, fault=_fault_in_window(flist, t, stride)
            )
            yield states, rep
            t += stride

    # -- statistics -------------------------------------------------------
    def metrics(self) -> dict:
        """FaultLedger / compare statistics accumulated so far."""
        return {
            "backend": self.name,
            "steps": self._t,
            "fault_totals": self.ledger.totals,
            "flagged": sorted(self.ledger.flagged),
            "suspects": self.ledger.permanent_fault_suspects(),
            "recoveries": list(self.recoveries),
        }

    def export_metrics(self, registry) -> None:
        """Publish this executor's statistics into a ``MetricsRegistry``."""
        registry.gauge("executor_steps", "transitions executed by the resident executor").set(self._t)
        registry.gauge("executor_recoveries_total", "§IV tie-break recoveries performed").set(len(self.recoveries))
        registry.gauge("executor_flagged_cells", "cells currently flagged by the fault ledger").set(len(self.ledger.flagged))
        registry.gauge("executor_suspect_cells", "cells suspected of a permanent fault").set(len(self.ledger.permanent_fault_suspects()))
        for cell, tot in self.ledger.totals.items():
            safe = "".join(c if c.isalnum() else "_" for c in cell)
            registry.gauge(
                f"executor_fault_events_{safe}",
                f"replica-compare mismatch events attributed to cell {cell}",
            ).set(float(tot["events"]))

    # -- shared internals -------------------------------------------------
    def _maybe_checkpoint(self, t: int, states: dict) -> None:
        if (
            self.checkpoint_cb is not None
            and self.checkpoint_every
            and t % self.checkpoint_every == 0
        ):
            self.checkpoint_cb(t, states)


# --------------------------------------------------------------------------
# back-end registry
# --------------------------------------------------------------------------
BACKENDS: dict[str, type] = {}


def register_backend(name: str):
    """Class decorator: make an Executor subclass reachable through
    ``compile(program, backend=name)``."""

    def deco(cls):
        cls.name = name
        BACKENDS[name] = cls
        return cls

    return deco


def available_backends() -> list[str]:
    return sorted(BACKENDS)


# --------------------------------------------------------------------------
# lock-step back-end
# --------------------------------------------------------------------------
@register_backend("lockstep")
class LockstepExecutor(Executor):
    """Every cell's transition from the previous program state, one step
    after another.  With ``compare_every=k`` one ``step`` advances k
    transitions with replica comparison only on the last."""

    def _compile_step(self, *, with_compare: bool):
        """Step-function factory hook.  Subclasses (the fused
        ``lockstep_cuda`` back-end) swap the per-cell transition/compare
        here; windows, fault threading and ledger attribution are shared."""
        return compile_step(self.program, with_compare=with_compare)

    def __init__(self, program, **kw):
        super().__init__(program, **kw)
        self._step_cmp = self._compile_step(with_compare=True)
        self._step_plain = self._compile_step(with_compare=False)

    def _window(self, states, step_idx: int, fault, compare: bool):
        k = self.compare_every
        for j in range(k - 1):
            states, _ = self._step_plain(states, step_idx + j, fault)
        last = self._step_cmp if compare else self._step_plain
        return last(states, step_idx + k - 1, fault)

    def step(self, states, *, step_idx=None, fault=None):
        t = self._t if step_idx is None else int(step_idx)
        states, reports = self._window(states, t, fault, True)
        # the compare runs on the window's last sub-step: attribute there
        self.ledger.update(t + self.compare_every - 1, _to_host(reports))
        self._t = t + self.compare_every
        return states, reports

    def pure_step(self, states, step_idx, fault=None, *, compare=True):
        """The §IV third execution: replay one step window with no
        ledger/counter side effects.  ``compare=False`` skips the replica
        compare on every sub-step (reports stay zero)."""
        return self._window(states, int(step_idx), fault, compare)


# --------------------------------------------------------------------------
# the front door
# --------------------------------------------------------------------------
def _auto_backend(program: MisoProgram, device: torch.device, compare_every) -> str:
    """The JAX package's ``auto`` rule: wavefront when the read graph has
    more than one independent unit (unless ``compare_every > 1``, which
    only the lock-step back-ends amortize), else the lock-step flavor of
    the device: the fused ``lockstep_cuda`` on a card, ``lockstep`` on
    the CPU (JAX picks ``lockstep`` off the TPU).  The wavefront back-end
    is not ported, so that case raises rather than run another schedule.
    (JAX resolves to its spatial back-end only when given a device mesh
    with a pod axis; this package's ``compile`` takes none, as JAX
    without a mesh.)"""
    units = len(program.graph().independent_groups())
    if units > 1 and not (compare_every and compare_every > 1):
        raise NotImplementedError(
            f"backend='auto' resolves to 'wavefront' for a program of {units} "
            "independent units, and the wavefront back-end is not ported yet "
            "(ROADMAP P13); name a lock-step back-end explicitly"
        )
    return "lockstep_cuda" if device.type == "cuda" else "lockstep"


def compile(
    program: MisoProgram,
    *,
    backend: str = "lockstep",
    device="cuda",
    policies: Optional[Mapping[str, Any]] = None,
    compare_every: Optional[int] = None,
    checkpoint_cb: Optional[Callable[[int, dict], None]] = None,
    checkpoint_every: int = 0,
) -> Executor:
    """Compile a MisoProgram into an Executor — the single front door.

    backend       -- a name registered through ``register_backend``
                     ("lockstep", "lockstep_cuda"), or "auto".
    device        -- "cuda" (default) or "cpu"; CUDA that is not there
                     raises.
    policies      -- optional {cell_name: RedundancyPolicy}: selective
                     replication (§IV) applied before compilation.
    compare_every -- compare replicas every k-th transition.
    checkpoint_cb -- ``(step, states) -> None``: run/stream snapshot the
                     pre-step buffer every ``checkpoint_every`` steps.
    """
    if policies:
        program = program.with_policies(policies)
    device = resolve_device(device)
    if backend == "auto":
        backend = _auto_backend(program, device, compare_every)
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; registered backends: "
            f"{available_backends()}"
        ) from None
    return cls(
        program,
        device=device,
        compare_every=compare_every,
        checkpoint_cb=checkpoint_cb,
        checkpoint_every=checkpoint_every,
    )
