"""The executor layer: one ``compile()`` over the registered back-ends.

    exe = miso.compile(program, backend="lockstep")     # device="cuda"
    states = exe.init(0)                                 # seed or Generator
    result = exe.run(states, n_steps)                    # -> RunResult

Every executor speaks the same protocol as the JAX package's:

    init(generator)              -> states        (replica axes included)
    step(states, ...)            -> (states', reports)
    pure_step(states, t, ...)    -> (states', reports), no side effects
    run(states, n_steps, ...)    -> RunResult(states, reports, collected)
    run_campaign(states, n, faults) -> RunResult with a campaign axis
    stream(states[, n_steps])    -> generator of (states', reports)
    metrics()                    -> dict (FaultLedger / compare statistics)

Back-ends:

  * ``lockstep``  -- every cell's transition computed from the previous
    program state, double-buffered, one Python-level step after another.
  * ``lockstep_cuda`` (``core/backend_cuda.py``) -- the same schedule with
    each replicated cell's compare or vote fused into one kernel.
  * ``host``      -- lock-step with the paper's §IV recovery protocol in
    the loop: a DMR mismatch triggers a third tie-breaking execution from
    the immutable previous buffer.
  * ``wavefront`` -- the §III "no global barrier" schedule: the SCC
    condensation of the read graph gives units that advance independently,
    each free-running up to a bounded buffer window ahead of its
    consumers.
  * ``auto``      -- resolves at compile time as the JAX package's does:
    wavefront when the read graph has more than one independent unit,
    else the lock-step flavour of the device (``lockstep_cuda`` on a card,
    ``lockstep`` on the CPU).

``on_event(name, attrs)`` is the observability hook of every back-end:
timed steps, checkpoints, compare mismatches, §IV recoveries and the
wavefront's unit steps.  ``None`` (the default) costs nothing: every
emission site is guarded, so no dicts are made and no clock is read.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import time
from typing import Any, Callable, Iterator, Mapping, Optional

import torch

from ..tree import tree_flatten, tree_map, tree_unflatten
from .fault import FaultSpec
from .program import MisoProgram
from .redundancy import FaultLedger, make_tiebreak, run_transition

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


def _single_fault(faults) -> Optional[FaultSpec]:
    fs = _as_fault_list(faults)
    if len(fs) > 1:
        raise ValueError(
            "this backend threads a single FaultSpec through the compiled "
            f"step (step-gated in-graph); got {len(fs)}.  Use "
            "backend='host' for multi-fault campaigns."
        )
    return fs[0] if fs else None


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


def _on_host(trees: list) -> list:
    """The trees with every CUDA tensor brought to the host in ONE copy,
    so one synchronisation, however many steps and cells they hold (the
    JAX package's single ``device_get`` of a run's reports)."""
    flat = [tree_flatten(t) for t in trees]
    dev = [x for leaves, _ in flat for x in leaves
           if isinstance(x, torch.Tensor) and x.device.type != "cpu"]
    if not dev:
        return trees
    host = iter(torch.cat([x.reshape(-1) for x in dev]).cpu().split([x.numel() for x in dev]))
    return [
        tree_unflatten(td, [
            next(host).to(x.dtype).reshape(x.shape)
            if isinstance(x, torch.Tensor) and x.device.type != "cpu" else x
            for x in leaves
        ])
        for leaves, td in flat
    ]


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


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
        on_event: Optional[Callable[[str, dict], None]] = None,
    ):
        self.program = program
        self.device = resolve_device(device)
        self.compare_every = compare_every or 1
        #: observability hook: ``on_event(name, attrs)`` for timed steps
        #: (``dur_us``, ``dispatch_us``, ``device_us``), checkpoints,
        #: compare mismatches, §IV recoveries and wavefront unit steps.
        #: ``Tracer.executor_hook()`` adapts it into trace events.
        self.on_event = on_event
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
            t0 = time.perf_counter() if self.on_event is not None else None
            states, rep = self.step(
                states, step_idx=t, fault=_fault_in_window(flist, t, stride)
            )
            if t0 is not None:
                # bracket the dispatch AND the device work: the split
                # tells host-bound from device-bound steps apart
                t1 = time.perf_counter()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t2 = time.perf_counter()
                self.on_event("step", {
                    "step": t, "dur_us": (t2 - t0) * 1e6,
                    "dispatch_us": (t1 - t0) * 1e6, "device_us": (t2 - t1) * 1e6,
                })
            totals = rep if totals is None else tree_map(lambda a, b: a + b, totals, rep)
            if collect is not None:
                collected.append(collect(states))
        if collected:
            collected = _stack(collected)
        return RunResult(
            states=states, reports=totals if totals is not None else {}, collected=collected
        )

    # -- multi-fault campaigns --------------------------------------------
    def run_campaign(
        self,
        states: dict,
        n_steps: int,
        faults,
        *,
        start_step: Optional[int] = None,
        collect: Optional[Callable[[dict], Tree]] = None,
    ) -> RunResult:
        """Run the SAME trajectory once per armed ``FaultSpec``: a fault
        campaign.  States, reports and collected carry a leading campaign
        axis of size ``len(faults)``.  Campaigns are analysis: no
        FaultLedger entries, no step-counter advance (the ``pure_step``
        contract, batched).  A host loop of ``pure_step`` on every
        back-end (the JAX package's lock-step flavours vmap it into one
        dispatch; the outputs are the same)."""
        flist = _as_fault_list(faults)
        if not flist:
            raise ValueError("run_campaign needs at least one FaultSpec")
        stride = self.step_stride
        if n_steps % stride != 0:
            raise ValueError("n_steps must be a multiple of compare_every")
        start = self._t if start_step is None else int(start_step)
        finals, totals_all, coll_all = [], [], []
        for fault in flist:
            st, totals = states, None
            coll = [] if collect is not None else None
            for t in range(start, start + n_steps, stride):
                st, rep = self.pure_step(st, t, _fault_in_window([fault], t, stride))
                totals = rep if totals is None else tree_map(lambda a, b: a + b, totals, rep)
                if collect is not None:
                    coll.append(collect(st))
            finals.append(st)
            totals_all.append(totals)
            if collect is not None:
                coll_all.append(_stack(coll))
        return RunResult(
            states=_stack(finals),
            reports=_stack(totals_all),
            collected=_stack(coll_all) if collect is not None else None,
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
            t0 = time.perf_counter() if self.on_event is not None else None
            self.checkpoint_cb(t, states)
            if t0 is not None:
                self.on_event("checkpoint", {
                    "step": t, "dur_us": (time.perf_counter() - t0) * 1e6,
                })

    def _ledger_update(self, step: int, reports: dict) -> None:
        host = _to_host(reports)
        self.ledger.update(step, host)
        if self.on_event is not None:
            self._emit_mismatches(step, host)

    def _emit_mismatches(self, step: int, host_reports: dict) -> None:
        """Surface replica-compare disagreements (caller guards on
        ``on_event``): one event per cell that detected any this step."""
        for name, rep in host_reports.items():
            ev = rep.get("events") if isinstance(rep, dict) else None
            if ev is not None and int(ev) > 0:
                self.on_event("compare_mismatch", {
                    "step": int(step), "cell": name, "events": int(ev),
                })


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
        self._ledger_update(t + self.compare_every - 1, reports)
        self._t = t + self.compare_every
        return states, reports

    def pure_step(self, states, step_idx, fault=None, *, compare=True):
        """The §IV third execution: replay one step window with no
        ledger/counter side effects.  ``compare=False`` skips the replica
        compare on every sub-step (reports stay zero)."""
        return self._window(states, int(step_idx), fault, compare)


# --------------------------------------------------------------------------
# host back-end: §IV recovery protocol in the loop
# --------------------------------------------------------------------------
@register_backend("host")
class HostExecutor(Executor):
    """Lock-step with the paper's §IV recovery in the host loop.

    Every step's reports come to the host (one copy); a DMR cell whose
    replicas disagree is repaired by a third transition from the immutable
    previous buffer, voted 2-of-3 with the two replicas
    (``redundancy.make_tiebreak``: K4 on a card), and ``(step, cell)`` is
    appended to ``recoveries``.  Extra option: ``ledger`` (a FaultLedger
    to accumulate into).  The JAX package's ``jit=`` option has no meaning
    for eager torch and is not accepted.  ``run`` takes a list of
    FaultSpecs, one armed strike per step.
    """

    def __init__(self, program, *, ledger: Optional[FaultLedger] = None, **kw):
        super().__init__(program, **kw)
        if self.compare_every != 1:
            raise ValueError(
                "backend='host' compares every step (the §IV protocol needs "
                "per-step reports); use backend='lockstep' for "
                "compare_every amortization"
            )
        if ledger is not None:
            self.ledger = ledger
        self._step = compile_step(program)
        self._step_nocmp = None  # lazy: pure_step(compare=False)
        levels = program.levels()
        self._tiebreakers = {
            name: make_tiebreak(cell, levels)
            for name, cell in program.cells.items()
            if cell.redundancy.level == 2
        }

    def pure_step(self, states, step_idx, fault=None, *, compare=True):
        """Replay one transition with no ledger/recovery side effects (the
        §IV third execution; see ``Executor.pure_step``)."""
        if not compare:
            if self._step_nocmp is None:
                self._step_nocmp = compile_step(self.program, with_compare=False)
            return self._step_nocmp(states, int(step_idx), fault)
        return self._step(states, int(step_idx), fault)

    def step(self, states, *, step_idx=None, fault=None):
        t = self._t if step_idx is None else int(step_idx)
        prev = states  # immutable previous buffer (double buffering)
        states, reports = self._step(prev, t, fault)
        host_reports = _on_host([reports])[0]
        self.ledger.update(t, host_reports)
        if self.on_event is not None:
            self._emit_mismatches(t, host_reports)
        # paper §IV: DMR mismatch -> a third equal transition decides
        for name, rep in host_reports.items():
            cell = self.program.cells[name]
            if cell.redundancy.level == 2 and rep["events"] > 0:
                t0 = time.perf_counter() if self.on_event is not None else None
                states = dict(states)
                # hand the disagreeing replicas over (a list the tie-break
                # empties) so their memory can return before the third
                # transition runs
                states[name] = self._tiebreakers[name](prev, [states.pop(name)])
                if t0 is not None:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    self.on_event("dmr_recovery", {
                        "step": t, "cell": name,
                        "dur_us": (time.perf_counter() - t0) * 1e6,
                    })
                self.recoveries.append((t, name))
        self._t = t + 1
        return states, host_reports


# --------------------------------------------------------------------------
# wavefront back-end (paper §III: no global barrier)
# --------------------------------------------------------------------------
@register_backend("wavefront")
class WavefrontExecutor(Executor):
    """Dependency-aware asynchronous execution.

    Units = SCCs of the read graph.  Unit u may compute its step t+1 as
    soon as every unit it reads has produced step t (it does NOT wait for
    the rest of the program), bounded by ``window`` so producers never run
    more than ``window`` steps ahead of their slowest consumer (bounded
    buffers).  Unit steps are dispatched eagerly on one CUDA stream, so the
    host runs ahead of the card as JAX's async dispatch does; a run's
    reports stay on the device and come to the host in one copy at its end.
    """

    def __init__(self, program, *, window: int = 4, **kw):
        super().__init__(program, **kw)
        if self.compare_every != 1:
            raise ValueError("backend='wavefront' does not amortize "
                             "compares; compare_every must be 1")
        self.window = window
        self.units, self._edges = program.graph().condensation()
        self._unit_of = {n: i for i, comp in enumerate(self.units) for n in comp}
        self._levels = program.levels()
        # external reads per unit
        self._ext_reads: list[set[str]] = [
            {r for n in comp for r in program.cells[n].reads
             if self._unit_of[r] != self._unit_of[n]}
            for comp in self.units
        ]
        self._consumers: dict[int, set[int]] = {i: set() for i in range(len(self.units))}
        for i, deps in self._edges.items():
            for d in deps:
                self._consumers[d].add(i)
        self._unit_step = [self._make_unit_step(i) for i in range(len(self.units))]
        self.trace: list[tuple[int, int]] = []  # (unit, step) order

    def _make_unit_step(self, ui: int):
        cells = [self.program.cells[n] for n in self.units[ui]]
        # the index lockstep gives the cell: a strike lands on the same
        # cell, replica, leaf, word and bit on every back-end
        ids = {c.name: self.program.cell_id(c.name) for c in cells}

        def ustep(own: dict, ext: dict, step_idx: int, fault):
            env = {**own, **ext}
            new, reports = {}, {}
            for cell in cells:
                new[cell.name], reports[cell.name] = run_transition(
                    cell, env, self._levels,
                    cell_id=ids[cell.name], step=step_idx, fault=fault,
                )
            return new, reports

        return ustep

    def step(self, states, *, step_idx=None, fault=None):
        """One globally synchronized transition (all units advance once).
        Read-prev semantics make unit order irrelevant within a step."""
        t = self._t if step_idx is None else int(step_idx)
        new, reports = {}, {}
        for ui in range(len(self.units)):
            own = {n: states[n] for n in self.units[ui]}
            ext = {r: states[r] for r in self._ext_reads[ui]}
            nstates, reps = self._unit_step[ui](own, ext, t, fault)
            new.update(nstates)
            reports.update(reps)
        self._ledger_update(t, reports)
        self._t = t + 1
        return new, reports

    def run(self, states, n_steps, *, start_step=None, faults=None, collect=None):
        if collect is not None:
            raise ValueError(
                "backend='wavefront' advances units out of global step "
                "order, so a per-step collect of the full program state "
                "does not exist; use .stream() for per-step observation")
        if self.checkpoint_cb is not None and self.checkpoint_every:
            raise ValueError(
                "backend='wavefront' has no globally consistent cut "
                "mid-run (units free-run); use .stream(), whose ticks are "
                "globally synchronized, for checkpointing")
        start = self._t if start_step is None else int(start_step)
        fault = _single_fault(faults)
        nU = len(self.units)
        clock = [0] * nU
        # history[name] = deque of (step, state) for produced states
        hist: dict[str, collections.deque] = {
            n: collections.deque([(0, states[n])], maxlen=self.window + 1)
            for n in self.program.cells
        }
        self.trace.clear()
        step_reports: dict[int, dict] = {}  # step -> per-cell reports, on the device

        def ready(ui: int) -> bool:
            t = clock[ui]
            if t >= n_steps:
                return False
            for r in self._ext_reads[ui]:
                if not any(s == t for s, _ in hist[r]):
                    return False  # dependency hasn't produced step t yet
            for k in self._consumers[ui]:
                if t - clock[k] >= self.window:
                    return False  # bounded buffer: don't outrun consumers
            return True

        progressed = True
        while progressed:
            progressed = False
            for ui in range(nU):
                while ready(ui):
                    t = clock[ui]
                    own = {n: next(st for s, st in hist[n] if s == t) for n in self.units[ui]}
                    ext = {r: next(st for s, st in hist[r] if s == t) for r in self._ext_reads[ui]}
                    new, reps = self._unit_step[ui](own, ext, start + t, fault)
                    for n, st in new.items():
                        hist[n].append((t + 1, st))
                    step_reports.setdefault(t, {}).update(reps)
                    clock[ui] = t + 1
                    self.trace.append((ui, t))
                    if self.on_event is not None:
                        # the barrier-free schedule is the observable:
                        # emission order IS the wavefront execution order
                        self.on_event("unit_step", {
                            "unit": ui, "step": t, "lead": max(clock) - min(clock)})
                    progressed = True
        if any(c != n_steps for c in clock):
            raise RuntimeError(f"wavefront deadlock: clocks={clock}")
        # the single host sync, at the end: attribute events to their true
        # step so the ledger's windowed permanent-fault flagging works here too
        steps = sorted(step_reports)
        totals = None
        for t, reps in zip(steps, _on_host([step_reports[t] for t in steps])):
            self._ledger_update(start + t, reps)
            totals = reps if totals is None else tree_map(lambda a, b: a + b, totals, reps)
        self._t = start + n_steps
        final = {n: hist[n][-1][1] for n in self.program.cells}
        return RunResult(states=final, reports=totals or {})

    def max_lead(self) -> int:
        """Largest step-gap between units observed during execution: > 0
        proves barrier-free overlap (paper §III)."""
        lead, clocks = 0, [0] * len(self.units)
        for ui, t in self.trace:
            clocks[ui] = t + 1
            lead = max(lead, max(clocks) - min(clocks))
        return lead

    def metrics(self) -> dict:
        m = super().metrics()
        m["units"] = len(self.units)
        m["max_lead"] = self.max_lead()
        m["window"] = self.window
        return m


# --------------------------------------------------------------------------
# the front door
# --------------------------------------------------------------------------
def _auto_backend(program: MisoProgram, device: torch.device, compare_every) -> str:
    """The JAX package's ``auto`` rule: wavefront when the read graph has
    more than one independent unit (weakly-connected component of the SCC
    condensation), unless ``compare_every > 1``, which only the lock-step
    back-ends amortize; else the lock-step flavour of the device: the
    fused ``lockstep_cuda`` on a card, ``lockstep`` on the CPU (JAX picks
    ``lockstep`` off the TPU).  (JAX resolves to its spatial back-end only
    when given a device mesh with a pod axis; this package's ``compile``
    takes none, as JAX without a mesh.)"""
    if len(program.graph().independent_groups()) > 1 and not (
        compare_every and compare_every > 1
    ):
        return "wavefront"
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
    on_event: Optional[Callable[[str, dict], None]] = None,
    **backend_opts,
) -> Executor:
    """Compile a MisoProgram into an Executor — the single front door.

    backend       -- a name registered through ``register_backend``
                     ("lockstep", "lockstep_cuda", "host", "wavefront"),
                     or "auto".
    device        -- "cuda" (default) or "cpu"; CUDA that is not there
                     raises.
    policies      -- optional {cell_name: RedundancyPolicy}: selective
                     replication (§IV) applied before compilation.
    compare_every -- compare replicas every k-th transition (lock-step
                     back-ends only).
    checkpoint_cb -- ``(step, states) -> None``: run/stream snapshot the
                     pre-step buffer every ``checkpoint_every`` steps (the
                     wavefront back-end on ``stream`` only).
    on_event      -- ``(name, attrs) -> None`` observability hook: timed
                     steps, checkpoints, compare mismatches, §IV
                     recoveries, wavefront unit steps.
                     ``Tracer.executor_hook()`` (obs/trace.py) adapts it
                     into trace events.  None allocates nothing and reads
                     no clocks.
    backend_opts  -- forwarded to the back-end (host: ledger; wavefront:
                     window).  Under "auto", options the resolved
                     back-end does not take are dropped.
    """
    if policies:
        program = program.with_policies(policies)
    device = resolve_device(device)
    auto = backend == "auto"
    if auto:
        backend = _auto_backend(program, device, compare_every)
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; registered backends: "
            f"{available_backends()}"
        ) from None
    if auto and backend_opts:
        # auto may resolve to any back-end, so hints for the others
        # (window= when lockstep wins) are dropped, not fatal
        accepted = set(inspect.signature(cls.__init__).parameters)
        backend_opts = {k: v for k, v in backend_opts.items() if k in accepted}
    return cls(
        program,
        device=device,
        compare_every=compare_every,
        checkpoint_cb=checkpoint_cb,
        checkpoint_every=checkpoint_every,
        on_event=on_event,
        **backend_opts,
    )
