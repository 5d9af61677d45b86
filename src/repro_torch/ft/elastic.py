"""Fault tolerance beyond cell replication (a port of
``repro/ft/elastic.py``): fail-stop recovery and straggler mitigation.

What the MISO machinery (``core/redundancy.py``) covers is *silent*
corruption.  A fail-stop (the process or its host dies) is covered by
checkpoints: the ``host`` executor (``compile(prog, backend="host",
checkpoint_cb=ckpt.callback(dir), checkpoint_every=k)``) checkpoints the
immutable previous buffer every k steps; ``elastic_restore`` places the
latest intact checkpoint on a device and ``elastic_resume`` hands it
back to any executor to continue with ``exe.run(states, n,
start_step=step)``.  The data cell's PRNG-keyed stream makes the replay
deterministic, so a resumed run is bitwise an uninterrupted one.

``elastic_restore`` / ``elastic_resume`` re-place the state under a
*new* mesh as the JAX package's do (``new_ctx``, ``pspec_fn``: e.g. a
(2, 4) data x model mesh restored onto (4, 2)); the port also takes a
device in ``new_ctx``'s place, and without ``pspec_fn`` places each leaf
as ``like``'s is (an executor compiled for the new mesh lays its own
``init`` out).

Stragglers: under spatial DMR (``spatial_lockstep``) the two pods compute
identical transitions; ``StragglerPolicy("first_wins")`` lets the runtime
adopt the faster replica's state when the gap exceeds ``slack`` and skip
the compare for that step (the compare deficit is repaid on the next
compare step).  Replica latencies are an input; the steps are real:
``run_with_straggler_policy`` drives an actual ``spatial_lockstep``
executor under the policy's decisions, and ``spatial_strike_report``
sweeps a multi-strike campaign through ``Executor.run_campaign``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from ..checkpoint import ckpt
from ..core.executor import _as_fault_list, _fault_in_window, _on_host
from ..distributed.sharding import ShardCtx, named
from ..tree import tree_map

Tree = Any


def elastic_restore(directory: str, like: Tree, new_ctx=None,
                    pspec_fn: Optional[Callable[[ShardCtx, Tree], Tree]] = None,
                    step: Optional[int] = None):
    """Restore a checkpoint onto a (possibly different) mesh.  Returns
    (states, step).

    ``new_ctx``: a ``ShardCtx``; with a mesh and ``pspec_fn(ctx, like) ->
    PartitionSpec tree`` each leaf is laid out on ``new_ctx.mesh`` by its
    spec (JAX's ``shardings``).  Otherwise each leaf is placed as
    ``like``'s is: ``Sharded`` by its spec and mesh, a tensor on its
    device.  ``new_ctx`` may also be a device (or None: where ``like``'s
    leaves are), every leaf then placed there."""
    if isinstance(new_ctx, ShardCtx):
        shardings = None
        if new_ctx.mesh is not None and pspec_fn is not None:
            shardings = named(new_ctx, pspec_fn(new_ctx, like))
        return ckpt.restore(directory, like, step=step, shardings=shardings)
    states, step = ckpt.restore(directory, like, step=step)
    if new_ctx is not None:
        states = tree_map(lambda x: x.to(new_ctx) if isinstance(x, torch.Tensor) else x, states)
    return states, step


def elastic_resume(directory: str, exe, new_ctx=None, *, generator=None,
                   pspec_fn: Optional[Callable[[ShardCtx, Tree], Tree]] = None,
                   step: Optional[int] = None) -> tuple[Tree, int]:
    """Restore a checkpoint into an executor's state structure, re-placed
    under ``new_ctx`` (see ``elastic_restore``; None: on the executor's
    device, each leaf as ``exe.init`` places it), ready for
    ``exe.run(states, n, start_step=step)``.  The structure comes from
    ``exe.init`` (replica axes, optimizer slots and layout all match the
    policies and mesh ``exe`` was compiled with)."""
    like = exe.init(generator if generator is not None else 0)
    return elastic_restore(directory, like, exe.device if new_ctx is None else new_ctx,
                           pspec_fn=pspec_fn, step=step)


@dataclasses.dataclass
class FailureLog:
    events: list = dataclasses.field(default_factory=list)

    def record(self, step: int, kind: str, detail: str = ""):
        self.events.append({"step": step, "kind": kind, "detail": detail, "t": time.time()})


# --------------------------------------------------------------------------
# stragglers
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    mode: str = "wait"  # wait | first_wins
    slack: float = 1.5  # adopt the fast replica if slow / fast > slack


@dataclasses.dataclass
class StragglerStats:
    adopted_fast: int = 0
    waited: int = 0
    compare_deficit: int = 0  # compares skipped, to be repaid


def simulate_spatial_step(policy: StragglerPolicy, stats: StragglerStats,
                          replica_times: tuple[float, float]) -> str:
    """Decide what the runtime does for one spatially replicated step from
    the replicas' completion times.  Returns 'wait' or 'adopt:<i>'."""
    t0, t1 = replica_times
    slow, fast = max(t0, t1), min(t0, t1)
    fast_idx = int(t1 < t0)
    if policy.mode == "first_wins" and slow / max(fast, 1e-9) > policy.slack:
        stats.adopted_fast += 1
        stats.compare_deficit += 1
        return f"adopt:{fast_idx}"
    stats.waited += 1
    return "wait"


def run_with_straggler_policy(exe, states: Tree, n_steps: int, policy: StragglerPolicy,
                              replica_times, *, faults=None, start_step: int = 0,
                              stats: Optional[StragglerStats] = None,
                              log: Optional[FailureLog] = None):
    """Drive a REAL spatially replicated executor under a straggler policy.

    For each step ``simulate_spatial_step`` decides from the per-replica
    completion times (``replica_times[t]``); the step is an executor
    transition:

      'wait'      -- the full compare step (``exe.step``): strikes are
                     detected and ledger-attributed, and any outstanding
                     compare deficit is repaid (DMR divergence persists,
                     so a strike hidden by an adopted step surfaces here).
      'adopt:<i>' -- the runtime takes the fast replica without waiting
                     for the compare: ``exe.pure_step(..., compare=False)``
                     advances the state with the compare left out, so
                     under spatial placement the controller never waits
                     for the slow pod's stream on that step.

    Returns ``(states, stats, log)``; ``log`` records detect/adopt/repay
    events at their true step."""
    stats = stats if stats is not None else StragglerStats()
    log = log if log is not None else FailureLog()
    flist = _as_fault_list(faults)
    stride = exe.step_stride
    if n_steps % stride != 0:
        raise ValueError("n_steps must be a multiple of compare_every")
    for t in range(start_step, start_step + n_steps, stride):
        times = replica_times[min((t - start_step) // stride, len(replica_times) - 1)]
        decision = simulate_spatial_step(policy, stats, times)
        fault = _fault_in_window(flist, t, stride)
        if decision.startswith("adopt"):
            states, _ = exe.pure_step(states, t, fault, compare=False)
            log.record(t, "adopt", decision.split(":", 1)[1])
            continue
        states, rep = exe.step(states, step_idx=t, fault=fault)
        rep = _on_host([rep])[0]
        detected = [name for name, r in rep.items() if float(r["events"]) > 0]
        for name in detected:
            log.record(t, "detect", name)
        if detected and stats.compare_deficit:
            # a deficit step may have hidden this strike; this compare
            # repays every outstanding skipped compare
            log.record(t, "repay", str(stats.compare_deficit))
        if stats.compare_deficit:
            stats.compare_deficit = 0
    return states, stats, log


def spatial_strike_report(exe, states: Tree, n_steps: int, faults, *,
                          start_step: int = 0) -> list[dict]:
    """Per-strike detect/repair outcomes of a multi-fault campaign from
    real executor trajectories (``exe.run_campaign``): whether any
    replicated cell detected the strike, and whether the detection
    implies in-graph repair (TMR votes correct; DMR only detects -- the
    §IV third execution is the host or serving engine's job)."""
    res = exe.run_campaign(states, n_steps, faults, start_step=start_step)
    reports = _on_host([res.reports])[0]
    levels = {n: c.redundancy.level for n, c in exe.program.cells.items()}
    faults = faults if isinstance(faults, (list, tuple)) else [faults]
    out = []
    for i, fault in enumerate(faults):
        events = {name: float(rep["events"][i]) for name, rep in reports.items()
                  if float(rep["events"][i]) > 0}
        out.append({
            "fault_step": int(fault.step),
            "detected": bool(events),
            "events": events,
            "repaired": bool(events) and all(levels.get(n, 1) == 3 for n in events),
        })
    return out
