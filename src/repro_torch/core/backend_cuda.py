"""Fused lock-step back-end: ``compile(prog, backend="lockstep_cuda")``.

The counterpart of ``repro/core/backend_pallas.py`` (``lockstep_pallas``).
The redundant compare or vote is part of the compiled program, not a
wrapper around it (MISO §IV): each replicated cell's dependability
epilogue is ONE kernel per step (``kernels/fused_step.py``, CUDA on the
card):

  DMR -- K1 ``dmr_compare``: word compare + both replica fingerprints in
         one pass over the replicas' words;
  TMR -- K2 ``tmr_step``: majority vote + per-replica mismatch counts +
         the voted state's fingerprint in one pass, writing the voted
         words into every replica of the next state.

The kernels read the leaves where they lie (``fused_step.plan_segments``:
one segment per leaf at its offset in the padded u32 stream that
``kernels.ops.flatten_replicas`` would build), so no packed copy of the
state is made and the voted state needs no unpacking or re-replication.

The transition, fault injection and read-prev/write-next semantics are
those of ``lockstep`` (``redundancy.replicated_transition`` is shared),
so trajectories and events are bitwise the ``lockstep`` back-end's.  As
in the JAX package, mismatch counters are u32-word-granular (the kernels
compare the packed word stream): equal to element counts for 32-bit
dtypes, coarser for packed bf16, int8 or bool leaves.  So this back-end
equals JAX's ``lockstep_pallas``, and its counts can differ from this
package's ``lockstep``; events never do.

A replicated cell whose state is laid out on a mesh (``Sharded``
leaves) is refused, as JAX's ``lockstep_pallas`` has no mesh path; the
``lockstep`` and ``host`` back-ends run it.

On a CUDA executor the kernels run; on the CPU their plain versions do
(``metrics()["interpret"]`` is True), which the CPU tests hold bitwise
against ``lockstep_pallas`` in Pallas interpret mode.
"""

from __future__ import annotations

import torch

from ..distributed.sharding import Sharded
from ..kernels import ops
from ..kernels.fused_step import dmr_compare, pick_block, tmr_step
from ..tree import tree_leaves
from .executor import LockstepExecutor, register_backend
from .program import MisoProgram
from .redundancy import MAX_REPLICAS, replicated_transition, run_transition, zero_report


def fused_transition(cell, prevs, levels, *, cell_id, step, fault, compare_now: bool = True):
    """One replicated cell transition with the fused epilogue.

    Mirrors ``redundancy.run_transition`` for R > 1 cells: the same
    replicated transition and injection, then one kernel instead of the
    element-wise compare or vote.  Steps without a compare skip the DMR
    kernel entirely and zero the TMR counters (the vote still runs and
    re-synchronizes the replicas every step, as in ``lockstep``)."""
    policy = cell.redundancy
    R = policy.level
    new = replicated_transition(cell, prevs, levels, cell_id=cell_id, step=step, fault=fault)
    layout = ops.word_layout(new, lead=1)
    blk = pick_block(layout.total)
    device = tree_leaves(new)[0].device

    if R == 2:
        if not compare_now:
            return new, zero_report(device)
        diff_words, fps = dmr_compare(new, blk, layout)
        if policy.compare == "hash":
            # what a spatial deployment ships between devices: 2 x 16 bytes
            diff = (fps[0] != fps[1]).sum(dtype=torch.float32)
        else:
            diff = diff_words.to(torch.float32)
        per = torch.zeros((MAX_REPLICAS,), dtype=torch.float32, device=device)
        return new, {"mismatch_elems": diff, "events": (diff > 0).to(torch.float32),
                     "per_replica": per}

    # R == 3: correction by vote; the replicas come back re-synchronized to
    # the voted value (prevents divergence)
    voted, counts, _fp = tmr_step(new, blk, layout)
    per = counts.to(torch.float32)
    if policy.compare == "hash":
        per = (per > 0).to(torch.float32)  # indicators, as lockstep's hash mode
    if not compare_now:
        per = torch.zeros_like(per)
    total = per.sum()
    return voted, {"mismatch_elems": total, "events": (total > 0).to(torch.float32),
                   "per_replica": (per > 0).to(torch.float32) * torch.clamp(per, min=1.0)}


def compile_step_cuda(program: MisoProgram, *, with_compare: bool = True):
    """program -> step(states, step_idx, fault) with the fused epilogue.
    Unreplicated cells, and cells with an empty state, take the plain
    ``run_transition``; each other replicated cell gets one kernel."""
    levels = program.levels()
    names = list(program.cells)

    def step(states: dict, step_idx: int, fault):
        new_states, reports = {}, {}
        for cid, name in enumerate(names):
            cell = program.cells[name]
            if cell.redundancy.level > 1 and any(
                    isinstance(x, Sharded) for x in tree_leaves(states[name])):
                raise NotImplementedError(
                    f"cell {name!r}: lockstep_cuda fuses the epilogue over one word stream "
                    "of the replicas; a replicated state laid out on a mesh (Sharded leaves) "
                    "has no such stream, and JAX's lockstep_pallas "
                    "(src/repro/core/backend_pallas.py) has no mesh path either: use "
                    "backend='lockstep' or 'host'")
            fused = cell.redundancy.level > 1 and ops.word_layout(states[name]).total > 0
            run = fused_transition if fused else run_transition
            new_states[name], reports[name] = run(
                cell, states, levels, cell_id=cid, step=step_idx, fault=fault,
                compare_now=with_compare,
            )
        return new_states, reports

    return step


@register_backend("lockstep_cuda")
class LockstepCudaExecutor(LockstepExecutor):
    """Lock-step schedule with the fused redundancy epilogue.  ``run``,
    ``stream``, ``compare_every``, fault threading and ledger attribution
    are the lockstep back-end's; only the per-cell step differs."""

    def _compile_step(self, *, with_compare: bool):
        return compile_step_cuda(self.program, with_compare=with_compare)

    def metrics(self) -> dict:
        m = super().metrics()
        m["interpret"] = self.device.type == "cpu"  # the plain versions run
        return m
