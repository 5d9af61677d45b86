"""The spatial back-end: ``compile(prog, backend="spatial_lockstep",
mesh=...)`` (a port of ``repro/core/backend_spatial.py``).

The paper's §IV names two placements for a replicated cell: *temporal*
(the replicas recomputed on the same cores: ``lockstep``,
``lockstep_cuda``, ``host``) and *spatial* ("the calculations may be
performed on different processor cores and the memory contents may be
duplicated").  This back-end makes the spatial one real on a device
mesh (``distributed/mesh.py``): the replica axis of every cell whose
policy says ``placement="spatial"`` is laid on the mesh's ``pod`` axis,
one replica per pod, each in its own allocation on ``pod_device(p)`` for
the whole run, its transition issued on ``pod_stream(p)``.  Detect and
vote are cross-pod collectives (``distributed/collectives.py``):

  DMR, ``compare="hash"``    -- each pod fingerprints its own replica
      (``redundancy.fingerprint``, 128 bits); the compare is
      ``psum_delta``, 16 bytes a pod.
  DMR, ``compare="bitwise"`` -- ``exchange_pytree`` of the word streams,
      then ``bit_mismatch_elems``.
  TMR, ``compare="hash"``    -- an all-gather of the three fingerprints
      picks the majority (``fingerprint_majority``); only on a mismatch
      does the minority pod adopt the majority state (``bcast_pytree``
      from the majority index, decided on the device).  Deciding whether
      to broadcast reads the equality flags on the host: one host
      synchronisation a step and TMR-hash cell, counted in
      ``metrics()["host_syncs"]``.
  TMR, ``compare="bitwise"`` -- the pods' word streams gathered on the
      controller's device and voted there: on a card by one K4 launch
      (``kernels/tmr_vote.py``, the three received streams are its
      inputs), on the CPU by ``majority_vote``.  The per-replica counts
      are ``bit_mismatch_elems`` of the unpacked replicas against the
      vote, element counts as in ``lockstep``'s ledger.  Every pod then
      holds its own copy of the voted state.

Cells that are not placed spatially live once, on the controller's
device (``mesh.home()``, pod 0's): one controller computes them once,
where the JAX package's SPMD body computes them redundantly on every
pod.  Their reads of a spatial cell resolve to pod 0's replica (the
canonical view), or, for a temporal cell replicated at the same level,
to the gathered replica axis, so the temporal pairing holds.

States: ``init`` and ``place`` return the lockstep layout with every
spatial cell's replica axis replaced by a list of R per-pod trees;
``gather(states)`` turns them back into lockstep's ``(R, ...)`` layout.

Everything else -- ``run``/``stream``, ``compare_every`` windows, fault
threading, checkpoints, ledger attribution, ``pure_step`` -- is
inherited from ``LockstepExecutor`` through ``_compile_step``, as in the
JAX package; a strike aimed at global replica r lands on pod r, so the
same ``FaultSpec`` hits the same bit under either placement, and states
and ledgers are bitwise ``lockstep``'s on the parity programs.

Serve mode (``program.spatial_serve``, set by
``ServeConfig(placement="spatial")``): the decoder cell's slot axis is
split over the pods (pod p owns global slots ``[p*spp, (p+1)*spp)``) and
each pod decodes its own slots with the unmodified temporal transition;
detection and repair are the serving engine's (``serving/spatial.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..distributed.collectives import (
    all_gather,
    bcast_pytree,
    exchange_pytree,
    gather_replicas,
    gather_words,
    psum_delta,
)
from ..kernels import ops
from ..kernels.tmr_vote import tmr_vote
from ..tree import tree_flatten, tree_leaves, tree_map
from .cell import abstract_eval, state_spec
from .executor import (
    LockstepExecutor,
    RunResult,
    _as_fault_list,
    _fault_in_window,
    _stack,
    register_backend,
    resolve_device,
)
from .fault import FaultSpec, inject
from .program import MisoProgram
from .redundancy import (
    _call,
    bit_mismatch_elems,
    canonical_state,
    fingerprint,
    fingerprint_majority,
    majority_vote,
    run_transition,
    zero_report,
)

Tree = Any


def spatial_cells(program: MisoProgram) -> dict:
    """{name: cell} for every cell placed spatially (level > 1)."""
    return {
        name: cell
        for name, cell in program.cells.items()
        if cell.redundancy.level > 1 and cell.redundancy.placement == "spatial"
    }


def cell_spec(program: MisoProgram, name: str) -> Tree:
    """The ``ShapeDtype`` skeleton of one cell's (unreplicated) state,
    from its ``init`` on fake tensors: no memory, no FLOPs."""
    with abstract_eval():
        return state_spec(program.cells[name].init(torch.Generator().manual_seed(0), "cpu"))


def state_words(program: MisoProgram, name: str) -> int:
    """u32 words of one replica of a cell's state (0: nothing to place)."""
    return ops._word_layout(
        tuple((tuple(s.shape), s.dtype) for s in tree_leaves(cell_spec(program, name)))).total


def _to(tree: Tree, dev: torch.device) -> Tree:
    return tree_map(lambda x: x if x.device == dev else x.to(dev), tree)


def _own_copy(tree: Tree, dev: torch.device) -> Tree:
    """A copy of ``tree`` in a new allocation on ``dev``."""
    return tree_map(lambda x: x.to(dev, copy=True, memory_format=torch.contiguous_format), tree)


# --------------------------------------------------------------------------
# fault rebasing
# --------------------------------------------------------------------------
def _pod_local_fault(fault: Optional[FaultSpec], p: int) -> Optional[FaultSpec]:
    """The fault as pod ``p`` sees it: a strike on global replica r belongs
    to pod r, whose local replica index is 0; every other pod has none."""
    if fault is None or fault.replica != p:
        return None
    return dataclasses.replace(fault, replica=0)


def _serve_local_fault(
    fault: Optional[FaultSpec], p: int, *, dec_cid: int, leaf_shapes: list,
    leaf_axes: list, spp: int,
) -> Optional[FaultSpec]:
    """The serve-mode fault as pod ``p`` sees it.

    A flat ``index`` into the GLOBAL decoder leaf names one slot: it is
    decomposed against the global leaf shape and its slot coordinate
    gives the owning pod (slot // spp); only that pod keeps the fault.
    Each pod decodes its slots at their global rows of a batch of the
    engine's width (``compile_step_spatial_serve``), so the owner strikes
    the index as it is: the same bit the temporal engine strikes.  (The
    JAX package's pods hold only their ``spp`` rows and recompose the
    index against the pod-local shape.)  Faults on other cells pass
    through to every pod (their states are not split)."""
    if fault is None or fault.cell_id != dec_cid:
        return fault
    if not 0 <= fault.leaf < len(leaf_shapes):
        return fault if p == 0 else None  # strikes no leaf anywhere
    shape, ax = leaf_shapes[fault.leaf], leaf_axes[fault.leaf]
    rem = fault.index
    for d in reversed(range(ax + 1, len(shape))):
        rem //= shape[d]
    return fault if (rem % shape[ax]) // spp == p else None


# --------------------------------------------------------------------------
# the per-step compilers
# --------------------------------------------------------------------------
def _spatial_transition(exe, cell, cid: int, states: dict, step_idx: int, fault,
                        compare_now: bool):
    """One spatially replicated cell transition: per pod on its stream,
    then the cross-pod compare or vote.  Returns (per-pod states, report)."""
    mesh, axis, levels = exe.mesh, exe.pod_axis, exe._levels
    policy = cell.redundancy
    R = policy.level
    home = mesh.home(axis)
    need_hash = policy.compare == "hash" and (compare_now or R == 3)
    parts, hs = [], []
    for p in range(R):
        dev = mesh.pod_device(p, axis)
        reads, shared = {}, {}
        for name in {cell.name, *cell.reads}:
            lr = levels.get(name, 1)
            if name in exe._spatial:
                reads[name] = states[name][p]  # pod-local, same level
                continue
            if lr == R:  # temporal, same level: this pod's replica slot
                val = tree_map(lambda x, p=p: x[p], states[name])
            elif lr != 1:
                val = canonical_state(states[name], lr)
            else:
                val = states[name]
            shared[name] = val
            reads[name] = _to(val, dev)
        # every input is marked as read on the pod's stream (a part the
        # controller's stream allocated too, e.g. after a TMR adoption)
        with mesh.on_pod(p, reads=(shared, reads), axis=axis):
            new = _call(cell, reads)
            f = _pod_local_fault(fault, p)
            if f is not None:  # the strike is physical: ONE pod's replica
                local = inject(f, cell_id=cid, step=step_idx,
                               replicated_state=tree_map(lambda x: x.unsqueeze(0), new))
                new = tree_map(lambda x: x[0], local)
            if need_hash:
                hs.append(fingerprint(new))
        parts.append(new)

    report = zero_report(home)
    if R == 2:
        if not compare_now:
            return parts, report
        for p in range(R):
            mesh.collect(p, (parts[p], hs[p] if hs else None), axis)
        if policy.compare == "hash":
            delta = psum_delta(hs)[0]
            diff = (delta != 0).sum(dtype=torch.float32)
        else:
            diff = bit_mismatch_elems(parts[0], exchange_pytree(parts)[0])
        report["mismatch_elems"] = diff
        report["events"] = (diff > 0).to(torch.float32)
        return parts, report

    # R == 3: the vote runs on every sub-step, so replicas re-synchronize;
    # the counters report only on compare steps (lockstep's semantics)
    for p in range(R):
        mesh.collect(p, (parts[p], hs[p] if hs else None), axis)
    if policy.compare == "hash":
        (eq01, eq02, _), idx, per = fingerprint_majority(all_gather(hs)[0])
        # one read of the flags and the majority index: whether any state
        # moves at all (a clean step moves the 48 fingerprint bytes only)
        healthy, src = torch.stack([(eq01 & eq02).to(idx.dtype), idx]).tolist()
        exe._host_syncs += 1
        if not healthy:
            parts = bcast_pytree(parts, src)
    else:
        g = gather_words(parts, home)  # the received streams, (3, words)
        layout = ops.word_layout(parts[0])
        reps = [ops.unflatten_from_u32(g[r], parts[0], layout=layout) for r in range(3)]
        if home.type == "cuda":
            voted_w, _ = tmr_vote(g[0], g[1], g[2])  # K4
            voted = ops.unflatten_from_u32(voted_w, parts[0], layout=layout)
        else:
            voted = majority_vote(*reps)
            voted_w = ops.flatten_to_u32(voted, layout=layout)
        per = torch.stack([bit_mismatch_elems(r, voted) for r in reps])
        new_parts = []
        for p in range(R):
            dev = mesh.pod_device(p, axis)
            with mesh.on_pod(p, reads=voted_w, axis=axis):
                mine = voted_w.to(dev, copy=True)
            new_parts.append(ops.unflatten_from_u32(mine, parts[0], layout=layout))
        parts = new_parts
    if not compare_now:
        per = torch.zeros_like(per)
    report["per_replica"] = (per > 0).to(torch.float32) * torch.clamp(per, min=1.0)
    report["mismatch_elems"] = per.sum()
    report["events"] = (per.sum() > 0).to(torch.float32)
    return parts, report


def compile_step_spatial(exe, *, with_compare: bool = True):
    """``exe``'s program -> step(states, step_idx, fault) with the spatial
    cells' replicas on the pods (see the module docstring)."""
    program, mesh, axis = exe.program, exe.mesh, exe.pod_axis
    levels, names = exe._levels, list(program.cells)

    def step(states: dict, step_idx: int, fault):
        canon: dict = {}
        gathered: dict = {}

        def canonical_spatial(name):
            # replica 0 lives on pod 0, on the controller's device: every
            # reader of ``name`` this step shares it
            if name not in canon:
                canon[name] = mesh.collect(0, states[name][0], axis)
            return canon[name]

        def gathered_spatial(name):
            # the full replica axis, as pod 0 (on the controller's device)
            # receives it, for a temporal reader at the same level
            if name not in gathered:
                parts = [mesh.collect(p, part, axis) for p, part in enumerate(states[name])]
                gathered[name] = gather_replicas(parts)[0]
            return gathered[name]

        new_states, reports = {}, {}
        for cid, name in enumerate(names):
            cell = program.cells[name]
            if name in exe._spatial:
                new, rep = _spatial_transition(exe, cell, cid, states, step_idx, fault,
                                               with_compare)
            else:
                prevs, lvl = {}, {}
                for r in {name, *cell.reads}:
                    if r in exe._spatial:
                        if cell.redundancy.level == levels[r]:
                            prevs[r], lvl[r] = gathered_spatial(r), levels[r]
                        else:
                            prevs[r], lvl[r] = canonical_spatial(r), 1
                    else:
                        prevs[r], lvl[r] = states[r], levels[r]
                new, rep = run_transition(cell, prevs, lvl, cell_id=cid, step=step_idx,
                                          fault=fault, compare_now=with_compare)
            new_states[name] = new
            reports[name] = rep
        return new_states, reports

    return step


def compile_step_spatial_serve(exe, *, with_compare: bool = True):
    """Serve mode: the temporal per-cell transition on every pod's own
    slots.  The decoder cell's slot axis is split over the pods, and each
    pod runs the ordinary slot-masked decode on its stream; the other
    cells (the weights) run once on the controller's device and every pod
    reads them there (one copy a card).  The step has no collective:
    cross-pod detection is the serving engine's post-tick call
    (``serving/spatial.py``).  The program is the temporal one, bit for
    bit; ``with_compare`` changes nothing (its cells are unreplicated).

    A pod decodes its ``spp`` slots at their global rows of a batch of
    the engine's width, the other rows empty (inactive) ballast, and
    keeps its own rows.  On a card the kernels' launch shapes depend on
    the batch (K5's lane splits, the row reductions' block splits), and
    with them the order of a row's sums: at the engine's width a slot
    gets the temporal engine's bits wherever it is placed, which is what
    makes token parity a gate.  The ballast costs one copy of the pod's
    part in and out a tick and the ballast rows' decode (the weight reads
    of a decode step do not grow with its rows)."""
    program, mesh, axis = exe.program, exe.mesh, exe.pod_axis
    serve = program.spatial_serve
    dec = serve["cell"]
    levels, names = exe._levels, list(program.cells)
    dec_cid = names.index(dec)
    n_pods = mesh.shape[axis]
    spp = serve["n_slots"] // n_pods
    leaf_shapes = [s.shape for s in tree_leaves(cell_spec(program, dec))]
    leaf_axes = tree_leaves(serve["axes"])
    dec_cell = program.cells[dec]

    def widen(part, p):
        # the pod's slots at their global rows of an engine-wide batch
        if n_pods == 1:
            return part

        def one(x, ax):
            shape = list(x.shape)
            shape[ax] = serve["n_slots"]
            full = x.new_zeros(shape)
            full.narrow(ax, p * spp, spp).copy_(x)
            return full

        return tree_map(one, part, serve["axes"])

    def narrow(full, p):
        if n_pods == 1:
            return full
        return tree_map(lambda x, ax: x.narrow(ax, p * spp, spp).clone(
            memory_format=torch.contiguous_format), full, serve["axes"])

    def step(states: dict, step_idx: int, fault):
        new_states, reports = {}, {}
        for cid, name in enumerate(names):
            if name != dec:
                new_states[name], reports[name] = run_transition(
                    program.cells[name], states, levels, cell_id=cid, step=step_idx,
                    fault=fault, compare_now=with_compare)
        parts = []
        others = {n: states[n] for n in dec_cell.reads if n != dec}
        for p, part in enumerate(states[dec]):
            dev = mesh.pod_device(p, axis)
            local = {n: exe._replica_on(n, v, dev) for n, v in others.items()}
            f = _serve_local_fault(fault, p, dec_cid=dec_cid, leaf_shapes=leaf_shapes,
                                   leaf_axes=leaf_axes, spp=spp)
            with mesh.on_pod(p, reads=(others, part), axis=axis):
                local[dec] = widen(part, p)
                new, rep = run_transition(dec_cell, local, levels, cell_id=dec_cid,
                                          step=step_idx, fault=f, compare_now=with_compare)
                new = narrow(new, p)
            parts.append(new)
            if p == 0:
                reports[dec] = rep
        for p in range(n_pods):  # the engine reads every pod's slots next
            mesh.collect(p, parts[p], axis)
        new_states[dec] = parts
        return new_states, reports

    return step


# --------------------------------------------------------------------------
# the back-end
# --------------------------------------------------------------------------
@register_backend("spatial_lockstep")
class SpatialLockstepExecutor(LockstepExecutor):
    """Lock-step schedule with spatially placed replicas (one per pod).

    Requires ``compile(..., mesh=...)`` with a ``pod`` axis (``pod_axis``)
    whose size equals the replication level of every
    ``placement="spatial"`` cell.  The executor runs on the mesh's
    controller device (``mesh.home()``).  ``run``/``stream``,
    ``compare_every``, faults, checkpoints, ledger attribution and
    ``pure_step`` are the lock-step back-end's; ``run_campaign`` returns
    gathered states."""

    def __init__(self, program, *, mesh=None, pod_axis: str = "pod", **kw):
        if mesh is None:
            raise ValueError(
                "backend='spatial_lockstep' places replicas across pods: "
                "compile(..., mesh=...) is required")
        if pod_axis not in mesh.axis_names:
            raise ValueError(
                f"mesh has no {pod_axis!r} axis (axes: {mesh.axis_names}); "
                "spatial replicas need the pod axis to live on")
        spatial = spatial_cells(program)
        serve = getattr(program, "spatial_serve", None)
        if not spatial and serve is None:
            raise ValueError(
                "program has no placement='spatial' replicated cells; "
                "use backend='lockstep' for temporal redundancy")
        n_pods = mesh.shape[pod_axis]
        if serve is not None and serve["n_slots"] % n_pods:
            raise ValueError(
                f"spatial serving needs n_slots={serve['n_slots']} "
                f"divisible by the {pod_axis!r} mesh axis ({n_pods} pods)")
        for name, cell in spatial.items():
            if cell.redundancy.level != n_pods:
                raise ValueError(
                    f"cell {name!r} wants {cell.redundancy.level} spatial "
                    f"replicas but the {pod_axis!r} mesh axis has {n_pods} "
                    "pods; they must match (one replica per pod)")
            if state_words(program, name) == 0:
                raise ValueError(
                    f"cell {name!r} has an empty state; spatial replication "
                    "has nothing to place across pods")
        for p in range(n_pods):
            resolve_device(mesh.pod_device(p, pod_axis))
        self.mesh = mesh
        self.pod_axis = pod_axis
        self._spatial = spatial
        self._serve = serve
        self._levels = program.levels()
        self._host_syncs = 0
        self._replicas: dict = {}
        kw["device"] = mesh.home(pod_axis)
        super().__init__(program, **kw)

    def _compile_step(self, *, with_compare: bool):
        if self._serve is not None:
            return compile_step_spatial_serve(self, with_compare=with_compare)
        return compile_step_spatial(self, with_compare=with_compare)

    # -- placement ----------------------------------------------------------
    def init(self, generator: torch.Generator | int = 0) -> dict:
        """Initialize on the controller's device, then ``place``."""
        return self.place(super().init(generator))

    def place(self, states: dict) -> dict:
        """Lay lockstep-layout ``states`` onto the mesh: each spatial cell's
        replica r (serve mode: the decoder's slots of pod r) is copied into
        a new allocation on pod r's device, on its stream; the other cells
        stay where they are (on the controller's device)."""
        mesh, axis = self.mesh, self.pod_axis
        out = dict(states)
        if self._serve is not None:
            dec, axes = self._serve["cell"], self._serve["axes"]
            n = mesh.shape[axis]
            spp = self._serve["n_slots"] // n
            parts = []
            for p in range(n):
                dev = mesh.pod_device(p, axis)
                with mesh.on_pod(p, reads=states[dec], axis=axis):
                    parts.append(_own_copy(tree_map(
                        lambda x, ax, p=p: x.narrow(ax, p * spp, spp), states[dec], axes), dev))
            out[dec] = parts
        for name in self._spatial:
            parts = []
            for p in range(self.program.cells[name].redundancy.level):
                dev = mesh.pod_device(p, axis)
                with mesh.on_pod(p, reads=states[name], axis=axis):
                    parts.append(_own_copy(tree_map(lambda x, p=p: x[p], states[name]), dev))
            out[name] = parts
        self._t = 0
        return out

    def gather(self, states: dict) -> dict:
        """The lockstep layout of placed ``states``, on the controller's
        device: each spatial cell's per-pod replicas stacked on a leading
        replica axis (serve mode: the decoder's per-pod slots concatenated
        along each leaf's slot axis), every other cell as it is.  This is
        how a caller compares with ``lockstep``'s ``(R, ...)`` states."""
        mesh, axis, home = self.mesh, self.pod_axis, self.mesh.home(self.pod_axis)
        out = dict(states)
        names = list(self._spatial)
        if self._serve is not None:
            names.append(self._serve["cell"])
        for name in names:
            parts = [mesh.collect(p, part, axis) for p, part in enumerate(states[name])]
            if name in self._spatial:
                out[name] = tree_map(lambda *xs: torch.stack([x.to(home) for x in xs]), *parts)
            else:
                out[name] = tree_map(lambda ax, *xs: torch.cat([x.to(home) for x in xs], dim=ax),
                                     self._serve["axes"], *parts)
        return out

    def _replica_on(self, name: str, tree: Tree, dev: torch.device) -> Tree:
        """``tree`` (cell ``name``'s state on the controller's device) as a
        pod on ``dev`` reads it: itself on the controller's card, else one
        copy a card, kept while the state is unchanged (the serve
        program's weights never change)."""
        if dev == self.mesh.home(self.pod_axis):
            return tree
        leaves, _ = tree_flatten(tree)
        hit = self._replicas.get((name, dev))
        if hit is not None and len(hit[0]) == len(leaves) and all(
                a is b for a, b in zip(hit[0], leaves)):
            return hit[1]
        copy = _to(tree, dev)
        self._replicas[(name, dev)] = (leaves, copy)
        return copy

    # -- runs -----------------------------------------------------------------
    def run(self, states: dict, n_steps: int, **kw) -> RunResult:
        """``LockstepExecutor.run``; the returned states are ordered after
        every pod's work, so the caller may read them on the current
        stream."""
        res = super().run(states, n_steps, **kw)
        self._collect_all(res.states)
        return res

    def run_campaign(self, states, n_steps, faults, *, start_step=None, collect=None):
        """``Executor.run_campaign`` with the finals gathered into the
        lockstep layout: states carry a leading campaign axis, then the
        replica axis, as ``lockstep``'s do."""
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
            finals.append(self.gather(st))
            totals_all.append(totals)
            if collect is not None:
                coll_all.append(_stack(coll))
        return RunResult(states=_stack(finals), reports=_stack(totals_all),
                         collected=_stack(coll_all) if collect is not None else None)

    def _collect_all(self, states: dict) -> None:
        names = list(self._spatial)
        if self._serve is not None:
            names.append(self._serve["cell"])
        for name in names:
            for p, part in enumerate(states[name]):
                self.mesh.collect(p, part, self.pod_axis)

    def metrics(self) -> dict:
        m = super().metrics()
        m["placement"] = "spatial"
        m["pod_axis"] = self.pod_axis
        m["n_pods"] = int(self.mesh.shape[self.pod_axis])
        m["host_syncs"] = self._host_syncs
        if self._serve is not None:
            m["slots_per_pod"] = self._serve["n_slots"] // m["n_pods"]
        return m
