"""The dry-run for H100 meshes (a port of ``repro/launch/dryrun.py``):
lay out every (architecture x input shape x mesh) cell on a mesh of up to
512 cards without a card, prove that its sharding is coherent, and
account its memory, FLOPs and wire bytes for the roofline.

Nothing is compiled and nothing is allocated.  The JAX package lowers
each cell with XLA for 512 placeholder devices and reads XLA's analyses;
the port evaluates one step on fake tensors (``core.cell.abstract_mode``)
whose ``Sharded`` leaves are laid out on a mesh of a stand-in device
(every member ``"cpu"``, so blocks that members share are one fake), and
counts what the step does:

  * sharding coherence -- every leaf's spec must divide it on the mesh
    (``sharding.spec_block``), or the cell fails, as in JAX;
  * ``memory`` -- ``argument_gib``: the bytes that member 0 holds of the
    previous state and the inputs, computed exactly from the specs;
    ``output_gib``: what it holds of the next state (and the reports);
    ``alias_gib`` is 0, since the port's executor keeps the previous
    state, which the §IV tie-break reads, and donates nothing;
    ``trainer_member_bytes`` (a train cell) and ``serve_member_bytes``
    (a decode cell, the weights with the decoder): what member 0 holds
    of the state's ``Sharded`` leaves as the port lays them out at run
    time, which ``chip_smoke.mp_layout`` reads on the card;
    ``trainer_spec_bytes``: the same bytes computed from the specs alone
    (every trainer leaf but the metrics, which stay on the controller);
    ``temp_gib``: the peak over the step of the bytes of the fake
    storages the step makes and has not yet freed, less those still live
    at its end (the outputs): the single controller's figure, which
    holds activations for the whole batch and every member's blocks;
  * ``flops`` -- ``torch.utils.flop_counter.FlopCounterMode`` over the
    step: every member's products once, so ``flops_per_chip`` is the
    count divided by the cards (an even split);
  * ``hbm_bytes_unfused`` -- the bytes each dispatched operator reads
    and writes (its tensor arguments and outputs; views skipped; a size
    that depends on data counts 0), an unfused upper bound in the role of XLA's ``bytes accessed``
    (``memory_s`` uses ``analysis.analytic_hbm_bytes``, as JAX's does);
  * ``wire`` -- every cross-member movement the step makes, recorded by
    ``distributed/wire.py`` with the ring-model factors, split into
    NVLink traffic (groups within the ``model`` axis) and network
    traffic; per card, the total over the cards.

The kernels' plain branches run (the fakes are CPU tensors), so no kernel
launches, and an attention's temporaries are its plain version's.

Costs use JAX's layer differencing: a base variant with every segment of
depth 1 and one variant a segment bumped to 2, each evaluated, the
per-layer deltas times the real depth.  The full-depth program is laid
out too (coherence, argument and output bytes); its step is evaluated
for ``temp_gib`` only when the variants predict it to take under
``FULL_STEP_BUDGET_S`` seconds, and ``temp_gib`` is otherwise
extrapolated from the variants (``temp_source`` says which).

The meshes are the H100 production meshes, the model axis one NVLink
domain of 8 cards: ``single`` is (32, 8) over ("data", "model"), 256
cards; ``multi`` is (2, 32, 8) over ("pod", "data", "model"), 512 cards
(the chip count of JAX's (16, 16) and (2, 16, 16)).

The record's ``notes`` say where its figures are not a card's: every
record, that ``temp_gib`` and ``live_est_gib`` are the controller's; a
record whose step joined activations over the model axis, that those
joins are the controller's (``layers._record_matmul``; an FSDP weight
is priced as the all-gather of its block and the reduce-scatter of its
gradient, as a deployment moves it).  Where the port's runtime layout
differs from JAX's declared one, the record says so too: the
trainer's ``int8_ef`` error-feedback buffer is one full-length buffer
a data member (``lm_cells.per_data_member``, what runs), where JAX's
dry-run declares ``P(dp)``.  ``--seq-shard-acts`` and ``--block-k`` go
into ``make_ctx`` as in JAX.  Under ``--seq-shard-acts`` each attention
layer's residual is laid out over the sequence (``ShardCtx.seq_spec``):
each forward pass of such a layer gathers its normed activation twice
over the model axis in its dtype (site ``seq``), and its ``wo`` and
``w2`` reduce-scatter their f32 partials where they all-reduce without
it (site ``matmul``), the residual gathered once more before the final
norm; the products, so the FLOPs, are the same, and ``temp_gib`` stays
the controller's.  ``pallas`` and ``unroll`` steer XLA only and are not
passed.  A sharded decode cache needs ``--decode-shardmap`` (the port
has no partitioner).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --reduced \\
      --mesh-shape 2x4 --shape train_4k     # a small cell, seconds
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import api as miso
from ..configs import CANONICAL, get_config, get_reduced
from ..core import FaultSpec, RedundancyPolicy
from ..core.cell import abstract_mode, counting
from ..data.pipeline import DataConfig
from ..distributed import sharding as shd
from ..distributed import make_mesh, wire
from ..models import transformer as T
from ..models.config import (SHAPES, ShapeSpec, applicable_shapes, segment_counts,
                             sub_quadratic, with_segment_counts)
from ..models.lm_cells import (ServeConfig, TrainConfig, make_serve_program, make_train_program,
                               place_params, train_state_pspecs)
from ..optim.adamw import OptConfig
from ..tree import tree_leaves, tree_map
from . import analysis
from .mesh import make_ctx, make_production_mesh

P = shd.PartitionSpec

#: the device every member of a dry-run mesh stands on
STAND_IN = "cpu"
#: the full-depth step is evaluated when the variants predict less
FULL_STEP_BUDGET_S = 60.0
#: the model axis: one NVLink domain of an HGX node
MODEL = 8
EF_NOTE = ("ef: one full-length error-feedback buffer a data member (what the port runs, "
           "lm_cells.per_data_member); JAX's dry-run declares it P(dp)")
TEMP_NOTE = ("memory: temp_gib and live_est_gib are the single controller's figures (the whole "
             "batch's activations and every member's blocks), not one card's")
EF_FSDP_NOTE = ("wire: under int8_ef each data member's forward runs on its own rows and "
                "records the FSDP weight gathers of every member, so the fsdp site counts "
                "them once a data member")
MATMUL_NOTE = ("wire: the model axis's activation joins are the controller's (every "
               "column-parallel output gathered, every row-parallel partial sum an f32 "
               "all-reduce, or under seq_shard_acts an f32 reduce-scatter into the sequence "
               "blocks after an all-gather of the normed activation); a deployment that keeps "
               "column outputs split and reduces in bf16 moves less, so the NVLink term is an "
               "upper bound")


def arch_opts(arch: str) -> dict:
    big = arch in ("deepseek-v3-671b",)
    large = arch in ("command-r-plus-104b", "granite-20b")
    return {
        "fsdp": big or large,
        "opt": OptConfig(quantized_state=big, master_fp32=not big),
    }


def production_mesh(multi_pod: bool):
    """The H100 production mesh over stand-in devices."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=[STAND_IN] * n, model=MODEL)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One laid-out leaf: its global shape and dtype and its spec (the
    port's ``ShapeDtypeStruct`` with a sharding)."""

    shape: tuple
    dtype: torch.dtype
    spec: P


def _prepend(spec: P, axis) -> P:
    return P(axis, *tuple(spec))


def _tree_prepend(pspecs, axis):
    return tree_map(lambda s: _prepend(s, axis), pspecs)


def _to_specs(shapes, pspecs):
    return tree_map(lambda sh, sp: LeafSpec(tuple(sh.shape), sh.dtype, sp), shapes, pspecs)


def _dp_ax(ctx):
    dp = ctx.data_axes
    return dp if len(dp) > 1 else dp[0]


def _axsize(ctx) -> int:
    n = 1
    for a in ctx.data_axes:
        n *= ctx.mesh.shape[a]
    return n


# --------------------------------------------------------------------------
# abstract states (fake tensors; nothing allocated)
# --------------------------------------------------------------------------
def abstract_states(prog) -> dict:
    """The program's initial states on fakes, laid out as the port lays
    them out at run time (``init`` on the mesh, replicas stacked)."""
    gen = torch.Generator().manual_seed(0)
    with abstract_mode():
        return prog.init_states(gen, STAND_IN)


def _shapes(tree):
    return tree_map(lambda x: LeafSpec(tuple(x.shape), x.dtype, None), tree)


def train_state_specs(cfg, tcfg, prog, ctx, policy: RedundancyPolicy, states=None):
    """The train cell's layout: the data cell's batch over the data axes
    (JAX's ``P(dp, None)``; the port runs it on the controller), the
    trainer's by ``lm_cells.train_state_pspecs`` with the replica entry
    prepended for ``level > 1``.  A tree of ``LeafSpec``."""
    states = abstract_states(prog) if states is None else states
    shapes = _shapes(states)
    dp_ax = _dp_ax(ctx)
    data_specs = {"tokens": P(dp_ax, None), "key": P()}
    if cfg.n_codebooks > 1:
        data_specs["tokens"] = P(dp_ax, None, None)
    if cfg.n_vision_tokens:
        data_specs["vision_embeds"] = P(dp_ax, None, None)
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                    shapes["trainer"])
    tspec = train_state_pspecs(cfg, ctx, meta, policy.level, policy.placement)
    return _to_specs(shapes, {"data": data_specs, "trainer": tspec})


def serve_state_specs(cfg, scfg, prog, ctx, policy: RedundancyPolicy, states=None):
    """The decode cell's layout, JAX's: weights by ``param_pspecs``, the
    cache by ``cache_pspecs`` over one replica (its batch unsharded when
    it does not divide over the data axes), tokens over the data axes."""
    states = abstract_states(prog) if states is None else states
    shapes = _shapes(states)
    dp_ax = _dp_ax(ctx)
    batch_shardable = scfg.batch % _axsize(ctx) == 0
    meta = lambda t: tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), t)
    wspec = {"params": shd.param_pspecs(ctx, meta(shapes["weights"]["params"]), cfg)}
    cache_shapes = meta(shapes["decoder"]["cache"])
    if policy.level > 1:
        cache_shapes = tree_map(lambda x: x[0], cache_shapes)
    cspec = shd.cache_pspecs(ctx, cache_shapes, cfg)
    if not batch_shardable:
        cspec = tree_map(lambda s: P(None, *tuple(s)[1:]), cspec)
    tok_spec = P(dp_ax if batch_shardable else None, None)
    if cfg.n_codebooks > 1:
        tok_spec = P(*tuple(tok_spec), None)
    dspec = {"cache": cspec, "tokens": tok_spec, "n_decoded": P()}
    if policy.level > 1:
        axis = "pod" if policy.placement == "spatial" else None
        dspec = _tree_prepend(dspec, axis)
    return _to_specs(shapes, {"weights": wspec, "decoder": dspec})


def _serve_cfg(shape: ShapeSpec) -> ServeConfig:
    return ServeConfig(batch=shape.global_batch, max_len=shape.seq_len,
                       prefill_len=shape.seq_len - 1)


def _train_cfg(cfg, shape: ShapeSpec, opt: OptConfig, grad_compression: str) -> TrainConfig:
    return TrainConfig(
        data=DataConfig(batch=shape.global_batch, seq_len=shape.seq_len, vocab=cfg.vocab_size,
                        kind="uniform", n_codebooks=cfg.n_codebooks),
        opt=opt, grad_compression=grad_compression)


def input_specs(cfg, shape_name, mesh, ctx, *, policy=RedundancyPolicy(),
                opt: OptConfig = OptConfig(), grad_compression: str = "none"):
    """(program | None, ``LeafSpec`` tree, fake states | None) for one
    cell; ``shape_name`` a name of ``SHAPES`` or a ``ShapeSpec``."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if shape.kind == "train":
        tcfg = _train_cfg(cfg, shape, opt, grad_compression)
        prog = make_train_program(cfg, tcfg, ctx).with_policies({"trainer": policy})
        states = abstract_states(prog)
        return prog, train_state_specs(cfg, tcfg, prog, ctx, policy, states), states
    if shape.kind == "decode":
        scfg = _serve_cfg(shape)
        prog = make_serve_program(cfg, scfg, ctx).with_policies({"decoder": policy})
        states = abstract_states(prog)
        return prog, serve_state_specs(cfg, scfg, prog, ctx, policy, states), states
    # prefill: forward with cache fill
    dp_ax = _dp_ax(ctx)
    B, S = shape.global_batch, shape.seq_len
    tok_shape = (B, S) if cfg.n_codebooks == 1 else (B, S, cfg.n_codebooks)
    tok_spec = P(dp_ax, None) if cfg.n_codebooks == 1 else P(dp_ax, None, None)
    with abstract_mode():
        params = T.init_params(cfg, torch.Generator().manual_seed(0), STAND_IN)
        meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), params)
        pspec = shd.param_pspecs(ctx, meta, cfg)
        inputs = {"params": place_params(cfg, params, ctx),
                  "tokens": torch.zeros(tok_shape, dtype=torch.int32)}
        specs = {"params": _to_specs(meta, pspec),
                 "tokens": LeafSpec(tok_shape, torch.int32, tok_spec)}
        if cfg.n_vision_tokens:
            vshape = (B, cfg.n_vision_tokens, cfg.d_model)
            inputs["vision_embeds"] = torch.zeros(vshape, dtype=cfg.compute_dtype)
            specs["vision_embeds"] = LeafSpec(vshape, cfg.compute_dtype, P(dp_ax, None, None))
    return None, specs, inputs


# --------------------------------------------------------------------------
# bytes from specs
# --------------------------------------------------------------------------
def _itemsize(dtype) -> int:
    return 1 if dtype == torch.bool else dtype.itemsize


def check_coherent(specs, mesh) -> None:
    """Every spec divides its leaf on the mesh and names an axis once."""
    for s in tree_leaves(specs):
        axes = [a for e in tuple(s.spec) for a in (e if isinstance(e, tuple) else (e,))
                if a is not None]
        if len(axes) != len(set(axes)):
            raise ValueError(f"spec {tuple(s.spec)} names a mesh axis twice")
        if len(tuple(s.spec)) > len(s.shape):
            raise ValueError(f"spec {tuple(s.spec)} is longer than the rank of {s.shape}")
        shd.spec_block(mesh, s.spec, s.shape, (0,) * len(mesh.axis_names))


def member_bytes(specs, mesh, coord=None) -> int:
    """The bytes member ``coord`` (default: the first) holds of ``specs``."""
    coord = (0,) * len(mesh.axis_names) if coord is None else coord
    total = 0
    for s in tree_leaves(specs):
        blk = shd.spec_block(mesh, s.spec, s.shape, coord)
        total += math.prod(b.stop - b.start for b in blk) * _itemsize(s.dtype)
    return total


def sharded_member_bytes(tree, coord=None) -> int:
    """The bytes member ``coord`` holds of ``tree``'s ``Sharded`` leaves
    (what ``chip_smoke.mp_layout`` reads on the card)."""
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, shd.Sharded):
            c = x.coords()[0] if coord is None else coord
            blk = x.block(c)
            total += math.prod(b.stop - b.start for b in blk) * _itemsize(x.dtype)
    return total


#: a replicated cell's report, f32: mismatch_elems, events, per_replica (3,)
REPORT_BYTES = 4 * (1 + 1 + 3)


# --------------------------------------------------------------------------
# one abstract step, counted
# --------------------------------------------------------------------------
def _sized(n) -> int:
    """A size, or 0 for one that depends on data (a symbol: M-RoPE's
    section table, a few dozen integers), which fakes cannot know."""
    return n if type(n) is int else 0


class StepCounter(TorchDispatchMode):
    """Counts, over the operators dispatched in it, the bytes each reads
    and writes (views, and queries that return no tensor, skipped) and
    the live bytes of the storages they make (freed when the storage is),
    with the peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self._seen: set = set()
        self._quiet = 0

    # a counter of ``core.cell.counting``
    def snapshot(self) -> float:
        return self.bytes

    def add(self, since: float, times: int) -> None:
        self.bytes += times * (self.bytes - since)

    @contextlib.contextmanager
    def quiet(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        aliases = any(r.alias_info is not None for r in schema.returns)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs and not aliases and not self._quiet:  # a metadata query (a device) moves nothing
            ins = [t for t in tree_leaves((args, kwargs or {})) if isinstance(t, torch.Tensor)]
            self.bytes += sum(_sized(t.numel()) * t.element_size() for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = _sized(st.nbytes())
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


class _FlopCounts:
    """A ``FlopCounterMode``'s counts as a counter of ``core.cell.counting``
    (what a quiet block makes costs no flops)."""

    def __init__(self, fc):
        self.fc = fc

    def snapshot(self) -> dict:
        return {mod: dict(ops) for mod, ops in self.fc.flop_counts.items()}

    def add(self, since: dict, times: int) -> None:
        for mod, ops in self.fc.flop_counts.items():
            base = since.get(mod, {})
            for op in list(ops):
                ops[op] += times * (ops[op] - base.get(op, 0))

    def quiet(self):
        return contextlib.nullcontext()


def abstract_step(run) -> dict:
    """``run()`` on fakes, counted: flops, unfused bytes, wire bytes by
    link and site, temp bytes and seconds.  The FLOP and byte counters
    are registered with ``core.cell.counting``, so a block that stands
    for several (``models.ssm``'s convs and scan of one member for every
    member of its block shape, which move nothing between members)
    counts as all of them."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    with abstract_mode(), wire.meter() as m, FlopCounterMode(display=False) as fc, \
            StepCounter() as sc, counting(sc, _FlopCounts(fc)):
        out = run()
        live_end = sc.live
        del out
    return {"flops": float(fc.get_total_flops()), "bytes": float(sc.bytes),
            "wire": m.total, "by_link": dict(m.by_link), "coll": m.to_dict(),
            "temp": float(max(sc.peak - live_end, 0)), "seconds": time.time() - t0}


def _variant(cfg, shape, mesh, ctx, policy, opt, compare_every, grad_compression, fault_hook):
    """(specs, states, run): one cell's layout and its abstract step."""
    prog, specs, states = input_specs(cfg, shape, mesh, ctx, policy=policy, opt=opt,
                                      grad_compression=grad_compression)
    if prog is not None:
        exe = miso.compile(prog, backend="lockstep", device=STAND_IN,
                           compare_every=compare_every)
        fault = FaultSpec.none() if fault_hook else None
        run = lambda: exe.pure_step(states, 0, fault)
    else:
        def run():
            with torch.no_grad():
                return T.forward(cfg, states["params"], states["tokens"], ctx=ctx,
                                 vision_embeds=states.get("vision_embeds"), fill_cache=True)
    return prog, specs, states, run


def _output_bytes(prog, specs, mesh, shape, cfg, ctx) -> int:
    if prog is not None:  # the next state keeps the layout; plus the reports
        return member_bytes(specs, mesh) + REPORT_BYTES * len(prog.cells)
    # the logits as JAX constrains them, (dp, None, tp): a vocabulary the
    # model axis does not divide is split unevenly, as XLA pads it
    B, S = shape.global_batch, shape.seq_len
    dp, tp = _axsize(ctx), ctx.axis_size("tp")
    rows = B // dp if B % dp == 0 else B
    if cfg.n_codebooks == 1:
        logits = rows * S * -(-cfg.vocab_size // tp)
    else:
        logits = rows * S * cfg.n_codebooks * cfg.vocab_size
    with abstract_mode():
        cache = T.init_cache(cfg, B, S, STAND_IN)
    meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), cache)
    cache_specs = _to_specs(meta, shd.cache_pspecs(ctx, meta, cfg))
    return logits * _itemsize(cfg.compute_dtype) + member_bytes(cache_specs, mesh)


def run_cell(arch: str, shape_name, *, multi_pod: bool, policy=RedundancyPolicy(),
             remat: str = "full", seq_shard_acts: bool = False, compare_every: int = 1,
             fsdp=None, block_k: int = 1024, tp_off: bool = False,
             decode_shardmap: bool = False, grad_compression: str = "none",
             fault_hook: bool = False, serve_ep2d: bool = False, verbose: bool = True,
             mesh=None, cfg=None, opt: Optional[OptConfig] = None,
             full_budget_s: float = FULL_STEP_BUDGET_S) -> dict:
    """One cell's record (JAX's keys; see the module docstring).  The
    port's extras, for the chip check and the tests: ``mesh`` (a mesh of
    any shape in place of the production one), ``cfg`` (a config in
    place of ``get_config(arch)``), ``shape_name`` a ``ShapeSpec``,
    ``opt`` (in place of ``arch_opts``'s) and ``full_budget_s``."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh = production_mesh(multi_pod) if mesh is None else mesh
    rec = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "redundancy": f"{policy.level}/{policy.placement}/{policy.compare}/k{compare_every}",
        "remat": remat, "seq_shard_acts": seq_shard_acts,
        "block_k": block_k, "tp_off": tp_off,
        "decode_shardmap": decode_shardmap,
        "grad_compression": grad_compression, "fault_hook": fault_hook,
        "serve_ep2d": serve_ep2d, "ok": False,
    }
    if shape.name == "long_500k" and not sub_quadratic(cfg):
        rec["skipped"] = "pure full-attention arch (see DESIGN.md §6)"
        return rec
    t0 = time.time()
    opts = arch_opts(arch)
    opt = opts["opt"] if opt is None else opt
    use_fsdp = opts["fsdp"] if fsdp is None else fsdp
    if serve_ep2d:
        use_fsdp = False   # serve layout supersedes fsdp (weights TP/EP2D)
    pod_role = "replica" if (policy.level > 1 and policy.placement == "spatial") else "data"
    chips = mesh.devices.size
    notes = [TEMP_NOTE]
    try:
        ctx = make_ctx(mesh, pod_role=pod_role, fsdp=use_fsdp, vocab_size=cfg.vocab_size,
                       d_model=cfg.d_model, remat=remat, seq_shard_acts=seq_shard_acts,
                       block_k=block_k, tp_off=tp_off, decode_shardmap=decode_shardmap,
                       serve_ep2d=serve_ep2d)
        args = (policy, opt, compare_every, grad_compression, fault_hook)

        # 1) full depth, laid out: coherence, argument and output bytes
        prog, specs, states, run_full = _variant(cfg, shape, mesh, ctx, *args)
        check_coherent(specs, mesh)
        arg = member_bytes(specs, mesh)
        if prog is not None and "ef" in specs.get("trainer", {}):
            notes.append(EF_NOTE)
            if ctx.fsdp_axes:
                notes.append(EF_FSDP_NOTE)
        out = _output_bytes(prog, specs, mesh, shape, cfg, ctx)
        if prog is not None:
            rec["trainer_member_bytes" if shape.kind == "train" else "serve_member_bytes"] = \
                sharded_member_bytes(states)
        if shape.kind == "train":  # from the specs: what the port lays out (metrics stay)
            rec["trainer_spec_bytes"] = member_bytes(
                {k: v for k, v in specs["trainer"].items() if k != "metrics"}, mesh)
        rec["compile_full_s"] = round(time.time() - t0, 1)

        # 2) layer differencing on small variants
        t1 = time.time()
        counts = segment_counts(cfg)
        base_counts = [1] * len(counts)
        step = lambda c: abstract_step(_variant(with_segment_counts(cfg, c), shape, mesh, ctx,
                                                *args)[3])
        cbase = step(base_counts)
        per_layer, cbumped = [], []
        for i in range(len(counts)):
            bumped = list(base_counts)
            bumped[i] = 2
            ci = step(bumped)
            cbumped.append(ci)
            per_layer.append({k: ci[k] - cbase[k] for k in ("flops", "bytes", "wire", "temp",
                                                            "seconds")})
        depth = lambda k: cbase[k] + sum((counts[i] - 1) * per_layer[i][k]
                                         for i in range(len(counts)))
        total = {k: depth(k) for k in ("flops", "bytes", "wire")}
        links = {ln: cbase["by_link"][ln] + sum(
            (counts[i] - 1) * (cbumped[i]["by_link"][ln] - cbase["by_link"][ln])
            for i in range(len(counts))) for ln in ("nvlink", "network")}
        if cbase["coll"]["by_site"].get("matmul"):
            notes.append(MATMUL_NOTE)
        rec["layerwise"] = {
            "base": {k: cbase[k] for k in ("flops", "bytes", "wire")},
            "per_layer": [{k: d[k] for k in ("flops", "bytes", "wire")} for d in per_layer],
            "counts": counts,
            "base_coll": cbase["coll"],
            "bumped_coll": [c["coll"] for c in cbumped],
        }
        predicted = max(depth("seconds"), cbase["seconds"])
        if predicted <= full_budget_s:
            temp = abstract_step(run_full)["temp"]
            rec["temp_source"] = "full-depth step"
        else:
            temp = max(depth("temp"), 0.0)
            rec["temp_source"] = (f"extrapolated from the variants (the full-depth step was "
                                  f"predicted to take {predicted:.0f} s)")
        del states, run_full
        rec["memory"] = {
            "argument_gib": arg / 2**30,
            "output_gib": out / 2**30,
            "temp_gib": temp / 2**30,
            "alias_gib": 0.0,
            "live_est_gib": (arg + temp + out) / 2**30,
        }
        rec["compile_variants_s"] = round(time.time() - t1, 1)

        # 3) roofline terms (per card: the counts split evenly)
        mf = analysis.model_flops_for(cfg, shape) * compare_every
        tp = 1 if tp_off else mesh.shape["model"]
        dp = chips // tp // (2 if pod_role == "replica" else 1)
        hbm_model = analysis.analytic_hbm_bytes(
            cfg, shape, chips=chips, tp=tp, dp=dp, remat=remat,
            redundancy=(policy.level if policy.placement == "temporal" else 1),
        ) * compare_every
        hw = analysis.HW
        flops_chip = total["flops"] / chips
        link_chip = {ln: b / chips for ln, b in links.items()}
        r = analysis.Roofline(
            compute_s=flops_chip / hw["peak_flops"], memory_s=hbm_model / hw["hbm_bw"],
            collective_s=analysis.collective_seconds(link_chip), flops_per_chip=flops_chip,
            hbm_bytes_per_chip=hbm_model, wire_bytes_per_chip=total["wire"] / chips,
            model_flops=mf, chips=chips)
        roof = {**r.to_dict(), "bound_s": r.bound_s,
                "memory_s_unfused": total["bytes"] / chips / hw["hbm_bw"],
                "hbm_bytes_model": hbm_model, "hbm_bytes_unfused": total["bytes"] / chips,
                "wire_bytes_by_link": link_chip}
        rec["roofline"] = roof
        rec["notes"] = notes
        rec["seconds"] = round(time.time() - t0, 1)
        rec["ok"] = True
        if verbose:
            print(
                f"OK  {arch:24s} {shape.name:12s} {rec['mesh']:8s} "
                f"comp={roof['compute_s']*1e3:9.2f}ms "
                f"mem={roof['memory_s']*1e3:9.2f}ms "
                f"coll={roof['collective_s']*1e3:9.2f}ms "
                f"dom={roof['dominant']:10s} "
                f"live={rec['memory']['live_est_gib']:7.2f}GiB "
                f"frac={roof['roofline_fraction']:.3f} "
                f"[{rec['compile_full_s']}s+{rec['compile_variants_s']}s]",
                flush=True,
            )
    except Exception as e:  # noqa: BLE001 - record and continue the matrix
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["seconds"] = round(time.time() - t0, 1)
        if verbose:
            print(f"FAIL {arch} {shape.name} {rec['mesh']}: {rec['error']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--redundancy", default="none",
                    choices=["none", "dmr_temporal", "dmr_spatial", "tmr_temporal",
                             "tmr_spatial"])
    ap.add_argument("--compare", default="bitwise", choices=["bitwise", "hash"])
    ap.add_argument("--compare-every", type=int, default=1)
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"])
    ap.add_argument("--seq-shard-acts", action="store_true")
    ap.add_argument("--block-k", type=int, default=1024)
    ap.add_argument("--fsdp", default=None, choices=["on", "off"])
    ap.add_argument("--tp-off", action="store_true")
    ap.add_argument("--decode-shardmap", action="store_true")
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--serve-ep2d", action="store_true",
                    help="serve weight layout: experts E over (data x model), dense TP-only "
                         "(decode cells)")
    ap.add_argument("--fault-hook", action="store_true",
                    help="evaluate the step WITH the fault-injection hook (production steps "
                         "pass none)")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    # the port's own: a small cell, for a smoke run on a laptop's CPU
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config (configs.get_reduced)")
    ap.add_argument("--mesh-shape", default=None,
                    help="a mesh of stand-ins in place of the production one: DxM over "
                         "(data, model), or PxDxM over (pod, data, model)")
    args = ap.parse_args(argv)

    level = {"none": 1, "dmr": 2, "tmr": 3}[args.redundancy.split("_")[0]]
    placement = args.redundancy.split("_")[1] if "_" in args.redundancy else "temporal"
    policy = RedundancyPolicy(level=level, placement=placement, compare=args.compare)

    archs = [args.arch] if args.arch else list(CANONICAL)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    custom = None
    if args.mesh_shape:
        dims = tuple(int(n) for n in args.mesh_shape.split("x"))
        axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
        custom = make_mesh(dims, axes, devices=[STAND_IN] * math.prod(dims))
        meshes = [len(dims) == 3]
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    results = []
    for arch in archs:
        cfg = (get_reduced if args.reduced else get_config)(arch)
        shapes = [args.shape] if args.shape else applicable_shapes(cfg)
        for shape in shapes:
            for mp in meshes:
                fn = outdir / f"{args.tag}_{arch}_{shape}_{'multi' if mp else 'single'}.json"
                if args.skip_existing and fn.exists():
                    rec = json.loads(fn.read_text())
                    if rec.get("ok") or "skipped" in rec:
                        results.append(rec)
                        continue
                rec = run_cell(
                    arch, shape, multi_pod=mp, policy=policy, remat=args.remat,
                    seq_shard_acts=args.seq_shard_acts, compare_every=args.compare_every,
                    block_k=args.block_k,
                    fsdp=None if args.fsdp is None else args.fsdp == "on",
                    tp_off=args.tp_off, decode_shardmap=args.decode_shardmap,
                    grad_compression=args.grad_compression, fault_hook=args.fault_hook,
                    serve_ep2d=args.serve_ep2d, mesh=custom, cfg=cfg,
                )
                results.append(rec)
                fn.write_text(json.dumps(rec, indent=1))
    n_ok = sum(bool(r.get("ok")) for r in results)
    n_skip = sum("skipped" in r for r in results)
    print(f"\n{n_ok} ok / {n_skip} skipped / {len(results) - n_ok - n_skip} failed of "
          f"{len(results)}")
    return results


if __name__ == "__main__":
    main()
