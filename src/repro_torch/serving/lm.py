"""LM adapter for the continuous batcher: the slot-masked serve program
of ``models/lm_cells.py`` packaged as a ``SlotAdapter`` (a port of
``repro/serving/lm.py``).

    cfg = get_config("internlm2-1.8b")
    prog, adapter = lm_engine_parts(cfg, ServeConfig(batch=8, max_len=512,
                                                     paged=True))
    engine = repro_torch.api.serve(prog, adapter)

Prefill is BUCKETED as in the JAX package: prompts are right-padded to a
geometric ladder (``ServeConfig.prefill_bucket_min`` doubling up to
``max_len``) and the padded positions are masked out of the filled cache
by ``prompt_len``, so the slot state equals an exact-length prefill's.
Prefill is optionally CHUNKED (``ServeConfig.prefill_chunk``): the tail
of a long prompt rides into the slot's ``pending`` segment and is walked
inside the resident transition.  Speculation (``ServeConfig.spec``)
falls back to plain decode on archs that cannot roll back, as paging
does on archs without pages; a request's ``spec.draft_len`` is clamped
to the engine's.

Under a ``ShardCtx`` with a mesh (``launch.mesh.make_ctx``) the program
holds sharded weights and a sharded cache (dense, or paged pools read
through the one global page table), a draft model's too, and every
prefill and decode step runs the model-parallel path; the engine needs
nothing new, since the slot surgery (``slots.py``, ``paging.py``) reads
and writes the sharded leaves member by member::

    mesh = make_mesh((2, 4), ("data", "model"), devices=["cuda:0"] * 8)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                   decode_shardmap=True)
    prog, adapter = lm_engine_parts(cfg, ServeConfig(batch=8, max_len=512), ctx)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.executor import resolve_device
from ..distributed.sharding import LOCAL, ShardCtx
from ..models.config import ModelConfig
from ..models.lm_cells import (
    ServeConfig,
    make_slot_serve_program,
    paged_pool_pages,
    paged_serving_supported,
    paged_slot_decoder_init,
    prefill_bucket_ladder,
    prefill_slot_state,
    resolve_draft_config,
    serve_ctx,
    slot_decoder_init,
    spec_serving_supported,
    token_dims,
)
from .engine import EngineParts, SlotAdapter
from .request import Request
from .slots import infer_slot_axes


def lm_engine_parts(cfg: ModelConfig, scfg: ServeConfig, ctx: ShardCtx = LOCAL, *,
                    device="cuda") -> EngineParts:
    """``EngineParts(program, adapter)`` for ``repro_torch.api.serve``:
    the resident slot-masked LM serve program plus the glue the engine
    needs to run it.  ``device`` must be the engine's device (the mesh's
    first device under a ``ctx`` with one)."""
    dev = resolve_device(device)
    prog = make_slot_serve_program(cfg, scfg, ctx)
    ctx = serve_ctx(ctx, scfg)  # the prefill runs under the program's ctx
    paged = scfg.paged and paged_serving_supported(cfg)
    # speculation falls back to plain decode where the cache cannot roll back
    spec = scfg.spec if scfg.spec is not None and spec_serving_supported(cfg) else None
    dcfg = resolve_draft_config(cfg, spec) if spec else None
    spec_len = spec.draft_len if spec else 0
    # bucket padding is maskable only for full-attention text caches
    bucketable = cfg.mixer_type != "mamba2" and not cfg.n_vision_tokens and not cfg.window
    ladder = prefill_bucket_ladder(scfg) if bucketable else ()
    chunk = scfg.prefill_chunk if not cfg.n_vision_tokens else 0
    if chunk > 0 and ladder:
        # a chunk-sized head must run a chunk-sized forward
        ladder = tuple(sorted(set(ladder) | {min(chunk, scfg.max_len)}))
    buckets_used: set = set()
    tail_dims = token_dims(cfg)  # a multi-codebook prompt is (P, K)

    def prefill(req: Request, states: dict):
        prompt = np.asarray(req.prompt, np.int32).reshape((-1,) + tail_dims)
        plen = int(prompt.shape[0])
        c0 = plen if chunk <= 0 or plen <= chunk else max(chunk, plen - scfg.max_len)
        bucket = min((b for b in ladder if b >= c0), default=c0)
        # the bucket-sized forward is paid for regardless: cover as much
        # prompt as fits in it, shrinking the walked tail
        c0 = min(plen, bucket)
        head = np.zeros((bucket,) + tail_dims, np.int32)
        head[:c0] = prompt[:c0]
        pend = np.zeros((scfg.max_len,) + tail_dims, np.int32)
        n_pending = plen - c0
        pend[:n_pending] = prompt[c0:]
        # the request's draft length, clamped to the resident walk's width
        spec_k = min(req.spec.draft_len, spec_len) if spec and req.spec else 0
        slot_state, first = prefill_slot_state(
            cfg,
            scfg,
            states["weights"]["params"],
            torch.from_numpy(head).to(dev),
            ctx=ctx,
            prompt_len=c0 if bucketable else None,
            pending=torch.from_numpy(pend).to(dev),
            n_pending=n_pending,
            spec_k=spec_k if spec else None,
            budget=req.max_new_tokens if spec else None,
            draft_cfg=dcfg,
            draft_params=states["weights"]["draft"] if dcfg is not None else None,
        )
        buckets_used.add(bucket)
        if n_pending:
            # the real first token comes from the tick that consumes the
            # last pending prompt token
            return slot_state, None, n_pending
        return slot_state, first, 0

    def validate(req: Request) -> Optional[str]:
        plen = int(np.asarray(req.prompt).shape[0])
        if plen + req.max_new_tokens > scfg.max_len and not cfg.window:
            return (
                f"prompt {plen} + budget {req.max_new_tokens} exceeds "
                f"cache capacity {scfg.max_len}"
            )
        if req.spec is not None and spec is not None:
            # one resident draft serves the engine: a request picks its
            # draft length, not another draft model
            if req.spec.draft_arch and req.spec.draft_arch != spec.draft_arch:
                return (
                    f"request draft_arch {req.spec.draft_arch!r} does not "
                    f"match the engine's resident draft "
                    f"{spec.draft_arch or 'self'!r}"
                )
        return None

    table = surgery = pre_tick = has_capacity = None
    if paged:
        from .paging import PageTable, infer_paged_axes, make_pre_tick, paged_surgery

        psize = scfg.page_size
        n_pages = paged_pool_pages(scfg)
        table = PageTable(n_pages, psize, scfg.max_len // psize)
        axes = infer_paged_axes(
            lambda b: paged_slot_decoder_init(cfg, b, scfg.max_len, psize, n_pages, "meta",
                                              dcfg, spec_len)
        )

        def reserve_fn(req: Request) -> int:
            # worst-case pages of ONE replica slot
            return table.pages_for(min(req.prompt_len + req.max_new_tokens, scfg.max_len))

        def make_empty():
            # the scrub template only reads non-pool leaves: a 1-page pool
            return paged_slot_decoder_init(cfg, 1, scfg.max_len, psize, 1, dev, dcfg, spec_len)

        surgery = paged_surgery(table, "decoder", axes, make_empty(), reserve_fn=reserve_fn)
        pre_tick = make_pre_tick(table, "decoder", scfg.batch, walk_chunk=max(1, chunk),
                                 draft_len=spec_len)

        def has_capacity(req: Request) -> bool:
            return table.can_admit(req.n_slots * reserve_fn(req))

    else:
        axes = infer_slot_axes(
            lambda b: slot_decoder_init(cfg, b, scfg.max_len, "meta", dcfg, spec_len))

        def make_empty():
            return slot_decoder_init(cfg, 1, scfg.max_len, dev, dcfg, spec_len)

    def stats() -> dict:
        out = {
            "prefill_buckets_used": len(buckets_used),
            "prefill_buckets": list(ladder) if ladder else None,
            "prefill_chunk": chunk,
            "paged": paged,
            "spec_draft_len": spec_len,
        }
        if spec is not None:
            out["spec_draft_arch"] = spec.draft_arch or "self"
        if table is not None:
            out["pages_total"] = table.n_pages
            out["pages_free"] = table.free_pages
            out["page_faults"] = table.page_faults
            out["page_size"] = table.page_size
        return out

    def attach_tracer(tracer) -> None:
        # the paged pre-tick hook emits its own page_fault instants
        if pre_tick is not None:
            pre_tick.tracer = tracer

    adapter = SlotAdapter(
        cell="decoder",
        n_slots=scfg.batch,
        slot_axes=axes,
        prefill=prefill,
        read_tokens=lambda dec: dec["tokens"],
        make_empty=make_empty,
        validate=validate,
        stats=stats,
        surgery=surgery,
        has_capacity=has_capacity,
        pre_tick=pre_tick,
        walk_chunk=max(1, chunk),
        contiguous_replicas=not paged,
        read_spec=(lambda dec: (dec["spec_out"], dec["spec_n"])) if spec else None,
        attach_tracer=attach_tracer,
    )
    return EngineParts(prog, adapter)
