"""The decoder-only LM (a port of ``repro/models/transformer.py``).

Parameters are the JAX package's tree: ``{"embed", "final_norm",
"segments": [stacked per-layer dicts]}`` (plus ``lm_head`` when untied,
both with a leading codebook axis for a multi-codebook model,
``shared_attn`` for Zamba2's weight-shared block, and
``mtp_proj``/``mtp_norm`` for a multi-token-prediction head), each
segment's leaves carrying a leading layer axis.  Layers run as a Python
loop over that axis; with grad enabled each layer is checkpointed as
``ctx.remat`` says (``_remat``: JAX's per-layer ``jax.checkpoint``).  Segment kinds:

  attn_mlp   -- [norm -> attention (GQA or MLA) -> residual]
                [norm -> MLP -> residual]
  attn_moe   -- the same with the MoE mixer (+ shared experts)
  mamba      -- [norm -> mamba2 block -> residual]
  zamba_unit -- ``shared_attn_every`` mamba layers followed by one call
                of a weight-shared attention + MLP block over
                concat(h, e0) (Zamba2; the shared block's weights live
                outside the segments, its KV cache in each unit's)

Entry points:
  forward(...)      logits (prefill; optional cache fill with prompt_len)
  loss_fn(...)      the training loss (next-token cross-entropy, the
                    multi-codebook mean, the MTP head's 0.1 term, the
                    MoE load-balance aux) and its metrics
  decode_step(...)  one-token serve step over a dense or paged KV cache

Under ``ctx.seq_shard_acts`` the residual of every attention layer of
``forward`` is a ``Sharded`` leaf laid out by ``ctx.seq_spec`` (the
batch over the data axes, the sequence over the model axis; Megatron-SP,
JAX's constraint at the end of each such layer); ``decode_step`` (S = 1)
is unchanged.

``forward``, ``decode_step``, ``embed_tokens`` and ``unembed`` take a
``ShardCtx`` (``ctx``, default ``LOCAL``).  Under one with a mesh the
params are ``Sharded`` leaves (``shard(params, param_pspecs(...))``)
and a decode cache is too (``cache_pspecs``): every product follows its
weight's spec (``layers.matmul``), the vocab-sharded embedding is a
masked lookup summed over the members (exact: each row has one
non-zero contribution), the vocab-sharded head concatenates the members'
logits, decode attention runs through ``distributed/decode.py``, MoE
through ``moe._moe_spmd``, and a Mamba2 layer runs its recurrence on
each member's rows and heads (``ssm.mamba_block``).  ``loss_fn`` takes
the same ``ctx``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed import decode as DD
from ..distributed.sharding import LOCAL, ShardCtx, Sharded, shard_leaf, stack
from ..tree import tree_flatten, tree_map, tree_unflatten
from . import layers as L
from .config import ModelConfig
from .moe import moe_block, moe_init
from .ssm import mamba_block, mamba_cache_init, mamba_init

Params = dict


# --------------------------------------------------------------------------
# segment plan
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str  # attn_mlp | attn_moe | mamba | zamba_unit
    count: int  # layers in the segment (units, for zamba_unit)
    sub: int = 1  # mamba layers folded inside one unit (zamba_unit)


def segment_plan(cfg: ModelConfig) -> list[Segment]:
    if cfg.mixer_type == "mamba2":
        if cfg.shared_attn_every:
            k = cfg.shared_attn_every
            if cfg.n_layers % k:
                raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not units of {k}")
            return [Segment("zamba_unit", cfg.n_layers // k, sub=k)]
        return [Segment("mamba", cfg.n_layers)]
    if cfg.mixer_type not in ("mlp", "moe") or cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: only GQA/MLA + MLP/MoE, Mamba2 and Zamba2 text decoders are ported "
            f"(mixer={cfg.mixer_type}, attn={cfg.attn_type})"
        )
    if cfg.mixer_type == "moe":
        nd = cfg.moe.n_dense_layers if cfg.moe else 0
        return ([Segment("attn_mlp", nd)] if nd else []) + [Segment("attn_moe", cfg.n_layers - nd)]
    return [Segment("attn_mlp", cfg.n_layers)]


def _recurrent(cfg: ModelConfig) -> bool:
    return any(seg.kind in ("mamba", "zamba_unit") for seg in segment_plan(cfg))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _stacked(count: int, make) -> Params:
    """``count`` draws of ``make()`` stacked on a leading axis.  Each draw
    is written into the stack and let go before the next is made, so the
    peak is the stack and one draw, not twice the stack (granite-20b's 52
    layers are 40 GB); a single draw is its own stack (deepseek's one MoE
    layer is 22.5 GB)."""
    leaves, treedef = tree_flatten(make())
    if count == 1:
        return tree_unflatten(treedef, [x[None] for x in leaves])
    stacks = [torch.empty((count, *x.shape), dtype=x.dtype, device=x.device) for x in leaves]
    for i in range(count):
        if i:
            leaves = tree_flatten(make())[0]
        for stack, x in zip(stacks, leaves):
            stack[i] = x
        leaves.clear()
    return tree_unflatten(treedef, stacks)


def _attn_init(gen, cfg: ModelConfig, device) -> Params:
    return L.mla_init(gen, cfg, device) if cfg.attn_type == "mla" else L.gqa_init(gen, cfg, device)


def _layer_init(gen, cfg: ModelConfig, kind: str, device) -> Params:
    d, dt = cfg.d_model, cfg.compute_dtype
    if kind == "mamba":
        return {"norm": torch.ones((d,), dtype=dt, device=device),
                "mamba": mamba_init(gen, cfg, device)}
    if kind == "zamba_unit":
        sub = cfg.shared_attn_every
        return {
            "norms": torch.ones((sub, d), dtype=dt, device=device),
            "mamba": _stacked(sub, lambda: mamba_init(gen, cfg, device)),
            "in_proj": L.dense_init(gen, 2 * d, d, dt, device),
            "attn_norm": torch.ones((d,), dtype=dt, device=device),
        }
    p = {
        "ln1": torch.ones((d,), dtype=dt, device=device),
        "ln2": torch.ones((d,), dtype=dt, device=device),
        "attn": _attn_init(gen, cfg, device),
    }
    if kind == "attn_moe":
        p["moe"] = moe_init(gen, cfg, device)
    else:
        p["mlp"] = L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dt, device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random weights from ``gen``, laid out as the JAX package's tree
    (the draws differ: torch cannot reproduce ``jax.random``)."""
    dt = cfg.compute_dtype
    d, V, K = cfg.d_model, cfg.vocab_size, cfg.n_codebooks
    shape = (K, V, d) if K > 1 else (V, d)
    embed = torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(0.02).to(dt)
    params: Params = {"embed": embed, "final_norm": torch.ones((d,), dtype=dt, device=device)}
    params["segments"] = [_stacked(seg.count, lambda seg=seg: _layer_init(gen, cfg, seg.kind, device))
                          for seg in segment_plan(cfg)]
    if cfg.shared_attn_every and cfg.mixer_type == "mamba2":
        params["shared_attn"] = {
            "attn": _attn_init(gen, cfg, device),
            "mlp": L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dt, device),
            "ln1": torch.ones((d,), dtype=dt, device=device),
            "ln2": torch.ones((d,), dtype=dt, device=device),
        }
    if not cfg.tie_embeddings:
        if K > 1:
            params["lm_head"] = torch.randn((K, d, V), generator=gen, dtype=torch.float32,
                                            device=device).mul_(d**-0.5).to(dt)
        else:
            params["lm_head"] = L.dense_init(gen, d, V, dt, device)
    if cfg.mtp:
        # the multi-token-prediction head, read only by ``loss_fn``
        params["mtp_proj"] = L.dense_init(gen, 2 * d, d, dt, device)
        params["mtp_norm"] = torch.ones((d,), dtype=dt, device=device)
    return params


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------
def _lookup(table, tokens: torch.Tensor, onehot: bool) -> torch.Tensor:
    """Rows of a (V, d) table at ``tokens``: a gather, or with ``onehot``
    the one-hot product (JAX's ``embed_strategy="onehot"``; the same
    bits).  A vocab-sharded table gives each member's rows of the tokens
    it holds, zero elsewhere, summed over the members in order."""
    if not isinstance(table, Sharded):
        if onehot:
            return F.one_hot(tokens.long(), table.shape[0]).to(table.dtype) @ table
        return table[tokens.long()]
    blocks: dict = {}
    for c in table.coords():
        rows = table.block(c)[0]
        blocks.setdefault((rows.start, rows.stop), table.local(c))
    out = None
    for (v0, v1), t in sorted(blocks.items()):
        local = (tokens.long() - v0).to(t.device)
        inside = (local >= 0) & (local < v1 - v0)
        if onehot:  # an id outside the block has no one-hot column here
            rows = (local[..., None] == torch.arange(v1 - v0, device=t.device)).to(t.dtype) @ t
        else:
            rows = torch.where(inside[..., None], t[local.clamp(0, v1 - v0 - 1)],
                               torch.zeros((), dtype=t.dtype, device=t.device))
        rows = rows.to(tokens.device)
        out = rows if out is None else out + rows
    return out


def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 ctx: ShardCtx = LOCAL) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d); a multi-codebook model's (B, S, K)
    sum their K codebooks' rows, in codebook order as JAX does."""
    table = params["embed"]
    onehot = ctx.embed_strategy == "onehot"
    if cfg.n_codebooks > 1:
        out = _lookup(table[0], tokens[..., 0], onehot)
        for k in range(1, cfg.n_codebooks):
            out = out + _lookup(table[k], tokens[..., k], onehot)
        return out
    return _lookup(table, tokens, onehot)


def unembed(params: Params, h: torch.Tensor, cfg: ModelConfig,
            ctx: ShardCtx = LOCAL) -> torch.Tensor:
    """h (B, S, d) -> logits (B, S, V), or (B, S, K, V) for K codebooks.
    A vocab-sharded head is a column-parallel product: the members'
    logits, concatenated."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    if cfg.n_codebooks > 1:
        if isinstance(w, Sharded):
            return torch.stack([L.matmul(h, w[k], transpose=cfg.tie_embeddings)
                                for k in range(cfg.n_codebooks)], dim=-2)
        if cfg.tie_embeddings:
            return torch.einsum("bsd,kvd->bskv", h, w)
        return torch.einsum("bsd,kdv->bskv", h, w)
    return L.matmul(h, w, transpose=cfg.tie_embeddings)


# --------------------------------------------------------------------------
# layer bodies
# --------------------------------------------------------------------------
def _attention(p, x, cfg: ModelConfig, positions, cache, fill_cache, active=None,
               prompt_len=None, pages=None, rows_lanes=None, ctx: ShardCtx = LOCAL,
               scatter=None):
    """Returns (out, cache_out): the updated cache (decode), the filled
    cache (fill_cache), or None.  ``prompt_len`` masks the fill for
    bucket-padded prefill: entries at positions >= prompt_len are
    scrubbed (slot_pos = -1, zero K/V), so the filled cache equals an
    exact-length prefill's.  ``scatter`` lays a prefill's ``out`` out as
    a sequence-parallel residual (``layers.matmul``)."""
    fn = L.mla_attention if cfg.attn_type == "mla" else L.gqa_attention
    if cache is not None:
        return fn(p, x, cfg, positions=positions, cache=cache, active=active, pages=pages,
                  rows_lanes=rows_lanes, ctx=ctx)
    out, _ = fn(p, x, cfg, positions=positions, cache=None, block_k=ctx.block_k,
                scatter=scatter)
    if not fill_cache:
        return out, None
    # re-derive the kv projections to populate a decode cache
    B, S, _ = x.shape
    if cfg.attn_type == "mla":
        ckv, k_rope = L.mla_latent(p, x, cfg, positions)
        sp = torch.broadcast_to(positions, (B, S)).to(torch.int32)
        if prompt_len is not None:
            keep = (sp >= 0) & (sp < prompt_len)
            ckv = torch.where(keep[..., None], ckv, torch.zeros_like(ckv))
            k_rope = torch.where(keep[..., None], k_rope, torch.zeros_like(k_rope))
            sp = torch.where(keep, sp, -1)
        return out, {"ckv": ckv, "krope": k_rope, "slot_pos": sp}
    dh = cfg.head_dim
    k = L.matmul(x, p["wk"]).reshape(B, S, cfg.n_kv_heads, dh)
    v = L.matmul(x, p["wv"]).reshape(B, S, cfg.n_kv_heads, dh)
    if cfg.use_bias:
        k = k + L.value(p["bk"]).reshape(cfg.n_kv_heads, dh)
        v = v + L.value(p["bv"]).reshape(cfg.n_kv_heads, dh)
    cos, sin = L.rope_cos_sin(positions, dh, cfg.rope_theta, cfg.mrope_sections)
    kc = L.apply_rope(k, cos, sin).transpose(1, 2)
    vc = v.transpose(1, 2)
    pos2d = positions[0] if cfg.mrope_sections else positions
    sp = torch.broadcast_to(pos2d, (B, S)).to(torch.int32)
    if cfg.window and S >= cfg.window:
        # the ring: keep the trailing window, position p at slot p % W
        W = cfg.window
        slots = torch.arange(S - W, S, device=x.device) % W
        ring_k, ring_v = torch.zeros_like(kc[:, :, :W]), torch.zeros_like(vc[:, :, :W])
        ring_k[:, :, slots], ring_v[:, :, slots] = kc[:, :, S - W:], vc[:, :, S - W:]
        ring_sp = torch.full((B, W), -1, dtype=torch.int32, device=x.device)
        ring_sp[:, slots] = sp[:, S - W:]
        kc, vc, sp = ring_k, ring_v, ring_sp
    if prompt_len is not None:
        keep = (sp >= 0) & (sp < prompt_len)
        kc = torch.where(keep[:, None, :, None], kc, torch.zeros_like(kc))
        vc = torch.where(keep[:, None, :, None], vc, torch.zeros_like(vc))
        sp = torch.where(keep, sp, -1)
    return out, {"k": kc, "v": vc, "slot_pos": sp}


def _shared_attn_apply(shared: Params, xin, cfg: ModelConfig, positions, cache, fill_cache,
                       active=None, ctx: ShardCtx = LOCAL):
    """The Zamba2 weight-shared transformer block (attention + MLP)."""
    h = xin
    a, kv = _attention(shared["attn"], L.rmsnorm(h, shared["ln1"], cfg.rms_eps), cfg, positions,
                       cache, fill_cache, active, ctx=ctx)
    h = h + a
    h = h + L.mlp(shared["mlp"], L.rmsnorm(h, shared["ln2"], cfg.rms_eps), cfg.mlp_act)
    return h, kv


def _stack(*xs):
    """``torch.stack`` of one leaf's per-layer values: plain tensors, or
    ``Sharded`` leaves of one layout (a sharded recurrent state)."""
    return stack(xs) if isinstance(xs[0], Sharded) else torch.stack(xs)


def _layer_apply(p: Params, h, cfg: ModelConfig, kind: str, positions, cache, fill_cache,
                 shared: Optional[Params] = None, e0=None, active=None, prompt_len=None,
                 pages=None, rows_lanes=None, ctx: ShardCtx = LOCAL):
    """One layer (one unit for ``zamba_unit``).  Returns (h, cache_out,
    aux): the MoE load-balance loss, 0.0 for the other kinds."""
    aux = 0.0
    if kind == "mamba":
        y, cout = mamba_block(p["mamba"], L.rmsnorm(h, p["norm"], cfg.rms_eps), cfg,
                              cache=cache, fill_cache=fill_cache, ctx=ctx)
        return h + y, cout, aux
    if kind == "zamba_unit":
        mcaches = []
        for i in range(cfg.shared_attn_every):
            pi = tree_map(lambda x, i=i: x[i], p["mamba"])
            ci = tree_map(lambda x, i=i: x[i], cache["mamba"]) if cache is not None else None
            y, c = mamba_block(pi, L.rmsnorm(h, p["norms"][i], cfg.rms_eps), cfg,
                               cache=ci, fill_cache=fill_cache, ctx=ctx)
            h = h + y
            mcaches.append(c)
        xin = L.matmul(torch.cat([h, e0], dim=-1), p["in_proj"])
        xin = L.rmsnorm(xin, p["attn_norm"], cfg.rms_eps)
        u, kv = _shared_attn_apply(shared, xin, cfg, positions,
                                   cache["attn"] if cache is not None else None, fill_cache, active,
                                   ctx)
        cout = None
        if mcaches[0] is not None or kv is not None:
            cout = {"mamba": tree_map(_stack, *mcaches), "attn": kv}
        return h + u, cout, aux
    # attn_mlp / attn_moe.  Under a mesh whose model axis splits the
    # sequence, each norm runs on the row tiles of ``seq_spec`` (so its
    # bits do not depend on the layout), and with ``seq_shard_acts`` the
    # residual stays laid out so between the sub-blocks: the row-parallel
    # products reduce-scatter into it (``scatter``)
    spec = ctx.seq_spec(h.shape) if cache is None else None
    scatter = (ctx.mesh, spec) if spec is not None and ctx.seq_shard_acts else None

    def norm(w):
        if spec is None:
            return L.rmsnorm(h, w, cfg.rms_eps)
        return L.norm_gather(h, w, cfg.rms_eps, ctx.mesh, spec)

    a, cout = _attention(p["attn"], norm(p["ln1"]), cfg, positions, cache, fill_cache, active,
                         prompt_len, pages, rows_lanes, ctx, scatter)
    h = L.add(h, a)
    x2 = norm(p["ln2"])
    if kind == "attn_moe":
        y, aux = moe_block(p["moe"], x2, cfg, ctx, scatter)
    else:
        y = L.mlp(p["mlp"], x2, cfg.mlp_act, scatter)
    return L.add(h, y), cout, aux


# --------------------------------------------------------------------------
# rematerialisation (``ShardCtx.remat``)
# --------------------------------------------------------------------------
def _save_dots(_ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of
    products with no batch dimension (``mm``, ``addmm``; not ``bmm``),
    recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` (one layer) under JAX's per-layer ``jax.checkpoint`` policy:
    ``"full"`` saves nothing inside the layer and recomputes its forward
    in the backward (``nothing_saveable``), ``"dots"`` saves only the
    outputs of products with no batch dimension, ``"none"`` keeps every
    activation.  Only where grad is enabled: a forward without a
    backward (serving, prefill) keeps nothing either way.  The
    recomputation runs the same operators on the same inputs, so the
    grads are bitwise those of ``"none"``; a mamba layer's scan
    (``kernels.ssd_scan.SSDScan``, whose forward writes fresh outputs)
    launches K8 again under both policies."""
    if remat not in ("full", "dots", "none"):
        raise ValueError(f"remat={remat!r}: full | dots | none")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    if remat == "full":
        return lambda *a, **k: checkpoint(fn, *a, use_reentrant=False, **k)
    policy = functools.partial(create_selective_checkpoint_contexts, _save_dots)
    return lambda *a, **k: checkpoint(fn, *a, use_reentrant=False, context_fn=policy, **k)


# --------------------------------------------------------------------------
# forward / decode
# --------------------------------------------------------------------------
def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S), or (B, S, K) for K codebooks
    *,
    ctx: ShardCtx = LOCAL,
    positions: Optional[torch.Tensor] = None,
    vision_embeds: Optional[torch.Tensor] = None,
    fill_cache: bool = False,
    prompt_len=None,
    with_aux: bool = False,
):
    """Returns (logits, filled_cache | None), and with ``with_aux`` a
    third item ``(aux, h)``: the summed MoE load-balance loss and the
    final-normed hidden states (what ``loss_fn`` reads).

    ``vision_embeds`` (B, n, d), for a vision arch: the stub's precomputed
    patch embeddings, spliced over the first ``n_vision_tokens`` rows.
    ``prompt_len`` (serving's bucketed prefill): the true prompt length
    when ``tokens`` is right-padded to a bucket; the filled caches are
    scrubbed past it and logits at real positions are untouched.  Not for
    recurrent (mamba, zamba_unit) segments, which fold the padding in,
    nor for windowed or vision archs."""
    B, S = tokens.shape[:2]
    if prompt_len is not None and (cfg.window or cfg.n_vision_tokens or _recurrent(cfg)):
        raise ValueError(
            "prompt_len (bucket-padded prefill) requires full-attention text models: "
            "recurrent mamba state folds padding in, a sliding-window fill keeps "
            "trailing padded positions, and the vision splice depends on the "
            "physical prompt length"
        )
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :]
        if cfg.mrope_sections:
            positions = positions[None].expand(3, 1, S)
    h = embed_tokens(params, tokens, cfg, ctx)
    if vision_embeds is not None and cfg.n_vision_tokens:
        h = torch.cat([vision_embeds.to(h.dtype), h[:, cfg.n_vision_tokens:]], dim=1)
    e0 = h if cfg.shared_attn_every else None
    shared = params.get("shared_attn")
    caches = []
    aux_total = 0.0
    layer = _remat(_layer_apply, ctx.remat)
    # ``seq_shard_acts``: the residual laid out over the sequence from the
    # first attention layer on (a slice), gathered before a recurrent
    # layer and the final norm, which JAX leaves unconstrained
    seq = ctx.seq_spec(h.shape) if ctx.seq_shard_acts else None
    for seg, sp in zip(segment_plan(cfg), params["segments"]):
        couts = []
        for i in range(seg.count):
            if seg.kind in ("attn_mlp", "attn_moe") and seq is not None:
                h = h if isinstance(h, Sharded) else L.seq_scatter(h, ctx.mesh, seq)
            elif isinstance(h, Sharded):
                h = L.seq_gather(h)
            lp = tree_map(lambda x, i=i: x[i], sp)
            h, cout, aux = layer(lp, h, cfg, seg.kind, positions, None, fill_cache,
                                 shared, e0, prompt_len=prompt_len, ctx=ctx)
            aux_total = aux_total + aux
            couts.append(cout)
        caches.append(tree_map(lambda *xs: torch.stack(xs), *couts) if fill_cache else None)
    if isinstance(h, Sharded):
        h = L.seq_gather(h)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = unembed(params, h, cfg, ctx)
    cache_out = None
    if fill_cache:
        cache_out = {
            "segments": caches,
            "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
        }
    if with_aux:
        return logits, cache_out, (aux_total, h)
    return logits, cache_out


# --------------------------------------------------------------------------
# training loss
# --------------------------------------------------------------------------
def _xent(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean next-token cross-entropy in f32.  The label's logit is
    a gather: every row gathers one column, so its backward writes each
    element once and is deterministic (the §IV replicas must agree bit
    for bit).  JAX picks a one-hot product here for its vocab-sharded
    mesh, where the partitioner keeps the logits sharded; the port's
    vocab-sharded head (``unembed``) concatenates the members' logits
    first, so the gather serves the sharded layout too."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.take_along_dim(lf, labels[..., None].long(), dim=-1)[..., 0]
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(cfg: ModelConfig, params: Params, batch: dict, *, ctx: ShardCtx = LOCAL):
    """batch: tokens (B, S[, K]) int32, optional loss_mask (B, S),
    optional vision_embeds / positions.  Returns (loss, metrics).  Under
    a ``ctx`` with a mesh the forward runs on the sharded params."""
    tokens = batch["tokens"]
    logits, _, (aux, h) = forward(
        cfg, params, tokens, ctx=ctx, positions=batch.get("positions"),
        vision_embeds=batch.get("vision_embeds"), with_aux=True,
    )
    aux = torch.as_tensor(aux, dtype=torch.float32, device=tokens.device)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(tokens.shape[:2], dtype=torch.float32, device=tokens.device)
    if cfg.n_codebooks > 1:
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for k in range(cfg.n_codebooks):
            loss = loss + _xent(logits[:, :-1, k], tokens[:, 1:, k], mask[:, 1:])
        loss = loss / cfg.n_codebooks
    else:
        loss = _xent(logits[:, :-1], tokens[:, 1:], mask[:, 1:])
    metrics = {"xent": loss, "aux": aux}
    if cfg.mtp:
        # predict t+2 from (h_t, embed(tok_{t+1})): the simplified MTP head
        emb_next = embed_tokens(params, tokens[:, 1:], cfg, ctx)
        h_mtp = L.matmul(torch.cat([h[:, :-1], emb_next], dim=-1), params["mtp_proj"])
        h_mtp = L.rmsnorm(h_mtp, params["mtp_norm"], cfg.rms_eps)
        logits2 = unembed(params, h_mtp, cfg, ctx)
        mtp_loss = _xent(logits2[:, :-1], tokens[:, 2:], mask[:, 2:])
        metrics["mtp"] = mtp_loss
        loss = loss + 0.1 * mtp_loss
    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


def _attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    if cfg.attn_type == "mla":
        return L.mla_cache_init(cfg, batch, max_len, device)
    return L.gqa_cache_init(cfg, batch, max_len, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    out = []
    for seg in segment_plan(cfg):
        if seg.kind == "mamba":
            one = mamba_cache_init(cfg, batch, device)
        elif seg.kind == "zamba_unit":
            one = {"mamba": tree_map(lambda x: torch.stack([x] * seg.sub),
                                     mamba_cache_init(cfg, batch, device)),
                   "attn": _attn_cache_init(cfg, batch, max_len, device)}
        else:
            one = _attn_cache_init(cfg, batch, max_len, device)
        out.append(tree_map(lambda x: torch.stack([x] * seg.count), one))
    return {"segments": out, "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int, page_size: int,
                     device) -> dict:
    """Paged serving cache: per-layer page POOLS shared by every slot (the
    page axis replaces the batch axis of the dense cache), plus the
    per-slot ``pos``.  Attention-only: recurrent (mamba, zamba) state is
    not pageable, and callers fall back to ``init_cache``.  Every segment
    has pools of the same pages, so one page table serves them all."""
    if _recurrent(cfg):
        raise ValueError("paged cache requires attention-only models")
    if cfg.window:
        raise ValueError("paged cache excludes sliding-window archs")
    out = []
    for seg in segment_plan(cfg):
        if cfg.attn_type == "mla":
            one = L.mla_paged_cache_init(cfg, n_pages, page_size, device)
        else:
            one = L.gqa_paged_cache_init(cfg, n_pages, page_size, device)
        out.append(tree_map(lambda x: torch.stack([x] * seg.count), one))
    return {"segments": out, "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: dict,
    tokens: torch.Tensor,
    *,
    ctx: ShardCtx = LOCAL,
    active: Optional[torch.Tensor] = None,
    pages: Optional[torch.Tensor] = None,
):
    """One serve step: tokens (B, 1[, K]) -> (logits (B, 1[, K], V), new cache).

    ``active`` (B,) bool is the continuous batcher's slot mask: inactive
    slots keep their cache bytes and position.  ``pages`` (B, P) switches
    to the paged pools (one paged-attention kernel launch per layer).

    The cache is written out of place, and the input ``cache`` is left
    untouched — the serving engine keeps it as the immutable previous
    buffer of the §IV replay.  Attention caches (a whole segment's, or a
    zamba unit's ``attn``) are copied once and every layer writes its new
    lane into the copy; mamba states are stacked new from the per-layer
    states the recurrence returns.

    Under a ``ctx`` with a mesh the cache is ``Sharded`` (``shard(cache,
    cache_pspecs(ctx, cache, cfg), mesh)``) and comes back so: each
    member's shard is copied once and written in place by its layers,
    and ``pos`` stays laid out over the data axes.  A paged GQA pool is
    laid out the same way (pages over the data axes, kv heads or each
    page's lanes over the model axis) and read through the global
    ``pages`` table: the step's write rows and each member's table come
    from it once (``distributed.decode.paged_plan``) for every layer;
    a paged MLA latent pool (pages over the data axes, each page's lanes
    over the model axis) too."""
    pos_leaf = cache["pos"]
    pos = L.value(pos_leaf)
    positions = pos[:, None]
    if cfg.mrope_sections:
        positions = positions[None].expand(3, -1, 1)
    h = embed_tokens(params, tokens, cfg, ctx)
    e0 = h if cfg.shared_attn_every else None
    shared = params.get("shared_attn")
    rows_lanes = None
    if pages is not None:
        # the stacked pool: (L, N, Hkv, ps, D) for GQA, (L, N, ps, lora) for
        # MLA; every segment's pools have the same pages
        pool = cache["segments"][0]["ckv" if cfg.attn_type == "mla" else "k"]
        rows_lanes = L.paged_write_rows(pages, pos, active, pool.shape[1], pool.shape[-2])
        if isinstance(pool, Sharded):
            rows_lanes = DD.paged_plan(pool, pages, pos, rows_lanes,
                                       latent=cfg.attn_type == "mla")
    new_segs = []
    for seg, sp, sc in zip(segment_plan(cfg), params["segments"], cache["segments"]):
        attn = None
        if seg.kind != "mamba":
            attn = {k: v.clone() for k, v in (sc["attn"] if seg.kind == "zamba_unit" else sc).items()}
        states = []
        for i in range(seg.count):
            lp = tree_map(lambda x, i=i: x[i], sp)
            lattn = {k: v[i] for k, v in attn.items()} if attn is not None else None  # views
            if seg.kind == "mamba":
                lc = tree_map(lambda x, i=i: x[i], sc)
            elif seg.kind == "zamba_unit":
                lc = {"mamba": tree_map(lambda x, i=i: x[i], sc["mamba"]), "attn": lattn}
            else:
                lc = lattn
            h, cout, _ = _layer_apply(lp, h, cfg, seg.kind, positions, lc, False, shared, e0,
                                      active, None, pages, rows_lanes, ctx)
            if seg.kind in ("mamba", "zamba_unit"):
                states.append(cout if seg.kind == "mamba" else cout["mamba"])
        if seg.kind == "mamba":
            new_segs.append(tree_map(_stack, *states))
        elif seg.kind == "zamba_unit":
            new_segs.append({"mamba": tree_map(_stack, *states), "attn": attn})
        else:
            new_segs.append(attn)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = unembed(params, h, cfg, ctx)
    new_pos = pos + 1 if active is None else pos + active.to(pos.dtype)
    if isinstance(pos_leaf, Sharded):
        new_pos = shard_leaf(new_pos, pos_leaf.spec, pos_leaf.mesh)
    return logits, {"segments": new_segs, "pos": new_pos}
