"""The decoder-only LM, GQA/MLA + MLP and Mamba2 segments (a port of the
matching subset of ``repro/models/transformer.py``).

Parameters are the JAX package's tree: ``{"embed", "final_norm",
"segments": [stacked per-layer dicts]}`` (plus ``lm_head`` when untied
and ``mtp_proj``/``mtp_norm`` for a multi-token-prediction head), each
segment's leaves carrying a leading layer axis.  Layers run as a Python
loop over that axis.  Segment kinds:

  attn_mlp  -- [norm -> attention (GQA or MLA) -> residual]
               [norm -> MLP -> residual]
  mamba     -- [norm -> mamba2 block -> residual]

Entry points:
  forward(...)      logits (prefill; optional cache fill with prompt_len)
  decode_step(...)  one-token serve step over a dense or paged KV cache
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..tree import tree_map
from . import layers as L
from .config import ModelConfig
from .ssm import mamba_block, mamba_cache_init, mamba_init

Params = dict


# --------------------------------------------------------------------------
# segment plan
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str  # attn_mlp | mamba
    count: int  # layers in the segment


def segment_plan(cfg: ModelConfig) -> list[Segment]:
    if cfg.mixer_type == "mamba2" and cfg.n_codebooks == 1:
        if cfg.shared_attn_every:
            raise NotImplementedError(
                f"{cfg.name}: zamba_unit segments (mamba layers with a shared "
                "attention block) are not ported yet (P12)"
            )
        return [Segment("mamba", cfg.n_layers)]
    if cfg.mixer_type == "moe":
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (P12's MoE item); serve the "
            "dense layers alone (configs.deepseek_v3_671b.dense_prefix)"
        )
    if cfg.mixer_type != "mlp" or cfg.attn_type not in ("gqa", "mla") or cfg.n_codebooks != 1:
        raise NotImplementedError(
            f"{cfg.name}: only GQA/MLA + MLP and Mamba2 text decoders are ported "
            f"(mixer={cfg.mixer_type}, attn={cfg.attn_type})"
        )
    return [Segment("attn_mlp", cfg.n_layers)]


def _recurrent(cfg: ModelConfig) -> bool:
    return any(seg.kind == "mamba" for seg in segment_plan(cfg))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _layer_init(gen, cfg: ModelConfig, kind: str, device) -> Params:
    d, dt = cfg.d_model, cfg.compute_dtype
    if kind == "mamba":
        return {"norm": torch.ones((d,), dtype=dt, device=device),
                "mamba": mamba_init(gen, cfg, device)}
    return {
        "ln1": torch.ones((d,), dtype=dt, device=device),
        "ln2": torch.ones((d,), dtype=dt, device=device),
        "attn": L.mla_init(gen, cfg, device) if cfg.attn_type == "mla" else L.gqa_init(gen, cfg, device),
        "mlp": L.mlp_init(gen, d, cfg.d_ff, cfg.mlp_act, dt, device),
    }


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Params:
    """Random weights from ``gen``, laid out as the JAX package's tree
    (the draws differ: torch cannot reproduce ``jax.random``)."""
    dt = cfg.compute_dtype
    d, V = cfg.d_model, cfg.vocab_size
    embed = torch.randn((V, d), generator=gen, dtype=torch.float32, device=device) * 0.02
    params: Params = {"embed": embed.to(dt), "final_norm": torch.ones((d,), dtype=dt, device=device)}
    segs = []
    for seg in segment_plan(cfg):
        layers = [_layer_init(gen, cfg, seg.kind, device) for _ in range(seg.count)]
        segs.append(tree_map(lambda *xs: torch.stack(xs), *layers))
    params["segments"] = segs
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, d, V, dt, device)
    if cfg.mtp:
        # the multi-token-prediction head: built as JAX builds it (the
        # trees match), read only by training, which is not ported
        params["mtp_proj"] = L.dense_init(gen, 2 * d, d, dt, device)
        params["mtp_norm"] = torch.ones((d,), dtype=dt, device=device)
    return params


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------
def embed_tokens(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"][tokens.long()]


def unembed(params: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


# --------------------------------------------------------------------------
# layer bodies
# --------------------------------------------------------------------------
def _attention(p, x, cfg: ModelConfig, positions, cache, fill_cache, active=None,
               prompt_len=None, pages=None, rows_lanes=None):
    """Returns (out, cache_out): the updated cache (decode), the filled
    cache (fill_cache), or None.  ``prompt_len`` masks the fill for
    bucket-padded prefill: entries at positions >= prompt_len are
    scrubbed (slot_pos = -1, zero K/V), so the filled cache equals an
    exact-length prefill's."""
    fn = L.mla_attention if cfg.attn_type == "mla" else L.gqa_attention
    if cache is not None:
        return fn(p, x, cfg, positions=positions, cache=cache, active=active, pages=pages,
                  rows_lanes=rows_lanes)
    out, _ = fn(p, x, cfg, positions=positions, cache=None)
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
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, dh)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, dh)
    if cfg.use_bias:
        k = k + p["bk"].reshape(cfg.n_kv_heads, dh)
        v = v + p["bv"].reshape(cfg.n_kv_heads, dh)
    cos, sin = L.rope_cos_sin(positions, dh, cfg.rope_theta, cfg.mrope_sections)
    kc = L.apply_rope(k, cos, sin).transpose(1, 2)
    vc = v.transpose(1, 2)
    if cfg.window and S >= cfg.window:
        raise NotImplementedError("sliding-window cache fill is not ported yet")
    sp = torch.broadcast_to(positions, (B, S)).to(torch.int32)
    if prompt_len is not None:
        keep = (sp >= 0) & (sp < prompt_len)
        kc = torch.where(keep[:, None, :, None], kc, torch.zeros_like(kc))
        vc = torch.where(keep[:, None, :, None], vc, torch.zeros_like(vc))
        sp = torch.where(keep, sp, -1)
    return out, {"k": kc, "v": vc, "slot_pos": sp}


def _layer_apply(p: Params, h, cfg: ModelConfig, kind: str, positions, cache, fill_cache,
                 active=None, prompt_len=None, pages=None, rows_lanes=None):
    """One layer: [norm -> attention -> residual] [norm -> MLP -> residual],
    or [norm -> mamba2 block -> residual].  Returns (h, cache_out)."""
    if kind == "mamba":
        y, cout = mamba_block(p["mamba"], L.rmsnorm(h, p["norm"], cfg.rms_eps), cfg,
                              cache=cache, fill_cache=fill_cache)
        return h + y, cout
    a, cout = _attention(p["attn"], L.rmsnorm(h, p["ln1"], cfg.rms_eps), cfg,
                         positions, cache, fill_cache, active, prompt_len,
                         pages, rows_lanes)
    h = h + a
    h = h + L.mlp(p["mlp"], L.rmsnorm(h, p["ln2"], cfg.rms_eps), cfg.mlp_act)
    return h, cout


# --------------------------------------------------------------------------
# forward / decode
# --------------------------------------------------------------------------
def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,  # (B, S)
    *,
    positions: Optional[torch.Tensor] = None,
    fill_cache: bool = False,
    prompt_len=None,
):
    """Returns (logits, filled_cache | None).

    ``prompt_len`` (serving's bucketed prefill): the true prompt length
    when ``tokens`` is right-padded to a bucket; the filled caches are
    scrubbed past it and logits at real positions are untouched.  Not for
    recurrent (mamba) segments: their state folds the padding in."""
    B, S = tokens.shape[:2]
    if prompt_len is not None and (cfg.window or _recurrent(cfg)):
        raise ValueError(
            "prompt_len (bucket-padded prefill) requires full-attention models: "
            "recurrent mamba state folds padding in, a sliding-window fill keeps "
            "trailing padded positions"
        )
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :]
    h = embed_tokens(params, tokens, cfg)
    caches = []
    for seg, sp in zip(segment_plan(cfg), params["segments"]):
        couts = []
        for i in range(seg.count):
            lp = tree_map(lambda x, i=i: x[i], sp)
            h, cout = _layer_apply(lp, h, cfg, seg.kind, positions, None, fill_cache,
                                   prompt_len=prompt_len)
            couts.append(cout)
        caches.append(tree_map(lambda *xs: torch.stack(xs), *couts) if fill_cache else None)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = unembed(params, h, cfg)
    cache_out = None
    if fill_cache:
        cache_out = {
            "segments": caches,
            "pos": torch.full((B,), S, dtype=torch.int32, device=tokens.device),
        }
    return logits, cache_out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    out = []
    for seg in segment_plan(cfg):
        if seg.kind == "mamba":
            one = mamba_cache_init(cfg, batch, device)
        elif cfg.attn_type == "mla":
            one = L.mla_cache_init(cfg, batch, max_len, device)
        else:
            one = L.gqa_cache_init(cfg, batch, max_len, device)
        out.append(tree_map(lambda x: torch.stack([x] * seg.count), one))
    return {"segments": out, "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def init_paged_cache(cfg: ModelConfig, batch: int, n_pages: int, page_size: int,
                     device) -> dict:
    """Paged serving cache: per-layer page POOLS shared by every slot (the
    page axis replaces the batch axis of the dense cache), plus the
    per-slot ``pos``.  Attention-only: recurrent (mamba) state is not
    pageable, and callers fall back to ``init_cache``."""
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
    active: Optional[torch.Tensor] = None,
    pages: Optional[torch.Tensor] = None,
):
    """One serve step: tokens (B, 1) -> (logits (B, 1, V), new cache).

    ``active`` (B,) bool is the continuous batcher's slot mask: inactive
    slots keep their cache bytes and position.  ``pages`` (B, P) switches
    to the paged pools (one paged-attention kernel launch per layer).

    The cache is written out of place, and the input ``cache`` is left
    untouched — the serving engine keeps it as the immutable previous
    buffer of the §IV replay.  Attention segments copy every stacked
    cache leaf once and write their new lane into the copy; mamba
    segments stack the new per-layer states the recurrence returns."""
    pos = cache["pos"]
    positions = pos[:, None]
    h = embed_tokens(params, tokens, cfg)
    rows_lanes = None
    if pages is not None:
        # the stacked pool: (L, N, Hkv, ps, D) for GQA, (L, N, ps, lora) for MLA
        pool = cache["segments"][0]["ckv" if cfg.attn_type == "mla" else "k"]
        rows_lanes = L.paged_write_rows(pages, pos, active, pool.shape[1], pool.shape[-2])
    new_segs = []
    for seg, sp, sc in zip(segment_plan(cfg), params["segments"], cache["segments"]):
        if seg.kind == "mamba":
            couts = []
            for i in range(seg.count):
                lp = tree_map(lambda x, i=i: x[i], sp)
                lc = tree_map(lambda x, i=i: x[i], sc)
                h, cout = _layer_apply(lp, h, cfg, seg.kind, positions, lc, False)
                couts.append(cout)
            new_segs.append(tree_map(lambda *xs: torch.stack(xs), *couts))
            continue
        new_c = {k: v.clone() for k, v in sc.items()}
        for i in range(seg.count):
            lp = tree_map(lambda x, i=i: x[i], sp)
            lc = {k: v[i] for k, v in new_c.items()}  # views into the copy
            h, _ = _layer_apply(lp, h, cfg, seg.kind, positions, lc, False, active, None,
                                pages, rows_lanes)
        new_segs.append(new_c)
    h = L.rmsnorm(h, params["final_norm"], cfg.rms_eps)
    logits = unembed(params, h, cfg)
    new_pos = pos + 1 if active is None else pos + active.to(pos.dtype)
    return logits, {"segments": new_segs, "pos": new_pos}
