"""The LM serving stack as a MISO program (the serving subset of
``repro/models/lm_cells.py``).

    cell weights  -- static cell (identity transition) holding the params
    cell decoder  -- slot-masked state (KV cache or page pools + page
                     table, last tokens, prompt-walk cursor); transition =
                     one greedy decode step for every active slot

Per-request replication (paper §IV) happens on replica *slots* of the
decoder batch (``repro_torch.serving``), not on the cells.  Training
cells, the fixed-batch ``make_serve_program`` and speculative decoding
are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import CellType, MisoProgram
from . import transformer as T
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The JAX package's ``ServeConfig`` (see there), without the
    fixed-batch ``prefill_len``."""

    batch: int
    max_len: int  # cache capacity
    param_seed: int = 0
    #: the out-of-band prefill forward covers at most this many prompt
    #: tokens; the tail is walked inside the resident transition (0 =
    #: whole prompt)
    prefill_chunk: int = 0
    #: smallest prefill bucket of the geometric ladder (0 = no bucketing)
    prefill_bucket_min: int = 16
    #: explicit bucket ladder override (sorted lengths); () = geometric
    prefill_buckets: tuple = ()
    #: paged KV cache: slot KV lives in fixed-size pages of one shared pool
    paged: bool = False
    #: tokens per KV page; ``max_len`` must be a multiple of it
    page_size: int = 16
    #: total pages in the pool; 0 = batch * (max_len / page_size)
    page_budget: int = 0
    spec: object = None
    placement: str = "temporal"

    def __post_init__(self):
        if self.spec is not None:
            raise NotImplementedError("speculative decoding is not ported yet")
        if self.placement != "temporal":
            raise NotImplementedError("spatial placement is not ported yet")


def prefill_bucket_ladder(scfg: ServeConfig) -> tuple:
    """The prefill bucket ladder: explicit override, or geometric doubling
    from ``prefill_bucket_min`` capped at ``max_len``; () when disabled."""
    if scfg.prefill_buckets:
        return tuple(
            sorted({min(b, scfg.max_len) for b in scfg.prefill_buckets if b > 0} | {scfg.max_len})
        )
    if scfg.prefill_bucket_min <= 0:
        return ()
    ladder, b = [], min(scfg.prefill_bucket_min, scfg.max_len)
    while b < scfg.max_len:
        ladder.append(b)
        b *= 2
    ladder.append(scfg.max_len)
    return tuple(ladder)


def _slot_leaves(batch: int, max_len: int, device) -> dict:
    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "tokens": z(batch, 1),
        "active": z(batch, dtype=torch.bool),
        "n_decoded": z(batch),
        "pending": z(batch, max_len),
        "p_head": z(batch),
        "p_len": z(batch),
    }


def slot_decoder_init(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Decoder-cell state for the continuous batcher: every leaf is
    per-slot, so requests can join/leave individual slots between ticks.
    ``active`` is the slot mask; ``pending``/``p_head``/``p_len`` hold the
    prompt tail the transition walks one token per sub-step."""
    return {"cache": T.init_cache(cfg, batch, max_len, device), **_slot_leaves(batch, max_len, device)}


def paged_serving_supported(cfg: ModelConfig) -> bool:
    """Archs whose serve cache can live in pages: pure-attention text
    models (callers fall back to the dense cache for the others)."""
    return cfg.mixer_type != "mamba2" and not cfg.window and not cfg.n_vision_tokens


def paged_pool_pages(scfg: ServeConfig) -> int:
    """Total pages in the shared pool (``page_budget`` override, else
    capacity-equivalent to the dense cache)."""
    return scfg.page_budget or scfg.batch * (scfg.max_len // scfg.page_size)


def paged_slot_decoder_init(cfg: ModelConfig, batch: int, max_len: int, page_size: int,
                            n_pages: int, device) -> dict:
    """Paged variant of ``slot_decoder_init``: shared page POOLS plus a
    per-slot page table ``pages`` ((batch, max_len/page_size) int32 pool
    rows, -1 = unmapped).  Pool leaves carry no slot axis."""
    if max_len % page_size:
        raise ValueError(
            f"max_len ({max_len}) must be a multiple of page_size ({page_size}): "
            "the paged-decode kernel gathers whole pages"
        )
    return {
        "cache": T.init_paged_cache(cfg, batch, n_pages, page_size, device),
        **_slot_leaves(batch, max_len, device),
        "pages": torch.full((batch, max_len // page_size), -1, dtype=torch.int32, device=device),
    }


def make_slot_serve_program(cfg: ModelConfig, scfg: ServeConfig) -> MisoProgram:
    """The serving engine's resident program: a static ``weights`` cell
    plus a *slot-masked* ``decoder`` cell.  The decoder gates every state
    write on the per-slot ``active`` mask, and each batch row's math is
    row-independent, so an active slot's trajectory does not depend on
    which other slots are occupied — the isolation invariant the
    continuous batcher is built on."""
    from ..serving.slots import infer_slot_axes, mask_slots

    def w_init(gen, device):
        # the weights draw from their own generator, seeded from the
        # program's seed and ``param_seed``
        g = torch.Generator(device=device).manual_seed(gen.initial_seed() + scfg.param_seed)
        return {"params": T.init_params(cfg, g, device)}

    weights = CellType(name="weights", init=w_init, transition=lambda prev: prev["weights"])

    paged = scfg.paged and paged_serving_supported(cfg)
    if paged:
        from ..serving.paging import infer_paged_axes, mask_slots_paged

        n_pages = paged_pool_pages(scfg)
        axes = infer_paged_axes(
            lambda b: paged_slot_decoder_init(cfg, b, scfg.max_len, scfg.page_size, n_pages, "meta")
        )
        mask_fn = mask_slots_paged

        def d_init(gen, device):
            return paged_slot_decoder_init(cfg, scfg.batch, scfg.max_len, scfg.page_size, n_pages, device)

    else:
        axes = infer_slot_axes(lambda b: slot_decoder_init(cfg, b, scfg.max_len, "meta"))
        mask_fn = mask_slots

        def d_init(gen, device):
            return slot_decoder_init(cfg, scfg.batch, scfg.max_len, device)

    # bounded k-token prefill walk: prefill_chunk > 1 drains up to k
    # pending prompt tokens per tick (k sub-steps; non-walking slots step
    # once, in the first)
    n_sub = max(1, scfg.prefill_chunk)

    def sub_step(st, weights_params, j: int):
        act = st["active"]
        walking = act & (st["p_head"] < st["p_len"])
        elig = act if j == 0 else walking
        idx = st["p_head"].clamp(0, scfg.max_len - 1).long()
        nxt_p = st["pending"].gather(1, idx[:, None])
        # walkers feed their next prompt token, the others their last argmax
        tok_in = torch.where(walking[:, None], nxt_p, st["tokens"])
        logits, cache = T.decode_step(
            cfg, weights_params, st["cache"], tok_in, active=elig, pages=st.get("pages")
        )
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).reshape(st["tokens"].shape)
        new = {
            "cache": cache,
            "tokens": nxt,
            "active": act,
            "n_decoded": st["n_decoded"] + (elig & ~walking).to(torch.int32),
            "pending": st["pending"],
            "p_head": st["p_head"] + (elig & walking).to(torch.int32),
            "p_len": st["p_len"],
        }
        if paged:
            new["pages"] = st["pages"]
        # gate the whole writeback on the eligibility mask
        return mask_fn(elig, new, st, axes)

    def d_transition(prev):
        st = prev["decoder"]
        wp = prev["weights"]["params"]
        for j in range(n_sub):
            st = sub_step(st, wp, j)
        return st

    decoder = CellType(
        name="decoder", init=d_init, transition=d_transition, reads=("weights",),
        instances=scfg.batch,
    )
    prog = MisoProgram()
    prog.add(weights)
    prog.add(decoder)
    return prog


def install_prefill(cfg: ModelConfig, full: dict, filled: dict, plen) -> dict:
    """Copy a prefill cache into a max_len-capacity cache: every leaf whose
    length differs is padded (``slot_pos`` with -1 so padded lanes read as
    empty) and ``pos = plen``."""

    def leaf(d, s):
        if d.shape == s.shape:
            return s.to(d.dtype)
        ax = next(i for i in range(d.dim()) if d.shape[i] != s.shape[i])
        fill = 0 if s.is_floating_point() else -1
        out = torch.full(d.shape, fill, dtype=d.dtype, device=d.device)
        out.narrow(ax, 0, s.shape[ax]).copy_(s)
        return out

    segs = [
        {k: leaf(d[k], s[k]) for k in d} for d, s in zip(full["segments"], filled["segments"])
    ]
    return {"segments": segs, "pos": torch.full_like(full["pos"], int(plen))}


def prefill_slot_state(
    cfg: ModelConfig,
    scfg: ServeConfig,
    params,
    prompt: torch.Tensor,
    *,
    prompt_len=None,
    pending=None,
    n_pending=None,
) -> tuple[dict, torch.Tensor]:
    """Run the prefill for ONE prompt (head chunk) and package it as a
    width-1 dense decoder slot state, ready to join a free slot.

    prompt: (P,) int32; P may be a bucket, with ``prompt_len`` the true
    head length (padded cache positions are masked and the first token is
    read at ``prompt_len - 1``).  ``pending``/``n_pending``: the uncovered
    prompt tail, (max_len,) zero-padded + its length.  Returns
    ``(slot_state, first_token)``."""
    dev = prompt.device
    tokens = prompt[None]
    plen = tokens.shape[1] if prompt_len is None else int(prompt_len)
    logits, cache = T.forward(cfg, params, tokens, fill_cache=True, prompt_len=prompt_len)
    full = T.init_cache(cfg, 1, scfg.max_len, dev)
    first = torch.argmax(logits[:, plen - 1 : plen], dim=-1).to(torch.int32)  # (1, 1)
    if pending is None:
        pending = torch.zeros((1, scfg.max_len), dtype=torch.int32, device=dev)
        n_pending = 0
    st = {
        "cache": install_prefill(cfg, full, cache, plen),
        "tokens": first,
        "active": torch.ones((1,), dtype=torch.bool, device=dev),
        "n_decoded": torch.zeros((1,), dtype=torch.int32, device=dev),
        "pending": pending.to(torch.int32).reshape(1, scfg.max_len),
        "p_head": torch.zeros((1,), dtype=torch.int32, device=dev),
        "p_len": torch.full((1,), int(n_pending), dtype=torch.int32, device=dev),
    }
    return st, first
