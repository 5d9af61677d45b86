"""Flash-decoding over a tensor-parallel mesh: keep decode caches sharded,
always (a port of ``repro/distributed/decode.py``).

The JAX package runs these bodies under ``shard_map``; here one
controller runs every member's body on the member's own cache shard (a
``Sharded`` leaf, ``distributed/sharding.py``) and combines the members
with the collectives of ``distributed/collectives.py``, in member order:

  * the cache never moves: each member updates its own slice (a local
    write masked to the owning member);
  * attention runs as a partial softmax per member (flash-decoding, the
    "split-KV" axis being the model axis of the mesh);
  * members combine with three small collectives: pmax(m), psum(l),
    psum(ctx).

Two cache layouts, matching ``sharding.cache_pspecs``:
  * head-sharded (n_kv_heads % tp == 0): update and attention are local
    to each member; on the card each member's attention is the paged GQA
    kernel (K5) over its own contiguous shard (``dense_gqa_view``);
  * seq-sharded (cache length % tp == 0): each member's ``(ctx, m, l)``
    over its lanes ``[lo, lo + S_l)``; on the card from K5's split
    kernel (``paged_gqa_partials``), then the flash-decoding combine.
Anything else returns None, and the caller decodes each data member's
rows on its own (``local_decode``; the cache then has no model axis).
MLA's latent cache is sequence-sharded; each member's partial is, on the
card, K6's partials entry point (``paged_mla_partials``) over its lanes
read in place, and on the CPU the plain torch math of JAX's
``mla_decode`` body.  Where the model axis does not divide the lanes (or
is 1, or ``tp_off``), ``mla_decode`` returns None and
``local_mla_decode`` decodes each data member's rows over its own latent
block, on the card through K6 as the unsharded decode does.  The members
of a model group combine in ``_combine_partials``.

A paged pool (N, Hkv, ps, D) under a mesh (``paged_gqa_decode``) is laid
out by the same ``cache_pspecs`` rule: pages over the data axes, and kv
heads over the model axis when they divide, else each page's lanes.  The
page table stays one global table; each decode step derives every
member's writes, table and positions from it once (``paged_plan``).
Where every member holds all pages and lanes (a (1, M) mesh whose kv
heads divide) each member runs K5 over its kv heads; else each member
runs K5's partials entry point over what it holds, and the partials
combine over the splitting axes: by lane block in member order when only
the lanes split, and by logical page when the pages split, so a slot's
result never depends on which member holds its pages (DMR/TMR replica
slots hold different rows and must agree bit for bit).  A paged MLA
latent pool (N, ps, lora) under a mesh (``paged_mla_decode``) takes the
same plan, with the pages over the data axes and each page's lanes over
the model axis: K6 a block where every block holds every page and lane,
else K6's partials entry point, combined the same way.

The caller's activations are ordinary tensors on the controller's
device (``q`` (B, Hq, 1, D) with every head): a member reads its rows
(and heads), and the output is assembled there again.  The cache is
written in place: ``decode_step`` hands every layer views of a fresh
copy of the members' shards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.paged_decode import (NEG_INF, attend, dense_decode_on_card, dense_gqa_view,
                                    dense_mla_decode, dense_mla_view, gate, paged_gqa_attention,
                                    paged_gqa_partials, paged_mla_attention, paged_mla_partials,
                                    ring_lane_pos)
from . import collectives as C
from . import wire
from .sharding import _key


def _tp(ctx) -> tuple[Optional[str], int]:
    if ctx.tp_off or ctx.mesh is None:
        return None, 1
    ma = ctx.model_axis
    return ma, ctx.mesh.shape[ma]


def _groups(x, ma: str) -> list[list[tuple]]:
    """The model-axis groups of ``x``'s members whose shards have not
    been seen yet (members on one device that share their shards, such
    as the data members of a cache replicated over data, are one
    group)."""
    seen, out = set(), []
    for c in x.coords():
        if c[x.mesh.axis_names.index(ma)] != 0 or id(x.local(c)) in seen:
            continue
        group = x.mesh.members(c, ma)
        seen.update(id(x.local(g)) for g in group)
        out.append(group)
    return out


# ===========================================================================
# GQA / MQA / MHA / SWA
# ===========================================================================
def gqa_decode(q, k_new, v_new, cache, pos, *, cfg, ctx, active=None):
    """q (B,Hq,1,D); k_new/v_new (B,Hkv,D); cache {"k","v","slot_pos"} of
    ``Sharded`` leaves laid out by ``cache_pspecs``.  ``active`` is the
    serving batcher's per-slot mask (B, bool): inactive slots keep their
    cache bytes.  Returns (out (B,Hq,1,D), cache) with the cache still
    sharded (written in place), or None when no layout divides."""
    B, Hq, _, Dk = q.shape
    Hkv = k_new.shape[1]
    S = cache["k"].shape[2]
    ma, tp = _tp(ctx)
    head_ok = tp > 1 and Hkv % tp == 0 and Hq % tp == 0
    seq_ok = tp > 1 and S % tp == 0
    if ctx.mesh is None or tp == 1 or not (head_ok or seq_ok):
        return None  # caller falls back to each data member's rows
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=q.device)
    if head_ok:
        return local_decode(q, k_new, v_new, cache, pos, cfg=cfg, active=active), cache
    return _seq_decode(q, k_new, v_new, cache, pos, cfg=cfg, ctx=ctx, active=active), cache


def local_decode(q, k_new, v_new, cache, pos, *, cfg, active):
    """Each member updates and attends over its own cache block (its rows
    and kv heads, all lanes): the head-sharded body, and with a cache
    that has no model axis the per-data-member fallback.  Members that
    share one tensor compute once.  Returns out (B,Hq,1,D)."""
    kc, vc, sp = cache["k"], cache["v"], cache["slot_pos"]
    G = q.shape[1] // k_new.shape[1]
    out = torch.empty_like(q)
    for c, kt in kc.distinct():
        rows, heads = kc.block(c)[:2]
        qh = slice(heads.start * G, heads.stop * G)
        dev = kt.device
        qm, pm, am = (t.to(dev) for t in (q[rows, qh], pos[rows], active[rows]))
        spt = sp.local(c)
        _update_local_slot(kt, vc.local(c), spt, k_new[rows, heads].to(dev),
                           v_new[rows, heads].to(dev), pm, active=am)
        o = _softmax_attend(qm, kt, vc.local(c), spt, pm, cfg.window)
        out[rows, qh] = o.to(out.device)
    return out


def _seq_decode(q, k_new, v_new, cache, pos, *, cfg, ctx, active):
    """Seq-sharded cache: each member writes the lane it owns and gives
    its partial softmax over its lanes; the model group combines them."""
    ma, tp = _tp(ctx)
    kc, vc, sp = cache["k"], cache["v"], cache["slot_pos"]
    B, Hq, _, Dk = q.shape
    Hkv, Dv = k_new.shape[1], vc.shape[-1]
    S = kc.shape[2]
    scale = Dk**-0.5
    out = torch.empty_like(q)
    for group in _groups(kc, ma):
        rows = kc.block(group[0])[0]
        ctxs, ms, ls = [], [], []
        for c in group:
            kt, vt = kc.local(c), vc.local(c)
            dev = kt.device
            lo, S_l = kc.block(c)[2].start, kt.shape[2]
            qm, pm, am = (t.to(dev) for t in (q[rows], pos[rows], active[rows]))
            spv = sp.local(c)[:, lo: lo + S_l]  # the member's lanes of the replicated table
            _update_local_slot(kt, vt, spv, k_new[rows].to(dev), v_new[rows].to(dev), pm,
                               lo=lo, tp=tp, active=am)
            if dense_decode_on_card(dev):
                bound = (ring_lane_pos(pm, S) - lo).to(torch.int32).contiguous()
                a, m, l = paged_gqa_partials(qm[:, :, 0].contiguous(), *dense_gqa_view(kt, vt),
                                             bound, scale=scale)
                B_l = a.shape[0]
                a, m, l = (a.reshape(B_l, Hkv, Hq // Hkv, Dv), m.reshape(B_l, Hkv, -1),
                           l.reshape(B_l, Hkv, -1))
            else:
                a, m, l = _partial_attend(qm, kt, vt, spv, pm, cfg.window, scale)
            ctxs.append(a)
            ms.append(m)
            ls.append(l)
        o = _combine_partials(ctxs, ms, ls)
        out[rows] = o.reshape(o.shape[0], Hq, 1, Dv).to(q.dtype).to(out.device)
    return out


def _combine_partials(ctxs, ms, ls):
    """The flash-decoding combine of one model group's partials, in member
    order, as JAX's: ``m_g = pmax(m)``, ``alpha = exp(m - m_g)``, ``l_g =
    psum(l * alpha)``, ``ctx_g = psum(ctx * alpha)``, then ``ctx_g /
    max(l_g, 1e-30)``.  ``ctxs`` (..., D), ``ms`` and ``ls`` (...), one
    each a member.  ``m_g`` is held at ``NEG_INF`` or above: K5's empty
    partial has m = -inf, and a row that is empty on every member (an
    inactive slot) then combines to 0 rather than NaN."""
    with wire.over((wire.MODEL_AXIS,)):
        m_g = [g.clamp(min=NEG_INF) for g in C.pmax(ms)]
        alpha = [torch.exp(m - g) for m, g in zip(ms, m_g)]
        l_g = C.psum([l * a for l, a in zip(ls, alpha)])[0]
        ctx_g = C.psum([x * a[..., None] for x, a in zip(ctxs, alpha)])[0]
    return ctx_g / torch.clamp(l_g, min=1e-30)[..., None]


def _update_local_slot(kc, vc, sp, k_new, v_new, pos, lo=None, tp=1, active=None):
    """Write the new token into ring slot pos % S on the owning member
    only, in place.  kc/vc (B,H,S_l,D); sp (B,S_l); k_new/v_new (B,H,D);
    pos (B,).  Head-local (``lo`` None): the local seq axis is the full
    ring.  Seq-sharded: the global ring has length S_l * tp; only the
    member whose range [lo, lo + S_l) holds the slot writes.  ``active``
    (B, bool) masks the write per slot."""
    B, S_l = kc.shape[0], kc.shape[2]
    if lo is None:
        slot = pos % S_l
        hit = torch.ones((B,), dtype=torch.bool, device=kc.device)
        local_slot = slot
    else:
        slot = pos % (S_l * tp)
        hit = (slot >= lo) & (slot < lo + S_l)
        local_slot = (slot - lo).clamp(0, S_l - 1)
    if active is not None:
        hit = hit & active
    bidx = torch.arange(B, device=kc.device)
    local_slot = local_slot.long()
    kc[bidx, :, local_slot] = gate(hit, k_new.to(kc.dtype), kc[bidx, :, local_slot])
    vc[bidx, :, local_slot] = gate(hit, v_new.to(vc.dtype), vc[bidx, :, local_slot])
    sp[bidx, local_slot] = gate(hit, pos.to(sp.dtype), sp[bidx, local_slot])


def _softmax_attend(q, kc, vc, sp, pos, window, scale=None):
    """Full (local) softmax of a member: q (B,Hq,1,D) over its cache
    block (B,Hkv,S,D).  On the card, K5 over the block read in place
    (``dense_gqa_view``, masked by lane at ``ring_lane_pos``); on the
    CPU, JAX's math masked by ``slot_pos``."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    if dense_decode_on_card(q.device):
        out = paged_gqa_attention(q[:, :, 0].contiguous(), *dense_gqa_view(kc, vc),
                                  ring_lane_pos(pos, kc.shape[2]).contiguous(), scale=scale)
        return out[:, :, None]
    return attend(q[:, :, 0], kc, vc, _valid_mask(sp, pos, window), scale)[:, :, None]


def _valid_mask(sp, pos, window):
    valid = (sp >= 0) & (sp <= pos[:, None])
    if window is not None:
        valid &= sp > (pos[:, None] - window)
    return valid


def _partial_attend(q, kc, vc, sp, pos, window, scale):
    """Partial-softmax accumulators over the local KV slice (JAX's math).
    Returns (ctx (B,Hkv,G,Dv) f32, m (B,Hkv,G) f32, l (B,Hkv,G) f32)."""
    B, Hq, _, Dk = q.shape
    Hkv = kc.shape[1]
    qf = q.reshape(B, Hkv, Hq // Hkv, Dk).float() * scale
    s = torch.einsum("bhgd,bhsd->bhgs", qf, kc.float())
    s = torch.where(_valid_mask(sp, pos, window)[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    ctx = torch.einsum("bhgs,bhsd->bhgd", e, vc.float())
    return ctx, m, e.sum(dim=-1)


# ===========================================================================
# GQA and MLA over a sharded page pool
# ===========================================================================
class PagedMember(NamedTuple):
    """One distinct block of a sharded pool in one decode step: its global
    ``block`` (a GQA pool's (rows, kv heads, lanes, D), a latent pool's
    (rows, lanes, d)); the step's writes that land in it (``rows``/
    ``lanes`` local, ``sel`` the writing slots); and the page table and
    positions its attention reads (``member_table``'s or ``page_table``'s,
    by the plan's route)."""

    block: tuple
    rows: torch.Tensor
    lanes: torch.Tensor
    sel: torch.Tensor
    pages: torch.Tensor
    pos: torch.Tensor


class PagedPlan(NamedTuple):
    """One decode step's member plan of a sharded pool, shared by every
    layer (every layer's pool has one layout): ``members`` keyed by block,
    in member order; ``route`` "head" (every block holds every page and
    lane: K5 a block over its kv heads, or K6 a block), "lanes" (every
    page on every block, its lanes split: a partial a slot, combined in
    lane order) or "pages" (the pages split: a partial a page of a slot,
    combined in page order); ``axes`` the mesh axes the partials combine
    over."""

    members: dict
    route: str
    axes: tuple


def _lanes_of(block, latent: bool) -> slice:
    """The lane slice of a pool block: dim 2 of a GQA pool's (N, Hkv, ps,
    D), dim 1 of a latent pool's (N, ps, d)."""
    return block[1] if latent else block[2]


def _held(pages, block, n_pages: int):
    """(global table with rows past the pool's end clamped to its last
    row, as the unsharded gather reads them; the mask of the entries
    ``block``'s rows hold)."""
    rs = block[0]
    g = torch.where(pages >= 0, pages.clamp(max=n_pages - 1), -1)
    return g, (g >= rs.start) & (g < rs.stop)


def member_table(pages, pos, block, n_pages: int, page_size: int, *, latent: bool = False):
    """The page table (B, P) and positions (B,) a member holding ``block``
    (of a GQA pool, or of a latent pool with ``latent``) reads on the
    "head" and "lanes" routes: rows held elsewhere are -1 (the kernels
    read them as unmapped) and the rows it holds are renumbered from 0;
    with the lanes split, a member holding lanes ``[lo, lo + ps_l)`` of
    every page sees global position p as ``(p // ps) ps_l + clamp(p % ps
    - lo, -1, ps_l - 1)``, so its lane j of logical page i is valid
    exactly where global lane ``i ps + lo + j`` is at or before p (-1 on
    the first page: none)."""
    g, held = _held(pages, block, n_pages)
    rs, ls = block[0], _lanes_of(block, latent)
    table = torch.where(held, g - rs.start, -1).to(torch.int32)
    ps_l = ls.stop - ls.start
    if ps_l == page_size:
        return table.contiguous(), pos.to(torch.int32).contiguous()
    page = torch.div(pos, page_size, rounding_mode="floor")
    lane = torch.clamp(pos - page * page_size - ls.start, -1, ps_l - 1)
    return table.contiguous(), (page * ps_l + lane).to(torch.int32).contiguous()


def page_table(pages, pos, block, n_pages: int, page_size: int, *, latent: bool = False):
    """The table (B P, 1) and positions (B P,) of the "pages" route: one
    row a logical page of a slot, mapped to the member's local row where
    ``block`` holds it (-1 elsewhere), with the position ``clamp(p - i ps
    - lo, -1, ps_l - 1)`` of page i's lanes ``[lo, lo + ps_l)``."""
    g, held = _held(pages, block, n_pages)
    rs, ls = block[0], _lanes_of(block, latent)
    B, P = pages.shape
    table = torch.where(held, g - rs.start, -1).to(torch.int32).reshape(B * P, 1)
    start = torch.arange(P, device=pos.device) * page_size + ls.start
    lpos = torch.clamp(pos[:, None] - start[None, :], -1, ls.stop - ls.start - 1)
    return table.contiguous(), lpos.reshape(B * P).to(torch.int32).contiguous()


def paged_plan(pool, pages, pos, rows_lanes, *, latent: bool = False) -> PagedPlan:
    """The member plan of one decode step over ``pool``, a ``Sharded``
    layer pool: GQA's (N, Hkv, ps, D), or with ``latent`` MLA's (N, ps,
    lora); or the stacked pool with a leading layer dim (every layer's
    blocks are its blocks).  Laid out by ``cache_pspecs``: pages over the
    data axes, and kv heads (when they divide) or each page's lanes over
    the model axis.  ``pages`` (B, P) is the global table, ``pos`` (B,)
    the global positions and ``rows_lanes`` the step's global write
    (``layers.paged_write_rows``).  The route is the layout's
    (``PagedPlan``)."""
    nd = 3 if latent else 4
    N, ps = pool.shape[-nd], pool.shape[-2]
    lead = pool.dim() - nd
    spec = tuple(pool.spec)[lead:] + (None,) * nd
    first = pool.block(pool.coords()[0])[lead:]
    ls0 = _lanes_of(first, latent)
    if first[0].stop - first[0].start != N:
        route, table_fn = "pages", page_table
    elif ls0.stop - ls0.start != ps:
        route, table_fn = "lanes", member_table
    else:
        route, table_fn = "head", member_table
    rows, lanes, sel = rows_lanes
    members = {}
    for c in pool.coords():
        block = pool.block(c)[lead:]
        key = _key(block)
        if key in members:
            continue
        rs, ls = block[0], _lanes_of(block, latent)
        hit = (rows >= rs.start) & (rows < rs.stop) & (lanes >= ls.start) & (lanes < ls.stop)
        idx = hit.nonzero()[:, 0]
        members[key] = PagedMember(block, rows[idx] - rs.start, lanes[idx] - ls.start, sel[idx],
                                   *table_fn(pages, pos, block, N, ps, latent=latent))
    return PagedPlan(members, route, wire.spec_axes(spec[0], spec[1 if latent else 2]))


def _combine_units(acc, m, l):
    """The flash-decoding combine of a slot's partials over their units
    (dim 1: logical pages, each page's lane blocks in order), the same
    arithmetic for every slot: acc (B, U, H, D), m and l (B, U, H) ->
    (B, H, D) f32.  A result that depends on the logical pages alone, not
    on the members holding them."""
    m_g = m.amax(dim=1).clamp(min=NEG_INF)
    alpha = torch.exp(m - m_g[:, None])
    l_g = (l * alpha).sum(dim=1)
    acc_g = (acc * alpha[..., None]).sum(dim=1)
    return acc_g / torch.clamp(l_g, min=1e-30)[..., None]


def _units(by_lanes: dict, B: int, plan: PagedPlan):
    """The units (acc (B, U, H, D), m and l (B, U, H)) of one head range's
    partials ``by_lanes`` (lane range -> [(acc, m, l)] in member order,
    rows a slot or a page of a slot): the members holding one lane range
    join exactly (a page's partial is nonzero on one member only), then
    the units stack by logical page, lane blocks minor.  The join is
    recorded as an all-reduce over the plan's axes."""
    units = []
    for _, held in sorted(by_lanes.items()):
        acc, m, l = held[0]
        for a2, m2, l2 in held[1:]:  # another member's pages: zero where it holds none
            acc, m, l = acc + a2, torch.maximum(m, m2), l + l2
        units.append((acc, m, l))
    if wire.active():  # a deployment joins its members' partials over the split axes
        members = sum(len(held) for held in by_lanes.values())
        wire.record("all-reduce", sum(wire.nbytes(t) for t in held[0]), members,
                    members=members, site="collectives", axes=plan.axes)
    return [torch.stack([u[i].reshape(B, -1, *u[i].shape[1:]) for u in units],
                        dim=2).flatten(1, 2) for i in range(3)]


def paged_gqa_decode(q, k_new, v_new, cache, plan: PagedPlan, *, scale=None):
    """Paged decode over a sharded pool: q (B, Hq, Dk) with every head on
    the controller's device; k_new/v_new (B, Hkv, D); cache {"k", "v"} of
    ``Sharded`` layer pools (N, Hkv, ps, D) laid out as ``plan`` was made
    for.  Each member writes the new lanes its block holds, in place (a
    slot's lane lands on the member holding row ``pages[b, pos // ps]``
    and lane ``pos % ps``; every copy of a replicated block is written).
    Attention, one launch a distinct block:

      * "head": K5 (``paged_gqa_attention``) over the block's kv heads of
        every page, for their query heads, with the global table;
      * "lanes": K5's partials (``paged_gqa_partials``) a slot over the
        block's lanes of every page, combined over the lane blocks in
        member order (``_combine_units``);
      * "pages": K5's partials a logical page of a slot (one row a page),
        over the pages and lanes the block holds.  The members holding
        one kv-head and lane range join exactly (a page's partial is
        nonzero on one member), then the units combine in page order,
        lanes minor (``_combine_units``): replica slots, whose pages lie
        on other members, get equal bits.

    Returns (B, Hq, Dk) in q.dtype."""
    kc, vc = cache["k"], cache["v"]
    B, Hq, Dk = q.shape
    G = Hq // k_new.shape[1]
    for c, kt in kc.distinct():
        mb = plan.members[_key(kc.block(c))]
        if mb.sel.numel():
            dev, heads = kt.device, mb.block[1]
            r, ln, sl = (t.to(dev) for t in (mb.rows, mb.lanes, mb.sel))
            kt[r, :, ln] = k_new[:, heads][sl.to(k_new.device)].to(dev, kt.dtype)
            vc.local(c)[r, :, ln] = v_new[:, heads][sl.to(v_new.device)].to(dev, kt.dtype)
    out = torch.empty_like(q) if plan.route == "head" else None
    home = q.device
    parts: dict = {}  # (query heads, lanes) -> [(acc, m, l)] in member order
    seen = set()
    for c in kc.coords():
        key = _key(kc.block(c))
        if key in seen:  # a block once, from its first member
            continue
        seen.add(key)
        mb = plan.members[key]
        heads, lanes = mb.block[1], mb.block[2]
        qh = slice(heads.start * G, heads.stop * G)
        kt = kc.local(c)
        dev = kt.device
        qm = q[:, qh].to(dev)
        if plan.route == "pages":
            qm = qm.repeat_interleave(mb.pages.shape[0] // B, dim=0)
        args = (qm.contiguous(), kt, vc.local(c), mb.pages.to(dev), mb.pos.to(dev))
        if plan.route == "head":
            out[:, qh] = paged_gqa_attention(*args, scale=scale).to(home)
            continue
        part = tuple(t.to(home) for t in paged_gqa_partials(*args, scale=scale))
        parts.setdefault((qh.start, qh.stop), {}).setdefault((lanes.start, lanes.stop), []).append(part)
    if plan.route == "head":
        return out
    # the units of every query-head range, (B, U, heads, ...): logical
    # pages ("pages"; one a slot on "lanes"), each page's lane blocks in
    # order
    groups = [_units(by_lanes, B, plan) for _, by_lanes in sorted(parts.items())]
    acc, m, l = (torch.cat([g[i] for g in groups], dim=2) for i in range(3))
    return _combine_units(acc, m, l).to(q.dtype)


def paged_mla_decode(q_lat, q_rope, ckv_new, krope_new, cache, plan: PagedPlan, *, scale: float):
    """Paged absorbed-MLA decode over a sharded latent pool: q_lat (B, h,
    lora) and q_rope (B, h, rope) on the controller's device; ckv_new (B,
    lora) / krope_new (B, rope); cache {"ckv", "krope"} of ``Sharded``
    layer pools (N, ps, lora) / (N, ps, rope) laid out as ``plan``
    (``paged_plan(..., latent=True)``) was made for.  Each member writes
    the new lanes its block holds, in place (every copy of a replicated
    block is written).  Attention, one launch a distinct block:

      * "head": every block holds every page and lane: K6
        (``paged_mla_attention``) with the global table;
      * "lanes": K6's partials (``paged_mla_partials``) a slot over the
        block's lanes of every page, combined over the lane blocks in
        member order;
      * "pages": K6's partials a logical page of a slot (one row a page);
        the members holding one lane range join exactly, then the units
        combine in page order, lanes minor (``_combine_units``): replica
        slots, whose pages lie on other members, get equal bits.

    Returns the f32 latent context (B, h, lora)."""
    cs, ks = cache["ckv"], cache["krope"]
    B = q_lat.shape[0]
    for c, ct in cs.distinct():
        mb = plan.members[_key(cs.block(c))]
        if mb.sel.numel():
            dev = ct.device
            r, ln, sl = (t.to(dev) for t in (mb.rows, mb.lanes, mb.sel))
            ct[r, ln] = ckv_new[sl.to(ckv_new.device)].to(dev, ct.dtype)
            kt = ks.local(c)
            kt[r, ln] = krope_new[sl.to(krope_new.device)].to(dev, kt.dtype)
    home = q_lat.device
    by_lanes: dict = {}  # lanes -> [(acc, m, l)] in member order
    seen = set()
    for c in cs.coords():
        key = _key(cs.block(c))
        if key in seen:  # a block once, from its first member
            continue
        seen.add(key)
        mb = plan.members[key]
        ct = cs.local(c)
        dev = ct.device
        ql, qr = q_lat.to(dev), q_rope.to(dev)
        if plan.route == "pages":
            n = mb.pages.shape[0] // B
            ql, qr = ql.repeat_interleave(n, dim=0), qr.repeat_interleave(n, dim=0)
        args = (ql.contiguous(), qr.contiguous(), ct, ks.local(c), mb.pages.to(dev),
                mb.pos.to(dev))
        if plan.route == "head":  # every block is the whole pool
            return paged_mla_attention(*args, scale=scale).to(home)
        lanes = mb.block[1]
        part = tuple(t.to(home) for t in paged_mla_partials(*args, scale=scale))
        by_lanes.setdefault((lanes.start, lanes.stop), []).append(part)
    return _combine_units(*_units(by_lanes, B, plan))


# ===========================================================================
# MLA (latent cache)
# ===========================================================================
def mla_decode(q_lat, q_rope, ckv_new, krope_new, cache, pos, *, cfg, ctx, active=None):
    """Absorbed MLA decode over a sequence-sharded latent cache.

    q_lat (B,1,h,lora), q_rope (B,1,h,r); ckv_new (B,lora), krope_new
    (B,r); cache {"ckv" (B,S,lora), "krope" (B,S,r), "slot_pos" (B,S)}
    of ``Sharded`` leaves.  ``active`` (B, bool): inactive slots' cache
    is never written.  Returns (ctx_lat (B,1,h,lora) f32, cache) or None
    (no model axis divides the lanes)."""
    B = q_lat.shape[0]
    S = cache["ckv"].shape[1]
    ma, tp = _tp(ctx)
    if ctx.mesh is None or tp == 1 or S % tp != 0:
        return None
    m_cfg = cfg.mla
    scale = (m_cfg.qk_nope_dim + m_cfg.qk_rope_dim) ** -0.5
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=q_lat.device)
    ckv_s, krope_s, sp = cache["ckv"], cache["krope"], cache["slot_pos"]
    out = torch.empty((*q_lat.shape[:3], ckv_s.shape[-1]), dtype=torch.float32,
                      device=q_lat.device)
    for group in _groups(ckv_s, ma):
        rows = ckv_s.block(group[0])[0]
        ctxs, ms, ls = [], [], []
        for c in group:
            ckv, krope = ckv_s.local(c), krope_s.local(c)
            dev = ckv.device
            B_l, S_l = ckv.shape[:2]
            lo = ckv_s.block(c)[1].start
            ql, qr, pm, am = (t.to(dev) for t in (q_lat[rows], q_rope[rows], pos[rows],
                                                  active[rows]))
            spv = sp.local(c)[:, lo: lo + S_l]
            slot = pm % (S_l * tp)
            hit = (slot >= lo) & (slot < lo + S_l) & am
            ls_ = (slot - lo).clamp(0, S_l - 1).long()
            bidx = torch.arange(B_l, device=dev)
            ckv[bidx, ls_] = gate(hit, ckv_new[rows].to(dev, ckv.dtype), ckv[bidx, ls_])
            krope[bidx, ls_] = gate(hit, krope_new[rows].to(dev, krope.dtype), krope[bidx, ls_])
            spv[bidx, ls_] = gate(hit, pm.to(spv.dtype), spv[bidx, ls_])
            if dense_decode_on_card(dev):  # K6's partials over the member's lanes in place
                bound = (ring_lane_pos(pm, S) - lo).to(torch.int32).contiguous()
                a, m, l = paged_mla_partials(ql[:, 0].contiguous(), qr[:, 0].contiguous(),
                                             *dense_mla_view(ckv, krope), bound, scale=scale)
                ctxs.append(a[:, :, None])  # (B,h,1,lora), as the einsums' below
                ms.append(m[..., None])
                ls.append(l[..., None])
                continue
            ckvf = ckv.float()
            s = torch.einsum("bshl,btl->bhst", ql.float(), ckvf)
            s = s + torch.einsum("bshr,btr->bhst", qr.float(), krope.float())
            s = s * scale                                   # (B,h,1,S_l)
            valid = (spv >= 0) & (spv <= pm[:, None])
            s = torch.where(valid[:, None, None, :], s, NEG_INF)
            m = s.amax(dim=-1)                              # (B,h,1)
            e = torch.exp(s - m[..., None])
            ls.append(e.sum(dim=-1))
            ms.append(m)
            ctxs.append(torch.einsum("bhst,btl->bhsl", e, ckvf))
        # (B,h,1,lora) -> (B,1,h,lora)
        out[rows] = _combine_partials(ctxs, ms, ls).transpose(1, 2).to(out.device)
    return out, cache


def local_mla_decode(q_lat, q_rope, ckv_new, krope_new, cache, pos, *, cfg, active):
    """JAX's fallback when ``mla_decode`` returns None: each data member
    updates and attends over its own latent block (its rows, every lane:
    the cache has no model axis), as the unsharded decode does
    (``kernels.paged_decode.dense_mla_decode``: K6 over the block in
    place on a card).  Members that share one tensor compute once.
    Arguments as ``mla_decode``'s; returns ctx_lat (B,1,h,lora) f32."""
    m_cfg = cfg.mla
    scale = (m_cfg.qk_nope_dim + m_cfg.qk_rope_dim) ** -0.5
    ckv_s, krope_s, sp = cache["ckv"], cache["krope"], cache["slot_pos"]
    out = torch.empty((*q_lat.shape[:3], ckv_s.shape[-1]), dtype=torch.float32,
                      device=q_lat.device)
    for c, ckv in ckv_s.distinct():
        rows, lanes = ckv_s.block(c)[:2]
        if lanes.stop - lanes.start != ckv_s.shape[1]:
            raise ValueError(f"local MLA decode needs every lane on a member; {ckv_s!r} "
                             "splits them")
        dev = ckv.device
        ql, qr, cn, kn, pm, am = (t[rows].to(dev) for t in (q_lat, q_rope, ckv_new, krope_new,
                                                             pos, active))
        blk = {"ckv": ckv, "krope": krope_s.local(c), "slot_pos": sp.local(c)}
        lat = dense_mla_decode(ql[:, 0], qr[:, 0], cn, kn, blk, pm, active=am, scale=scale)
        out[rows] = lat[:, None].to(out.device)
    return out
