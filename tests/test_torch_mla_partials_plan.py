"""K6's bf16 partials kernel (``csrc/paged_mla_partials.cu``): its plan and
its merge, by their plain versions on the CPU.

``mla_partials_plan`` takes the lane count alone (no batch size, no SM
count), and its splits cover ``[0, S)`` at multiples of 64 lanes with at
most one cluster of 8.  For each plan, ``paged_mla_partials_plain`` over
each split's lanes, merged in split order with the kernel's arithmetic
(log2 units, a split with l = 0 skipped), equals the whole row's plain
partials at 1e-6 in f32, with the empty rows ``(0, -inf, 0)`` exact: this
pins the merge order the kernel follows.  ``tc_model``, the kernel's
algorithm in torch (64-lane tiles, the online softmax in log2 units, P
as a bf16 high part plus its bf16 remainder, the cluster's merge), holds
to the plain version at the card's 1e-3.  On the card (the
``cuda``-marked cases), the kernel against the plain version through
pages of 4, 16 and 64 lanes and a dense view, at every split count, one
launch a call, and a row's bits equal at any batch index and in calls of
B 1, 4, 8 and 64."""

import inspect

import pytest
import torch

from repro_torch.kernels import paged_decode as pd
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
#: lane counts of the sweep: 12d's 4-lane members, 9c's 128, the kernel's
#: tile edges and lengths that are no multiple of 64
SWEEP = [4, 16, 63, 64, 65, 100, 127, 128, 129, 192, 255, 256, 300, 512, 513, 1000, 1024, 2048,
         3000, 4095, 4096]
SCALE = (128 + 64) ** -0.5  # DeepSeek's (qk_nope + qk_rope) ** -0.5


def splits(plan, S):
    return [(lo, min(S, lo + plan.split_lanes)) for lo in range(0, S, plan.split_lanes)]


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
def test_plan_reads_only_the_lanes():
    assert list(inspect.signature(pd.mla_partials_plan).parameters) == ["S"]
    # the main paths' shapes: 9c's and 12d's "lanes" members (128 lanes),
    # 12d's "pages" member (one page of 4 lanes a row)
    assert pd.mla_partials_plan(128) == ("tc", 64, 2)
    assert pd.mla_partials_plan(4) == ("tc", 64, 1)
    # longer lanes: the most splits, up to one cluster of 8
    assert pd.mla_partials_plan(192) == ("tc", 64, 3)
    assert pd.mla_partials_plan(512) == ("tc", 64, 8)
    assert pd.mla_partials_plan(4096) == ("tc", 512, 8)


@pytest.mark.parametrize("S", SWEEP)
def test_plan_splits_cover_the_lanes(S):
    plan = pd.mla_partials_plan(S)
    assert plan.route == "tc" and plan.split_lanes % pd.SPLIT_QUANTUM == 0
    assert 1 <= plan.cluster <= pd.MLA_MAX_CLUSTER
    assert (plan.cluster - 1) * plan.split_lanes < S <= plan.cluster * plan.split_lanes
    assert len(splits(plan, S)) == plan.cluster
    tiles = -(-S // pd.SPLIT_QUANTUM)  # the most splits of whole tiles, at most one cluster
    assert plan.split_lanes == pd.SPLIT_QUANTUM * -(-tiles // pd.MLA_MAX_CLUSTER)
    if tiles <= pd.MLA_MAX_CLUSTER:
        assert plan.cluster == tiles


# --------------------------------------------------------------------------
# the merge order
# --------------------------------------------------------------------------
def merge_in_split_order(parts):
    """The kernel's merge of the splits' ``(acc, m, l)``: m in log2 units,
    M the max over the splits with l > 0, each such split scaled by
    exp2(m - M) and summed in split order, m back to natural units; no
    split with l > 0 gives (0, -inf, 0)."""
    acc = torch.zeros_like(parts[0][0])
    L = torch.zeros_like(parts[0][2])
    M = torch.full_like(parts[0][1], -torch.inf)
    for _, m, l in parts:
        M = torch.where(l > 0, torch.maximum(M, m * LOG2E), M)
    for a, m, l in parts:
        f = torch.where(l > 0, torch.exp2(torch.where(l > 0, m * LOG2E - M, 0.0)), 0.0)
        acc, L = acc + a * f[..., None], L + l * f
    return acc, torch.where(torch.isneginf(M), -torch.inf, M * LN2), L


def latent_case(S, ps, B=6, h=4, lora=32, rope=8, seed=0, dtype=torch.float32):
    """Queries and latent lanes of B slots over S lanes: a dense cache
    (``ps`` None) or a pool of pages of ``ps`` through a shuffled table
    with an unmapped page; positions below the lanes, inside the first
    split, on a split's last lane and past the end."""
    g = torch.Generator().manual_seed(seed + S)
    q_lat, q_rope = (torch.randn((B, h, d), generator=g).to(dtype) for d in (lora, rope))
    lanes = pd.mla_partials_plan(S).split_lanes
    pos = torch.tensor([-1, min(10, S - 1), S - 1, min(lanes, S) - 1, S + 50, -9][:B],
                       dtype=torch.int32)
    if ps is None:
        ckv, krope = (torch.randn((B, S, d), generator=g).to(dtype) for d in (lora, rope))
        return q_lat, q_rope, ckv, krope, pos
    P = S // ps
    ckv, krope = (torch.randn((B * P, ps, d), generator=g).to(dtype) for d in (lora, rope))
    pages = torch.randperm(B * P, generator=g).reshape(B, P).to(torch.int32)
    pages[2, P // 2] = -1
    return q_lat, q_rope, ckv, krope, pages, pos


def split_args(args, lo, hi, ps):
    """The inputs of the split over lanes [lo, hi): the dense cache's
    lanes in place, or the table's pages of the split; pos shifted by lo."""
    if ps is None:
        q_lat, q_rope, ckv, krope, pos = args
        return (q_lat, q_rope, *pd.dense_mla_view(ckv[:, lo:hi].contiguous(),
                                                  krope[:, lo:hi].contiguous()), pos - lo)
    q_lat, q_rope, ckv, krope, pages, pos = args
    return q_lat, q_rope, ckv, krope, pages[:, lo // ps:hi // ps].contiguous(), pos - lo


def whole_args(args, ps):
    if ps is None:
        q_lat, q_rope, ckv, krope, pos = args
        return (q_lat, q_rope, *pd.dense_mla_view(ckv, krope), pos)
    return args


def held(got, want, tol):
    """(acc, m, l) against the plain version: the same empty rows exactly,
    the rest within ``tol`` of the largest value (atol = rtol)."""
    empty = torch.isneginf(want[1])
    assert torch.equal(torch.isneginf(got[1]), empty)
    assert (got[2][empty] == 0).all() and (got[0][empty] == 0).all()
    for a, b in zip(got, want):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        if fin.any():
            scale = max(float(b[fin].abs().max()), 1.0)
            assert float((a[fin].float() - b[fin].float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("S,layout", [(S, ps) for S in SWEEP for ps in (None, 4, 16, 64)
                                      if ps is None or S % ps == 0],
                         ids=lambda x: "dense" if x is None else str(x))
def test_split_partials_merged_in_order_equal_the_whole_row(S, layout):
    """Dense caches of every length of the sweep, and pools of pages of 4,
    16 and 64 lanes where the length is a whole number of pages."""
    args = latent_case(S, layout)
    plan = pd.mla_partials_plan(S)
    parts = [pd.paged_mla_partials_plain(*split_args(args, lo, hi, layout), scale=SCALE)
             for lo, hi in splits(plan, S)]
    want = pd.paged_mla_partials_plain(*whole_args(args, layout), scale=SCALE)
    got = merge_in_split_order(parts)
    held(got, want, tol=1e-6)
    assert torch.isneginf(got[1][0]).all() and torch.isneginf(got[1][5]).all()  # pos < 0
    assert torch.isfinite(got[1][1]).all()  # valid lanes end inside the first split


# --------------------------------------------------------------------------
# the kernel's algorithm
# --------------------------------------------------------------------------
def tc_model(q_lat, q_rope, ckv_pool, krope_pool, pages, pos, plan, *, scale):
    """``csrc/paged_mla_partials.cu``'s algorithm in torch: per split of
    ``plan``, 64-lane tiles in lane order, f32 scores of the bf16 inputs
    scaled into log2 units, an online softmax, P.V with P as a bf16 high
    part plus its bf16 remainder; then the splits merged in order."""
    ps = ckv_pool.shape[1]
    S = pages.shape[1] * ps
    ckv = pd.paged_gather_lanes(ckv_pool, pages).float()
    kr = pd.paged_gather_lanes(krope_pool, pages).float()
    valid = pd.paged_valid(pages, pos, ps)[:, None, :]
    ql, qr = q_lat.float(), q_rope.float()
    parts = []
    for lo, hi in splits(plan, S):
        m = torch.full(ql.shape[:2], -torch.inf)
        l, o = torch.zeros(ql.shape[:2]), torch.zeros(ql.shape)
        for t0 in range(lo, hi, 64):
            t = slice(t0, min(hi, t0 + 64))
            s = (torch.einsum("bhl,btl->bht", ql, ckv[:, t])
                 + torch.einsum("bhr,btr->bht", qr, kr[:, t])) * (scale * LOG2E)
            s = torch.where(valid[..., t], s, -torch.inf)
            mn = torch.maximum(m, s.amax(-1))
            mu = torch.where(mn == -torch.inf, 0.0, mn)
            al, p = torch.exp2(m - mu), torch.exp2(s - mu[..., None])
            hi_p = p.bfloat16().float()
            lo_p = (p - hi_p).bfloat16().float()
            o = o * al[..., None] + torch.einsum("bht,btl->bhl", hi_p, ckv[:, t]) \
                + torch.einsum("bht,btl->bhl", lo_p, ckv[:, t])
            l, m = l * al + p.sum(-1), mn
        parts.append((o, torch.where(torch.isneginf(m), -torch.inf, m * LN2), l))
    return merge_in_split_order(parts)


@pytest.mark.parametrize("S,ps", [(128, 4), (128, 16), (512, 16), (1024, 64), (256, 256)],
                         ids=["12d_lanes", "9c_member", "4_splits", "8_splits", "dense"])
def test_tc_model_matches_plain(S, ps):
    """The kernel's algorithm at DeepSeek's latent widths (lora 512, rope
    64) against the plain version at the card's 1e-3 of the largest."""
    g = torch.Generator().manual_seed(S + ps)
    B, h, P = 4, 8, S // ps
    q_lat, q_rope = (torch.randn((B, h, d), generator=g).bfloat16() for d in (512, 64))
    ckv, krope = (torch.randn((B * P, ps, d), generator=g).bfloat16() for d in (512, 64))
    pages = torch.randperm(B * P, generator=g).reshape(B, P).to(torch.int32)
    pages[1, -1] = -1
    pages[2, 0] = B * P + 3  # past the pool's end: the last row
    pos = torch.tensor([S - 1, S // 2 + 3, 70, -2], dtype=torch.int32)
    args = (q_lat, q_rope, ckv, krope, pages, pos)
    got = tc_model(*args, pd.mla_partials_plan(S), scale=SCALE)
    held(got, pd.paged_mla_partials_plain(*args, scale=SCALE), tol=1e-3)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------
def card_case(B, S, ps, seed=7):
    """bf16 at DeepSeek's widths (h 128, lora 512, rope 64) through a
    shuffled table of pages of ``ps`` (an unmapped page, a row past the
    pool's end), rows with pos -1, on a page and a split boundary, past
    the end; and the same lanes as a dense view."""
    g = torch.Generator().manual_seed(seed)
    h, P = 128, S // ps
    q_lat, q_rope = (torch.randn((B, h, d), generator=g).bfloat16().cuda() for d in (512, 64))
    dense = [torch.randn((B, S, d), generator=g).bfloat16() for d in (512, 64)]
    pages = torch.randperm(B * P, generator=g).reshape(B, P).to(torch.int32)
    pool = [x.reshape(B * P, ps, -1)[pages.flatten().argsort()].contiguous().cuda() for x in dense]
    pages[min(3, B - 1), P // 2] = -1
    pos = torch.tensor([-1, 0, ps - 1, ps, 64, S // 2, S - 1, S + 100], dtype=torch.int32)
    pos = pos.repeat(-(-B // 8))[:B].cuda()
    return ((q_lat, q_rope, *pool, pages.cuda(), pos),
            (q_lat, q_rope, *pd.dense_mla_view(*(x.cuda() for x in dense)), pos))


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [4, 16, 64])
@pytest.mark.parametrize("S", [128, 192, 384, 512, 640, 832, 4096])
def test_kernel_matches_plain_on_the_card(ps, S):
    """The plan's route (clusters of 2, 3, 6, 8, 5, 7 and 8) on a paged
    pool and on a dense view: within 1e-3 of the largest value, empty rows
    exact, one launch a call; then 1, 2, 4 and 8 splits, forced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K6's partials kernel)")
    for args in card_case(8, S, ps):
        before = pd.paged_mla_partials.launches
        got = pd.paged_mla_partials(*args, scale=SCALE)
        assert pd.paged_mla_partials.launches == before + 1
        want = pd.paged_mla_partials_plain(*args, scale=SCALE)
        held(got, want, tol=1e-3)
        tiles = S // 64
        for n in (1, 2, 4, 8):
            if n <= tiles:
                lanes = 64 * -(-tiles // n)
                plan = pd.PartialsPlan("tc", lanes, -(-S // lanes))
                held(pd.launch_mla_partials(plan, *args, scale=SCALE), want, tol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, 512, 4096])
def test_kernel_rows_equal_bits_on_the_card(S):
    """A row gives the same bits at any batch index and in calls of B 1,
    4, 8 and 64, and a dense view gives a paged pool's bits: the sharded
    engine's clean DMR ticks rest on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K6's partials kernel)")
    paged, dense = card_case(64, S, 16)
    a = pd.paged_mla_partials(*paged, scale=SCALE)
    b = pd.paged_mla_partials(*dense, scale=SCALE)
    whole = (paged[4] >= 0).all(dim=1)  # the rows with no unmapped page
    for x, y in zip(a, b):
        assert torch.equal(x[whole], y[whole])
    ql, qr, ckv, krope, _, pos = dense
    ql[1:], qr[1:], ckv[1:], krope[1:] = ql[:1], qr[:1], ckv[:1], krope[:1]
    pos = torch.full_like(pos, S - 30)
    ref = pd.paged_mla_partials(ql[:1].contiguous(), qr[:1].contiguous(),
                                *pd.dense_mla_view(ckv[:1].contiguous(), krope[:1].contiguous()),
                                pos[:1].contiguous(), scale=SCALE)
    for B in (1, 4, 8, 64):
        got = pd.paged_mla_partials(ql[:B].contiguous(), qr[:B].contiguous(),
                                    *pd.dense_mla_view(ckv[:B].contiguous(),
                                                       krope[:B].contiguous()),
                                    pos[:B].contiguous(), scale=SCALE)
        for x, r in zip(got, ref):
            assert all(torch.equal(x[i], r[0]) for i in range(B))
