"""K5's partials entry point (``kernels.paged_decode.paged_gqa_partials``)
by its plain version, on the CPU: each row's flash-decoding partial
``(acc, m, l)`` over the lanes it is given.

``acc / l`` equals the normalised ``paged_gqa_plain`` output where a row
has a valid lane; a row without one (negative ``pos``, a member whose
lanes start past the query) is the empty partial m = -inf, l = 0, acc =
0, where the full kernel would take the uniform mean; cutting a dense
cache into 4 members' lane ranges, giving each its own view and ``pos``
shifted by its first lane, and combining the members' partials with
``distributed/decode.py``'s ``_combine_partials`` (pmax, alpha, psum) equals attention over
the whole cache; and on a dense view the partials equal the JAX
package's ``repro.distributed.decode._partial_attend`` (the math of its
sharded decode's member body) at every valid row, also at head dims 80
and 120 and a group of 48.  ``gqa_partials_plan``, the route rule, is
a function of the shapes alone, and ``tc_model`` (the bf16 tensor-core
kernel's algorithm in torch) holds to the plain version at the card's
1e-4.  On the card (the ``cuda``-marked cases), each route against the
plain version over query groups, head dims and lane counts, and equal
rows in equal bits at any batch index and B."""

import numpy as np
import pytest
import torch

from repro_torch.distributed import decode as DD
from repro_torch.kernels import paged_decode as pd
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def dense(B=3, Hq=8, Hkv=2, S=64, D=16, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, Hq, D, generator=g).to(dtype)
    k = torch.randn(B, Hkv, S, D, generator=g).to(dtype)
    v = torch.randn(B, Hkv, S, D, generator=g).to(dtype)
    return q, k, v


@pytest.mark.parametrize("G", [1, 4, 12])
def test_partials_normalise_to_the_attention(G):
    q, k, v = dense(Hq=2 * G)
    pos = torch.tensor([0, 17, 63], dtype=torch.int32)
    acc, m, l = pd.paged_gqa_partials(q, *pd.dense_gqa_view(k, v), pos)
    want = pd.paged_gqa_plain(q, *pd.dense_gqa_view(k, v), pos)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert torch.allclose(acc / l[..., None], want.float(), atol=1e-6, rtol=1e-5)
    assert (l >= 1).all() and torch.isfinite(m).all()
    assert pd.paged_gqa_partials.launches == 0  # CPU tensors take the plain version


def test_row_without_a_valid_lane_is_empty():
    q, k, v = dense()
    pos = torch.tensor([-1, -64, 5], dtype=torch.int32)
    acc, m, l = pd.paged_gqa_partials(q, *pd.dense_gqa_view(k, v), pos)
    assert torch.isneginf(m[:2]).all() and (l[:2] == 0).all() and (acc[:2] == 0).all()
    assert torch.isfinite(m[2]).all() and (l[2] > 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [[3, 40, 63], [0, 15, 16]])
def test_members_partials_combine_to_the_whole(dtype, pos):
    q, k, v = dense(dtype=dtype)
    pos = torch.tensor(pos, dtype=torch.int32)
    tp, S = 4, k.shape[2]
    S_l = S // tp
    parts = []
    for mbr in range(tp):
        ks, vs = k[:, :, mbr * S_l:(mbr + 1) * S_l].contiguous(), v[:, :, mbr * S_l:(mbr + 1) * S_l].contiguous()
        parts.append(pd.paged_gqa_partials(q, *pd.dense_gqa_view(ks, vs), pos - mbr * S_l))
    got = DD._combine_partials(*([p[i] for p in parts] for i in range(3)))
    # the partials are f32 whatever the inputs: compare with f32 attention
    want = pd.paged_gqa_plain(q.float(), *pd.dense_gqa_view(k.float(), v.float()), pos)
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-5)


def test_partials_equal_jax_partial_attend():
    jax_partial_attend_case(Hq=8, Hkv=2, D=16)


@pytest.mark.parametrize("Hq,Hkv,D", [(8, 2, 80), (8, 2, 120), (48, 1, 16)],
                         ids=["Dk80", "Dk120", "G48"])
def test_partials_equal_jax_partial_attend_at_arch_shapes(Hq, Hkv, D):
    """The archs' head dims that are not multiples of 16 (the tensor-core
    kernel pads them) and granite-20b's group of 48, f32."""
    jax_partial_attend_case(Hq=Hq, Hkv=Hkv, D=D)


def jax_partial_attend_case(Hq, Hkv, D):
    import jax.numpy as jnp  # here, not at the top: the card's cases run without JAX

    from repro.distributed import decode as JD

    q, k, v = dense(B=4, Hq=Hq, Hkv=Hkv, S=32, D=D, seed=3)
    pos = torch.tensor([0, 9, 31, 20], dtype=torch.int32)
    S = k.shape[2]
    sp = torch.arange(S, dtype=torch.int32)[None].expand(4, S).clone()
    sp = torch.where(sp <= pos[:, None], sp, -1)  # a full cache: lane s holds position s
    scale = q.shape[-1] ** -0.5
    ctx, m, l = (np.asarray(a) for a in JD._partial_attend(
        jnp.asarray(q.numpy()[:, :, None]), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(sp.numpy()), jnp.asarray(pos.numpy()), None, scale))
    acc_t, m_t, l_t = pd.paged_gqa_partials(q, *pd.dense_gqa_view(k, v), pos, scale=scale)
    B, Hq, D = q.shape
    assert np.allclose(m_t.numpy(), m.reshape(B, Hq), atol=1e-6)
    assert np.allclose(l_t.numpy(), l.reshape(B, Hq), rtol=1e-5)
    assert np.allclose(acc_t.numpy(), ctx.reshape(B, Hq, D), rtol=1e-5, atol=1e-5)


def test_partials_refuse_other_devices():
    q, k, v = (x.to("meta") for x in dense())
    with pytest.raises(ValueError, match="cuda or cpu"):
        pd.paged_gqa_partials(q, *pd.dense_gqa_view(k, v), torch.zeros(3, dtype=torch.int32,
                                                                        device="meta"))


# --------------------------------------------------------------------------
# the route rule and the tensor-core kernel's algorithm
# --------------------------------------------------------------------------
def test_partials_plan_is_a_function_of_the_shapes():
    args = (8, 1, 48, 128, 128, torch.bfloat16, 132)
    assert pd.gqa_partials_plan(*args) == pd.gqa_partials_plan(*args)
    for S in (64, 128, 1000, 2048, 8192):
        # the tensor-core route reads neither the batch nor the SM count
        plans = {pd.gqa_partials_plan(B, 2, 12, S, 80, torch.bfloat16, sms)
                 for B in (1, 5, 8, 64) for sms in (78, 132)}
        assert plans == {pd.tc_partials_plan(2, 12, S, 80)} and plans.pop().route == "tc"


@pytest.mark.parametrize("G", [1, 2, 7, 12, 48, 96])
@pytest.mark.parametrize("Dk", [64, 80, 120, 128, 256])
def test_partials_plan_f32_takes_split(G, Dk):
    for B, S in ((1, 64), (8, 128), (8, 1000), (32, 4096)):
        plan = pd.gqa_partials_plan(B, 2, G, S, Dk, torch.float32, 132)
        assert plan == ("split", pd.gqa_split_lanes(B, 2 * -(-G // pd.GQA_CHUNK), S, 132), 1)


def test_partials_plan_bf16_at_granite_member_takes_tc():
    # granite-20b's member on a (1, 4) mesh: 48 query heads on one kv head, 128 lanes
    assert pd.gqa_partials_plan(8, 1, 48, 128, 128, torch.bfloat16, 132) == ("tc", 128, 1)
    # head dims past the kernel's 128 columns keep the split pass
    assert pd.gqa_partials_plan(8, 1, 48, 128, 256, torch.bfloat16, 132).route == "split"
    # so do groups below the measured crossover (G = 1: 63 of 64 wgmma rows idle)
    assert pd.TC_MIN_GROUP == 2
    assert pd.gqa_partials_plan(8, 32, 1, 128, 64, torch.bfloat16, 132).route == "split"


@pytest.mark.parametrize("Hkv,G,Dk,cluster", [(1, 48, 128, 8), (4, 12, 128, 4), (8, 2, 128, 2),
                                              (8, 2, 64, 4), (24, 2, 128, 1), (1, 128, 128, 8)])
def test_partials_plan_caps_a_slots_blocks(Hkv, G, Dk, cluster):
    """At 2048 lanes the splits stop at ``TC_SLOT_BLOCKS`` blocks a slot
    (twice as many at Dk 64), or at the cluster's 8."""
    plan = pd.gqa_partials_plan(8, Hkv, G, 2048, Dk, torch.bfloat16, 132)
    assert plan.route == "tc" and plan.cluster == cluster
    assert Hkv * -(-G // 64) * cluster <= pd.TC_SLOT_BLOCKS * (2 if Dk <= 64 else 1)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 128, 129, 500, 1000, 1008, 2048, 4000, 8192, 65536])
def test_partials_plan_splits_cover_the_lanes(S):
    route, lanes, cluster = pd.gqa_partials_plan(8, 1, 48, S, 128, torch.bfloat16, 132)
    assert route == "tc" and lanes % pd.SPLIT_QUANTUM == 0
    assert 1 <= cluster <= pd.TC_MAX_CLUSTER
    assert (cluster - 1) * lanes < S <= cluster * lanes  # every split holds a lane


LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def tc_model(q, k_pool, v_pool, pages, pos, plan, *, remainder=True):
    """``csrc/paged_gqa_partials.cu``'s algorithm in torch: per split of
    ``plan``, 64-lane tiles in lane order, f32 scores scaled into log2
    units, an online softmax, P.V with P as a bf16 high part plus (with
    ``remainder``) its bf16 remainder; then the splits merged in order, a
    split with l = 0 skipped, m back in natural units."""
    B, Hq, Dk = q.shape
    Hkv, ps = k_pool.shape[1], k_pool.shape[2]
    S = pages.shape[1] * ps
    k, v = pd.paged_gather(k_pool, pages).float(), pd.paged_gather(v_pool, pages).float()
    valid = pd.paged_valid(pages, pos, ps)[:, None, None, :]
    qf = q.reshape(B, Hkv, Hq // Hkv, Dk).float()
    ms, ls, accs = [], [], []
    for lo in range(0, S, plan.split_lanes):
        m = torch.full(qf.shape[:3], -torch.inf)
        l, o = torch.zeros(qf.shape[:3]), torch.zeros(qf.shape)
        for t0 in range(lo, min(S, lo + plan.split_lanes), 64):
            t = slice(t0, min(S, t0 + 64))
            s = torch.einsum("bhgd,bhsd->bhgs", qf, k[:, :, t]) * (Dk**-0.5 * LOG2E)
            s = torch.where(valid[..., t], s, -torch.inf)
            mn = torch.maximum(m, s.amax(-1))
            mu = torch.where(mn == -torch.inf, 0.0, mn)
            al, p = torch.exp2(m - mu), torch.exp2(s - mu[..., None])
            hi = p.bfloat16().float()
            parts = [hi, (p - hi).bfloat16().float()] if remainder else [hi]
            o = o * al[..., None] + sum(torch.einsum("bhgs,bhsd->bhgd", x, v[:, :, t]) for x in parts)
            l, m = l * al + p.sum(-1), mn
        ms.append(m), ls.append(l), accs.append(o)
    ms, ls, accs = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    M = torch.where(ls > 0, ms, -torch.inf).amax(0)
    f = torch.where(ls > 0, torch.exp2(torch.where(ls > 0, ms - M, 0.0)), 0.0)
    acc, L = (accs * f[..., None]).sum(0), (ls * f).sum(0)
    m = torch.where(M == -torch.inf, -torch.inf, M * LN2)
    return acc.reshape(B, Hq, Dk), m.reshape(B, Hq), L.reshape(B, Hq)


def paged_case(B, Hq, Hkv, S, D, ps=16, seed=0):
    """bf16 inputs in a pool of pages of ``ps`` through a shuffled table
    with unmapped pages and a row past the pool's end; pos below, inside
    and past the lanes."""
    g = torch.Generator().manual_seed(seed)
    P = -(-S // ps)
    q = torch.randn(B, Hq, D, generator=g).bfloat16()
    k, v = (torch.randn(B * P, Hkv, ps, D, generator=g).bfloat16() for _ in range(2))
    pages = torch.randperm(B * P, generator=g).reshape(B, P).to(torch.int32)
    pages[1, P // 2:] = -1
    pages[2, ::3] = -1
    pages[3] = -1
    pages[0, -1] = B * P + 5
    pos = torch.tensor([S - 1, S // 2, S + 100, S - 1, -4, 0, 17, S // 3][:B], dtype=torch.int32)
    return q, k, v, pages, pos


def held(got, want, tol=1e-4):
    for a, b in zip(got, want):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin)
        assert torch.allclose(a[fin], b[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("Hq,Hkv,S,D", [(48, 1, 128, 128), (48, 1, 1000, 128), (12, 2, 256, 120),
                                        (7, 1, 2048, 80), (4, 4, 192, 64)],
                         ids=["granite_member", "8_splits", "Dk120", "G7_2048", "G1"])
def test_tc_model_matches_plain(Hq, Hkv, S, D):
    """The kernel's algorithm (tiles, online softmax, P as two bf16 parts,
    the cluster's merge) against the plain version at the card's 1e-4,
    also at G = 1, which the plan sends to the split pass."""
    q, k, v, pages, pos = paged_case(8, Hq, Hkv, S, D)
    plan = pd.tc_partials_plan(Hkv, Hq // Hkv, pages.shape[1] * 16, D)
    held(tc_model(q, k, v, pages, pos, plan), pd.paged_gqa_partials_plain(q, k, v, pages, pos))


def test_tc_model_needs_the_bf16_remainder():
    """bf16 P alone (2^-9 relative error a weight) breaks the 1e-4 limit
    the remainder keeps."""
    q, k, v, pages, pos = paged_case(8, 48, 1, 512, 128, seed=1)
    plan = pd.tc_partials_plan(1, 48, 512, 128)
    want = pd.paged_gqa_partials_plain(q, k, v, pages, pos)
    with pytest.raises(AssertionError):
        held(tc_model(q, k, v, pages, pos, plan, remainder=False), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2, 7, 12, 48])
@pytest.mark.parametrize("Dk", [64, 80, 120, 128])
@pytest.mark.parametrize("S", [64, 128, 1000, 2048])
def test_partials_kernel_matches_plain_on_the_card(dtype, G, Dk, S):
    """Each route the plan takes, on a dense view and on a paged pool
    (pages of 16, a shuffled table, unmapped pages), at 1e-4, one launch
    a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K5's partials)")
    Hkv = max(1, 48 // G)
    q, k, v = (x.cuda() for x in dense(B=8, Hq=G * Hkv, Hkv=Hkv, S=S, D=Dk, dtype=dtype))
    pos = torch.tensor([-3, 0, 5, 63, 64, S // 2, S - 1, S + 400], dtype=torch.int32, device="cuda")
    pooled = [x.cuda() for x in paged_case(8, G * Hkv, Hkv, S, Dk)]
    pooled[0], pooled[1], pooled[2] = (x.to(dtype) for x in pooled[:3])
    for args in ((q, *pd.dense_gqa_view(k, v), pos), tuple(pooled)):
        before = pd.paged_gqa_partials.launches
        got = pd.paged_gqa_partials(*args)
        assert pd.paged_gqa_partials.launches == before + 1
        held(got, pd.paged_gqa_partials_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, 2048])
def test_partials_rows_equal_bits_on_the_card(S):
    """A row gives the same bits at batch index 0 and 5 of one call and in
    a B = 1 call: the sharded engine's clean DMR ticks rest on it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K5's partials)")
    q, k, v = (x.cuda() for x in dense(B=8, Hq=48, Hkv=1, S=S, D=128, dtype=torch.bfloat16))
    q[5], k[5], v[5] = q[0], k[0], v[0]
    pos = torch.tensor([S - 30, 3, S - 1, 40, 64, S - 30, 0, 90], dtype=torch.int32, device="cuda")
    eight = pd.paged_gqa_partials(q, *pd.dense_gqa_view(k, v), pos)
    one = pd.paged_gqa_partials(q[:1].contiguous(), *pd.dense_gqa_view(k[:1].contiguous(),
                                                                      v[:1].contiguous()), pos[:1])
    for a, b in zip(eight, one):
        assert torch.equal(a[0], a[5]) and torch.equal(a[0], b[0])
