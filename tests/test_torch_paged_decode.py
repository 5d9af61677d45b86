"""K5, paged single-query GQA decode: the port's plain version held to the
JAX package's Pallas kernel (interpret mode, as tests/test_paging.py runs
it) and to its reference ``paged_gqa_ref``, at atol = rtol = 1e-5 in f32
(different reduction order across frameworks, values O(1)).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there.  Here: the wrapper's dispatch (CPU
tensors -> plain version), its refusal of inputs the kernel does not
take, its choice of splits (lanes, in multiples of 64), and a torch model
of the kernel's split-lane algorithm (per-split online softmax,
cross-split merge, the explicit uniform mean of a slot with no valid
lane) held to the plain version at 1e-6 in f32.  Any query group is
taken (the kernel runs groups above 8 as chunks of 8 heads).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode import paged_gqa_attention as jax_paged
from repro.kernels.ref import paged_gqa_ref
from repro_torch.kernels import paged_decode as pd
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

CASES = {
    # B, Hq, Hkv, Dk, ps, N, pages, pos
    "scattered_partial_one": (
        3, 4, 2, 8, 8, 10,
        [[7, 2, 9, 0], [5, 3, -1, -1], [8, -1, -1, -1]],
        [31, 11, 0],
    ),
    "unmapped_and_fully_masked": (
        4, 4, 2, 16, 4, 12,
        [[-1, -1, -1], [3, -1, 6], [11, 10, 9], [1, 4, -1]],
        [5, 9, 11, 2],
    ),
    "pos_at_page_edges": (
        3, 8, 2, 16, 8, 8,
        [[0, 1, 2, 3], [4, 5, 6, 7], [7, 6, 5, 4]],
        [7, 8, 15],
    ),
    "mqa_group8": (
        2, 8, 1, 32, 4, 6,
        [[5, 0, 3], [2, -1, 4]],
        [10, 11],
    ),
    # slot 0: pages mapped, but the only lanes at or before pos lie on the
    # unmapped page 0 -> the uniform mean of the mapped V lanes
    "mapped_no_valid_lane": (
        2, 4, 2, 8, 4, 6,
        [[-1, 3, 5], [2, 0, -1]],
        [2, 5],
    ),
    # 160 lanes a slot: three 64-lane split quanta, the last one ragged;
    # a group of 12 (two head chunks on the card)
    "long_group12": (
        2, 12, 1, 16, 16, 20,
        [[19, 3, 7, 0, 11, 2, 9, 14, 5, 1], [4, 6, 8, 10, 12, 13, 15, 16, -1, -1]],
        [150, 70],
    ),
}


def make(case, dtype=np.float32, seed=0):
    B, Hq, Hkv, Dk, ps, N, pages, pos = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, Dk)).astype(dtype)
    k = rng.normal(size=(N, Hkv, ps, Dk)).astype(dtype)
    v = rng.normal(size=(N, Hkv, ps, Dk)).astype(dtype)
    return q, k, v, np.asarray(pages, np.int32), np.asarray(pos, np.int32)


def torch_args(q, k, v, pages, pos):
    def t(a):
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return [t(x) for x in (q, k, v, pages, pos)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_ref(case):
    args = make(case)
    ours = pd.paged_gqa_attention(*torch_args(*args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    kernel = np.asarray(jax_paged(*jargs, interpret=True))
    ref = np.asarray(paged_gqa_ref(*jargs))
    np.testing.assert_allclose(ours, kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_row_with_nothing_mapped_is_zero_and_masked_rows_average_v():
    """NEG_INF is finite: a row with no valid lane averages its gathered V
    lanes (zero when no page is mapped), like the JAX kernel — not NaN."""
    q, k, v, pages, pos = make("unmapped_and_fully_masked")
    out = pd.paged_gqa_attention(*torch_args(q, k, v, pages, pos)).numpy()
    assert np.all(out[0] == 0.0)  # nothing mapped
    pos2 = pos.copy()
    pos2[1] = -1  # mapped pages, no valid lane -> mean of gathered lanes
    out2 = pd.paged_gqa_attention(*torch_args(q, k, v, pages, pos2)).numpy()
    ref = np.asarray(jax_paged(*[jnp.asarray(a) for a in (q, k, v, pages, pos2)],
                               interpret=True))
    np.testing.assert_allclose(out2, ref, atol=1e-5, rtol=1e-5)
    assert np.isfinite(out2).all()


LOG2E = 1.4426950408889634


def split_model(q, k, v, pages, pos, split_lanes):
    """K5's algorithm (csrc/paged_gqa_decode.cu) in torch, f32: each split
    of ``split_lanes`` lanes keeps an online-softmax state (m, l, acc) in
    log2 units over its valid lanes only; the splits merge by their maxima;
    a slot with no valid lane scores every lane 0, unmapped lanes weighing
    1 with V = 0 (the full softmax's uniform mean).  The kernel's splits
    are multiples of 64 lanes; the model takes any count, so the small
    cases split too."""
    B, Hq, Dk = q.shape
    Hkv, ps = k.shape[1], k.shape[2]
    P, G = pages.shape[1], Hq // Hkv
    S = P * ps
    kg, vg = pd.paged_gather(k, pages).float(), pd.paged_gather(v, pages).float()
    valid = pd.paged_valid(pages, pos, ps)
    out = torch.zeros(B, Hq, Dk)
    for b in range(B):
        uniform = not bool(valid[b].any())
        qb = q[b].float().reshape(Hkv, G, Dk) * (Dk**-0.5 * LOG2E)
        parts = []
        for s0 in range(0, S, split_lanes):
            lanes = torch.arange(s0, min(S, s0 + split_lanes))
            take = lanes if uniform else lanes[valid[b, lanes]]
            if len(take) == 0:
                continue  # the kernel's empty partial, l = 0: skipped
            sc = (torch.zeros(Hkv, G, len(take)) if uniform
                  else torch.einsum("hgd,hsd->hgs", qb, kg[b][:, take]))
            m = sc.amax(-1)
            p = torch.exp2(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hgs,hsd->hgd", p, vg[b][:, take])))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L = sum(l * torch.exp2(m - M) for m, l, _ in parts)
        A = sum(a * torch.exp2(m - M)[..., None] for m, _, a in parts)
        out[b] = (A / L[..., None]).reshape(Hq, Dk)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_model_matches_plain(case):
    """Every split size, from one page a split to the whole slot, and the
    wrapper's own, gives the plain version's output within 1e-6 (f32, O(1)
    values)."""
    q, k, v, pages, pos = torch_args(*make(case))
    want = pd.paged_gqa_plain(q, k, v, pages, pos)
    ps, S = k.shape[2], pages.shape[1] * k.shape[2]
    G = q.shape[1] // k.shape[1]
    rule = pd.gqa_split_lanes(q.shape[0], k.shape[1] * -(-G // pd.GQA_CHUNK), S, 132)
    for split_lanes in sorted({ps, 2 * ps, 3 * ps, S, rule}):
        got = split_model(q, k, v, pages, pos, split_lanes)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_mapped_pages_without_a_valid_lane_average_the_mapped_lanes():
    """The trap the kernel handles explicitly: mapped pages, no valid lane
    -> the sum of the mapped V lanes over all P * ps lanes, not 0 / 0."""
    q, k, v, pages, pos = torch_args(*make("mapped_no_valid_lane"))
    out = pd.paged_gqa_attention(q, k, v, pages, pos)
    vg = pd.paged_gather(v, pages)  # zeros on unmapped pages
    mean = vg[0].float().sum(1) / vg.shape[2]  # (Hkv, Dk)
    want = mean.repeat_interleave(q.shape[1] // k.shape[1], 0)
    np.testing.assert_allclose(out[0].numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    assert np.any(out[0].numpy() != 0.0)


@pytest.mark.parametrize(
    "B,Hkv,G,S,sms,want",
    [
        (8, 8, 2, 512, 132, 8),  # the serving shape: 8 splits of 64 lanes, 512 blocks
        (8, 8, 2, 512, 1, 1),  # the grid already fills the card
        (8, 8, 2, 512, 33, 2),  # 128 blocks >= 2 x 33 SMs
        (1, 1, 1, 65536, 132, 512),  # the fewest powers of two for two blocks an SM
        (8, 1, 48, 512, 132, 8),  # granite-20b's MQA group: 6 head chunks a kv head
        (8, 8, 12, 512, 132, 4),  # command-r-plus' group of 12: 2 head chunks
        (1, 1, 1, 300, 1000, 3),  # 8 wanted, at most 5 quanta: 4, and 128-lane splits cover 300
    ],
)
def test_split_count(B, Hkv, G, S, sms, want):
    lanes = pd.gqa_split_lanes(B, Hkv * -(-G // pd.GQA_CHUNK), S, sms)
    assert lanes % pd.SPLIT_QUANTUM == 0
    assert -(-S // lanes) == want


def test_bf16_plain_within_tolerance_of_jax_ref():
    """bf16 inputs: f32 math, output rounded to bf16 — at most a couple of
    bf16 ulps (2**-8 relative) from the JAX reference."""
    args = make("pos_at_page_edges", dtype=ml_dtypes.bfloat16)
    ours = pd.paged_gqa_attention(*torch_args(*args)).float().numpy()
    ref = np.asarray(paged_gqa_ref(*[jnp.asarray(a) for a in args])).astype(np.float32)
    np.testing.assert_allclose(ours, ref, atol=2e-2, rtol=2e-2)


def test_paged_plain_reduces_like_dense_decode_bitwise():
    """Within the port a paged decode equals the dense decode over the
    same lanes bit for bit (both run ``attend``): the paged-vs-dense
    token parity of the serving engine rests on it."""
    from repro_torch.models.layers import decode_attention

    q, k, v, pages, pos = torch_args(*make("scattered_partial_one"))
    paged = pd.paged_gqa_attention(q, k, v, pages, pos)
    kd, vd = pd.paged_gather(k, pages), pd.paged_gather(v, pages)
    ps = k.shape[2]
    lane = torch.arange(pages.shape[1] * ps)
    slot_pos = torch.where((pages >= 0).repeat_interleave(ps, 1), lane[None], -1)
    dense = decode_attention(q[:, :, None], kd, vd, slot_pos, pos)[:, :, 0]
    assert torch.equal(paged, dense)


def good_cuda_like():
    q, k, v, pages, pos = torch_args(*make("pos_at_page_edges"))
    return dict(q=q, k_pool=k, v_pool=v, pages=pages, pos=pos)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: a.update(q=a["q"].double()), TypeError),
        (lambda a: a.update(pages=a["pages"].long()), TypeError),
        (lambda a: a.update(v_pool=a["v_pool"][:, :, :4]), ValueError),
        (lambda a: a.update(q=a["q"].transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
        (lambda a: a.update(pos=a["pos"][:2]), ValueError),
        # once the shared-memory limit of the first kernel; that limit is
        # gone, and the case now holds the head-dim rule that replaced it
        (lambda a: a.update(q=a["q"][..., :12].contiguous(), k_pool=a["k_pool"][..., :12].contiguous(),
                            v_pool=a["v_pool"][..., :12].contiguous()), ValueError),
    ],
    ids=["f64", "i64_pages", "pool_shape", "noncontiguous", "pos_len", "smem_over_227k"],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    a = good_cuda_like()
    pd._check(**a)  # the good inputs pass
    mutate(a)
    with pytest.raises(err):
        pd._check(**a)


def test_long_page_table_passes_check():
    """The scores no longer live in shared memory: 8192 lanes a slot (the
    inputs the old shared-memory limit refused) are taken."""
    a = good_cuda_like()
    a.update(pages=torch.zeros((3, 8192 // a["k_pool"].shape[2]), dtype=torch.int32))
    pd._check(**a)


def test_head_dim_over_256_is_refused():
    a = good_cuda_like()
    a.update(q=torch.zeros((3, 8, 264)), k_pool=torch.zeros((8, 2, 8, 264)),
             v_pool=torch.zeros((8, 2, 8, 264)))
    with pytest.raises(ValueError, match="at most 256"):
        pd._check(**a)


def test_non_cuda_non_cpu_tensor_raises():
    a = {k: v.to("meta") for k, v in good_cuda_like().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        pd.paged_gqa_attention(**a)


def test_default_device_without_cuda_raises():
    """Entry points default to cuda and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch import bridge
    from repro_torch.core.executor import resolve_device

    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        bridge.states_from_numpy({"x": np.zeros(2, np.float32)})


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["paged_gqa_decode"])
    assert build.library_path("paged_gqa_decode").name.startswith("libpaged_gqa_decode-")


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(monkeypatch):
    """Every case, the mapped-but-no-valid-lane slot included, in f32 (1e-4)
    and bf16 (2e-2), at the wrapper's split size and at 64, 128 and 192
    lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rule = pd.gqa_split_lanes
    for n in (None, 64, 128, 192):
        monkeypatch.setattr(pd, "gqa_split_lanes", rule if n is None else lambda *a, n=n: n)
        for case in sorted(CASES):
            for dtype, tol in ((np.float32, 1e-4), (ml_dtypes.bfloat16, 2e-2)):
                args = [t.cuda() for t in torch_args(*make(case, dtype=dtype))]
                got = pd.paged_gqa_attention(*args)
                want = pd.paged_gqa_plain(*args)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    pd.paged_gqa_attention.launches = 0


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", [(96, 8), (48, 1)], ids=["group12", "group48"])
def test_kernel_takes_large_groups_on_the_card(Hq, Hkv):
    """Groups above 8 (command-r-plus' 12, granite-20b's MQA 48) against
    the plain version, f32 1e-4 and bf16 2e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(Hq)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q = torch.randn(3, Hq, 128, generator=gen).to(dtype).cuda()
        k, v = (torch.randn(12, Hkv, 16, 128, generator=gen).to(dtype).cuda() for _ in range(2))
        pages = torch.tensor([[3, 7, 1, 0], [5, -1, 2, 4], [11, 10, 9, 8]], dtype=torch.int32).cuda()
        pos = torch.tensor([63, 20, 40], dtype=torch.int32).cuda()
        got = pd.paged_gqa_attention(q, k, v, pages, pos)
        torch.testing.assert_close(got.float(), pd.paged_gqa_plain(q, k, v, pages, pos).float(),
                                   atol=tol, rtol=tol)
    pd.paged_gqa_attention.launches = 0


@pytest.mark.cuda
def test_dense_view_equals_shuffled_pages_bitwise_on_the_card():
    """The same values through a dense view and through a shuffled page
    table give the same bits: the reduction order is the lane index's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(7)
    B, Hq, Hkv, S, D, ps = 4, 16, 8, 256, 128, 16
    P = S // ps
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, Hq, D, generator=gen).to(dtype).cuda()
        k, v = (torch.randn(B, Hkv, S, D, generator=gen).to(dtype).cuda() for _ in range(2))
        pos = torch.tensor([0, 63, 64, 255], dtype=torch.int32).cuda()
        pages = torch.randperm(B * P, generator=gen).reshape(B, P).to(torch.int32).cuda()
        pools = []
        for x in (k, v):
            pool = torch.empty(B * P, Hkv, ps, D, dtype=dtype, device="cuda")
            pool[pages.long()] = x.reshape(B, Hkv, P, ps, D).permute(0, 2, 1, 3, 4)
            pools.append(pool)
        dense = pd.paged_gqa_attention(q, *pd.dense_gqa_view(k, v), pos)
        paged = pd.paged_gqa_attention(q, *pools, pages, pos)
        assert torch.equal(dense, paged)
    pd.paged_gqa_attention.launches = 0
