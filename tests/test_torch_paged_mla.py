"""K6, paged absorbed-MLA single-query decode: the port's plain version
held to the JAX package's Pallas kernel (interpret mode, as
tests/test_paging.py runs it) and to its reference ``paged_mla_ref``, at
atol = rtol = 1e-5 in f32 (different reduction order across frameworks,
values O(1)), and at 1e-3 with bf16 inputs (both sides read the same bf16
values and sum in f32; the output is f32).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there (the ``cuda``-marked test below does the
same when a card is present).  Here: the wrapper's dispatch (CPU tensors
-> plain version), its choice of heads per block (the f32 kernel) and of
splits (the bf16 kernel: lanes in multiples of its 64-lane tile), and its
refusal of inputs the kernel does not take.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode import paged_mla_attention as jax_paged_mla
from repro.kernels.ref import paged_mla_ref
from repro_torch.kernels import paged_decode as pd
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

CASES = {
    # B, h, lora, rope, ps, N, pages, pos
    "scattered_partial_last_page": (
        3, 4, 16, 8, 8, 10,
        [[7, 2, 9, 0], [5, 3, -1, -1], [8, -1, -1, -1]],
        [29, 11, 0],
    ),
    "unmapped_middle_and_nothing_mapped": (
        4, 4, 16, 8, 4, 12,
        [[-1, -1, -1], [3, -1, 6], [11, 10, 9], [1, 4, -1]],
        [5, 9, 11, 2],
    ),
    "row_past_the_pool": (
        2, 8, 32, 16, 4, 6,
        [[5, 17, 3], [2, 0, 4]],
        [10, 6],
    ),
    "pos_at_page_edges": (
        3, 2, 24, 8, 8, 8,
        [[0, 1, 2, 3], [4, 5, 6, 7], [7, 6, 5, 4]],
        [7, 8, 15],
    ),
}
SCALE = 24**-0.5


def make(case, dtype=np.float32, seed=0):
    B, h, lora, rope, ps, N, pages, pos = CASES[case]
    rng = np.random.default_rng(seed)
    q_lat = rng.normal(size=(B, h, lora)).astype(dtype)
    q_rope = rng.normal(size=(B, h, rope)).astype(dtype)
    ckv = rng.normal(size=(N, ps, lora)).astype(dtype)
    krope = rng.normal(size=(N, ps, rope)).astype(dtype)
    return q_lat, q_rope, ckv, krope, np.asarray(pages, np.int32), np.asarray(pos, np.int32)


def torch_args(*arrays):
    def t(a):
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return [t(x) for x in arrays]


def jax_both(args):
    jargs = [jnp.asarray(a) for a in args]
    kernel = np.asarray(jax_paged_mla(*jargs, scale=SCALE, interpret=True))
    ref = np.asarray(paged_mla_ref(*jargs, scale=SCALE))
    return kernel, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_kernel_and_ref(case):
    args = make(case)
    ours = pd.paged_mla_attention(*torch_args(*args), scale=SCALE)
    assert ours.dtype == torch.float32 and ours.shape == args[0].shape
    kernel, ref = jax_both(args)
    np.testing.assert_allclose(ours.numpy(), kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_nothing_mapped_is_zero_and_no_valid_lane_averages_ckv():
    """NEG_INF is finite: a row with no valid lane averages its gathered
    ckv lanes (zero when no page is mapped), like the JAX kernel — not
    NaN.  Inactive serving slots reach the kernel in this state."""
    args = list(make("unmapped_middle_and_nothing_mapped"))
    out = pd.paged_mla_attention(*torch_args(*args), scale=SCALE).numpy()
    assert np.all(out[0] == 0.0)  # nothing mapped
    args[5] = args[5].copy()
    args[5][1] = -1  # mapped pages, no valid lane -> mean of the gathered lanes
    out2 = pd.paged_mla_attention(*torch_args(*args), scale=SCALE).numpy()
    kernel, _ = jax_both(args)
    np.testing.assert_allclose(out2, kernel, atol=1e-5, rtol=1e-5)
    gathered = pd.paged_gather_lanes(*torch_args(args[2], args[4]))[1].numpy()
    np.testing.assert_allclose(out2[1], np.broadcast_to(gathered.mean(0), out2[1].shape),
                               atol=1e-6, rtol=1e-6)


def test_bf16_inputs_within_1e3_of_jax_ref():
    """bf16 inputs, f32 output: the same bf16 values summed in f32 in
    another order."""
    args = make("row_past_the_pool", dtype=ml_dtypes.bfloat16)
    ours = pd.paged_mla_attention(*torch_args(*args), scale=SCALE)
    assert ours.dtype == torch.float32
    _, ref = jax_both(args)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-3, rtol=1e-3)


def test_paged_plain_reduces_like_dense_decode_bitwise():
    """Within the port a paged MLA decode equals the dense absorbed decode
    over the same lanes bit for bit (both run ``attend_mla``): the
    paged-vs-dense token parity of the serving engine rests on it."""
    q_lat, q_rope, ckv, krope, pages, pos = torch_args(*make("scattered_partial_last_page"))
    paged = pd.paged_mla_attention(q_lat, q_rope, ckv, krope, pages, pos, scale=SCALE)
    ckv_d, kr_d = pd.paged_gather_lanes(ckv, pages), pd.paged_gather_lanes(krope, pages)
    ps = ckv.shape[1]
    lane = torch.arange(pages.shape[1] * ps)
    slot_pos = torch.where((pages >= 0).repeat_interleave(ps, 1), lane[None], -1)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    dense = pd.attend_mla(q_lat, q_rope, ckv_d, kr_d, valid, SCALE)
    assert torch.equal(paged, dense)


@pytest.mark.parametrize(
    "h,S,want",
    [(128, 512, 16), (128, 4096, 8), (128, 16384, 2), (128, 32768, 1), (4, 32, 4), (6, 512, 2)],
    ids=["served", "s4096", "s16384", "s32768", "reduced", "six_heads"],
)
def test_heads_per_block(h, S, want):
    """The wrapper's G: the largest power of two up to 16 that divides h
    and whose block fits in shared memory."""
    G = pd.mla_group(h, 512, 64, S, S // 16)
    assert G == want
    assert pd.mla_smem_bytes(G, 512, 64, S, S // 16) <= pd.SMEM_LIMIT


@pytest.mark.parametrize(
    "B,h,S,sms,want",
    [(8, 128, 512, 132, 4), (8, 128, 4096, 132, 8), (8, 128, 16384, 132, 8),
     (8, 128, 512, 16, 1), (1, 3, 100, 132, 1), (1, 128, 4096, 132, 32)],
    ids=["served", "s4096", "s16384", "small_card", "reduced", "one_slot"],
)
def test_bf16_split_count(B, h, S, sms, want):
    """The bf16 kernel's splits: the most, a power of two, that keep the
    grid (B, ceil(h / 64), splits) within one wave of one block an SM,
    with at least two 64-lane tiles a split."""
    lanes = pd.mla_split_lanes(B, -(-h // pd.MLA_HEADS), S, sms)
    assert lanes % pd.SPLIT_QUANTUM == 0
    assert -(-S // lanes) == want


def good_inputs():
    q_lat, q_rope, ckv, krope, pages, pos = torch_args(*make("pos_at_page_edges"))
    return dict(q_lat=q_lat, q_rope=q_rope, ckv_pool=ckv, krope_pool=krope, pages=pages, pos=pos)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: a.update(q_lat=a["q_lat"].double()), TypeError),
        (lambda a: a.update(krope_pool=a["krope_pool"].bfloat16()), TypeError),
        (lambda a: a.update(pages=a["pages"].long()), TypeError),
        (lambda a: a.update(q_lat=a["q_lat"][None]), ValueError),
        (lambda a: a.update(ckv_pool=a["ckv_pool"][:, :, :16]), ValueError),
        (lambda a: a.update(q_rope=a["q_rope"][:, :1]), ValueError),
        (lambda a: a.update(q_lat=a["q_lat"].transpose(0, 1).contiguous().transpose(0, 1)),
         ValueError),
        (lambda a: a.update(q_lat=torch.zeros(3 * 2 * 25 + 1)[1:].view(3, 2, 25)[:, :, :24]),
         ValueError),
        (lambda a: a.update(pos=a["pos"][:2]), ValueError),
        (lambda a: a.update(q_lat=a["q_lat"][:, :, :20], ckv_pool=a["ckv_pool"][:, :, :20]
                            .contiguous()), ValueError),
        (lambda a: a.update(pages=torch.zeros((3, 8192), dtype=torch.int32)), ValueError),
    ],
    ids=["f64", "mixed_dtypes", "i64_pages", "rank", "pool_width", "heads", "noncontiguous",
         "unaligned", "pos_len", "lora_not_multiple_of_8", "smem_over_227k"],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    a = good_inputs()
    pd._check_mla(**a)  # the good inputs pass
    mutate(a)
    with pytest.raises(err):
        pd._check_mla(**a)


def test_bf16_takes_long_caches_and_refuses_wide_rows():
    """The bf16 kernel keeps no scores in shared memory: the 65536-lane
    table the f32 kernel refuses passes; rows wider than its instance
    (lora 512, rope 64) are refused."""
    a = {k: v.bfloat16() if v.is_floating_point() else v for k, v in good_inputs().items()}
    a.update(pages=torch.zeros((3, 8192), dtype=torch.int32))
    pd._check_mla(**a)
    a = {k: v.bfloat16() if v.is_floating_point() else v for k, v in good_inputs().items()}
    a.update(q_lat=torch.zeros((3, 2, 520), dtype=torch.bfloat16),
             ckv_pool=torch.zeros((8, 8, 520), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="lora <= 512"):
        pd._check_mla(**a)


def test_non_cuda_non_cpu_tensor_raises():
    a = {k: v.to("meta") for k, v in good_inputs().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        pd.paged_mla_attention(**a, scale=SCALE)


def test_cuda_without_a_card_raises():
    """A CUDA tensor never falls back to the plain version: without a card
    the request itself raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        pd.paged_mla_attention(*[t.to("cuda") for t in good_inputs().values()], scale=SCALE)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for case in sorted(CASES):
        args = [t.cuda() for t in torch_args(*make(case))]
        pd.paged_mla_attention.launches = 0
        got = pd.paged_mla_attention(*args, scale=SCALE)
        assert pd.paged_mla_attention.launches == 1
        ref = pd.paged_mla_plain(*args, scale=SCALE)
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_bf16_kernel_matches_plain_at_every_split_on_the_card(monkeypatch):
    """The tensor-core kernel, bf16 inputs, f32 output, 1e-3, at the
    wrapper's splits and at 64, 128 and 256 lanes a split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rule = pd.mla_split_lanes
    for n in (None, 64, 128, 256):
        monkeypatch.setattr(pd, "mla_split_lanes", rule if n is None else lambda *a, n=n: n)
        for case in sorted(CASES):
            args = [t.cuda() for t in torch_args(*make(case, dtype=ml_dtypes.bfloat16))]
            got = pd.paged_mla_attention(*args, scale=SCALE)
            ref = pd.paged_mla_plain(*args, scale=SCALE)
            torch.testing.assert_close(got, ref, atol=1e-3, rtol=1e-3)
    pd.paged_mla_attention.launches = 0


@pytest.mark.cuda
def test_dense_view_equals_shuffled_pages_bitwise_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(3)
    B, h, S, lora, rope, ps = 3, 128, 256, 512, 64, 16
    P = S // ps
    for dtype in (torch.float32, torch.bfloat16):
        ql, qr = (torch.randn(B, h, d, generator=gen).to(dtype).cuda() for d in (lora, rope))
        ckv, kr = (torch.randn(B, S, d, generator=gen).to(dtype).cuda() for d in (lora, rope))
        pos = torch.tensor([0, 100, 255], dtype=torch.int32).cuda()
        pages = torch.randperm(B * P, generator=gen).reshape(B, P).to(torch.int32).cuda()
        pools = []
        for x in (ckv, kr):
            pool = torch.empty(B * P, ps, x.shape[-1], dtype=dtype, device="cuda")
            pool[pages.long()] = x.reshape(B, P, ps, -1)
            pools.append(pool)
        dense = pd.paged_mla_attention(ql, qr, *pd.dense_mla_view(ckv, kr), pos, scale=SCALE)
        paged = pd.paged_mla_attention(ql, qr, *pools, pages, pos, scale=SCALE)
        assert torch.equal(dense, paged)
    pd.paged_mla_attention.launches = 0
