"""K7, blocked (flash) attention: the port's plain version held to the JAX
package's Pallas kernel (interpret mode) on tests/test_kernels.py's cases
and to ``attention_ref``, plus fully masked rows, ``q_offset`` and ragged
lengths the Pallas kernel refuses.  Tolerances are test_kernels.py's:
f32 2e-5 (different reduction order), bf16 2e-2 (output rounded to bf16;
a few ulps at O(1) values).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to this
plain version at internlm2's head layout); ``test_kernel_matches_plain_on_the_card``
does the same here when a card is present.  Here also: a torch model of
the bf16 kernel's algorithm (D zero-padded to its instance, online softmax
over key tiles, P rounded to bf16 before P.V) within the bf16 tolerance
of the plain version, and the wrapper's choice of instance and
warpgroups.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def qkv(b, hq, hkv, sq, sk, d, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(dtype),
            rng.normal(size=(b, hkv, sk, d)).astype(dtype),
            rng.normal(size=(b, hkv, sk, d)).astype(dtype))


def tt(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.fixture(autouse=True)
def no_launches():
    """The CPU path launches no kernel."""
    fa.flash_attention.launches = 0
    yield
    assert fa.flash_attention.launches == 0


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,hq,hkv,sq,sk,d,causal,window,bq,bk",
    [
        (1, 2, 2, 64, 64, 32, True, None, 32, 32),  # MHA causal
        (2, 4, 2, 64, 64, 64, True, None, 32, 32),  # GQA
        (1, 4, 1, 32, 32, 64, True, None, 16, 16),  # MQA
        (1, 2, 2, 64, 64, 32, False, None, 32, 32),  # bidirectional
        (1, 2, 1, 64, 64, 32, True, 24, 16, 16),  # sliding window
        (1, 2, 2, 32, 96, 32, True, None, 16, 32),  # chunked prefill
        (1, 3, 3, 48, 48, 16, True, 16, 24, 16),  # odd heads + window
    ],
)
def test_plain_matches_jax_kernel_and_ref(b, hq, hkv, sq, sk, d, causal, window, bq, bk, dtype):
    q, k, v = qkv(b, hq, hkv, sq, sk, d, dtype)
    q_offset = sk - sq  # queries are the suffix of the kv timeline
    out = ops.attention(tt(q), tt(k), tt(v), causal=causal, window=window,
                        q_offset=q_offset).float().numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kern = jax_flash(jq, jk, jv, causal=causal, window=window, q_offset=q_offset,
                     block_q=bq, block_k=bk, interpret=True)
    want = ref.attention_ref(jq, jk, jv, causal=causal, window=window, q_offset=q_offset)
    tol = 2e-2 if dtype is ml_dtypes.bfloat16 else 2e-5
    np.testing.assert_allclose(out, np.asarray(kern, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(out, np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_fully_masked_rows_are_zero_like_jax():
    """A window narrower than the query offset hides every key from the
    first rows: they are 0 (the kernel's l = 0 branch), not NaN."""
    q, k, v = qkv(1, 2, 1, 32, 32, 16, seed=1)
    out = ops.attention(tt(q), tt(k), tt(v), causal=True, window=4, q_offset=-8).numpy()
    assert np.isfinite(out).all()
    assert np.all(out[:, :, :8] == 0.0) and np.any(out[:, :, 8:] != 0.0)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    kern = jax_flash(jq, jk, jv, causal=True, window=4, q_offset=-8, block_q=8, block_k=8,
                     interpret=True)
    np.testing.assert_allclose(out, np.asarray(kern), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("q_offset", [0, 5, 40])
def test_q_offset_matches_jax_kernel(q_offset):
    q, k, v = qkv(1, 4, 2, 16, 64, 32, seed=q_offset)
    out = ops.attention(tt(q), tt(k), tt(v), q_offset=q_offset).numpy()
    kern = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), q_offset=q_offset, block_q=16,
                     block_k=16, interpret=True)
    np.testing.assert_allclose(out, np.asarray(kern), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("sq,sk,window", [(37, 37, None), (21, 70, 9), (1, 33, None)])
def test_ragged_lengths_match_reference(sq, sk, window):
    """Sq / Sk that no block divides (the Pallas wrapper asserts)."""
    q, k, v = qkv(1, 4, 2, sq, sk, 16, seed=sq)
    out = ops.attention(tt(q), tt(k), tt(v), window=window, q_offset=sk - sq).numpy()
    want = ref.attention_ref(*(jnp.asarray(x) for x in (q, k, v)), window=window,
                             q_offset=sk - sq)
    np.testing.assert_allclose(out, np.asarray(want), atol=2e-5, rtol=2e-5)


def good_args():
    q, k, v = (tt(x) for x in qkv(1, 4, 2, 40, 40, 32))
    return dict(q=q, k=k, v=v, window=None)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: a.update(q=a["q"].double()), TypeError),
        (lambda a: a.update(v=a["v"].bfloat16()), TypeError),
        (lambda a: a.update(k=a["k"][:, :, :8]), ValueError),
        (lambda a: a.update(q=torch.zeros((1, 3, 40, 32))), ValueError),
        (lambda a: a.update(q=a["q"].transpose(2, 3).contiguous().transpose(2, 3)), ValueError),
        (lambda a: a.update(q=torch.zeros((1, 4, 4, 512)), k=torch.zeros((1, 2, 4, 512)),
                            v=torch.zeros((1, 2, 4, 512))), ValueError),
        (lambda a: a.update(window=0), ValueError),
        (lambda a: a.update(q=torch.zeros((1, 4, 4, 512), dtype=torch.bfloat16),
                            k=torch.zeros((1, 2, 4, 512), dtype=torch.bfloat16),
                            v=torch.zeros((1, 2, 4, 512), dtype=torch.bfloat16)), ValueError),
    ],
    ids=["f64", "v_dtype", "kv_shape", "heads_not_grouped", "noncontiguous", "smem_over_227k",
         "window_0", "bf16_head_dim_over_256"],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    a = good_args()
    fa._check(**a)
    mutate(a)
    with pytest.raises(err):
        fa._check(**a)


LOG2E = 1.4426950408889634


def wgmma_model(q, k, v, *, causal=True, window=None, q_offset=0):
    """K7's bf16 algorithm (csrc/flash_attention.cu, bf16_kernel) in torch:
    D zero-padded to the kernel's instance, f32 scores of the bf16 inputs
    in log2 units, an online softmax over key tiles (128 keys, 64 at the
    256 instance), P rounded to bf16 before P.V, f32 accumulators, rows
    with no visible key 0."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    inst, _ = fa.plan(B, Hq, Sq, D, sms=1)
    block_k = 64 if inst == 256 else 128

    def pad(x):
        return torch.nn.functional.pad(x.float(), (0, inst - D))

    qf = pad(q) * (D**-0.5 * LOG2E)
    kf, vf = (pad(x).repeat_interleave(Hq // Hkv, dim=1) for x in (k, v))
    qpos = torch.arange(Sq)[:, None] + q_offset
    m = torch.full((B, Hq, Sq), -torch.inf)
    l = torch.zeros((B, Hq, Sq))
    acc = torch.zeros((B, Hq, Sq, inst))
    for k0 in range(0, Sk, block_k):
        kpos = torch.arange(k0, min(Sk, k0 + block_k))[None, :]
        vis = torch.ones((Sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            vis &= kpos <= qpos
        if window is not None:
            vis &= kpos > qpos - window
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + block_k])
        s = s.masked_fill(~vis, -torch.inf)
        mx = torch.maximum(m, s.amax(-1))
        mu = torch.where(mx == -torch.inf, 0.0, mx)
        al = torch.exp2(m - mu)
        p = torch.exp2(s - mu[..., None])
        l = l * al + p.sum(-1)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), vf[:, :, k0:k0 + block_k])
        acc = acc * al[..., None] + pv
        m = mx
    out = torch.where(l[..., None] > 0, acc / l.clamp_min(1e-30)[..., None], 0.0)
    return out[..., :D].to(q.dtype)


@pytest.mark.parametrize("D", [128, 120])
def test_bf16_kernel_model_within_tolerance_of_plain(D):
    """P rounded to bf16 before P.V costs 2**-9 relative on weights that
    sum to 1: within the bf16 tolerance, 2e-2, at internlm2's head layout
    and at a D the kernel zero-pads (120 -> 128)."""
    q, k, v = (tt(x) for x in qkv(1, 16, 8, 512, 512, D, ml_dtypes.bfloat16, seed=D))
    got = wgmma_model(q, k, v)
    want = fa.attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


def row_rel_l2(got, want):
    return float(((got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)).max())


@pytest.mark.parametrize("D", [64, 128, 256])
def test_bf16_kernel_model_rows_within_limit_and_a_skipped_tile_is_not(D):
    """The row limit chip_smoke.py holds K7's bf16 output to, 1e-2 relative
    L2: the algorithm's roundings (P and the output to bf16, about 2**-9
    each) stay far inside it at 1024 keys, while the same rows with one
    key tile skipped by the last quarter's queries fall outside it, though
    their elements are ~0.03 and within the elementwise 2e-2."""
    q, k, v = (tt(x) for x in qkv(1, 4, 2, 1024, 1024, D, ml_dtypes.bfloat16, seed=D + 1))
    want = fa.attention_plain(q, k, v)
    assert row_rel_l2(wgmma_model(q, k, v), want) < 1e-2
    t0, t1 = 5 * 128, 6 * 128
    keep = torch.ones(1024, 1024, dtype=torch.bool).tril()
    keep[768:, t0:t1] = False
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * D**-0.5, k.float().repeat_interleave(2, 1))
    p = torch.softmax(s.masked_fill(~keep, -torch.inf), -1)
    skipped = torch.einsum("bhqk,bhkd->bhqd", p, v.float().repeat_interleave(2, 1)).bfloat16()
    assert row_rel_l2(skipped, want) > 1e-2


def test_bf16_kernel_model_masks_like_plain():
    """Window, q_offset, ragged lengths and fully masked rows, in f32
    inputs so only the bf16 rounding of P differs."""
    q, k, v = (tt(x) for x in qkv(2, 4, 2, 37, 70, 24, seed=7))
    for kw in (dict(window=9, q_offset=33), dict(window=4, q_offset=-8), dict(causal=False)):
        got = wgmma_model(q, k, v, **kw)
        want = fa.attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize(
    "B,Hq,Sq,D,sms,want",
    [
        (1, 16, 512, 128, 132, (128, 1)),  # 64 blocks of 128 rows < 132 SMs
        (1, 16, 4096, 128, 132, (128, 2)),  # 512 blocks of 128 rows
        (1, 16, 4096, 120, 132, (128, 2)),  # zero-padded to 128
        (1, 16, 512, 64, 1, (64, 2)),
        (1, 16, 512, 256, 132, (256, 1)),
        (2, 8, 100, 8, 16, (64, 2)),
        (1, 4, 512, 200, 132, (256, 1)),
    ],
)
def test_bf16_plan(B, Hq, Sq, D, sms, want):
    assert fa.plan(B, Hq, Sq, D, sms) == want


def test_bf16_plan_refuses_head_dim_over_256():
    with pytest.raises(ValueError, match="at most 256"):
        fa.plan(1, 16, 512, 257, 132)


def test_non_cuda_non_cpu_tensor_raises():
    q, k, v = (tt(x).to("meta") for x in qkv(1, 2, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, k, v)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    # 2048 rows: two warpgroups a block at D = 64 and 256 (fa.plan)
    for sq, sk, window, off, d in ((512, 512, None, 0, 128), (100, 300, 64, 200, 128),
                                   (512, 512, None, 0, 64), (512, 512, None, 0, 120),
                                   (512, 512, None, 0, 256), (2048, 2048, None, 0, 64),
                                   (2048, 2048, None, 0, 256)):
        q, k, v = (tt(x).cuda() for x in qkv(1, 16, 8, sq, sk, d, ml_dtypes.bfloat16))
        got = fa.flash_attention(q, k, v, window=window, q_offset=off)
        want = fa.attention_plain(q, k, v, window=window, q_offset=off)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
        assert row_rel_l2(got, want) < 1e-2
    fa.flash_attention.launches = 0
