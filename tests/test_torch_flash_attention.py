"""K7, blocked (flash) attention: the port's plain version held to the JAX
package's Pallas kernel (interpret mode) on tests/test_kernels.py's cases
and to ``attention_ref``, plus fully masked rows, ``q_offset`` and ragged
lengths the Pallas kernel refuses.  Tolerances are test_kernels.py's:
f32 2e-5 (different reduction order), bf16 2e-2 (output rounded to bf16;
a few ulps at O(1) values).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to this
plain version at internlm2's head layout); ``test_kernel_matches_plain_on_the_card``
does the same here when a card is present.
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
    ],
    ids=["f64", "v_dtype", "kv_shape", "heads_not_grouped", "noncontiguous", "smem_over_227k",
         "window_0"],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    a = good_args()
    fa._check(**a)
    mutate(a)
    with pytest.raises(err):
        fa._check(**a)


def test_non_cuda_non_cpu_tensor_raises():
    q, k, v = (tt(x).to("meta") for x in qkv(1, 2, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(q, k, v)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for sq, sk, window, off in ((512, 512, None, 0), (100, 300, 64, 200)):
        q, k, v = (tt(x).cuda() for x in qkv(1, 16, 8, sq, sk, 128, ml_dtypes.bfloat16))
        got = fa.flash_attention(q, k, v, window=window, q_offset=off)
        want = fa.attention_plain(q, k, v, window=window, q_offset=off)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    fa.flash_attention.launches = 0
