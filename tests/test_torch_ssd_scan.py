"""K8, the Mamba2 SSD chunked scan: the port's plain version held to the
JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py
runs it) on that file's shape table, and to the reference ``ssd_ref`` on
ragged lengths the Pallas kernel refuses, with and without ``h0``.
Tolerances are test_kernels.py's: f32 1e-4 (the chunked and the
quadratic forms sum in different orders), bf16 5e-2 (inputs and y are
bf16; a few bf16 ulps at O(1) values).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to this
plain version at the served shapes); ``test_kernel_matches_plain_on_the_card``
does the same here when a card is present.  Here: the wrapper's dispatch
(CPU tensors -> plain version, no launch) and its refusal of inputs the
kernel does not take.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ks
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def inputs(b, l, h, p, g, n, dtype=np.float32, seed=0, with_h0=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(dtype)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)  # softplus
    a = -np.exp(rng.normal(size=(h,)) * 0.5).astype(np.float32)
    bm = rng.normal(size=(b, l, g, n)).astype(dtype)
    cm = rng.normal(size=(b, l, g, n)).astype(dtype)
    h0 = rng.normal(size=(b, h, n, p)).astype(np.float32) if with_h0 else None
    return x, dt, a, bm, cm, h0


def tt(a):
    """numpy -> CPU tensor, bf16 by its bits."""
    if a is None:
        return None
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def ours(args, chunk):
    x, dt, a, bm, cm, h0 = (tt(v) for v in args)
    y, ht = ops.ssd(x, dt, a, bm, cm, h0=h0, chunk=chunk)
    return y.float().numpy(), ht.numpy()


@pytest.fixture(autouse=True)
def no_launches():
    """The CPU path launches no kernel."""
    ks.ssd_scan.launches = 0
    yield
    assert ks.ssd_scan.launches == 0


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,l,h,p,g,n,chunk",
    [
        (1, 64, 2, 16, 1, 32, 16),
        (2, 64, 4, 32, 2, 16, 32),
        (1, 128, 2, 64, 1, 64, 64),
        (1, 32, 2, 16, 1, 32, 32),  # single chunk
    ],
)
def test_plain_matches_jax_kernel(b, l, h, p, g, n, chunk, dtype):
    args = inputs(b, l, h, p, g, n, dtype)
    y, ht = ours(args, chunk)
    jy, jht = jax_ssd(*[jnp.asarray(v) for v in args[:5]], chunk=chunk, interpret=True)
    tol = 1e-4 if dtype == np.float32 else 5e-2
    np.testing.assert_allclose(y, np.asarray(jy, np.float32), atol=tol, rtol=tol)
    np.testing.assert_allclose(ht, np.asarray(jht), atol=tol, rtol=tol)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
@pytest.mark.parametrize("l,chunk,g", [(37, 16, 1), (130, 32, 2), (5, 128, 1)])
def test_ragged_length_matches_reference(l, chunk, g, with_h0):
    """L not a multiple of the chunk: the last chunk is padded with dt = 0
    and x = B = C = 0, which leaves y and the state exact."""
    args = inputs(2, l, 4, 8, g, 16, seed=l, with_h0=with_h0)
    y, ht = ours(args, chunk)
    x, dt, a, bm, cm, h0 = (None if v is None else jnp.asarray(v) for v in args)
    ry, rht = ref.ssd_ref(x, dt, a, bm, cm, h0=h0)
    np.testing.assert_allclose(y, np.asarray(ry), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ht, np.asarray(rht), atol=1e-4, rtol=1e-4)


def test_initial_state_carries_and_split_equals_one_shot():
    """tests/test_kernels.py's carry check: two calls chained through the
    state equal one call over the whole sequence, and both match JAX."""
    b, l, h, p, g, n = 1, 32, 2, 16, 1, 8
    x, dt, a, bm, cm, h0 = (tt(v) for v in inputs(b, l, h, p, g, n, seed=7, with_h0=True))
    dt = dt * 0.5
    y, ht = ops.ssd(x, dt, a, bm, cm, h0=h0, chunk=16)
    y1, h1 = ops.ssd(x[:, :16], dt[:, :16], a, bm[:, :16], cm[:, :16], h0=h0, chunk=16)
    y2, h2 = ops.ssd(x[:, 16:], dt[:, 16:], a, bm[:, 16:], cm[:, 16:], h0=h1, chunk=16)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h2.numpy(), ht.numpy(), atol=1e-4, rtol=1e-4)
    jy, jht = jax_ssd(*[jnp.asarray(v.numpy()) for v in (x, dt, a, bm, cm)],
                      h0=jnp.asarray(h0.numpy()), chunk=16, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ht.numpy(), np.asarray(jht), atol=1e-4, rtol=1e-4)


def test_strong_decay_gives_no_nan():
    """Large dt * |a| drives exp(cum_i - cum_j) for j > i toward inf; only
    the j <= i half is evaluated, so nothing overflows into the result."""
    x, dt, a, bm, cm, _ = (tt(v) for v in inputs(1, 64, 2, 8, 1, 8, seed=3))
    y, ht = ops.ssd(x, dt * 200.0, a * 10.0, bm, cm, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(ht).all()
    jy, _ = ref.ssd_ref(*[jnp.asarray(v.numpy()) for v in (x, dt * 200.0, a * 10.0, bm, cm)])
    np.testing.assert_allclose(y.numpy(), np.nan_to_num(np.asarray(jy)), atol=1e-4, rtol=1e-4)


def good_args():
    x, dt, a, bm, cm, h0 = (tt(v) for v in inputs(1, 40, 4, 8, 2, 16, with_h0=True))
    return dict(x=x, dt=dt, a=a, b=bm, c=cm, h0=h0, chunk=16)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: a.update(x=a["x"].double()), TypeError),
        (lambda a: a.update(dt=a["dt"].bfloat16()), TypeError),
        (lambda a: a.update(b=a["b"].bfloat16()), TypeError),
        (lambda a: a.update(c=a["c"][:, :, :1]), ValueError),
        (lambda a: a.update(a=a["a"][:3]), ValueError),
        (lambda a: a.update(h0=a["h0"][:, :, :8]), ValueError),
        (lambda a: a.update(x=a["x"].transpose(2, 3).contiguous().transpose(2, 3)), ValueError),
        (lambda a: a.update(b=torch.zeros((1, 40, 3, 16)), c=torch.zeros((1, 40, 3, 16))), ValueError),
        (lambda a: a.update(b=torch.zeros((1, 40, 2, 1024)), c=torch.zeros((1, 40, 2, 1024)),
                            h0=None, chunk=128), ValueError),
    ],
    ids=["f64", "dt_bf16", "b_dtype", "c_shape", "a_shape", "h0_shape", "noncontiguous",
         "groups_not_dividing_heads", "smem_over_227k"],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, err):
    a = good_args()
    ks._check(**a)
    mutate(a)
    with pytest.raises(err):
        ks._check(**a)


def bf16_args(l=300, chunk=128):
    """mamba2's head shape (P 64, N 128), two groups, bf16, with h0."""
    x, dt, a, bm, cm, h0 = (tt(v) for v in inputs(1, l, 4, 64, 2, 128, ml_dtypes.bfloat16,
                                                 with_h0=True))
    return dict(x=x, dt=dt, a=a, b=bm, c=cm, h0=h0, chunk=chunk)


def unaligned(t):
    """t's values in a contiguous tensor whose data starts 2 bytes past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    flat.copy_(t.reshape(-1))
    return flat.view(t.shape)


@pytest.mark.parametrize(
    "mutate",
    [
        lambda a: a.update(chunk=64),
        lambda a: a.update(chunk=256),
        lambda a: a.update(b=torch.zeros((1, 300, 2, 136), dtype=torch.bfloat16),
                           c=torch.zeros((1, 300, 2, 136), dtype=torch.bfloat16), h0=None),
        lambda a: a.update(x=torch.zeros((1, 300, 4, 72), dtype=torch.bfloat16), h0=None),
        lambda a: a.update(x=torch.zeros((1, 300, 4, 60), dtype=torch.bfloat16), h0=None),
        lambda a: a.update(b=torch.zeros((1, 300, 2, 100), dtype=torch.bfloat16),
                           c=torch.zeros((1, 300, 2, 100), dtype=torch.bfloat16), h0=None),
        lambda a: a.update(x=unaligned(a["x"])),
        lambda a: a.update(h0=unaligned(a["h0"])),
    ],
    ids=["chunk_64", "chunk_256", "state_over_128", "head_dim_over_64", "head_dim_not_x8",
         "state_not_x8", "x_unaligned", "h0_unaligned"],
)
def test_wrapper_refuses_what_the_bf16_kernel_does_not_take(mutate):
    """The bf16 instance scans chunks of 128 rows, N <= 128 and P <= 64 in
    multiples of 8 (zero-padded to the instance), with 16-byte copies."""
    a = bf16_args()
    ks._check(**a)
    mutate(a)
    with pytest.raises(ValueError):
        ks._check(**a)


@pytest.mark.parametrize("l,chunk", [(300, 128), (128, 256), (100, 100), (40, 64), (1, 16)])
def test_bf16_kernel_takes_its_chunks(l, chunk):
    """chunk = 128, or a single chunk of at most 128 rows: the chunk
    boundaries are the kernel's either way."""
    a = bf16_args(l, chunk)
    ks._check(**a)
    assert ks.bf16_blocks(1, l, 4, 128, 64)["chunk_outputs"] == 4 * 2 * -(-l // 128)


def test_non_cuda_non_cpu_tensor_raises():
    a = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v) for k, v in good_args().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        ks.ssd_scan(a.pop("x"), a.pop("dt"), a.pop("a"), a.pop("b"), a.pop("c"), **a)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for l, with_h0 in ((256, False), (300, True)):
        args = [None if v is None else tt(v).cuda()
                for v in inputs(1, l, 8, 64, 1, 128, ml_dtypes.bfloat16, with_h0=with_h0)]
        x, dt, a, bm, cm, h0 = args
        y, ht = ks.ssd_scan(x, dt, a, bm, cm, h0=h0)
        ry, rht = ks.ssd_scan_plain(x, dt, a, bm, cm, h0=h0)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), ry.float(), atol=5e-2, rtol=5e-2)
        torch.testing.assert_close(ht, rht, atol=1e-3, rtol=1e-3)
    ks.ssd_scan.launches = 0
