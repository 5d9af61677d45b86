"""K8's bf16 kernel, in plain torch: its three steps (chunk states, state
passing, chunk outputs) and its hi/lo bf16 operand split.

The steps chained (``ssd_scan_chunked``) are held to the plain version
``ssd_scan_plain`` (1e-5: the same f32 arithmetic, batched over chunks
instead of looped), to the JAX package's Pallas kernel in interpret mode
and to ``ref.ssd_ref`` at ragged lengths, with more than one B/C group
and with an initial state (1e-4, test_kernels.py's f32 tolerance: the
chunked and the quadratic forms sum in different orders).

The kernel hands each operand that is f32 by nature (``wl o B``, ``W``,
``S_in``) to the bf16 tensor cores as a bf16 high part plus a bf16
remainder.  At L = 300 (three chunks of 128) at mamba2's head shape that
keeps y (before its final rounding) and the state within the 1e-3 limit
``chip_smoke.py`` holds the kernel to; one bf16 rounding of any of the
three operands breaks the limit of the output it feeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro_torch.kernels import ssd_scan as ks
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def inputs(b, l, h, p, g, n, seed=0, with_h0=False):
    """tests/test_torch_ssd_scan.py's inputs, f32 CPU tensors."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)  # softplus
    a = -np.exp(rng.normal(size=(h,)) * 0.5).astype(np.float32)
    bm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, l, g, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, n, p)).astype(np.float32) if with_h0 else None
    return [None if v is None else torch.from_numpy(v) for v in (x, dt, a, bm, cm, h0)]


def mamba_inputs(L, H=8, seed=0):
    """Inputs as a mamba2-2.7b layer makes them (chip_smoke.py's
    ``ssd_inputs``) at its head shape (P 64, N 128, one group), with an
    initial state: dt = softplus(normal - 2), a = -(1..16), x / B / C
    bf16 values held in f32."""
    rng = np.random.default_rng(seed)
    bf = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16().float()
    x = bf(1, L, H, 64)
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.normal(size=(1, L, H)).astype(np.float32)) - 2.0)
    a = -torch.linspace(1.0, 16.0, H)
    bm, cm = bf(1, L, 1, 128), bf(1, L, 1, 128)
    h0 = torch.from_numpy(rng.normal(size=(1, H, 128, 64)).astype(np.float32))
    return x, dt, a, bm, cm, h0


def close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)


def over_limit(got, ref, tol=1e-3):
    """Worst |got - ref| / (tol + tol |ref|): above 1 breaks atol = rtol = tol."""
    return float(((got - ref).abs() / (tol + tol * ref.abs())).max())


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (1, 300, 4, 16, 1, 32, 128),  # three chunks, the last ragged
    (2, 37, 4, 8, 2, 16, 16),
    (2, 130, 4, 8, 2, 16, 32),
    (1, 64, 2, 16, 1, 32, 64),  # one chunk
])
def test_three_steps_equal_plain(b, l, h, p, g, n, chunk, with_h0):
    x, dt, a, bm, cm, h0 = inputs(b, l, h, p, g, n, seed=l, with_h0=with_h0)
    y, ht = ks.ssd_scan_chunked(x, dt, a, bm, cm, h0=h0, chunk=chunk)
    ry, rht = ks.ssd_scan_plain(x, dt, a, bm, cm, h0=h0, chunk=chunk)
    assert y.shape == x.shape and y.dtype == x.dtype and ht.shape == rht.shape
    close(y, ry, 1e-5)
    close(ht, rht, 1e-5)


def test_state_passing_is_the_carry():
    """S_in[0] is h0 and each S_in[c + 1] the decayed S_in[c] plus dS_c;
    a sequence split at a chunk boundary and chained through the state
    gives the one-shot result."""
    x, dt, a, bm, cm, h0 = inputs(1, 96, 2, 8, 1, 16, seed=5, with_h0=True)
    ds, dec = ks.ssd_chunk_states(x, dt, a, bm, chunk=32)
    s_in, ht = ks.ssd_state_passing(ds, dec, h0)
    assert ds.shape == s_in.shape == (1, 2, 3, 16, 8) and dec.shape == (1, 2, 3)
    assert torch.equal(s_in[:, :, 0], h0)
    for c in range(2):
        torch.testing.assert_close(s_in[:, :, c + 1], dec[:, :, c, None, None] * s_in[:, :, c] + ds[:, :, c])
    y1, h1 = ks.ssd_scan_chunked(x[:, :64], dt[:, :64], a, bm[:, :64], cm[:, :64], h0=h0, chunk=32)
    y2, h2 = ks.ssd_scan_chunked(x[:, 64:], dt[:, 64:], a, bm[:, 64:], cm[:, 64:], h0=h1, chunk=32)
    y, _ = ks.ssd_scan_chunked(x, dt, a, bm, cm, h0=h0, chunk=32)
    close(torch.cat([y1, y2], 1), y.numpy(), 1e-5)
    close(h2, ht.numpy(), 1e-5)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (2, 64, 4, 32, 2, 16, 32),
    (1, 128, 2, 64, 1, 64, 64),
])
def test_three_steps_match_jax_kernel(b, l, h, p, g, n, chunk, with_h0):
    x, dt, a, bm, cm, h0 = inputs(b, l, h, p, g, n, seed=1, with_h0=with_h0)
    y, ht = ks.ssd_scan_chunked(x, dt, a, bm, cm, h0=h0, chunk=chunk)
    jy, jht = jax_ssd(*[jnp.asarray(v.numpy()) for v in (x, dt, a, bm, cm)],
                      h0=None if h0 is None else jnp.asarray(h0.numpy()), chunk=chunk,
                      interpret=True)
    close(y, jy, 1e-4)
    close(ht, jht, 1e-4)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_state", "h0"])
@pytest.mark.parametrize("l,chunk,g", [(37, 16, 1), (130, 32, 2), (300, 128, 2)])
def test_three_steps_match_reference(l, chunk, g, with_h0):
    """Ragged L: the last chunk padded with dt = 0 and x = B = C = 0."""
    x, dt, a, bm, cm, h0 = inputs(2, l, 4, 8, g, 16, seed=l + 1, with_h0=with_h0)
    y, ht = ks.ssd_scan_chunked(x, dt, a, bm, cm, h0=h0, chunk=chunk)
    ry, rht = ref.ssd_ref(*[jnp.asarray(v.numpy()) for v in (x, dt, a, bm, cm)],
                          h0=None if h0 is None else jnp.asarray(h0.numpy()))
    close(y, ry, 1e-4)
    close(ht, rht, 1e-4)


def test_bf16_pair_carries_16_bits():
    """The high part and the remainder together keep 16 significant bits
    (relative error <= 2^-16); the high part alone 8 (<= 2^-8)."""
    t = torch.from_numpy(np.random.default_rng(2).normal(size=4096).astype(np.float32)) * 37.0
    rel = lambda u: float(((u - t).abs() / t.abs()).max())
    assert rel(ks.bf16_pair(t)) <= 2.0 ** -16
    assert 2.0 ** -9 < rel(t.bfloat16().float()) <= 2.0 ** -8


@pytest.fixture(scope="module")
def l300():
    """mamba2's head shape at L = 300 with h0, and the plain result."""
    args = mamba_inputs(300)
    return args, ks.ssd_scan_plain(*args[:5], h0=args[5])


def emulate(args, wlb, w, s_in):
    """The bf16 kernel's arithmetic: each of its three f32 operands passed
    through its own rounding before its product; y before its final
    rounding to bf16."""
    x, dt, a, bm, cm, h0 = args
    ds, dec = ks.ssd_chunk_states(x, dt, a, bm, operand=wlb)
    s, ht = ks.ssd_state_passing(ds, dec, h0)
    return ks.ssd_chunk_outputs(x, dt, a, bm, cm, s_in(s), operand=w), ht


def test_hi_lo_split_stays_within_the_limit(l300):
    args, (ry, rht) = l300
    pair = ks.bf16_pair
    y, ht = emulate(args, pair, pair, pair)
    assert over_limit(y, ry) < 0.5 and over_limit(ht, rht) < 0.5
    y2, ht2 = ks.ssd_scan_chunked(*args[:5], h0=args[5], operand=pair)
    assert torch.equal(y, y2) and torch.equal(ht, ht2)


@pytest.mark.parametrize("operand,feeds", [("wl_B", "state"), ("W", "y"), ("S_in", "y")])
def test_single_bf16_rounding_breaks_the_limit(l300, operand, feeds):
    """Rounding one operand once to bf16 (the others split) puts up to
    2^-8 of relative error on its terms: the output it feeds leaves the
    1e-3 limit.  (S_in and W feed only y; wl o B feeds the state and, through
    S_in, y.)"""
    args, (ry, rht) = l300
    pair, once = ks.bf16_pair, lambda t: t.bfloat16().float()
    ops = {k: (once if k == operand else pair) for k in ("wl_B", "W", "S_in")}
    y, ht = emulate(args, ops["wl_B"], ops["W"], ops["S_in"])
    got, want = (ht, rht) if feeds == "state" else (y, ry)
    assert over_limit(got, want) > 1.0


@pytest.mark.parametrize("L", [16, 77, 128, 256, 300, 320])
def test_bf16_grids_fill_the_card(L):
    """At mamba2-2.7b's scan (B 1, H 80, N 128, P 64) the chunk-state and
    chunk-output launches give at least one block per SM of an H100 (132)
    at every prompt length of the served stream."""
    blocks = ks.bf16_blocks(1, L, 80, 128, 64)
    nc = -(-L // 128)
    assert blocks == {"chunk_states": 160 * nc, "state_passing": 320, "chunk_outputs": 160 * nc}
    assert min(blocks.values()) >= 132
