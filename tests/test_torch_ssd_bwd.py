"""K8's backward on the CPU: the plain backward ``ssd_scan_bwd_plain`` and
the autograd Function ``SSDScan`` that ``ssd_scan`` goes through where an
input requires grad.

  * ``ssd_scan_bwd_plain`` against ``jax.vjp`` of the JAX package's
    reference ``ref.ssd_ref`` on the same numpy inputs and cotangents,
    within 1e-4 relative L2 per gradient leaf (test_torch_ssd_chunked.py's
    f32 tolerance: the chunked and the quadratic forms sum in different
    orders): L a multiple of the chunk and ragged, one and two B/C groups
    of four heads, h0 absent and given, the final state's cotangent zero
    and given;
  * ``torch.autograd.gradcheck`` of ``SSDScan`` in f64 (the plain versions
    work in f64 for f64 inputs);
  * ``SSDScan``'s grads against autograd through ``ssd_scan_plain``,
    within 1e-5;
  * the wrappers on CPU tensors launch nothing, and without grad the scan
    does not go through the Function.

dt is softplus(normal - 2) and |a| about 1, so that |cum| stays far below
88 over each case: ``ssd_ref`` takes exp(cum_i - cum_j) above the
diagonal too before masking it, which overflows there past 88, and its
gradient through ``jnp.where`` turns the inf into NaN.  The kernel
against the plain backward on the card is ``test_torch_ssd_bwd_card.py``
(no JAX there) and ``chip_smoke.py`` phase 2h."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ssd_scan as ks
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

LEAVES = ("dx", "ddt", "da", "db", "dc", "dh0")


def inputs(b, l, h, p, g, n, *, seed, with_h0, with_dht):
    """(x, dt, a, B, C, h0, dy, dht) as f32 numpy arrays; h0 / dht None
    where absent."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x, dy = f(b, l, h, p), f(b, l, h, p)
    dt = np.log1p(np.exp(f(b, l, h) - 2.0)).astype(np.float32)
    a = -np.exp(f(h) * 0.5).astype(np.float32)
    bm, cm = f(b, l, g, n), f(b, l, g, n)
    h0 = f(b, h, n, p) if with_h0 else None
    dht = f(b, h, n, p) if with_dht else None
    return x, dt, a, bm, cm, h0, dy, dht


def torch_args(arrays):
    return [None if v is None else torch.from_numpy(v) for v in arrays]


def jax_vjp(x, dt, a, bm, cm, h0, dy, dht):
    """``jax.vjp`` of ``ref.ssd_ref`` at the inputs, pulled back from (dy,
    dht or zeros): (dx, ddt, da, db, dc, dh0 or None)."""
    args = [jnp.asarray(v) for v in (x, dt, a, bm, cm)]
    zero = np.zeros((x.shape[0], x.shape[2], bm.shape[3], x.shape[3]), np.float32)
    ct = (jnp.asarray(dy), jnp.asarray(zero if dht is None else dht))
    if h0 is None:
        _, vjp = jax.vjp(lambda *t: ref.ssd_ref(*t), *args)
        return (*vjp(ct), None)
    _, vjp = jax.vjp(lambda *t: ref.ssd_ref(*t[:5], h0=t[5]), *args, jnp.asarray(h0))
    return vjp(ct)


def rel_l2(want, got) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert want.shape == got.shape
    return float(np.linalg.norm(want - got) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("with_dht", [False, True], ids=["dht_zero", "dht"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("l,chunk,g", [
    (64, 16, 1),  # four whole chunks
    (96, 32, 2),  # three whole chunks, two groups
    (37, 16, 2),  # ragged: the last chunk padded
    (130, 32, 1),  # ragged, five chunks
])
def test_plain_backward_within_1e4_of_jax_vjp(l, chunk, g, with_h0, with_dht):
    arrays = inputs(2, l, 4, 8, g, 16, seed=l + 10 * g, with_h0=with_h0, with_dht=with_dht)
    want = jax_vjp(*arrays)
    got = ks.ssd_scan_bwd_plain(*torch_args(arrays), chunk=chunk)
    for name, w, t in zip(LEAVES, want, got):
        if name == "dh0" and not with_h0:
            assert t is None
            continue
        assert t.dtype == torch.float32
        err = rel_l2(w, t)
        assert err <= 1e-4, f"{name}: {err:.3e}"


def test_plain_backward_steps_chain_to_the_whole():
    """``ssd_bwd_states`` then ``ssd_bwd_chunks`` are the plain backward."""
    args = torch_args(inputs(2, 37, 4, 8, 2, 16, seed=3, with_h0=True, with_dht=True))
    s_in, g_out, dh0 = ks.ssd_bwd_states(*args, chunk=16)
    assert s_in.shape == g_out.shape == (2, 4, 3, 16, 8)
    whole = ks.ssd_scan_bwd_plain(*args, chunk=16)
    parts = (*ks.ssd_bwd_chunks(*args[:5], args[6], s_in, g_out, chunk=16), dh0)
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))


def f64_inputs(b, l, h, p, g, n, seed):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)  # noqa: E731
    x, bm, cm, h0 = r(b, l, h, p), r(b, l, g, n), r(b, l, g, n), r(b, h, n, p)
    dt = torch.rand(b, l, h, generator=gen, dtype=torch.float64) * 0.5 + 0.1
    a = -torch.rand(h, generator=gen, dtype=torch.float64) - 0.5
    return [t.requires_grad_() for t in (x, dt, a, bm, cm, h0)]


@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("g", [1, 2])
def test_function_gradcheck_f64(g, with_h0):
    """Both outputs' Jacobians, chunks of 4 over L = 7 (the last ragged)."""
    x, dt, a, bm, cm, h0 = f64_inputs(1, 7, 2 * g, 2, g, 3, seed=g)
    if with_h0:
        assert torch.autograd.gradcheck(lambda *t: ks.SSDScan.apply(*t, 4),
                                        (x, dt, a, bm, cm, h0))
    else:
        assert torch.autograd.gradcheck(lambda *t: ks.SSDScan.apply(*t, None, 4),
                                        (x, dt, a, bm, cm))


@pytest.mark.parametrize("final_state", [False, True], ids=["y_only", "y_and_state"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
def test_function_grads_equal_autograd_through_plain(with_h0, final_state):
    """A loss of y (and of the final state) through ``ssd_scan`` (the
    Function) and through ``ssd_scan_plain`` differentiated by autograd:
    every input's grad within 1e-5 relative L2."""
    arrays = inputs(2, 45, 4, 8, 2, 16, seed=7, with_h0=with_h0, with_dht=False)
    wy = torch.from_numpy(np.random.default_rng(1).normal(size=arrays[0].shape).astype(np.float32))
    wh = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 4, 16, 8)).astype(np.float32))

    def grads(fn):
        leaves = [None if v is None else torch.from_numpy(v).requires_grad_()
                  for v in arrays[:6]]
        y, ht = fn(*leaves[:5], h0=leaves[5], chunk=16)
        loss = (y * wy).sum() + ((ht * wh).sum() if final_state else 0.0)
        want = [t for t in leaves if t is not None]
        return y, torch.autograd.grad(loss, want)

    y, got = grads(ks.ssd_scan)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    _, want = grads(ks.ssd_scan_plain)
    for name, w, g in zip(LEAVES, want, got):
        assert rel_l2(w.numpy(), g) <= 1e-5, name


def test_wrappers_launch_nothing_on_cpu_and_no_grad_skips_the_function():
    arrays = torch_args(inputs(1, 20, 4, 8, 1, 16, seed=5, with_h0=False, with_dht=False))
    x, dt, a, bm, cm, _, dy, _ = arrays
    before = (ks.ssd_scan.launches, ks.ssd_scan_bwd.launches)
    xg = x.clone().requires_grad_()
    y, _ = ks.ssd_scan(xg, dt, a, bm, cm, chunk=16)
    y.backward(dy)
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    with torch.no_grad():
        y2, _ = ks.ssd_scan(xg, dt, a, bm, cm, chunk=16)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())
    y3, _ = ks.ssd_scan(x, dt, a, bm, cm, chunk=16)  # nothing requires grad
    assert y3.grad_fn is None
    assert (ks.ssd_scan.launches, ks.ssd_scan_bwd.launches) == before


def test_backward_wrapper_refuses_other_devices():
    args = torch_args(inputs(1, 8, 2, 4, 1, 8, seed=0, with_h0=False, with_dht=False))
    meta = [None if t is None else t.to("meta") for t in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ks.ssd_scan_bwd(*meta, chunk=8)


@pytest.mark.parametrize("Q,P,N,fits", [(128, 64, 128, True), (16, 8, 16, True),
                                        (256, 64, 128, False)])
def test_backward_shared_memory_reckoning(Q, P, N, fits):
    """The chunk-gradient step's block at mamba2's training shape (chunk
    128, P 64, N 128) fits a Hopper block; a chunk of 256 does not."""
    sums, grad = ks.bwd_smem_bytes(Q, P, N)
    assert (max(sums, grad) <= ks.SMEM_LIMIT) == fits
