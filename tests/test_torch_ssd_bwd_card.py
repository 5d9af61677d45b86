"""K8's backward kernel (``csrc/ssd_scan_bwd.cu``) against its plain
backward on the card, and a trainer's gradient through ``SSDScan``.
Every test is marked ``cuda`` and skips without a card; the file imports
no JAX, so it runs on a machine with a card and no JAX
(``pytest -m cuda tests/test_torch_ssd_bwd_card.py``).  Limits: relative
L2 per gradient leaf, f32 1e-3 and bf16 inputs 2e-2 (K8 y's, as
``chip_smoke.py`` phase 2h holds them).  bf16 runs on the tensor cores at
mamba2's and zamba2's training call (batch 4 x 512), with two groups, with
L below one 64-row tile, and with N and P zero-padded to the instance;
f32 on the CUDA cores."""

import pytest
import torch

from repro_torch.kernels import ssd_scan as ks

TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def scan_inputs(card, B, L, H, P, G, N, dtype, given, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=gen, device=card)  # noqa: E731
    x, dy = rn(B, L, H, P).to(dtype), rn(B, L, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, L, H) - 2.0)
    a = -torch.linspace(1.0, 16.0, H, device=card)
    bm, cm = rn(B, L, G, N).to(dtype), rn(B, L, G, N).to(dtype)
    h0 = rn(B, H, N, P) if given else None
    dht = rn(B, H, N, P) if given else None
    return x, dt, a, bm, cm, h0, dy, dht


def rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("given", [False, True], ids=["none", "h0_dht"])
@pytest.mark.parametrize("B,L,H,P,G,N,dtype,chunk", [
    (1, 300, 80, 64, 1, 128, torch.bfloat16, 128),  # mamba2's head shape, ragged
    (1, 512, 80, 64, 1, 64, torch.bfloat16, 128),  # zamba2's
    (4, 512, 80, 64, 1, 128, torch.bfloat16, 128),  # mamba2's training call
    (4, 512, 80, 64, 1, 64, torch.bfloat16, 128),  # zamba2's
    (1, 300, 8, 64, 2, 128, torch.bfloat16, 128),  # two groups, a block of 4 heads each
    (2, 50, 80, 64, 1, 128, torch.bfloat16, 128),  # L < 64: one partial tile
    (1, 200, 6, 32, 3, 48, torch.bfloat16, 128),  # N and P zero-padded, blocks of 2 heads
    (1, 300, 80, 64, 1, 128, torch.float32, 128),
    (2, 37, 4, 8, 2, 16, torch.float32, 16),  # a reduced config's, two groups
])
def test_kernel_matches_plain_backward_and_repeats_bitwise(card, B, L, H, P, G, N, dtype, chunk,
                                                           given):
    args = scan_inputs(card, B, L, H, P, G, N, dtype, given)
    n = ks.ssd_scan_bwd.launches
    got = ks.ssd_scan_bwd(*args, chunk=chunk)
    again = ks.ssd_scan_bwd(*args, chunk=chunk)
    assert ks.ssd_scan_bwd.launches == n + 2
    want = ks.ssd_scan_bwd_plain(*args, chunk=chunk)
    for name, g, a, w in zip(("dx", "ddt", "da", "db", "dc", "dh0"), got, again, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, a), f"{name}: two calls differ"
        assert rel(g, w) <= TOL[dtype], f"{name}: {rel(g, w):.3e}"


@pytest.mark.cuda
def test_scan_with_grad_trains_through_the_kernel(card):
    """``ssd_scan`` with grad: outputs with a grad_fn, one forward and one
    backward launch, grads within the limits of autograd through
    ``ssd_scan_plain``."""
    x, dt, a, bm, cm, _, dy, _ = scan_inputs(card, 2, 300, 8, 64, 1, 128, torch.bfloat16, False)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm)]
    f, b = ks.ssd_scan.launches, ks.ssd_scan_bwd.launches
    y, _ = ks.ssd_scan(*leaves, chunk=128)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, dy)
    assert (ks.ssd_scan.launches, ks.ssd_scan_bwd.launches) == (f + 1, b + 1)
    plain = [t.detach().clone().requires_grad_() for t in (x, dt, a, bm, cm)]
    yp, _ = ks.ssd_scan_plain(*plain, chunk=128)
    want = torch.autograd.grad(yp, plain, dy)
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL[torch.bfloat16]
