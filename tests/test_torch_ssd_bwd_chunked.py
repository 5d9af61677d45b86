"""K8's bf16 backward kernel, in plain torch: its arithmetic emulated on the
CPU and its grids counted.

The kernel (``csrc/ssd_scan_bwd.cu``) computes the plain backward's two
steps, ``ssd_bwd_states`` (each chunk's S_in and the cotangent G_out of
its final state) and ``ssd_bwd_chunks`` (the gradients a chunk), with
every product on the bf16 tensor cores.  x, B, C and dy enter them
exactly; every operand that is f32 by nature (``wl o B``, ``exp(cum) o
C``, S_in, G_out, dCB and W) enters as a bf16 high part plus the bf16
remainder, which the steps' ``operand`` hook emulates with
``ks.bf16_pair``.  Here:

  * with the identity operand the two steps are the plain backward, bit
    for bit;
  * with ``bf16_pair``, and dx, dB and dC rounded to bf16 as the kernel
    writes them, every gradient leaf and every row of a leaf is within
    relative L2 2e-2 (the limit ``chip_smoke.py`` phase 2h holds the
    kernel to) of ``jax.vjp`` of the JAX package's reference
    ``ref.ssd_ref``, at mamba2-2.7b's head shape (P 64, N 128, chunks of
    128) cut to 4 heads, at a ragged L, with h0 and the final state's
    cotangent absent and given;
  * the f32 leaves (ddt, da, dh0) stay within 1e-4 of the plain backward
    with the pairs; one bf16 rounding of the operands instead breaks 1e-4;
  * ``ks.bwd_blocks``: each of the kernel's launches gives every SM of an
    H100 (132) a block at the trainer's call (batch 4 x 512, 80 heads).

dt is softplus(normal - 2) and |a| <= 1, so |cum| stays far below 88
over the whole sequence, where ``ssd_ref``'s gradient turns NaN
(test_torch_ssd_bwd.py says why)."""

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
#: relative L2 a leaf and a row: K8's bf16 limit (chip_smoke.py SSD_BWD_TOL)
BF16_TOL = 2e-2


def mamba_inputs(L, *, H=4, G=1, given, seed=0):
    """mamba2-2.7b's head shape (P 64, N 128) at H heads: x, B, C and dy
    bf16, dt softplus(normal - 2), a in [-1, -0.3], h0 and dht f32 (given
    or None).  Returns (x, dt, a, B, C, h0, dy, dht) torch tensors."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    bf = lambda *s: torch.from_numpy(f(*s)).bfloat16()  # noqa: E731
    x, dy = bf(1, L, H, 64), bf(1, L, H, 64)
    dt = torch.nn.functional.softplus(torch.from_numpy(f(1, L, H)) - 2.0)
    a = -torch.linspace(0.3, 1.0, H)
    bm, cm = bf(1, L, G, 128), bf(1, L, G, 128)
    h0 = torch.from_numpy(f(1, H, 128, 64)) if given else None
    dht = torch.from_numpy(f(1, H, 128, 64)) if given else None
    return x, dt, a, bm, cm, h0, dy, dht


def emulated(args, operand):
    """The two steps of the backward with ``operand`` on the kernel's f32
    operands: (dx, ddt, da, db, dc, dh0)."""
    x, dt, a, bm, cm, h0, dy, dht = args
    s_in, g_out, dh0 = ks.ssd_bwd_states(*args, operand=operand)
    return (*ks.ssd_bwd_chunks(x, dt, a, bm, cm, dy, s_in, g_out, operand=operand), dh0)


def jax_vjp(args):
    """``jax.vjp`` of ``ref.ssd_ref`` on the same values in f32, pulled back
    from (dy, dht or zeros): (dx, ddt, da, db, dc, dh0 or None)."""
    x, dt, a, bm, cm, h0, dy, dht = (None if t is None else jnp.asarray(t.float().numpy())
                                     for t in args)
    ct = (dy, jnp.zeros((x.shape[0], x.shape[2], bm.shape[3], x.shape[3])) if dht is None else dht)
    if h0 is None:
        _, vjp = jax.vjp(lambda *t: ref.ssd_ref(*t), x, dt, a, bm, cm)
        return (*vjp(ct), None)
    _, vjp = jax.vjp(lambda *t: ref.ssd_ref(*t[:5], h0=t[5]), x, dt, a, bm, cm, h0)
    return vjp(ct)


def rel_l2(got, want) -> tuple[float, float]:
    """(relative L2 of the leaf, of its worst row: the last axis)."""
    g = got.detach().double().numpy()
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    gr, wr = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    leaf = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
    row = (np.linalg.norm(gr - wr, axis=-1) / np.maximum(np.linalg.norm(wr, axis=-1), 1e-30)).max()
    return float(leaf), float(row)


@pytest.mark.parametrize("given", [False, True], ids=["none", "h0_dht"])
def test_identity_operand_is_the_plain_backward(given):
    args = mamba_inputs(300, given=given, seed=1)
    got = emulated(args, lambda t: t)
    want = ks.ssd_scan_bwd_plain(*args)
    for name, g, w in zip(LEAVES, got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("L,G,given", [(300, 1, False), (300, 1, True), (200, 2, True)],
                         ids=["L300", "L300_h0_dht", "L200_G2_h0_dht"])
def test_bf16_pairs_within_the_limit_of_jax_vjp(L, G, given):
    """The kernel's arithmetic (pairs on every f32 operand, dx / dB / dC
    rounded to bf16) against ``jax.vjp(ssd_ref)``, leaf and row."""
    args = mamba_inputs(L, G=G, given=given, seed=L + G)
    got = emulated(args, ks.bf16_pair)
    assert got[0].dtype == got[3].dtype == got[4].dtype == torch.bfloat16
    want = jax_vjp(args)
    for name, g, w in zip(LEAVES, got, want):
        if w is None:
            assert g is None
            continue
        assert torch.isfinite(g.float()).all(), name
        leaf, row = rel_l2(g.float(), w)
        assert leaf <= BF16_TOL and row <= BF16_TOL, f"{name}: leaf {leaf:.3e}, row {row:.3e}"


@pytest.mark.parametrize("rounding", ["pair", "once"])
def test_pairs_keep_the_f32_leaves_and_one_rounding_does_not(rounding):
    """ddt, da and dh0 come out of the kernel in f32: with the pairs they
    stay within 1e-4 (relative L2, leaf and row) of the plain backward;
    rounding each f32 operand once to bf16 puts up to 2^-8 on its terms
    and leaves that limit."""
    args = mamba_inputs(300, given=True, seed=7)
    op = ks.bf16_pair if rounding == "pair" else (lambda t: t.bfloat16().float())
    got = dict(zip(LEAVES, emulated(args, op)))
    want = dict(zip(LEAVES, ks.ssd_scan_bwd_plain(*args)))
    worst = max(max(rel_l2(got[k], want[k].numpy())) for k in ("ddt", "da", "dh0"))
    assert (worst <= 1e-4) == (rounding == "pair"), f"{rounding}: {worst:.3e}"


@pytest.mark.parametrize("N", [128, 64], ids=["mamba2", "zamba2"])
def test_bwd_grids_fill_the_card(N):
    """At the trainer's call (batch 4 x 512, 80 heads of 64, one group)
    every launch of the bf16 backward has at least one block per SM of an
    H100; the chunk gradients run 320 blocks of 8 heads a sweep, and the
    group sums have 10 head groups' partials a row to add."""
    blocks = ks.bwd_blocks(4, 512, 80, N, 64)
    assert blocks["states"] == N // 64 * 320
    assert blocks["chunk_grads"] == 2 * 320
    assert ks.bwd_heads(80, 1) == 8
    assert blocks["group_da"] == 4 * 512 + 1
    assert min(blocks.values()) >= 132, blocks


def test_bwd_heads_divide_the_group():
    """A block of the chunk gradients never walks heads of two groups: its
    head count divides H / G."""
    for H, G, hb in [(80, 1, 8), (80, 2, 8), (8, 2, 4), (6, 3, 2), (5, 5, 1), (24, 2, 4)]:
        assert ks.bwd_heads(H, G) == hb
        assert (H // G) % hb == 0
