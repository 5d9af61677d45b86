"""Counter-based random numbers, bitwise ``jax.random``'s (threefry2x32).

The JAX package draws its data stream, its vision stub and its bigram
table from ``jax.random`` under ``jax_threefry_partitionable=True`` (the
default since jax 0.5): every element of a draw of shape ``s`` is the
threefry2x32 block cipher of the key applied to that element's own
64-bit counter, its row-major index in ``s`` split into (high, low)
32-bit words.  Nothing is sequential, so any slice of a draw can be made
alone: ``normal_rows`` makes rows of a (rows, n) normal draw without the
rest of it (the bigram table of a 92544-token vocabulary is 34 GB whole).

A key is a ``torch.uint32`` tensor of shape (2,), as ``jax.random.PRNGKey``
(the legacy raw key) holds it.  torch's uint32 has no ``+`` or ``>>``, so
the cipher computes on int32 tensors holding the same bits: ``+`` wraps
as u32 arithmetic does, and each ``>>`` masks the sign bits away.

Integer draws (``bits``, ``randint``, ``split``, ``fold_in``) are JAX's
bit for bit.  ``uniform`` follows JAX's mantissa construction and
XLA's fused scaling (``f * (hi - lo) + lo`` as one multiply-add), so it
is bitwise too.
``normal`` (``sqrt(2) * erf_inv(u)``) and ``gumbel`` (JAX's default
low-range formula, ``-log(-log(u))``) go through XLA's own f32 ``log``,
``log1p`` and ``erf_inv`` as its CPU back-end computes them (Cephes
polynomials, fused multiply-adds), written out here; torch's ``log`` and
``torch.erfinv`` use other algorithms and differ in the last bits.  So
the bigram table and ``categorical`` draws are JAX's (CPU) bit for bit.
"""

from __future__ import annotations

import math
import struct
from typing import Sequence

import torch

from .kernels.state_hash import M32, mul32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny


def _key_words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A key's two words as int32 (the bits of its uint32 words; a key
    may also come as their int32 view)."""
    k = key.view(torch.int32)
    return k[..., 0], k[..., 1]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    # int32 ">>" is arithmetic: mask the sign bits away
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry2x32(k0, k1, x0, x1):
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = x0 ^ _rotl(x1, r)
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + (i + 1)
    return x0, x1


@torch.library.custom_op("repro_torch::threefry2x32", mutates_args=())
def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block cipher (Salmon et al. 2011) as
    ``jax._src.prng`` applies it, on int32 tensors holding u32 words
    (two's-complement ``+`` wraps as u32 arithmetic does), broadcast.

    One operator (``torch.ops.repro_torch.threefry2x32``), so a traced
    transition shows each draw as one graph node, as a jaxpr shows JAX's
    ``threefry2x32`` primitive: the static analyzer finds a draw from a
    constant key there (MISO101)."""
    return _threefry2x32(k0, k1, x0, x1)


@threefry2x32.register_fake
def _(k0, k1, x0, x1):
    shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    return x0.new_empty(shape), x0.new_empty(shape)


def _counters(n: int, device, start=0) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) int32 words of the 64-bit counters ``start +
    arange(n)`` (``start`` an int or an int64 tensor broadcasting against
    them)."""
    c = torch.arange(n, dtype=torch.int64, device=device) + start
    return (c >> 32).to(torch.int32), c.to(torch.int32)  # the low word wraps


def _signed(v: int) -> int:
    v &= M32
    return v - (1 << 32) if v >> 31 else v


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in int32's range (JAX's
    default, x64 off): ``[0, seed mod 2**32]``."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} is outside int32's range")
    return torch.tensor([0, seed], dtype=torch.int32, device=device).view(torch.uint32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (num, 2) keys, key i the cipher of counter i."""
    hi, lo = _counters(num, key.device)
    k0, k1 = _key_words(key)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return torch.stack([b0, b1], dim=-1).view(torch.uint32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the cipher of the pair (0, data mod 2**32)."""
    k0, k1 = _key_words(key)
    x1 = torch.full((1,), _signed(int(data)), dtype=torch.int32, device=key.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(x1), x1)
    return torch.cat([b0, b1]).view(torch.uint32)


def _bits32(key: torch.Tensor, shape: Sequence[int], start=0) -> torch.Tensor:
    """32 random bits per element (int32 holding the u32 word) of a draw
    of ``shape``; ``start`` offsets the counters (rows of a larger draw:
    an int64 tensor of shape (R, 1) gives (R, *shape))."""
    hi, lo = _counters(math.prod(shape), key.device, start)
    k0, k1 = _key_words(key)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return (b0 ^ b1).reshape(*hi.shape[:-1], *shape)


def _bits64(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``_bits32`` as int64 in [0, 2**32) (for integer arithmetic)."""
    return _bits32(key, shape).to(torch.int64) & M32


def bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` (32-bit) as ``torch.uint32``."""
    return _bits32(key, tuple(shape)).view(torch.uint32)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)`` for
    python-int bounds in int32's range: 64 random bits per value folded
    into the span (JAX's biased-modulus construction)."""
    shape = tuple(shape)
    k1, k2 = split(key)
    higher, lower = _bits64(k1, shape), _bits64(k2, shape)
    span = (maxval - minval) & M32 if maxval > minval else 1
    m = (2**16) % span
    mult = ((m * m) & M32) % span  # JAX squares in uint32, wrapping
    off = (mul32(higher % span, mult) + lower % span) & M32
    off = off % span
    return (minval + off).to(torch.int32)


def _r32(v: float) -> float:
    """``v`` rounded to the nearest f32, as a Python float: a constant
    that takes part in f64 arithmetic with the value XLA gives it."""
    return struct.unpack("f", struct.pack("f", v))[0]


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """int32 random words -> f32 in [0, 1): 23 mantissa bits under the
    exponent of 1.0, minus 1."""
    return (((b >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0


def _scale(f: torch.Tensor, lo: float, span: float) -> torch.Tensor:
    """``max(lo, f * span + lo)`` in f32, ``lo`` and ``span`` (= hi - lo
    rounded to f32) f32 values as Python floats: no copy to the device.
    XLA fuses the product and the sum; with a power-of-two span (the
    normal's 2, the Gumbel's 1) the product is exact and the plain sum
    is the same."""
    if math.frexp(span)[0] == 0.5:
        return torch.clamp(f * span + lo, min=lo)
    return torch.clamp(_fma(f, span, lo), min=lo)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    lo = _r32(minval)
    return _scale(_unit_floats(_bits32(key, tuple(shape))), lo, _r32(_r32(maxval) - lo))


# XLA's CPU code for f32 log, log1p and erf_inv, which jax.random's normal
# and gumbel reach.  XLA contracts a product and a sum into one fused
# multiply-add (``_fma``: exact in f64, then rounded once to f32).
def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once; ``b`` and ``c`` f32 tensors (or
    their f64 copies, made once by the caller) or f32 values as Python
    floats."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


_LOG_P = tuple(_r32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _r32(-2.12194440e-4), _r32(0.693359375)
_SQRT_HALF = _r32(0.707106781186547524)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` on the CPU: Cephes' ``logf`` polynomial (as in
    Eigen's ``plog``) on the mantissa in [sqrt(1/2), sqrt(2)), plus the
    exponent times ln 2 in two parts.  For positive finite x."""
    t = torch.clamp(x, min=_F32_TINY)
    w = t.view(torch.int32)
    e = ((w >> 23) & 0x1FF).to(torch.float32) - 126.0
    m = ((w & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    small = m < _SQRT_HALF
    e = e - small.to(torch.float32)
    t = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = t * t
    x3 = (x2 * t).double()
    t64 = t.double()
    P = _LOG_P
    y = _fma(t64, P[0], P[1])
    y1 = _fma(t64, P[3], P[4])
    y2 = _fma(t64, P[6], P[7])
    y = _fma(y, t64, P[2])
    y1 = _fma(y1, t64, P[5])
    y2 = _fma(y2, t64, P[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    t = t - 0.5 * x2
    return (t + y) + _LOG_Q2 * e


_LOG1P_NUM = tuple(_r32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_r32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _horner(x64: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x64, coeffs[0], dtype=torch.float32)  # fma(0, x, c0) = c0
    for c in coeffs[1:]:
        p = _fma(p, x64, c)
    return p


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p`` on the CPU: Cephes' rational approximation for
    |x| < sqrt(2) - 1, else ``log_f32(1 + x)``.  For x > -1.  (The f32
    division goes through f64, which rounds it the same way.)"""
    x2 = x * x
    x64 = x.double()
    ratio = (_horner(x64, _LOG1P_NUM).double() / _horner(x64, _LOG1P_DEN).double()).float()
    small = x + (-0.5 * x2 + (x * x2) * ratio)
    return torch.where(x.abs() < _r32(0.41421356237309504880), small, log_f32(x + 1.0))


# XLA's f32 ErfInv (after Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w = -log1p(-x^2), split at w = 5
_ERFINV_LT5 = tuple(_r32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = tuple(_r32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``: Giles' polynomial, +-inf at +-1."""
    w = -log1p_f32(-x * x)
    lt = w < 5.0
    # sqrt through f64 is correctly rounded; torch's f32 sqrt on the CPU
    # is not always
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, lo, hi))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = -1.0 + 2.0**-24  # nextafter(-1, 0) in f32
_NORMAL_SPAN = _r32(1.0 - _NORMAL_LO)  # 2.0
_GUMBEL_SPAN = _r32(1.0 - _F32_TINY)  # 1.0
_SQRT2_F32 = _r32(math.sqrt(2))


def _normal_from_bits(b: torch.Tensor) -> torch.Tensor:
    u = _scale(_unit_floats(b), _NORMAL_LO, _NORMAL_SPAN)
    return _SQRT2_F32 * erfinv_f32(u)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32."""
    return _normal_from_bits(_bits32(key, tuple(shape)))


def normal_rows(key: torch.Tensor, n_cols: int, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` (an int tensor of any shape) of ``normal(key, (R,
    n_cols))`` for any R above them, made alone: (*rows.shape, n_cols)."""
    start = rows.to(torch.int64).reshape(-1, 1) * n_cols
    b = _bits32(key, (n_cols,), start=start)
    return _normal_from_bits(b).reshape(*rows.shape, n_cols)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low", JAX's default) in float32."""
    u = _scale(_unit_floats(_bits32(key, tuple(shape))), _F32_TINY, _GUMBEL_SPAN)
    return -log_f32(-log_f32(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: argmax of Gumbel
    noise plus the logits (int64 indices; the first maximum wins, as in
    ``jnp.argmax``)."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)
