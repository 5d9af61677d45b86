"""``repro_torch.prng`` against ``jax.random`` (threefry2x32, partitionable
bit generation, the JAX package's setting): keys, split, fold_in, bits,
randint, uniform, normal and categorical BITWISE, under hypothesis-drawn
seeds and shapes; rows of a normal draw made alone equal the whole
draw's; XLA's f32 log, log1p and erf_inv as written out in the port
equal XLA's own bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import prng
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

SEEDS = st.integers(-(2**31), 2**31 - 1)
SHAPES = st.lists(st.integers(1, 9), min_size=1, max_size=3).map(tuple)
FAST = settings(max_examples=15, deadline=None)


def words(t: torch.Tensor) -> np.ndarray:
    """A torch uint32 tensor's words as numpy uint32."""
    return t.view(torch.int32).numpy().view(np.uint32)


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize and (
        a.view(f"u{a.dtype.itemsize}") == b.view(f"u{b.dtype.itemsize}")).all()


def as_key(jk) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jk).astype(np.uint32).view(np.int32).copy()).view(torch.uint32)


@FAST
@given(SEEDS)
def test_prngkey(seed):
    assert (words(prng.PRNGKey(seed)) == np.asarray(jax.random.PRNGKey(seed))).all()


def test_prngkey_refuses_seeds_outside_int32():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2**31)


@FAST
@given(SEEDS, st.integers(1, 40))
def test_split(seed, num):
    jk = jax.random.PRNGKey(seed)
    assert (words(prng.split(as_key(jk), num)) == np.asarray(jax.random.split(jk, num))).all()


@FAST
@given(SEEDS, st.integers(0, 2**32 - 1))
def test_fold_in(seed, data):
    jk = jax.random.PRNGKey(seed)
    assert (words(prng.fold_in(as_key(jk), data)) == np.asarray(jax.random.fold_in(jk, data))).all()


@FAST
@given(SEEDS, SHAPES)
def test_bits(seed, shape):
    jk = jax.random.PRNGKey(seed)
    assert (words(prng.bits(as_key(jk), shape)) == np.asarray(jax.random.bits(jk, shape))).all()


@FAST
@given(SEEDS, SHAPES, st.sampled_from([(0, 256), (0, 92544), (-7, 11), (0, 2**31 - 1),
                                       (-(2**31), 2**31 - 1), (5, 5), (9, 3)]))
def test_randint(seed, shape, bounds):
    """Spans above 2**16 included (JAX squares its multiplier in uint32,
    wrapping), and empty ranges (min is returned)."""
    jk = jax.random.PRNGKey(seed)
    lo, hi = bounds
    got = prng.randint(as_key(jk), shape, lo, hi)
    assert got.dtype == torch.int32
    assert (got.numpy() == np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32))).all()


@FAST
@given(SEEDS, SHAPES, st.sampled_from([(0.0, 1.0), (-3.0, 2.5), (1e-3, 1e-3 + 1e-6)]))
def test_uniform(seed, shape, bounds):
    jk = jax.random.PRNGKey(seed)
    got = prng.uniform(as_key(jk), shape, *bounds)
    assert same_bits(got.numpy(), jax.random.uniform(jk, shape, jnp.float32, *bounds))


@FAST
@given(SEEDS, SHAPES)
def test_normal(seed, shape):
    jk = jax.random.PRNGKey(seed)
    assert same_bits(prng.normal(as_key(jk), shape).numpy(), jax.random.normal(jk, shape))


@pytest.mark.parametrize("seed", [0, 7919 * 3 + 13])
def test_normal_bitwise_on_a_large_draw(seed):
    """200000 values reach both branches of erf_inv (w < 5 and the sqrt
    branch near |u| = 1) and both of log1p."""
    jk = jax.random.PRNGKey(seed)
    assert same_bits(prng.normal(as_key(jk), (200_000,)).numpy(), jax.random.normal(jk, (200_000,)))


@pytest.mark.parametrize("seed", [0, 5])
def test_gumbel_bitwise(seed):
    jk = jax.random.PRNGKey(seed)
    assert same_bits(prng.gumbel(as_key(jk), (100_000,)).numpy(), jax.random.gumbel(jk, (100_000,)))


@FAST
@given(SEEDS, st.integers(1, 6), st.integers(2, 300), st.floats(0.1, 4.0))
def test_categorical(seed, rows, vocab, scale):
    jk = jax.random.PRNGKey(seed)
    logits = (np.random.default_rng(abs(seed)).standard_normal((rows, vocab)) * scale).astype(np.float32)
    got = prng.categorical(as_key(jk), torch.from_numpy(logits))
    assert (got.numpy() == np.asarray(jax.random.categorical(jk, logits))).all()


@FAST
@given(SEEDS, st.integers(1, 50), st.lists(st.integers(0, 63), min_size=1, max_size=6))
def test_normal_rows_equal_the_whole_draw(seed, n_cols, rows):
    """Rows made alone (per-element counters) are the rows of the whole
    (64, n_cols) draw: what lets the bigram walk skip the whole table."""
    jk = jax.random.PRNGKey(seed)
    whole = np.asarray(jax.random.normal(jk, (64, n_cols)))
    got = prng.normal_rows(as_key(jk), n_cols, torch.tensor(rows).reshape(-1, 1))
    assert same_bits(got.numpy(), whole[np.asarray(rows)][:, None])


@pytest.mark.parametrize("fn,ref,lo,hi", [
    (prng.log_f32, jnp.log, 1e-30, 50.0),
    (prng.log1p_f32, jnp.log1p, -0.9999, 3.0),
    (prng.erfinv_f32, jax.lax.erf_inv, -0.99999, 0.99999),
])
def test_xla_math_bitwise(fn, ref, lo, hi):
    x = np.random.default_rng(0).uniform(lo, hi, 100_000).astype(np.float32)
    assert same_bits(fn(torch.from_numpy(x)).numpy(), jax.jit(ref)(x))
