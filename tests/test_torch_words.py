"""The port's u32 word layer (``repro_torch.kernels.ops``), held BITWISE
against the JAX package's ``repro.kernels.ops``: the same numpy-made
trees give the same layouts and the same word streams, and the round
trip is exact.  JAX runs without x64 here, so 64-bit leaves are held
against numpy's little-endian ``.view(np.uint32)``."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch import bridge, tree
from repro_torch.core.fault import bitcast_int
from repro_torch.kernels import ops as tops
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def mixed_tree(seed=0, n=7):
    """f32/bf16/f16/int8/uint8/bool/int32 leaves with odd element counts,
    a scalar and an empty leaf, nested and with unsorted keys."""
    rng = np.random.default_rng(seed)
    return {
        "z_f32": rng.normal(size=(3, n)).astype(np.float32),
        "bf16": rng.normal(size=(n,)).astype(ml_dtypes.bfloat16),
        "f16": rng.normal(size=(2, n)).astype(np.float16),
        "m": {
            "i8": rng.integers(-128, 128, size=(n,)).astype(np.int8),
            "u8": rng.integers(0, 256, size=(n + 2,)).astype(np.uint8),
            "flag": rng.integers(0, 2, size=(n,)).astype(bool),
        },
        "i32": rng.integers(-(2**31), 2**31 - 1, size=(n,)).astype(np.int32),
        "scalar": np.float32(rng.normal()),
        "empty": np.zeros((0, 3), np.float32),
    }


def jax_words(np_tree, multiple=1):
    flat = jops.flatten_to_u32(jax.tree.map(jnp.asarray, np_tree), multiple=multiple)
    return np.asarray(flat).view(np.int32)


def same_leaves(a, b):
    la, lb = tree.tree_leaves(a), tree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(bitcast_int(x), bitcast_int(y))


@pytest.mark.parametrize("n", [1, 7, 8, 33])
def test_word_layout_matches_jax(n):
    np_tree = mixed_tree(n=n)
    jl = jops.word_layout(jax.tree.map(jnp.asarray, np_tree))
    tl = tops.word_layout(bridge.states_from_numpy(np_tree, device="cpu"))
    assert (tl.n_words, tl.offsets, tl.total) == (jl.n_words, jl.offsets, jl.total)
    for m in (1, 4, 128, 1000):
        assert tl.padded(m) == jl.padded(m)


def test_word_layout_is_cached_per_signature():
    t = bridge.states_from_numpy(mixed_tree(0), device="cpu")
    u = bridge.states_from_numpy(mixed_tree(1), device="cpu")
    assert tops.word_layout(t) is tops.word_layout(u)


@pytest.mark.parametrize("multiple", [1, 4, 128, 1000])
@pytest.mark.parametrize("n", [1, 7, 33])
def test_flatten_to_u32_matches_jax_and_round_trips(n, multiple):
    np_tree = mixed_tree(seed=n, n=n)
    t = bridge.states_from_numpy(np_tree, device="cpu")
    flat = tops.flatten_to_u32(t, multiple=multiple)
    assert flat.dtype == torch.int32 and flat.dim() == 1
    np.testing.assert_array_equal(flat.numpy(), jax_words(np_tree, multiple))
    same_leaves(tops.unflatten_from_u32(flat, t), t)


def test_unflatten_matches_jax_on_the_same_words():
    np_tree = mixed_tree(seed=3, n=5)
    rng = np.random.default_rng(9)
    like_j = jax.tree.map(jnp.asarray, np_tree)
    words = rng.integers(0, 2**32, size=jops.word_layout(like_j).padded(16), dtype=np.uint32)
    # bools unflatten as "byte != 0", so any word pattern maps the same way
    got = tops.unflatten_from_u32(torch.from_numpy(words.view(np.int32).copy()),
                                  bridge.states_from_numpy(np_tree, device="cpu"))
    want = jops.unflatten_from_u32(jnp.asarray(words), like_j)
    same_leaves(got, bridge.states_from_numpy(jax.tree.map(np.asarray, want), device="cpu"))


def test_64_bit_leaves_split_low_high_like_numpy():
    rng = np.random.default_rng(5)
    np_tree = {"i64": rng.integers(-(2**62), 2**62, size=(5,)).astype(np.int64),
               "f64": rng.normal(size=(3,)),
               "a_i8": np.arange(3, dtype=np.int8)}
    t = bridge.states_from_numpy(np_tree, device="cpu")
    flat = tops.flatten_to_u32(t, multiple=8).numpy().view(np.uint32)
    pad8 = np.zeros(4, np.uint8)
    pad8[:3] = np_tree["a_i8"].view(np.uint8)
    want = np.concatenate([pad8.view(np.uint32),  # sorted keys: a_i8, f64, i64
                           np_tree["f64"].view(np.uint32),
                           np_tree["i64"].view(np.uint32)])
    want = np.concatenate([want, np.zeros(-len(want) % 8, np.uint32)])
    np.testing.assert_array_equal(flat, want)
    # f64 sits at word 1, an odd offset: the leaf is copied out, not viewed
    same_leaves(tops.unflatten_from_u32(torch.from_numpy(flat.view(np.int32).copy()), t), t)


@pytest.mark.parametrize("rows", [2, 3])
def test_flatten_replicas_rows_equal_per_replica_streams(rows):
    reps = [bridge.states_from_numpy(mixed_tree(seed=10 + r, n=9), device="cpu")
            for r in range(rows)]
    stacked = tree.tree_map(lambda *xs: torch.stack(xs), *reps)
    flats = tops.flatten_replicas(stacked, rows, multiple=128)
    assert flats.shape == (rows, tops.word_layout(reps[0]).padded(128))
    for r in range(rows):
        assert torch.equal(flats[r], tops.flatten_to_u32(reps[r], multiple=128))


def test_empty_tree_flattens_to_padding_only():
    assert tops.flatten_to_u32({}).shape == (0,)
    assert tops.word_layout({"e": torch.zeros(0)}).padded(128) == 0
    np.testing.assert_array_equal(tops.flatten_to_u32({"e": torch.zeros(0)}, multiple=4).numpy(),
                                  jax_words({"e": np.zeros(0, np.float32)}, 4))
