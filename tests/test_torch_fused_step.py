"""The plain versions of the port's redundancy kernels K1-K4 held BITWISE
against the JAX package's Pallas kernels run in interpret mode, on the
same numpy-made u32 streams: ``dmr_compare`` and ``tmr_step``
(``kernels/fused_step.py``), ``state_hash`` and ``tmr_vote``, ``pick_block``
and the two tree-level wrappers of ``kernels/ops.py``.  Every wrapper on
a CPU tensor takes its plain version and launches nothing."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import fused_step as jfs
from repro.kernels import ops as jops
from repro.kernels.state_hash import state_hash as jstate_hash
from repro.kernels.tmr_vote import tmr_vote as jtmr_vote
from repro_torch import bridge, tree
from repro_torch.core.fault import bitcast_int
from repro_torch.kernels import fused_step as tfs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import state_hash as tsh
from repro_torch.kernels import tmr_vote as ttv

WRAPPERS = (tfs.dmr_compare, tfs.tmr_step, tsh.state_hash, ttv.tmr_vote)


@pytest.fixture(autouse=True)
def no_launches():
    """The CPU path launches no kernel: every count stays 0."""
    for w in WRAPPERS:
        w.launches = 0
    yield
    assert [w.launches for w in WRAPPERS] == [0, 0, 0, 0]


def streams(n, seed, flips=()):
    """Three replica streams as numpy uint32: a == b, c = a with each
    (index, bit) of ``flips`` flipped."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, n, dtype=np.uint32)
    c = a.copy()
    for i, bit in flips:
        c[i] ^= np.uint32(1 << bit)
    return a, a.copy(), c


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32).copy())


def i32(x):
    return np.asarray(x).view(np.int32)


CASES = [(128, 128, ()), (512, 128, ((3, 0),)), (4096, 1024, ((0, 31), (4095, 7), (2000, 13)))]


@pytest.mark.parametrize("n,block,flips", CASES, ids=["n128", "n512_flip", "n4096_flips"])
def test_state_hash_plain_matches_pallas(n, block, flips):
    _, _, c = streams(n, 1, flips)
    got = tsh.state_hash(t(c))
    assert got.dtype == torch.int32 and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), i32(jstate_hash(jnp.asarray(c), block=block, interpret=True)))


@pytest.mark.parametrize("n,block,flips", CASES, ids=["n128", "n512_flip", "n4096_flips"])
def test_tmr_vote_plain_matches_pallas(n, block, flips):
    a, b, c = streams(n, 2, flips)
    voted, counts = ttv.tmr_vote(t(a), t(c), t(b))  # the struck replica in the middle
    jv, jc = jtmr_vote(*(jnp.asarray(x) for x in (a, c, b)), block=block, interpret=True)
    np.testing.assert_array_equal(voted.numpy(), i32(jv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts.tolist() == [0, len(flips), 0]


@pytest.mark.parametrize("n,block,flips", CASES, ids=["n128", "n512_flip", "n4096_flips"])
def test_dmr_compare_plain_matches_pallas(n, block, flips):
    a, _, c = streams(n, 3, flips)
    diff, fps = tfs.dmr_compare(t(a), t(c))
    jd, jf = jfs.dmr_compare(jnp.asarray(a), jnp.asarray(c), block=block, interpret=True)
    assert diff.dtype == torch.int32 and int(diff) == int(jd) == len(flips)
    assert fps.shape == (2, 4)
    np.testing.assert_array_equal(fps.numpy(), i32(jf))
    assert bool((fps[0] == fps[1]).all()) == (not flips)


@pytest.mark.parametrize("n,block,flips", CASES, ids=["n128", "n512_flip", "n4096_flips"])
def test_tmr_step_plain_matches_pallas(n, block, flips):
    a, b, c = streams(n, 4, flips)
    voted, counts, fp = tfs.tmr_step(t(c), t(a), t(b))
    jv, jc, jf = jfs.tmr_step(*(jnp.asarray(x) for x in (c, a, b)), block=block, interpret=True)
    np.testing.assert_array_equal(voted.numpy(), i32(jv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(fp.numpy(), i32(jf))
    assert counts.tolist() == [len(flips), 0, 0]
    assert torch.equal(voted, t(a))


def test_fingerprints_do_not_depend_on_the_pallas_block():
    a, _, _ = streams(2048, 5)
    got = tsh.state_hash(t(a)).numpy()
    for block in (128, 512, 2048):
        np.testing.assert_array_equal(got, i32(jstate_hash(jnp.asarray(a), block=block, interpret=True)))


def test_state_hash_detects_every_single_bit_flip_position():
    a, _, _ = streams(256, 6)
    h0 = tsh.state_hash(t(a))
    for pos, bit in [(0, 0), (100, 17), (255, 31)]:
        _, _, c = streams(256, 6, [(pos, bit)])
        assert not torch.equal(tsh.state_hash(t(c)), h0)


def test_empty_stream_fingerprint_is_zero():
    assert tsh.state_hash(torch.zeros(0, dtype=torch.int32)).tolist() == [0, 0, 0, 0]


def test_pick_block_matches_jax():
    for total in (0, 1, 8, 127, 128, 129, 65535, 65536, 65537, 1 << 20, 24_883_200):
        assert tfs.pick_block(total) == jfs.pick_block(total)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tsh.state_hash(x.float())
    with pytest.raises(ValueError):
        tfs.dmr_compare(x, torch.zeros(9, dtype=torch.int32))
    with pytest.raises(ValueError):
        ttv.tmr_vote(x, x, x.reshape(2, 4))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tfs.tmr_step(*(torch.zeros(8, dtype=torch.int32, device="meta"),) * 3)


def blend_like_tree(seed):
    rng = np.random.default_rng(seed)
    return {"r": rng.normal(size=(1000,)).astype(np.float32),
            "h": rng.normal(size=(33,)).astype(ml_dtypes.bfloat16),
            "flag": rng.integers(0, 2, size=(5,)).astype(bool)}


def test_fingerprint_fused_matches_jax():
    np_tree = blend_like_tree(7)
    got = tops.fingerprint_fused(bridge.states_from_numpy(np_tree, device="cpu"))
    jtree = jax.tree.map(jnp.asarray, np_tree)
    np.testing.assert_array_equal(got.numpy(), i32(jops.fingerprint_fused(jtree, pallas=True, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), i32(jops.fingerprint_fused(jtree, pallas=False)))


def test_tmr_vote_pytree_matches_jax():
    reps = [blend_like_tree(8) for _ in range(3)]
    reps[1]["r"][0] = 99.0
    reps[2]["h"][4] = ml_dtypes.bfloat16(-3.0)
    stacked = {k: np.stack([r[k] for r in reps]) for k in reps[0]}
    voted, counts = tops.tmr_vote_pytree(bridge.states_from_numpy(stacked, device="cpu"))
    jv, jc = jops.tmr_vote_pytree(jax.tree.map(jnp.asarray, stacked), pallas=True, interpret=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts.tolist() == [0, 1, 1]
    want = bridge.states_from_numpy(jax.tree.map(np.asarray, jv), device="cpu")
    for x, y in zip(tree.tree_leaves(voted), tree.tree_leaves(want)):
        assert x.dtype == y.dtype and torch.equal(bitcast_int(x), bitcast_int(y))
