"""The plain versions of the port's redundancy kernels K1-K4 held BITWISE
against the JAX package's Pallas kernels run in interpret mode, on the
same numpy-made u32 streams: ``dmr_compare`` and ``tmr_step``
(``kernels/fused_step.py``, over a one-leaf replicated tree), ``state_hash``
and ``tmr_vote``, ``pick_block`` and the two tree-level wrappers of
``kernels/ops.py``.  Every wrapper on a CPU tensor takes its plain version
and launches nothing."""

import ctypes

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
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

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
    diff, fps = tfs.dmr_compare([torch.stack([t(a), t(c)])], block)  # a flat stream: one leaf
    jd, jf = jfs.dmr_compare(jnp.asarray(a), jnp.asarray(c), block=block, interpret=True)
    assert diff.dtype == torch.int32 and int(diff) == int(jd) == len(flips)
    assert fps.shape == (2, 4)
    np.testing.assert_array_equal(fps.numpy(), i32(jf))
    assert bool((fps[0] == fps[1]).all()) == (not flips)


@pytest.mark.parametrize("n,block,flips", CASES, ids=["n128", "n512_flip", "n4096_flips"])
def test_tmr_step_plain_matches_pallas(n, block, flips):
    a, b, c = streams(n, 4, flips)
    [voted], counts, fp = tfs.tmr_step([torch.stack([t(c), t(a), t(b)])], block)
    jv, jc, jf = jfs.tmr_step(*(jnp.asarray(x) for x in (c, a, b)), block=block, interpret=True)
    assert voted.shape == (3, n)
    for r in range(3):  # re-replicated
        np.testing.assert_array_equal(voted[r].numpy(), i32(jv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(fp.numpy(), i32(jf))
    assert counts.tolist() == [len(flips), 0, 0]
    assert torch.equal(voted[0], t(a))


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
    with pytest.raises(ValueError, match="replica axis of 2"):
        tfs.dmr_compare([x.reshape(1, 8), torch.zeros(2, 9, dtype=torch.int32)], 1)
    with pytest.raises(ValueError):
        ttv.tmr_vote(x, x, x.reshape(2, 4))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tfs.tmr_step([torch.zeros(3, 8, dtype=torch.int32, device="meta")], 1)


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


# ---------------------------------------------------------------------------
# K1 / K2 over a replicated tree read in place (the leaf segments)
# ---------------------------------------------------------------------------
def replicated_tree(R, seed, flip):
    """A state tree with a leading replica axis of R: mixed dtypes and odd
    sizes, word-aligned leaves (f32 of 7, int64, int8 of 12, bool of 8)
    read in place, and leaves a replica of which is not whole words (bf16
    of 5, bool of 3) or that are not contiguous (a transposed f32), which
    get packed copies.  ``flip``: a bit of replica 1 flipped in each
    leaf."""
    g = torch.Generator().manual_seed(seed)
    one = {
        "a_f32": torch.randn(7, generator=g),
        "b_bf16": torch.randn(5, generator=g).bfloat16(),
        "c_i64": torch.randint(-2**40, 2**40, (3,), generator=g),
        "d_i8": torch.randint(-128, 127, (3, 4), generator=g).to(torch.int8),
        "e_bool": torch.randint(0, 2, (3,), generator=g).bool(),
        "f_bool8": torch.randint(0, 2, (8,), generator=g).bool(),
    }
    tree_ = {k: v.unsqueeze(0).repeat(R, *([1] * v.dim())) for k, v in one.items()}
    tree_["g_f32_t"] = torch.randn(R, 4, 6, generator=g).transpose(1, 2)  # not contiguous
    tree_["g_f32_t"][1:] = tree_["g_f32_t"][0]
    if flip:
        for k, x in tree_.items():
            w = bitcast_int(x[1]).reshape(-1)
            w[0] ^= 1  # bool: 1 -> 0 or 0 -> 1
            x[1] = tsh_bitcast_back(w.reshape(x[1].shape), x.dtype)
    return tree_


def tsh_bitcast_back(w, dtype):
    from repro_torch.core.fault import bitcast_back

    return w.to(torch.bool) if dtype == torch.bool else bitcast_back(w, dtype)


def words_at(ptr, n):
    """The n u32 words at a host address, as a writable numpy view."""
    return np.ctypeslib.as_array((ctypes.c_uint32 * n).from_address(ptr))


def segments_plain(segs, R, vote):
    """What the kernel computes over a ``Seg`` array, in torch: counts and
    fingerprints of the padded stream, segment by segment at their global
    word indices (sums add mod 2**32, h3 xors), reading each replica's
    words through the segment's pointers as the kernel does (CPU tensors
    here); with ``vote``, the voted words written through every output
    pointer of a segment."""
    fps = [torch.zeros(4, dtype=torch.int64) for _ in range(R if not vote else 1)]
    counts = torch.zeros(R, dtype=torch.int64)
    diff = torch.zeros((), dtype=torch.int64)

    def add(h, seg_words, off):
        f = tsh.fingerprint_u32(seg_words, off)
        h[[0, 1, 3]] = (h[[0, 1, 3]] + f[[0, 1, 3]]) & tsh.M32
        h[2] = h[2] ^ f[2]

    for s in segs:
        ws = ([torch.from_numpy(words_at(s.inp[r], s.n).astype(np.int64)) for r in range(R)]
              if s.inp[0] else [torch.zeros(s.n, dtype=torch.int64)] * R)
        if vote:
            v = (ws[0] & ws[1]) | (ws[0] & ws[2]) | (ws[1] & ws[2])
            counts += torch.stack([(w != v).sum() for w in ws])
            add(fps[0], v, s.off)
            for p in s.out:
                if p:
                    words_at(p, s.n)[:] = v.numpy().astype(np.uint32)
        else:
            diff += (ws[0] != ws[1]).sum()
            for h, w in zip(fps, ws):
                add(h, w, s.off)
    fps = torch.stack([tsh.from_u32(h) for h in fps])
    return diff.to(torch.int32), counts.to(torch.int32), fps


@pytest.mark.parametrize("flip", [False, True], ids=["clean", "flipped"])
@pytest.mark.parametrize("multiple", [1, 128, 1000], ids=["unpadded", "block128", "pad1000"])
def test_dmr_leaf_segments_equal_flatten_path_bitwise(flip, multiple):
    tree_ = replicated_tree(2, 1, flip)
    segs, finish = tfs.plan_segments(tree_, 2, multiple)
    diff, _, fps = segments_plain(segs, 2, vote=False)
    assert finish() is None
    want_diff, want_fps = tfs.dmr_compare_plain(*tops.flatten_replicas(tree_, 2, multiple=multiple))
    assert torch.equal(diff, want_diff) and torch.equal(fps, want_fps)
    assert int(diff) == (7 if flip else 0)  # one word of each leaf
    got_diff, got_fps = tfs.dmr_compare(tree_, multiple)  # the CPU path
    assert torch.equal(got_diff, want_diff) and torch.equal(got_fps, want_fps)


@pytest.mark.parametrize("flip", [False, True], ids=["clean", "flipped"])
@pytest.mark.parametrize("multiple", [1, 128, 1000], ids=["unpadded", "block128", "pad1000"])
def test_tmr_leaf_segments_equal_flatten_path_bitwise(flip, multiple):
    tree_ = replicated_tree(3, 2, flip)
    segs, finish = tfs.plan_segments(tree_, 3, multiple, vote=True)
    _, counts, fps = segments_plain(segs, 3, vote=True)
    voted = finish()
    want_voted, want_counts, want_fp = tfs.tmr_step(tree_, multiple)  # the CPU path
    flats = tops.flatten_replicas(tree_, 3, multiple=multiple)
    _, plain_counts, plain_fp = tfs.tmr_step_plain(flats[0], flats[1], flats[2])
    assert torch.equal(want_counts, plain_counts) and torch.equal(want_fp, plain_fp)
    assert torch.equal(counts, want_counts) and torch.equal(fps[0], want_fp)
    assert counts.tolist() == ([0, 7, 0] if flip else [0, 0, 0])
    for k in tree_:
        x, y = voted[k], want_voted[k]
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(bitcast_int(x), bitcast_int(y)), k
        assert all(torch.equal(bitcast_int(x[r]), bitcast_int(tree_[k][0])) for r in range(3))


@pytest.mark.parametrize("R", [2, 3], ids=["dmr", "tmr"])
def test_card_branch_with_a_plain_launch_equals_flatten_path(R, monkeypatch):
    """The wrappers' card branch (plan, launch, finish) with the launch
    replaced by the plain evaluation of its ``Seg`` array: the outputs
    the wrapper builds equal the flatten path bitwise."""
    def plain_launch(kernel, segs, device, n_out):
        diff, counts, fps = segments_plain(segs, R, vote=kernel == "tmr_step")
        out = torch.cat([diff.reshape(1), fps.reshape(-1)]) if kernel == "dmr_compare" \
            else torch.cat([counts, fps.reshape(-1)])
        assert out.shape == (n_out,)
        return out

    monkeypatch.setattr(tfs, "_tree_on_cpu", lambda kernel, tree_, rows: False)
    monkeypatch.setattr(tfs, "launch_segments", plain_launch)
    tree_ = replicated_tree(R, 5, True)
    if R == 2:
        got = tfs.dmr_compare(tree_, 1000)
        want = tfs.dmr_compare_tree_plain(tree_, 1000)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert tfs.dmr_compare.launches == 1
        tfs.dmr_compare.launches = 0  # (the fixture holds the CPU path's counts at 0)
    else:
        (voted, counts, fp), want = tfs.tmr_step(tree_, 1000), tfs.tmr_step_tree_plain(tree_, 1000)
        assert torch.equal(counts, want[1]) and torch.equal(fp, want[2])
        for k in tree_:
            assert torch.equal(bitcast_int(voted[k]), bitcast_int(want[0][k])), k
        assert tfs.tmr_step.launches == 1
        tfs.tmr_step.launches = 0


def test_leaf_segments_read_word_aligned_leaves_in_place():
    """Word-aligned contiguous leaves are read where they lie, replica r
    at the r-th share of the leaf's bytes; a leaf a replica of which is
    not whole words, or that is not contiguous, gets a packed copy; the
    padding is one segment of zeros."""
    tree_ = replicated_tree(3, 3, False)
    segs, _ = tfs.plan_segments(tree_, 3, 1000, vote=True)
    leaves = [tree_[k] for k in sorted(tree_)]
    in_place = {k for k, x, s in zip(sorted(tree_), leaves, segs) if s.inp[0] == x.data_ptr()}
    assert in_place == {"a_f32", "c_i64", "d_i8", "f_bool8"}
    for k in in_place:
        x, s = tree_[k], segs[sorted(tree_).index(k)]
        share = x[0].numel() * x.element_size()
        assert list(s.inp) == [x.data_ptr() + r * share for r in range(3)]
    assert not segs[-1].inp[0] and not any(segs[-1].out) and segs[-1].off + segs[-1].n == 1000
    layout = tops.word_layout(tree_, lead=1)
    assert [s.off for s in segs[:-1]] == list(layout.offsets)
    assert [s.n for s in segs[:-1]] == list(layout.n_words)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [2, 3])
def test_leaf_kernels_equal_flatten_path_on_the_card(R):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tree_ = {k: v.cuda() for k, v in replicated_tree(R, 4, True).items()}
    tree_["g_f32_t"] = tree_["g_f32_t"].transpose(1, 2).contiguous().transpose(1, 2)
    flats = tops.flatten_replicas(tree_, R, multiple=1000)
    if R == 2:
        got = tfs.dmr_compare(tree_, 1000)
        want = tfs.dmr_compare_plain(*flats)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        voted, counts, fp = tfs.tmr_step(tree_, 1000)
        _, want_counts, want_fp = tfs.tmr_step_plain(flats[0], flats[1], flats[2])
        assert torch.equal(counts, want_counts) and torch.equal(fp, want_fp)
        for k in tree_:
            assert all(torch.equal(bitcast_int(voted[k][r]), bitcast_int(tree_[k][0]))
                       for r in range(3))
    tfs.dmr_compare.launches = tfs.tmr_step.launches = 0
