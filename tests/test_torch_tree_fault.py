"""repro_torch's tree order, bitcasts, fault injection and fingerprints,
held BITWISE against the JAX package on the same inputs.

Fault specs, fingerprint leaf salts and ledger attribution all index
leaves by flatten order, so the port must flatten in ``jax.tree.leaves``
order (dict keys sorted) and flip/hash exactly the same bits.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import fault as jfault
from repro.core import redundancy as jred
from repro_torch import bridge, tree
from repro_torch.core import fault as tfault
from repro_torch.core import redundancy as tred
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


def mixed_state(seed=0):
    """numpy state with an f32/bf16/i32/bool mix, nested and unsorted."""
    rng = np.random.default_rng(seed)
    return {
        "z_f32": rng.normal(size=(3, 5)).astype(np.float32),
        "a_bf16": rng.normal(size=(4, 2, 3)).astype(ml_dtypes.bfloat16),
        "m": {
            "i32": rng.integers(-(2**31), 2**31 - 1, size=(7,)).astype(np.int32),
            "flag": rng.integers(0, 2, size=(2, 3)).astype(bool),
        },
        "scalar": np.float32(rng.normal()),
        "seq": [np.arange(6, dtype=np.int32).reshape(2, 3), np.float32(2.5)],
    }


def to_jax(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


# jitted once per state structure: eager JAX re-dispatches every op
jinject = jax.jit(lambda spec, st: jfault.inject(
    spec, cell_id=0, step=jnp.int32(0), replicated_state=st))
jfingerprint = jax.jit(jred.fingerprint)


def to_torch(np_tree):
    return bridge.states_from_numpy(np_tree, device="cpu")


@pytest.mark.parametrize(
    "t",
    [
        {"b": 1, "a": 2},
        {"z": [3, {"y": 4, "x": 5}], "a": (6, 7), "m": None},
        [{"q": 1, "p": 2}, (3, {"c": 4, "b": 5, "a": 6})],
        mixed_state(),
    ],
    ids=["flat_dict", "nested", "list_root", "mixed_state"],
)
def test_leaf_order_matches_jax(t):
    ours = tree.tree_leaves(t)
    ref = jax.tree.leaves(t)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a is b
    leaves, td = tree.tree_flatten(t)
    back = tree.tree_unflatten(td, leaves)
    assert tree.tree_flatten(back)[1] == td


@pytest.mark.parametrize(
    "dtype", [np.float32, ml_dtypes.bfloat16, np.int32, np.bool_, np.int8, np.float16]
)
def test_bitcast_matches_jax(dtype):
    rng = np.random.default_rng(1)
    a = (rng.normal(size=(5, 4)) * 100).astype(dtype)
    ju = np.asarray(jfault.bitcast_uint(jnp.asarray(a)))
    t = to_torch({"a": a})["a"]
    tu = tfault.bitcast_uint(t)
    assert str(tu.dtype).replace("torch.", "") == ju.dtype.name
    np.testing.assert_array_equal(tu.to(torch.int64).numpy(), ju.astype(np.int64))
    back = tfault.bitcast_back(tu, t.dtype)
    assert back.dtype == t.dtype
    assert torch.equal(tfault.bitcast_int(back), tfault.bitcast_int(t))


def replicated(np_tree, R=2):
    return jax.tree.map(lambda x: np.stack([np.asarray(x)] * R), np_tree)


def campaign(seed, n=12):
    st = mixed_state()
    sizes = [int(np.asarray(x).size) for x in jax.tree.leaves(st)]
    specs = {}
    for name, mod in (("jax", jfault), ("torch", tfault)):
        specs[name] = mod.random_fault_campaign(
            np.random.default_rng(seed), n=n, steps=1, cell_id=0, replicas=2,
            leaf_sizes=sizes, bits=64,
        )
    return specs


def test_random_fault_campaign_identical_specs():
    specs = campaign(7)
    for j, t in zip(specs["jax"], specs["torch"]):
        for f in ("step", "cell_id", "replica", "leaf", "index", "bit"):
            assert int(getattr(j, f)) == getattr(t, f)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_inject_flips_the_same_bits_as_jax(seed):
    """Every spec of a campaign (including bits past a leaf's width and
    indices past its end) flips the same element and bit in both."""
    state = replicated(mixed_state())
    specs = campaign(seed)
    for js, ts in zip(specs["jax"], specs["torch"]):
        jout = jinject(js, to_jax(state))
        tout = tfault.inject(ts, cell_id=0, step=0, replicated_state=to_torch(state))
        for jl, tl in zip(jax.tree.leaves(jout), tree.tree_leaves(tout)):
            np.testing.assert_array_equal(
                np.asarray(jfault.bitcast_uint(jl)).astype(np.int64),
                tfault.bitcast_uint(tl).to(torch.int64).numpy(),
            )


@pytest.mark.parametrize("index,bit", [(-1, 3), (-7, 0), (10**6, 31), (5, -1)])
def test_inject_edge_addresses_match_jax(index, bit):
    state = replicated(mixed_state())
    for leaf in range(len(jax.tree.leaves(state))):
        js = jfault.FaultSpec.at(step=0, cell_id=0, replica=1, leaf=leaf, index=index, bit=bit)
        ts = tfault.FaultSpec.at(step=0, cell_id=0, replica=1, leaf=leaf, index=index, bit=bit)
        jout = jinject(js, to_jax(state))
        tout = tfault.inject(ts, cell_id=0, step=0, replicated_state=to_torch(state))
        for jl, tl in zip(jax.tree.leaves(jout), tree.tree_leaves(tout)):
            np.testing.assert_array_equal(
                np.asarray(jfault.bitcast_uint(jl)).astype(np.int64),
                tfault.bitcast_uint(tl).to(torch.int64).numpy(),
            )


def test_inject_disarmed_or_other_step_is_identity():
    state = to_torch(replicated(mixed_state()))
    for spec in (tfault.FaultSpec.none(), tfault.FaultSpec.at(step=3, cell_id=0)):
        out = tfault.inject(spec, cell_id=0, step=0, replicated_state=state)
        assert out is state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fingerprint_bitwise_equals_jax(seed):
    st = mixed_state(seed)
    jfp = np.asarray(jfingerprint(to_jax(st))).astype(np.int64)
    tfp = tred.fingerprint(to_torch(st)).numpy()
    np.testing.assert_array_equal(tfp, jfp)


def test_fingerprint_sees_every_single_bit_flip_like_jax():
    state = replicated(mixed_state(), R=1)
    for spec in campaign(11, n=20)["torch"]:
        spec = tfault.FaultSpec.at(0, 0, 0, spec.leaf, spec.index, spec.bit)
        jspec = jfault.FaultSpec.at(0, 0, 0, spec.leaf, spec.index, spec.bit)
        tflip = tfault.inject(spec, cell_id=0, step=0, replicated_state=to_torch(state))
        jflip = jinject(jspec, to_jax(state))
        tfp = tred.fingerprint(tree.tree_map(lambda x: x[0], tflip)).numpy()
        jfp = np.asarray(jfingerprint(jax.tree.map(lambda x: x[0], jflip))).astype(np.int64)
        np.testing.assert_array_equal(tfp, jfp)


def test_fingerprint_rows_equal_vmapped_jax():
    st = replicated(mixed_state(4), R=3)
    st = jax.tree.map(lambda x: x.copy(), st)
    st["z_f32"][1, 0, 0] += 1.0  # rows differ
    jfp = np.asarray(jax.vmap(jred.fingerprint)(to_jax(st))).astype(np.int64)
    tfp = tred.fingerprint_rows(to_torch(st), 3).numpy()
    np.testing.assert_array_equal(tfp, jfp)


def test_bit_mismatch_and_majority_vote_match_jax():
    rng = np.random.default_rng(5)
    a = mixed_state(0)
    b = jax.tree.map(lambda x: np.asarray(x).copy(), a)
    c = jax.tree.map(lambda x: np.asarray(x).copy(), a)
    b["z_f32"][0, 1] = rng.normal()
    c["m"]["flag"][1, 2] = ~c["m"]["flag"][1, 2]
    c["a_bf16"][3, 1, 2] = ml_dtypes.bfloat16(9.0)
    for x, y in ((a, b), (a, c), (b, c)):
        assert float(tred.bit_mismatch_elems(to_torch(x), to_torch(y))) == float(
            jred.bit_mismatch_elems(to_jax(x), to_jax(y)))
    jv = jred.majority_vote(to_jax(a), to_jax(b), to_jax(c))
    tv = tred.majority_vote(to_torch(a), to_torch(b), to_torch(c))
    for jl, tl in zip(jax.tree.leaves(jv), tree.tree_leaves(tv)):
        np.testing.assert_array_equal(
            np.asarray(jfault.bitcast_uint(jl)).astype(np.int64),
            tfault.bitcast_uint(tl).to(torch.int64).numpy())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decoder_tokens_leaf_index_matches_jax(paged):
    """The strike target of ``launch/serve.py --strike``: the flat index of
    the decoder state's ``tokens`` leaf, computed as the JAX launcher
    computes it, equals the port's ``tree.leaf_index``."""
    import dataclasses as dc

    from repro.configs import get_reduced
    from repro.models import lm_cells as jl
    from repro_torch.models import lm_cells as tl

    cfg = get_reduced("internlm2-1.8b")
    from repro_torch.configs import get_reduced as tget

    tcfg = tget("internlm2-1.8b")
    assert dc.asdict(cfg) == dc.asdict(tcfg)
    if paged:
        jex = jl.paged_slot_decoder_init(cfg, 2, 32, 8, 1)
        tex = tl.paged_slot_decoder_init(tcfg, 2, 32, 8, 1, "meta")
    else:
        jex = jl.slot_decoder_init(cfg, 2, 32)
        tex = tl.slot_decoder_init(tcfg, 2, 32, "meta")
    flat, _ = jax.tree_util.tree_flatten_with_path(jex)
    jidx = next(i for i, (p, _) in enumerate(flat)
                if any(getattr(q, "key", None) == "tokens" for q in p))
    assert tree.leaf_index(tex, "tokens") == jidx
    # and every leaf has the JAX shape and dtype, in the same order
    for (_, jleaf), tleaf in zip(flat, tree.tree_leaves(tex)):
        assert tuple(jleaf.shape) == tuple(tleaf.shape)
        assert jnp.dtype(jleaf.dtype).itemsize == tleaf.element_size()
