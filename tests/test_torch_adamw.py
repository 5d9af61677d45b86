"""``repro_torch.optim.adamw`` against ``repro.optim.adamw`` on seeded numpy
trees: ``schedule``, ``global_norm`` and ``apply_updates`` over several
steps (f32; bf16 params with the f32 master copy; the blockwise int8
moments) within 1e-6 relative in f32, state trees in JAX's leaf order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro_torch import bridge
from repro_torch.optim import adamw as TA
from repro_torch.tree import tree_leaves, tree_paths
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

CFG = dict(peak_lr=1e-2, min_lr=1e-3, warmup_steps=3, decay_steps=9, weight_decay=0.1,
           clip_norm=1.0)


def tree(rng, dtype=np.float32):
    """A params-like tree: 2-D leaves (decayed), 1-D (not), a leaf whose
    last axis is a multiple of 256 (quantizable) and one that is not."""
    def r(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    return {"w": r(4, 512), "b": r(512), "layers": [{"k": r(3, 256), "odd": r(5, 7)}],
            "norm": r(8)}


def to_jax(t, dtype):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), t)


def to_torch(t, dtype):
    return bridge.states_from_numpy(jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dtype)), t),
                                    device="cpu")


def assert_close(j, t, rel=1e-6, what=""):
    jl, tl = jax.tree.leaves(j), tree_leaves(t)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        assert a.shape == b.shape
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= rel * scale, what


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 9, 12])
def test_schedule(step):
    jc, tc = JA.OptConfig(**CFG), TA.OptConfig(**CFG)
    a = float(JA.schedule(jc, jnp.int32(step)))
    b = float(TA.schedule(tc, torch.tensor(step, dtype=torch.int32)))
    assert abs(a - b) <= 1e-6 * max(abs(a), 1e-12)


def test_global_norm():
    g = tree(np.random.default_rng(1))
    a = float(JA.global_norm(to_jax(g, jnp.float32)))
    b = float(TA.global_norm(to_torch(g, jnp.float32)))
    assert abs(a - b) <= 1e-6 * a


@pytest.mark.parametrize("dtype,master,quantized", [
    (jnp.float32, False, False), (jnp.float32, True, False), (jnp.bfloat16, True, False),
    (jnp.float32, True, True), (jnp.bfloat16, True, True),
])
def test_apply_updates_steps(dtype, master, quantized):
    """Five steps, each side feeding its own state, the same grads (a
    large first one, so clipping engages); params, master and moments
    within 1e-6 relative in f32 (the bf16 params: one bf16 ulp)."""
    rng = np.random.default_rng(0)
    p0 = tree(rng)
    jc = JA.OptConfig(**CFG, master_fp32=master, quantized_state=quantized)
    tc = TA.OptConfig(**CFG, master_fp32=master, quantized_state=quantized)
    jp, tp = to_jax(p0, dtype), to_torch(p0, dtype)
    js, ts = JA.init_opt_state(jp, jc), TA.init_opt_state(tp, tc)
    assert [p for p in tree_paths(ts)] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(js)[0]]
    for step in range(5):
        g = jax.tree.map(lambda x: x * (10.0 if step == 0 else 0.3), tree(rng))
        jp, js, jinfo = JA.apply_updates(jp, to_jax(g, dtype), js, jc)
        tp, ts, tinfo = TA.apply_updates(tp, to_torch(g, dtype), ts, tc)
        for k in ("grad_norm", "lr"):
            assert abs(float(jinfo[k]) - float(tinfo[k])) <= 1e-6 * abs(float(jinfo[k]))
        assert int(ts["step"]) == int(js["step"]) == step + 1
    rel = 1e-6 if dtype == jnp.float32 else 2**-7
    assert_close(jp, tp, rel, "params")
    if master:
        assert_close(js["master"], ts["master"], 1e-6, "master")
    if not quantized:
        assert_close(js["m"], ts["m"], 1e-6, "m")
        assert_close(js["v"], ts["v"], 1e-6, "v")
    else:
        # int8 codes and block scales: leaves {q, scale} where the last
        # axis is a multiple of 256, plain f32 elsewhere
        assert isinstance(ts["m"]["w"], dict) and ts["m"]["w"]["q"].dtype == torch.int8
        assert not isinstance(ts["m"]["layers"][0]["odd"], dict)
        for name in ("m", "v"):
            for a, b in zip(jax.tree.leaves(js[name]), tree_leaves(ts[name])):
                a = np.asarray(a)
                if a.dtype == np.int8:
                    assert np.abs(a.astype(np.int32) - b.numpy()).max() <= 1
                else:
                    np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-12)


def test_quantize_round_trip_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 512)).astype(np.float32)
    jq = JA._quantize(jnp.asarray(x))
    tq = TA._quantize(torch.from_numpy(x))
    assert (np.asarray(jq["q"]) == tq["q"].numpy()).all()
    np.testing.assert_allclose(tq["scale"].numpy(), np.asarray(jq["scale"]), rtol=1e-6)
    np.testing.assert_allclose(TA._dequantize(tq, x.shape).numpy(),
                               np.asarray(JA._dequantize(jq, x.shape)), rtol=1e-6)


def test_updates_do_not_write_the_previous_state():
    p = to_torch(tree(np.random.default_rng(2)), jnp.float32)
    cfg = TA.OptConfig(**CFG)
    st = TA.init_opt_state(p, cfg)
    before = [x.clone() for x in tree_leaves((p, st))]
    TA.apply_updates(p, to_torch(tree(np.random.default_rng(4)), jnp.float32), st, cfg)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves((p, st))))
