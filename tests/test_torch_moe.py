"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's single-shard path (``repro.models.moe``) on the same numpy
inputs: routing (softmax and sigmoid; ``idx`` bitwise, gates and the aux
loss within 1e-6), the capacity rule, dispatch and combine (``slot`` and
``keep`` bitwise, also when the capacity drops tokens), the expert FFN
(swiglu and gelu) and ``moe_block`` with a shared expert (f32, 1e-5:
different reduction orders)."""

import dataclasses as dc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import moe as jmoe
from repro.models.config import MoEConfig as JMoEConfig
from repro_torch import bridge
from repro_torch.configs import get_reduced as tget
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.tree import tree_leaves, tree_paths
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ROUTERS = ["softmax", "sigmoid"]


def moe_cfgs(act="softmax", **kw):
    j = JMoEConfig(n_experts=8, top_k=2, d_ff_expert=16, router_act=act, **kw)
    return j, TMoEConfig(**dc.asdict(j))


def rn(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("act", ROUTERS)
def test_route_matches_jax(act):
    jm, tm = moe_cfgs(act)
    logits = rn(0, 37, 8)
    jg, ji, ja = jmoe._route(jnp.asarray(logits), jm)
    tg, ti, ta = tmoe._route(t(logits), tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("act", ROUTERS)
def test_route_breaks_ties_toward_the_lower_index_like_jax_top_k(act):
    """Equal scores: ``jax.lax.top_k`` picks the lower expert index first."""
    jm, tm = moe_cfgs(act)
    logits = np.zeros((6, 8), np.float32)
    logits[1, [2, 5, 7]] = 1.0  # a three-way tie above the rest
    logits[2, [6, 3]] = -0.5  # the rest tie at 0 above them
    logits[3] = np.repeat(np.float32([0.25, -1.0]), 4)
    _, ji, _ = jmoe._route(jnp.asarray(logits), jm)
    _, ti, _ = tmoe._route(t(logits), tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti[0].tolist() == [0, 1] and ti[1].tolist() == [2, 5]


@pytest.mark.parametrize("n_tokens", [1, 8, 37, 64, 500, 4096])
@pytest.mark.parametrize("cf", [1.0, 1.25, 4.0])
def test_capacity_matches_jax(n_tokens, cf):
    for e, k in ((8, 2), (32, 8), (256, 8)):
        j = JMoEConfig(n_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf)
        assert tmoe._capacity(n_tokens, TMoEConfig(**dc.asdict(j))) == jmoe._capacity(n_tokens, j)


@pytest.mark.parametrize("C", [24, 2], ids=["no_drop", "drops"])
def test_dispatch_and_combine_match_jax(C):
    """``slot`` and ``keep`` bitwise (C = 24 holds every pair of the 23
    tokens, C = 2 drops the pairs past each expert's second), the buffers
    equal, the combined output within 1e-6."""
    jm, tm = moe_cfgs()
    T, d, E = 23, 12, 8
    x, logits = rn(1, T, d), rn(2, T, E)
    jg, ji, _ = jmoe._route(jnp.asarray(logits), jm)
    tg, ti, _ = tmoe._route(t(logits), tm)
    jbuf, jslot, jkeep = jmoe._dispatch(jnp.asarray(x), jg, ji, E, C)
    tbuf, tslot, tkeep = tmoe._dispatch(t(x), ti, E, C)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert bool((~tkeep).any()) == (C == 2)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    h = rn(3, E * C, d)
    jy = jmoe._combine(jnp.asarray(h), jslot, jkeep, jg, T, 2)
    ty = tmoe._combine(t(h), tslot, tkeep, tg, T, 2)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_expert_ffn_matches_jax(act):
    E, C, d, f = 4, 8, 12, 20
    p = {"w1": rn(4, E, d, f), "w2": rn(5, E, f, d)}
    if act == "swiglu":
        p["w3"] = rn(6, E, d, f)
    buf = rn(7, E, C, d)
    jy = jmoe._expert_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(buf), act)
    ty = tmoe._expert_ffn({k: t(v) for k, v in p.items()}, t(buf), act)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)


CASES = {"deepseek-v3-671b": "sigmoid router, one shared expert, swiglu",
         "granite-moe-1b-a400m": "softmax router, no shared expert"}


@pytest.mark.parametrize("arch", sorted(CASES))
@pytest.mark.parametrize("cf", [1.25, 0.25], ids=["cf1.25", "cf0.25_drops"])
def test_moe_block_matches_jax(arch, cf):
    """The whole layer on JAX-made weights (bridged), with capacity factor
    1.25 and with 0.25, which drops routed tokens."""
    cfg = dc.replace(get_reduced(arch), dtype="float32")
    cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, capacity_factor=cf))
    tcfg = dc.replace(tget(arch), dtype="float32", moe=TMoEConfig(**dc.asdict(cfg.moe)))
    p = jmoe.moe_init(jax.random.PRNGKey(3), cfg)
    tp = bridge.states_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
    x = rn(8, 3, 11, cfg.d_model)
    jy, jaux = jmoe.moe_block(p, jnp.asarray(x), cfg)
    ty, taux = tmoe.moe_block(tp, t(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)
    assert ("shared" in tp) == (cfg.moe.n_shared_experts > 0)


@pytest.mark.parametrize("arch", sorted(CASES))
def test_moe_init_layout_and_f32_router_match_jax(arch):
    """Generator-made MoE weights have JAX's keys, shapes and dtypes: the
    router f32 under a bf16 config, the experts in bf16."""
    cfg, tcfg = get_reduced(arch), tget(arch)
    jp = jax.eval_shape(lambda k: jmoe.moe_init(k, cfg), jax.random.PRNGKey(0))
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, "cpu")
    jflat, _ = jax.tree.flatten_with_path(jp)
    assert [tuple(k.key for k in path) for path, _ in jflat] == tree_paths(tp)
    for (_, a), b in zip(jflat, tree_leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
    assert tp["router"].dtype == torch.float32 and tp["w1"].dtype == torch.bfloat16
    # each expert drawn on its own, scaled by d_in ** -0.5
    assert 0.5 < float(tp["w1"].float().std() * cfg.d_model**0.5) < 2.0
