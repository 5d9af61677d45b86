"""The expert-parallel MoE (``models/moe.py::_moe_spmd``) against the JAX
package's, on ``tests/test_moe.py``'s SPMD child config in f32 (reduced
granite-moe with 8 experts, top-2, d_ff 16, softmax routing and a
capacity factor of 8, so no shard drops a token).

JAX's ``_moe_spmd`` runs in a child on 8 forced host devices (a (2, 4)
data x model mesh with Auto axes) for its three layouts: the all-to-all
(tokens (4, 8): sequence 8 over the model axis), the decode-time sum
over the model axis (tokens (4, 1)) and EP2D (``serve_ep2d``, one
expert a member).  The port runs the same weights, sharded by
``param_pspecs`` on a (2, 4) mesh of CPU devices, on the same inputs:
``y`` within 1e-5 of JAX's, the aux loss within 1e-6 of JAX's *sharded*
aux (the pmean of per-shard terms, which differs from the local aux by
design: ``tests/test_moe.py:167-171``), the routing bitwise the port's
own ``_moe_local`` and ``y`` within 1e-5 of it (nothing drops)."""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_reduced as tget
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import Sharded, param_pspecs, shard
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import moe as M
from repro_torch.models.config import MoEConfig
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE = dict(n_experts=8, top_k=2, d_ff_expert=16, router_act="softmax", capacity_factor=8.0)

_CHILD = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_reduced
from repro.launch.mesh import make_ctx
from repro.models.config import MoEConfig
from repro.models import moe as M

moe_kw, out = pickle.loads(bytes.fromhex(sys.argv[1]))
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
cfg = dataclasses.replace(get_reduced("granite-moe-1b-a400m"), dtype="float32",
                          moe=MoEConfig(**moe_kw))
key = jax.random.PRNGKey(0)
p = M.moe_init(key, cfg)
x = jax.random.normal(jax.random.fold_in(key, 1), (4, 8, cfg.d_model), jnp.float32)
res = {"p": jax.tree.map(np.asarray, p), "x": np.asarray(x)}
ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model)
ctx2 = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, serve_ep2d=True)
with mesh:
    for path, c, xx in (("a2a", ctx, x), ("ar", ctx, x[:, :1]), ("ep2d", ctx2, x[:, :1])):
        y, aux = jax.jit(lambda p, x, c=c: M._moe_spmd(p, x, cfg, c))(p, xx)
        res[path] = (np.asarray(y), float(aux))
with open(out, "wb") as f:
    pickle.dump(res, f)
"""

PATHS = {"a2a": (False, 8), "ar": (False, 1), "ep2d": (True, 1)}


@pytest.fixture(scope="module")
def jax_res(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe") / "jax.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD, pickle.dumps((MOE, str(out))).hex()],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def cfg():
    import dataclasses

    return dataclasses.replace(tget("granite-moe-1b-a400m"), dtype="float32",
                               moe=MoEConfig(**MOE))


def port(jax_res, path):
    c = cfg()
    ep2d, seq = PATHS[path]
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    ctx = make_ctx(mesh, vocab_size=c.vocab_size, d_model=c.d_model, serve_ep2d=ep2d)
    p = bridge.states_from_numpy(jax_res["p"], device="cpu")
    sp = shard({"moe": p}, param_pspecs(ctx, {"moe": p}, c), mesh)["moe"]
    x = torch.from_numpy(jax_res["x"][:, :seq].copy())
    return c, ctx, p, sp, x


@pytest.mark.parametrize("path", sorted(PATHS))
def test_moe_spmd_matches_jax(jax_res, path):
    c, ctx, p, sp, x = port(jax_res, path)
    y, aux = M._moe_spmd(sp, x, c, ctx)
    y_j, aux_j = jax_res[path]
    assert float((y - torch.from_numpy(y_j)).abs().max()) < 1e-5
    assert abs(float(aux) - aux_j) < 1e-6


@pytest.mark.parametrize("path", sorted(PATHS))
def test_moe_spmd_routing_and_output_equal_local(jax_res, path):
    c, ctx, p, sp, x = port(jax_res, path)
    y, _, idx = M._moe_spmd(sp, x, c, ctx, with_idx=True)
    y_l, _, idx_l = M._moe_local(p, x, c, with_idx=True)
    assert torch.equal(idx, idx_l)
    assert float((y - y_l).abs().max()) < 1e-5


def test_expert_layouts():
    c = cfg()
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    p = M.moe_init(torch.Generator().manual_seed(0), c, "cpu")
    for ep2d, per in ((False, 2), (True, 1)):
        ctx = make_ctx(mesh, vocab_size=c.vocab_size, d_model=c.d_model, serve_ep2d=ep2d)
        sp = shard({"moe": p}, param_pspecs(ctx, {"moe": p}, c), mesh)["moe"]
        w1 = sp["w1"]
        assert isinstance(w1, Sharded) and tuple(w1.local((1, 3)).shape) == (per, c.d_model, 16)
        n = len({w1.local(cc).data_ptr() for cc in w1.coords()})
        assert n == (8 if ep2d else 4)  # one allocation a member (EP2D) / model member
        assert len({id(x) for x in tree_leaves(sp["router"].shards.tolist())}) == 1
