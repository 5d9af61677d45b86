"""Sharded decode (``distributed/decode.py`` and the ``ctx`` threading of
the model) against the JAX package's, case 1 of the four of
``tests/test_decode_spmd.py``'s child: head-sharded musicgen (4 kv
heads over a model axis of 4).  The other cases and the helpers they
share are in ``test_torch_decode_spmd_{seq,mla,ep2d}.py`` (one file a
case, so that each JAX child stays near 30 s).

JAX's side runs in a child process on 8 forced host devices, with the
mesh's axes ``AxisType.Auto`` (under the installed jax, ``make_mesh``
without ``axis_types`` gives Explicit axes, which the reference's
sharded decode does not run on; its own launcher asks for Auto).  The
child prefills 4 prompts of 12 tokens unsharded, installs them in a
32-lane cache and decodes 3 steps under ``make_ctx(..., decode_shardmap
=True)`` on a (2, 4) data x model mesh, in f32 and in bf16; it returns
the params, the prefilled cache, the tokens it fed, the logits and the
final cache.  The port starts from the same params and cache (through
``repro_torch.bridge``), sharded on a (2, 4) mesh of CPU devices, and
feeds the same tokens.  Gates: logits within 1e-4 (relative to the
largest) of JAX's sharded logits in f32 and within JAX's 3e-2 in bf16;
3 free-running greedy tokens bitwise the port's unsharded decode in f32;
the final cache, unsharded, bitwise the port's unsharded cache and
JAX's on the integer leaves and within 1e-4 on the float ones."""

import json
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
from repro_torch.distributed.sharding import Sharded, unshard
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import transformer as T
from repro_torch.models.lm_cells import place_cache, place_params
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves, tree_map, tree_paths

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: case -> (arch, config overrides, serve_ep2d): the reference child's
CASES = {
    "head_sharded": ("musicgen-large", dict(n_heads=4, n_kv_heads=4, d_model=64, n_layers=2,
                                            d_ff=128, vocab_size=128, n_codebooks=1), False),
    "seq_sharded": ("internlm2-1.8b", dict(n_heads=4, n_kv_heads=2, d_model=64, n_layers=2,
                                           d_ff=128, vocab_size=128), False),
    "mla": ("deepseek-v3-671b", {}, False),
    "moe_ep2d": ("granite-moe-1b-a400m", {}, True),
    "mla_local": ("deepseek-v3-671b", {}, False),
    # test_torch_decode_spmd_ssm.py: the recurrent archs' reduced configs
    "mamba2": ("mamba2-2.7b", {}, False),
    "zamba2": ("zamba2-2.7b", {}, False),
}
#: case -> mesh shape, where it is not (2, 4): a model axis of 1 gives
#: MLA's latent cache no model axis, so both packages fall back to each
#: data member's own rows
MESHES = {"mla_local": (2, 1)}
B, PLEN, CAP, STEPS = 4, 12, 32, 3

_CHILD = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_reduced
from repro.distributed.sharding import LOCAL
from repro.launch.mesh import make_ctx
from repro.models import transformer as T

arch, over, ep2d, shape, B, plen, cap, steps, out = pickle.loads(bytes.fromhex(sys.argv[1]))
mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:shape[0] * shape[1]])
res = {}
for dtype in ("float32", "bfloat16"):
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype, **over)
    params = T.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, plen), 0, cfg.vocab_size, jnp.int32)
    logits, fcache, _ = T.forward(cfg, params, toks, ctx=LOCAL, fill_cache=True)
    cache = T.init_cache(cfg, B, cap)

    def fit(d, s):
        if d.shape == s.shape:
            return s.astype(d.dtype)
        pad = [(0, a - b) for a, b in zip(d.shape, s.shape)]
        fill = -1 if jnp.issubdtype(s.dtype, jnp.integer) else 0
        return jnp.pad(s, pad, constant_values=fill).astype(d.dtype)

    cache = {"segments": [jax.tree.map(fit, d, s) for d, s in
                          zip(cache["segments"], fcache["segments"])],
             "pos": jnp.full((B,), plen, jnp.int32)}
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                   decode_shardmap=True, serve_ep2d=ep2d)
    step = jax.jit(lambda c, t: T.decode_step(cfg, params, c, t, ctx=ctx))
    c, fed, outs = cache, [], []
    with mesh:
        for _ in range(steps):
            fed.append(np.asarray(tok))
            lg, c = step(c, tok)
            tok = jnp.argmax(lg[:, -1:, :].reshape(B, 1, -1), -1).astype(jnp.int32)
            outs.append(np.asarray(lg, np.float32))
    res[dtype] = dict(params=jax.tree.map(np.asarray, params),
                      cache=jax.tree.map(np.asarray, cache), fed=np.stack(fed),
                      logits=np.stack(outs), final=jax.tree.map(np.asarray, c))
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def run_child(case, tmp_path_factory) -> dict:
    arch, over, ep2d = CASES[case]
    out = tmp_path_factory.mktemp(case) / "jax.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    arg = pickle.dumps((arch, over, ep2d, MESHES.get(case, (2, 4)), B, PLEN, CAP, STEPS,
                        str(out))).hex()
    proc = subprocess.run([sys.executable, "-c", _CHILD, arg], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def port_cfg(case, dtype):
    import dataclasses

    arch, over, ep2d = CASES[case]
    return dataclasses.replace(tget(arch), dtype=dtype, **over), ep2d


def mesh_ctx(cfg, ep2d, shape=(2, 4)):
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
    return make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, decode_shardmap=True,
                    serve_ep2d=ep2d)


def decode(cfg, params, cache, feeds, ctx=None, free=False):
    """``len(feeds)`` decode steps from ``cache``, fed ``feeds[i]`` (or,
    with ``free``, ``feeds[0]`` then the argmax): (logits, tokens fed,
    final cache unsharded)."""
    kw = {} if ctx is None else {"ctx": ctx}
    tok, outs, fed = feeds[0], [], []
    for i in range(len(feeds)):
        fed.append(tok)
        lg, cache = T.decode_step(cfg, params, cache, tok, **kw)
        outs.append(lg.float())
        tok = lg[:, -1:].argmax(-1).to(torch.int32) if free else feeds[min(i + 1, len(feeds) - 1)]
    return torch.stack(outs), torch.stack(fed), unshard(cache)


def port_runs(case, jax_res) -> dict:
    """The port's decodes of the child's prefill: sharded teacher-forced
    with JAX's tokens, and sharded and unsharded free-running (f32)."""
    out = {}
    for dtype, r in jax_res.items():
        cfg, ep2d = port_cfg(case, dtype)
        ctx = mesh_ctx(cfg, ep2d, MESHES.get(case, (2, 4)))
        params = bridge.params_from_numpy(cfg, r["params"], device="cpu")
        cache = bridge.states_from_numpy(r["cache"], device="cpu")
        feeds = [torch.from_numpy(np.asarray(f)).to(torch.int32) for f in r["fed"]]
        sp = place_params(cfg, tree_map(lambda x: x, params), ctx)
        sc = place_cache(cfg, cache, ctx)
        assert all(isinstance(x, Sharded) for x in tree_leaves(sp) + tree_leaves(sc))
        run = {"forced": decode(cfg, sp, sc, feeds, ctx)}
        if dtype == "float32":
            run["free_sharded"] = decode(cfg, sp, sc, feeds, ctx, free=True)
            run["free_local"] = decode(cfg, params, cache, feeds, free=True)
        out[dtype] = run
    return out


def max_rel(got, want) -> float:
    want = torch.as_tensor(np.asarray(want, np.float32))
    return float((got - want).abs().max() / max(float(want.abs().max()), 1e-9))


def check_logits(jax_res, port, dtype, bound):
    err = max_rel(port[dtype]["forced"][0], jax_res[dtype]["logits"])
    assert err < bound, (dtype, err)


def check_greedy(port):
    _, sharded, _ = port["float32"]["free_sharded"]
    _, local, _ = port["float32"]["free_local"]
    assert torch.equal(sharded, local)


def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def check_caches(jax_res, port):
    """Final caches: the port's sharded decode, unsharded, against its
    unsharded decode (free runs) and against JAX's (forced run)."""
    pairs = [(port["float32"]["free_sharded"][2], port["float32"]["free_local"][2]),
             (port["float32"]["forced"][2],
              bridge.states_from_numpy(jax_res["float32"]["final"], device="cpu"))]
    for got, want in pairs:
        paths = tree_paths(want)
        for path, a, b in zip(paths, tree_leaves(got), tree_leaves(want)):
            assert a.shape == b.shape, path
            if a.is_floating_point():
                assert float((a.float() - b.float()).abs().max()) <= 1e-4, path
            else:
                assert torch.equal(a, b), path


# --------------------------------------------------------------------------
# case 1: head-sharded
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def head(tmp_path_factory):
    jax_res = run_child("head_sharded", tmp_path_factory)
    return jax_res, port_runs("head_sharded", jax_res)


def test_head_sharded_f32_logits_match_jax(head):
    check_logits(*head, "float32", 1e-4)


def test_head_sharded_bf16_logits_within_jax_bound(head):
    check_logits(*head, "bfloat16", 3e-2)


def test_head_sharded_greedy_equals_unsharded(head):
    check_greedy(head[1])


def test_head_sharded_caches(head):
    check_caches(*head)


def test_head_sharded_cache_layout(head):
    cfg, ep2d = port_cfg("head_sharded", "float32")
    cache = T.init_cache(cfg, B, CAP, "cpu")
    sc = place_cache(cfg, cache, mesh_ctx(cfg, ep2d))
    k = sc["segments"][0]["k"]
    assert tuple(k.spec) == (None, "data", "model", None, None)
    assert tuple(k.local((1, 3)).shape) == (cfg.n_layers, B // 2, 1, CAP, cfg.head_dim)
    assert len({k.local(c).data_ptr() for c in k.coords()}) == 8
    sp = sc["segments"][0]["slot_pos"]
    assert len({sp.local(c).data_ptr() for c in sp.coords()}) == 2  # one a data member
    assert json.dumps(tuple(sc["pos"].spec)) == '["data"]'
