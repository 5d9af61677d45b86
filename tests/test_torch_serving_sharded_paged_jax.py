"""The port's sharded paged engine against the JAX package's paged engine
on the same mesh: reduced f32 internlm2 (4 query / 2 kv heads) served on
a (2, 4) data x model mesh, pages over data and each page's lanes over
model, through ``lm_engine_parts(cfg, scfg, ctx)`` with ``make_ctx(mesh,
..., decode_shardmap=True)``, on the stream of
``test_torch_serving_sharded_paged.SCENARIO`` (its strikes on a DMR and
a TMR replica slot, its page budget).

JAX's engine runs in a child on 8 forced host devices, on a mesh with
``AxisType.Auto`` axes (under the installed jax, ``jax.make_mesh`` alone
gives Explicit axes, which the reference's sharded serving does not run
on); the child hands its weights back, and the port's engine starts from
them, laid out by ``param_pspecs``.  Tokens, statuses, faults, ledger
totals and recent steps, the page tables, free pages and page faults
must be equal."""

import json
import os
import pathlib
import pickle
import subprocess
import sys

import pytest

from repro_torch import bridge
from repro_torch.models.lm_cells import place_params
from repro_torch.testing import cap_threads_for_xdist
from test_torch_serving_sharded_paged import (CFG, FIELDS, SCENARIO, SERVE, STRIKES, mesh_ctx,
                                              run)

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = (2, 4)

_HEAD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses, json, pickle
import jax
import numpy as np
from jax.sharding import AxisType

from repro import api as miso
from repro.configs import get_reduced
from repro.launch.mesh import make_ctx
from repro.models.lm_cells import ServeConfig, SpecConfig
from repro.serving import Request
from repro.serving.lm import lm_engine_parts


def leaf_of(state, key):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return next(i for i, (path, _) in enumerate(flat)
                if any(getattr(p, "key", None) == key for p in path))


def host(x):
    return np.asarray(x).tolist()


CFG = dataclasses.replace(get_reduced("internlm2-1.8b"), dtype="float32")
mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
ctx = make_ctx(mesh, vocab_size=CFG.vocab_size, d_model=CFG.d_model, decode_shardmap=True)


def engine(**serve):
    eng = miso.serve(*lm_engine_parts(CFG, ServeConfig(**serve), ctx))
    eng.start(jax.random.PRNGKey(0))
    return eng
"""


def run_child(body: str, out_dir: pathlib.Path, head: str = _HEAD, **consts) -> dict:
    """Run the JAX child (``head``, ``SCENARIO``, then ``body``) with
    ``consts`` bound, its pickles written into ``out_dir``; returns its
    ``RESULT`` line."""
    bound = "".join(f"{k} = {v!r}\n" for k, v in consts.items())
    src = bound + head + SCENARIO + body
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CHILD_OUT=str(out_dir))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", src], env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


_BODY = r"""
out = {}
for strike in STRIKES:
    eng = engine(**SERVE)
    if strike == STRIKES[0]:
        with open(os.path.join(os.environ["CHILD_OUT"], "weights.pkl"), "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, eng._states["weights"]), f)
    out[strike] = scenario(eng, miso, Request, leaf_of, host, CFG.vocab_size, strike)
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paged_jax")
    jax_runs = run_child(_BODY, tmp, MESH=MESH, SERVE=SERVE, STRIKES=STRIKES)
    with open(tmp / "weights.pkl", "rb") as f:
        w = pickle.load(f)

    def weights(ctx):
        return {"params": place_params(CFG, bridge.states_from_numpy(w["params"], "cpu"), ctx)}

    port = {s: run(mesh_ctx(MESH), s, weights=weights) for s in STRIKES}
    return jax_runs, port


#: the fields JAX's engine reports too (not the port's replay and page-wait counters)
JAX_FIELDS = [f for f in FIELDS if f not in ("replays", "page_waits")]


@pytest.mark.parametrize("field", JAX_FIELDS)
@pytest.mark.parametrize("strike", STRIKES)
def test_sharded_paged_engine_equals_jax_on_the_mesh(jax_and_port, strike, field):
    jax_runs, port = jax_and_port
    assert port[strike][field] == jax_runs[strike][field]


def test_jax_sharded_paged_engine_ran_the_scenario(jax_and_port):
    jax_runs, _ = jax_and_port
    for strike in STRIKES:
        got = jax_runs[strike]
        assert all(s == "done" for s in got["status"])
        assert got["request_faults"] == {strike: 1} and got["page_faults"] > 0
        assert len(got["pages"]) == 2
