"""The port's sharded paged MLA engine against the JAX package's paged
engine on the same mesh: reduced f32 deepseek-v3 served through
``lm_engine_parts(cfg, ServeConfig(paged=True, ...), ctx)`` with
``make_ctx(mesh, ..., decode_shardmap=True)``, its latent pools laid out
by ``cache_pspecs`` (JAX's GSPMD runs K6 over them; the port runs K6's
partials a member), on the stream of
``test_torch_serving_sharded_paged.SCENARIO``, without the MoE layers
(3 MLA layers with dense MLPs):

  (1, 2)  each page's lanes over model ("lanes");
  (2, 2)  pages over data, lanes over model ("pages").  JAX's MoE prefill
          fails on a data axis of 2 with a batch of 1, so the MoE layers
          are left out on these meshes;

and with its MoE layers on (1, 4) in
``test_torch_serving_sharded_paged_mla_moe_jax.py`` (experts over model,
"lanes").  JAX's engine runs in a child on 8 forced host devices, on
meshes with ``AxisType.Auto`` axes; the child hands its weights back and
the port's engine starts from them, laid out by ``param_pspecs``.
Tokens, statuses, faults, ledger totals and recent steps, the page
tables, free pages and page faults must be equal, on one strike a mesh
(the DMR request's replica slot, or the TMR request's)."""

import pickle

import pytest

from repro_torch import bridge
from repro_torch.models.lm_cells import place_params
from repro_torch.testing import cap_threads_for_xdist
from test_torch_serving_sharded_paged import SERVE
from test_torch_serving_sharded_paged_jax import JAX_FIELDS, run_child
from test_torch_serving_sharded_paged_mla import CFG, FULL, mesh_ctx, run

cap_threads_for_xdist()

#: name -> (mesh, with the MoE layers, strike)
CASES = {"1x2": ((1, 2), False, "r4"), "2x2": ((2, 2), False, "r6")}

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
from repro.models.lm_cells import ServeConfig
from repro.serving import Request
from repro.serving.lm import lm_engine_parts


def leaf_of(state, key):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return next(i for i, (path, _) in enumerate(flat)
                if any(getattr(p, "key", None) == key for p in path))


def host(x):
    return np.asarray(x).tolist()


FULL = dataclasses.replace(get_reduced("deepseek-v3-671b"), dtype="float32")
"""

_BODY = r"""
out = {}
for name, (shape, moe, strike) in CASES.items():
    cfg = FULL if moe else dataclasses.replace(FULL, mixer_type="mlp", moe=None, n_layers=3)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, decode_shardmap=True)
    eng = miso.serve(*lm_engine_parts(cfg, ServeConfig(**SERVE), ctx))
    eng.start(jax.random.PRNGKey(0))
    with open(os.path.join(os.environ["CHILD_OUT"], f"weights_{name}.pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, eng._states["weights"]), f)
    out[name] = scenario(eng, miso, Request, leaf_of, host, cfg.vocab_size, strike)
print("RESULT" + json.dumps(out))
"""


def jax_and_port_runs(tmp, cases) -> tuple[dict, dict]:
    """Each case of ``cases`` served by JAX's engine (one child) and by
    the port's from JAX's weights: (JAX's records, the port's)."""
    jax_runs = run_child(_BODY, tmp, head=_HEAD, CASES=cases, SERVE=SERVE)
    port = {}
    for name, (shape, moe, strike) in cases.items():
        cfg = FULL if moe else CFG
        with open(tmp / f"weights_{name}.pkl", "rb") as f:
            w = pickle.load(f)

        def weights(ctx, w=w, cfg=cfg):
            return {"params": place_params(cfg, bridge.states_from_numpy(w["params"], "cpu"),
                                           ctx)}

        port[name] = run(mesh_ctx(shape, cfg), strike, cfg=cfg, weights=weights)
    return jax_runs, port


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    return jax_and_port_runs(tmp_path_factory.mktemp("paged_mla_jax"), CASES)


@pytest.mark.parametrize("field", JAX_FIELDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_paged_mla_engine_equals_jax_on_the_mesh(jax_and_port, case, field):
    jax_runs, port = jax_and_port
    assert port[case][field] == jax_runs[case][field]


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_sharded_paged_mla_engine_ran_the_scenario(jax_and_port, case):
    got = jax_and_port[0][case]
    assert all(s == "done" for s in got["status"])
    assert got["request_faults"] == {CASES[case][2]: 1} and got["page_faults"] > 0
    assert len(got["pages"]) == 2
