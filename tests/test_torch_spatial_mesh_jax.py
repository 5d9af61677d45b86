"""Spatial placement under a mesh with ``make_spatial_ctx``: reduced f32
internlm2-1.8b served by ``lm_engine_parts(cfg, ServeConfig(placement=
"spatial"), make_spatial_ctx(mesh, ...))`` on a (2, 2, 2) ``("pod",
"data", "model")`` mesh, against the JAX package's spatial engine on the
same mesh (a child on 8 forced host devices, ``AxisType.Auto`` axes).

The pod axis carries the replica slots (a DMR request's two slots at one
column, one a pod); inside a pod the weights and the cache are
replicated over the data and model members, as the JAX package's
spatial executor places them.  On a staggered none/DMR stream with a bit
flip into replica slot 1 (pod 1) of a DMR request, tokens, statuses,
faults, ledger totals and recent steps and slot placement must equal
JAX's, which must equal its own temporal engine's tokens.  Under
``make_ctx``'s ctx, and with ``decode_shardmap=True``, the port raises
``NotImplementedError``; the child shows the JAX package raises there
too."""

import dataclasses
import json

import pytest
import torch

from repro_torch import api as miso
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.distributed import make_mesh
from repro_torch.launch.mesh import make_ctx, make_spatial_ctx
from repro_torch.models.lm_cells import ServeConfig, make_slot_serve_program
from repro_torch.serving import Request
from repro_torch.serving.lm import lm_engine_parts
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import leaf_index
from test_torch_serving_sharded_paged_jax import run_child

cap_threads_for_xdist()

CFG = dataclasses.replace(get_reduced("internlm2-1.8b"), dtype="float32")
SHAPE, AXES = (2, 2, 2), ("pod", "data", "model")
SERVE = dict(batch=8, max_len=64, placement="spatial")

#: the stream, run by both packages' engines with their own ``miso``,
#: ``Request``, ``leaf_of`` (a leaf's flat index) and ``host``
SCENARIO = r'''
import numpy as np

PROMPT_LENS = (5, 9, 3, 12, 7, 4)
LEVELS = (1, 2, 1, 2, 1, 2)
STRIKE = "s3"


def spatial_scenario(eng, miso, Request, leaf_of, host, vocab, dec0):
    """Three requests, two ticks, the other three; then a bit flip into
    replica slot 1 (pod 1) of request ``STRIKE`` once it is resident.
    ``dec0``: a decoder state of the engine's width (the fault's leaf)."""
    ps = [np.random.default_rng(i).integers(0, vocab, size=k).astype(np.int32)
          for i, k in enumerate(PROMPT_LENS)]
    pol = lambda lv: miso.RedundancyPolicy(level=lv, placement="spatial" if lv > 1 else "temporal")
    reqs = [Request(prompt=p, max_new_tokens=8, policy=pol(lv), id=f"s{i}")
            for i, (p, lv) in enumerate(zip(ps, LEVELS))]
    for r in reqs[:3]:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    for r in reqs[3:]:
        assert eng.submit(r)
    rec = eng.requests[STRIKE]
    while rec.status != "running":
        eng.pump(max_ticks=1)
    fault = miso.FaultSpec.at(step=eng.exe.metrics()["steps"] + 1,
                              cell_id=eng.exe.program.cell_id("decoder"),
                              leaf=leaf_of(dec0, "tokens"), index=rec.slots[1], bit=4)
    eng.pump(faults=fault)
    m = eng.metrics()
    res = [eng.result(r.id) for r in reqs]
    out = {"tokens": [list(x["tokens"]) for x in res], "status": [x["status"] for x in res],
           "faults": [x["faults"] for x in res], "slots": [list(x["slots"]) for x in res],
           "totals": [eng.ledger.totals.get(r.id) for r in reqs],
           "recent": [eng.ledger.recent.get(r.id) for r in reqs],
           "request_faults": m["request_faults"], "placement": m["placement"],
           "pods": m["pods"]}
    return json.loads(json.dumps(out, default=float))
'''

_ns: dict = {"json": json}
exec(SCENARIO, _ns)
spatial_scenario = _ns["spatial_scenario"]

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
from repro.launch.mesh import make_ctx, make_spatial_ctx
from repro.models.lm_cells import ServeConfig, slot_decoder_init
from repro.serving import Request
from repro.serving.lm import lm_engine_parts


def leaf_of(state, key):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return next(i for i, (path, _) in enumerate(flat)
                if any(getattr(p, "key", None) == key for p in path))


def host(x):
    return np.asarray(x).tolist()


CFG = dataclasses.replace(get_reduced("internlm2-1.8b"), dtype="float32")
mesh = jax.make_mesh(SHAPE, AXES, axis_types=(AxisType.Auto,) * 3)
kw = dict(vocab_size=CFG.vocab_size, d_model=CFG.d_model)
"""

_BODY = SCENARIO + r"""
dec0 = jax.eval_shape(lambda: slot_decoder_init(CFG, SERVE["batch"], SERVE["max_len"]))
out = {}
eng = miso.serve(*lm_engine_parts(CFG, ServeConfig(**SERVE), make_spatial_ctx(mesh, **kw)),
                 miso.EngineConfig(placement="spatial", mesh=mesh))
eng.start(jax.random.PRNGKey(0))
with open(os.path.join(os.environ["CHILD_OUT"], "states.pkl"), "wb") as f:
    pickle.dump(jax.tree.map(np.asarray, eng._states), f)
out["spatial"] = spatial_scenario(eng, miso, Request, leaf_of, host, CFG.vocab_size, dec0)
temporal = dict(SERVE, placement="temporal")
eng = miso.serve(*lm_engine_parts(CFG, ServeConfig(**temporal)))
eng.start(jax.random.PRNGKey(0))
out["temporal"] = spatial_scenario(eng, miso, Request, leaf_of, host, CFG.vocab_size, dec0)
out["raises"] = {}
for name, ctx in (("make_ctx", make_ctx(mesh, **kw)),
                  ("decode_shardmap", make_spatial_ctx(mesh, decode_shardmap=True, **kw))):
    try:
        e2 = miso.serve(*lm_engine_parts(CFG, ServeConfig(**SERVE), ctx),
                        miso.EngineConfig(placement="spatial", mesh=mesh))
        e2.start(jax.random.PRNGKey(0))
        assert e2.submit(Request(prompt=np.arange(5, dtype=np.int32), max_new_tokens=2))
        e2.pump()
        out["raises"][name] = None
    except Exception as e:
        out["raises"][name] = type(e).__name__
print("RESULT" + json.dumps(out))
"""


def mesh():
    return make_mesh(SHAPE, AXES, devices=["cpu"] * 8)


def kw():
    return dict(vocab_size=CFG.vocab_size, d_model=CFG.d_model)


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    import pickle

    tmp = tmp_path_factory.mktemp("spatial_mesh_jax")
    jax_runs = run_child(_BODY, tmp, head=_HEAD, SHAPE=SHAPE, AXES=AXES, SERVE=SERVE)
    with open(tmp / "states.pkl", "rb") as f:
        states = bridge.states_from_numpy(pickle.load(f), device="cpu")
    m = mesh()
    prog, adapter = lm_engine_parts(CFG, ServeConfig(**SERVE), make_spatial_ctx(m, **kw()),
                                    device="cpu")
    eng = miso.serve(prog, adapter, miso.EngineConfig(placement="spatial", mesh=m), device="cpu")
    eng.start(states=states)
    from repro_torch.models.lm_cells import slot_decoder_init

    dec0 = slot_decoder_init(CFG, SERVE["batch"], SERVE["max_len"], "meta")
    port = spatial_scenario(eng, miso, Request, leaf_index, lambda x: x.tolist(),
                            CFG.vocab_size, dec0)
    return jax_runs, {**port, "backend": eng.metrics()["backend"]}


FIELDS = ("tokens", "status", "faults", "slots", "totals", "recent", "request_faults",
          "placement", "pods")


@pytest.mark.parametrize("field", FIELDS)
def test_spatial_under_make_spatial_ctx_equals_jax(jax_and_port, field):
    jax_runs, port = jax_and_port
    assert port[field] == jax_runs["spatial"][field]


def test_spatial_run_is_the_scenario(jax_and_port):
    jax_runs, port = jax_and_port
    assert all(s == "done" for s in port["status"])
    assert port["request_faults"] == {"s3": 1} and port["totals"][3]["per_replica"][1] == 1.0
    assert (port["placement"], port["pods"], port["backend"]) == ("spatial", 2,
                                                                  "spatial_lockstep")
    assert jax_runs["spatial"]["tokens"] == jax_runs["temporal"]["tokens"]
    slots = port["slots"][3]
    assert [s // 4 for s in slots] == [0, 1] and slots[0] % 4 == slots[1] % 4  # one column


def test_program_state_is_replicated_inside_a_pod():
    """Under ``make_spatial_ctx`` no leaf is laid out by the mesh: the
    weights and the cache are whole tensors, the spatial executor's pods
    split only the slot columns."""
    from repro_torch.distributed.sharding import Sharded
    from repro_torch.tree import tree_leaves

    prog = make_slot_serve_program(CFG, ServeConfig(**SERVE), make_spatial_ctx(mesh(), **kw()))
    states = prog.init_states(torch.Generator().manual_seed(0), "cpu")
    assert not any(isinstance(x, Sharded) for x in tree_leaves(states))
    assert prog.spatial_serve["n_slots"] == SERVE["batch"]


@pytest.mark.parametrize("case", ["make_ctx", "decode_shardmap"])
def test_other_ctxs_still_raise_as_jax_does(jax_and_port, case):
    ctx = (make_ctx(mesh(), **kw()) if case == "make_ctx"
           else make_spatial_ctx(mesh(), decode_shardmap=True, **kw()))
    with pytest.raises(NotImplementedError, match="make_spatial_ctx") as e:
        make_slot_serve_program(CFG, ServeConfig(**SERVE), ctx)
    assert "JAX package raises there too" in str(e.value)
    assert jax_and_port[0]["raises"][case] is not None  # the JAX package raises as well
