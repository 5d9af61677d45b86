"""The port's spatial engine against the JAX package's *spatial* engine,
on the scenario of ``tests/test_serving_spatial.py``: the toy slotted
decoder (power-of-two float math, exact), 8 slots on a (4, 2) pod x data
mesh, a none/DMR/TMR/none stream, and a bit flip into ``slots[1]`` (pod
1's member) of the DMR or the TMR request mid-decode.

JAX's engine runs in a child on 8 forced host devices.  The reference
test builds its mesh with ``jax.make_mesh`` alone, which under the
installed jax has Explicit axes that its spatial engine does not run on;
the child asks for ``AxisType.Auto``, as the reference's own launcher
does (``src/repro/launch/mesh.py``).  The port runs the same toy program
with its own API on ``["cpu"] * 8``.  Every field must be equal: tokens,
statuses, faults, ledger totals and recent steps, slot placement, the
placement, ``pods`` and ``slots_per_pod``."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import api as miso
from repro_torch.distributed import make_mesh
from repro_torch.serving import Request, SlotAdapter, infer_slot_axes, mask_slots
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import leaf_index

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLOTS, PODS = 8, 4
STRIKES = {"none": 0, "dmr": 2, "tmr": 3}

_CHILD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import json
import jax, jax.numpy as jnp
from jax.sharding import AxisType

from repro import api as miso
from repro.serving import Request, SlotAdapter, infer_slot_axes, mask_slots

SLOTS, PODS = 8, 4


def toy_init(b):
    return {"x": jnp.zeros((b,), jnp.float32), "tokens": jnp.zeros((b, 1), jnp.int32),
            "active": jnp.zeros((b,), jnp.bool_), "pos": jnp.zeros((b,), jnp.int32)}


axes = infer_slot_axes(toy_init)


def parts():
    def d_transition(prev):
        st = prev["dec"]
        act = st["active"]
        x = st["x"] * prev["w"]["m"] + st["pos"].astype(jnp.float32)
        tok = (jnp.abs(x) * 64.0).astype(jnp.int32) % 1009
        new = {"x": x, "tokens": tok[:, None], "active": act, "pos": st["pos"] + 1}
        return mask_slots(act, new, st, axes)

    prog = miso.MisoProgram()
    prog.add(miso.CellType("w", lambda k: {"m": jnp.float32(1.0) + jnp.float32(2.0) ** -3},
                           lambda prev: prev["w"]))
    prog.add(miso.CellType("dec", lambda k: toy_init(SLOTS), d_transition, reads=("w",),
                           instances=SLOTS))
    prog.spatial_serve = {"cell": "dec", "axes": axes, "n_slots": SLOTS}

    def prefill(req, states):
        p = jnp.asarray(req.prompt, jnp.float32)
        x0 = jnp.sum(p) * jnp.float32(2.0) ** -6
        tok0 = (jnp.abs(x0) * 64.0).astype(jnp.int32) % 1009
        return ({"x": x0[None], "tokens": tok0[None, None], "active": jnp.ones((1,), jnp.bool_),
                 "pos": jnp.full((1,), p.shape[0], jnp.int32)}, tok0[None, None])

    return prog, SlotAdapter(cell="dec", n_slots=SLOTS, slot_axes=axes, prefill=prefill,
                             read_tokens=lambda dec: dec["tokens"],
                             make_empty=lambda: toy_init(1))


def drive(strike_level):
    mesh = jax.make_mesh((PODS, 8 // PODS), ("pod", "data"), axis_types=(AxisType.Auto,) * 2)
    prog, adapter = parts()
    eng = miso.serve(prog, adapter, miso.EngineConfig(placement="spatial", mesh=mesh))
    eng.start(jax.random.PRNGKey(0))
    pol = lambda lv: miso.RedundancyPolicy(level=lv, placement="spatial" if lv > 1 else "temporal")
    reqs = [Request(prompt=[3.0, 1.0], max_new_tokens=8, policy=pol(1)),
            Request(prompt=[4.0, 1.0], max_new_tokens=8, policy=pol(2)),
            Request(prompt=[2.0, 7.0], max_new_tokens=8, policy=pol(3)),
            Request(prompt=[5.0], max_new_tokens=8, policy=pol(1))]
    for r in reqs:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    fault = None
    if strike_level:
        rec = eng.requests[(reqs[1] if strike_level == 2 else reqs[2]).id]
        flat, _ = jax.tree_util.tree_flatten_with_path(toy_init(SLOTS))
        leaf = next(i for i, (p, _) in enumerate(flat)
                    if any(getattr(q, "key", None) == "x" for q in p))
        fault = miso.FaultSpec.at(step=eng.exe.metrics()["steps"] + 1, cell_id=prog.cell_id("dec"),
                                  leaf=leaf, index=rec.slots[1], bit=20)
    eng.pump(faults=fault)
    m = eng.metrics()
    return {"tokens": [eng.result(r.id)["tokens"] for r in reqs],
            "status": [eng.result(r.id)["status"] for r in reqs],
            "faults": [eng.result(r.id)["faults"] for r in reqs],
            "totals": [eng.ledger.totals.get(r.id) for r in reqs],
            "recent": [eng.ledger.recent.get(r.id) for r in reqs],
            "slots": [eng.result(r.id)["slots"] for r in reqs],
            "placement": m["placement"], "pods": m["pods"],
            "slots_per_pod": eng.exe.metrics().get("slots_per_pod")}


print("RESULT" + json.dumps({tag: drive(lv) for tag, lv in
                             (("none", 0), ("dmr", 2), ("tmr", 3))}))
"""


def toy_init(b, device="cpu"):
    return {"x": torch.zeros((b,), dtype=torch.float32, device=device),
            "tokens": torch.zeros((b, 1), dtype=torch.int32, device=device),
            "active": torch.zeros((b,), dtype=torch.bool, device=device),
            "pos": torch.zeros((b,), dtype=torch.int32, device=device)}


AXES = infer_slot_axes(lambda b: toy_init(b, "meta"))


def parts():
    def d_transition(prev):
        st = prev["dec"]
        act = st["active"]
        x = st["x"] * prev["w"]["m"] + st["pos"].to(torch.float32)
        tok = (x.abs() * 64.0).to(torch.int32) % 1009
        new = {"x": x, "tokens": tok[:, None], "active": act, "pos": st["pos"] + 1}
        return mask_slots(act, new, st, AXES)

    prog = miso.MisoProgram()
    prog.add(miso.CellType("w", lambda g, d: {"m": torch.tensor(1.0 + 2.0**-3, device=d)},
                           lambda prev: prev["w"]))
    prog.add(miso.CellType("dec", lambda g, d: toy_init(SLOTS, d), d_transition, reads=("w",),
                           instances=SLOTS))
    prog.spatial_serve = {"cell": "dec", "axes": AXES, "n_slots": SLOTS}

    def prefill(req, states):
        p = torch.tensor(req.prompt, dtype=torch.float32)
        x0 = p.sum() * 2.0**-6
        tok0 = (x0.abs() * 64.0).to(torch.int32) % 1009
        return ({"x": x0[None], "tokens": tok0[None, None],
                 "active": torch.ones((1,), dtype=torch.bool),
                 "pos": torch.full((1,), p.shape[0], dtype=torch.int32)}, tok0[None, None], 0)

    return prog, SlotAdapter(cell="dec", n_slots=SLOTS, slot_axes=AXES, prefill=prefill,
                             read_tokens=lambda dec: dec["tokens"],
                             make_empty=lambda: toy_init(1))


def drive(strike_level):
    mesh = make_mesh((PODS, 8 // PODS), ("pod", "data"), devices=["cpu"] * 8)
    prog, adapter = parts()
    eng = miso.serve(prog, adapter, miso.EngineConfig(placement="spatial", mesh=mesh),
                     device="cpu")
    eng.start(0)

    def pol(lv):
        return miso.RedundancyPolicy(level=lv, placement="spatial" if lv > 1 else "temporal")

    reqs = [Request(prompt=[3.0, 1.0], max_new_tokens=8, policy=pol(1)),
            Request(prompt=[4.0, 1.0], max_new_tokens=8, policy=pol(2)),
            Request(prompt=[2.0, 7.0], max_new_tokens=8, policy=pol(3)),
            Request(prompt=[5.0], max_new_tokens=8, policy=pol(1))]
    for r in reqs:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    fault = None
    if strike_level:
        rec = eng.requests[(reqs[1] if strike_level == 2 else reqs[2]).id]
        fault = miso.FaultSpec.at(step=eng.exe.metrics()["steps"] + 1, cell_id=prog.cell_id("dec"),
                                  leaf=leaf_index(toy_init(SLOTS), "x"), index=rec.slots[1],
                                  bit=20)
    eng.pump(faults=fault)
    m = eng.metrics()
    out = {"tokens": [eng.result(r.id)["tokens"] for r in reqs],
           "status": [eng.result(r.id)["status"] for r in reqs],
           "faults": [eng.result(r.id)["faults"] for r in reqs],
           "totals": [eng.ledger.totals.get(r.id) for r in reqs],
           "recent": [eng.ledger.recent.get(r.id) for r in reqs],
           "slots": [eng.result(r.id)["slots"] for r in reqs],
           "placement": m["placement"], "pods": m["pods"],
           "slots_per_pod": eng.exe.metrics().get("slots_per_pod")}
    return json.loads(json.dumps(out))  # JSON's view, as the child's


@pytest.fixture(scope="module")
def jax_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


FIELDS = ["tokens", "status", "faults", "totals", "recent", "slots", "placement", "pods",
          "slots_per_pod"]


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("tag", sorted(STRIKES))
def test_spatial_engine_equals_jax_spatial_engine(jax_runs, tag, field):
    got = drive(STRIKES[tag])
    assert got[field] == jax_runs[tag][field]


def test_jax_spatial_engine_ran_the_scenario(jax_runs):
    assert jax_runs["none"]["placement"] == "spatial" and jax_runs["none"]["pods"] == PODS
    assert jax_runs["dmr"]["faults"][1] == 1 and jax_runs["tmr"]["faults"][2] == 1
    assert all(s == "done" for run in jax_runs.values() for s in run["status"])
