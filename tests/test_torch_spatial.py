"""``spatial_lockstep`` against the JAX package's spatial back-end.

JAX's runs the parity programs of ``tests/test_spatial.py`` on meshes of
8 forced host devices, in a subprocess shared by this file; the child
saves the initial states, the final states, the summed reports, the
ledgers, the campaign, the strike reports and the straggler run.  The
port runs the same programs from the same initial states on ``["cpu"] *
n`` meshes, and must equal JAX's bitwise, states, reports and ledgers,
and equal its own ``lockstep`` in process: DMR and TMR, hash and
bitwise, with and without a strike; ``compare_every=4``; a temporal DMR
cell pair-reading a spatial one; ``run_campaign``; and ``ft.elastic``'s
straggler run and strike reports.  (The error paths, ``auto`` and the
placement run in ``test_torch_spatial_auto.py``.)"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api as miso
from repro_torch.core.fault import bitcast_int
from repro_torch.distributed import make_mesh
from repro_torch.ft import elastic
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh

from repro import api as miso
from repro.ft import elastic

sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
exec(compile(open(os.path.join(sys.argv[2], "tests", "test_torch_spatial.py")).read()
             .split("# ---- " + "programs ----")[1], "programs", "exec"), globals())

arrays, meta = {}, {}


def mesh_for(level):
    if level == 2:
        return jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    return Mesh(np.array(jax.devices()[:6]).reshape(3, 2, 1), ("pod", "data", "model"))


def keep(tag, tree):
    for i, x in enumerate(jax.tree.leaves(tree)):
        arrays[f"{tag}/{i}"] = np.asarray(x)


def ledger(exe):
    return {"totals": exe.ledger.totals,
            "recent": {k: [int(s) for s in v] for k, v in exe.ledger.recent.items()}}


def run_case(tag, prog, level, steps, faults=None, **kw):
    spa = miso.compile(prog, backend="spatial_lockstep", mesh=mesh_for(level), donate=False, **kw)
    s0 = spa.init(jax.random.PRNGKey(0))
    keep(f"{tag}/init", s0)
    res = spa.run(s0, steps, start_step=0, faults=faults)
    keep(f"{tag}/states", res.states)
    keep(f"{tag}/reports", res.reports)
    meta[tag] = ledger(spa)
    return spa, s0


for case in CASES:
    tag, prog, level, steps, fault, kw = case_args(miso, jnp, case)
    run_case(tag, prog, level, steps, fault, **kw)

# run_campaign and the strike reports
prog = replicated_program(miso, jnp, 2, "hash")
spa = miso.compile(prog, backend="spatial_lockstep", mesh=mesh_for(2), donate=False)
s0 = spa.init(jax.random.PRNGKey(0))
keep("campaign/init", s0)
faults = [miso.FaultSpec.at(**f) for f in CAMPAIGN]
camp = spa.run_campaign(s0, 6, faults, start_step=0)
keep("campaign/states", camp.states)
keep("campaign/reports", camp.reports)
meta["strike_report"] = elastic.spatial_strike_report(spa, s0, 6, faults, start_step=0)
spa3 = miso.compile(replicated_program(miso, jnp, 3, "hash"), backend="spatial_lockstep",
                    mesh=mesh_for(3), donate=False)
s3 = spa3.init(jax.random.PRNGKey(0))
keep("strike_tmr/init", s3)
meta["strike_report_tmr"] = elastic.spatial_strike_report(
    spa3, s3, 6, [miso.FaultSpec.at(**TMR_STRIKE)], start_step=0)

# the straggler run
spa = miso.compile(prog, backend="spatial_lockstep", mesh=mesh_for(2), donate=False)
final, stats, log = elastic.run_with_straggler_policy(
    spa, spa.init(jax.random.PRNGKey(0)), 4, elastic.StragglerPolicy(mode="first_wins", slack=1.5),
    STRAGGLER_TIMES, faults=miso.FaultSpec.at(**STRAGGLER_STRIKE), start_step=0)
keep("straggler/states", final)
meta["straggler"] = {"stats": [stats.adopted_fast, stats.waited, stats.compare_deficit],
                     "kinds": [[e["step"], e["kind"], e["detail"]] for e in log.events],
                     "ledger": ledger(spa)}
np.savez(sys.argv[1] + ".npz", **arrays)
open(sys.argv[1] + ".json", "w").write(json.dumps(meta))
"""

# ---- programs ----
# (shared with the JAX child above, which executes this part of the file
# with its own ``miso`` and ``jnp``; here they are the port's)


def replicated_program(miso, np_, level, compare, placement="spatial"):
    """tests/test_spatial.py's parity program: powers-of-two constants, so
    the float math is exact; the unreplicated reader "b" takes the
    canonical (replica-0) view of "a"."""
    p = miso.MisoProgram()
    p.add(miso.CellType(
        "a", lambda *_: {"x": np_.linspace(0.0, 1.0, 8, dtype=np_.float32)},
        lambda prev: {"x": prev["a"]["x"] * 0.5 + np_.roll(prev["a"]["x"], 1) * 0.25},
        redundancy=miso.RedundancyPolicy(level=level, compare=compare, placement=placement)))
    p.add(miso.CellType(
        "b", lambda *_: {"x": np_.ones((8,), np_.float32)},
        lambda prev: {"x": prev["b"]["x"] * 0.5 + prev["a"]["x"] * 2.0},
        reads=("a",)))
    return p


def mixed_program(miso, np_):
    """A temporal DMR cell pair-reading a spatial DMR cell."""
    p = miso.MisoProgram()
    p.add(miso.CellType(
        "a", lambda *_: {"x": np_.linspace(0.0, 1.0, 8, dtype=np_.float32)},
        lambda prev: {"x": prev["a"]["x"] * 0.5 + np_.roll(prev["a"]["x"], 1) * 0.25},
        redundancy=miso.RedundancyPolicy(level=2, placement="spatial")))
    p.add(miso.CellType(
        "t", lambda *_: {"x": np_.ones((8,), np_.float32)},
        lambda prev: {"x": prev["t"]["x"] * 0.5 + prev["a"]["x"] * 0.25},
        reads=("a",), redundancy=miso.RedundancyPolicy(level=2, placement="temporal")))
    return p


STRIKE = dict(step=2, cell_id=0, replica=1, index=3, bit=21)
CASES = (
    [(f"l{lv}_{cmp}_{tag}", lv, cmp, 6, STRIKE if tag == "fault" else None, {})
     for lv in (2, 3) for cmp in ("bitwise", "hash") for tag in ("nofault", "fault")]
    + [(f"every4_l{lv}", lv, "hash", 8, None, {"compare_every": 4}) for lv in (2, 3)]
    + [("every4_midwindow", 3, "hash", 8, dict(step=1, cell_id=0, replica=0, index=3, bit=21),
        {"compare_every": 4}),
       ("mixed", 2, "mixed", 5, dict(step=1, cell_id=0, replica=1, index=2, bit=20), {})]
)
CAMPAIGN = [dict(step=s, cell_id=0, replica=r, index=3, bit=21) for s, r in ((1, 0), (3, 1), (9, 1))]
TMR_STRIKE = dict(step=2, cell_id=0, replica=2, index=1, bit=19)
STRAGGLER_TIMES = [(1.0, 1.0), (1.0, 4.0), (1.0, 1.0), (1.0, 1.0)]
STRAGGLER_STRIKE = dict(step=1, cell_id=0, replica=1, index=3, bit=21)


def case_args(miso, np_, case):
    tag, level, compare, steps, fault, kw = case
    prog = (mixed_program(miso, np_) if compare == "mixed"
            else replicated_program(miso, np_, level, compare))
    return tag, prog, level, steps, (miso.FaultSpec.at(**fault) if fault else None), kw
# ---- programs ----


class _TorchNp:
    """The few ``jnp`` names the shared programs use, in torch."""

    float32 = torch.float32

    @staticmethod
    def ones(shape, dtype):
        return torch.ones(shape, dtype=dtype)

    @staticmethod
    def linspace(a, b, n, dtype):
        return torch.linspace(a, b, n, dtype=dtype)

    @staticmethod
    def roll(x, k):
        return torch.roll(x, k)


TNP = _TorchNp()


@pytest.fixture(scope="module")
def jax_spatial(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("spatial") / "out")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _CHILD, base, str(ROOT)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    arrays = np.load(base + ".npz")
    meta = json.loads(pathlib.Path(base + ".json").read_text())
    return {k: arrays[k] for k in arrays.files}, meta


def leaves_of(arrays, tag) -> list:
    n = sum(1 for k in arrays if k.startswith(tag + "/"))
    return [torch.from_numpy(np.array(arrays[f"{tag}/{i}"], copy=True)) for i in range(n)]


def same_bits(xs, ys) -> bool:
    xs, ys = list(xs), list(ys)
    return len(xs) == len(ys) and all(
        x.shape == y.shape and torch.equal(bitcast_int(x), bitcast_int(y)) for x, y in zip(xs, ys))


def init_states(prog, arrays, tag):
    """The JAX child's initial (lockstep-layout) states as port tensors."""
    exe = miso.compile(prog, backend="lockstep", device="cpu")
    like = exe.init(0)
    from repro_torch.tree import tree_flatten, tree_unflatten

    _, td = tree_flatten(like)
    return tree_unflatten(td, leaves_of(arrays, f"{tag}/init"))


def mesh(level):
    return make_mesh((level,), ("pod",), devices=["cpu"] * level)


def ledger(exe):
    return {"totals": exe.ledger.totals,
            "recent": {k: [int(s) for s in v] for k, v in exe.ledger.recent.items()}}


def port_case(case, arrays):
    tag, prog, level, steps, fault, kw = case_args(miso, TNP, case)
    s0 = init_states(prog, arrays, tag)
    spa = miso.compile(prog, backend="spatial_lockstep", mesh=mesh(level), **kw)
    res = spa.run(spa.place(s0), steps, start_step=0, faults=fault)
    tmp = miso.compile(prog, backend="lockstep", device="cpu", **kw)
    ref = tmp.run(s0, steps, start_step=0, faults=fault)
    return spa, res, tmp, ref


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_spatial_states_and_reports_equal_jax(jax_spatial, case):
    arrays, meta = jax_spatial
    tag = case[0]
    spa, res, _, _ = port_case(case, arrays)
    assert same_bits(tree_leaves(spa.gather(res.states)), leaves_of(arrays, f"{tag}/states"))
    assert same_bits(tree_leaves(res.reports), leaves_of(arrays, f"{tag}/reports"))
    assert ledger(spa) == meta[tag]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_spatial_equals_port_lockstep(jax_spatial, case):
    arrays, _ = jax_spatial
    spa, res, tmp, ref = port_case(case, arrays)
    assert same_bits(tree_leaves(spa.gather(res.states)), tree_leaves(ref.states))
    assert same_bits(tree_leaves(res.reports), tree_leaves(ref.reports))
    assert ledger(spa) == ledger(tmp)
    m = spa.metrics()
    assert (m["backend"], m["placement"], m["pod_axis"], m["n_pods"]) == (
        "spatial_lockstep", "spatial", "pod", case[1])


def test_strike_events_detected_and_voted(jax_spatial):
    """DMR detects on every step the divergence persists (2..5), TMR
    votes the strike away once and names replica 1 (tests/test_spatial.py)."""
    _, meta = jax_spatial
    assert meta["l2_hash_fault"]["totals"]["a"]["events"] == 4.0
    assert meta["l3_hash_fault"]["totals"]["a"]["events"] == 1.0
    assert meta["l3_hash_fault"]["totals"]["a"]["per_replica"] == [0.0, 1.0, 0.0]
    assert meta["every4_midwindow"]["totals"]["a"]["events"] == 0.0  # voted, unseen
    arrays, _ = jax_spatial
    spa, _, _, _ = port_case(next(c for c in CASES if c[0] == "l3_hash_fault"), arrays)
    spa.ledger.flagged.add("a")
    assert spa.metrics()["suspects"]["a"]["replica"] == 1


def test_run_campaign_equals_jax_and_sequential_runs(jax_spatial):
    arrays, _ = jax_spatial
    prog = replicated_program(miso, TNP, 2, "hash")
    s0 = init_states(prog, arrays, "campaign")
    spa = miso.compile(prog, backend="spatial_lockstep", mesh=mesh(2))
    faults = [miso.FaultSpec.at(**f) for f in CAMPAIGN]
    camp = spa.run_campaign(spa.place(s0), 6, faults, start_step=0)
    assert same_bits(tree_leaves(camp.states), leaves_of(arrays, "campaign/states"))
    assert same_bits(tree_leaves(camp.reports), leaves_of(arrays, "campaign/reports"))
    assert camp.reports["a"]["events"].tolist() == [5.0, 3.0, 0.0]
    assert spa.ledger.totals == {} and spa.metrics()["steps"] == 0
    seq = [spa.gather(spa.run(spa.place(s0), 6, start_step=0, faults=f).states) for f in faults]
    for i, st in enumerate(seq):
        assert same_bits(tree_leaves(st), [x[i] for x in tree_leaves(camp.states)])


def test_strike_reports_equal_jax(jax_spatial):
    arrays, meta = jax_spatial
    prog = replicated_program(miso, TNP, 2, "hash")
    spa = miso.compile(prog, backend="spatial_lockstep", mesh=mesh(2))
    faults = [miso.FaultSpec.at(**f) for f in CAMPAIGN]
    rep = elastic.spatial_strike_report(spa, spa.place(init_states(prog, arrays, "campaign")), 6,
                                        faults, start_step=0)
    assert rep == meta["strike_report"]
    assert [r["detected"] for r in rep] == [True, True, False]
    assert not any(r["repaired"] for r in rep)  # DMR detects only
    prog3 = replicated_program(miso, TNP, 3, "hash")
    spa3 = miso.compile(prog3, backend="spatial_lockstep", mesh=mesh(3))
    rep3 = elastic.spatial_strike_report(spa3, spa3.place(init_states(prog3, arrays, "strike_tmr")),
                                         6, [miso.FaultSpec.at(**TMR_STRIKE)], start_step=0)
    assert rep3 == meta["strike_report_tmr"] and rep3[0]["detected"] and rep3[0]["repaired"]


def test_straggler_run_equals_jax(jax_spatial):
    """An adopted (compare-skipped) step hides the strike; the next
    wait-step compare repays the deficit by detecting it; the trajectory
    is JAX's and a plain run's, bitwise."""
    arrays, meta = jax_spatial
    prog = replicated_program(miso, TNP, 2, "hash")
    s0 = init_states(prog, arrays, "campaign")
    spa = miso.compile(prog, backend="spatial_lockstep", mesh=mesh(2))
    strike = miso.FaultSpec.at(**STRAGGLER_STRIKE)
    final, stats, log = elastic.run_with_straggler_policy(
        spa, spa.place(s0), 4, elastic.StragglerPolicy(mode="first_wins", slack=1.5),
        STRAGGLER_TIMES, faults=strike, start_step=0)
    want = meta["straggler"]
    assert [stats.adopted_fast, stats.waited, stats.compare_deficit] == want["stats"] == [1, 3, 0]
    kinds = [[e["step"], e["kind"], e["detail"]] for e in log.events]
    assert kinds == want["kinds"]
    assert [1, "adopt", "0"] in kinds and [2, "repay", "1"] in kinds
    assert next(s for s, k, _ in kinds if k == "detect") == 2
    assert ledger(spa) == want["ledger"]
    assert same_bits(tree_leaves(spa.gather(final)), leaves_of(arrays, "straggler/states"))
    plain = miso.compile(prog, backend="spatial_lockstep", mesh=mesh(2))
    ref = plain.run(plain.place(s0), 4, start_step=0, faults=strike)
    assert same_bits(tree_leaves(spa.gather(final)), tree_leaves(plain.gather(ref.states)))


def test_simulate_spatial_step_decisions():
    stats = elastic.StragglerStats()
    wait = elastic.StragglerPolicy()
    first = elastic.StragglerPolicy(mode="first_wins", slack=1.5)
    assert elastic.simulate_spatial_step(wait, stats, (1.0, 9.0)) == "wait"
    assert elastic.simulate_spatial_step(first, stats, (1.0, 1.4)) == "wait"
    assert elastic.simulate_spatial_step(first, stats, (3.0, 1.0)) == "adopt:1"
    assert elastic.simulate_spatial_step(first, stats, (1.0, 3.0)) == "adopt:0"
    assert (stats.adopted_fast, stats.waited, stats.compare_deficit) == (2, 2, 2)
