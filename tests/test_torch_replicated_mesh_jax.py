"""A replicated (DMR) trainer whose state is laid out on a mesh, against
the JAX package's ``lockstep`` run of the same program on the same mesh.

JAX's side runs in a child process on 8 forced host devices, on meshes
with ``AxisType.Auto`` axes (under the installed jax ``make_mesh`` alone
gives Explicit ones): DMR temporal on a (2, 4) data x model mesh, and
DMR spatial on a (2, 2, 2) pod x data x model mesh under
``make_ctx(mesh, pod_role="replica")``.  The child lays the replicated
trainer state out by the JAX dry-run's ``train_state_specs`` (the
replica axis prepended as None, or as ``"pod"``) and runs three steps on
``lockstep``, a strike at the last; it returns the initial states, each
step's reports and losses, the ledger totals, its final state and
``fingerprint`` of that state on the mesh.  The port starts from the
same states (``lm_cells.place_train_state(..., level=2, placement)``),
runs the same steps on its ``lockstep`` on a mesh of CPU devices of the
same shape, and must give the same reports and ledger totals bit for
bit, losses within 1e-5, and, on JAX's final state laid out the same
way, JAX's fingerprint bit for bit.  (The strike lands on the last step
so the mismatch count is the one struck element in both: DMR on
``lockstep`` detects and does not repair, and a step after a strike
would compare replicas that differ in float noise.)"""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import api as tmiso
from repro_torch import bridge
from repro_torch.configs import get_reduced as tget
from repro_torch.core import FaultSpec, RedundancyPolicy
from repro_torch.core.redundancy import fingerprint
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import Sharded
from repro_torch.launch.mesh import make_ctx
from repro_torch.models import lm_cells as TL
from repro_torch.optim.adamw import OptConfig
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves
from test_torch_train_spmd import CHILD_XLA_FLAGS

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
BATCH, SEQ, STEPS = 4, 16, 3
OPT = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
STRIKE = dict(step=STEPS - 1, cell_id=1, replica=1, leaf=4, index=11, bit=22)
CASES = {"temporal": ((2, 4), ("data", "model")), "spatial": ((2, 2, 2), ("pod", "data", "model"))}

_CHILD = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "@XLA_FLAGS@"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
jax.devices()  # the backend takes its 8 devices before the dry-run sets 512
from repro import api as miso
from repro.configs import get_reduced
from repro.core import FaultSpec, RedundancyPolicy
from repro.core.redundancy import fingerprint
from repro.data.pipeline import DataConfig
from repro.launch.dryrun import train_state_specs
from repro.launch.mesh import make_ctx
from repro.models import lm_cells as L
from repro.optim.adamw import OptConfig

arch, cases, batch, seq, steps, opt, strike, out = pickle.loads(bytes.fromhex(sys.argv[1]))
res = {}
for placement, (shape, axes) in cases.items():
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(shape))
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", n_layers=2)
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                   pod_role="replica" if placement == "spatial" else "data")
    tcfg = L.TrainConfig(data=DataConfig(batch=batch, seq_len=seq, vocab=cfg.vocab_size),
                         opt=OptConfig(**opt))
    policy = RedundancyPolicy(level=2, placement=placement)
    prog = L.make_train_program(cfg, tcfg, ctx).with_policies({"trainer": policy})
    st = jax.jit(prog.init_states)(jax.random.PRNGKey(0))
    specs = train_state_specs(cfg, tcfg, prog, ctx, policy)
    st = jax.tree.map(lambda x, s: jax.device_put(x, s.sharding), st, specs)
    r = {"init": jax.tree.map(np.asarray, st), "reports": [], "loss": []}
    exe = miso.compile(prog, backend="lockstep")
    with mesh:
        for t in range(steps):
            fault = FaultSpec.at(**strike) if t == strike["step"] else None
            st, rep = exe.step(jax.tree.map(jnp.copy, st), step_idx=t, fault=fault)
            r["reports"].append(jax.tree.map(np.asarray, rep))
            r["loss"].append(np.asarray(st["trainer"]["metrics"]["loss"]))
        r["fingerprint"] = np.asarray(jax.jit(fingerprint)(st["trainer"]))
    r["totals"] = exe.metrics()["fault_totals"]
    r["final"] = jax.tree.map(np.asarray, st)
    r["spec"] = str(st["trainer"]["params"]["embed"].sharding.spec)
    res[placement] = r
with open(out, "wb") as f:
    pickle.dump(res, f)
""".replace("@XLA_FLAGS@", CHILD_XLA_FLAGS)


def run_children(tmp_path_factory, arch=ARCH, cases=CASES) -> dict:
    """Each placement's JAX run of ``arch``, one child each, run side by
    side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = {}
    for placement in cases:
        out = tmp_path_factory.mktemp(placement) / "jax.pkl"
        arg = pickle.dumps((arch, {placement: cases[placement]}, BATCH, SEQ, STEPS, OPT, STRIKE,
                            str(out))).hex()
        procs[placement] = (out, subprocess.Popen(
            [sys.executable, "-c", _CHILD, arg], env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True))
    res = {}
    for placement, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with open(out, "rb") as f:
            res.update(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Both placements' JAX runs."""
    return run_children(tmp_path_factory)


def port_setup(placement, arch=ARCH):
    shape, axes = CASES[placement]
    cfg = dataclasses.replace(tget(arch), dtype="float32", n_layers=2)
    mesh = make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                   pod_role="replica" if placement == "spatial" else "data")
    tcfg = TL.TrainConfig(data=DataConfig(batch=BATCH, seq_len=SEQ, vocab=cfg.vocab_size),
                          opt=OptConfig(**OPT))
    policy = RedundancyPolicy(level=2, placement=placement)
    prog = TL.make_train_program(cfg, tcfg, ctx).with_policies({"trainer": policy})
    return cfg, ctx, prog


def placed(cfg, ctx, placement, numpy_states) -> dict:
    st = bridge.states_from_numpy(numpy_states, device="cpu")
    st["trainer"] = TL.place_train_state(cfg, ctx, st["trainer"], level=2, placement=placement)
    return st


def as_numbers(rep):
    return {k: np.asarray(v, np.float32).tolist() for k, v in rep.items()}


@pytest.mark.parametrize("placement", sorted(CASES))
def test_reports_ledger_and_losses_equal_jax_lockstep(jax_runs, placement):
    check_reports(jax_runs, placement)


def check_reports(jax_runs, placement, arch=ARCH, jax_reports=True):
    """The port's lockstep run from JAX's initial state against JAX's:
    losses within 1e-5; the reports and ledger totals JAX's bit for bit,
    or (``jax_reports`` False, where JAX's own replicas diverge) the
    port's own: no event before the strike, the one struck element at
    it."""
    j = jax_runs[placement]
    cfg, ctx, prog = port_setup(placement, arch)
    st = placed(cfg, ctx, placement, j["init"])
    x = st["trainer"]["params"]["embed"]
    assert isinstance(x, Sharded)
    assert tuple(x.spec)[0] == ("pod" if placement == "spatial" else None)
    exe = tmiso.compile(prog, backend="lockstep", device="cpu")
    for t in range(STEPS):
        fault = FaultSpec.at(**STRIKE) if t == STRIKE["step"] else None
        st, rep = exe.step(st, step_idx=t, fault=fault)
        for cell in ("data", "trainer"):
            if jax_reports:
                assert as_numbers(rep[cell]) == as_numbers(j["reports"][t][cell]), (t, cell)
            else:
                assert float(rep[cell]["events"]) == (t == STRIKE["step"] and cell == "trainer")
        loss = st["trainer"]["metrics"]["loss"]
        np.testing.assert_allclose(loss.numpy(), j["loss"][t], rtol=1e-5, atol=0)
    totals = exe.metrics()["fault_totals"] if not jax_reports else j["totals"]
    if jax_reports:
        assert exe.metrics()["fault_totals"] == j["totals"]
    assert totals["trainer"]["events"] == 1.0 and totals["trainer"]["elems"] == 1.0


@pytest.mark.parametrize("placement", sorted(CASES))
def test_fingerprint_of_jaxs_final_state_on_the_mesh(jax_runs, placement):
    check_fingerprint(jax_runs, placement)


def check_fingerprint(jax_runs, placement, arch=ARCH):
    j = jax_runs[placement]
    cfg, ctx, _ = port_setup(placement, arch)
    tr = placed(cfg, ctx, placement, j["final"])["trainer"]
    assert sum(isinstance(x, Sharded) for x in tree_leaves(tr)) > 10
    got = fingerprint(tr).numpy().astype(np.uint32)
    assert np.array_equal(got, j["fingerprint"].astype(np.uint32))
