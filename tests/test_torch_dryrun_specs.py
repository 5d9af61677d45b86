"""The dry-run's layouts (``launch/dryrun.py``) against the JAX package's.

JAX's side runs in child processes on 8 forced host devices, on meshes
with ``AxisType.Auto`` axes.  The trap: ``repro/launch/dryrun.py`` sets
``XLA_FLAGS`` to 512 host devices when it is imported, so the child
initialises jax's backend with its 8 devices (``jax.devices()``) first.

Held: ``train_state_specs``, ``serve_state_specs`` and the prefill
``input_specs`` equal JAX's leaf for leaf, spec and shape, on (2, 4) and
(2, 2, 2) meshes, for the ten reduced archs and under none / dmr_temporal
/ dmr_spatial / tmr_temporal, FSDP on and off, ``int8_ef`` and
``serve_ep2d``.  The one difference is named: ``int8_ef``'s error-feedback
buffer, one full-length buffer a data member in the port (``P()``, what
runs) where JAX declares ``P(dp)``.  The argument bytes against XLA's
are ``test_torch_dryrun_argbytes.py``'s.  ``long_500k`` is skipped on a pure-attention
arch with JAX's reason."""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs import CANONICAL, get_reduced
from repro_torch.core import RedundancyPolicy
from repro_torch.distributed import make_mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_ctx
from repro_torch.models.config import ShapeSpec
from repro_torch.optim.adamw import OptConfig
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {(2, 4): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}
SHAPES = {"train": ("t_small", "train", 16, 8), "decode": ("d_small", "decode", 32, 8),
          "prefill": ("p_small", "prefill", 16, 8)}
POLICIES = {"none": (1, "temporal"), "dmr_temporal": (2, "temporal"),
            "dmr_spatial": (2, "spatial"), "tmr_temporal": (3, "temporal")}


def case(arch, kind, mesh=(2, 4), policy="none", fsdp=False, comp="none", ep2d=False):
    return (arch, kind, mesh, policy, fsdp, comp, ep2d)


SPEC_CASES = (
    [case(a, k) for a in CANONICAL for k in ("train", "decode", "prefill")]
    + [case(a, "train", fsdp=True) for a in CANONICAL]
    + [case(a, k, mesh=(2, 2, 2) if p == "dmr_spatial" else (2, 4), policy=p)
       for a in ("internlm2-1.8b", "granite-moe-1b-a400m", "mamba2-2.7b")
       for k in ("train", "decode") for p in ("dmr_temporal", "dmr_spatial", "tmr_temporal")]
    + [case("internlm2-1.8b", "train", mesh=(2, 2, 2)),
       case("internlm2-1.8b", "train", comp="int8_ef"),
       case("granite-moe-1b-a400m", "decode", ep2d=True),
       case("deepseek-v3-671b", "decode", ep2d=True)]
)

_CHILD = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from jax.sharding import AxisType
jax.devices()  # the backend takes its 8 devices before the dry-run sets 512
from repro.launch import dryrun as D
from repro.configs import get_reduced
from repro.core import RedundancyPolicy
from repro.launch.mesh import make_ctx
from repro.models.config import ShapeSpec

cases, meshes, shapes, policies, compile_, out = pickle.loads(bytes.fromhex(sys.argv[1]))
res = {}
for c in cases:
    arch, kind, mshape, pol, fsdp, comp, ep2d = c
    mesh = jax.make_mesh(mshape, meshes[mshape], axis_types=(AxisType.Auto,) * len(mshape))
    cfg = get_reduced(arch)
    level, placement = policies[pol]
    policy = RedundancyPolicy(level=level, placement=placement)
    ctx = make_ctx(mesh, pod_role="replica" if placement == "spatial" else "data", fsdp=fsdp,
                   vocab_size=cfg.vocab_size, d_model=cfg.d_model, serve_ep2d=ep2d)
    name, *rest = shapes[kind]
    D.SHAPES[name] = ShapeSpec(name, *rest)
    if compile_:
        compiled = D._compile_variant(cfg, name, mesh, ctx, policy, D.OptConfig(), 1, comp)
        res[("arg",) + c] = compiled.memory_analysis().argument_size_in_bytes
        continue
    _, specs = D.input_specs(cfg, name, mesh, ctx, policy=policy, grad_compression=comp)
    res[c] = [(tuple(s.shape), tuple(s.sharding.spec)) for s in jax.tree.leaves(specs)]
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def run_children(tmp_path_factory, jobs) -> dict:
    """JAX's side of ``jobs`` ((cases, compile) each), one child a job,
    run side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = []
    for i, (cases, comp) in enumerate(jobs):
        out = tmp_path_factory.mktemp(f"specs{i}") / "jax.pkl"
        arg = pickle.dumps((cases, MESHES, SHAPES, POLICIES, comp, str(out))).hex()
        procs.append((out, subprocess.Popen([sys.executable, "-c", _CHILD, arg], env=env,
                                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                            text=True)))
    res = {}
    for out, proc in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with open(out, "rb") as f:
            res.update(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX's specs: three children side by side (the argument bytes are
    ``test_torch_dryrun_argbytes.py``'s)."""
    return run_children(tmp_path_factory, [(SPEC_CASES[i::3], False) for i in range(3)])


def port(c):
    arch, kind, mshape, pol, fsdp, comp, ep2d = c
    mesh = make_mesh(mshape, MESHES[mshape], devices=["cpu"] * int(np.prod(mshape)))
    cfg = get_reduced(arch)
    level, placement = POLICIES[pol]
    policy = RedundancyPolicy(level=level, placement=placement)
    ctx = make_ctx(mesh, pod_role="replica" if placement == "spatial" else "data", fsdp=fsdp,
                   vocab_size=cfg.vocab_size, d_model=cfg.d_model, serve_ep2d=ep2d,
                   decode_shardmap=True)
    _, specs, _ = D.input_specs(cfg, ShapeSpec(*SHAPES[kind]), mesh, ctx, policy=policy,
                                opt=OptConfig(), grad_compression=comp)
    return mesh, specs


def padded(spec, rank):
    return tuple(spec) + (None,) * (rank - len(tuple(spec)))


def leaf_paths(tree):
    from repro_torch.tree import tree_paths
    return ["/".join(str(k) for k in p) for p in tree_paths(tree)]


@pytest.mark.parametrize("c", SPEC_CASES, ids=["-".join(map(str, c)) for c in SPEC_CASES])
def test_specs_equal_jax(jax_side, c):
    _, specs = port(c)
    mine = [(s.shape, padded(s.spec, len(s.shape))) for s in tree_leaves(specs)]
    theirs = [(tuple(sh), padded(sp, len(sh))) for sh, sp in jax_side[c]]
    paths = leaf_paths(specs)
    assert len(mine) == len(theirs)
    diff = [(p, a, b) for p, a, b in zip(paths, mine, theirs) if a != b]
    if c[5] == "int8_ef":
        # the one named difference: the port's ef is a buffer a data member
        assert [p for p, _, _ in diff] == ["trainer/ef"], diff
        (_, (shape, ours), (_, jaxs)), = diff
        assert ours == (None,) and jaxs == ("data",)
    else:
        assert not diff, diff[:5]


def test_long_500k_is_skipped_on_a_pure_attention_arch():
    rec = D.run_cell("internlm2-1.8b", "long_500k", multi_pod=False,
                     mesh=make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8))
    assert rec["skipped"] == "pure full-attention arch (see DESIGN.md §6)" and not rec["ok"]
    assert "long_500k" not in D.applicable_shapes(get_reduced("internlm2-1.8b"))
    assert "long_500k" in D.applicable_shapes(get_reduced("mamba2-2.7b"))
