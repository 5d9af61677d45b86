"""Mamba2 and Zamba2 trained on a device mesh against the JAX package's
mesh trainer: ``test_torch_train_spmd.py``'s cases and gates on the SSM
architectures (reduced, f32, a (2, 4) data x model mesh, 2 steps).  This
file runs mamba2 under ZeRO-1; ``..._ssm_fsdp.py``, ``..._ssm_zamba2.py``
and ``..._ssm_zamba2_fsdp.py`` run the other three (one JAX child a
file).

A member runs K8 and its backward on its own rows and heads (on the CPU
their plain versions: ``ssd_scan_plain``, ``ssd_scan_bwd_plain`` through
``SSDScan``), its inputs read through ``ssm._Fanout``, whose backward sums
the members' cotangents in member order.  Gates, against JAX's run and
against the port's unsharded run: loss and grad_norm within 1e-5; each
step from the same input state leaf by leaf: every moment leaf within
1e-5 of the other run's in L2 (the gradient, as AdamW's first moment
carries it), and every param and master leaf's update what AdamW makes
of its own run's moments, within one ulp of the new value and 1e-6 of
the update an element (``check_step(..., explained=True)``); the
chained state after step 2 joined within 1e-5; the batches bitwise;
every mamba leaf laid out by ``param_pspecs`` (over the model axis
``w_z``, ``w_x``, ``conv_x``, ``conv_x_b`` and ``out_proj``; the rest
replicated), each member's block its own allocation.

Why not internlm2's element-wise update rule: an SSM's parameter
gradients are sums over every row and position that cancel (``a_log``,
``dt_bias``, ``d_skip``, the conv biases, ``w_dt`` and the B/C group's
weights also over the members that share a head group), so a small
element's gradient moves by 1e-4 of itself under another summation
order, and AdamW divides each element by its own gradient scale: the
update of such an element moves the leaf's update by 1.0-1.3e-5 in
either direction (measured: zamba2 FSDP ``conv_bc_b`` at step 2,
element 119, sqrt(v) 7.0e-8 against the leaf's 5.7e-5, its first moment
1.8e-4 of itself from JAX's; ``dt_bias`` at step 1, one ulp of a value
near -5, 4.8e-7, against an update of 5e-3; mamba2 FSDP ``embed`` at
step 2, sharded against unsharded 1.10e-5), and JAX's own mesh and
unsharded runs differ by the same kind of steps (``dt_bias`` 0 and
``a_log`` 7.9e-6 at step 2 on mamba2).  JAX's unsharded trainer run from
each of its mesh run's inputs (``local_stepped``) is held to its mesh
run by the same rule."""

import pytest
import torch

import test_torch_train_spmd as S
from repro_torch.distributed.sharding import Sharded, param_pspecs
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import tree_leaves, tree_paths

cap_threads_for_xdist()

ARCH = "mamba2-2.7b"
#: the SSM leaves the model axis splits; every other one is replicated
MODEL_SPLIT = ("w_z", "w_x", "conv_x", "conv_x_b", "out_proj")


def ssm_case(arch, case, tmp_path_factory):
    jax_res = S.run_child(case, tmp_path_factory, arch=arch, local=True)
    return arch, case, jax_res, S.port_run(case, jax_res, arch=arch)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ssm_case(ARCH, "zero1", tmp_path_factory)


def test_loss_and_grad_norm_within_1e5_of_jax(run):
    arch, name, jres, port = run
    for step, (jm, tm) in enumerate(zip(jres["metrics"], port["sharded"]["metrics"])):
        for k in ("loss", "grad_norm", "lr"):
            S.close(jm[k], tm[k], 1e-5, f"{arch} {name} step {step} {k}")


def test_params_and_moments_against_jax(run):
    arch, name, jres, port = run
    S.check_run(name, jres, {"stepped": jres["states"], "states": jres["states"]}, port["sharded"],
                explained=True)


def test_sharded_against_unsharded(run):
    arch, name, jres, port = run
    S.check_run(name, jres, port["unsharded"], port["sharded"], explained=True)
    for a, b in zip(port["sharded"]["metrics"], port["unsharded"]["metrics"]):
        for k in ("loss", "grad_norm"):
            S.close(a[k].numpy(), b[k], 1e-5, f"{arch} {name} {k}")


def test_jaxs_own_unsharded_step_by_the_same_rule(run):
    """JAX's unsharded trainer against its mesh trainer, each step from
    the same input: the rule the port is held to holds JAX's two runs."""
    arch, name, jres, _ = run
    for step, (a, b) in enumerate(zip(jres["states"], jres["local_stepped"])):
        S.check_step(S.jax_input(jres, step)["trainer"], a, b,
                     float(jres["metrics"][step]["lr"]), f"{arch} {name} jax step {step + 1}",
                     explained=True)


def test_batches_bitwise(run):
    arch, name, jres, port = run
    final = port["sharded"]["final"]
    assert torch.equal(torch.as_tensor(jres["final"]["data"]["tokens"]), final["data"]["tokens"])
    for a, b in zip(port["sharded"]["batches"], port["unsharded"]["batches"]):
        assert torch.equal(a, b)


def test_ssm_layout(run):
    """Every mamba leaf by ``param_pspecs``; a member's block its own
    allocation, a replicated leaf one tensor."""
    arch, name, _, port = run
    cfg, _, ctx = S.port_setup(name, arch=arch)
    tr = port["sharded"]["final"]["trainer"]
    specs = param_pspecs(ctx, S.unshard(tr["params"]), cfg)
    seen = set()
    for path, leaf, spec in zip(tree_paths(tr["params"]), tree_leaves(tr["params"]),
                                tree_leaves(specs)):
        if "mamba" not in path:
            continue
        assert isinstance(leaf, Sharded) and leaf.spec == spec, path
        axes = {a for e in spec if e for a in (e if isinstance(e, tuple) else (e,))}
        assert ("model" in axes) == (path[-1] in MODEL_SPLIT), (path, spec)
        seen.add(path[-1])
        ptrs = {}
        for c in leaf.coords():
            ptrs.setdefault(tuple((s.start, s.stop) for s in leaf.block(c)), set()).add(
                leaf.local(c).data_ptr())
        assert all(len(v) == 1 for v in ptrs.values())
        assert len({p for v in ptrs.values() for p in v}) == len(ptrs)
    assert {"a_log", "dt_bias", "d_skip", "w_bc", "w_dt", "conv_bc", "w_x", "out_proj"} <= seen
