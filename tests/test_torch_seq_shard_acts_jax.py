"""Sequence-parallel activations (``ShardCtx.seq_shard_acts``) on the
mesh trainer against the JAX package's mesh trainer with the same flag:
reduced internlm2 in f32, FSDP on a (2, 4) data x model mesh, 2 steps,
through ``test_torch_train_spmd.py``'s child (``run_child(...,
seq_shard_acts=True)``: JAX's ``make_ctx`` takes the flag and pins each
attention layer's output to (dp, "model", None)) and its gates
(``check_run``: loss and grad_norm within 1e-5, moments within 1e-5 a
leaf, each step's update by ``check_step``, the chained state within
1e-5, the batches bitwise).  The port's run lays each attention layer's
residual out as JAX's constraint says (``layers.seq_scatter``); its
sharded run is also held to its unsharded one by the same rules.
``test_torch_seq_shard_acts_jax_moe.py`` runs granite-moe the same way."""

import pytest

import test_torch_train_spmd as S
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCH = "internlm2-1.8b"


def sp_case(arch, tmp_path_factory, unsharded=True):
    """JAX's SP mesh run (its initial state made under ``jax.jit``) and
    the port's from its initial state, SP on the mesh and, with
    ``unsharded``, unsharded."""
    jax_res = S.run_child("fsdp", tmp_path_factory, arch=arch, seq_shard_acts=True,
                          jit_init=True)
    return jax_res, S.port_run("fsdp", jax_res, arch=arch, seq_shard_acts=True,
                               unsharded=unsharded)


def check_loss_and_grad_norm(jres, port, what):
    for step, (jm, tm) in enumerate(zip(jres["metrics"], port["sharded"]["metrics"])):
        for k in ("loss", "grad_norm", "lr"):
            S.close(jm[k], tm[k], 1e-5, f"{what} step {step} {k}")


def check_batches(jres, port):
    final = port["sharded"]["final"]
    assert (jres["final"]["data"]["tokens"] == final["data"]["tokens"].numpy()).all()
    for step, batch in enumerate(port["sharded"]["batches"][1:]):
        assert (jres["data_tokens"][step] == batch.numpy()).all()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return sp_case(ARCH, tmp_path_factory)


def test_loss_and_grad_norm_within_1e5_of_jaxs_sp_run(case):
    check_loss_and_grad_norm(*case, f"{ARCH} sp")


def test_params_and_moments_within_1e5_of_jaxs_sp_run(case):
    jres, port = case
    S.check_run("fsdp", jres, {"stepped": jres["states"], "states": jres["states"]},
                port["sharded"])


def test_sp_run_within_1e5_of_the_unsharded_run(case):
    jres, port = case
    S.check_run("fsdp", jres, port["unsharded"], port["sharded"])


def test_batches_bitwise(case):
    check_batches(*case)
