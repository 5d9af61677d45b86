"""``test_torch_seq_shard_acts_jax.py``'s case on granite-moe (reduced, f32,
FSDP on a (2, 4) mesh, 2 steps): the port's sequence-parallel mesh
trainer, its MoE layers routed through ``moe._moe_spmd`` on the gathered
normed activation and their output sliced into the residual's layout,
against JAX's mesh trainer with ``seq_shard_acts=True``, by
``check_run``'s rules (loss and grad_norm within 1e-5, moments within
1e-5 a leaf, each step's update by ``check_step``, the chained state
within 1e-5) and the batches bitwise.  (Its unsharded run is not a
bound: a member routes its own tokens into buffers of its own capacity,
so expert parallelism drops other tokens than one device does, with or
without the flag; ``test_torch_seq_shard_acts.py`` holds the SP run
bitwise to the same mesh's run without it.)"""

import pytest

import test_torch_seq_shard_acts_jax as J
import test_torch_train_spmd as S
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCH = "granite-moe-1b-a400m"


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return J.sp_case(ARCH, tmp_path_factory, unsharded=False)


def test_loss_and_grad_norm_within_1e5_of_jaxs_sp_run(case):
    J.check_loss_and_grad_norm(*case, f"{ARCH} sp")


def test_params_and_moments_within_1e5_of_jaxs_sp_run(case):
    jres, port = case
    S.check_run("fsdp", jres, {"stepped": jres["states"], "states": jres["states"]},
                port["sharded"])


def test_batches_bitwise(case):
    J.check_batches(*case)
