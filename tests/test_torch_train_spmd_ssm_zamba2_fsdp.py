"""``test_torch_train_spmd_ssm.py``'s gates on zamba2-2.7b under
FSDP on a (2, 4) mesh (one JAX child a file)."""

import pytest

from test_torch_train_spmd_ssm import (ssm_case, test_batches_bitwise,  # noqa: F401
                                       test_jaxs_own_unsharded_step_by_the_same_rule,
                                       test_loss_and_grad_norm_within_1e5_of_jax,
                                       test_params_and_moments_against_jax,
                                       test_sharded_against_unsharded, test_ssm_layout)
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ssm_case("zamba2-2.7b", "fsdp", tmp_path_factory)
