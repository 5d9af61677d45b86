"""The quantized case of ``test_torch_train_spmd.py``: FSDP with 8-bit
moments and no f32 master (``OptConfig(quantized_state=True,
master_fp32=False)``, as the JAX dry-run trains deepseek), ``d_ff`` 256
so that the MLP's moments quantize and a model member's slice of their
last axis is a quarter of a 256-element block.  The tests and gates are
that file's (imported here, run on this file's ``case``)."""

import pytest

from repro_torch.testing import cap_threads_for_xdist

import test_torch_train_spmd as S
from test_torch_train_spmd import (test_batches_bitwise_and_data_stays_on_the_controller,  # noqa: F401
                                   test_loss_and_grad_norm_within_1e5_of_jax,
                                   test_params_and_moments_within_1e5_of_jax,
                                   test_sharded_equals_unsharded_within_1e5, test_state_layout)

cap_threads_for_xdist()


@pytest.fixture(scope="module", params=["quantized"])
def case(request, tmp_path_factory):
    jax_res = S.run_child(request.param, tmp_path_factory)
    return request.param, jax_res, S.port_run(request.param, jax_res)


def test_the_mlp_moments_are_int8_blocks_cut_by_the_model_axis(case):
    _, _, port = case
    m = port["sharded"]["final"]["trainer"]["opt"]["m"]["segments"][0]["mlp"]["w1"]
    assert set(m) == {"q", "scale"} and m["q"].dtype.is_floating_point is False
    assert m["q"].local((0, 0)).shape[-1] == 64 and tuple(m["scale"].spec)[-1] is None
