"""The port's sharded paged MLA engine against the JAX package's on a
(1, 4) mesh, with the reduced f32 deepseek-v3's MoE layers: the latent
pools' lanes over the model axis ("lanes": K6's partials a member in
the port, JAX's GSPMD over K6), its experts over the model axis (JAX's
``_moe_spmd`` and the port's), on one strike of
``test_torch_serving_sharded_paged.SCENARIO``.  The child and the fields
are ``test_torch_serving_sharded_paged_mla_jax.py``'s."""

import pytest

from repro_torch.testing import cap_threads_for_xdist
from test_torch_serving_sharded_paged_jax import JAX_FIELDS
from test_torch_serving_sharded_paged_mla_jax import jax_and_port_runs

cap_threads_for_xdist()

#: name -> (mesh, with the MoE layers, strike)
CASES = {"1x4": ((1, 4), True, "r4")}


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory):
    return jax_and_port_runs(tmp_path_factory.mktemp("paged_mla_moe_jax"), CASES)


@pytest.mark.parametrize("field", JAX_FIELDS)
def test_sharded_paged_mla_moe_engine_equals_jax_on_the_mesh(jax_and_port, field):
    jax_runs, port = jax_and_port
    assert port["1x4"][field] == jax_runs["1x4"][field]


def test_jax_sharded_paged_mla_moe_engine_ran_the_scenario(jax_and_port):
    got = jax_and_port[0]["1x4"]
    assert all(s == "done" for s in got["status"])
    assert got["request_faults"] == {"r4": 1} and got["page_faults"] > 0
    assert jax_and_port[1]["1x4"]["tokens"] == got["tokens"]
