"""The dense cases of ``test_torch_spec_sharded`` (true self-speculation
and a ``draft_arch`` draft over the dense cache, whose draft cache is
sequence-sharded on the (2, 4) mesh) against the JAX package's
speculating engines on the same mesh, as ``test_torch_spec_sharded_jax``
holds the paged ones."""

import pytest

from repro_torch.testing import cap_threads_for_xdist
from test_torch_spec_sharded import STRIKE
from test_torch_spec_sharded_jax import FIELDS, jax_runs

cap_threads_for_xdist()

DENSE_CASES = ("self-dense", "draft-dense")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return jax_runs(DENSE_CASES, tmp_path_factory.mktemp("spec_dense_jax"))


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("case", DENSE_CASES)
def test_sharded_dense_speculation_equals_jax_on_the_mesh(pairs, case, field):
    want, got = pairs[case]
    assert got[field] == want[field]


@pytest.mark.parametrize("case", DENSE_CASES)
def test_jax_speculating_engine_ran_the_scenario(pairs, case):
    want, _ = pairs[case]
    assert all(s == "done" for s in want["status"]) and want["request_faults"] == {STRIKE: 1}
    assert want["spec"]["spec_ticks"] > 0 and want["pages"] == []
