"""``test_torch_replicated_mesh_jax.py`` on mamba2: a DMR trainer whose
state is laid out on a (2, 4) data x model mesh (temporal placement),
reduced mamba2 in f32 at 2 layers, against the JAX package's
``lockstep`` run of the same program on the same mesh, three steps with
a strike at the last.  Losses within 1e-5 of JAX's and JAX's fingerprint
of its final state on the mesh bit for bit.  The reports are the port's
own: no event on the clean steps (the members' scans give both replicas
the same bits) and the one struck element at the last.  JAX's are not
held: its own two replicas disagree on 10 elements at the clean step 1
(``events`` 1, ``mismatch_elems`` 10 under jax 0.9.0), a property of the
reference's mesh program, not of the port's."""

import pytest

from repro_torch.testing import cap_threads_for_xdist
from test_torch_replicated_mesh_jax import CASES, check_fingerprint, check_reports, run_children

cap_threads_for_xdist()

ARCH = "mamba2-2.7b"


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return run_children(tmp_path_factory, ARCH, {"temporal": CASES["temporal"]})


def test_reports_ledger_and_losses_equal_jax_lockstep(jax_runs):
    check_reports(jax_runs, "temporal", ARCH, jax_reports=False)


def test_fingerprint_of_jaxs_final_state_on_the_mesh(jax_runs):
    check_fingerprint(jax_runs, "temporal", ARCH)
