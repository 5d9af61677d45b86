"""Registry parity of the static analyzer, the dense vision, windowed, MoE and codebook serve programs: the port's analysis
equals the JAX analyzer's leaf for leaf (reads, dead and undeclared
reads, output-leaf kinds, shapes and dtypes, the DAG's JSON and DOT) and
code for code, with default policies and with every cell under DMR, up
to ``test_torch_analysis.DIFFERENCES``.  The 23 registry programs are
split over eight files so that each stays near half a minute."""

import pytest

from repro_torch.testing import cap_threads_for_xdist
from test_torch_analysis import check_registry_program, jax_analysis  # noqa: F401

cap_threads_for_xdist()

PROGRAMS = ["serve:vision", "serve:windowed", "serve:moe", "serve:codebook"]


@pytest.mark.parametrize("policy", ["default", "dmr"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_registry_program_matches_jax(jax_analysis, name, policy):  # noqa: F811
    check_registry_program(jax_analysis, name, policy)
