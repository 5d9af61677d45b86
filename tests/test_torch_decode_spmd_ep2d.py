"""Sharded decode against the JAX package's, case ``moe_ep2d`` of
``tests/test_decode_spmd.py``'s child: EP2D granite-moe (``serve_ep2d=True``: the 8 experts one a member of the (2, 4) mesh, decode tokens gathered over the data axis).  The child, the
port's runs and the gates are ``test_torch_decode_spmd.py``'s."""

import pytest

from repro_torch.testing import cap_threads_for_xdist
from test_torch_decode_spmd import check_caches, check_greedy, check_logits, port_runs, run_child

cap_threads_for_xdist()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_res = run_child("moe_ep2d", tmp_path_factory)
    return jax_res, port_runs("moe_ep2d", jax_res)


def test_moe_ep2d_f32_logits_match_jax(runs):
    check_logits(*runs, "float32", 1e-4)


def test_moe_ep2d_bf16_logits_within_jax_bound(runs):
    check_logits(*runs, "bfloat16", 3e-2)


def test_moe_ep2d_greedy_equals_unsharded(runs):
    check_greedy(runs[1])


def test_moe_ep2d_caches(runs):
    check_caches(*runs)
