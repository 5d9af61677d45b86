"""Sharded decode against the JAX package's, case ``mla`` of
``tests/test_decode_spmd.py``'s child: MLA deepseek-v3's reduced decoder (sequence-sharded latent cache, 32 lanes over a model axis of 4; each member's partial is the plain torch math, as JAX's ``mla_decode`` body is jnp).  The child, the
port's runs and the gates are ``test_torch_decode_spmd.py``'s."""

import pytest

from repro_torch.testing import cap_threads_for_xdist
from test_torch_decode_spmd import check_caches, check_greedy, check_logits, port_runs, run_child

cap_threads_for_xdist()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_res = run_child("mla", tmp_path_factory)
    return jax_res, port_runs("mla", jax_res)


def test_mla_f32_logits_match_jax(runs):
    check_logits(*runs, "float32", 1e-4)


def test_mla_bf16_logits_within_jax_bound(runs):
    check_logits(*runs, "bfloat16", 3e-2)


def test_mla_greedy_equals_unsharded(runs):
    check_greedy(runs[1])


def test_mla_caches(runs):
    check_caches(*runs)
