"""zamba2-2.7b and deepseek-v3-671b with its MoE layers, reduced and in
f32, against the JAX package through the checks of
``tests/test_torch_archs.py`` (a file of their own, so each file stays
near 30 s): forward logits and the filled cache within 1e-4, and 16
greedy decode steps with JAX's tokens, dense for both and paged for
deepseek (zamba2's recurrent state does not page, as in JAX).  JAX's
mamba runs as ``tests/test_torch_ssm.py`` runs it."""

import numpy as np
import pytest
import torch

from repro_torch.models import transformer as TT
from test_torch_archs import check_forward_and_filled_cache, check_greedy, make_runs
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


@pytest.fixture(scope="module")
def runs():
    return make_runs()


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "deepseek-v3-671b"])
def test_forward_logits_and_filled_cache_within_1e4_of_jax(runs, arch):
    r = runs(arch)
    check_forward_and_filled_cache(r)
    if arch == "zamba2-2.7b":  # each unit's cache nests its mamba states and its KV
        assert sorted(r["torch"][1]["segments"][0]) == ["attn", "mamba"]
    else:  # three dense layers, then MoE layers: one page pool each
        assert [s.kind for s in TT.segment_plan(r["tcfg"])] == ["attn_mlp", "attn_moe"]


@pytest.mark.parametrize("arch,paged", [("zamba2-2.7b", False), ("deepseek-v3-671b", False),
                                        ("deepseek-v3-671b", True)],
                         ids=["zamba2-2.7b-dense", "deepseek-v3-671b-dense",
                              "deepseek-v3-671b-paged"])
def test_decode_16_greedy_steps_equal_jax_tokens(runs, arch, paged):
    check_greedy(runs(arch), paged)


def test_paged_cache_and_prompt_len_refused_for_zamba_like_jax(runs):
    r = runs("zamba2-2.7b")
    with pytest.raises(ValueError, match="attention-only"):
        TT.init_paged_cache(r["tcfg"], 2, 8, 4, "cpu")
    with pytest.raises(ValueError, match="recurrent mamba state"):
        TT.forward(r["tcfg"], r["tparams"], torch.from_numpy(np.asarray(r["toks"])), prompt_len=5)
