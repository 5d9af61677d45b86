"""The static fixed-batch serving path against the JAX package on four
more reduced f32 archs, each a different decoder state: mamba2 (conv
histories and SSM states), deepseek's dense prefix (the MLA latent
cache), qwen2-vl (M-RoPE, the vision stub's zero rows spliced over the
prompt) and musicgen (four codebooks: (B, P, K) prompts, (B, 1, K)
tokens).  JAX's program, init states and steps come from
``test_torch_serve_static.jax_static``; the port's ``static_main`` under
none, DMR and TMR collects JAX's tokens bitwise, with no ledger event."""

import dataclasses as dc

import numpy as np
import pytest

from repro.configs import get_reduced
from repro_torch.configs import deepseek_v3_671b as tds
from repro_torch.configs import get_reduced as tget
from repro_torch.core.redundancy import replicate_state
from repro_torch.launch import serve as TS
from repro_torch.testing import cap_threads_for_xdist
from test_torch_serve_static import argv, carried, jax_static

cap_threads_for_xdist()


def configs(arch: str):
    if arch == "deepseek-v3-671b":
        # the dense prefix: 2 MLA layers with a dense MLP
        return (dc.replace(get_reduced(arch), n_layers=2, mixer_type="mlp", moe=None,
                           dtype="float32"),
                dc.replace(tds.dense_prefix(tget(arch)), n_layers=2, dtype="float32"))
    return (dc.replace(get_reduced(arch), dtype="float32"),
            dc.replace(tget(arch), dtype="float32"))


ARCHS = ["mamba2-2.7b", "deepseek-v3-671b", "qwen2-vl-7b", "musicgen-large"]


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for arch in ARCHS:
        cfg, tcfg = configs(arch)
        states0, toks, _, _ = jax_static(cfg, "none")
        out[arch] = (tcfg, states0, toks)
    return out


@pytest.mark.parametrize("redundancy", ["none", "dmr", "tmr"])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_tokens_bitwise_jax(jax_runs, arch, redundancy):
    """JAX's unreplicated init states, replicated for the port's policy
    (``init_states`` replicates the decoder the same way)."""
    tcfg, states0, want = jax_runs[arch]
    level = TS.POLICIES[redundancy].level
    states = carried(states0)
    states["decoder"] = replicate_state(states["decoder"], level)
    out = TS.static_main(tcfg, TS.parser().parse_args(argv(redundancy)), states=states)
    assert out["tokens"].shape == want.shape and np.array_equal(out["tokens"], want)
    if arch == "musicgen-large":
        assert want.shape[-1] == tcfg.n_codebooks
    if level > 1:
        assert float(out["reports"]["decoder"]["events"]) == 0.0
