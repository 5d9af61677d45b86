"""Sharded decode of the recurrent archs (``ssm.mamba_block`` under a
``ShardCtx`` with a mesh, zamba2's shared attention block through
``distributed/decode.py``) against the JAX package's sharded decode:
the child and helpers of ``test_torch_decode_spmd.py``, on reduced
mamba2-2.7b and zamba2-2.7b (16 SSM heads of 8 over a model axis of 4;
zamba2's shared block 4 kv heads, head-sharded) on a (2, 4) data x
model mesh with Auto axes.  JAX reaches these layers through its
partitioner (``cache_pspecs``' ``ssm``/``conv_x`` rules); the port runs
each member's rows and heads.  Gates: logits within 1e-4 of JAX's
sharded logits in f32 and within JAX's 3e-2 in bf16; 3 free-running
greedy tokens bitwise the port's unsharded decode in f32; the final
cache, unsharded, within 1e-4 of the port's unsharded cache and of
JAX's on the float leaves and bitwise on the integer ones; the cache
laid out by ``cache_pspecs``, one allocation a member's block."""

import pytest
import torch

from repro_torch.models import transformer as T
from repro_torch.models.lm_cells import place_cache, place_params
from repro_torch.testing import cap_threads_for_xdist

from test_torch_decode_spmd import (B, CAP, check_caches, check_greedy, check_logits, mesh_ctx,
                                    port_cfg, port_runs, run_child)

cap_threads_for_xdist()


@pytest.fixture(scope="module", params=["mamba2", "zamba2"])
def ssm(request, tmp_path_factory):
    jax_res = run_child(request.param, tmp_path_factory)
    return request.param, jax_res, port_runs(request.param, jax_res)


def test_f32_logits_match_jax(ssm):
    _, jres, port = ssm
    check_logits(jres, port, "float32", 1e-4)


def test_bf16_logits_within_jax_bound(ssm):
    _, jres, port = ssm
    check_logits(jres, port, "bfloat16", 3e-2)


def test_greedy_equals_unsharded(ssm):
    check_greedy(ssm[2])


def test_caches(ssm):
    _, jres, port = ssm
    check_caches(jres, port)


def test_state_layout(ssm):
    """The SSM state's heads and conv_x's channels over the model axis,
    every leaf's rows over the data axis; a member's block its own
    allocation (conv_bc's shared by a data member's model members)."""
    case = ssm[0]
    cfg, ep2d = port_cfg(case, "float32")
    sc = place_cache(cfg, T.init_cache(cfg, B, CAP, "cpu"), mesh_ctx(cfg, ep2d))
    seg = sc["segments"][0]
    mamba = seg if case == "mamba2" else seg["mamba"]
    lead = (None,) if case == "mamba2" else (None, None)
    assert tuple(mamba["ssm"].spec) == lead + ("data", "model", None, None)
    assert tuple(mamba["conv_x"].spec) == lead + ("data", None, "model")
    assert tuple(mamba["conv_bc"].spec) == lead + ("data", None, None)
    ssm_leaf = mamba["ssm"]
    assert len({ssm_leaf.local(c).data_ptr() for c in ssm_leaf.coords()}) == 8
    assert len({mamba["conv_bc"].local(c).data_ptr() for c in ssm_leaf.coords()}) == 2
    if case == "zamba2":
        assert tuple(seg["attn"]["k"].spec) == (None, "data", "model", None, None)


def test_the_prefill_runs_one_scan_a_member(monkeypatch):
    """Under the mesh a prefill's mamba layer scans each member's rows and
    heads once: 8 calls of ``kernels.ops.ssd`` a layer, each on 4 of the
    16 heads and 2 of the 4 rows; the logits those of the unsharded
    prefill within 1e-4."""
    from repro_torch.kernels import ops as kops

    cfg, ep2d = port_cfg("mamba2", "float32")
    ctx = mesh_ctx(cfg, ep2d)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, 12), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    want, _ = T.forward(cfg, params, toks)
    shapes, real = [], kops.ssd
    monkeypatch.setattr(kops, "ssd", lambda x, *a, **k: (shapes.append(tuple(x.shape)), real(x, *a, **k))[1])
    got, _ = T.forward(cfg, place_params(cfg, params, ctx), toks, ctx=ctx)
    assert len(shapes) == 8 * cfg.n_layers
    assert set(shapes) == {(B // 2, 12, 4, cfg.ssm.headdim)}
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
