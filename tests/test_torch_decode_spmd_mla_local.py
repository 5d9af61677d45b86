"""Sharded MLA decode where no model axis divides the latent cache,
against the JAX package's: deepseek-v3's reduced decoder on a (2, 1)
data x model mesh.  ``mla_decode`` returns None in both packages (a
model axis of 1), and each falls back to each data member's own rows
over every lane: JAX through its partitioner on the global cache, the
port through ``distributed.decode.local_mla_decode`` on the member's
latent block.  The child, the port's runs and the gates are
``test_torch_decode_spmd.py``'s."""

import pytest
import torch

from repro_torch.distributed import decode as DD
from repro_torch.models import transformer as T
from repro_torch.models.lm_cells import place_cache
from repro_torch.testing import cap_threads_for_xdist
from test_torch_decode_spmd import (B, CAP, MESHES, check_caches, check_greedy, check_logits,
                                    mesh_ctx, port_cfg, port_runs, run_child)

cap_threads_for_xdist()

CASE = "mla_local"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_res = run_child(CASE, tmp_path_factory)
    return jax_res, port_runs(CASE, jax_res)


def test_mla_local_f32_logits_match_jax(runs):
    check_logits(*runs, "float32", 1e-4)


def test_mla_local_bf16_logits_within_jax_bound(runs):
    check_logits(*runs, "bfloat16", 3e-2)


def test_mla_local_greedy_equals_unsharded(runs):
    check_greedy(runs[1])


def test_mla_local_caches(runs):
    check_caches(*runs)


def test_mla_local_takes_the_fallback(monkeypatch):
    """The latent cache has rows over data and no model axis; every
    layer's decode goes through ``mla_decode``'s None to
    ``local_mla_decode``, one call a layer and step."""
    cfg, ep2d = port_cfg(CASE, "float32")
    ctx = mesh_ctx(cfg, ep2d, MESHES[CASE])
    cache = place_cache(cfg, T.init_cache(cfg, B, CAP, "cpu"), ctx)
    ckv = cache["segments"][0]["ckv"]
    assert tuple(ckv.spec) == (None, "data", None, None)
    assert len({ckv.local(c).data_ptr() for c in ckv.coords()}) == 2
    seen = {"none": 0, "local": 0}
    mla, local = DD.mla_decode, DD.local_mla_decode

    def spy_mla(*a, **k):
        res = mla(*a, **k)
        seen["none"] += res is None
        return res

    def spy_local(*a, **k):
        seen["local"] += 1
        return local(*a, **k)

    monkeypatch.setattr(DD, "mla_decode", spy_mla)
    monkeypatch.setattr(DD, "local_mla_decode", spy_local)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    from repro_torch.models.lm_cells import place_params

    sp = place_params(cfg, params, ctx)
    T.decode_step(cfg, sp, cache, torch.zeros((B, 1), dtype=torch.int32), ctx=ctx)
    assert seen == {"none": cfg.n_layers, "local": cfg.n_layers}
