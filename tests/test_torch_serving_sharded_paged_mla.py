"""Paged MLA latent pools under a ``ShardCtx``: reduced f32 deepseek-v3
without its MoE layers (3 MLA layers with dense MLPs) served with its
weights and its latent pools (N, ps, lora) sharded over CPU meshes that
reach every route of ``distributed/decode.py``'s paged MLA decode,
against the port's unsharded paged engine from the same seed:

  (1, 2), (1, 4)  each page's lanes over the model axis: K6's partials a
                  slot over 4 and 2 lanes a page, combined in lane order;
  (2, 2), (2, 4)  pages over the data axis and lanes over model: K6's
                  partials a page of a slot, combined in page order;
  (1, 3)          3 does not divide the 8-lane page: every member holds
                  the whole pool, K6 once.

On ``test_torch_serving_sharded_paged.SCENARIO``'s stream (a page budget
that makes requests queue, a strike on replica slot 1 of a DMR and of a
TMR request): tokens, statuses, faults, ledger totals and recent steps,
the page tables, free pages and page faults must be bitwise the
unsharded engine's.  The MoE layers are left out here because a sharded
MoE layer sizes its expert capacity from each member's tokens (the JAX
package's ``_moe_spmd``), so the unsharded engine is not its twin; the
model with its MoE layers is held to JAX's sharded engine in
``test_torch_serving_sharded_paged_mla_jax.py``.  Also: the pools'
layouts are ``cache_pspecs``', each mesh's route is the one above, and
``MLA_POOL_REFUSAL`` is gone."""

import dataclasses

import pytest

from repro_torch import api as miso
from repro_torch.configs import get_reduced
from repro_torch.distributed import decode as DD
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import LOCAL, Sharded, cache_pspecs, unshard
from repro_torch.launch.mesh import make_ctx
from repro_torch.models.layers import paged_write_rows
from repro_torch.serving import Request
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import leaf_index
from test_torch_serving_sharded_paged import FIELDS, STRIKES, engine, host, scenario

cap_threads_for_xdist()

FULL = dataclasses.replace(get_reduced("deepseek-v3-671b"), dtype="float32")
#: the reduced model's MLA layers with dense MLPs (``n_layers`` 3)
CFG = dataclasses.replace(FULL, mixer_type="mlp", moe=None, n_layers=3)
MESHES = {"1x2": (1, 2), "1x4": (1, 4), "2x2": (2, 2), "2x4": (2, 4), "1x3": (1, 3)}
ROUTES = {"1x2": "lanes", "1x4": "lanes", "2x2": "pages", "2x4": "pages", "1x3": "head"}
#: the stacked latent pool's spec (L, N, ps, lora), as ``cache_pspecs`` gives it
POOL_SPECS = {"1x2": (None, None, "model", None), "1x4": (None, None, "model", None),
              "2x2": (None, "data", "model", None), "2x4": (None, "data", "model", None),
              "1x3": (None, None, None, None)}


def mesh_ctx(shape, cfg=CFG):
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
    return make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model, decode_shardmap=True)


def run(ctx, strike, cfg=CFG, **kw):
    """``SCENARIO``'s stream on the port's engine of ``cfg`` under ``ctx``."""
    eng = engine(ctx, cfg=cfg, **kw)
    out = scenario(eng, miso, Request, leaf_index, host, cfg.vocab_size, strike)
    return {**out, "page_waits": eng.page_waits[0]}


@pytest.fixture(scope="module")
def local_runs():
    return {s: run(LOCAL, s) for s in STRIKES}


@pytest.fixture(scope="module")
def mesh_runs():
    return {(m, s): run(mesh_ctx(MESHES[m]), s) for m in MESHES for s in STRIKES}


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("strike", STRIKES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_paged_mla_engine_equals_unsharded(local_runs, mesh_runs, mesh, strike, field):
    assert mesh_runs[(mesh, strike)][field] == local_runs[strike][field]


@pytest.mark.parametrize("strike", STRIKES)
def test_unsharded_paged_mla_run_is_the_scenario(local_runs, strike):
    got = local_runs[strike]
    assert all(s == "done" for s in got["status"])
    assert got["request_faults"] == {strike: 1}
    assert got["page_faults"] > 0 and got["page_waits"] > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_latent_pool_layout_and_route(mesh):
    ctx = mesh_ctx(MESHES[mesh])
    eng = engine(ctx, cfg=CFG)
    st = eng._states["decoder"]
    cache = st["cache"]
    specs = cache_pspecs(ctx, cache, CFG)
    for name in ("ckv", "krope"):
        assert tuple(specs["segments"][0][name]) == POOL_SPECS[mesh]
        pool = cache["segments"][0][name]
        assert isinstance(pool, Sharded) and tuple(pool.spec) == POOL_SPECS[mesh]
    pool, pages, pos = cache["segments"][0]["ckv"], st["pages"], cache["pos"].full()
    rows_lanes = paged_write_rows(pages, pos, None, pool.shape[1], pool.shape[-2])
    plan = DD.paged_plan(pool, pages, pos, rows_lanes, latent=True)
    assert plan.route == ROUTES[mesh]
    assert len(plan.members) == (1 if mesh == "1x3" else MESHES[mesh][0] * MESHES[mesh][1])


def test_sharded_latent_fingerprints_are_the_unsharded_views():
    """Mid-stream, the per-slot fingerprints of the sharded paged MLA
    decoder state equal those of its gathered copy, bit for bit."""
    eng = engine(mesh_ctx((2, 4)), cfg=CFG)
    for i, n in enumerate((5, 9, 12)):
        p = [(7 * i + j) % CFG.vocab_size for j in range(n)]
        assert eng.submit(Request(prompt=p, max_new_tokens=6, id=f"f{i}",
                                  policy=miso.RedundancyPolicy(level=1 + i)))
    eng.pump(max_ticks=3)
    dec = eng._states["decoder"]
    assert isinstance(dec["cache"]["segments"][0]["ckv"], Sharded)
    got = eng._ops.fingerprints(dec)
    assert got.tolist() == eng._ops.fingerprints(unshard(dec)).tolist()


def test_mla_pool_refusal_is_gone():
    assert not hasattr(DD, "MLA_POOL_REFUSAL")
