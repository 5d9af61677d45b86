"""Paged serving under a ``ShardCtx``: the reduced f32 internlm2 engine
(4 query / 2 kv heads) with its weights and its paged KV pools sharded
over CPU meshes that reach every route of ``distributed/decode.py``'s
paged decode, against the port's unsharded paged engine from the same
seed:

  (1, 2)  kv heads over the model axis: the head route (K5 a member);
  (2, 2)  pages over the data axis, kv heads over the model axis: K5's
          partials a member, combined over data;
  (1, 4)  each page's lanes over the model axis (2 kv heads do not
          divide 4): the partials at 2 lanes a page, combined over model;
  (2, 4)  pages over data and lanes over model: combined over both.

A staggered none/DMR/TMR stream under a ``page_budget`` that makes
requests queue for pages, with one strike on replica slot 1 of a DMR and
of a TMR request: tokens, statuses, faults, ledger totals and recent
steps, the page table at two points of the run, free pages and page
faults must equal the unsharded engine's; the pools' layouts are
``cache_pspecs``'; the slot fingerprints of a sharded state are its
gathered copy's.  ``SCENARIO`` is the stream's
source, run by the JAX package's engine too
(``test_torch_serving_sharded_paged_jax.py``)."""

import dataclasses
import json

import pytest

from repro_torch import api as miso
from repro_torch.configs import get_reduced
from repro_torch.distributed import make_mesh
from repro_torch.distributed.sharding import LOCAL, Sharded, cache_pspecs, unshard
from repro_torch.launch.mesh import make_ctx
from repro_torch.models.lm_cells import ServeConfig
from repro_torch.serving import Request
from repro_torch.serving.lm import lm_engine_parts
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import leaf_index

cap_threads_for_xdist()

CFG = dataclasses.replace(get_reduced("internlm2-1.8b"), dtype="float32")
SERVE = dict(batch=8, max_len=64, paged=True, page_size=8, page_budget=16)
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4), "2x4": (2, 4)}
#: the pool's spec on each mesh (stacked (L, N, Hkv, ps, D)), as
#: ``cache_pspecs`` gives it
POOL_SPECS = {"1x2": (None, None, "model", None, None),
              "2x2": (None, "data", "model", None, None),
              "1x4": (None, None, None, "model", None),
              "2x4": (None, "data", None, "model", None)}
STRIKES = ("r4", "r6")  # replica slot 1 of a DMR and of a TMR request

#: the stream, one run a strike; executed by both packages' tests with
#: their own ``miso``, ``Request``, ``leaf_of`` (a leaf's flat index) and
#: ``host`` (a tensor or array as nested lists)
SCENARIO = r'''
import numpy as np

PROMPT_LENS = (5, 9, 3, 12, 7, 4, 6)
LEVELS = (1, 2, 3, 1, 2, 1, 3)
BUDGET = 10


def scenario(eng, miso, Request, leaf_of, host, vocab, strike, spec=None):
    """Three requests, two ticks, the other four; then a bit flip into
    replica slot 1 of request ``strike`` once it is resident.  ``spec``:
    each request's speculation (a SpecConfig), or None."""
    ps = [np.random.default_rng(i).integers(0, vocab, size=k).astype(np.int32)
          for i, k in enumerate(PROMPT_LENS)]
    reqs = [Request(prompt=p, max_new_tokens=BUDGET, policy=miso.RedundancyPolicy(level=lv),
                    id=f"r{i}", spec=spec) for i, (p, lv) in enumerate(zip(ps, LEVELS))]
    tables = []
    for r in reqs[:3]:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    dec = eng._states["decoder"]
    if "pages" in dec:
        tables.append(host(dec["pages"]))
    for r in reqs[3:]:
        assert eng.submit(r)
    rec = eng.requests[strike]
    while rec.status != "running":
        eng.pump(max_ticks=1)
    dec = eng._states["decoder"]
    if "pages" in dec:
        tables.append(host(dec["pages"]))
    fault = miso.FaultSpec.at(step=eng.exe.metrics()["steps"] + 1,
                              cell_id=eng.exe.program.cell_id("decoder"),
                              leaf=leaf_of(dec, "tokens"), index=rec.slots[1], bit=4)
    eng.pump(faults=fault)
    m = eng.metrics()
    res = [eng.result(r.id) for r in reqs]
    out = {"tokens": [list(x["tokens"]) for x in res], "status": [x["status"] for x in res],
           "faults": [x["faults"] for x in res],
           "totals": [eng.ledger.totals.get(r.id) for r in reqs],
           "recent": [eng.ledger.recent.get(r.id) for r in reqs],
           "request_faults": m["request_faults"], "replays": m.get("replays"), "pages": tables,
           "pages_free": m.get("pages_free"), "page_faults": m.get("page_faults"),
           "spec": {k: m.get(k) for k in ("spec_ticks", "spec_tokens", "spec_min_commit")}}
    return json.loads(json.dumps(out, default=float))
'''

_ns: dict = {"json": json}
exec(SCENARIO, _ns)
scenario = _ns["scenario"]


def host(x):
    return x.cpu().numpy().tolist()


def mesh_ctx(shape):
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * (shape[0] * shape[1]))
    return make_ctx(mesh, vocab_size=CFG.vocab_size, d_model=CFG.d_model, decode_shardmap=True)


def engine(ctx, cfg=CFG, weights=None, **serve):
    """A started port engine of ``ServeConfig(**serve)`` (default
    ``SERVE``); ``weights(ctx)``: the weights cell to put in place of its
    own.  ``eng.page_waits`` counts the admissions the
    page budget held back."""
    scfg = ServeConfig(**(serve or SERVE))
    prog, adapter = lm_engine_parts(cfg, scfg, ctx, device="cpu")
    waits = [0]
    if adapter.has_capacity is not None:
        def has_capacity(req, inner=adapter.has_capacity):
            ok = inner(req)
            waits[0] += not ok
            return ok

        adapter = dataclasses.replace(adapter, has_capacity=has_capacity)
    eng = miso.serve(prog, adapter, device="cpu")
    states = eng.exe.init(0)
    if weights is not None:
        states["weights"] = weights(ctx)
    eng.start(states=states)
    eng.page_waits = waits
    return eng


def run(ctx, strike, req_spec=None, **kw):
    """The scenario on ``engine(ctx, **kw)``, each request asking for
    ``req_spec``."""
    eng = engine(ctx, **kw)
    out = scenario(eng, miso, Request, leaf_index, host, CFG.vocab_size, strike, spec=req_spec)
    return {**out, "page_waits": eng.page_waits[0]}


@pytest.fixture(scope="module")
def local_runs():
    return {s: run(LOCAL, s) for s in STRIKES}


@pytest.fixture(scope="module")
def mesh_runs():
    return {(m, s): run(mesh_ctx(MESHES[m]), s) for m in MESHES for s in STRIKES}


FIELDS = ("tokens", "status", "faults", "totals", "recent", "request_faults", "replays",
          "pages", "pages_free", "page_faults", "page_waits")


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("strike", STRIKES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_paged_engine_equals_unsharded(local_runs, mesh_runs, mesh, strike, field):
    assert mesh_runs[(mesh, strike)][field] == local_runs[strike][field]


@pytest.mark.parametrize("strike", STRIKES)
def test_unsharded_paged_run_is_the_scenario(local_runs, strike):
    got = local_runs[strike]
    assert all(s == "done" for s in got["status"])
    assert got["request_faults"] == {strike: 1}
    assert (got["replays"] >= 1) == (strike == "r4")  # DMR replays; TMR votes
    assert got["totals"][int(strike[1:])]["per_replica"][1] == 1.0
    assert got["page_faults"] > 0
    assert got["page_waits"] > 0  # the budget made a request queue for pages


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sharded_pool_layout(mesh):
    ctx = mesh_ctx(MESHES[mesh])
    st = engine(ctx)._states["decoder"]
    assert not isinstance(st["pages"], Sharded) and not isinstance(st["tokens"], Sharded)
    cache = st["cache"]
    specs = cache_pspecs(ctx, cache, CFG)
    assert tuple(specs["segments"][0]["k"]) == POOL_SPECS[mesh]
    for name in ("k", "v"):
        pool = cache["segments"][0][name]
        assert isinstance(pool, Sharded) and tuple(pool.spec) == POOL_SPECS[mesh]
        blocks = {tuple((s.start, s.stop) for s in pool.block(c)) for c in pool.coords()}
        ptrs = {pool.local(c).data_ptr() for c in pool.coords()}
        assert len(ptrs) == len(blocks)  # every distinct block its own allocation
    assert isinstance(cache["pos"], Sharded) and tuple(cache["pos"].spec) == (
        ("data",) if MESHES[mesh][0] > 1 else (None,))


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_slot_fingerprints_are_the_unsharded_views(mesh):
    """Mid-stream, the paged surgery's per-slot fingerprints of the
    sharded decoder state equal those of its gathered (unsharded) copy,
    bit for bit: the dense view is assembled by global position."""
    eng = engine(mesh_ctx(MESHES[mesh]))
    for i, n in enumerate((5, 9, 12)):
        p = [(7 * i + j) % CFG.vocab_size for j in range(n)]
        assert eng.submit(Request(prompt=p, max_new_tokens=6, id=f"f{i}",
                                  policy=miso.RedundancyPolicy(level=1 + i)))
    eng.pump(max_ticks=3)
    dec = eng._states["decoder"]
    assert isinstance(dec["cache"]["segments"][0]["k"], Sharded)
    got = eng._ops.fingerprints(dec)
    want = eng._ops.fingerprints(unshard(dec))
    assert got.tolist() == want.tolist()
    assert len({tuple(r) for r in got.tolist()}) > 1
