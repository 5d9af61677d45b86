"""The dry-run's sequence-parallel cells (``run_cell(...,
seq_shard_acts=True)``), port only: reduced internlm2 on a (2, 4) mesh of
stand-ins, at small train and prefill shapes, each beside the same cell
without the flag.

The products are the same, so the FLOPs are equal exactly (the base and
bumped variants, and the record's per-card figure).  The wire differs by
the hand count and by nothing else: each forward pass of a sequence-
parallel layer (two under ``remat`` full: the forward and its
recomputation) gathers its normed activation twice over the model axis in
its dtype (site ``seq``, 2 B S d (tp - 1) bytes summed over the members
in bf16), and its ``wo`` and ``w2`` reduce-scatter their f32 partials in
place of the all-reduces (site ``matmul``: 4 B S d (tp - 1) in place of
8 B S d (tp - 1)); the residual is gathered once more before the final
norm.  Every other site is unchanged."""

import math

import pytest

from repro_torch.configs import get_reduced
from repro_torch.distributed import make_mesh
from repro_torch.distributed import wire
from repro_torch.launch import dryrun as D
from repro_torch.models.config import ShapeSpec
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCH = "internlm2-1.8b"
TP = 4
SHAPES = {"train": (ShapeSpec("train_small", "train", 64, 8), 2),  # (shape, passes a layer)
          "prefill": (ShapeSpec("prefill_small", "prefill", 64, 8), 1)}


@pytest.fixture(scope="module", params=sorted(SHAPES))
def cells(request):
    shape, passes = SHAPES[request.param]
    mesh = make_mesh((2, TP), ("data", "model"), devices=[D.STAND_IN] * 8)
    cfg = get_reduced(ARCH)
    recs = {sp: D.run_cell(ARCH, shape, multi_pod=False, mesh=mesh, cfg=cfg,
                           seq_shard_acts=sp, verbose=False, full_budget_s=0.0)
            for sp in (False, True)}
    return cfg, shape, passes, recs


def hand_count(cfg, shape, passes, layers):
    """The wire the flag adds, by site, for ``layers`` attention layers."""
    out = shape.global_batch * shape.seq_len * cfg.d_model  # B S d
    gather = wire.wire_bytes("all-gather", out * cfg.compute_dtype.itemsize, TP) * TP
    reduce = (wire.wire_bytes("all-reduce", 4 * out, TP)
              - wire.wire_bytes("reduce-scatter", 4 * out / TP, TP)) * TP
    return {"seq": (2 * passes * layers + 1) * gather, "matmul": -2 * passes * layers * reduce}


def test_an_sp_cell_is_ok(cells):
    _, _, _, recs = cells
    assert recs[True]["ok"], recs[True].get("error")
    assert recs[True]["seq_shard_acts"] is True and recs[False]["ok"]
    assert D.TEMP_NOTE in recs[True]["notes"]


def test_flops_equal_exactly(cells):
    _, _, _, recs = cells
    a, b = recs[False]["layerwise"], recs[True]["layerwise"]
    assert a["base"]["flops"] == b["base"]["flops"] > 0
    assert [x["flops"] for x in a["per_layer"]] == [x["flops"] for x in b["per_layer"]]
    assert recs[False]["roofline"]["flops_per_chip"] == recs[True]["roofline"]["flops_per_chip"]


def test_wire_differs_by_the_hand_count(cells):
    cfg, shape, passes, recs = cells
    a, b = recs[False]["layerwise"], recs[True]["layerwise"]
    for layers, ca, cb in ((1, a["base_coll"], b["base_coll"]),
                           (2, a["bumped_coll"][0], b["bumped_coll"][0])):
        want = hand_count(cfg, shape, passes, layers)
        sites = set(ca["by_site"]) | set(cb["by_site"])
        for site in sites:
            diff = cb["by_site"].get(site, 0.0) - ca["by_site"].get(site, 0.0)
            assert math.isclose(diff, want.get(site, 0.0), rel_tol=1e-12, abs_tol=1e-6), site
        assert set(want) <= sites
        assert math.isclose(cb["total"] - ca["total"], sum(want.values()), rel_tol=1e-12)
        # the whole difference is NVLink traffic (groups within the model axis)
        assert math.isclose(cb["by_link"]["network"], ca["by_link"]["network"], rel_tol=1e-12)
