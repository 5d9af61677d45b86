"""The dry-run's records, port only: ``run_cell`` on a reduced cell of a
(2, 4) mesh, where ``temp_gib`` is lower under ``remat="full"`` than
under ``"none"``, the recomputation costs products, and the argument
bytes are those of the specs; and ``python -m repro_torch.launch.dryrun``
runs one reduced cell end to end and writes a record with JAX's keys
(XLA's two byte keys named ``*_unfused``); a ``ShardCtx`` field the port
does not honour is the cell's recorded error.  The counts themselves are
held in ``test_torch_dryrun_costs.py``."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

from repro_torch.configs import get_reduced
from repro_torch.distributed import make_mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_ctx
from repro_torch.models.config import ShapeSpec
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN = ShapeSpec("t_small", "train", 32, 8)


def mesh24():
    return make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)


def test_remat_full_lowers_temp_and_argument_bytes_are_the_specs():
    cfg = dataclasses.replace(get_reduced("internlm2-1.8b"), n_layers=2)
    mesh = mesh24()
    recs = {r: D.run_cell("internlm2-1.8b", TRAIN, multi_pod=False, mesh=mesh, cfg=cfg,
                          remat=r, verbose=False) for r in ("full", "none")}
    assert all(r["ok"] for r in recs.values()), [r.get("error") for r in recs.values()]
    full, none = recs["full"], recs["none"]
    assert full["memory"]["temp_gib"] < none["memory"]["temp_gib"]
    assert full["temp_source"] == "full-depth step"
    # recomputing the forward costs products, and its movements again
    assert full["roofline"]["flops_per_chip"] > none["roofline"]["flops_per_chip"]
    ctx = make_ctx(mesh, vocab_size=cfg.vocab_size, d_model=cfg.d_model)
    _, specs, states = D.input_specs(cfg, TRAIN, mesh, ctx)
    assert full["memory"]["argument_gib"] == D.member_bytes(specs, mesh) / 2**30
    assert full["trainer_member_bytes"] == D.sharded_member_bytes(states)
    assert full["memory"]["alias_gib"] == 0.0


JAX_KEYS = {"arch", "shape", "mesh", "redundancy", "remat", "seq_shard_acts", "block_k", "tp_off",
            "decode_shardmap", "grad_compression", "fault_hook", "serve_ep2d", "ok", "memory",
            "compile_full_s", "layerwise", "compile_variants_s", "roofline"}
JAX_MEMORY = {"argument_gib", "output_gib", "temp_gib", "alias_gib", "live_est_gib"}
JAX_LAYERWISE = {"base", "per_layer", "counts", "base_coll", "bumped_coll"}
#: JAX's roofline keys, its two XLA byte keys renamed ``*_unfused``
ROOFLINE = {"compute_s", "memory_s_unfused", "memory_s", "collective_s", "flops_per_chip",
            "hbm_bytes_model", "hbm_bytes_unfused", "wire_bytes_per_chip", "model_flops",
            "chips", "dominant", "bound_s", "roofline_fraction", "useful_ratio"}


def test_the_cli_writes_jaxs_record_keys(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "internlm2-1.8b",
         "--reduced", "--mesh-shape", "2x4", "--shape", "decode_32k", "--decode-shardmap",
         "--redundancy", "dmr_temporal", "--out", str(tmp_path), "--tag", "t"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "1 ok / 0 skipped / 0 failed of 1" in proc.stdout
    rec = json.loads((tmp_path / "t_internlm2-1.8b_decode_32k_single.json").read_text())
    assert rec["ok"] and JAX_KEYS <= set(rec)
    assert set(rec["memory"]) == JAX_MEMORY and set(rec["layerwise"]) == JAX_LAYERWISE
    assert ROOFLINE <= set(rec["roofline"])
    assert rec["mesh"] == "2x4" and rec["redundancy"] == "2/temporal/bitwise/k1"
    assert rec["roofline"]["chips"] == 8 and rec["roofline"]["flops_per_chip"] > 0


def test_an_sp_cell_is_recorded_ok():
    """``--seq-shard-acts`` goes into ``make_ctx`` as in JAX and is
    honoured: a prefill cell with it is recorded ``ok`` with
    ``seq_shard_acts: true`` and JAX's keys, and its step gathered the
    sequence-parallel residual (wire site ``seq``)."""
    rec = D.run_cell("internlm2-1.8b", ShapeSpec("p_small", "prefill", 32, 8), multi_pod=False, mesh=mesh24(),
                     cfg=get_reduced("internlm2-1.8b"), seq_shard_acts=True, verbose=False,
                     full_budget_s=0.0)
    assert rec["ok"], rec.get("error")
    assert rec["seq_shard_acts"] is True and JAX_KEYS <= set(rec)
    assert rec["layerwise"]["base_coll"]["by_site"]["seq"] > 0
