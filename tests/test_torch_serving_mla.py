"""The port's serving engine on an MLA model (deepseek-v3-671b's dense
prefix, reduced, two layers, f32) against the JAX package's, end to end:
the SAME weights and initial states (the JAX engine's, carried over
through ``repro_torch.bridge``), the same staggered none/DMR/TMR request
stream, a dense latent cache and paged latent pools.

Per-request tokens are EQUAL across the packages, paged tokens equal
dense tokens within the port (the counterpart of tests/test_paging.py's
paged-vs-dense gate, without MoE), and a strike into a DMR replica slot
(its ``tokens`` leaf, or a latent ``ckv`` lane) is detected, attributed
and repaired with FaultLedger entries equal to JAX's.
"""

import dataclasses as dc

import jax
import numpy as np
import pytest

from repro import api as jmiso
from repro.configs import get_reduced
from repro.models.lm_cells import ServeConfig as JServeConfig
from repro.serving import DONE
from repro.serving import Request as JRequest
from repro.serving.lm import lm_engine_parts as jax_parts
from repro_torch import api as tmiso
from repro_torch import bridge, tree
from repro_torch.configs import deepseek_v3_671b as tds
from repro_torch.configs import get_reduced as tget
from repro_torch.kernels import paged_decode as pd
from repro_torch.models.lm_cells import ServeConfig as TServeConfig
from repro_torch.models.lm_cells import paged_slot_decoder_init, slot_decoder_init
from repro_torch.serving import Request as TRequest
from repro_torch.serving.lm import lm_engine_parts as torch_parts
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCH = "deepseek-v3-671b"
CFG = dc.replace(get_reduced(ARCH), n_layers=2, mixer_type="mlp", moe=None, dtype="float32")
TCFG = dc.replace(tds.dense_prefix(tget(ARCH)), n_layers=2, dtype="float32")
LEVELS = [1, 2, 3, 1, 2]
PROMPTS = [
    np.random.default_rng(i).integers(0, CFG.vocab_size, size=n).astype(np.int32)
    for i, n in enumerate([5, 9, 3, 12, 7])
]


def serve_kw(paged):
    return dict(batch=4, max_len=32, paged=paged, page_size=8)


def engines(paged):
    """The JAX engine and a port engine started from its states."""
    jeng = jmiso.serve(*jax_parts(CFG, JServeConfig(**serve_kw(paged))))
    jeng.start(jax.random.PRNGKey(0))
    states = bridge.states_from_numpy(jax.tree.map(np.asarray, jeng._states), device="cpu")
    teng = tmiso.serve(*torch_parts(TCFG, TServeConfig(**serve_kw(paged)), device="cpu"),
                       device="cpu")
    teng.start(states=states)
    return jeng, teng


def staggered(eng, R, Pol):
    reqs = [R(prompt=p, max_new_tokens=6, policy=Pol(level=lv), id=f"r{i}")
            for i, (p, lv) in enumerate(zip(PROMPTS, LEVELS))]
    for r in reqs[:2]:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    for r in reqs[2:]:
        assert eng.submit(r)
    eng.pump()
    return [eng.result(r.id) for r in reqs]


@pytest.fixture(scope="module")
def clean_runs():
    """The clean stream on each engine pair; the pairs (idle after it) are
    kept for the strike runs, which give their requests new ids."""
    out = {}
    for paged in (False, True):
        jeng, teng = engines(paged)
        pd.paged_mla_attention.launches = 0
        out[paged] = {
            "jax": staggered(jeng, JRequest, jmiso.RedundancyPolicy),
            "torch": staggered(teng, TRequest, tmiso.RedundancyPolicy),
            "torch_metrics": teng.metrics(),
            "engines": (jeng, teng),
        }
        assert pd.paged_mla_attention.launches == 0  # CPU: the plain version ran
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_tokens_equal_jax(clean_runs, paged):
    run = clean_runs[paged]
    for j, t in zip(run["jax"], run["torch"]):
        assert t["status"] == j["status"] == DONE
        assert t["tokens"] == j["tokens"] and len(t["tokens"]) == 6
        assert t["faults"] == j["faults"] == 0


def test_paged_tokens_equal_dense_within_port(clean_runs):
    dense = [r["tokens"] for r in clean_runs[False]["torch"]]
    paged = [r["tokens"] for r in clean_runs[True]["torch"]]
    assert paged == dense
    m = clean_runs[True]["torch_metrics"]
    assert m["paged"] and m["pages_free"] == m["pages_total"] == 16 and m["page_faults"] > 0
    assert m["done"] == len(PROMPTS) and m["replays"] == 0 and m["request_faults"] == {}


def strike_run(eng, R, Pol, FaultSpec, leaf_of, tag):
    victim = R(prompt=PROMPTS[1], max_new_tokens=6, policy=Pol(level=2), id=f"{tag}v")
    bystander = R(prompt=PROMPTS[0], max_new_tokens=6, id=f"{tag}b")
    assert eng.submit(victim) and eng.submit(bystander)
    eng.pump(max_ticks=1)
    leaf, index = leaf_of(eng.requests[victim.id].slots[1])
    fault = FaultSpec.at(step=eng.exe.metrics()["steps"] + 1,
                         cell_id=eng.exe.program.cell_id("decoder"),
                         leaf=leaf, index=index, bit=20)
    eng.pump(faults=fault)
    return eng.result(victim.id), eng.result(bystander.id), eng.ledger.totals[victim.id]


def tokens_at(paged):
    example = (paged_slot_decoder_init(TCFG, 2, 32, 8, 1, "meta") if paged
               else slot_decoder_init(TCFG, 2, 32, "meta"))
    return lambda slot: (tree.leaf_index(example, "tokens"), slot)


def dense_ckv_at(slot):
    """Layer 0's ``ckv`` leaf of the dense slot state, lane 0 of ``slot``."""
    example = slot_decoder_init(TCFG, 2, 32, "meta")
    paths = tree.tree_paths(example)
    leaf = next(i for i, p in enumerate(paths) if p[-1] == "ckv")
    return leaf, slot * 32 * TCFG.mla.kv_lora_rank


@pytest.mark.parametrize(
    "paged,target", [(False, "tokens"), (True, "tokens"), (False, "ckv")],
    ids=["dense_tokens", "paged_tokens", "dense_ckv_lane"])
def test_dmr_strike_detected_attributed_repaired_like_jax(clean_runs, paged, target):
    jeng, teng = clean_runs[paged]["engines"]
    leaf_of = tokens_at(paged) if target == "tokens" else dense_ckv_at
    replays = teng.metrics()["replays"]
    jv, jb, jled = strike_run(jeng, JRequest, jmiso.RedundancyPolicy, jmiso.FaultSpec, leaf_of,
                              target)
    tv, tb, tled = strike_run(teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec, leaf_of,
                              target)
    assert tv["status"] == DONE and tv["faults"] == jv["faults"] == 1 and tb["faults"] == 0
    assert tled == jled  # events, damaged elements, struck replica
    assert tled["per_replica"][1] == 1.0 and teng.metrics()["replays"] == replays + 1
    clean = dict(zip([tuple(p) for p in PROMPTS], clean_runs[paged]["torch"]))
    assert tv["tokens"] == jv["tokens"] == clean[tuple(PROMPTS[1])]["tokens"]
    assert tb["tokens"] == jb["tokens"] == clean[tuple(PROMPTS[0])]["tokens"]
