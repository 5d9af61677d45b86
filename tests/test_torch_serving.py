"""The port's serving engine against the JAX package's, end to end:
reduced internlm2-1.8b in f32, the SAME weights and initial states
(the JAX engine's, carried over through ``repro_torch.bridge``), the same
staggered none/DMR/TMR request stream, dense and paged KV.

Mirrors the JAX gates tests/test_paging.py (paged tokens equal dense,
paged DMR strike) and tests/test_serving.py (TMR repair): per-request
tokens are EQUAL across the packages, and strike detection, attribution
and the FaultLedger entries are bitwise equal.
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
from repro_torch.configs import get_reduced as tget
from repro_torch.models.lm_cells import ServeConfig as TServeConfig
from repro_torch.models.lm_cells import paged_slot_decoder_init, slot_decoder_init
from repro_torch.serving import Request as TRequest
from repro_torch.serving.lm import lm_engine_parts as torch_parts
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

CFG = dc.replace(get_reduced("internlm2-1.8b"), dtype="float32")
TCFG = dc.replace(tget("internlm2-1.8b"), dtype="float32")
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


def staggered(eng, R, Pol, tag):
    """Half the requests now, the rest after two ticks (join/leave churn;
    more replica slots are asked for than the batch holds, so requests
    queue too)."""
    reqs = [R(prompt=p, max_new_tokens=6, policy=Pol(level=lv), id=f"{tag}{i}")
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
    out = {}
    for paged in (False, True):
        jeng, teng = engines(paged)
        out[paged] = {
            "jax": staggered(jeng, JRequest, jmiso.RedundancyPolicy, "r"),
            "torch": staggered(teng, TRequest, tmiso.RedundancyPolicy, "r"),
            "torch_metrics": teng.metrics(),
        }
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_tokens_equal_jax(clean_runs, paged):
    run = clean_runs[paged]
    for j, t in zip(run["jax"], run["torch"]):
        assert t["status"] == j["status"] == DONE
        assert t["tokens"] == j["tokens"]
        assert t["faults"] == j["faults"] == 0


def test_paged_tokens_equal_dense_within_port(clean_runs):
    dense = [r["tokens"] for r in clean_runs[False]["torch"]]
    paged = [r["tokens"] for r in clean_runs[True]["torch"]]
    assert paged == dense


def test_paged_pool_drains_and_counts_page_faults(clean_runs):
    m = clean_runs[True]["torch_metrics"]
    assert m["paged"] and m["pages_free"] == m["pages_total"] == 16
    assert m["page_faults"] > 0 and m["request_faults"] == {}
    assert m["done"] == len(PROMPTS) and m["replays"] == 0


def strike_run(eng, R, Pol, FaultSpec, replica, level, tag, leaf):
    victim = R(prompt=PROMPTS[1], max_new_tokens=6, policy=Pol(level=level), id=f"{tag}v")
    bystander = R(prompt=PROMPTS[0], max_new_tokens=6, id=f"{tag}b")
    assert eng.submit(victim) and eng.submit(bystander)
    eng.pump(max_ticks=1)
    fault = FaultSpec.at(
        step=eng.exe.metrics()["steps"] + 1,
        cell_id=eng.exe.program.cell_id("decoder"),
        leaf=leaf,
        index=eng.requests[victim.id].slots[replica],
        bit=4,
    )
    eng.pump(faults=fault)
    return eng.result(victim.id), eng.result(bystander.id), eng.ledger.totals[victim.id]


def tokens_leaf(paged):
    """Flat index of the decoder's ``tokens`` leaf in the engine's layout."""
    example = (paged_slot_decoder_init(TCFG, 2, 32, 8, 1, "meta") if paged
               else slot_decoder_init(TCFG, 2, 32, "meta"))
    return tree.leaf_index(example, "tokens")


def clean_tokens(clean_runs, paged, prompt):
    runs = dict(zip([tuple(p) for p in PROMPTS], clean_runs[paged]["torch"]))
    return runs[tuple(prompt)]["tokens"]


def test_paged_dmr_strike_detected_attributed_repaired_like_jax(clean_runs):
    jeng, teng = engines(paged=True)
    leaf = tokens_leaf(paged=True)
    jv, jb, jled = strike_run(jeng, JRequest, jmiso.RedundancyPolicy, jmiso.FaultSpec,
                              1, 2, "s", leaf)
    tv, tb, tled = strike_run(teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec,
                              1, 2, "s", leaf)
    assert tv["faults"] == jv["faults"] == 1
    assert tled == jled  # events, damaged elements, struck replica
    assert tv["tokens"] == jv["tokens"] and tb["tokens"] == jb["tokens"]
    assert tv["tokens"] == clean_tokens(clean_runs, True, PROMPTS[1])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("replica", [0, 1])
def test_dmr_strike_replayed_and_localized(clean_runs, paged, replica):
    """The §IV replay decides the DMR pair and names the struck replica."""
    _, teng = engines(paged)
    tv, tb, tled = strike_run(teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec,
                              replica, 2, "d", tokens_leaf(paged))
    assert tv["status"] == DONE and tv["faults"] == 1 and tb["faults"] == 0
    assert tled["events"] == 1.0 and tled["per_replica"][replica] == 1.0
    assert tv["tokens"] == clean_tokens(clean_runs, paged, PROMPTS[1])
    assert teng.metrics()["replays"] == 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("replica", [0, 1, 2])
def test_tmr_strike_repaired_and_localized(clean_runs, paged, replica):
    _, teng = engines(paged)
    tv, tb, tled = strike_run(teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec,
                              replica, 3, "t", tokens_leaf(paged))
    assert tv["status"] == DONE and tv["faults"] == 1
    assert tled["per_replica"][replica] == 1.0 and sum(tled["per_replica"]) == 1.0
    assert tv["tokens"] == clean_tokens(clean_runs, paged, PROMPTS[1])
    assert tb["faults"] == 0
    assert teng.metrics()["replays"] == 0  # TMR repairs by vote, no replay


def test_unported_options_raise():
    # speculation and the engine's tracer are ported; spatial placement is not
    TServeConfig(batch=2, max_len=16, spec=tmiso.SpecConfig(draft_len=2))
    tmiso.EngineConfig(tracer=tmiso.Tracer())
    with pytest.raises(NotImplementedError):
        TServeConfig(batch=2, max_len=16, placement="spatial")
    with pytest.raises(NotImplementedError):
        tmiso.EngineConfig(placement="spatial")
