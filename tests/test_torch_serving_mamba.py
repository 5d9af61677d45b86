"""The port's serving engine on a recurrent model (reduced mamba2-2.7b in
f32) against the JAX package's, end to end: the SAME weights and initial
states (the JAX engine's, carried over through ``repro_torch.bridge``),
the same staggered none/DMR/TMR request stream, the dense slot state with
mamba leaves (conv histories and SSM states; nothing to page).

Per-request tokens are EQUAL across the packages, and a strike into a DMR
replica slot (the ``tokens`` leaf, or an f32 SSM state) is detected,
attributed and repaired with FaultLedger entries equal to JAX's.  Three
distinct prompt lengths only: mamba prefill has no buckets, so the JAX
side compiles once per length.
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
from repro_torch.kernels import ssd_scan as ks
from repro_torch.models.lm_cells import ServeConfig as TServeConfig
from repro_torch.models.lm_cells import paged_serving_supported, slot_decoder_init
from repro_torch.serving import Request as TRequest
from repro_torch.serving.lm import lm_engine_parts as torch_parts
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

CFG = dc.replace(get_reduced("mamba2-2.7b"), dtype="float32")
TCFG = dc.replace(tget("mamba2-2.7b"), dtype="float32")
LEVELS = [1, 2, 3, 1, 2]
PROMPTS = [
    np.random.default_rng(i).integers(0, CFG.vocab_size, size=n).astype(np.int32)
    for i, n in enumerate([5, 19, 2, 5, 19])  # 19 > one 16-step chunk; 2 < the conv window
]
SERVE = dict(batch=4, max_len=32)


def engines():
    """The JAX engine and a port engine started from its states."""
    jeng = jmiso.serve(*jax_parts(CFG, JServeConfig(**SERVE)))
    jeng.start(jax.random.PRNGKey(0))
    states = bridge.states_from_numpy(jax.tree.map(np.asarray, jeng._states), device="cpu")
    teng = tmiso.serve(*torch_parts(TCFG, TServeConfig(**SERVE), device="cpu"), device="cpu")
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
def clean():
    jeng, teng = engines()
    ks.ssd_scan.launches = 0
    out = {"jax": staggered(jeng, JRequest, jmiso.RedundancyPolicy),
           "torch": staggered(teng, TRequest, tmiso.RedundancyPolicy),
           "metrics": teng.metrics()}
    assert ks.ssd_scan.launches == 0  # CPU: the plain version ran
    return out


def test_engine_tokens_equal_jax(clean):
    for j, t in zip(clean["jax"], clean["torch"]):
        assert t["status"] == j["status"] == DONE
        assert t["tokens"] == j["tokens"] and len(t["tokens"]) == 6
        assert t["faults"] == j["faults"] == 0


def test_no_buckets_and_no_pages_for_a_recurrent_model(clean):
    m = clean["metrics"]
    assert m["prefill_buckets"] is None and m["paged"] is False
    assert m["done"] == len(PROMPTS) and m["replays"] == 0 and m["request_faults"] == {}


def leaf_and_index(key, slot):
    """Flat leaf index of the decoder's ``key`` leaf and the flat element
    index of ``slot``'s first element in it (layer 0 for cache leaves)."""
    example = slot_decoder_init(TCFG, 2, 32, "meta")
    paths = tree.tree_paths(example)
    leaf = next(i for i, p in enumerate(paths) if p[-1] == key)
    shape = tree.tree_leaves(slot_decoder_init(TCFG, SERVE["batch"], 32, "meta"))[leaf].shape
    per_slot = int(np.prod(shape[2:])) if key == "ssm" else int(np.prod(shape[1:]))
    return leaf, slot * per_slot


def strike_run(eng, R, Pol, FaultSpec, key, bit):
    victim = R(prompt=PROMPTS[1], max_new_tokens=6, policy=Pol(level=2), id="v")
    bystander = R(prompt=PROMPTS[0], max_new_tokens=6, id="b")
    assert eng.submit(victim) and eng.submit(bystander)
    eng.pump(max_ticks=1)
    leaf, index = leaf_and_index(key, eng.requests[victim.id].slots[1])
    fault = FaultSpec.at(step=eng.exe.metrics()["steps"] + 1,
                         cell_id=eng.exe.program.cell_id("decoder"),
                         leaf=leaf, index=index, bit=bit)
    eng.pump(faults=fault)
    return eng.result(victim.id), eng.result(bystander.id), eng.ledger.totals[victim.id]


@pytest.mark.parametrize("key,bit", [("tokens", 4), ("ssm", 30)], ids=["tokens", "ssm_state"])
def test_dmr_strike_detected_attributed_repaired_like_jax(clean, key, bit):
    jeng, teng = engines()
    jv, jb, jled = strike_run(jeng, JRequest, jmiso.RedundancyPolicy, jmiso.FaultSpec, key, bit)
    tv, tb, tled = strike_run(teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec, key, bit)
    assert tv["status"] == DONE and tv["faults"] == jv["faults"] == 1 and tb["faults"] == 0
    assert tled == jled  # events, damaged elements, struck replica
    assert tled["per_replica"][1] == 1.0 and teng.metrics()["replays"] == 1
    assert tv["tokens"] == jv["tokens"] == clean["torch"][1]["tokens"]
    assert tb["tokens"] == jb["tokens"] == clean["torch"][0]["tokens"]


def test_paged_request_falls_back_to_dense():
    """tests/test_paging.py's check: ``paged=True`` on a recurrent model
    serves from the dense slot state."""
    assert not paged_serving_supported(TCFG)
    eng = tmiso.serve(*torch_parts(TCFG, TServeConfig(batch=2, max_len=16, paged=True),
                                   device="cpu"), device="cpu")
    eng.start(0)
    req = TRequest(prompt=np.arange(4, dtype=np.int32), max_new_tokens=3)
    assert eng.submit(req)
    eng.pump()
    assert eng.result(req.id)["status"] == DONE and len(eng.result(req.id)["tokens"]) == 3
    m = eng.metrics()
    assert m["paged"] is False and "pages_total" not in m
