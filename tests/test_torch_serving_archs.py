"""The port's serving engine on the MoE and Zamba2 layer kinds against
the JAX package's, end to end: reduced f32 granite-moe-1b-a400m (MoE
layers; dense slots and paged pools) and zamba2-2.7b (Mamba2 layers with
a weight-shared attention block: each unit's slot state nests its mamba
states beside its KV cache).  The SAME weights and initial states (the
JAX engine's, carried over through ``repro_torch.bridge``), the same
staggered none/DMR/TMR stream.

Per-request tokens are EQUAL across the packages, and a strike into a
DMR replica slot (its ``tokens`` leaf, or for zamba2 a lane of a unit's
KV cache or a unit's SSM state, leaves of the nested cache) is detected,
attributed and repaired with FaultLedger entries equal to JAX's, by one
§IV replay.  zamba2 asked to speculate falls back to plain decode, as
mamba2 and JAX do.
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
from repro_torch.models.lm_cells import SpecConfig, paged_slot_decoder_init, slot_decoder_init
from repro_torch.serving import Request as TRequest
from repro_torch.serving.lm import lm_engine_parts as torch_parts
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

MOE, ZAMBA = "granite-moe-1b-a400m", "zamba2-2.7b"
LEVELS = [1, 2, 3, 1, 2]
# zamba2 prefills have no buckets (JAX compiles each length): two lengths,
# one of them more than a 16-step chunk
LENGTHS = {MOE: [5, 9, 3, 12, 7], ZAMBA: [5, 19, 5, 19, 5]}
RUNS = [(MOE, False), (MOE, True), (ZAMBA, False)]
IDS = ["moe-dense", "moe-paged", "zamba2-dense"]


def cfgs(arch):
    return dc.replace(get_reduced(arch), dtype="float32"), dc.replace(tget(arch), dtype="float32")


def prompts(arch):
    vocab = get_reduced(arch).vocab_size
    return [np.random.default_rng(i).integers(0, vocab, size=n).astype(np.int32)
            for i, n in enumerate(LENGTHS[arch])]


def serve_kw(paged):
    return dict(batch=4, max_len=32, paged=paged, page_size=8)


def engines(arch, paged):
    """The JAX engine and a port engine started from its states."""
    cfg, tcfg = cfgs(arch)
    jeng = jmiso.serve(*jax_parts(cfg, JServeConfig(**serve_kw(paged))))
    jeng.start(jax.random.PRNGKey(0))
    states = bridge.states_from_numpy(jax.tree.map(np.asarray, jeng._states), device="cpu")
    teng = tmiso.serve(*torch_parts(tcfg, TServeConfig(**serve_kw(paged)), device="cpu"),
                       device="cpu")
    teng.start(states=states)
    return jeng, teng


def staggered(eng, R, Pol, arch):
    reqs = [R(prompt=p, max_new_tokens=6, policy=Pol(level=lv), id=f"r{i}")
            for i, (p, lv) in enumerate(zip(prompts(arch), LEVELS))]
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
    for arch, paged in RUNS:
        jeng, teng = engines(arch, paged)
        out[arch, paged] = {
            "jax": staggered(jeng, JRequest, jmiso.RedundancyPolicy, arch),
            "torch": staggered(teng, TRequest, tmiso.RedundancyPolicy, arch),
            "metrics": (jeng.metrics(), teng.metrics()),
            "engines": (jeng, teng),
        }
    return out


@pytest.mark.parametrize("arch,paged", RUNS, ids=IDS)
def test_engine_tokens_and_counters_equal_jax(clean_runs, arch, paged):
    run = clean_runs[arch, paged]
    for j, t in zip(run["jax"], run["torch"]):
        assert t["status"] == j["status"] == DONE
        assert t["tokens"] == j["tokens"] and len(t["tokens"]) == 6
        assert t["faults"] == j["faults"] == 0
    jm, tm = run["metrics"]
    for key in ("ticks", "done", "tokens_out", "paged", "prefill_buckets", "request_faults"):
        assert tm[key] == jm[key], key
    assert tm["paged"] == paged and tm["replays"] == 0 and tm["request_faults"] == {}


def test_moe_paged_tokens_equal_dense_within_port(clean_runs):
    assert ([r["tokens"] for r in clean_runs[MOE, True]["torch"]]
            == [r["tokens"] for r in clean_runs[MOE, False]["torch"]])


def element(arch, paged, key, slot, nested=None):
    """Flat leaf index of the decoder's ``key`` leaf (under ``nested`` for
    a zamba unit's cache) and the flat element index of ``slot``'s first
    element in it (layer or unit 0)."""
    _, tcfg = cfgs(arch)
    make = ((lambda b: paged_slot_decoder_init(tcfg, b, 32, 8, 1, "meta")) if paged
            else (lambda b: slot_decoder_init(tcfg, b, 32, "meta")))
    paths = tree.tree_paths(make(2))
    leaf = next(i for i, p in enumerate(paths)
                if p[-1] == key and (nested is None or nested in p))
    shape = tree.tree_leaves(make(serve_kw(paged)["batch"]))[leaf].shape
    if key == "tokens":
        return leaf, slot
    ax = 2 if nested == "mamba" else 1  # (units, sub, B, ...) or (units, B, ...)
    return leaf, slot * int(np.prod(shape[ax + 1:]))


STRIKES = [(MOE, False, "tokens", None), (MOE, True, "tokens", None),
           (ZAMBA, False, "tokens", None), (ZAMBA, False, "k", "attn"),
           (ZAMBA, False, "ssm", "mamba")]


@pytest.mark.parametrize("arch,paged,key,nested", STRIKES,
                         ids=["moe-dense-tokens", "moe-paged-tokens", "zamba2-tokens",
                              "zamba2-attn-k-lane", "zamba2-ssm-state"])
def test_dmr_strike_detected_attributed_repaired_like_jax(clean_runs, arch, paged, key, nested):
    jeng, teng = clean_runs[arch, paged]["engines"]
    ps = prompts(arch)
    tag = f"{key}{nested}"

    def strike_run(eng, R, Pol, FaultSpec):
        victim = R(prompt=ps[1], max_new_tokens=6, policy=Pol(level=2), id=f"{tag}v")
        bystander = R(prompt=ps[0], max_new_tokens=6, id=f"{tag}b")
        assert eng.submit(victim) and eng.submit(bystander)
        eng.pump(max_ticks=1)
        leaf, index = element(arch, paged, key, eng.requests[victim.id].slots[1], nested)
        fault = FaultSpec.at(step=eng.exe.metrics()["steps"] + 1,
                             cell_id=eng.exe.program.cell_id("decoder"),
                             leaf=leaf, index=index, bit=20 if key != "tokens" else 4)
        eng.pump(faults=fault)
        return eng.result(victim.id), eng.result(bystander.id), eng.ledger.totals[victim.id]

    replays = teng.metrics()["replays"]
    jv, jb, jled = strike_run(jeng, JRequest, jmiso.RedundancyPolicy, jmiso.FaultSpec)
    tv, tb, tled = strike_run(teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec)
    assert tv["status"] == DONE and tv["faults"] == jv["faults"] == 1 and tb["faults"] == 0
    assert tled == jled  # events, damaged elements, struck replica
    assert tled["per_replica"][1] == 1.0 and teng.metrics()["replays"] == replays + 1
    clean = clean_runs[arch, paged]["torch"]  # the same prompts' clean streams
    assert tv["tokens"] == jv["tokens"] == clean[1]["tokens"]
    assert tb["tokens"] == jb["tokens"] == clean[0]["tokens"]


def test_zamba2_falls_back_from_speculation_like_jax():
    """A speculating ServeConfig on zamba2: the recurrent state cannot roll
    back, so the engine decodes plainly (no spec leaves, no verify walks)
    and emits the plain stream."""
    _, tcfg = cfgs(ZAMBA)
    kw = serve_kw(False)
    eng = tmiso.serve(*torch_parts(tcfg, TServeConfig(**kw, spec=SpecConfig(draft_len=3)),
                                   device="cpu"), device="cpu")
    eng.start(0)
    plain = tmiso.serve(*torch_parts(tcfg, TServeConfig(**kw), device="cpu"), device="cpu")
    plain.start(0)
    out = []
    for e in (eng, plain):
        req = TRequest(prompt=prompts(ZAMBA)[1], max_new_tokens=5, spec=SpecConfig(draft_len=3))
        assert e.submit(req)
        e.pump()
        out.append(e.result(req.id)["tokens"])
    assert "spec_out" not in eng._states["decoder"]
    assert out[0] == out[1] and len(out[0]) == 5
    assert "spec_ticks" not in eng.metrics() and eng.adapter.stats()["spec_draft_len"] == 0
