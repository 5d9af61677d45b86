"""Spatially placed serving in the port against the JAX package's
TEMPORAL engine.

The property the reference's ``tests/test_serving_spatial.py`` asserts --
spatial placement serves exactly what temporal placement serves -- is
held across the packages here, on the LM engine.  (JAX's spatial engine
runs only on a mesh with Auto axes, which ``jax.make_mesh`` alone does
not give under the installed jax; ``test_torch_spatial_serving_jax.py``
asks for them and holds the port's spatial engine to JAX's spatial
engine on the reference's toy scenario, field for field.)  Here:
the port's engine with ``EngineConfig(placement="spatial")`` on 2- and
3-pod CPU meshes, started from the JAX engine's weights, must emit the
JAX temporal engine's tokens for a staggered none/DMR(/TMR) stream, and
a strike on one replica of a DMR or TMR request must be detected by the
cross-pod collective, charged to the same request and replica with the
same ledger entry, and repaired (``test_torch_spatial_serving_strikes.py``).
Reduced f32 internlm2-1.8b and granite-20b (MQA).  Plus the refusals: a
paged spatial program (JAX's message) and a policy that needs more pods
than the mesh has."""

import dataclasses as dc

import jax
import numpy as np
import pytest

from repro import api as jmiso
from repro.configs import get_reduced
from repro.models.lm_cells import ServeConfig as JServeConfig
from repro.serving import Request as JRequest
from repro.serving.lm import lm_engine_parts as jax_parts
from repro_torch import api as tmiso
from repro_torch import bridge
from repro_torch.configs import get_reduced as tget
from repro_torch.distributed import make_mesh
from repro_torch.models.lm_cells import ServeConfig as TServeConfig
from repro_torch.serving import DONE
from repro_torch.serving import Request as TRequest
from repro_torch.serving.lm import lm_engine_parts as torch_parts
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ARCHS = ["internlm2-1.8b", "granite-20b"]
#: (pods, slots, levels of the stream)
MIXES = {2: (4, [1, 2, 1, 2, 1]), 3: (6, [1, 2, 3, 1, 2])}
MAX_LEN = 32


def configs(arch):
    return (dc.replace(get_reduced(arch), dtype="float32"),
            dc.replace(tget(arch), dtype="float32"))


def prompts(cfg, n):
    return [np.random.default_rng(i).integers(0, cfg.vocab_size, size=k).astype(np.int32)
            for i, k in enumerate([5, 9, 3, 12, 7, 4][:n])]


def jax_engine(cfg, slots):
    eng = jmiso.serve(*jax_parts(cfg, JServeConfig(batch=slots, max_len=MAX_LEN)))
    eng.start(jax.random.PRNGKey(0))
    return eng


def spatial_engine(tcfg, jeng, slots, pods):
    states = bridge.states_from_numpy(jax.tree.map(np.asarray, jeng._states), device="cpu")
    mesh = make_mesh((pods,), ("pod",), devices=["cpu"] * pods)
    eng = tmiso.serve(
        *torch_parts(tcfg, TServeConfig(batch=slots, max_len=MAX_LEN, placement="spatial"),
                     device="cpu"),
        tmiso.EngineConfig(placement="spatial", mesh=mesh), device="cpu")
    eng.start(states=states)
    return eng


def stream(eng, R, policy, levels, ps, tag):
    reqs = [R(prompt=p, max_new_tokens=6, policy=policy(lv), id=f"{tag}{i}")
            for i, (p, lv) in enumerate(zip(ps, levels))]
    for r in reqs[:2]:
        assert eng.submit(r)
    eng.pump(max_ticks=2)
    for r in reqs[2:]:
        assert eng.submit(r)
    eng.pump()
    return [eng.result(r.id) for r in reqs]


def jpolicy(level):
    return jmiso.RedundancyPolicy(level=level)


def tpolicy(level):
    return tmiso.RedundancyPolicy(level=level, placement="spatial" if level > 1 else "temporal")


@pytest.fixture(scope="module")
def runs():
    out = {}
    for arch in ARCHS:
        cfg, tcfg = configs(arch)
        for pods, (slots, levels) in MIXES.items():
            jeng = jax_engine(cfg, slots)
            teng = spatial_engine(tcfg, jeng, slots, pods)
            ps = prompts(cfg, len(levels))
            out[arch, pods] = {
                "jax": stream(jeng, JRequest, jpolicy, levels, ps, "r"),
                "torch": stream(teng, TRequest, tpolicy, levels, ps, "r"),
                "metrics": teng.metrics(),
            }
    return out


@pytest.mark.parametrize("pods", sorted(MIXES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spatial_tokens_equal_jax_temporal(runs, arch, pods):
    run = runs[arch, pods]
    for j, t in zip(run["jax"], run["torch"]):
        assert t["status"] == j["status"] == DONE
        assert t["tokens"] == j["tokens"]
        assert t["faults"] == j["faults"] == 0
    m = run["metrics"]
    assert (m["backend"], m["placement"], m["pods"]) == ("spatial_lockstep", "spatial", pods)
    assert m["slots_per_pod"] == MIXES[pods][0] // pods and m["replays"] == 0


def test_paged_spatial_program_refused_as_in_jax():
    cfg, tcfg = configs("internlm2-1.8b")
    kw = dict(batch=4, max_len=MAX_LEN, paged=True, page_size=8, placement="spatial")
    with pytest.raises(ValueError) as je:
        jax_parts(cfg, JServeConfig(**kw))
    with pytest.raises(ValueError) as te:
        torch_parts(tcfg, TServeConfig(**kw), device="cpu")
    assert str(te.value) == str(je.value) and "paged=True" in str(te.value)


def test_policy_needing_more_pods_is_refused():
    cfg, tcfg = configs("internlm2-1.8b")
    jeng = jax_engine(cfg, 4)
    teng = spatial_engine(tcfg, jeng, 4, 2)
    tmr = TRequest(prompt=prompts(cfg, 1)[0], max_new_tokens=2, policy=tpolicy(3), id="t")
    assert not teng.submit(tmr)
    m = teng.metrics()
    assert teng.result("t")["status"] == "rejected" and m["rejected_invalid"] == 1
    with pytest.raises(ValueError, match="divisible"):
        spatial_engine(tcfg, jeng, 4, 3)
