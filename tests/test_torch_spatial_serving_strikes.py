"""Strikes under spatially placed serving against the JAX package's
temporal engine (see ``test_torch_spatial_serving.py``): a bit flip into
one replica slot of a DMR or TMR request, on 2 and 3 CPU pods, is
detected by the cross-pod collective, charged to the same request and
replica with the same ledger entry as JAX's temporal engine charges it,
and repaired (DMR by the §IV replay, TMR by the vote); every token, the
victim's and a bystander's, equals JAX's."""

import pytest

from repro import api as jmiso
from repro.serving import Request as JRequest
from repro_torch import api as tmiso
from repro_torch.models.lm_cells import slot_decoder_init
from repro_torch.serving import DONE
from repro_torch.serving import Request as TRequest
from repro_torch.testing import cap_threads_for_xdist
from repro_torch.tree import leaf_index

from test_torch_spatial_serving import (MAX_LEN, MIXES, configs, jax_engine, jpolicy, prompts,
                                        spatial_engine, tpolicy)

cap_threads_for_xdist()


def strike(eng, R, policy, level, replica, tag, leaf, ps):
    victim = R(prompt=ps[1], max_new_tokens=6, policy=policy(level), id=f"{tag}v")
    bystander = R(prompt=ps[0], max_new_tokens=6, policy=policy(1), id=f"{tag}b")
    assert eng.submit(victim) and eng.submit(bystander)
    eng.pump(max_ticks=1)
    slots = list(eng.requests[victim.id].slots)
    fault = (jmiso if R is JRequest else tmiso).FaultSpec.at(
        step=eng.exe.metrics()["steps"] + 1, cell_id=eng.exe.program.cell_id("decoder"),
        leaf=leaf, index=slots[replica], bit=4)
    eng.pump(faults=fault)
    return eng.result(victim.id), eng.result(bystander.id), eng.metrics(), slots


@pytest.mark.parametrize("level,replica,pods", [(2, 1, 2), (2, 0, 3), (3, 2, 3), (3, 0, 3)],
                         ids=["dmr_r1_2pods", "dmr_r0_3pods", "tmr_r2_3pods", "tmr_r0_3pods"])
def test_spatial_strike_attributed_like_jax_temporal(level, replica, pods):
    cfg, tcfg = configs("internlm2-1.8b")
    slots = MIXES[pods][0]
    ps = prompts(cfg, 2)
    leaf = leaf_index(slot_decoder_init(tcfg, 2, MAX_LEN, "meta"), "tokens")
    jeng = jax_engine(cfg, slots)
    teng = spatial_engine(tcfg, jeng, slots, pods)
    jv, jb, jm, _ = strike(jeng, JRequest, jpolicy, level, replica, "s", leaf, ps)
    tv, tb, tm, tslots = strike(teng, TRequest, tpolicy, level, replica, "s", leaf, ps)
    spp = slots // pods
    assert [s // spp for s in tslots] == list(range(level))  # one replica a pod
    assert len({s % spp for s in tslots}) == 1  # at one column
    assert tv["status"] == DONE and tv["tokens"] == jv["tokens"] and tb["tokens"] == jb["tokens"]
    assert tv["faults"] == jv["faults"] == 1 and tb["faults"] == 0
    assert tm["fault_totals"]["sv"] == jm["fault_totals"]["sv"]
    assert tm["fault_totals"]["sv"]["per_replica"][replica] == 1.0
    assert tm["replays"] == (1 if level == 2 else 0)  # TMR repairs by the vote
