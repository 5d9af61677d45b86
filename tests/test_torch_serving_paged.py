"""The port's paged serving engine against the JAX package's: a bit flip
in a DMR replica's page table (the gathered view reads another page or a
row past the pool; the §IV replay repairs the row from the host table),
and the chunked prefill walk.  Shares the configuration and engine
pairing of tests/test_torch_serving.py."""

import numpy as np
import pytest
from test_torch_serving import PROMPTS, TCFG, engines, serve_kw

from repro import api as jmiso
from repro.serving import DONE
from repro.serving import Request as JRequest
from repro_torch import api as tmiso
from repro_torch import tree
from repro_torch.models.lm_cells import paged_slot_decoder_init
from repro_torch.serving import Request as TRequest
from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()


@pytest.mark.parametrize("bit", [2, 20], ids=["other_row", "row_past_pool"])
def test_paged_dmr_strike_on_the_page_table_like_jax(bit):
    """A flip in a DMR replica's page-table row: the gathered view reads
    another page (bit 2) or a row past the pool (bit 20: the gather
    clamps, the K/V write is dropped as JAX drops it), the slot
    fingerprints diverge, and the §IV replay repairs the row from the
    host's table.  Ledger and tokens equal JAX's."""
    jeng, teng = engines(paged=True)
    out = {}
    for name, eng, R, Pol, FS in (
            ("jax", jeng, JRequest, jmiso.RedundancyPolicy, jmiso.FaultSpec),
            ("torch", teng, TRequest, tmiso.RedundancyPolicy, tmiso.FaultSpec)):
        victim = R(prompt=PROMPTS[1], max_new_tokens=6, policy=Pol(level=2), id="pv")
        assert eng.submit(victim)
        eng.pump(max_ticks=1)
        P = serve_kw(True)["max_len"] // serve_kw(True)["page_size"]
        leaf = tree.leaf_index(paged_slot_decoder_init(TCFG, 2, 32, 8, 1, "meta"), "pages")
        fault = FS.at(step=eng.exe.metrics()["steps"] + 1,
                      cell_id=eng.exe.program.cell_id("decoder"), leaf=leaf,
                      index=eng.requests[victim.id].slots[1] * P, bit=bit)
        eng.pump(faults=fault)
        res = {k: v for k, v in eng.result(victim.id).items() if k != "ttft_s"}
        out[name] = (res, eng.ledger.totals[victim.id])
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["faults"] == 1 and out["torch"][0]["status"] == DONE


def test_chunked_prefill_walk_matches_jax():
    """prefill_chunk=4: the prompt tail past the first chunk is walked 4
    tokens per tick inside the resident transition (paged); tokens and
    the walk's progress equal JAX's."""
    import dataclasses as dc

    import jax

    from repro.models.lm_cells import ServeConfig as JServeConfig
    from repro.serving.lm import lm_engine_parts as jax_parts
    from repro_torch import bridge
    from repro_torch.models.lm_cells import ServeConfig as TServeConfig
    from repro_torch.serving.lm import lm_engine_parts as torch_parts
    from test_torch_serving import CFG

    kw = dict(serve_kw(True), prefill_chunk=4, prefill_bucket_min=4)
    jeng = jmiso.serve(*jax_parts(CFG, JServeConfig(**kw)))
    jeng.start(jax.random.PRNGKey(0))
    teng = tmiso.serve(*torch_parts(TCFG, TServeConfig(**kw), device="cpu"), device="cpu")
    teng.start(states=bridge.states_from_numpy(
        jax.tree.map(np.asarray, jeng._states), device="cpu"))
    assert dc.asdict(TServeConfig(**kw))["prefill_chunk"] == 4
    out = {}
    for name, eng, R, Pol in (("jax", jeng, JRequest, jmiso.RedundancyPolicy),
                              ("torch", teng, TRequest, tmiso.RedundancyPolicy)):
        long = R(prompt=PROMPTS[3], max_new_tokens=4, policy=Pol(level=2), id="c0")
        short = R(prompt=PROMPTS[2], max_new_tokens=4, id="c1")
        assert eng.submit(long) and eng.submit(short)
        eng.pump(max_ticks=1)
        walked = eng.requests["c0"].prefill_remaining
        eng.pump()
        out[name] = (walked, [eng.result(r)["tokens"] for r in ("c0", "c1")])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == 4  # 12-token prompt: 4 in the head, 4 walked, 4 left
