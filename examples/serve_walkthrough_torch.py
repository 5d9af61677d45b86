"""Serving walkthrough in PyTorch: the continuous batcher, end to end
(the port's ``examples/serve_walkthrough.py``).

``miso.serve()`` multiplexes independent requests onto ONE resident
slot-masked decoder program driven through ``Executor.stream`` --
continuous batching with per-REQUEST dependability (a request may ask
for DMR/TMR and pays for it in replica slots; nobody else pays
anything).

Three sections:

  1. adapter mechanics -- a minimal slotted program (not an LM) wired to
     the engine through a SlotAdapter: the isolation invariant, slot
     join/leave, per-request policies.
  2. the LM engine -- ``repro_torch.serving.lm.lm_engine_parts`` with
     bucketed + chunked prefill and the paged KV pool
     (ServeConfig(paged=True)).
  3. speculative decoding -- ``SpecConfig``: k tokens per tick through
     the verify walk, bitwise-identical to plain greedy decode.

Run:  PYTHONPATH=src python examples/serve_walkthrough_torch.py             # on cuda
      PYTHONPATH=src python examples/serve_walkthrough_torch.py --device cpu --smoke
"""
import argparse
import dataclasses as dc

import numpy as np
import torch

from repro_torch import api as miso
from repro_torch.configs import get_reduced
from repro_torch.serving import DONE, Request, SlotAdapter, infer_slot_axes, mask_slots
from repro_torch.serving.lm import lm_engine_parts


# ---------------------------------------------------------------------------
# 1. Adapter mechanics: ANY slot-masked cell program can be served.  The
#    SlotAdapter tells the engine which cell holds per-slot state, how to
#    prefill one slot out-of-band, and how to read freshly decoded tokens.
# ---------------------------------------------------------------------------
def slot_init(b, device):
    return {
        "x": torch.zeros((b,), dtype=torch.float32, device=device),
        "tokens": torch.zeros((b, 1), dtype=torch.int32, device=device),
        "active": torch.zeros((b,), dtype=torch.bool, device=device),
        "pos": torch.zeros((b,), dtype=torch.int32, device=device),
    }


AXES = infer_slot_axes(lambda b: slot_init(b, "meta"))


def slot_transition(prev):
    st = prev["dec"]
    x = st["x"] * prev["w"]["m"] + st["pos"].to(torch.float32)
    new = {
        "x": x,
        "tokens": (torch.abs(x) * 64).to(torch.int32)[:, None] % 997,
        "active": st["active"],
        "pos": st["pos"] + 1,
    }
    # the writeback gate: inactive slots are bit-frozen, so requests
    # joining/leaving other slots can never perturb this one
    return mask_slots(st["active"], new, st, AXES)


def adapter_section(device) -> dict:
    sprog = miso.MisoProgram()
    sprog.add(miso.CellType(
        "w", lambda gen, dev: {"m": torch.tensor(1.125, device=dev)}, lambda prev: prev["w"]))
    sprog.add(miso.CellType("dec", lambda gen, dev: slot_init(6, dev), slot_transition,
                            reads=("w",), instances=6))

    def prefill(req, states):
        x0 = torch.tensor(req.prompt, dtype=torch.float32, device=device).sum() * 0.125
        tok0 = (torch.abs(x0) * 64).to(torch.int32)[None, None] % 997
        slot = {
            "x": x0[None],
            "tokens": tok0,
            "active": torch.ones((1,), dtype=torch.bool, device=device),
            "pos": torch.full((1,), len(req.prompt), dtype=torch.int32, device=device),
        }
        return slot, tok0, 0  # (slot state, first token, prompt tokens left to walk)

    # miso.EngineConfig is the typed engine surface (backend, queue depth,
    # tracer, ...); the defaults are the temporal lockstep engine
    engine = miso.serve(
        sprog,
        SlotAdapter(cell="dec", n_slots=6, slot_axes=AXES, prefill=prefill,
                    read_tokens=lambda d: d["tokens"],
                    make_empty=lambda: slot_init(1, device)),
        miso.EngineConfig(), device=device)
    engine.start(0)
    plain = Request(prompt=[3.0, 1.0], max_new_tokens=6)
    guarded = Request(prompt=[4.0, 1.0], max_new_tokens=6,
                      policy=miso.RedundancyPolicy(level=2))
    engine.submit(plain)
    engine.pump(max_ticks=2)  # plain is mid-decode when guarded joins
    engine.submit(guarded)
    engine.pump()
    em = engine.metrics()
    print(f"adapter    : {em['done']}/{em['submitted']} requests done, "
          f"{em['tokens_out']} tokens, ttft p50={em['ttft_p50_s']:.4f}s; "
          f"per-request policies cost only their owner "
          f"(plain={engine.result(plain.id)['slots']} slot, "
          f"dmr={engine.result(guarded.id)['slots']} slots)")
    assert em["done"] == 2 and len(engine.result(guarded.id)["slots"]) == 2
    return {"metrics": em, "plain": engine.result(plain.id),
            "guarded": engine.result(guarded.id)}


def main(argv=None) -> dict:
    """Run the three sections; returns their metrics, the adapter
    section's two results and the speculating request's tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="shrink token budgets so the walkthrough finishes in CI time")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)
    decode, dev = (4 if ns.smoke else 8), ns.device
    out = {"adapter": adapter_section(dev)}

    # -----------------------------------------------------------------------
    # 2. The LM engine: lm_engine_parts packages a real transformer as the
    #    resident decoder.  ServeConfig flags used here:
    #      prefill_bucket_min=8   -- prompts pad to a geometric ladder of
    #                                lengths (8/16/.../max_len);
    #      prefill_chunk=4        -- the out-of-band prefill forward is
    #                                bounded to 4 tokens; a long prompt's tail
    #                                walks up to 4 tokens per tick INSIDE the
    #                                resident transition;
    #      paged=True, page_size=8 -- ONE shared pool of fixed-size KV pages:
    #                                admission reserves a worst-case page
    #                                count, decode maps ahead of the write
    #                                head (page_faults), eviction is a
    #                                page-table release.  Tokens are BITWISE
    #                                identical to the dense cache.
    # -----------------------------------------------------------------------
    cfg = dc.replace(get_reduced("internlm2-1.8b"), d_model=32, n_layers=2, d_ff=64, n_heads=2,
                     n_kv_heads=1, vocab_size=128)
    scfg = miso.ServeConfig(batch=4, max_len=32, prefill_bucket_min=8, prefill_chunk=4,
                            paged=True, page_size=8)
    lm_prog, lm_adapter = lm_engine_parts(cfg, scfg, device=dev)
    lm = miso.serve(lm_prog, lm_adapter, device=dev)
    lm.start(0)
    rng = np.random.default_rng(0)

    def mk(n):
        return rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)

    # the DMR request's replicas share the pool
    lm_reqs = [Request(prompt=mk(4), max_new_tokens=decode,
                       policy=miso.RedundancyPolicy(level=lv)) for lv in (1, 2)]
    for r in lm_reqs:
        lm.submit(r)
    lm.pump()
    pm = out["paged"] = lm.metrics()
    print(f"paged LM   : {pm['done']}/{pm['submitted']} requests done, "
          f"prefill buckets used={pm['prefill_buckets_used']} (chunk={pm['prefill_chunk']}), "
          f"pages {pm['pages_free']}/{pm['pages_total']} free after drain "
          f"(page_size={pm['page_size']}, page_faults={pm['page_faults']})")
    assert pm["done"] == 2 and pm["pages_free"] == pm["pages_total"]

    # -----------------------------------------------------------------------
    # 3. Speculative decoding: an engine built with ServeConfig(spec=...)
    #    keeps a resident draft; a request that ASKS for speculation
    #    (Request(spec=SpecConfig(draft_len=k))) decodes through the verify
    #    walk -- up to k+1 tokens commit per tick, and a rejection rolls the
    #    cache back by a position reset.  With the default self-drafting
    #    config the proposals are the target's own argmaxes, so no second
    #    model runs and every proposal accepts; the output must be BITWISE
    #    plain greedy decode's, so speculation is a pure throughput knob.
    # -----------------------------------------------------------------------
    spec_scfg = miso.ServeConfig(batch=4, max_len=32, spec=miso.SpecConfig(draft_len=4))
    sp_prog, sp_adapter = lm_engine_parts(cfg, spec_scfg, device=dev)
    sp = miso.serve(sp_prog, sp_adapter, device=dev)
    sp.start(0)
    prompt = mk(4)
    want = 2 * decode + 1
    spec_req = Request(prompt=prompt, max_new_tokens=want, spec=miso.SpecConfig(draft_len=4))
    sp.submit(spec_req)
    sp.pump()
    sm = out["spec"] = sp.metrics()

    # the same request through a PLAIN engine -- the parity oracle
    ref_prog, ref_adapter = lm_engine_parts(cfg, miso.ServeConfig(batch=4, max_len=32),
                                            device=dev)
    ref = miso.serve(ref_prog, ref_adapter, device=dev)
    ref.start(0)
    ref_req = Request(prompt=prompt, max_new_tokens=want)
    ref.submit(ref_req)
    ref.pump()

    spec_toks = sp.result(spec_req.id)["tokens"]
    ref_toks = ref.result(ref_req.id)["tokens"]
    assert sp.result(spec_req.id)["status"] == DONE and len(spec_toks) == want
    assert spec_toks == ref_toks, "speculation must not change tokens"
    print(f"speculation: {len(spec_toks)} tokens in {sm['spec_ticks']} verify "
          f"ticks ({sm['spec_tokens_per_tick']:.1f} tokens/tick, ceiling "
          f"draft_len+1=5) -- bitwise equal to plain greedy decode")
    out["spec_tokens"] = spec_toks

    print("\nNext: examples/serve_lm_torch.py (--strike: per-request fault attribution).")
    return out


if __name__ == "__main__":
    main()
