"""LM serving through the MISO continuous batcher in PyTorch (the port's
``examples/serve_lm.py``).

One resident slot-masked decoder program (weights cell + decoder cell) is
compiled once and driven through ``Executor.stream``; independent
requests with *per-request* dependability policies join and leave its
batch between ticks:

  * request A asks for nothing (1 slot),
  * request B asks for DMR (2 replica slots: detection + §IV third-
    execution repair, charged to B alone),
  * request C asks for TMR (3 replica slots: majority repair),

and none of them can perturb the others' tokens.

Prefill is bucketed (prompts padded to a geometric ladder of lengths)
and chunked (``prefill_chunk``: long prompts join at once and walk their
tail one token per tick inside the resident transition).

Run:  PYTHONPATH=src python examples/serve_lm_torch.py                  # on cuda
      PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
      PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --arch mamba2-2.7b
      PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --strike   # flip a bit
"""
import argparse

import numpy as np

from repro_torch import api as miso
from repro_torch.configs import get_reduced
from repro_torch.models.lm_cells import ServeConfig, slot_decoder_init
from repro_torch.serving import DONE, Request
from repro_torch.serving.lm import lm_engine_parts
from repro_torch.tree import leaf_index


def main(argv=None) -> dict:
    """Serve A, B and C; returns the engine's metrics and each one's
    result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--decode", type=int, default=8)
    ap.add_argument("--slots", type=int, default=6)
    ap.add_argument("--prefill-chunk", type=int, default=4)
    ap.add_argument("--strike", action="store_true",
                    help="inject a bit flip into the DMR request's replica")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)  # a reduced config of the arch
    scfg = ServeConfig(batch=args.slots, max_len=64, prefill_chunk=args.prefill_chunk,
                       prefill_bucket_min=8)
    prog, adapter = lm_engine_parts(cfg, scfg, device=args.device)  # EngineParts
    engine = miso.serve(prog, adapter, miso.EngineConfig(), device=args.device)
    engine.start(0)

    rng = np.random.default_rng(0)

    def mk(n):
        return rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)

    a = Request(prompt=mk(5), max_new_tokens=args.decode)
    b = Request(prompt=mk(3), max_new_tokens=args.decode, policy=miso.RedundancyPolicy(level=2))
    c = Request(prompt=mk(4), max_new_tokens=args.decode, policy=miso.RedundancyPolicy(level=3))

    engine.submit(a)
    engine.pump(max_ticks=2)  # a is mid-decode...
    engine.submit(b)          # ...when b and c join its batch
    engine.submit(c)

    fault = None
    if args.strike:
        engine.pump(max_ticks=1)  # b resident -> aim at its replica slot 1
        leaf = leaf_index(slot_decoder_init(cfg, 2, 64, "meta"), "tokens")
        fault = miso.FaultSpec.at(step=engine.exe.metrics()["steps"] + 1,
                                  cell_id=prog.cell_id("decoder"), leaf=leaf,
                                  index=engine.requests[b.id].slots[1], bit=5)
    engine.pump(faults=fault)  # drain

    m = engine.metrics()
    print(f"{m['done']}/{m['submitted']} done | {m['tokens_out']} tokens | "
          f"{m['tokens_per_s']:.1f} tok/s | ttft p50={m.get('ttft_p50_s', 0):.3f}s | "
          f"prefill buckets used={m['prefill_buckets_used']} (buckets={m['prefill_buckets']})")
    results = {}
    for name, r in (("A none", a), ("B dmr ", b), ("C tmr ", c)):
        res = results[name.strip()] = engine.result(r.id)
        print(f"  {name}: {res['status']:8s} slots={res['slots']} "
              f"faults={res['faults']} tokens={res['tokens']}")
        assert res["status"] == DONE and res["n_tokens"] == args.decode
    if args.strike:
        assert results["B dmr"]["faults"] >= 1, "strike missed"
        assert results["A none"]["faults"] == results["C tmr"]["faults"] == 0
        print("strike: attributed to B + repaired")
    return {"metrics": m, "requests": results}


if __name__ == "__main__":
    main()
