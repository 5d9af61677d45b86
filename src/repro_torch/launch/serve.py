"""Serving launcher (a port of ``repro/launch/serve.py``).

Default path -- the continuous-batching engine (``api.serve``): one
resident slot-masked decoder; requests with mixed per-request
dependability policies join and leave the batch mid-stream; prints the
SLO surface (tokens/s, TTFT p50/p99, per-request faults).  It runs on
the card unless --device cpu.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch internlm2-1.8b --reduced --slots 4 --requests 6 --mix none,dmr --decode 12

Prefill is bucketed (``--prefill-bucket-min``: prompts are right-padded
to a geometric ladder of lengths) and optionally chunked
(``--prefill-chunk``: the out-of-band forward is bounded to the chunk,
the prompt tail walks through the resident transition one token per
tick).  ``--paged`` keeps the KV cache in a shared pool of
``--page-size``-token pages.  ``--spec-k K`` turns on speculative
decoding (``--spec-arch`` names a reduced config for a divergent draft;
default: self-drafting).  ``--strike`` arms one bit flip against the
last DMR request's second replica slot mid-decode and exits non-zero
unless it is detected, attributed to that request and repaired; with
--spec-k give --decode headroom (> 2*(K+1)) so the victim is still
resident when the flip lands.

The engine path serves single-codebook archs: the reference launcher
draws 1-D prompts, which a multi-codebook arch cannot take, so this
launcher refuses such an arch (``--static`` serves it).
``--placement spatial`` places replica slots one a pod of a mesh over
the distinct devices (the CUDA cards, or the one CPU with --device
cpu): ``--pods`` (default min(4, devices)) must divide their number, as
in the JAX launcher, so on one card the launcher serves 1 pod, which is
the temporal engine bit for bit.  Several pods on one card go through
``api.serve`` with an explicit mesh (``distributed.make_mesh(...,
devices=["cuda:0"] * n)``).

``--static`` keeps the fixed-batch reference path: prefill a batch of
identical-length prompts, then decode the whole batch a step at a time
(optionally with cell-level DMR/TMR on the whole decoder).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --static \\
      --arch mamba2-2.7b --reduced --batch 4 --prompt-len 12 --decode 24
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import api as miso
from .. import prng
from ..configs import get_config, get_reduced
from ..core import RedundancyPolicy
from ..core.executor import resolve_device
from ..core.redundancy import canonical_state, replicate_state
from ..models import transformer as T
from ..models.lm_cells import ServeConfig, install_prefill, make_serve_program

POLICIES = {"none": RedundancyPolicy(),
            "dmr": RedundancyPolicy(level=2),
            "tmr": RedundancyPolicy(level=3)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--decode", type=int, default=24,
                    help="tokens per request (engine) / steps (static)")
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    # engine path
    ap.add_argument("--slots", type=int, default=4, help="resident batch width of the engine")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--mix", default="none,dmr",
                    help="comma list of per-request policies to cycle (none|dmr|tmr)")
    ap.add_argument("--strike", action="store_true",
                    help="inject one bit flip into the last DMR request's replica slot "
                         "and verify attribution")
    ap.add_argument("--placement", default="temporal", choices=["temporal", "spatial"],
                    help="where replica slots live: temporal = batch rows of one "
                         "device; spatial = one column across mesh pods")
    ap.add_argument("--pods", type=int, default=0,
                    help="mesh pods for --placement spatial (default min(4, devices); "
                         "must divide the number of distinct devices)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: bound the out-of-band prefill to this many "
                         "tokens; the prompt tail walks through the resident transition "
                         "one token per tick (0 = whole prompt)")
    ap.add_argument("--prefill-bucket-min", type=int, default=16,
                    help="smallest prefill bucket (geometric ladder up to --max-len; "
                         "0 = exact-length prefills)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: fixed-size pages in one shared pool instead of "
                         "a per-slot contiguous cache")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (--paged; must divide --max-len)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: draft length k (every request asks for "
                         "it; 0 = plain decode)")
    ap.add_argument("--spec-arch", default="",
                    help="draft architecture for --spec-k (reduced config name; "
                         "empty = self-drafting)")
    # observability
    ap.add_argument("--trace-out", default="",
                    help="attach a tracer and export the run as Chrome trace-event JSON "
                         "to this path")
    ap.add_argument("--metrics-json", default="",
                    help="write the metrics-registry snapshot (JSON) to this path on exit")
    # static path
    ap.add_argument("--static", action="store_true",
                    help="fixed-batch reference path (no engine)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--redundancy", default="none", choices=["none", "dmr", "tmr"],
                    help="static path: cell-level policy on the decoder")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    """Serve; returns ``engine_main``'s or ``static_main``'s result."""
    args = parser().parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.static:
        return static_main(cfg, args)
    return engine_main(cfg, args)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ===========================================================================
# continuous-batching engine path
# ===========================================================================
def engine_main(cfg, args, *, states=None):
    """Serve ``--requests`` staggered requests through the engine and
    print its SLO surface; returns the engine.  ``states`` (weights and
    empty slots, e.g. the JAX package's through ``repro_torch.bridge``)
    replace the seeded init."""
    from ..serving import DONE, RUNNING, Request
    from ..serving.lm import lm_engine_parts

    if cfg.n_codebooks > 1:
        raise SystemExit(
            f"the engine path cannot serve {cfg.name}: its {cfg.n_codebooks} codebooks need "
            "(P, K) prompts, and the reference launcher draws 1-D prompts (its engine fails "
            "to reshape them); serve it with --static")
    device = resolve_device(args.device)
    spec = None
    if args.spec_k:
        from ..models.lm_cells import SpecConfig

        spec = SpecConfig(draft_len=args.spec_k, draft_arch=args.spec_arch)
    spatial = args.placement == "spatial"
    mesh = _spatial_mesh(args, device) if spatial else None
    scfg = ServeConfig(batch=args.slots, max_len=args.max_len,
                       prefill_chunk=args.prefill_chunk,
                       prefill_bucket_min=args.prefill_bucket_min,
                       paged=args.paged, page_size=args.page_size, spec=spec,
                       placement=args.placement)
    prog, adapter = lm_engine_parts(cfg, scfg, device=device)
    tracer = miso.Tracer() if args.trace_out else None
    engine = miso.serve(prog, adapter, miso.EngineConfig(
        placement=args.placement, mesh=mesh, tracer=tracer), device=device)
    engine.start(args.seed, states=states)
    policies = POLICIES
    if spatial:
        print(f"placement: spatial ({engine.pods} pods x {args.slots // engine.pods} slots, "
              f"backend={engine.exe.name}, mesh={mesh})")
        policies = {k: RedundancyPolicy(level=p.level, placement="spatial") if p.level > 1 else p
                    for k, p in POLICIES.items()}

    # the reference launcher's prompts, drawn the same way
    rng = np.random.default_rng(args.seed + 1)
    mix = [m.strip() for m in args.mix.split(",") if m.strip()]
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(2, max(3, args.prompt_len + 1)))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        reqs.append(Request(prompt=prompt, max_new_tokens=args.decode,
                            policy=policies[mix[i % len(mix)]], spec=spec))

    # staggered submission: half now, half after a few ticks, so requests
    # genuinely join/leave the resident batch mid-stream
    _sync(device)
    t0 = time.time()
    for r in reqs[: max(1, len(reqs) // 2)]:
        engine.submit(r)
    engine.pump(max_ticks=3)
    for r in reqs[max(1, len(reqs) // 2):]:
        engine.submit(r)

    fault = None
    victim = next((r for r in reversed(reqs) if r.policy.level == 2), None)
    if args.strike:
        if victim is None:
            raise SystemExit("--strike needs a dmr request in --mix")
        # tick until the victim is resident with decode budget left, then
        # arm a flip against its SECOND replica slot.  The flip fires one
        # tick after the arming tick, and a speculative tick commits up to
        # spec_k+1 tokens, so the victim needs that much headroom
        margin = args.spec_k + 2
        rec = engine.requests[victim.id]
        for _ in range(10 * args.decode):
            if rec.status == RUNNING and len(rec.tokens) + margin <= victim.max_new_tokens:
                break
            engine.pump(max_ticks=1)
        if rec.status != RUNNING:
            raise SystemExit("strike victim never became resident")
        fault = miso.FaultSpec.at(
            step=engine.exe.metrics()["steps"] + 1, cell_id=prog.cell_id("decoder"),
            leaf=_tokens_leaf(cfg, args, spec), index=rec.slots[1], bit=4)
    engine.pump(faults=fault)
    _sync(device)
    wall = time.time() - t0

    m = engine.metrics()
    print(f"engine: {m['done']}/{m['submitted']} requests done | "
          f"{m['tokens_out']} tokens in {wall:.2f}s "
          f"({m['tokens_out'] / max(wall, 1e-9):.1f} tok/s wall, "
          f"{m['tokens_per_s_busy']:.1f} tok/s busy, "
          f"util={m['utilization']:.0%}) | "
          f"ttft p50={m.get('ttft_p50_s', 0):.3f}s "
          f"p99={m.get('ttft_p99_s', 0):.3f}s")
    print("metrics:")
    print(engine.registry.render("serving_"))
    print(f"prefill: {m['prefill_buckets_used']} buckets used "
          f"(buckets={m['prefill_buckets']}, chunk={m['prefill_chunk']}) | "
          f"defrag moves={m['defrag_moves']}")
    if m.get("paged"):
        print(f"paged: {m['pages_free']}/{m['pages_total']} pages free "
              f"(size={m['page_size']}) | page faults={m['page_faults']}")
    if args.spec_k:
        print(f"spec: k={args.spec_k} draft={args.spec_arch or 'self'} | "
              f"{m['spec_tokens']} tokens over {m['spec_ticks']} verify "
              f"ticks ({m.get('spec_tokens_per_tick', 0):.2f}/tick, "
              f"min commit={m.get('spec_min_commit')})")
    for r in reqs:
        res = engine.result(r.id)
        mark = f" policy={r.policy.level}" if r.policy.level > 1 else ""
        print(f"  {r.id}: {res['status']} {res['n_tokens']} tok "
              f"faults={res['faults']}{mark} -> {res['tokens'][:8]}")
    bad = [r.id for r in reqs if engine.result(r.id)["status"] != DONE]
    if bad:
        raise SystemExit(f"requests did not complete: {bad}")
    if args.strike:
        res = engine.result(victim.id)
        if res["faults"] < 1 or victim.id not in m["fault_totals"]:
            raise SystemExit("strike was not attributed to its request")
        print(f"strike: detected, attributed to {victim.id}, repaired "
              f"(events={m['fault_totals'][victim.id]['events']:.0f})")
    if tracer is not None:
        if args.strike:
            # the repair instant must be on the struck request's own track
            vtid = tracer.tid(victim.id)
            if not any(e.get("name") == "strike_repaired" and e["tid"] == vtid
                       for e in tracer.events()):
                raise SystemExit("strike repair event missing from trace")
        tracer.export(args.trace_out)
        print(f"trace: {tracer.emitted} events ({tracer.dropped} dropped) -> {args.trace_out}")
    if args.metrics_json:
        engine.metrics()  # refresh gauges before snapshotting
        with open(args.metrics_json, "w", encoding="utf-8") as f:
            json.dump(engine.registry.snapshot(), f, indent=1)
        print(f"metrics snapshot -> {args.metrics_json}")
    return engine


def _spatial_mesh(args, device: torch.device):
    """The JAX launcher's rule over the distinct devices present (the
    CUDA cards, or the CPU): ``--pods`` (default min(4, devices)) must
    divide their number and ``--slots``; the mesh is (pods, devices /
    pods) over ("pod", "data")."""
    from ..distributed import make_mesh

    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    pods = args.pods or min(4, n_dev)
    if n_dev % pods:
        raise SystemExit(f"--pods {pods} does not divide {n_dev} devices")
    if args.slots % pods:
        raise SystemExit(f"--slots {args.slots} must be a multiple of --pods {pods}")
    devices = None if device.type == "cuda" else [device] * n_dev
    return make_mesh((pods, n_dev // pods), ("pod", "data"), devices=devices)


def _tokens_leaf(cfg, args, spec) -> int:
    """Flat index of the decoder's ``tokens`` leaf, from the same state
    layout the engine runs (paged trees order differently, and a
    speculating decoder carries extra leaves), made on the meta device."""
    from ..models.lm_cells import (
        paged_serving_supported,
        paged_slot_decoder_init,
        resolve_draft_config,
        slot_decoder_init,
        spec_serving_supported,
    )
    from ..tree import leaf_index

    dcfg, dlen = None, 0
    if spec is not None and spec_serving_supported(cfg):
        dcfg, dlen = resolve_draft_config(cfg, spec), spec.draft_len
    if args.paged and paged_serving_supported(cfg):
        example = paged_slot_decoder_init(cfg, 2, args.max_len, args.page_size, 1, "meta",
                                          dcfg, dlen)
    else:
        example = slot_decoder_init(cfg, 2, args.max_len, "meta", dcfg, dlen)
    return leaf_index(example, "tokens")


# ===========================================================================
# static fixed-batch reference path
# ===========================================================================
def static_main(cfg, args, *, states=None, backend="lockstep", faults=None) -> dict:
    """Prefill ``--batch`` prompts of ``--prompt-len`` tokens in one
    forward, install the filled cache into every decoder replica, then
    decode ``--decode`` greedy steps of the whole batch under the
    ``--redundancy`` policy.  ``states`` replace the seeded init;
    ``backend`` and ``faults`` go to the executor.  Returns the collected
    tokens of replica 0 ((decode, batch, 1[, K]) on the host), the
    reports, the executor and the prefill and decode seconds."""
    device = resolve_device(args.device)
    scfg = ServeConfig(batch=args.batch, max_len=args.max_len)
    policy = POLICIES[args.redundancy]
    prog = make_serve_program(cfg, scfg).with_policies({"decoder": policy})
    exe = miso.compile(prog, backend=backend, device=device)
    if states is None:
        states = exe.init(args.seed)

    # prefill: the real batched forward with cache fill, then the cache
    # installed into the decoder cell's state
    shape = (args.batch, args.prompt_len)
    if cfg.n_codebooks > 1:
        shape = shape + (cfg.n_codebooks,)
    prompts = prng.randint(prng.PRNGKey(args.seed + 1, device), shape, 0, cfg.vocab_size)
    # prefill reads the canonical (replica-0) view of the weights
    params = canonical_state(states["weights"], prog.cells["weights"].redundancy.level)["params"]
    _sync(device)
    t0 = time.time()
    vision = None
    if cfg.n_vision_tokens:
        vision = torch.zeros((args.batch, min(cfg.n_vision_tokens, args.prompt_len), cfg.d_model),
                             dtype=cfg.compute_dtype, device=device)
    with torch.no_grad():
        logits, cache = T.forward(cfg, params, prompts, vision_embeds=vision, fill_cache=True)
    # pad the filled cache up to max_len and install it into EVERY decoder
    # replica: replicas start from the same prefill
    filled = install_prefill(cfg, T.init_cache(cfg, args.batch, args.max_len, device), cache,
                             args.prompt_len)
    dec = dict(canonical_state(states["decoder"], policy.level))
    dec["cache"] = filled
    dec["tokens"] = _first_token(cfg, logits)
    states = dict(states)
    states["decoder"] = replicate_state(dec, policy.level)
    _sync(device)
    t_prefill = time.time() - t0

    t1 = time.time()
    with torch.no_grad():
        res = exe.run(
            states, args.decode, faults=faults,
            collect=lambda st: (st["decoder"]["tokens"] if policy.level == 1
                                else st["decoder"]["tokens"][0]),
        )
    toks = res.collected.cpu().numpy()
    t_decode = time.time() - t1
    print(f"prefill {args.prompt_len} tok x{args.batch}: {t_prefill:.2f}s | "
          f"decode {args.decode} steps: {t_decode:.2f}s "
          f"({args.decode * args.batch / max(t_decode, 1e-9):.1f} tok/s)")
    seq = toks[:, 0].reshape(args.decode, -1)[:, 0]
    print("sample continuation (seq 0):", seq.tolist())
    if policy.level > 1:
        print("redundancy events:", float(res.reports["decoder"]["events"]))
    return {"tokens": toks, "reports": res.reports, "exe": exe,
            "prefill_s": t_prefill, "decode_s": t_decode}


def _first_token(cfg, logits: torch.Tensor) -> torch.Tensor:
    nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    if cfg.n_codebooks > 1:
        return nxt.reshape(nxt.shape[0], 1, cfg.n_codebooks)
    return nxt


if __name__ == "__main__":
    main()
