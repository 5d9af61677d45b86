"""Quickstart in PyTorch: the MISO cell calculus in five minutes (the
port's ``examples/quickstart.py``).

A MISO program is a set of *cells* -- state + transition (paper §II).
You write the program ONCE; ``miso.compile()`` retargets it to any
execution back-end without touching the source:

    exe = miso.compile(prog, backend="lockstep" | "host" | "wavefront"
                                      | "auto", device="cuda")
    states = exe.init(seed)                # replica axes included
    result = exe.run(states, n_steps)      # -> RunResult(states, reports)
    exe.metrics()                          # fault ledger / compare stats

This walkthrough compiles one tiny program four ways:

  1. backend="lockstep"  -- one transition of every cell a step,
  2. backend="auto"      -- observes the dependency graph and (because this
     program has an independent cell) resolves to the barrier-free
     wavefront schedule (paper §III),
  3. backend="host" + DMR replication + an injected bit flip (paper §IV):
     the mismatch is detected, and the runtime's third tie-breaking
     execution repairs it,
  4. TMR on the lock-step back-end: corrected by majority vote,
  4b. (--placement spatial) the same DMR policy placed spatially: each
     replica on its own pod of a two-pod mesh (on the card: two pods of
     cuda:0, each its own allocation and stream), compared by a 16-byte
     fingerprint psum; ``auto`` resolves to ``spatial_lockstep``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py                 # on cuda
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
      PYTHONPATH=src python examples/quickstart_torch.py --backend lockstep_cuda

--backend picks the lock-step flavour used below: "lockstep" or
"lockstep_cuda" (each replicated cell's compare or vote fused into one
CUDA kernel a step; on CPU tensors the kernels' plain versions run).
--placement spatial adds section 4b.
"""
import argparse

import torch

from repro_torch import api as miso
from repro_torch.distributed import make_mesh

N = 64


# ---------------------------------------------------------------------------
# 1. A MISO program: a 1-D heat rod (SIMD stencil cell) + a probe cell (MIMD)
# ---------------------------------------------------------------------------
def rod_init(gen, device):
    t = torch.zeros((N,), dtype=torch.float32, device=device)
    t[N // 2] = 100.0
    return {"t": t}


def rod_transition(prev):
    """Reads ONLY the previous state (paper §II read-prev/write-next)."""
    t = prev["rod"]["t"]
    left = torch.cat([t[:1], t[:-1]])
    right = torch.cat([t[1:], t[-1:]])
    return {"t": 0.25 * left + 0.5 * t + 0.25 * right}


def probe_init(gen, device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"peak": z, "mean": z.clone()}


def probe_transition(prev):
    # a *different* cell type (MIMD) reading the rod's previous state
    t = prev["rod"]["t"]
    return {"peak": torch.max(t), "mean": torch.mean(t)}


def standalone_init(gen, device):
    return {"x": torch.ones((), dtype=torch.float32, device=device)}


def standalone_transition(prev):
    # no reads outside itself -> independent dependency component: the
    # wavefront back-end can run it ahead without a global barrier
    return {"x": prev["lfsr"]["x"] * 1.000001 + 0.5}


def program() -> miso.MisoProgram:
    prog = miso.MisoProgram()
    prog.add(miso.CellType("rod", rod_init, rod_transition, instances=N))
    prog.add(miso.CellType("probe", probe_init, probe_transition, reads=("rod",)))
    prog.add(miso.CellType("lfsr", standalone_init, standalone_transition))
    prog.validate()  # checks the §II single-output contract on fake tensors
    return prog


def main(argv=None) -> dict:
    """Run the four sections; returns their outcomes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="lockstep", choices=("lockstep", "lockstep_cuda"),
                    help="lock-step flavour (both are bitwise-identical)")
    ap.add_argument("--placement", default="temporal", choices=("temporal", "spatial"),
                    help="replica placement for section 4")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)
    backend, dev = ns.backend, ns.device
    print("""sections:
  1. cells + program     a heat rod (SIMD), a probe (MIMD), an
                         independent lfsr
  2. lockstep            one compile call, one transition of each cell a step
  3. backend="auto"      resolves to the barrier-free wavefront schedule
  4. DMR / TMR           an injected bit flip, detected and repaired
  5. serving             -> examples/serve_walkthrough_torch.py (continuous
                         batching, paged KV, speculative decoding)
""")
    prog = program()
    out = {}

    # -----------------------------------------------------------------------
    # 2. Lock-step execution: one compile call
    # -----------------------------------------------------------------------
    exe = miso.compile(prog, backend=backend, device=dev)
    final = exe.run(exe.init(0), 100, start_step=0).states
    out["peak"], out["mean"] = float(final["probe"]["peak"]), float(final["probe"]["mean"])
    print(f"{backend:<11}: after 100 steps  peak={out['peak']:7.3f} "
          f"mean={out['mean']:6.3f} (heat diffused)")

    # -----------------------------------------------------------------------
    # 3. backend="auto": the lfsr cell is independent of rod/probe, so auto
    #    resolves to the wavefront schedule (paper §III: no global barrier)
    #    -- same program, same states.
    # -----------------------------------------------------------------------
    wf = miso.compile(prog, backend="auto", window=4, device=dev)
    wfinal = wf.run(wf.init(0), 100).states
    same = bool(torch.allclose(wfinal["rod"]["t"], final["rod"]["t"]))
    m = wf.metrics()
    out.update(auto_backend=m["backend"], auto_same=same, max_lead=m["max_lead"])
    print(f"auto       : resolved backend={m['backend']!r}, identical result={same}, "
          f"max unit lead={m['max_lead']} steps (>0 proves barrier-free overlap)")
    assert same and m["backend"] == "wavefront" and m["max_lead"] > 0

    # -----------------------------------------------------------------------
    # 4. Dependability (paper §IV): DMR + injected soft error.  The SAME
    #    program compiles with a per-cell replication policy; the host
    #    back-end runs the detect/tie-break recovery protocol in the loop.
    # -----------------------------------------------------------------------
    dmr = miso.compile(prog, backend="host", device=dev,
                       policies={"rod": miso.RedundancyPolicy(level=2)})
    fault = miso.FaultSpec.at(step=50, cell_id=prog.cell_id("rod"), replica=0, leaf=0,
                              index=N // 2, bit=30)
    dfinal = dmr.run(dmr.init(0), 100, faults=[fault]).states
    repaired = bool(torch.allclose(dfinal["rod"]["t"][0], final["rod"]["t"]))
    dm = dmr.metrics()
    out.update(dmr_events=dm["fault_totals"]["rod"]["events"],
               dmr_detected=dmr.ledger.recent["rod"], dmr_recoveries=len(dm["recoveries"]),
               dmr_repaired=repaired)
    print(f"DMR        : bit flip at step 50 -> detected events="
          f"{out['dmr_events']:.0f}, tie-break recoveries={out['dmr_recoveries']}, "
          f"final state repaired={repaired}")
    assert repaired and out["dmr_events"] >= 1 and out["dmr_recoveries"] == 1

    # TMR corrects by majority vote, no host round trip, so it runs on the
    # lock-step back-end (with --backend lockstep_cuda the vote, the
    # per-replica counts and the state fingerprint are ONE CUDA kernel)
    tmr = miso.compile(prog, backend=backend, device=dev,
                       policies={"rod": miso.RedundancyPolicy(level=3)})
    tres = tmr.run(tmr.init(0), 100, start_step=0, faults=fault)
    ok = bool(torch.allclose(tres.states["rod"]["t"][0], final["rod"]["t"]))
    out.update(tmr_ok=ok, tmr_events=float(tres.reports["rod"]["events"]))
    print(f"TMR        : corrected in-graph={ok} "
          f"(votes fixed {out['tmr_events']:.0f} strike)")
    assert ok and out["tmr_events"] == 1

    # -----------------------------------------------------------------------
    # 4b. (--placement spatial) The SAME policy knob, spatial placement:
    #     each replica runs on its own pod of a mesh, and the compare is a
    #     cross-pod collective -- a 16-byte fingerprint psum (compare="hash")
    #     instead of moving O(state) bytes.  backend="auto" sees the
    #     placement request and a mesh with a pod axis and resolves to the
    #     spatial back-end; run/stream/faults/ledger are the inherited
    #     Executor protocol.  On one card the two pods are two allocations
    #     and two streams of that card, asked for explicitly.
    # -----------------------------------------------------------------------
    if ns.placement == "spatial":
        on = torch.device(dev)
        mesh = make_mesh((2,), ("pod",), devices=[on] * 2)
        print(f"mesh       : {mesh}")
        sp = miso.compile(prog, backend="auto", mesh=mesh,
                          policies={"rod": miso.RedundancyPolicy(
                              level=2, placement="spatial", compare="hash")})
        sres = sp.run(sp.init(0), 100, start_step=0, faults=fault)
        sm = sp.metrics()
        srepaired = bool(torch.allclose(sp.gather(sres.states)["rod"]["t"][0],
                                        final["rod"]["t"]))
        out.update(spatial_backend=sm["backend"], spatial_pods=sm["n_pods"],
                   spatial_detected=sp.ledger.recent["rod"][0], spatial_repaired=srepaired)
        print(f"spatial DMR: backend={sm['backend']!r} pods={sm['n_pods']} "
              f"compare=16-byte fingerprint psum; strike detected at step "
              f"{out['spatial_detected']} (repaired={srepaired}: DMR detects; repair "
              "is the host/serving tie-break)")
        # a whole fault campaign: the executor replays the trajectory once
        # per FaultSpec, with no ledger or counter side effects
        rod = prog.cell_id("rod")
        campaign = [miso.FaultSpec.at(step=s, cell_id=rod, replica=s % 2, index=N // 2, bit=30)
                    for s in (10, 40, 70)]
        camp = sp.run_campaign(sp.init(0), 100, campaign, start_step=0)
        out["campaign_events"] = [float(e) for e in camp.reports["rod"]["events"]]
        print(f"campaign   : {len(campaign)} strikes -> per-strike detection events "
              f"{out['campaign_events']}")
        assert sm["backend"] == "spatial_lockstep" and out["spatial_detected"] == 50

    print("\nNew back-ends register with miso.register_backend without touching "
          "this file (the CUDA-fused lock-step plugged in exactly that way).")
    print("\nNext: examples/serve_walkthrough_torch.py -- the same cells, served: "
          "continuous batching with per-request DMR/TMR, paged KV, and "
          "speculative decoding.")
    return out


if __name__ == "__main__":
    main()
