"""End-to-end training launcher (a port of ``repro/launch/train.py``).

The training loop is a MISO program (data cell -> trainer cell) compiled
through ``compile(prog, backend="host")``: per-step DMR tie-breaks,
fault-ledger accounting and checkpoints of the immutable previous
buffer.  Fail-stop recovery is built in: rerunning with the same
--ckpt-dir resumes from the latest intact checkpoint (--simulate-failure
N crashes after step N and restarts from it).  It runs on the card
unless --device cpu.  ``prog.validate()`` checks the §II contract on
fake tensors before anything is allocated.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch internlm2-1.8b --reduced --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch mamba2-2.7b --reduced --steps 20 --redundancy dmr --inject-fault 7
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time

from .. import api as miso
from ..checkpoint import ckpt
from ..configs import get_config, get_reduced
from ..core import FaultLedger, FaultSpec, RedundancyPolicy
from ..data.pipeline import MAX_XENT_VOCAB, DataConfig, bigram_optimal_xent
from ..ft.elastic import elastic_resume
from ..models.lm_cells import TrainConfig, make_train_program
from ..optim.adamw import OptConfig

POLICIES = {
    "none": RedundancyPolicy(),
    "dmr": RedundancyPolicy(level=2),
    "dmr_hash": RedundancyPolicy(level=2, compare="hash"),
    "tmr": RedundancyPolicy(level=3),
}


def strike(prog, step: int) -> FaultSpec:
    """--inject-fault's strike: one bit of replica 0's fresh trainer
    state (leaf 5, element 11, bit 19, as the JAX launcher aims it)."""
    return FaultSpec.at(step=step, cell_id=prog.cell_id("trainer"), replica=0, leaf=5, index=11,
                        bit=19)


def build(args):
    """(model config, train config, program) from the parsed flags."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model, n_layers=args.layers or cfg.n_layers,
                                  d_ff=args.d_model * 4)
    tcfg = TrainConfig(
        data=DataConfig(batch=args.batch, seq_len=args.seq, vocab=cfg.vocab_size, kind=args.data,
                        n_codebooks=cfg.n_codebooks, seed=args.seed),
        opt=OptConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                      decay_steps=max(args.steps, 2 * args.warmup)),
        microbatches=args.microbatches,
    )
    prog = make_train_program(cfg, tcfg).with_policies({"trainer": POLICIES[args.redundancy]})
    return cfg, tcfg, prog


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--d-model", type=int, default=0, help="override width (custom-size run)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", default="bigram", choices=["bigram", "uniform"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--redundancy", default="none", choices=sorted(POLICIES))
    ap.add_argument("--inject-fault", type=int, default=-1,
                    help="flip a bit in replica 0's output at this step")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--log-file", default="")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None):
    """Train; returns (final states, executor, log rows)."""
    args = parser().parse_args(argv)
    cfg, tcfg, prog = build(args)
    prog.validate()
    print(f"arch={cfg.name} params~{cfg.n_params()/1e6:.1f}M batch={args.batch} seq={args.seq} "
          f"steps={args.steps} redundancy={args.redundancy} device={args.device}")
    if args.data == "bigram":
        if cfg.vocab_size <= MAX_XENT_VOCAB:
            floor = bigram_optimal_xent(tcfg.data, device=args.device)
            print(f"bigram entropy floor: {floor:.3f} nats "
                  f"(uniform: {math.log(cfg.vocab_size):.3f})")
        else:
            print(f"bigram entropy floor: not computed for vocab {cfg.vocab_size} "
                  f"(above {MAX_XENT_VOCAB}); uniform: {math.log(cfg.vocab_size):.3f}")

    exe = miso.compile(
        prog, backend="host", device=args.device, ledger=FaultLedger(),
        checkpoint_cb=ckpt.callback(args.ckpt_dir) if args.ckpt_dir else None,
        checkpoint_every=args.ckpt_every if args.ckpt_dir else 0,
    )
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        states, start_step = elastic_resume(args.ckpt_dir, exe, generator=args.seed)
        print(f"restored checkpoint at step {start_step}")
    else:
        states = exe.init(args.seed)
    faults = []
    if args.inject_fault >= 0:
        faults.append(strike(prog, args.inject_fault))

    log_rows = []
    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    step = start_step
    try:
        while step < args.steps:
            n = min(args.log_every, args.steps - step)
            if args.simulate_failure >= 0 and step <= args.simulate_failure < step + n:
                n = args.simulate_failure - step + 1
            states = exe.run(states, n, faults=faults, start_step=step).states
            step += n
            m = states["trainer"]["metrics"]
            loss = float(m["loss"].reshape(-1)[0])
            gn = float(m["grad_norm"].reshape(-1)[0])
            tps = tokens_per_step * (step - start_step) / max(time.time() - t0, 1e-9)
            row = {"step": step, "loss": round(loss, 4), "grad_norm": round(gn, 3),
                   "tokens_per_s": round(tps, 1), "recoveries": len(exe.recoveries)}
            log_rows.append(row)
            print(json.dumps(row), flush=True)
            if args.simulate_failure >= 0 and step > args.simulate_failure:
                print(f"simulated fail-stop at step {step} — restarting from checkpoint")
                if not args.ckpt_dir:
                    raise SystemExit("--simulate-failure needs --ckpt-dir")
                del states  # the crashed process's memory is gone
                states, step = elastic_resume(args.ckpt_dir, exe, generator=args.seed)
                args.simulate_failure = -1
    finally:
        if args.log_file:
            mt = exe.metrics()
            pathlib.Path(args.log_file).write_text(json.dumps({
                "config": vars(args), "rows": log_rows,
                "ledger": mt["fault_totals"], "recoveries": mt["recoveries"],
            }, indent=1))
    if exe.ledger.flagged:
        print("permanent-fault suspects:", exe.metrics()["suspects"])
    print(f"done: {step} steps in {time.time() - t0:.1f}s; "
          f"final loss {log_rows[-1]['loss'] if log_rows else float('nan')}")
    return states, exe, log_rows


if __name__ == "__main__":
    main()
