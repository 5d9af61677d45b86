"""Dependable training on unreliable hardware (paper §IV, end to end), in
PyTorch (the port's ``examples/dependable_training.py``).

Trains the same small LM under a campaign of injected soft errors
(single bit flips in one replica's freshly computed trainer state):

  A. no redundancy -- the strike silently corrupts training,
  B. DMR via host  -- every strike is *detected* (bitwise compare of the
                      two replica states) and repaired by the runtime's
                      third tie-breaking execution from the immutable
                      previous buffer,
  C. TMR           -- every strike is *corrected* by the bitwise majority
                      vote of the lock-step executor,
  D. the permanent-fault ledger: a device that keeps faulting crosses the
     ledger threshold and is flagged for maintenance.

It runs on the card unless --device cpu.

Run:  PYTHONPATH=src python examples/dependable_training_torch.py --device cpu
"""
import argparse
import dataclasses

import numpy as np

from repro_torch import api as miso
from repro_torch.configs import get_reduced
from repro_torch.core import FaultLedger, FaultSpec, RedundancyPolicy
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.lm_cells import TrainConfig, make_train_program
from repro_torch.optim.adamw import OptConfig
from repro_torch.tree import tree_leaves

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=40)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=64)
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()
STEPS = args.steps

cfg = get_reduced("internlm2-1.8b")
cfg = dataclasses.replace(cfg, d_model=128, n_layers=2, d_ff=384, n_heads=2, n_kv_heads=1)
tcfg = TrainConfig(
    data=DataConfig(batch=args.batch, seq_len=args.seq, vocab=cfg.vocab_size, kind="bigram"),
    opt=OptConfig(peak_lr=2e-3, warmup_steps=8, decay_steps=STEPS),
)


def make(policy):
    prog = make_train_program(cfg, tcfg).with_policies({"trainer": policy})
    return prog


def campaign(prog, n=4, replica=0):
    """Strikes against the trainer cell's state (leaf 5, as in JAX)."""
    rng = np.random.default_rng(7)
    return [FaultSpec.at(step=int(s), cell_id=prog.cell_id("trainer"), replica=replica, leaf=5,
                         index=int(rng.integers(1024)), bit=30)
            for s in np.linspace(5, STEPS - 5, n).astype(int)]


def loss_of(states):
    return float(states["trainer"]["metrics"]["loss"].reshape(-1)[0])


def drift(params, clean_params, replicated):
    return float(sum(
        ((a[0] if replicated else a).float() - b.float()).abs().max()
        for a, b in zip(tree_leaves(params), tree_leaves(clean_params))))


def run(prog, backend="lockstep", faults=None, ledger=None):
    kw = {"ledger": ledger} if ledger is not None else {}
    exe = miso.compile(prog, backend=backend, device=args.device, **kw)
    return exe, exe.run(exe.init(0), STEPS, start_step=0, faults=faults)


# ---- reference: clean run (no faults, no redundancy) ----------------------
_, clean = run(make(RedundancyPolicy()), backend="host")
clean_loss = loss_of(clean.states)
clean_params = clean.states["trainer"]["params"]
print(f"clean run           : final loss {clean_loss:.4f}")

# ---- A: unprotected, struck ------------------------------------------------
progA = make(RedundancyPolicy())
_, resA = run(progA, faults=campaign(progA, n=1)[0])
lossA = loss_of(resA.states)
driftA = drift(resA.states["trainer"]["params"], clean_params, False)
print(f"A unprotected       : final loss {lossA:.4f}  max param drift vs clean = "
      f"{driftA:.3e}  <- silent corruption")

# ---- B: DMR detect + host tie-break ---------------------------------------
progB = make(RedundancyPolicy(level=2))
exeB, resB = run(progB, backend="host", faults=campaign(progB, n=4), ledger=FaultLedger())
mB = exeB.metrics()
lossB = loss_of(resB.states)
driftB = drift(resB.states["trainer"]["params"], clean_params, True)
print(f"B DMR               : final loss {lossB:.4f}  detected "
      f"{mB['fault_totals']['trainer']['events']:.0f} strikes, "
      f"{len(mB['recoveries'])} tie-break recoveries, drift vs clean = {driftB:.3e}")

# ---- C: TMR corrects by vote -----------------------------------------------
progC = make(RedundancyPolicy(level=3))
_, resC = run(progC, faults=campaign(progC, n=1)[0])
lossC = loss_of(resC.states)
driftC = drift(resC.states["trainer"]["params"], clean_params, True)
print(f"C TMR               : final loss {lossC:.4f}  votes corrected "
      f"{float(resC.reports['trainer']['events']):.0f} strike(s), drift vs clean = {driftC:.3e}")

# ---- D: permanent-fault localization (paper §IV last paragraph) -----------
progD = make(RedundancyPolicy(level=2))
bad = [FaultSpec.at(step=s, cell_id=progD.cell_id("trainer"), replica=1, leaf=5, index=17, bit=22)
       for s in range(4, STEPS, 4)]
exeD, _ = run(progD, backend="host", faults=bad, ledger=FaultLedger(threshold=3))
suspects = exeD.metrics()["suspects"]
print(f"\npermanent-fault localization: ledger flagged {suspects} "
      "(cell, replica slot) -> maintenance + restart from a checkpoint (repro_torch/ft/elastic.py)")

assert abs(lossB - clean_loss) < 1e-3 and driftB < 1e-4, "DMR failed"
assert abs(lossC - clean_loss) < 1e-3 and driftC < 1e-4, "TMR failed"
assert driftA > 0, "the unprotected strike left no trace"
assert "trainer" in suspects, "the permanent fault was not flagged"
print("\nDMR/TMR preserved the clean trajectory under strikes; the unprotected run drifted.")
