"""End-to-end LM training through the MISO runtime, in PyTorch (the port's
``examples/train_lm.py``).

The training loop *is* a MISO program -- a ``data`` source cell feeding a
``trainer`` cell whose transition is forward + backward + AdamW --
compiled with ``compile(program, backend="host")`` so the §IV recovery
protocol and checkpoints of the immutable previous buffer run in the
loop.  It runs on the card unless --device cpu; the defaults are small
(an internlm2-family model of a few million parameters), and the loss
falls below the uniform floor toward the bigram entropy floor.

Run:  PYTHONPATH=src python examples/train_lm_torch.py            # on cuda
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 40
"""
import argparse
import dataclasses
import math
import os
import tempfile
import time

from repro_torch import api as miso
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, bigram_optimal_xent
from repro_torch.models.lm_cells import TrainConfig, make_train_program
from repro_torch.optim.adamw import OptConfig

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="internlm2-1.8b")
ap.add_argument("--d-model", type=int, default=256)
ap.add_argument("--layers", type=int, default=4)
ap.add_argument("--steps", type=int, default=120)
ap.add_argument("--batch", type=int, default=16)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "miso_train_lm_torch_ckpt"))
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

# a same-family config at the requested width
cfg = get_reduced(args.arch)
cfg = dataclasses.replace(
    cfg, d_model=args.d_model, n_layers=args.layers,
    d_ff=int(args.d_model * 8 / 3 // 64 * 64) or 128,
    n_heads=max(args.d_model // 64, 1),
    n_kv_heads=max(args.d_model // 128, 1),
)
tcfg = TrainConfig(
    data=DataConfig(batch=args.batch, seq_len=args.seq, vocab=cfg.vocab_size, kind="bigram"),
    opt=OptConfig(peak_lr=3e-3, warmup_steps=20, decay_steps=args.steps),
)

program = make_train_program(cfg, tcfg)
exe = miso.compile(program, backend="host", device=args.device,
                   checkpoint_cb=ckpt.callback(args.ckpt_dir), checkpoint_every=40)
print(f"family={cfg.name}  params={cfg.n_params()/1e6:.1f}M  "
      f"tokens/step={args.batch * args.seq}  device={args.device}")
floor = bigram_optimal_xent(tcfg.data, device=args.device)
print(f"uniform floor {math.log(cfg.vocab_size):.3f} | bigram entropy floor {floor:.3f} nats")

states = exe.init(0)
start = 0
if ckpt.latest_step(args.ckpt_dir) is not None:
    states, start = ckpt.restore(args.ckpt_dir, states)
    print(f"resumed from checkpoint @ step {start} (fault-tolerant restart path)")

t0 = time.time()
for step in range(start, args.steps, 20):
    n = min(20, args.steps - step)
    states = exe.run(states, n, start_step=step).states
    m = states["trainer"]["metrics"]
    tps = args.batch * args.seq * (step + n - start) / (time.time() - t0)
    print(f"step {step + n:4d}  loss {float(m['loss']):.4f}  "
          f"grad_norm {float(m['grad_norm']):.3f}  lr {float(m['lr']):.2e}  {tps:,.0f} tok/s")

final = float(states["trainer"]["metrics"]["loss"])
assert final < math.log(cfg.vocab_size), "did not beat uniform"
print(f"\nfinal loss {final:.4f} — beat the uniform floor; "
      f"gap to bigram entropy floor: {final - floor:+.3f} nats")
print(f"checkpoints in {args.ckpt_dir} (restart me to resume)")
