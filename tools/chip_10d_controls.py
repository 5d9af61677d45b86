"""Phase 10d of ``chip_smoke.py`` alone on one CUDA card, then controls of
its bf16 gate: the same mamba2-2.7b run with a fault put into the
sharded Mamba path at run time.

  * ``yroll``: each member's SSM output rolled by one of its heads;
  * ``shift``: each member reads its neighbour head's ``a_log`` and
    ``dt_bias`` (every (H,) f32 leaf the sharded path reads, rolled by
    one head), in bf16 and in f32.

A sound run passes every gate; each control should fail one, and its
message gives the reading.  Run on a machine with a card, e.g.
``python3 tools/chip_10d_controls.py [records.json]``: a summary goes to
standard output, the full records to the file named."""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch.models.ssm as ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
t0 = time.perf_counter()
build.build(["paged_gqa_decode", "ssd_scan"])
cs.log(f"build {time.perf_counter() - t0:.1f} s")
out = {}
for name in cs.SSM_ARCHS:
    for dt in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        r = cs.mp_10d_arch(name, dt)
        r["seconds"] = time.perf_counter() - t0
        out[f"{name} {dt}"] = r
        cs.gc.collect()
        torch.cuda.empty_cache()

real_L, real_ssm = ssm.L, ssm._ssm
H = ssm._dims(get_config("mamba2-2.7b"))[2]


class Shift:
    def __getattr__(self, k):
        return getattr(real_L, k)

    @staticmethod
    def value(w):
        v = real_L.value(w)
        return v.roll(1) if v.dim() == 1 and v.dtype == torch.float32 and v.shape[0] == H else v


def yroll(xh, *a, **k):
    y, hf, h1 = real_ssm(xh, *a, **k)
    return (y.roll(1, dims=2) if xh.shape[2] != H else y), hf, h1


controls = {}
for label, dt in (("yroll", "bfloat16"), ("shift", "bfloat16"), ("shift", "float32")):
    if label == "yroll":
        ssm._ssm = yroll
    else:
        ssm.L = Shift()
    try:
        cs.mp_10d_arch("mamba2-2.7b", dt)
        controls[f"{label} {dt}"] = "passed every gate"
    except AssertionError as e:
        controls[f"{label} {dt}"] = str(e)[:600]
    ssm.L, ssm._ssm = real_L, real_ssm
    cs.log(f"control {label} {dt}: {controls[f'{label} {dt}']}")
    cs.gc.collect()
    torch.cuda.empty_cache()
if len(sys.argv) > 1:
    with open(sys.argv[1], "w") as f:
        json.dump({"runs": out, "controls": controls}, f, default=str)
print(json.dumps({k: {"ref": v["reference"], "max_rel": v["max_rel"], "share": v["greedy_share"],
                      "k5": v["k5_member"], "s": v["seconds"]} for k, v in out.items()}))
