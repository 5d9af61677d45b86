#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device and nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``);
imports nothing of JAX.  Phases, each of which raises on failure:

  1. build    -- every CUDA kernel of the serving path, from
                 ``src/repro_torch/csrc``, one nvcc per source in parallel.
  2. kernels  -- each kernel against its plain PyTorch version on the card
                 at the serving path's shapes, with its tolerance; device
                 times (CUDA-graph replays, so host overhead is excluded)
                 of the kernel, the plain version and a library yardstick,
                 beside the bound computed from this run's inputs.
  3. engine   -- the main path: ``repro_torch.api.serve`` on full-width,
                 full-depth internlm2-1.8b (bf16, random weights from a
                 seed) with paged KV: 8 staggered requests, policies
                 cycling none/dmr/tmr, one bit flip struck into a DMR
                 replica slot.  Every request must finish, the strike must
                 be detected, attributed and repaired, and every kernel's
                 launch count must match the decoder steps the run took.
  4. check    -- a reduced f32 model served the same way must emit the
                 tokens a full-sequence forward pass predicts.

The last lines are the engine's and the kernels' JSON records, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SEED = 0
KERNELS = ["paged_gqa_decode"]


def log(msg: str) -> None:
    print(msg, flush=True)


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, the graph replayed ``iters`` times between CUDA events."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * iters)


def events_ms(fn, iters: int = 20) -> float:
    """Wall time per call on the device clock, host overhead included."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# --------------------------------------------------------------------------
# phase 2: K5 against its plain version
# --------------------------------------------------------------------------
def paged_inputs(dtype, gen, B=8, Hq=16, Hkv=8, Dk=128, ps=16, max_len=512):
    """The serving path's K5 shapes, with unmapped pages, ``pos`` at page
    edges, one slot with nothing mapped and one row past the pool."""
    P = max_len // ps
    N = B * P
    dev = "cuda"
    q = torch.randn((B, Hq, Dk), generator=gen, device=dev).to(dtype)
    k = torch.randn((N, Hkv, ps, Dk), generator=gen, device=dev).to(dtype)
    v = torch.randn((N, Hkv, ps, Dk), generator=gen, device=dev).to(dtype)
    pages = torch.randperm(N, generator=gen, device=dev).reshape(B, P).to(torch.int32)
    pages[1, P // 2 :] = -1  # half the slot unmapped
    pages[3, ::3] = -1  # holes
    pages[7, :] = -1  # nothing mapped
    pages[5, 3] = N + 9  # past the pool's end: reads the last row
    pos = torch.tensor(
        [max_len - 1, ps * 5 - 1, ps * 5, ps * 12, ps * 31 - 1, ps * 31, 47, 200],
        dtype=torch.int32, device=dev,
    )
    return q, k, v, pages, pos


def k5_bound(q, k, pages, pos) -> tuple[float, str]:
    """Least time for this call's work: the valid K/V lanes read once plus
    q, the page table, pos and the output, over HBM bandwidth — or its
    flops over the f32 rate, whichever is larger."""
    B, Hq, Dk = q.shape
    Hkv, ps = k.shape[1], k.shape[2]
    lane = torch.arange(pages.shape[1] * ps, device=q.device)
    valid = (pages >= 0).repeat_interleave(ps, 1) & (lane[None] <= pos[:, None])
    n_valid = int(valid.sum())
    item = q.element_size()
    nbytes = 2 * q.numel() * item + pages.numel() * 4 + pos.numel() * 4
    nbytes += 2 * n_valid * Hkv * Dk * item
    flops = 4 * n_valid * (Hq // Hkv) * Hkv * Dk
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase() -> dict:
    from repro_torch.kernels import paged_decode as pd

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # atol = rtol
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = paged_inputs(dtype, gen)
        got = pd.paged_gqa_attention(*args)
        torch.cuda.synchronize()
        ref = pd.paged_gqa_plain(*args)
        assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref.float()).abs()
        lim = tol[dtype] + tol[dtype] * ref.float().abs()
        errs[str(dtype)] = float(err.max())
        if not bool((err <= lim).all()):
            raise AssertionError(f"paged_gqa_decode {dtype}: max abs err {float(err.max())}")
        log(f"kernels: paged_gqa_decode {dtype} max_abs_err={float(err.max()):.3e} "
            f"(tolerance atol=rtol={tol[dtype]})")
    # times in the serving dtype, on 4 input sets (67 MB of pools, more
    # than the 50 MB L2) so every call reads its K/V from HBM as in serving
    sets = [paged_inputs(torch.bfloat16, gen) for _ in range(4)]
    it = iter(range(10**9))

    def nxt():
        return sets[next(it) % len(sets)]

    def library():
        q, k, v, pages, pos = nxt()
        kg, vg = pd.paged_gather(k, pages), pd.paged_gather(v, pages)
        ps = k.shape[2]
        lane = torch.arange(pages.shape[1] * ps, device=q.device)
        mask = (pages >= 0).repeat_interleave(ps, 1) & (lane[None] <= pos[:, None])
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kg, vg, attn_mask=mask[:, None, None], enable_gqa=True)

    # the same shapes with every lane valid (all pages mapped, pos at the
    # last lane): the largest read this call can make
    full = []
    for q, k, v, pages, pos in sets:
        P = pages.shape[1]
        full.append((q, k, v, torch.arange(q.shape[0] * P, dtype=torch.int32,
                     device="cuda").reshape(-1, P), torch.full_like(pos, P * k.shape[2] - 1)))
    it_full = iter(range(10**9))

    launches0 = pd.paged_gqa_attention.launches
    ms_full = graph_ms(lambda: pd.paged_gqa_attention(*full[next(it_full) % len(full)]))
    ms = graph_ms(lambda: pd.paged_gqa_attention(*nxt()))
    eager_ms = events_ms(lambda: pd.paged_gqa_attention(*nxt()))
    plain_ms = graph_ms(lambda: pd.paged_gqa_plain(*nxt()))
    library_ms = graph_ms(library)
    pd.paged_gqa_attention.launches = launches0  # comparison launches do not count
    bound_ms, bound_by = k5_bound(*[sets[0][i] for i in (0, 1, 3, 4)])
    bound_full, _ = k5_bound(*[full[0][i] for i in (0, 1, 3, 4)])
    log(f"kernels: paged_gqa_decode bf16 B=8 max_len=512: kernel {ms:.4f} ms "
        f"(eager {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, gather+sdpa "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); all 512 lanes "
        f"valid: kernel {ms_full:.4f} ms, bound {bound_full:.4f} ms")
    return {
        "name": "paged_gqa_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_gqa_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:144",
        "launches": None,
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_dtype": errs,
        "ms": ms,
        "eager_ms": eager_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "ms_all_lanes_valid": ms_full,
        "bound_ms_all_lanes_valid": bound_full,
    }


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------
POLICIES = ("none", "dmr", "tmr")


def make_requests(vocab: int, n: int = 8, new: int = 32):
    from repro_torch.api import RedundancyPolicy
    from repro_torch.serving import Request

    rng = np.random.default_rng(SEED + 1)
    levels = {"none": 1, "dmr": 2, "tmr": 3}
    return [
        Request(
            prompt=rng.integers(0, vocab, size=int(rng.integers(8, 65))).astype(np.int32),
            max_new_tokens=new,
            policy=RedundancyPolicy(level=levels[POLICIES[i % 3]]),
        )
        for i in range(n)
    ]


def drive(engine, reqs, strike: bool):
    """Staggered submission as ``repro.launch.serve`` does it, then a bit
    flip against the second replica slot of the last DMR request."""
    from repro_torch.api import FaultSpec
    from repro_torch.serving import RUNNING
    from repro_torch.tree import leaf_index

    half = max(1, len(reqs) // 2)
    for r in reqs[:half]:
        assert engine.submit(r)
    engine.pump(max_ticks=3)
    for r in reqs[half:]:
        assert engine.submit(r)
    victim = fault = None
    if strike:
        victim = next(r for r in reversed(reqs) if r.policy.level == 2)
        rec = engine.requests[victim.id]
        for _ in range(10 * victim.max_new_tokens):
            if rec.status == RUNNING and len(rec.tokens) + 2 <= victim.max_new_tokens:
                break
            engine.pump(max_ticks=1)
        if rec.status != RUNNING:
            raise AssertionError("strike victim never became resident")
        dec = engine._states["decoder"]
        fault = FaultSpec.at(
            step=engine.exe.metrics()["steps"] + 1,
            cell_id=engine.exe.program.cell_id("decoder"),
            leaf=leaf_index(dec, "tokens"),
            index=rec.slots[1],
            bit=4,
        )
    engine.pump(faults=fault)
    return victim


def serve_engine(cfg, scfg):
    from repro_torch import api
    from repro_torch.serving.lm import lm_engine_parts

    prog, adapter = lm_engine_parts(cfg, scfg)
    engine = api.serve(prog, adapter)
    engine.start(SEED)
    return engine


def engine_phase() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models.lm_cells import ServeConfig
    from repro_torch.serving import DONE, Request

    cfg = get_config("internlm2-1.8b")
    scfg = ServeConfig(batch=8, max_len=512, paged=True, page_size=16)
    t0 = time.perf_counter()
    engine = serve_engine(cfg, scfg)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(engine._states["weights"]))
    log(f"engine: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} vocab="
        f"{cfg.vocab_size} {cfg.dtype}: {n_params / 1e9:.3f} B params "
        f"(config n_params {cfg.n_params() / 1e9:.3f} B), init "
        f"{time.perf_counter() - t0:.1f} s")
    # warm-up request: CUDA context, cuBLAS handles, the allocator
    warm = Request(prompt=np.arange(8, dtype=np.int32), max_new_tokens=2)
    assert engine.submit(warm)
    engine.pump()
    assert engine.result(warm.id)["status"] == DONE

    reqs = make_requests(cfg.vocab_size)
    R = engine.registry
    ticks0 = R["serving_ticks_total"].value
    replays0 = R["serving_replays_total"].value
    busy0 = R["serving_tick_seconds"].sum
    torch.cuda.synchronize()
    pd.paged_gqa_attention.launches = 0  # counts start here
    t0 = time.perf_counter()
    victim = drive(engine, reqs, strike=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pd.paged_gqa_attention.launches  # and are read here
    ticks = int(R["serving_ticks_total"].value - ticks0)
    replays = int(R["serving_replays_total"].value - replays0)
    busy = R["serving_tick_seconds"].sum - busy0

    results = {r.id: engine.result(r.id) for r in reqs}
    for r in reqs:
        res = results[r.id]
        toks = np.asarray(res["tokens"])
        if res["status"] != DONE or len(toks) != r.max_new_tokens:
            raise AssertionError(f"{r.id}: {res['status']} with {len(toks)} tokens")
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{r.id}: token out of range")
    m = engine.metrics()
    struck = {rid: n for rid, n in m["request_faults"].items() if rid != warm.id}
    if struck != {victim.id: 1} or m["fault_totals"][victim.id]["events"] != 1.0:
        raise AssertionError(f"strike not detected/attributed once to {victim.id}: {struck}")
    if m["fault_totals"][victim.id]["per_replica"][1] != 1.0 or replays < 1:
        raise AssertionError("strike not localized to replica 1 by a §IV replay")
    n_sub = max(1, scfg.prefill_chunk)
    expect = cfg.n_layers * (ticks + replays) * n_sub
    if launches == 0 or launches != expect:
        raise AssertionError(f"K5 launches {launches} != {cfg.n_layers} x {ticks + replays} steps")
    n_tok = sum(len(results[r.id]["tokens"]) for r in reqs)
    ttfts = sorted(results[r.id]["ttft_s"] for r in reqs)
    log(f"engine: {len(reqs)} requests DONE, {n_tok} tokens in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tok/s; TTFT p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms "
        f"max {ttfts[-1] * 1e3:.1f} ms; {ticks} ticks, {busy / ticks * 1e3:.2f} ms/tick; "
        f"{replays} replay(s); strike on {victim.id} detected, attributed, repaired")
    log(f"engine: paged_gqa_decode launches {launches} = {cfg.n_layers} layers x "
        f"({ticks} ticks + {replays} replays); pages {m['pages_free']}/{m['pages_total']} "
        f"free, {m['page_faults']} page faults")

    # where one tick's time goes: the decode transition alone, the slot
    # fingerprints of the replica check, and the out-of-place pool copy
    states = engine._states
    seg = states["decoder"]["cache"]["segments"][0]
    pool_bytes = sum(x.numel() * x.element_size() for x in seg.values())
    copy_ms = events_ms(lambda: {k: x.clone() for k, x in seg.items()})
    step_ms = events_ms(lambda: engine.exe.pure_step(states, 0), iters=5)
    fp_ms = events_ms(lambda: engine._ops.fingerprints(states["decoder"]), iters=5)
    log(f"engine: per tick: decode step {step_ms:.2f} ms, slot fingerprints {fp_ms:.2f} ms, "
        f"KV pool copy {copy_ms:.3f} ms ({2 * pool_bytes / 1e9:.3f} GB moved, "
        f"{2 * pool_bytes / (copy_ms * 1e-3) / 1e12:.2f} TB/s)")
    return {
        "launches": launches,
        "tokens_per_s": n_tok / wall,
        "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
        "ttft_max_ms": ttfts[-1] * 1e3,
        "ms_per_tick": busy / ticks * 1e3,
        "ticks": ticks,
        "replays": replays,
        "decode_step_ms": step_ms,
        "fingerprints_ms": fp_ms,
        "pool_copy_ms": copy_ms,
        "pool_copy_gb": 2 * pool_bytes / 1e9,
    }


def _leaves(tree):
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


# --------------------------------------------------------------------------
# phase 4: a small f32 model agrees with a full-sequence forward
# --------------------------------------------------------------------------
def check_phase() -> None:
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_cells import ServeConfig

    cfg = dataclasses.replace(get_reduced("internlm2-1.8b"), dtype="float32")
    engine = serve_engine(cfg, ServeConfig(batch=8, max_len=128, paged=True, page_size=16))
    reqs = make_requests(cfg.vocab_size, n=6, new=24)
    drive(engine, reqs, strike=False)
    params = engine._states["weights"]["params"]
    checked = 0
    for r in reqs:
        res = engine.result(r.id)
        toks = np.asarray(res["tokens"], np.int64)
        seq = torch.tensor(np.concatenate([r.prompt, toks[:-1]]), device="cuda")[None]
        logits, _ = T.forward(cfg, params, seq)
        tail = logits[0, len(r.prompt) - 1 :].float()
        top2 = tail.topk(2, dim=-1)
        pred = top2.indices[:, 0].cpu().numpy()
        gap = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
        clear = gap > 1e-3  # near-ties may flip between decode and prefill order
        if not (pred[clear] == toks[clear]).all():
            raise AssertionError(f"{r.id}: served tokens disagree with the forward pass")
        checked += int(clear.sum())
    log(f"check: reduced f32 paged serving matches the full forward on {checked} tokens")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    paths = build.build(KERNELS)
    log(f"build: {len(paths)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log_path = path.with_suffix(".log")
        regs = [ln.strip() for ln in log_path.read_text().splitlines() if "registers" in ln]
        log(f"build: {name}: {'; '.join(regs)}")
    record = kernel_phase()
    eng = engine_phase()
    record["launches"] = eng["launches"]
    check_phase()
    print(json.dumps({"engine": eng}), flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
