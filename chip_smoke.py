#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device and nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``);
imports nothing of JAX.  Phases, each of which raises on failure:

  1. build    -- every CUDA kernel of the port's paths, from
                 ``src/repro_torch/csrc``, one nvcc per source in parallel.
  2. kernels  -- K5 against its plain PyTorch version on the card at the
                 serving path's shapes, with its tolerance, also with a
                 slot whose pages are mapped but which has no valid lane,
                 at query groups 12 and 48 (chunks of 8 heads), on a
                 dense cache read in place (bitwise equal to the same
                 values through a shuffled page table), and at every
                 split count of the sweep (1, 2, 3, 4, 8; 3 splits 512
                 lanes unevenly) at the served, the
                 engine-like and the edge inputs; ptxas registers and
                 spills per instance; device times
                 (CUDA-graph replays, so host overhead is excluded) of the
                 kernel, the plain version and a library yardstick (page
                 gather + SDPA), beside the bound computed from this run's
                 inputs, at the serving shape, with every lane valid and
                 at the engine's own inputs (pos at 40-100 lanes); and at
                 the head shapes of the decoders of phases 3e-3l:
                 granite-moe's (Hq 16, Hkv 8, Dk 64) and musicgen's (Hq
                 32, Hkv 32, Dk 64) through pages, zamba2's shared block
                 (Hq 32, Hkv 32, Dk 80) and qwen2-vl's (Hq 28, Hkv 4, Dk
                 128) on a dense cache read in place, and h2o-danube's
                 (Hq 32, Hkv 8, Dk 120) on a wrapped 4096-lane ring at the
                 lane bound min(pos, S-1), also held to the window mask;
                 each case twice bitwise, timed beside its bound and
                 gather + SDPA.
  2b. epilogue -- K1-K4 (the DMR/TMR compare, vote and fingerprint
                 kernels) BITWISE against their plain versions, each run
                 twice, with one bit flip in one replica.  K1 and K2
                 through their wrappers on replicated trees read in place
                 (the 4K blend's, a tree of 43 leaves in three launches
                 with sub-word, non-contiguous and unaligned leaves, and
                 one-leaf streams of odd sizes), each padded three ways,
                 against the flatten path (voted trees, counts and
                 fingerprints); K3 and K4 on the 4K blend's padded word
                 stream and on odd sizes (raw, padded as the wrappers pad,
                 and unaligned); device times at 4K beside the bound.
  2c. loop    -- the paper's loop: Listing 1's image blend at 4K UHD
                 compiled with ``backend="auto"`` (must resolve to
                 ``lockstep_cuda``), 64 steps each of DMR (bitwise, hash,
                 compare_every=4) and TMR with a bit flip at step 20:
                 detected at step 20 / voted away, states bitwise equal to
                 the port's ``lockstep`` (DMR) or the unstruck run (TMR),
                 K1/K2 launches equal to the compared steps, reading the
                 replicas in place (``flatten_replicas`` called 0 times);
                 then K3 and K4 through ``kernels.ops`` on the final
                 state; ms per step of ``lockstep`` and ``lockstep_cuda``
                 in turns, DMR ``lockstep_cuda`` no slower.
  2g. schedules -- the paper's other schedules and its language at 4K
                 UHD: Listing 1 through ``compile_source`` with Int
                 slots, DMR and TMR through ``auto`` (must resolve to
                 ``lockstep_cuda``), a bit flip at step 20 detected on
                 every later step / voted away, K1/K2 launches equal to
                 the compared steps, 8 DMR steps bitwise equal to the
                 port's CPU path, ms/step beside the float blend of 2c in
                 turns; ``host`` under DMR: one recovery through K4, the
                 final states the unstruck run's, host syncs a step; a
                 TMR ``run_campaign`` of four strikes: each trajectory
                 the unstruck run and a ``pure_step`` loop, one event
                 each, ledger and step counter unchanged; the §III
                 wavefront (``benchmarks/run.py::bench_mimd_wavefront``
                 at 8,294,400 cells a unit): ``auto`` -> wavefront,
                 ``max_lead`` > 0, bitwise equal to ``lockstep`` and
                 ``lockstep_cuda``, one host sync a run (torch's sync
                 debug mode), a strike in the ledger at its step, 64
                 ``unit_step`` events through a ``Tracer``; ms/step
                 against ``lockstep`` in turns.
  2d. ssd     -- K8 (the Mamba2 SSD chunked scan: chunk states, state
                 passing and chunk outputs on wgmma) against its plain
                 version at mamba2-2.7b's shapes (80 heads of 64, state
                 128, one group, bf16), L = 256 and a ragged L = 300, each
                 with and without an initial state, plus one f32 case;
                 each element within its tolerance and each row of y and
                 of the state within a relative L2 limit, a check that two
                 planted faults at L = 300 (the inter-chunk carry dropped,
                 a chunk reading the previous chunk's carry) must fail;
                 ptxas registers and spills per kernel; device times at
                 L = 128, 256, 300 and 320 beside the bound, and each
                 launch's device time from torch.profiler; and at
                 zamba2-2.7b's shapes (state 64) at L = 256 and 320, the
                 two planted faults at L = 320 rejected again, timed.
  2e. attention -- K7 (flash attention) through ``kernels.ops.attention``
                 at internlm2's head layout (16 query / 8 KV heads of 128,
                 bf16): causal at 512 and 4096, windowed, and with a
                 q_offset; then against its plain version, also in f32
                 and at head dims 64, 120 (zero-padded) and 256 with one
                 and with two warpgroups a block, so every bf16 instance
                 is compared; each element within its tolerance and each
                 row within a relative L2 limit, a limit that two planted
                 faults at causal 4096 (a K/V tile skipped, a stale
                 stage) must fail; ptxas registers and spills per
                 instance; causal 512 and 4096 timed with SDPA as the
                 library yardstick.
  2f. mla     -- K6 (absorbed-MLA paged decode) against its plain version
                 at deepseek-v3-671b's served shape (8 slots, 128 heads,
                 lora 512, rope 64, pages of 16, 512 lanes, ragged pos) in
                 f32 (every CUDA-core instance G = 1..16) and bf16 (the
                 tensor-core kernel), at 4096 and 16384 lanes, and on an
                 edge case (an unmapped page in the middle, a slot with
                 nothing mapped, a row past the pool, mapped pages but no
                 valid lane); the bf16 kernel at every split count (1-64);
                 each element within its tolerance and each row within a
                 relative L2 limit that two planted faults at 4096 lanes
                 (a lane tile skipped, a stale tile) must fail; a dense
                 latent cache bitwise equal to the same values through a
                 shuffled page table; ptxas per instance; device times
                 beside the bound, with gather + SDPA as the library
                 yardstick, which the kernel must beat at the served shape.
  3. engine   -- the main path: ``repro_torch.api.serve`` on full-width,
                 full-depth internlm2-1.8b (bf16, random weights from a
                 seed) with paged KV: 8 staggered requests, policies
                 cycling none/dmr/tmr, one bit flip struck into a DMR
                 replica slot.  Every request must finish, the strike must
                 be detected, attributed and repaired, and every kernel's
                 launch count must match the decoder steps the run took.
  3b. mamba2  -- the new path: ``repro_torch.api.serve`` on full-width,
                 full-depth mamba2-2.7b (bf16, random weights from a
                 seed) on the dense slot state: 8 staggered requests with
                 prompts of 16-320 tokens (whole, ragged and multi-chunk
                 prefills), policies cycling none/dmr/tmr, one bit flip
                 into a DMR replica slot; K8 launches must equal
                 64 layers x prefills.
  3c. deepseek -- ``repro_torch.api.serve`` on deepseek-v3-671b's three
                 dense MLA layers at full width (bf16, random weights from
                 a seed, the MTP head built) with paged latent KV: the
                 stream and strike of phase 3; K6 launches must equal
                 3 layers x (ticks + replays), K5 none.
  3d. spec    -- speculative decoding on replica slots, phase 3's stream
                 again with every request asking for ``draft_len`` 4, and
                 the tokens of each request bitwise phase 3's: (a)
                 self-speculation (K5 launches = 24 x (ticks + replays) x
                 5, more than one token a verify walk); (b) a second
                 full-width internlm2 drawn from another seed as the draft
                 (real rejections; its dense cache through K5 too, so K5
                 launches = 2 x 24 x (ticks + replays) x 5), under a
                 ``Tracer`` and with the strike of phase 3 landing
                 mid-verify: the trace passes ``tools/validate_trace.py``,
                 holds one tick span a tick, one verify-walk span a
                 counted walk, one B/E pair a request and the strike's
                 detect -> attribute -> repair on the victim's track, and
                 gives each tick's dispatch / device / harvest split; (c)
                 phase 3c's deepseek stream self-speculating with
                 ``draft_len`` 2 (tokens bitwise 3c's, K6 launches = 3 x
                 (ticks + replays) x 3, K5 none).
  3e-3l. archs -- phase 3's stream and strike, each engine released
                 before the next, at full width: (3e) granite-20b, 52
                 layers, paged (K5 at group 48 = 52 x (ticks + replays));
                 (3f) command-r-plus-104b's first 8 of 64 layers, paged
                 (K5 at group 12 = 8 x (ticks + replays)); (3g) zamba2-2.7b,
                 dense (K8 = 54 mamba layers x prefills, K5 on the shared
                 block's dense cache = 9 units x (ticks + replays)); (3h)
                 granite-moe-1b-a400m, paged (K5 = 24 x (ticks + replays)),
                 then the same stream self-speculating with ``draft_len``
                 4, its tokens bitwise 3h's; (3i) deepseek-v3-671b's 3
                 dense layers and its first MoE layer (256 experts),
                 paged latent (K6 = 4 x (ticks + replays), K5 none); (3j)
                 h2o-danube-3-4b, 24 layers, its dense ring of 4096 lanes
                 (max_len = window), prompts of 4000-4600 tokens that fill
                 the ring or whose decode wraps it (K5 at Dk 120 = 24 x
                 (ticks + replays)); (3k) qwen2-vl-7b, 28 layers, dense,
                 M-RoPE, prompts of 264-320 tokens past the 256 zero
                 vision rows (K5 at group 7 = 28 x (ticks + replays));
                 (3l) musicgen-large, 48 layers, four codebooks, paged
                 (K5 at Dk 64 group 1 = 48 x (ticks + replays)), the
                 strike into codebook 0 of a replica slot's (B, 1, 4)
                 tokens.  Each prints tok/s, TTFT, ms/tick, peak device
                 memory, the decode step and the slot fingerprints.
  4. check    -- reduced f32 models (internlm2, mamba2, and deepseek's
                 dense prefix) served the same way must emit the tokens a
                 full-sequence forward pass predicts; internlm2 and
                 deepseek are served paged and dense (through K5 / K6 over
                 the dense cache), and the two token streams must be
                 equal, none / DMR / TMR; the same for granite-moe (its
                 capacity raised to n_experts / top_k, so that neither the
                 served steps nor the forward drop a routed token),
                 granite-20b and musicgen (two codebooks); zamba2 served
                 dense; h2o-danube (window 32) served dense across its
                 ring's wraps through K5.

  5. train    -- training through the port's entry points (the launcher's
                 ``build``/``main``, ``compile(backend="host")``):
                 (5a) internlm2-1.8b at full width and depth, policy none,
                 bigram data, batch 4 x 512, 20 steps: every loss finite,
                 the last below the first; ms/step, tokens/s, peak memory
                 and one step cut into data / forward / backward / AdamW;
                 (5b) its first 4 layers at full width (``--d-model 2048
                 --layers 4``) under DMR: the unstruck run shows zero
                 ledger events, the launcher's strike at step 3 gives one
                 recovery at (3, trainer) through one K4 launch, the
                 replicas end bitwise equal and the final state bitwise
                 the unstruck run's; one replica's transition in parts
                 and the replicas' compare timed; (5c) the 4-layer config, a checkpoint
                 every 2 steps, a crash after step 5, restore and resume
                 to step 8 (``--simulate-failure``): bitwise an
                 uninterrupted run; (5d) F4: the reduced mamba2 trainer on
                 the card refuses (K8 has no backward), as K7 does on
                 inputs that require grad; (4t) reduced f32 internlm2, 3
                 train steps on the card against the CPU: batches bitwise
                 (and a full-vocabulary bigram batch), loss within 1e-4,
                 params within ``TRAIN_PARAM_TOL``.
  6. launch   -- the launchers and the examples through their entry
                 points (``launch.serve.main``, each example's ``main``):
                 (6a) the engine launcher on internlm2-1.8b at full width
                 and depth, paged, 8 slots, 8 requests cycling
                 none/dmr/tmr, 32 tokens each, prompts of 2-64 tokens,
                 ``--strike --trace-out --metrics-json``: every request
                 DONE, the strike attributed once to its request and
                 repaired (``strike_repaired`` on its trace track), the
                 snapshot parses, K5 = 24 x (ticks + replays); (6b) the
                 same with ``--spec-k 2``: every request's tokens bitwise
                 6a's, K5 = 24 x (ticks + replays) x 3; (6c) the static
                 path (``--static --batch 4 --prompt-len 12 --decode 24``):
                 internlm2 under none and TMR, tokens bitwise equal and 0
                 events (K5 on every decode step of every layer and
                 replica through the dense view); the TMR program on
                 ``lockstep_cuda`` with a bit flip into a decoder
                 replica's KV cache at step 12: one event, tokens bitwise
                 the unstruck run's, K2 = 24 decode steps; mamba2-2.7b
                 under DMR: 0 events, K8 = 64 (the prefill); (6d)
                 ``validate()`` of the full-width internlm2 train program
                 (5a's), 6a's paged slot serve program and 6c's static
                 TMR program on fake tensors: the card's peak memory
                 grows under 1 MB; (6e) the four examples
                 (``examples/{quickstart,image_blend,serve_lm,
                 serve_walkthrough}_torch.py``) on the card at their own
                 defaults, quickstart with ``lockstep`` and
                 ``lockstep_cuda``, serve_lm with ``--strike``,
                 serve_walkthrough with ``--smoke``, their own asserts
                 passing; K2, K4 and K5 each launched.
  7. analysis -- the static analyzer (``repro_torch.analysis``), which
                 traces transitions to FX graphs on fake CPU tensors:
                 (7a) the CI lane, ``python -m repro_torch.analysis --all
                 --json --fail-on warning --dag-out DIR``, and
                 ``tools/validate_dag.py`` over the 23 exports, each a
                 subprocess that must exit 0; (7b) the full-width
                 programs of the phases above (internlm2-1.8b's paged
                 slot serve program with the decoder under DMR and under
                 TMR, granite-moe-1b-a400m's under DMR, mamba2-2.7b's,
                 5b's 4-layer DMR trainer, Listing 1 at 3840 x 2160 with
                 image1 under TMR): seconds and codes of each, no error,
                 the codes of each cell those of the reduced program of
                 its family, the card's peak memory grown under 1 MB;
                 (7c) MISO002's promise: the random programs of
                 ``tests/test_torch_analysis_random.py`` that have dead
                 reads and Listing 1 at 4K with a planted
                 declared-but-unused read, every read the analyzer calls
                 dead dropped, both versions 16 steps under DMR and TMR
                 on ``lockstep_cuda`` with a bit flip at step 8: states
                 bitwise, the same events, K1/K2 = compared steps x
                 cells; (7d) JAX's MISO102 fixture as ``index_add_`` of a
                 16 M f32 row into one index under DMR for 32 steps:
                 MISO102, and whether K1 saw the replicas diverge
                 (observed, not gated).
  8. spatial  -- spatial placement (``compile(..., mesh=...)``,
                 ``backend="spatial_lockstep"``) with every pod an
                 explicit allocation and stream of cuda:0: (8a) 2c's 4K
                 blend, 64 steps, a flip at step 20 on replica 1, DMR on
                 2 pods and TMR on 3, hash and bitwise: final states,
                 reports and ledger bitwise ``lockstep``'s, an unstruck
                 run 0 events, the pods' allocations distinct, K4 = 64 in
                 each TMR bitwise run (the vote of the gathered word
                 streams); ms/step of ``spatial_lockstep``, ``lockstep``
                 and ``lockstep_cuda`` in turns, the analytic bytes a
                 compare; (8b) ``ft.elastic``'s straggler run and strike
                 report on the spatial DMR blend (tests/test_spatial.py's
                 latencies and strikes): outcomes equal to the same run
                 on a CPU mesh and to the reference test's; (8c)
                 internlm2-1.8b at full width, dense, 512 lanes, phase
                 3's traffic served spatially on 2 pods (8 slots,
                 none/dmr) and 3 pods (9 slots, none/dmr/tmr) and
                 temporally in the same call: every token bitwise
                 temporal, the strike on the same request and replica,
                 K5 = 24 x (ticks + replays) x pods; tok/s, ms/tick,
                 detect ms against the temporal fingerprints, peak GB;
                 (8d) ``launch.serve.main`` with ``--placement spatial``
                 on one card (1 pod) bitwise the temporal launcher, and
                 the quickstart's section 4b.

The last lines are the paged-vs-dense parity and the ring check, the
loop's, the schedules', the three engines', the speculating engines'
(``engine_spec``), phases 3e-3l's (``engine_archs``), the training
phases' (``train``), the launchers' (``launch``), the analyzer's
(``analysis``), phase 8's (``spatial``) and the kernels' JSON records
(each kernel's launches add up the paths that drive it,
``launches_by_path``: K1-K4 phases 2c and 2g, K1 and K2 also 7c, K4
also 5b, the examples and 8a, K2 also 6c and the examples, K5 phases 3,
3d, 3e-3h, 3j-3l, 6a-6c, the examples, 8c and 8d, K6 phases 3c, 3d and
3i, K8 phases 3b, 3g and 6c), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
SEED = 0
KERNELS = ["paged_gqa_decode", "redundancy_epilogue", "ssd_scan", "flash_attention",
           "paged_mla_decode"]


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
def paged_inputs(dtype, gen, B=8, Hq=16, Hkv=8, Dk=128, ps=16, max_len=512, no_valid_lane=False):
    """The serving path's K5 shapes, with unmapped pages, ``pos`` at page
    edges, one slot with nothing mapped and one row past the pool;
    ``no_valid_lane`` also unmaps slot 6's first page and sets its pos
    inside it: mapped pages, no valid lane (the uniform mean)."""
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
    if no_valid_lane:
        pages[6, 0] = -1
        pos[6] = ps - 2
    return q, k, v, pages, pos


def engine_like_inputs(gen, B=8, Hq=16, Hkv=8, Dk=128, ps=16, max_len=512):
    """K5's inputs as a short serving run gives them (phase 3: prompts of
    8-64 tokens, 32 new): each slot's pos at 40-100 lanes, its first 7
    pages mapped (the admission reservation), the rest unmapped."""
    q, k, v, pages, _ = paged_inputs(torch.bfloat16, gen, B, Hq, Hkv, Dk, ps, max_len)
    pages = torch.randperm(pages.numel(), generator=gen, device="cuda").reshape(pages.shape)
    pages = pages.to(torch.int32)
    pages[:, 7:] = -1
    pos = torch.linspace(40, 100, B, device="cuda").to(torch.int32)
    return q, k, v, pages, pos


def dense_and_shuffled(dtype, gen, B=8, Hq=16, Hkv=8, S=512, D=128, ps=16):
    """A dense GQA cache (B, Hkv, S, D), its in-place view for K5, and
    the same values in a pool through a shuffled page table: (q, k, v,
    pos, view, pools, pages); pos covers lane 0, page edges and the last
    lane."""
    P = S // ps
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
    pos = torch.linspace(0, S - 1, B, device="cuda").to(torch.int32)
    pos[1] = ps - 1
    pages = torch.randperm(B * P, generator=gen, device="cuda").reshape(B, P).to(torch.int32)
    pools = []
    for x in (k, v):
        pool = torch.empty((B * P, Hkv, ps, D), dtype=dtype, device="cuda")
        pool[pages.long()] = x.reshape(B, Hkv, P, ps, D).permute(0, 2, 1, 3, 4)
        pools.append(pool)
    from repro_torch.kernels.paged_decode import dense_gqa_view

    return q, k, v, pos, dense_gqa_view(k, v), pools, pages


def ptxas_lines(build_log: Path) -> list[str]:
    """ptxas' report of one library's build log, one line per kernel
    instance: ``name<template args>: R registers, S B spill stores, L B
    spill loads`` (names demangled by c++filt where it is installed)."""
    text = build_log.read_text()
    names = re.findall(r"Compiling entry function '([^']+)'", text)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, timeout=30).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        plain = []
    short = {}
    for mangled, d in zip(names, plain if len(plain) == len(names) else names):
        m = re.search(r"(\w+(?:<[^()]*>)?)\(", d.replace("(anonymous namespace)::", ""))
        short[mangled] = m[1] if m else d
    rows, cur = [], None
    for ln in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            cur = {"name": short[m[1]]}
            rows.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            cur["spill"] = f"{m[1]} B spill stores, {m[2]} B spill loads"
        elif cur is not None and (m := re.search(r"Used (\d+) registers", ln)):
            cur["regs"] = f"{m[1]} registers"
    return [f"{r['name']}: {r.get('regs', '? registers')}, {r.get('spill', 'spills not reported')}"
            for r in rows]


def k5_bound(q, k, pages, pos) -> tuple[float, str]:
    """Least time for this call's work: the valid K/V lanes read once plus
    q, the page table, pos and the output, over HBM bandwidth — or its
    flops over the f32 rate, whichever is larger."""
    B, Hq, Dk = q.shape
    from repro_torch.kernels.paged_decode import paged_valid

    Hkv, ps = k.shape[1], k.shape[2]
    n_valid = int(paged_valid(pages, pos, ps).sum())
    item = q.element_size()
    nbytes = 2 * q.numel() * item + pages.numel() * 4 + pos.numel() * 4
    nbytes += 2 * n_valid * Hkv * Dk * item
    flops = 4 * n_valid * (Hq // Hkv) * Hkv * Dk
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ring_inputs(dtype, gen, B=8, Hq=32, Hkv=8, S=4096, D=120):
    """A sliding window's dense ring of S lanes as decode leaves it (h2o-
    danube's: window 4096 = S, head dim 120): position p at lane p % S,
    most slots past the wrap.  (q, k, v, pos, slot_pos)."""
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
    pos = torch.tensor([S - 1, S, S + 31, 2 * S + 5, 100, S - 40, S + 1000, 3],
                       dtype=torch.int32, device="cuda")[:B]
    lanes = torch.arange(S, device="cuda")[None, :]
    slot_pos = torch.where(lanes <= pos[:, None], pos[:, None] - (pos[:, None] - lanes) % S, -1)
    return q, k, v, pos, slot_pos


#: K5 at the head shapes of phases 3e-3l's decoders: (record key, label,
#: cache, Hq, Hkv, Dk)
K5_ARCH_CASES = [
    ("dk64_paged", "Dk 64 paged (Hq 16, Hkv 8)", "paged", 16, 8, 64),  # granite-moe
    ("dk80_dense", "Dk 80 dense view (B 8, Hq 32, Hkv 32, S 512)", "dense", 32, 32, 80),  # zamba2
    ("dk120_ring", "Dk 120 group 4 ring view (B 8, Hq 32, Hkv 8, S 4096, wrapped)", "ring", 32, 8,
     120),  # h2o-danube
    ("dk128_g7_dense", "Dk 128 group 7 dense view (B 8, Hq 28, Hkv 4, S 512)", "dense", 28, 4,
     128),  # qwen2-vl
    ("dk64_g1_paged", "Dk 64 group 1 paged (Hq 32, Hkv 32)", "paged", 32, 32, 64),  # musicgen
]


def k5_arch_shapes(pd, gen, compare, library) -> dict:
    """K5 at the head shapes phases 3e-3l give it (``K5_ARCH_CASES``):
    through pages (the no-valid-lane edge too), on a dense cache read in
    place (bitwise equal to the same values through a shuffled page
    table), and on a sliding window's wrapped ring read in place at the
    lane bound ``ring_lane_pos`` (also within K5's limits of ``attend``
    under JAX's window mask).  Each f32 and bf16 case within K5's limits
    of the plain version, each call twice, bitwise equal.  Times in bf16
    (kernel, plain, gather + SDPA) beside the bound from this run's
    inputs, on input sets larger than the 50 MB L2."""
    from repro_torch.models.layers import ring_lane_pos

    out, errs = {}, {}

    def twice(label, args) -> float:
        a = pd.paged_gqa_attention(*args)
        b = pd.paged_gqa_attention(*args)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"paged_gqa_decode {label}: two calls differ")
        return compare(label, args)

    def timed(label, sets) -> dict:
        it = iter(range(10**9))

        def nxt():
            return sets[next(it) % len(sets)]

        ms = graph_ms(lambda: pd.paged_gqa_attention(*nxt()))
        plain_ms = graph_ms(lambda: pd.paged_gqa_plain(*nxt()))
        library_ms = graph_ms(lambda: library(*nxt()))
        bound_ms, bound_by = k5_bound(*[sets[0][i] for i in (0, 1, 3, 4)])
        log(f"kernels: paged_gqa_decode {label} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"gather+sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    def dense_args(dtype, Hq, Hkv, Dk, label):
        q, k, v, pos, view, pools, pages = dense_and_shuffled(dtype, gen, Hq=Hq, Hkv=Hkv, D=Dk)
        got_dense = pd.paged_gqa_attention(q, *view, pos)
        got_paged = pd.paged_gqa_attention(q, *pools, pages, pos)
        torch.cuda.synchronize()
        if not torch.equal(got_dense, got_paged):
            raise AssertionError(f"paged_gqa_decode {label} {dtype}: dense view != shuffled pages")
        return (q, *view, pos)

    def ring_args(dtype, Hq, Hkv, Dk, label):
        q, k, v, pos, slot_pos = ring_inputs(dtype, gen, Hq=Hq, Hkv=Hkv, D=Dk)
        S = k.shape[2]
        args = (q, *pd.dense_gqa_view(k, v), ring_lane_pos(pos, S))
        window = (slot_pos >= 0) & (slot_pos <= pos[:, None]) & (slot_pos > pos[:, None] - S)
        got = pd.paged_gqa_attention(*args).float()
        want = pd.attend(q, k, v, window, Dk**-0.5).float()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
            raise AssertionError(f"paged_gqa_decode {label} {dtype}: the ring's lane bound "
                                 "disagrees with the window mask")
        return args

    for key, label, cache, Hq, Hkv, Dk in K5_ARCH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            if cache == "paged":
                for edge in (False, True):
                    case = f"{label} {dtype}{' mapped, no valid lane' if edge else ''}"
                    errs[case] = twice(case, paged_inputs(dtype, gen, Hq=Hq, Hkv=Hkv, Dk=Dk,
                                                          no_valid_lane=edge))
            else:
                case = f"{label} {dtype}"
                make = dense_args if cache == "dense" else ring_args
                errs[case] = twice(case, make(dtype, Hq, Hkv, Dk, label))
        if cache == "paged":
            sets = [paged_inputs(torch.bfloat16, gen, Hq=Hq, Hkv=Hkv, Dk=Dk) for _ in range(8)]
        else:
            make = dense_args if cache == "dense" else ring_args
            sets = [make(torch.bfloat16, Hq, Hkv, Dk, label) for _ in range(4)]
        out[key] = timed(label, sets)
        del sets
    log("kernels: paged_gqa_decode at the arch shapes (dense views bitwise equal to shuffled "
        "pages, the wrapped ring within limits of the window mask): each case twice bitwise, "
        "max abs err " + ", ".join(f"{k}: {v:.3e}" for k, v in errs.items()))
    out["max_abs_err"] = errs
    return out


def kernel_phase(build_log: Path) -> dict:
    from repro_torch.kernels import paged_decode as pd

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # atol = rtol

    def compare(label, args) -> float:
        got = pd.paged_gqa_attention(*args)
        torch.cuda.synchronize()
        ref = pd.paged_gqa_plain(*args)
        dtype = args[0].dtype
        assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= tol[dtype] + tol[dtype] * ref.float().abs()).all()):
            raise AssertionError(f"paged_gqa_decode {label}: max abs err {float(err.max())}")
        return float(err.max())

    errs, edges = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for edge in (False, True):
            args = paged_inputs(dtype, gen, no_valid_lane=edge)
            label = f"{dtype}{' mapped, no valid lane' if edge else ''}"
            errs[label] = compare(label, args)
            if edge:
                edges[dtype] = args
                if not bool((pd.paged_gqa_plain(*args)[6] != 0).any()):
                    raise AssertionError("paged_gqa_decode: the no-valid-lane slot's mean is 0")
            log(f"kernels: paged_gqa_decode {label} max_abs_err={errs[label]:.3e} "
                f"(tolerance atol=rtol={tol[dtype]})")
    # F2: query groups above 8 (command-r-plus' 12, granite-20b's MQA 48)
    for Hq, Hkv in ((96, 8), (48, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            for edge in (False, True):
                label = (f"group {Hq // Hkv} (Hq={Hq} Hkv={Hkv}) {dtype}"
                         f"{' mapped, no valid lane' if edge else ''}")
                errs[label] = compare(label, paged_inputs(dtype, gen, Hq=Hq, Hkv=Hkv,
                                                          no_valid_lane=edge))
        log(f"kernels: paged_gqa_decode group {Hq // Hkv}: max abs err "
            + ", ".join(f"{v:.3e}" for k, v in errs.items() if k.startswith(f"group {Hq // Hkv} ")))
    # F1: a dense cache read in place equals the same values through a
    # shuffled page table, bit for bit
    dense_bitwise = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, pos, view, pools, pages = dense_and_shuffled(dtype, gen)
        got_dense = pd.paged_gqa_attention(q, *view, pos)
        got_paged = pd.paged_gqa_attention(q, *pools, pages, pos)
        torch.cuda.synchronize()
        if not torch.equal(got_dense, got_paged):
            raise AssertionError(f"paged_gqa_decode {dtype}: dense view != shuffled pages")
        errs[f"dense view {dtype}"] = compare(f"dense view {dtype}", (q, *view, pos))
        dense_bitwise[str(dtype).removeprefix("torch.")] = True
    log("kernels: paged_gqa_decode on a dense (8, 8, 512, 128) cache read in place equals the "
        "same values through a shuffled page table bitwise, f32 and bf16; both within tolerance "
        "of the plain version")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split_lanes = pd.gqa_split_lanes(8, 8, 512, sms)
    n_split = -(-512 // split_lanes)
    ptxas = ptxas_lines(build_log)
    log(f"kernels: paged_gqa_decode {n_split} splits of {split_lanes} lanes at the serving shape; "
        f"ptxas per instance (split_kernel<dtype, chunk bound>, merge_kernel<dtype>): "
        f"{'; '.join(ptxas)}")
    # times in the serving dtype, on 4 input sets (67 MB of pools, more
    # than the 50 MB L2) so every call reads its K/V from HBM as in serving
    sets = [paged_inputs(torch.bfloat16, gen) for _ in range(4)]
    it = iter(range(10**9))

    def nxt():
        return sets[next(it) % len(sets)]

    def library(q, k, v, pages, pos):
        kg, vg = pd.paged_gather(k, pages), pd.paged_gather(v, pages)
        mask = pd.paged_valid(pages, pos, k.shape[2])
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
    arch_shapes = k5_arch_shapes(pd, gen, compare, library)
    errs.update(arch_shapes.pop("max_abs_err"))
    ms_full = graph_ms(lambda: pd.paged_gqa_attention(*full[next(it_full) % len(full)]))
    ms = graph_ms(lambda: pd.paged_gqa_attention(*nxt()))
    eager_ms = events_ms(lambda: pd.paged_gqa_attention(*nxt()))
    plain_ms = graph_ms(lambda: pd.paged_gqa_plain(*nxt()))
    library_ms = graph_ms(lambda: library(*nxt()))
    # the engine's own inputs: 40-100 valid lanes a slot
    eng_sets = [engine_like_inputs(gen) for _ in range(4)]
    it_eng = iter(range(10**9))

    def eng():
        return eng_sets[next(it_eng) % len(eng_sets)]

    eng_ms = graph_ms(lambda: pd.paged_gqa_attention(*eng()))
    eng_plain_ms = graph_ms(lambda: pd.paged_gqa_plain(*eng()))
    eng_library_ms = graph_ms(lambda: library(*eng()))
    # the split rule's evidence: the kernel at every split count, both
    # inputs, each count also held against the plain version (3 splits
    # of 192 lanes take 512 unevenly: 192, 192, 128)
    rule, sweep, sweep_err = pd.gqa_split_lanes, {}, {}
    held = [("served", sets[0]), ("engine-like", eng_sets[0]),
            ("edge f32", edges[torch.float32]), ("edge bf16", edges[torch.bfloat16])]
    try:
        for n, lanes in ((1, 512), (2, 256), (3, 192), (4, 128), (8, 64)):
            pd.gqa_split_lanes = lambda *a, lanes=lanes: lanes
            sweep_err[n] = max(compare(f"{label} at {n} splits", args) for label, args in held)
            sweep[n] = (graph_ms(lambda: pd.paged_gqa_attention(*nxt())),
                        graph_ms(lambda: pd.paged_gqa_attention(*eng())))
    finally:
        pd.gqa_split_lanes = rule
    pd.paged_gqa_attention.launches = launches0  # comparison launches do not count
    log("kernels: paged_gqa_decode by split count (served / engine-like ms; max abs err over "
        f"the {len(held)} held inputs): "
        + ", ".join(f"{n}: {a:.4f} / {b:.4f} ({sweep_err[n]:.3e})" for n, (a, b) in sweep.items()))
    bound_ms, bound_by = k5_bound(*[sets[0][i] for i in (0, 1, 3, 4)])
    bound_full, _ = k5_bound(*[full[0][i] for i in (0, 1, 3, 4)])
    eng_bound, eng_by = k5_bound(*[eng_sets[0][i] for i in (0, 1, 3, 4)])
    log(f"kernels: paged_gqa_decode bf16 B=8 max_len=512: kernel {ms:.4f} ms "
        f"(eager {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, gather+sdpa "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); all 512 lanes "
        f"valid: kernel {ms_full:.4f} ms, bound {bound_full:.4f} ms; engine-like (pos "
        f"40-100): kernel {eng_ms:.4f} ms, plain {eng_plain_ms:.4f} ms, gather+sdpa "
        f"{eng_library_ms:.4f} ms, bound {eng_bound:.4f} ms ({eng_by})")
    return {
        "name": "paged_gqa_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_gqa_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:144",
        "launches": None,
        "max_abs_err": max(max(errs.values()), max(sweep_err.values())),
        "max_abs_err_by_dtype": errs,
        "max_abs_err_by_splits": sweep_err,
        "ms": ms,
        "eager_ms": eager_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "ms_all_lanes_valid": ms_full,
        "bound_ms_all_lanes_valid": bound_full,
        "splits": n_split,
        "split_lanes": split_lanes,
        "dense_view_equals_shuffled_pages": dense_bitwise,
        "ms_by_splits": {n: {"served": a, "engine_like": b} for n, (a, b) in sweep.items()},
        "engine_like": {"ms": eng_ms, "plain_ms": eng_plain_ms, "library_ms": eng_library_ms,
                        "bound_ms": eng_bound, "bound_by": eng_by},
        "ptxas": ptxas,
        **arch_shapes,
    }


# --------------------------------------------------------------------------
# phase 2b: K1-K4 against their plain versions, bitwise
# --------------------------------------------------------------------------
W4K, H4K = 3840, 2160
#: the 4K blend's state, 3 f32 channels, padded to ``pick_block`` (64 Ki)
STREAM_4K = 380 * 65536
ODD_SIZES = (1, 129, 65537)
NO_LIBRARY = ("no single PyTorch call computes the vote with its counts, or the "
              "4-word position-weighted fingerprint")


def epilogue_specs():
    """K3, K4 (flat streams): name -> (wrapper, plain version, streams
    read, words the wrappers pad to, integer ops per word and bytes per
    word as counted in csrc/redundancy_epilogue.cu, TPU kernel it
    replaces)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import state_hash as sh
    from repro_torch.kernels import tmr_vote as tv

    return {
        "state_hash": (sh.state_hash, sh.state_hash_plain, 1, lambda n: ops.HASH_BLOCK, 14, 4,
                       "src/repro/kernels/state_hash.py:85"),
        "tmr_vote": (tv.tmr_vote, tv.tmr_vote_plain, 3, lambda n: ops.VOTE_BLOCK, 11, 16,
                     "src/repro/kernels/tmr_vote.py:50"),
    }


def tree_specs():
    """K1, K2 (replicated state trees read in place): name -> (wrapper,
    plain version, replicas, integer ops per stream word, bytes per
    state word, TPU kernel it replaces).  K2 reads 3 replicas and writes
    the voted word into 3: 24 B a word."""
    from repro_torch.kernels import fused_step as fs

    return {
        "dmr_compare": (fs.dmr_compare, fs.dmr_compare_tree_plain, 2, 28, 8,
                        "src/repro/kernels/fused_step.py:81"),
        "tmr_step": (fs.tmr_step, fs.tmr_step_tree_plain, 3, 25, 24,
                     "src/repro/kernels/fused_step.py:134"),
    }


def replica_streams(n: int, gen, pad_to: int = 0, offset: int = 0):
    """Three replica word streams of n words (zero-padded to ``pad_to``),
    replica 1 with bit 30 of its middle word flipped; ``offset`` > 0 makes
    them views that start ``offset`` words into a buffer (not 16-byte
    aligned)."""
    m = max(n, pad_to)
    base = torch.zeros(m + offset, dtype=torch.int32, device="cuda")
    base[offset : offset + n] = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32,
                                              generator=gen, device="cuda")
    reps = [base.clone()[offset:] for _ in range(3)]
    reps[1][n // 2] ^= 1 << 30
    return reps


def replicate(one: dict, R: int, struck: int = 1) -> dict:
    """A replicated tree: each leaf of ``one`` repeated R times along a new
    leading axis, then one bit of replica ``struck`` flipped in the leaf's
    middle byte."""
    tree = {}
    for k, x in one.items():
        y = x.unsqueeze(0).repeat(R, *([1] * x.dim()))
        b = y[struck].reshape(-1).view(torch.uint8) if y.dtype != torch.bool else None
        if b is None:
            y[struck].view(-1)[x.numel() // 2] ^= True
        else:
            b[b.numel() // 2] ^= 1 << 6
        tree[k] = y
    return tree


def odd_tree(R: int, gen) -> dict:
    """A replicated tree of 40 leaves (three launches of 16 segments):
    f32, f16, int64 and int8 leaves of odd sizes read in place, some of
    whose replicas start off a 16-byte boundary (the scalar loop);
    sub-word bf16 and bool leaves and non-contiguous f32 leaves (packed
    copies); one leaf a contiguous view one word into a buffer; a bit of
    replica 1 flipped in every leaf."""
    dev = "cuda"
    one = {}
    for i in range(40):
        kind, n = i % 8, (7, 129, 65537, 12, 5, 33, 3, 1024)[i % 8]
        if kind in (0, 1, 2):
            one[f"l{i:02d}_f32_{n}"] = torch.randn(n, generator=gen, device=dev)
        elif kind == 3:
            one[f"l{i:02d}_i8_{n}"] = torch.randint(-128, 127, (3, n // 3), generator=gen,
                                                    device=dev).to(torch.int8)
        elif kind == 4:
            one[f"l{i:02d}_bf16_{n}"] = torch.randn(n, generator=gen, device=dev).bfloat16()
        elif kind == 5:
            one[f"l{i:02d}_f16_{n + 1}"] = torch.randn(n + 1, generator=gen, device=dev).half()
        elif kind == 6:
            one[f"l{i:02d}_bool_{n}"] = torch.rand(n, generator=gen, device=dev) > 0.5
        else:
            one[f"l{i:02d}_i64_{n}"] = torch.randint(-2**40, 2**40, (n,), generator=gen,
                                                     device=dev)
    tree = replicate(one, R)
    for i in (4, 20):  # non-contiguous: transposed views
        x = torch.randn(R, 6, 9, generator=gen, device=dev)
        x[1:] = x[0]
        x[1, 2, 3] = -x[1, 2, 3]
        tree[f"l{i:02d}_f32_t"] = x.transpose(1, 2)
    buf = torch.randn(1 + R * 257, generator=gen, device=dev)
    view = buf[1:].view(R, 257)  # contiguous, 4 bytes past a 16-byte boundary
    view[1:] = view[0]
    view[1, 100] += 1.0
    tree["l99_f32_offset"] = view
    return tree


def epilogue_bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bits_equal(t1, t2) -> bool:
    """Two trees (or tuples) of tensors hold the same shapes, dtypes and bits."""
    from repro_torch.core.fault import bitcast_int

    l1, l2 = _leaves(t1), _leaves(t2)
    return len(l1) == len(l2) and all(
        a.shape == b.shape and a.dtype == b.dtype and torch.equal(bitcast_int(a), bitcast_int(b))
        for a, b in zip(l1, l2))


def epilogue_record(name, replaces, ms, eager_ms, plain_ms, bound_ms, bound_by) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/csrc/redundancy_epilogue.cu",
        "replaces": replaces,
        "launches": None,
        "max_abs_err": 0.0,
        "tolerance": "bitwise",
        "ms": ms,
        "eager_ms": eager_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "library_why": NO_LIBRARY,
    }


def blend_tree(R: int, gen) -> dict:
    """The 4K blend's replicated state, {r, g, b} (R, W x H) f32 on the
    device, a bit of replica 1 flipped in "g"."""
    one = {c: torch.rand(W4K * H4K, generator=gen, device="cuda") * 255 for c in "rgb"}
    tree = {c: x.unsqueeze(0).repeat(R, 1) for c, x in one.items()}
    g = tree["g"][1].view(torch.int32)
    g[g.numel() // 2] ^= 1 << 30
    return tree


def tree_epilogue_phase(records: dict) -> None:
    """K1 and K2 through their wrappers, on replicated trees read in place,
    bitwise against the plain flatten path; times at the 4K blend tree."""
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    for name, (kernel, plain, R, ops_pw, bytes_pw, replaces) in tree_specs().items():
        cases = []
        for label, tree in (("4K blend", blend_tree(R, gen)), ("40 odd leaves", odd_tree(R, gen))):
            total = ops.word_layout(tree, lead=1).total
            for multiple in (fs.pick_block(total), 1, 1000):
                cases.append((f"{label}, padded to a multiple of {multiple}", tree, multiple))
        for n in ODD_SIZES:
            words = torch.randint(-(2**31), 2**31, (n,), dtype=torch.int32, generator=gen,
                                  device="cuda")
            flat = replicate({"w": words}, R)
            buf = torch.zeros(1 + R * n, dtype=torch.int32, device="cuda")
            buf[1:].view(R, n).copy_(flat["w"])
            cases += [(f"one leaf of {n} words", flat, 1),
                      (f"one leaf of {n} words, padded", flat, fs.pick_block(n)),
                      (f"one leaf of {n} words, unaligned", {"w": buf[1:].view(R, n)}, 1)]
        for label, tree, multiple in cases:
            got = kernel(tree, multiple)
            again = kernel(tree, multiple)
            torch.cuda.synchronize()
            ref = plain(tree, multiple)
            if not bits_equal(got, again):
                raise AssertionError(f"{name} {label}: two runs disagree")
            if not bits_equal(got, ref):
                raise AssertionError(f"{name} {label}: kernel != plain version")
            # every struck leaf has one struck word, in replica 1
            struck = sum(not bits_equal(x[1], x[0]) for x in _leaves(tree))
            if name == "dmr_compare" and int(got[0]) != struck:
                raise AssertionError(f"{name} {label}: {int(got[0])} mismatching words, "
                                     f"not {struck}")
            if name == "tmr_step":
                voted, counts = got[0], got[1].tolist()
                if counts != [0, struck, 0]:
                    raise AssertionError(f"{name} {label}: counts {counts}, not [0, {struck}, 0]")
                for k, x in tree.items():
                    if not all(bits_equal(voted[k][r], x[0]) for r in range(R)):
                        raise AssertionError(f"{name} {label}: leaf {k} not voted to replica 0")
        log(f"epilogue: {name} over replicated trees read in place bitwise equal to the plain "
            f"flatten path, twice, on {len(cases)} cases ({'; '.join(c[0] for c in cases)})")
        # times at the 4K blend tree: one replica set is 100-300 MB, above the 50 MB L2
        tree = blend_tree(R, gen)
        layout = ops.word_layout(tree, lead=1)
        blk = fs.pick_block(layout.total)
        launches0 = kernel.launches
        ms = graph_ms(lambda: kernel(tree, blk, layout))
        eager_ms = events_ms(lambda: kernel(tree, blk, layout))
        plain_ms = graph_ms(lambda: plain(tree, blk, layout), reps=2, iters=3)
        kernel.launches = launches0  # comparison launches do not count
        padded = layout.padded(blk)
        bound_ms, bound_by = epilogue_bound(layout.total * bytes_pw, padded * ops_pw)
        log(f"epilogue: {name} at the 4K blend tree ({layout.total} words a replica, padded to "
            f"{padded}): kernel {ms:.4f} ms (eager {eager_ms:.4f} ms, "
            f"{layout.total * bytes_pw / (ms * 1e-3) / 1e12:.2f} TB/s), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {bytes_pw} B a word, {ops_pw} int ops a "
            f"stream word)")
        records[name] = epilogue_record(name, replaces, ms, eager_ms, plain_ms, bound_ms, bound_by)
        del tree


def epilogue_phase() -> dict:
    records = {}
    tree_epilogue_phase(records)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    for name, (kernel, plain, k, pad, ops_pw, bytes_pw, replaces) in epilogue_specs().items():
        cases = [("4K", STREAM_4K, 0, 0)]
        for n in ODD_SIZES:
            padded = n + (-n) % pad(n)
            cases += [(f"n={n}", n, 0, 0), (f"n={n} padded to {padded}", n, padded, 0),
                      (f"n={n} unaligned", n, 0, 1)]
        for label, n, pad_to, offset in cases:
            reps = replica_streams(n, gen, pad_to, offset)
            ins = reps[:k] if k > 1 else reps[1:2]  # K3 hashes the struck replica
            got = kernel(*ins)
            again = kernel(*ins)
            torch.cuda.synchronize()
            ref = plain(*ins)
            if not bits_equal(got, again):
                raise AssertionError(f"{name} {label}: two runs disagree")
            if not bits_equal(got, ref):
                raise AssertionError(f"{name} {label}: kernel != plain version")
            if name == "tmr_vote" and (
                    got[1].tolist() != [0, 1, 0] or not torch.equal(got[0], reps[0])):
                raise AssertionError(f"{name} {label}: vote did not outvote the flip")
        log(f"epilogue: {name} bitwise equal to its plain version, twice, on "
            f"{len(cases)} streams (4K = {STREAM_4K} words; {', '.join(c[0] for c in cases[1:])})")
        # times at the 4K stream: one replica set is 100-300 MB, above the 50 MB L2
        reps = replica_streams(STREAM_4K, gen)
        ins = reps[:k] if k > 1 else reps[1:2]
        launches0 = kernel.launches
        ms = graph_ms(lambda: kernel(*ins))
        eager_ms = events_ms(lambda: kernel(*ins))
        plain_ms = graph_ms(lambda: plain(*ins), reps=2, iters=3)
        kernel.launches = launches0  # comparison launches do not count
        bound_ms, bound_by = epilogue_bound(STREAM_4K * bytes_pw, STREAM_4K * ops_pw)
        log(f"epilogue: {name} at the 4K stream: kernel {ms:.4f} ms (eager {eager_ms:.4f} ms, "
            f"{STREAM_4K * bytes_pw / (ms * 1e-3) / 1e12:.2f} TB/s), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {bytes_pw} B and {ops_pw} int ops a word)")
        records[name] = epilogue_record(name, replaces, ms, eager_ms, plain_ms, bound_ms, bound_by)
    return records


# --------------------------------------------------------------------------
# phase 2c: the paper's loop, Listing 1 at 4K under DMR and TMR
# --------------------------------------------------------------------------
LOOP_STEPS = 64
STRIKE_STEP = 20


def blend_program(policy, n: int = W4K * H4K):
    """Paper Listing 1: ImageBlend {r, g, b} blends toward the unreplicated
    StaticImage, c = .99 c + .01 StaticImage.c, at 4K UHD (or ``n``
    pixels); both images made from the generator on the device."""
    from repro_torch import api


    def image(gen, dev):
        return {c: torch.rand(n, generator=gen, device=dev) * 255 for c in "rgb"}

    prog = api.MisoProgram()
    prog.add(api.CellType(
        "ImageBlend", image,
        lambda prev: {c: 0.99 * prev["ImageBlend"][c] + 0.01 * prev["StaticImage"][c] for c in "rgb"},
        reads=("StaticImage",), redundancy=policy))
    prog.add(api.CellType("StaticImage", image, lambda prev: prev["StaticImage"]))
    return prog


def loop_phase(epi: dict) -> dict:
    from repro_torch import api
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import ops
    from repro_torch.kernels import state_hash as sh
    from repro_torch.kernels import tmr_vote as tv
    from repro_torch.tree import tree_map

    dmr = api.RedundancyPolicy(level=2)
    tmr = api.RedundancyPolicy(level=3)
    fault = api.FaultSpec.at(step=STRIKE_STEP, cell_id=0, replica=1, leaf=0,
                             index=(H4K // 2) * W4K + W4K // 2, bit=30)
    wrappers = (fs.dmr_compare, fs.tmr_step, sh.state_hash, tv.tmr_vote)
    exe = api.compile(blend_program(dmr), backend="auto")
    if exe.name != "lockstep_cuda":
        raise AssertionError(f"backend='auto' resolved to {exe.name!r}, not 'lockstep_cuda'")
    s_dmr = exe.init(SEED)
    torch.cuda.synchronize()
    launches = {}
    for w in wrappers:  # counts start here
        w.launches = 0
    # F3: lockstep_cuda reads the replicas where they lie; the packed copy
    # of the word layer must not run on its path
    flatten_calls = [0]
    flatten = ops.flatten_replicas

    def counting_flatten(*a, **k):
        flatten_calls[0] += 1
        return flatten(*a, **k)

    ops.flatten_replicas = counting_flatten

    def run(exe, states, faults=None):
        res = exe.run(states, LOOP_STEPS, faults=faults)
        torch.cuda.synchronize()
        return res

    # (a) DMR bitwise, against the port's own lockstep on the card
    k0 = fs.dmr_compare.launches
    res = run(exe, s_dmr, fault)
    launches["dmr_bitwise"] = fs.dmr_compare.launches - k0
    ref_exe = api.compile(blend_program(dmr), backend="lockstep")
    ref = run(ref_exe, s_dmr, fault)
    recent = exe.ledger.recent.get("ImageBlend", [])
    if recent[:1] != [STRIKE_STEP] or recent != ref_exe.ledger.recent["ImageBlend"]:
        raise AssertionError(f"DMR: events at {recent[:3]}..., not from step {STRIKE_STEP}")
    if not bits_equal(res.states, ref.states) or not bits_equal(res.reports, ref.reports):
        raise AssertionError("DMR: lockstep_cuda states/reports differ from lockstep")
    if exe.ledger.totals != ref_exe.ledger.totals:
        raise AssertionError("DMR: ledger totals differ from lockstep")
    canon = res.states["ImageBlend"]
    if not all(bool(torch.isfinite(x[0]).all()) for x in _leaves(canon)):
        raise AssertionError("DMR: replica 0 is not finite")
    log(f"loop: auto -> {exe.name}; DMR bitwise: first event at step {recent[0]}, "
        f"{exe.ledger.totals['ImageBlend']['events']:.0f} events over {LOOP_STEPS} steps, "
        f"states, reports and ledger bitwise equal to lockstep; K1 launches "
        f"{launches['dmr_bitwise']}")

    # (b) DMR compare="hash": the kernel's fingerprints decide
    exe_h = api.compile(blend_program(api.RedundancyPolicy(level=2, compare="hash")), backend="auto")
    k0 = fs.dmr_compare.launches
    res_h = run(exe_h, s_dmr, fault)
    launches["dmr_hash"] = fs.dmr_compare.launches - k0
    recent_h = exe_h.ledger.recent.get("ImageBlend", [])
    if recent_h != recent or not bits_equal(res_h.states, res.states):
        raise AssertionError(f"DMR hash: events at {recent_h[:3]}..., not those of bitwise")

    # (c) DMR compare_every=4: the kernel runs on every 4th step only
    exe_4 = api.compile(blend_program(dmr), backend="auto", compare_every=4)
    k0 = fs.dmr_compare.launches
    res_4 = run(exe_4, s_dmr, fault)
    launches["dmr_every4"] = fs.dmr_compare.launches - k0
    recent_4 = exe_4.ledger.recent.get("ImageBlend", [])
    if recent_4[:1] != [STRIKE_STEP + 3] or not bits_equal(res_4.states, res.states):
        raise AssertionError(f"DMR every 4: events at {recent_4[:3]}, not from step {STRIKE_STEP + 3}")
    del s_dmr, res, ref, res_h, res_4

    # (d) TMR: voted away at once; the final states are the unstruck run's
    exe_t = api.compile(blend_program(tmr), backend="auto")
    s_tmr = exe_t.init(SEED)
    k0 = fs.tmr_step.launches
    res_t = run(exe_t, s_tmr, fault)
    launches["tmr"] = fs.tmr_step.launches - k0
    tot = exe_t.ledger.totals["ImageBlend"]
    if tot["per_replica"] != [0.0, 1.0, 0.0] or tot["events"] != 1.0:
        raise AssertionError(f"TMR: totals {tot}, want one event on replica 1")
    clean_exe = api.compile(blend_program(tmr), backend="auto")
    clean = run(clean_exe, s_tmr)
    if not bits_equal(res_t.states, clean.states):
        raise AssertionError("TMR: the struck run's final states differ from the unstruck run's")
    if not all(bool(torch.isfinite(x).all()) for x in _leaves(res_t.states)):
        raise AssertionError("TMR: state not finite")
    ops.flatten_replicas = flatten
    if flatten_calls[0]:
        raise AssertionError(f"lockstep_cuda called flatten_replicas {flatten_calls[0]} times")
    log(f"loop: DMR hash: first event at step {recent_h[0]}, K1 launches "
        f"{launches['dmr_hash']}; DMR compare_every=4: first event at step {recent_4[0]}, "
        f"K1 launches {launches['dmr_every4']}; TMR: {tot['events']:.0f} event, per replica "
        f"{tot['per_replica']}, final states bitwise equal to the unstruck run; K2 launches "
        f"{launches['tmr']} (+{LOOP_STEPS} unstruck); flatten_replicas calls on the "
        f"lockstep_cuda runs: {flatten_calls[0]}")
    want = {"dmr_bitwise": LOOP_STEPS, "dmr_hash": LOOP_STEPS, "dmr_every4": LOOP_STEPS // 4,
            "tmr": LOOP_STEPS}
    if launches != want:
        raise AssertionError(f"K1/K2 launches {launches} != the compared steps {want}")

    # K3 and K4 through kernels.ops on the final state, against the plain versions
    final = res_t.states["ImageBlend"]  # (3, n) per channel, all replicas equal
    fp = ops.fingerprint_fused(tree_map(lambda x: x[0], final))
    fp_ref = sh.state_hash_plain(ops.flatten_to_u32(tree_map(lambda x: x[0], final),
                                                    multiple=ops.HASH_BLOCK))
    struck = tree_map(lambda x: x.clone(), final)
    g = struck["g"]
    g[2, g.shape[1] // 3] = -g[2, g.shape[1] // 3]  # a sign flip in replica 2
    voted, counts = ops.tmr_vote_pytree(struck)
    flats = ops.flatten_replicas(struck, 3, multiple=ops.VOTE_BLOCK)
    voted_ref, counts_ref = tv.tmr_vote_plain(flats[0], flats[1], flats[2])
    torch.cuda.synchronize()
    if not bits_equal(fp, fp_ref):
        raise AssertionError("fingerprint_fused: K3 != plain version")
    if not bits_equal(counts, counts_ref) or counts.tolist() != [0, 0, 1]:
        raise AssertionError(f"tmr_vote_pytree: counts {counts.tolist()} != plain / [0, 0, 1]")
    voted_words = ops.flatten_to_u32(voted, multiple=ops.VOTE_BLOCK)
    if not bits_equal(voted_words, voted_ref) or not bits_equal(voted, tree_map(lambda x: x[0], final)):
        raise AssertionError("tmr_vote_pytree: voted state != plain version / replica 0")
    for w, key in zip(wrappers, ("dmr_compare", "tmr_step", "state_hash", "tmr_vote")):
        epi[key]["launches"] = w.launches  # and are read here
        epi[key]["launches_by_path"] = {"loop_2c": w.launches}
        if w.launches == 0:
            raise AssertionError(f"{key} was not launched on the paper's loop")
    log(f"loop: ops.fingerprint_fused (K3) and ops.tmr_vote_pytree (K4, counts "
        f"{counts.tolist()}) on the final state bitwise equal to the plain versions; "
        f"launches on the loop: " + ", ".join(f"{k} {v['launches']}" for k, v in epi.items()))

    # ms per step, lockstep vs lockstep_cuda, in turns (F3's gate: DMR
    # lockstep_cuda no slower than lockstep)
    timing = {}
    for label, policy, states in (("dmr", dmr, None), ("tmr", tmr, s_tmr)):
        prog = blend_program(policy)
        if states is None:
            states = api.compile(prog, backend="lockstep").init(SEED)
        for backend in ("lockstep", "lockstep_cuda", "lockstep_cuda", "lockstep"):
            e = api.compile(prog, backend=backend)
            e.run(states, 4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.run(states, 16)
            torch.cuda.synchronize()
            timing.setdefault(f"{label}_{backend}_ms_per_step", []).append(
                (time.perf_counter() - t0) / 16 * 1e3)
        kernel = "dmr_compare" if policy.level == 2 else "tmr_step"
        fused = timing[f"{label}_lockstep_cuda_ms_per_step"]
        plain = timing[f"{label}_lockstep_ms_per_step"]
        log(f"loop: {label.upper()} 4K ms/step: lockstep {plain[0]:.3f} / {plain[1]:.3f}, "
            f"lockstep_cuda {fused[0]:.3f} / {fused[1]:.3f}; {kernel} {epi[kernel]['ms']:.4f} ms "
            f"({epi[kernel]['ms'] / min(fused) * 100:.1f} % of a step)")
    fused, plain = timing["dmr_lockstep_cuda_ms_per_step"], timing["dmr_lockstep_ms_per_step"]
    if sum(fused) > sum(plain):
        raise AssertionError(f"DMR lockstep_cuda {fused} ms/step is slower than lockstep {plain}")
    return {"launches": launches, "flatten_replicas_calls": flatten_calls[0], **timing}


# --------------------------------------------------------------------------
# phase 2g: the schedules and the MISO language, 4K UHD
# --------------------------------------------------------------------------
#: (step, replica, leaf, bit) of the campaign's four strikes: leaves 0-2 are
#: image1's b, g, r (keys sorted)
CAMPAIGN = ((5, 0, 0, 30), (20, 1, 1, 7), (40, 2, 2, 12), (63, 1, 0, 31))
WAVE_STEPS = 32


def listing1_4k():
    """The paper's Listing 1 at 4K UHD through the port's IR, with Int
    r/g/b images 0-255 made from the seed with numpy."""
    from repro_torch import api
    from repro_torch.core.ir import LISTING_1

    rng = np.random.default_rng(SEED)
    n = W4K * H4K
    inputs = {img: {c: rng.integers(0, 256, n).astype(np.int32) for c in "rgb"}
              for img in ("image1", "image2")}
    return api.compile_source(LISTING_1.replace("300*200", f"{W4K}*{H4K}"), inputs)


def sync_warnings(fn):
    """``(fn(), the texts of the warnings fn raised)`` under torch's sync
    debug mode, which warns once per synchronising CUDA call."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, [str(w.message) for w in caught]


def calibrate_syncs() -> tuple[str, list]:
    """The text of the warning one copy to the host raises, learnt after a
    first copy that may also carry the mode's once-a-process notice, and
    every text seen; a kernel launch must raise none."""
    x = torch.zeros(4, device="cuda")
    _, first = sync_warnings(lambda: x.cpu())
    _, texts = sync_warnings(lambda: x.cpu())
    _, quiet = sync_warnings(lambda: x + 1)
    if len(texts) != 1 or quiet:
        raise AssertionError(f"sync counter: a copy to the host raised {texts}, a launch {quiet}")
    return texts[0], sorted(set(first) | set(texts))


def host_syncs(fn, sync_text: str):
    """``(fn(), the synchronising CUDA calls fn made)``."""
    out, texts = sync_warnings(fn)
    return out, texts.count(sync_text)


def ms_per_step(exe, states, steps: int, faults=None) -> float:
    """Host clock over ``steps`` steps that end in a synchronise, after 4
    warm-up steps."""
    exe.run(states, 4, start_step=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exe.run(states, steps, start_step=0, faults=faults)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def in_turns(steps: int, **variants) -> dict:
    """ms/step of each (executor, states) variant, timed in turns a b b a."""
    names = list(variants)
    out = {k: [] for k in names}
    for k in names + names[::-1]:
        exe, states = variants[k]
        out[k].append(ms_per_step(exe, states, steps))
    return out


def wave_program(n: int):
    """``benchmarks/run.py::bench_mimd_wavefront`` in torch: two
    independent stencil chains, ``fast`` (work 1, DMR) and ``slow`` (work
    16, unreplicated), of n f32 cells each."""
    from repro_torch import api

    def stencil_cell(name, work, redundancy):
        def init(gen, dev):
            return {"t": torch.linspace(0, 1, n, device=dev)}

        def transition(prev):
            t = prev[name]["t"]
            for _ in range(work):  # heavier transition = slower unit
                t = 0.25 * torch.roll(t, 1) + 0.5 * t + 0.25 * torch.roll(t, -1)
            return {"t": t}

        return api.CellType(name, init, transition, instances=n, redundancy=redundancy)

    prog = api.MisoProgram()
    prog.add(stencil_cell("fast", 1, api.RedundancyPolicy(level=2)))
    prog.add(stencil_cell("slow", 16, api.NO_REDUNDANCY))
    return prog


def schedules_phase(epi: dict) -> dict:
    from repro_torch import api
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import state_hash as sh
    from repro_torch.kernels import tmr_vote as tv
    from repro_torch.tree import tree_map

    wrappers = {"dmr_compare": fs.dmr_compare, "tmr_step": fs.tmr_step,
                "state_hash": sh.state_hash, "tmr_vote": tv.tmr_vote}
    for w in wrappers.values():  # counts start here
        w.launches = 0
    dmr, tmr = api.RedundancyPolicy(level=2), api.RedundancyPolicy(level=3)
    centre = (H4K // 2) * W4K + W4K // 2
    strike = api.FaultSpec.at(step=STRIKE_STEP, cell_id=0, replica=1, leaf=2, index=centre,
                              bit=30)
    prog = listing1_4k()
    out = {}
    sync_text, texts = calibrate_syncs()
    log(f"schedules: host syncs counted by torch.cuda.set_sync_debug_mode('warn'), whose "
        f"warnings read: {'; '.join(texts)}")

    def run(exe, states, n, faults=None):
        res = exe.run(states, n, start_step=0, faults=faults)
        torch.cuda.synchronize()
        return res

    # (a) Listing 1 through the IR: auto -> lockstep_cuda, DMR and TMR
    exe_d = api.compile(prog, backend="auto", policies={"image1": dmr})
    exe_t = api.compile(prog, backend="auto", policies={"image1": tmr})
    for e in (exe_d, exe_t):
        if e.name != "lockstep_cuda":
            raise AssertionError(f"IR Listing 1: auto resolved to {e.name!r}, not lockstep_cuda")
    s_d, s_t = exe_d.init(SEED), exe_t.init(SEED)
    r = s_d["image1"]["r"]
    if r.dtype != torch.int32 or tuple(r.shape) != (2, W4K * H4K):
        raise AssertionError(f"IR Listing 1: image1.r is {r.dtype} {tuple(r.shape)}")
    k1 = fs.dmr_compare.launches
    res_d = run(exe_d, s_d, LOOP_STEPS, strike)
    k1 = fs.dmr_compare.launches - k1
    want = {"image1": list(range(STRIKE_STEP, LOOP_STEPS))}  # DMR detects, does not repair
    if exe_d.ledger.recent != want or k1 != LOOP_STEPS:
        raise AssertionError(f"IR DMR: ledger.recent {exe_d.ledger.recent}, K1 launches {k1}")
    k2 = fs.tmr_step.launches
    res_t = run(exe_t, s_t, LOOP_STEPS, strike)
    k2 = fs.tmr_step.launches - k2
    tot = exe_t.ledger.totals["image1"]
    clean_t = run(api.compile(prog, backend="auto", policies={"image1": tmr}), s_t, LOOP_STEPS)
    if (exe_t.ledger.recent != {"image1": [STRIKE_STEP]} or tot["per_replica"] != [0.0, 1.0, 0.0]
            or k2 != LOOP_STEPS or not bits_equal(res_t.states, clean_t.states)):
        raise AssertionError(f"IR TMR: recent {exe_t.ledger.recent}, totals {tot}, K2 {k2}, "
                             f"equal to unstruck {bits_equal(res_t.states, clean_t.states)}")
    # card against the port's CPU path: 8 steps, unstruck, DMR
    cpu_exe = api.compile(prog, backend="auto", device="cpu", policies={"image1": dmr})
    cpu = cpu_exe.run(cpu_exe.init(SEED), 8, start_step=0).states
    card = run(api.compile(prog, backend="auto", policies={"image1": dmr}), s_d, 8).states
    if cpu_exe.name != "lockstep" or not bits_equal(tree_map(lambda x: x.cpu(), card), cpu):
        raise AssertionError("IR DMR: 8 card steps differ from the port's CPU path")
    log(f"schedules: IR Listing 1 at 4K (Int slots): auto -> {exe_d.name}; DMR strike at step "
        f"{STRIKE_STEP} detected on steps {STRIKE_STEP}-{LOOP_STEPS - 1}, K1 launches {k1}; TMR "
        f"voted away ({tot['events']:.0f} event, per replica {tot['per_replica']}), final states "
        f"bitwise the unstruck run's, K2 launches {k2}; 8 DMR steps bitwise equal to the CPU path")
    blend_d = api.compile(blend_program(dmr), backend="lockstep_cuda")
    blend_t = api.compile(blend_program(tmr), backend="lockstep_cuda")
    times = in_turns(16, blend_dmr=(blend_d, blend_d.init(SEED)), ir_dmr=(exe_d, s_d))
    times.update(in_turns(16, blend_tmr=(blend_t, blend_t.init(SEED)), ir_tmr=(exe_t, s_t)))
    out["ir_ms_per_step"] = times
    log("schedules: 4K ms/step on lockstep_cuda, in turns: " + "; ".join(
        f"{k} {' / '.join(f'{v:.3f}' for v in vs)}" for k, vs in times.items()))
    del blend_d, blend_t, res_t, clean_t, cpu, card

    # (b) host: the §IV tie-break through K4
    exe_h = api.compile(prog, backend="host", policies={"image1": dmr})
    k4 = tv.tmr_vote.launches
    res_h = run(exe_h, s_d, LOOP_STEPS, [strike])
    k4 = tv.tmr_vote.launches - k4
    clean_d = run(api.compile(prog, backend="auto", policies={"image1": dmr}), s_d, LOOP_STEPS)
    if exe_h.recoveries != [(STRIKE_STEP, "image1")] or k4 != 1:
        raise AssertionError(f"host: recoveries {exe_h.recoveries}, K4 launches {k4}")
    if exe_h.ledger.totals["image1"]["events"] != 1.0:
        raise AssertionError(f"host: ledger {exe_h.ledger.totals['image1']}, want one event")
    if not bits_equal(res_h.states, clean_d.states):
        raise AssertionError("host: the recovered states differ from the unstruck lockstep_cuda run")
    _, host_sync = host_syncs(lambda: api.compile(prog, backend="host", policies={
        "image1": dmr}).run(s_d, 4, start_step=0), sync_text)
    _, lock_sync = host_syncs(lambda: exe_d.run(s_d, 4, start_step=0), sync_text)
    times = in_turns(16, lockstep_cuda=(exe_d, s_d), host=(exe_h, s_d))
    out["host"] = {"recoveries": [list(x) for x in exe_h.recoveries], "tmr_vote_launches": k4,
                   "syncs_per_4_steps": host_sync, "lockstep_cuda_syncs_per_4_steps": lock_sync,
                   "ms_per_step": times}
    log(f"schedules: host at 4K, DMR: recoveries {exe_h.recoveries} through K4 ({k4} launch), "
        f"final states bitwise the unstruck lockstep_cuda run's; host syncs over 4 steps "
        f"{host_sync} (lockstep_cuda {lock_sync}); ms/step in turns: " + "; ".join(
            f"{k} {' / '.join(f'{v:.3f}' for v in vs)}" for k, vs in times.items()))
    del res_h, clean_d, exe_h

    # (c) a fault campaign: TMR on lockstep_cuda, four strikes
    specs = [api.FaultSpec.at(step=t, cell_id=0, replica=rep, leaf=leaf, index=centre + 997 * i,
                              bit=bit) for i, (t, rep, leaf, bit) in enumerate(CAMPAIGN)]
    exe_c = api.compile(prog, backend="auto", policies={"image1": tmr})
    clean = run(exe_c, s_t, LOOP_STEPS).states
    steps0, ledger0 = exe_c.metrics()["steps"], json.dumps(exe_c.ledger.totals, sort_keys=True)
    k2 = fs.tmr_step.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    camp = exe_c.run_campaign(s_t, LOOP_STEPS, specs, start_step=0)
    torch.cuda.synchronize()
    camp_ms = (time.perf_counter() - t0) / (len(specs) * LOOP_STEPS) * 1e3
    k2 = fs.tmr_step.launches - k2
    if exe_c.metrics()["steps"] != steps0 or json.dumps(exe_c.ledger.totals, sort_keys=True) != ledger0:
        raise AssertionError("run_campaign moved the executor's step counter or ledger")
    events = camp.reports["image1"]["events"].tolist()
    per = camp.reports["image1"]["per_replica"].tolist()
    if events != [1.0] * len(specs) or k2 != len(specs) * LOOP_STEPS:
        raise AssertionError(f"run_campaign: events {events}, K2 launches {k2}")
    for i, spec in enumerate(specs):
        traj = tree_map(lambda x, i=i: x[i], camp.states)
        st = s_t
        for t in range(LOOP_STEPS):
            st, _ = exe_c.pure_step(st, t, spec if spec.step == t else None)
        if not bits_equal(traj, clean) or not bits_equal(traj, st):
            raise AssertionError(f"run_campaign trajectory {i}: not the unstruck run / pure_step")
        if per[i][spec.replica] != 1.0 or sum(per[i]) != 1.0:
            raise AssertionError(f"run_campaign trajectory {i}: per replica {per[i]}")
    out["campaign"] = {"trajectories": len(specs), "events": events, "tmr_step_launches": k2,
                       "ms_per_trajectory_step": camp_ms}
    log(f"schedules: run_campaign at 4K, TMR on {exe_c.name}: {len(specs)} trajectories "
        f"(strikes at steps {[s.step for s in specs]}, replicas {[s.replica for s in specs]}, "
        f"leaves {[s.leaf for s in specs]}) each voted away (events {events}), bitwise the "
        f"unstruck run and a pure_step loop; ledger and step counter unchanged; "
        f"{camp_ms:.3f} ms a trajectory-step, K2 launches {k2}")
    del camp, clean, exe_c, exe_d, exe_t, s_d, s_t, prog
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the §III wavefront: two independent chains at 4K cells each
    from repro_torch.obs import Tracer

    wprog = wave_program(W4K * H4K)
    wf = api.compile(wprog, backend="auto", window=8)
    if wf.name != "wavefront":
        raise AssertionError(f"wavefront program: auto resolved to {wf.name!r}")
    s_w = wf.init(SEED)
    res_w, wave_sync = host_syncs(lambda: wf.run(s_w, WAVE_STEPS, start_step=0), sync_text)
    lock = api.compile(wprog, backend="lockstep")
    res_l, lock_sync = host_syncs(lambda: lock.run(s_w, WAVE_STEPS, start_step=0), sync_text)
    res_c = run(api.compile(wprog, backend="lockstep_cuda"), s_w, WAVE_STEPS)
    if wf.max_lead() <= 0 or wave_sync != 1:
        raise AssertionError(f"wavefront: max_lead {wf.max_lead()}, host syncs {wave_sync}")
    if not bits_equal(res_w.states, res_l.states) or not bits_equal(res_w.states, res_c.states):
        raise AssertionError("wavefront: final states differ from lockstep / lockstep_cuda")
    tracer = Tracer()
    wf_s = api.compile(wprog, backend="auto", window=8, on_event=tracer.executor_hook())
    hit = api.FaultSpec.at(step=12, cell_id=wprog.cell_id("fast"), replica=1, index=12345, bit=29)
    wf_s.run(s_w, WAVE_STEPS, start_step=0, faults=hit)
    unit_steps = sum(e["name"] == "unit_step" for e in tracer.events())
    recent = wf_s.ledger.recent.get("fast", [])
    if recent[:1] != [12] or unit_steps != 2 * WAVE_STEPS:
        raise AssertionError(f"wavefront: strike at {recent[:1]}, unit_step events {unit_steps}")
    times = in_turns(WAVE_STEPS, lockstep=(lock, s_w), wavefront=(wf, s_w))
    out["wavefront"] = {"units": wf.metrics()["units"], "max_lead": wf.max_lead(),
                        "window": wf.window, "host_syncs": wave_sync,
                        "lockstep_host_syncs": lock_sync, "unit_step_events": unit_steps,
                        "ms_per_step": times}
    log(f"schedules: wavefront at {W4K * H4K} cells a unit (fast DMR work 1, slow work 16): "
        f"auto -> wavefront, max_lead {wf.max_lead()}, host syncs over {WAVE_STEPS} steps "
        f"{wave_sync} (lockstep {lock_sync}), final states bitwise lockstep's and "
        f"lockstep_cuda's, strike into fast in the ledger at {recent[0]}, {unit_steps} unit_step "
        f"events traced; ms/step in turns: " + "; ".join(
            f"{k} {' / '.join(f'{v:.3f}' for v in vs)}" for k, vs in times.items()))
    for key, w in wrappers.items():  # and are read here
        epi[key]["launches_by_path"]["schedules_2g"] = w.launches
        epi[key]["launches"] += w.launches
    out["launches"] = {k: w.launches for k, w in wrappers.items()}
    return out


# --------------------------------------------------------------------------
# phase 2d: K8 against its plain version
# --------------------------------------------------------------------------
#: mamba2-2.7b's scan shapes: 80 heads of 64, state 128, one B/C group
#: (zamba2-2.7b's are the same with state 64)
SSD_SHAPE = dict(H=80, P=64, G=1, N=128)
ZAMBA_N = 64
SSD_CHUNK = 128
NO_SSD_LIBRARY = "none, no one PyTorch call computes the SSD scan"


def ssd_inputs(L, gen, dtype=torch.bfloat16, with_h0=False, B=1, H=80, P=64, G=1, N=128):
    """Scan inputs as a mamba2 layer makes them: dt = softplus of a
    normal shifted by -2 (0.01-1), a = -(1..16) as ``a_log`` is
    initialised, x / B / C of O(1)."""
    dev = "cuda"

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = rn(B, L, H, P).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, L, H) - 2.0)
    a = -torch.linspace(1.0, 16.0, H, device=dev)
    bm, cm = rn(B, L, G, N).to(dtype), rn(B, L, G, N).to(dtype)
    h0 = rn(B, H, N, P) if with_h0 else None
    return x, dt, a, bm, cm, h0


def ssd_bound(x, bm, h0, chunk=SSD_CHUNK) -> tuple[float, str, float, int, int]:
    """Least time for one scan: x, dt, a, B, C (and h0) read once, y and
    the f32 state written once, over HBM bandwidth — or the products this
    run's chunks need (the causal half of C.B^T and W.X, C.S and the
    state update, counted per real row) over the bf16 tensor-core rate,
    whichever is larger.  Also the same FLOPs over the f32 CUDA-core
    rate, the rate the kernel computes at."""
    B, L, H, P = x.shape
    G, N = bm.shape[2], bm.shape[3]
    item = x.element_size()
    nbytes = 2 * x.numel() * item + B * L * H * 4 + H * 4 + 2 * bm.numel() * item
    nbytes += B * H * N * P * 4 * (2 if h0 is not None else 1)
    Q = min(chunk, L)
    flops = 0
    for c0 in range(0, L, Q):
        q = min(Q, L - c0)
        flops += q * (q + 1) * N + q * (q + 1) * P + 2 * q * N * P + 2 * q * N * P
    flops *= B * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    bound = max(t_bytes, t_ops) * 1e3
    return bound, "bytes" if t_bytes >= t_ops else "operations", flops / F32_FLOP_PER_S * 1e3, nbytes, flops


#: K8's limits (atol = rtol): y in bf16 2e-2 (both sides sum in f32 and
#: round to bf16, so one rounding may flip by a bf16 ulp, 2**-8 relative),
#: y in f32 1e-3; the state 1e-3 (f32; its decays exp(cum) come from
#: cumsums of up to 128 terms of |cum| <= 10**2, whose f32 rounding, ~1e-5,
#: exp turns into ~1e-5 relative; the bf16 kernel's hi/lo operands keep 16
#: significant bits).  Each row, one (b, t, h) vector of P in y and one (b,
#: h, n) row of P in the state, also within a relative L2 limit: 1e-2 for
#: bf16 y (K7's), 1e-3 for f32 y and the state.
SSD_TOL = {"y_bf16": 2e-2, "y_f32": 1e-3, "state": 1e-3}
SSD_ROW_TOL = {"y_bf16": 1e-2, "y_f32": 1e-3, "state": 1e-3}


def ssd_verdict(got, ref, kind) -> tuple[bool, float, float, float]:
    """(within both limits, max abs err, worst ratio to the elementwise
    limit, worst row's relative L2 error) of one K8 output."""
    t, r = SSD_TOL[kind], SSD_ROW_TOL[kind]
    g, f = got.float(), ref.float()
    err = (g - f).abs()
    ratio = float((err / (t + t * f.abs())).max())
    row = float(((g - f).norm(dim=-1) / f.norm(dim=-1).clamp_min(1e-30)).max())
    ok = bool(torch.isfinite(g).all()) and ratio <= 1.0 and row <= r
    return ok, float(err.max()), ratio, row


def ssd_planted_faults(x, dt, a, bm, cm, h0) -> dict:
    """(y, state) of two faults the state passing could make, computed from
    the plain form of the kernel's three steps: the inter-chunk carry
    dropped (every chunk reads S_in = h0), and a stale chunk (chunk c reads
    S_in of chunk c - 1)."""
    from repro_torch.kernels import ssd_scan as ks

    ds, dec = ks.ssd_chunk_states(x, dt, a, bm, chunk=SSD_CHUNK)
    s_in, _ = ks.ssd_state_passing(ds, dec, h0)
    dec_last, ds_last = dec[:, :, -1, None, None], ds[:, :, -1]
    dropped = h0[:, :, None].expand_as(s_in)
    stale = torch.cat([s_in[:, :, :1], s_in[:, :, :-1]], dim=2)
    out = {}
    for name, s in (("carry dropped (S_in = h0 in every chunk)", dropped),
                    ("stale chunk (chunk c reads S_in of c - 1)", stale)):
        y = ks.ssd_chunk_outputs(x, dt, a, bm, cm, s, chunk=SSD_CHUNK)
        out[name] = (y, dec_last * s[:, :, -1] + ds_last)
    return out


def ssd_phase(build_log: Path) -> dict:
    from repro_torch.kernels import ssd_scan as ks

    for ln in ptxas_lines(build_log):
        log(f"ssd: ptxas {ln}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    errs, rows = {}, {}
    launches0 = ks.ssd_scan.launches
    N = SSD_SHAPE["N"]
    cases = [(256, torch.bfloat16, False, N), (256, torch.bfloat16, True, N),
             (300, torch.bfloat16, False, N), (300, torch.bfloat16, True, N),
             (300, torch.float32, True, N),
             # zamba2-2.7b's scans: state 64, two and two and a half chunks
             (256, torch.bfloat16, True, ZAMBA_N), (320, torch.bfloat16, False, ZAMBA_N),
             (320, torch.bfloat16, True, ZAMBA_N)]
    for L, dtype, with_h0, N in cases:
        x, dt, a, bm, cm, h0 = ssd_inputs(L, gen, dtype, with_h0, N=N)
        y, ht = ks.ssd_scan(x, dt, a, bm, cm, h0=h0, chunk=SSD_CHUNK)
        torch.cuda.synchronize()
        ry, rht = ks.ssd_scan_plain(x, dt, a, bm, cm, h0=h0, chunk=SSD_CHUNK)
        label = (f"L={L} {str(dtype).removeprefix('torch.')}{' h0' if with_h0 else ''}"
                 f"{f' N={N}' if N != SSD_SHAPE['N'] else ''}")
        assert y.dtype == dtype and y.shape == x.shape and ht.shape == rht.shape
        msg = []
        for name, got, ref, kind in (("y", y, ry, "y_bf16" if dtype == torch.bfloat16 else "y_f32"),
                                     ("state", ht, rht, "state")):
            ok, err, ratio, row = ssd_verdict(got, ref, kind)
            errs[f"{label} {name}"], rows[f"{label} {name}"] = err, row
            msg.append(f"{name} max_abs_err {err:.3e} ({ratio:.3f} of atol=rtol {SSD_TOL[kind]}), "
                       f"worst row L2 {row:.3e} (limit {SSD_ROW_TOL[kind]})")
            if not ok:
                raise AssertionError(f"ssd_scan {label} {name}: max abs err {err}, {ratio} of the "
                                     f"elementwise limit, row L2 {row}")
        log(f"ssd: {label}: " + "; ".join(msg))
        if L in (300, 320) and dtype == torch.bfloat16 and with_h0:
            # the check must reject what a broken state passing would give
            for name, (fy, fht) in ssd_planted_faults(x, dt, a, bm, cm, h0).items():
                v = [ssd_verdict(fy.to(dtype), ry, "y_bf16"), ssd_verdict(fht, rht, "state")]
                if v[0][0] and v[1][0]:
                    raise AssertionError(f"ssd_scan {label}: the planted fault '{name}' passes "
                                         "the check")
                log(f"ssd: {label} planted fault, {name}: y {v[0][2]:.1f} of the elementwise "
                    f"limit, row L2 {v[0][3]:.3e}; state {v[1][2]:.1f}, row L2 {v[1][3]:.3e}: "
                    "rejected")
    # times at the prefill's own call: no h0, bf16; 4 input sets so a call
    # does not find its 8 MB in L2 from the one before
    timings = {}
    for L, N in ((128, SSD_SHAPE["N"]), (256, SSD_SHAPE["N"]), (300, SSD_SHAPE["N"]),
                 (320, SSD_SHAPE["N"]), (256, ZAMBA_N), (320, ZAMBA_N)):
        sets = [ssd_inputs(L, gen, N=N) for _ in range(4)]
        it = iter(range(10**9))

        def nxt():
            return sets[next(it) % len(sets)]

        ms = graph_ms(lambda: ks.ssd_scan(*nxt()[:5], chunk=SSD_CHUNK), reps=10, iters=5)
        eager_ms = events_ms(lambda: ks.ssd_scan(*nxt()[:5], chunk=SSD_CHUNK), iters=10)
        plain_ms = graph_ms(lambda: ks.ssd_scan_plain(*nxt()[:5], chunk=SSD_CHUNK), reps=2, iters=3)
        x, _, _, bm, _, _ = sets[0]
        bound_ms, bound_by, f32_ms, nbytes, flops = ssd_bound(x, bm, None)
        timings[L if N == SSD_SHAPE["N"] else f"{L}_N{N}"] = dict(
            ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        blocks = ks.bf16_blocks(1, L, SSD_SHAPE["H"], N, SSD_SHAPE["P"])
        log(f"ssd: L={L} B=1 H=80 P=64 N={N} bf16: kernel {ms:.4f} ms (eager {eager_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP; the FLOPs on the f32 CUDA cores {f32_ms:.4f} ms); "
            f"library: {NO_SSD_LIBRARY}; blocks of the three launches {blocks} on "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    # a CUDA graph keeps the three launches' dependencies: its replay gives
    # the eager call's bits
    x, dt, a, bm, cm, h0 = ssd_inputs(300, gen, with_h0=True)
    ey, eht = ks.ssd_scan(x, dt, a, bm, cm, h0=h0, chunk=SSD_CHUNK)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        gy, ght = ks.ssd_scan(x, dt, a, bm, cm, h0=h0, chunk=SSD_CHUNK)
    gy.zero_(), ght.zero_()
    g.replay()
    torch.cuda.synchronize()
    if not (torch.equal(gy, ey) and torch.equal(ght, eht)):
        raise AssertionError("ssd_scan: a CUDA-graph replay differs from the eager call")
    log("ssd: L=300 bf16 h0 under CUDA-graph replay: y and state bitwise equal to the eager call")
    log(f"ssd: device time by launch at L=256, eager: {ssd_launch_breakdown(ks, gen)}")
    ks.ssd_scan.launches = launches0  # comparison launches do not count
    t = timings[256]
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:103",
        "launches": None,
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_case": errs,
        "row_l2_by_case": rows,
        "tolerance": SSD_TOL,
        "row_tolerance": SSD_ROW_TOL,
        "ms": t["ms"],
        "eager_ms": t["eager_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "library_why": NO_SSD_LIBRARY,
        "shape": "B=1 L=256 H=80 P=64 G=1 N=128 bf16, chunk 128",
        **{f"L{L}": timings[L] for L in (128, 300, 320, f"256_N{ZAMBA_N}", f"320_N{ZAMBA_N}")},
    }


def device_kernel_us(prof) -> dict:
    """Device time (us) by kernel name of a torch.profiler run: the events
    the profiler recorded on the card (kernels, copies, fills)."""
    from torch.autograd import DeviceType

    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return out


def profiled(fn, calls: int = 1) -> tuple[float, dict]:
    """(host ms per call, synchronised; device us per call by kernel name)
    of ``calls`` calls of fn under torch.profiler, after one warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    return wall, {k: v / calls for k, v in device_kernel_us(prof).items()}


def ssd_launch_breakdown(ks, gen, L: int = 256, calls: int = 20) -> str:
    """Device time of each CUDA kernel one K8 call launches, from
    torch.profiler over ``calls`` eager calls; "not measured" where the
    profiler records no device time."""
    args = ssd_inputs(L, gen)[:5]
    _, by_name = profiled(lambda: ks.ssd_scan(*args, chunk=SSD_CHUNK), calls)
    parts = [f"{re.sub(r'[(<].*', '', k.replace('(anonymous namespace)::', ''))}: {us / 1e3:.4f} ms"
             for k, us in by_name.items() if us > 0]
    return "; ".join(parts) or "not measured"


# --------------------------------------------------------------------------
# phase 2e: K7 through kernels.ops.attention, against its plain version
# --------------------------------------------------------------------------
#: (label, Sq, Sk, window, q_offset) at internlm2's head layout
ATTN_CASES = [("causal 512", 512, 512, None, 0), ("causal 4096", 4096, 4096, None, 0),
              ("window 128 at 512", 512, 512, 128, 0), ("q_offset 384", 128, 512, None, 384)]


def attn_inputs(Sq, Sk, gen, dtype=torch.bfloat16, B=1, Hq=16, Hkv=8, D=128):
    dev = "cuda"
    q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, Sk, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, Sk, D), generator=gen, device=dev).to(dtype)
    return q, k, v


def attn_bound(q, k, window, q_offset) -> tuple[float, str, float]:
    """Least time for one call: q, k, v read once and the output written
    once over HBM bandwidth, or 4 D flops per visible (query, key) pair
    and query head over the bf16 tensor-core rate, whichever is larger;
    and the FLOPs over the f32 CUDA-core rate."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    vis = kpos <= qpos
    if window is not None:
        vis &= kpos > qpos - window
    pairs = int(vis.sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    flops = 4 * D * pairs * Hq * B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", flops / F32_FLOP_PER_S * 1e3


#: (label, S, head dim) of the extra bf16 cases: the other head-dim
#: instances with one warpgroup a block (512) and with two (2048)
ATTN_HEAD_DIMS = [("causal 512 D=64", 512, 64), ("causal 512 D=120 (padded to 128)", 512, 120),
                  ("causal 512 D=256", 512, 256), ("causal 2048 D=64", 2048, 64),
                  ("causal 2048 D=256", 2048, 256)]
#: each element within atol = rtol; bf16: one rounding of an O(1) output
#: of the first rows is 2**-8 relative, f32: reduction order only
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
#: each row's relative L2 error.  bf16: P and the output rounded to bf16
#: cost about 2**-9 relative each; at 4096 keys an output is ~0.03, so
#: the elementwise atol alone could not see a tile skipped or read stale
ATTN_ROW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
#: the key tile of the D=128 bf16 instance: the planted faults' unit
ATTN_BLOCK_K = 128


def attn_verdict(got, ref) -> tuple[bool, float, float, int]:
    """(passes, max abs err, max row relative L2 err, elements over the
    elementwise limit) of K7's output against its plain version."""
    t, r = ATTN_TOL[ref.dtype], ATTN_ROW_TOL[ref.dtype]
    g, f = got.float(), ref.float()
    err = (g - f).abs()
    over = int((err > t + t * f.abs()).sum())
    row = float(((g - f).norm(dim=-1) / f.norm(dim=-1).clamp_min(1e-30)).max())
    return over == 0 and row <= r, float(err.max()), row, over


def planted_faults(q, k, v) -> dict:
    """Outputs of two faults a TMA ring could make, computed plainly, at
    causal attention: the query rows of the last quarter skip key tile 10,
    and key tile 10 is read from the stage of tile 8 (stale)."""
    from repro_torch.kernels.flash_attention import attention_plain

    Sq, Sk, G = q.shape[2], k.shape[2], q.shape[1] // k.shape[1]
    t0, t1, back = 10 * ATTN_BLOCK_K, 11 * ATTN_BLOCK_K, 2 * ATTN_BLOCK_K
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril()
    keep[3 * Sq // 4:, t0:t1] = False
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * q.shape[-1] ** -0.5,
                     k.float().repeat_interleave(G, 1))
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    del s
    skipped = torch.einsum("bhqk,bhkd->bhqd", p, v.float().repeat_interleave(G, 1)).to(q.dtype)
    del p
    ks, vs = k.clone(), v.clone()
    ks[:, :, t0:t1], vs[:, :, t0:t1] = k[:, :, t0 - back:t1 - back], v[:, :, t0 - back:t1 - back]
    return {"key tile 10 skipped by the last quarter's rows": skipped,
            "key tile 10 read from tile 8's stage": attention_plain(q, ks, vs, causal=True)}


def attention_phase(build_log: Path) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    inputs = [attn_inputs(sq, sk, gen) for _, sq, sk, _, _ in ATTN_CASES]
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0  # counts start here
    outs = [ops.attention(*qkv, causal=True, window=w, q_offset=off)
            for qkv, (_, _, _, w, off) in zip(inputs, ATTN_CASES)]
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches  # and are read here
    if launches != len(ATTN_CASES):
        raise AssertionError(f"K7 launches {launches} != {len(ATTN_CASES)} ops.attention calls")
    errs, row_errs = {}, {}
    checks = list(zip(ATTN_CASES, inputs, outs))
    q32 = [t.float() for t in inputs[0]]
    checks.append((("causal 512 f32", 512, 512, None, 0), q32, fa.flash_attention(*q32)))
    for label, n, d in ATTN_HEAD_DIMS:
        qkv = attn_inputs(n, n, gen, D=d)
        checks.append(((label, n, n, None, 0), qkv, fa.flash_attention(*qkv)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    instances = set()
    for (label, _, _, w, off), qkv, got in checks:
        ref = fa.attention_plain(*qkv, causal=True, window=w, q_offset=off)
        if not bool(torch.isfinite(got.float()).all()) or got.shape != ref.shape:
            raise AssertionError(f"flash_attention {label}: not finite or wrong shape")
        ok, errs[label], row_errs[label], over = attn_verdict(got, ref)
        if not ok:
            raise AssertionError(f"flash_attention {label}: max abs err {errs[label]}, max row "
                                 f"relative L2 err {row_errs[label]}, {over} elements over the limit")
        if got.dtype == torch.bfloat16:
            B, Hq, Sq, D = qkv[0].shape
            instances.add(fa.plan(B, Hq, Sq, D, sms))
    want = {(d, w) for d in fa.BF16_HEAD_DIMS for w in (1, 2)}
    if instances != want:
        raise AssertionError(f"bf16 instances compared {sorted(instances)}, not all of {sorted(want)}")
    log("attention: ops.attention -> flash_attention (K7), B=1 Hq=16 Hkv=8, D=128 bf16 unless "
        "named: " + ", ".join(f"{k} max_abs_err {v:.3e} row_rel_l2 {row_errs[k]:.3e}"
                              for k, v in errs.items())
        + f" (atol=rtol bf16 {ATTN_TOL[torch.bfloat16]}, f32 {ATTN_TOL[torch.float32]}; row "
        f"relative L2 bf16 {ATTN_ROW_TOL[torch.bfloat16]}, f32 {ATTN_ROW_TOL[torch.float32]}); "
        f"bf16 (instance, warpgroups) compared: {sorted(instances)}; launches {launches}")
    # the check must be sharp enough to see a ring fault at 4096
    ref4k = fa.attention_plain(*inputs[1], causal=True)
    planted = {}
    for label, bad in planted_faults(*inputs[1]).items():
        ok, err, row, over = attn_verdict(bad, ref4k)
        planted[label] = {"max_abs_err": err, "row_rel_l2": row, "elements_over": over}
        log(f"attention: planted fault at causal 4096, {label}: max abs err {err:.3e}, row "
            f"relative L2 {row:.3e}, {over} elements over the elementwise limit -> "
            f"{'PASSES (check too loose)' if ok else 'rejected'}")
        if ok:
            raise AssertionError(f"flash_attention check does not reject the planted fault: {label}")
    del ref4k
    ptxas = ptxas_lines(build_log)
    log(f"attention: bf16 plan (head-dim instance, warpgroups) at 512 {fa.plan(1, 16, 512, 128, sms)}, "
        f"at 4096 {fa.plan(1, 16, 4096, 128, sms)}; ptxas per instance (f32_kernel, "
        f"bf16_kernel<D, key tile, warpgroups>): {'; '.join(ptxas)}")
    timings = {}
    for (label, sq, sk, w, off), qkv in zip(ATTN_CASES[:2], inputs[:2]):
        sets = [qkv] + [attn_inputs(sq, sk, gen) for _ in range(3)]
        it = iter(range(10**9))

        def nxt():
            return sets[next(it) % len(sets)]

        heavy = sq >= 4096
        ms = graph_ms(lambda: fa.flash_attention(*nxt()), reps=4 if heavy else 20, iters=5 if heavy else 10)
        eager_ms = events_ms(lambda: fa.flash_attention(*nxt()), iters=5 if heavy else 20)
        plain_ms = graph_ms(lambda: fa.attention_plain(*nxt()), reps=2, iters=3)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(*nxt(), is_causal=True,
                                                                    enable_gqa=True)

        library_ms = graph_ms(library, reps=4 if heavy else 20, iters=5 if heavy else 10)
        bound_ms, bound_by, f32_ms = attn_bound(qkv[0], qkv[1], w, off)
        timings[label] = dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        log(f"attention: {label}: kernel {ms:.4f} ms (eager {eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; the FLOPs on the f32 "
            f"CUDA cores {f32_ms:.4f} ms)")
    fa.flash_attention.launches = launches  # comparison launches do not count
    t = timings["causal 512"]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:123",
        "launches": launches,
        "path": "repro_torch.kernels.ops.attention",
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_case": errs,
        "row_rel_l2_by_case": row_errs,
        "planted_faults_at_4096": planted,
        "ms": t["ms"],
        "eager_ms": t["eager_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention (yardstick only)",
        "shape": "B=1 Hq=16 Hkv=8 Sq=Sk=512 D=128 bf16 causal",
        "causal_4096": timings["causal 4096"],
        "ptxas": ptxas,
    }


# --------------------------------------------------------------------------
# phase 2f: K6 against its plain version
# --------------------------------------------------------------------------
MLA_SCALE = (128 + 64) ** -0.5  # (qk_nope + qk_rope) ** -0.5


def mla_inputs(dtype, gen, B=8, h=128, lora=512, rope=64, ps=16, max_len=512, edge=False,
               full=False):
    """K6's inputs, by default at the served shape: every page of every
    slot mapped, ``pos`` ragged (``full``: every lane valid); ``edge``
    adds an unmapped page in the middle of a slot, a slot with nothing
    mapped and a row past the pool's end."""
    P = max_len // ps
    N = B * P
    dev = "cuda"

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q_lat, q_rope, ckv, krope = rn(B, h, lora), rn(B, h, rope), rn(N, ps, lora), rn(N, ps, rope)
    pages = torch.randperm(N, generator=gen, device=dev).reshape(B, P).to(torch.int32)
    if full:
        pos = torch.full((B,), max_len - 1, dtype=torch.int32, device=dev)
    else:
        pos = torch.linspace(ps - 1, max_len - 1, B, device=dev).to(torch.int32)
        pos[1] = ps * (P // 2)  # the first lane of a page
    if edge:
        pages[2, P // 2 - 1] = -1  # a hole in the middle of the valid lanes
        pos[2] = max_len - 1
        pages[4, :] = -1  # nothing mapped: the output is 0
        pages[6, 3] = N + 9  # past the pool's end: reads the last row
        pos[7] = -1  # mapped, no valid lane: the mean of its lanes
    return q_lat, q_rope, ckv, krope, pages, pos


def k6_bound(q_lat, q_rope, ckv, pages, pos) -> tuple[float, str, int, float]:
    """Least time for this call's work: q read once, the valid latent and
    RoPE lanes read once, the page table and pos, and the f32 output
    written once, over HBM bandwidth; or the two products over the valid
    lanes, 2 (lora + rope) flops a lane and head for the scores and 2 lora
    for the context, over the tensor-core rate of the input type (the f32
    CUDA-core rate for f32), whichever is larger.  Also the bytes and
    FLOPs counted."""
    from repro_torch.kernels.paged_decode import paged_valid

    B, h, lora = q_lat.shape
    rope = q_rope.shape[-1]
    n_valid = int(paged_valid(pages, pos, ckv.shape[1]).sum())
    item = q_lat.element_size()
    nbytes = (q_lat.numel() + q_rope.numel() + n_valid * (lora + rope)) * item
    nbytes += pages.numel() * 4 + pos.numel() * 4 + B * h * lora * 4
    flops = n_valid * h * (2 * (lora + rope) + 2 * lora)
    rate = BF16_FLOP_PER_S if q_lat.dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes, flops


def sdpa_backend(fn):
    """The first SDPA backend, in torch's order, that accepts ``fn``'s
    call, and a function that runs the call under it."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusing backend says why
                fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def run(be=be):
            with sdpa_kernel([be]):
                return fn()

        return be.name, run
    raise AssertionError("no SDPA backend takes the MLA yardstick")


#: per (slot, head) row: the relative L2 error a sound K6 stays within
#: (its elementwise tolerances); an average over hundreds of lanes is
#: small, so an elementwise check alone could pass a skipped or stale lane
#: tile, which this limit rejects
MLA_ROW_L2 = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
MLA_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}  # atol = rtol


def mla_verdict(got, ref, dtype) -> tuple[bool, float, float, int]:
    """(within both limits, max abs err, worst row's relative L2 error,
    elements over the elementwise limit)."""
    err = (got - ref).abs()
    over = int((err > MLA_TOL[dtype] + MLA_TOL[dtype] * ref.abs()).sum())
    row = float(((got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max())
    return over == 0 and row <= MLA_ROW_L2[dtype], float(err.max()), row, over


def mla_planted_faults(q_lat, q_rope, ckv, krope, pages, pos) -> dict:
    """Outputs of two faults a lane-tile ring could make, computed
    plainly: lane tile 10 (lanes 640-703) skipped, and tile 10 read from
    the stage tile 8 left there (stale)."""
    from repro_torch.kernels import paged_decode as pd

    cd, rd = pd.paged_gather_lanes(ckv, pages), pd.paged_gather_lanes(krope, pages)
    valid = pd.paged_valid(pages, pos, ckv.shape[1])
    skip = valid.clone()
    skip[:, 640:704] = False
    c2, r2 = cd.clone(), rd.clone()
    c2[:, 640:704], r2[:, 640:704] = cd[:, 512:576], rd[:, 512:576]
    return {"lane tile 10 skipped": pd.attend_mla(q_lat, q_rope, cd, rd, skip, MLA_SCALE),
            "lane tile 10 stale (tile 8's stage)": pd.attend_mla(q_lat, q_rope, c2, r2, valid,
                                                                   MLA_SCALE)}


def mla_dense_and_shuffled(dtype, gen, B=8, h=128, lora=512, rope=64, S=512, ps=16):
    """A dense latent cache, its view for K6, and the same values through
    a shuffled page table: (queries, pos, view, pools, pages)."""
    from repro_torch.kernels.paged_decode import dense_mla_view

    P = S // ps
    rn = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(dtype)  # noqa: E731
    ql, qr, ckv, kr = rn(B, h, lora), rn(B, h, rope), rn(B, S, lora), rn(B, S, rope)
    pos = torch.linspace(0, S - 1, B, device="cuda").to(torch.int32)
    pos[1] = 63
    pages = torch.randperm(B * P, generator=gen, device="cuda").reshape(B, P).to(torch.int32)
    pools = []
    for x in (ckv, kr):
        pool = torch.empty((B * P, ps, x.shape[-1]), dtype=dtype, device="cuda")
        pool[pages.long()] = x.reshape(B, P, ps, -1)
        pools.append(pool)
    return (ql, qr), pos, dense_mla_view(ckv, kr), pools, pages


def mla_kernel_phase(build_log: Path) -> dict:
    from repro_torch.kernels import paged_decode as pd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launches0 = pd.paged_mla_attention.launches
    errs, rows = {}, {}

    def held(name, args, dtype):
        got = pd.paged_mla_attention(*args, scale=MLA_SCALE)
        torch.cuda.synchronize()
        ref = pd.paged_mla_plain(*args, scale=MLA_SCALE)
        if got.dtype != torch.float32 or got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"paged_mla_decode {name}: wrong type/shape or not finite")
        ok, err, row, over = mla_verdict(got, ref, dtype)
        errs[name], rows[name] = err, row
        if not ok:
            raise AssertionError(f"paged_mla_decode {name}: max abs err {err}, row L2 {row}, "
                                 f"{over} elements over")
        return got

    # every f32 instance (G = 16 at 512 lanes, 8 at 4096, 2 at 16384; h =
    # 12, 6, 3 give 4, 2, 1) and the bf16 kernel at the wrapper's splits
    cases = [("served 512", {}), ("all lanes valid 512", {"full": True}),
             ("4096", {"max_len": 4096}), ("16384", {"max_len": 16384}),
             ("edge 512", {"edge": True})]
    cases += [(f"h={h} B=3 512", {"h": h, "B": 3}) for h in (12, 6, 3)]
    instances = set()
    for label, kw in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = mla_inputs(dtype, gen, **kw)
            h, S = kw.get("h", 128), kw.get("max_len", 512)
            if dtype == torch.float32:
                inst = f"f32 G={pd.mla_group(h, 512, 64, S, S // 16)}"
            else:
                lanes = pd.mla_split_lanes(kw.get("B", 8), -(-h // pd.MLA_HEADS), S, sms)
                inst = f"bf16 {-(-S // lanes)} splits"
            instances.add(inst)
            got = held(f"{label} {inst}", args, dtype)
            if kw.get("edge") and not bool((got[4] == 0).all()):
                raise AssertionError(f"paged_mla_decode {label} {dtype}: nothing mapped is not 0")
    if not {f"f32 G={g}" for g in (1, 2, 4, 8, 16)} <= instances:
        raise AssertionError(f"paged_mla_decode: not every f32 instance compared: {instances}")
    # the bf16 kernel at every split count it can take at 512 and 4096 lanes
    rule, split_ms = pd.mla_split_lanes, {}
    sweep_sets = [mla_inputs(torch.bfloat16, gen, max_len=4096, full=True),
                  mla_inputs(torch.bfloat16, gen), mla_inputs(torch.bfloat16, gen, edge=True)]
    try:
        for lanes in (64, 128, 256, 512, 1024, 4096):
            pd.mla_split_lanes = lambda *a, lanes=lanes: lanes
            held(f"4096 all valid bf16 {4096 // lanes} splits", sweep_sets[0], torch.bfloat16)
            if lanes <= 512:
                for name, args in (("served 512", sweep_sets[1]), ("edge 512", sweep_sets[2])):
                    held(f"{name} bf16 {512 // lanes} splits", args, torch.bfloat16)
    finally:
        pd.mla_split_lanes = rule
    log("mla: paged_mla_decode (K6) vs paged_mla_plain at B=8 h=128 lora=512 rope=64 ps=16: "
        + ", ".join(f"{k} max_abs_err {errs[k]:.3e} row L2 {rows[k]:.3e}" for k in errs)
        + f" (atol=rtol f32 {MLA_TOL[torch.float32]}, bf16 inputs {MLA_TOL[torch.bfloat16]}; "
        f"row relative L2 f32 {MLA_ROW_L2[torch.float32]}, bf16 {MLA_ROW_L2[torch.bfloat16]})")
    # the row limit must reject the faults a lane-tile ring could make
    planted = {}
    for label, bad in mla_planted_faults(*sweep_sets[0]).items():
        ref = pd.paged_mla_plain(*sweep_sets[0], scale=MLA_SCALE)
        ok, err, row, over = mla_verdict(bad, ref, torch.bfloat16)
        planted[label] = {"max_abs_err": err, "row_rel_l2": row, "elements_over": over}
        log(f"mla: planted fault at 4096 lanes, {label}: max abs err {err:.3e}, row L2 {row:.3e}, "
            f"{over} of {ref.numel()} elements over the elementwise limit: rejected")
        if ok:
            raise AssertionError(f"paged_mla_decode check does not reject the planted fault: {label}")
    # F1: a dense latent cache through its view equals the same values
    # through a shuffled page table, bit for bit
    for dtype in (torch.float32, torch.bfloat16):
        (ql, qr), pos, view, pools, pages = mla_dense_and_shuffled(dtype, gen)
        dense = pd.paged_mla_attention(ql, qr, *view, pos, scale=MLA_SCALE)
        paged = pd.paged_mla_attention(ql, qr, *pools, pages, pos, scale=MLA_SCALE)
        torch.cuda.synchronize()
        if not torch.equal(dense, paged):
            raise AssertionError(f"paged_mla_decode {dtype}: dense view != shuffled pages")
        held(f"dense view {dtype}", (ql, qr, *view, pos), dtype)
    log("mla: paged_mla_decode on a dense (8, 512, 512 / 64) latent cache equals the same values "
        "through a shuffled page table bitwise, f32 and bf16")
    ptxas = ptxas_lines(build_log)
    log(f"mla: ptxas per instance (f32_kernel<G>, bf16_kernel, merge_kernel): {'; '.join(ptxas)}")

    # device times in the serving dtype; enough input sets that the sets
    # together exceed the 50 MB L2, so every call reads its pages from HBM
    timings, backends = {}, {}
    for label, kw, n_sets in (("served 512", {}, 16), ("all lanes valid 512", {"full": True}, 16),
                              ("4096", {"max_len": 4096}, 4), ("16384", {"max_len": 16384}, 2)):
        sets = [mla_inputs(torch.bfloat16, gen, **kw) for _ in range(n_sets)]
        it = iter(range(10**9))

        def nxt():
            return sets[next(it) % len(sets)]

        def sdpa_call():
            q_lat, q_rope, ckv, krope, pages, pos = nxt()
            B, h, _ = q_lat.shape
            kg, rg = pd.paged_gather_lanes(ckv, pages), pd.paged_gather_lanes(krope, pages)
            mask = pd.paged_valid(pages, pos, ckv.shape[1])
            q = torch.cat([q_lat, q_rope], -1)[:, :, None]  # (B, h, 1, 576)
            k = torch.cat([kg, rg], -1)[:, None].expand(B, h, -1, -1)
            v = kg[:, None].expand(B, h, -1, -1)
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=mask[:, None, None], scale=MLA_SCALE)

        heavy = "512" not in label
        ms = graph_ms(lambda: pd.paged_mla_attention(*nxt(), scale=MLA_SCALE),
                      reps=10 if heavy else 20, iters=5 if heavy else 10)
        eager_ms = events_ms(lambda: pd.paged_mla_attention(*nxt(), scale=MLA_SCALE))
        plain_ms = graph_ms(lambda: pd.paged_mla_plain(*nxt(), scale=MLA_SCALE), reps=4, iters=5)
        backend, sdpa_run = sdpa_backend(sdpa_call)
        backends[label] = backend
        library_ms = graph_ms(sdpa_run, reps=4 if heavy else 10, iters=5)
        bound_ms, bound_by, nbytes, flops = k6_bound(*[sets[0][i] for i in (0, 1, 2, 4, 5)])
        timings[label] = dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        if label in ("served 512", "4096"):  # the split rule's evidence: every count, same inputs
            S = kw.get("max_len", 512)
            try:
                for lanes in (64, 128, 256, 512, 1024, 2048):
                    if lanes > S:
                        continue
                    pd.mla_split_lanes = lambda *a, lanes=lanes: lanes
                    split_ms.setdefault(label, {})[S // lanes] = graph_ms(
                        lambda: pd.paged_mla_attention(*nxt(), scale=MLA_SCALE),
                        reps=10 if heavy else 20, iters=5 if heavy else 10)
            finally:
                pd.mla_split_lanes = rule
        log(f"mla: {label} bf16: kernel {ms:.4f} ms (eager {eager_ms:.4f} ms), plain {plain_ms:.4f} "
            f"ms, gather + sdpa ({backend}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)"
            + (f"; by split count (the rule takes {S // rule(8, 2, S, sms)}): "
               + ", ".join(f"{n}: {t:.4f} ms" for n, t in split_ms[label].items())
               if label in split_ms else ""))
    pd.paged_mla_attention.launches = launches0  # comparison launches do not count
    t = timings["served 512"]
    if not t["ms"] < t["library_ms"]:
        raise AssertionError(f"paged_mla_decode bf16 {t['ms']} ms is not faster than gather + "
                             f"sdpa {t['library_ms']} ms at the served shape")
    return {
        "name": "paged_mla_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_mla_decode.cu",
        "replaces": "src/repro/kernels/paged_decode.py:250",
        "launches": None,
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_case": errs,
        "row_rel_l2_by_case": rows,
        "tolerance": {"f32": MLA_TOL[torch.float32], "bf16_inputs": MLA_TOL[torch.bfloat16],
                      "row_rel_l2_f32": MLA_ROW_L2[torch.float32],
                      "row_rel_l2_bf16": MLA_ROW_L2[torch.bfloat16]},
        "planted_faults_at_4096": planted,
        "ms": t["ms"],
        "eager_ms": t["eager_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "library": f"page gather + torch.nn.functional.scaled_dot_product_attention "
                   f"({backends['served 512']}; yardstick only)",
        "shape": "B=8 h=128 lora=512 rope=64 ps=16 max_len=512 bf16, pos ragged",
        "ms_by_splits": split_ms,
        "all_lanes_valid_512": timings["all lanes valid 512"],
        "max_len_4096": timings["4096"],
        "max_len_16384": timings["16384"],
        "ptxas": ptxas,
    }


# --------------------------------------------------------------------------
# phase 3: the main paths, served
# --------------------------------------------------------------------------
POLICIES = ("none", "dmr", "tmr")
#: phase 3b's prompt lengths: one chunk short, ragged, whole chunks (128,
#: 256) and multi-chunk ragged, up to 320 (K8 chunks are 128 steps)
MAMBA_PROMPTS = (16, 320, 128, 77, 256, 300, 129, 190)


def make_requests(vocab: int, n: int = 8, new: int = 32, lengths=None, spec=None,
                  codebooks: int = 1, mix=POLICIES, placement: str = "temporal"):
    """``n`` requests of 8-64 prompt tokens (or ``lengths``), one (P, K)
    row a position for K > 1 codebooks, policies cycling ``mix``
    (replicated ones placed by ``placement``)."""
    from repro_torch.api import RedundancyPolicy
    from repro_torch.serving import Request

    rng = np.random.default_rng(SEED + 1)
    levels = {"none": 1, "dmr": 2, "tmr": 3}
    tail = (codebooks,) if codebooks > 1 else ()
    return [
        Request(
            prompt=rng.integers(0, vocab, size=(int(rng.integers(8, 65)) if lengths is None
                                                else lengths[i], *tail)).astype(np.int32),
            max_new_tokens=new,
            policy=RedundancyPolicy(level=levels[mix[i % len(mix)]],
                                    placement=placement if mix[i % len(mix)] != "none"
                                    else "temporal"),
            spec=spec,
        )
        for i in range(n)
    ]


def drive(engine, reqs, strike: bool):
    """Staggered submission as ``repro.launch.serve`` does it, then a bit
    flip against the second replica slot of the last DMR request (its
    first token; codebook 0 of a multi-codebook model's)."""
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
        if isinstance(dec, list):  # spatial placement: the pods' parts
            dec = dec[0]
        fault = FaultSpec.at(
            step=engine.exe.metrics()["steps"] + 1,
            cell_id=engine.exe.program.cell_id("decoder"),
            leaf=leaf_index(dec, "tokens"),
            index=rec.slots[1] * dec["tokens"][0].numel(),  # (B, 1) or (B, 1, K)
            bit=4,
        )
    engine.pump(faults=fault)
    return victim


def serve_engine(cfg, scfg, tracer=None, mesh=None):
    from repro_torch import api
    from repro_torch.serving.lm import lm_engine_parts

    prog, adapter = lm_engine_parts(cfg, scfg)
    config = api.EngineConfig(tracer=tracer) if mesh is None else api.EngineConfig(
        tracer=tracer, placement="spatial", mesh=mesh)
    engine = api.serve(prog, adapter, config)
    engine.start(SEED)
    return engine


def serve_stream(cfg, scfg, wrappers, lengths=None, *, strike=True, spec=None,
                 tracer=None, mesh=None, mix=POLICIES) -> tuple:
    """Build the engine on the card, warm it up with one request, set the
    ``wrappers``' launch counts to 0, drive the 8-request stream (each
    request asking for ``spec``) with its strike, read the counts, and
    check every request and the strike.  Returns (engine, run record,
    launch counts, each request's tokens)."""
    from repro_torch.serving import DONE, Request

    t0 = time.perf_counter()
    engine = serve_engine(cfg, scfg, tracer, mesh)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(engine._states["weights"]))
    log(f"engine: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} vocab="
        f"{cfg.vocab_size} {cfg.dtype}: {n_params / 1e9:.3f} B params "
        f"(config n_params {cfg.n_params() / 1e9:.3f} B), init "
        f"{time.perf_counter() - t0:.1f} s")
    # warm-up request: CUDA context, cuBLAS handles, the allocator
    prompt = np.arange(8, dtype=np.int32)
    if cfg.n_codebooks > 1:
        prompt = np.repeat(prompt[:, None], cfg.n_codebooks, axis=1)
    warm = Request(prompt=prompt, max_new_tokens=2)
    assert engine.submit(warm)
    engine.pump()
    assert engine.result(warm.id)["status"] == DONE

    reqs = make_requests(cfg.vocab_size, lengths=lengths, spec=spec, codebooks=cfg.n_codebooks,
                         mix=mix, placement="temporal" if mesh is None else "spatial")
    R = engine.registry
    names = ("serving_ticks_total", "serving_replays_total", "serving_spec_verify_ticks_total",
             "serving_spec_tokens_committed_total")
    before = [R[k].value for k in names]
    busy0 = R["serving_tick_seconds"].sum
    first_step = engine.exe.metrics()["steps"]
    torch.cuda.synchronize()
    for w in wrappers:  # counts start here
        w.launches = 0
    t0 = time.perf_counter()
    victim = drive(engine, reqs, strike=strike)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [w.launches for w in wrappers]  # and are read here
    ticks, replays, spec_ticks, spec_tokens = (int(R[k].value - b) for k, b in zip(names, before))
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
    if strike:
        if struck != {victim.id: 1} or m["fault_totals"][victim.id]["events"] != 1.0:
            raise AssertionError(f"strike not detected/attributed once to {victim.id}: {struck}")
        if m["fault_totals"][victim.id]["per_replica"][1] != 1.0 or replays < 1:
            raise AssertionError("strike not localized to replica 1 by a §IV replay")
    elif struck or replays:
        raise AssertionError(f"faults {struck} and {replays} replays in a run without a strike")
    n_tok = sum(len(results[r.id]["tokens"]) for r in reqs)
    ttfts = sorted(results[r.id]["ttft_s"] for r in reqs)
    spec_line = ""
    if spec is not None:
        spec_line = (f"; {spec_ticks} verify walks committed {spec_tokens} tokens "
                     f"({spec_tokens / max(spec_ticks, 1):.3f} a walk, smallest commit "
                     f"{m['spec_min_commit']})")
    log(f"engine: {cfg.name}: {len(reqs)} requests DONE (prompts "
        f"{min(len(r.prompt) for r in reqs)}-{max(len(r.prompt) for r in reqs)} tokens), "
        f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s; TTFT p50 "
        f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms max {ttfts[-1] * 1e3:.1f} ms; {ticks} ticks, "
        f"{busy / ticks * 1e3:.2f} ms/tick; {replays} replay(s)"
        + (f"; strike on {victim.id} detected, attributed, repaired" if strike else "")
        + spec_line)
    run = {
        "requests": len(reqs),
        "tokens_per_s": n_tok / wall,
        "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
        "ttft_max_ms": ttfts[-1] * 1e3,
        "ms_per_tick": busy / ticks * 1e3,
        "ticks": ticks,
        "replays": replays,
        "params_b": n_params / 1e9,
    }
    if spec is not None:
        run.update(spec_ticks=spec_ticks, spec_tokens=spec_tokens,
                   spec_tokens_per_tick=spec_tokens / max(spec_ticks, 1),
                   spec_min_commit=m["spec_min_commit"])
    run["first_step"] = first_step
    run["victim"] = victim.id if strike else None
    return engine, run, launches, [list(results[r.id]["tokens"]) for r in reqs]


def engine_phase() -> tuple[dict, list]:
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models.lm_cells import ServeConfig

    cfg = get_config("internlm2-1.8b")
    scfg = ServeConfig(batch=8, max_len=512, paged=True, page_size=16)
    engine, run, (launches,), tokens = serve_stream(cfg, scfg, [pd.paged_gqa_attention])
    n_sub = max(1, scfg.prefill_chunk)
    expect = cfg.n_layers * (run["ticks"] + run["replays"]) * n_sub
    if launches == 0 or launches != expect:
        raise AssertionError(f"K5 launches {launches} != {cfg.n_layers} x "
                             f"{run['ticks'] + run['replays']} steps")
    m = engine.metrics()
    log(f"engine: paged_gqa_decode launches {launches} = {cfg.n_layers} layers x "
        f"({run['ticks']} ticks + {run['replays']} replays); pages {m['pages_free']}/"
        f"{m['pages_total']} free, {m['page_faults']} page faults")

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
        **run,
        "decode_step_ms": step_ms,
        "fingerprints_ms": fp_ms,
        "pool_copy_ms": copy_ms,
        "pool_copy_gb": 2 * pool_bytes / 1e9,
    }, tokens


def mamba_engine_phase() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.models.lm_cells import ServeConfig

    cfg = get_config("mamba2-2.7b")
    scfg = ServeConfig(batch=8, max_len=512)
    torch.cuda.reset_peak_memory_stats()
    engine, run, (launches,), _ = serve_stream(cfg, scfg, [ks.ssd_scan], lengths=MAMBA_PROMPTS)
    m = engine.metrics()
    if m["paged"] or m["prefill_buckets"] is not None:
        raise AssertionError(f"mamba2 must serve dense and unbucketed: {m['paged']}, "
                             f"{m['prefill_buckets']}")
    prefills = run["requests"]  # each request is prefilled once, at admission
    if launches != cfg.n_layers * prefills:
        raise AssertionError(f"K8 launches {launches} != {cfg.n_layers} layers x {prefills} prefills")
    log(f"engine: ssd_scan launches {launches} = {cfg.n_layers} layers x {prefills} prefills; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # one tick: the decode transition, the slot fingerprints of the
    # replica check, and a copy of the whole slot state (each tick writes
    # the stacked new states, and the slot mask selects over them)
    states = engine._states
    seg = states["decoder"]["cache"]["segments"][0]
    state_bytes = sum(x.numel() * x.element_size() for x in seg.values())
    copy_ms = events_ms(lambda: {k: x.clone() for k, x in seg.items()})
    step_ms = events_ms(lambda: engine.exe.pure_step(states, 0), iters=5)
    fp_ms = events_ms(lambda: engine._ops.fingerprints(states["decoder"]), iters=3)
    # one prefill at the longest prompt: 64 scans of L = 320
    from repro_torch.models import transformer as T

    prompt = torch.zeros((1, MAMBA_PROMPTS[1]), dtype=torch.int64, device="cuda")
    params = states["weights"]["params"]
    prefill_ms = events_ms(lambda: T.forward(cfg, params, prompt, fill_cache=True), iters=3)
    # the same prefill under torch.profiler: how much of it the card is busy
    wall_ms, by_name = profiled(lambda: T.forward(cfg, params, prompt, fill_cache=True))
    if not by_name:
        raise AssertionError("torch.profiler recorded no device time for the prefill")
    busy_ms = sum(by_name.values()) / 1e3
    k8_ms = sum(us for k, us in by_name.items() if re.search(r"chunk_state|state_pass|chunk_out", k)) / 1e3
    ks.ssd_scan.launches = launches  # the prefill timings' launches do not count
    log(f"engine: one prefill of {MAMBA_PROMPTS[1]} tokens under torch.profiler: device busy "
        f"{busy_ms:.2f} ms of the unprofiled {prefill_ms:.2f} ms (idle share "
        f"{1 - busy_ms / prefill_ms:.3f}; {wall_ms:.2f} ms wall under the profiler), K8 "
        f"{k8_ms:.2f} ms, {len(by_name)} kernel names; the largest: " + ", ".join(
            f"{re.sub(r'[(<].*', '', k)[:60]} {us / 1e3:.2f} ms"
            for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]))
    log(f"engine: per tick: decode step {step_ms:.2f} ms, slot fingerprints {fp_ms:.2f} ms, "
        f"state copy {copy_ms:.3f} ms ({2 * state_bytes / 1e9:.3f} GB moved, "
        f"{2 * state_bytes / (copy_ms * 1e-3) / 1e12:.2f} TB/s); one prefill of "
        f"{MAMBA_PROMPTS[1]} tokens {prefill_ms:.2f} ms")
    return {
        "launches": launches,
        "prefills": prefills,
        **run,
        "decode_step_ms": step_ms,
        "fingerprints_ms": fp_ms,
        "state_copy_ms": copy_ms,
        "state_copy_gb": 2 * state_bytes / 1e9,
        "prefill_320_ms": prefill_ms,
        "prefill_320_device_busy_ms": busy_ms,
        "prefill_320_idle_share": 1 - busy_ms / prefill_ms,
        "prefill_320_k8_ms": k8_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def mla_engine_phase() -> tuple[dict, list]:
    from repro_torch.configs import get_config
    from repro_torch.configs.deepseek_v3_671b import dense_prefix
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models.lm_cells import ServeConfig

    cfg = dense_prefix(get_config("deepseek-v3-671b"))
    scfg = ServeConfig(batch=8, max_len=512, paged=True, page_size=16)
    torch.cuda.reset_peak_memory_stats()
    mem_start = torch.cuda.memory_allocated() / 1e9
    engine, run, (k6, k5), tokens = serve_stream(cfg, scfg, [pd.paged_mla_attention,
                                                             pd.paged_gqa_attention])
    m = engine.metrics()
    if not m["paged"]:
        raise AssertionError("deepseek's MLA layers must serve from paged latent pools")
    n_sub = max(1, scfg.prefill_chunk)
    expect = cfg.n_layers * (run["ticks"] + run["replays"]) * n_sub
    if k6 == 0 or k6 != expect or k5 != 0:
        raise AssertionError(f"K6 launches {k6} != {cfg.n_layers} x {run['ticks'] + run['replays']} "
                             f"steps x {n_sub}, or K5 launches {k5} != 0")
    peak = torch.cuda.max_memory_allocated() / 1e9
    held = torch.cuda.memory_allocated() / 1e9
    log(f"engine: paged_mla_decode launches {k6} = {cfg.n_layers} layers x ({run['ticks']} ticks + "
        f"{run['replays']} replays) x {n_sub}; paged_gqa_decode launches {k5}; pages "
        f"{m['pages_free']}/{m['pages_total']} free, {m['page_faults']} page faults; device memory: "
        f"{mem_start:.2f} GB in use before the engine, {held:.2f} GB after the stream, peak {peak:.2f} GB")

    # one tick: the decode transition, the slot fingerprints of the replica
    # check, and the out-of-place copy of the latent pools
    states = engine._states
    seg = states["decoder"]["cache"]["segments"][0]
    pool_bytes = sum(x.numel() * x.element_size() for x in seg.values())
    copy_ms = events_ms(lambda: {k: x.clone() for k, x in seg.items()})
    step_ms = events_ms(lambda: engine.exe.pure_step(states, 0), iters=5)
    fp_ms = events_ms(lambda: engine._ops.fingerprints(states["decoder"]), iters=5)
    pd.paged_mla_attention.launches = k6  # the timing steps' launches do not count
    log(f"engine: per tick: decode step {step_ms:.2f} ms, slot fingerprints {fp_ms:.2f} ms, "
        f"latent pool copy {copy_ms:.3f} ms ({2 * pool_bytes / 1e9:.4f} GB moved)")
    return {
        "launches": k6,
        "paged_gqa_launches": k5,
        **run,
        "decode_step_ms": step_ms,
        "fingerprints_ms": fp_ms,
        "pool_copy_ms": copy_ms,
        "pool_copy_gb": 2 * pool_bytes / 1e9,
        "peak_memory_gb": peak,
        "memory_before_gb": mem_start,
        "memory_after_gb": held,
    }, tokens


# --------------------------------------------------------------------------
# phase 3d: speculative decoding on replica slots, and the engine's trace
# --------------------------------------------------------------------------
TICK_SPLIT = ("dispatch_us", "device_us", "harvest_us")


def load_validate_trace():
    """``tools/validate_trace.py``, loaded by path (it imports only json
    and sys)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / "validate_trace.py"
    spec = importlib.util.spec_from_file_location("validate_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec_stream(label, cfg, spec_cfg, req_spec, wrappers, want, *, strike, tracer=None):
    """One speculating stream of phase 3d: the engine, the run, the launch
    counts; its tokens must equal ``want`` (a plain stream's), bitwise."""
    from repro_torch.models.lm_cells import ServeConfig

    scfg = ServeConfig(batch=8, max_len=512, paged=True, page_size=16, spec=spec_cfg)
    engine, run, launches, tokens = serve_stream(cfg, scfg, wrappers, strike=strike,
                                                 spec=req_spec, tracer=tracer)
    if tokens != want:
        bad = [i for i, (g, w) in enumerate(zip(tokens, want)) if g != w]
        raise AssertionError(f"{label}: tokens of requests {bad} differ from the plain stream's")
    n_sub = max(max(1, scfg.prefill_chunk), spec_cfg.draft_len + 1)
    return engine, run, launches, n_sub


def tick_split(tracer, engine, run) -> dict:
    """The trace of phase 3d (b): valid, one tick span a tick, one verify
    walk span a counted walk, one B/E pair a request, the strike timeline
    on the victim's track; and each tick's dispatch / device / harvest
    split over the stream."""
    evs = tracer.events()
    errors = load_validate_trace().validate_events(evs)
    if errors:
        raise AssertionError(f"trace fails tools/validate_trace.py: {errors[:3]}")
    m = engine.metrics()
    xs = [e for e in evs if e["ph"] == "X"]
    ticks = [e for e in xs if e["name"] == "tick"]
    walks = sum(e["name"] == "verify_walk" for e in xs)
    begins = sum(e["ph"] == "B" and e["name"] == "request" for e in evs)
    ends = sum(e["ph"] == "E" and e["name"] == "request" for e in evs)
    if (len(ticks), walks, begins, ends) != (m["ticks"], m["spec_ticks"], m["submitted"],
                                             m["submitted"]):
        raise AssertionError(
            f"trace spans (tick {len(ticks)}, verify_walk {walks}, request B {begins} / E {ends}) "
            f"!= counters (ticks {m['ticks']}, spec_ticks {m['spec_ticks']}, submitted "
            f"{m['submitted']})")
    vtid = tracer.tid(run["victim"])
    line = [e["name"] for e in evs if e["tid"] == vtid and e["name"].startswith("strike_")]
    if line != ["strike_detected", "strike_attributed", "strike_repaired"]:
        raise AssertionError(f"strike timeline on {run['victim']}: {line}")
    stream = [e["args"] for e in ticks if e["args"]["step"] >= run["first_step"]]
    out = {"ticks_traced": len(stream), "events": len(evs)}
    for k in TICK_SPLIT:
        v = sorted(a[k] for a in stream)
        out[k] = {"median": float(np.median(v)), "min": v[0], "max": v[-1]}
    return out


def spec_phase(plain_tokens: list, mla_tokens: list) -> dict:
    """Phase 3d: phase 3's stream (and 3c's) again, every request asking
    for speculation; the tokens must be the plain streams', bitwise."""
    from repro_torch.api import Tracer
    from repro_torch.configs import get_config
    from repro_torch.configs.deepseek_v3_671b import dense_prefix
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models.lm_cells import SpecConfig

    cfg = get_config("internlm2-1.8b")
    k5 = [pd.paged_gqa_attention]
    out, launches = {}, {"paged_gqa_decode": {}, "paged_mla_decode": {}}

    # (a) self-speculation: the draft is the target's own pass
    spec = SpecConfig(draft_len=4)
    engine, run, (n5,), n_sub = spec_stream("3d (a)", cfg, spec, spec, k5, plain_tokens,
                                            strike=False)
    expect = cfg.n_layers * (run["ticks"] + run["replays"]) * n_sub
    if n5 != expect or not run["spec_tokens_per_tick"] > 1:
        raise AssertionError(f"3d (a): K5 launches {n5} != {expect}, or "
                             f"{run['spec_tokens_per_tick']} tokens a verify walk")
    log(f"spec: (a) self-speculation, draft_len 4: tokens equal phase 3's; K5 launches {n5} = "
        f"{cfg.n_layers} layers x ({run['ticks']} ticks + {run['replays']} replays) x {n_sub}")
    out["self"] = {**run, "k5_launches": n5, "k5_formula": f"{cfg.n_layers} x (ticks + replays) x {n_sub}"}
    launches["paged_gqa_decode"]["spec_3d_self"] = n5
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # (b) a second full-width model as the draft (another seed: real
    # rejections), under a tracer, with a strike in a DMR replica slot
    tracer = Tracer()
    engine, run, (n5,), n_sub = spec_stream(
        "3d (b)", cfg, SpecConfig(draft_len=4, draft_param_seed=SEED + 1), spec, k5,
        plain_tokens, strike=True, tracer=tracer)
    expect = 2 * cfg.n_layers * (run["ticks"] + run["replays"]) * n_sub
    if n5 != expect:
        raise AssertionError(f"3d (b): K5 launches {n5} != 2 x {cfg.n_layers} x "
                             f"({run['ticks']} + {run['replays']}) x {n_sub}")
    split = tick_split(tracer, engine, run)
    log(f"spec: (b) full-width draft (seed {SEED + 1}), draft_len 4: tokens equal phase 3's; "
        f"strike on {run['victim']} detected, attributed to replica 1, repaired by a §IV "
        f"replay; K5 launches {n5} = 2 models x {cfg.n_layers} layers x ({run['ticks']} ticks + "
        f"{run['replays']} replays) x {n_sub} (the draft's dense cache through dense_gqa_view)")
    log("spec: (b) trace valid (tools/validate_trace.py), span counts equal the counters; "
        f"{split['ticks_traced']} stream ticks, per tick (median, min-max): " + "; ".join(
            f"{k} {split[k]['median'] / 1e3:.2f} ms ({split[k]['min'] / 1e3:.2f}-"
            f"{split[k]['max'] / 1e3:.2f})" for k in TICK_SPLIT))
    out["draft"] = {**run, "k5_launches": n5,
                    "k5_formula": f"2 x {cfg.n_layers} x (ticks + replays) x {n_sub}",
                    "tick_split_us": split}
    launches["paged_gqa_decode"]["spec_3d_draft"] = n5
    del engine, tracer
    gc.collect()
    torch.cuda.empty_cache()

    # (c) deepseek-v3's dense prefix, self-speculating: the latent cache
    # rolls back on the card
    cfg = dense_prefix(get_config("deepseek-v3-671b"))
    spec = SpecConfig(draft_len=2)
    engine, run, (n6, n5), n_sub = spec_stream(
        "3d (c)", cfg, spec, spec, [pd.paged_mla_attention, pd.paged_gqa_attention], mla_tokens,
        strike=True)
    expect = cfg.n_layers * (run["ticks"] + run["replays"]) * n_sub
    if n6 != expect or n5 != 0:
        raise AssertionError(f"3d (c): K6 launches {n6} != {expect}, or K5 launches {n5} != 0")
    log(f"spec: (c) {cfg.name} dense prefix, draft_len 2: tokens equal phase 3c's; K6 launches "
        f"{n6} = {cfg.n_layers} layers x ({run['ticks']} ticks + {run['replays']} replays) x "
        f"{n_sub}; K5 launches 0")
    out["deepseek_self"] = {**run, "k6_launches": n6,
                            "k6_formula": f"{cfg.n_layers} x (ticks + replays) x {n_sub}"}
    launches["paged_mla_decode"]["spec_3d_deepseek"] = n6
    out["launches"] = launches
    return out


# --------------------------------------------------------------------------
# phases 3e-3l: granite-20b, command-r-plus, zamba2, MoE, h2o-danube,
# qwen2-vl and musicgen at full width
# --------------------------------------------------------------------------
#: phase 3j's prompts (h2o-danube, window 4096 = max_len): at least three
#: at or past the window (the prefill fills the ring), at least three
#: that the 32 new tokens carry across it (p < 4096 <= p + 30: the decode
#: wraps the ring), one that stays inside
DANUBE_PROMPTS = (4000, 4600, 4070, 4096, 4080, 4200, 4090, 4500)
#: phase 3k's prompts (qwen2-vl): the 256 vision-stub rows and 8-64 text
#: tokens, so no prompt is swallowed by the splice
QWEN_PROMPTS = (264, 320, 279, 296, 273, 311, 287, 268)


def arch_phase(phase: str, cfg, paged: bool, per_step: dict, per_prefill=None, *,
               max_len: int = 512, lengths=None) -> tuple:
    """Phase 3's stream (8 requests, none/DMR/TMR, one strike; prompts of
    8-64 tokens or ``lengths``) on ``cfg`` at full width, then one decode
    step and the slot fingerprints timed.  ``per_step`` / ``per_prefill``:
    {kernel wrapper: its launches a decode step / a prefill}; each count
    of the stream must equal its formula.  The engine is released before
    this returns (record, tokens)."""
    from repro_torch.models.lm_cells import ServeConfig

    scfg = ServeConfig(batch=8, max_len=max_len, paged=paged, page_size=16)
    per_prefill = per_prefill or {}
    wrappers = [*per_step, *per_prefill]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine, run, launches, tokens = serve_stream(cfg, scfg, wrappers, lengths)
    m = engine.metrics()
    if m["paged"] != paged:
        raise AssertionError(f"{phase} {cfg.name}: paged {m['paged']}, expected {paged}")
    steps = run["ticks"] + run["replays"]
    expect = [n * steps for n in per_step.values()] + [n * run["requests"]
                                                        for n in per_prefill.values()]
    formulas = [f"{n} x (ticks + replays)" for n in per_step.values()] + [
        f"{n} x prefills" for n in per_prefill.values()]
    names = [w.__name__ for w in wrappers]
    if launches != expect or not any(launches):
        raise AssertionError(f"{phase} {cfg.name}: launches {dict(zip(names, launches))} != "
                             f"{dict(zip(names, formulas))} = {expect}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    held = torch.cuda.memory_allocated() / 1e9
    states = engine._states
    slot_gb = sum(x.numel() * x.element_size() for x in _leaves(states["decoder"])) / 1e9
    step_ms = events_ms(lambda: engine.exe.pure_step(states, 0), iters=3)
    fp_ms = events_ms(lambda: engine._ops.fingerprints(states["decoder"]), iters=3)
    # is the decode step host or device work: the card's busy time in it
    _, by_name = profiled(lambda: engine.exe.pure_step(states, 0))
    busy_ms = sum(by_name.values()) / 1e3 if by_name else None
    for w, n in zip(wrappers, launches):  # the timing steps' launches do not count
        w.launches = n
    top = {re.sub(r"[(<].*", "", k)[:60]: us / 1e3
           for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:3]}
    busy = ("not measured (no device events)" if busy_ms is None else
            f"device busy {busy_ms:.2f} ms of it (idle share {1 - busy_ms / step_ms:.3f}; the "
            "largest: " + ", ".join(f"{k} {ms:.2f} ms" for k, ms in top.items()) + ")")
    log(f"engine: {phase} {cfg.name}: launches " + ", ".join(
        f"{name} {n} = {f}" for name, n, f in zip(names, launches, formulas))
        + f" ({run['ticks']} ticks, {run['replays']} replays, {run['requests']} prefills); "
        f"device memory peak {peak:.2f} GB, {held:.2f} GB held after the stream; per tick: "
        f"decode step {step_ms:.2f} ms, {busy}; "
        f"slot fingerprints {fp_ms:.2f} ms over {slot_gb:.3f} GB of slot state")
    rec = {**run, "launches": dict(zip(names, launches)),
           "formulas": dict(zip(names, formulas)), "paged": paged, "n_layers": cfg.n_layers,
           "max_len": max_len, "slot_state_gb": slot_gb,
           "decode_step_ms": step_ms, "decode_step_device_busy_ms": busy_ms,
           "decode_step_largest_kernels_ms": top,
           "fingerprints_ms": fp_ms, "peak_memory_gb": peak, "memory_after_gb": held}
    del engine, states
    gc.collect()
    torch.cuda.empty_cache()  # hand the engine's memory back before the next phase
    return rec, tokens


def arch_phases() -> tuple[dict, dict]:
    """Phases 3e-3l, each released before the next: granite-20b (paged,
    K5 at group 48), command-r-plus-104b's first 8 layers (paged, group
    12), zamba2-2.7b (dense: K8 on every mamba layer of a prefill, K5 on
    the shared block's dense cache), granite-moe-1b-a400m (paged, then the
    same stream self-speculating: tokens bitwise equal), deepseek's 3
    dense layers and first MoE layer (paged latent, K6), h2o-danube-3-4b
    (its dense ring of 4096 lanes through K5, prompts of 4000-4600
    tokens), qwen2-vl-7b (dense, group 7, prompts past the 256-row
    splice) and musicgen-large (four codebooks, paged, group 1).  Returns
    the records and the launches by path."""
    from repro_torch.configs import command_r_plus_104b as cr
    from repro_torch.configs import deepseek_v3_671b as ds
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.models.lm_cells import SpecConfig

    k5, k6, k8 = pd.paged_gqa_attention, pd.paged_mla_attention, ks.ssd_scan
    out, paths = {}, {"paged_gqa_decode": {}, "paged_mla_decode": {}, "ssd_scan": {}}

    cfg = get_config("granite-20b")
    out["3e"], _ = arch_phase("3e", cfg, True, {k5: cfg.n_layers, k6: 0})
    paths["paged_gqa_decode"]["engine_3e"] = out["3e"]["launches"]["paged_gqa_attention"]

    cfg = cr.layer_prefix(get_config("command-r-plus-104b"), 8)
    out["3f"], _ = arch_phase("3f", cfg, True, {k5: cfg.n_layers, k6: 0})
    paths["paged_gqa_decode"]["engine_3f"] = out["3f"]["launches"]["paged_gqa_attention"]

    cfg = get_config("zamba2-2.7b")
    units = cfg.n_layers // cfg.shared_attn_every
    out["3g"], _ = arch_phase("3g", cfg, False, {k5: units, k6: 0}, {k8: cfg.n_layers})
    paths["paged_gqa_decode"]["engine_3g"] = out["3g"]["launches"]["paged_gqa_attention"]
    paths["ssd_scan"]["engine_3g"] = out["3g"]["launches"]["ssd_scan"]

    cfg = get_config("granite-moe-1b-a400m")
    out["3h"], tokens = arch_phase("3h", cfg, True, {k5: cfg.n_layers, k6: 0})
    paths["paged_gqa_decode"]["engine_3h"] = out["3h"]["launches"]["paged_gqa_attention"]
    spec = SpecConfig(draft_len=4)
    engine, run, (n5,), n_sub = spec_stream("3h spec", cfg, spec, spec, [k5], tokens,
                                            strike=False)
    expect = cfg.n_layers * (run["ticks"] + run["replays"]) * n_sub
    if n5 != expect or not run["spec_tokens_per_tick"] > 1:
        raise AssertionError(f"3h spec: K5 launches {n5} != {expect}, or "
                             f"{run['spec_tokens_per_tick']} tokens a verify walk")
    log(f"engine: 3h {cfg.name} self-speculating, draft_len 4: tokens bitwise equal to 3h's "
        f"plain stream; K5 launches {n5} = {cfg.n_layers} layers x ({run['ticks']} ticks + "
        f"{run['replays']} replays) x {n_sub}")
    out["3h_spec"] = {**run, "k5_launches": n5,
                      "k5_formula": f"{cfg.n_layers} x (ticks + replays) x {n_sub}"}
    paths["paged_gqa_decode"]["spec_3h_self"] = n5
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    cfg = ds.moe_prefix(get_config("deepseek-v3-671b"), 1)
    out["3i"], _ = arch_phase("3i", cfg, True, {k6: cfg.n_layers, k5: 0})
    paths["paged_mla_decode"]["engine_3i"] = out["3i"]["launches"]["paged_mla_attention"]

    # 3j: the sliding window's dense ring through K5 at the lane bound
    # min(pos, S-1), S = window = max_len = 4096 lanes
    cfg = get_config("h2o-danube-3-4b")
    if not (sum(p >= cfg.window for p in DANUBE_PROMPTS) >= 3
            and sum(p < cfg.window <= p + 30 for p in DANUBE_PROMPTS) >= 3):
        raise AssertionError("3j's prompts must fill the ring and wrap it, three of each")
    out["3j"], _ = arch_phase("3j", cfg, False, {k5: cfg.n_layers, k6: 0}, max_len=cfg.window,
                              lengths=DANUBE_PROMPTS)
    # 3k: M-RoPE and the vision stub's 256 zero rows, dense
    cfg = get_config("qwen2-vl-7b")
    out["3k"], _ = arch_phase("3k", cfg, False, {k5: cfg.n_layers, k6: 0}, lengths=QWEN_PROMPTS)
    # 3l: four codebooks, paged, MHA
    cfg = get_config("musicgen-large")
    out["3l"], _ = arch_phase("3l", cfg, True, {k5: cfg.n_layers, k6: 0})
    for ph in ("3j", "3k", "3l"):
        paths["paged_gqa_decode"][f"engine_{ph}"] = out[ph]["launches"]["paged_gqa_attention"]
    return out, paths


def _leaves(tree):
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


# --------------------------------------------------------------------------
# phase 4: small f32 models agree with a full-sequence forward
# --------------------------------------------------------------------------
def check_phase(arch: str, cfg=None, **serve) -> list:
    """Serve six requests (none / DMR / TMR) on a reduced f32 model; every
    clear token must be the full forward's.  Returns the token streams."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.lm_cells import ServeConfig

    cfg = dataclasses.replace(cfg or get_reduced(arch), dtype="float32")
    engine = serve_engine(cfg, ServeConfig(batch=8, max_len=128, **serve))
    reqs = make_requests(cfg.vocab_size, n=6, new=24, codebooks=cfg.n_codebooks)
    drive(engine, reqs, strike=False)
    params = engine._states["weights"]["params"]
    checked = 0
    for r in reqs:
        res = engine.result(r.id)
        toks = np.asarray(res["tokens"], np.int64)
        seq = torch.tensor(np.concatenate([r.prompt, toks[:-1]]), device="cuda")[None]
        logits, _ = T.forward(cfg, params, seq)
        tail = logits[0, len(r.prompt) - 1 :].float()  # (T, V), or (T, K, V)
        top2 = tail.topk(2, dim=-1)
        pred = top2.indices[..., 0].cpu().numpy()
        gap = (top2.values[..., 0] - top2.values[..., 1]).cpu().numpy()
        clear = gap > 1e-3  # near-ties may flip between decode and prefill order
        if not (pred[clear] == toks[clear]).all():
            raise AssertionError(f"{arch} {r.id}: served tokens disagree with the forward pass")
        checked += int(clear.sum())
    note = ""
    if cfg.moe is not None:
        note = (f" (capacity_factor {cfg.moe.capacity_factor} = n_experts / top_k: no routed "
                "token is dropped, in serving or in the forward)")
    log(f"check: reduced f32 {arch} serving ({'paged' if serve.get('paged') else 'dense'}) "
        f"matches the full forward on {checked} tokens{note}")
    return [np.asarray(engine.result(r.id)["tokens"]).tolist() for r in reqs]


def no_drops(cfg):
    """``cfg`` with the capacity raised so that no routed token is dropped:
    a forward over T tokens at once could drop where a decode step of 8
    tokens cannot, and the check compares the two."""
    moe = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, moe=moe)


def parity_phase(arch: str, kernel, cfg=None) -> dict:
    """F1 on the card: the same requests served from paged pools and from
    the dense cache give EQUAL token streams, and the dense run's decode
    went through ``kernel`` (K5 or K6) too."""
    paged = check_phase(arch, cfg, paged=True, page_size=16)
    kernel.launches = 0
    dense = check_phase(arch, cfg)
    launches = kernel.launches
    if launches == 0:
        raise AssertionError(f"{arch}: dense decode did not launch {kernel.__name__}")
    if paged != dense:
        raise AssertionError(f"{arch}: paged and dense token streams differ")
    log(f"check: {arch} paged and dense token streams equal ({sum(map(len, dense))} tokens, "
        f"none/dmr/tmr); dense decode launched {kernel.__name__} {launches} times")
    return {"tokens": sum(map(len, dense)), "dense_launches": launches}


def ring_phase() -> dict:
    """Reduced f32 h2o-danube (window 32) served dense with prompts of
    8-64 tokens and 24 new: the prefill fills the ring, the decode wraps
    it, and K5 reads it at the lane bound ``min(pos, S-1)``; every clear
    token must be the full windowed forward's."""
    from repro_torch.kernels import paged_decode as pd

    pd.paged_gqa_attention.launches = 0
    tokens = check_phase("h2o-danube-3-4b")
    launches = pd.paged_gqa_attention.launches
    if launches == 0:
        raise AssertionError("h2o-danube: dense decode of the ring did not launch K5")
    log(f"check: h2o-danube-3-4b's ring (window 32) served through paged_gqa_decode "
        f"({launches} launches) across its wraps matches the full forward")
    return {"tokens": sum(map(len, tokens)), "dense_launches": launches}


# --------------------------------------------------------------------------
# phase 5: training (data cell -> trainer cell, AdamW, host §IV, checkpoints)
# --------------------------------------------------------------------------
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_LR, TRAIN_WARMUP = "1e-3", "4"
DMR_LAYERS = 4  # 5b, 5c: the first 4 of 24 layers at full width
DMR_STEPS = 6
DMR_STRIKE = 3
RESUME_STEPS, RESUME_CRASH, RESUME_EVERY = 8, 5, 2


def train_argv(*extra) -> list:
    """The launcher's flags for internlm2-1.8b at full width, batch 4 x 512
    bigram tokens; ``--d-model 2048 --layers N`` (d_ff 4 x 2048 = 8192,
    internlm2's own) cuts the depth alone."""
    return ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--lr", TRAIN_LR, "--warmup", TRAIN_WARMUP, "--device", "cuda", *extra]


def cut_argv(layers: int, *extra) -> list:
    return train_argv("--d-model", "2048", "--layers", str(layers), *extra)


def timed(fn):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def train_breakdown(cfg, tcfg, states) -> dict:
    """One trainer transition cut into its parts, each between CUDA
    events: the data cell's next batch, the forward (loss), the backward
    (``torch.autograd.grad``) and AdamW.  Returns ms per part."""
    from repro_torch.models import lm_cells as lc
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import apply_updates
    from repro_torch.tree import tree_flatten, tree_unflatten

    data = lc.make_data_cell(cfg, tcfg)
    _, data_ms = timed(lambda: data.transition({"data": states["data"]}))
    st = states["trainer"]
    batch = lc._make_batch(cfg, states["data"])
    leaves, treedef = tree_flatten(st["params"])
    xs = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        (loss, _), fwd_ms = timed(lambda: T.loss_fn(cfg, tree_unflatten(treedef, xs), batch))
        gs, bwd_ms = timed(lambda: torch.autograd.grad(loss, xs))
    del loss
    grads = tree_unflatten(treedef, list(gs))
    del gs, xs
    _, opt_ms = timed(lambda: apply_updates(st["params"], grads, st["opt"], tcfg.opt))
    return {"data_ms": data_ms, "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "optimizer_ms": opt_ms}


def train_5a() -> dict:
    """5a: internlm2-1.8b at full width and depth, policy none, host
    back-end, bigram data; ms per step on the device clock, the loss of
    every step, the peak device memory."""
    from repro_torch import api
    from repro_torch.launch import train as L

    args = L.parser().parse_args(train_argv("--steps", str(TRAIN_STEPS)))
    cfg, tcfg, prog = L.build(args)
    exe = api.compile(prog, backend="host", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    states = exe.init(args.seed)
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    losses, ms = [], []
    for t in range(TRAIN_STEPS):
        states, dt = timed(lambda t=t: exe.run(states, 1, start_step=t).states)
        losses.append(float(states["trainer"]["metrics"]["loss"]))
        ms.append(dt)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"5a: losses not finite or not falling: {losses}")
    n_params = sum(x.numel() for x in _leaves(states["trainer"]["params"]))
    parts = train_breakdown(cfg, tcfg, states)
    del states, exe
    med = float(np.median(ms[1:]))
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": n_params, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "ms_per_step_median": med, "ms_per_step": ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (med * 1e-3),
           "peak_gb": peak, "state_gb": state_gb, "losses": losses, "breakdown": parts}
    log(f"train 5a: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model}, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps: median {med:.1f} ms/step "
        f"({rec['tokens_per_s']:.0f} tokens/s), first step {ms[0]:.1f} ms, state "
        f"{state_gb:.2f} GB, peak {peak:.2f} GB; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({', '.join(f'{x:.3f}' for x in losses)}); one step in parts (ms): "
        + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in parts.items()))
    return rec


def host_bits(tree):
    """The tree's leaves on the host (a copy), for a bitwise comparison
    after the device memory is given back."""
    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.detach().cpu(), tree)


def train_5b() -> dict:
    """5b: the first 4 layers at full width under DMR, the launcher's
    strike at step 3: one recovery at (3, trainer), ledger events at step 3
    only, zero on the unstruck run's every step, K4 launched once a
    tie-break, both replicas bitwise equal, and the final state bitwise
    the unstruck run's."""
    from repro_torch import api
    from repro_torch.core import FaultLedger, bit_mismatch_elems
    from repro_torch.kernels import tmr_vote as tv
    from repro_torch.launch import train as L
    from repro_torch.tree import tree_map

    args = L.parser().parse_args(cut_argv(DMR_LAYERS, "--steps", str(DMR_STEPS),
                                          "--redundancy", "dmr"))
    cfg, tcfg, prog = L.build(args)
    runs = {}
    for label, faults in (("clean", []), ("struck", [L.strike(prog, DMR_STRIKE)])):
        events = []
        exe = api.compile(prog, backend="host", device="cuda", ledger=FaultLedger(),
                          on_event=lambda name, attrs: events.append((name, attrs)))
        torch.cuda.reset_peak_memory_stats()
        states = exe.init(args.seed)
        tv.tmr_vote.launches = 0
        states = exe.run(states, DMR_STEPS, start_step=0, faults=faults).states
        torch.cuda.synchronize()
        k4 = tv.tmr_vote.launches
        tr = states["trainer"]
        r0, r1 = tree_map(lambda x: x[0], tr), tree_map(lambda x: x[1], tr)
        if not bits_equal(r0, r1):
            raise AssertionError(f"5b {label}: the two replicas differ after the run")
        if label == "clean":
            # the DMR step in parts: one replica's transition, and the
            # compare the host back-end runs on every step
            _, compare_ms = timed(lambda: bit_mismatch_elems(r0, r1))
            parts = train_breakdown(cfg, tcfg, {"data": states["data"], "trainer": r0})
        step_ms = [a["dur_us"] / 1e3 for n, a in events if n == "step"]
        recov_ms = [a["dur_us"] / 1e3 for n, a in events if n == "dmr_recovery"]
        runs[label] = {"recoveries": list(exe.recoveries), "k4_launches": k4,
                       "events": exe.ledger.totals.get("trainer", {}).get("events", 0.0),
                       "event_steps": list(exe.ledger.recent.get("trainer", [])),
                       "ms_per_step": step_ms, "tiebreak_ms": recov_ms,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "final": host_bits(r0), "loss": float(tr["metrics"]["loss"][0])}
        del states, tr, r0, r1, exe
        gc.collect()
        torch.cuda.empty_cache()
    clean, struck = runs["clean"], runs["struck"]
    if clean["events"] != 0 or clean["recoveries"] or clean["k4_launches"]:
        raise AssertionError(f"5b: the unstruck DMR run saw events {clean['events']} at steps "
                             f"{clean['event_steps']} (the replicas must agree bit for bit)")
    if struck["recoveries"] != [(DMR_STRIKE, "trainer")] or struck["event_steps"] != [DMR_STRIKE]:
        raise AssertionError(f"5b: recoveries {struck['recoveries']}, events at "
                             f"{struck['event_steps']}; want one at step {DMR_STRIKE}")
    if struck["k4_launches"] != len(struck["recoveries"]):
        raise AssertionError(f"5b: K4 launched {struck['k4_launches']} times for "
                             f"{len(struck['recoveries'])} tie-break(s)")
    if not bits_equal(struck.pop("final"), clean.pop("final")):
        raise AssertionError("5b: the repaired final state differs from the unstruck run's")
    clean_ms = [m for i, m in enumerate(struck["ms_per_step"]) if i not in (0, DMR_STRIKE)]
    med = float(np.median(clean["ms_per_step"][1:]))
    log(f"train 5b: {cfg.name} first {DMR_LAYERS} layers at full width, DMR, host, "
        f"{DMR_STEPS} steps: unstruck 0 events; strike at step {DMR_STRIKE} -> recoveries "
        f"{struck['recoveries']}, events at steps {struck['event_steps']}, K4 launches "
        f"{struck['k4_launches']}, replicas bitwise equal, final state bitwise the unstruck "
        f"run's; median {med:.1f} ms/step unstruck, struck step "
        f"{struck['ms_per_step'][DMR_STRIKE]:.1f} ms (tie-break "
        f"{struck['tiebreak_ms'][0]:.1f} ms), peak {struck['peak_gb']:.2f} GB; a replica's "
        f"transition in parts (ms): " + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in parts.items())
        + f"; the replicas' compare {compare_ms:.1f} ms")
    return {"layers": DMR_LAYERS, "steps": DMR_STEPS, "strike_step": DMR_STRIKE,
            "recoveries": struck["recoveries"], "event_steps": struck["event_steps"],
            "k4_launches": struck["k4_launches"], "clean_events": clean["events"],
            "ms_per_step_median": med, "ms_per_step_clean": clean["ms_per_step"],
            "ms_per_step_struck": struck["ms_per_step"], "other_struck_steps_ms": clean_ms,
            "tiebreak_ms": struck["tiebreak_ms"], "peak_gb": struck["peak_gb"],
            "peak_gb_clean": clean["peak_gb"], "loss": struck["loss"],
            "compare_ms": compare_ms, "breakdown": parts}


def train_5c() -> dict:
    """5c: fail-stop.  The 4-layer config, policy none, a checkpoint every
    2 steps, a crash after step 5, restore and resume to step 8 through
    the launcher; the final trainer state bitwise an uninterrupted run's.
    Uniform tokens: the restored data key replays the stream all the
    same, and the bigram walk's time would only add to the checkpoint IO."""
    import shutil
    import tempfile

    from repro_torch.launch import train as L

    base = ("--steps", str(RESUME_STEPS), "--log-every", "1", "--data", "uniform")
    root = Path(tempfile.mkdtemp(prefix="miso_ckpt_"))
    try:
        t0 = time.perf_counter()
        resumed, exe, rows = L.main(cut_argv(DMR_LAYERS, *base, "--ckpt-dir", str(root / "a"),
                                             "--ckpt-every", str(RESUME_EVERY),
                                             "--simulate-failure", str(RESUME_CRASH)))
        resumed_s = time.perf_counter() - t0
        ckpt_gb = sum(f.stat().st_size for f in root.rglob("*.npy")) / 1e9
        got = host_bits(resumed["trainer"])
        del resumed, exe
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        straight, _, rows2 = L.main(cut_argv(DMR_LAYERS, *base))
        straight_s = time.perf_counter() - t0
        if not bits_equal(got, host_bits(straight["trainer"])):
            raise AssertionError("5c: the resumed trainer state differs from the uninterrupted run's")
        del straight
    finally:
        shutil.rmtree(root, ignore_errors=True)
    steps = [r["step"] for r in rows]
    log(f"train 5c: crash after step {RESUME_CRASH}, checkpoints every {RESUME_EVERY} "
        f"({ckpt_gb:.2f} GB written), restored and resumed to step {RESUME_STEPS} (rows at "
        f"{steps}); final trainer state bitwise the uninterrupted run's "
        f"({resumed_s:.1f} s with the crash, {straight_s:.1f} s without)")
    return {"crash_after": RESUME_CRASH, "ckpt_every": RESUME_EVERY, "steps": RESUME_STEPS,
            "row_steps": steps, "ckpt_gb_written": ckpt_gb, "seconds_resumed": resumed_s,
            "seconds_uninterrupted": straight_s}


def train_5d() -> dict:
    """5d: F4's refusal.  The reduced mamba2 trainer on the card raises
    (K8 has no backward), as does K7 on inputs that require grad; under
    no_grad K8 still runs (phase 2d holds it to its plain version)."""
    from repro_torch import api
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.models.lm_cells import TrainConfig, make_train_program

    cfg = get_reduced("mamba2-2.7b")
    tcfg = TrainConfig(data=DataConfig(batch=2, seq_len=32, vocab=cfg.vocab_size, kind="uniform"))
    exe = api.compile(make_train_program(cfg, tcfg), backend="host", device="cuda")
    states = exe.init(0)
    launches = ks.ssd_scan.launches
    try:
        exe.run(states, 1)
    except RuntimeError as e:
        if "K8 has no backward" not in str(e):
            raise
        k8_msg = str(e)
    else:
        raise AssertionError("5d: training mamba2 on the card did not refuse")
    if ks.ssd_scan.launches != launches:
        raise AssertionError("5d: the refused scan was launched")
    q = torch.randn(1, 2, 64, 64, device="cuda", requires_grad=True)
    try:
        fa.flash_attention(q, q, q)
    except RuntimeError as e:
        if "K7 has no backward" not in str(e):
            raise
        k7_msg = str(e)
    else:
        raise AssertionError("5d: K7 on inputs that require grad did not refuse")
    n = fa.flash_attention.launches
    with torch.no_grad():
        y = fa.flash_attention(q, q, q)
    fa.flash_attention.launches = n  # a check, not the main path
    log(f"train 5d: reduced mamba2 training on the card refuses ({k8_msg.split(';')[0]}); "
        f"K7 with grad refuses ({k7_msg.split(';')[0]}); under no_grad K7 runs "
        f"({tuple(y.shape)})")
    return {"k8": k8_msg, "k7": k7_msg}


def train_parity_4t() -> dict:
    """4t: reduced f32 internlm2, 3 train steps on the card against the
    port on the CPU from the same state: batches bitwise, losses within
    1e-4 relative, params within TRAIN_PARAM_TOL of the CPU's."""
    from repro_torch import api, prng
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import DataConfig, sample_batch
    from repro_torch.models.lm_cells import TrainConfig, make_train_program
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_reduced(TRAIN_ARCH), dtype="float32")
    tcfg = TrainConfig(data=DataConfig(batch=2, seq_len=32, vocab=cfg.vocab_size),
                       opt=OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10))
    prog = make_train_program(cfg, tcfg)
    cpu = api.compile(prog, backend="host", device="cpu")
    card = api.compile(prog, backend="host", device="cuda")
    s_cpu = cpu.init(0)
    s_card = tree_map(lambda x: x.to("cuda"), s_cpu)
    worst_loss, worst_param = 0.0, 0.0
    for t in range(3):
        s_cpu = cpu.run(s_cpu, 1, start_step=t).states
        s_card = card.run(s_card, 1, start_step=t).states
        if not torch.equal(s_cpu["data"]["tokens"], s_card["data"]["tokens"].cpu()):
            raise AssertionError(f"4t: step {t}: the card's batch differs from the CPU's")
        a, b = float(s_cpu["trainer"]["metrics"]["loss"]), float(s_card["trainer"]["metrics"]["loss"])
        worst_loss = max(worst_loss, abs(a - b) / abs(a))
    for x, y in zip(tree_leaves(s_cpu["trainer"]["params"]), tree_leaves(s_card["trainer"]["params"])):
        worst_param = max(worst_param, float((x - y.cpu()).abs().max() / x.abs().max()))
    # the full vocabulary's bigram walk (5a's shapes), a few steps: the
    # card's compiled walk against the CPU's eager one
    full = DataConfig(batch=TRAIN_BATCH, seq_len=16, vocab=92544)
    key = prng.fold_in(prng.PRNGKey(0), 1)
    if not torch.equal(sample_batch(full, key), sample_batch(full, key.to("cuda")).cpu()):
        raise AssertionError("4t: the full-vocabulary bigram batch differs between card and CPU")
    if worst_loss > 1e-4 or worst_param > TRAIN_PARAM_TOL:
        raise AssertionError(f"4t: loss rel {worst_loss:.2e} (limit 1e-4), params {worst_param:.2e} "
                             f"(limit {TRAIN_PARAM_TOL})")
    log(f"check 4t: reduced f32 {TRAIN_ARCH}, 3 train steps card vs CPU: batches bitwise, "
        f"loss within {worst_loss:.2e} rel (limit 1e-4), params within {worst_param:.2e} of each "
        f"leaf's largest (limit {TRAIN_PARAM_TOL}); a full-vocabulary (92544) bigram batch of "
        f"{TRAIN_BATCH} x 16 bitwise the CPU's")
    return {"loss_rel": worst_loss, "param_rel": worst_param}


#: params after a few AdamW steps, relative to each leaf's largest element:
#: Adam divides by sqrt(v), so a gradient of a few ulps' difference near
#: zero moves its element by up to the learning rate (1e-2 here)
TRAIN_PARAM_TOL = 5e-3


def train_phase() -> dict:
    out = {"5a": train_5a()}
    gc.collect()
    torch.cuda.empty_cache()
    out["5b"] = train_5b()
    gc.collect()
    torch.cuda.empty_cache()
    out["5c"] = train_5c()
    gc.collect()
    torch.cuda.empty_cache()
    out["5d"] = train_5d()
    out["4t"] = train_parity_4t()
    return out


# --------------------------------------------------------------------------
# phase 6: the launchers and the examples, through the entry points a
# user calls
# --------------------------------------------------------------------------
LAUNCH_ARCH = "internlm2-1.8b"
LAUNCH_6A = ["--arch", LAUNCH_ARCH, "--paged", "--slots", "8", "--requests", "8", "--mix",
             "none,dmr,tmr", "--decode", "32", "--prompt-len", "64", "--max-len", "512",
             "--strike", "--device", "cuda"]
LAUNCH_SPEC_K = 2
STATIC_RUN = ["--static", "--batch", "4", "--prompt-len", "12", "--decode", "24", "--device",
              "cuda"]
STATIC_STEPS = 24
STATIC_STRIKE = dict(step=12, replica=1, index=5 * 128 + 7, bit=14)  # K lane 5, dim 7, bf16 exponent
EXAMPLES = Path(__file__).resolve().parent / "examples"


def launch_engine(label: str, extra: list) -> tuple[dict, list]:
    """``launch.serve.main`` on the engine path (6a's flags plus
    ``extra``), K5's count set to 0 just before and read just after; a
    tracer and a metrics snapshot written to a temporary directory.  The
    launcher itself exits non-zero unless every request is DONE and the
    strike is detected, attributed to its request and repaired on its
    trace track.  Returns (record, each request's tokens)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.launch import serve as S
    from repro_torch.serving import DONE

    with tempfile.TemporaryDirectory() as tmp:
        trace, metrics = f"{tmp}/trace.json", f"{tmp}/metrics.json"
        torch.cuda.synchronize()
        pd.paged_gqa_attention.launches = 0  # counts start here
        t0 = time.perf_counter()
        engine = S.main(LAUNCH_6A + extra + ["--trace-out", trace, "--metrics-json", metrics])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = pd.paged_gqa_attention.launches  # and are read here
        snap = json.loads(Path(metrics).read_text())
        n_events = len(json.loads(Path(trace).read_text())["traceEvents"])
    m = engine.metrics()
    reqs = list(engine.requests.values())
    victim = [r for r in reqs if r.req.policy.level == 2][-1].id
    if m["request_faults"] != {victim: 1} or snap["serving_strikes_detected_total"]["value"] != 1:
        raise AssertionError(f"{label}: strike not attributed once to {victim}: "
                             f"{m['request_faults']}")
    if any(r.status != DONE or len(r.tokens) != 32 for r in reqs):
        raise AssertionError(f"{label}: not every request DONE with 32 tokens")
    n_sub = LAUNCH_SPEC_K + 1 if "--spec-k" in extra else 1
    layers = get_config(LAUNCH_ARCH).n_layers
    expect = layers * (m["ticks"] + m["replays"]) * n_sub
    if launches != expect:
        raise AssertionError(f"{label}: K5 launches {launches} != {layers} x ({m['ticks']} "
                             f"ticks + {m['replays']} replays) x {n_sub}")
    rec = {"tokens_per_s": m["tokens_per_s"], "ttft_p50_ms": m["ttft_p50_s"] * 1e3,
           "ttft_p99_ms": m["ttft_p99_s"] * 1e3, "ms_per_tick": m["busy_s"] / m["ticks"] * 1e3,
           "ticks": m["ticks"], "replays": m["replays"], "tokens": m["tokens_out"],
           "victim": victim, "k5_launches": launches, "trace_events": n_events,
           "command_s": seconds}
    if n_sub > 1:
        rec["spec_tokens_per_tick"] = m["spec_tokens_per_tick"]
    log(f"launch {label}: {LAUNCH_ARCH} paged, {len(reqs)} requests DONE, {m['tokens_out']} "
        f"tokens, {rec['tokens_per_s']:.1f} tok/s (traced), TTFT p50 {rec['ttft_p50_ms']:.1f} ms "
        f"p99 {rec['ttft_p99_ms']:.1f} ms, {m['ticks']} ticks at {rec['ms_per_tick']:.2f} "
        f"ms/tick, {m['replays']} replay(s); strike on {victim} repaired; K5 launches "
        f"{launches} = {layers} x ({m['ticks']} + {m['replays']}) x {n_sub}; {n_events} trace "
        f"events" + (f"; {rec['spec_tokens_per_tick']:.3f} tokens a verify tick"
                     if n_sub > 1 else "") + f"; {seconds:.1f} s with init")
    tokens = [list(r.token_ids()) for r in reqs]
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return rec, tokens


def launch_static(arch: str, redundancy: str, wrappers, *, backend="lockstep",
                  faults=None) -> tuple[dict, list, np.ndarray]:
    """``launch.serve.static_main`` at full width, the ``wrappers``'
    counts set to 0 just before and read just after.  Returns (record,
    launch counts, collected tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S

    args = S.parser().parse_args(STATIC_RUN + ["--arch", arch, "--redundancy", redundancy])
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    out = S.static_main(get_config(arch), args, backend=backend, faults=faults)
    torch.cuda.synchronize()
    launches = [w.launches for w in wrappers]
    events = float(out["reports"]["decoder"]["events"]) if redundancy != "none" else 0.0
    rec = {"arch": arch, "redundancy": redundancy, "backend": backend,
           "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
           "tokens_per_s": STATIC_STEPS * args.batch / out["decode_s"], "events": events}
    toks = out["tokens"]
    if toks.shape[:2] != (STATIC_STEPS, args.batch) or toks.min() < 0:
        raise AssertionError(f"static {arch}: tokens {toks.shape}, min {toks.min()}")
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches, toks


def launch_6c() -> dict:
    """6c: the static path at full width: internlm2 under none and TMR
    (tokens bitwise equal, 0 events), the TMR program on ``lockstep_cuda``
    with a bit flip into a decoder replica's cache (voted away by K2:
    tokens bitwise, one event, K2 = decode steps), mamba2 under DMR (0
    events, K8 = 64 layers at the prefill)."""
    from repro_torch.api import FaultSpec
    from repro_torch.configs import get_config
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.models.lm_cells import ServeConfig, make_serve_program
    from repro_torch.tree import leaf_index

    k5 = pd.paged_gqa_attention
    layers = get_config(LAUNCH_ARCH).n_layers
    k5_total = 0
    none, (n5,), base = launch_static(LAUNCH_ARCH, "none", [k5])
    tmr, (t5,), voted = launch_static(LAUNCH_ARCH, "tmr", [k5])
    if not np.array_equal(base, voted) or tmr["events"] != 0:
        raise AssertionError(f"6c: TMR tokens differ from the unreplicated run's or events "
                             f"{tmr['events']}")
    spec = make_serve_program(get_config(LAUNCH_ARCH), ServeConfig(batch=4, max_len=128))
    leaf = leaf_index(spec.state_specs()["decoder"], "k")
    strike = FaultSpec.at(cell_id=1, leaf=leaf, **STATIC_STRIKE)
    struck, (s5, k2), hit = launch_static(LAUNCH_ARCH, "tmr", [k5, fs.tmr_step],
                                          backend="lockstep_cuda", faults=strike)
    if not np.array_equal(base, hit) or struck["events"] != 1 or k2 != STATIC_STEPS:
        raise AssertionError(f"6c: struck lockstep_cuda TMR: tokens equal "
                             f"{np.array_equal(base, hit)}, events {struck['events']}, K2 "
                             f"launches {k2} (want 1 event and {STATIC_STEPS})")
    for label, n, level in (("none", n5, 1), ("tmr", t5, 3), ("tmr_cuda_struck", s5, 3)):
        if n != layers * STATIC_STEPS * level:
            raise AssertionError(f"6c {label}: K5 launches {n} != {layers} x {STATIC_STEPS} x "
                                 f"{level}")
        k5_total += n
    mamba, (k8,), _ = launch_static("mamba2-2.7b", "dmr", [ks.ssd_scan])
    n_mamba = get_config("mamba2-2.7b").n_layers
    if mamba["events"] != 0 or k8 != n_mamba:
        raise AssertionError(f"6c mamba2: events {mamba['events']}, K8 launches {k8} != "
                             f"{n_mamba}")
    runs = {"internlm2_none": none, "internlm2_tmr": tmr, "internlm2_tmr_cuda_struck": struck,
            "mamba2_dmr": mamba}
    for label, r in runs.items():
        log(f"launch 6c: {label}: prefill 12 tok x4 {r['prefill_s'] * 1e3:.1f} ms, decode "
            f"{STATIC_STEPS} steps {r['decode_s']:.3f} s = {r['tokens_per_s']:.1f} tok/s, "
            f"events {r['events']:.0f}")
    log(f"launch 6c: internlm2 TMR tokens bitwise the unreplicated run's; the strike into "
        f"replica 1's cache at step {STATIC_STRIKE['step']} voted away by K2 ({k2} launches, "
        f"1 event, tokens bitwise); K5 {n5} + {t5} + {s5} = {layers} x {STATIC_STEPS} x "
        f"(1 + 3 + 3); mamba2 DMR 0 events, K8 {k8}")
    return {"runs": runs, "k5_launches": k5_total, "k2_launches": k2, "k8_launches": k8}


def launch_6d() -> dict:
    """6d: ``validate`` on the full-width internlm2 train program (5a's
    config), 6a's paged slot serve program and 6c's static TMR program:
    no exception, and the card's peak memory where it was."""
    from repro_torch.api import RedundancyPolicy
    from repro_torch.configs import get_config
    from repro_torch.launch import train as L
    from repro_torch.models.lm_cells import (
        ServeConfig,
        make_serve_program,
        make_slot_serve_program,
    )

    cfg = get_config(LAUNCH_ARCH)
    progs = {
        "train": L.build(L.parser().parse_args(train_argv("--steps", str(TRAIN_STEPS))))[2],
        "serve_paged": make_slot_serve_program(
            cfg, ServeConfig(batch=8, max_len=512, paged=True, page_size=16)),
        "static_tmr": make_serve_program(cfg, ServeConfig(batch=4, max_len=128)).with_policies(
            {"decoder": RedundancyPolicy(level=3)}),
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.max_memory_allocated()
    seconds = {}
    for name, prog in progs.items():
        t0 = time.perf_counter()
        prog.validate()
        seconds[name] = time.perf_counter() - t0
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - before
    if growth >= 1 << 20:
        raise AssertionError(f"6d: validate took {growth} B of device memory")
    log(f"launch 6d: validate at full width: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in seconds.items()) + f"; peak device memory grew {growth} B")
    return {"seconds": seconds, "peak_growth_bytes": growth}


def load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_6e() -> dict:
    """6e: the four examples on the card at their own defaults, their own
    asserts passing; K2, K4 and K5 counted from 0 over them."""
    from repro_torch.kernels import fused_step as fs
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import tmr_vote as tv

    wrappers = {"tmr_step": fs.tmr_step, "tmr_vote": tv.tmr_vote,
                "paged_gqa_decode": pd.paged_gqa_attention}
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    seconds = {}
    runs = (("quickstart_torch", ["--backend", "lockstep"]),
            ("quickstart_torch", ["--backend", "lockstep_cuda"]),
            ("image_blend_torch", []), ("serve_lm_torch", ["--strike"]),
            ("serve_walkthrough_torch", ["--smoke"]))
    for name, argv in runs:
        t0 = time.perf_counter()
        load_example(name).main(argv)
        torch.cuda.synchronize()
        seconds[f"{name} {' '.join(argv)}".strip()] = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"6e: a kernel of the examples' paths never launched: {launches}")
    log(f"launch 6e: the four examples passed on the card (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items()) + f"); launches {launches}")
    return {"seconds": seconds, "launches": launches}


def launch_phase() -> dict:
    t0 = time.perf_counter()
    out = {}
    out["6a"], plain = launch_engine("6a", [])
    out["6b"], spec = launch_engine("6b", ["--spec-k", str(LAUNCH_SPEC_K)])
    if spec != plain:
        raise AssertionError("6b: speculating tokens differ from 6a's")
    log("launch 6b: every request's tokens bitwise 6a's")
    out["6c"] = launch_6c()
    out["6d"] = launch_6d()
    out["6e"] = launch_6e()
    out["seconds"] = time.perf_counter() - t0
    log(f"launch: phase 6 took {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 7: the static analyzer (repro_torch.analysis) -- the CI lane, the
# full-width programs of the phases above, and MISO002's promise replayed
# through K1/K2
# --------------------------------------------------------------------------
ROOT = Path(__file__).resolve().parent
ANALYSIS_STEPS = 16
ANALYSIS_STRIKE = 8
ANALYSIS_SEEDS = range(1000, 1030)  # tests/test_torch_analysis_random.py's deletion seeds
ACCUM_STEPS = 32
ACCUM_N = 1 << 24  # 7d: one f32 row of 16 M values, every one added into index 0


def analysis_7a() -> dict:
    """7a: the CI lane, ``python -m repro_torch.analysis --all --json
    --fail-on warning --dag-out DIR``, then ``tools/validate_dag.py`` over
    every export, each a subprocess that must exit 0."""
    import os
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--all", "--json", "--fail-on",
             "warning", "--dag-out", tmp], capture_output=True, text=True, timeout=600, env=env,
            cwd=str(ROOT))
        lane_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"7a: the analyzer exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        doc = json.loads(proc.stdout)
        exports = sorted(Path(tmp).glob("*.json"))
        t0 = time.perf_counter()
        check = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "validate_dag.py"), *map(str, exports)],
            capture_output=True, text=True, timeout=120, cwd=str(ROOT))
        validate_s = time.perf_counter() - t0
    if check.returncode != 0:
        raise AssertionError(f"7a: validate_dag.py exited {check.returncode}: "
                             f"{check.stdout[-2000:]}")
    summary = doc["summary"]
    if summary["n_programs"] != 23 or len(exports) != 23 or summary["failed"]:
        raise AssertionError(f"7a: {summary}, {len(exports)} exports")
    codes = sorted({d["code"] for p in doc["programs"] for d in p["diagnostics"]})
    log(f"analysis 7a: --all --json --fail-on warning: exit 0, {summary['n_programs']} programs, "
        f"counts {summary['counts']}, codes {codes}, {lane_s:.1f} s; validate_dag.py over "
        f"{len(exports)} exports: exit 0, {validate_s:.1f} s")
    return {"seconds": lane_s, "validate_s": validate_s, "n_programs": summary["n_programs"],
            "counts": summary["counts"], "codes": codes}


def codes_by_cell(result) -> dict:
    out = {}
    for d in result.diagnostics:
        out.setdefault(d.cell, []).append(d.code)
    return out


def analysis_7b() -> dict:
    """7b: the full-width programs the phases above run on the card,
    analysed on fake CPU tensors: seconds, codes, and the card's peak
    memory growth (under 1 MB, as 6d).  No error on a program an earlier
    phase ran under DMR/TMR with zero events on clean steps, and the
    codes of each cell those of the reduced CPU program of its family."""
    from repro_torch import api
    from repro_torch.analysis import analyze_program, registry
    from repro_torch.configs import get_config
    from repro_torch.launch import train as L
    from repro_torch.models.lm_cells import ServeConfig, make_slot_serve_program

    dmr, tmr = api.RedundancyPolicy(level=2), api.RedundancyPolicy(level=3)
    paged = ServeConfig(batch=8, max_len=512, paged=True, page_size=16)

    def serve(arch, scfg):
        return lambda: make_slot_serve_program(get_config(arch), scfg)

    def listing1():
        from repro_torch.core.ir import LISTING_1

        return api.compile_source(LISTING_1.replace("300*200", f"{W4K}*{H4K}"))

    # (label, build, policies, reduced registry twin, ran under DMR/TMR on the card)
    cases = [
        ("internlm2-1.8b serve paged, decoder DMR", serve("internlm2-1.8b", paged),
         {"decoder": dmr}, "serve-paged:gqa"),
        ("internlm2-1.8b serve paged, decoder TMR", serve("internlm2-1.8b", paged),
         {"decoder": tmr}, "serve-paged:gqa"),
        ("granite-moe-1b-a400m serve paged, decoder DMR", serve("granite-moe-1b-a400m", paged),
         {"decoder": dmr}, "serve-paged:moe"),
        ("mamba2-2.7b serve", serve("mamba2-2.7b", ServeConfig(batch=8, max_len=512)), {},
         "serve:mamba"),
        ("5b trainer (4 layers, DMR)",
         lambda: L.build(L.parser().parse_args(cut_argv(DMR_LAYERS, "--redundancy", "dmr")))[2],
         {}, "train:gqa"),
        ("Listing 1 3840x2160, image1 TMR", listing1, {"image1": tmr}, "ir:listing1"),
    ]
    twin_policy = {"5b trainer (4 layers, DMR)": {"trainer": dmr}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.max_memory_allocated()
    out = {}
    for label, build, policies, twin in cases:
        t0 = time.perf_counter()
        prog = build()
        if policies:
            prog = prog.with_policies(policies)
        result = analyze_program(prog, name=label)
        seconds = time.perf_counter() - t0
        small = registry()[twin].build().with_policies(twin_policy.get(label, policies))
        reduced = analyze_program(small, name=twin)
        codes, want = codes_by_cell(result), codes_by_cell(reduced)
        errors = [d.code for d in result.diagnostics if d.severity == "error"]
        leaves = sum(len(o) for o in (a.out_leaves for a in result.accesses.values()))
        nodes = sum(len(a.graph.graph.nodes) for a in result.accesses.values())
        log(f"analysis 7b: {label}: {seconds:.2f} s, {nodes} graph nodes, {leaves} output "
            f"leaves, codes {codes} (reduced {twin}: {want})")
        if errors:
            raise AssertionError(f"7b {label}: error diagnostics {errors}")
        if codes != want:
            raise AssertionError(f"7b {label}: codes {codes} != reduced {twin}'s {want}")
        if result.dag is None:
            raise AssertionError(f"7b {label}: no DAG")
        out[label] = {"seconds": seconds, "codes": codes, "graph_nodes": nodes}
        del prog, result
        gc.collect()
    torch.cuda.synchronize()
    growth = torch.cuda.max_memory_allocated() - before
    if growth >= 1 << 20:
        raise AssertionError(f"7b: the analysis took {growth} B of device memory")
    log(f"analysis 7b: peak device memory grew {growth} B over the six analyses")
    return {"programs": out, "peak_growth_bytes": growth}


def rand_program(seed):
    """tests/test_torch_analysis_random.py's (and tests/test_analysis.py's)
    random program: 2-6 cells, declared reads a superset of the consumed
    ones, drawn from ``random.Random(seed)`` in the same order."""
    import random

    from repro_torch import api

    def transition_of(name, used, rng):
        coeffs = {d: rng.uniform(0.1, 0.9) for d in used}

        def transition(prev):
            out = prev[name]["x"] * 0.5 + prev[name]["y"].sum()
            for d, c in coeffs.items():
                out = out + c * torch.tanh(prev[d]["x"])
            return {"x": out, "y": prev[name]["y"] * 0.9}

        return transition

    rng = random.Random(seed)
    names = [f"c{i}" for i in range(rng.randint(2, 6))]
    prog = api.MisoProgram()
    for i, name in enumerate(names):
        declared = tuple(m for m in names[:i] if rng.random() < 0.6)
        used = tuple(m for m in declared if rng.random() < 0.6)
        prog.add(api.CellType(
            name, lambda g, d: {"x": torch.randn(3, generator=g, device=d),
                                "y": torch.ones(2, device=d)},
            transition_of(name, used, rng), reads=declared))
    return prog


def without_dead_reads(prog):
    """``prog`` with every read the analyzer calls dead dropped, and the
    dead reads."""
    from repro_torch import api
    from repro_torch.analysis import trace_cell

    specs = prog.state_specs()
    dead = {name: trace_cell(cell, specs).dead_reads for name, cell in prog.cells.items()}
    pruned = api.MisoProgram()
    for name, cell in prog.cells.items():
        pruned.add(dataclasses.replace(cell, reads=tuple(r for r in cell.reads
                                                          if r not in dead[name])))
    return pruned, {k: v for k, v in dead.items() if v}


def replay_pair(prog, pruned, level: int, fault) -> tuple[dict, int]:
    """Both programs ``ANALYSIS_STEPS`` steps on ``lockstep_cuda`` with
    every cell at ``level`` and the same strike: states bitwise, the same
    ledger and recoveries.  Returns (events, kernel launches)."""
    from repro_torch import api
    from repro_torch.kernels import fused_step as fs

    name, w = ("K1", fs.dmr_compare) if level == 2 else ("K2", fs.tmr_step)
    runs = []
    for p in (prog, pruned):
        policies = {c: api.RedundancyPolicy(level=level) for c in p.cells}
        exe = api.compile(p, backend="lockstep_cuda", policies=policies)
        states = exe.init(SEED)
        torch.cuda.synchronize()
        k0 = w.launches
        res = exe.run(states, ANALYSIS_STEPS, faults=fault)
        torch.cuda.synchronize()
        runs.append((res.states, exe.ledger.totals, exe.ledger.recent, exe.recoveries,
                     w.launches - k0))
    (a, ta, ra, reca, ka), (b, tb, rb, recb, kb) = runs
    if not bits_equal(a, b):
        raise AssertionError("7c: the states differ with and without the dead reads")
    if (ta, ra, reca) != (tb, rb, recb):
        raise AssertionError(f"7c: events differ: {ra} / {rb}")
    want = ANALYSIS_STEPS * len(prog.cells)
    if ka != want or kb != want:
        raise AssertionError(f"7c: {name} launches {ka}, {kb} != {ANALYSIS_STEPS} steps x "
                             f"{len(prog.cells)} cells")
    return ra, ka + kb


def analysis_7c() -> dict:
    """7c: MISO002's promise on the card.  The random programs of the
    parity test that have dead reads, and Listing 1 at 4K with one
    planted declared-but-unused read (image2 declares image1): every read
    the analyzer calls dead dropped, both versions 16 steps under DMR and
    TMR on ``lockstep_cuda`` with a bit flip at step 8; states bitwise,
    the same events, K1/K2 launches = compared steps x cells."""
    from repro_torch import api
    from repro_torch.kernels import fused_step as fs

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    fs.dmr_compare.launches = fs.tmr_step.launches = 0  # counts start here
    progs = {}
    for seed in ANALYSIS_SEEDS:
        prog = rand_program(seed)
        pruned, dead = without_dead_reads(prog)
        if dead:
            progs[f"random {seed}"] = (prog, pruned, dead, len(prog.cells) - 1, 0, 1, 22)
    l1 = listing1_4k()
    planted = api.MisoProgram()
    for name, cell in l1.cells.items():
        planted.add(dataclasses.replace(cell, reads=cell.reads + (("image1",) if name == "image2"
                                                                  else ())))
    pruned, dead = without_dead_reads(planted)
    if dead != {"image2": ("image1",)} or {n: c.reads for n, c in pruned.cells.items()} != {
            n: c.reads for n, c in l1.cells.items()}:
        raise AssertionError(f"7c: Listing 1's planted read not found dead: {dead}")
    progs["Listing 1 4K, planted"] = (planted, pruned, dead, 0, 2, (H4K // 2) * W4K, 30)
    out, k = {}, {2: 0, 3: 0}
    for label, (prog, pruned, dead, cell_id, leaf, index, bit) in progs.items():
        fault = api.FaultSpec.at(step=ANALYSIS_STRIKE, cell_id=cell_id, replica=1, leaf=leaf,
                                 index=index, bit=bit)
        events = {}
        for level in (2, 3):
            events[level], n = replay_pair(prog, pruned, level, fault)
            k[level] += n
        struck = prog.cells[list(prog.cells)[cell_id]].name
        if events[3] != {struck: [ANALYSIS_STRIKE]} or events[2].get(struck, [])[:1] != [
                ANALYSIS_STRIKE]:
            raise AssertionError(f"7c {label}: events DMR {events[2]}, TMR {events[3]}")
        out[label] = {"dead": {c: list(r) for c, r in dead.items()}}
    torch.cuda.synchronize()
    launches = {"dmr_compare": fs.dmr_compare.launches, "tmr_step": fs.tmr_step.launches}
    if launches != {"dmr_compare": k[2], "tmr_step": k[3]}:
        raise AssertionError(f"7c: launches {launches} != compared steps {k}")
    seconds = time.perf_counter() - t0
    n_dead = sum(len(r) for v in out.values() for r in v["dead"].values())
    log(f"analysis 7c: {len(out)} programs ({len(out) - 1} random seeds of "
        f"{len(ANALYSIS_SEEDS)} with dead reads, and Listing 1 at 4K with its planted read), "
        f"{n_dead} dead reads dropped; with and without them {ANALYSIS_STEPS} steps of DMR and "
        f"TMR on lockstep_cuda, a flip at step {ANALYSIS_STRIKE}: states bitwise, the same "
        f"events (DMR from step {ANALYSIS_STRIKE} on, TMR voted at it); K1 {launches['dmr_compare']}"
        f" and K2 {launches['tmr_step']} launches = compared steps x cells; {seconds:.1f} s")
    return {"programs": out, "launches": launches, "seconds": seconds}


def accumulation_program(level: int):
    """JAX's MISO102 fixture, ``x.at[zeros].add(1.0)``, as
    ``index_add_`` at full size: every value of a 16 M f32 row added into
    index 0, whose sum feeds the next state."""
    from repro_torch import api

    def transition(prev):
        x = prev["acc"]["x"]
        idx = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        total = torch.zeros(1, device=x.device).index_add_(0, idx, x)
        return {"x": x * 0.5 + total * (1.0 / x.shape[0])}

    return api.MisoProgram().add(api.CellType(
        "acc", lambda g, d: {"x": torch.rand(ACCUM_N, generator=g, device=d)}, transition,
        redundancy=api.RedundancyPolicy(level=level)))


def analysis_7d(moe_codes) -> dict:
    """7d: what MISO102 is about, observed (not gated: atomics need not
    diverge in a given run).  The fixture under DMR on ``lockstep_cuda``
    for 32 steps: the analyzer's MISO102, and whether K1 saw the
    replicas diverge; beside it the granite-moe decoder (``index_copy_``)
    that 7b analysed under DMR without MISO102, whose clean DMR steps
    phase 3h gates at 0 events."""
    from repro_torch import api
    from repro_torch.analysis import analyze_program
    from repro_torch.kernels import fused_step as fs

    codes = [d.code for d in analyze_program(accumulation_program(2), name="7d").diagnostics]
    if codes != ["MISO102"]:
        raise AssertionError(f"7d: the analyzer gave {codes}, not MISO102")
    exe = api.compile(accumulation_program(2), backend="lockstep_cuda")
    states = exe.init(SEED)
    torch.cuda.synchronize()
    k0 = fs.dmr_compare.launches
    exe.run(states, ACCUM_STEPS)
    torch.cuda.synchronize()
    k1 = fs.dmr_compare.launches - k0
    tot = exe.ledger.totals.get("acc", {"events": 0.0})
    steps = exe.ledger.recent.get("acc", [])
    log(f"analysis 7d: index_add_ of {ACCUM_N} f32 values into one index under DMR, "
        f"{ACCUM_STEPS} steps on lockstep_cuda: analyzer {codes}; K1 ({k1} launches) saw the "
        f"replicas diverge on {tot['events']:.0f} step(s)"
        + (f", first at step {steps[0]}" if steps else "") + f" (observed, not gated); the "
        f"granite-moe decoder (index_copy_) under DMR: {moe_codes} (0 events on clean steps "
        f"gated in 3h)")
    return {"codes": codes, "events": tot["events"], "first_event": steps[:1], "k1_launches": k1,
            "moe_decoder_codes": moe_codes}


def analysis_phase() -> dict:
    t0 = time.perf_counter()
    out = {"7a": analysis_7a(), "7b": analysis_7b()}
    gc.collect()
    torch.cuda.empty_cache()
    out["7c"] = analysis_7c()
    gc.collect()
    torch.cuda.empty_cache()
    moe = out["7b"]["programs"]["granite-moe-1b-a400m serve paged, decoder DMR"]["codes"]
    out["7d"] = analysis_7d(moe)
    out["seconds"] = time.perf_counter() - t0
    log(f"analysis: phase 7 took {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 8: spatial placement (replicas one a pod of a mesh on the card)
# --------------------------------------------------------------------------
SPATIAL_TIMED_STEPS = 16
#: tests/test_spatial.py's straggler run and strike campaign
STRAGGLER_TIMES = [(1.0, 1.0), (1.0, 4.0), (1.0, 1.0), (1.0, 1.0)]
STRAGGLER_STRIKE = dict(step=1, cell_id=0, replica=1, index=3, bit=21)
STRIKE_CAMPAIGN = ((1, 0), (3, 1), (9, 1))  # (step, replica); step 9 never fires in 6 steps
SPATIAL_SERVE = ((2, 8, ("none", "dmr")), (3, 9, ("none", "dmr", "tmr")))
LAUNCH_8D = ["--arch", LAUNCH_ARCH, "--slots", "4", "--requests", "4", "--mix", "none,dmr",
             "--decode", "16", "--prompt-len", "64", "--max-len", "512", "--strike",
             "--device", "cuda"]


def pod_mesh(n: int, device: str = "cuda:0"):
    """``n`` pods on one device, asked for explicitly."""
    from repro_torch.distributed import make_mesh

    return make_mesh((n,), ("pod",), devices=[device] * n)


def pods_apart(parts) -> bool:
    """No two pods' trees share an allocation."""
    seen = []
    for part in parts:
        ptrs = {x.untyped_storage().data_ptr() for x in _leaves(part)}
        if any(ptrs & other for other in seen):
            return False
        seen.append(ptrs)
    return True


def spatial_8a() -> dict:
    """8a: 2c's 4K blend under ``spatial_lockstep`` (DMR on 2 pods, TMR on
    3, hash and bitwise, all on cuda:0) against ``lockstep`` in this call."""
    from repro_torch import api
    from repro_torch.kernels import tmr_vote as tv

    out = {}
    state_bytes = 3 * W4K * H4K * 4
    for level, compare in ((2, "hash"), (2, "bitwise"), (3, "hash"), (3, "bitwise")):
        label = f"{'dmr' if level == 2 else 'tmr'}_{compare}"
        mesh = pod_mesh(level)
        spa = api.compile(blend_program(api.RedundancyPolicy(
            level=level, compare=compare, placement="spatial")), backend="spatial_lockstep",
            mesh=mesh)
        temporal = blend_program(api.RedundancyPolicy(level=level, compare=compare))
        ref = api.compile(temporal, backend="lockstep")
        s0 = ref.init(SEED)
        p0 = spa.place(s0)
        if not pods_apart(p0["ImageBlend"]):
            raise AssertionError(f"8a {label}: two pods share an allocation")
        fault = api.FaultSpec.at(step=STRIKE_STEP, cell_id=0, replica=1, leaf=0,
                                 index=(H4K // 2) * W4K + W4K // 2, bit=30)
        torch.cuda.synchronize()
        tv.tmr_vote.launches = 0  # counts start here
        clean = spa.run(p0, LOOP_STEPS, start_step=0)
        torch.cuda.synchronize()
        k4_clean = tv.tmr_vote.launches  # and are read here
        if float(clean.reports["ImageBlend"]["events"]) != 0.0 or spa.ledger.totals[
                "ImageBlend"]["events"] != 0.0:
            raise AssertionError(f"8a {label}: events in an unstruck run")
        spa.ledger = api.FaultLedger()
        tv.tmr_vote.launches = 0  # counts start here
        res = spa.run(p0, LOOP_STEPS, start_step=0, faults=fault)
        torch.cuda.synchronize()
        k4 = tv.tmr_vote.launches  # and are read here
        want = ref.run(s0, LOOP_STEPS, start_step=0, faults=fault)
        torch.cuda.synchronize()
        if not bits_equal(spa.gather(res.states), want.states):
            raise AssertionError(f"8a {label}: final states differ from lockstep's")
        if not bits_equal(res.reports, want.reports) or spa.ledger.totals != ref.ledger.totals \
                or spa.ledger.recent != ref.ledger.recent:
            raise AssertionError(f"8a {label}: reports or ledger differ from lockstep's")
        if not pods_apart(res.states["ImageBlend"]):
            raise AssertionError(f"8a {label}: two pods share an allocation after the run")
        tmr_bitwise = level == 3 and compare == "bitwise"
        if tmr_bitwise and not (k4 == k4_clean == LOOP_STEPS):
            raise AssertionError(f"8a {label}: K4 launches {k4_clean} / {k4} != {LOOP_STEPS} "
                                 "steps x 1 spatial TMR cell")
        if not tmr_bitwise and k4 + k4_clean:
            raise AssertionError(f"8a {label}: K4 launched {k4 + k4_clean} times")
        tot = dict(spa.ledger.totals["ImageBlend"])
        first, syncs = spa.ledger.recent["ImageBlend"][0], spa.metrics()["host_syncs"]
        cuda_exe = api.compile(temporal, backend="lockstep_cuda")
        ms = in_turns(SPATIAL_TIMED_STEPS, spatial_lockstep=(spa, p0), lockstep=(ref, s0),
                      lockstep_cuda=(cuda_exe, s0))
        wire = {"dmr_hash": 16, "dmr_bitwise": state_bytes, "tmr_hash": 48,
                "tmr_bitwise": 3 * state_bytes}[label]
        out[label] = {"pods": level, "events": tot["events"], "per_replica": tot["per_replica"],
                      "first_event": first, "k4_launches": k4 + k4_clean,
                      "host_syncs_in_two_runs": syncs, "analytic_bytes_a_compare_a_pod": wire,
                      **{f"{k}_ms_per_step": v for k, v in ms.items()}}
        log(f"spatial 8a {label}: {level} pods on cuda:0, 4K blend, {LOOP_STEPS} steps: states, "
            f"reports and ledger bitwise lockstep's (events {tot['events']:.0f}, first at step "
            f"{out[label]['first_event']}), unstruck 0 events, pods' allocations distinct, "
            f"K4 {k4_clean} + {k4}; ms/step spatial "
            + " / ".join(f"{x:.3f}" for x in ms["spatial_lockstep"]) + ", lockstep "
            + " / ".join(f"{x:.3f}" for x in ms["lockstep"]) + ", lockstep_cuda "
            + " / ".join(f"{x:.3f}" for x in ms["lockstep_cuda"])
            + f"; {wire} B a compare a pod (analytic)")
        del spa, ref, cuda_exe, s0, p0, clean, res, want
        gc.collect()
        torch.cuda.empty_cache()
    return out


def straggler_outcomes(device: str, n: int) -> dict:
    """8b: ``run_with_straggler_policy`` and ``spatial_strike_report`` on
    the spatial DMR blend of ``n`` pixels, 2 pods on ``device``."""
    from repro_torch import api
    from repro_torch.ft import elastic

    prog = blend_program(api.RedundancyPolicy(level=2, compare="hash", placement="spatial"), n)
    mesh = pod_mesh(2, device)

    def fresh():
        return api.compile(prog, backend="spatial_lockstep", mesh=mesh)

    spa = fresh()
    s0 = spa.init(SEED)
    strike = api.FaultSpec.at(**STRAGGLER_STRIKE)
    final, stats, flog = elastic.run_with_straggler_policy(
        spa, s0, 4, elastic.StragglerPolicy(mode="first_wins", slack=1.5), STRAGGLER_TIMES,
        faults=strike, start_step=0)
    kinds = [[e["step"], e["kind"]] for e in flog.events]
    plain = fresh()
    ref = plain.run(s0, 4, start_step=0, faults=strike)
    campaign = [api.FaultSpec.at(step=st, cell_id=0, replica=r, index=3, bit=21)
                for st, r in STRIKE_CAMPAIGN]
    report = elastic.spatial_strike_report(fresh(), s0, 6, campaign, start_step=0)
    return {
        "adopted": stats.adopted_fast, "waited": stats.waited,
        "deficit_repaid": stats.compare_deficit == 0, "kinds": kinds,
        "first_detect": next((st for st, k in kinds if k == "detect"), None),
        "ledger_first": spa.ledger.recent.get("ImageBlend", [None])[0],
        "states_match_plain_run": bits_equal(spa.gather(final), plain.gather(ref.states)),
        "strike_report": [{k: r[k] for k in ("fault_step", "detected", "events", "repaired")}
                          for r in report],
    }


def spatial_8b() -> dict:
    t0 = time.perf_counter()
    card = straggler_outcomes("cuda:0", W4K * H4K)
    torch.cuda.synchronize()
    cpu = straggler_outcomes("cpu", 64 * 32)
    if card != cpu:
        raise AssertionError(f"8b: the card's outcomes {card} differ from the CPU's {cpu}")
    if (card["adopted"], card["waited"], card["first_detect"], card["ledger_first"]) != (1, 3, 2, 2) \
            or [1, "adopt"] not in card["kinds"] or [2, "repay"] not in card["kinds"] \
            or not card["states_match_plain_run"] \
            or [r["detected"] for r in card["strike_report"]] != [True, True, False]:
        raise AssertionError(f"8b: outcomes {card} are not tests/test_spatial.py's")
    log(f"spatial 8b: straggler on the 4K spatial DMR blend: adopted {card['adopted']}, waited "
        f"{card['waited']}, first detect at step {card['first_detect']} (the adopted step 1 hid "
        f"the strike), trajectory bitwise a plain run; strike report detected "
        f"{[r['detected'] for r in card['strike_report']]}; equal to the CPU's outcomes "
        f"({time.perf_counter() - t0:.1f} s)")
    return card


def spatial_8c() -> dict:
    """8c: internlm2-1.8b at full width, dense, served spatially on 2 and 3
    pods of cuda:0 and temporally in this call."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models.lm_cells import ServeConfig
    from repro_torch.serving import spatial as sp

    cfg = get_config(LAUNCH_ARCH)
    out = {}
    k5 = 0
    for pods, batch, mix in SPATIAL_SERVE:
        runs = {}
        for label, mesh in (("temporal", None), ("spatial", pod_mesh(pods))):
            placement = "spatial" if mesh is not None else "temporal"
            scfg = ServeConfig(batch=batch, max_len=512, placement=placement)
            torch.cuda.reset_peak_memory_stats()
            engine, run, (launches,), tokens = serve_stream(
                cfg, scfg, [pd.paged_gqa_attention], mesh=mesh, mix=mix)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 1e9
            n_pods = pods if mesh is not None else 1
            expect = cfg.n_layers * (run["ticks"] + run["replays"]) * n_pods
            if launches != expect:
                raise AssertionError(f"8c {pods} pods {label}: K5 launches {launches} != "
                                     f"{cfg.n_layers} x ({run['ticks']} + {run['replays']}) x "
                                     f"{n_pods}")
            k5 += launches
            m = engine.metrics()
            dec = engine._states["decoder"]
            if mesh is not None:
                if not pods_apart(dec):
                    raise AssertionError(f"8c {pods} pods: two pods share an allocation")
                lvl = np.full(batch // pods, 3 if "tmr" in mix else 2, np.int32)
                detect = engine._get_detect("tmr" in mix)
                check_ms = events_ms(lambda: detect(dec, lvl), iters=5)
            else:
                check_ms = events_ms(lambda: engine._ops.fingerprints(dec), iters=5)
            victim = m["fault_totals"][run["victim"]]
            runs[label] = {**run, "k5_launches": launches, "peak_gb": peak,
                           "check_ms_per_tick": check_ms, "victim_ledger": victim,
                           "victim_index": [r for r in engine.requests].index(run["victim"]),
                           "pods": m["pods"], "backend": m["backend"], "tokens": tokens}
            del engine, dec
            gc.collect()
            torch.cuda.empty_cache()
        t, s = runs["temporal"], runs["spatial"]
        if s["tokens"] != t["tokens"]:
            raise AssertionError(f"8c {pods} pods: spatial tokens differ from temporal ones")
        if s["victim_ledger"] != t["victim_ledger"] or s["victim_index"] != t["victim_index"]:
            raise AssertionError(f"8c {pods} pods: strike ledger {s['victim_ledger']} != "
                                 f"temporal {t['victim_ledger']}")
        for r in runs.values():
            r.pop("tokens")
        detect = "TMR all-gather" if "tmr" in mix else "DMR psum_delta"
        log(f"spatial 8c: {LAUNCH_ARCH} dense, {pods} pods x {batch // pods} slots ({'/'.join(mix)}): "
            f"tokens bitwise temporal, strike on the same request and replica "
            f"({s['victim_ledger']['per_replica']}); spatial {s['tokens_per_s']:.1f} tok/s, "
            f"{s['ms_per_tick']:.2f} ms/tick, {detect} {s['check_ms_per_tick']:.2f} ms, peak "
            f"{s['peak_gb']:.2f} GB, K5 {s['k5_launches']}; temporal {t['tokens_per_s']:.1f} "
            f"tok/s, {t['ms_per_tick']:.2f} ms/tick, fingerprints {t['check_ms_per_tick']:.2f} ms, "
            f"peak {t['peak_gb']:.2f} GB, K5 {t['k5_launches']}; detect "
            f"{sp.detect_wire_bytes(pods, batch // pods, 'tmr' in mix)} B a pod a tick (analytic)")
        out[f"{pods}_pods"] = runs
    out["k5_launches"] = k5
    return out


def spatial_8d() -> dict:
    """8d: the launcher with ``--placement spatial`` on one card (1 pod)
    against the temporal launcher, then the quickstart's section 4b."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.launch import serve as S

    toks, k5 = {}, 0
    for label, extra in (("temporal", []), ("spatial", ["--placement", "spatial"])):
        torch.cuda.synchronize()
        pd.paged_gqa_attention.launches = 0  # counts start here
        engine = S.main(LAUNCH_8D + extra)
        torch.cuda.synchronize()
        k5 += pd.paged_gqa_attention.launches  # and are read here
        m = engine.metrics()
        toks[label] = [r.token_ids() for r in engine.requests.values()]
        if label == "spatial" and (m["pods"], m["backend"]) != (1, "spatial_lockstep"):
            raise AssertionError(f"8d: the one-card launcher served {m['pods']} pods on "
                                 f"{m['backend']}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    if toks["spatial"] != toks["temporal"]:
        raise AssertionError("8d: the 1-pod spatial launcher's tokens differ from the temporal one's")
    qs = load_example("quickstart_torch").main(["--placement", "spatial"])
    torch.cuda.synchronize()
    log(f"spatial 8d: launcher --placement spatial on one card = 1 pod, tokens bitwise the "
        f"temporal launcher's; quickstart 4b: {qs['spatial_backend']} on {qs['spatial_pods']} "
        f"pods of cuda:0, strike detected at step {qs['spatial_detected']}, campaign events "
        f"{qs['campaign_events']}")
    return {"k5_launches": k5, "quickstart": {k: v for k, v in qs.items() if k.startswith(
        ("spatial", "campaign"))}}


def spatial_phase() -> dict:
    t0 = time.perf_counter()
    out = {"8a": spatial_8a(), "8b": spatial_8b()}
    gc.collect()
    torch.cuda.empty_cache()
    out["8c"] = spatial_8c()
    out["8d"] = spatial_8d()
    out["seconds"] = time.perf_counter() - t0
    log(f"spatial: phase 8 took {out['seconds']:.1f} s")
    return out


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
        log(f"build: {name}: {'; '.join(ptxas_lines(path.with_suffix('.log')))}")
    record = kernel_phase(paths["paged_gqa_decode"].with_suffix(".log"))
    epi = epilogue_phase()
    loop = loop_phase(epi)
    torch.cuda.empty_cache()  # hand the 4K states' memory back
    schedules = schedules_phase(epi)
    gc.collect()
    torch.cuda.empty_cache()
    ssd = ssd_phase(paths["ssd_scan"].with_suffix(".log"))
    attn = attention_phase(paths["flash_attention"].with_suffix(".log"))
    mla = mla_kernel_phase(paths["paged_mla_decode"].with_suffix(".log"))
    torch.cuda.empty_cache()
    eng, plain_tokens = engine_phase()
    record["launches"] = eng["launches"]
    record["launches_by_path"] = {"engine_3": eng["launches"]}
    gc.collect()
    torch.cuda.empty_cache()  # the internlm2 engine is gone: hand its memory back
    mamba = mamba_engine_phase()
    ssd["launches"] = mamba["launches"]
    gc.collect()
    torch.cuda.empty_cache()  # the mamba2 engine is gone: hand its memory back
    deepseek, mla_tokens = mla_engine_phase()
    mla["launches"] = deepseek["launches"]
    mla["launches_by_path"] = {"engine_3c": deepseek["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    spec = spec_phase(plain_tokens, mla_tokens)
    for rec, key in ((record, "paged_gqa_decode"), (mla, "paged_mla_decode")):
        for path, n in spec["launches"][key].items():
            rec["launches_by_path"][path] = n
            rec["launches"] += n
    gc.collect()
    torch.cuda.empty_cache()
    arch_engines, arch_paths = arch_phases()
    ssd["launches_by_path"] = {"engine_3b": mamba["launches"]}
    for rec, key in ((record, "paged_gqa_decode"), (mla, "paged_mla_decode"), (ssd, "ssd_scan")):
        for path, n in arch_paths[key].items():
            rec["launches_by_path"][path] = n
            rec["launches"] += n
    from repro_torch.configs import deepseek_v3_671b as ds
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import paged_decode as pd

    parity = {"internlm2-1.8b": parity_phase("internlm2-1.8b", pd.paged_gqa_attention)}
    check_phase("mamba2-2.7b")
    parity["deepseek-v3-671b"] = parity_phase(
        "deepseek-v3-671b", pd.paged_mla_attention,
        dataclasses.replace(ds.dense_prefix(ds.reduced()), n_layers=2))
    parity["granite-moe-1b-a400m"] = parity_phase(
        "granite-moe-1b-a400m", pd.paged_gqa_attention, no_drops(get_reduced("granite-moe-1b-a400m")))
    parity["granite-20b"] = parity_phase("granite-20b", pd.paged_gqa_attention)
    check_phase("zamba2-2.7b")
    parity["musicgen-large"] = parity_phase("musicgen-large", pd.paged_gqa_attention)
    ring = ring_phase()
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase()
    epi["tmr_vote"]["launches_by_path"]["train_5b"] = train["5b"]["k4_launches"]
    epi["tmr_vote"]["launches"] += train["5b"]["k4_launches"]
    gc.collect()
    torch.cuda.empty_cache()
    launch = launch_phase()
    ex = launch["6e"]["launches"]
    for rec, path, n in ((record, "launch_6a", launch["6a"]["k5_launches"]),
                         (record, "launch_6b", launch["6b"]["k5_launches"]),
                         (record, "launch_6c", launch["6c"]["k5_launches"]),
                         (record, "examples", ex["paged_gqa_decode"]),
                         (epi["tmr_step"], "launch_6c", launch["6c"]["k2_launches"]),
                         (epi["tmr_step"], "examples", ex["tmr_step"]),
                         (epi["tmr_vote"], "examples", ex["tmr_vote"]),
                         (ssd, "launch_6c", launch["6c"]["k8_launches"])):
        rec["launches_by_path"][path] = n
        rec["launches"] += n
    gc.collect()
    torch.cuda.empty_cache()
    analysis = analysis_phase()
    for key, n in analysis["7c"]["launches"].items():
        epi[key]["launches_by_path"]["analysis_7c"] = n
        epi[key]["launches"] += n
    gc.collect()
    torch.cuda.empty_cache()
    spatial = spatial_phase()
    epi["tmr_vote"]["launches_by_path"]["spatial_8a"] = sum(
        r["k4_launches"] for r in spatial["8a"].values())
    epi["tmr_vote"]["launches"] += epi["tmr_vote"]["launches_by_path"]["spatial_8a"]
    for path, n in (("spatial_8c", spatial["8c"]["k5_launches"]),
                    ("spatial_8d", spatial["8d"]["k5_launches"])):
        record["launches_by_path"][path] = n
        record["launches"] += n
    print(json.dumps({"paged_dense_parity": parity, "ring_check": ring}), flush=True)
    print(json.dumps({"loop": loop}), flush=True)
    print(json.dumps({"schedules": schedules}), flush=True)
    print(json.dumps({"engine": eng}), flush=True)
    print(json.dumps({"engine_mamba2": mamba}), flush=True)
    print(json.dumps({"engine_deepseek_mla": deepseek}), flush=True)
    print(json.dumps({"engine_spec": spec}), flush=True)
    print(json.dumps({"engine_archs": arch_engines}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"launch": launch}), flush=True)
    print(json.dumps({"analysis": analysis}), flush=True)
    print(json.dumps({"spatial": spatial}), flush=True)
    print(json.dumps({"kernels": [record, *epi.values(), attn, ssd, mla]}), flush=True)
    print(smi, flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
