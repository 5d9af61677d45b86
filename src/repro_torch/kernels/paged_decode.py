"""Paged single-query decode attention: the wrappers of the CUDA kernels
``csrc/paged_gqa_decode.cu`` (GQA) and ``csrc/paged_mla_decode.cu``
(absorbed MLA), and their plain PyTorch versions.

Replace the Pallas kernels ``repro/kernels/paged_decode.py::
paged_gqa_attention`` and ``::paged_mla_attention`` (TPU).  Each slot's
K/V bytes live in fixed-size pages of one shared pool; the per-slot page
table maps logical page -> pool row (-1 = unmapped).  GQA semantics,
shared by kernel and plain version:

  * unmapped pages read as zero lanes and are masked; a page row past
    the pool's end reads the pool's last row (the gather clamps, as the
    JAX reference does);
  * lanes past ``pos`` are masked;
  * scores are f32, ``q * scale`` dotted with K, ``scale = Dk**-0.5``;
  * a full f32 softmax over all ``P * ps`` lanes (masked lanes hold
    ``NEG_INF = -1e30``, which is finite: a row with no valid lane gets
    the mean of its gathered V lanes, 0 when no page is mapped), then
    P.V in f32, cast to ``q.dtype``.

MLA (``paged_mla_attention``) keeps one latent row per token, shared
by every head: ``ckv`` (N, ps, lora) and its RoPE key ``krope`` (N, ps,
rope).  The page and lane masks, the clamp and the full f32 softmax are
the GQA kernel's; scores are ``(q_lat . ckv + q_rope . krope) * scale``,
the scale applied after the sum, and the output is the f32 latent
context ``p . ckv`` (B, h, lora), cast by the caller before ``w_uv``.

A dense cache is read by the same kernels in place, as one page of S
lanes a slot: ``dense_gqa_view`` (a strided view of (B, Hkv, S, D) and
the table ``b * Hkv``) and ``dense_mla_view`` (the cache itself and the
table ``b``).  Both kernels split a slot's lanes at multiples of
``SPLIT_QUANTUM`` and reduce in an order fixed by the lane index alone,
so a dense view and a paged pool holding the same values give the same
bits: the paged-vs-dense token parity of the engine holds on the card.

``paged_mla_partials`` is K6's partials entry point, the same for the
latent pools: a member of a mesh holding some of a slot's pages or lanes
(paged pools, or a sequence-sharded dense latent cache read through
``dense_mla_view``) gives its ``(acc, m, l)``.  In bf16 it runs
``csrc/paged_mla_partials.cu`` along ``mla_partials_plan`` (the lanes
alone): one tensor-core launch whose splits merge in a thread-block
cluster.

``paged_gqa_partials`` is the GQA kernel's second entry point: each
row's flash-decoding partial ``(acc, m, l)`` over the lanes it is given,
a row with no valid lane an empty partial (no uniform mean).  A member of
a sequence-sharded mesh reads its own cache shard through it
(``distributed/decode.py``).  ``gqa_partials_plan`` picks its kernel by
the shapes alone: bf16 groups from ``TC_MIN_GROUP`` heads on (and Dk up
to 128) take ``csrc/paged_gqa_partials.cu``, one tensor-core launch whose
splits merge in a thread-block cluster; f32 and smaller groups take the
GQA kernel's split pass and a merge that does not divide.

The dense-cache decode pieces that the model's layers and the sharded
decode (``distributed/decode.py``) share live here too, below both:
``dense_decode_on_card``, ``ring_lane_pos``, the serving slot ``gate``
and ``dense_mla_decode``.

Each wrapper takes its plain version for CPU tensors only; a CUDA tensor
reaches the kernel or an exception.  ``launches`` on a wrapper counts
its kernel launches: one a call (each kernel's split pass and merge
pass are one launch of its entry point).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

NEG_INF = -1e30

#: dynamic shared memory one block of the kernel may use on Hopper
SMEM_LIMIT = 232448
#: largest head dim of the GQA kernel (ceil(Dk / 8) threads a row, one warp)
MAX_HEAD_DIM = 256
#: query heads one GQA block takes (its register tile); a larger group
#: takes ceil(G / GQA_CHUNK) blocks per kv head
GQA_CHUNK = 8
#: lanes of a split boundary: both kernels split a slot's lanes at
#: multiples of it, so their reduction order is a function of the lane
#: index alone (a dense view and any page size give the same bits)
SPLIT_QUANTUM = 64
#: bf16 query groups of at least this many heads take the partials'
#: tensor-core kernel (``csrc/paged_gqa_partials.cu``); smaller groups
#: take the split pass and merge.  The route sweep of ``chip_smoke.py``
#: phase 9b (PERF.md section 6, the K5 partials row): from G = 2 the
#: tensor cores win at every head dim and lane count; at G = 1, where 63
#: of the 64 wgmma rows idle, they do not.
TC_MIN_GROUP = 2
#: widest head dim of the partials' tensor-core kernel (rows zero-padded
#: to 64 or 128 columns)
TC_MAX_HEAD_DIM = 128
#: most splits of the tensor-core kernel: one thread-block cluster of the
#: portable size merges them
TC_MAX_CLUSTER = 8
#: fewest 64-lane tiles a split of the tensor-core kernel takes where the
#: lanes allow (one tile a split re-reads Q and merges more for no overlap)
TC_MIN_TILES = 2
#: most blocks of the tensor-core kernel a slot (kv heads x head groups x
#: splits) at 128 padded columns, twice as many at 64 (half the shared
#: memory a block): the split counts of phase 9b's sweep
TC_SLOT_BLOCKS = 24


def attend(q, k, v, valid, scale: float) -> torch.Tensor:
    """Single-query GQA over a dense view: q (B, Hq, Dk), k/v (B, Hkv, S, D),
    valid (B, S) -> (B, Hq, Dv) in q.dtype.  The math of the JAX
    package's ``layers.decode_attention``; the dense decode path and the
    paged plain version both run it, so within this package a paged
    decode reduces in the same order as a dense one."""
    B, Hq, Dk = q.shape
    Hkv = k.shape[1]
    qf = q.reshape(B, Hkv, Hq // Hkv, Dk).float() * scale
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k.float().contiguous())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v.float().contiguous())
    return out.reshape(B, Hq, v.shape[-1]).to(q.dtype)


def paged_gather(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Dense view (B, Hkv, P*ps, D) of pool (N, Hkv, ps, D) through the
    page table (B, P); unmapped pages read as zeros."""
    B, P = pages.shape
    _, Hkv, ps, D = pool.shape
    g = pool[pages.clamp(0, pool.shape[0] - 1).long()]  # (B, P, Hkv, ps, D)
    g = torch.where((pages >= 0)[:, :, None, None, None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, P * ps, D)


def paged_valid(pages: torch.Tensor, pos: torch.Tensor, page_size: int) -> torch.Tensor:
    """(B, P*ps) mask of the lanes a decode attends to: on a mapped page
    and at or before ``pos``."""
    lane = torch.arange(pages.shape[1] * page_size, device=pages.device)
    return (pages >= 0).repeat_interleave(page_size, dim=1) & (lane[None, :] <= pos[:, None])


def paged_gqa_plain(q, k_pool, v_pool, pages, pos, *, scale=None) -> torch.Tensor:
    """The plain version: gather pages in logical order, then ``attend``
    (``repro/kernels/ref.py::paged_gqa_ref``)."""
    scale = (q.shape[-1] ** -0.5) if scale is None else scale
    valid = paged_valid(pages, pos, k_pool.shape[2])
    return attend(q, paged_gather(k_pool, pages), paged_gather(v_pool, pages), valid, scale)


def gqa_split_lanes(B: int, blocks: int, S: int, sms: int) -> int:
    """Lanes a split of the GQA kernel takes, a multiple of
    ``SPLIT_QUANTUM``: the fewest splits, a power of two, that give the
    grid (B, blocks = Hkv x head chunks, splits) at least two blocks an
    SM, at most one quantum each; 64 lanes, 8 splits, at B = 8, Hkv = 8,
    G = 2, S = 512 on 132 SMs.  A function of S, not of the page size: a
    dense view and a paged pool of one slot length split alike."""
    quanta = -(-S // SPLIT_QUANTUM)
    n = 1
    while n * 2 <= quanta and B * blocks * n < 2 * sms:
        n *= 2
    return SPLIT_QUANTUM * -(-quanta // n)


class PartialsPlan(NamedTuple):
    """How ``paged_gqa_partials`` (or, always "tc", ``paged_mla_partials``)
    runs: ``route`` "tc" (the tensor-core kernel, one launch) or "split"
    (the split pass and the merge), ``split_lanes`` lanes a split (a
    multiple of ``SPLIT_QUANTUM``) and ``cluster`` the splits one cluster
    merges ("tc": all of them; 1 for "split", which merges in a second
    pass)."""

    route: str
    split_lanes: int
    cluster: int


def gqa_partials_plan(B: int, Hkv: int, G: int, S: int, Dk: int, dtype, sms: int) -> PartialsPlan:
    """The partials' kernel for these shapes, by the shapes alone: bf16
    with G >= ``TC_MIN_GROUP`` and Dk <= ``TC_MAX_HEAD_DIM`` takes
    ``tc_partials_plan``, which reads neither B nor the SM count, so a row
    gives the same bits in a call of any batch size; anything else
    "split", at ``gqa_split_lanes``."""
    if dtype != torch.bfloat16 or G < TC_MIN_GROUP or Dk > TC_MAX_HEAD_DIM:
        chunks = -(-G // GQA_CHUNK)
        return PartialsPlan("split", gqa_split_lanes(B, Hkv * chunks, S, sms), 1)
    return tc_partials_plan(Hkv, G, S, Dk)


def tc_partials_plan(Hkv: int, G: int, S: int, Dk: int) -> PartialsPlan:
    """The tensor-core route over S lanes: the most splits, a power of two
    up to ``TC_MAX_CLUSTER``, that leave each split ``TC_MIN_TILES``
    64-lane tiles and a slot at most ``TC_SLOT_BLOCKS`` blocks (twice as
    many at Dk <= 64), all in one cluster.  One split of 128 lanes at
    granite-20b's 128-lane member, 8 of 256 at 2048 lanes; 2 of 1024 with
    8 kv heads of 128."""
    tiles = -(-S // SPLIT_QUANTUM)
    per_split = Hkv * -(-G // 64)  # a slot's blocks for each split
    cap = TC_SLOT_BLOCKS * (2 if Dk <= 64 else 1)
    n = 1
    while 2 * n <= TC_MAX_CLUSTER and 2 * n * TC_MIN_TILES <= tiles and per_split * 2 * n <= cap:
        n *= 2
    lanes = SPLIT_QUANTUM * -(-tiles // n)
    return PartialsPlan("tc", lanes, -(-S // lanes))


def dense_gqa_view(k: torch.Tensor, v: torch.Tensor):
    """A dense cache (B, Hkv, S, D) seen as a pool for the paged kernel,
    read in place: views (N, Hkv, S, D) with strides (S D, S D, D, 1), so
    page row r and kv head h start at element (r + h) S D, and the table
    ``pages[b, 0] = b Hkv`` (one page of S lanes a slot; N = (B - 1) Hkv +
    1 rows, the last of which ends at the cache's last element)."""
    if not (k.is_contiguous() and v.is_contiguous()) or v.shape != k.shape:
        raise ValueError("dense_gqa_view takes two contiguous caches of one shape")
    B, Hkv, S, D = k.shape
    N = (B - 1) * Hkv + 1
    views = [x.as_strided((N, Hkv, S, D), (S * D, S * D, D, 1)) for x in (k, v)]
    pages = (torch.arange(B, dtype=torch.int32, device=k.device) * Hkv)[:, None]
    return views[0], views[1], pages


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_gqa_decode")
    for fn, ptrs in ((lib.paged_gqa_decode_f32, 7), (lib.paged_gqa_decode_bf16, 7),
                     (lib.paged_gqa_partials_f32, 9), (lib.paged_gqa_partials_bf16, 9)):
        fn.argtypes = ([ctypes.c_void_p] * ptrs + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _partials_lib() -> ctypes.CDLL:
    lib = build.load("paged_gqa_partials")
    lib.paged_gqa_partials_tc.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                          + [ctypes.c_longlong] * 2
                                          + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    lib.paged_gqa_partials_tc_empty.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for fn in (lib.paged_gqa_partials_tc, lib.paged_gqa_partials_tc_empty):
        fn.restype = ctypes.c_int
    return lib


def _check(q, k_pool, v_pool, pages, pos) -> None:
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be (B,Hq,Dk), pools (N,Hkv,ps,Dk); got {tuple(q.shape)}, {tuple(k_pool.shape)}")
    B, Hq, Dk = q.shape
    N, Hkv, ps, Dk2 = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk2 != Dk:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if pages.dim() != 2 or pages.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(f"pages must be (B,P) and pos (B,) for B={B}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if min(B, N, ps, Dk, pages.shape[1]) < 1:
        raise ValueError("empty input")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or bfloat16")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q and the pools must share one dtype")
    if pages.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("pages and pos must be int32")
    tensors = (q, k_pool, v_pool, pages, pos)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in (q, pages, pos)):
        raise ValueError("the kernel takes contiguous q, pages and pos")
    if k_pool.stride()[2:] != (Dk, 1) or v_pool.stride() != k_pool.stride():
        raise ValueError("the pools' lanes must be contiguous rows of Dk, and both pools must "
                         "share one layout (a contiguous pool, or a dense_gqa_view)")
    if Dk % 8 or Dk > MAX_HEAD_DIM:
        raise ValueError(f"head dim {Dk} must be a multiple of 8 (16-byte row loads) and at most "
                         f"{MAX_HEAD_DIM}")
    if any(t.data_ptr() % 16 for t in tensors[:3]):
        raise ValueError("the kernel reads 16-byte rows: q and the pools must be 16-byte aligned")


def paged_gqa_attention(q, k_pool, v_pool, pages, pos, *, scale=None) -> torch.Tensor:
    """Single-query GQA attention reading K/V through a page table.

    q (B, Hq, Dk), any group Hq / Hkv; pools (N, Hkv, ps, Dk), contiguous
    or a ``dense_gqa_view`` (the kernel reads them through their page and
    head strides); pages (B, P) int32, -1 = unmapped; pos (B,) int32.
    Returns (B, Hq, Dk) in q.dtype.  CPU tensors take
    ``paged_gqa_plain``; CUDA tensors launch the kernel on the current
    stream."""
    if q.device.type == "cpu":
        return paged_gqa_plain(q, k_pool, v_pool, pages, pos, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa_attention runs on cuda or cpu, not {q.device}")
    _check(q, k_pool, v_pool, pages, pos)
    B, Hq, Dk = q.shape
    N, Hkv, ps, _ = k_pool.shape
    P = pages.shape[1]
    scale = (Dk**-0.5) if scale is None else scale
    lib = _lib()
    fn = lib.paged_gqa_decode_f32 if q.dtype == torch.float32 else lib.paged_gqa_decode_bf16
    chunks = -(-(Hq // Hkv) // GQA_CHUNK)
    split_lanes = gqa_split_lanes(B, Hkv * chunks, P * ps, build.sm_count(q.device.index))
    n_split = -(-P * ps // split_lanes)
    out = torch.empty_like(q)
    # per split and query head: the unnormalised f32 context, then (m, l)
    part = torch.empty(B * Hq * n_split * (Dk + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):  # the C launch uses the current device
        err = fn(
            q.data_ptr(),
            k_pool.data_ptr(),
            v_pool.data_ptr(),
            pages.data_ptr(),
            pos.data_ptr(),
            out.data_ptr(),
            part.data_ptr(),
            B,
            Hq,
            Hkv,
            Dk,
            ps,
            P,
            N,
            k_pool.stride(0),
            k_pool.stride(1),
            split_lanes,
            float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"paged_gqa_decode launch failed: cudaError {err}")
    paged_gqa_attention.launches += 1
    return out


paged_gqa_attention.launches = 0


def paged_gqa_partials_plain(q, k_pool, v_pool, pages, pos, *, scale=None):
    """The plain version of ``paged_gqa_partials``: over the lanes of
    mapped pages at or before ``pos``, the f32 scores' max ``m`` (B, Hq),
    ``l = sum exp(s - m)`` (B, Hq) and ``acc = sum exp(s - m) V`` (B, Hq,
    Dv); a row with no valid lane gives m = -inf, l = 0, acc = 0."""
    B, Hq, Dk = q.shape
    Hkv = k_pool.shape[1]
    scale = (Dk**-0.5) if scale is None else scale
    valid = paged_valid(pages, pos, k_pool.shape[2])[:, None, None, :]
    k, v = paged_gather(k_pool, pages).float(), paged_gather(v_pool, pages).float()
    qf = q.reshape(B, Hkv, Hq // Hkv, Dk).float() * scale
    s = torch.where(valid, torch.einsum("bhgd,bhsd->bhgs", qf, k), -torch.inf)
    m = s.amax(dim=-1)
    e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhgs,bhsd->bhgd", e, v)
    return acc.reshape(B, Hq, v.shape[-1]), m.reshape(B, Hq), e.sum(dim=-1).reshape(B, Hq)


def paged_gqa_partials(q, k_pool, v_pool, pages, pos, *, scale=None):
    """Single-query GQA over a page table as a flash-decoding partial:
    ``(acc (B,Hq,Dk) f32, m (B,Hq) f32, l (B,Hq) f32)``, the unnormalised
    context, the scores' max (natural units) and the softmax sum over the
    valid lanes (``acc / l`` is ``paged_gqa_attention``'s output where a
    lane is valid).  The inputs are ``paged_gqa_attention``'s; ``pos``
    may be negative, and a row without a valid lane gives m = -inf, l =
    0.  The kernel follows ``gqa_partials_plan`` and merges its splits in
    order, so equal inputs give equal bits.  CPU tensors take
    ``paged_gqa_partials_plain``."""
    if q.device.type == "cpu":
        return paged_gqa_partials_plain(q, k_pool, v_pool, pages, pos, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa_partials runs on cuda or cpu, not {q.device}")
    _check(q, k_pool, v_pool, pages, pos)
    B, Hq, Dk = q.shape
    _, Hkv, ps, _ = k_pool.shape
    plan = gqa_partials_plan(B, Hkv, Hq // Hkv, pages.shape[1] * ps, Dk, q.dtype,
                             build.sm_count(q.device.index))
    return launch_partials(plan, q, k_pool, v_pool, pages, pos, scale=scale)


def launch_partials(plan: PartialsPlan, q, k_pool, v_pool, pages, pos, *, scale=None):
    """One launch of the partials' kernel along ``plan`` on inputs
    ``paged_gqa_partials`` has checked; ``paged_gqa_partials`` passes
    ``gqa_partials_plan``'s, and ``chip_smoke.py`` times the other route
    through it.  Counts the launch on ``paged_gqa_partials.launches``."""
    B, Hq, Dk = q.shape
    N, Hkv, ps, _ = k_pool.shape
    P = pages.shape[1]
    scale = (Dk**-0.5) if scale is None else scale
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, Hq, Dk), **f32)
    m, l = torch.empty((B, Hq), **f32), torch.empty((B, Hq), **f32)
    ptrs = [t.data_ptr() for t in (q, k_pool, v_pool, pages, pos, acc, m, l)]
    sizes = (B, Hq, Hkv, Dk, ps, P, N, k_pool.stride(0), k_pool.stride(1), plan.split_lanes,
             float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):  # the C launch uses the current device
        if plan.route == "tc":
            if q.dtype != torch.bfloat16:
                raise TypeError("the partials' tensor-core kernel takes bfloat16")
            err = _partials_lib().paged_gqa_partials_tc(*ptrs, *sizes)
        else:
            lib = _lib()
            fn = lib.paged_gqa_partials_f32 if q.dtype == torch.float32 else lib.paged_gqa_partials_bf16
            n_split = -(-P * ps // plan.split_lanes)
            # per split and query head: the unnormalised f32 context, then (m, l)
            part = torch.empty(B * Hq * n_split * (Dk + 2), **f32)
            err = fn(*ptrs, part.data_ptr(), *sizes)
    if err:
        raise RuntimeError(f"paged_gqa_partials launch failed: cudaError {err}")
    paged_gqa_partials.launches += 1
    return acc, m, l


def partials_empty_launch(plan: PartialsPlan, q, S: int, Hkv: int) -> None:
    """The launch floor of the tensor-core partials: an empty kernel with
    ``plan``'s grid, cluster and shared memory for ``q`` (B, Hq, Dk) over
    S lanes on Hkv kv heads.  For ``chip_smoke.py``'s timing; counts no
    launch."""
    B, Hq, Dk = q.shape
    with torch.cuda.device(q.device):
        err = _partials_lib().paged_gqa_partials_tc_empty(
            B, Hq, Hkv, Dk, S, plan.split_lanes, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_gqa_partials_tc_empty launch failed: cudaError {err}")


paged_gqa_partials.launches = 0


# --------------------------------------------------------------------------
# MLA: absorbed latent attention through a page table
# --------------------------------------------------------------------------
#: query heads one block of the f32 MLA kernel may take (its register tiles)
MLA_MAX_GROUP = 16
#: threads of one f32 MLA block (the kernel's kThreads)
MLA_THREADS = 256
#: query heads one bf16 MLA block takes (one wgmma M)
MLA_HEADS = 64
#: widest latent and RoPE rows of the bf16 MLA instance (zero-padded up to them)
MLA_MAX_LORA, MLA_MAX_ROPE = 512, 64


def attend_mla(q_lat, q_rope, ckv, krope, valid, scale: float) -> torch.Tensor:
    """Absorbed-MLA single-query attention over a dense view: q_lat (B, h,
    lora), q_rope (B, h, rope), ckv (B, S, lora), krope (B, S, rope),
    valid (B, S) -> the f32 latent context (B, h, lora).  The math of the
    JAX package's dense absorbed decode (``layers.mla_attention``); the
    dense decode path and the paged plain version both run it, so within
    this package a paged MLA decode reduces in the same order as a dense
    one."""
    ckv = ckv.float().contiguous()
    s_lat = torch.einsum("bhl,btl->bht", q_lat.float(), ckv)
    s_rope = torch.einsum("bhr,btr->bht", q_rope.float(), krope.float().contiguous())
    s = torch.where(valid[:, None, :], (s_lat + s_rope) * scale, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,btl->bhl", p, ckv)


def paged_gather_lanes(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Dense view (B, P*ps, d) of a latent pool (N, ps, d) through the
    page table (B, P); unmapped pages read as zeros.  ``paged_gather``
    over a pool of one head."""
    return paged_gather(pool[:, None], pages)[:, 0]


def paged_mla_plain(q_lat, q_rope, ckv_pool, krope_pool, pages, pos, *, scale: float) -> torch.Tensor:
    """The plain version: gather pages in logical order, then
    ``attend_mla`` (``repro/kernels/ref.py::paged_mla_ref``)."""
    valid = paged_valid(pages, pos, ckv_pool.shape[1])
    return attend_mla(q_lat, q_rope, paged_gather_lanes(ckv_pool, pages),
                      paged_gather_lanes(krope_pool, pages), valid, scale)


def dense_mla_view(ckv: torch.Tensor, krope: torch.Tensor):
    """A dense latent cache (B, S, lora) / (B, S, rope) seen as a pool for
    the paged kernel: it already has the pool layout (N = B rows of one
    page of S lanes), so only the table ``pages[b, 0] = b`` is new."""
    pages = torch.arange(ckv.shape[0], dtype=torch.int32, device=ckv.device)[:, None]
    return ckv, krope, pages


def mla_smem_bytes(group: int, lora: int, rope: int, seq: int, n_pages: int) -> int:
    """Dynamic shared memory of one f32 MLA block: the per-warp reduction
    scratch, the group's f32 query rows [q_lat | q_rope], the (seq, group)
    f32 scores and the slot's page row."""
    return 4 * (MLA_THREADS // 32 * MLA_MAX_GROUP + group * (lora + rope) + seq * group + n_pages)


def mla_group(h: int, lora: int, rope: int, seq: int, n_pages: int) -> int:
    """Query heads per f32 block: the largest power of two up to
    ``MLA_MAX_GROUP`` that divides ``h`` and whose block fits in shared
    memory (16 at h = 128 and 512 lanes, 8 at 4096).  0 when not even
    one head fits."""
    fits = [g for g in (16, 8, 4, 2, 1)
            if h % g == 0 and mla_smem_bytes(g, lora, rope, seq, n_pages) <= SMEM_LIMIT]
    return fits[0] if fits else 0


def mla_split_lanes(B: int, head_blocks: int, S: int, sms: int) -> int:
    """Lanes a split of the bf16 MLA kernel takes, a multiple of its
    64-lane tile (``SPLIT_QUANTUM``): the most splits, a power of two,
    that keep the grid (B, head_blocks, splits) within one wave (a block
    fills an SM's shared memory) and leave each split at least two tiles
    (the next tile's copy overlaps this one's products).  4 splits of 128
    lanes at DeepSeek's B = 8, h = 128 (2 head blocks), S = 512 on 132
    SMs, 8 of 512 at S = 4096: the fastest of the split sweep in
    ``chip_smoke.py`` phase 2f at both lengths.  A function of S, not of
    the page size."""
    quanta = -(-S // SPLIT_QUANTUM)
    n = 1
    while 4 * n <= quanta and B * head_blocks * 2 * n <= sms:
        n *= 2
    return SPLIT_QUANTUM * -(-quanta // n)


#: most splits of K6's partials kernel (``csrc/paged_mla_partials.cu``):
#: one thread-block cluster of the portable size merges them.  The split
#: sweep of ``chip_smoke.py`` phase 9 (``MLA_SWEEP``; PERF.md section 6):
#: a tile's walk costs a block about 4.6 us and the cluster's merge about
#: 4 us, and the most splits win at every length swept: two one-tile
#: splits at 128 lanes by 0.3-0.55 us of 13 in each of four calls, 3 at 192
#: lanes 0.0130 ms against 0.0180 for one block, 8 at 512 lanes 0.0133
#: against 0.0172 for 4
MLA_MAX_CLUSTER = 8


def mla_partials_plan(S: int) -> PartialsPlan:
    """K6's partials kernel over S lanes: the most splits of whole 64-lane
    tiles, up to ``MLA_MAX_CLUSTER``, all in one cluster.  It reads neither
    the batch nor the SM count, so a row gives the same bits at any batch
    index and in a call of any B, and split boundaries sit at multiples of
    ``SPLIT_QUANTUM`` from lane 0, so a dense view and a paged pool of the
    same lanes give the same bits.  Two splits of 64 lanes at 9c's and
    12d's 128-lane members, one at 12d's 4-lane pages, 8 of 64 at 512
    lanes, 8 of 512 at 4096."""
    tiles = -(-S // SPLIT_QUANTUM)
    lanes = SPLIT_QUANTUM * -(-tiles // MLA_MAX_CLUSTER)
    return PartialsPlan("tc", lanes, -(-S // lanes))


@functools.cache
def _mla_lib() -> ctypes.CDLL:
    lib = build.load("paged_mla_decode")
    lib.paged_mla_decode_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_size_t, ctypes.c_void_p]
    lib.paged_mla_decode_bf16.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.paged_mla_partials_f32.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_size_t, ctypes.c_void_p]
    for fn in (lib.paged_mla_decode_f32, lib.paged_mla_decode_bf16, lib.paged_mla_partials_f32):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _mla_partials_lib() -> ctypes.CDLL:
    lib = build.load("paged_mla_partials")
    lib.paged_mla_partials_tc.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.paged_mla_partials_tc_empty.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.paged_mla_partials_tc, lib.paged_mla_partials_tc_empty):
        fn.restype = ctypes.c_int
    return lib


#: what ``csrc/paged_mla_partials.cu`` returns when no cluster of the
#: plan's size can be resident on the card
NO_CLUSTER = -1


def _check_mla(q_lat, q_rope, ckv_pool, krope_pool, pages, pos) -> None:
    if q_lat.dim() != 3 or q_rope.dim() != 3 or ckv_pool.dim() != 3 or krope_pool.dim() != 3:
        raise ValueError(
            "q_lat / q_rope must be (B,h,lora) / (B,h,rope) and the pools (N,ps,lora) / "
            f"(N,ps,rope); got {tuple(q_lat.shape)}, {tuple(q_rope.shape)}, "
            f"{tuple(ckv_pool.shape)}, {tuple(krope_pool.shape)}")
    B, h, lora = q_lat.shape
    N, ps, lora2 = ckv_pool.shape
    rope = q_rope.shape[-1]
    if q_rope.shape[:2] != (B, h) or lora2 != lora or krope_pool.shape != (N, ps, rope):
        raise ValueError(
            f"shapes do not match: q_lat {tuple(q_lat.shape)}, q_rope {tuple(q_rope.shape)}, "
            f"ckv {tuple(ckv_pool.shape)}, krope {tuple(krope_pool.shape)}")
    if pages.dim() != 2 or pages.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(f"pages must be (B,P) and pos (B,) for B={B}")
    if min(B, h, N, ps, lora, rope, pages.shape[1]) < 1:
        raise ValueError("empty input")
    if lora % 8 or rope % 8:
        raise ValueError(f"lora {lora} and rope {rope} must be multiples of 8 (16-byte row loads)")
    if q_lat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q_lat dtype {q_lat.dtype}: the kernel takes float32 or bfloat16")
    if any(t.dtype != q_lat.dtype for t in (q_rope, ckv_pool, krope_pool)):
        raise TypeError("the queries and the pools must share one dtype")
    if pages.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("pages and pos must be int32")
    tensors = (q_lat, q_rope, ckv_pool, krope_pool, pages, pos)
    if any(t.device != q_lat.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors[:4]):
        raise ValueError("the kernel reads 16-byte rows: the queries and pools must be 16-byte aligned")
    if q_lat.dtype == torch.bfloat16:
        if lora > MLA_MAX_LORA or rope > MLA_MAX_ROPE:
            raise ValueError(f"the bf16 kernel takes lora <= {MLA_MAX_LORA} and rope <= "
                             f"{MLA_MAX_ROPE}, not {lora} / {rope}")
        return
    smem = mla_smem_bytes(1, lora, rope, pages.shape[1] * ps, pages.shape[1])
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{smem} bytes of shared memory for one head (max_len {pages.shape[1] * ps}) exceed "
            f"the {SMEM_LIMIT} a Hopper block of the f32 kernel can use")


def paged_mla_attention(q_lat, q_rope, ckv_pool, krope_pool, pages, pos, *, scale: float) -> torch.Tensor:
    """Absorbed-MLA single-query attention reading the latent cache
    through a page table.

    q_lat (B, h, lora) latent-absorbed query; q_rope (B, h, rope); pools
    (N, ps, lora) / (N, ps, rope), or a ``dense_mla_view``; pages (B, P)
    int32, -1 = unmapped; pos (B,) int32.  Returns the f32 latent context
    (B, h, lora).  CPU tensors take ``paged_mla_plain``; CUDA tensors
    launch the kernel on the current stream (bf16: the tensor-core
    kernel; f32: the CUDA-core kernel)."""
    if q_lat.device.type == "cpu":
        return paged_mla_plain(q_lat, q_rope, ckv_pool, krope_pool, pages, pos, scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"paged_mla_attention runs on cuda or cpu, not {q_lat.device}")
    _check_mla(q_lat, q_rope, ckv_pool, krope_pool, pages, pos)
    B, h, lora = q_lat.shape
    N, ps, _ = ckv_pool.shape
    rope, P = q_rope.shape[-1], pages.shape[1]
    lib = _mla_lib()
    out = torch.empty((B, h, lora), dtype=torch.float32, device=q_lat.device)
    ptrs = [t.data_ptr() for t in (q_lat, q_rope, ckv_pool, krope_pool, pages, pos, out)]
    stream = torch.cuda.current_stream(q_lat.device).cuda_stream
    with torch.cuda.device(q_lat.device):  # the C launch uses the current device
        if q_lat.dtype == torch.float32:
            G = mla_group(h, lora, rope, P * ps, P)
            err = lib.paged_mla_decode_f32(*ptrs, B, h, lora, rope, ps, P, N, G, float(scale),
                                           mla_smem_bytes(G, lora, rope, P * ps, P), stream)
        else:
            split_lanes = mla_split_lanes(B, -(-h // MLA_HEADS), P * ps,
                                          build.sm_count(q_lat.device.index))
            n_split = -(-P * ps // split_lanes)
            # per split and query head: the unnormalised f32 context, then (m, l)
            part = torch.empty(B * h * n_split * (lora + 2), dtype=torch.float32,
                               device=q_lat.device)
            err = lib.paged_mla_decode_bf16(*ptrs, part.data_ptr(), B, h, lora, rope, ps, P, N,
                                            split_lanes, float(scale), stream)
    if err:
        raise RuntimeError(f"paged_mla_decode launch failed: cudaError {err}")
    paged_mla_attention.launches += 1
    return out


paged_mla_attention.launches = 0


def paged_mla_partials_plain(q_lat, q_rope, ckv_pool, krope_pool, pages, pos, *, scale: float):
    """The plain version of ``paged_mla_partials``: the JAX package's
    member math of its sequence-sharded MLA decode
    (``repro/distributed/decode.py::mla_decode``'s body) over the gathered
    pages: f32 scores ``(q_lat . ckv + q_rope . krope) * scale`` on the
    lanes of mapped pages at or before ``pos``, their max ``m`` (B, h),
    ``l = sum exp(s - m)`` (B, h) and ``acc = sum exp(s - m) ckv`` (B, h,
    lora); a row with no valid lane gives m = -inf, l = 0, acc = 0."""
    valid = paged_valid(pages, pos, ckv_pool.shape[1])[:, None, :]
    ckv = paged_gather_lanes(ckv_pool, pages).float()
    s = torch.einsum("bhl,btl->bht", q_lat.float(), ckv)
    s = s + torch.einsum("bhr,btr->bht", q_rope.float(),
                         paged_gather_lanes(krope_pool, pages).float())
    s = torch.where(valid, s * scale, -torch.inf)
    m = s.amax(dim=-1)
    e = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return torch.einsum("bht,btl->bhl", e, ckv), m, e.sum(dim=-1)


def paged_mla_partials(q_lat, q_rope, ckv_pool, krope_pool, pages, pos, *, scale: float):
    """Absorbed-MLA single-query attention over a page table as a
    flash-decoding partial: ``(acc (B,h,lora) f32, m (B,h) f32, l (B,h)
    f32)``, the unnormalised latent context, the scores' max (natural
    units) and the softmax sum over the valid lanes (``acc / l`` is
    ``paged_mla_attention``'s output where a lane is valid).  The inputs
    are ``paged_mla_attention``'s (a pool or a ``dense_mla_view``); ``pos``
    may be negative, and a row without a valid lane gives the empty
    partial m = -inf, l = 0, acc = 0 (not the whole-slot kernel's uniform
    mean).  bf16: ``csrc/paged_mla_partials.cu`` along
    ``mla_partials_plan``, one launch whose splits merge in a thread-block
    cluster; f32: the CUDA-core kernel's partials epilogue.  CPU tensors
    take ``paged_mla_partials_plain``; CUDA tensors launch the kernel on
    the current stream."""
    if q_lat.device.type == "cpu":
        return paged_mla_partials_plain(q_lat, q_rope, ckv_pool, krope_pool, pages, pos,
                                        scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"paged_mla_partials runs on cuda or cpu, not {q_lat.device}")
    _check_mla(q_lat, q_rope, ckv_pool, krope_pool, pages, pos)
    S = pages.shape[1] * ckv_pool.shape[1]
    if q_lat.dtype == torch.bfloat16:
        return launch_mla_partials(mla_partials_plan(S), q_lat, q_rope, ckv_pool, krope_pool,
                                   pages, pos, scale=scale)
    B, h, lora = q_lat.shape
    N, ps, _ = ckv_pool.shape
    rope, P = q_rope.shape[-1], pages.shape[1]
    acc, m, l = _mla_partials_out(B, h, lora, q_lat.device)
    ptrs = [t.data_ptr() for t in (q_lat, q_rope, ckv_pool, krope_pool, pages, pos, acc, m, l)]
    G = mla_group(h, lora, rope, S, P)
    with torch.cuda.device(q_lat.device):  # the C launch uses the current device
        err = _mla_lib().paged_mla_partials_f32(
            *ptrs, B, h, lora, rope, ps, P, N, G, float(scale), mla_smem_bytes(G, lora, rope, S, P),
            torch.cuda.current_stream(q_lat.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_mla_partials launch failed: cudaError {err}")
    paged_mla_partials.launches += 1
    return acc, m, l


def _mla_partials_out(B: int, h: int, lora: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return torch.empty((B, h, lora), **f32), torch.empty((B, h), **f32), torch.empty((B, h), **f32)


def launch_mla_partials(plan: PartialsPlan, q_lat, q_rope, ckv_pool, krope_pool, pages, pos, *,
                        scale: float):
    """One launch of K6's bf16 partials kernel along ``plan`` on inputs
    ``paged_mla_partials`` has checked; ``paged_mla_partials`` passes
    ``mla_partials_plan``'s, and ``chip_smoke.py`` times every split count
    through it.  Raises when the launch fails or no cluster of the plan's
    size fits the card.  Counts the launch on
    ``paged_mla_partials.launches``."""
    if q_lat.dtype != torch.bfloat16:
        raise TypeError("K6's partials kernel on the tensor cores takes bfloat16")
    B, h, lora = q_lat.shape
    N, ps, _ = ckv_pool.shape
    rope, P = q_rope.shape[-1], pages.shape[1]
    acc, m, l = _mla_partials_out(B, h, lora, q_lat.device)
    ptrs = [t.data_ptr() for t in (q_lat, q_rope, ckv_pool, krope_pool, pages, pos, acc, m, l)]
    with torch.cuda.device(q_lat.device):  # the C launch uses the current device
        err = _mla_partials_lib().paged_mla_partials_tc(
            *ptrs, B, h, lora, rope, ps, P, N, plan.split_lanes, float(scale),
            torch.cuda.current_stream(q_lat.device).cuda_stream)
    if err == NO_CLUSTER:
        raise RuntimeError(f"paged_mla_partials: no cluster of {plan.cluster} blocks of the "
                           "partials kernel can be resident on this card")
    if err:
        raise RuntimeError(f"paged_mla_partials launch failed: cudaError {err}")
    paged_mla_partials.launches += 1
    return acc, m, l


def mla_partials_empty_launch(plan: PartialsPlan, B: int, h: int, S: int) -> None:
    """The launch floor of K6's partials kernel: an empty kernel with
    ``plan``'s grid, cluster and shared memory for B slots of h query
    heads over S lanes, on the current device and stream.  For
    ``chip_smoke.py``'s timing; counts no launch."""
    err = _mla_partials_lib().paged_mla_partials_tc_empty(
        B, h, S, plan.split_lanes, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"paged_mla_partials_tc_empty launch failed: cudaError {err}")


paged_mla_partials.launches = 0


# --------------------------------------------------------------------------
# dense-cache decode: the pieces the model's layers and the sharded decode
# (``distributed/decode.py``) share
# --------------------------------------------------------------------------
def dense_decode_on_card(device: torch.device) -> bool:
    """Does dense decode on ``device`` run the paged kernels?  True on a
    card, False on the CPU (plain torch)."""
    return device.type == "cuda"


def ring_lane_pos(pos: torch.Tensor, S: int) -> torch.Tensor:
    """The lane bound the kernels mask a dense cache of ``S`` lanes by:
    lanes ``0..min(pos, S-1)``.  A sliding window's ring holds S =
    min(max_len, window) lanes written at ``pos % S``, so once the write
    of ``pos`` has landed, the lanes ``slot_pos`` selects (filled, at most
    ``pos``, inside the window) are exactly these; a full cache never
    reaches ``pos > S-1``."""
    return pos.clamp(max=S - 1)


def gate(active, new, old):
    """The serving slot mask on a decode write: an inactive slot (``active``
    False) keeps its old bytes."""
    if active is None:
        return new
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def dense_mla_decode(q_lat, q_rope, ckv_new, krope_new, cache, pos, *, active, scale: float):
    """One absorbed-MLA decode step over a dense latent cache: q_lat (B,
    h, lora), q_rope (B, h, rope); the new lane ``ckv_new`` (B, lora) /
    ``krope_new`` (B, rope) written INTO ``cache`` {"ckv" (B, S, lora),
    "krope" (B, S, rope), "slot_pos" (B, S)} at ``pos % S`` (``active``
    gates it), then attention: on a card K6 over the cache read in place
    (``dense_mla_view``), on the CPU the JAX package's math masked by
    ``slot_pos`` (``attend_mla``).  Returns the f32 latent context (B, h,
    lora)."""
    B = q_lat.shape[0]
    slot = pos % cache["ckv"].shape[1]
    bidx = torch.arange(B, device=q_lat.device)
    for key, new in (("ckv", ckv_new), ("krope", krope_new), ("slot_pos", pos)):
        cache[key][bidx, slot] = gate(active, new.to(cache[key].dtype), cache[key][bidx, slot])
    if dense_decode_on_card(q_lat.device):
        return paged_mla_attention(q_lat.contiguous(), q_rope.contiguous(),
                                   *dense_mla_view(cache["ckv"], cache["krope"]),
                                   pos.contiguous(), scale=scale)
    valid = (cache["slot_pos"] >= 0) & (cache["slot_pos"] <= pos[:, None])
    return attend_mla(q_lat, q_rope, cache["ckv"], cache["krope"], valid, scale)
