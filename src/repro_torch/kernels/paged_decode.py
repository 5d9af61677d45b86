"""Paged single-query GQA decode attention: the wrapper of the CUDA kernel
``csrc/paged_gqa_decode.cu`` and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/paged_decode.py::
paged_gqa_attention`` (TPU).  Each slot's K/V bytes live in fixed-size
pages of one shared pool; the per-slot page table maps logical page ->
pool row (-1 = unmapped).  Semantics, shared by kernel and plain version:

  * unmapped pages read as zero lanes and are masked; a page row past
    the pool's end reads the pool's last row (the gather clamps, as the
    JAX reference does);
  * lanes past ``pos`` are masked;
  * scores are f32, ``q * scale`` dotted with K, ``scale = Dk**-0.5``;
  * a full f32 softmax over all ``P * ps`` lanes (masked lanes hold
    ``NEG_INF = -1e30``, which is finite: a row with no valid lane gets
    the mean of its gathered V lanes, 0 when no page is mapped), then
    P.V in f32, cast to ``q.dtype``.

``paged_gqa_attention`` takes the plain version for CPU tensors only; a
CUDA tensor reaches the kernel or an exception.  ``launches`` on the
wrapper counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30

#: dynamic shared memory one block of the kernel may use on Hopper
SMEM_LIMIT = 232448
#: largest query-group size (Hq / Hkv) the kernel's register tiles hold
MAX_GROUP = 8


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


def paged_gqa_plain(q, k_pool, v_pool, pages, pos, *, scale=None) -> torch.Tensor:
    """The plain version: gather pages in logical order, then ``attend``
    (``repro/kernels/ref.py::paged_gqa_ref``)."""
    Dk, ps = q.shape[-1], k_pool.shape[2]
    scale = (Dk**-0.5) if scale is None else scale
    lane = torch.arange(pages.shape[1] * ps, device=q.device)
    mapped = (pages >= 0).repeat_interleave(ps, dim=1)
    valid = mapped & (lane[None, :] <= pos[:, None])
    return attend(q, paged_gather(k_pool, pages), paged_gather(v_pool, pages), valid, scale)


def smem_bytes(group: int, head_dim: int, seq: int, n_pages: int) -> int:
    """Dynamic shared memory of one block: reduction scratch, the scaled
    query group, the (group, seq) f32 scores and the slot's page row."""
    return 4 * (32 + group * head_dim + group * seq + n_pages)


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import build

    lib = build.load("paged_gqa_decode")
    for fn in (lib.paged_gqa_decode_f32, lib.paged_gqa_decode_bf16):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
            ctypes.c_float,
            ctypes.c_size_t,
            ctypes.c_void_p,
        ]
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
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}, at most {MAX_GROUP}x")
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
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    smem = smem_bytes(Hq // Hkv, Dk, pages.shape[1] * ps, pages.shape[1])
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{smem} bytes of shared memory (max_len {pages.shape[1] * ps}) "
            f"exceed the {SMEM_LIMIT} a Hopper block can use"
        )


def paged_gqa_attention(q, k_pool, v_pool, pages, pos, *, scale=None) -> torch.Tensor:
    """Single-query GQA attention reading K/V through a page table.

    q (B, Hq, Dk); pools (N, Hkv, ps, Dk); pages (B, P) int32, -1 =
    unmapped; pos (B,) int32.  Returns (B, Hq, Dk) in q.dtype.  CPU
    tensors take ``paged_gqa_plain``; CUDA tensors launch the kernel on
    the current stream."""
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
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):  # the C launch uses the current device
        err = fn(
            q.data_ptr(),
            k_pool.data_ptr(),
            v_pool.data_ptr(),
            pages.data_ptr(),
            pos.data_ptr(),
            out.data_ptr(),
            B,
            Hq,
            Hkv,
            Dk,
            ps,
            P,
            N,
            float(scale),
            smem_bytes(Hq // Hkv, Dk, P * ps, P),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"paged_gqa_decode launch failed: cudaError {err}")
    paged_gqa_attention.launches += 1
    return out


paged_gqa_attention.launches = 0
