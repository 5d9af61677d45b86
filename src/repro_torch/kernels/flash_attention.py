"""Blocked (flash) attention: the wrapper of the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention`` (TPU).  Semantics, shared by kernel and plain version:
q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), query head h reads kv head
``h // (Hq / Hkv)``; f32 scores ``(q * scale) . k`` with ``scale =
D**-0.5`` by default; query row i sits at absolute position ``i +
q_offset``; ``causal`` masks keys after the query, ``window`` keys at or
before ``query - window``; a row with no visible key is 0; f32
accumulation, output in q's dtype.  Ragged Sq/Sk are fine (the Pallas
wrapper asserts divisibility by its blocks).

``flash_attention`` takes the plain version for CPU tensors only; a CUDA
tensor reaches the kernel or an exception.  ``launches`` on the wrapper
counts kernel launches.  bf16 runs on the tensor cores (TMA copies,
``wgmma`` products) at a head-dim instance of 64, 128 or 256 (D
zero-padded up to it) with 1 or 2 warpgroups of 64 query rows a block
(``plan``); f32 keeps the CUDA-core kernel, whose shared memory bounds D.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: dynamic shared memory one block of the kernel may use on Hopper
SMEM_LIMIT = 232448
#: query rows and key rows per tile of the f32 kernel
BLOCK_Q, BLOCK_K = 32, 64
#: head-dim instances of the bf16 (tensor-core) kernel
BF16_HEAD_DIMS = (64, 128, 256)


def attention_plain(q, k, v, *, causal=True, window=None, scale=None, q_offset=0):
    """The plain version: materialised-scores softmax attention
    (``repro/kernels/ref.py::attention_ref``)."""
    B, Hq, Sq, D = q.shape
    G = Hq // k.shape[1]
    scale = (D**-0.5) if scale is None else scale
    qf = q.float() * scale
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((Sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    # fully masked rows -> zeros, not NaN
    probs = torch.where(mask.any(-1)[:, None], probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)


def smem_bytes(D: int) -> int:
    """Dynamic shared memory of one block of the f32 kernel: the scaled Q
    tile, the K tile (row stride D + 1), the V tile, the scores, the
    accumulator, and the running max, sum and rescale of each row."""
    return 4 * (BLOCK_Q * D + BLOCK_K * (D + 1) + BLOCK_K * D + BLOCK_Q * BLOCK_K
                + BLOCK_Q * D + 3 * BLOCK_Q)


def plan(B: int, Hq: int, Sq: int, D: int, sms: int) -> tuple[int, int]:
    """The bf16 kernel's (head-dim instance, warpgroups per block): the
    smallest instance that holds D, and 2 warpgroups (128 query rows a
    block) unless that would give fewer blocks than the card has SMs."""
    inst = next((d for d in BF16_HEAD_DIMS if D <= d), None)
    if inst is None:
        raise ValueError(f"head dimension {D}: the bf16 kernel takes at most {BF16_HEAD_DIMS[-1]}")
    return inst, 2 if B * Hq * -(-Sq // 128) >= sms else 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    head = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3
    lib.flash_attention_f32.argtypes = head + [ctypes.c_size_t, ctypes.c_void_p]
    lib.flash_attention_bf16.argtypes = head + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.flash_attention_f32, lib.flash_attention_bf16):
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B,Hq,Sq,D) and k/v (B,Hkv,Sk,D); got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    if v.shape != k.shape or k.shape[0] != B or Dk != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if min(B, Hq, Sq, Sk, D) < 1:
        raise ValueError("empty input")
    if window is not None and window < 1:
        raise ValueError(f"window {window} must be at least 1")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dtype == torch.bfloat16 and D > BF16_HEAD_DIMS[-1]:
        raise ValueError(f"head dimension {D}: the bf16 kernel takes at most {BF16_HEAD_DIMS[-1]}")
    if q.dtype == torch.float32 and smem_bytes(D) > SMEM_LIMIT:
        raise ValueError(f"head dimension {D}: {smem_bytes(D)} bytes of shared memory exceed "
                         f"the {SMEM_LIMIT} a Hopper block can use")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all inputs must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None, q_offset=0):
    """Blocked online-softmax attention.  q (B, Hq, Sq, D); k, v (B, Hkv,
    Sk, D).  Returns (B, Hq, Sq, D) in q's dtype.  CPU tensors take
    ``attention_plain``, which autograd differentiates; CUDA tensors launch
    the kernel on the current stream, which has no backward: with grad
    enabled and an input that requires grad it raises."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window, scale=scale,
                               q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the ctypes launch is invisible to autograd (no grad_fn on out)
        raise RuntimeError("K7 has no backward on the card yet; see ROADMAP.  Run it under "
                           "torch.no_grad(), or train on the CPU")
    _check(q, k, v, window)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = (D**-0.5) if scale is None else scale
    lib = _lib()
    if q.dtype == torch.bfloat16 and (D % 8 or any(t.data_ptr() % 16 for t in (q, k, v))):
        # the kernel's tensor maps need rows of whole 16 bytes and 16-byte
        # aligned bases: zero-padded copies (the zeros add nothing to q . k)
        q, k, v = (torch.nn.functional.pad(t, (0, -D % 8)) for t in (q, k, v))
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Sk,
            q.shape[-1], float(scale), int(causal), 0 if window is None else int(window),
            int(q_offset))
    with torch.cuda.device(q.device):  # the C launch uses the current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.float32:
            err = lib.flash_attention_f32(*args, smem_bytes(D), stream)
        else:
            head_dim, warpgroups = plan(B, Hq, Sq, D, build.sm_count(q.device.index))
            err = lib.flash_attention_bf16(*args, head_dim, warpgroups, stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out if out.shape[-1] == D else out[..., :D].contiguous()


flash_attention.launches = 0
