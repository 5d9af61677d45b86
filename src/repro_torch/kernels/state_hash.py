"""The flat-stream state fingerprint (K3): the wrapper of the CUDA kernel
in ``csrc/redundancy_epilogue.cu``, its plain PyTorch version, and the
u32 arithmetic every fingerprint of this package uses.

Replaces the Pallas kernel ``repro/kernels/state_hash.py::state_hash``
(TPU) and its oracle ``repro/kernels/ref.py::state_hash_ref``.  Over a
flat stream of u32 words v[0..n) (held in an ``int32`` tensor), with the
global word index i and all arithmetic mod 2**32:

    w_i = i * MIX + PHI
    h1  = sum v_i * w_i          h2 = sum (v_i ^ w_i) * MIX
    h3  = xor v_i ^ (w_i * PHI)  h4 = sum (v_i + w_i) ^ (v_i >> 7)

This is NOT ``core.redundancy.fingerprint``, the per-leaf fingerprint
whose h3 is an FNV-weighted sum: the two definitions differ and each is
held bitwise to its own JAX counterpart.  The result depends only on the
stream: the TPU kernel's block size is a tiling of the same sums, so
``state_hash`` equals the JAX kernel's output for any of its blocks.

Streams and fingerprints are ``int32`` tensors holding u32 bits.  The
plain version computes in int64 masked with ``& 0xFFFFFFFF``, because
the CPU build of torch has no uint32 ``+``, ``>>`` or ``.sum()``.
``state_hash`` takes the plain version for CPU tensors only; a CUDA
tensor reaches the kernel or an exception.  ``launches`` on the wrapper
counts kernel launches.

The ctypes binding of the four epilogue kernels (K1-K4) lives here too;
``tmr_vote`` and ``fused_step`` launch through it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

M32 = 0xFFFFFFFF
PHI = 0x9E3779B9
MIX = 2654435761


def mul32(a, b):
    """``a * b mod 2**32`` for int64 operands in [0, 2**32): split ``a``
    into 16-bit halves so no partial product leaves int64."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & M32


def to_u32(v: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 in [0, 2**32) holding the same bits."""
    return v.to(torch.int64) & M32


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 holding the same bits."""
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


def xor_fold(x: torch.Tensor) -> torch.Tensor:
    """xor of all elements of a 1-D int64 tensor (0 when empty): pairwise
    halving, n words of work."""
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        half = x.numel() // 2
        x = x[:half] ^ x[half:]
    return x.sum()


def fingerprint_u32(v: torch.Tensor, start: int = 0) -> torch.Tensor:
    """(4,) int64 fingerprint of a 1-D int64 stream of u32 values whose
    first word sits at global index ``start`` (a segment of a longer
    stream: the segments' sums add and their h3 xor)."""
    i = (torch.arange(v.numel(), dtype=torch.int64, device=v.device) + start) & M32
    w = (mul32(i, MIX) + PHI) & M32
    h1 = mul32(v, w).sum() & M32
    h2 = mul32(v ^ w, MIX).sum() & M32
    h3 = xor_fold(v ^ mul32(w, PHI))
    h4 = (((v + w) & M32) ^ (v >> 7)).sum() & M32
    return torch.stack([h1, h2, h3, h4])


def state_hash_plain(v: torch.Tensor) -> torch.Tensor:
    """The plain version: (4,) int32 fingerprint of an int32 word stream
    (``repro/kernels/ref.py::state_hash_ref``)."""
    return from_u32(fingerprint_u32(to_u32(v.reshape(-1))))


# --------------------------------------------------------------------------
# the CUDA binding shared by K1-K4
# --------------------------------------------------------------------------
class Seg(ctypes.Structure):
    """One segment of a word stream, as the kernels' C interface takes it:
    n words at global index ``off``, word k of replica r at ``inp[r][k]``
    (``inp[0]`` null: zeros), the voted word k to each non-null
    ``out[r][k]``."""

    _fields_ = [("inp", ctypes.c_void_p * 3), ("out", ctypes.c_void_p * 3),
                ("n", ctypes.c_ulonglong), ("off", ctypes.c_ulonglong)]


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import build

    lib = build.load("redundancy_epilogue")
    for name in ("state_hash_u32", "tmr_vote_u32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in ("dmr_compare_segs", "tmr_step_segs"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def on_cpu(kernel: str, streams) -> bool:
    """True when the streams lie on the CPU (the plain version runs);
    False for CUDA streams the kernel takes.  Raises on anything else:
    another device, mixed devices, a shape, dtype or layout the kernel
    does not take."""
    dev, n = streams[0].device, streams[0].shape
    for s in streams:
        if s.device != dev:
            raise ValueError(f"{kernel}: all streams must be on one device")
        if s.dim() != 1 or s.shape != n:
            raise ValueError(f"{kernel}: streams must be 1-D of one length, got {tuple(s.shape)}")
        if s.dtype != torch.int32:
            raise TypeError(f"{kernel}: streams hold u32 words as int32, got {s.dtype}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, not {dev}")
    if not all(s.is_contiguous() for s in streams):
        raise ValueError(f"{kernel}: the kernel takes contiguous streams")
    return False


def launch(kernel: str, streams, voted, n_out: int) -> torch.Tensor:
    """Launch ``<kernel>_u32`` (K3, K4) on the current stream over 1 or 3
    int32 word streams (``voted``: the output stream, or None).  Returns the
    kernel's ``n_out`` output words (the C side zeroes them before
    accumulating)."""
    dev = streams[0].device
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    ptrs = [s.data_ptr() for s in streams] + [None] * (3 - len(streams))
    fn = getattr(_lib(), f"{kernel}_u32")
    with torch.cuda.device(dev):  # the C launch uses the current device
        err = fn(
            *ptrs,
            None if voted is None else voted.data_ptr(),
            streams[0].numel(),
            out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    return out


def launch_segments(kernel: str, segs, device, n_out: int) -> torch.Tensor:
    """Launch ``<kernel>_segs`` (K1, K2) on the current stream over a
    stream given as a ctypes array of ``Seg`` (``fused_step.plan_segments``
    builds it).  Returns the kernel's ``n_out`` output words (the C side
    zeroes them before accumulating)."""
    out = torch.empty(n_out, dtype=torch.int32, device=device)
    fn = getattr(_lib(), f"{kernel}_segs")
    with torch.cuda.device(device):  # the C launch uses the current device
        err = fn(ctypes.addressof(segs), len(segs), out.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    return out


def state_hash(v: torch.Tensor) -> torch.Tensor:
    """(4,) int32 fingerprint (u32 bits) of a 1-D int32 word stream in
    one pass.  CPU tensors take ``state_hash_plain``; CUDA tensors launch
    the kernel on the current stream."""
    if on_cpu("state_hash", [v]):
        return state_hash_plain(v)
    out = launch("state_hash", [v], None, 4)
    state_hash.launches += 1
    return out


state_hash.launches = 0
