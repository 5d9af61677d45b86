"""Mamba2 SSD chunked scan: the wrapper of the CUDA kernel
``csrc/ssd_scan.cu`` and its plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan`` (TPU).
Computes ``y_t = C_t . h_t`` with ``h_t = exp(dt_t a) h_{t-1} + dt_t B_t
x_t^T`` in chunks of ``Q = min(chunk, L)`` steps, in f32:

  * ``cum = cumsum(dt * a)`` within the chunk;
  * intra-chunk ``y = ((C B^T) o exp(cum_i - cum_j)[j <= i] o dt_j) X``,
    the exponential taken only where ``j <= i``;
  * inter-chunk ``y += exp(cum_i) C_i . S``;
  * ``S <- exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T``.

Head ``h`` reads B/C group ``h // (H / G)``.  Any ``L``: the last chunk is
padded with ``dt = 0`` and ``x = B = C = 0``, which leaves the state and
the real rows exact (the Pallas kernel asserts ``L % chunk == 0``; its
reference ``ssd_ref`` has no such limit).  Returns ``y`` (B, L, H, P) in
x's dtype and the final state (B, H, N, P) f32; ``h0`` is the initial
state.

``ssd_scan`` takes the plain version for CPU tensors only; a CUDA tensor
reaches the kernel or an exception.  ``launches`` on the wrapper counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

#: dynamic shared memory one block of the kernel may use on Hopper
SMEM_LIMIT = 232448
#: rows of the intra-chunk weight matrix the kernel builds at a time
ROW_TILE = 32


def ssd_scan_plain(x, dt, a, b, c, *, h0=None, chunk: int = 128):
    """The plain version: the kernel's chunked arithmetic in torch, f32."""
    Bsz, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    Q = min(chunk, L)
    n_chunks = -(-L // Q)
    pad = n_chunks * Q - L

    def chunks(t):  # (B, L, ...) -> f32 (B, n_chunks, Q, ...), zero-padded
        t = t.float()
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, n_chunks, Q, *t.shape[2:])

    xf = chunks(x)
    dtf = chunks(dt)
    bf = chunks(b.repeat_interleave(rep, dim=2))  # (B, nc, Q, H, N)
    cf = chunks(c.repeat_interleave(rep, dim=2))
    cum = torch.cumsum(dtf * a.float(), dim=2)  # (B, nc, Q, H)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    S = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for ci in range(n_chunks):
        X, dtc, Bc, Cc, cc = xf[:, ci], dtf[:, ci], bf[:, ci], cf[:, ci], cum[:, ci]
        diff = (cc[:, :, None, :] - cc[:, None, :, :]).masked_fill(~tril[None, :, :, None], 0.0)
        decay = torch.exp(diff).masked_fill(~tril[None, :, :, None], 0.0)  # (B, Qi, Qj, H)
        w = torch.einsum("bihn,bjhn->bijh", Cc, Bc) * decay * dtc[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", w, X)
        y = y + torch.exp(cc)[..., None] * torch.einsum("bihn,bhnp->bihp", Cc, S)
        last = cc[:, -1]  # (B, H)
        wlast = torch.exp(last[:, None, :] - cc) * dtc  # (B, Q, H)
        S = torch.exp(last)[:, :, None, None] * S + torch.einsum(
            "bjhn,bjhp->bhnp", Bc * wlast[..., None], X)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :L]
    return y.to(x.dtype), S


def smem_bytes(Q: int, P: int, N: int) -> int:
    """Dynamic shared memory of one block: the chunk's x, B (row stride
    N + 1), C, the carried state, one row tile of W, and dt, cum and the
    two decay vectors."""
    return 4 * (Q * P + Q * (N + 1) + Q * N + N * P + min(ROW_TILE, Q) * Q + 4 * Q)


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import build

    lib = build.load("ssd_scan")
    for fn in (lib.ssd_scan_f32, lib.ssd_scan_bf16):
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_size_t, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, dt, a, b, c, h0, chunk) -> None:
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"x must be (B,L,H,P) and b/c (B,L,G,N); got {tuple(x.shape)}, {tuple(b.shape)}")
    Bsz, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if tuple(b.shape[:2]) != (Bsz, L) or c.shape != b.shape:
        raise ValueError(f"b {tuple(b.shape)} / c {tuple(c.shape)} do not match x {tuple(x.shape)}")
    if tuple(dt.shape) != (Bsz, L, H) or tuple(a.shape) != (H,):
        raise ValueError(f"dt must be (B,L,H) and a (H,) for x {tuple(x.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"H={H} must be a multiple of G={G}")
    if min(Bsz, L, H, P, N, chunk) < 1:
        raise ValueError("empty input")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or bfloat16")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("x, b and c must share one dtype")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("dt and a must be float32")
    tensors = [x, dt, a, b, c]
    if h0 is not None:
        if tuple(h0.shape) != (Bsz, H, N, P) or h0.dtype != torch.float32:
            raise ValueError(f"h0 must be float32 (B,H,N,P) = {(Bsz, H, N, P)}")
        tensors.append(h0)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    smem = smem_bytes(min(chunk, L), P, N)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{smem} bytes of shared memory exceed the {SMEM_LIMIT} a Hopper block can use")


def ssd_scan(x, dt, a, b, c, *, h0=None, chunk: int = 128):
    """The SSD chunked scan.  x (B, L, H, P); dt (B, L, H) f32; a (H,) f32;
    b, c (B, L, G, N); h0 (B, H, N, P) f32 or None.  Returns (y in x's
    dtype, final state f32).  CPU tensors take ``ssd_scan_plain``; CUDA
    tensors launch the kernel on the current stream."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, h0=h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    _check(x, dt, a, b, c, h0, chunk)
    Bsz, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q = min(chunk, L)
    lib = _lib()
    fn = lib.ssd_scan_f32 if x.dtype == torch.float32 else lib.ssd_scan_bf16
    y = torch.empty_like(x)
    ht = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):  # the C launch uses the current device
        err = fn(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), ht.data_ptr(),
            Bsz, L, H, P, G, N, Q, smem_bytes(Q, P, N),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    ssd_scan.launches += 1
    return y, ht


ssd_scan.launches = 0
