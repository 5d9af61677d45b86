"""Mamba2 SSD chunked scan: the wrapper of the CUDA kernels
``csrc/ssd_scan.cu``, its plain PyTorch version, and the plain form of
the bf16 kernel's three steps.

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

The bf16 kernel computes the same function in the chunked algorithm's
parallel form, three launches of one entry point:

  1. chunk states, parallel over (b, h, chunk): ``dS_c = (wl o B)^T X``
     with ``wl_j = exp(cum_last - cum_j) dt_j``, and ``exp(cum_last_c)``;
  2. state passing, serial over chunks and elementwise over N x P:
     ``S_in[0] = h0`` (or 0), ``S_in[c+1] = exp(cum_last_c) S_in[c] + dS_c``,
     each S_in written as a bf16 pair for step 3; the last one is the
     final state;
  3. chunk outputs, parallel over (b, h, chunk, 64-row tile):
     ``y = W X + exp(cum_i) C S_in[c]``.

``ssd_chunk_states``, ``ssd_state_passing`` and ``ssd_chunk_outputs`` are
those steps in plain torch (``ssd_scan_chunked`` chains them), with a
hook for the operands that are f32 by nature (``wl o B``, ``W``,
``S_in``): the kernel hands each to the bf16 tensor cores as a bf16 high
part plus a bf16 remainder (``bf16_pair``).

``ssd_scan`` takes the plain version for CPU tensors only; a CUDA tensor
reaches the kernel or an exception.  ``launches`` on the wrapper counts
calls of the entry point that launched the kernel (one a scan, whatever
the number of CUDA launches inside it).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

#: dynamic shared memory one block of the kernel may use on Hopper
SMEM_LIMIT = 232448
#: rows of the intra-chunk weight matrix the f32 kernel builds at a time
ROW_TILE = 32
#: the bf16 kernel's chunk, and the widths its instance zero-pads to
BF16_CHUNK = 128
BF16_MAX_STATE = 128
BF16_MAX_HEAD_DIM = 64
#: rows of a chunk-output tile of the bf16 kernel (one wgmma M)
BF16_ROW_TILE = 64


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


# --------------------------------------------------------------------------
# the bf16 kernel's three steps, in plain torch
# --------------------------------------------------------------------------
def bf16_pair(t):
    """An f32 operand as the bf16 kernel hands it to the tensor cores: a
    bf16 high part plus the bf16 remainder (16 significant bits), summed
    back in f32."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float()


def _identity(t):
    return t


def _chunked(x, dt, a, b, c, chunk):
    """f32 chunks (B, nc, Q, ...), zero-padded past L, of x, dt, the
    head-broadcast B and C (None stays None), and cum."""
    Bsz, L, H, _ = x.shape
    rep = H // b.shape[2]
    Q = min(chunk, L)
    nc = -(-L // Q)

    def chunks(t):
        if t is None:
            return None
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, nc * Q - L))
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    dtf = chunks(dt)
    cum = torch.cumsum(dtf * a.float(), dim=2)  # (B, nc, Q, H)
    bf = chunks(b.repeat_interleave(rep, dim=2))
    cf = None if c is None else chunks(c.repeat_interleave(rep, dim=2))
    return chunks(x), dtf, bf, cf, cum


def ssd_chunk_states(x, dt, a, b, *, chunk: int = 128, operand=_identity):
    """Step 1: each chunk's own state update ``dS_c = (wl o B)^T X`` with
    ``wl_j = exp(cum_last - cum_j) dt_j`` (an exponential of an argument
    <= 0), and its decay ``exp(cum_last_c)``.  ``operand`` is applied to
    ``wl o B`` before the product.  Returns dS (B, H, nc, N, P) and the
    decays (B, H, nc), f32."""
    xf, dtf, bf, _, cum = _chunked(x, dt, a, b, None, chunk)
    last = cum[:, :, -1]  # (B, nc, H)
    wl = torch.exp(last[:, :, None] - cum) * dtf  # (B, nc, Q, H)
    ds = torch.einsum("bcjhn,bcjhp->bhcnp", operand(bf * wl[..., None]), xf)
    return ds, torch.exp(last).transpose(1, 2)


def ssd_state_passing(ds, decay, h0=None):
    """Step 2: ``S_in[0] = h0`` (or 0), ``S_in[c+1] = decay_c S_in[c] +
    dS_c``.  Returns S_in (B, H, nc, N, P) and the final state (B, H, N,
    P), f32."""
    s = torch.zeros_like(ds[:, :, 0]) if h0 is None else h0.float()
    s_in = []
    for ci in range(ds.shape[2]):
        s_in.append(s)
        s = decay[:, :, ci, None, None] * s + ds[:, :, ci]
    return torch.stack(s_in, dim=2), s


def ssd_chunk_outputs(x, dt, a, b, c, s_in, *, chunk: int = 128, operand=_identity):
    """Step 3: ``y = W X + exp(cum_i) C S_in[c]`` in every chunk, with ``W
    = (C B^T) o exp(cum_i - cum_j) o dt_j`` where ``j <= i`` and 0
    elsewhere (the exponential taken only there).  ``operand`` is applied
    to W before its product (the caller applies its own to ``s_in``).
    Returns y (B, L, H, P) in x's dtype."""
    Bsz, L, H, P = x.shape
    xf, dtf, bf, cf, cum = _chunked(x, dt, a, b, c, chunk)
    Q = cum.shape[2]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    diff = (cum[:, :, :, None] - cum[:, :, None, :]).masked_fill(~causal, 0.0)
    decay = torch.exp(diff).masked_fill(~causal, 0.0)  # (B, nc, Qi, Qj, H)
    w = torch.einsum("bcihn,bcjhn->bcijh", cf, bf) * decay * dtf[:, :, None]
    y = torch.einsum("bcijh,bcjhp->bcihp", operand(w), xf)
    y = y + torch.exp(cum)[..., None] * torch.einsum("bcihn,bhcnp->bcihp", cf, s_in)
    return y.reshape(Bsz, -1, H, P)[:, :L].to(x.dtype)


def ssd_scan_chunked(x, dt, a, b, c, *, h0=None, chunk: int = 128, operand=_identity):
    """The three steps chained; ``operand`` is applied to every operand
    that is f32 by nature (``wl o B``, ``W`` and ``S_in``): ``bf16_pair``
    emulates the bf16 kernel's tensor-core arithmetic.  Returns (y, final
    state) as ``ssd_scan_plain`` does."""
    ds, decay = ssd_chunk_states(x, dt, a, b, chunk=chunk, operand=operand)
    s_in, ht = ssd_state_passing(ds, decay, h0)
    y = ssd_chunk_outputs(x, dt, a, b, c, operand(s_in), chunk=chunk, operand=operand)
    return y, ht


def bf16_blocks(B: int, L: int, H: int, N: int, P: int) -> dict:
    """Blocks of the bf16 kernel's three launches (the C entry computes the
    same grids): chunk states over (b, h, chunk, 64-wide half of N), state
    passing over (b, h, 2048 state elements: 256 threads of 8), chunk
    outputs over (b, h, chunk, 64-row tile)."""
    nc = -(-L // BF16_CHUNK)
    return {"chunk_states": B * H * nc * -(-N // 64),
            "state_passing": B * H * -(-N * P // 2048),
            "chunk_outputs": B * H * nc * (BF16_CHUNK // BF16_ROW_TILE)}


def smem_bytes(Q: int, P: int, N: int) -> int:
    """Dynamic shared memory of one block of the f32 kernel: the chunk's x,
    B (row stride N + 1), C, the carried state, one row tile of W, and dt,
    cum and the two decay vectors."""
    return 4 * (Q * P + Q * (N + 1) + Q * N + N * P + min(ROW_TILE, Q) * Q + 4 * Q)


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import build

    lib = build.load("ssd_scan")
    lib.ssd_scan_f32.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                 + [ctypes.c_size_t, ctypes.c_void_p])
    lib.ssd_scan_bf16.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    for fn in (lib.ssd_scan_f32, lib.ssd_scan_bf16):
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
    if x.dtype == torch.bfloat16:
        _check_bf16(x, b, c, h0, chunk)
        return
    smem = smem_bytes(min(chunk, L), P, N)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{smem} bytes of shared memory exceed the {SMEM_LIMIT} a Hopper block can use")


def _check_bf16(x, b, c, h0, chunk) -> None:
    """What the bf16 instance takes: chunks of 128 rows (or one chunk of at
    most 128), N <= 128 and P <= 64 in multiples of 8 (zero-padded to the
    instance), and 16-byte aligned rows for its 16-byte copies."""
    L, P, N = x.shape[1], x.shape[3], b.shape[3]
    if chunk != BF16_CHUNK and L > min(chunk, BF16_CHUNK):
        raise ValueError(f"the bf16 kernel scans chunks of {BF16_CHUNK} rows; chunk={chunk} at "
                         f"L={L} splits the sequence elsewhere")
    if N > BF16_MAX_STATE or N % 8 or P > BF16_MAX_HEAD_DIM or P % 8:
        raise ValueError(f"the bf16 kernel takes N <= {BF16_MAX_STATE} and P <= "
                         f"{BF16_MAX_HEAD_DIM}, multiples of 8; got N={N}, P={P}")
    if any(t.data_ptr() % 16 for t in (x, b, c, h0) if t is not None):
        raise ValueError("the bf16 kernel needs 16-byte aligned x, b, c and h0")


def ssd_scan(x, dt, a, b, c, *, h0=None, chunk: int = 128):
    """The SSD chunked scan.  x (B, L, H, P); dt (B, L, H) f32; a (H,) f32;
    b, c (B, L, G, N); h0 (B, H, N, P) f32 or None.  Returns (y in x's
    dtype, final state f32).  CPU tensors take ``ssd_scan_plain``, which
    autograd differentiates; CUDA tensors launch the kernel on the current
    stream, which has no backward: with grad enabled and an input that
    requires grad it raises rather than return outputs with no grad_fn."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, h0=h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    inputs = (x, dt, a, b, c, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        # the kernel writes its outputs through a ctypes launch, which
        # autograd cannot see: they would carry no grad_fn and silently cut
        # the gradient of everything upstream of the scan
        raise RuntimeError("K8 has no backward on the card yet; see ROADMAP (a K8 backward "
                           "kernel).  Run the scan under torch.no_grad(), or train on the CPU")
    _check(x, dt, a, b, c, h0, chunk)
    Bsz, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    lib = _lib()
    y = torch.empty_like(x)
    ht = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    h0p = None if h0 is None else h0.data_ptr()
    with torch.cuda.device(x.device):  # the C launch uses the current device
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.float32:
            Q = min(chunk, L)
            err = lib.ssd_scan_f32(
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), h0p,
                y.data_ptr(), ht.data_ptr(), Bsz, L, H, P, G, N, Q, smem_bytes(Q, P, N), stream)
        else:
            # scratch: each chunk's dS and decay exp(cum_last) (step 1), and
            # its S_in as bf16 high parts and remainders, transposed (step 2)
            nc = -(-L // BF16_CHUNK)
            ds = torch.empty((Bsz, H, nc, N, P), dtype=torch.float32, device=x.device)
            dec = torch.empty((Bsz, H, nc), dtype=torch.float32, device=x.device)
            s_in = torch.empty((Bsz, H, nc, 2, P, N), dtype=torch.bfloat16, device=x.device)
            err = lib.ssd_scan_bf16(
                x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), h0p,
                y.data_ptr(), ht.data_ptr(), ds.data_ptr(), dec.data_ptr(), s_in.data_ptr(),
                Bsz, L, H, P, G, N, stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    ssd_scan.launches += 1
    return y, ht


ssd_scan.launches = 0
