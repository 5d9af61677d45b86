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

The backward (``csrc/ssd_scan_bwd.cu``, new Hopper work: the JAX
package differentiates its reference ``ssd_ref``) is the wrapper
``ssd_scan_bwd`` with its plain version ``ssd_scan_bwd_plain``, the
gradient of the chunked form written out, in two steps
(``ssd_bwd_states``: each chunk's S_in and the cotangent G_out of its
final state; ``ssd_bwd_chunks``: the gradients a chunk).  Their
``operand`` hook takes ``bf16_pair`` to emulate the bf16 kernel, which
hands every operand that is f32 by nature (``wl o B``, ``exp(cum) o C``,
S_in, G_out, dCB and W) to the tensor cores as a pair; ``bwd_blocks``
counts its launches' blocks.  ``SSDScan`` is the
``torch.autograd.Function`` that joins the two; ``ssd_scan`` goes through
it where an input requires grad, on either device.

``ssd_scan`` and ``ssd_scan_bwd`` take their plain versions for CPU
tensors only; a CUDA tensor reaches the kernel or an exception.
``launches`` on each wrapper counts calls of the entry point that
launched its kernel (one a call, whatever the number of CUDA launches
inside it).
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


def _wide(t):
    """``t`` in the plain versions' working type: f32, or f64 for f64
    inputs (the CPU's gradient checks)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def bf16_pair(t):
    """An f32 operand as the bf16 kernel hands it to the tensor cores: a
    bf16 high part plus the bf16 remainder (16 significant bits), summed
    back in f32."""
    hi = t.bfloat16().float()
    return hi + (t - hi).bfloat16().float()


def _identity(t):
    return t


def ssd_scan_plain(x, dt, a, b, c, *, h0=None, chunk: int = 128):
    """The plain version: the kernel's chunked arithmetic in torch, f32
    (f64 for f64 inputs)."""
    Bsz, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    Q = min(chunk, L)
    n_chunks = -(-L // Q)
    pad = n_chunks * Q - L

    def chunks(t):  # (B, L, ...) -> f32 (B, n_chunks, Q, ...), zero-padded
        t = _wide(t)
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(Bsz, n_chunks, Q, *t.shape[2:])

    xf = chunks(x)
    dtf = chunks(dt)
    bf = chunks(b.repeat_interleave(rep, dim=2))  # (B, nc, Q, H, N)
    cf = chunks(c.repeat_interleave(rep, dim=2))
    cum = torch.cumsum(dtf * _wide(a), dim=2)  # (B, nc, Q, H)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    S = (torch.zeros((Bsz, H, N, P), dtype=xf.dtype, device=x.device)
         if h0 is None else _wide(h0))
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


def ssd_scan_bwd_plain(x, dt, a, b, c, h0, dy, dht, *, chunk: int = 128):
    """The plain backward: the gradient of the chunked form written out in
    torch, f32, without autograd.  ``dy`` (B, L, H, P) is y's cotangent,
    ``dht`` (B, H, N, P) the final state's or None (zero).  Per chunk,
    with S_in its initial state and G_out the cotangent of its final
    state (G_out of the last chunk = dht):

      * reverse state pass: ``G_in = exp(cum_last) G_out + sum_i
        exp(cum_i) C_i dy_i^T``, G_out[c] = G_in[c + 1], dh0 = G_in[0];
      * ``dx_j = sum_{i >= j} W_ij dy_i + wl_j G_out^T B_j``;
      * ``dC_i = sum_{j <= i} dW_ij e_ij dt_j B_j + exp(cum_i) S_in dy_i``;
      * ``dB_j = sum_{i >= j} dW_ij e_ij dt_j C_i + wl_j G_out x_j``;
      * ``ddt_j = sum_i dW_ij (C_i.B_j) e_ij + exp(cum_last - cum_j) u_j``
        with ``u_j = B_j^T G_out x_j``, plus ``a d(dt a)_j``;
      * d(cum): ``dW o W`` summed over j (+) and over i (-), the carry
        ``exp(cum_i) C_i.(S_in dy_i)``, ``-wl_j u_j``, and at the last row
        ``exp(cum_last) <G_out, S_in> + sum_j wl_j u_j``; its reverse
        cumsum is d(dt a), so ``da = sum dt d(dt a)``;

    where ``e_ij = exp(cum_i - cum_j)`` (j <= i), ``W_ij = (C_i.B_j) e_ij
    dt_j``, ``dW_ij = dy_i.x_j`` and ``wl_j = exp(cum_last - cum_j) dt_j``.
    Padded rows (past L) carry dt = 0 and zero x, B, C and dy: they give
    nothing.  Returns (dx, ddt, da, db, dc, dh0): dx, db, dc in the
    inputs' dtype, the rest f32; dh0 is None without h0."""
    s_in, g_out, dh0 = ssd_bwd_states(x, dt, a, b, c, h0, dy, dht, chunk=chunk)
    return (*ssd_bwd_chunks(x, dt, a, b, c, dy, s_in, g_out, chunk=chunk), dh0)


def _sum_to(t, dim: int):
    """``t.sum(dim)`` for a tensor whose last axis is the heads, each
    element summed along one contiguous row: the order then depends on
    the summed length alone, not on how many heads lie beside it (torch
    sums a strided axis in an order that changes with the width of the
    axes inside it), so a mesh member's heads get the bits of the whole
    scan's."""
    return t.movedim(dim, -1).contiguous().sum(-1)


def _chunked_dy(dy, Q: int, nc: int):
    Bsz, L, H, P = dy.shape
    return F.pad(_wide(dy), (0, 0, 0, 0, 0, nc * Q - L)).reshape(Bsz, nc, Q, H, P)


def ssd_bwd_states(x, dt, a, b, c, h0, dy, dht, *, chunk: int = 128, operand=_identity):
    """The backward's steps 1-2 in plain torch: each chunk's initial state
    S_in (the forward's state passing, recomputed) and the cotangent
    G_out of its final state (the reverse pass).  ``operand`` is applied
    to the products' operands that are f32 by nature, ``wl o B`` and
    ``exp(cum) o C``.  Returns S_in and G_out (B, H, nc, N, P) and dh0
    (None without h0)."""
    ds, decay = ssd_chunk_states(x, dt, a, b, chunk=chunk, operand=operand)  # decay (B, H, nc)
    s_in, _ = ssd_state_passing(ds, decay, h0)
    _, _, _, cf, cum = _chunked(x, dt, a, b, c, chunk)  # (B, nc, Q, H, ...)
    dyf = _chunked_dy(dy, cum.shape[2], cum.shape[1])
    e = torch.einsum("bcihn,bcihp->bhcnp", operand(cf * torch.exp(cum)[..., None]), dyf)
    g = torch.zeros_like(ds[:, :, 0]) if dht is None else _wide(dht)
    g_out = [None] * ds.shape[2]
    for ci in reversed(range(ds.shape[2])):
        g_out[ci] = g
        g = decay[:, :, ci, None, None] * g + e[:, :, ci]
    return s_in, torch.stack(g_out, dim=2), None if h0 is None else g


def ssd_bwd_chunks(x, dt, a, b, c, dy, s_in, g_out, *, chunk: int = 128, operand=_identity):
    """The backward's per-chunk step in plain torch, from each chunk's S_in
    and G_out (``ssd_bwd_states``).  ``operand`` is applied to the
    products' operands that are f32 by nature: S_in and G_out (also S_in
    in the carry ``<G_out, S_in>``, as the kernel reads it back), dCB
    (for dC and, transposed, dB) and W (for dx).  Returns (dx, ddt, da,
    db, dc)."""
    Bsz, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    xf, dtf, bf, cf, cum = _chunked(x, dt, a, b, c, chunk)  # (B, nc, Q, H, ...)
    Q, nc = cum.shape[2], cum.shape[1]
    dyf = _chunked_dy(dy, Q, nc)
    last = cum[:, :, -1]  # (B, nc, H)
    wl = torch.exp(last[:, :, None] - cum) * dtf  # (B, nc, Q, H)
    ecum = torch.exp(cum)
    # the intra-chunk weights and their cotangents, (B, nc, Qi, Qj, H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    diff = (cum[:, :, :, None] - cum[:, :, None, :]).masked_fill(~causal, 0.0)
    decay = torch.exp(diff).masked_fill(~causal, 0.0)
    cb = torch.einsum("bcihn,bcjhn->bcijh", cf, bf)
    w = cb * decay * dtf[:, :, None]
    dw = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf).masked_fill(~causal, 0.0)
    dcb = dw * decay * dtf[:, :, None]
    sp, gp, dcbp = operand(s_in), operand(g_out), operand(dcb)
    sdy = torch.einsum("bhcnp,bcihp->bcihn", sp, dyf)  # S_in dy_i
    gx = torch.einsum("bhcnp,bcjhp->bcjhn", gp, xf)  # G_out x_j
    dx = (torch.einsum("bcijh,bcihp->bcjhp", operand(w), dyf)
          + wl[..., None] * torch.einsum("bcjhn,bhcnp->bcjhp", bf, gp))
    dc = torch.einsum("bcijh,bcjhn->bcihn", dcbp, bf) + ecum[..., None] * sdy
    db = torch.einsum("bcijh,bcihn->bcjhn", dcbp, cf) + wl[..., None] * gx
    u = (bf * gx).sum(-1)  # (B, nc, Q, H)
    t = dw * w
    dcum = _sum_to(t, 3) - _sum_to(t, 2) + ecum * (cf * sdy).sum(-1) - wl * u
    carry = torch.exp(last) * torch.einsum("bhcnp,bhcnp->bch", g_out, sp) + _sum_to(wl * u, 2)
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + carry[:, :, None]], dim=2)
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])  # d(dt a)
    ddt = _sum_to(dw * cb * decay, 2) + torch.exp(last[:, :, None] - cum) * u + dda * _wide(a)
    da = _sum_to((dda * dtf).reshape(-1, H), 0)

    def rows(t):  # (B, nc, Q, ...) -> (B, L, ...)
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :L]

    def groups(t):  # per head (B, L, H, N) -> per group (B, L, G, N)
        return rows(t).reshape(Bsz, L, G, rep, N).sum(3).to(b.dtype)

    return rows(dx).to(x.dtype), rows(ddt), da, groups(db), groups(dc)


# --------------------------------------------------------------------------
# the bf16 kernel's three steps, in plain torch
# --------------------------------------------------------------------------
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
        t = F.pad(_wide(t), (0, 0) * (t.dim() - 2) + (0, nc * Q - L))
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    dtf = chunks(dt)
    cum = torch.cumsum(dtf * _wide(a), dim=2)  # (B, nc, Q, H)
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
    s = torch.zeros_like(ds[:, :, 0]) if h0 is None else h0.to(ds.dtype)
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


#: rows (and columns) of the f32 backward's sweep tiles
BWD_TILE = 32


def bwd_smem_bytes(Q: int, P: int, N: int) -> tuple[int, int]:
    """Dynamic shared memory of one block of the f32 backward's chunk-sums
    step (the chunk's B or C and x or dy, and three vectors) and of its
    chunk-gradient step (``grad_smem_floats`` in ``csrc/ssd_scan_bwd.cu``:
    whole rows of B or C, x or dy and the state with a row stride one past
    their width, a tile's rows, two weight tiles, a tile of terms summed
    over N, seven vectors and a block sum's 32 totals)."""
    T = min(BWD_TILE, Q)
    grad = (Q * (N + 1) + Q * (P + 1) + N * (P + 1) + T * N + T * P + 2 * T * (Q + 1)
            + T * (N + 1) + 7 * Q + 32)
    return 4 * (Q * (N + P) + 3 * Q), 4 * grad


def bwd_heads(H: int, G: int) -> int:
    """Heads a block of the bf16 backward's chunk-gradient step walks,
    summing their dB and dC in its accumulators: the largest of 8, 4, 2, 1
    that divides the H / G heads of a group (at most 8: ``kMaxHeads`` in
    ``csrc/ssd_scan_bwd.cu``)."""
    rep = H // G
    return next(hb for hb in (8, 4, 2, 1) if rep % hb == 0)


def bwd_blocks(B: int, L: int, H: int, N: int, P: int, G: int = 1) -> dict:
    """Blocks of the bf16 backward's four launches (the C entry computes
    the same grids): the state passes over (64-wide half of N, head,
    batch); the chunk gradients over (chunk, 64-row tile, sweep, group of
    ``bwd_heads`` heads, batch); the finish over (chunk, head, batch); the
    group sums a (b, t, g) row where a group has more heads than a block
    walks, and one block for da."""
    nc = -(-L // BF16_CHUNK)
    tiles = BF16_CHUNK // BF16_ROW_TILE
    hb = bwd_heads(H, G)
    return {"states": -(-N // 64) * H * B,
            "chunk_grads": nc * tiles * 2 * (H // hb) * B,
            "finish": nc * H * B,
            "group_da": (B * L * G if H // G > hb else 0) + 1}


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    from . import build

    lib = build.load("ssd_scan_bwd")
    lib.ssd_scan_bwd_f32.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.ssd_scan_bwd_bf16.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    for fn in (lib.ssd_scan_bwd_f32, lib.ssd_scan_bwd_bf16):
        fn.restype = ctypes.c_int
    return lib


def ssd_scan_bwd(x, dt, a, b, c, h0, dy, dht, *, chunk: int = 128):
    """The scan's backward: (dx, ddt, da, db, dc, dh0) for y's cotangent
    ``dy`` and the final state's ``dht`` (None: zero), as
    ``ssd_scan_bwd_plain`` computes them.  CPU tensors take the plain
    version; CUDA tensors launch ``csrc/ssd_scan_bwd.cu`` on the current
    stream (f32 on the CUDA cores at any chunk whose blocks fit, bf16 on
    the tensor cores at the forward's bf16 shapes) and count one launch in
    ``ssd_scan_bwd.launches``."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt, a, b, c, h0, dy, dht, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd runs on cuda or cpu, not {x.device}")
    _check(x, dt, a, b, c, h0, chunk)
    Bsz, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"dy must be a contiguous {x.dtype} {tuple(x.shape)} tensor beside x")
    if dht is not None and (tuple(dht.shape) != (Bsz, H, N, P) or dht.dtype != torch.float32
                            or dht.device != x.device or not dht.is_contiguous()):
        raise ValueError(f"dht must be a contiguous float32 {(Bsz, H, N, P)} tensor beside x")
    if Bsz * H > 65535:
        raise ValueError(f"B x H = {Bsz * H} exceeds the state pass's grid")
    bf16 = x.dtype == torch.bfloat16
    Q = BF16_CHUNK if bf16 else min(chunk, L)
    if not bf16:
        smem = max(bwd_smem_bytes(Q, P, N))
        if smem > SMEM_LIMIT:
            raise ValueError(f"the backward needs {smem} bytes of shared memory a block; a Hopper "
                             f"block can use {SMEM_LIMIT}")
    elif dy.data_ptr() % 16:
        raise ValueError("the bf16 backward needs a 16-byte aligned dy")
    nc = -(-L // Q)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    ddt = torch.empty((Bsz, L, H), **f32)
    da = torch.empty((H,), **f32)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    dh0 = None if h0 is None else torch.empty((Bsz, H, N, P), **f32)
    pda = torch.empty((Bsz, H, nc), **f32)  # each (b, chunk)'s share of da

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _bwd_lib()
    common = [x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), ptr(h0),
              dy.data_ptr(), ptr(dht), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
              dc.data_ptr(), ptr(dh0)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf16:
            # scratch: each chunk's S_in and G_out as bf16 pairs laid out as the
            # chunk gradients read them, each half of N's share of <G_out,
            # S_in>, the sweeps' terms of dcum and u, and the head groups'
            # partials of dB / dC where a group has more heads than a block
            # of the chunk gradients walks
            hb = bwd_heads(H, G)
            sp = torch.empty((Bsz, H, nc, 2, P, N), dtype=torch.bfloat16, device=dev)
            gp = torch.empty((Bsz, H, nc, 2, P, N), dtype=torch.bfloat16, device=dev)
            gsp = torch.empty((Bsz, H, nc, -(-N // 64)), **f32)
            terms = torch.empty((3, Bsz, H, nc, BF16_CHUNK), **f32)
            parts = H // G > hb
            pdb = torch.empty((Bsz, L, H // hb, N), **f32) if parts else None
            pdc = torch.empty((Bsz, L, H // hb, N), **f32) if parts else None
            err = lib.ssd_scan_bwd_bf16(
                *common, sp.data_ptr(), gp.data_ptr(), gsp.data_ptr(), terms.data_ptr(),
                ptr(pdb), ptr(pdc), pda.data_ptr(), Bsz, L, H, P, G, N, hb, stream)
        else:
            # scratch: S_in and G_out of every chunk (step 1 writes dS and E
            # there), the decays, and the per-head dB / dC
            ws_s = torch.empty((Bsz, H, nc, N, P), **f32)
            ws_g = torch.empty((Bsz, H, nc, N, P), **f32)
            ws_dec = torch.empty((Bsz, H, nc), **f32)
            pdb = torch.empty((Bsz, L, H, N), **f32)
            pdc = torch.empty((Bsz, L, H, N), **f32)
            err = lib.ssd_scan_bwd_f32(
                *common, ws_s.data_ptr(), ws_g.data_ptr(), ws_dec.data_ptr(), pdb.data_ptr(),
                pdc.data_ptr(), pda.data_ptr(), Bsz, L, H, P, G, N, Q, stream)
    if err:
        raise RuntimeError(f"ssd_scan_bwd launch failed: cudaError {err}")
    ssd_scan_bwd.launches += 1
    return dx, ddt, da, db, dc, dh0


ssd_scan_bwd.launches = 0


def _forward(x, dt, a, b, c, h0, chunk):
    """(y, final state): ``ssd_scan_plain`` for CPU tensors, the kernel
    for CUDA tensors (counted in ``ssd_scan.launches``)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b, c, h0=h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
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


class SSDScan(torch.autograd.Function):
    """The scan with its gradient: the forward is ``_forward`` (K8 on the
    card, ``ssd_scan_plain`` on the CPU), the backward ``ssd_scan_bwd``
    (K8's backward kernel on the card, ``ssd_scan_bwd_plain`` on the
    CPU).  It saves the inputs only: the backward recomputes each chunk's
    initial state, so under ``torch.utils.checkpoint`` a recompute
    launches the forward again and nothing of it is kept."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, h0, chunk):
        ctx.save_for_backward(x, dt, a, b, c, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused output's cotangent comes as None
        return _forward(x, dt, a, b, c, h0, chunk)

    @staticmethod
    def backward(ctx, dy, dht):
        x, dt, a, b, c, h0 = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dht = None if dht is None else dht.contiguous()
        dx, ddt, da, db, dc, dh0 = ssd_scan_bwd(x, dt, a, b, c, h0, dy, dht, chunk=ctx.chunk)
        return dx, ddt, da, db, dc, dh0, None


def ssd_scan(x, dt, a, b, c, *, h0=None, chunk: int = 128):
    """The SSD chunked scan.  x (B, L, H, P); dt (B, L, H) f32; a (H,) f32;
    b, c (B, L, G, N); h0 (B, H, N, P) f32 or None.  Returns (y in x's
    dtype, final state f32).  CPU tensors take ``ssd_scan_plain``; CUDA
    tensors launch the kernel on the current stream.  With grad enabled
    and an input that requires grad the scan goes through ``SSDScan``,
    whose backward is K8's backward kernel on the card and
    ``ssd_scan_bwd_plain`` on the CPU; ``h0`` gets a gradient when it
    requires one."""
    inputs = (x, dt, a, b, c, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return SSDScan.apply(x, dt, a, b, c, h0, chunk)
    return _forward(x, dt, a, b, c, h0, chunk)


ssd_scan.launches = 0
