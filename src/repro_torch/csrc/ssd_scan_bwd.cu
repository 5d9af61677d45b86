// The backward of the Mamba2 SSD chunked scan (K8) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's ops.ssd has no custom_vjp,
// so JAX differentiates its quadratic reference ssd_ref
// (repro/kernels/ref.py).  It was added because a trainer on the card
// needs the scan's gradient and the port has no plain fallback there.
// It computes the gradient of the chunked form csrc/ssd_scan.cu
// computes, per batch row b and head h (B/C group g = h / (H / G)), in
// chunks of Q rows with cum_i = sum_{k <= i} dt_k a, e_ij = exp(cum_i -
// cum_j) for j <= i, W_ij = (C_i . B_j) e_ij dt_j, wl_j = exp(cum_last -
// cum_j) dt_j, and S_in / G_out a chunk's initial state and the cotangent
// of its final state:
//   reverse state pass   G_in = exp(cum_last) G_out + sum_i exp(cum_i) C_i dy_i^T,
//                        G_out[c] = G_in[c + 1], G_out[last] = dht, dh0 = G_in[0];
//   dx_j  = sum_{i >= j} W_ij dy_i + wl_j G_out^T B_j
//   dC_i  = sum_{j <= i} dW_ij e_ij dt_j B_j + exp(cum_i) S_in dy_i  (dW_ij = dy_i . x_j)
//   dB_j  = sum_{i >= j} dW_ij e_ij dt_j C_i + wl_j G_out x_j
//   ddt_j = sum_i dW_ij (C_i . B_j) e_ij + exp(cum_last - cum_j) u_j + a d(dt a)_j,
//           u_j = B_j^T G_out x_j
//   dcum  = sum_j dW_ij W_ij (row i) - sum_i dW_ij W_ij (column j)
//           + exp(cum_i) C_i . (S_in dy_i) - wl_j u_j
//           + [last row] (exp(cum_last) <G_out, S_in> + sum_j wl_j u_j),
//   d(dt a) = the reverse cumsum of dcum within the chunk, da = sum dt d(dt a).
// Rows past L read x = B = C = dy = 0 and dt = 0, as in the forward: they
// give no gradient and nothing of theirs is stored.
//
// What bounds it: at mamba2-2.7b's layer in training (B = 4, L = 512, H =
// 80 heads of P = 64, N = 128, one group, bf16) the bytes are x, dy, dx
// (21 MB each), B, C, dt, ddt and the state cotangents, about 65 MB, 19
// us at 3.35 TB/s; the products (the causal halves of C.B^T, dy.x^T,
// W^T dy, dCB B and dCB^T C, and five N x P x Q products a chunk) are
// about 24 GFLOP, 24 us on the bf16 tensor cores.  So only the tensor
// cores come near the bound: on the f32 CUDA cores the same work takes
// 0.36 ms.  The bf16 design below issues about 57 GFLOP of wgmma by its
// tile counts (the f32 operands' pairs double their products, diagonal
// tiles are whole) and moves S_in and G_out as bf16 pairs (84 MB); it
// takes 0.44 ms there on an H100, most of it in tile_grad_kernel.
//
// bf16 design: every product on wgmma with bf16 operands and f32
// accumulators (hopper.cuh), blocks of one warpgroup, chunks of 128 rows,
// four launches of one entry point; steps 2 and 4 are programmatic
// dependent launches (each waits, griddepcontrol.wait, only where it
// reads what the launch before wrote; a CUDA graph keeps the edges), step
// 3 a plain launch after step 2:
//   1. state_kernel, grid (64-wide half of N, head, batch): the state
//      passes in wgmma accumulators, one block carrying its rows of the
//      state over the chunks: forward S_in[c + 1] = exp(cum_last_c) S_in[c]
//      + (wl o B)^T X, reverse G_out[c - 1] = exp(cum_last_c) G_out[c] +
//      (exp(cum) o C)^T dY, each an N x P product of depth 128 added onto
//      the scaled accumulator (the forward's step-1 product,
//      ssd_chunk.cuh); each S_in and G_out written as bf16 pairs laid out
//      as step 2's tiles read them (rows p, columns n: the forward's S_in
//      layout), staged so each row leaves whole; dh0; and each half's
//      <G_out, S_in> (S_in read back as step 2 reads it), in a fixed
//      order.  No f32 state goes through device memory;
//   2. tile_grad_kernel, grid (chunk x 64-row tile x sweep, group of up
//      to 8 heads, batch): 64-row tiles as in the forward's step 3, 320
//      blocks (2560 tiles) a sweep at the training call, each walking
//      the heads of its group in order.  Both sweeps have one shape: an
//      own tile (rows i: C, dy; columns j: B, x) against the key tiles (B,
//      x of rows j <= the tile; C, dy of rows i >= it), copied with
//      cp.async into the 128-byte swizzle (B and C once a block, x and dy
//      each head, the next head's while this head's state terms run):
//        S = own_N keys_N^T, D = own_P keys_P^T     wgmma, K-major
//        rows i:    dCB = D o e o dt_j, its row sums of D o S o e o dt_j
//                   dC += dCB B                     A = dCB from registers
//                                                   (the accumulator
//                                                   layout is the A layout),
//                                                   B MN-major (N = 128)
//        columns j: W^T = S o e o dt_j, dCB^T = D o e o dt_j, the row sums
//                   of D o S o e; dx += W^T dY, dB += dCB^T C
//      then, after the wait for step 1, the state terms on the pairs:
//        T = own_P St^T (A = dy or x from registers, St MN-major);
//        rows i: dC += exp(cum_i) T, the row term exp(cum_i) C_i . T_i;
//        columns j: dB += wl_j T, u_j = B_j . T_j; dx += wl_j (B G_out)
//        (wgmma, K-major);
//      the row and column terms of dcum go to f32 scratch and dx to its
//      output each head; dB or dC stays in the accumulators, summed over
//      the block's heads in head order, and goes out once: into dB / dC
//      when the block spans its group, else into f32 partials of H / 8
//      head groups (a thread-block cluster of 8 heads summing through
//      distributed shared memory, built first, took as long on an H100,
//      0.36 ms, and loaded B and C for every head);
//   3. finish_kernel, grid (chunk, head, batch), a thread a row: cum and
//      the reverse cumsum by warp scans, the carry of the chunk's final
//      state on its last row (exp(cum_last) <G_out, S_in> + sum_j wl_j
//      u_j), ddt, and the chunk's share of da;
//   4. group_da_kernel: dB / dC of each (b, t, g) from the head groups'
//      partials in order (mamba2: 80 heads, 10 groups), and da.
// No atomics: every sum runs in one fixed order (the heads' included), so
// two calls and a CUDA-graph replay give the same bits: a
// DMR trainer compares its replicas bit for bit every step.
// Precision: x, B, C and dy enter the products exactly; every operand
// that is f32 by nature (dCB, dCB^T, W^T, S_in, G_out, wl o B, exp(cum) o
// C) enters as a bf16 high part and its bf16 remainder, two products, 16
// significant bits (K6 and the forward do the same); the dcum terms are
// formed in f32 registers from the accumulators and never rounded; every
// exponential has an argument <= 0, none factored into exp(cum_i)
// exp(-cum_j).
//
// f32 inputs keep the simple kernels (reduced configs and tests only; no
// full-width model trains in f32 on the card): every product on the CUDA
// cores in f32 out of shared memory, five launches, no atomics:
//   1. chunk_sums_kernel, grid (chunk, head, batch): cum (one thread, in
//      order); each chunk's state update dS_c = sum_j wl_j B_j x_j^T,
//      E_c = sum_i exp(cum_i) C_i dy_i^T, and exp(cum_last_c);
//   2. state_pass_kernel, elementwise over N x P, serial over chunks: the
//      forward pass writes S_in[c] over dS_c, the reverse pass G_out[c]
//      over E_c, and dh0;
//   3. chunk_grad_kernel, grid (chunk, head, batch), two sweeps over the
//      chunk with one shared-memory layout: rows i in tiles of 32 (B, x,
//      S_in whole; C, dy of the tile) give dC, the row sums of dW o W and
//      the carry term; columns j in tiles of 32 (C, dy, G_out whole; B, x
//      of the tile) give dx, dB, u and the column sums; then one thread
//      turns dcum into d(dt a) and the chunk's share of da.  Whole
//      operands are stored with a row stride one past their width so the
//      lanes of a warp, which walk rows, hit distinct banks.
//   4. group_sum_kernel: dB and dC are written per head (f32) and summed
//      over the H / G heads of a group in order;
//   5. da_kernel: da[h] = the per-(b, chunk) shares summed in order.
// S_in is recomputed rather than saved by the forward on both routes: the
// forward's bf16 S_in pairs would be 42 MB a layer to keep alive from the
// forward to the backward, and under remat="full" the forward is
// recomputed in the backward anyway.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"     // cp.async, wgmma and the swizzled descriptors
#include "ssd_chunk.cuh"  // the chunk tiles, the cumsum, the chunk-state product

namespace {

// --------------------------------------------------------------------------
// f32: CUDA cores, out of shared memory
// --------------------------------------------------------------------------
constexpr int kThreads = 512;  // chunk kernels: 16 warps
constexpr int kTile = 32;      // rows / columns of a sweep's tile
constexpr int kPassThreads = 256;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dt of the chunk's rows (0 past L) and cum, summed in order by one
// thread; every kernel here computes it the same way.
__device__ void chunk_cum(const float* __restrict__ dt, float ah, int b, int h, int t0, int L,
                          int H, int Q, float* dts, float* cum) {
  for (int r = threadIdx.x; r < Q; r += blockDim.x) {
    const int t = t0 + r;
    dts[r] = t < L ? dt[((size_t)b * L + t) * H + h] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int r = 0; r < Q; ++r) {
      run += dts[r] * ah;
      cum[r] = run;
    }
  }
  __syncthreads();
}

// Rows [t0 + r0, t0 + r0 + rows) of a (B, L, W, width) tensor at (b, w)
// into dst (row stride ld), as f32, zero past L.
template <typename T>
__device__ void stage(float* dst, int ld_dst, const T* __restrict__ src, int b, int w, int W,
                      int width, int t0, int r0, int rows, int L) {
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
    const int r = i / width, k = i - r * width, t = t0 + r0 + r;
    dst[r * ld_dst + k] = t < L ? ld(src, (((size_t)b * L + t) * W + w) * width + k) : 0.f;
  }
}

// Step 1: ds[c] = sum_j wl_j B_j x_j^T, es[c] = sum_i exp(cum_i) C_i dy_i^T
// (N x P each, f32), dec[c] = exp(cum_last).  Shared memory: Q x N, Q x
// P, and three vectors of Q.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chunk_sums_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ bm,
                      const T* __restrict__ cm, const T* __restrict__ dy, float* __restrict__ ds,
                      float* __restrict__ es, float* __restrict__ dec, int L, int H, int P, int G,
                      int N, int Q, int nc) {
  extern __shared__ float smem[];
  float* rn = smem;        // Q x N: B, then C
  float* rp = rn + Q * N;  // Q x P: x, then dy
  float* dts = rp + Q * P;
  float* cum = dts + Q;
  float* wts = cum + Q;  // wl, then exp(cum)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int tid = threadIdx.x, nt = blockDim.x, t0 = c * Q;
  chunk_cum(dt, a[h], b, h, t0, L, H, Q, dts, cum);
  const float last = cum[Q - 1];
  const size_t chunk = ((size_t)b * H + h) * nc + c;
  if (tid == 0) dec[chunk] = expf(last);
  for (int pass = 0; pass < 2; ++pass) {
    stage(rn, N, pass ? cm : bm, b, g, G, N, t0, 0, Q, L);
    stage(rp, P, pass ? dy : x, b, h, H, P, t0, 0, Q, L);
    for (int r = tid; r < Q; r += nt) wts[r] = pass ? expf(cum[r]) : expf(last - cum[r]) * dts[r];
    __syncthreads();
    float* out = (pass ? es : ds) + chunk * N * P;
    for (int k = tid; k < N * P; k += nt) {
      const int n = k / P, p = k - n * P;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc = fmaf(wts[j] * rn[j * N + n], rp[j * P + p], acc);
      out[k] = acc;
    }
    __syncthreads();  // the next pass restages rn, rp and wts
  }
}

// Step 2, thread k of N x P of one (b, h): S_in[c] over ds[c] (S_in[0] =
// h0 or 0), G_out[c] over es[c] (G_out of the last chunk = dht or 0), and
// dh0 = G_in[0] where asked for.  Grid (ceil(N P / 256), B H).
__global__ void __launch_bounds__(kPassThreads)
    state_pass_kernel(float* __restrict__ ds, float* __restrict__ es,
                      const float* __restrict__ dec, const float* __restrict__ h0,
                      const float* __restrict__ dht, float* __restrict__ dh0, int NP, int nc) {
  const int k = blockIdx.x * kPassThreads + threadIdx.x;
  if (k >= NP) return;
  const size_t bh = blockIdx.y;
  const size_t base = bh * nc * NP + k;
  float s = h0 ? h0[bh * NP + k] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t i = base + (size_t)c * NP;
    const float d = ds[i];
    ds[i] = s;
    s = dec[bh * nc + c] * s + d;
  }
  float gg = dht ? dht[bh * NP + k] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t i = base + (size_t)c * NP;
    const float e = es[i];
    es[i] = gg;
    gg = dec[bh * nc + c] * gg + e;
  }
  if (dh0) dh0[bh * NP + k] = gg;
}

// Floats of chunk_grad_kernel's shared memory (the wrapper computes the
// same): whole Q x (N + 1), Q x (P + 1), N x (P + 1); a tile's TQ x N and
// TQ x P rows; two TQ x (Q + 1) weight tiles; a TQ x (N + 1) tile of
// terms summed over n; seven vectors of Q and 32 for a block sum.
__host__ __device__ inline size_t grad_smem_floats(int Q, int P, int N) {
  const int TQ = Q < kTile ? Q : kTile;
  return (size_t)Q * (N + 1) + (size_t)Q * (P + 1) + (size_t)N * (P + 1) + (size_t)TQ * N +
         (size_t)TQ * P + 2 * (size_t)TQ * (Q + 1) + (size_t)TQ * (N + 1) + 7 * (size_t)Q + 32;
}

// Step 3: dx, ddt, the per-head dB and dC and the chunk's share of da.
// s_in / g_out (B, H, nc, N, P) as step 2 left them.  pdb, pdc: (B, L, H,
// N) f32; pda: (B, H, nc).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chunk_grad_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const T* __restrict__ bm,
                      const T* __restrict__ cm, const T* __restrict__ dy,
                      const float* __restrict__ s_in, const float* __restrict__ g_out,
                      T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ pdb,
                      float* __restrict__ pdc, float* __restrict__ pda, int L, int H, int P, int G,
                      int N, int Q, int nc) {
  extern __shared__ float smem[];
  const int NB = N + 1, PB = P + 1, QB = Q + 1, TQ = min(kTile, Q);
  float* wn = smem;          // Q x NB: B (sweep 1), C (sweep 2)
  float* wp = wn + Q * NB;   // Q x PB: x, dy
  float* sg = wp + Q * PB;   // N x PB: S_in, G_out
  float* tn = sg + N * PB;   // TQ x N: the tile's rows of C, B
  float* tp = tn + TQ * N;   // TQ x P: of dy, x
  float* m1 = tp + TQ * P;   // TQ x QB: dW e dt (rows i), W (rows j)
  float* m2 = m1 + TQ * QB;  // TQ x QB: dW (C.B) e (rows i), dW e dt (rows j)
  float* red = m2 + TQ * QB;  // TQ x NB: terms summed over n
  float* dts = red + TQ * NB;
  float* cum = dts + Q;
  float* ecum = cum + Q;  // exp(cum_i)
  float* wl = ecum + Q;   // exp(cum_last - cum_j) dt_j
  float* dcum = wl + Q;
  float* ddts = dcum + Q;  // ddt without its a d(dt a) term
  float* su = ddts + Q;    // wl_j u_j
  float* part = su + Q;    // 32: a block sum's warp totals

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int tid = threadIdx.x, nt = blockDim.x, t0 = c * Q;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const float ah = a[h];
  chunk_cum(dt, ah, b, h, t0, L, H, Q, dts, cum);
  const float last = cum[Q - 1];
  for (int r = tid; r < Q; r += nt) {
    ecum[r] = expf(cum[r]);
    wl[r] = expf(last - cum[r]) * dts[r];
    dcum[r] = 0.f;
    ddts[r] = 0.f;
  }
  const size_t chunk = ((size_t)b * H + h) * nc + c;
  const float* s_c = s_in + chunk * N * P;
  const float* g_c = g_out + chunk * N * P;

  // sweep 1: rows i
  stage(wn, NB, bm, b, g, G, N, t0, 0, Q, L);
  stage(wp, PB, x, b, h, H, P, t0, 0, Q, L);
  for (int i = tid; i < N * P; i += nt) sg[(i / P) * PB + i % P] = s_c[i];
  for (int i0 = 0; i0 < Q; i0 += TQ) {
    const int ni = min(TQ, Q - i0), ncol = i0 + ni;  // j < ncol covers j <= i
    stage(tn, N, cm, b, g, G, N, t0, i0, ni, L);
    stage(tp, P, dy, b, h, H, P, t0, i0, ni, L);
    __syncthreads();
    for (int k = tid; k < ni * ncol; k += nt) {
      const int ii = k / ncol, j = k - ii * ncol, i = i0 + ii;
      float dcb = 0.f, z = 0.f;
      if (j <= i) {
        const float* ci = tn + ii * N;
        const float* bj = wn + j * NB;
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(ci[n], bj[n], cb);
        const float* dyi = tp + ii * P;
        const float* xj = wp + j * PB;
        float dw = 0.f;
        for (int p = 0; p < P; ++p) dw = fmaf(dyi[p], xj[p], dw);
        const float e = expf(cum[i] - cum[j]);
        dcb = dw * e * dts[j];
        z = dw * cb * e;
      }
      m1[ii * QB + j] = dcb;
      m2[ii * QB + j] = z;
    }
    __syncthreads();
    for (int k = tid; k < ni * N; k += nt) {
      const int ii = k / N, n = k - ii * N, i = i0 + ii;
      const float* wi = m1 + ii * QB;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(wi[j], wn[j * NB + n], intra);
      const float* sn = sg + n * PB;
      const float* dyi = tp + ii * P;
      float sdy = 0.f;
      for (int p = 0; p < P; ++p) sdy = fmaf(sn[p], dyi[p], sdy);
      const int t = t0 + i;
      if (t < L) pdc[(((size_t)b * L + t) * H + h) * N + n] = intra + ecum[i] * sdy;
      red[ii * NB + n] = tn[ii * N + n] * sdy;
    }
    __syncthreads();
    // row i: sum_j dW_ij W_ij and the carry term, one warp a row
    for (int ii = warp; ii < ni; ii += nwarps) {
      const int i = i0 + ii;
      float rt = 0.f, inter = 0.f;
      for (int j = lane; j <= i; j += 32) rt = fmaf(m2[ii * QB + j], dts[j], rt);
      for (int n = lane; n < N; n += 32) inter += red[ii * NB + n];
      rt = warp_sum(rt);
      inter = warp_sum(inter);
      if (lane == 0) dcum[i] += rt + ecum[i] * inter;
    }
    __syncthreads();
    // column j: sum_i dW_ij (C_i.B_j) e_ij over the tile's rows
    for (int j = tid; j < ncol; j += nt) {
      float z = 0.f;
      for (int ii = 0; ii < ni; ++ii) z += m2[ii * QB + j];
      ddts[j] += z;
      dcum[j] -= z * dts[j];
    }
    __syncthreads();  // the next tile restages tn, tp and rewrites m1, m2, red
  }

  // <G_out, S_in>, summed in a fixed order
  float gs = 0.f;
  for (int i = tid; i < N * P; i += nt) gs = fmaf(g_c[i], s_c[i], gs);
  gs = warp_sum(gs);
  if (lane == 0) part[warp] = gs;

  // sweep 2: columns j
  stage(wn, NB, cm, b, g, G, N, t0, 0, Q, L);
  stage(wp, PB, dy, b, h, H, P, t0, 0, Q, L);
  for (int i = tid; i < N * P; i += nt) sg[(i / P) * PB + i % P] = g_c[i];
  for (int j0 = 0; j0 < Q; j0 += TQ) {
    const int nj = min(TQ, Q - j0), nrow = Q - j0;  // rows i >= j0
    stage(tn, N, bm, b, g, G, N, t0, j0, nj, L);
    stage(tp, P, x, b, h, H, P, t0, j0, nj, L);
    __syncthreads();
    for (int k = tid; k < nj * nrow; k += nt) {
      const int jj = k / nrow, i = j0 + (k - jj * nrow), j = j0 + jj;
      float w = 0.f, dcb = 0.f;
      if (i >= j) {
        const float* ci = wn + i * NB;
        const float* bj = tn + jj * N;
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(ci[n], bj[n], cb);
        const float* dyi = wp + i * PB;
        const float* xj = tp + jj * P;
        float dw = 0.f;
        for (int p = 0; p < P; ++p) dw = fmaf(dyi[p], xj[p], dw);
        const float ed = expf(cum[i] - cum[j]) * dts[j];
        w = cb * ed;
        dcb = dw * ed;
      }
      m1[jj * QB + i] = w;
      m2[jj * QB + i] = dcb;
    }
    __syncthreads();
    for (int k = tid; k < nj * P; k += nt) {
      const int jj = k / P, p = k - jj * P, j = j0 + jj;
      const float* wj = m1 + jj * QB;
      float intra = 0.f;
      for (int i = j; i < Q; ++i) intra = fmaf(wj[i], wp[i * PB + p], intra);
      const float* bj = tn + jj * N;
      float gb = 0.f;
      for (int n = 0; n < N; ++n) gb = fmaf(bj[n], sg[n * PB + p], gb);
      const int t = t0 + j;
      if (t < L) st(dx, (((size_t)b * L + t) * H + h) * P + p, intra + wl[j] * gb);
    }
    for (int k = tid; k < nj * N; k += nt) {
      const int jj = k / N, n = k - jj * N, j = j0 + jj;
      const float* dj = m2 + jj * QB;
      float intra = 0.f;
      for (int i = j; i < Q; ++i) intra = fmaf(dj[i], wn[i * NB + n], intra);
      const float* sn = sg + n * PB;
      const float* xj = tp + jj * P;
      float gx = 0.f;
      for (int p = 0; p < P; ++p) gx = fmaf(sn[p], xj[p], gx);
      const int t = t0 + j;
      if (t < L) pdb[(((size_t)b * L + t) * H + h) * N + n] = intra + wl[j] * gx;
      red[jj * NB + n] = tn[jj * N + n] * gx;
    }
    __syncthreads();
    // u_j = B_j^T G_out x_j, one warp a column
    for (int jj = warp; jj < nj; jj += nwarps) {
      const int j = j0 + jj;
      float u = 0.f;
      for (int n = lane; n < N; n += 32) u += red[jj * NB + n];
      u = warp_sum(u);
      if (lane == 0) {
        ddts[j] += expf(last - cum[j]) * u;
        su[j] = wl[j] * u;
        dcum[j] -= su[j];
      }
    }
    __syncthreads();
  }

  // d(dt a) = the reverse cumsum of dcum, the last row first taking the
  // carry of the chunk's final state; ddt; the chunk's share of da
  if (tid == 0) {
    float gsum = 0.f;
    for (int w = 0; w < nwarps; ++w) gsum += part[w];
    float carry = expf(last) * gsum;
    for (int j = 0; j < Q; ++j) carry += su[j];
    dcum[Q - 1] += carry;
    float run = 0.f, da = 0.f;
    for (int r = Q - 1; r >= 0; --r) {
      run += dcum[r];
      dcum[r] = run;
      da = fmaf(dts[r], run, da);
    }
    pda[chunk] = da;
  }
  __syncthreads();
  for (int r = tid; r < Q; r += nt) {
    const int t = t0 + r;
    if (t < L) ddt[((size_t)b * L + t) * H + h] = ddts[r] + ah * dcum[r];
  }
}

// Step 4: db / dc (B, L, G, N) in the inputs' type = the per-head partials
// (B, L, H, N) summed over the group's heads in order.  Grid (B L G).
template <typename T>
__global__ void __launch_bounds__(128)
    group_sum_kernel(const float* __restrict__ pdb, const float* __restrict__ pdc,
                     T* __restrict__ db, T* __restrict__ dc, int H, int G, int N) {
  const size_t row = blockIdx.x;  // (b, t) * G + g
  const size_t bt = row / G;
  const int g = (int)(row - bt * G), rep = H / G;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      const size_t i = (bt * H + (size_t)g * rep + r) * N + n;
      sb += pdb[i];
      sc += pdc[i];
    }
    st(db, row * N + n, sb);
    st(dc, row * N + n, sc);
  }
}

// Step 5: da[h] = sum over b, then chunks, of pda (B, H, nc), in order.
__global__ void __launch_bounds__(128)
    da_kernel(const float* __restrict__ pda, float* __restrict__ da, int B, int H, int nc) {
  for (int h = blockIdx.x * blockDim.x + threadIdx.x; h < H; h += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < B; ++b)
      for (int c = 0; c < nc; ++c) s += pda[((size_t)b * H + h) * nc + c];
    da[h] = s;
  }
}

// --------------------------------------------------------------------------
// bf16: the products on wgmma
// --------------------------------------------------------------------------
constexpr int kMaxHeads = 8;  // heads a block of step 2 sums dB / dC over
// tile_grad_kernel: the own tile's N- and P-wide operands (kT rows), the
// keys' (kQ rows), the state's pairs (64 rows p x kNmax, high parts and
// remainders), all swizzled; cum, dt, the scan's warp totals, and the
// slack to align to 1024.  106 KB: two blocks an SM, as the registers
// allow.
constexpr size_t kGradSmem =
    (kT * 2 + kT + kQ * 2 + kQ + 2 * 64 * 2) * kTileRow + (2 * kQ + 4) * 4 + 1024;

// The block's sum of v in a fixed order (each warp's by a butterfly, then
// the warps' totals in order), in every thread.  tot: a slot a warp.
__device__ __forceinline__ float block_sum(float v, float* tot) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) tot[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += tot[w];
  __syncthreads();  // tot may be written again
  return s;
}

// sum_{k >= r} v_k over a chunk's rows, thread r holding row r: warp
// scans from the top, then the later warps' totals in order.
__device__ __forceinline__ float reverse_cumsum(float v, float* tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += u;
  }
  if (lane == 0) tot[w] = v;
  __syncthreads();
  float after = 0.f;
  for (int k = kQ / 32 - 1; k > w; --k) after += tot[k];
  __syncthreads();
  return after + v;
}

constexpr int kPairStride = 64 + 8;  // bf16 row stride of a staged 64 x 64 tile of pairs
static_assert(2 * 64 * kPairStride <= 2 * 64 * kBtStride,
              "the staged pairs fit the chunk-state product's transposed tiles");

// acc (chunk_state_product's layout: rows n of the block's half, columns
// p) as bf16 pairs into dst (2, P, N): [0, p, n] the high parts, [1, p, n]
// the remainders.  Staged through shared memory (st: 2 x 64 x kPairStride
// bf16) so that each row p leaves as 128 contiguous bytes.
__device__ __forceinline__ void store_pairs(bf16* __restrict__ dst, const float (&acc)[32],
                                            bf16* st, int half, int P, int N) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  bf16* sl = st + 64 * kPairStride;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = (8 * jj + c0 + (e & 1)) * kPairStride + r0 + 8 * (e >> 1);
      split(acc[4 * jj + e], st[q], sl[q]);
    }
  __syncthreads();
  const size_t np = (size_t)N * P;
  for (int i = tid; i < 2 * 64 * 8; i += kWG) {
    const int lo = i >> 9, p = (i >> 3) & 63, ch = i & 7, n0 = 64 * half + 8 * ch;
    if (p < P && n0 < N)
      *reinterpret_cast<uint4*>(dst + lo * np + (size_t)p * N + n0) =
          *reinterpret_cast<const uint4*>((lo ? sl : st) + p * kPairStride + 8 * ch);
  }
  __syncthreads();
}

// This thread's share of <acc, S> over the block's rows n, S read back
// from its pairs src (2, P, N) as step 2 reads them (through shared
// memory st, as store_pairs writes them).
__device__ __forceinline__ float pair_dot(const float (&acc)[32], const bf16* __restrict__ src,
                                          bf16* st, int half, int P, int N) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  bf16* sl = st + 64 * kPairStride;
  const size_t np = (size_t)N * P;
  for (int i = tid; i < 2 * 64 * 8; i += kWG) {
    const int lo = i >> 9, p = (i >> 3) & 63, ch = i & 7, n0 = 64 * half + 8 * ch;
    const bool in = p < P && n0 < N;
    cp_async16(smem_u32((lo ? sl : st) + p * kPairStride + 8 * ch),
               in ? src + lo * np + (size_t)p * N + n0 : src, in ? 16u : 0u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = (8 * jj + c0 + (e & 1)) * kPairStride + r0 + 8 * (e >> 1);
      s = fmaf(acc[4 * jj + e], __bfloat162float(st[q]) + __bfloat162float(sl[q]), s);
    }
  __syncthreads();
  return s;
}

// acc = the rows n of the block's half of src (N, P) f32, or 0 without
// src; and back.
__device__ __forceinline__ void load_rows(float (&acc)[32], const float* __restrict__ src,
                                          int half, int P, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int na = 64 * half + 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = na + 8 * r, p = 8 * jj + c0;
      const float2 v = src && n < N && p < P
                           ? *reinterpret_cast<const float2*>(src + (size_t)n * P + p)
                           : make_float2(0.f, 0.f);
      acc[4 * jj + 2 * r] = v.x;
      acc[4 * jj + 2 * r + 1] = v.y;
    }
}
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&acc)[32],
                                           int half, int P, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int na = 64 * half + 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = na + 8 * r, p = 8 * jj + c0;
      if (n < N && p < P)
        *reinterpret_cast<float2*>(dst + (size_t)n * P + p) =
            make_float2(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
    }
}

// Steps 1-2: grid (halves of N, H, B), one warpgroup carrying the rows n
// of one 64-wide half of the state over the chunks in wgmma accumulators
// (chunk_state_product, the forward's step-1 product):
//   forward: S_in[0] = h0 (or 0), S_in[c + 1] = exp(cum_last_c) S_in[c] +
//     (wl o B)^T X of chunk c; each S_in[c] (c > 0, or with h0) into sp
//     (B, H, nc, 2, P, N) as bf16 pairs, laid out as step 2 reads them;
//   reverse: G_out[nc - 1] = dht (or 0), G_out[c - 1] = exp(cum_last_c)
//     G_out[c] + (exp(cum) o C)^T dY of chunk c; each G_out[c] (c < nc - 1,
//     or with dht) into gp likewise; dh0 = G_in[0] where asked for;
//   gsp (B, H, nc, halves): the half's <G_out[c], S_in[c]>, S_in read back
//     as step 2 reads it, summed in a fixed order.
// Three blocks an SM (at most 170 registers, 53 KB of shared memory): a
// block's chain of dependent products is latency, which more blocks hide
// (on an H100 at the training call 0.095 ms against 0.114 with two).
__global__ void __launch_bounds__(kWG, 3)
    state_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 const float* __restrict__ dt, const float* __restrict__ a,
                 const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                 const float* __restrict__ h0, const float* __restrict__ dht,
                 bf16* __restrict__ sp, bf16* __restrict__ gp, float* __restrict__ gsp,
                 float* __restrict__ dh0, int L, int H, int P, int G, int N, int nc) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  // the staged pairs and the block sums' totals use the product's place for
  // its transposed tiles and its scan's totals, free between products
  bf16* st = reinterpret_cast<bf16*>(smem_raw + (((raw + 1023) & ~1023u) - raw) + kQ * kTileRow);
  float* tot = reinterpret_cast<float*>(st + 2 * 64 * kBtStride) + 2 * kQ;
  const int nh = gridDim.x, half = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  launch_dependents();  // step 2's blocks may start their intra-chunk part
  const size_t bh = (size_t)b * H + h, np = (size_t)N * P;
  const size_t xy = (size_t)b * L * H * P + (size_t)h * P;
  const size_t bc = (size_t)b * L * G * N + (size_t)g * N;
  const float ah = a[h];
  float acc[32];
  load_rows(acc, h0 ? h0 + bh * np : nullptr, half, P, N);
  for (int c = 0; c < nc; ++c) {
    if (c > 0 || h0) store_pairs(sp + (bh * nc + c) * 2 * np, acc, st, half, P, N);
    if (c + 1 < nc)
      chunk_state_product(acc, true, 0, smem_raw, x + xy, bm + bc, dt, ah, b, h, c, half, L, H, P,
                          G, N);
  }
  load_rows(acc, dht ? dht + bh * np : nullptr, half, P, N);
  for (int c = nc - 1; c >= 0; --c) {
    const size_t chunk = bh * nc + c;
    if (c + 1 < nc || dht) store_pairs(gp + chunk * 2 * np, acc, st, half, P, N);
    const float part = c > 0 || h0 ? pair_dot(acc, sp + chunk * 2 * np, st, half, P, N) : 0.f;
    const float gs = block_sum(part, tot);
    if (threadIdx.x == 0) gsp[chunk * nh + half] = gs;
    if (c > 0 || dh0)
      chunk_state_product(acc, true, 1, smem_raw, dy + xy, cm + bc, dt, ah, b, h, c, half, L, H, P,
                          G, N);
  }
  if (dh0) store_rows(dh0 + bh * np, acc, half, P, N);
}

// A step of 16 columns of a swizzled tile of `rows` rows: a step inside a
// 64-column block moves 32 bytes within the swizzle atom.
__device__ __forceinline__ uint32_t kstep(int kk, int rows) {
  return (kk >> 2) * (rows * kTileRow) + (kk & 3) * 32;
}

// Two bf16 of a swizzled tile of `rows` rows (row r, columns k, k + 1; k
// even), as a 32-bit word.
__device__ __forceinline__ uint32_t tile_u32(const unsigned char* tile, int rows, int r, int k) {
  return *reinterpret_cast<const uint32_t*>(tile + swz(rows, r, k >> 3) + (k & 7) * 2);
}

// The gradients of one 64-row tile of one chunk in one sweep, for the hb
// heads of head group blockIdx.y (the caller has the block's shared
// memory and its indices).  kCol = false, rows i: dC, and the row terms
// of dcum into terms[0]; kCol = true, columns j: dx, dB, and sum_i dW o
// CB o e into terms[1], u into terms[2].  terms: (3, B, H, nc, kQ) f32.
// dB / dC, summed over the block's heads in head order in the
// accumulators, go to out (B, L, G, N) when the block spans its group,
// else to part (B, L, H / hb, N) f32.
template <bool kCol>
__device__ __forceinline__ void grad_tile(
    unsigned char* smem_raw, const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const bf16* __restrict__ bm, const bf16* __restrict__ cm,
    const bf16* __restrict__ dy, const bf16* __restrict__ sp, const bf16* __restrict__ gp,
    int has_h0, int has_dht, bf16* __restrict__ dx, float* __restrict__ terms,
    float* __restrict__ part, bf16* __restrict__ out, int B, int L, int H, int P, int G, int N,
    int nc, int hb) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t on_s = (raw + 1023) & ~1023u;    // own N-wide: kT x kNmax (C or B)
  const uint32_t op_s = on_s + kT * 2 * kTileRow;  // own P-wide: kT x 64 (dy or x)
  const uint32_t kn_s = op_s + kT * kTileRow;      // keys N-wide: kQ x kNmax (B or C)
  const uint32_t kp_s = kn_s + kQ * 2 * kTileRow;  // keys P-wide: kQ x 64 (x or dy)
  // the state's pairs (S_in or G_out; rows p, columns n), high parts and
  // remainders
  const uint32_t sh = kp_s + kQ * kTileRow, sl = sh + 64 * 2 * kTileRow;
  const unsigned char* base = smem_raw + (on_s - raw);
  float* cums = reinterpret_cast<float*>(smem_raw + (sl - raw) + 64 * 2 * kTileRow);
  float* dts = cums + kQ;
  float* tot = dts + kQ;

  const int tile = (blockIdx.x >> 1) & 1, c = blockIdx.x >> 2;
  const int hg = blockIdx.y, b = blockIdx.z, g = hg * hb / (H / G);
  const int tid = threadIdx.x, t0 = c * kQ, o0 = tile * kT;
  const int k_lo = kCol ? o0 : 0, k_rows = kCol ? kQ - o0 : o0 + kT;
  const size_t bc = (size_t)b * L * G * N + (size_t)g * N;  // (b, t = 0, g) of B and C
  // the group's N-wide tiles, once; each head's P-wide tiles
  load_tile(on_s, kT, kT, 16, (kCol ? bm : cm) + bc, (size_t)G * N, t0 + o0, L, N);
  load_tile(kn_s + k_lo * kTileRow, kQ, k_rows, 16, (kCol ? cm : bm) + bc, (size_t)G * N,
            t0 + k_lo, L, N);
  auto load_p = [&](int h) {
    const size_t xy = (size_t)b * L * H * P + (size_t)h * P;  // (b, t = 0, h) of x and dy
    load_tile(op_s, kT, kT, 8, (kCol ? x : dy) + xy, (size_t)H * P, t0 + o0, L, P);
    load_tile(kp_s + k_lo * kTileRow, kQ, k_rows, 8, (kCol ? dy : x) + xy, (size_t)H * P,
              t0 + k_lo, L, P);
  };
  load_p(hg * hb);
  cp_async_commit();

  // this thread's own rows ra, rb (of the chunk) and columns 8 jj + c0 (+1)
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int ra = o0 + r0, rb = ra + 8;
  const bool has = kCol ? c + 1 < nc || has_dht : c > 0 || has_h0;  // a nonzero state
  float an[64];  // dC (rows i) or dB (columns j), kT x kNmax, over the block's heads
#pragma unroll
  for (int k = 0; k < 64; ++k) an[k] = 0.f;

  for (int h = hg * hb; h < (hg + 1) * hb; ++h) {
    const float d = t0 + tid < L ? dt[((size_t)b * L + t0 + tid) * H + h] : 0.f;
    cums[tid] = chunk_cumsum(d * a[h], tot);
    dts[tid] = d;
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();
    const float cum_a = cums[ra], cum_b = cums[rb], last = cums[kQ - 1];

    float ap[32];  // dx (columns j): kT x 64
#pragma unroll
    for (int k = 0; k < 32; ++k) ap[k] = 0.f;
    float rs_a = 0.f, rs_b = 0.f;  // the row sums: dW o W (rows i), dW o CB o e (columns j)

    // the intra-chunk part first: it needs nothing of step 1, so the first
    // heads' run while step 1 does
#pragma unroll
    for (int kt = 0; kt < kQ / kT; ++kt) {
      if (kCol ? kt < tile : kt > tile) continue;
      const uint32_t kn_t = kn_s + kt * (kT * kTileRow), kp_t = kp_s + kt * (kT * kTileRow);
      // s = own_N keys_N^T, dd = own_P keys_P^T; s[4 jj + e] is own row ra /
      // rb (e >> 1), key 64 kt + 8 jj + c0 + (e & 1)
      float s[32], dd[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kNmax / 16; ++kk)
        wgmma_ss(s, desc(on_s + kstep(kk, kT), 16, 1024), desc(kn_t + kstep(kk, kQ), 16, 1024),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(dd, desc(op_s + kstep(kk, kT), 16, 1024), desc(kp_t + kstep(kk, kQ), 16, 1024),
                 kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dd);
      // dCB (rows i) or dCB^T (columns j), and W^T (columns j), in
      // registers as A fragments: bf16 high parts and remainders
      uint32_t ph[kT / 16][4], pl[kT / 16][4], wh[kT / 16][4], wlo[kT / 16][4];
#pragma unroll
      for (int jj = 0; jj < kT / 8; ++jj) {
        float vd[4], vw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e & 2 ? rb : ra;
          const float cr = e & 2 ? cum_b : cum_a;
          const int k = kT * kt + 8 * jj + c0 + (e & 1);
          const float sv = s[4 * jj + e], dv = dd[4 * jj + e];
          vd[e] = vw[e] = 0.f;
          if (kCol ? k >= r : k <= r) {
            const float ex = kCol ? expf(cums[k] - cr) : expf(cr - cums[k]);
            const float dtj = dts[kCol ? r : k];
            vd[e] = dv * ex * dtj;
            if (kCol) {
              vw[e] = sv * ex * dtj;
              (e & 2 ? rs_b : rs_a) += dv * sv * ex;
            } else {
              (e & 2 ? rs_b : rs_a) += dv * (sv * ex * dtj);
            }
          }
        }
        split2(vd[0], vd[1], ph[jj >> 1][(jj & 1) * 2], pl[jj >> 1][(jj & 1) * 2]);
        split2(vd[2], vd[3], ph[jj >> 1][(jj & 1) * 2 + 1], pl[jj >> 1][(jj & 1) * 2 + 1]);
        if (kCol) {
          split2(vw[0], vw[1], wh[jj >> 1][(jj & 1) * 2], wlo[jj >> 1][(jj & 1) * 2]);
          split2(vw[2], vw[3], wh[jj >> 1][(jj & 1) * 2 + 1], wlo[jj >> 1][(jj & 1) * 2 + 1]);
        }
      }
      // an += dCB keys_N, ap += W^T keys_P: 16 keys a step, the keys
      // MN-major (64-column blocks kQ rows apart, 8-key groups 1024 B)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        const uint64_t bn = desc(kn_t + 16 * kk * kTileRow, kQ * kTileRow, 1024);
        wgmma_rs(an, ph[kk], bn, 1);
        wgmma_rs(an, pl[kk], bn, 1);
        if (kCol) {
          const uint64_t bp = desc(kp_t + 16 * kk * kTileRow, kQ * kTileRow, 1024);
          wgmma_rs(ap, wh[kk], bp, 1);
          wgmma_rs(ap, wlo[kk], bp, 1);
        }
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(an);
      fence_regs(ph);
      fence_regs(pl);
      if (kCol) {
        fence_regs(ap);
        fence_regs(wh);
        fence_regs(wlo);
      }
    }

    // then the state terms, on the pairs step 1 wrote
    wait_dependencies();  // every block waits: the backward ends after step 1 has
    // A = own_P from shared memory into registers: rows r0, r0 + 8,
    // columns 16 kk + c0 (+1, +8, +9)
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        af[kk][e] =
            tile_u32(base + (op_s - on_s), kT, r0 + 8 * (e & 1), 16 * kk + c0 + 8 * (e >> 1));
    __syncthreads();  // every warp is done with this head's P-wide tiles
    if (has) {
      const bf16* src = (kCol ? gp : sp) + (((size_t)b * H + h) * nc + c) * 2 * (size_t)N * P;
      load_tile(sh, 64, 64, kNmax / 8, src, N, 0, P, N);  // rows p, columns n
      load_tile(sl, 64, 64, kNmax / 8, src + (size_t)N * P, N, 0, P, N);
    }
    cp_async_commit();
    if (h + 1 < (hg + 1) * hb) load_p(h + 1);  // the next head's tiles fly meanwhile
    cp_async_commit();
    const float sa = kCol ? expf(last - cum_a) * dts[ra] : expf(cum_a);  // wl_j or exp(cum_i)
    const float sb = kCol ? expf(last - cum_b) * dts[rb] : expf(cum_b);
    float v_a = 0.f, v_b = 0.f;  // own_N . T: C_i . (S_in dy_i) or u_j
    if (has) {
      cp_async_wait<1>();  // the pairs
      fence_async_shared();
      __syncthreads();
      // T = own_P St^T (S_in dy_i or G_out x_j): 16 columns p a step, the
      // pairs MN-major (two 64-column blocks of n, 64 rows p apart)
      float tt[64];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(tt, af[kk], desc(sh + 16 * kk * kTileRow, 64 * kTileRow, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(tt, af[kk], desc(sl + 16 * kk * kTileRow, 64 * kTileRow, 1024), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(tt);
      fence_regs(af);
#pragma unroll
      for (int jj = 0; jj < kNmax / 8; ++jj) {
        const float2 ua = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            base + swz(kT, r0, jj) + c0 * 2));
        const float2 ub = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            base + swz(kT, r0 + 8, jj) + c0 * 2));
        v_a = fmaf(ua.x, tt[4 * jj], fmaf(ua.y, tt[4 * jj + 1], v_a));
        v_b = fmaf(ub.x, tt[4 * jj + 2], fmaf(ub.y, tt[4 * jj + 3], v_b));
        an[4 * jj] += sa * tt[4 * jj];
        an[4 * jj + 1] += sa * tt[4 * jj + 1];
        an[4 * jj + 2] += sb * tt[4 * jj + 2];
        an[4 * jj + 3] += sb * tt[4 * jj + 3];
      }
      if (kCol) {
        // ap += wl_j (B_j G_out): the pairs K-major (rows p, columns n)
        float gg[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kNmax / 16; ++kk)
          wgmma_ss(gg, desc(on_s + kstep(kk, kT), 16, 1024), desc(sh + kstep(kk, 64), 16, 1024),
                   kk > 0);
#pragma unroll
        for (int kk = 0; kk < kNmax / 16; ++kk)
          wgmma_ss(gg, desc(on_s + kstep(kk, kT), 16, 1024), desc(sl + kstep(kk, 64), 16, 1024), 1);
        wg_commit();
        wg_wait<0>();
        fence_regs(gg);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          ap[4 * jj] += sa * gg[4 * jj];
          ap[4 * jj + 1] += sa * gg[4 * jj + 1];
          ap[4 * jj + 2] += sb * gg[4 * jj + 2];
          ap[4 * jj + 3] += sb * gg[4 * jj + 3];
        }
      }
    }

    // the rows' terms: a quad holds a row, its lanes' partial sums added
    // by a butterfly
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      rs_a += __shfl_xor_sync(0xffffffffu, rs_a, o);
      rs_b += __shfl_xor_sync(0xffffffffu, rs_b, o);
      v_a += __shfl_xor_sync(0xffffffffu, v_a, o);
      v_b += __shfl_xor_sync(0xffffffffu, v_b, o);
    }
    const size_t chunk = ((size_t)b * H + h) * nc + c, plane = (size_t)B * H * nc * kQ;
    if ((lane & 3) == 0) {
      float* tr = terms + chunk * kQ;
      if (kCol) {
        tr[plane + ra] = rs_a;
        tr[plane + rb] = rs_b;
        tr[2 * plane + ra] = v_a;
        tr[2 * plane + rb] = v_b;
      } else {
        tr[ra] = rs_a + sa * v_a;
        tr[rb] = rs_b + sb * v_b;
      }
    }
    if (kCol) {
      bf16* xb = dx + (size_t)b * L * H * P + (size_t)h * P;
      const int ta = t0 + ra, tb = t0 + rb;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int p = 8 * jj + c0;
        if (p >= P) continue;
        if (ta < L)
          *reinterpret_cast<__nv_bfloat162*>(xb + (size_t)ta * H * P + p) =
              __floats2bfloat162_rn(ap[4 * jj], ap[4 * jj + 1]);
        if (tb < L)
          *reinterpret_cast<__nv_bfloat162*>(xb + (size_t)tb * H * P + p) =
              __floats2bfloat162_rn(ap[4 * jj + 2], ap[4 * jj + 3]);
      }
    }
    __syncthreads();  // every warp is done with the pairs and cum before the next head
  }

  // the heads' dB or dC: rows ra, rb and columns 8 jj + c0 (+1)
  const bool whole = H / G == hb;  // the block spans its group: dB / dC itself
  const int ta = t0 + ra, tb = t0 + rb;
#pragma unroll
  for (int jj = 0; jj < kNmax / 8; ++jj) {
    const int n = 8 * jj + c0;
    if (n >= N) continue;  // N % 8 == 0: n < N means n + 1 < N
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r ? tb : ta;
      if (t >= L) continue;
      const float v0 = an[4 * jj + 2 * r], v1 = an[4 * jj + 2 * r + 1];
      if (whole)
        *reinterpret_cast<__nv_bfloat162*>(out + (((size_t)b * L + t) * G + g) * N + n) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(part + (((size_t)b * L + t) * (H / hb) + hg) * N + n) =
            make_float2(v0, v1);
    }
  }
}

// Step 2: grid (nc x 2 tiles x 2 sweeps, H / hb, B), blockIdx.x = (2 c +
// tile) 2 + sweep, blockIdx.y the group of hb heads (hb divides H / G).
// sp, gp: step 1's pairs (S_in of the first chunk only with h0, G_out of
// the last only with dht).  dB / dC into db / dc when a block spans its
// group (H / G == hb), else into pdb / pdc (B, L, H / hb, N) f32.
__global__ void __launch_bounds__(kWG, 1)
    tile_grad_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const bf16* __restrict__ bm,
                     const bf16* __restrict__ cm, const bf16* __restrict__ dy,
                     const bf16* __restrict__ sp, const bf16* __restrict__ gp, int has_h0,
                     int has_dht, bf16* __restrict__ dx, float* __restrict__ terms,
                     float* __restrict__ pdb, float* __restrict__ pdc, bf16* __restrict__ db,
                     bf16* __restrict__ dc, int B, int L, int H, int P, int G, int N, int nc,
                     int hb) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (blockIdx.x & 1)
    grad_tile<true>(smem_raw, x, dt, a, bm, cm, dy, sp, gp, has_h0, has_dht, dx, terms, pdb, db,
                    B, L, H, P, G, N, nc, hb);
  else
    grad_tile<false>(smem_raw, x, dt, a, bm, cm, dy, sp, gp, has_h0, has_dht, dx, terms, pdc, dc,
                     B, L, H, P, G, N, nc, hb);
}

// Step 3: grid (nc, H, B), thread r = row r of the chunk: dcum from the
// sweeps' terms, the carry of the chunk's final state on its last row,
// d(dt a) = its reverse cumsum, ddt, and the chunk's share of da into pda
// (B, H, nc).  gsp: step 1's nblk shares of <G_out, S_in> a chunk.
// Launched plainly after step 2, so it starts once step 2 has completed.
__global__ void __launch_bounds__(kQ)
    finish_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                  const float* __restrict__ terms, const float* __restrict__ gsp, int nblk,
                  float* __restrict__ ddt, float* __restrict__ pda, int B, int L, int H, int nc) {
  __shared__ float tot[kQ / 32];
  __shared__ float last_s;
  launch_dependents();  // step 4's blocks may take their places and wait
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, r = threadIdx.x, t = c * kQ + r;
  const float ah = a[h];
  const float d = t < L ? dt[((size_t)b * L + t) * H + h] : 0.f;
  const float cum = chunk_cumsum(d * ah, tot);
  if (r == kQ - 1) last_s = cum;
  __syncthreads();
  const float last = last_s;
  const size_t chunk = ((size_t)b * H + h) * nc + c, plane = (size_t)B * H * nc * kQ;
  const float rowt = terms[chunk * kQ + r], z = terms[plane + chunk * kQ + r],
              u = terms[2 * plane + chunk * kQ + r];
  const float el = expf(last - cum), wu = el * d * u;  // exp(cum_last - cum_j), wl_j u_j
  float dcum = rowt - d * z - wu;
  const float carry = block_sum(wu, tot);
  if (r == kQ - 1) {
    float gs = 0.f;
    for (int k = 0; k < nblk; ++k) gs += gsp[chunk * nblk + k];
    dcum += expf(last) * gs + carry;
  }
  const float dda = reverse_cumsum(dcum, tot);  // d(dt a)
  if (t < L) ddt[((size_t)b * L + t) * H + h] = z + el * u + ah * dda;
  const float share = block_sum(d * dda, tot);
  if (r == 0) pda[chunk] = share;
}

// Step 4: dB and dC of row (b, t, g) = blockIdx.x, each the in-order sum
// of its group's H / hb / G head groups' partials (B, L, H / hb, N) f32;
// and in the last block da[h] = the shares of every (b, chunk) in order.
__global__ void __launch_bounds__(128)
    group_da_kernel(const float* __restrict__ pdb, const float* __restrict__ pdc,
                    bf16* __restrict__ db, bf16* __restrict__ dc, int hc, int G, int N,
                    const float* __restrict__ pda, float* __restrict__ da, int B, int H, int nc) {
  wait_dependencies();  // the partials of step 2 and the shares of step 3
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.f;
      for (int b = 0; b < B; ++b)
        for (int c = 0; c < nc; ++c) s += pda[((size_t)b * H + h) * nc + c];
      da[h] = s;
    }
    return;
  }
  const size_t row = blockIdx.x, bt = row / G;
  const int g = (int)(row - bt * G), k = hc / G;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float sb = 0.f, sc = 0.f;
    for (int q = 0; q < k; ++q) {
      const size_t i = (bt * hc + (size_t)g * k + q) * N + n;
      sb += pdb[i];
      sc += pdc[i];
    }
    db[row * N + n] = __float2bfloat16(sb);
    dc[row * N + n] = __float2bfloat16(sc);
  }
}

int launch_bf16(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                const void* h0, const void* dy, const void* dht, void* dx, void* ddt, void* da,
                void* db, void* dc, void* dh0, void* sp, void* gp, void* gsp, void* terms,
                void* pdb, void* pdc, void* pda, int B, int L, int H, int P, int G, int N, int hb,
                cudaStream_t s) {
  const bool parts = G >= 1 && H % G == 0 && hb >= 1 && H / G > hb;
  if (B < 1 || L < 1 || H < 1 || G < 1 || H % G || N < 8 || N > kNmax || N % 8 || P < 8 ||
      P > 64 || P % 8 || hb < 1 || hb > kMaxHeads || (H / G) % hb ||
      B > 65535 || H > 65535 || (parts && (!pdb || !pdc)) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
        reinterpret_cast<uintptr_t>(cm) | reinterpret_cast<uintptr_t>(dy)) & 15))
    return (int)cudaErrorInvalidValue;
  static SmemLimit lim_state, lim_grad;
  if (const int e = raise_smem(state_kernel, kStateSmem, lim_state)) return e;
  if (const int e = raise_smem(tile_grad_kernel, kGradSmem, lim_grad)) return e;
  const int nc = (L + kQ - 1) / kQ, nh = (N + 63) / 64;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bm);
  const bf16* cb = static_cast<const bf16*>(cm);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  bf16* spb = static_cast<bf16*>(sp);
  bf16* gpb = static_cast<bf16*>(gp);
  float* gspf = static_cast<float*>(gsp);
  float* tf = static_cast<float*>(terms);
  float* pdbf = static_cast<float*>(pdb);
  float* pdcf = static_cast<float*>(pdc);
  float* pdaf = static_cast<float*>(pda);
  state_kernel<<<dim3(nh, H, B), kWG, kStateSmem, s>>>(
      xb, dyb, dtf, af, bb, cb, static_cast<const float*>(h0), static_cast<const float*>(dht), spb,
      gpb, gspf, static_cast<float*>(dh0), L, H, P, G, N, nc);
  if (const int e = (int)cudaGetLastError()) return e;
  if (const int e = launch_dependent(
          tile_grad_kernel, dim3(4 * nc, H / hb, B), kWG, kGradSmem, s, xb, dtf, af, bb, cb, dyb,
          (const bf16*)spb, (const bf16*)gpb, (int)(h0 != nullptr), (int)(dht != nullptr),
          static_cast<bf16*>(dx), tf, pdbf, pdcf, static_cast<bf16*>(db), static_cast<bf16*>(dc),
          B, L, H, P, G, N, nc, hb))
    return e;
  // a plain launch: it reads every block's terms, and a programmatic
  // dependent of step 2 was seen (on an H100, when step 2 summed its heads
  // in thread-block clusters) to pass its griddepcontrol.wait while step
  // 2's last blocks still ran
  finish_kernel<<<dim3(nc, H, B), kQ, 0, s>>>(dtf, af, tf, gspf, nh, static_cast<float*>(ddt),
                                             pdaf, B, L, H, nc);
  if (const int e = (int)cudaGetLastError()) return e;
  return launch_dependent(group_da_kernel, dim3(parts ? (unsigned)((size_t)B * L * G) + 1 : 1u),
                          128, 0, s, (const float*)pdbf, (const float*)pdcf,
                          static_cast<bf16*>(db), static_cast<bf16*>(dc), H / hb, G, N,
                          (const float*)pdaf, static_cast<float*>(da), B, H, nc);
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
           const void* h0, const void* dy, const void* dht, void* dx, void* ddt, void* da,
           void* db, void* dc, void* dh0, void* ws_s, void* ws_g, void* ws_dec, void* pdb,
           void* pdc, void* pda, int B, int L, int H, int P, int G, int N, int Q,
           cudaStream_t s) {
  if (B < 1 || L < 1 || H < 1 || P < 1 || N < 1 || Q < 1 || G < 1 || H % G || B > 65535 ||
      H > 65535 || (size_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  static SmemLimit lim_sums, lim_grad;
  const size_t sums_smem = 4 * ((size_t)Q * (N + P) + 3 * (size_t)Q);
  const size_t grad_smem = 4 * grad_smem_floats(Q, P, N);
  if (const int e = raise_smem(chunk_sums_kernel<T>, sums_smem, lim_sums)) return e;
  if (const int e = raise_smem(chunk_grad_kernel<T>, grad_smem, lim_grad)) return e;
  const int nc = (L + Q - 1) / Q;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  const T* dyt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(ws_s);
  float* gf = static_cast<float*>(ws_g);
  float* decf = static_cast<float*>(ws_dec);
  const dim3 chunks(nc, H, B);
  chunk_sums_kernel<T><<<chunks, kThreads, sums_smem, s>>>(xt, dtf, af, bt, ct, dyt, sf, gf, decf,
                                                           L, H, P, G, N, Q, nc);
  if (const int e = (int)cudaGetLastError()) return e;
  const int NP = N * P;
  state_pass_kernel<<<dim3((NP + kPassThreads - 1) / kPassThreads, B * H), kPassThreads, 0, s>>>(
      sf, gf, decf, static_cast<const float*>(h0), static_cast<const float*>(dht),
      static_cast<float*>(dh0), NP, nc);
  if (const int e = (int)cudaGetLastError()) return e;
  chunk_grad_kernel<T><<<chunks, kThreads, grad_smem, s>>>(
      xt, dtf, af, bt, ct, dyt, sf, gf, static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(pdb), static_cast<float*>(pdc), static_cast<float*>(pda), L, H, P, G, N,
      Q, nc);
  if (const int e = (int)cudaGetLastError()) return e;
  group_sum_kernel<T><<<(unsigned)((size_t)B * L * G), 128, 0, s>>>(
      static_cast<const float*>(pdb), static_cast<const float*>(pdc), static_cast<T*>(db),
      static_cast<T*>(dc), H, G, N);
  if (const int e = (int)cudaGetLastError()) return e;
  da_kernel<<<(H + 127) / 128, 128, 0, s>>>(static_cast<const float*>(pda),
                                            static_cast<float*>(da), B, H, nc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Device pointers of contiguous tensors: x, dy, dx (B,L,H,P) and bm, cm,
// db, dc (B,L,G,N) in the entry point's type; dt, ddt (B,L,H), a, da (H,),
// h0, dht, dh0 (B,H,N,P) f32; h0, dht and dh0 may be null.  One call
// launches five (f32) or four (bf16) kernels: the wrapper counts it as
// one launch.
//
// f32: chunks of Q rows.  Scratch, nc = ceil(L / Q): ws_s, ws_g
// (B,H,nc,N,P) f32, ws_dec and pda (B,H,nc) f32, pdb and pdc (B,L,H,N)
// f32.  Shared memory, computed by the wrapper: 4 (Q (N + P) + 3 Q) bytes
// for step 1, 4 grad_smem_floats(Q, P, N) for step 3.
extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* a, const void* bm,
                                const void* cm, const void* h0, const void* dy, const void* dht,
                                void* dx, void* ddt, void* da, void* db, void* dc, void* dh0,
                                void* ws_s, void* ws_g, void* ws_dec, void* pdb, void* pdc,
                                void* pda, int B, int L, int H, int P, int G, int N, int Q,
                                void* stream) {
  return launch<float>(x, dt, a, bm, cm, h0, dy, dht, dx, ddt, da, db, dc, dh0, ws_s, ws_g, ws_dec,
                       pdb, pdc, pda, B, L, H, P, G, N, Q, static_cast<cudaStream_t>(stream));
}

// bf16: chunks of 128 rows; N <= 128 and P <= 64, multiples of 8; x, bm,
// cm and dy 16-byte aligned; hb, the heads a block of step 2 sums dB and
// dC over, at most 8 and dividing H / G.  Scratch, nc = ceil(L / 128),
// nh = ceil(N / 64): sp, gp (B,H,nc,2,P,N) bf16; gsp (B,H,nc,nh) f32;
// terms (3,B,H,nc,128) f32; pda (B,H,nc) f32; pdb, pdc (B,L,H/hb,N) f32
// when H / G > hb, else null.
extern "C" int ssd_scan_bwd_bf16(const void* x, const void* dt, const void* a, const void* bm,
                                 const void* cm, const void* h0, const void* dy, const void* dht,
                                 void* dx, void* ddt, void* da, void* db, void* dc, void* dh0,
                                 void* sp, void* gp, void* gsp, void* terms, void* pdb, void* pdc,
                                 void* pda, int B, int L, int H, int P, int G, int N, int hb,
                                 void* stream) {
  return launch_bf16(x, dt, a, bm, cm, h0, dy, dht, dx, ddt, da, db, dc, dh0, sp, gp, gsp, terms,
                     pdb, pdc, pda, B, L, H, P, G, N, hb, static_cast<cudaStream_t>(stream));
}
