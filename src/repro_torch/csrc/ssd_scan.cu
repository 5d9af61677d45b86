// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:25-132
// (ssd_scan / _ssd_kernel, pallas_call at :103).  Same function: for each
// batch row b and head h (reading B/C group g = h / (H / G)), in chunks of
// Q steps,
//   cum_i  = sum_{k <= i} dt_k a                      (within the chunk)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) C_i . S                        (S: carried state)
//   S     <- exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
// with S = h0 (or 0) before the first chunk; y is written in x's type and
// the final S (N x P, f32) once at the end.  Any L: rows past L read
// x = B = C = 0 and dt = 0, so cum stays flat there, their weights are 0
// and the state and the real rows are exact; their y is not stored.
//
// What bounds it: at mamba2-2.7b's scan (B = 1, H = 80 heads of P = 64,
// N = 128, one group, bf16 x/B/C, L = 256) the bytes are x, y, B, C, dt
// and the f32 state, about 8 MB, 2.4 us at 3.35 TB/s; the products are
// about 1.2 GFLOP (the causal half of C.B^T and W.X, C.S and the state
// update), 1.2 us on the bf16 tensor cores.  So only the tensor cores and
// a grid that fills the card can come near it.
//
// bf16 design: the chunked algorithm's parallel form (the decomposition
// Mamba2's own GPU kernels use), three launches of one entry point, each
// block one warpgroup of 128 threads, every product on wgmma with bf16
// operands and f32 accumulators (hopper.cuh's helpers):
//   1. chunk_state_kernel, grid (chunk x 64-wide half of N, head, batch;
//      its product, ssd_chunk.cuh's chunk_state_product, is also the
//      backward's): cum by warp scans; wl_j = exp(cum_last - cum_j) dt_j;
//      dS_c = (wl o B)^T X, an N x P product of depth Q, with A = (wl o B)^T
//      from registers (staged transposed in shared memory, a padded row
//      stride so the fragment loads are conflict-free) and B = the X tile,
//      MN-major (transpose-B, as K7's V); dS_c and exp(cum_last_c) go to
//      f32 scratch the wrapper allocates;
//   2. state_pass_kernel, elementwise over N x P (8 values of a column of
//      the state a thread), serial over the chunks: S_in[0] = h0 (or 0),
//      S_in[c + 1] = exp(cum_last_c) S_in[c] + dS_c in f32 registers; each
//      S_in[c] goes to bf16 scratch already split into its high parts and
//      remainders and transposed (rows p, columns n: the K-major B operand
//      of C S_in), so step 3 copies it like its other tiles; the last one
//      is the final state;
//   3. chunk_out_kernel, grid (chunk x 64-row tile, head, batch): at the
//      main path's prompts (1-3 chunks of 128) one block per (chunk, head)
//      would leave 80 of 132 SMs busy at L <= 128, so each chunk is two
//      tiles of 64 rows (160 blocks there).  A tile of rows [i0, i0 + 64)
//      copies C of its rows and B and X of rows [0, i0 + 64) with cp.async
//      into the 128-byte swizzle wgmma reads, then computes
//        for each 64-key tile jt <= the row tile:
//          S  = C B_jt^T                    wgmma, K-major, f32 in registers
//          W  = S o exp(cum_i - cum_j) dt_j where j <= i, else 0, in
//               registers: the accumulator layout of S is the A-fragment
//               layout of W (K7's register-A trick)
//          y += W X_jt                      wgmma, A = W from registers,
//                                           B = X, MN-major
//        y += exp(cum_i) (C S_in)           wgmma, A = C, B = S_in^T, both
//                                           K-major; S_in copied into B's
//                                           place (66 KB: 3 blocks an SM)
// Steps 2 and 3 are programmatic dependent launches: step 1's blocks let
// step 2's take their places at once, step 2's let step 3's start, and
// each waits (griddepcontrol.wait) only where it reads what the step
// before wrote.  So step 3's intra-chunk products, which need nothing of
// steps 1 and 2, run while they do; a CUDA graph keeps these edges.
// Precision: x, B, C are bf16 and enter the products exactly.  Three
// operands are f32 by nature, W, wl o B and S_in: each goes in as a bf16
// high part and the bf16 remainder, two products, 16 significant bits
// (K6 does the same for P); one bf16 rounding would put up to 2^-8 of
// relative error on every term, which the 1e-3 limits of the f32 state
// (and of y before its rounding) cannot absorb.
// Every exponential has an argument <= 0 (cum falls within a chunk):
// exp(cum_i - cum_j) for j <= i, exp(cum_last - cum_j), exp(cum_i),
// exp(cum_last); none is factored into exp(cum_i) exp(-cum_j), which
// overflows f32 once cum passes -88.
//
// f32 inputs keep the simple CUDA-core kernel (f32_kernel; reduced configs
// and tests only, no served config runs it on the card): one block per
// (h, b), the Pallas grid's sequential chunk axis a loop inside it, the
// carried state in shared memory; each chunk's x, B, C, dt, cum and decays
// staged in shared memory and W built one tile of TI rows at a time.  B is
// stored with a row stride of N + 1 so the lanes of a warp, which walk j,
// hit distinct banks.

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
constexpr int kThreads = 512;
constexpr int kRowTile = 32;  // TI: rows of W built at a time

__global__ void __launch_bounds__(kThreads)
    f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ h0, float* __restrict__ y,
               float* __restrict__ ht, int L, int H, int P, int G, int N, int Q) {
  extern __shared__ float smem[];
  const int NB = N + 1;                 // padded row stride of B
  const int TI = min(kRowTile, Q);
  float* xs = smem;                     // Q * P
  float* bs = xs + Q * P;               // Q * (N + 1)
  float* cs = bs + Q * NB;              // Q * N
  float* ss = cs + Q * N;               // N * P carried state
  float* ws = ss + N * P;               // TI * Q tile of W
  float* dts = ws + TI * Q;             // Q
  float* cum = dts + Q;                 // Q
  float* ecum = cum + Q;                // Q: exp(cum_i)
  float* wl = ecum + Q;                 // Q: exp(cum_last - cum_j) dt_j

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float ah = a[h];
  const size_t state_off = ((size_t)b * H + h) * N * P;

  for (int i = tid; i < N * P; i += nt) ss[i] = h0 ? h0[state_off + i] : 0.f;

  const int n_chunks = (L + Q - 1) / Q;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * Q;
    __syncthreads();  // the previous chunk is done with the staging buffers
    for (int i = tid; i < Q * P; i += nt) {
      const int r = i / P, p = i - r * P, t = t0 + r;
      xs[i] = t < L ? x[(((size_t)b * L + t) * H + h) * P + p] : 0.f;
    }
    for (int i = tid; i < Q * N; i += nt) {
      const int r = i / N, n = i - r * N, t = t0 + r;
      const size_t off = (((size_t)b * L + t) * G + g) * N + n;
      bs[r * NB + n] = t < L ? bm[off] : 0.f;
      cs[i] = t < L ? cm[off] : 0.f;
    }
    for (int r = tid; r < Q; r += nt) {
      const int t = t0 + r;
      dts[r] = t < L ? dt[((size_t)b * L + t) * H + h] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of dt * a, in order
      float run = 0.f;
      for (int r = 0; r < Q; ++r) {
        run += dts[r] * ah;
        cum[r] = run;
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    for (int r = tid; r < Q; r += nt) {
      ecum[r] = expf(cum[r]);
      wl[r] = expf(cum_last - cum[r]) * dts[r];
    }
    __syncthreads();

    // y, one tile of TI rows at a time
    for (int i0 = 0; i0 < Q; i0 += TI) {
      for (int k = tid; k < TI * Q; k += nt) {
        const int i = i0 + k / Q, j = k % Q;
        float w = 0.f;
        if (j <= i && i < Q) {
          const float* ci_ = cs + i * N;
          const float* bj = bs + j * NB;
          float dot = 0.f;
          for (int n = 0; n < N; ++n) dot = fmaf(ci_[n], bj[n], dot);
          w = dot * expf(cum[i] - cum[j]) * dts[j];
        }
        ws[k] = w;
      }
      __syncthreads();
      for (int k = tid; k < TI * P; k += nt) {
        const int ii = k / P, p = k - ii * P, i = i0 + ii;
        if (i >= Q) continue;
        const float* wi = ws + ii * Q;
        float intra = 0.f;
        for (int j = 0; j <= i; ++j) intra = fmaf(wi[j], xs[j * P + p], intra);
        const float* ci_ = cs + i * N;
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter = fmaf(ci_[n], ss[n * P + p], inter);
        const int t = t0 + i;
        if (t < L) y[(((size_t)b * L + t) * H + h) * P + p] = intra + ecum[i] * inter;
      }
      __syncthreads();  // ws is rebuilt, and ss updated, only after every read
    }

    // state update
    const float decay = expf(cum_last);
    for (int k = tid; k < N * P; k += nt) {
      const int n = k / P, p = k - n * P;
      float acc = 0.f;
      for (int j = 0; j < Q; ++j) acc = fmaf(wl[j] * bs[j * NB + n], xs[j * P + p], acc);
      ss[k] = decay * ss[k] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += nt) ht[state_off + i] = ss[i];
}

// --------------------------------------------------------------------------
// bf16: three launches, products on wgmma
// --------------------------------------------------------------------------
// chunk_out_kernel: C (kT x kNmax), B (kQ x kNmax; later S_in^T's high
// parts and remainders, 64 x kNmax each), X (kQ x 64), all swizzled; cum,
// dt, the scan's warp totals, and the slack.  66 KB: three blocks an SM.
constexpr size_t kOutSmem = (kT * 2 + kQ * 2 + kQ) * kTileRow + (2 * kQ + 4) * 4 + 1024;

// Step 2: from dS (B, H, nc, N, P) f32 and the decays, S_in[c] of every
// chunk as bf16 pairs into sin (B, H, nc, 2, P, N): [.., 0, p, n] the high
// parts, [.., 1, p, n] the remainders (S_in[0] only with h0: without it
// step 3 reads nothing there); the final state into ht (B, H, N, P) f32.
// A thread owns column p and rows n0 .. n0 + 7 of the state (the reads
// coalesce along p); grid (P N / 8 / 256 blocks, B H).
constexpr int kPassThreads = 256;

__global__ void __launch_bounds__(kPassThreads)
    state_pass_kernel(const float* __restrict__ ds, const float* __restrict__ dec,
                      const float* __restrict__ h0, bf16* __restrict__ sin,
                      float* __restrict__ ht, int P, int N, int nc) {
  launch_dependents();  // step 3's blocks may start their own part
  const int i = blockIdx.x * kPassThreads + threadIdx.x;
  const int p = i % P, n0 = 8 * (i / P);
  if (n0 >= N) return;  // N % 8 == 0: the thread's 8 rows are all real
  wait_dependencies();  // dS and the decays of step 1
  const size_t bh = blockIdx.y, np = (size_t)N * P;
  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = h0 ? h0[bh * np + (size_t)(n0 + k) * P + p] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t chunk = bh * nc + c;
    if (c > 0 || h0) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) split2(s[2 * k], s[2 * k + 1], hi[k], lo[k]);
      bf16* dst = sin + chunk * 2 * np + (size_t)p * N + n0;
      *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + np) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    const float* d = ds + chunk * np + (size_t)n0 * P + p;
    const float k = dec[chunk];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) s[kk] = k * s[kk] + d[(size_t)kk * P];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) ht[bh * np + (size_t)(n0 + k) * P + p] = s[k];
}

// Step 3: y of rows [i0, i0 + 64) of one chunk.  sin holds S_in[c] as
// step 2 wrote it; with carry = 0 (the first chunk without h0) S_in is 0
// and is not read.
__global__ void __launch_bounds__(kWG, 1)
    chunk_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const bf16* __restrict__ bm,
                     const bf16* __restrict__ cm, const bf16* __restrict__ sin, int has_h0,
                     bf16* __restrict__ y, int L, int H, int P, int G, int N, int nc) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t cs = (raw + 1023) & ~1023u;     // C: kT rows x kNmax
  const uint32_t bs = cs + kT * 2 * kTileRow;    // B: kQ rows x kNmax
  const uint32_t xs = bs + kQ * 2 * kTileRow;    // X: kQ rows x 64
  // S_in^T (64 rows p x kNmax), high parts and remainders: B's place, once
  // the intra-chunk products are done with B
  const uint32_t sh = bs, sl = bs + 64 * 2 * kTileRow;
  float* cums = reinterpret_cast<float*>(smem_raw + (xs - raw) + kQ * kTileRow);
  float* dts = cums + kQ;
  float* tot = dts + kQ;

  const int it = blockIdx.x & 1, c = blockIdx.x >> 1;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int tid = threadIdx.x, t0 = c * kQ, i0 = it * kT, nj = i0 + kT;
  const bool carry = c > 0 || has_h0;

  const size_t bc_off = (size_t)b * L * G * N + (size_t)g * N;  // (b, t = 0, g) of B and C
  load_tile(cs, kT, kT, 16, cm + bc_off, (size_t)G * N, t0 + i0, L, N);
  load_tile(bs, kQ, nj, 16, bm + bc_off, (size_t)G * N, t0, L, N);
  load_tile(xs, kQ, nj, 8, x + (size_t)b * L * H * P + (size_t)h * P, (size_t)H * P, t0, L, P);
  cp_async_commit();

  const float d = tid < nj && t0 + tid < L ? dt[((size_t)b * L + t0 + tid) * H + h] : 0.f;
  cums[tid] = chunk_cumsum(d * a[h], tot);
  dts[tid] = d;
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();

  // this thread's rows ia, ib (of the chunk) and columns 8 jj + c0 (+1)
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int ia = i0 + r0, ib = ia + 8;
  const float cum_a = cums[ia], cum_b = cums[ib];

  // C (64 rows) and S_in^T (64 rows) share a geometry: 16 columns a step,
  // a step inside a 64-column block moves 32 bytes within the swizzle atom
  auto kstep = [](int kk, int rows) { return (kk >> 2) * (rows * kTileRow) + (kk & 3) * 32; };

  // the intra-chunk part first: it needs nothing of steps 1 and 2, so it
  // runs while they do
  float yacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
#pragma unroll
  for (int jt = 0; jt < kQ / kT; ++jt) {
    if (jt > it) break;
    // S = C B_jt^T over the state width; s[4 jj + e] is row ia / ib (e >> 1),
    // key 64 jt + 8 jj + c0 + (e & 1)
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kNmax / 16; ++kk)
      wgmma_ss(s, desc(cs + kstep(kk, kT), 16, 1024),
               desc(bs + jt * (kT * kTileRow) + kstep(kk, kQ), 16, 1024), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    // W in registers as the A fragments of W X: bf16 high parts, remainders
    uint32_t wh[kT / 16][4], wlo[kT / 16][4];
#pragma unroll
    for (int jj = 0; jj < kT / 8; ++jj) {
      float w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e & 2 ? ib : ia;
        const int j = kT * jt + 8 * jj + c0 + (e & 1);
        w[e] = j <= i ? s[4 * jj + e] * expf((e & 2 ? cum_b : cum_a) - cums[j]) * dts[j] : 0.f;
      }
      split2(w[0], w[1], wh[jj >> 1][(jj & 1) * 2], wlo[jj >> 1][(jj & 1) * 2]);
      split2(w[2], w[3], wh[jj >> 1][(jj & 1) * 2 + 1], wlo[jj >> 1][(jj & 1) * 2 + 1]);
    }
    // y += W X_jt: 16 keys a step, X MN-major
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const uint64_t bx = desc(xs + (kT * jt + 16 * kk) * kTileRow, kQ * kTileRow, 1024);
      wgmma_rs(yacc, wh[kk], bx, 1);
      wgmma_rs(yacc, wlo[kk], bx, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(yacc);
    fence_regs(wh);
    fence_regs(wlo);
  }

  // then the carry: y += exp(cum_i) (C S_in), S_in as step 2 wrote it
  wait_dependencies();  // every block waits: the scan ends after step 2 has
  if (carry) {
    __syncthreads();  // every warp's products are done with B: S_in lands there
    const bf16* sc = sin + (((size_t)b * H + h) * nc + c) * 2 * (size_t)N * P;
    load_tile(sh, 64, 64, kNmax / 8, sc, N, 0, P, N);  // rows p, columns n
    load_tile(sl, 64, 64, kNmax / 8, sc + (size_t)N * P, N, 0, P, N);
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_shared();
    __syncthreads();
    float yi[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kNmax / 16; ++kk)
      wgmma_ss(yi, desc(cs + kstep(kk, kT), 16, 1024), desc(sh + kstep(kk, 64), 16, 1024), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kNmax / 16; ++kk)
      wgmma_ss(yi, desc(cs + kstep(kk, kT), 16, 1024), desc(sl + kstep(kk, 64), 16, 1024), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(yi);
    const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      yacc[4 * jj] += ea * yi[4 * jj];
      yacc[4 * jj + 1] += ea * yi[4 * jj + 1];
      yacc[4 * jj + 2] += eb * yi[4 * jj + 2];
      yacc[4 * jj + 3] += eb * yi[4 * jj + 3];
    }
  }

  bf16* yb = y + (size_t)b * L * H * P + (size_t)h * P;
  const int ta = t0 + ia, tb = t0 + ib;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int p = 8 * jj + c0;
    if (p >= P) continue;
    if (ta < L)
      *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)ta * H * P + p) =
          __floats2bfloat162_rn(yacc[4 * jj], yacc[4 * jj + 1]);
    if (tb < L)
      *reinterpret_cast<__nv_bfloat162*>(yb + (size_t)tb * H * P + p) =
          __floats2bfloat162_rn(yacc[4 * jj + 2], yacc[4 * jj + 3]);
  }
}

int launch_bf16(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                const void* h0, void* y, void* ht, void* ds, void* dec, void* sin, int B, int L,
                int H, int P, int G, int N, cudaStream_t s) {
  if (N > kNmax || N % 8 || P > 64 || P % 8 || G < 1 || H % G ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bm) |
        reinterpret_cast<uintptr_t>(cm) | reinterpret_cast<uintptr_t>(h0)) & 15))
    return (int)cudaErrorInvalidValue;
  static SmemLimit lim_state, lim_out;
  if (const int e = raise_smem(chunk_state_kernel, kStateSmem, lim_state)) return e;
  if (const int e = raise_smem(chunk_out_kernel, kOutSmem, lim_out)) return e;
  const int nc = (L + kQ - 1) / kQ;
  const bf16* xb = static_cast<const bf16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* dsf = static_cast<float*>(ds);
  float* decf = static_cast<float*>(dec);
  chunk_state_kernel<<<dim3(nc * ((N + 63) / 64), H, B), kWG, kStateSmem, s>>>(
      xb, dtf, af, static_cast<const bf16*>(bm), dsf, decf, L, H, P, G, N, nc);
  if (const int e = (int)cudaGetLastError()) return e;
  if (const int e = launch_dependent(
          state_pass_kernel, dim3((P * N / 8 + kPassThreads - 1) / kPassThreads, B * H),
          kPassThreads, 0, s, dsf, decf, static_cast<const float*>(h0), static_cast<bf16*>(sin),
          static_cast<float*>(ht), P, N, nc))
    return e;
  return launch_dependent(chunk_out_kernel, dim3(nc * (kQ / kT), H, B), kWG, kOutSmem, s, xb, dtf,
                          af, static_cast<const bf16*>(bm), static_cast<const bf16*>(cm),
                          static_cast<const bf16*>(sin), (int)(h0 != nullptr),
                          static_cast<bf16*>(y), L, H, P, G, N, nc);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Device pointers of contiguous tensors: x (B,L,H,P), dt (B,L,H) f32,
// a (H,) f32, bm/cm (B,L,G,N), h0 (B,H,N,P) f32 or null, y (B,L,H,P),
// ht (B,H,N,P) f32.  x, bm, cm and y share the type of the entry point.
//
// f32: chunks of Q rows; `smem` is the block's dynamic shared memory in
// bytes, computed by the wrapper:
// 4 * (Q*P + Q*(N+1) + Q*N + N*P + min(32,Q)*Q + 4*Q).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a, const void* bm,
                            const void* cm, const void* h0, void* y, void* ht, int B, int L,
                            int H, int P, int G, int N, int Q, size_t smem, void* stream) {
  static SmemLimit lim;
  if (const int e = raise_smem(f32_kernel, smem, lim)) return e;
  const dim3 grid(H, B);
  f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(ht), L, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

// bf16: chunks of 128 rows; N <= 128 and P <= 64, multiples of 8; x, bm,
// cm and h0 16-byte aligned.  Scratch, nc = ceil(L / 128): ds
// (B,H,nc,N,P) f32, dec (B,H,nc) f32 and sin (B,H,nc,2,P,N) bf16.  One call
// launches the three kernels: the wrapper counts it as one launch.
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a, const void* bm,
                             const void* cm, const void* h0, void* y, void* ht, void* ds,
                             void* dec, void* sin, int B, int L, int H, int P, int G, int N,
                             void* stream) {
  return launch_bf16(x, dt, a, bm, cm, h0, y, ht, ds, dec, sin, B, L, H, P, G, N,
                     static_cast<cudaStream_t>(stream));
}
