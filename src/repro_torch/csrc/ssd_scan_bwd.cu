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
// about 24 GFLOP, 24 us on the bf16 tensor cores.  So, as for the
// forward, only the tensor cores come near the bound.
//
// Design: simple and right first, every product on the CUDA cores in f32
// out of shared memory, five launches of one entry point, no atomics:
//   1. chunk_sums_kernel, grid (chunk, head, batch): cum (one thread, in
//      order); each chunk's state update dS_c = sum_j wl_j B_j x_j^T (the
//      forward's steps 1-2, recomputed rather than saved: the forward's
//      bf16 S_in pairs would be 42 MB a layer to keep alive from the
//      forward to the backward, and under remat="full" the forward is
//      recomputed in the backward anyway), E_c = sum_i exp(cum_i) C_i
//      dy_i^T, and exp(cum_last_c);
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
//      over the H / G heads of a group in order (mamba2: 80 heads, one
//      group), in the inputs' type;
//   5. da_kernel: da[h] = the per-(b, chunk) shares summed in order.
// Every sum runs in a fixed order, so two calls give the same bits: a DMR
// trainer compares its replicas bit for bit every step.  The f32 and bf16
// instances are one template; bf16 is converted to f32 as it is staged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 512;  // chunk kernels: 16 warps
constexpr int kTile = 32;      // rows / columns of a sweep's tile
constexpr int kPassThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, size_t i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(bf16* p, size_t i, float v) { p[i] = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The dynamic shared memory limit a kernel was raised to, on each device.
struct SmemLimit {
  size_t raised[kMaxDevices];
};

template <typename Kernel>
int raise_smem(Kernel kernel, size_t smem, SmemLimit& lim) {
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem <= 48 * 1024 || smem <= lim.raised[dev]) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  lim.raised[dev] = smem;
  return 0;
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
// db, dc (B,L,G,N) in the entry point's type (bf16 = 1: bfloat16, else
// float32); dt, ddt (B,L,H), a, da (H,), h0, dht, dh0 (B,H,N,P) f32, h0,
// dht and dh0 may be null.  Scratch, nc = ceil(L / Q): ws_s, ws_g
// (B,H,nc,N,P) f32, ws_dec and pda (B,H,nc) f32, pdb and pdc (B,L,H,N)
// f32.  Shared memory, computed by the wrapper: 4 (Q (N + P) + 3 Q) bytes
// for step 1, 4 grad_smem_floats(Q, P, N) for step 3.  One call launches
// the five kernels: the wrapper counts it as one launch.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* bm,
                            const void* cm, const void* h0, const void* dy, const void* dht,
                            void* dx, void* ddt, void* da, void* db, void* dc, void* dh0,
                            void* ws_s, void* ws_g, void* ws_dec, void* pdb, void* pdc, void* pda,
                            int B, int L, int H, int P, int G, int N, int Q, int bf16_inputs,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_inputs)
    return launch<bf16>(x, dt, a, bm, cm, h0, dy, dht, dx, ddt, da, db, dc, dh0, ws_s, ws_g, ws_dec,
                        pdb, pdc, pda, B, L, H, P, G, N, Q, s);
  return launch<float>(x, dt, a, bm, cm, h0, dy, dht, dx, ddt, da, db, dc, dh0, ws_s, ws_g, ws_dec,
                       pdb, pdc, pda, B, L, H, P, G, N, Q, s);
}
