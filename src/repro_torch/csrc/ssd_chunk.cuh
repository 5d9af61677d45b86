// The Mamba2 SSD scan's bf16 chunk tiles, shared by the forward
// (ssd_scan.cu) and its backward (ssd_scan_bwd.cu): the swizzled tile
// copies, the chunk's cumsum by warp scans, the bf16 pair split,
// programmatic dependent launches, and the chunk-state product on wgmma
// (the forward's step 1; the backward's state passes).  Header-only,
// each helper in an anonymous namespace of the including source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"  // cp.async, wgmma and the swizzled descriptors

namespace {

typedef __nv_bfloat16 bf16;

// The dynamic shared memory limit a kernel was raised to, on each device
// of the process (a function attribute is set per device).
constexpr int kMaxDevices = 64;
struct SmemLimit {
  size_t raised[kMaxDevices];
};

// Raise `kernel`'s dynamic shared memory limit to `smem` on the current
// device, once per device: the first (eager) launch does it, not a later
// one inside a CUDA-graph capture.
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

constexpr int kQ = 128;     // rows of a chunk
constexpr int kT = 64;      // rows of an output tile and of a key tile: one wgmma M / N
constexpr int kNmax = 128;  // state width of the instance (N zero-padded to it)
constexpr int kWG = 128;    // threads of a block: one warpgroup
constexpr int kBtStride = kQ + 8;  // row stride (bf16) of the transposed (w o M) tiles
constexpr uint32_t kTileRow = 128;  // bytes of a swizzled tile row: 64 bf16

// chunk_state_kernel: V (kQ x 64, swizzled), (w o M)^T high parts and
// remainders (64 x kBtStride each), cum, w, the scan's warp totals, and
// the slack to align V to 1024
constexpr size_t kStateSmem = kQ * kTileRow + 2 * 64 * kBtStride * 2 + (2 * kQ + 4) * 4 + 1024;

// Byte offset of 16-byte chunk `ch` (columns 8 ch .. 8 ch + 7) of row r in
// a swizzled tile of `rows` rows: 64-column blocks of rows x 128 B one
// after another, each row's chunks XOR row % 8 (hopper.cuh's layout).
__device__ __forceinline__ uint32_t swz(int rows, int r, int ch) {
  return (ch >> 3) * (rows * kTileRow) + r * kTileRow + (((ch & 7) ^ (r & 7)) << 4);
}

// Rows [0, n_rows) of a swizzled tile of `rows` rows with `chunks` 16-byte
// chunks a row, from global rows t0 + r of `src` (row stride `ld`
// elements) by cp.async; rows at or past L and columns at or past `cols`
// are zero-filled.  (dst may start at a row that is a multiple of 8 of a
// larger tile of `rows` rows: the swizzle only sees r % 8.)
__device__ __forceinline__ void load_tile(uint32_t dst, int rows, int n_rows, int chunks,
                                          const bf16* src, size_t ld, int t0, int L, int cols) {
  for (int i = threadIdx.x; i < n_rows * chunks; i += kWG) {
    const int r = i / chunks, ch = i - r * chunks;
    const bool in = t0 + r < L && ch * 8 < cols;
    cp_async16(dst + swz(rows, r, ch), in ? src + (size_t)(t0 + r) * ld + ch * 8 : src,
               in ? 16u : 0u);
  }
}

// cum[r] = sum_{k <= r} dt_k a over the chunk's rows, thread r holding
// row r (d = dt_r, 0 past L): warp scans, then the warps' totals in order.
// Every bf16 kernel of the scan and of its backward calls it on the same
// rows, so they agree on every bit.
__device__ __forceinline__ float chunk_cumsum(float v, float* tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) tot[w] = v;
  __syncthreads();
  float before = 0.f;
  for (int k = 0; k < w; ++k) before += tot[k];
  return before + v;
}

// f as a bf16 pair: the high part and the remainder
__device__ __forceinline__ void split(float f, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(f);
  lo = __float2bfloat16(f - __bfloat162float(hi));
}
__device__ __forceinline__ void split2(float f0, float f1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(f0, f1);  // .x = f0
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(f0 - back.x, f1 - back.y);
}

// Programmatic dependent launch: let the stream's next kernel (launched
// with launch_dependent) start its blocks now; and, in that kernel, wait
// until the kernels it follows have completed and their writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_dependencies() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The chunk-state product of chunk c for the rows n of one 64-wide half
// of N: acc = (w o M)^T V, an N x P product of depth kQ, or with carry
// acc = exp(cum_last) acc + (w o M)^T V (the state carried over the
// chunk), where
//   kind 0: M = B, V = x, w_j = exp(cum_last - cum_j) dt_j: the chunk's
//           own state update dS_c;
//   kind 1: M = C, V = dy, w_j = exp(cum_j): the cotangent E_c the
//           chunk's outputs send its initial state (the backward's).
// A = (w o M)^T comes from registers (staged transposed in shared memory,
// a padded row stride so the fragment loads are conflict-free) as bf16
// pairs, B = the V tile, MN-major (transpose-B, as K7's V).  acc[4 jj + e]
// is row n = 64 half + r0 + 8 (e >> 1), column p = 8 jj + c0 + (e & 1)
// (r0 = 16 warp + lane / 4, c0 = 2 (lane % 4)).  v and m point at (b, t =
// 0, h) of V and (b, t = 0, g) of M.  Every thread of the block calls it;
// it returns exp(cum_last) and leaves the block synchronised, its shared
// memory (kStateSmem) free again.
__device__ __forceinline__ float chunk_state_product(float (&acc)[32], bool carry, int kind,
                                                     unsigned char* smem_raw, const bf16* v,
                                                     const bf16* m, const float* dt, float ah,
                                                     int b, int h, int c, int half, int L, int H,
                                                     int P, int G, int N) {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t xs = (raw + 1023) & ~1023u;
  bf16* bth = reinterpret_cast<bf16*>(smem_raw + (xs - raw) + kQ * kTileRow);
  bf16* btl = bth + 64 * kBtStride;
  float* cums = reinterpret_cast<float*>(btl + 64 * kBtStride);
  float* wl = cums + kQ;
  float* tot = wl + kQ;
  const int tid = threadIdx.x, t0 = c * kQ;

  load_tile(xs, kQ, kQ, 8, v, (size_t)H * P, t0, L, P);
  cp_async_commit();
  // row j = tid of M, this half's 8 chunks of 8 columns, read before the
  // scan so the loads fly while it runs
  const int tj = t0 + tid;
  uint4 braw[8];
#pragma unroll
  for (int ch = 0; ch < 8; ++ch) {
    const int n0 = 64 * half + 8 * ch;
    braw[ch] = tj < L && n0 < N ? __ldg(reinterpret_cast<const uint4*>(m + (size_t)tj * G * N + n0))
                                : make_uint4(0u, 0u, 0u, 0u);
  }

  const float d = tj < L ? dt[((size_t)b * L + tj) * H + h] : 0.f;
  const float cum = chunk_cumsum(d * ah, tot);
  cums[tid] = cum;
  __syncthreads();
  const float last = cums[kQ - 1];
  wl[tid] = kind ? expf(cum) : expf(last - cum) * d;
  __syncthreads();

  // (w o M)^T as bf16 pairs: thread tid writes column j = tid of the
  // transposed tiles
  {
    const float w = wl[tid];
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) {
      const bf16* e = reinterpret_cast<const bf16*>(&braw[ch]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        bf16 hi, lo;
        split(__bfloat162float(e[k]) * w, hi, lo);
        bth[(8 * ch + k) * kBtStride + tid] = hi;
        btl[(8 * ch + k) * kBtStride + tid] = lo;
      }
    }
  }
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();

  // A fragments: rows r0, r0 + 8 (n), columns 16 kk + c0 (+1, +8, +9) (j)
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  uint32_t ah_[kQ / 16][4], al[kQ / 16][4];
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    const int j = 16 * kk + c0;
    const int o[4] = {r0 * kBtStride + j, (r0 + 8) * kBtStride + j, r0 * kBtStride + j + 8,
                      (r0 + 8) * kBtStride + j + 8};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah_[kk][e] = *reinterpret_cast<const uint32_t*>(bth + o[e]);
      al[kk][e] = *reinterpret_cast<const uint32_t*>(btl + o[e]);
    }
  }
  const float dec = expf(last);
  if (carry)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] *= dec;
  // (w o M)^T V: 16 rows of the chunk a step, V MN-major (one 64-column
  // block; 8-row groups 1024 B apart)
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    const uint64_t bx = desc(xs + kk * (16 * kTileRow), kQ * kTileRow, 1024);
    wgmma_rs(acc, ah_[kk], bx, carry || kk > 0);
    wgmma_rs(acc, al[kk], bx, 1);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(acc);
  fence_regs(ah_);
  fence_regs(al);
  __syncthreads();  // every warp is done with the tiles
  return dec;
}

// Step 1 of the forward: dS_c = (wl o B)^T X for chunk c and the rows n of
// one 64-wide half of N, and exp(cum_last_c).  Grid (nc x halves, H, B),
// blockIdx.x = c halves + half.  ds: (B, H, nc, N, P) f32; dec: (B, H, nc).
__global__ void __launch_bounds__(kWG, 1)
    chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a, const bf16* __restrict__ bm,
                       float* __restrict__ ds, float* __restrict__ dec, int L, int H, int P,
                       int G, int N, int nc) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nh = (N + 63) / 64;
  const int half = blockIdx.x % nh, c = blockIdx.x / nh;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  launch_dependents();  // step 2's blocks may take their places and wait

  float acc[32];
  const float k = chunk_state_product(acc, false, 0, smem_raw,
                                      x + (size_t)b * L * H * P + (size_t)h * P,
                                      bm + (size_t)b * L * G * N + (size_t)g * N, dt, a[h], b, h,
                                      c, half, L, H, P, G, N);
  if (half == 0 && threadIdx.x == 0) dec[((size_t)b * H + h) * nc + c] = k;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  float* out = ds + (((size_t)b * H + h) * nc + c) * N * P;
  const int na = 64 * half + r0, nb = na + 8;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int p = 8 * jj + c0;  // P % 8 == 0: p < P means p + 1 < P
    if (p >= P) continue;
    if (na < N) *reinterpret_cast<float2*>(out + (size_t)na * P + p) = make_float2(acc[4 * jj], acc[4 * jj + 1]);
    if (nb < N)
      *reinterpret_cast<float2*>(out + (size_t)nb * P + p) = make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// Launch `kernel` so that its blocks may start once every block of the
// stream's previous kernel has called launch_dependents (programmatic
// dependent launch, kept as such in a CUDA graph); the kernel calls
// wait_dependencies before it reads what that kernel writes.
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                     cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace
