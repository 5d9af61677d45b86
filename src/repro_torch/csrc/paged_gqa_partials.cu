// K5's partials entry point in bf16 on Hopper's tensor cores (sm_90a): one
// launch that writes each query head's flash-decoding partial (acc, m, l).
//
// Replaces, with paged_gqa_decode.cu's split pass and merge_partials_kernel
// (which keep the f32 instance and the small query groups), the member body
// of the JAX package's sequence-sharded decode over the Pallas TPU kernel
// src/repro/kernels/paged_decode.py::paged_gqa_attention (pallas_call at
// :144; the member body is src/repro/distributed/decode.py::_partial_attend).
// The function is kernels/paged_decode.py::paged_gqa_partials_plain: for
// each slot b and query head, over the lanes on a mapped page and at or
// before pos[b] (pos may be negative or past the lanes), the f32 scores
// s = (q . k) * scale, their max m in natural units, l = sum exp(s - m) and
// acc = sum exp(s - m) V; a row with no valid lane gives m = -inf, l = 0,
// acc = 0.  Unmapped pages are never read, and a page row past the pool's
// end reads the last row (the gather clamps).
//
// What bounds it: the bytes, and at a member's shape the launch.  At
// granite-20b's member shape (B = 8 slots, 48 query heads on one kv head,
// Dk = 128, a 128-lane shard, bf16) it must move q 98 KB, K and V 0.52 MB
// and the f32 partials 0.2 MB: 0.25 us at 3.35 TB/s, and 25 MFLOP, 0.03 us
// on the tensor cores.  A launch costs microseconds, so the design's aim is
// one launch with a short chain of dependent steps.  All the heads of one
// kv head share each K and V row, so a slot's work is two small products
// a tile, (64 x Dk) . (Dk x 64) and (64 x 64) . (64 x Dk): K6's shape
// (absorbed MLA), and this kernel is K6's bf16 kernel cut to it.
//
// Design:
//   * grid (slot, kv head x group of 64 query heads, split), 128 threads
//     (one warpgroup) a block.  The group's query rows are one wgmma M tile
//     of 64: a group of 48 is padded with zero rows, never written.  A
//     split is a run of split_lanes lanes, a multiple of the 64-lane tile,
//     and the splits of one (slot, group) form a thread-block cluster along
//     the split axis, at most 8 (the portable size);
//   * the threads copy with cp.async, 16 bytes a thread, two threads a row:
//     the group's query rows once, then tiles of 64 K rows and 64 V rows,
//     each lane's rows found through the page table and the pool's page
//     and head strides, into two stages (the next tile's copies fly while
//     the tensor cores work on this one).  Rows are Dk zero-padded to DP =
//     64 or 128 columns, 128 B a 64-column block, 16-byte chunks XOR row %
//     8: the 128-byte swizzle wgmma reads.  Lanes past pos, past the split
//     and on unmapped pages are never read: cp.async writes zeros there,
//     and their flag scores them -inf;
//   * S = Q K^T with wgmma.m64n64k16 over the DP columns (the zero padding
//     adds exact zeros), f32 accumulators; the scale and log2(e) applied to
//     the f32 sum; the online softmax in registers (quad shuffles per row,
//     ex2 in log2 units); O += P V with P from registers (S's accumulator
//     layout is P's A-fragment layout) and V's tile MN-major.  P is split
//     into a bf16 high part and a bf16 remainder, two products, so P keeps
//     16 bits of mantissa: bf16 P alone puts 2^-9 of relative error on every
//     weight, and the partials are held to the plain version at 1e-4;
//   * the splits merge inside the launch: each block leaves its (acc, m, l)
//     in its own shared memory (the stages, free once its last tile is
//     done), the cluster synchronises, and each block merges a slice of the
//     group's rows, reading every split's partial through distributed
//     shared memory in split order (merge_partials_kernel's arithmetic: a
//     split with l = 0 is skipped), and writes acc, m (natural units) and l.
//     A second cluster barrier keeps every block's shared memory alive until
//     the last read.  There is no global scratch and no second kernel; with
//     one split the block writes its registers directly;
//   * the reduction order is a function of the lane index and the shapes:
//     split boundaries and tiles sit at multiples of 64 lanes from lane 0,
//     and the split length and cluster size (paged_decode.py's
//     gqa_partials_plan) follow the lanes alone, not the batch.  A row
//     gives the same bits at any batch index and in a call of any B, and a
//     dense cache read in place (dense_gqa_view) gives a paged pool's bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"  // cp.async, wgmma and the swizzled descriptors

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;               // one warpgroup
constexpr int kRows = 64;                   // query heads a block takes: one wgmma M
constexpr int kTile = 64;                   // lanes a tile
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr uint32_t kBlockBytes = 64 * 128;  // 64 rows of one swizzled 64-column block
constexpr float kLn2 = 0.69314718055994531f;

// Shared memory of a block whose rows are padded to DP columns: Q, two
// stages of [K | V] tiles, the stages' lane flags, and the slack to align
// to 1024.  After the last tile the stages hold the block's partial: acc
// (64 rows at a stride of DP + 8 floats, so a quad's float2 stores of 8
// rows fill the banks twice, not 8 times), m and l; the Q region holds
// the merge's split factors.
template <int DP>
struct Smem {
  static constexpr int kBlocks = DP / 64;
  static constexpr uint32_t kTileBytes = kBlocks * kBlockBytes;  // Q, K or V
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr int kAccStride = DP + 8;
  static constexpr size_t kBytes = (size_t)kTileBytes + 2 * kStageBytes + 2 * kTile + 1024;
  static_assert((size_t)kRows * (kAccStride + 2) * 4 <= 2 * kStageBytes, "partial fits the stages");
  static_assert((size_t)kRows * kMaxCluster * 4 <= kTileBytes, "split factors fit Q");
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
    partials_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
                    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ pages,
                    const int* __restrict__ pos, float* __restrict__ acc_out,
                    float* __restrict__ m_out, float* __restrict__ l_out, int Hq, int Hkv, int Dk,
                    int ps, int P, int N, long long page_stride, long long head_stride,
                    int split_lanes, int n_groups, float scale_log2) {
  using L = Smem<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;
  unsigned char* base = smem_raw + (qs - raw);
  auto k_stage = [&](int st) { return qs + L::kTileBytes + st * L::kStageBytes; };
  auto v_stage = [&](int st) { return k_stage(st) + L::kTileBytes; };
  // per stage and lane of the tile: 1 where the lane's score counts
  unsigned char* okf = base + L::kTileBytes + 2 * L::kStageBytes;

  const int G = Hq / Hkv;
  const int b = blockIdx.x, h = blockIdx.y / n_groups, split = blockIdx.z;
  const int g0 = (blockIdx.y % n_groups) * kRows;
  const int Gc = min(kRows, G - g0);  // rows of this block's group
  const size_t row0 = (size_t)b * Hq + h * G + g0;  // its first (slot, query head) row
  const int tid = threadIdx.x;
  const int qpos = __ldg(pos + b);
  const int* prow = pages + (size_t)b * P;
  const int L0 = split * split_lanes;
  const int L1 = min(min(P * ps, L0 + split_lanes), qpos + 1);  // lanes [L0, L1) of the split
  const int n_tiles = L1 > L0 ? (L1 - L0 + kTile - 1) / kTile : 0;

  // copies: thread tid fills row tid / 2 of a tile, chunks tid % 2 + 2 i;
  // chunks at or past Dk, and rows that are not read, are zero-filled
  const int lr = tid >> 1, lp = tid & 1;
  auto copy_row = [&](uint32_t dst, const __nv_bfloat16* src, bool ok) {
#pragma unroll
    for (int i = 0; i < DP / 16; ++i) {
      const int c = lp + 2 * i;
      const uint32_t d = dst + (c >> 3) * kBlockBytes + lr * 128 + (((c & 7) ^ (lr & 7)) << 4);
      const bool in = ok && c * 8 < Dk;
      cp_async16(d, in ? src + c * 8 : k_pool, in ? 16u : 0u);
    }
  };
  auto load_tile = [&](int j) {
    const int st = j & 1, t = L0 + j * kTile + lr;
    const int row = t < L1 ? min(__ldg(prow + t / ps), N - 1) : -1;
    const size_t off = row >= 0 ? (size_t)row * page_stride + (size_t)h * head_stride +
                                      (size_t)(t % ps) * Dk
                                : 0;
    copy_row(k_stage(st), k_pool + off, row >= 0);
    copy_row(v_stage(st), v_pool + off, row >= 0);
    if (lp == 0) okf[st * kTile + lr] = row >= 0;
  };
  if (n_tiles > 0) {
    copy_row(qs, q + (row0 + min(lr, Gc - 1)) * Dk, lr < Gc);
    load_tile(0);
    cp_async_commit();
  }

  // this thread: rows r0 and r0 + 8 of the 64, context columns 8 jj + c0
  // and + 1 of o[4 jj ...] (the wgmma accumulator layout)
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) load_tile(j + 1);  // into the stage tile j - 1 left
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q) landed for this thread's copies
    fence_async_shared();
    __syncthreads();  // ... and for every thread's

    // S = Q K^T: s[4 jj + e] is row r0 + 8 (e >> 1), lane L0 + 64 j + 8 jj + c0 + (e & 1)
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
      wgmma_ss(s, desc(qs + off, 16, 1024), desc(k_stage(st) + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    // the online softmax of the tile, in log2 units; a lane whose flag is 0
    // scores -inf (p = 0)
    const unsigned char* ok = okf + st * kTile;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * jj + e] * scale_log2;
        s[4 * jj + e] = ok[8 * jj + c0 + (e & 1)] ? x : -INFINITY;
        if (e & 2)
          mx1 = fmaxf(mx1, s[4 * jj + e]);
        else
          mx0 = fmaxf(mx0, s[4 * jj + e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;  // a row that saw nothing yet
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = ex2(m0 - mu0), al1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    // P as the A fragments of P.V: a bf16 high part and the bf16 remainder
    uint32_t ph[4][4], pl[4][4];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = ex2(s[4 * jj + e] - (e & 2 ? mu1 : mu0));
      ls0 += p[0] + p[1];
      ls1 += p[2] + p[3];
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(p[2], p[3]);
      const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
      ph[jj >> 1][(jj & 1) * 2] = *reinterpret_cast<const uint32_t*>(&h01);
      ph[jj >> 1][(jj & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&h23);
      pl[jj >> 1][(jj & 1) * 2] = pack_bf16(p[0] - f01.x, p[1] - f01.y);
      pl[jj >> 1][(jj & 1) * 2 + 1] = pack_bf16(p[2] - f23.x, p[3] - f23.y);
    }
    l0 = l0 * al0 + ls0;  // this thread's share of the row sum
    l1 = l1 * al1 + ls1;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      o[4 * jj] *= al0;
      o[4 * jj + 1] *= al0;
      o[4 * jj + 2] *= al1;
      o[4 * jj + 3] *= al1;
    }
    // O += P V: 16 lanes a step; V's 64-column blocks are a block apart
    // (the leading byte offset), 8-lane groups 1024 B (the stride)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint64_t bv = desc(v_stage(st) + kk * (16 * 128), kBlockBytes, 1024);
      wgmma_rs(o, ph[kk], bv, 1);
      wgmma_rs(o, pl[kk], bv, 1);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    __syncthreads();  // the whole block is done with the stage: tile j + 2 may land there
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int rA = r0, rB = r0 + 8;

  if (gridDim.z == 1) {  // one split: this block's registers are the partial
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int col = 8 * jj + c0;  // Dk % 8 == 0: col + 1 < Dk too
      if (col >= Dk) continue;
      if (rA < Gc)
        *reinterpret_cast<float2*>(acc_out + (row0 + rA) * Dk + col) =
            make_float2(o[4 * jj], o[4 * jj + 1]);
      if (rB < Gc)
        *reinterpret_cast<float2*>(acc_out + (row0 + rB) * Dk + col) =
            make_float2(o[4 * jj + 2], o[4 * jj + 3]);
    }
    if ((lane & 3) == 0 && rA < Gc) {
      m_out[row0 + rA] = m0 == -INFINITY ? -INFINITY : m0 * kLn2;  // log2 -> natural units
      l_out[row0 + rA] = l0;
    }
    if ((lane & 3) == 0 && rB < Gc) {
      m_out[row0 + rB] = m1 == -INFINITY ? -INFINITY : m1 * kLn2;
      l_out[row0 + rB] = l1;
    }
    return;
  }

  // this split's partial into this block's shared memory: acc, then m and
  // l in log2 units (the stages are free: the last tile's barrier passed)
  float* pacc = reinterpret_cast<float*>(base + L::kTileBytes);
  float* pm = pacc + kRows * L::kAccStride;
  float* pl_ = pm + kRows;
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj) {
    const int col = 8 * jj + c0;
    *reinterpret_cast<float2*>(pacc + rA * L::kAccStride + col) = make_float2(o[4 * jj], o[4 * jj + 1]);
    *reinterpret_cast<float2*>(pacc + rB * L::kAccStride + col) =
        make_float2(o[4 * jj + 2], o[4 * jj + 3]);
  }
  if ((lane & 3) == 0) {
    pm[rA] = m0;
    pl_[rA] = l0;
    pm[rB] = m1;
    pl_[rB] = l1;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is written and visible to the cluster

  // This block merges rows [ra, rb) of the group, every split in order.
  const int nsplit = gridDim.z;
  const int rank = (int)cluster.block_rank();  // == split: the cluster spans the split axis
  const int per = (Gc + nsplit - 1) / nsplit;
  const int ra = min(Gc, rank * per), rb = min(Gc, ra + per);
  float* fac = reinterpret_cast<float*>(base);  // (rb - ra) x nsplit factors, -1 = skip
  for (int r = ra + tid; r < rb; r += kThreads) {
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) {
      const float ls = cluster.map_shared_rank(pl_, s)[r];
      if (ls > 0.f) M = fmaxf(M, cluster.map_shared_rank(pm, s)[r]);
    }
    float Lsum = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float ls = cluster.map_shared_rank(pl_, s)[r];
      float f = -1.f;
      if (ls > 0.f) {
        f = exp2f(cluster.map_shared_rank(pm, s)[r] - M);
        Lsum += ls * f;
      }
      fac[(r - ra) * nsplit + s] = f;
    }
    m_out[row0 + r] = M == -INFINITY ? -INFINITY : M * kLn2;  // log2 -> natural units
    l_out[row0 + r] = Lsum;
  }
  __syncthreads();
  const int nq = Dk / 4;  // float4 columns
  for (int i = tid; i < (rb - ra) * nq; i += kThreads) {
    const int r = ra + i / nq, d = 4 * (i % nq);
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsplit; ++s) {
      const float f = fac[(r - ra) * nsplit + s];
      if (f < 0.f) continue;
      const float4 a =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(pacc, s) + r * L::kAccStride + d);
      A.x += a.x * f;
      A.y += a.y * f;
      A.z += a.z * f;
      A.w += a.w * f;
    }
    *reinterpret_cast<float4*>(acc_out + (row0 + r) * Dk + d) = A;
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

// The launch floor: a kernel that does nothing, launched as
// partials_kernel<DP> is (same grid, block, cluster and shared memory).
template <int DP>
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

template <int DP, typename Kernel, typename... Args>
int launch(Kernel kernel, int B, int Hkv, int G, int nsplit, cudaStream_t stream, Args... args) {
  // Raise the dynamic shared memory limit on the first (eager) launch: not
  // again inside a CUDA-graph capture.
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)Smem<DP>::kBytes);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nsplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, Hkv * ((G + kRows - 1) / kRows), nsplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Smem<DP>::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Hq, int Hkv, int Dk, int S, int split_lanes) {
  const int nsplit = split_lanes > 0 ? (S + split_lanes - 1) / split_lanes : 0;
  return B < 1 || Hkv < 1 || Hq % Hkv || Dk < 8 || Dk % 8 || Dk > 128 || split_lanes < kTile ||
         split_lanes % kTile || nsplit < 1 || nsplit > kMaxCluster;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Device pointers, 16-byte aligned: q (B,Hq,Dk) bf16 contiguous; the
// pools' lane t of page row r and kv head h at element r * page_stride +
// h * head_stride + (t % ps) * Dk (rows r < N, strides multiples of 8);
// pages (B,P) int32 (-1 = unmapped); pos (B,) int32, may be negative; acc
// (B,Hq,Dk), m and l (B,Hq) f32 contiguous.  Dk is a multiple of 8 and at
// most 128; split_lanes, a multiple of 64, is chosen by the wrapper with
// at most 8 splits of P * ps lanes (one cluster).
extern "C" int paged_gqa_partials_tc(const void* q, const void* k_pool, const void* v_pool,
                                     const void* pages, const void* pos, void* acc, void* m,
                                     void* l, int B, int Hq, int Hkv, int Dk, int ps, int P, int N,
                                     long long page_stride, long long head_stride,
                                     int split_lanes, float scale, void* stream) {
  const int S = P * ps;
  if (bad_shape(B, Hq, Hkv, Dk, S, split_lanes) || !acc || !m || !l)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S + split_lanes - 1) / split_lanes;
  const int G = Hq / Hkv, n_groups = (G + kRows - 1) / kRows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_pool);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_pool);
  const auto* pg = static_cast<const int*>(pages);
  const auto* pp = static_cast<const int*>(pos);
  auto* a = static_cast<float*>(acc);
  auto* mm = static_cast<float*>(m);
  auto* ll = static_cast<float*>(l);
  const float sl = scale * kLog2e;
  if (Dk <= 64)
    return launch<64>(partials_kernel<64>, B, Hkv, G, nsplit, s, qq, kp, vp, pg, pp, a, mm, ll, Hq,
                      Hkv, Dk, ps, P, N, page_stride, head_stride, split_lanes, n_groups, sl);
  return launch<128>(partials_kernel<128>, B, Hkv, G, nsplit, s, qq, kp, vp, pg, pp, a, mm, ll, Hq,
                     Hkv, Dk, ps, P, N, page_stride, head_stride, split_lanes, n_groups, sl);
}

// The launch floor of paged_gqa_partials_tc at these shapes: the empty
// kernel with its grid, cluster and shared memory.
extern "C" int paged_gqa_partials_tc_empty(int B, int Hq, int Hkv, int Dk, int S, int split_lanes,
                                           void* stream) {
  if (bad_shape(B, Hq, Hkv, Dk, S, split_lanes)) return (int)cudaErrorInvalidValue;
  const int nsplit = (S + split_lanes - 1) / split_lanes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dk <= 64) return launch<64>(empty_kernel<64>, B, Hkv, Hq / Hkv, nsplit, s);
  return launch<128>(empty_kernel<128>, B, Hkv, Hq / Hkv, nsplit, s);
}
