// K6's partials entry point in bf16 on Hopper's tensor cores (sm_90a): one
// launch that writes each query head's flash-decoding partial (acc, m, l)
// of absorbed-MLA attention over a member's latent lanes.
//
// Replaces, with paged_mla_decode.cu's f32 partials epilogue (which keeps
// the f32 instance), the member body of the JAX package's sequence-sharded
// MLA decode over the Pallas TPU kernel
// src/repro/kernels/paged_decode.py::paged_mla_attention (pallas_call at
// :250; the member body is src/repro/distributed/decode.py::mla_decode).
// The function is kernels/paged_decode.py::paged_mla_partials_plain: for
// each slot b and query head, over the lanes on a mapped page and at or
// before pos[b] (pos may be negative or past the lanes), the f32 scores
// s = (q_lat . ckv + q_rope . krope) * scale, their max m in natural
// units, l = sum exp(s - m) and acc = sum exp(s - m) ckv (B, h, lora); a
// row with no valid lane gives m = -inf, l = 0, acc = 0 (never the
// whole-slot kernel's uniform mean).  Unmapped pages are never read, and a
// page row past the pool's end reads the last row (the gather clamps).
//
// What bounds it: the bytes, and at a member's shape the launch.  At
// DeepSeek-V3's member of a (2, 4) mesh (B = 4 slots, h = 128, lora 512,
// rope 64, a 128-lane shard, bf16) it must move q 0.6 MB, the latent lanes
// 0.6 MB and the f32 partials 1.1 MB: 0.67 us at 3.35 TB/s, and 0.15 GFLOP,
// 0.15 us on the tensor cores.  A launch costs microseconds, so the aim is
// one launch with a short chain of dependent steps.
//
// Design: K6's bf16 tile walk (mla_tiles.cuh: two warpgroups, cp.async of
// the 64 query rows and 64-lane [ckv | krope] tiles through the page table
// in two stages, S = Q K^T on wgmma.m64n64k16 over 576 columns, the online
// softmax in log2 units, O += P V with P as a bf16 high part and its bf16
// remainder, the 512 context columns split between the warpgroups), here
// with no uniform case, and:
//   * grid (slot, group of 64 query heads, split); a split is a run of
//     split_lanes lanes, a multiple of the 64-lane tile, and the splits of
//     one (slot, group) form a thread-block cluster along the split axis,
//     at most 8 (the portable size).  A block takes 221 KB of shared
//     memory, so one fills an SM and a cluster of n needs n SMs of one GPC;
//     the first launch of each cluster size asks the runtime whether such
//     a cluster can be resident at all and refuses the call if not;
//   * the splits merge inside the launch: each block leaves its (acc, m, l)
//     in its own shared memory (the stages, free after its last tile: 64
//     rows of 512 f32 at a padded stride), the cluster synchronises, and
//     each block merges a slice of the group's rows, reading every split's
//     partial through distributed shared memory in split order
//     (merge_partials_kernel's arithmetic: a split with l = 0 is skipped, m
//     back to natural units), and writes acc, m and l.  A second cluster
//     barrier keeps every block's shared memory alive until the last read.
//     There is no global scratch and no second kernel; with one split the
//     block writes its registers directly.  The merge costs a block about
//     as much as one tile's walk (chip_smoke.py's split sweep on an H100:
//     about 4 us against 4.6), so splitting two tiles gains little (3 %),
//     and more tiles a split gain more;
//   * the reduction order is a function of the lane index and the shapes:
//     split boundaries and tiles sit at multiples of 64 lanes from lane 0,
//     and the split length and cluster size (paged_decode.py's
//     mla_partials_plan) follow the lanes alone, not the batch.  A row
//     gives the same bits at any batch index and in a call of any B, and a
//     dense latent cache read in place (dense_mla_view) gives a paged
//     pool's bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"     // cp.async, wgmma and the swizzled descriptors
#include "mla_tiles.cuh"  // the bf16 tile walk

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr int kAccStride = kLoraMax + 8;  // a quad's float2 stores of 8 rows fill the banks twice
constexpr float kLn2 = 0.69314718055994531f;
constexpr int kNoCluster = -1;            // returned when no cluster of the size fits the card
static_assert((size_t)kHeads * (kAccStride + 2) * 4 <= 2 * kTileBytes, "partial fits the stages");
static_assert((size_t)kHeads * kMaxCluster * 4 <= kTileBytes, "split factors fit Q");

// acc rows [ra, rb) of a group (out: its first row) merged from the N
// splits' partials in the cluster's shared memory (pacc: this block's,
// 64 rows at kAccStride; this block is split `rank`), in split order, each
// split scaled by its factor fac[(r - ra) * kMaxCluster + s] (-1:
// skipped).  A thread reads kInFlight float4 items of every split (its
// own block's from its own shared memory, the others' across the SM-to-SM
// network) before it uses the first, so their latencies overlap, and N is
// a constant so that the reads stay in registers.
template <int N>
__device__ __forceinline__ void merge_acc(const cg::cluster_group& cluster, int rank,
                                          const float* pacc, const float* fac,
                                          float* __restrict__ out, int ra, int rb, int lora) {
  constexpr int kInFlight = N <= 4 ? 4 : 2;
  const int nq = lora / 4;  // float4 columns
  const int items = (rb - ra) * nq;
  for (int i0 = threadIdx.x; i0 < items; i0 += kInFlight * kBf16Threads) {
    float4 a[kInFlight][N];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = min(i0 + u * kBf16Threads, items - 1);  // past the end: read, not stored
      const float* src = pacc + (ra + i / nq) * kAccStride + 4 * (i % nq);
#pragma unroll
      for (int s = 0; s < N; ++s)
        a[u][s] = *reinterpret_cast<const float4*>(s == rank ? src
                                                             : cluster.map_shared_rank(src, s));
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kBf16Threads;
      if (i < items) {
        const int r = ra + i / nq;
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int s = 0; s < N; ++s) {
          const float f = fac[(r - ra) * kMaxCluster + s];
          if (f >= 0.f) {
            A.x += a[u][s].x * f;
            A.y += a[u][s].y * f;
            A.z += a[u][s].z * f;
            A.w += a[u][s].w * f;
          }
        }
        *reinterpret_cast<float4*>(out + (size_t)r * lora + 4 * (i % nq)) = A;
      }
    }
  }
}

__global__ void __launch_bounds__(kBf16Threads, 1)
    mla_partials_kernel(const __nv_bfloat16* __restrict__ q_lat,
                        const __nv_bfloat16* __restrict__ q_rope,
                        const __nv_bfloat16* __restrict__ ckv,
                        const __nv_bfloat16* __restrict__ krope, const int* __restrict__ pages,
                        const int* __restrict__ pos, float* __restrict__ acc_out,
                        float* __restrict__ m_out, float* __restrict__ l_out, int H, int lora,
                        int rope, int ps, int P, int N, int split_lanes, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;
  unsigned char* base = smem_raw + (qs - raw);
  // per stage and lane of the tile: 1 where the lane's score counts
  unsigned char* okf = base + 3 * kTileBytes;

  const int b = blockIdx.x, h0 = blockIdx.y * kHeads, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int qpos = __ldg(pos + b);
  const int Gc = min(kHeads, H - h0);      // query heads of this block
  const size_t row0 = (size_t)b * H + h0;  // its first (slot, query head) row
  const int L0 = split * split_lanes;
  const int L1 = min(min(P * ps, L0 + split_lanes), qpos + 1);  // lanes [L0, L1) of the split

  float o[2][64];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 64; ++j) o[i][j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  if (L1 > L0)
    mla_walk(q_lat, q_rope, ckv, krope, pages + (size_t)b * P, b, H, h0, lora, rope, ps, N, L0,
             L1, false, scale_log2, qs, okf, o, m0, m1, l0, l1);

  // this thread: rows rA and rB of the 64, context columns 256 wg + 128 i
  // + 8 jj + c0 and + 1 of o[i][4 jj ...] (the wgmma accumulator layout)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int rA = 16 * warp + (lane >> 2), rB = rA + 8, c0 = 2 * (lane & 3);

  if (gridDim.z == 1) {  // one split: this block's registers are the partial
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int col = 256 * wg + 128 * i + 8 * jj + c0;  // lora % 8 == 0: col + 1 < lora too
        if (col >= lora) continue;
        if (rA < Gc)
          *reinterpret_cast<float2*>(acc_out + (row0 + rA) * lora + col) =
              make_float2(o[i][4 * jj], o[i][4 * jj + 1]);
        if (rB < Gc)
          *reinterpret_cast<float2*>(acc_out + (row0 + rB) * lora + col) =
              make_float2(o[i][4 * jj + 2], o[i][4 * jj + 3]);
      }
    if (wg == 0 && (lane & 3) == 0) {
      if (rA < Gc) {
        m_out[row0 + rA] = m0 == -INFINITY ? -INFINITY : m0 * kLn2;  // log2 -> natural units
        l_out[row0 + rA] = l0;
      }
      if (rB < Gc) {
        m_out[row0 + rB] = m1 == -INFINITY ? -INFINITY : m1 * kLn2;
        l_out[row0 + rB] = l1;
      }
    }
    return;
  }

  // this split's partial into this block's shared memory: acc, then m and
  // l in log2 units (the stages are free: the last tile's barrier passed)
  float* pacc = reinterpret_cast<float*>(base + kTileBytes);
  float* pm = pacc + kHeads * kAccStride;
  float* pl = pm + kHeads;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int col = 256 * wg + 128 * i + 8 * jj + c0;
      *reinterpret_cast<float2*>(pacc + rA * kAccStride + col) =
          make_float2(o[i][4 * jj], o[i][4 * jj + 1]);
      *reinterpret_cast<float2*>(pacc + rB * kAccStride + col) =
          make_float2(o[i][4 * jj + 2], o[i][4 * jj + 3]);
    }
  if (wg == 0 && (lane & 3) == 0) {
    pm[rA] = m0;
    pl[rA] = l0;
    pm[rB] = m1;
    pl[rB] = l1;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is written and visible to the cluster

  // This block merges rows [ra, rb) of the group, every split in order:
  // first each row's factors (a thread a row, its reads of every split
  // issued before the first is used), then the rows' acc (merge_acc).
  const int nsplit = gridDim.z;
  const int rank = (int)cluster.block_rank();  // == split: the cluster spans the split axis
  const int per = (Gc + nsplit - 1) / nsplit;
  const int ra = min(Gc, rank * per), rb = min(Gc, ra + per);
  float* fac = reinterpret_cast<float*>(base);  // (rb - ra) x kMaxCluster factors, -1 = skip
  for (int r = ra + tid; r < rb; r += kBf16Threads) {
    float ms[kMaxCluster], ls[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      ms[s] = s < nsplit ? cluster.map_shared_rank(pm, s)[r] : -INFINITY;
      ls[s] = s < nsplit ? cluster.map_shared_rank(pl, s)[r] : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s)
      if (ls[s] > 0.f) M = fmaxf(M, ms[s]);
    float Lsum = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      float f = -1.f;
      if (ls[s] > 0.f) {
        f = exp2f(ms[s] - M);
        Lsum += ls[s] * f;
      }
      fac[(r - ra) * kMaxCluster + s] = f;
    }
    m_out[row0 + r] = M == -INFINITY ? -INFINITY : M * kLn2;  // log2 -> natural units
    l_out[row0 + r] = Lsum;
  }
  __syncthreads();
  switch (nsplit) {  // the split count as a constant: the reads stay in registers
#define MERGE(N_) merge_acc<N_>(cluster, rank, pacc, fac, acc_out + row0 * lora, ra, rb, lora)
    case 2: MERGE(2); break;
    case 3: MERGE(3); break;
    case 4: MERGE(4); break;
    case 5: MERGE(5); break;
    case 6: MERGE(6); break;
    case 7: MERGE(7); break;
    default: MERGE(8); break;
#undef MERGE
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

// The launch floor: a kernel that does nothing, launched as mla_partials_kernel
// is (same grid, block, cluster and shared memory).
__global__ void __launch_bounds__(kBf16Threads, 1) empty_kernel() {}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int B, int H, int nsplit, cudaStream_t stream, Args... args) {
  // Raise the dynamic shared memory limit on the first (eager) launch: not
  // again inside a CUDA-graph capture.
  static bool raised = false;
  if (!raised) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBf16Smem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nsplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, (H + kHeads - 1) / kHeads, nsplit);
  cfg.blockDim = dim3(kBf16Threads);
  cfg.dynamicSmemBytes = kBf16Smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // The first launch of each cluster size: can one such cluster of these
  // blocks be resident at all?  If not, the call is refused (no fallback).
  static bool fits[kMaxCluster + 1] = {};
  if (!fits[nsplit]) {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return kNoCluster;
    fits[nsplit] = true;
  }
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int lora, int rope, int S, int split_lanes) {
  const int nsplit = split_lanes > 0 ? (S + split_lanes - 1) / split_lanes : 0;
  return B < 1 || H < 1 || S < 1 || lora < 8 || lora > kLoraMax || lora % 8 || rope < 8 ||
         rope > kRopeMax || rope % 8 || split_lanes < kTile || split_lanes % kTile || nsplit < 1 ||
         nsplit > kMaxCluster;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t, 0 = ok,
// or -1 when no cluster of the plan's size fits the card.  Device pointers
// of contiguous, 16-byte aligned tensors: q_lat (B,H,lora), q_rope
// (B,H,rope), ckv (N,ps,lora), krope (N,ps,rope), bf16; pages (B,P) int32
// (-1 = unmapped); pos (B,) int32, may be negative; acc (B,H,lora), m and
// l (B,H) f32.  lora <= 512 and rope <= 64, multiples of 8; split_lanes, a
// multiple of 64, is chosen by the wrapper with at most 8 splits of P * ps
// lanes (one cluster).
extern "C" int paged_mla_partials_tc(const void* q_lat, const void* q_rope, const void* ckv,
                                     const void* krope, const void* pages, const void* pos,
                                     void* acc, void* m, void* l, int B, int H, int lora, int rope,
                                     int ps, int P, int N, int split_lanes, float scale,
                                     void* stream) {
  const int S = P * ps;
  if (bad_shape(B, H, lora, rope, S, split_lanes) || !acc || !m || !l)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S + split_lanes - 1) / split_lanes;
  return launch(mla_partials_kernel, B, H, nsplit, static_cast<cudaStream_t>(stream),
                static_cast<const __nv_bfloat16*>(q_lat),
                static_cast<const __nv_bfloat16*>(q_rope), static_cast<const __nv_bfloat16*>(ckv),
                static_cast<const __nv_bfloat16*>(krope), static_cast<const int*>(pages),
                static_cast<const int*>(pos), static_cast<float*>(acc), static_cast<float*>(m),
                static_cast<float*>(l), H, lora, rope, ps, P, N, split_lanes, scale * kLog2e);
}

// The launch floor of paged_mla_partials_tc at these shapes: the empty
// kernel with its grid, cluster and shared memory.
extern "C" int paged_mla_partials_tc_empty(int B, int H, int S, int split_lanes, void* stream) {
  if (bad_shape(B, H, kLoraMax, kRopeMax, S, split_lanes)) return (int)cudaErrorInvalidValue;
  const int nsplit = (S + split_lanes - 1) / split_lanes;
  return launch(empty_kernel, B, H, nsplit, static_cast<cudaStream_t>(stream));
}
