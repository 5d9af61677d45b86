// Paged absorbed-MLA single-query decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_decode.py::paged_mla_attention (_mla_kernel,
// pallas_call at :250).  Same function: for each slot b and query head,
// attend over the slot's latent pages through its page-table row (-1 =
// unmapped, read as zero lanes and masked; a row past the pool's end reads
// the last row, as the plain gather clamps), masking lanes past pos[b]
// with the finite -1e30; scores in f32 as
// (q_lat . ckv + q_rope . krope) * scale, the scale applied after the sum;
// a full f32 softmax over all P * ps lanes (a row with no valid lane
// averages its gathered ckv lanes, 0 when nothing is mapped); the output
// is the f32 latent context p . ckv, (B, h, lora).
//
// What bounds it: the bytes.  At DeepSeek-V3's served shape (B = 8 slots,
// h = 128 heads, lora = 512, rope = 64, 512 lanes, bf16 in, f32 out) it
// must move q 1.2 MB + ckv 4.2 MB + krope 0.5 MB + out 2.1 MB = 8.0 MB,
// 2.4 us at 3.35 TB/s, and do 1.14 GFLOP: 1.2 us on the bf16 tensor
// cores.  All heads share one latent row per lane, so the work is two
// small products per slot, (h x 576) . (576 x S) and (h x S) . (S x 512).
//
// bf16 design (bf16_kernel; the layout of DeepSeek's public FlashMLA for
// this function on Hopper, on K7's wgmma helpers in hopper.cuh; the tile
// walk is mla_walk in mla_tiles.cuh, which paged_mla_partials.cu shares):
//   * grid (slot, group of 64 query heads, split): a split is a run of
//     split_lanes lanes, a multiple of the 64-lane tile.  The wrapper takes
//     the most splits that keep the grid within one wave (one block fills
//     an SM: 221 KB of shared memory) with at least two tiles a split, so
//     a tile's copy overlaps the products of the one before: 4 splits of
//     128 lanes at B = 8 and 512 lanes, 8 of 512 at 4096, the fastest of
//     the split sweep in chip_smoke.py phase 2f (one tile a split re-reads
//     Q and writes more partials per lane; a second wave waits on the
//     first).  Split boundaries and tiles sit at
//     multiples of 64 lanes from lane 0, so the reduction order is a
//     function of the lane index alone: a dense cache seen as one page of
//     S lanes a slot and a paged pool give the same bits;
//   * all 256 threads (two warpgroups) copy with cp.async, 16 bytes a
//     thread, four threads a lane: the block's 64 query rows [q_lat |
//     q_rope] once, then tiles of 64 latent rows [ckv | krope], each lane's
//     row found through the page table, into two stages (the next tile's
//     copies fly while the tensor cores work on this one).  Each row is 9
//     blocks of 64 columns (lora zero-padded to 512, rope to 64), 128 B a
//     row, 16-byte chunks XOR row % 8: the 128-byte swizzle wgmma reads.
//     Lanes past pos, past the split and on unmapped pages are never read:
//     cp.async writes zeros there (a zero in the tile, not a stale value,
//     meets p = 0 in P.V);
//   * S = Q K^T with wgmma.m64n64k16 over the 576 columns (36 steps; both
//     operands K-major in shared memory), f32 accumulators.  Both
//     warpgroups compute the same S: P.V needs all of P in each, and
//     recomputing S costs less than a handoff through shared memory;
//   * the online softmax in registers (quad shuffles per row, ex2 in log2
//     units; the scale applied to the f32 sum);
//   * O += P V with P from registers (the accumulator layout of S is the
//     A-fragment layout of P, as in K7) and V the tile's first 512
//     columns, MN-major (transpose-B).  The 512 context columns are split
//     between the two warpgroups (64 x 256 f32 accumulators each: one
//     warpgroup could not hold 64 x 512).  P is split into a bf16 high
//     part and a bf16 remainder, two products, so P carries 16 bits of
//     mantissa and the f32 context stays within the instance's 1e-3 limit
//     (bf16 P alone would put 2^-9 of relative error on every weight);
//   * the splits' unnormalised contexts and (m, l) go to f32 partials and
//     merge_kernel (split_merge.cuh, launched from the same entry point, as
//     K5's) combines them in split order and normalises;
//   * a slot with mapped pages but no valid lane: the full softmax over
//     -1e30 scores is uniform over all P * ps lanes.  The block detects the
//     case from the page row and pos (as K5 does) and takes that mean
//     explicitly: no S product, score 0 on every lane of the slot, the
//     unmapped ones zero-filled;
//   * the scores never sit in shared memory: max_len has no shared-memory
//     cap.
//
// f32 design (f32_kernel): CUDA cores, since TF32 tensor cores would break
// f32's 1e-4 limit.  One block per (slot, group of G query heads); G is a
// template parameter chosen by the wrapper, the largest that fits (16 at
// 512 lanes).  The block loads its page row and its G query rows into
// shared memory as f32.
//   Pass 1: one thread per lane (t = tid, tid + 256, ...) reads the lane's
//   576 latent values straight from device memory in 16-byte chunks and
//   keeps G dot products in registers.  Masked lanes never touch the
//   pools.  Scores go to shared memory as (S, G).
//   Softmax: per-head max and sum over all S lanes, each thread over its
//   lanes, reduced across the block.  The scores become p in place.
//   Pass 2: each thread owns two of the lora columns for all G heads and
//   streams the live lanes again: the lanes <= pos of mapped pages, or
//   every mapped lane when the row has no valid lane.
// Every sum runs over lanes in index order with the lane -> thread map
// t % 256, so a dense view gives the paged pool's bits here too.  The
// (S, G) scores live in shared memory, which bounds max_len; the wrapper
// refuses inputs whose block would exceed Hopper's 227 KB, and picks a
// smaller G for longer caches.
//
// The partials entry point paged_mla_partials_f32 gives each row's
// flash-decoding partial over the lanes it is given: the unnormalised f32
// context acc, the scores' max m in natural units and the softmax sum l.
// A member of a mesh that holds some of a slot's pages or lanes passes its
// own (a page table of its rows, pos shifted to its lanes; pos may be
// negative), and the members' partials combine in distributed/decode.py.
// A row with no valid lane gives the empty partial (acc 0, m -inf, l 0),
// never the whole-slot kernel's uniform mean: that mean is right for one
// whole slot and wrong inside a combine.  It is an epilogue variant of the
// CUDA-core kernel (kPartials): the same two passes, the softmax not
// normalised, and m and l written beside the context.  It keeps the f32
// kernel's lane order and its 1e-4 accuracy and needs no scratch.  The
// bf16 partials are paged_mla_partials.cu: one launch on this file's tile
// walk (mla_tiles.cuh), its splits merged in a thread-block cluster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"        // cp.async, wgmma and the swizzled descriptors
#include "mla_tiles.cuh"     // the bf16 tile walk
#include "split_merge.cuh"   // the split partials and the merge kernel

namespace {

// --------------------------------------------------------------------------
// f32: CUDA cores, scores in shared memory
// --------------------------------------------------------------------------

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;  // the wrapper's MLA_MAX_GROUP

// 8 consecutive values as f32; p is 16-byte aligned (the wrapper checks).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
// two consecutive values as f32 (p 8- or 4-byte aligned: the column is even)
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// G consecutive f32 from shared memory (16-byte aligned when G % 4 == 0)
template <int G>
__device__ __forceinline__ void load_row(const float* p, float (&r)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      r[i] = v.x; r[i + 1] = v.y; r[i + 2] = v.z; r[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) r[i] = p[i];
  }
}

template <int G>
__device__ __forceinline__ void store_row(float* p, const float (&r)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) p[i] = r[i];
  }
}

// Reduce each of the G values over the whole block; every thread gets
// the results.  `red` is kWarps * kMaxGroup floats of shared scratch.
template <int G, bool kMax>
__device__ void block_reduce(float (&v)[G], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, v[g], o);
      v[g] = kMax ? fmaxf(v[g], y) : v[g] + y;
    }
  }
  __syncthreads();  // the previous reduction may still be reading red
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) red[warp * G + g] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float a = red[g];
    for (int w = 1; w < kWarps; ++w) a = kMax ? fmaxf(a, red[w * G + g]) : a + red[w * G + g];
    v[g] = a;
  }
}

// dot products of one lane's row (n values, n % 8 == 0) with the G query
// rows held in shared memory at stride `dk`
template <int G>
__device__ __forceinline__ void dot_rows(const float* __restrict__ row, const float* qs, int dk,
                                         int n, float (&acc)[G]) {
#pragma unroll 4
  for (int d = 0; d < n; d += 8) {
    float kv[8];
    load8(row + d, kv);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 q0 = *reinterpret_cast<const float4*>(qs + g * dk + d);
      const float4 q1 = *reinterpret_cast<const float4*>(qs + g * dk + d + 4);
      float a = acc[g];
      a = fmaf(q0.x, kv[0], a);
      a = fmaf(q0.y, kv[1], a);
      a = fmaf(q0.z, kv[2], a);
      a = fmaf(q0.w, kv[3], a);
      a = fmaf(q1.x, kv[4], a);
      a = fmaf(q1.y, kv[5], a);
      a = fmaf(q1.z, kv[6], a);
      a = fmaf(q1.w, kv[7], a);
      acc[g] = a;
    }
  }
}

// kPartials: out takes the unnormalised context, m_out / l_out the row's
// max (natural units) and sum; a row with no valid lane the empty partial.
template <int G, bool kPartials>
__global__ void __launch_bounds__(kThreads)
    f32_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
                            const float* __restrict__ ckv, const float* __restrict__ krope,
                            const int* __restrict__ pages, const int* __restrict__ pos,
                            float* __restrict__ out, float* __restrict__ m_out,
                            float* __restrict__ l_out, int H, int lora, int rope, int ps, int P,
                            int N, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dk = lora + rope;
  const int S = P * ps;
  float* red = smem;                                 // kWarps * kMaxGroup
  float* qs = red + kWarps * kMaxGroup;              // G * dk query rows, f32
  float* sc = qs + G * dk;                           // S * G scores, then p
  int* rows = reinterpret_cast<int*>(sc + (size_t)S * G);  // P page rows of slot b

  const int b = blockIdx.x;
  const int h0 = blockIdx.y * G;
  const int tid = threadIdx.x;
  const int qpos = pos[b];

  for (int i = tid; i < P; i += kThreads) rows[i] = min(pages[(size_t)b * P + i], N - 1);
  for (int i = tid; i < G * dk; i += kThreads) {
    const int g = i / dk, d = i - g * dk;
    const size_t hq = (size_t)b * H + h0 + g;
    qs[i] = d < lora ? q_lat[hq * lora + d] : q_rope[hq * rope + d - lora];
  }
  __syncthreads();

  // Pass 1: scores, one thread per lane.
  int my_valid = 0;
  for (int t = tid; t < S; t += kThreads) {
    const int row = rows[t / ps];
    float s[G];
    if (row < 0 || t > qpos) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = kNegInf;
    } else {
      my_valid = 1;
      const size_t lane_off = (size_t)row * ps + (t % ps);
      float al[G], ar[G];
#pragma unroll
      for (int g = 0; g < G; ++g) al[g] = ar[g] = 0.f;
      dot_rows<G>(ckv + lane_off * lora, qs, dk, lora, al);
      dot_rows<G>(krope + lane_off * rope, qs + lora, dk, rope, ar);
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = (al[g] + ar[g]) * scale;
    }
    store_row<G>(sc + (size_t)t * G, s);
  }
  const int any_valid = __syncthreads_or(my_valid);
  if (kPartials && !any_valid) {  // the empty partial
    for (int i = tid; i < G * lora; i += kThreads) out[((size_t)b * H + h0) * lora + i] = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      m_out[(size_t)b * H + h0 + g] = -INFINITY;
      l_out[(size_t)b * H + h0 + g] = 0.f;
    }
    return;
  }

  // Softmax over all S lanes, per head: max, exp and sum, normalise.
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = -INFINITY, l[g] = 0.f;
  for (int t = tid; t < S; t += kThreads) {
    float r[G];
    load_row<G>(sc + (size_t)t * G, r);
#pragma unroll
    for (int g = 0; g < G; ++g) m[g] = fmaxf(m[g], r[g]);
  }
  block_reduce<G, true>(m, red);
  for (int t = tid; t < S; t += kThreads) {
    float r[G];
    load_row<G>(sc + (size_t)t * G, r);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      r[g] = expf(r[g] - m[g]);
      l[g] += r[g];
    }
    store_row<G>(sc + (size_t)t * G, r);
  }
  block_reduce<G, false>(l, red);
  if constexpr (kPartials) {
    if (tid == 0) {  // every thread holds the reduced m and l
#pragma unroll
      for (int g = 0; g < G; ++g) {
        m_out[(size_t)b * H + h0 + g] = m[g];
        l_out[(size_t)b * H + h0 + g] = l[g];
      }
    }
  } else {
    for (int t = tid; t < S; t += kThreads) {
      float r[G];
      load_row<G>(sc + (size_t)t * G, r);
#pragma unroll
      for (int g = 0; g < G; ++g) r[g] = r[g] / l[g];
      store_row<G>(sc + (size_t)t * G, r);
    }
  }
  __syncthreads();

  // Pass 2: the latent context, two columns of all G heads per thread,
  // over the live lanes.
  float* ob = out + ((size_t)b * H + h0) * lora;
  for (int c = 2 * tid; c < lora; c += 2 * kThreads) {
    float a0[G], a1[G];
#pragma unroll
    for (int g = 0; g < G; ++g) a0[g] = a1[g] = 0.f;
    for (int pg = 0; pg < P; ++pg) {
      const int row = rows[pg];
      if (row < 0) continue;  // unmapped page: zero lanes
      const int t0 = pg * ps;
      const int t1 = any_valid ? min(t0 + ps, qpos + 1) : t0 + ps;
      const float* kr = ckv + (size_t)row * ps * lora + c;
#pragma unroll 8
      for (int t = t0; t < t1; ++t) {
        const float2 kv = load2(kr + (size_t)(t - t0) * lora);
        float r[G];
        load_row<G>(sc + (size_t)t * G, r);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          a0[g] = fmaf(r[g], kv.x, a0[g]);
          a1[g] = fmaf(r[g], kv.y, a1[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      *reinterpret_cast<float2*>(ob + (size_t)g * lora + c) = make_float2(a0[g], a1[g]);
  }
}

template <int G, bool kPartials>
int launch_g(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
             const void* pages, const void* pos, void* out, void* m_out, void* l_out, int B,
             int H, int lora, int rope, int ps, int P, int N, float scale, size_t smem,
             cudaStream_t stream) {
  // Raise the block's dynamic shared memory limit once per size, on the
  // first (eager) launch: not again inside a CUDA-graph capture.
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        f32_kernel<G, kPartials>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid(B, H / G);
  f32_kernel<G, kPartials><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope), static_cast<const float*>(ckv),
      static_cast<const float*>(krope), static_cast<const int*>(pages), static_cast<const int*>(pos),
      static_cast<float*>(out), static_cast<float*>(m_out), static_cast<float*>(l_out), H, lora,
      rope, ps, P, N, scale);
  return (int)cudaGetLastError();
}

// m_out == nullptr: the normalised context; else the partials
int launch_f32(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
               const void* pages, const void* pos, void* out, int B, int H, int lora, int rope,
               int ps, int P, int N, int G, float scale, size_t smem, void* stream,
               void* m_out = nullptr, void* l_out = nullptr) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLA_F32(G_)                                                                          \
  (m_out ? launch_g<G_, true>(q_lat, q_rope, ckv, krope, pages, pos, out, m_out, l_out, B, H, \
                              lora, rope, ps, P, N, scale, smem, s)                          \
         : launch_g<G_, false>(q_lat, q_rope, ckv, krope, pages, pos, out, nullptr, nullptr, \
                               B, H, lora, rope, ps, P, N, scale, smem, s))
  switch (G) {
    case 1: return MLA_F32(1);
    case 2: return MLA_F32(2);
    case 4: return MLA_F32(4);
    case 8: return MLA_F32(8);
    case 16: return MLA_F32(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MLA_F32
}

// --------------------------------------------------------------------------
// bf16: cp.async tiles through the page table, wgmma on the tensor cores
// (the walk is mla_tiles.cuh's, shared with paged_mla_partials.cu)
// --------------------------------------------------------------------------
__global__ void __launch_bounds__(kBf16Threads, 1)
    bf16_kernel(const __nv_bfloat16* __restrict__ q_lat, const __nv_bfloat16* __restrict__ q_rope,
                const __nv_bfloat16* __restrict__ ckv, const __nv_bfloat16* __restrict__ krope,
                const int* __restrict__ pages, const int* __restrict__ pos,
                float* __restrict__ part, int H, int lora, int rope, int ps, int P, int N,
                int split_lanes, int nsplit, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;
  // per stage and lane of the tile: 1 where the lane's score counts
  unsigned char* okf = smem_raw + (qs - raw) + 3 * kTileBytes;

  const int b = blockIdx.x, h0 = blockIdx.y * kHeads, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int qpos = pos[b];
  const int* prow = pages + (size_t)b * P;

  // Does the slot have a valid lane (a mapped page starting at or before
  // pos)?  If not, the block takes the uniform mean of the slot's lanes.
  int has_valid = 0;
  for (int i = tid; i < P; i += kBf16Threads) has_valid |= prow[i] >= 0 && i * ps <= qpos;
  const bool uniform = !__syncthreads_or(has_valid);
  const int S = P * ps;
  const int L0 = split * split_lanes;
  const int Lend = min(S, L0 + split_lanes);
  const int L1 = uniform ? Lend : min(Lend, qpos + 1);  // lanes [L0, L1) of the split
  const Partials pt(part, gridDim.x * H, nsplit, lora);
  if (L1 <= L0) {  // no valid lane in this split: an empty partial
    for (int g = tid; g < kHeads && h0 + g < H; g += kBf16Threads) {
      const size_t i = ((size_t)b * H + h0 + g) * nsplit + split;
      pt.m[i] = -INFINITY;
      pt.l[i] = 0.f;
    }
    return;
  }

  float o[2][64];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 64; ++j) o[i][j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  mla_walk(q_lat, q_rope, ckv, krope, prow, b, H, h0, lora, rope, ps, N, L0, L1, uniform,
           scale_log2, qs, okf, o, m0, m1, l0, l1);

  // this split's partials: the unnormalised context, (m, l) in log2 units
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int hA = h0 + r0, hB = hA + 8;
  const size_t jA = ((size_t)b * H + hA) * nsplit + split, jB = jA + 8 * (size_t)nsplit;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int col = 256 * wg + 128 * i + 8 * jj + c0;  // lora % 8 == 0: col + 1 < lora too
      if (col >= lora) continue;
      if (hA < H)
        *reinterpret_cast<float2*>(pt.acc + jA * lora + col) =
            make_float2(o[i][4 * jj], o[i][4 * jj + 1]);
      if (hB < H)
        *reinterpret_cast<float2*>(pt.acc + jB * lora + col) =
            make_float2(o[i][4 * jj + 2], o[i][4 * jj + 3]);
    }
  if (wg == 0 && (lane & 3) == 0) {
    if (hA < H) pt.m[jA] = m0, pt.l[jA] = l0;
    if (hB < H) pt.m[jB] = m1, pt.l[jB] = l1;
  }
}

// the split kernel, then merge_kernel: the normalised context
int launch_bf16(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
                const void* pages, const void* pos, void* out, void* part, int B, int H,
                int lora, int rope, int ps, int P, int N, int split_lanes, float scale,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lora > kLoraMax || rope > kRopeMax || lora % 8 || rope % 8 || split_lanes < kTile ||
      split_lanes % kTile || !part || !out)
    return (int)cudaErrorInvalidValue;
  // Raise the dynamic shared memory limit on the first (eager) launch:
  // not again inside a CUDA-graph capture.
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBf16Smem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const int nsplit = (P * ps + split_lanes - 1) / split_lanes;
  const dim3 grid(B, (H + kHeads - 1) / kHeads, nsplit);
  bf16_kernel<<<grid, kBf16Threads, kBf16Smem, s>>>(
      static_cast<const __nv_bfloat16*>(q_lat), static_cast<const __nv_bfloat16*>(q_rope),
      static_cast<const __nv_bfloat16*>(ckv), static_cast<const __nv_bfloat16*>(krope),
      static_cast<const int*>(pages), static_cast<const int*>(pos), static_cast<float*>(part), H,
      lora, rope, ps, P, N, split_lanes, nsplit, scale * kLog2e);
  if (const int e = (int)cudaGetLastError()) return e;
  merge_kernel<float><<<B * H, kMergeThreads, 0, s>>>(static_cast<const float*>(part),
                                                      static_cast<float*>(out), B * H, lora,
                                                      nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Device pointers of contiguous, 16-byte aligned tensors: q_lat (B,H,lora),
// q_rope (B,H,rope), ckv (N,ps,lora), krope (N,ps,rope), all of the entry
// point's type; pages (B,P) int32 (-1 = unmapped); pos (B,) int32; out
// (B,H,lora) f32.  lora and rope are multiples of 8.
//
// f32: G (heads per block) is 1, 2, 4, 8 or 16 and divides H; `smem` is
// the block's dynamic shared memory in bytes, computed by the wrapper:
// 4 * (8 * 16 + G * (lora + rope) + P * ps * G + P).
extern "C" int paged_mla_decode_f32(const void* q_lat, const void* q_rope, const void* ckv,
                                    const void* krope, const void* pages, const void* pos,
                                    void* out, int B, int H, int lora, int rope, int ps, int P,
                                    int N, int G, float scale, size_t smem, void* stream) {
  return launch_f32(q_lat, q_rope, ckv, krope, pages, pos, out, B, H, lora, rope, ps, P, N, G,
                    scale, smem, stream);
}

// bf16: lora <= 512 and rope <= 64; `part` is f32 scratch of
// B*H*nsplit*(lora + 2) floats, nsplit = ceil(P * ps / split_lanes), and
// split_lanes a multiple of 64 chosen by the wrapper.  One call launches
// the split kernel and the merge kernel: the wrapper counts it as one
// launch.
extern "C" int paged_mla_decode_bf16(const void* q_lat, const void* q_rope, const void* ckv,
                                     const void* krope, const void* pages, const void* pos,
                                     void* out, void* part, int B, int H, int lora, int rope,
                                     int ps, int P, int N, int split_lanes, float scale,
                                     void* stream) {
  return launch_bf16(q_lat, q_rope, ckv, krope, pages, pos, out, part, B, H, lora, rope, ps, P,
                     N, split_lanes, scale, stream);
}

// The partials of the same attention (see the header): acc (B,H,lora) f32,
// m and l (B,H) f32, contiguous; pos may be negative (no valid lane).
// f32: the arguments of paged_mla_decode_f32 with out = acc.
extern "C" int paged_mla_partials_f32(const void* q_lat, const void* q_rope, const void* ckv,
                                      const void* krope, const void* pages, const void* pos,
                                      void* acc, void* m, void* l, int B, int H, int lora,
                                      int rope, int ps, int P, int N, int G, float scale,
                                      size_t smem, void* stream) {
  if (!acc || !m || !l) return (int)cudaErrorInvalidValue;
  return launch_f32(q_lat, q_rope, ckv, krope, pages, pos, acc, B, H, lora, rope, ps, P, N, G,
                    scale, smem, stream, m, l);
}
