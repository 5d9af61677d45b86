// Paged single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode.py:50-152
// (paged_gqa_attention / _gqa_kernel, pallas_call at :144).  Same
// function: for each slot b and query head, attend over the slot's K/V
// pages through its page-table row (-1 = unmapped, read as zero lanes and
// masked; a row past the pool's end reads the pool's last row), masking
// lanes past pos[b]; scores in f32 as (q * scale) . k; softmax over all
// P * ps lanes with masked lanes at -1e30; P.V in f32; cast to the input
// type.  Like the reference, any query group G = Hq / Hkv is taken.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): the bytes of
// the valid K/V lanes, read once.  At the serving shape (B = 8 slots,
// Hkv = 8, Dk = 128, bf16, pages of 16, 512 lanes) with every lane valid
// that is 16.8 MB, 5.0 us at 3.35 TB/s; with ragged pos 2.3 us, and with
// the 40-100 valid lanes of a short serving run under 1 us, where launch
// and latency rule.  The arithmetic (4 flop per lane, head and dimension)
// is far below the card's f32 rate.
//
// Design (split-lane decode):
//   * grid (slot, kv head x head chunk, split): a chunk is at most 8 of
//     the group's query heads, so G > 8 (48 for MQA granite-20b, 12 for
//     command-r-plus) takes ceil(G / 8) blocks per kv head.  The blocks
//     of one kv head read the same K/V rows, the later ones from L2.  The
//     other choice, a loop over chunks inside the block, was argued, not
//     built or measured: it would hold the same register tile (kG <= 8)
//     plus the loop's state and leave the grid smaller, so the grid axis
//     was taken.  ptxas' report of the instances built (the chip smoke
//     log) covers this design only.  A split takes a run of split_lanes
//     lanes (a multiple of 64), and the wrapper picks the number of splits
//     so the grid has at least two blocks an SM (8 splits of 64 lanes, 512
//     blocks, at the serving shape).  A split with no valid lane writes an empty partial
//     and exits;
//   * the pool is addressed by strides: lane t of page row r and kv head h
//     is at r * page_stride + h * head_stride + (t % ps) * Dk.  A pool
//     (N, Hkv, ps, Dk) has strides (Hkv ps Dk, ps Dk); a dense cache
//     (B, Hkv, S, Dk) is read in place as one page of S lanes a slot
//     (strides (S Dk, S Dk), page row b * Hkv), which is how dense decode
//     runs this kernel on the card;
//   * the reduction order is a function of the lane index alone: split
//     boundaries are multiples of 64 lanes, fixed by (B, Hkv, G, P * ps)
//     and the SM count, and a lane's row group, warp and unroll slot
//     depend on t - L0 only.  So a dense view and a paged pool that hold
//     the same values at the lanes a slot attends to give the same bits
//     for any page size, which the engine's paged-vs-dense token parity
//     rests on;
//   * the G <= 8 query heads of the chunk stay in registers; a K or V row
//     is read with 16-byte loads, 8 values a thread, ceil(Dk / 8) threads
//     (a power of two) a row, so a warp covers 32 / that many rows at once
//     and keeps kUnroll of its rows' loads in flight;
//   * each row group keeps its own online softmax (m, l, acc) over the
//     lanes it reads, in log2 units; masked lanes and unmapped pages are
//     never read.  Row groups merge by shuffles, warps in shared memory,
//     splits in a second kernel (merge_kernel, launched from the same
//     entry point), which also normalises; one split takes the same two
//     passes;
//   * a slot with mapped pages but no valid lane (page 0 unmapped and
//     pos < ps, say): the full softmax over -1e30 scores is uniform over
//     all P * ps lanes, so the output is the sum of the mapped V lanes over
//     P * ps (0 when nothing is mapped).  An online softmax that skips
//     masked lanes would give 0 / 0, so the block detects the case from the
//     page row and pos and takes that uniform mean explicitly (score 0 on
//     every lane, unmapped lanes weighing 1 with V = 0).
// The partials entry point (paged_gqa_partials_*) runs the same split
// kernel without the uniform case (a slot with no valid lane gives an
// empty partial: m = -inf, l = 0), then merge_partials_kernel, which
// merges the splits but does not divide: each row's (acc, m, l) over the
// lanes it was given.  A member of a sequence-sharded mesh passes its own
// lanes with pos shifted by its first lane, and the members' partials are
// combined by the flash-decoding collectives (distributed/decode.py).
// The scores and the page rows never live in shared memory, so neither
// max_len nor the page size is bounded by it; Dk must be a multiple of 8
// and at most 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "split_merge.cuh"  // the split partials and the merge kernel

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // lanes a row group has in flight
constexpr int kChunk = 8;      // query heads a block takes at most
constexpr float kLog2e = 1.4426950408889634f;

// 8 consecutive values of a row, as 16-byte loads (one for bf16, two for
// f32), kept raw until used.
template <typename T>
struct Row8;
template <>
struct Row8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);  // bf16 -> f32 is exact
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Row8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void get(float (&x)[8]) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

// Merge the online-softmax state (m2, l2, acc2) into (m, l, acc); m in
// log2 units, -inf when nothing was seen.
template <int kN>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[kN], float m2, float l2,
                                      const float (&acc2)[kN]) {
  const float mx = fmaxf(m, m2);
  const float mu = mx == -INFINITY ? 0.f : mx;
  const float a = exp2f(m - mu), b = exp2f(m2 - mu);
  l = l * a + l2 * b;
#pragma unroll
  for (int e = 0; e < kN; ++e) acc[e] = acc[e] * a + acc2[e] * b;
  m = mx;
}

// kG: the chunk bound (a block takes Gc <= kG <= kChunk query heads).
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const int* __restrict__ pages,
                 const int* __restrict__ pos, float* __restrict__ part, int Hq, int Hkv, int Dk,
                 int ps, int P, int N, long long page_stride, long long head_stride,
                 int split_lanes, int nsplit, int nchunk, float scale_log2, int tpr,
                 int allow_uniform) {
  extern __shared__ float smem[];  // warp partials: m, l (kWarps * Gc each), acc
  const int G = Hq / Hkv;
  const int b = blockIdx.x, h = blockIdx.y / nchunk, split = blockIdx.z;
  const int g0 = (blockIdx.y % nchunk) * kChunk;  // the chunk's first head in the group
  const int Gc = min(kChunk, G - g0);
  const int hq0 = h * G + g0;  // its first query head
  float* wm = smem;
  float* wl = wm + kWarps * Gc;
  float* wacc = wl + kWarps * Gc;  // kWarps * Gc * Dk

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qpos = pos[b];
  const int* prow = pages + (size_t)b * P;

  // Does the slot have any valid lane (a mapped page starting at or
  // before pos)?  If not, every split takes the uniform mean.
  int has_valid = 0;
  for (int i = tid; i < P; i += kThreads) has_valid |= prow[i] >= 0 && i * ps <= qpos;

  // this thread: row group warp * rpw + lane / tpr of ngroups, chunk sub
  // (dims 8 sub .. 8 sub + 7); its query values, loaded meanwhile
  const int rpw = 32 / tpr;
  const int ngroups = kWarps * rpw;
  const int sub = lane % tpr;
  const bool active = sub * 8 < Dk;
  float qv[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (g < Gc && active) {
      Row8<T> r;
      r.load(q + ((size_t)b * Hq + hq0 + g) * Dk + sub * 8);
      r.get(x);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[g][e] = x[e] * scale_log2;
  }
  const bool none_valid = !__syncthreads_or(has_valid);
  const bool uniform = allow_uniform && none_valid;
  const int S = P * ps;
  const int L0 = split * split_lanes;
  const int Lend = min(S, L0 + split_lanes);
  const int L1 = uniform ? Lend : min(Lend, qpos + 1);  // lanes [L0, L1) of the split
  const int BH = gridDim.x * Hq;
  const Partials pt(part, BH, nsplit, Dk);
  if (L1 <= L0) {  // no valid lane in this split: an empty partial
    for (int g = tid; g < Gc; g += kThreads) {
      const size_t i = ((size_t)b * Hq + hq0 + g) * nsplit + split;
      pt.m[i] = -INFINITY;
      pt.l[i] = 0.f;
    }
    return;
  }
  float m[kG], l[kG], acc[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  // The trip count is the warp's (its first row group's), not the row
  // group's: every lane of the warp must reach the shuffles below.
  const size_t head_off = (size_t)h * head_stride + sub * 8;
  for (int tw = L0 + warp * rpw; tw < L1; tw += ngroups * kUnroll) {
    Row8<T> kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = tw + lane / tpr + u * ngroups;
      const int row = t < L1 ? min(__ldg(prow + t / ps), N - 1) : -1;
      ok[u] = t < L1 && (uniform || row >= 0);
      kr[u].zero();
      vr[u].zero();
      if (row >= 0 && active) {
        const size_t off = (size_t)row * page_stride + head_off + (size_t)(t % ps) * Dk;
        if (!uniform) kr[u].load(k_pool + off);
        vr[u].load(v_pool + off);
      }
    }
    float sc[kUnroll][kG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kx[8];
      kr[u].get(kx);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(qv[g][e], kx[e], s);
        for (int o = tpr >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        sc[u][g] = ok[u] ? (uniform ? 0.f : s) : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, sc[u][g]);
      const float mu = mx == -INFINITY ? 0.f : mx;
      const float al = exp2f(m[g] - mu);
      float pu[kUnroll], ps_sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        pu[u] = exp2f(sc[u][g] - mu);
        ps_sum += pu[u];
      }
      l[g] = l[g] * al + ps_sum;
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= al;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float vx[8];
        vr[u].get(vx);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pu[u], vx[e], acc[g][e]);
      }
    }
  }

  // row groups of a warp, by shuffles; then warps, in shared memory
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    for (int o = tpr; o < 32; o <<= 1) {
      float acc2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc2[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      merge(m[g], l[g], acc[g], m2, l2, acc2);
    }
    if (g < Gc && lane < tpr) {
      if (lane == 0) {
        wm[warp * Gc + g] = m[g];
        wl[warp * Gc + g] = l[g];
      }
      if (active)
#pragma unroll
        for (int e = 0; e < 8; ++e) wacc[(warp * Gc + g) * Dk + sub * 8 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < Gc * Dk; i += kThreads) {
    const int g = i / Dk, d = i - g * Dk;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * Gc + g]);
    const float mu = M == -INFINITY ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm[w * Gc + g] - mu);  // 0 for a warp that saw nothing
      L += wl[w * Gc + g] * f;
      A += f == 0.f ? 0.f : wacc[(w * Gc + g) * Dk + d] * f;
    }
    const size_t j = ((size_t)b * Hq + hq0 + g) * nsplit + split;
    pt.acc[j * Dk + d] = A;
    if (d == 0) {
      pt.m[j] = M;
      pt.l[j] = L;
    }
  }
}

// out != null: the normalised output (merge_kernel); else the partials
// acc / m / l (merge_partials_kernel), with no uniform case.
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* pages,
           const void* pos, void* out, void* part, int B, int Hq, int Hkv, int Dk, int ps, int P,
           int N, long long page_stride, long long head_stride, int split_lanes, float scale,
           void* stream, float* acc = nullptr, float* m_out = nullptr, float* l_out = nullptr) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  int tpr = 1;
  while (tpr * 8 < Dk) tpr <<= 1;  // threads a row: ceil(Dk / 8), a power of two <= 32
  if (Dk % 8 || tpr > 32 || G < 1 || Hq % Hkv || split_lanes < 64 || split_lanes % 64 || !part)
    return (int)cudaErrorInvalidValue;
  const int S = P * ps;
  const int nsplit = (S + split_lanes - 1) / split_lanes;
  const int nchunk = (G + kChunk - 1) / kChunk;
  const int Gc = min(G, kChunk);
  const size_t smem = sizeof(float) * (2 * kWarps * Gc + (size_t)kWarps * Gc * Dk);
  const dim3 grid(B, Hkv * nchunk, nsplit);
  const T* qq = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  const int* pg = static_cast<const int*>(pages);
  const int* pp = static_cast<const int*>(pos);
  float* pt = static_cast<float*>(part);
  const float sl = scale * kLog2e;
#define GQA_SPLIT(KG)                                                                       \
  split_kernel<T, KG><<<grid, kThreads, smem, s>>>(qq, kp, vp, pg, pp, pt, Hq, Hkv, Dk, ps, P, \
                                                   N, page_stride, head_stride, split_lanes,  \
                                                   nsplit, nchunk, sl, tpr, out != nullptr)
  if (Gc == 1)
    GQA_SPLIT(1);
  else if (Gc == 2)
    GQA_SPLIT(2);
  else if (Gc <= 4)
    GQA_SPLIT(4);
  else
    GQA_SPLIT(8);
#undef GQA_SPLIT
  if (const int e = (int)cudaGetLastError()) return e;
  if (out)
    merge_kernel<T><<<B * Hq, kMergeThreads, 0, s>>>(pt, static_cast<T*>(out), B * Hq, Dk, nsplit);
  else
    merge_partials_kernel<<<B * Hq, kMergeThreads, 0, s>>>(pt, acc, m_out, l_out, B * Hq, Dk,
                                                            nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Device pointers, 16-byte aligned: q (B,Hq,Dk) and out (B,Hq,Dk)
// contiguous; the pools' lane t of page row r and kv head h at element
// r * page_stride + h * head_stride + (t % ps) * Dk (rows r < N); pages
// (B,P) int32 (-1 = unmapped); pos (B,) int32; `part` is f32 scratch of
// B*Hq*nsplit*(Dk + 2) floats, nsplit = ceil(P * ps / split_lanes).
// split_lanes, a multiple of 64, is chosen by the wrapper.  One call
// launches the split kernel and the merge kernel: the wrapper counts it
// as one launch.
extern "C" int paged_gqa_decode_f32(const void* q, const void* k_pool, const void* v_pool,
                                    const void* pages, const void* pos, void* out, void* part,
                                    int B, int Hq, int Hkv, int Dk, int ps, int P, int N,
                                    long long page_stride, long long head_stride,
                                    int split_lanes, float scale, void* stream) {
  return launch<float>(q, k_pool, v_pool, pages, pos, out, part, B, Hq, Hkv, Dk, ps, P, N,
                       page_stride, head_stride, split_lanes, scale, stream);
}

extern "C" int paged_gqa_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                     const void* pages, const void* pos, void* out, void* part,
                                     int B, int Hq, int Hkv, int Dk, int ps, int P, int N,
                                     long long page_stride, long long head_stride,
                                     int split_lanes, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, pages, pos, out, part, B, Hq, Hkv, Dk, ps, P,
                               N, page_stride, head_stride, split_lanes, scale, stream);
}

// The partials of the same attention (see the header): acc (B,Hq,Dk) f32,
// m and l (B,Hq) f32, contiguous; pos may be negative (no valid lane).
extern "C" int paged_gqa_partials_f32(const void* q, const void* k_pool, const void* v_pool,
                                      const void* pages, const void* pos, void* acc, void* m,
                                      void* l, void* part, int B, int Hq, int Hkv, int Dk, int ps,
                                      int P, int N, long long page_stride, long long head_stride,
                                      int split_lanes, float scale, void* stream) {
  if (!acc || !m || !l) return (int)cudaErrorInvalidValue;
  return launch<float>(q, k_pool, v_pool, pages, pos, nullptr, part, B, Hq, Hkv, Dk, ps, P, N,
                       page_stride, head_stride, split_lanes, scale, stream,
                       static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l));
}

extern "C" int paged_gqa_partials_bf16(const void* q, const void* k_pool, const void* v_pool,
                                       const void* pages, const void* pos, void* acc, void* m,
                                       void* l, void* part, int B, int Hq, int Hkv, int Dk, int ps,
                                       int P, int N, long long page_stride, long long head_stride,
                                       int split_lanes, float scale, void* stream) {
  if (!acc || !m || !l) return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16>(q, k_pool, v_pool, pages, pos, nullptr, part, B, Hq, Hkv, Dk, ps,
                               P, N, page_stride, head_stride, split_lanes, scale, stream,
                               static_cast<float*>(acc), static_cast<float*>(m),
                               static_cast<float*>(l));
}
