// Paged absorbed-MLA single-query decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_decode.py::paged_mla_attention (_mla_kernel).  Same function: for each slot b and
// query head, attend over the slot's latent pages through its page-table
// row (-1 = unmapped, read as zero lanes and masked; a row past the pool's
// end reads the last row, as the plain gather clamps), masking lanes past
// pos[b] with the finite -1e30; scores in f32 as
// (q_lat . ckv + q_rope . krope) * scale, the scale applied after the sum;
// a full f32 softmax over all P * ps lanes (a row with no valid lane
// averages its gathered ckv lanes, 0 when nothing is mapped); the output
// is the f32 latent context p . ckv, (B, h, lora).
//
// What bounds it: the bytes.  At DeepSeek-V3's served shape (B = 8 slots,
// h = 128 heads, lora = 512, rope = 64, 512 lanes, bf16 in, f32 out) it
// must move q 1.2 MB + ckv 4.2 MB + krope 0.5 MB + out 2.1 MB = 8.0 MB,
// 2.4 us at 3.35 TB/s, and do 1.14 GFLOP: 1.2 us on the bf16 tensor
// cores, 17 us on the f32 CUDA cores this kernel uses.  All heads share
// one latent row per lane, so the work is two small products per slot,
// (h x 576) . (576 x S) and (h x S) . (S x 512).
//
// Design (simple and right first): one block per (slot, group of G query
// heads); G is a template parameter chosen by the wrapper, the largest
// that fits (16 at the served shape).  The block loads its page row itself (no
// scalar prefetch) and its G query rows [q_lat | q_rope] into shared
// memory as f32.
//   Pass 1: one thread per lane (t = tid, tid + 256, ...) reads the lane's
//   576 latent values straight from device memory in 16-byte chunks and
//   keeps G dot products in registers; the query values are shared-memory
//   broadcasts (every thread of a warp reads the same float4).  Masked
//   lanes never touch the pools.  Scores go to shared memory as (S, G).
//   Softmax: per-head max and sum over all S lanes, each thread over its
//   lanes, reduced across the block (warp shuffles, then one row per warp
//   in shared memory).  The scores become p in place.
//   Pass 2: each thread owns two of the lora columns for all G heads (2G
//   f32 accumulators in registers) and streams the live lanes again: the
//   lanes <= pos of mapped pages, or every mapped lane when the row has no
//   valid lane (masked lanes of a row with a valid lane have p = 0 exactly).
// Known costs, recorded and not fixed here: at the served shape the grid
// is 64 blocks on 132 SMs, the latent rows are read h / G times (from L2),
// and the products run on the CUDA cores in f32.
// The (S, G) scores live in shared memory, which bounds max_len; the
// wrapper refuses inputs whose block would exceed Hopper's 227 KB, and
// picks a smaller G for longer caches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

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
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// two consecutive values as f32 (p 8- or 4-byte aligned: the column is even)
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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
template <int G, typename T>
__device__ __forceinline__ void dot_rows(const T* __restrict__ row, const float* qs, int dk,
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

template <int G, typename T>
__global__ void __launch_bounds__(kThreads)
    paged_mla_decode_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                            const T* __restrict__ ckv, const T* __restrict__ krope,
                            const int* __restrict__ pages, const int* __restrict__ pos,
                            float* __restrict__ out, int H, int lora, int rope, int ps, int P,
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
    qs[i] = d < lora ? load_f32(q_lat + hq * lora + d) : load_f32(q_rope + hq * rope + d - lora);
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
  for (int t = tid; t < S; t += kThreads) {
    float r[G];
    load_row<G>(sc + (size_t)t * G, r);
#pragma unroll
    for (int g = 0; g < G; ++g) r[g] = r[g] / l[g];
    store_row<G>(sc + (size_t)t * G, r);
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
      const T* kr = ckv + (size_t)row * ps * lora + c;
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

template <int G, typename T>
int launch_g(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
             const void* pages, const void* pos, void* out, int B, int H, int lora, int rope,
             int ps, int P, int N, float scale, size_t smem, cudaStream_t stream) {
  // Raise the block's dynamic shared memory limit once per size, on the
  // first (eager) launch: not again inside a CUDA-graph capture.
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_mla_decode_kernel<G, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid(B, H / G);
  paged_mla_decode_kernel<G, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope), static_cast<const T*>(ckv),
      static_cast<const T*>(krope), static_cast<const int*>(pages), static_cast<const int*>(pos),
      static_cast<float*>(out), H, lora, rope, ps, P, N, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
           const void* pages, const void* pos, void* out, int B, int H, int lora, int rope,
           int ps, int P, int N, int G, float scale, size_t smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 1:
      return launch_g<1, T>(q_lat, q_rope, ckv, krope, pages, pos, out, B, H, lora, rope, ps, P,
                            N, scale, smem, s);
    case 2:
      return launch_g<2, T>(q_lat, q_rope, ckv, krope, pages, pos, out, B, H, lora, rope, ps, P,
                            N, scale, smem, s);
    case 4:
      return launch_g<4, T>(q_lat, q_rope, ckv, krope, pages, pos, out, B, H, lora, rope, ps, P,
                            N, scale, smem, s);
    case 8:
      return launch_g<8, T>(q_lat, q_rope, ckv, krope, pages, pos, out, B, H, lora, rope, ps, P,
                            N, scale, smem, s);
    case 16:
      return launch_g<16, T>(q_lat, q_rope, ckv, krope, pages, pos, out, B, H, lora, rope, ps,
                             P, N, scale, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Device pointers of contiguous, 16-byte aligned tensors: q_lat (B,H,lora),
// q_rope (B,H,rope), ckv (N,ps,lora), krope (N,ps,rope), all of the entry
// point's type; pages (B,P) int32 (-1 = unmapped); pos (B,) int32; out
// (B,H,lora) f32.  lora and rope are multiples of 8; G (heads per block)
// is 1, 2, 4, 8 or 16 and divides H.  `smem` is the block's dynamic
// shared memory in bytes, computed by the wrapper:
// 4 * (8 * 16 + G * (lora + rope) + P * ps * G + P).
extern "C" int paged_mla_decode_f32(const void* q_lat, const void* q_rope, const void* ckv,
                                    const void* krope, const void* pages, const void* pos,
                                    void* out, int B, int H, int lora, int rope, int ps, int P,
                                    int N, int G, float scale, size_t smem, void* stream) {
  return launch<float>(q_lat, q_rope, ckv, krope, pages, pos, out, B, H, lora, rope, ps, P, N, G,
                       scale, smem, stream);
}

extern "C" int paged_mla_decode_bf16(const void* q_lat, const void* q_rope, const void* ckv,
                                     const void* krope, const void* pages, const void* pos,
                                     void* out, int B, int H, int lora, int rope, int ps, int P,
                                     int N, int G, float scale, size_t smem, void* stream) {
  return launch<__nv_bfloat16>(q_lat, q_rope, ckv, krope, pages, pos, out, B, H, lora, rope, ps,
                               P, N, G, scale, smem, stream);
}
