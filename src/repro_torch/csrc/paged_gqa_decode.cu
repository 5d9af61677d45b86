// Paged single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode.py:97-152
// (paged_gqa_attention / _gqa_kernel).  Same function: for each slot b
// and query head, attend over the slot's K/V pages through its page-table
// row (-1 = unmapped, read as zero lanes and masked), masking lanes past
// pos[b]; scores in f32 as (q * scale) . k; a full f32 softmax over all
// P * ps lanes with masked lanes at -1e30 (finite: a row with no valid
// lane averages its gathered V lanes); P.V in f32; cast to the input type.
//
// What bounds it: the bytes of the valid K/V lanes, read once.  At the
// serving shapes (B = 8 slots, Hkv = 8, Dk = 128, bf16) with all 512 lanes
// valid that is 8*8*512*128*2*2 B = 16.8 MB, about 5.0 us at 3.35 TB/s;
// with the 40-100 valid lanes of a short serving run it is under 1 us, so
// launch overhead dominates there.  The arithmetic (4 flop per lane per
// head dimension per query head) is far below the card's f32 rate.
//
// Design (simple and right first): one block per (slot, kv head), so the
// G = Hq / Hkv query heads of a group share every K/V byte they read.
// The block loads its page row itself (no scalar prefetch); a row past
// the pool's end is clamped to its last row, as the plain version's
// gather does, so a corrupted page table never reads out of bounds.
// Pass 1: one warp per lane computes the G scores of that lane into
// shared memory;
// masked lanes never touch K.  Pass 2: max / exp / sum / normalise per
// query head with block reductions (the same full softmax as the Pallas
// kernel; no online rescaling, no split over pages).  Pass 3: one thread
// per (query head, dimension) sums p * V over the mapped lanes with p != 0.
// The G x S f32 scores live in shared memory, which bounds max_len; the
// wrapper refuses inputs whose block would exceed Hopper's 227 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kMaxGroup = 8;  // largest Hq / Hkv; the wrapper checks it

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Reduction over the whole block; every thread gets the result.
// `red` is 32 floats of shared scratch.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // the previous reduction may still be reading red
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float y = lane < nwarps ? red[lane] : (kMax ? -INFINITY : 0.f);
  return kMax ? warp_max(y) : warp_sum(y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                            const T* __restrict__ v_pool, const int* __restrict__ pages,
                            const int* __restrict__ pos, T* __restrict__ out, int Hq,
                            int Hkv, int Dk, int ps, int P, int N, float scale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int S = P * ps;
  float* red = smem;                                 // 32
  float* qs = red + 32;                              // G * Dk, scaled query group
  float* sc = qs + G * Dk;                           // G * S scores, then p
  int* rows = reinterpret_cast<int*>(sc + G * S);    // P page rows of slot b

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int qpos = pos[b];

  for (int i = tid; i < P; i += blockDim.x) rows[i] = min(pages[(size_t)b * P + i], N - 1);
  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * Dk;
  for (int i = tid; i < G * Dk; i += blockDim.x) qs[i] = load_f32(qb + i) * scale;
  __syncthreads();

  // Pass 1: scores, one warp per lane.
  for (int t = warp; t < S; t += nwarps) {
    const int row = rows[t / ps];
    if (row < 0 || t > qpos) {
      for (int g = lane; g < G; g += 32) sc[g * S + t] = kNegInf;
      continue;
    }
    const T* kr = k_pool + (((size_t)row * Hkv + h) * ps + (t % ps)) * Dk;
    float acc[kMaxGroup];
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
    for (int d = lane; d < Dk; d += 32) {
      const float kv = load_f32(kr + d);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) acc[g] = fmaf(qs[g * Dk + d], kv, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float s = warp_sum(acc[g]);
        if (lane == 0) sc[g * S + t] = s;
      }
    }
  }
  __syncthreads();

  // Pass 2: full softmax per query head of the group.
  for (int g = 0; g < G; ++g) {
    float* sg = sc + (size_t)g * S;
    float m = -INFINITY;
    for (int t = tid; t < S; t += blockDim.x) m = fmaxf(m, sg[t]);
    m = block_reduce<true>(m, red);
    float sum = 0.f;
    for (int t = tid; t < S; t += blockDim.x) {
      const float e = expf(sg[t] - m);
      sg[t] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red);
    for (int t = tid; t < S; t += blockDim.x) sg[t] = sg[t] / sum;
  }
  __syncthreads();

  // Pass 3: P.V over the mapped lanes that carry weight.
  T* ob = out + ((size_t)b * Hq + (size_t)h * G) * Dk;
  for (int i = tid; i < G * Dk; i += blockDim.x) {
    const int g = i / Dk;
    const int d = i - g * Dk;
    const float* sg = sc + (size_t)g * S;
    float acc = 0.f;
    for (int pg = 0; pg < P; ++pg) {
      const int row = rows[pg];
      if (row < 0) continue;  // unmapped page: zero lanes
      const T* vr = v_pool + (((size_t)row * Hkv + h) * ps) * Dk + d;
      for (int j = 0; j < ps; ++j) {
        const float p = sg[pg * ps + j];
        if (p != 0.f) acc = fmaf(p, load_f32(vr + (size_t)j * Dk), acc);
      }
    }
    store_from_f32(ob + i, acc);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* pages,
           const void* pos, void* out, int B, int Hq, int Hkv, int Dk, int ps, int P,
           int N, float scale, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_gqa_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B, Hkv);
  paged_gqa_decode_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(pages), static_cast<const int*>(pos), static_cast<T*>(out), Hq,
      Hkv, Dk, ps, P, N, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Pointers are device pointers of contiguous tensors: q (B,Hq,Dk), pools
// (N,Hkv,ps,Dk), pages (B,P) int32 (-1 = unmapped), pos (B,) int32,
// out (B,Hq,Dk).
// `smem` is the block's dynamic shared memory in bytes, computed by the
// wrapper: 4 * (32 + G*Dk + G*P*ps + P).
extern "C" int paged_gqa_decode_f32(const void* q, const void* k_pool, const void* v_pool,
                                    const void* pages, const void* pos, void* out, int B,
                                    int Hq, int Hkv, int Dk, int ps, int P, int N,
                                    float scale, size_t smem, void* stream) {
  return launch<float>(q, k_pool, v_pool, pages, pos, out, B, Hq, Hkv, Dk, ps, P, N, scale,
                       smem, stream);
}

extern "C" int paged_gqa_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                     const void* pages, const void* pos, void* out, int B,
                                     int Hq, int Hkv, int Dk, int ps, int P, int N,
                                     float scale, size_t smem, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, pages, pos, out, B, Hq, Hkv, Dk, ps, P, N,
                               scale, smem, stream);
}
