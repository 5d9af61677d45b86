// Blocked (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:30-149
// (flash_attention / _attn_kernel).  Same function: for batch row b and
// query head h (kv head h / (Hq / Hkv)), online-softmax attention over K
// tiles with f32 scores (q * scale) . k, causal and sliding-window masks
// on absolute positions (query row i sits at i + q_offset), masked scores
// at NEG_INF = -1e30, p = 0 where masked, f32 accumulators, and rows with
// no visible key written as 0; output in q's type.  Ragged Sq / Sk are
// masked here instead of asserted (the Pallas wrapper asserts
// divisibility by its blocks).
//
// What bounds it: at internlm2's head layout (Hq = 16, Hkv = 8, D = 128,
// bf16) and Sq = Sk = 512, causal, the bytes (q, k, v, out: 6.3 MB) take
// 1.9 us at 3.35 TB/s and the 4 * D * (visible pairs) = 1.1 GFLOP take
// 1.1 us on the bf16 tensor cores; at 4096 the FLOPs rule (70 us).  This
// simple version computes on the f32 CUDA cores out of shared memory
// (about two shared loads per FMA), so it is bound by that arithmetic,
// well above either bound.
//
// Design (right and simple first): one block per (q tile of BQ rows, q
// head, batch row); the sequential K axis of the Pallas grid is a loop in
// the block.  The scaled Q tile, the K and V tiles, the BQ x BK scores and
// the BQ x D accumulator live in shared memory as f32 (107 KB at D = 128,
// two blocks per SM); one warp per row does the online max / exp / sum.
// K tiles wholly past the causal edge end the loop, and tiles wholly
// outside the window are skipped, as the Pallas kernel's pl.when does.  K
// rows are stored with a stride of D + 1 so the lanes of a warp, which
// walk keys, hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 64;

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

// Is key position kp visible from query position qp?  window <= 0: none.
__device__ __forceinline__ bool visible(int qp, int kp, int Sk, int causal, int window) {
  return kp < Sk && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int Hq, int Hkv,
                           int Sq, int Sk, int D, float scale, int causal, int window,
                           int q_offset) {
  extern __shared__ float smem[];
  const int DS = D + 1;  // padded row stride of K
  float* qs = smem;                   // BQ * D, scaled
  float* ks = qs + kBlockQ * D;       // BK * (D + 1)
  float* vs = ks + kBlockK * DS;      // BK * D
  float* sc = vs + kBlockK * D;       // BQ * BK scores, then p
  float* acc = sc + kBlockQ * kBlockK;  // BQ * D
  float* m = acc + kBlockQ * D;       // BQ running max
  float* l = m + kBlockQ;             // BQ running sum
  float* alpha = l + kBlockQ;         // BQ rescale of this tile

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const T* qb = q + ((size_t)b * Hq + h) * Sq * D;
  const T* kb = k + ((size_t)b * Hkv + kvh) * Sk * D;
  const T* vb = v + ((size_t)b * Hkv + kvh) * Sk * D;

  for (int i = tid; i < kBlockQ * D; i += nt) {
    const int r = i / D;
    qs[i] = q0 + r < Sq ? load_f32(qb + (size_t)q0 * D + i) * scale : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < kBlockQ; r += nt) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  const int qpos_lo = q0 + q_offset;
  const int qpos_hi = min(q0 + kBlockQ, Sq) - 1 + q_offset;
  const int n_k = (Sk + kBlockK - 1) / kBlockK;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBlockK;
    if (causal && k0 > qpos_hi) break;  // every later tile is masked too
    if (window > 0 && k0 + kBlockK - 1 <= qpos_lo - window) continue;
    __syncthreads();  // the previous tile is done with ks / vs / sc
    for (int i = tid; i < kBlockK * D; i += nt) {
      const int r = i / D, d = i - r * D;
      const bool in = k0 + r < Sk;
      ks[r * DS + d] = in ? load_f32(kb + (size_t)k0 * D + i) : 0.f;
      vs[i] = in ? load_f32(vb + (size_t)k0 * D + i) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kBlockQ * kBlockK; i += nt) {
      const int r = i / kBlockK, j = i - r * kBlockK;
      const float* qr = qs + r * D;
      const float* kr = ks + j * DS;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      sc[i] = visible(q0 + r + q_offset, k0 + j, Sk, causal, window) ? s : kNegInf;
    }
    __syncthreads();
    for (int r = warp; r < kBlockQ; r += nwarps) {
      float* sr = sc + r * kBlockK;
      const int qp = q0 + r + q_offset;
      float mx = kNegInf;
      for (int j = lane; j < kBlockK; j += 32) mx = fmaxf(mx, sr[j]);
      const float m_new = fmaxf(m[r], warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < kBlockK; j += 32) {
        const float p = visible(qp, k0 + j, Sk, causal, window) ? expf(sr[j] - m_new) : 0.f;
        sr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m[r] - m_new);
        alpha[r] = al;
        l[r] = l[r] * al + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < kBlockQ * D; i += nt) {
      const int r = i / D, d = i - r * D;
      const float* pr = sc + r * kBlockK;
      float a = acc[i] * alpha[r];
      for (int j = 0; j < kBlockK; ++j) a = fmaf(pr[j], vs[j * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * Hq + h) * Sq * D;
  for (int i = tid; i < kBlockQ * D; i += nt) {
    const int r = i / D;
    if (q0 + r >= Sq) continue;
    const float lr = l[r];
    store_from_f32(ob + (size_t)q0 * D + i, lr > 0.f ? acc[i] / lr : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
           int Sq, int Sk, int D, float scale, int causal, int window, int q_offset,
           size_t smem, void* stream) {
  // Raise the block's dynamic shared memory limit once per size, on the
  // first (eager) launch: not again inside a CUDA-graph capture.
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Hq, Hkv, Sq, Sk, D, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Device pointers of contiguous tensors: q / out (B,Hq,Sq,D), k / v
// (B,Hkv,Sk,D), all of the entry point's type.  window <= 0 means no
// window.  `smem` is the block's dynamic shared memory in bytes, computed
// by the wrapper: 4 * (BQ*D + BK*(D+1) + BK*D + BQ*BK + BQ*D + 3*BQ) with
// BQ = 32, BK = 64.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int Sq, int Sk, int D, float scale,
                                   int causal, int window, int q_offset, size_t smem,
                                   void* stream) {
  return launch<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale, causal, window, q_offset,
                       smem, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                    float scale, int causal, int window, int q_offset,
                                    size_t smem, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale, causal, window,
                               q_offset, smem, stream);
}
