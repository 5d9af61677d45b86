// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:25-132
// (ssd_scan / _ssd_kernel).  Same function, in f32 throughout: for each
// batch row b and head h (reading B/C group g = h / (H / G)), in chunks of
// Q steps,
//   cum_i  = sum_{k <= i} dt_k a                      (within the chunk)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) C_i . S                        (S: carried state)
//   S     <- exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
// with S = h0 (or 0) before the first chunk; y is written in x's type and
// the final S (N x P, f32) once at the end.
//
// What bounds it: at the serving shapes (H = 80 heads of P = 64, N = 128,
// one group, bf16 x/B/C) the bytes are x, y and the f32 state, about 8 MB
// for L = 256, 2.4 us at 3.35 TB/s; the products are about 1.2 GFLOP
// (the causal half of C.B^T, W.X, C.S and the state update), 1.2 us on the
// bf16 tensor cores but 18 us on the f32 CUDA cores this kernel uses.  So
// this simple version is bound by its f32 arithmetic out of shared memory
// (about two shared loads per FMA), and with B = 1 its 80 blocks fill 80
// of the 132 SMs.
//
// Design (right and simple first): the Pallas grid's sequential chunk axis
// becomes a loop inside one block per (h, b); the carried state lives in
// shared memory (N x P f32 = 32 KB at the serving shapes) instead of VMEM
// scratch.  Each chunk's x, B, C (as f32), dt, cum and the two decay
// vectors are staged in shared memory; the intra-chunk weight matrix
// W = (C B^T) o decay o dt is built one tile of TI rows at a time (the
// whole Q x Q would not fit beside the rest).  The exponential is taken
// only where j <= i: the Pallas kernel evaluates exp(cum - cum^T)
// everywhere and masks afterwards, which on the card could give inf * 0.
// Any L: rows past L load x = B = C = 0 and dt = 0, so their cum stays
// flat, their weight is 0 and the state and the real rows are exact;
// their y is not stored.  B is stored with a row stride of N + 1 so that
// the lanes of a warp, which walk j, hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowTile = 32;  // TI: rows of W built at a time

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ h0,
                    T* __restrict__ y, float* __restrict__ ht, int L, int H, int P,
                    int G, int N, int Q) {
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
      xs[i] = t < L ? load_f32(x + (((size_t)b * L + t) * H + h) * P + p) : 0.f;
    }
    for (int i = tid; i < Q * N; i += nt) {
      const int r = i / N, n = i - r * N, t = t0 + r;
      const size_t off = (((size_t)b * L + t) * G + g) * N + n;
      bs[r * NB + n] = t < L ? load_f32(bm + off) : 0.f;
      cs[i] = t < L ? load_f32(cm + off) : 0.f;
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
        if (t < L)
          store_from_f32(y + (((size_t)b * L + t) * H + h) * P + p, intra + ecum[i] * inter);
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

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
           const void* h0, void* y, void* ht, int B, int L, int H, int P, int G, int N,
           int Q, size_t smem, void* stream) {
  // Raise the block's dynamic shared memory limit once per size, on the
  // first (eager) launch: not again inside a CUDA-graph capture.
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid(H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(ht), L, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Device pointers of contiguous tensors: x (B,L,H,P), dt (B,L,H) f32,
// a (H,) f32, bm/cm (B,L,G,N), h0 (B,H,N,P) f32 or null, y (B,L,H,P),
// ht (B,H,N,P) f32.  x, bm, cm and y share the type of the entry point.
// `smem` is the block's dynamic shared memory in bytes, computed by the
// wrapper: 4 * (Q*P + Q*(N+1) + Q*N + N*P + min(32,Q)*Q + 4*Q).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a, const void* bm,
                            const void* cm, const void* h0, void* y, void* ht, int B, int L,
                            int H, int P, int G, int N, int Q, size_t smem, void* stream) {
  return launch<float>(x, dt, a, bm, cm, h0, y, ht, B, L, H, P, G, N, Q, smem, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a, const void* bm,
                             const void* cm, const void* h0, void* y, void* ht, int B, int L,
                             int H, int P, int G, int N, int Q, size_t smem, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, h0, y, ht, B, L, H, P, G, N, Q, smem,
                               stream);
}
