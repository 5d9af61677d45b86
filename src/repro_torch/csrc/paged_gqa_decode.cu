// Paged single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode.py:50-152
// (paged_gqa_attention / _gqa_kernel, pallas_call at :144).  Same
// function: for each slot b and query head, attend over the slot's K/V
// pages through its page-table row (-1 = unmapped, read as zero lanes and
// masked; a row past the pool's end reads the pool's last row), masking
// lanes past pos[b]; scores in f32 as (q * scale) . k; softmax over all
// P * ps lanes with masked lanes at -1e30; P.V in f32; cast to the input
// type.
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
//   * grid (slot, kv head, split): a split takes a contiguous run of the
//     slot's pages, and the wrapper picks the number of splits so the grid
//     has at least two blocks an SM (8 splits of 4 pages, 512 blocks, at
//     the serving shape).  A split with no valid lane writes an empty partial and
//     exits;
//   * the G <= 8 query heads of the group stay in registers; a K or V row
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
// The scores never live in shared memory, so max_len is not bounded by
// it; Dk must be a multiple of 8 and at most 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // lanes a row group has in flight
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

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

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

// Partials of split s for query head row bh = b * Hq + head: acc at
// part[(bh * nsplit + s) * Dk ...], then m and l of all B * Hq * nsplit.
struct Partials {
  float* acc;
  float* m;
  float* l;
  __device__ Partials(float* part, int BH, int nsplit, int Dk)
      : acc(part), m(part + (size_t)BH * nsplit * Dk), l(m + (size_t)BH * nsplit) {}
};

// kG: the group bound (G <= kG query heads per kv head).
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
    split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                 const T* __restrict__ v_pool, const int* __restrict__ pages,
                 const int* __restrict__ pos, float* __restrict__ part,
                 int Hq, int Hkv, int Dk, int ps, int P, int N, int nsplit, float scale_log2,
                 int tpr) {
  extern __shared__ float smem[];  // warp partials: m, l (kWarps * G each), acc; then page rows
  const int G = Hq / Hkv;
  float* wm = smem;
  float* wl = wm + kWarps * G;
  float* wacc = wl + kWarps * G;  // kWarps * G * Dk
  int* rows = reinterpret_cast<int*>(wacc + kWarps * G * Dk);

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pps = (P + nsplit - 1) / nsplit;  // pages per split
  const int pg0 = split * pps, pg1 = min(P, pg0 + pps);
  const int qpos = pos[b];

  // One pass over the slot's page row: does the slot have any valid lane
  // (a mapped page starting at or before pos)?  If not, every split takes
  // the uniform mean.  And this split's rows, clamped to the pool.
  int has_valid = 0;
  for (int i = tid; i < P; i += kThreads) {
    const int row = pages[(size_t)b * P + i];
    has_valid |= row >= 0 && i * ps <= qpos;
    if (i >= pg0 && i < pg1) rows[i - pg0] = min(row, N - 1);
  }

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
    if (g < G && active) {
      Row8<T> r;
      r.load(q + ((size_t)b * Hq + h * G + g) * Dk + sub * 8);
      r.get(x);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) qv[g][e] = x[e] * scale_log2;
  }
  const bool uniform = !__syncthreads_or(has_valid);  // and rows[] is written
  const int L0 = pg0 * ps;
  const int L1 = uniform ? pg1 * ps : min(pg1 * ps, qpos + 1);  // lanes [L0, L1) of the split
  const int BH = gridDim.x * Hq;
  const Partials pt(part, BH, nsplit, Dk);
  if (L1 <= L0) {  // no valid lane in this split: an empty partial
    for (int g = tid; g < G; g += kThreads) {
      const size_t i = ((size_t)b * Hq + h * G + g) * nsplit + split;
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
  for (int tw = L0 + warp * rpw; tw < L1; tw += ngroups * kUnroll) {
    Row8<T> kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = tw + lane / tpr + u * ngroups;
      const int row = t < L1 ? rows[t / ps - pg0] : -1;
      ok[u] = t < L1 && (uniform || row >= 0);
      kr[u].zero();
      vr[u].zero();
      if (row >= 0 && active) {
        const size_t off = (((size_t)row * Hkv + h) * ps + t % ps) * Dk + sub * 8;
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
    if (g < G && lane < tpr) {
      if (lane == 0) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
      if (active)
#pragma unroll
        for (int e = 0; e < 8; ++e) wacc[(warp * G + g) * Dk + sub * 8 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * Dk; i += kThreads) {
    const int g = i / Dk, d = i - g * Dk;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * G + g]);
    const float mu = M == -INFINITY ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm[w * G + g] - mu);  // 0 for a warp that saw nothing
      L += wl[w * G + g] * f;
      A += f == 0.f ? 0.f : wacc[(w * G + g) * Dk + d] * f;
    }
    const size_t j = ((size_t)b * Hq + h * G + g) * nsplit + split;
    pt.acc[j * Dk + d] = A;
    if (d == 0) {
      pt.m[j] = M;
      pt.l[j] = L;
    }
  }
}

// One block per (slot, query head): merge the splits' partials (a split
// with l = 0 saw no lane and is skipped).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    merge_kernel(const float* __restrict__ part, T* __restrict__ out, int BH, int Dk,
                 int nsplit) {
  const int bh = blockIdx.x;
  const Partials pt(const_cast<float*>(part), BH, nsplit, Dk);
  const float* m = pt.m + (size_t)bh * nsplit;
  const float* l = pt.l + (size_t)bh * nsplit;
  float M = -INFINITY;
  for (int s = 0; s < nsplit; ++s)
    if (l[s] > 0.f) M = fmaxf(M, m[s]);
  for (int d = threadIdx.x; d < Dk; d += blockDim.x) {
    float L = 0.f, A = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      if (!(l[s] > 0.f)) continue;
      const float f = exp2f(m[s] - M);
      L += l[s] * f;
      A += pt.acc[((size_t)bh * nsplit + s) * Dk + d] * f;
    }
    store_out(out + (size_t)bh * Dk + d, L > 0.f ? A / L : 0.f);
  }
}

template <typename T, int kG>
int launch_split(const T* q, const T* k_pool, const T* v_pool, const int* pages, const int* pos,
                 float* part, int B, int Hq, int Hkv, int Dk, int ps, int P, int N, int nsplit,
                 float scale_log2, int tpr, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int pps = (P + nsplit - 1) / nsplit;
  const size_t smem =
      sizeof(float) * (2 * kWarps * G + (size_t)kWarps * G * Dk) + sizeof(int) * pps;
  split_kernel<T, kG><<<dim3(B, Hkv, nsplit), kThreads, smem, stream>>>(
      q, k_pool, v_pool, pages, pos, part, Hq, Hkv, Dk, ps, P, N, nsplit, scale_log2, tpr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* pages,
           const void* pos, void* out, void* part, int B, int Hq, int Hkv, int Dk, int ps, int P,
           int N, int nsplit, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  int tpr = 1;
  while (tpr * 8 < Dk) tpr <<= 1;  // threads a row: ceil(Dk / 8), a power of two <= 32
  if (Dk % 8 || tpr > 32 || G < 1 || G > 8 || nsplit < 1 || !part)
    return (int)cudaErrorInvalidValue;
  const T* qq = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  const int* pg = static_cast<const int*>(pages);
  const int* pp = static_cast<const int*>(pos);
  T* o = static_cast<T*>(out);
  float* pt = static_cast<float*>(part);
  const float sl = scale * kLog2e;
#define GQA_SPLIT(KG) \
  launch_split<T, KG>(qq, kp, vp, pg, pp, pt, B, Hq, Hkv, Dk, ps, P, N, nsplit, sl, tpr, s)
  const int e =
      G == 1 ? GQA_SPLIT(1) : G == 2 ? GQA_SPLIT(2) : G <= 4 ? GQA_SPLIT(4) : GQA_SPLIT(8);
#undef GQA_SPLIT
  if (e) return e;
  merge_kernel<T><<<B * Hq, kThreads, 0, s>>>(pt, o, B * Hq, Dk, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Pointers are device pointers of contiguous, 16-byte aligned tensors: q
// (B,Hq,Dk), pools (N,Hkv,ps,Dk), pages (B,P) int32 (-1 = unmapped), pos
// (B,) int32, out (B,Hq,Dk); `part` is f32 scratch of B*Hq*nsplit*(Dk + 2)
// floats.  `nsplit` splits of ceil(P / nsplit) pages each (at most 1024),
// chosen by the wrapper.  One call launches the split kernel and the merge
// kernel: the wrapper counts it as one launch.
extern "C" int paged_gqa_decode_f32(const void* q, const void* k_pool, const void* v_pool,
                                    const void* pages, const void* pos, void* out, void* part,
                                    int B, int Hq, int Hkv, int Dk, int ps, int P, int N,
                                    int nsplit, float scale, void* stream) {
  return launch<float>(q, k_pool, v_pool, pages, pos, out, part, B, Hq, Hkv, Dk, ps, P, N,
                       nsplit, scale, stream);
}

extern "C" int paged_gqa_decode_bf16(const void* q, const void* k_pool, const void* v_pool,
                                     const void* pages, const void* pos, void* out, void* part,
                                     int B, int Hq, int Hkv, int Dk, int ps, int P, int N,
                                     int nsplit, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, pages, pos, out, part, B, Hq, Hkv, Dk, ps, P,
                               N, nsplit, scale, stream);
}
