// The split-lane decode kernels' second pass (paged_gqa_decode.cu,
// paged_mla_decode.cu): each block of the first pass leaves, per query
// head and split, an unnormalised f32 context and its online-softmax
// (m, l) in log2 units; merge_kernel combines the splits in order and
// normalises.  Header-only, in an anonymous namespace of the including
// source.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMergeThreads = 128;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
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

// One block per (slot, query head) row bh: merge the splits' partials in
// split order (a split with l = 0 saw no lane and is skipped) and write
// acc / l, 0 where no split saw a lane.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
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

// The same merge without the division: one block per row bh writes the
// merged unnormalised context acc[bh * Dk ...], its softmax max m[bh] in
// natural units (the split kernel keeps log2 units) and its sum l[bh]:
// the row's partial, for a caller that combines it with partials of other
// lanes (flash-decoding across the members of a mesh).  A row no split
// saw writes acc 0, m -inf, l 0.
__global__ void __launch_bounds__(kMergeThreads)
    merge_partials_kernel(const float* __restrict__ part, float* __restrict__ acc,
                          float* __restrict__ m_out, float* __restrict__ l_out, int BH, int Dk,
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
    acc[(size_t)bh * Dk + d] = A;
    if (d == 0) {
      m_out[bh] = M == -INFINITY ? -INFINITY : M * 0.69314718055994531f;  // log2 -> natural
      l_out[bh] = L;
    }
  }
}

}  // namespace
