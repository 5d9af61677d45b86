// The DMR/TMR epilogue kernels for Hopper (sm_90a): integer streaming
// passes over u32 word streams (a state tree as
// repro_torch/kernels/ops.py::flatten_to_u32 lays it out).
//
// Replaces four Pallas TPU kernels, all of which share one piece of
// fingerprint math (repro/kernels/state_hash.py::block_fingerprint):
//   K1 dmr_compare  repro/kernels/fused_step.py:69-98   mismatching-word
//                   count of two replica streams + both fingerprints;
//   K2 tmr_step     repro/kernels/fused_step.py:122-154 bitwise 2-of-3
//                   vote + per-replica mismatch counts + the voted
//                   stream's fingerprint;
//   K3 state_hash   repro/kernels/state_hash.py:76-96   fingerprint of
//                   one stream;
//   K4 tmr_vote     repro/kernels/tmr_vote.py:33-67     vote + counts.
//
// The fingerprint of a stream v[0..n) (all arithmetic mod 2^32), with
// w_i = i * MIX + PHI over the GLOBAL word index i:
//   h1 = sum v_i * w_i            h2 = sum (v_i ^ w_i) * MIX
//   h3 = xor v_i ^ (w_i * PHI)    h4 = sum (v_i + w_i) ^ (v_i >> 7)
// fp_add below is its single definition on the card; K1, K2 and K3 all
// call it.
//
// What bounds them: bytes.  Per word K1 reads 8 B, K2 moves 24 B (3
// reads, and the voted word written to 3 replicas), K4 16 B (3 reads, 1
// write), K3 reads 4 B.  Their integer work is 11-28
// operations a word (K4 11, K3 14, K2 25, K1 28), which on this card
// (132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 T ops/s against 3.35 TB/s)
// puts K1 and K2 near the bytes line and K3/K4 below it.
//
// Design (simple and right first).  The TPU kernels walk a sequential
// grid of 64 Ki-word blocks and emit per-block partials that the wrapper
// combines.  Here a grid-stride loop reads every stream coalesced, 16
// bytes a thread (uint4, streaming loads: nothing is read twice); each
// thread keeps its sums, its xor and its counts in registers; a warp
// reduction (__shfl_xor_sync) and a block reduction follow; and one
// atomicAdd / atomicXor per output word and block lands the result in an
// output the launch zeroed.  Addition mod 2^32 and xor are commutative
// and associative, so every result is BITWISE the same for any launch
// shape, any split of the stream into launches and any order of the
// atomics: no run-to-run variation.  Streams whose pointers are not
// 16-byte aligned, and the last n % 4 words, take a scalar loop with the
// same arithmetic.
//
// The stream is given as segments: runs of words at a global index, each
// read from its own pointer per replica, or read as zeros (the stream's
// padding).  K3 and K4 take a flat stream, one segment.  K1 and K2 take a
// replicated state tree as one segment per leaf, read where the replicas
// lie (a u32 view of each word-aligned leaf), so they need no packed copy
// of the state; K2 writes the voted words of a segment to up to three
// outputs, the re-replicated leaves.  Up to kMaxSegs segments travel in
// one launch's parameters; more take more launches into the same output.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhi = 0x9E3779B9u;
constexpr uint32_t kMix = 2654435761u;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads per SM

enum Mode { kHash = 0, kVote = 1, kDmr = 2, kTmr = 3 };

// Inputs read, output words, and where the fingerprints sit in the output.
template <int M> struct Spec;
template <> struct Spec<kHash> {  // out: h[4]
  static constexpr int kIn = 1, kOut = 4;
  static constexpr bool kVoted = false;
};
template <> struct Spec<kVote> {  // out: counts[3]
  static constexpr int kIn = 3, kOut = 3;
  static constexpr bool kVoted = true;
};
template <> struct Spec<kDmr> {  // out: diff, h_a[4], h_b[4]
  static constexpr int kIn = 2, kOut = 9;
  static constexpr bool kVoted = false;
};
template <> struct Spec<kTmr> {  // out: counts[3], h_voted[4]
  static constexpr int kIn = 3, kOut = 7;
  static constexpr bool kVoted = true;
};

// Output words that fold by xor (each fingerprint's h3); the rest add.
template <int M>
__device__ __forceinline__ constexpr bool is_xor(int k) {
  return (M == kHash && k == 2) || (M == kDmr && (k == 3 || k == 7)) || (M == kTmr && k == 5);
}

// The fingerprint accumulators of word v at global index i, into h[0..4).
__device__ __forceinline__ void fp_add(uint32_t* h, uint32_t v, uint32_t i) {
  const uint32_t w = i * kMix + kPhi;
  h[0] += v * w;
  h[1] += (v ^ w) * kMix;
  h[2] ^= v ^ (w * kPhi);
  h[3] += (v + w) ^ (v >> 7);
}

// One word of every input stream at global index i; returns the voted word
// (modes that vote) and updates the accumulators.
template <int M>
__device__ __forceinline__ uint32_t word(uint32_t* acc, uint32_t x, uint32_t y, uint32_t z,
                                         uint32_t i) {
  if constexpr (M == kHash) {
    fp_add(acc, x, i);
    return 0;
  } else if constexpr (M == kDmr) {
    acc[0] += x != y;
    fp_add(acc + 1, x, i);
    fp_add(acc + 5, y, i);
    return 0;
  } else {
    const uint32_t v = (x & y) | (x & z) | (y & z);
    acc[0] += x != v;
    acc[1] += y != v;
    acc[2] += z != v;
    if constexpr (M == kTmr) fp_add(acc + 3, v, i);
    return v;
  }
}

__device__ __forceinline__ uint4 load4(const uint32_t* p, size_t q) {
  return __ldcs(reinterpret_cast<const uint4*>(p) + q);
}

// A run of n words at global index off: word k of replica r at in[r][k]
// (in[0] null: every word is 0), the voted word k to out[r][k] for each
// non-null out[r].  The layout of the C interface's segment array.
struct Seg {
  const uint32_t* in[3];
  uint32_t* out[3];
  unsigned long long n;
  unsigned long long off;
};
constexpr int kMaxSegs = 16;
struct Segs {
  Seg s[kMaxSegs];
  int count;
};

template <int M>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(const __grid_constant__ Segs segs, uint32_t* __restrict__ out) {
  using S = Spec<M>;
  uint32_t acc[S::kOut];
#pragma unroll
  for (int k = 0; k < S::kOut; ++k) acc[k] = 0;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);

  for (int k = 0; k < segs.count; ++k) {
    const Seg& g = segs.s[k];
    const uint32_t* a = g.in[0];
    const uint32_t* b = S::kIn >= 2 ? g.in[1] : nullptr;
    const uint32_t* c = S::kIn >= 3 ? g.in[2] : nullptr;
    const bool zeros = a == nullptr;
    uintptr_t ptrs = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c;
    if (S::kVoted) ptrs |= (uintptr_t)g.out[0] | (uintptr_t)g.out[1] | (uintptr_t)g.out[2];
    const size_t n = g.n, n_vec = ptrs % 16 == 0 ? n / 4 : 0;
    const uint32_t i0 = (uint32_t)g.off;  // the global index, as a u32

    // words 4q .. 4q+3 of every stream, 16 bytes a thread and stream
    for (size_t q = tid; q < n_vec; q += stride) {
      const uint4 x = zeros ? zero4 : load4(a, q);
      const uint4 y = S::kIn >= 2 && !zeros ? load4(b, q) : zero4;
      const uint4 z = S::kIn >= 3 && !zeros ? load4(c, q) : zero4;
      const uint32_t i = i0 + (uint32_t)(4 * q);
      uint4 v;
      v.x = word<M>(acc, x.x, y.x, z.x, i);
      v.y = word<M>(acc, x.y, y.y, z.y, i + 1);
      v.z = word<M>(acc, x.z, y.z, z.z, i + 2);
      v.w = word<M>(acc, x.w, y.w, z.w, i + 3);
      if constexpr (S::kVoted) {
#pragma unroll
        for (int r = 0; r < 3; ++r)
          if (g.out[r]) __stcs(reinterpret_cast<uint4*>(g.out[r]) + q, v);
      }
    }
    // the words the vector loop left: the tail, or every word when unaligned
    for (size_t j = 4 * n_vec + tid; j < n; j += stride) {
      const uint32_t x = zeros ? 0u : a[j];
      const uint32_t y = S::kIn >= 2 && !zeros ? b[j] : 0u;
      const uint32_t z = S::kIn >= 3 && !zeros ? c[j] : 0u;
      const uint32_t v = word<M>(acc, x, y, z, i0 + (uint32_t)j);
      if constexpr (S::kVoted) {
#pragma unroll
        for (int r = 0; r < 3; ++r)
          if (g.out[r]) g.out[r][j] = v;
      }
    }
  }

  // warp, then block, then one atomic per output word and block
  __shared__ uint32_t red[S::kOut][kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < S::kOut; ++k) {
    uint32_t x = acc[k];
    for (int o = 16; o > 0; o >>= 1) {
      const uint32_t t = __shfl_xor_sync(0xffffffffu, x, o);
      x = is_xor<M>(k) ? (x ^ t) : (x + t);
    }
    if (lane == 0) red[k][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < S::kOut; ++k) {
      uint32_t x = lane < kThreads / 32 ? red[k][lane] : 0u;
      for (int o = 16; o > 0; o >>= 1) {
        const uint32_t t = __shfl_xor_sync(0xffffffffu, x, o);
        x = is_xor<M>(k) ? (x ^ t) : (x + t);
      }
      if (lane == 0) {
        if (is_xor<M>(k)) {
          atomicXor(out + k, x);
        } else {
          atomicAdd(out + k, x);
        }
      }
    }
  }
}

// Zero `out`, then launch over `count` segments, kMaxSegs a launch, all
// accumulating into it.
template <int M>
int launch(const Seg* segs, int count, void* out, void* stream) {
  if (count < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(uint32_t) * Spec<M>::kOut, st);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  for (int first = 0; first < count; first += kMaxSegs) {
    Segs batch;
    batch.count = count - first < kMaxSegs ? count - first : kMaxSegs;
    unsigned long long work = 0;  // the longest segment's words, then its 16-byte quads
    for (int k = 0; k < batch.count; ++k) {
      batch.s[k] = segs[first + k];
      work = work > batch.s[k].n ? work : batch.s[k].n;
    }
    work = (work + 3) / 4;
    unsigned long long blocks = (work + kThreads - 1) / kThreads;
    const unsigned long long cap = (unsigned long long)sms * kBlocksPerSm;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    epilogue_kernel<M><<<(unsigned)blocks, kThreads, 0, st>>>(batch, static_cast<uint32_t*>(out));
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

// One segment: a flat stream of n words from global index 0 (K3, K4).
template <int M>
int launch_flat(const void* a, const void* b, const void* c, void* voted, long long n, void* out,
                void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  using S = Spec<M>;
  Seg g = {{static_cast<const uint32_t*>(a), S::kIn >= 2 ? static_cast<const uint32_t*>(b) : nullptr,
            S::kIn >= 3 ? static_cast<const uint32_t*>(c) : nullptr},
           {S::kVoted ? static_cast<uint32_t*>(voted) : nullptr, nullptr, nullptr},
           (unsigned long long)n,
           0ull};
  return launch<M>(&g, 1, out, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every entry launches on
// `stream` and returns a cudaError_t; 0 = ok.  out: the kernel's output
// words, zeroed here before the sums land (K3 4, K4 3, K1 9, K2 7;
// layouts at Spec above).
//
// K3 / K4 over a flat stream: a, b, c device pointers to n u32 words each
// (b, c NULL for K3); voted: n words written by K4.
extern "C" int state_hash_u32(const void* a, const void* b, const void* c, void* voted,
                              long long n, void* out, void* stream) {
  return launch_flat<kHash>(a, b, c, voted, n, out, stream);
}

extern "C" int tmr_vote_u32(const void* a, const void* b, const void* c, void* voted,
                            long long n, void* out, void* stream) {
  return launch_flat<kVote>(a, b, c, voted, n, out, stream);
}

// K1 / K2 over a stream given as `count` segments (host array of Seg, the
// struct above: 3 input pointers, 3 output pointers, n, off; 64 bytes),
// which together cover the word indices [0, total) once each.
extern "C" int dmr_compare_segs(const void* segs, int count, void* out, void* stream) {
  return launch<kDmr>(static_cast<const Seg*>(segs), count, out, stream);
}

extern "C" int tmr_step_segs(const void* segs, int count, void* out, void* stream) {
  return launch<kTmr>(static_cast<const Seg*>(segs), count, out, stream);
}
