// Blocked (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:30-149
// (flash_attention / _attn_kernel, pallas_call at :123).  Same function:
// for batch row b and query head h (kv head h / (Hq / Hkv)), online-softmax
// attention over K tiles with f32 scores (q . k) * scale, causal and
// sliding-window masks on absolute positions (query row i sits at i +
// q_offset), p = 0 where masked, f32 accumulators, and rows with no
// visible key written as 0; output in q's type.  Ragged Sq / Sk are masked
// here instead of asserted (the Pallas wrapper asserts divisibility by its
// blocks).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): at
// internlm2's head layout (Hq = 16, Hkv = 8, D = 128, bf16), causal,
// Sq = Sk = 4096 needs 4 * D * (visible pairs) * Hq = 68.7 GFLOP, 70 us on
// the bf16 tensor cores (989 TFLOP/s) and 1.03 ms on the f32 CUDA cores
// (67 TFLOP/s): only the tensor cores can come near it.  At 512 the bytes
// (q, k, v, out: 6.3 MB, 1.9 us) and the launch bound it.
//
// bf16 design (FA3's structure):
//   * one block per (query head, tile of 64 * W query rows, batch row):
//     W = 1 or 2 consumer warpgroups of 64 rows, plus a producer; the
//     wrapper takes W = 1 when W = 2 would leave SMs idle.  Heads vary
//     fastest and tiles run last-first, so the longest causal tiles start
//     first;
//   * warp specialisation: one producer thread copies the Q tile once and
//     the K and V tiles of every key tile with TMA (3-d tensor maps, 64-
//     column boxes, 128-byte swizzle; rows past Sq / Sk and columns past
//     D read as zeros, so any D <= 256 is zero-padded up to the instance,
//     64, 128 or 256) into two stages each, signalling "full" mbarriers;
//     consumers release a stage through "empty" mbarriers, and no block
//     barrier couples the warpgroups.  With W = 2 the producer is a whole
//     warpgroup that gives its registers to the consumers (setmaxnreg);
//   * S = Q K^T with wgmma.m64nBKk16 (A = the Q tile, B = the K tile, both
//     K-major in shared memory in the swizzle TMA wrote and the
//     descriptors declare), f32 accumulators in registers;
//   * the online softmax in registers: each row's max and sum over the 4
//     threads that hold it (quad shuffles); scores never touch shared
//     memory; masks, two integer compares a score, only on tiles that
//     cross the causal, window or Sk edge; exponentials are single
//     ex2.approx.ftz;
//   * O += P V with wgmma, A = P from registers (the f32 score fragment
//     rounded to bf16 pairs, FA3's register-A trick: the accumulator
//     layout of S is the A-fragment layout of P), B = the V tile, stored
//     keys x D with D contiguous, i.e. MN-major: the transpose-B
//     immediate; O in f32 registers;
//   * within a warpgroup, S of tile j and P V of tile j - 1 are issued
//     together, and the softmax of tile j runs while P V still occupies
//     the tensor cores (FA3's intra-warpgroup overlap); O is rescaled once
//     P V has landed.  The first tile is peeled off the loop, so the order
//     of the wgmma groups is fixed and ptxas keeps them asynchronous.
// P is rounded to bf16 before P V (relative error 2^-9 on weights that sum
// to 1), as SDPA does; the tolerance stays 2e-2.
//
// f32 inputs keep the simple CUDA-core kernel below (f32_kernel): one
// block per (32-row q tile, head, batch row), Q/K/V, scores and the
// accumulator in shared memory as f32, one warp per row for the softmax.
// TF32 tensor cores would break f32's 1e-4 tolerance, and no served config
// runs this kernel in f32.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"  // TMA, mbarrier and wgmma helpers

namespace {

// --------------------------------------------------------------------------
// f32: CUDA cores, out of shared memory
// --------------------------------------------------------------------------
constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBlockQ = 32;
constexpr int kBlockK = 64;

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

// K rows are stored with a stride of D + 1 so the lanes of a warp, which
// walk keys, hit distinct banks.  K tiles wholly past the causal edge end
// the loop, and tiles wholly outside the window are skipped.
__global__ void __launch_bounds__(kThreads)
    f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out, int Hq, int Hkv, int Sq,
               int Sk, int D, float scale, int causal, int window, int q_offset) {
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
  const float* qb = q + ((size_t)b * Hq + h) * Sq * D;
  const float* kb = k + ((size_t)b * Hkv + kvh) * Sk * D;
  const float* vb = v + ((size_t)b * Hkv + kvh) * Sk * D;

  for (int i = tid; i < kBlockQ * D; i += nt) {
    const int r = i / D;
    qs[i] = q0 + r < Sq ? qb[(size_t)q0 * D + i] * scale : 0.f;
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
      ks[r * DS + d] = in ? kb[(size_t)k0 * D + i] : 0.f;
      vs[i] = in ? vb[(size_t)k0 * D + i] : 0.f;
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
  float* ob = out + ((size_t)b * Hq + h) * Sq * D;
  for (int i = tid; i < kBlockQ * D; i += nt) {
    const int r = i / D;
    if (q0 + r >= Sq) continue;
    const float lr = l[r];
    ob[(size_t)q0 * D + i] = lr > 0.f ? acc[i] / lr : 0.f;
  }
}

// --------------------------------------------------------------------------
// bf16: TMA copies from a producer, wgmma products on the tensor cores
// (the helpers are hopper.cuh's)
// --------------------------------------------------------------------------
// Producer threads of a block: with one consumer warpgroup a warp (five
// warps: at most two on each SM sub-partition, 255 registers a thread);
// with two a whole warpgroup, which hands its registers to the consumers
// with setmaxnreg (24 + 2 x 240 a sub-partition), since nine warps would
// cap every thread at 168 and make ptxas serialise the wgmmas.
template <int kW>
constexpr int producer_threads() {
  return kW == 1 ? 32 : 128;
}

// kD: the head-dim instance (D zero-padded up to it by the tensor maps);
// kBK: keys per tile; kW: consumer warpgroups (64 query rows each) per
// block.  Threads: the kW consumer warpgroups, then the producer.
// Shared memory: Q, K[2], V[2], then the barriers.
template <int kD, int kBK, int kW>
__global__ void __launch_bounds__(128 * kW + producer_threads<kW>(), 1)
    bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int Hq,
                int Hkv, int Sq, int Sk, int D, float scale_log2, int causal, int window,
                int q_offset) {
  constexpr int kBQ = 64 * kW;
  constexpr int kNW = kD < 128 ? kD : 128;  // columns of O one P.V wgmma covers
  constexpr int kNO = kD / kNW;             // P.V wgmmas per 16 keys
  constexpr uint32_t kQBytes = kBQ * kD * 2, kKVBytes = kBK * kD * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t qs = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t kvs = qs + kQBytes;  // K[0], K[1], V[0], V[1]
  // barriers: Q full; K full[2], V full[2] (the producer's copies landed);
  // K empty[2], V empty[2] (every consumer thread is done with the stage)
  const uint32_t bars = kvs + 4 * kKVBytes;
  const uint32_t qfull = bars;
  auto kfull = [&](int st) { return bars + 8 * (1 + st); };
  auto vfull = [&](int st) { return bars + 8 * (3 + st); };
  auto kempty = [&](int st) { return bars + 8 * (5 + st); };
  auto vempty = [&](int st) { return bars + 8 * (7 + st); };
  auto kstage = [&](int st) { return kvs + st * kKVBytes; };
  auto vstage = [&](int st) { return kvs + (2 + st) * kKVBytes; };

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // the longest causal tiles first
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);

  // the keys any row of the block sees: tiles [kt_lo, kt_hi)
  const int qhi_blk = min(q0 + kBQ, Sq) - 1 + q_offset;
  const int kbeg = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int kend = causal ? min(Sk, qhi_blk + 1) : Sk;
  const int kt_lo = kbeg / kBK;
  const int n_tiles = kend > kbeg ? (kend + kBK - 1) / kBK - kt_lo : 0;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(kfull(st), 1);
      mbar_init(vfull(st), 1);
      mbar_init(kempty(st), 128 * kW);
      mbar_init(vempty(st), 128 * kW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kW) {
    // the producer: one lane copies Q once, then K and V of tile j into
    // stage j & 1 once every consumer has released the stage's previous
    // tile (the round j / 2 - 1 of its empty barrier)
    if constexpr (kW == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kW && n_tiles > 0) {
      mbar_expect_tx(qfull, kQBytes);
      for (int cb = 0; cb < kD / 64; ++cb)
        tma_load(qs + cb * (kBQ * 128), &tq, cb * 64, q0, b * Hq + h, qfull);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j & 1, row = (kt_lo + j) * kBK;
        if (j >= 2) mbar_wait(kempty(st), ((j >> 1) - 1) & 1);
        mbar_expect_tx(kfull(st), kKVBytes);
        for (int cb = 0; cb < kD / 64; ++cb)
          tma_load(kstage(st) + cb * (kBK * 128), &tk, cb * 64, row, b * Hkv + kvh, kfull(st));
        if (j >= 2) mbar_wait(vempty(st), ((j >> 1) - 1) & 1);
        mbar_expect_tx(vfull(st), kKVBytes);
        for (int cb = 0; cb < kD / 64; ++cb)
          tma_load(vstage(st) + cb * (kBK * 128), &tv, cb * 64, row, b * Hkv + kvh, vfull(st));
      }
    }
    return;
  }

  // a consumer: warpgroup wg, its rows, and this thread's two (r and r + 8
  // of the 64)
  if constexpr (kW == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int wq0 = q0 + 64 * wg;
  const int wlo = wq0 + q_offset;
  const int whi = min(wq0 + 64, Sq) - 1 + q_offset;  // < wlo: no row of the warpgroup is real
  const int r0 = 16 * warp + (lane >> 2);
  const int qp0 = wlo + r0, qp1 = qp0 + 8;
  const int c0 = 2 * (lane & 3);

  float o[kNO][kNW / 2];
#pragma unroll
  for (int i = 0; i < kNO; ++i)
#pragma unroll
    for (int j = 0; j < kNW / 2; ++j) o[i][j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // S = Q K^T: kD / 16 steps of 16 columns; a step inside a 64-column
  // block moves the start address by 32 bytes within the swizzle atom
  auto scores = [&](float (&s)[kBK / 2], uint32_t ks) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t a = qs + (kk >> 2) * (kBQ * 128) + wg * (64 * 128) + (kk & 3) * 32;
      const uint32_t bk = ks + (kk >> 2) * (kBK * 128) + (kk & 3) * 32;
      wgmma_ss(s, desc(a, 16, 1024), desc(bk, 16, 1024), kk > 0);
    }
  };
  // O += P V: 16 keys a step; V's 64-column blocks are kBK * 128 bytes
  // apart (the leading byte offset), 8-key groups 1024 (the stride)
  auto pv = [&](const uint32_t (&p)[kBK / 16][4], uint32_t vs) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < kNO; ++i) {
        const uint32_t bv = vs + kk * (16 * 128) + i * 2 * (kBK * 128);
        wgmma_rs(o[i], p[kk], desc(bv, kBK * 128, 1024), 1);
      }
  };
  // The online softmax of tile kt in registers: s[4j + e] is row
  // r0 + 8 (e >> 1), key k0 + 8j + c0 + (e & 1).  Updates m, l; gives P
  // rounded to bf16 pairs (the A fragment of P.V) and the rescale factors
  // of O.
  auto softmax = [&](float (&s)[kBK / 2], int kt, uint32_t (&p)[kBK / 16][4], float& al0,
                     float& al1) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) s[j] *= scale_log2;
    if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > wlo) || (window > 0 && k0 <= whi - window)) {
      // a tile across an edge: row r sees tile columns [lo, hi), as
      // offsets from this thread's c0
      const int hi0 = min(Sk, causal ? qp0 + 1 : Sk) - k0 - c0;
      const int hi1 = min(Sk, causal ? qp1 + 1 : Sk) - k0 - c0;
      const int lo0 = window > 0 ? qp0 - window + 1 - k0 - c0 : -kBK;
      const int lo1 = window > 0 ? qp1 - window + 1 - k0 - c0 : -kBK;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + (e & 1);
          if (col < (e & 2 ? lo1 : lo0) || col >= (e & 2 ? hi1 : hi0)) s[4 * j + e] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;  // a row that saw nothing yet
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    al0 = ex2(m0 - mu0);
    al1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p0 = ex2(s[4 * j] - mu0), p1 = ex2(s[4 * j + 1] - mu0);
      const float p2 = ex2(s[4 * j + 2] - mu1), p3 = ex2(s[4 * j + 3] - mu1);
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      p[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * al0 + ls0;  // this thread's share of the row sum
    l1 = l1 * al1 + ls1;
  };

  if (n_tiles > 0) {
    mbar_wait(qfull, 0);
    // the first tile, alone: O is still 0
    uint32_t pc[kBK / 16][4];  // P of the previous tile: the A of its P.V
    {
      float s[kBK / 2], al0, al1;
      mbar_wait(kfull(0), 0);
      wg_fence();
      scores(s, kstage(0));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      mbar_arrive(kempty(0));
      softmax(s, kt_lo, pc, al0, al1);
    }
    // then S of tile j and, behind it on the tensor cores, P.V of tile
    // j - 1; the softmax of tile j runs while P.V does
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j & 1;
      float s[kBK / 2], al0, al1;
      uint32_t pn[kBK / 16][4];
      mbar_wait(kfull(st), (j >> 1) & 1);
      mbar_wait(vfull(st ^ 1), ((j - 1) >> 1) & 1);
      wg_fence();
      scores(s, kstage(st));
      wg_commit();
      pv(pc, vstage(st ^ 1));
      wg_commit();
      wg_wait<1>();  // S has landed
      fence_regs(s);
      mbar_arrive(kempty(st));
      softmax(s, kt_lo + j, pn, al0, al1);
      wg_wait<0>();  // P.V has landed: O holds tiles up to j - 1 at the old maxima
#pragma unroll
      for (int i = 0; i < kNO; ++i) fence_regs(o[i]);
      fence_regs(pc);
      mbar_arrive(vempty(st ^ 1));
#pragma unroll
      for (int i = 0; i < kNO; ++i)
#pragma unroll
        for (int jj = 0; jj < kNW / 8; ++jj) {
          o[i][4 * jj] *= al0;
          o[i][4 * jj + 1] *= al0;
          o[i][4 * jj + 2] *= al1;
          o[i][4 * jj + 3] *= al1;
        }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pc[kk][e] = pn[kk][e];
    }
    // P.V of the last tile
    const int jl = n_tiles - 1;
    mbar_wait(vfull(jl & 1), (jl >> 1) & 1);
    wg_fence();
    pv(pc, vstage(jl & 1));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < kNO; ++i) fence_regs(o[i]);
    fence_regs(pc);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int row0 = wq0 + r0, row1 = row0 + 8;
  __nv_bfloat16* ob = out + ((size_t)b * Hq + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < kNO; ++i)
#pragma unroll
    for (int j = 0; j < kNW / 8; ++j) {
      const int col = i * kNW + 8 * j + c0;  // D % 8 == 0: col < D means col + 1 < D
      if (col >= D) continue;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * D + col) =
            __floats2bfloat162_rn(o[i][4 * j] * inv0, o[i][4 * j + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * D + col) =
            __floats2bfloat162_rn(o[i][4 * j + 2] * inv1, o[i][4 * j + 3] * inv1);
    }
}

// Raise a kernel's dynamic shared memory limit once per size, on the first
// (eager) launch that needs it: not again inside a CUDA-graph capture.
// `raised` is the kernel's current limit.
template <typename Kernel>
int raise_smem(Kernel kernel, size_t smem, size_t& raised) {
  if (smem <= raised) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  raised = smem;
  return 0;
}

// cuTensorMapEncodeTiled, looked up in libcuda through the CUDA runtime, so
// the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (heads, rows, D) bf16 tensor as a 3-d tensor map of 64-column boxes of
// `rows_box` rows, 128-byte swizzled; reads past it return zeros.
bool tensor_map(CUtensorMap* map, const void* base, int heads, int rows, int D, int rows_box) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows_box, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD, int kBK, int kW>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hkv,
                int Sq, int Sk, int D, float scale, int causal, int window, int q_offset,
                cudaStream_t stream) {
  // Q, K[2], V[2], 9 barriers, and the slack to align the tiles to 1024
  constexpr size_t smem = 2 * (64 * kW * kD + 4 * kBK * kD) + 128 + 1024;
  static size_t raised = 48 * 1024;
  if (const int e = raise_smem(bf16_kernel<kD, kBK, kW>, smem, raised)) return e;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B * Hq, Sq, D, 64 * kW) || !tensor_map(&tk, k, B * Hkv, Sk, D, kBK) ||
      !tensor_map(&tv, v, B * Hkv, Sk, D, kBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hq, (Sq + 64 * kW - 1) / (64 * kW), B);
  bf16_kernel<kD, kBK, kW><<<grid, 128 * kW + producer_threads<kW>(), smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq, Sk, D, scale * kLog2e, causal,
      window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns a cudaError_t; 0 = ok.
// Device pointers of contiguous tensors: q / out (B,Hq,Sq,D), k / v
// (B,Hkv,Sk,D), all of the entry point's type.  window <= 0 means no
// window.
//
// f32: `smem` is the block's dynamic shared memory in bytes, computed by
// the wrapper: 4 * (BQ*D + BK*(D+1) + BK*D + BQ*BK + BQ*D + 3*BQ) with
// BQ = 32, BK = 64.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int Sq, int Sk, int D, float scale,
                                   int causal, int window, int q_offset, size_t smem,
                                   void* stream) {
  static size_t raised = 48 * 1024;
  if (const int e = raise_smem(f32_kernel, smem, raised)) return e;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  f32_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Hq, Hkv, Sq, Sk, D, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// bf16: `head_dim` is the instance (64, 128 or 256; D <= head_dim) and
// `warpgroups` the query warpgroups per block (1 or 2), both chosen by the
// wrapper.  D must be a multiple of 8 and the pointers 16-byte aligned
// (the tensor maps' strides and base); the wrapper pads D otherwise.
// Keys per tile: 128, or 64 at head_dim 256 (registers).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int Hq, int Hkv, int Sq, int Sk, int D,
                                    float scale, int causal, int window, int q_offset,
                                    int head_dim, int warpgroups, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(HD, BK, W) \
  launch_bf16<HD, BK, W>(q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale, causal, window, q_offset, s)
  if (D > head_dim || D % 8 || (warpgroups != 1 && warpgroups != 2) ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15))
    return (int)cudaErrorInvalidValue;
  switch (head_dim * 2 + warpgroups) {
    case 64 * 2 + 1: return FA_LAUNCH(64, 128, 1);
    case 64 * 2 + 2: return FA_LAUNCH(64, 128, 2);
    case 128 * 2 + 1: return FA_LAUNCH(128, 128, 1);
    case 128 * 2 + 2: return FA_LAUNCH(128, 128, 2);
    case 256 * 2 + 1: return FA_LAUNCH(256, 64, 1);
    case 256 * 2 + 2: return FA_LAUNCH(256, 64, 2);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}
