// The bf16 tile pipeline of absorbed-MLA decode on Hopper, shared by K6's
// whole-slot kernel (paged_mla_decode.cu) and its partials kernel
// (paged_mla_partials.cu): one block takes 64 query heads of one slot and
// walks a run of the slot's latent lanes in 64-lane tiles (the design is
// in paged_mla_decode.cu's header).  Header-only, in an anonymous
// namespace of the including source.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"  // cp.async, wgmma and the swizzled descriptors

namespace {

constexpr int kHeads = 64;       // query heads a block takes: one wgmma M
constexpr int kTile = 64;        // latent lanes a tile
constexpr int kLoraMax = 512;    // latent width of the instance (zero-padded)
constexpr int kRopeMax = 64;     // RoPE width of the instance (zero-padded)
constexpr int kColBlocks = (kLoraMax + kRopeMax) / 64;  // 9 swizzled 64-column blocks
constexpr uint32_t kBlockBytes = 64 * 128;              // one 64-row, 64-column block
constexpr uint32_t kTileBytes = kColBlocks * kBlockBytes;  // 72 KB, Q's size too
constexpr int kBf16Threads = 256;  // two warpgroups
// Q, two tile stages, the stages' lane flags, and the slack to align to 1024
constexpr size_t kBf16Smem = 3 * (size_t)kTileBytes + 2 * kTile + 1024;

// Row r (< 64) of a swizzled [lat | rope] tile at dst: this thread's 18 of
// its 72 16-byte chunks (chunk c = part + 4 i), each read from lat or rope,
// or zero-filled past lora / rope and where `ok` is false.
__device__ __forceinline__ void copy_row(uint32_t dst, int r, int part,
                                         const __nv_bfloat16* lat, const __nv_bfloat16* rp,
                                         int lora, int rope, bool ok) {
#pragma unroll
  for (int i = 0; i < 18; ++i) {
    const int c = part + 4 * i;
    const int cc = c & 7;
    const uint32_t d = dst + (c >> 3) * kBlockBytes + r * 128 + ((cc ^ (r & 7)) << 4);
    const bool in = c < 64 ? ok && c * 8 < lora : ok && (c - 64) * 8 < rope;
    const __nv_bfloat16* src = c < 64 ? lat + c * 8 : rp + (c - 64) * 8;
    cp_async16(d, in ? src : lat, in ? 16u : 0u);
  }
}

// One block's walk over lanes [L0, L1) (L1 > L0) of slot b, whose page row
// is prow, for query heads [h0, h0 + 64): the block's Q rows, then the
// tiles in two stages, S = Q K^T, the online softmax in log2 units and
// O += P V.  qs is the 1024-aligned shared-memory address of Q (the stages
// follow it), okf the stages' lane flags.  On entry o is 0, m -inf and l 0;
// on return this thread holds, for rows r0 = 16 warp + lane / 4 and r0 + 8
// of the 64, the unnormalised context of columns 256 wg + 128 i + 8 jj +
// c0 (+ 1) in o[i][4 jj (+ 1)] (row r0) and o[i][4 jj + 2 (+ 1)] (row r0 +
// 8), and the rows' max (log2 units) and sum in m0, l0 and m1, l1 (the
// sums reduced over the quad).  With `uniform` every lane of [L0, L1)
// scores 0 and no S product runs (K6's slot without a valid lane).  The
// last tile's barrier has passed on return: Q and the stages are free.
__device__ __forceinline__ void mla_walk(const __nv_bfloat16* __restrict__ q_lat,
                                         const __nv_bfloat16* __restrict__ q_rope,
                                         const __nv_bfloat16* __restrict__ ckv,
                                         const __nv_bfloat16* __restrict__ krope,
                                         const int* __restrict__ prow, int b, int H, int h0,
                                         int lora, int rope, int ps, int N, int L0, int L1,
                                         bool uniform, float scale_log2, uint32_t qs,
                                         unsigned char* okf, float (&o)[2][64], float& m0,
                                         float& m1, float& l0, float& l1) {
  auto stage = [&](int st) { return qs + (1 + st) * kTileBytes; };
  const int tid = threadIdx.x;
  const int n_tiles = (L1 - L0 + kTile - 1) / kTile;

  // copies: thread tid fills row tid / 4 of a tile, chunks tid % 4 + 4 i
  const int lr = tid >> 2, lp = tid & 3;
  auto load_tile = [&](int j) {
    const int st = j & 1, t = L0 + j * kTile + lr;
    const int row = t < L1 ? min(__ldg(prow + t / ps), N - 1) : -1;
    const size_t lane = row >= 0 ? (size_t)row * ps + t % ps : 0;
    copy_row(stage(st), lr, lp, ckv + lane * lora, krope + lane * rope, lora, rope, row >= 0);
    if (lp == 0) okf[st * kTile + lr] = t < L1 && (uniform || row >= 0);
  };
  {
    const int hq = min(h0 + lr, H - 1);  // rows past H: zeros, never stored
    const size_t qrow = (size_t)b * H + hq;
    copy_row(qs, lr, lp, q_lat + qrow * lora, q_rope + qrow * rope, lora, rope, h0 + lr < H);
  }
  load_tile(0);
  cp_async_commit();

  // a warpgroup: rows r0 and r0 + 8 of the 64 heads in this thread; its
  // 256 context columns [256 wg, 256 wg + 256)
  const int wg = tid >> 7, lane = tid & 31;
  const int c0 = 2 * (lane & 3);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) load_tile(j + 1);  // into the stage tile j - 1 left
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and Q) landed for this thread's copies
    fence_async_shared();
    __syncthreads();  // ... and for every thread's

    // S = Q K^T over the 576 columns; s[4 jj + e] is row r0 + 8 (e >> 1),
    // lane L0 + 64 j + 8 jj + c0 + (e & 1)
    float s[32];
    if (!uniform) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kColBlocks; ++kk) {
        const uint32_t off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
        wgmma_ss(s, desc(qs + off, 16, 1024), desc(stage(st) + off, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
    }
    // the online softmax of the tile, in log2 units; a lane whose flag is
    // 0 scores -inf (p = 0), and every lane of a uniform slot scores 0
    const unsigned char* ok = okf + st * kTile;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * jj + e] * scale_log2;
        s[4 * jj + e] = ok[8 * jj + c0 + (e & 1)] ? x : -INFINITY;
        if (e & 2)
          mx1 = fmaxf(mx1, s[4 * jj + e]);
        else
          mx0 = fmaxf(mx0, s[4 * jj + e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;  // a row that saw nothing yet
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = ex2(m0 - mu0), al1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    // P as the A fragments of P.V: a bf16 high part and the bf16 remainder
    uint32_t ph[4][4], pl[4][4];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = ex2(s[4 * jj + e] - (e & 2 ? mu1 : mu0));
      ls0 += p[0] + p[1];
      ls1 += p[2] + p[3];
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(p[0], p[1]);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(p[2], p[3]);
      const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
      ph[jj >> 1][(jj & 1) * 2] = *reinterpret_cast<const uint32_t*>(&h01);
      ph[jj >> 1][(jj & 1) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&h23);
      pl[jj >> 1][(jj & 1) * 2] = pack_bf16(p[0] - f01.x, p[1] - f01.y);
      pl[jj >> 1][(jj & 1) * 2 + 1] = pack_bf16(p[2] - f23.x, p[3] - f23.y);
    }
    l0 = l0 * al0 + ls0;  // this thread's share of the row sum
    l1 = l1 * al1 + ls1;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        o[i][4 * jj] *= al0;
        o[i][4 * jj + 1] *= al0;
        o[i][4 * jj + 2] *= al1;
        o[i][4 * jj + 3] *= al1;
      }
    // O += P V: 16 lanes a step; V's 64-column blocks are a block apart
    // (the leading byte offset), 8-lane groups 1024 B (the stride)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t bv = stage(st) + (4 * wg + 2 * i) * kBlockBytes + kk * (16 * 128);
        wgmma_rs(o[i], ph[kk], desc(bv, kBlockBytes, 1024), 1);
        wgmma_rs(o[i], pl[kk], desc(bv, kBlockBytes, 1024), 1);
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 2; ++i) fence_regs(o[i]);
    fence_regs(ph);
    fence_regs(pl);
    __syncthreads();  // every warpgroup is done with the stage: tile j + 2 may land there
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
}

}  // namespace
