// The Hopper attention main loop, shared by K5's forward (flash_attention.cu)
// and K9 (ring_attention.cu): one design on hopper_common.cuh's tiles.
//
// A block holds up to 128 query rows of one head in shared memory (TMA, the
// 128-byte swizzle) and a producer warp (of a producer warpgroup that hands
// its registers to the consumers) streams key / value tiles of BN rows
// into a 2-stage ring with full and empty mbarriers. attend_tiles() is the
// consumer side for one warpgroup's 64 rows: S = Q.K^T by SS wgmma, the
// online softmax in registers (scores and m in log2 units, one exp2 a score),
// O += P.V by RS wgmma with P taken from the score accumulator and V read
// MN-major. Tiles at or past `my_tiles` are waited for and released without
// work (a causal warpgroup may own rows above the block's last tile). Only
// tiles the mask calls edges are masked element by element.
//
// SPLIT_P = false rounds p to bf16 for P.V (K5, as the TPU's kernel); SPLIT_P
// = true carries p as two bf16 halves, hi = bf16(p) and lo = bf16(p - hi),
// through two RS wgmma chains into the same accumulator, so P.V keeps p to
// about 2^-17 relative (K9, whose TPU kernel keeps p in fp32).
//
// The Mask supplies edge(k0, k1): whether keys [k0, k1) may hold a masked
// score for this warpgroup, and ok(st, col, key, second): whether row g
// (second: g + 8) of the thread attends key `key` (column `col` of ring stage
// `st`).
#pragma once

#include "hopper_common.cuh"

namespace {

constexpr float kMaskedScore = -1e30f;     // the TPU kernels' NEG_INF
constexpr int kRingStages = 2;
// A block is two consumer warpgroups and a producer warpgroup (384 threads,
// 168 registers a thread at launch): the producer keeps 40, the consumers
// grow to 232 (setmaxnreg), so that the accumulators of D = 256 and K9's two
// P.V chains fit without spilling or serializing the wgmmas.
constexpr int kAttnThreads = 384, kProducerRegs = 40, kConsumerRegs = 232;

// hi = bf16(x, y) and lo = bf16 of what hi leaves out, as packed pairs
__device__ __forceinline__ void split_pair(uint32_t& hi, uint32_t& lo, float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&r);
}

// One warpgroup's pass over the kv ring: o (64 x D fp32 accumulator), the
// row maxima m0, m1 (log2 units) and per-lane partial row sums l0, l1 carried
// across calls' tiles. Qw: the warpgroup's 64 rows inside a [D / 64][q_rows]
// [64] tile; Ks / Vs: [kRingStages][D / 64][BN][64] rings.
template <int D, int BN, bool SPLIT_P, typename Mask>
__device__ __forceinline__ void attend_tiles(float (&o)[D / 2], float& m0, float& m1, float& l0,
                                             float& l1, const bf16* Qw, int q_rows,
                                             const bf16* Ks, const bf16* Vs, uint64_t* full,
                                             uint64_t* empty, int ntiles, int my_tiles,
                                             float scale2, const Mask& mask) {
  constexpr int NCH = D / 64;
  const int tq = threadIdx.x & 3;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kRingStages, k0 = j * BN;
    mbar_wait(&full[st], (j / kRingStages) & 1);
    if (j < my_tiles) {
      float s[BN / 2];
      qk_product<D, BN>(s, Qw, q_rows, Ks + st * NCH * BN * 64);
      const bool edge = mask.edge(k0, k0 + BN);
      float mx0 = kMaskedScore, mx1 = kMaskedScore;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = s[i] * scale2;
        if (edge) {
          const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
          if (!mask.ok(st, col, k0 + col, (i & 2) != 0)) x = kMaskedScore;
        }
        s[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
      }
      const float mn0 = fmaxf(m0, quad_max4(mx0)), mn1 = fmaxf(m1, quad_max4(mx1));
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float e = exp2f(s[i] - ((i & 2) ? mn1 : mn0));
        s[i] = e;
        if (i & 2) ls1 += e; else ls0 += e;
      }
      // per-lane partial row sums; the quad adds them up at the end
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? al1 : al0;
      const bf16* Vt = Vs + st * NCH * BN * 64;
      if constexpr (SPLIT_P) {
        uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            split_pair(ph[kk][r], pl[kk][r], s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        fence_acc(o);
        wgmma_fence();
        rs_issue<D, BN>(o, ph, Vt);
        rs_issue<D, BN>(o, pl, Vt);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(o);
      } else {
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) acc_to_a_frag(pa[kk], s, kk);
        pv_product<D, BN>(o, pa, Vt);
      }
    }
    mbar_arrive(&empty[st]);
  }
}

}  // namespace
