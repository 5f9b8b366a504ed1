// Causal flash attention for Hopper (sm_90a): the forward and the two backward
// kernels. They replace the three pallas_calls of slime_tpu/ops/flash_attention.py:
//   K5   _fwd (:133, call :154)        out, lse from q, k, v
//   K5b  _bwd_impl dK/dV (:316, :347)  dk, dv from q, k, v, do, lse, delta
//   K5c  _bwd_impl dQ (:316, :389)     dq from the same inputs
// On the training path they run in every decoder layer at q [B, 32, 2048, 128],
// k/v [B, 8, 2048, 128] bf16 (the forward twice with per-layer remat), and the
// forward in every serving prefill.
//
// Semantics kept from the TPU kernels (scores s = (q . k) * scale in fp32):
//   - masked scores are -1e30 (not -inf); a query attends a key when the key
//     lies inside S, under causality (key <= query) when causal, and, with
//     segment ids, when both carry the same id;
//   - forward: the online softmax over key tiles in ascending order, m starting
//     at -1e30; p = exp(s - m_new) in fp32, rounded to bf16 for P.V while l
//     sums the unrounded p; out = acc / l and lse = m + log(l), with l == 0
//     read as 1. A first key tile that is wholly masked for a row leaves
//     m = -1e30 and p = 1 for a moment; the first tile with a real score
//     scales that away by alpha = exp(-1e30 - m) = 0, as on the TPU;
//   - backward: p = ok ? exp(s - lse) : 0; dp = do . v; ds = p (dp - delta)
//     scale; dv += bf16(p)^T do, dk += bf16(ds)^T q, dq += bf16(ds) k, all
//     accumulated in fp32 and rounded once to bf16 at the end.
// Every kernel also takes fp32 q/k/v/do (its *_f32 twin at the end of this
// file, on the FFMA units): then p and ds are never rounded, and the outputs
// are fp32. D is 128 (Llama-3-8B) or 256, in both dtypes.
// Rows and keys past S read as zeros (TMA's out-of-bounds fill in the forward,
// bound checks in the others), which is what JAX's _zero_tail does for the
// TPU's ragged block padding; keys past S are masked.
//
// Design. What bounds attention at these shapes is tensor-core throughput
// (S = 2048, D = 128: 256 flops per byte of q/k/v read). The TPU kernel's
// grid order (b, i, h, j) and the lse read-modify-write across heads exist
// for Mosaic's VMEM revisit rules; here a block owns one tile and loops:
//   - forward (bf16): Hopper's own shape (hopper_common.cuh). A block owns
//     (128 query rows, q head, batch): one producer warp keeps TMA loads of
//     K and V tiles (128 keys at D = 128, 64 at D = 256) in a 2-stage ring
//     with full and empty mbarriers, and two consumer warpgroups of 64 rows
//     each run S = Q.K^T as an SS wgmma, the online softmax in registers, and
//     O += P.V as an RS wgmma with P straight from the score accumulator and V
//     read MN-major (no transpose). Causal blocks visit key tiles up to the
//     diagonal only and mask only the diagonal, ragged and segmented tiles;
//     the heavy query tiles launch first. The epilogue stores O by TMA. The
//     softmax does not overlap the products yet (FlashAttention-3's ping-pong
//     is a later version);
//   - dQ: a block owns (64 query rows, head, batch) and loops over key tiles
//     of 64 (causal: only up to the diagonal); heavy tiles launch first;
//   - dK/dV: a block owns (64 keys, kv head, batch) and loops over the query
//     heads of its GQA group and over query tiles (causal: from the diagonal
//     on). The group sum runs inside the block, so there is no [B, H, S, D]
//     fp32 scratch and no separate reduction (JAX computes dK/dV per query
//     head in fp32 and sums the group after the kernel, :385-386);
//   - dQ and dK/dV in bf16: 4 warps of 16 rows each; every product is an
//     mma.sync m16n8k16 bf16 tile with fp32 accumulation; tiles are staged in
//     shared memory with rows padded by 8 elements (16 B), so the fragment
//     loads of a warp hit 32 distinct banks; operands that a product needs
//     transposed (K for dS.K, Q and dO for the dK/dV products) are also stored
//     transposed while loading. At D = 256 their accumulators spill to local
//     memory (no path runs them yet);
//   - q/k/v/do are read through (batch, head, sequence) element strides, so
//     llama's [B, S, H, D] projections need no transpose copy; outputs are
//     written through strides too. lse and delta are [B, H, S] fp32.
#include <type_traits>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

struct Mat { long long b, h, s; };       // element strides; unit stride over D

// T is bf16 (the mma.sync kernels) or float (the FFMA kernels)
template <typename T>
struct Args {
  const T* q; const T* k; const T* v; const T* dout;
  T* out; T* dq; T* dk; T* dv;
  float* lse; const float* delta; const int* seg;
  Mat sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int H, KVH, S, causal;
  float scale;
};

__device__ __forceinline__ void stage_ids(int* dst, const int* seg, int r0, int S) {
  if (seg != nullptr && threadIdx.x < kTile)
    dst[threadIdx.x] = r0 + (int)threadIdx.x < S ? seg[r0 + threadIdx.x] : 0;
}

template <typename A>
__device__ __forceinline__ bool attends(const A& a, int query, int key, int seg_q,
                                        int seg_k) {
  bool ok = query < a.S && key < a.S;
  if (a.causal) ok = ok && key <= query;
  if (a.seg != nullptr) ok = ok && seg_q == seg_k;
  return ok;
}

// ---------------------------------------------------------------------------
// K5: forward (wgmma, TMA, mbarrier ring)
// ---------------------------------------------------------------------------
struct FwdParams {
  CUtensorMap q, k, v, o;
  float* lse;
  const int* seg;
  int H, KVH, S, causal;
  float scale;
};

// One block per (128 query rows, q head, batch): consumer warpgroups 0 and 1
// own 64 rows each, warp 8 is the producer. BN keys a tile: 128 at D = 128,
// 64 at D = 256 so that the O accumulator (D / 2 fp32 a thread) and the
// scores fit in registers.
template <int D, int BN>
__global__ void __launch_bounds__(288, 1) flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  constexpr int BM = 128, NCH = D / 64, STAGES = 2;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align1024(smem_raw));    // [NCH][BM][64]
  bf16* Ks = Qs + NCH * BM * 64;                                // [STAGES][NCH][BN][64]
  bf16* Vs = Ks + STAGES * NCH * BN * 64;                       // [STAGES][NCH][BN][64]
  int* segk = reinterpret_cast<int*>(Vs + STAGES * NCH * BN * 64);   // [STAGES][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(segk + STAGES * BN);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int S = p.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;           // diagonal-heavy first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.KVH);
  const int kend = p.causal ? min(S, q0 + BM) : S;
  const int ntiles = (kend + BN - 1) / BN;
  const int* segb = p.seg != nullptr ? p.seg + (long long)b * S : nullptr;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 32);                                  // the producer's lanes
      mbar_init(&empty[i], 256);                                // every consumer thread
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {                                                // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, NCH * BM * 128);
      for (int c = 0; c < NCH; ++c) tma_load(Qs + c * BM * 64, &p.q, qbar, 64 * c, q0, h, b);
    }
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES, k0 = j * BN;
      mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
      // the tile's segment ids, published by each lane's arrive
      if (segb != nullptr)
        for (int i = lane; i < BN; i += 32) segk[st * BN + i] = k0 + i < S ? segb[k0 + i] : 0;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * NCH * BN * 128);
        for (int c = 0; c < NCH; ++c) {
          tma_load(Ks + (st * NCH + c) * BN * 64, &p.k, &full[st], 64 * c, k0, hk, b);
          tma_load(Vs + (st * NCH + c) * BN * 64, &p.v, &full[st], 64 * c, k0, hk, b);
        }
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  const int t = threadIdx.x & 127, warp = t >> 5, g = (t & 31) >> 2, tq = t & 3;
  const int qw = q0 + 64 * wg;                                  // this warpgroup's first row
  const int row0 = qw + 16 * warp + g, row1 = row0 + 8;
  // causal: the last tile the block loads may lie wholly above this warpgroup's rows
  const int my_tiles = ((p.causal ? min(S, qw + 64) : S) + BN - 1) / BN;
  int seg0 = 0, seg1 = 0;
  if (segb != nullptr) {
    seg0 = row0 < S ? segb[row0] : 0;
    seg1 = row1 < S ? segb[row1] : 0;
  }
  bf16* Qw = Qs + 64 * wg * 64;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  mbar_wait(qbar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES, k0 = j * BN;
    mbar_wait(&full[st], (j / STAGES) & 1);
    if (j < my_tiles) {
      float s[BN / 2];
      qk_product<D, BN>(s, Qw, BM, Ks + st * NCH * BN * 64);
      // only tiles on the diagonal, at the ragged end or with segments mask;
      // scores and m are kept in log2 units (x log2(e)) so that each exp is
      // one exp2
      const bool edge = segb != nullptr || k0 + BN > S || (p.causal && k0 + BN - 1 > qw);
      const float scale2 = p.scale * kLog2e;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float x = s[i] * scale2;
        if (edge) {
          const int col = 8 * (i >> 2) + 2 * tq + (i & 1), key = k0 + col;
          const int row = (i & 2) ? row1 : row0;
          bool ok = key < S && row < S;
          if (p.causal) ok = ok && key <= row;
          if (segb != nullptr) ok = ok && ((i & 2) ? seg1 : seg0) == segk[st * BN + col];
          if (!ok) x = kNegInf;
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
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a_frag(pa[kk], s, kk);
      pv_product<D, BN>(o, pa, Vs + st * NCH * BN * 64);
    }
    mbar_arrive(&empty[st]);
  }

  l0 = quad_sum4(l0);
  l1 = quad_sum4(l1);
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  if (tq == 0) {
    float* lp = p.lse + ((long long)b * p.H + h) * S;
    if (row0 < S) lp[row0] = m0 / kLog2e + logf(d0);
    if (row1 < S) lp[row1] = m1 / kLog2e + logf(d1);
  }
  store_rows<D>(o, d0, d1, Qw, BM, &p.o, qw, h, b, 1 + wg);
}

// ---------------------------------------------------------------------------
// K5c: dQ
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args<bf16> a) {
  constexpr int LD = D + kPad, LDT = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);         // [kBlock][LD]
  bf16* dOs = Qs + kBlock * LD;                     // [kBlock][LD]
  bf16* Ks = dOs + kBlock * LD;                     // [kTile][LD]
  bf16* Vs = Ks + kTile * LD;                       // [kTile][LD]
  bf16* Kt = Vs + kTile * LD;                       // [D][LDT]
  int* segk = reinterpret_cast<int*>(Kt + D * LDT); // [kTile]

  const int S = a.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;

  const bf16* qp = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* dop = a.dout + b * a.sdo.b + h * a.sdo.h;
  const bf16* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const bf16* vp = a.v + b * a.sv.b + hk * a.sv.h;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;
  const long long bh = ((long long)b * a.H + h) * S;

  stage<D>(qp, a.sq.s, q0, S, Qs, nullptr);
  stage<D>(dop, a.sdo.s, q0, S, dOs, nullptr);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qa[kk], Qs + wr * LD + kk * 16, LD, g, t);
  const float lse0 = row0 < S ? a.lse[bh + row0] : 0.f;
  const float lse1 = row1 < S ? a.lse[bh + row1] : 0.f;
  const float dl0 = row0 < S ? a.delta[bh + row0] : 0.f;
  const float dl1 = row1 < S ? a.delta[bh + row1] : 0.f;
  int seg0 = 0, seg1 = 0;
  if (segb != nullptr) {
    seg0 = row0 < S ? segb[row0] : 0;
    seg1 = row1 < S ? segb[row1] : 0;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  const int kend = a.causal ? min(S, q0 + kBlock) : S;
  const int ntiles = (kend + kTile - 1) / kTile;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    stage<D>(kp, a.sk.s, k0, S, Ks, Kt);
    stage<D>(vp, a.sv.s, k0, S, Vs, nullptr);
    stage_ids(segk, segb, k0, S);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t da[4];
      load_a(da, dOs + wr * LD + kk * 16, LD, g, t);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, Ks + n * 8 * LD + kk * 16, LD, g, t);
        mma16816(s[n], qa[kk], b0, b1);
        load_b(b0, b1, Vs + n * 8 * LD + kk * 16, LD, g, t);
        mma16816(dp[n], da, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n * 8 + 2 * t + (i & 1);
        const bool ok = i < 2 ? attends(a, row0, k0 + col, seg0, segk[col])
                              : attends(a, row1, k0 + col, seg1, segk[col]);
        const float p = ok ? expf(s[n][i] * a.scale - (i < 2 ? lse0 : lse1)) : 0.f;
        s[n][i] = p * (dp[n][i] - (i < 2 ? dl0 : dl1)) * a.scale;   // ds
      }
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t dsa[4];
      acc_to_a(dsa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, Kt + n * 8 * LDT + kk * 16, LDT, g, t);
        mma16816(dq[n], dsa, b0, b1);
      }
    }
  }

  bf16* dqp = a.dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqp + row0 * a.sdq.s + col) =
          __floats2bfloat162_rn(dq[n][0], dq[n][1]);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqp + row1 * a.sdq.s + col) =
          __floats2bfloat162_rn(dq[n][2], dq[n][3]);
  }
}

// ---------------------------------------------------------------------------
// K5b: dK, dV (the GQA group summed inside the block)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Args<bf16> a) {
  constexpr int LD = D + kPad, LDT = kTile + kPad;
  constexpr int kHalf = kTile / 2;                  // queries per inner product step
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);         // [kBlock][LD]
  bf16* Vs = Ks + kBlock * LD;                      // [kBlock][LD]
  bf16* Qs = Vs + kBlock * LD;                      // [kTile][LD]
  bf16* dOs = Qs + kTile * LD;                      // [kTile][LD]
  bf16* Qt = dOs + kTile * LD;                      // [D][LDT]
  bf16* dOt = Qt + D * LDT;                         // [D][LDT]
  float* lse_s = reinterpret_cast<float*>(dOt + D * LDT);   // [kTile]
  float* dl_s = lse_s + kTile;                      // [kTile]
  int* segq = reinterpret_cast<int*>(dl_s + kTile); // [kTile]

  const int S = a.S;
  const int k0 = blockIdx.x * kBlock;               // causal: low keys are heavy
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int key0 = k0 + wr + g, key1 = key0 + 8;

  const bf16* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const bf16* vp = a.v + b * a.sv.b + hk * a.sv.h;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;
  stage<D>(kp, a.sk.s, k0, S, Ks, nullptr);
  stage<D>(vp, a.sv.s, k0, S, Vs, nullptr);
  int segk0 = 0, segk1 = 0;
  if (segb != nullptr) {
    segk0 = key0 < S ? segb[key0] : 0;
    segk1 = key1 < S ? segb[key1] : 0;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  const int nq = (S + kTile - 1) / kTile;
  const int first = a.causal ? k0 / kTile : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const bf16* qp = a.q + b * a.sq.b + h * a.sq.h;
    const bf16* dop = a.dout + b * a.sdo.b + h * a.sdo.h;
    const long long bh = ((long long)b * a.H + h) * S;
    for (int i = first; i < nq; ++i) {
      const int q0 = i * kTile;
      __syncthreads();
      stage<D>(qp, a.sq.s, q0, S, Qs, Qt);
      stage<D>(dop, a.sdo.s, q0, S, dOs, dOt);
      if (threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < S ? a.lse[bh + r] : 0.f;
        dl_s[threadIdx.x] = r < S ? a.delta[bh + r] : 0.f;
      }
      stage_ids(segq, segb, q0, S);
      __syncthreads();

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = half * kHalf;               // first query column of this step
        float st[kHalf / 8][4], dpt[kHalf / 8][4]; // S^T and dP^T: keys x queries
#pragma unroll
        for (int n = 0; n < kHalf / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ka[4], va[4];
          load_a(ka, Ks + wr * LD + kk * 16, LD, g, t);
          load_a(va, Vs + wr * LD + kk * 16, LD, g, t);
#pragma unroll
          for (int n = 0; n < kHalf / 8; ++n) {
            uint32_t b0, b1;
            load_b(b0, b1, Qs + (c0 + n * 8) * LD + kk * 16, LD, g, t);
            mma16816(st[n], ka, b0, b1);
            load_b(b0, b1, dOs + (c0 + n * 8) * LD + kk * 16, LD, g, t);
            mma16816(dpt[n], va, b0, b1);
          }
        }
#pragma unroll
        for (int n = 0; n < kHalf / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + n * 8 + 2 * t + (e & 1);   // query within the tile
            const bool ok = e < 2 ? attends(a, q0 + col, key0, segq[col], segk0)
                                  : attends(a, q0 + col, key1, segq[col], segk1);
            const float p = ok ? expf(st[n][e] * a.scale - lse_s[col]) : 0.f;
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - dl_s[col]) * a.scale;   // ds^T
          }
        }
#pragma unroll
        for (int kk = 0; kk < kHalf / 16; ++kk) {
          uint32_t pa[4], dsa[4];
          acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
          acc_to_a(dsa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            uint32_t b0, b1;
            load_b(b0, b1, dOt + n * 8 * LDT + c0 + kk * 16, LDT, g, t);
            mma16816(dv[n], pa, b0, b1);
            load_b(b0, b1, Qt + n * 8 * LDT + c0 + kk * 16, LDT, g, t);
            mma16816(dk[n], dsa, b0, b1);
          }
        }
      }
    }
  }

  bf16* dkp = a.dk + b * a.sdk.b + hk * a.sdk.h;
  bf16* dvp = a.dv + b * a.sdv.b + hk * a.sdv.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (key0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + key0 * a.sdk.s + col) =
          __floats2bfloat162_rn(dk[n][0], dk[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + key0 * a.sdv.s + col) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    }
    if (key1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + key1 * a.sdk.s + col) =
          __floats2bfloat162_rn(dk[n][2], dk[n][3]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + key1 * a.sdv.s + col) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 inputs: K5, K5c and K5b on the FFMA units
// ---------------------------------------------------------------------------
// The loops of the bf16 kernels above with every product a plain fp32 FMA (no
// TF32, p and ds never rounded): what JAX's interpret-mode kernels compute
// for fp32 inputs, and what llama.forward's default fp32 compute dtype sends
// here. 256 threads; thread (ty = tid / 16, tx = tid % 16) owns rows 4 ty ..
// 4 ty + 3 of the block, columns tx + 16 c (c < 4) of a 64-wide tile and
// output columns tx + 16 n (n < D / 16). The 16 threads of a row group are
// one half-warp, so row reductions are shuffles within it. Staged rows are
// padded to D + 1 floats: the 16 threads reading 16 rows at one depth hit 16
// distinct banks. Shared memory holds the operands, so these kernels are
// bound by its bandwidth (two loads per two FMAs in the score loop), not by
// the 67 TFLOP/s fp32 peak; a register-blocked design is for a later version.
constexpr int kF32Threads = 256;
constexpr int kRows = 4;               // block rows per thread
constexpr int kCols = kTile / 16;      // tile columns per thread
constexpr int kLdp = kTile + 1;        // row stride of the [64][64] p / ds tiles

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + R) of one head's [S, D] fp32 matrix (row stride rs) into
// dst [R][D + 1]; rows at or past S are 0.
template <int D, int R = kTile>
__device__ __forceinline__ void stage_f32(const float* src, long long rs, int r0, int S,
                                          float* dst) {
  for (int e = threadIdx.x; e < R * D; e += kF32Threads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r0 + r < S ? src[(long long)(r0 + r) * rs + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(const Args<float> a) {
  constexpr int LD = D + 1, NO = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);              // [kBlock][LD]
  float* Ks = Qs + kBlock * LD;                            // [kTile][LD]
  float* Vs = Ks + kTile * LD;                             // [kTile][LD]
  float* Ps = Vs + kTile * LD;                             // [kBlock][kLdp]
  int* segk = reinterpret_cast<int*>(Ps + kBlock * kLdp);  // [kTile]

  const int S = a.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;   // diagonal-heavy first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.KVH);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const float* vp = a.v + b * a.sv.b + hk * a.sv.h;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;

  stage_f32<D>(a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, S, Qs);
  int row[kRows], segr[kRows];
  float o[kRows][NO], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    row[i] = q0 + ty * kRows + i;
    segr[i] = segb != nullptr && row[i] < S ? segb[row[i]] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[i][n] = 0.f;
  }

  const int kend = a.causal ? min(S, q0 + kBlock) : S;
  const int ntiles = (kend + kTile - 1) / kTile;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();                              // the previous tile is consumed
    stage_f32<D>(kp, a.sk.s, k0, S, Ks);
    stage_f32<D>(vp, a.sv.s, k0, S, Vs);
    stage_ids(segk, segb, k0, S);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        const float x = attends(a, row[i], k0 + col, segr[i], segk[col]) ? s[i][c] * a.scale
                                                                         : kNegInf;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], max16(mx));
      const float al = expf(m[i] - mn);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = expf(s[i][c] - mn);
        Ps[(ty * kRows + i) * kLdp + tx + 16 * c] = p;
        ls += p;
      }
      // per-thread partial row sums; the half-warp adds them up at the end
      l[i] = l[i] * al + ls;
      m[i] = mn;
#pragma unroll
      for (int n = 0; n < NO; ++n) o[i][n] *= al;
    }
    __syncwarp();                                 // a row's p is written by its half-warp
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[kRows], vv[NO];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * kLdp + kk];
#pragma unroll
      for (int n = 0; n < NO; ++n) vv[n] = Vs[kk * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int n = 0; n < NO; ++n) o[i][n] = fmaf(pv[i], vv[n], o[i][n]);
    }
  }

  float* op = a.out + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float lt = sum16(l[i]);
    const float dn = lt == 0.f ? 1.f : lt;
    if (row[i] >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) op[row[i] * a.so.s + tx + 16 * n] = o[i][n] / dn;
    if (tx == 0) a.lse[((long long)b * a.H + h) * S + row[i]] = m[i] + logf(dn);
  }
}

template <int D, int BR>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(const Args<float> a) {
  constexpr int LD = D + 1, NO = D / 16, R = BR / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);              // [BR][LD]
  float* dOs = Qs + BR * LD;                               // [BR][LD]
  float* Ks = dOs + BR * LD;                               // [kTile][LD]
  float* Vs = Ks + kTile * LD;                             // [kTile][LD]
  float* DSs = Vs + kTile * LD;                            // [BR][kLdp]
  int* segk = reinterpret_cast<int*>(DSs + BR * kLdp);     // [kTile]

  const int S = a.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.KVH);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const float* vp = a.v + b * a.sv.b + hk * a.sv.h;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;
  const long long bh = ((long long)b * a.H + h) * S;

  stage_f32<D, BR>(a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, S, Qs);
  stage_f32<D, BR>(a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s, q0, S, dOs);
  int row[R], segr[R];
  float lse[R], dl[R], dq[R][NO];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row[i] = q0 + ty * R + i;
    const bool in = row[i] < S;
    segr[i] = segb != nullptr && in ? segb[row[i]] : 0;
    lse[i] = in ? a.lse[bh + row[i]] : 0.f;
    dl[i] = in ? a.delta[bh + row[i]] : 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) dq[i][n] = 0.f;
  }

  const int kend = a.causal ? min(S, q0 + BR) : S;
  const int ntiles = (kend + kTile - 1) / kTile;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    stage_f32<D>(kp, a.sk.s, k0, S, Ks);
    stage_f32<D>(vp, a.sv.s, k0, S, Vs);
    stage_ids(segk, segb, k0, S);
    __syncthreads();

    float s[R][kCols], dp[R][kCols];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R], dov[R], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(ty * R + i) * LD + d];
        dov[i] = dOs[(ty * R + i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        kv[c] = Ks[(tx + 16 * c) * LD + d];
        vv[c] = Vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        const float p = attends(a, row[i], k0 + col, segr[i], segk[col])
                            ? expf(s[i][c] * a.scale - lse[i]) : 0.f;
        DSs[(ty * R + i) * kLdp + col] = p * (dp[i][c] - dl[i]) * a.scale;
      }
    __syncwarp();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[R], kv[NO];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = DSs[(ty * R + i) * kLdp + kk];
#pragma unroll
      for (int n = 0; n < NO; ++n) kv[n] = Ks[kk * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int n = 0; n < NO; ++n) dq[i][n] = fmaf(dsv[i], kv[n], dq[i][n]);
    }
  }

  float* dqp = a.dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (row[i] >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) dqp[row[i] * a.sdq.s + tx + 16 * n] = dq[i][n];
  }
}

template <int D, int BR>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkdv_f32_kernel(const Args<float> a) {
  constexpr int LD = D + 1, NO = D / 16, R = BR / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);              // [BR][LD]
  float* Vs = Ks + BR * LD;                                // [BR][LD]
  float* Qs = Vs + BR * LD;                                // [kTile][LD]
  float* dOs = Qs + kTile * LD;                            // [kTile][LD]
  float* PT = dOs + kTile * LD;                             // [BR][kLdp]: p^T
  float* DST = PT + BR * kLdp;                             // [BR][kLdp]: ds^T
  float* lse_s = DST + BR * kLdp;                          // [kTile]
  float* dl_s = lse_s + kTile;                             // [kTile]
  int* segq = reinterpret_cast<int*>(dl_s + kTile);        // [kTile]

  const int S = a.S;
  const int k0 = blockIdx.x * BR;                          // causal: low keys are heavy
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.KVH;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;
  stage_f32<D, BR>(a.k + b * a.sk.b + hk * a.sk.h, a.sk.s, k0, S, Ks);
  stage_f32<D, BR>(a.v + b * a.sv.b + hk * a.sv.h, a.sv.s, k0, S, Vs);
  int key[R], segr[R];
  float dk[R][NO], dv[R][NO];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    key[i] = k0 + ty * R + i;
    segr[i] = segb != nullptr && key[i] < S ? segb[key[i]] : 0;
#pragma unroll
    for (int n = 0; n < NO; ++n) dk[i][n] = dv[i][n] = 0.f;
  }

  const int nq = (S + kTile - 1) / kTile;
  const int first = a.causal ? k0 / kTile : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const float* qp = a.q + b * a.sq.b + h * a.sq.h;
    const float* dop = a.dout + b * a.sdo.b + h * a.sdo.h;
    const long long bh = ((long long)b * a.H + h) * S;
    for (int qi = first; qi < nq; ++qi) {
      const int q0 = qi * kTile;
      __syncthreads();
      stage_f32<D>(qp, a.sq.s, q0, S, Qs);
      stage_f32<D>(dop, a.sdo.s, q0, S, dOs);
      if (threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < S ? a.lse[bh + r] : 0.f;
        dl_s[threadIdx.x] = r < S ? a.delta[bh + r] : 0.f;
      }
      stage_ids(segq, segb, q0, S);
      __syncthreads();

      float st[R][kCols], dpt[R][kCols];   // S^T and dP^T: keys x queries
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[R], vv[R], qv[kCols], dov[kCols];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = Ks[(ty * R + i) * LD + d];
          vv[i] = Vs[(ty * R + i) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          qv[c] = Qs[(tx + 16 * c) * LD + d];
          dov[c] = dOs[(tx + 16 * c) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            st[i][c] = fmaf(kv[i], qv[c], st[i][c]);
            dpt[i][c] = fmaf(vv[i], dov[c], dpt[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = tx + 16 * c;              // query within the tile
          const float p = attends(a, q0 + col, key[i], segq[col], segr[i])
                              ? expf(st[i][c] * a.scale - lse_s[col]) : 0.f;
          PT[(ty * R + i) * kLdp + col] = p;
          DST[(ty * R + i) * kLdp + col] = p * (dpt[i][c] - dl_s[col]) * a.scale;
        }
      __syncwarp();
#pragma unroll 2
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[R], dsv[R], dov[NO], qv[NO];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = PT[(ty * R + i) * kLdp + qq];
          dsv[i] = DST[(ty * R + i) * kLdp + qq];
        }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          dov[n] = dOs[qq * LD + tx + 16 * n];
          qv[n] = Qs[qq * LD + tx + 16 * n];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            dv[i][n] = fmaf(pv[i], dov[n], dv[i][n]);
            dk[i][n] = fmaf(dsv[i], qv[n], dk[i][n]);
          }
      }
    }
  }

  float* dkp = a.dk + b * a.sdk.b + hk * a.sdk.h;
  float* dvp = a.dv + b * a.sdv.b + hk * a.sdv.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (key[i] >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      dkp[key[i] * a.sdk.s + tx + 16 * n] = dk[i][n];
      dvp[key[i] * a.sdv.s + tx + 16 * n] = dv[i][n];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
template <typename Kernel, typename A>
int launch(Kernel kernel, int threads, size_t smem, dim3 grid, const A& a, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// bytes of the bf16 backward kernels' staged tiles: row-major [64][D + kPad]
// and transposed [D][64 + kPad]
template <int D>
size_t tile_bytes(int row_tiles, int col_tiles) {
  return (size_t)(row_tiles * kTile * (D + kPad) + col_tiles * D * (kTile + kPad)) *
         sizeof(bf16);
}

// bytes of the fp32 kernels' staged [rows][D + 1] tiles and [p_rows][65] p / ds tiles
size_t f32_bytes(int D, int rows, int p_rows) {
  return (size_t)(rows * (D + 1) + p_rows * kLdp) * sizeof(float);
}

Mat mat(const long long* s, int i) { return Mat{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename T>
Args<T> base_args(const void* q, const void* k, const void* v, const long long* strides,
                  int H, int KVH, int S, int causal, float scale, const void* seg) {
  Args<T> a = {};
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.seg = (const int*)seg;
  a.sq = mat(strides, 0); a.sk = mat(strides, 1); a.sv = mat(strides, 2);
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.causal = causal;
  a.scale = scale;
  return a;
}

// D = 128 (Llama-3-8B) or 256; other head dims are ROADMAP Queue 3
bool bad_shape(int B, int H, int KVH, int S, int D) {
  return B < 1 || B > 65535 || S < 1 || KVH < 1 || H % KVH != 0 || H > 65535 ||
         (D != 128 && D != 256);
}

// The bf16 forward: tensor maps of q, k, v (boxes of 128 query / BN key
// rows) and out (64 rows, one warpgroup's store), then the launch.
template <int D, int BN>
int run_fwd_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                  const void* seg, const long long* st, int B, int H, int KVH, int S,
                  int causal, float scale, void* stream) {
  constexpr int NCH = D / 64, STAGES = 2;
  FwdParams p;
  // st: (batch, head, seq) element strides of q, k, v, out
  int err = encode_bshd(&p.q, q, B, S, H, D, st[0], st[2], st[1], 128);
  if (err == 0) err = encode_bshd(&p.k, k, B, S, KVH, D, st[3], st[5], st[4], BN);
  if (err == 0) err = encode_bshd(&p.v, v, B, S, KVH, D, st[6], st[8], st[7], BN);
  if (err == 0) err = encode_bshd(&p.o, out, B, S, H, D, st[9], st[11], st[10], 64);
  if (err != 0) return err;
  p.lse = (float*)lse;
  p.seg = (const int*)seg;
  p.H = H;
  p.KVH = KVH;
  p.S = S;
  p.causal = causal;
  p.scale = scale;
  const size_t smem = (size_t)NCH * 128 * 128 + (size_t)2 * STAGES * NCH * BN * 128 +
                      STAGES * BN * sizeof(int) + (2 * STAGES + 1) * sizeof(uint64_t) + 1024;
  auto kernel = flash_fwd_kernel<D, BN>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((S + 127) / 128, H, B), 288, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int run_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse,
                const void* seg, const long long* strides, int B, int H, int KVH, int S,
                int causal, float scale, void* stream) {
  Args<float> a = base_args<float>(q, k, v, strides, H, KVH, S, causal, scale, seg);
  a.out = (float*)out;
  a.lse = (float*)lse;
  a.so = mat(strides, 3);
  return launch(flash_fwd_f32_kernel<D>, kF32Threads,
                f32_bytes(D, kBlock + 2 * kTile, kBlock) + kTile * sizeof(int),
                dim3((S + kBlock - 1) / kBlock, H, B), a, stream);
}

// dK/dV: the bf16 mma.sync kernel (at D = 256 its two [64 keys][256] fp32
// accumulators spill to local memory), the fp32 FFMA kernel with 64 keys a
// block at D = 128 and 32 at D = 256 (shared memory)
template <typename T, int D>
int run_dkdv(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* seg, void* dk, void* dv,
             const long long* strides, int B, int H, int KVH, int S, int causal,
             float scale, void* stream) {
  Args<T> a = base_args<T>(q, k, v, strides, H, KVH, S, causal, scale, seg);
  a.dout = (const T*)dout;
  a.lse = (float*)lse;
  a.delta = (const float*)delta;
  a.dk = (T*)dk;
  a.dv = (T*)dv;
  a.sdo = mat(strides, 3); a.sdk = mat(strides, 4); a.sdv = mat(strides, 5);
  const size_t extra = 2 * kTile * sizeof(float) + kTile * sizeof(int);
  if constexpr (std::is_same<T, float>::value) {
    constexpr int BR = D == 128 ? 64 : 32;
    return launch(flash_bwd_dkdv_f32_kernel<D, BR>, kF32Threads,
                  f32_bytes(D, 2 * BR + 2 * kTile, 2 * BR) + extra,
                  dim3((S + BR - 1) / BR, KVH, B), a, stream);
  } else {
    return launch(flash_bwd_dkdv_kernel<D>, kThreads, tile_bytes<D>(4, 2) + extra,
                  dim3((S + kBlock - 1) / kBlock, KVH, B), a, stream);
  }
}

// dQ: as dK/dV, with 32 query rows a block for the fp32 kernel at D = 256
template <typename T, int D>
int run_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, const void* seg, void* dq, const long long* strides, int B,
           int H, int KVH, int S, int causal, float scale, void* stream) {
  Args<T> a = base_args<T>(q, k, v, strides, H, KVH, S, causal, scale, seg);
  a.dout = (const T*)dout;
  a.lse = (float*)lse;
  a.delta = (const float*)delta;
  a.dq = (T*)dq;
  a.sdo = mat(strides, 3); a.sdq = mat(strides, 4);
  if constexpr (std::is_same<T, float>::value) {
    constexpr int BR = D == 128 ? 64 : 32;
    return launch(flash_bwd_dq_f32_kernel<D, BR>, kF32Threads,
                  f32_bytes(D, 2 * BR + 2 * kTile, BR) + kTile * sizeof(int),
                  dim3((S + BR - 1) / BR, H, B), a, stream);
  } else {
    return launch(flash_bwd_dq_kernel<D>, kThreads, tile_bytes<D>(4, 1) + kTile * sizeof(int),
                  dim3((S + kBlock - 1) / kBlock, H, B), a, stream);
  }
}

}  // namespace

extern "C" {

// q [B, H, S, D], k/v [B, KVH, S, D], all bf16 (fp32 == 0) or all fp32
// (fp32 == 1), unit stride over D, 16-byte aligned; `strides` holds (batch,
// head, seq) element strides of q, k, v, out. out has q's shape and dtype; lse
// is a contiguous [B, H, S] fp32 output; seg is a contiguous [B, S] int32
// array or null. D is 128 (every Llama-family model here) or 256.
int slime_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                    const void* seg, const long long* strides, int B, int H, int KVH,
                    int S, int D, int fp32, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S, D)) return (int)cudaErrorInvalidValue;
  if (fp32)
    return D == 128 ? run_fwd_f32<128>(q, k, v, out, lse, seg, strides, B, H, KVH, S, causal,
                                       scale, stream)
                    : run_fwd_f32<256>(q, k, v, out, lse, seg, strides, B, H, KVH, S, causal,
                                       scale, stream);
  return D == 128 ? run_fwd_wgmma<128, 128>(q, k, v, out, lse, seg, strides, B, H, KVH, S,
                                            causal, scale, stream)
                  : run_fwd_wgmma<256, 64>(q, k, v, out, lse, seg, strides, B, H, KVH, S,
                                           causal, scale, stream);
}

// dk/dv [B, KVH, S, D] in the inputs' dtype from q, k, v, do (strides of q,
// k, v, do, dk, dv in that order), lse and delta contiguous [B, H, S] fp32.
int slime_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* seg, void* dk,
                         void* dv, const long long* strides, int B, int H, int KVH,
                         int S, int D, int fp32, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S, D)) return (int)cudaErrorInvalidValue;
#define SLIME_DKDV(T, DD) run_dkdv<T, DD>(q, k, v, dout, lse, delta, seg, dk, dv, strides, \
                                         B, H, KVH, S, causal, scale, stream)
  if (fp32) return D == 128 ? SLIME_DKDV(float, 128) : SLIME_DKDV(float, 256);
  return D == 128 ? SLIME_DKDV(bf16, 128) : SLIME_DKDV(bf16, 256);
#undef SLIME_DKDV
}

// dq [B, H, S, D] in the inputs' dtype from the same inputs (strides of q,
// k, v, do, dq).
int slime_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* seg, void* dq,
                       const long long* strides, int B, int H, int KVH, int S, int D,
                       int fp32, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S, D)) return (int)cudaErrorInvalidValue;
#define SLIME_DQ(T, DD) run_dq<T, DD>(q, k, v, dout, lse, delta, seg, dq, strides, B, H, KVH, \
                                     S, causal, scale, stream)
  if (fp32) return D == 128 ? SLIME_DQ(float, 128) : SLIME_DQ(float, 256);
  return D == 128 ? SLIME_DQ(bf16, 128) : SLIME_DQ(bf16, 256);
#undef SLIME_DQ
}

}  // extern "C"
