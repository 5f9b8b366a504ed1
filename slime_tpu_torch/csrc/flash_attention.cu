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
// Every kernel also takes fp32 q/k/v/do (the FFMA kernels at the end of this
// file): then p and ds are never rounded, and the outputs are fp32. D is any
// multiple of 128, in both dtypes.
// Rows and keys past S read as zeros (TMA's out-of-bounds fill, bound checks
// in the FFMA kernels), which is what JAX's _zero_tail does for the TPU's
// ragged block padding; keys past S are masked.
//
// Design. What bounds attention at these shapes is tensor-core throughput
// (S = 2048, D = 128: 256 flops per byte of q/k/v read). The TPU kernel's
// grid order (b, i, h, j) and the lse read-modify-write across heads exist
// for Mosaic's VMEM revisit rules; here a block owns one tile and loops. The
// bf16 kernels at D = 128 and 256 share Hopper's shape (hopper_common.cuh): one
// producer warp keeps TMA loads in a 2-stage ring of shared-memory stages with
// full and empty mbarriers, consumer warpgroups run wgmma on them (two in the
// forward, whose producer warp sits in a warpgroup of its own that hands its
// registers to them), and no
// operand is ever copied transposed (the transpose bit of the descriptor reads
// a tile MN-major):
//   - K5 forward: a block owns (128 query rows, q head, batch), 64 rows a
//     warpgroup; the producer streams K and V tiles (128 keys at D = 128, 64 at
//     D = 256); S = Q.K^T is an SS wgmma, the online softmax runs in
//     registers, O += P.V an RS wgmma with P straight from the score
//     accumulator and V MN-major: the main loop of hopper_attention.cuh,
//     which K9 (ring_attention.cu) shares. Causal blocks visit key tiles up
//     to the diagonal only and mask only the diagonal, ragged and segmented
//     tiles; the heavy query tiles launch first; the epilogue stores O by
//     TMA. The softmax does not overlap the products yet (FlashAttention-3's
//     ping-pong is a later version);
//   - K5c dQ: a block owns (128 query rows at D = 128, 64 at D = 256; q head,
//     batch) and keeps Q and dO; the producer streams 64-key tiles of K and V
//     (up to the diagonal when causal). S = Q.K^T and dP = dO.V^T are SS
//     wgmmas issued together, dS is formed in registers, dQ += dS.K is an RS
//     wgmma with K read MN-major. Heavy tiles launch first;
//   - K5b dK/dV: a block owns (64 keys, kv head, batch, 128 columns of dK and
//     dV) with one consumer warpgroup, and keeps K and V; the producer streams
//     64-query tiles of Q and dO, with their lse and delta, over the query
//     heads of the GQA group and, when causal, over query tiles from the
//     diagonal on. S^T = K.Q^T and dP^T = V.dO^T are SS wgmmas, P^T and dS^T
//     are formed in registers, dV += P^T.dO and dK += dS^T.Q are RS wgmmas
//     with dO and Q read MN-major. The group sum runs inside the block, so
//     there is no [B, H, S, D] fp32 scratch and no separate reduction (JAX
//     computes dK/dV per query head in fp32 and sums the group after the
//     kernel, :385-386); the sums stay deterministic. One warpgroup, because
//     a thread of a two-warpgroup block gets 168 registers, and the two
//     64 x 128 accumulators with S^T and dP^T spilled there;
//   - at D = 256 the two warpgroups of K5c own the same 64 rows and split
//     dQ's columns (128 each), and two K5b blocks split dK's and dV's; each
//     forms S and dP over the whole D, so the fp32 accumulators of a thread
//     stay those of D = 128;
//   - the backward kernels write dq, dk, dv from registers through strides;
//   - the FFMA kernels (fp32 inputs at every D, bf16 at D > 256) stage 64-row
//     tiles in 128- or 256-column chunks of D and loop over the chunks for
//     the scores; each block owns one chunk of the output's columns;
//   - q/k/v/do are read through (batch, head, sequence) element strides, so
//     llama's [B, S, H, D] projections need no transpose copy; outputs are
//     written through strides too. lse and delta are [B, H, S] fp32.
#include <type_traits>

#include "attention_common.cuh"
#include "hopper_attention.cuh"

namespace {

struct Mat { long long b, h, s; };       // element strides; unit stride over D

// T is bf16 or float: the element type of the FFMA kernels' inputs and outputs
template <typename T>
struct Args {
  const T* q; const T* k; const T* v; const T* dout;
  T* out; T* dq; T* dk; T* dv;
  float* lse; const float* delta; const int* seg;
  Mat sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int H, KVH, S, D, causal;
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

// K5's mask (attend_tiles): keys inside S, rows inside S, causal, segments;
// only tiles on the diagonal, at the ragged end or with segments mask.
struct FwdMask {
  int S, causal, row0, row1, seg0, seg1, qw;
  const int* segk;            // the ring's [kRingStages][BN] key segment ids, or null
  int BN;
  __device__ bool edge(int k0, int k1) const {
    return segk != nullptr || k1 > S || (causal && k1 - 1 > qw);
  }
  __device__ bool ok(int st, int col, int key, bool second) const {
    const int row = second ? row1 : row0;
    bool keep = key < S && row < S;
    if (causal) keep = keep && key <= row;
    if (segk != nullptr) keep = keep && (second ? seg1 : seg0) == segk[st * BN + col];
    return keep;
  }
};

// One block per (128 query rows, q head, batch): consumer warpgroups 0 and 1
// own 64 rows each, warpgroup 2 is the producer (its warp 8 loads) and hands
// its registers to them (kConsumerRegs). BN keys a tile: 128 at D = 128, 64
// at D = 256 so that the O accumulator (D / 2 fp32 a thread) and the scores
// fit in registers.
template <int D, int BN>
__global__ void __launch_bounds__(kAttnThreads, 1) flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  constexpr int BM = 128, NCH = D / 64, STAGES = kRingStages;
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
  if (wg == 2) {                                  // the producer warpgroup; warp 8 loads
    regs_dec<kProducerRegs>();
    if (threadIdx.x >= 288) return;
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

  regs_inc<kConsumerRegs>();
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
  const FwdMask mask{S, p.causal, row0, row1, seg0, seg1, qw, segb != nullptr ? segk : nullptr,
                     BN};
  attend_tiles<D, BN, false>(o, m0, m1, l0, l1, Qw, BM, Ks, Vs, full, empty, ntiles, my_tiles,
                             p.scale * kLog2e, mask);

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
// K5c and K5b (wgmma, TMA, mbarrier ring)
// ---------------------------------------------------------------------------
struct BwdParams {
  CUtensorMap q, k, v, dout;
  const float* lse;
  const float* delta;
  const int* seg;
  bf16* dq; bf16* dk; bf16* dv;
  Mat sdq, sdk, sdv;
  int H, KVH, S, causal;
  float scale;
};

constexpr int kBwdCols = 128;   // output columns a consumer warpgroup owns

// Rows row0 (lanes' g) and row1 = row0 + 8 of a warpgroup's 64 x kBwdCols
// fp32 accumulator, rounded to bf16, into dst (row stride rs) from column c0.
__device__ __forceinline__ void store_acc_rows(const float (&acc)[kBwdCols / 2], bf16* dst,
                                               long long rs, int row0, int S, int c0) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int n8 = 0; n8 < kBwdCols / 8; ++n8) {
    const int col = c0 + 8 * n8 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row < S)
        *reinterpret_cast<__nv_bfloat162*>(dst + row * rs + col) =
            __floats2bfloat162_rn(acc[4 * n8 + 2 * half], acc[4 * n8 + 2 * half + 1]);
    }
  }
}

// K5c. One block per (BM query rows, q head, batch): consumer warpgroups 0
// and 1, warp 8 the producer. D = 128: the warpgroups own 64 rows each (BM =
// 128) and all of dQ's columns; D = 256: both own the same 64 rows (BM = 64)
// and 128 columns each.
template <int D>
__global__ void __launch_bounds__(288, 1) flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  constexpr bool kSplit = D > kBwdCols;
  constexpr int BM = kSplit ? 64 : 128, BN = 64, NCH = D / 64, STAGES = 2;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align1024(smem_raw));    // [NCH][BM][64]
  bf16* dOs = Qs + NCH * BM * 64;                               // [NCH][BM][64]
  bf16* Ks = dOs + NCH * BM * 64;                               // [STAGES][NCH][BN][64]
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
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 256);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {                                                // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * NCH * BM * 128);
      for (int c = 0; c < NCH; ++c) {
        tma_load(Qs + c * BM * 64, &p.q, qbar, 64 * c, q0, h, b);
        tma_load(dOs + c * BM * 64, &p.dout, qbar, 64 * c, q0, h, b);
      }
    }
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES, k0 = j * BN;
      mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
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
  const int qw = q0 + (kSplit ? 0 : 64 * wg);                  // this warpgroup's first row
  const int row0 = qw + 16 * warp + g, row1 = row0 + 8;
  const int c0 = kSplit ? kBwdCols * wg : 0;                    // its first dQ column
  const int my_tiles = ((p.causal ? min(S, qw + 64) : S) + BN - 1) / BN;
  const long long bh = ((long long)b * p.H + h) * S;
  // lse in log2 units, so that each p is one exp2
  const float lse0 = row0 < S ? p.lse[bh + row0] * kLog2e : 0.f;
  const float lse1 = row1 < S ? p.lse[bh + row1] * kLog2e : 0.f;
  const float dl0 = row0 < S ? p.delta[bh + row0] : 0.f;
  const float dl1 = row1 < S ? p.delta[bh + row1] : 0.f;
  int seg0 = 0, seg1 = 0;
  if (segb != nullptr) {
    seg0 = row0 < S ? segb[row0] : 0;
    seg1 = row1 < S ? segb[row1] : 0;
  }
  const bf16* Qw = Qs + (kSplit ? 0 : 64 * wg * 64);
  const bf16* dOw = dOs + (kSplit ? 0 : 64 * wg * 64);
  const float scale2 = p.scale * kLog2e;
  float dq[kBwdCols / 2];
#pragma unroll
  for (int i = 0; i < kBwdCols / 2; ++i) dq[i] = 0.f;
  mbar_wait(qbar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES, k0 = j * BN;
    mbar_wait(&full[st], (j / STAGES) & 1);
    if (j < my_tiles) {
      const bf16* Kt = Ks + st * NCH * BN * 64;
      float s[BN / 2], dp[BN / 2];
      fence_acc(s);
      fence_acc(dp);
      wgmma_fence();
      ss_issue<D, BN>(s, Qw, BM, Kt);                              // S = Q.K^T
      ss_issue<D, BN>(dp, dOw, BM, Vs + st * NCH * BN * 64);       // dP = dO.V^T
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(s);
      fence_acc(dp);
      const bool edge = segb != nullptr || k0 + BN > S || qw + 64 > S ||
                        (p.causal && k0 + BN - 1 > qw);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        float pr = exp2f(fmaf(s[i], scale2, -((i & 2) ? lse1 : lse0)));
        if (edge) {
          const int key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
          const int row = (i & 2) ? row1 : row0;
          bool ok = key < S && row < S;
          if (p.causal) ok = ok && key <= row;
          if (segb != nullptr)
            ok = ok && ((i & 2) ? seg1 : seg0) == segk[st * BN + key - k0];
          if (!ok) pr = 0.f;
        }
        s[i] = pr * (dp[i] - ((i & 2) ? dl1 : dl0)) * p.scale;     // ds
      }
      uint32_t dsa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a_frag(dsa[kk], s, kk);
      pv_product<kBwdCols, BN>(dq, dsa, Kt + (c0 / 64) * BN * 64);   // dQ += dS.K
    }
    mbar_arrive(&empty[st]);
  }
  store_acc_rows(dq, p.dq + b * p.sdq.b + h * p.sdq.h, p.sdq.s, row0, S, c0);
}

// K5b. One block per (64 keys, kv head, batch, 128 columns of dK and dV):
// one consumer warpgroup and a producer warp. Five warps leave a thread 255
// registers (the nine of a two-warpgroup block leave 168, since each of the
// SM's four schedulers holds at most 16384 registers for its warps): the two
// 64 x 128 fp32 accumulators and S^T, dP^T fit without spilling. At D = 256
// two blocks own the two column halves of the same keys, each forming S^T
// and dP^T over the whole D.
template <int D>
__global__ void __launch_bounds__(160, 1) flash_bwd_dkdv_kernel(
    const __grid_constant__ BwdParams p) {
  constexpr int KB = 64, BQ = 64, NCH = D / 64, NC = D / kBwdCols, STAGES = 2;
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(align1024(smem_raw));    // [NCH][KB][64]
  bf16* Vs = Ks + NCH * KB * 64;                                // [NCH][KB][64]
  bf16* Qs = Vs + NCH * KB * 64;                                // [STAGES][NCH][BQ][64]
  bf16* dOs = Qs + STAGES * NCH * BQ * 64;                      // [STAGES][NCH][BQ][64]
  float* lse_s = reinterpret_cast<float*>(dOs + STAGES * NCH * BQ * 64);  // [STAGES][BQ]
  float* dl_s = lse_s + STAGES * BQ;                            // [STAGES][BQ]
  int* segq = reinterpret_cast<int*>(dl_s + STAGES * BQ);       // [STAGES][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(segq + STAGES * BQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kbar = empty + STAGES;

  const int S = p.S;
  const int k0 = blockIdx.x * KB;                               // causal: low keys are heavy
  const int hk = blockIdx.y, b = blockIdx.z / NC;
  const int c0 = kBwdCols * (blockIdx.z % NC);                  // the block's first column
  const int group = p.H / p.KVH;
  const int first = p.causal ? k0 / BQ : 0;
  const int per_head = (S + BQ - 1) / BQ - first, ntiles = group * per_head;
  const int* segb = p.seg != nullptr ? p.seg + (long long)b * S : nullptr;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 128);
    }
    mbar_init(kbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {                                     // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_expect_tx(kbar, 2 * NCH * KB * 128);
      for (int c = 0; c < NCH; ++c) {
        tma_load(Ks + c * KB * 64, &p.k, kbar, 64 * c, k0, hk, b);
        tma_load(Vs + c * KB * 64, &p.v, kbar, 64 * c, k0, hk, b);
      }
    }
    for (int j = 0; j < ntiles; ++j) {
      const int st = j % STAGES, h = hk * group + j / per_head;
      const int q0 = (first + j % per_head) * BQ;
      mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
      // the tile's lse (log2 units), delta and segment ids, published by
      // each lane's arrive
      const long long bh = ((long long)b * p.H + h) * S;
      for (int i = lane; i < BQ; i += 32) {
        const int r = q0 + i;
        lse_s[st * BQ + i] = r < S ? p.lse[bh + r] * kLog2e : 0.f;
        dl_s[st * BQ + i] = r < S ? p.delta[bh + r] : 0.f;
        if (segb != nullptr) segq[st * BQ + i] = r < S ? segb[r] : 0;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * NCH * BQ * 128);
        for (int c = 0; c < NCH; ++c) {
          tma_load(Qs + (st * NCH + c) * BQ * 64, &p.q, &full[st], 64 * c, q0, h, b);
          tma_load(dOs + (st * NCH + c) * BQ * 64, &p.dout, &full[st], 64 * c, q0, h, b);
        }
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  const int t = threadIdx.x, warp = t >> 5, g = (t & 31) >> 2, tq = t & 3;
  const int key0 = k0 + 16 * warp + g, key1 = key0 + 8;
  int segk0 = 0, segk1 = 0;
  if (segb != nullptr) {
    segk0 = key0 < S ? segb[key0] : 0;
    segk1 = key1 < S ? segb[key1] : 0;
  }
  const float scale2 = p.scale * kLog2e;
  float dk[kBwdCols / 2], dv[kBwdCols / 2];
#pragma unroll
  for (int i = 0; i < kBwdCols / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kbar, 0);

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES, q0 = (first + j % per_head) * BQ;
    mbar_wait(&full[st], (j / STAGES) & 1);
    // causal: a tile whose queries all precede the block's keys adds nothing
    // (only the first tile of a head can, when k0 is not a tile edge)
    if (!p.causal || q0 + BQ > k0) {
      const bf16* Qt = Qs + st * NCH * BQ * 64;
      const bf16* dOt = dOs + st * NCH * BQ * 64;
      const float* ls = lse_s + st * BQ;
      const float* dls = dl_s + st * BQ;
      float sT[BQ / 2], dpT[BQ / 2];                            // keys x queries
      fence_acc(sT);
      fence_acc(dpT);
      wgmma_fence();
      ss_issue<D, BQ>(sT, Ks, KB, Qt);                              // S^T = K.Q^T
      ss_issue<D, BQ>(dpT, Vs, KB, dOt);                            // dP^T = V.dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sT);
      fence_acc(dpT);
      const bool edge = segb != nullptr || q0 + BQ > S || k0 + KB > S ||
                        (p.causal && q0 < k0 + KB);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int qc = 8 * (e >> 2) + 2 * tq + (e & 1);        // query within the tile
        float pr = exp2f(fmaf(sT[e], scale2, -ls[qc]));
        if (edge) {
          const int key = (e & 2) ? key1 : key0, query = q0 + qc;
          bool ok = query < S && key < S;
          if (p.causal) ok = ok && key <= query;
          if (segb != nullptr) ok = ok && segq[st * BQ + qc] == ((e & 2) ? segk1 : segk0);
          if (!ok) pr = 0.f;
        }
        sT[e] = pr;
        dpT[e] = pr * (dpT[e] - dls[qc]) * p.scale;            // ds^T
      }
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        acc_to_a_frag(pa[kk], sT, kk);
        acc_to_a_frag(dsa[kk], dpT, kk);
      }
      fence_acc(dv);
      fence_acc(dk);
      wgmma_fence();
      rs_issue<kBwdCols, BQ>(dv, pa, dOt + (c0 / 64) * BQ * 64);    // dV += P^T.dO
      rs_issue<kBwdCols, BQ>(dk, dsa, Qt + (c0 / 64) * BQ * 64);    // dK += dS^T.Q
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(dv);
      fence_acc(dk);
    }
    mbar_arrive(&empty[st]);
  }
  store_acc_rows(dk, p.dk + b * p.sdk.b + hk * p.sdk.h, p.sdk.s, key0, S, c0);
  store_acc_rows(dv, p.dv + b * p.sdv.b + hk * p.sdv.h, p.sdv.s, key0, S, c0);
}

// ---------------------------------------------------------------------------
// FFMA kernels: fp32 inputs at every D, bf16 inputs at D > 256
// ---------------------------------------------------------------------------
// Plain fp32 FMAs (no TF32): what JAX's interpret-mode kernels compute for
// fp32 inputs, and what llama.forward's default fp32 compute dtype sends
// here; for bf16 inputs p and ds are rounded to bf16 before their products,
// as in the wgmma kernels. 256 threads; thread (ty = tid / 16, tx = tid % 16)
// owns rows R ty .. R ty + R - 1 of the block (R = 4 for 64 rows), columns tx
// + 16 c (c < 4) of a 64-wide tile and output columns tx + 16 n (n < DC / 16)
// of the block's chunk. D is staged in chunks of DC (128 or 256) columns
// padded to DC + 1 floats, so the 16 threads reading 16 rows at one depth hit
// 16 distinct banks; the scores sum over the chunks, and a block owns one
// chunk of the output's columns (blockIdx.z = batch x chunks + chunk), so at
// D > DC the scores are formed once per output chunk. The 16 threads of a row
// group are one half-warp, so row reductions are shuffles within it. Shared
// memory holds the operands, so these kernels are bound by its bandwidth (two
// loads per two FMAs in the score loop), not by the 67 TFLOP/s fp32 peak; a
// register-blocked design is for a later version.
constexpr int kF32Threads = 256;
constexpr int kRows = 4;               // block rows per thread
constexpr int kCols = kTile / 16;      // tile columns per thread
constexpr int kLdp = kTile + 1;        // row stride of the [64][64] p / ds tiles

// x as the operand of the second product: rounded to bf16 for bf16 inputs
template <typename T>
__device__ __forceinline__ float operand(float x) {
  if constexpr (std::is_same<T, bf16>::value) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

// Rows [r0, r0 + R) x columns [c0, c0 + DC) of one head's [S, D] matrix (row
// stride rs) into dst [R][DC + 1] as fp32; rows at or past S are 0.
template <int DC, int R = kTile, typename T>
__device__ __forceinline__ void stage_f32(const T* src, long long rs, int r0, int c0, int S,
                                          float* dst) {
  for (int e = threadIdx.x; e < R * DC; e += kF32Threads) {
    const int r = e / DC, c = e % DC;
    dst[r * (DC + 1) + c] = r0 + r < S ? to_f32(src[(long long)(r0 + r) * rs + c0 + c]) : 0.f;
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(const Args<T> a) {
  constexpr int LD = DC + 1, NO = DC / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);              // [kBlock][LD]
  float* Ks = Qs + kBlock * LD;                            // [kTile][LD]
  float* Vs = Ks + kTile * LD;                             // [kTile][LD]
  float* Ps = Vs + kTile * LD;                             // [kBlock][kLdp]
  int* segk = reinterpret_cast<int*>(Ps + kBlock * kLdp);  // [kTile]

  const int S = a.S, nd = a.D / DC;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;   // diagonal-heavy first
  const int h = blockIdx.y, b = blockIdx.z / nd, oc = blockIdx.z % nd;
  const int hk = h / (a.H / a.KVH);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qp = a.q + b * a.sq.b + h * a.sq.h;
  const T* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const T* vp = a.v + b * a.sv.b + hk * a.sv.h;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;

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
    stage_f32<DC>(vp, a.sv.s, k0, oc * DC, S, Vs);
    stage_ids(segk, segb, k0, S);
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
    for (int dc = 0; dc < nd; ++dc) {
      if (dc > 0) __syncthreads();                // the previous chunk is consumed
      if (nd > 1 || j == 0) stage_f32<DC>(qp, a.sq.s, q0, dc * DC, S, Qs);
      stage_f32<DC>(kp, a.sk.s, k0, dc * DC, S, Ks);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
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
        Ps[(ty * kRows + i) * kLdp + tx + 16 * c] = operand<T>(p);
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

  T* op = a.out + b * a.so.b + h * a.so.h + oc * DC;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float lt = sum16(l[i]);
    const float dn = lt == 0.f ? 1.f : lt;
    if (row[i] >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) from_f32(op + row[i] * a.so.s + tx + 16 * n, o[i][n] / dn);
    if (tx == 0 && oc == 0) a.lse[((long long)b * a.H + h) * S + row[i]] = m[i] + logf(dn);
  }
}

template <typename T, int DC, int BR>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(const Args<T> a) {
  constexpr int LD = DC + 1, NO = DC / 16, R = BR / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);              // [BR][LD]
  float* dOs = Qs + BR * LD;                               // [BR][LD]
  float* Ks = dOs + BR * LD;                               // [kTile][LD]
  float* Vs = Ks + kTile * LD;                             // [kTile][LD]
  float* DSs = Vs + kTile * LD;                            // [BR][kLdp]
  int* segk = reinterpret_cast<int*>(DSs + BR * kLdp);     // [kTile]

  const int S = a.S, nd = a.D / DC;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int h = blockIdx.y, b = blockIdx.z / nd, oc = blockIdx.z % nd;
  const int hk = h / (a.H / a.KVH);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qp = a.q + b * a.sq.b + h * a.sq.h;
  const T* dop = a.dout + b * a.sdo.b + h * a.sdo.h;
  const T* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const T* vp = a.v + b * a.sv.b + hk * a.sv.h;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;
  const long long bh = ((long long)b * a.H + h) * S;

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
    stage_ids(segk, segb, k0, S);
    float s[R][kCols], dp[R][kCols];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = dp[i][c] = 0.f;
    for (int dc = 0; dc < nd; ++dc) {
      if (dc > 0) __syncthreads();
      if (nd > 1 || j == 0) {
        stage_f32<DC, BR>(qp, a.sq.s, q0, dc * DC, S, Qs);
        stage_f32<DC, BR>(dop, a.sdo.s, q0, dc * DC, S, dOs);
      }
      stage_f32<DC>(kp, a.sk.s, k0, dc * DC, S, Ks);
      stage_f32<DC>(vp, a.sv.s, k0, dc * DC, S, Vs);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
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
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        const float p = attends(a, row[i], k0 + col, segr[i], segk[col])
                            ? expf(s[i][c] * a.scale - lse[i]) : 0.f;
        DSs[(ty * R + i) * kLdp + col] = operand<T>(p * (dp[i][c] - dl[i]) * a.scale);
      }
    if (nd > 1) {                                 // K's chunk of the block's dQ columns
      __syncthreads();
      stage_f32<DC>(kp, a.sk.s, k0, oc * DC, S, Ks);
      __syncthreads();
    } else {
      __syncwarp();
    }
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

  T* dqp = a.dq + b * a.sdq.b + h * a.sdq.h + oc * DC;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (row[i] >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) from_f32(dqp + row[i] * a.sdq.s + tx + 16 * n, dq[i][n]);
  }
}

template <typename T, int DC, int BR>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkdv_f32_kernel(const Args<T> a) {
  constexpr int LD = DC + 1, NO = DC / 16, R = BR / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);              // [BR][LD]
  float* Vs = Ks + BR * LD;                                // [BR][LD]
  float* Qs = Vs + BR * LD;                                // [kTile][LD]
  float* dOs = Qs + kTile * LD;                            // [kTile][LD]
  float* PT = dOs + kTile * LD;                            // [BR][kLdp]: p^T
  float* DST = PT + BR * kLdp;                             // [BR][kLdp]: ds^T
  float* lse_s = DST + BR * kLdp;                          // [kTile]
  float* dl_s = lse_s + kTile;                             // [kTile]
  int* segq = reinterpret_cast<int*>(dl_s + kTile);        // [kTile]

  const int S = a.S, nd = a.D / DC;
  const int k0 = blockIdx.x * BR;                          // causal: low keys are heavy
  const int hk = blockIdx.y, b = blockIdx.z / nd, oc = blockIdx.z % nd;
  const int group = a.H / a.KVH;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const T* vp = a.v + b * a.sv.b + hk * a.sv.h;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;
  if (nd == 1) {
    stage_f32<DC, BR>(kp, a.sk.s, k0, 0, S, Ks);
    stage_f32<DC, BR>(vp, a.sv.s, k0, 0, S, Vs);
  }
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
    const T* qp = a.q + b * a.sq.b + h * a.sq.h;
    const T* dop = a.dout + b * a.sdo.b + h * a.sdo.h;
    const long long bh = ((long long)b * a.H + h) * S;
    for (int qi = first; qi < nq; ++qi) {
      const int q0 = qi * kTile;
      __syncthreads();
      if (threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < S ? a.lse[bh + r] : 0.f;
        dl_s[threadIdx.x] = r < S ? a.delta[bh + r] : 0.f;
      }
      stage_ids(segq, segb, q0, S);
      float st[R][kCols], dpt[R][kCols];   // S^T and dP^T: keys x queries
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) st[i][c] = dpt[i][c] = 0.f;
      for (int dc = 0; dc < nd; ++dc) {
        if (dc > 0) __syncthreads();
        if (nd > 1) {
          stage_f32<DC, BR>(kp, a.sk.s, k0, dc * DC, S, Ks);
          stage_f32<DC, BR>(vp, a.sv.s, k0, dc * DC, S, Vs);
        }
        stage_f32<DC>(qp, a.sq.s, q0, dc * DC, S, Qs);
        stage_f32<DC>(dop, a.sdo.s, q0, dc * DC, S, dOs);
        __syncthreads();
#pragma unroll 4
        for (int d = 0; d < DC; ++d) {
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
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = tx + 16 * c;              // query within the tile
          const float p = attends(a, q0 + col, key[i], segq[col], segr[i])
                              ? expf(st[i][c] * a.scale - lse_s[col]) : 0.f;
          PT[(ty * R + i) * kLdp + col] = operand<T>(p);
          DST[(ty * R + i) * kLdp + col] = operand<T>(p * (dpt[i][c] - dl_s[col]) * a.scale);
        }
      if (nd > 1) {                                 // Q's and dO's chunk of the block's columns
        __syncthreads();
        stage_f32<DC>(qp, a.sq.s, q0, oc * DC, S, Qs);
        stage_f32<DC>(dop, a.sdo.s, q0, oc * DC, S, dOs);
        __syncthreads();
      } else {
        __syncwarp();
      }
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

  T* dkp = a.dk + b * a.sdk.b + hk * a.sdk.h + oc * DC;
  T* dvp = a.dv + b * a.sdv.b + hk * a.sdv.h + oc * DC;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (key[i] >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      from_f32(dkp + key[i] * a.sdk.s + tx + 16 * n, dk[i][n]);
      from_f32(dvp + key[i] * a.sdv.s + tx + 16 * n, dv[i][n]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
template <typename Kernel, typename P>
int launch(Kernel kernel, int threads, size_t smem, dim3 grid, const P& p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// bytes of the FFMA kernels' staged [rows][DC + 1] tiles and [p_rows][65] p / ds tiles
size_t f32_bytes(int DC, int rows, int p_rows) {
  return (size_t)(rows * (DC + 1) + p_rows * kLdp) * sizeof(float);
}

Mat mat(const long long* s, int i) { return Mat{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename T>
Args<T> base_args(const void* q, const void* k, const void* v, const long long* strides,
                  int H, int KVH, int S, int D, int causal, float scale, const void* seg) {
  Args<T> a = {};
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.seg = (const int*)seg;
  a.sq = mat(strides, 0); a.sk = mat(strides, 1); a.sv = mat(strides, 2);
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.D = D;
  a.causal = causal;
  a.scale = scale;
  return a;
}

// D: any multiple of 128 (Llama-3-8B has 128); the FFMA kernels' z grid
// dimension holds batch x D-chunks
bool bad_shape(int B, int H, int KVH, int S, int D) {
  return B < 1 || S < 1 || KVH < 1 || H % KVH != 0 || H > 65535 || D < 128 || D % 128 != 0 ||
         (long long)B * (D / 128) > 65535;
}

// The FFMA kernels stage D in chunks of 256 columns where D allows, else 128.
bool wide_chunks(int D) { return D % 256 == 0; }

// The bf16 forward: tensor maps of q, k, v (boxes of 128 query / BN key
// rows) and out (64 rows, one warpgroup's store), then the launch.
template <int D, int BN>
int run_fwd_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                  const void* seg, const long long* st, int B, int H, int KVH, int S,
                  int causal, float scale, void* stream) {
  constexpr int NCH = D / 64, STAGES = kRingStages;
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
  return launch(flash_fwd_kernel<D, BN>, kAttnThreads, smem, dim3((S + 127) / 128, H, B), p, stream);
}

// The tensor maps of the backward kernels' inputs (boxes of q_rows query and
// k_rows key rows; st: (batch, head, seq) element strides of q, k, v, do).
int bwd_maps(BwdParams& p, const void* q, const void* k, const void* v, const void* dout,
             const long long* st, int B, int H, int KVH, int S, int D, int q_rows,
             int k_rows) {
  int err = encode_bshd(&p.q, q, B, S, H, D, st[0], st[2], st[1], q_rows);
  if (err == 0) err = encode_bshd(&p.k, k, B, S, KVH, D, st[3], st[5], st[4], k_rows);
  if (err == 0) err = encode_bshd(&p.v, v, B, S, KVH, D, st[6], st[8], st[7], k_rows);
  if (err == 0) err = encode_bshd(&p.dout, dout, B, S, H, D, st[9], st[11], st[10], q_rows);
  return err;
}

template <int D>
int run_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* seg, void* dq,
                 const long long* st, int B, int H, int KVH, int S, int causal, float scale,
                 void* stream) {
  constexpr int BM = D > kBwdCols ? 64 : 128, BN = 64, NCH = D / 64, STAGES = 2;
  BwdParams p = {};
  const int err = bwd_maps(p, q, k, v, dout, st, B, H, KVH, S, D, BM, BN);
  if (err != 0) return err;
  p.lse = (const float*)lse;
  p.delta = (const float*)delta;
  p.seg = (const int*)seg;
  p.dq = (bf16*)dq;
  p.sdq = mat(st, 4);
  p.H = H;
  p.KVH = KVH;
  p.S = S;
  p.causal = causal;
  p.scale = scale;
  const size_t smem = (size_t)2 * NCH * BM * 128 + (size_t)2 * STAGES * NCH * BN * 128 +
                      STAGES * BN * sizeof(int) + (2 * STAGES + 1) * sizeof(uint64_t) + 1024;
  return launch(flash_bwd_dq_kernel<D>, 288, smem, dim3((S + BM - 1) / BM, H, B), p, stream);
}

template <int D>
int run_dkdv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                   const long long* st, int B, int H, int KVH, int S, int causal, float scale,
                   void* stream) {
  constexpr int KB = 64, BQ = 64, NCH = D / 64, STAGES = 2;
  BwdParams p = {};
  const int err = bwd_maps(p, q, k, v, dout, st, B, H, KVH, S, D, BQ, KB);
  if (err != 0) return err;
  p.lse = (const float*)lse;
  p.delta = (const float*)delta;
  p.seg = (const int*)seg;
  p.dk = (bf16*)dk;
  p.dv = (bf16*)dv;
  p.sdk = mat(st, 4);
  p.sdv = mat(st, 5);
  p.H = H;
  p.KVH = KVH;
  p.S = S;
  p.causal = causal;
  p.scale = scale;
  const size_t smem = (size_t)2 * NCH * KB * 128 + (size_t)2 * STAGES * NCH * BQ * 128 +
                      3 * STAGES * BQ * sizeof(float) + (2 * STAGES + 1) * sizeof(uint64_t) +
                      1024;
  return launch(flash_bwd_dkdv_kernel<D>, 160, smem,
                dim3((S + KB - 1) / KB, KVH, B * (D / kBwdCols)), p, stream);
}

template <typename T, int DC>
int run_fwd_ffma(const void* q, const void* k, const void* v, void* out, void* lse,
                 const void* seg, const long long* strides, int B, int H, int KVH, int S, int D,
                 int causal, float scale, void* stream) {
  Args<T> a = base_args<T>(q, k, v, strides, H, KVH, S, D, causal, scale, seg);
  a.out = (T*)out;
  a.lse = (float*)lse;
  a.so = mat(strides, 3);
  return launch(flash_fwd_f32_kernel<T, DC>, kF32Threads,
                f32_bytes(DC, kBlock + 2 * kTile, kBlock) + kTile * sizeof(int),
                dim3((S + kBlock - 1) / kBlock, H, B * (D / DC)), a, stream);
}

// dK/dV on the FFMA units: 64 keys a block with 128-column chunks, 32 with 256
template <typename T, int DC>
int run_dkdv_ffma(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                  const long long* strides, int B, int H, int KVH, int S, int D, int causal,
                  float scale, void* stream) {
  constexpr int BR = DC == 128 ? 64 : 32;
  Args<T> a = base_args<T>(q, k, v, strides, H, KVH, S, D, causal, scale, seg);
  a.dout = (const T*)dout;
  a.lse = (float*)lse;
  a.delta = (const float*)delta;
  a.dk = (T*)dk;
  a.dv = (T*)dv;
  a.sdo = mat(strides, 3); a.sdk = mat(strides, 4); a.sdv = mat(strides, 5);
  const size_t extra = 2 * kTile * sizeof(float) + kTile * sizeof(int);
  return launch(flash_bwd_dkdv_f32_kernel<T, DC, BR>, kF32Threads,
                f32_bytes(DC, 2 * BR + 2 * kTile, 2 * BR) + extra,
                dim3((S + BR - 1) / BR, KVH, B * (D / DC)), a, stream);
}

// dQ on the FFMA units: as dK/dV
template <typename T, int DC>
int run_dq_ffma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, const void* seg, void* dq, const long long* strides, int B,
                int H, int KVH, int S, int D, int causal, float scale, void* stream) {
  constexpr int BR = DC == 128 ? 64 : 32;
  Args<T> a = base_args<T>(q, k, v, strides, H, KVH, S, D, causal, scale, seg);
  a.dout = (const T*)dout;
  a.lse = (float*)lse;
  a.delta = (const float*)delta;
  a.dq = (T*)dq;
  a.sdo = mat(strides, 3); a.sdq = mat(strides, 4);
  return launch(flash_bwd_dq_f32_kernel<T, DC, BR>, kF32Threads,
                f32_bytes(DC, 2 * BR + 2 * kTile, BR) + kTile * sizeof(int),
                dim3((S + BR - 1) / BR, H, B * (D / DC)), a, stream);
}

}  // namespace

extern "C" {

// q [B, H, S, D], k/v [B, KVH, S, D], all bf16 (fp32 == 0) or all fp32
// (fp32 == 1), unit stride over D, 16-byte aligned; `strides` holds (batch,
// head, seq) element strides of q, k, v, out. out has q's shape and dtype; lse
// is a contiguous [B, H, S] fp32 output; seg is a contiguous [B, S] int32
// array or null. D is a multiple of 128: bf16 at D = 128 and 256 takes the
// wgmma kernel, fp32 and bf16 at D > 256 the FFMA one.
int slime_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                    const void* seg, const long long* strides, int B, int H, int KVH,
                    int S, int D, int fp32, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S, D)) return (int)cudaErrorInvalidValue;
#define SLIME_FWD(T, DC) run_fwd_ffma<T, DC>(q, k, v, out, lse, seg, strides, B, H, KVH, S, D, \
                                             causal, scale, stream)
  if (fp32) return wide_chunks(D) ? SLIME_FWD(float, 256) : SLIME_FWD(float, 128);
  if (D == 128)
    return run_fwd_wgmma<128, 128>(q, k, v, out, lse, seg, strides, B, H, KVH, S, causal,
                                   scale, stream);
  if (D == 256)
    return run_fwd_wgmma<256, 64>(q, k, v, out, lse, seg, strides, B, H, KVH, S, causal,
                                  scale, stream);
  return wide_chunks(D) ? SLIME_FWD(bf16, 256) : SLIME_FWD(bf16, 128);
#undef SLIME_FWD
}

// dk/dv [B, KVH, S, D] in the inputs' dtype from q, k, v, do (strides of q,
// k, v, do, dk, dv in that order), lse and delta contiguous [B, H, S] fp32.
int slime_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* seg, void* dk,
                         void* dv, const long long* strides, int B, int H, int KVH,
                         int S, int D, int fp32, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S, D)) return (int)cudaErrorInvalidValue;
#define SLIME_DKDV(T, DC) run_dkdv_ffma<T, DC>(q, k, v, dout, lse, delta, seg, dk, dv, strides, \
                                               B, H, KVH, S, D, causal, scale, stream)
#define SLIME_DKDV_WGMMA(DD) run_dkdv_wgmma<DD>(q, k, v, dout, lse, delta, seg, dk, dv,      \
                                                 strides, B, H, KVH, S, causal, scale, stream)
  if (fp32) return wide_chunks(D) ? SLIME_DKDV(float, 256) : SLIME_DKDV(float, 128);
  if (D == 128) return SLIME_DKDV_WGMMA(128);
  if (D == 256) return SLIME_DKDV_WGMMA(256);
  return wide_chunks(D) ? SLIME_DKDV(bf16, 256) : SLIME_DKDV(bf16, 128);
#undef SLIME_DKDV
#undef SLIME_DKDV_WGMMA
}

// dq [B, H, S, D] in the inputs' dtype from the same inputs (strides of q,
// k, v, do, dq).
int slime_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* seg, void* dq,
                       const long long* strides, int B, int H, int KVH, int S, int D,
                       int fp32, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S, D)) return (int)cudaErrorInvalidValue;
#define SLIME_DQ(T, DC) run_dq_ffma<T, DC>(q, k, v, dout, lse, delta, seg, dq, strides, B, H, \
                                           KVH, S, D, causal, scale, stream)
  if (fp32) return wide_chunks(D) ? SLIME_DQ(float, 256) : SLIME_DQ(float, 128);
  if (D == 128)
    return run_dq_wgmma<128>(q, k, v, dout, lse, delta, seg, dq, strides, B, H, KVH, S,
                             causal, scale, stream);
  if (D == 256)
    return run_dq_wgmma<256>(q, k, v, dout, lse, delta, seg, dq, strides, B, H, KVH, S,
                             causal, scale, stream);
  return wide_chunks(D) ? SLIME_DQ(bf16, 256) : SLIME_DQ(bf16, 128);
#undef SLIME_DQ
}

}  // extern "C"
