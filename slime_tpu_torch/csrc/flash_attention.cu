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
// are fp32. D is 128 in both.
// Rows and keys past S are bound-checked on load (zero-filled), which is what
// JAX's _zero_tail does for the TPU's ragged block padding.
//
// Design. What bounds attention at these shapes is tensor-core throughput
// (S = 2048, D = 128: 256 flops per byte of q/k/v read). The TPU kernel's
// grid order (b, i, h, j) and the lse read-modify-write across heads exist
// for Mosaic's VMEM revisit rules; here a block owns one tile and loops:
//   - forward and dQ: a block owns (64 query rows, head, batch) and loops over
//     key tiles of 64 (causal: only up to the diagonal); heavy tiles launch
//     first;
//   - dK/dV: a block owns (64 keys, kv head, batch) and loops over the query
//     heads of its GQA group and over query tiles (causal: from the diagonal
//     on). The group sum runs inside the block, so there is no [B, H, S, D]
//     fp32 scratch and no separate reduction (JAX computes dK/dV per query
//     head in fp32 and sums the group after the kernel, :385-386);
//   - 4 warps of 16 rows each; every product is an mma.sync m16n8k16 bf16
//     tile with fp32 accumulation (wgmma and TMA are for a later version).
//     Q.K^T reuses the score accumulators as the A operand of P.V, as
//     FlashAttention-2 does;
//   - tiles are staged in shared memory with rows padded by 8 elements (16 B),
//     so the fragment loads of a warp hit 32 distinct banks; operands that a
//     product needs transposed (V for P.V, K for dS.K, Q and dO for the dK/dV
//     products) are also stored transposed while loading;
//   - q/k/v/do are read through (batch, head, sequence) element strides, so
//     llama's [B, S, H, D] projections need no transpose copy; outputs are
//     written through strides too. lse and delta are [B, H, S] fp32.
#include <type_traits>

#include "attention_common.cuh"

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
// K5: forward
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args<bf16> a) {
  constexpr int LD = D + kPad, LDT = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);         // [kBlock][LD]
  bf16* Ks = Qs + kBlock * LD;                      // [kTile][LD]
  bf16* Vt = Ks + kTile * LD;                       // [D][LDT]
  int* segk = reinterpret_cast<int*>(Vt + D * LDT); // [kTile]

  const int S = a.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;   // diagonal-heavy first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.KVH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;

  const bf16* qp = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const bf16* vp = a.v + b * a.sv.b + hk * a.sv.h;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;

  stage<D>(qp, a.sq.s, q0, S, Qs, nullptr);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qa[kk], Qs + wr * LD + kk * 16, LD, g, t);
  int seg0 = 0, seg1 = 0;
  if (segb != nullptr) {
    seg0 = row0 < S ? segb[row0] : 0;
    seg1 = row1 < S ? segb[row1] : 0;
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int kend = a.causal ? min(S, q0 + kBlock) : S;
  const int ntiles = (kend + kTile - 1) / kTile;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();                              // the previous tile is consumed
    stage<D>(kp, a.sk.s, k0, S, Ks, nullptr);
    stage<D>(vp, a.sv.s, k0, S, nullptr, Vt);
    stage_ids(segk, segb, k0, S);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, Ks + n * 8 * LD + kk * 16, LD, g, t);
        mma16816(s[n], qa[kk], b0, b1);
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = n * 8 + 2 * t + (i & 1);
        const bool ok = i < 2 ? attends(a, row0, k0 + col, seg0, segk[col])
                              : attends(a, row1, k0 + col, seg1, segk[col]);
        const float x = ok ? s[n][i] * a.scale : kNegInf;
        s[n][i] = x;
        if (i < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[n][i] - (i < 2 ? mn0 : mn1));
        s[n][i] = p;
        if (i < 2) ls0 += p; else ls1 += p;
      }
    }
    // per-lane partial row sums; the quad adds them up at the end
    l0 = l0 * al0 + ls0;
    l1 = l1 * al1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= al0; o[n][1] *= al0;
      o[n][2] *= al1; o[n][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, Vt + n * 8 * LDT + kk * 16, LDT, g, t);
        mma16816(o[n], pa, b0, b1);
      }
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
  bf16* op = a.out + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(op + row0 * a.so.s + col) =
          __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(op + row1 * a.so.s + col) =
          __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
  if (t == 0) {
    float* lp = a.lse + ((long long)b * a.H + h) * S;
    if (row0 < S) lp[row0] = m0 + logf(d0);
    if (row1 < S) lp[row1] = m1 + logf(d1);
  }
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

// Rows [r0, r0 + 64) of one head's [S, D] fp32 matrix (row stride rs) into
// dst [64][D + 1]; rows at or past S are 0.
template <int D>
__device__ __forceinline__ void stage_f32(const float* src, long long rs, int r0, int S,
                                          float* dst) {
  for (int e = threadIdx.x; e < kTile * D; e += kF32Threads) {
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

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(const Args<float> a) {
  constexpr int LD = D + 1, NO = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);              // [kBlock][LD]
  float* dOs = Qs + kBlock * LD;                           // [kBlock][LD]
  float* Ks = dOs + kBlock * LD;                           // [kTile][LD]
  float* Vs = Ks + kTile * LD;                             // [kTile][LD]
  float* DSs = Vs + kTile * LD;                            // [kBlock][kLdp]
  int* segk = reinterpret_cast<int*>(DSs + kBlock * kLdp); // [kTile]

  const int S = a.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.KVH);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* kp = a.k + b * a.sk.b + hk * a.sk.h;
  const float* vp = a.v + b * a.sv.b + hk * a.sv.h;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;
  const long long bh = ((long long)b * a.H + h) * S;

  stage_f32<D>(a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q0, S, Qs);
  stage_f32<D>(a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s, q0, S, dOs);
  int row[kRows], segr[kRows];
  float lse[kRows], dl[kRows], dq[kRows][NO];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    row[i] = q0 + ty * kRows + i;
    const bool in = row[i] < S;
    segr[i] = segb != nullptr && in ? segb[row[i]] : 0;
    lse[i] = in ? a.lse[bh + row[i]] : 0.f;
    dl[i] = in ? a.delta[bh + row[i]] : 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) dq[i][n] = 0.f;
  }

  const int kend = a.causal ? min(S, q0 + kBlock) : S;
  const int ntiles = (kend + kTile - 1) / kTile;
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    stage_f32<D>(kp, a.sk.s, k0, S, Ks);
    stage_f32<D>(vp, a.sv.s, k0, S, Vs);
    stage_ids(segk, segb, k0, S);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], dov[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = Qs[(ty * kRows + i) * LD + d];
        dov[i] = dOs[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        kv[c] = Ks[(tx + 16 * c) * LD + d];
        vv[c] = Vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = tx + 16 * c;
        const float p = attends(a, row[i], k0 + col, segr[i], segk[col])
                            ? expf(s[i][c] * a.scale - lse[i]) : 0.f;
        DSs[(ty * kRows + i) * kLdp + col] = p * (dp[i][c] - dl[i]) * a.scale;
      }
    __syncwarp();
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[kRows], kv[NO];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = DSs[(ty * kRows + i) * kLdp + kk];
#pragma unroll
      for (int n = 0; n < NO; ++n) kv[n] = Ks[kk * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int n = 0; n < NO; ++n) dq[i][n] = fmaf(dsv[i], kv[n], dq[i][n]);
    }
  }

  float* dqp = a.dq + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (row[i] >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) dqp[row[i] * a.sdq.s + tx + 16 * n] = dq[i][n];
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkdv_f32_kernel(const Args<float> a) {
  constexpr int LD = D + 1, NO = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);              // [kBlock][LD]
  float* Vs = Ks + kBlock * LD;                            // [kBlock][LD]
  float* Qs = Vs + kBlock * LD;                            // [kTile][LD]
  float* dOs = Qs + kTile * LD;                            // [kTile][LD]
  float* PT = dOs + kTile * LD;                             // [kBlock][kLdp]: p^T
  float* DST = PT + kBlock * kLdp;                         // [kBlock][kLdp]: ds^T
  float* lse_s = DST + kBlock * kLdp;                      // [kTile]
  float* dl_s = lse_s + kTile;                             // [kTile]
  int* segq = reinterpret_cast<int*>(dl_s + kTile);        // [kTile]

  const int S = a.S;
  const int k0 = blockIdx.x * kBlock;                      // causal: low keys are heavy
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.KVH;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int* segb = a.seg != nullptr ? a.seg + (long long)b * S : nullptr;
  stage_f32<D>(a.k + b * a.sk.b + hk * a.sk.h, a.sk.s, k0, S, Ks);
  stage_f32<D>(a.v + b * a.sv.b + hk * a.sv.h, a.sv.s, k0, S, Vs);
  int key[kRows], segr[kRows];
  float dk[kRows][NO], dv[kRows][NO];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    key[i] = k0 + ty * kRows + i;
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

      float st[kRows][kCols], dpt[kRows][kCols];   // S^T and dP^T: keys x queries
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[kRows], vv[kRows], qv[kCols], dov[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = Ks[(ty * kRows + i) * LD + d];
          vv[i] = Vs[(ty * kRows + i) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          qv[c] = Qs[(tx + 16 * c) * LD + d];
          dov[c] = dOs[(tx + 16 * c) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            st[i][c] = fmaf(kv[i], qv[c], st[i][c]);
            dpt[i][c] = fmaf(vv[i], dov[c], dpt[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = tx + 16 * c;              // query within the tile
          const float p = attends(a, q0 + col, key[i], segq[col], segr[i])
                              ? expf(st[i][c] * a.scale - lse_s[col]) : 0.f;
          PT[(ty * kRows + i) * kLdp + col] = p;
          DST[(ty * kRows + i) * kLdp + col] = p * (dpt[i][c] - dl_s[col]) * a.scale;
        }
      __syncwarp();
#pragma unroll 2
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[kRows], dsv[kRows], dov[NO], qv[NO];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = PT[(ty * kRows + i) * kLdp + qq];
          dsv[i] = DST[(ty * kRows + i) * kLdp + qq];
        }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          dov[n] = dOs[qq * LD + tx + 16 * n];
          qv[n] = Qs[qq * LD + tx + 16 * n];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
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
  for (int i = 0; i < kRows; ++i) {
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

// bytes of the bf16 kernels' staged tiles: row-major [64][D + kPad] and
// transposed [D][64 + kPad]
template <int D>
size_t tile_bytes(int row_tiles, int col_tiles) {
  return (size_t)(row_tiles * kTile * (D + kPad) + col_tiles * D * (kTile + kPad)) *
         sizeof(bf16);
}

// bytes of the fp32 kernels' staged [64][D + 1] tiles and [64][65] p / ds tiles
template <int D>
size_t f32_bytes(int row_tiles, int p_tiles) {
  return (size_t)(row_tiles * kTile * (D + 1) + p_tiles * kBlock * kLdp) * sizeof(float);
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

bool bad_shape(int B, int H, int KVH, int S, int D) {
  return B < 1 || B > 65535 || S < 1 || KVH < 1 || H % KVH != 0 || H > 65535 || D != 128;
}

template <typename T>
int run_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
            const void* seg, const long long* strides, int B, int H, int KVH, int S,
            int causal, float scale, void* stream) {
  Args<T> a = base_args<T>(q, k, v, strides, H, KVH, S, causal, scale, seg);
  a.out = (T*)out;
  a.lse = (float*)lse;
  a.so = mat(strides, 3);
  const dim3 grid((S + kBlock - 1) / kBlock, H, B);
  if constexpr (std::is_same<T, float>::value)
    return launch(flash_fwd_f32_kernel<128>, kF32Threads,
                  f32_bytes<128>(3, 1) + kTile * sizeof(int), grid, a, stream);
  else
    return launch(flash_fwd_kernel<128>, kThreads,
                  tile_bytes<128>(2, 1) + kTile * sizeof(int), grid, a, stream);
}

template <typename T>
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
  const dim3 grid((S + kBlock - 1) / kBlock, KVH, B);
  const size_t extra = 2 * kTile * sizeof(float) + kTile * sizeof(int);
  if constexpr (std::is_same<T, float>::value)
    return launch(flash_bwd_dkdv_f32_kernel<128>, kF32Threads, f32_bytes<128>(4, 2) + extra,
                  grid, a, stream);
  else
    return launch(flash_bwd_dkdv_kernel<128>, kThreads, tile_bytes<128>(4, 2) + extra, grid,
                  a, stream);
}

template <typename T>
int run_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, const void* seg, void* dq, const long long* strides, int B,
           int H, int KVH, int S, int causal, float scale, void* stream) {
  Args<T> a = base_args<T>(q, k, v, strides, H, KVH, S, causal, scale, seg);
  a.dout = (const T*)dout;
  a.lse = (float*)lse;
  a.delta = (const float*)delta;
  a.dq = (T*)dq;
  a.sdo = mat(strides, 3); a.sdq = mat(strides, 4);
  const dim3 grid((S + kBlock - 1) / kBlock, H, B);
  if constexpr (std::is_same<T, float>::value)
    return launch(flash_bwd_dq_f32_kernel<128>, kF32Threads,
                  f32_bytes<128>(4, 1) + kTile * sizeof(int), grid, a, stream);
  else
    return launch(flash_bwd_dq_kernel<128>, kThreads,
                  tile_bytes<128>(4, 1) + kTile * sizeof(int), grid, a, stream);
}

}  // namespace

extern "C" {

// q [B, H, S, D], k/v [B, KVH, S, D], all bf16 (fp32 == 0) or all fp32
// (fp32 == 1), unit stride over D; `strides` holds (batch, head, seq) element
// strides of q, k, v, out. out has q's shape and dtype; lse is a contiguous
// [B, H, S] fp32 output; seg is a contiguous [B, S] int32 array or null. D is
// 128 (every Llama-family model here).
int slime_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                    const void* seg, const long long* strides, int B, int H, int KVH,
                    int S, int D, int fp32, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S, D)) return (int)cudaErrorInvalidValue;
  return fp32 ? run_fwd<float>(q, k, v, out, lse, seg, strides, B, H, KVH, S, causal, scale,
                               stream)
              : run_fwd<bf16>(q, k, v, out, lse, seg, strides, B, H, KVH, S, causal, scale,
                              stream);
}

// dk/dv [B, KVH, S, D] in the inputs' dtype from q, k, v, do (strides of q,
// k, v, do, dk, dv in that order), lse and delta contiguous [B, H, S] fp32.
int slime_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* seg, void* dk,
                         void* dv, const long long* strides, int B, int H, int KVH,
                         int S, int D, int fp32, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S, D)) return (int)cudaErrorInvalidValue;
  return fp32 ? run_dkdv<float>(q, k, v, dout, lse, delta, seg, dk, dv, strides, B, H, KVH,
                                S, causal, scale, stream)
              : run_dkdv<bf16>(q, k, v, dout, lse, delta, seg, dk, dv, strides, B, H, KVH,
                               S, causal, scale, stream);
}

// dq [B, H, S, D] in the inputs' dtype from the same inputs (strides of q,
// k, v, do, dq).
int slime_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* seg, void* dq,
                       const long long* strides, int B, int H, int KVH, int S, int D,
                       int fp32, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S, D)) return (int)cudaErrorInvalidValue;
  return fp32 ? run_dq<float>(q, k, v, dout, lse, delta, seg, dq, strides, B, H, KVH, S,
                              causal, scale, stream)
              : run_dq<bf16>(q, k, v, dout, lse, delta, seg, dq, strides, B, H, KVH, S,
                             causal, scale, stream);
}

}  // extern "C"
