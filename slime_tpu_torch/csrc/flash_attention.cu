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
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlock = 64;       // rows a block owns: queries (fwd, dq) or keys (dkdv)
constexpr int kTile = 64;        // columns a loop step visits: keys or queries
constexpr int kThreads = 128;    // 4 warps x 16 rows
constexpr int kPad = 8;          // bf16 elements of padding per staged row
constexpr float kNegInf = -1e30f;

struct Mat { long long b, h, s; };       // element strides; unit stride over D

struct Args {
  const bf16* q; const bf16* k; const bf16* v; const bf16* dout;
  bf16* out; bf16* dq; bf16* dk; bf16* dv;
  float* lse; const float* delta; const int* seg;
  Mat sq, sk, sv, sdo, so, sdq, sdk, sdv;
  int H, KVH, S, causal;
  float scale;
};

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, fp32 sum
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16 x 16 slab at `base` (row-major, row stride ld).
// Lane (g = lane / 4, t = lane % 4) holds rows g and g + 8, columns 2t, 2t+1
// and 2t+8, 2t+9.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base, int ld,
                                       int g, int t) {
  a[0] = ld_pair(base + g * ld + 2 * t);
  a[1] = ld_pair(base + (g + 8) * ld + 2 * t);
  a[2] = ld_pair(base + g * ld + 2 * t + 8);
  a[3] = ld_pair(base + (g + 8) * ld + 2 * t + 8);
}

// B fragment (16 deep x 8 wide) from its transpose stored row-major at
// `base`: 8 rows (the B columns) of 16 contiguous elements (the depth).
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* base,
                                       int ld, int g, int t) {
  b0 = ld_pair(base + g * ld + 2 * t);
  b1 = ld_pair(base + g * ld + 2 * t + 8);
}

// The A operand of a product from two adjacent 16 x 8 fp32 accumulators
// (columns 0-7 and 8-15 of a 16 x 16 slab), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows [r0, r0 + 64) of one head's [S, D] matrix (row stride rs) in
// shared memory: row-major into `rows` ([64][D + kPad]) and/or transposed
// into `cols` ([D][64 + kPad]); either may be null. Rows at or past S are 0.
// With a transposed copy, neighbouring threads take neighbouring rows, so the
// 2-byte transposed stores of a warp fall in distinct banks; otherwise they
// take neighbouring 16-byte pieces of a row, so the global loads coalesce.
template <int D>
__device__ __forceinline__ void stage(const bf16* src, long long rs, int r0, int S,
                                      bf16* rows, bf16* cols) {
  constexpr int kVec = D / 8;
  for (int e = threadIdx.x; e < kTile * kVec; e += kThreads) {
    int r, c;
    if (cols) { r = e % kTile; c = (e / kTile) * 8; }
    else      { r = e / kVec;  c = (e % kVec) * 8; }
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + c);
    if (rows) *reinterpret_cast<uint4*>(rows + r * (D + kPad) + c) = val;
    if (cols) {
      const bf16* x = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[(c + j) * (kTile + kPad) + r] = x[j];
    }
  }
}

__device__ __forceinline__ void stage_ids(int* dst, const int* seg, int r0, int S) {
  if (seg != nullptr && threadIdx.x < kTile)
    dst[threadIdx.x] = r0 + (int)threadIdx.x < S ? seg[r0 + threadIdx.x] : 0;
}

__device__ __forceinline__ bool attends(const Args& a, int query, int key, int seg_q,
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
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
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
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Args a) {
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
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Args a) {
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

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, const Args& a, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
size_t tile_bytes(int row_tiles, int col_tiles) {
  return (size_t)(row_tiles * kTile * (D + kPad) + col_tiles * D * (kTile + kPad)) *
         sizeof(bf16);
}

Mat mat(const long long* s, int i) { return Mat{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

Args base_args(const void* q, const void* k, const void* v, int H, int KVH, int S,
               int causal, float scale, const void* seg) {
  Args a = {};
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.seg = (const int*)seg;
  a.H = H;
  a.KVH = KVH;
  a.S = S;
  a.causal = causal;
  a.scale = scale;
  return a;
}

bool bad_shape(int B, int H, int KVH, int S) {
  return B < 1 || B > 65535 || S < 1 || KVH < 1 || H % KVH != 0 || H > 65535;
}

}  // namespace

extern "C" {

// q [B, H, S, D], k/v [B, KVH, S, D] bf16, unit stride over D; `strides`
// holds (batch, head, seq) element strides of q, k, v, out. out has q's
// shape; lse is a contiguous [B, H, S] fp32 output; seg is a contiguous
// [B, S] int32 array or null. D is 128 (every Llama-family model here).
int slime_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                    const void* seg, const long long* strides, int B, int H, int KVH,
                    int S, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S)) return (int)cudaErrorInvalidValue;
  Args a = base_args(q, k, v, H, KVH, S, causal, scale, seg);
  a.out = (bf16*)out;
  a.lse = (float*)lse;
  a.sq = mat(strides, 0); a.sk = mat(strides, 1); a.sv = mat(strides, 2);
  a.so = mat(strides, 3);
  const dim3 grid((S + kBlock - 1) / kBlock, H, B);
  if (D != 128) return (int)cudaErrorInvalidValue;
  return launch(flash_fwd_kernel<128>, tile_bytes<128>(2, 1) + kTile * sizeof(int), grid, a,
                stream);
}

// dk/dv [B, KVH, S, D] bf16 from q, k, v, do (strides of q, k, v, do, dk, dv
// in that order), lse and delta contiguous [B, H, S] fp32.
int slime_flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, const void* seg, void* dk,
                         void* dv, const long long* strides, int B, int H, int KVH,
                         int S, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S)) return (int)cudaErrorInvalidValue;
  Args a = base_args(q, k, v, H, KVH, S, causal, scale, seg);
  a.dout = (const bf16*)dout;
  a.lse = (float*)lse;
  a.delta = (const float*)delta;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  a.sq = mat(strides, 0); a.sk = mat(strides, 1); a.sv = mat(strides, 2);
  a.sdo = mat(strides, 3); a.sdk = mat(strides, 4); a.sdv = mat(strides, 5);
  const dim3 grid((S + kBlock - 1) / kBlock, KVH, B);
  const size_t extra = 2 * kTile * sizeof(float) + kTile * sizeof(int);
  if (D != 128) return (int)cudaErrorInvalidValue;
  return launch(flash_bwd_dkdv_kernel<128>, tile_bytes<128>(4, 2) + extra, grid, a, stream);
}

// dq [B, H, S, D] bf16 from the same inputs (strides of q, k, v, do, dq).
int slime_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, const void* seg, void* dq,
                       const long long* strides, int B, int H, int KVH, int S, int D,
                       int causal, float scale, void* stream) {
  if (bad_shape(B, H, KVH, S)) return (int)cudaErrorInvalidValue;
  Args a = base_args(q, k, v, H, KVH, S, causal, scale, seg);
  a.dout = (const bf16*)dout;
  a.lse = (float*)lse;
  a.delta = (const float*)delta;
  a.dq = (bf16*)dq;
  a.sq = mat(strides, 0); a.sk = mat(strides, 1); a.sv = mat(strides, 2);
  a.sdo = mat(strides, 3); a.sdq = mat(strides, 4);
  const dim3 grid((S + kBlock - 1) / kBlock, H, B);
  if (D != 128) return (int)cudaErrorInvalidValue;
  return launch(flash_bwd_dq_kernel<128>, tile_bytes<128>(4, 1) + kTile * sizeof(int), grid, a,
                stream);
}

}  // extern "C"
