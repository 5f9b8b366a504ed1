// Non-causal encoder (ViT) attention for Hopper (sm_90a): K4. It replaces the
// TPU kernel slime_tpu/ops/encoder_attention.py _pallas_fwd (_kernel, :57-105),
// which runs in every CLIP-L layer at q/k/v [crops, 577, 16, 64] bf16.
//
// Semantics kept from the TPU kernel (encoder_attention.py:57-75):
//   qs = bf16(q * scale)                   scale folded into q, in fp32
//   s  = qs . k                            fp32 accumulation
//   p  = exp(bf16(min(s, 80)))             clamp instead of a row-max subtract
//   l  = bf16(sum_keys p)                  p summed in fp32
//   o  = (sum_keys bf16(p) * v) / l        p enters the product as bf16,
//                                          fp32 accumulation
// Keys past S (the ragged tail of the last key tile) get p = 0: TMA fills them
// with zeros, and exp(0) = 1, so the tail is masked explicitly.
//
// Because of the clamp there is no running max: each key tile's p only adds
// to l and to o, and nothing is rescaled between tiles.
//
// What bounds it on this card: at CLIP-L's shape the bytes (q, k, v in, o out:
// 0.011 ms at 3.35 TB/s) and the tensor work (2 x 2 x 577^2 x 64 flops per
// head, 0.011 ms at 989 TFLOP/s) weigh about the same, so both products run on
// the tensor cores and every copy is a TMA tile:
//   - one block per (64 WGS query rows, head, crop): WGS consumer warpgroups
//     of 64 rows and one producer warp;
//   - the producer loads the block's q tile once, then streams k and v tiles
//     of BN keys through a STAGES-deep ring of shared-memory stages with full
//     and empty mbarriers; q/k/v are read in the ViT's [B, S, H, D] layout
//     through their strides (views of one packed qkv projection need no copy);
//   - each warpgroup scales its q rows in shared memory (the rounding point of
//     the TPU kernel), then per tile: S = Q.K^T as an SS wgmma, clamp, round,
//     exp (as exp2 of x log2(e), one MUFU op) and the row sums in registers,
//     P.V as an RS wgmma (P straight from the score accumulator);
//   - the epilogue divides by l, stages the rows swizzled in the warpgroup's
//     own q rows and writes them with one TMA store per 64 columns.
// D that is not a multiple of 64 (the tests' D = 40) is padded by the TMA
// box's zero fill, which adds nothing to either product.
//
// `variant` selects the design (the P2 probe, slime_tpu_torch/probes/
// encoder_attention.py, times each): 0 the production choice, 1-3 the others
// (head dims up to 64 only).
//
// fp32 q/k/v (the tower's default compute dtype) take enc_attn_f32_kernel: the
// same semantics on the FFMA units, rounded where encoder_attention_ref rounds
// for fp32 inputs: qs = q * scale and p enter their products unrounded (their
// dtype is fp32), while p = exp(bf16(min(s, 80))) and l = bf16(sum p) keep
// their bf16 roundings. Its design is described above the kernel.
#include "hopper_common.cuh"

namespace {

constexpr float kClamp = 80.f;

struct EncParams {
  CUtensorMap q, k, v, o;
  int S;
  float scale;
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// WGS consumer warpgroups of 64 query rows, key tiles of BN, a STAGES-deep
// ring, W the head dim padded to 64 or 128.
template <int WGS, int BN, int STAGES, int W>
__global__ void __launch_bounds__(128 * WGS + 32) enc_attn_kernel(
    const __grid_constant__ EncParams p) {
  constexpr int BM = 64 * WGS, NCH = W / 64;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align1024(smem_raw));    // [NCH][BM][64]
  bf16* Ks = Qs + NCH * BM * 64;                                // [STAGES][NCH][BN][64]
  bf16* Vs = Ks + STAGES * NCH * BN * 64;                       // [STAGES][NCH][BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * NCH * BN * 64);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int S = p.S, q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (S + BN - 1) / BN;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * WGS);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == WGS) {                                  // the producer warp
    if (threadIdx.x == 128 * WGS) {
      mbar_arrive_expect_tx(qbar, NCH * BM * 128);
      for (int c = 0; c < NCH; ++c) tma_load(Qs + c * BM * 64, &p.q, qbar, 64 * c, q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        mbar_wait(&empty[st], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * NCH * BN * 128);
        for (int c = 0; c < NCH; ++c) {
          tma_load(Ks + (st * NCH + c) * BN * 64, &p.k, &full[st], 64 * c, j * BN, h, b);
          tma_load(Vs + (st * NCH + c) * BN * 64, &p.v, &full[st], 64 * c, j * BN, h, b);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x & 127, tq = t & 3;
  bf16* Qw = Qs + 64 * wg * 64;                     // this warpgroup's rows of chunk 0
  mbar_wait(qbar, 0);
  // qs = bf16(q * scale) in place: elementwise, so the swizzle does not matter
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    uint4* rows = reinterpret_cast<uint4*>(Qw + c * BM * 64);
    for (int e = t; e < 64 * 64 / 8; e += 128) {
      uint4 x = rows[e];
      __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(pair[i]);
        pair[i] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
      }
      rows[e] = x;
    }
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);

  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;                         // per-lane partial row sums
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    mbar_wait(&full[st], (j / STAGES) & 1);
    float s[BN / 2];
    qk_product<W, BN>(s, Qw, BM, Ks + st * NCH * BN * 64);
    const int k0 = j * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int key = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
      const float e = key < S ? exp2f(bf16r(fminf(s[i], kClamp)) * kLog2e) : 0.f;
      if (i & 2) l1 += e; else l0 += e;
      s[i] = e;
    }
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) acc_to_a_frag(pa[kk], s, kk);
    pv_product<W, BN>(o, pa, Vs + st * NCH * BN * 64);
    mbar_arrive(&empty[st]);
  }
  const float d0 = bf16r(quad_sum4(l0)), d1 = bf16r(quad_sum4(l1));
  store_rows<W>(o, d0, d1, Qw, BM, &p.o, q0 + 64 * wg, h, b, 1 + wg);
}

template <int WGS, int BN, int STAGES, int W>
int launch_enc(EncParams& p, const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int D, const long long* st, void* stream) {
  constexpr int BM = 64 * WGS, NCH = W / 64;
  int err = encode_bshd(&p.q, q, B, S, H, D, st[0], st[1], st[2], BM);
  if (err == 0) err = encode_bshd(&p.k, k, B, S, H, D, st[3], st[4], st[5], BN);
  if (err == 0) err = encode_bshd(&p.v, v, B, S, H, D, st[6], st[7], st[8], BN);
  if (err == 0)
    err = encode_bshd(&p.o, o, B, S, H, D, (long long)S * H * D, (long long)H * D, D, 64);
  if (err != 0) return err;
  const size_t smem = (size_t)NCH * BM * 128 + (size_t)2 * STAGES * NCH * BN * 128 +
                      (2 * STAGES + 1) * sizeof(uint64_t) + 1024;
  auto kernel = enc_attn_kernel<WGS, BN, STAGES, W>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BM - 1) / BM, H, B);
  kernel<<<grid, 128 * WGS + 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// fp32 q/k/v: an FFMA kernel. What bounds it on this card: the two products
// (2 x 2 x 577^2 x 64 flops a head: 0.163 ms for CLIP-L's 128 heads at 67
// TFLOP/s) weigh 15 times its bytes, and an SM issues 128 FMAs a clock but
// moves 128 bytes a clock from shared memory into registers, so the design
// keeps each loaded word feeding 4 or 8 FMAs and the copies off the FMA
// units' path:
//   - one block per (BM query rows, head, crop), 2 BM threads: thread (ty =
//     tid / 16, tx = tid % 16) holds rows 8 ty .. 8 ty + 7 and keys tx + 16 c
//     (c < 4) of a 64-key tile's S, and the same rows by columns 4 tx .. 4 tx
//     + 3 (+ 64 where D > 64) of O, in registers (8 x 4 and 8 x 4 or 8 x 8);
//   - q (scaled once, fp32) stays in shared memory row-major; its reads are
//     float4 over 4 depths: per 4 depths 8 q and 4 k float4 loads feed 128
//     FMAs; p goes to shared memory key-major, so P.V reads 2 float4 of p
//     and 1-2 of v a key for 32-64 FMAs;
//   - k and v tiles of 64 keys come by 16-byte cp.async (zero-filled past S
//     and past D) into a two-stage ring: the next tile's copy is issued
//     right after the one barrier of a tile and lands while this tile
//     computes;
//   - row strides padded by 4 floats (q and k rows, p's key rows) and q's
//     rows skewed by 4 more every 8, so a warp's 16 distinct k rows, and
//     the 2 q rows 8 apart that it reads at once, fall in distinct banks;
//   - a row's keys live in one half-warp, so p is exchanged with __syncwarp
//     only; warps whose rows all lie past S skip the arithmetic, and P.V
//     stops at the tile's last key (rounded up to 4).
// It reaches about 36% of the FFMA peak on an H100 (PERF.md, K4); 64 query
// rows a block, 8 x 8 tiles, depth-major q and k, and S and P.V on two
// warp groups of a block were tried beside it and ran no faster. BM is 128
// at D <= 64 (136 KB of shared memory) and 64 at D <= 128 (184 KB).
// Semantics as encoder_attention_ref for fp32 inputs: qs = q * scale and p
// enter their products unrounded (their dtype is fp32), p = exp(bf16(min(s,
// 80))), l = bf16(sum p) from the fp32 sum (in another order), o = (sum p v)
// / l. q/k/v are read through their (batch, seq, head) strides, every one a
// multiple of 16 bytes (the wrapper copies a view that is not).
struct EncF32Params {
  const float* q; const float* k; const float* v;
  float* o;
  long long st[9];                      // (batch, seq, head) element strides of q, k, v
  int S, H, D;
  float scale;
};

// the fp32 kernel's shared memory, in floats: q [BM rows of DP + 4, skewed],
// k [2][64][DP + 4], v [2][64][DP], p key-major [64][BM + 4]
template <int DP, int BM>
struct F32Cfg {
  static constexpr int BN = 64, NT = 2 * BM, LQ = DP + 4, LP = BM + 4;
  static constexpr int QF = BM * LQ + BM / 2, KF = BN * LQ, VF = BN * DP, PF = BN * LP;
  static constexpr size_t SMEM = (size_t)(QF + 2 * KF + 2 * VF + PF) * sizeof(float);
};

// float offset of q row r: 4 floats of skew every 8 rows
__device__ __forceinline__ int q_row(int r, int lq) { return r * lq + (r >> 3) * 4; }

// 16 bytes global -> shared, asynchronously; zeros where !valid (src unread)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

template <int DP, int BM>
__global__ void __launch_bounds__(2 * BM) enc_attn_f32_kernel(const EncF32Params p) {
  using C = F32Cfg<DP, BM>;
  constexpr int BN = C::BN, NT = C::NT, LQ = C::LQ, LP = C::LP, C4 = DP / 4, NH = DP / 64;
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;
  float* Ks = Qs + C::QF;
  float* Vs = Ks + 2 * C::KF;
  float* Pt = Vs + 2 * C::VF;
  const int S = p.S, D = p.D, q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* qp = p.q + b * p.st[0] + h * p.st[2];
  const float* kp = p.k + b * p.st[3] + h * p.st[5];
  const float* vp = p.v + b * p.st[6] + h * p.st[8];
  const int ntiles = (S + BN - 1) / BN;

  auto stage = [&](int j) {             // key tile j into ring stage j & 1
    float* ks = Ks + (j & 1) * C::KF;
    float* vs = Vs + (j & 1) * C::VF;
    for (int e = tid; e < BN * C4; e += NT) {
      const int r = e / C4, c = (e % C4) * 4, key = j * BN + r;
      const bool in = key < S && c < D;
      cp_async16(ks + r * LQ + c, in ? kp + key * p.st[4] + c : kp, in);
      cp_async16(vs + r * DP + c, in ? vp + key * p.st[7] + c : vp, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage(0);
  for (int e = tid; e < BM * C4; e += NT) {
    const int r = e / C4, c = (e % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S && c < D) {
      x = *reinterpret_cast<const float4*>(qp + (q0 + r) * p.st[1] + c);
      x = make_float4(x.x * p.scale, x.y * p.scale, x.z * p.scale, x.w * p.scale);
    }
    *reinterpret_cast<float4*>(Qs + q_row(r, LQ) + c) = x;
  }

  // a warp's rows are 16 (ty pairs 2w, 2w + 1): it works if any lies below S
  const bool live = q0 + (tid >> 5) * 16 < S;
  float o[8][4 * NH], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < 4 * NH; ++n) o[i][n] = 0.f;
  }
  for (int j = 0; j < ntiles; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();                    // tile j landed; tile j - 1's stage is free
    if (j + 1 < ntiles) stage(j + 1);
    if (!live) continue;
    const float* ks = Ks + (j & 1) * C::KF;
    const float* vs = Vs + (j & 1) * C::VF;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(ks + (tx + 16 * c) * LQ + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + q_row(8 * ty + i, LQ) + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv.x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv.y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv.z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv.w, kv[c].w, s[i][c]);
        }
      }
    }
    const int k0 = j * BN, kn = min(BN, S - k0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = tx + 16 * c < kn;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float e = in ? expf(bf16r(fminf(s[i][c], kClamp))) : 0.f;
        l[i] += e;
        s[i][c] = e;
      }
      float* prow = Pt + (tx + 16 * c) * LP + 8 * ty;
      *reinterpret_cast<float4*>(prow) = make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(prow + 4) = make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
    }
    __syncwarp();                       // a row's p is its half-warp's
    const int kend = (kn + 3) & ~3;     // p and v are 0 past S
    for (int kk = 0; kk < kend; kk += 4) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 pa = *reinterpret_cast<const float4*>(Pt + (kk + t) * LP + 8 * ty);
        const float4 pb = *reinterpret_cast<const float4*>(Pt + (kk + t) * LP + 8 * ty + 4);
        const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + (kk + t) * DP + 64 * n + 4 * tx);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            o[i][4 * n] = fmaf(pr[i], vv.x, o[i][4 * n]);
            o[i][4 * n + 1] = fmaf(pr[i], vv.y, o[i][4 * n + 1]);
            o[i][4 * n + 2] = fmaf(pr[i], vv.z, o[i][4 * n + 2]);
            o[i][4 * n + 3] = fmaf(pr[i], vv.w, o[i][4 * n + 3]);
          }
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = bf16r(lt);
    const int row = q0 + 8 * ty + i;
    if (row >= S) continue;
    float* orow = p.o + (((long long)b * S + row) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int col = 64 * n + 4 * tx;
      if (col < D)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(o[i][4 * n] / lt, o[i][4 * n + 1] / lt, o[i][4 * n + 2] / lt,
                        o[i][4 * n + 3] / lt);
    }
  }
}

template <int DP, int BM>
int launch_enc_f32(const EncF32Params& p, int B, void* stream) {
  using C = F32Cfg<DP, BM>;
  auto kernel = enc_attn_f32_kernel<DP, BM>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((p.S + BM - 1) / BM, p.H, B), C::NT, C::SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v [B, S, H, D] bf16 (fp32 == 0) or fp32 (fp32 == 1) with unit stride
// over D and element strides (batch, seq, head), 16-byte aligned; o is a
// contiguous [B, S, H, D] output of their dtype. S <= 1024, D <= 128, D % 8
// == 0 (the wrapper checks). fp32 takes the FFMA kernel (variant 0 only):
// 128 query rows a block at D <= 64, 64 at D <= 128 (shared memory).
// variant 0 is the production design; 1-3 are the P2 probe's others (D <= 64):
//   0: 128 query rows (2 warpgroups), 64-key tiles, 2 stages
//   1:  64 query rows (1 warpgroup),  64-key tiles, 2 stages
//   2: 128 query rows, 128-key tiles, 2 stages
//   3: 128 query rows,  64-key tiles, 3 stages
int slime_encoder_attention(const void* q, const void* k, const void* v, void* o, int B, int S,
                            int H, int D, long long qb, long long qs, long long qh,
                            long long kb, long long ks, long long kh, long long vb,
                            long long vs, long long vh, float scale, int variant, int fp32,
                            void* stream) {
  if (S < 1 || S > 1024 || D < 8 || D > 128 || D % 8 || B > 65535 || H > 65535 ||
      (variant != 0 && (D > 64 || fp32)))
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {qb, qs, qh, kb, ks, kh, vb, vs, vh};
  if (fp32) {
    EncF32Params f;
    f.q = (const float*)q;
    f.k = (const float*)k;
    f.v = (const float*)v;
    f.o = (float*)o;
    for (int i = 0; i < 9; ++i) f.st[i] = st[i];
    f.S = S;
    f.H = H;
    f.D = D;
    f.scale = scale;
    return D <= 64 ? launch_enc_f32<64, 128>(f, B, stream)
                   : launch_enc_f32<128, 64>(f, B, stream);
  }
  EncParams p;
  p.S = S;
  p.scale = scale;
  switch (variant) {
    case 0:
      return D <= 64 ? launch_enc<2, 64, 2, 64>(p, q, k, v, o, B, S, H, D, st, stream)
                     : launch_enc<2, 64, 2, 128>(p, q, k, v, o, B, S, H, D, st, stream);
    case 1: return launch_enc<1, 64, 2, 64>(p, q, k, v, o, B, S, H, D, st, stream);
    case 2: return launch_enc<2, 128, 2, 64>(p, q, k, v, o, B, S, H, D, st, stream);
    case 3: return launch_enc<2, 64, 3, 64>(p, q, k, v, o, B, S, H, D, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
