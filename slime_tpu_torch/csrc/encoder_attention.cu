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
// their bf16 roundings. It is the simplest right kernel, in the style of
// flash_attention.cu's FFMA forward.
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

// One block per (64 query rows, head, crop), 256 threads: thread (ty = tid /
// 16, tx = tid % 16) owns rows 4 ty .. 4 ty + 3, keys tx + 16 c (c < 4) of a
// 64-key tile and output columns tx + 16 n (n < DP / 16). q (scaled), k and
// v tiles are staged as [64][DP + 1] floats, D zero-padded to DP (64 or 128):
// the 16 threads reading 16 keys at one depth hit 16 distinct banks.
struct EncF32Params {
  const float* q; const float* k; const float* v;
  float* o;
  long long st[9];                      // (batch, seq, head) element strides of q, k, v
  int S, H, D;
  float scale;
};

template <int DP>
__global__ void __launch_bounds__(256) enc_attn_f32_kernel(const EncF32Params p) {
  constexpr int LD = DP + 1, NO = DP / 16, LDP = 65;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* Qs = reinterpret_cast<float*>(smem_f32);             // [64][LD]
  float* Ks = Qs + 64 * LD;                                     // [64][LD]
  float* Vs = Ks + 64 * LD;                                     // [64][LD]
  float* Ps = Vs + 64 * LD;                                     // [64][LDP]
  const int S = p.S, D = p.D, q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* qp = p.q + b * p.st[0] + h * p.st[2];
  const float* kp = p.k + b * p.st[3] + h * p.st[5];
  const float* vp = p.v + b * p.st[6] + h * p.st[8];
  for (int e = threadIdx.x; e < 64 * DP; e += 256) {
    const int r = e / DP, c = e % DP;
    Qs[r * LD + c] = q0 + r < S && c < D ? qp[(q0 + r) * p.st[1] + c] * p.scale : 0.f;
  }
  float o[4][NO], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[i][n] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += 64) {
    __syncthreads();                                            // the last tile is consumed
    for (int e = threadIdx.x; e < 64 * DP; e += 256) {
      const int r = e / DP, c = e % DP;
      const bool in = k0 + r < S && c < D;
      Ks[r * LD + c] = in ? kp[(k0 + r) * p.st[4] + c] : 0.f;
      Vs[r * LD + c] = in ? vp[(k0 + r) * p.st[7] + c] : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = k0 + tx + 16 * c < S ? expf(bf16r(fminf(s[i][c], kClamp))) : 0.f;
        Ps[(4 * ty + i) * LDP + tx + 16 * c] = e;
        l[i] += e;
      }
    __syncwarp();                                               // a row's p is its half-warp's
#pragma unroll 4
    for (int kk = 0; kk < 64; ++kk) {
      float pv[4], vv[NO];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * LDP + kk];
#pragma unroll
      for (int n = 0; n < NO; ++n) vv[n] = Vs[kk * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NO; ++n) o[i][n] = fmaf(pv[i], vv[n], o[i][n]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = bf16r(lt);
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    float* orow = p.o + (((long long)b * S + row) * p.H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (tx + 16 * n < D) orow[tx + 16 * n] = o[i][n] / lt;
  }
}

template <int DP>
int launch_enc_f32(const EncF32Params& p, int B, void* stream) {
  const size_t smem = (size_t)(3 * 64 * (DP + 1) + 64 * 65) * sizeof(float);
  auto kernel = enc_attn_f32_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((p.S + 63) / 64, p.H, B), 256, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v [B, S, H, D] bf16 (fp32 == 0) or fp32 (fp32 == 1) with unit stride
// over D and element strides (batch, seq, head), 16-byte aligned; o is a
// contiguous [B, S, H, D] output of their dtype. S <= 1024, D <= 128, D % 8
// == 0 (the wrapper checks). fp32 takes the FFMA kernel (variant 0 only).
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
    return D <= 64 ? launch_enc_f32<64>(f, B, stream) : launch_enc_f32<128>(f, B, stream);
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
