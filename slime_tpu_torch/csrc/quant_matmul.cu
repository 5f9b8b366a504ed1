// Weight-only quantized matmul for Hopper (sm_90a): y = x @ dequant(W).T.
// It replaces two TPU kernels of slime_tpu/ops/quant_matmul.py:
//   K6  quant_matmul      (:130; _kernel_int4 :23, _kernel_int8 :38)
//       per-row scales: y[b, o] = (sum_i x[b, i] * w_int[o, i]) * scale[o]
//   K7  quant_matmul_q4g  (:82; _kernel_int4_group :46)
//       group-128 scales: y[b, o] = sum_g (sum_{i in g} x[b, i] * w_int[o, i]) * scale[o, g]
// with x bf16 [M, K], packed weights int8 and fp32 scales. Storage formats
// (slime_tpu/ops/quantization.py): "q4" holds column 2i in the low nibble of
// byte i and column 2i+1 in the high nibble; "q4g" packed block b (128 bytes
// of a row) holds group 2b in its low nibbles and group 2b+1 in its high
// nibbles; "q" (int8) is one byte per column.
//
// What bounds it on this card. At prefill (M = 2048 rows, K = 4096 or 14336)
// the product is far above the H100's ridge: operations, at the bf16
// tensor-core rate. At decode (M = 1) it is the packed weight bytes. K7 with
// bf16 x of 64 rows or more (the prefill) takes the Hopper kernel at the end
// of this file (wgmma, weights dequantized in registers); below that, K6,
// and fp32 x, the kernels here:
//   - one tiled GEMM on mma.sync m16n8k16 bf16 tiles with fp32 sums (the
//     fragment vocabulary of csrc/flash_attention.cu). A block owns a 64 x 64
//     output tile; 4 warps own 32 x 32 each;
//   - the weight tile is unpacked into shared memory as bf16: nibbles and int8
//     values are exact in bf16, so every product is exact and only the fp32
//     sums round, as on the TPU. Sign extension reads the packed byte as
//     unsigned and takes ((p & 0xF) ^ 8) - 8. q4 is unpacked in natural column
//     order (the TPU kernel's column permutation of x is a Mosaic device);
//   - K6 applies the per-row scale once, in the epilogue. K7's k-tile is one
//     packed block, two 128-column groups: each group's products go to a fresh
//     fragment, which is scaled by scale[o, g] and added to the fp32
//     accumulator (folding the scale into the bf16 weight would change the
//     rounding);
//   - at decode an output-tile grid alone would leave most of the 132 SMs idle
//     (16 blocks for a 1024-row k/v projection), so the wrapper splits K over
//     blockIdx.z into an fp32 workspace and a second pass sums the splits in
//     a fixed order, applies the per-row scale and rounds to bf16.
// Loads are plain 16-byte loads staged through registers (no cp.async, TMA or
// wgmma yet): a right and simple first version.
// fp32 x (the default compute dtype of llama.forward and generate) takes a
// second kernel on the FFMA units with the same tiles and split: the weights
// are dequantized to fp32 in shared memory (exact integers, JAX's
// astype(x.dtype)), every product is an fp32 FMA (no TF32), the scales apply
// as above, and y is fp32.
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 64, kBN = 64;   // output tile
constexpr int kThreads = 128;       // 4 warps, 2 x 2 over the tile
constexpr int kPad = 8;             // bf16 elements of padding per staged row
constexpr int kGroup = 128;         // q4g group width

enum { kQ4 = 0, kInt8 = 1, kQ4G = 2 };

template <int FMT> struct Fmt { static constexpr int BK = FMT == kQ4G ? 2 * kGroup : 128; };

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float nib(uint32_t byte, int shift) {
  return (float)((int)(((byte >> shift) & 0xFu) ^ 8u) - 8);
}

// K6's masked K tail, in the kernels' TAIL instances (K not a multiple of
// the 128-column k-tile; the others keep their plain 16-byte loads): the 16
// bytes at byte `off` of a row of `len` bytes, one vector load where they
// lie inside a 16-byte aligned row, else byte loads, zero past len (zero
// values and zero nibbles add nothing to a sum). x is never copied.
__device__ __forceinline__ uint4 load16(const void* row, int off, int len) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(row);
  if (len % 16 == 0 && off + 16 <= len) return *reinterpret_cast<const uint4*>(p + off);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (off + i < len) w[i / 4] |= (uint32_t)p[off + i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
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

// A fragment of the 16 x 16 slab at `base` (row-major, row stride ld): lane
// (g, t) holds rows g and g + 8, columns 2t, 2t+1 and 2t+8, 2t+9.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base, int ld,
                                       int g, int t) {
  a[0] = ld_pair(base + g * ld + 2 * t);
  a[1] = ld_pair(base + (g + 8) * ld + 2 * t);
  a[2] = ld_pair(base + g * ld + 2 * t + 8);
  a[3] = ld_pair(base + (g + 8) * ld + 2 * t + 8);
}

// B fragment (16 deep x 8 wide) from W's rows (the B columns), row-major.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* base,
                                       int ld, int g, int t) {
  b0 = ld_pair(base + g * ld + 2 * t);
  b1 = ld_pair(base + g * ld + 2 * t + 8);
}

// Stage x[m0:m0+64, k0:k0+BK] (rows past M are 0).
template <int BK, bool TAIL>
__device__ __forceinline__ void stage_x(bf16* xs, const bf16* __restrict__ x, int M, int K,
                                        int m0, int k0) {
  constexpr int LD = BK + kPad, kVec = BK / 8;
  for (int e = threadIdx.x; e < kBM * kVec; e += kThreads) {
    const int r = e / kVec, c = (e % kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) {
      if constexpr (TAIL) v = load16(x + (size_t)(m0 + r) * K, (k0 + c) * 2, K * 2);
      else v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
    }
    *reinterpret_cast<uint4*>(xs + r * LD + c) = v;
  }
}

// Stage W's k-tile for output rows n0..n0+63 as bf16 values (rows past N are 0).
template <int FMT, bool TAIL>
__device__ __forceinline__ void stage_w(bf16* ws, const uint8_t* __restrict__ w, int N, int K,
                                        int n0, int k0) {
  constexpr int BK = Fmt<FMT>::BK, LD = BK + kPad;
  if (FMT == kInt8) {                       // 16 bytes = 16 columns
    for (int e = threadIdx.x; e < kBN * (BK / 16); e += kThreads) {
      const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N) {
        if constexpr (TAIL) v = load16(w + (size_t)(n0 + r) * K, k0 + c, K);
        else v = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * K + k0 + c);
      }
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
      uint32_t out[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[2 * i] = pack_bf16((float)(int8_t)(wd[i] & 0xffu), (float)(int8_t)((wd[i] >> 8) & 0xffu));
        out[2 * i + 1] = pack_bf16((float)(int8_t)((wd[i] >> 16) & 0xffu),
                                   (float)(int8_t)(wd[i] >> 24));
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + r * LD + c);
      dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
      dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
    }
  } else if (FMT == kQ4) {                  // 16 bytes = 32 columns, natural order
    const int KP = K / 2;
    for (int e = threadIdx.x; e < kBN * (BK / 32); e += kThreads) {
      const int r = e / (BK / 32), c = (e % (BK / 32)) * 32;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N) {
        if constexpr (TAIL) v = load16(w + (size_t)(n0 + r) * KP, (k0 + c) / 2, KP);
        else v = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * KP + (k0 + c) / 2);
      }
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
      uint32_t out[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {        // byte i -> columns 2i (low), 2i+1 (high)
        const uint32_t byte = (wd[i / 4] >> (8 * (i % 4))) & 0xffu;
        out[i] = pack_bf16(nib(byte, 0), nib(byte, 4));
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + r * LD + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = make_uint4(out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3]);
    }
  } else {                                  // q4g: one packed block = groups 2b, 2b+1
    const int KP = K / 2, blk = k0 / BK;
    for (int e = threadIdx.x; e < kBN * (kGroup / 16); e += kThreads) {
      const int r = e / (kGroup / 16), j = (e % (kGroup / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N) v = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * KP + blk * kGroup + j);
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {         // bytes 2i, 2i+1 -> columns j+2i, j+2i+1
        const uint32_t b0 = (wd[i / 2] >> (16 * (i % 2))) & 0xffu;
        const uint32_t b1 = (wd[i / 2] >> (16 * (i % 2) + 8)) & 0xffu;
        lo[i] = pack_bf16(nib(b0, 0), nib(b1, 0));
        hi[i] = pack_bf16(nib(b0, 4), nib(b1, 4));
      }
      uint4* dlo = reinterpret_cast<uint4*>(ws + r * LD + j);
      uint4* dhi = reinterpret_cast<uint4*>(ws + r * LD + kGroup + j);
      dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
}

// acc += part * scale[o, grp] per output column, then part = 0 (K7).
__device__ __forceinline__ void fold_group(float (&acc)[2][4][4], float (&part)[2][4][4],
                                           const float* __restrict__ s, int N, int G,
                                           int ncol0, int grp, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = ncol0 + 8 * j + 2 * t;
    const float s0 = c < N ? s[(size_t)c * G + grp] : 0.f;
    const float s1 = c + 1 < N ? s[(size_t)(c + 1) * G + grp] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[i][j][0] += part[i][j][0] * s0;
      acc[i][j][1] += part[i][j][1] * s1;
      acc[i][j][2] += part[i][j][2] * s0;
      acc[i][j][3] += part[i][j][3] * s1;
#pragma unroll
      for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
    }
  }
}

// One 64 x 64 output tile over k-tiles [kt0, kt1) of blockIdx.z's split. With
// `ws` null the epilogue writes bf16 y (K6 scaled per row); otherwise the
// split's fp32 sums go to ws[z] (K7's already carry the group scales).
template <int FMT, bool TAIL>
__global__ void __launch_bounds__(kThreads) qmm_kernel(
    const bf16* __restrict__ x, int M, int K, const uint8_t* __restrict__ w,
    const float* __restrict__ s, int N, bf16* __restrict__ y, float* __restrict__ ws,
    int tiles_per_split) {
  constexpr int BK = Fmt<FMT>::BK, LD = BK + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);      // [kBM][LD]
  bf16* wsm = xs + kBM * LD;                      // [kBN][LD]

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, z = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int nk = TAIL ? (K + BK - 1) / BK : K / BK;   // the last k-tile masked past K
  const int kt0 = z * tiles_per_split, kt1 = min(nk, kt0 + tiles_per_split);
  const int G = K / kGroup;

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = part[i][j][q] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                              // the last tile's readers are done
    stage_x<BK, TAIL>(xs, x, M, K, m0, k0);
    stage_w<FMT, TAIL>(wsm, w, N, K, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (FMT == kQ4G && kk == kGroup / 16)       // group 2b done, 2b+1 starts
        fold_group(acc, part, s, N, G, n0 + wn, 2 * kt, t);
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) load_a(a[i], xs + (wm + 16 * i) * LD + kk * 16, LD, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b0, b1;
        load_b(b0, b1, wsm + (wn + 8 * j) * LD + kk * 16, LD, g, t);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (FMT == kQ4G) mma16816(part[i][j], a[i], b0, b1);
          else mma16816(acc[i][j], a[i], b0, b1);
        }
      }
    }
    if (FMT == kQ4G) fold_group(acc, part, s, N, G, n0 + wn, 2 * kt + 1, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + wm + 16 * i + g + (q >= 2 ? 8 : 0);
        const int c = n0 + wn + 8 * j + 2 * t + (q & 1);
        if (r >= M || c >= N) continue;
        if (ws != nullptr) {
          ws[((size_t)z * M + r) * N + c] = acc[i][j][q];
        } else {
          const float v = FMT == kQ4G ? acc[i][j][q] : acc[i][j][q] * s[c];
          y[(size_t)r * N + c] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 x: the FFMA kernel
// ---------------------------------------------------------------------------
// 256 threads own the 64 x 64 output tile, 4 x 4 each: thread (ty = tid / 16,
// tx = tid % 16) rows 4 ty .. 4 ty + 3 and columns tx + 16 c (c < 4). A step
// stages 128 columns of x and of W (one q4g group) as [64][129] floats, so the
// 16 threads reading 16 W rows at one depth hit 16 distinct banks. Shared
// memory bounds it (8 loads per 16 FMAs): a right and simple first version.
constexpr int kF32Threads = 256, kF32K = 128, kF32LD = kF32K + 1;

// Stage W's columns [k0, k0 + 128) for output rows n0..n0+63 as fp32 (rows
// past N are 0); for q4g those columns are group k0 / 128, the low (even
// group) or high (odd) nibbles of packed block k0 / 256.
template <int FMT, bool TAIL>
__device__ __forceinline__ void stage_w_f32(float* ws, const uint8_t* __restrict__ w, int N,
                                            int K, int n0, int k0) {
  constexpr int kCols = FMT == kQ4 ? 32 : 16;   // columns in 16 bytes of a row
  const int KP = FMT == kInt8 ? K : K / 2;
  const int g = k0 / kGroup, shift = (g & 1) * 4;
  for (int e = threadIdx.x; e < kBN * (kF32K / kCols); e += kF32Threads) {
    const int r = e / (kF32K / kCols), c = (e % (kF32K / kCols)) * kCols;
    size_t off;
    if (FMT == kInt8) off = (size_t)k0 + c;
    else if (FMT == kQ4) off = (size_t)(k0 + c) / 2;
    else off = (size_t)(g / 2) * kGroup + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < N) {
      if constexpr (TAIL) v = load16(w + (size_t)(n0 + r) * KP, (int)off, KP);
      else v = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * KP + off);
    }
    const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
    float* dst = ws + r * kF32LD + c;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t byte = (wd[i / 4] >> (8 * (i % 4))) & 0xffu;
      if (FMT == kInt8) {
        dst[i] = (float)(int8_t)byte;
      } else if (FMT == kQ4) {                  // byte i -> columns 2i (low), 2i+1 (high)
        dst[2 * i] = nib(byte, 0);
        dst[2 * i + 1] = nib(byte, 4);
      } else {
        dst[i] = nib(byte, shift);
      }
    }
  }
}

// One 64 x 64 fp32 output tile over k-tiles [kt0, kt1) of blockIdx.z's split
// (the bf16 kernel's k-tiles, in steps of 128 columns); the epilogue as
// qmm_kernel's, in fp32.
template <int FMT, bool TAIL>
__global__ void __launch_bounds__(kF32Threads) qmm_f32_kernel(
    const float* __restrict__ x, int M, int K, const uint8_t* __restrict__ w,
    const float* __restrict__ s, int N, float* __restrict__ y, float* __restrict__ ws,
    int tiles_per_split) {
  constexpr int BK = Fmt<FMT>::BK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);     // [kBM][kF32LD]
  float* wsm = xs + kBM * kF32LD;                 // [kBN][kF32LD]

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, z = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nk = TAIL ? (K + BK - 1) / BK : K / BK;
  const int kt0 = z * tiles_per_split, kt1 = min(nk, kt0 + tiles_per_split);
  const int G = K / kGroup;

  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = part[i][c] = 0.f;

  for (int k0 = kt0 * BK; k0 < kt1 * BK; k0 += kF32K) {
    __syncthreads();                              // the last step's readers are done
    for (int e = threadIdx.x; e < kBM * (kF32K / 4); e += kF32Threads) {
      const int r = e / (kF32K / 4), c = (e % (kF32K / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M) {
        if constexpr (TAIL) {
          const uint4 u = load16(x + (size_t)(m0 + r) * K, (k0 + c) * 4, K * 4);
          v = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                          __uint_as_float(u.w));
        } else {
          v = *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * K + k0 + c);
        }
      }
      float* dst = xs + r * kF32LD + c;
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    stage_w_f32<FMT, TAIL>(wsm, w, N, K, n0, k0);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kF32K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[(4 * ty + i) * kF32LD + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = wsm[(tx + 16 * c) * kF32LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (FMT == kQ4G) part[i][c] = fmaf(a[i], b[c], part[i][c]);
          else acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
        }
    }
    if (FMT == kQ4G) {                            // the group's partial sums, scaled
      const int grp = k0 / kGroup;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n0 + tx + 16 * c;
        const float sc = col < N ? s[(size_t)col * G + grp] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][c] += part[i][c] * sc;
          part[i][c] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = m0 + 4 * ty + i, col = n0 + tx + 16 * c;
      if (r >= M || col >= N) continue;
      if (ws != nullptr) ws[((size_t)z * M + r) * N + col] = acc[i][c];
      else y[(size_t)r * N + col] = FMT == kQ4G ? acc[i][c] : acc[i][c] * s[col];
    }
  }
}

__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// y = TY(sum_z ws[z] (* scale[o] when `s` is given)), z in order.
template <typename TY>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, int splits, int M, int N,
                                     const float* __restrict__ s, TY* __restrict__ y) {
  const size_t MN = (size_t)M * N;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < MN;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[z * MN + e];
    if (s != nullptr) v *= s[e % N];
    store_out(y + e, v);
  }
}

// x, y of type TX (bf16: the mma.sync kernel; float: the FFMA kernel); TAIL:
// K is not a multiple of the 128-column k-tile (the instance that masks it)
template <int FMT, typename TX, bool TAIL>
int launch(const void* x, int M, int K, const void* w, const void* s, int N, void* y,
           void* ws, int splits, int tiles_per_split, cudaStream_t st) {
  constexpr int BK = Fmt<FMT>::BK;
  constexpr bool f32 = std::is_same<TX, float>::value;
  static bool smem_set = false;             // once per kernel instance
  cudaError_t err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  float* split_ws = splits > 1 ? (float*)ws : nullptr;
  if constexpr (f32) {
    const int smem = (kBM + kBN) * kF32LD * (int)sizeof(float);
    if (!smem_set) {
      err = cudaFuncSetAttribute(qmm_f32_kernel<FMT, TAIL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      smem_set = true;
    }
    qmm_f32_kernel<FMT, TAIL><<<grid, kF32Threads, smem, st>>>(
        (const float*)x, M, K, (const uint8_t*)w, (const float*)s, N, (float*)y, split_ws,
        tiles_per_split);
  } else {
    const int smem = (kBM + kBN) * (BK + kPad) * (int)sizeof(bf16);
    if (!smem_set) {
      err = cudaFuncSetAttribute(qmm_kernel<FMT, TAIL>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      smem_set = true;
    }
    qmm_kernel<FMT, TAIL><<<grid, kThreads, smem, st>>>(
        (const bf16*)x, M, K, (const uint8_t*)w, (const float*)s, N, (bf16*)y, split_ws,
        tiles_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t MN = (size_t)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  splitk_reduce_kernel<TX><<<blocks, 256, 0, st>>>((const float*)ws, splits, M, N,
                                                    FMT == kQ4G ? nullptr : (const float*)s,
                                                    (TX*)y);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7 at M >= 64 rows of bf16 x: wgmma with the weights dequantized in registers
// ---------------------------------------------------------------------------
// y^T = W . x^T, so the int4 weights are wgmma's A operand, which may come from
// registers: they never pass through shared memory as bf16. A block owns 128
// output rows (two consumer warpgroups of 64) x 128 tokens; a producer warp
// streams one packed block a stage (256 columns of x: groups 2b and 2b+1) by
// TMA into a 2-stage mbarrier ring: x [128 tokens][256] bf16 as four 128-byte
// swizzled [128][64] chunks (wgmma's B, K-major in x's natural [M, K] layout)
// and the packed weights [128 rows][128 bytes], swizzled the same way.
//   - The A fragment of a k16 step (lane (g, t) of warp w: rows 16 w + g and
//     + 8, k = 2t, 2t+1 and 2t+8, 2t+9) is two 16-bit shared loads a row of
//     the packed bytes 16 kk + 2t (+ 8): their low nibbles are group 2b's
//     pair, their high nibbles group 2b+1's in the same fragment slot, so one
//     staged tile feeds both groups. (ldmatrix's b16 layout would hand a lane
//     bytes 4t..4t+3, not the pairs the fragment needs.)
//   - Exact nibble -> bf16: the two bytes spread to [b0, 0, b1, 0] (prmt),
//     (x & 0x000F000F) ^ 0x43084308 (one lop3) is 0x4300 | (n ^ 8), bf16
//     128 + (n + 8) with an ulp of 1, and one bf16x2 subtract of 136 leaves n
//     in -8..7 exactly.
//   - Group scaling without a second rounding: a group's eight k16 wgmmas go
//     into a fresh fp32 `part` (scale-d 0 on the first); after they retire,
//     acc += part * s[o, g] (two scales a thread a group: rows g and g + 8).
//     Group 2b+1's fragments are converted while group 2b's wgmmas run. One
//     `part` (acc 64 + part 64 + two groups' fragments 64 registers a
//     thread): a second one would not fit beside them. Those 192 registers
//     spilled 1040 bytes under the 168 a thread of a 288-thread block gets,
//     so the producer is a whole warpgroup that hands its registers to the
//     consumers (setmaxnreg: 40 for it, 232 for them).
//   - Epilogue: the accumulator is y^T; each warpgroup stages its 64 x 128
//     tile as bf16 [tokens][outputs] in shared memory and writes y in 16-byte
//     rows. With a split over K (few tiles, few rows), fp32 partial sums go to
//     the workspace from registers and the reduction kernel adds them in
//     order.
constexpr int kWgRows = 128, kWgTok = 128, kWgBK = 2 * kGroup, kWgStages = 2;
constexpr int kWgThreads = 384;        // two consumer warpgroups, one producer
constexpr int kYPitch = 72;           // bf16 pitch of the epilogue's [tokens][64] rows

struct Q4gParams {
  CUtensorMap x, w;
  const float* s;
  bf16* y;
  float* ws;
  int M, N, K, kb_per_split;
};

// The A fragments of one group (HI: 2b + 1) for the warpgroup's 64 rows
// from the swizzled packed tile `wt` ([128 rows][128 bytes]).
template <bool HI>
__device__ __forceinline__ void q4g_frags(uint32_t (&a)[8][4], const unsigned char* wt,
                                          int row0, int t) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = row0 + 8 * (x & 1), j = 8 * (x >> 1) + 2 * t;
      const uint32_t two = *reinterpret_cast<const uint16_t*>(
          wt + row * 128 + ((kk ^ (row & 7)) << 4) + j);
      a[kk][x] = nibbles_bf16x2<HI>(two);
    }
}

// issue part = A . x-tile columns of group `half` (eight k16 steps)
__device__ __forceinline__ void q4g_issue(float (&part)[64], const uint32_t (&a)[8][4],
                                          const bf16* xs, int half) {
  fence_acc(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int chunk = 2 * half + (kk >> 2), col = (kk & 3) * 16;
    wgmma_rs_kmajor128(part, a[kk], sw128_desc(xs + chunk * kWgTok * 64 + col, 16, 1024),
                       kk > 0);
  }
  wgmma_commit();
}

// wait for the group's wgmmas, then acc += part * scale; `a` (the fragments
// they read from registers) stays live and untouched until the wait
__device__ __forceinline__ void q4g_fold(float (&acc)[64], float (&part)[64], float s0,
                                         float s1, uint32_t (&a)[8][4]) {
  wgmma_wait_all();
  keep_frags(a);
  fence_acc(part);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] += part[i] * ((i & 2) ? s1 : s0);
}

__global__ void __launch_bounds__(kWgThreads, 1) q4g_wgmma_kernel(
    const __grid_constant__ Q4gParams p) {
  extern __shared__ unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(align1024(smem_raw));     // [stages][4][128][64]
  unsigned char* Ws = reinterpret_cast<unsigned char*>(Xs + kWgStages * 4 * kWgTok * 64);
  bf16* Ys = reinterpret_cast<bf16*>(Ws + kWgStages * kWgRows * 128);   // [2][128][kYPitch]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ys + 2 * kWgTok * kYPitch);
  uint64_t* empty = full + kWgStages;

  const int n0 = blockIdx.x * kWgRows, m0 = blockIdx.y * kWgTok, z = blockIdx.z;
  const int nkb = p.K / kWgBK, kb0 = z * p.kb_per_split;
  const int kb1 = min(nkb, kb0 + p.kb_per_split);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {                                                // the producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 256) {
      for (int kb = kb0; kb < kb1; ++kb) {
        const int j = kb - kb0, st = j % kWgStages;
        mbar_wait(&empty[st], ((j / kWgStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 4 * kWgTok * 128 + kWgRows * 128);
        for (int c = 0; c < 4; ++c)
          tma_load_2d(Xs + (st * 4 + c) * kWgTok * 64, &p.x, &full[st], kb * kWgBK + 64 * c,
                      m0);
        tma_load_2d(Ws + st * kWgRows * 128, &p.w, &full[st], kb * kGroup, n0);
      }
    }
    return;
  }

  regs_inc<232>();
  const int tl = threadIdx.x & 127, warp = tl >> 5, g = (tl & 31) >> 2, tq = tl & 3;
  const int row0 = 64 * wg + 16 * warp + g;                   // rows of the block's W tile
  const int o0 = n0 + row0, o1 = o0 + 8;
  const int G = p.K / kGroup;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t lo[8][4], hi[8][4];
  for (int kb = kb0; kb < kb1; ++kb) {
    const int j = kb - kb0, st = j % kWgStages;
    const float s00 = o0 < p.N ? p.s[(size_t)o0 * G + 2 * kb] : 0.f;
    const float s01 = o0 < p.N ? p.s[(size_t)o0 * G + 2 * kb + 1] : 0.f;
    const float s10 = o1 < p.N ? p.s[(size_t)o1 * G + 2 * kb] : 0.f;
    const float s11 = o1 < p.N ? p.s[(size_t)o1 * G + 2 * kb + 1] : 0.f;
    mbar_wait(&full[st], (j / kWgStages) & 1);
    const unsigned char* wt = Ws + st * kWgRows * 128;
    const bf16* xs = Xs + st * 4 * kWgTok * 64;
    q4g_frags<false>(lo, wt, row0, tq);
    q4g_issue(part, lo, xs, 0);                                  // group 2b
    q4g_frags<true>(hi, wt, row0, tq);                           // while it runs
    q4g_fold(acc, part, s00, s10, lo);
    q4g_issue(part, hi, xs, 1);                                  // group 2b + 1
    q4g_fold(acc, part, s01, s11, hi);
    mbar_arrive(&empty[st]);
  }

  // acc[i]: output row row0 + 8 ((i >> 1) & 1) of the block, token 8 (i >> 2) +
  // 2 tq + (i & 1)
  if (p.ws != nullptr) {
    float* ws = p.ws + (size_t)z * p.M * p.N;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int m = m0 + 8 * (i >> 2) + 2 * tq + (i & 1), o = (i & 2) ? o1 : o0;
      if (m < p.M && o < p.N) ws[(size_t)m * p.N + o] = acc[i];
    }
    return;
  }
  bf16* ys = Ys + wg * kWgTok * kYPitch;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int tok = 8 * (i >> 2) + 2 * tq + (i & 1), r = 16 * warp + g + ((i & 2) ? 8 : 0);
    ys[tok * kYPitch + r] = __float2bfloat16_rn(acc[i]);
  }
  named_barrier(1 + wg, 128);
  const int ob = n0 + 64 * wg;
  for (int e = tl; e < kWgTok * 8; e += 128) {
    const int tok = e >> 3, c8 = (e & 7) * 8, m = m0 + tok, o = ob + c8;
    if (m >= p.M || o >= p.N) continue;
    bf16* dst = p.y + (size_t)m * p.N + o;
    const bf16* src = ys + tok * kYPitch + c8;
    if (o + 8 <= p.N && p.N % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int c = 0; c < 8 && o + c < p.N; ++c) dst[c] = src[c];
    }
  }
}

int launch_q4g_wgmma(const void* x, int M, int K, const void* w, const void* s, int N,
                     void* y, void* ws, int splits, int kb_per_split, cudaStream_t st) {
  static bool smem_set = false;
  Q4gParams p;
  int err = encode_2d(&p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (long long)K * 2, 64,
                      kWgTok);
  if (err == 0)
    err = encode_2d(&p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K / 2, N, K / 2, 128, kWgRows);
  if (err != 0) return err;
  p.s = (const float*)s;
  p.y = (bf16*)y;
  p.ws = splits > 1 ? (float*)ws : nullptr;
  p.M = M; p.N = N; p.K = K; p.kb_per_split = kb_per_split;
  const int smem = kWgStages * (4 * kWgTok * 128 + kWgRows * 128) + 2 * kWgTok * kYPitch * 2 +
                   2 * kWgStages * (int)sizeof(uint64_t) + 1024;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(q4g_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((N + kWgRows - 1) / kWgRows, (M + kWgTok - 1) / kWgTok, splits);
  q4g_wgmma_kernel<<<grid, kWgThreads, smem, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t MN = (size_t)M * N;
  const int blocks = (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
  splitk_reduce_kernel<bf16><<<blocks, 256, 0, st>>>((const float*)ws, splits, M, N, nullptr,
                                                      (bf16*)y);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_fmt(int fmt, const void* x, int M, int K, const void* w, const void* s, int N,
               void* y, void* ws, int splits, int tiles_per_split, cudaStream_t st) {
  const bool tail = K % 128 != 0;
  if (fmt == kQ4)
    return tail ? launch<kQ4, TX, true>(x, M, K, w, s, N, y, ws, splits, tiles_per_split, st)
                : launch<kQ4, TX, false>(x, M, K, w, s, N, y, ws, splits, tiles_per_split, st);
  if (fmt == kInt8)
    return tail ? launch<kInt8, TX, true>(x, M, K, w, s, N, y, ws, splits, tiles_per_split, st)
                : launch<kInt8, TX, false>(x, M, K, w, s, N, y, ws, splits, tiles_per_split, st);
  if (fmt == kQ4G)       // K a multiple of 256 (the wrapper's rule): no tail
    return launch<kQ4G, TX, false>(x, M, K, w, s, N, y, ws, splits, tiles_per_split, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes. fmt 0 = q4 per-row, 1 = int8 per-row
// (K6), 2 = q4g group-128 (K7). x bf16 (x_f32 == 0) or fp32 (x_f32 == 1)
// [M, K]; w int8 [N, K/2] (q4, q4g) or [N, K] (int8); s fp32 [N, 1] or
// [N, K/128]; y [M, N] in x's dtype; ws fp32 [splits, M, N] when splits > 1.
// K: any for int8, even for q4 (the last k-tile is masked), a multiple of 256
// for q4g. Returns the cudaError_t of the launches.
extern "C" int slime_quant_matmul(int fmt, int x_f32, const void* x, int M, int K,
                                  const void* w, const void* s, int N, void* y, void* ws,
                                  int splits, int tiles_per_split, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return x_f32 ? launch_fmt<float>(fmt, x, M, K, w, s, N, y, ws, splits, tiles_per_split, st)
               : launch_fmt<bf16>(fmt, x, M, K, w, s, N, y, ws, splits, tiles_per_split, st);
}

// K7's wgmma instance: bf16 x [M, K] (M >= 64 in the wrapper's route), q4g w
// [N, K / 2], s fp32 [N, K / 128], y bf16 [M, N]; a split over K of
// `kb_per_split` packed blocks per blockIdx.z into ws fp32 [splits, M, N]
// when splits > 1. Returns the cudaError_t of the launches (or a tensor-map
// error code).
extern "C" int slime_quant_matmul_q4g_wgmma(const void* x, int M, int K, const void* w,
                                            const void* s, int N, void* y, void* ws,
                                            int splits, int kb_per_split, void* stream) {
  if (M < 1 || N < 1 || K < kWgBK || K % kWgBK != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  return launch_q4g_wgmma(x, M, K, w, s, N, y, ws, splits, kb_per_split, (cudaStream_t)stream);
}
