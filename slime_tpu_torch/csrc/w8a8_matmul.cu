// W8A8 matmul for Hopper (sm_90a): int8 activations x int8 weights. It
// replaces the TPU kernel slime_tpu/ops/w8a8_matmul.py w8a8_matmul (:64,
// _kernel :46; called through w8a8_linear :118), which serves the quantized
// CLIP-L tower (--quantize-vision): on the serving path x is [4616, 1024] or
// [4616, 4096] bf16 (8 crops x 577 tokens) in every encoder layer.
//
// Arithmetic, exactly w8a8_matmul_ref's (w8a8_matmul.py:101-115):
//   xs[m] = am > 0 ? am * (1/127) : 1, am = max_k |x[m, k]| (fp32)
//   q[m, k] = rint(x[m, k] / xs[m])     (a true division, half to even)
//   acc = sum_k q[m, k] * w[n, k]       (int32, exact in any order)
//   y = T((float(acc) * xs[m]) * ws[n] + b[n])
// with x and y bf16 or fp32 (T, the tower's compute dtype: JAX's kernel
// writes x.dtype); the int8 product does not depend on it. The intrinsics
// (__fdiv_rn, __fmul_rn, __fadd_rn) keep nvcc from contracting the epilogue
// into an fma, so every rounding is the plain version's: the kernel is bit
// for bit the plain version.
//
// What bounds it: at the ViT's shapes the product (29-39 GOP a linear) is
// above the ridge, so int8 tensor-core operations; only out_proj's
// [1024, 1024] is bytes. Two launches, because a 128-row int8 tile at K =
// 4096 (512 KB) does not fit in shared memory: the TPU kernel's per-M-tile
// VMEM scratch becomes
//   1. a row pass at memory bandwidth: 1-8 warps a row, its 16-byte loads
//      of x all in flight at once and held in registers, q [M, Kp] int8
//      written with its row padded to Kp = round_up(K, 16) bytes and zero past
//      K (TMA takes 16-byte row strides; zero columns add nothing), and xs [M].
//      A row whose 16-byte pieces are not aligned (K not a multiple of 8
//      bf16 or 4 fp32) takes element loads, so x is never copied;
//   2. the int8 GEMM of int8_gemm.cuh on q and the weights ("nt": TMA ring,
//      s8 wgmma, persistent grid), with the epilogue above from registers, its
//      scales and bias loaded under the tile's products, each warpgroup's
//      block staged in shared memory and written by TMA stores, on 128 x 128
//      output tiles (P3 sweeps 128 x 256 ones too; at K8's shapes they were
//      no faster on an H100).
// The row pass divides by multiplying with 1 / xs[m], with the true division
// where the two could round to different integers (quant_byte).
// The wrapper pads a weight whose K is not a multiple of 16 into a [N, Kp]
// copy once a call (the row stride TMA needs).
#include "int8_gemm.cuh"

namespace {

constexpr int kRowWarps = 8;                   // warps a block of the row pass
constexpr int kRowVecs = 4;                    // 16-byte pieces of a row a lane holds

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// the V = 16 / sizeof(T) values of one 16-byte load
__device__ __forceinline__ void unpack16(float (&v)[8], uint4 u, const bf16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}
__device__ __forceinline__ void unpack16(float (&v)[4], uint4 u, const float*) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

// rint(v / scale), the quotient correctly rounded (__fdiv_rn), as a byte.
// v * inv (inv = 1 / scale rounded) lies within 2 ulp of that quotient
// (|v / scale| <= 127, so 2 ulp < 2^-15): their rints agree unless the
// quotient lies within 1e-4 of a half-integer, where the true division is
// taken. So the result is bit for bit the plain version's at a multiply's
// cost, where the IEEE division alone bounded the pass at K = 4096.
__device__ __forceinline__ uint32_t quant_byte(float v, float scale, float inv) {
  const float t = __fmul_rn(v, inv);
  const float f = t - floorf(t);
  const float r = fabsf(f - 0.5f) > 1e-4f ? rintf(t) : rintf(__fdiv_rn(v, scale));
  return (uint32_t)(uint8_t)(int8_t)r;
}

// q's V = 16 / sizeof(T) bytes of one 16-byte piece of x at qr + k
template <typename T>
__device__ __forceinline__ void quant_store(int8_t* qr, int k, uint4 u, float scale, float inv,
                                            const T* t) {
  constexpr int V = 16 / sizeof(T);
  float v[V];
  unpack16(v, u, t);
  uint32_t w[V / 4];
#pragma unroll
  for (int j = 0; j < V / 4; ++j)
    w[j] = quant_byte(v[4 * j], scale, inv) | quant_byte(v[4 * j + 1], scale, inv) << 8 |
           quant_byte(v[4 * j + 2], scale, inv) << 16 |
           quant_byte(v[4 * j + 3], scale, inv) << 24;
  if (V == 8)
    *reinterpret_cast<uint2*>(qr + k) = make_uint2(w[0], w[V / 4 - 1]);
  else
    *reinterpret_cast<uint32_t*>(qr + k) = w[0];
}

template <typename T>
__device__ __forceinline__ float amax16(uint4 u, const T* t) {
  constexpr int V = 16 / sizeof(T);
  float v[V], am = 0.f;
  unpack16(v, u, t);
#pragma unroll
  for (int i = 0; i < V; ++i) am = fmaxf(am, fabsf(v[i]));
  return am;
}

__device__ __forceinline__ float row_scale(float am) {
  return am > 0.f ? __fmul_rn(am, 1.0f / 127.0f) : 1.f;
}

// Row pass: block b quantizes rows R b .. R b + R - 1 of x, R = 8 / WPR, each
// by WPR warps. With WPR > 0 a row of at most 32 WPR kRowVecs 16-byte pieces
// is loaded once into registers, every load in flight together, and its
// amax reduced across its warps in shared memory (the launch picks the
// least WPR that holds K, so every row keeps few registers and an SM many
// warps); WPR = 0 (longer or unaligned rows: a warp a row) reads the row
// twice, the second read from L1. Each block lets the GEMM start (programmatic
// dependent launch) once its rows are written.
template <typename T, int WPR>
__global__ void __launch_bounds__(32 * kRowWarps) w8a8_row_quant_kernel(
    const T* __restrict__ x, int M, int K, int Kp, int8_t* __restrict__ q,
    float* __restrict__ xs) {
  constexpr int V = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float am = 0.f;
  if constexpr (WPR > 0) {
    __shared__ float part[kRowWarps];
    const int row = blockIdx.x * (kRowWarps / WPR) + warp / WPR, piece = warp % WPR;
    const bool live = row < M;
    const T* xr = x + (size_t)row * K;
    uint4 r[kRowVecs];
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      const int k = ((i * WPR + piece) * 32 + lane) * V;
      r[i] = live && k < K ? __ldg(reinterpret_cast<const uint4*>(xr + k))
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) am = fmaxf(am, amax16(r[i], xr));
    am = warp_max(am);
    if (WPR > 1) {
      if (lane == 0) part[warp] = am;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < WPR; ++j) am = fmaxf(am, part[warp - piece + j]);
    }
    if (!live) return;
    const float scale = row_scale(am), inv = __frcp_rn(scale);
    if (piece == 0 && lane == 0) xs[row] = scale;
    int8_t* qr = q + (size_t)row * Kp;
#pragma unroll
    for (int i = 0; i < kRowVecs; ++i) {
      const int k = ((i * WPR + piece) * 32 + lane) * V;
      if (k < K) quant_store(qr, k, r[i], scale, inv, xr);
    }
    for (int k = K + piece * 32 + lane; k < Kp; k += 32 * WPR) qr[k] = 0;
    griddep_launch_dependents();
  } else {
    const int row = blockIdx.x * kRowWarps + warp;
    if (row >= M) return;
    const T* xr = x + (size_t)row * K;
    int8_t* qr = q + (size_t)row * Kp;
    const bool vec = K % V == 0;                // x's rows are then 16-byte aligned
    if (vec) {
      for (int k = lane * V; k < K; k += 32 * V)
        am = fmaxf(am, amax16(*reinterpret_cast<const uint4*>(xr + k), xr));
    } else {
      for (int k = lane; k < K; k += 32) am = fmaxf(am, fabsf(to_f32(xr[k])));
    }
    const float scale = row_scale(warp_max(am)), inv = __frcp_rn(scale);
    if (lane == 0) xs[row] = scale;
    if (vec) {
      for (int k = lane * V; k < K; k += 32 * V)
        quant_store(qr, k, *reinterpret_cast<const uint4*>(xr + k), scale, inv, xr);
    } else {
      for (int k = lane; k < K; k += 32) qr[k] = (int8_t)quant_byte(to_f32(xr[k]), scale, inv);
    }
    for (int k = K + lane; k < Kp; k += 32) qr[k] = 0;
    griddep_launch_dependents();
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
  }
}
__device__ __forceinline__ void store2(float* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
  }
}

// a pair of outputs at p in a staged tile
__device__ __forceinline__ void stage2(unsigned char* p, float a, float b, const bf16*) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void stage2(unsigned char* p, float a, float b, const float*) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// K8's epilogue: y = T((float(acc) * xs[m]) * ws[n] + b[n]) from registers.
// Each thread loads its rows' xs and its 2 BN / 8 columns' ws and bias
// before the tile's products (loaded after the last tile's stores they would
// wait on them). Where y's rows are 16-byte multiples (tma), each
// warpgroup's 64 x 128 block is staged in shared memory and TMA stored (rows
// and columns past M and N dropped), so the card writes whole lines and the
// consumers go on while the store drains; otherwise each thread stores its
// pairs.
template <typename T>
struct W8a8Epilogue {
  CUtensorMap ymap;             // y [M, N], box 128 bytes x 64 rows, 128-byte swizzle
  const float* xs;
  const float* ws;
  const float* bias;            // null: no bias
  T* y;
  int tma;

  static constexpr int kCols = 128 / sizeof(T);   // columns of a staged 128-byte row

  // each warpgroup stages its 64-row block: [BN / kCols][64][128 bytes]
  template <int BN>
  __host__ __device__ static constexpr int smem_bytes() {
    return 2 * 64 * BN * (int)sizeof(T);
  }

  template <int BN>
  struct Pre {
    float s[2];                       // xs of the thread's two rows
    float w[BN / 8][2], b[BN / 8][2];  // ws and bias of its columns
  };

  __device__ __forceinline__ static float at(const float* v, int i, int n) {
    return i < n ? __ldg(v + i) : 0.f;
  }

  template <int BN>
  __device__ __forceinline__ Pre<BN> load(const I8Ctx& ctx, int M, int N) const {
    Pre<BN> pre;
    pre.s[0] = at(xs, ctx.r0, M);
    pre.s[1] = at(xs, ctx.r0 + 8, M);
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        pre.w[n8][j] = at(ws, ctx.c0 + 8 * n8 + j, N);
        pre.b[n8][j] = bias != nullptr ? at(bias, ctx.c0 + 8 * n8 + j, N) : 0.f;
      }
    return pre;
  }

  // (row, col) of a staged half in TMA's 128-byte swizzle
  __device__ __forceinline__ static unsigned char* staged(unsigned char* st, int row, int col) {
    const int off = (col % kCols) * (int)sizeof(T);
    return st + (col / kCols) * 8192 + row * 128 + (((off >> 4) ^ (row & 7)) << 4) + (off & 15);
  }

  template <int BN>
  __device__ __forceinline__ void store(const int (&acc)[BN / 2], const Pre<BN>& pre,
                                        const I8Ctx& ctx, int M, int N) const {
    const int tl = threadIdx.x & 127, bar = 1 + ctx.wg;
    const bool even = (N & 1) == 0;
    if (tma) {                                  // the last tile's store has read the stage
      if (tl == 0) tma_store_wait<true>();
      named_barrier(bar, 128);
    }
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8) {
      const int c = ctx.c0 + 8 * n8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float s = pre.s[half];
        float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * n8 + 2 * half]), s), pre.w[n8][0]);
        float v1 =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * n8 + 2 * half + 1]), s), pre.w[n8][1]);
        if (bias != nullptr) {
          v0 = __fadd_rn(v0, pre.b[n8][0]);
          v1 = __fadd_rn(v1, pre.b[n8][1]);
        }
        const int r = ctx.r0 + 8 * half;
        if (tma) {
          stage2(staged(ctx.smem, r - ctx.m, c - ctx.n), v0, v1, y);
        } else if (r < M && c < N) {
          const bool two = c + 1 < N;
          T* dst = y + (size_t)r * N + c;
          if (two && !even) {
            store2(dst, v0, 0.f, false);
            store2(dst + 1, v1, 0.f, false);
          } else {
            store2(dst, v0, v1, two);
          }
        }
      }
    }
    if (tma) {
      fence_proxy_async();
      named_barrier(bar, 128);
      if (tl == 0) {
#pragma unroll
        for (int c = 0; c < BN / kCols; ++c)
          tma_store_2d(&ymap, ctx.smem + c * 8192, ctx.n + c * kCols, ctx.m);
        tma_store_commit();
      }
    }
  }

  __device__ __forceinline__ void finish(const I8Ctx&) const {
    if (tma && (threadIdx.x & 127) == 0) tma_store_wait<false>();
  }
};

template <typename T, int WPR>
int launch_rows(const T* x, int M, int K, int Kp, int8_t* q, float* xs, cudaStream_t st) {
  const int rows = WPR > 0 ? kRowWarps / WPR : kRowWarps;     // rows a block
  w8a8_row_quant_kernel<T, WPR><<<(M + rows - 1) / rows, 32 * kRowWarps, 0, st>>>(
      x, M, K, Kp, q, xs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, int M, int K, int Kp, void* q, void* xs, const void* w,
           const void* ws, const void* bias, int N, void* y, int grid, cudaStream_t st) {
  constexpr int kRow = 32 * kRowVecs * (16 / sizeof(T));   // elements a warp holds
  const T* xt = (const T*)x;
  int8_t* qt = (int8_t*)q;
  float* st_xs = (float*)xs;
  int err = K % (16 / sizeof(T)) != 0 ? launch_rows<T, 0>(xt, M, K, Kp, qt, st_xs, st)
            : K <= kRow               ? launch_rows<T, 1>(xt, M, K, Kp, qt, st_xs, st)
            : K <= 2 * kRow           ? launch_rows<T, 2>(xt, M, K, Kp, qt, st_xs, st)
            : K <= 4 * kRow           ? launch_rows<T, 4>(xt, M, K, Kp, qt, st_xs, st)
            : K <= 8 * kRow           ? launch_rows<T, 8>(xt, M, K, Kp, qt, st_xs, st)
                                      : launch_rows<T, 0>(xt, M, K, Kp, qt, st_xs, st);
  if (err != 0) return err;
  I8Params<W8a8Epilogue<T>> p;
  int e = encode_i8(&p.a, q, M, Kp, Kp, kI8BM);
  if (e == 0) e = encode_i8(&p.b, w, N, Kp, Kp, 128);
  W8a8Epilogue<T>& epi = p.epi;
  epi.tma = ((long long)N * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const CUtensorMapDataType yt =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (e == 0 && epi.tma)
    e = encode_2d(&epi.ymap, yt, y, N, M, (long long)N * sizeof(T), W8a8Epilogue<T>::kCols, 64);
  if (e != 0) return e;
  p.bt = nullptr;
  p.M = M;
  p.N = N;
  p.K = Kp;
  epi.xs = (const float*)xs;
  epi.ws = (const float*)ws;
  epi.bias = (const float*)bias;
  epi.y = (T*)y;
  return launch_int8_gemm<128, false>(p, grid, st, true);      // behind the row pass
}

}  // namespace

// Plain C interface, bound with ctypes: x bf16 (x_f32 == 0) or fp32 (x_f32
// == 1) [M, K] (16-byte aligned) -> q int8 [M, Kp] and xs fp32 [M] (scratch
// the wrapper allocates; Kp = round_up(K, 16)), then y [M, N] in x's dtype
// from w int8 [N, Kp] (zero past K), ws fp32 [N] and bias fp32 [N] or null,
// on 128 x 128 output tiles over `grid` persistent blocks. Returns the
// cudaError_t of the launches (or a tensor-map error code).
extern "C" int slime_w8a8_matmul(int x_f32, const void* x, int M, int K, int Kp, void* q,
                                 void* xs, const void* w, const void* ws, const void* bias,
                                 int N, void* y, int grid, void* stream) {
  if (M < 1 || N < 1 || K < 1 || Kp < K || Kp % 16 != 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return x_f32 ? launch<float>(x, M, K, Kp, q, xs, w, ws, bias, N, y, grid, st)
               : launch<bf16>(x, M, K, Kp, q, xs, w, ws, bias, N, y, grid, st);
}
