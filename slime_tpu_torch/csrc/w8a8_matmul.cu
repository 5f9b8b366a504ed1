// W8A8 matmul for Hopper (sm_90a): int8 activations x int8 weights. It
// replaces the TPU kernel slime_tpu/ops/w8a8_matmul.py w8a8_matmul (:64,
// _kernel :46; called through w8a8_linear :118), which serves the quantized
// CLIP-L tower (--quantize-vision): on the serving path x is [4616, 1024] or
// [4616, 4096] bf16 (8 crops x 577 tokens) in every encoder layer.
//
// Arithmetic, exactly w8a8_matmul_ref's (w8a8_matmul.py:101-115):
//   xs[m] = am > 0 ? am * (1/127) : 1, am = max_k |x[m, k]| (fp32)
//   q[m, k] = rint(x[m, k] / xs[m])     (a true division, half to even)
//   acc = sum_k q[m, k] * w[n, k]       (int32, exact)
//   y = T((float(acc) * xs[m]) * ws[n] + b[n])
// with x and y bf16 or fp32 (T, the tower's compute dtype: JAX's kernel
// writes x.dtype); the int8 dot does not depend on it.
// The intrinsics (__fdiv_rn, __fmul_rn, __fadd_rn) keep nvcc from contracting
// the epilogue into an fma, so every rounding is the plain version's.
//
// What bounds it: at these shapes the product (116 GOP per layer) is above
// the ridge, so int8 tensor-core operations. Two launches, because the row
// quant and the product work differently and a 64-row int8 tile at K = 4096
// (256 KB) does not fit in shared memory: the TPU kernel's per-M-tile VMEM
// scratch becomes
//   1. a row pass: one block per row reduces |x| and writes q [M, K] int8 and
//      xs [M] fp32 (the scratch is a few MB in device memory, read back from
//      L2 by the product);
//   2. a tiled GEMM on mma.sync m16n8k32 s8 x s8 -> s32 tiles: a block owns a
//      64 x 64 output tile, 4 warps 32 x 32 each, k-tiles of 128 bytes staged
//      in shared memory with rows padded by 16 bytes (the fragment loads of a
//      warp hit 32 distinct banks), and the fp32 epilogue above.
// Plain 16-byte loads staged through registers: a right and simple first
// version (no cp.async, TMA or wgmma yet).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 64, kBN = 64, kBK = 128;   // tile; k-tile in bytes (= int8 columns)
constexpr int kThreads = 128;
constexpr int kLD = kBK + 16;                  // padded staged row, bytes
constexpr int kQuantThreads = 256;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// Row pass: block m quantizes row m of x.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads) row_quant_kernel(
    const T* __restrict__ x, int K, int8_t* __restrict__ q, float* __restrict__ xs) {
  __shared__ float part[kQuantThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * K;
  float am = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads) am = fmaxf(am, fabsf(to_f32(xr[k])));
  am = warp_max(am);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = am;
  __syncthreads();
  am = 0.f;
#pragma unroll
  for (int i = 0; i < kQuantThreads / 32; ++i) am = fmaxf(am, part[i]);
  const float scale = am > 0.f ? __fmul_rn(am, 1.0f / 127.0f) : 1.f;
  if (threadIdx.x == 0) xs[blockIdx.x] = scale;
  int8_t* qr = q + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    qr[k] = (int8_t)rintf(__fdiv_rn(to_f32(xr[k]), scale));
}

// c += a (16 x 32, row-major) * b (32 x 8, column-major), s8 in, s32 sum
__device__ __forceinline__ void mma16832(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [r0, r0 + 64) x bytes [k0, k0 + 128) of an int8 [R, K] matrix
// (rows past R are 0).
__device__ __forceinline__ void stage(int8_t* dst, const int8_t* __restrict__ src, int R, int K,
                                      int r0, int k0) {
  for (int e = threadIdx.x; e < kBM * (kBK / 16); e += kThreads) {
    const int r = e / (kBK / 16), c = (e % (kBK / 16)) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < R) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * K + k0 + c);
    *reinterpret_cast<uint4*>(dst + r * kLD + c) = v;
  }
}

// The m16n8k32 s8 fragments, in bytes, have the bf16 m16n8k16 layout: lane
// (g, t) holds A rows g, g + 8 at bytes 4t..4t+3 and 4t+16..4t+19, and B
// column g at depth bytes 4t..4t+3 and 4t+16..4t+19; C as for bf16.
template <typename T>
__global__ void __launch_bounds__(kThreads) w8a8_gemm_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ xs, int M, int K,
    const int8_t* __restrict__ w, const float* __restrict__ ws, const float* __restrict__ bias,
    int N, T* __restrict__ y) {
  __shared__ __align__(16) int8_t as[kBM * kLD];
  __shared__ __align__(16) int8_t bs[kBN * kLD];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    stage(as, q, M, K, m0, k0);
    stage(bs, w, N, K, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* base = as + (wm + 16 * i) * kLD + kk;
        a[i][0] = ld_u32(base + g * kLD + 4 * t);
        a[i][1] = ld_u32(base + (g + 8) * kLD + 4 * t);
        a[i][2] = ld_u32(base + g * kLD + 4 * t + 16);
        a[i][3] = ld_u32(base + (g + 8) * kLD + 4 * t + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = bs + (wn + 8 * j + g) * kLD + kk;
        const uint32_t b0 = ld_u32(base + 4 * t), b1 = ld_u32(base + 4 * t + 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma16832(acc[i][j], a[i], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + 16 * i + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn + 8 * j + 2 * t + (r & 1);
        if (row >= M || col >= N) continue;
        float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][r]), xs[row]), ws[col]);
        if (bias != nullptr) v = __fadd_rn(v, bias[col]);
        store_out(y + (size_t)row * N + col, v);
      }
    }
  }
}

template <typename T>
int launch(const void* x, int M, int K, void* q, void* xs, const void* w, const void* ws,
           const void* bias, int N, void* y, cudaStream_t st) {
  row_quant_kernel<T><<<M, kQuantThreads, 0, st>>>((const T*)x, K, (int8_t*)q, (float*)xs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8a8_gemm_kernel<T><<<grid, kThreads, 0, st>>>(
      (const int8_t*)q, (const float*)xs, M, K, (const int8_t*)w, (const float*)ws,
      (const float*)bias, N, (T*)y);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes: x bf16 (x_f32 == 0) or fp32 (x_f32
// == 1) [M, K] -> q int8 [M, K] and xs fp32 [M] (scratch the wrapper
// allocates), then y [M, N] in x's dtype from w int8 [N, K], ws fp32 [N] and
// bias fp32 [N] or null. K is a multiple of 128. Returns the cudaError_t of
// the launches.
extern "C" int slime_w8a8_matmul(int x_f32, const void* x, int M, int K, void* q, void* xs,
                                 const void* w, const void* ws, const void* bias, int N,
                                 void* y, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return x_f32 ? launch<float>(x, M, K, q, xs, w, ws, bias, N, y, st)
               : launch<bf16>(x, M, K, q, xs, w, ws, bias, N, y, st);
}
