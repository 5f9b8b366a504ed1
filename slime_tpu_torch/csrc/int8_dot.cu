// P3, the int8 dot probe, for Hopper (sm_90a). It replaces the TPU probe
// scripts/bench_int8_dot_probe.py pallas_dot (:59; the kernels _k_nt, _k_nn
// and _k_nn_bf16 :42-57), which measured one int8 x int8 -> int32 product in
// three operand forms at M, K, N = 32768, 1024, 4096:
//   nt       C = xq . wq^T, wq [N, K] (the layout quantize_weight stores)
//   nn       C = xq . wt,   wt [K, N]
//   nn_bf16  nn with the int32 result rounded to bf16 (through fp32, as
//            torch's int32 -> bf16 conversion: exact below 2^24, which holds
//            for |C| <= 1024 * 128^2)
// on the main loop K8 runs (int8_gemm.cuh). On the TPU the three forms ran
// at one rate; here s8 wgmma reads both operands K-major, so nt is TMA
// straight into the swizzled tiles and nn has the producer warpgroup
// transpose each [128 k][BN n] tile of wt into K-major form: what that costs
// against nt is the probe's reading.
//
// What bounds it: 275 GOP against 575 MB (int32 out) or 306 MB (bf16 out)
// at the probe's shape, so bytes for nt and nn (0.172 ms) and operations
// for nn_bf16 (0.139 ms) on an H100 SXM.
#include "int8_gemm.cuh"

namespace {

enum { kNT = 0, kNN = 1, kNNBf16 = 2 };

__device__ __forceinline__ void store_pair(int* p, int a, int b, bool pair) {
  if (pair) {
    *reinterpret_cast<int2*>(p) = make_int2(a, b);
  } else {
    p[0] = a;
  }
}
__device__ __forceinline__ void store_pair(bf16* p, int a, int b, bool pair) {
  const float fa = __int2float_rn(a), fb = __int2float_rn(b);
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(fa, fb);
  } else {
    p[0] = __float2bfloat16_rn(fa);
  }
}

// C's tile from registers, int32 or rounded to bf16
template <typename T>
struct DotEpilogue {
  T* out;
  struct Pre {};

  template <int BN>
  __host__ __device__ static constexpr int smem_bytes() { return 0; }

  template <int BN>
  __device__ __forceinline__ Pre load(const I8Ctx&, int, int) const { return Pre{}; }

  __device__ __forceinline__ void finish(const I8Ctx&) const {}

  template <int BN>
  __device__ __forceinline__ void store(const int (&acc)[BN / 2], const Pre&, const I8Ctx& ctx,
                                        int M, int N) const {
    const bool even = (N & 1) == 0;
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8) {
      const int c = ctx.c0 + 8 * n8;
      if (c < N) {
        const bool two = c + 1 < N;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = ctx.r0 + 8 * half;
          if (r < M) {
            T* dst = out + (size_t)r * N + c;
            const int a = acc[4 * n8 + 2 * half], b = acc[4 * n8 + 2 * half + 1];
            if (two && !even) {
              store_pair(dst, a, 0, false);
              store_pair(dst + 1, b, 0, false);
            } else {
              store_pair(dst, a, b, two);
            }
          }
        }
      }
    }
  }
};

template <typename T, bool NN>
int launch_dot(const void* xq, int M, int K, const void* w, int N, void* out, int bn, int grid,
               cudaStream_t st) {
  I8Params<DotEpilogue<T>> p;
  int e = encode_i8(&p.a, xq, M, K, K, kI8BM);
  if (e == 0 && !NN) e = encode_i8(&p.b, w, N, K, K, bn);
  if (e != 0) return e;
  if (NN) p.b = p.a;                       // unused: B comes from bt
  p.bt = NN ? (const int8_t*)w : nullptr;
  p.M = M;
  p.N = N;
  p.K = K;
  p.epi = DotEpilogue<T>{(T*)out};
  return bn == 256 ? launch_int8_gemm<256, NN>(p, grid, st)
                   : launch_int8_gemm<128, NN>(p, grid, st);
}

}  // namespace

// Plain C interface, bound with ctypes: xq int8 [M, K] and w int8 [N, K]
// (form 0, nt) or [K, N] (forms 1 nn and 2 nn_bf16) -> out [M, N] int32
// (forms 0, 1) or bf16 (form 2), on output tiles of 128 x bn (128 or 256)
// over `grid` persistent blocks. K and, for nn, N are multiples of 16; the
// operands are 16-byte aligned. Returns the cudaError_t of the launch (or a
// tensor-map error code).
extern "C" int slime_int8_dot(int form, int bn, const void* xq, int M, int K, const void* w,
                              int N, void* out, int grid, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 || (bn != 128 && bn != 256) || grid < 1 ||
      (form != kNT && N % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (form == kNT) return launch_dot<int, false>(xq, M, K, w, N, out, bn, grid, st);
  if (form == kNN) return launch_dot<int, true>(xq, M, K, w, N, out, bn, grid, st);
  if (form == kNNBf16) return launch_dot<bf16, true>(xq, M, K, w, N, out, bn, grid, st);
  return (int)cudaErrorInvalidValue;
}
