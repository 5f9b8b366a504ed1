// Weight-streaming kernels for one decode step of a Llama layer, for Hopper
// (sm_90a). They replace three TPU kernels of the JAX package:
//   slime_tpu/ops/fused_qkvo.py  fused_qkv_decode  (_qkv_kernel)
//   slime_tpu/ops/fused_qkvo.py  fused_o_residual  (_o_kernel)
//   slime_tpu/ops/fused_mlp.py   fused_mlp_decode  (_kernel)
//
// What bounds them on this card: bytes. At batch 1 a decode step of the 8B
// model streams about 7 GB of int8 weights and does two flops per weight byte,
// far below the H100's ridge (about 295 bf16 flops per byte of HBM). So the
// kernels spend nothing on tensor cores and everything on reading each weight
// row once, with wide coalesced loads:
//   - one warp owns one output row; every lane loads 16 bytes of the row per
//     step, so a warp reads 512 contiguous bytes at a time;
//   - the activations (B rows, 8 KB each at H = 4096 in bf16) are read through
//     L1/L2, where they stay hot: they are small next to the weights;
//   - the batch runs in tiles of kBT rows, so each lane keeps kBT fp32
//     accumulators in registers; a weight row is re-read from L2 once per
//     tile. Any B runs in one launch: the tiles are a loop (B = 65 is 9 tiles);
//   - activations are bf16 or fp32 (TA, the caller's compute dtype: JAX's
//     kernels compute in the dtype of their input); weights are dense (bf16,
//     or fp32 with fp32 activations), per-row int8 or q4g. int8, int4 and bf16
//     convert to fp32 exactly (JAX's astype(x.dtype)), every dot accumulates
//     in fp32, and the per-row int8 scale multiplies the fp32 result, as on
//     the TPU; the outputs round to TA;
//   - q4g (group-128 int4, half the int8 bytes): packed block b of a row (128
//     bytes) holds group 2b in its low nibbles and group 2b+1 in its high
//     nibbles, so a lane's 16 packed bytes at offset j of block b are the
//     columns 2b*128 + j..j+15 and (2b+1)*128 + j..j+15. The lane keeps one
//     fp32 partial sum per group over those 16 columns and scales it by the
//     group's scale when it is done (_q4g_contract's per-group partial sums,
//     fused_mlp.py:126-211); scales are the canonical [out, in/128].
// The TPU kernels pick the layer by scalar prefetch; here the wrapper passes a
// pointer to layer li of the contiguous [L, out, in] stack, which is a view.
// The MLP runs as two launches: gate/up into a [B, I] scratch in the
// activations' dtype (a few tens of KB a row, which stays in L2), then down
// plus the residual.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // output rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kBT = 8;                    // batch rows per tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 16 bytes of one weight row -> N fp32 values (exact for int8 and bf16).
template <typename TW> struct WVec;

template <> struct WVec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};

template <> struct WVec<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(const int8_t* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[4 * i + j] = static_cast<float>(static_cast<int8_t>((w[i] >> (8 * j)) & 0xffu));
      }
    }
  }
};

template <> struct WVec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf16_lo(w[i]);
      f[2 * i + 1] = bf16_hi(w[i]);
    }
  }
};

// N (a multiple of 8) bf16 or (of 4) fp32 activations -> fp32, 16-byte loads.
template <int N>
__device__ __forceinline__ void load_act(const bf16* p, float* f) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    const uint4 v = q[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[8 * c + 2 * i] = bf16_lo(w[i]);
      f[8 * c + 2 * i + 1] = bf16_hi(w[i]);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_act(const float* p, float* f) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float4 v = reinterpret_cast<const float4*>(p)[c];
    f[4 * c] = v.x; f[4 * c + 1] = v.y; f[4 * c + 2] = v.z; f[4 * c + 3] = v.w;
  }
}

__device__ __forceinline__ float act_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float act_f32(float x) { return x; }
__device__ __forceinline__ void act_store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void act_store(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Weight formats of the kernels (the wrappers' format codes): dense bf16,
// per-row int8, q4g, dense fp32 (with fp32 activations only).
enum { kDense = 0, kInt8 = 1, kQ4G = 2, kDenseF32 = 3 };

// acc[b] = sum_k h[b, k] * w[k] for the nb (<= kBT) activation rows at h
// (row stride K), summed over the warp: every lane returns the full sums.
// K is a multiple of 16 bytes of weights (the wrapper checks).
template <typename TW, typename TA>
__device__ __forceinline__ void row_dot(const TA* __restrict__ h, int K, int nb,
                                        const TW* __restrict__ w, float* acc) {
  constexpr int N = WVec<TW>::N;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < kBT; ++b) acc[b] = 0.f;
  for (int k = lane * N; k < K; k += 32 * N) {
    float wf[N];
    WVec<TW>::load(w + k, wf);
#pragma unroll
    for (int b = 0; b < kBT; ++b) {
      if (b < nb) {
        float hf[N];
        load_act<N>(h + (size_t)b * K + k, hf);
#pragma unroll
        for (int j = 0; j < N; ++j) acc[b] = fmaf(hf[j], wf[j], acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kBT; ++b) acc[b] = warp_sum(acc[b]);
}

// The q4g row dot: acc[b] = sum_g (sum_{k in g} h[b, k] * nibble[k]) * s[g]
// over the packed row w (K / 2 bytes) and its K / 128 group scales s. K is a
// multiple of 256 (the wrapper checks).
template <typename TA>
__device__ __forceinline__ void row_dot_q4g(const TA* __restrict__ h, int K, int nb,
                                            const uint8_t* __restrict__ w,
                                            const float* __restrict__ s, float* acc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < kBT; ++b) acc[b] = 0.f;
  for (int p = lane * 16; p < K / 2; p += 32 * 16) {
    const int blk = p >> 7, j = p & 127;
    const uint4 v = *reinterpret_cast<const uint4*>(w + p);
    const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
    float lo[16], hi[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t byte = (wd[i / 4] >> (8 * (i % 4))) & 0xffu;
      lo[i] = (float)((int)((byte & 0xFu) ^ 8u) - 8);
      hi[i] = (float)((int)(((byte >> 4) & 0xFu) ^ 8u) - 8);
    }
    const float s_lo = s[2 * blk], s_hi = s[2 * blk + 1];
    const int c_lo = 2 * blk * 128 + j, c_hi = c_lo + 128;
#pragma unroll
    for (int b = 0; b < kBT; ++b) {
      if (b < nb) {
        float hl[16], hh[16];
        load_act<16>(h + (size_t)b * K + c_lo, hl);
        load_act<16>(h + (size_t)b * K + c_hi, hh);
        float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          d_lo = fmaf(hl[i], lo[i], d_lo);
          d_hi = fmaf(hh[i], hi[i], d_hi);
        }
        acc[b] += d_lo * s_lo + d_hi * s_hi;
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kBT; ++b) acc[b] = warp_sum(acc[b]);
}

// acc[b] = (h[b] @ W[row]) with the row's scales applied, for weight format
// FMT: dense bf16 or fp32 (s null), int8 with one scale per row (applied to
// the fp32 sum), or q4g with K / 128 scales per row.
template <int FMT, typename TA>
__device__ __forceinline__ void scaled_row_dot(const TA* __restrict__ h, int K, int nb,
                                               const void* __restrict__ w,
                                               const float* __restrict__ s, int row,
                                               float* acc) {
  if constexpr (FMT == kQ4G) {
    row_dot_q4g(h, K, nb, static_cast<const uint8_t*>(w) + (size_t)row * (K / 2),
                s + (size_t)row * (K / 128), acc);
  } else if constexpr (FMT == kInt8) {
    row_dot<int8_t>(h, K, nb, static_cast<const int8_t*>(w) + (size_t)row * K, acc);
    const float scale = s[row];
#pragma unroll
    for (int b = 0; b < kBT; ++b) acc[b] *= scale;
  } else if constexpr (FMT == kDenseF32) {
    row_dot<float>(h, K, nb, static_cast<const float*>(w) + (size_t)row * K, acc);
  } else {
    row_dot<bf16>(h, K, nb, static_cast<const bf16*>(w) + (size_t)row * K, acc);
  }
}

// h[b] = TA(x[b] * rsqrt(mean(x[b]^2) + eps) * w), one block per row
// (fused_qkvo.py:72-77, fused_mlp.py:227-233).
template <typename TA>
__global__ void __launch_bounds__(256) rms_norm_kernel(const TA* __restrict__ x,
                                                       const float* __restrict__ w,
                                                       TA* __restrict__ h, int H, float eps) {
  __shared__ float part[32];
  const TA* xr = x + (size_t)blockIdx.x * H;
  TA* hr = h + (size_t)blockIdx.x * H;
  float ss = 0.f;
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    const float v = act_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float r = 1.f / sqrtf(part[0] / (float)H + eps);
  for (int i = threadIdx.x; i < H; i += blockDim.x) {
    act_store(hr + i, act_f32(xr[i]) * r * w[i]);
  }
}

// q, k, v = (h @ Wq.T) * sq, ... over the concatenated row space
// [0, nq) | [nq, nq + nkv) | [nq + nkv, nq + 2 nkv): one launch for all three.
template <int FMT, typename TA>
__global__ void __launch_bounds__(kThreads) qkv_kernel(
    const TA* __restrict__ h, int B, int K,
    const void* __restrict__ wq, const float* __restrict__ sq, int nq,
    const void* __restrict__ wk, const float* __restrict__ sk,
    const void* __restrict__ wv, const float* __restrict__ sv, int nkv,
    TA* __restrict__ q, TA* __restrict__ k, TA* __restrict__ v) {
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= nq + 2 * nkv) return;          // uniform over the warp
  const void* w;
  const float* s;
  TA* y;
  int n;
  if (row < nq) {
    w = wq; s = sq; y = q; n = nq;
  } else if (row < nq + nkv) {
    row -= nq; w = wk; s = sk; y = k; n = nkv;
  } else {
    row -= nq + nkv; w = wv; s = sv; y = v; n = nkv;
  }
  float acc[kBT];
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int nb = min(kBT, B - b0);
    scaled_row_dot<FMT>(h + (size_t)b0 * K, K, nb, w, s, row, acc);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int b = 0; b < kBT; ++b) {
        if (b < nb) act_store(y + (size_t)(b0 + b) * n + row, acc[b]);
      }
    }
  }
}

// y = TA(x + (h @ W.T) * s): the o projection (fused_qkvo.py:100-106) and the
// down projection with its residual (fused_mlp.py:283-292).
template <int FMT, typename TA>
__global__ void __launch_bounds__(kThreads) resid_kernel(
    const TA* __restrict__ h, int B, int K, const void* __restrict__ w,
    const float* __restrict__ s, int n, const TA* __restrict__ x, TA* __restrict__ y) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  float acc[kBT];
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int nb = min(kBT, B - b0);
    scaled_row_dot<FMT>(h + (size_t)b0 * K, K, nb, w, s, row, acc);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int b = 0; b < kBT; ++b) {
        if (b < nb) {
          const size_t i = (size_t)(b0 + b) * n + row;
          act_store(y + i, act_f32(x[i]) + acc[b]);
        }
      }
    }
  }
}

// a = TA(silu(g * sg) * (u * su)) with g = h @ Wg.T, u = h @ Wu.T
// (fused_mlp.py:274-282); silu(t) = t * sigmoid(t), as jax.nn.silu.
template <int FMT, typename TA>
__global__ void __launch_bounds__(kThreads) gate_up_kernel(
    const TA* __restrict__ h, int B, int K,
    const void* __restrict__ wg, const float* __restrict__ sg,
    const void* __restrict__ wu, const float* __restrict__ su, int n, TA* __restrict__ a) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  float g[kBT], u[kBT];
  for (int b0 = 0; b0 < B; b0 += kBT) {
    const int nb = min(kBT, B - b0);
    scaled_row_dot<FMT>(h + (size_t)b0 * K, K, nb, wg, sg, row, g);
    scaled_row_dot<FMT>(h + (size_t)b0 * K, K, nb, wu, su, row, u);
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int b = 0; b < kBT; ++b) {
        if (b < nb) {
          const float gf = g[b];
          const float uf = u[b];
          const float sig = 1.f / (1.f + expf(-gf));
          act_store(a + (size_t)(b0 + b) * n + row, gf * sig * uf);
        }
      }
    }
  }
}

inline int blocks_for(int rows) { return (rows + kWarps - 1) / kWarps; }

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers, `stream`
// is a cudaStream_t; act_f32 0 = bf16 activations and outputs, 1 = fp32; wfmt
// 0 = dense bf16 weights (scales null), 1 = int8 with per-row fp32 scales, 2 =
// q4g with fp32 scales [out, in/128], 3 = dense fp32 weights (fp32
// activations only). Each call returns cudaGetLastError() after its launch.
// B is any number of rows: the kernels loop over tiles of kBT.
extern "C" {

int slime_rms_norm(int act_f32, const void* x, const void* w, void* h, int B, int H, float eps,
                   void* stream) {
  if (act_f32)
    rms_norm_kernel<float><<<B, 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (float*)h, H, eps);
  else
    rms_norm_kernel<bf16><<<B, 256, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const float*)w, (bf16*)h, H, eps);
  return (int)cudaGetLastError();
}

// Launch KERNEL<format, activation type> for (wfmt, act_f32); dense fp32
// weights with bf16 activations are refused.
#define SLIME_DISPATCH(LAUNCH)                                   \
  if (act_f32) {                                                 \
    if (wfmt == kQ4G) LAUNCH(kQ4G, float);                       \
    else if (wfmt == kInt8) LAUNCH(kInt8, float);                \
    else if (wfmt == kDenseF32) LAUNCH(kDenseF32, float);        \
    else LAUNCH(kDense, float);                                  \
  } else {                                                       \
    if (wfmt == kDenseF32) return (int)cudaErrorInvalidValue;    \
    if (wfmt == kQ4G) LAUNCH(kQ4G, bf16);                        \
    else if (wfmt == kInt8) LAUNCH(kInt8, bf16);                 \
    else LAUNCH(kDense, bf16);                                   \
  }

int slime_qkv_gemv(int act_f32, int wfmt, const void* h, int B, int K,
                   const void* wq, const void* sq, int nq,
                   const void* wk, const void* sk, const void* wv, const void* sv, int nkv,
                   void* q, void* k, void* v, void* stream) {
  const dim3 grid(blocks_for(nq + 2 * nkv));
  cudaStream_t st = (cudaStream_t)stream;
#define SLIME_QKV(F, TA)                                                             \
  qkv_kernel<F, TA><<<grid, kThreads, 0, st>>>((const TA*)h, B, K, wq, (const float*)sq, \
                                               nq, wk, (const float*)sk, wv,          \
                                               (const float*)sv, nkv, (TA*)q, (TA*)k, \
                                               (TA*)v)
  SLIME_DISPATCH(SLIME_QKV)
#undef SLIME_QKV
  return (int)cudaGetLastError();
}

int slime_resid_gemv(int act_f32, int wfmt, const void* h, int B, int K, const void* w,
                     const void* s, int n, const void* x, void* y, void* stream) {
  const dim3 grid(blocks_for(n));
  cudaStream_t st = (cudaStream_t)stream;
#define SLIME_RESID(F, TA)                                                              \
  resid_kernel<F, TA><<<grid, kThreads, 0, st>>>((const TA*)h, B, K, w, (const float*)s, \
                                                 n, (const TA*)x, (TA*)y)
  SLIME_DISPATCH(SLIME_RESID)
#undef SLIME_RESID
  return (int)cudaGetLastError();
}

int slime_gate_up_gemv(int act_f32, int wfmt, const void* h, int B, int K, const void* wg,
                       const void* sg, const void* wu, const void* su, int n, void* a,
                       void* stream) {
  const dim3 grid(blocks_for(n));
  cudaStream_t st = (cudaStream_t)stream;
#define SLIME_GATE_UP(F, TA)                                                               \
  gate_up_kernel<F, TA><<<grid, kThreads, 0, st>>>((const TA*)h, B, K, wg, (const float*)sg, \
                                                   wu, (const float*)su, n, (TA*)a)
  SLIME_DISPATCH(SLIME_GATE_UP)
#undef SLIME_GATE_UP
  return (int)cudaGetLastError();
}

#undef SLIME_DISPATCH

// cudaError_t's text, or that of the TMA tensor-map helpers' codes
// (hopper_common.cuh: 20000 no cuTensorMapEncodeTiled entry point, 20001 + a
// CUresult when it refused a map)
const char* slime_error_string(int err) {
  if (err == 20000) return "cuTensorMapEncodeTiled: no driver entry point";
  if (err > 20000) return "cuTensorMapEncodeTiled refused the tensor map (code - 20001 is its CUresult)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
