// Helpers of the FFMA attention kernels (flash_attention.cu's fp32 and wide
// K5-K5c, ring_attention.cu's FFMA K9): tile sizes, the masked score, half-warp
// reductions over the 16 threads that share a row, and fp32 <-> element
// conversions for bf16 or fp32 inputs.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlock = 64;       // rows a block owns: queries (fwd, dq) or keys (dkdv)
constexpr int kTile = 64;        // columns a loop step visits: keys or queries
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

}  // namespace
