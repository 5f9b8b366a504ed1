// Tile helpers of the mma.sync attention kernel (ring_attention.cu: K9): bf16
// mma.sync m16n8k16 fragments with fp32 accumulation, quad reductions over the
// four lanes that hold one row of a fragment, and staging of 64-row tiles in
// padded shared memory. flash_attention.cu's FFMA kernels take its tile
// constants.
#pragma once

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

}  // namespace
