// The int4 design probes P1 and P4 on Hopper (sm_90a): hand-written
// counterparts of two TPU probe scripts, run by slime_tpu_torch/probes/ and by
// chip_smoke.py phase 1 (each variant held to its plain PyTorch version).
//
// P1 replaces bench_quant_kernel.py's pallas_call (`build`, :75; kernels
// kern_i32 / kern_twodot_i16, :26-73): the per-row int4 ("q4") matvec of K6,
// y[o] = bf16((sum_i x[i] w[o, i]) s[o]), x [1, 4096] bf16 against W
// [14336, 2048] packed (byte i of a row: column 2i low nibble, 2i+1 high).
// One kernel, the unpack a template parameter:
//   kI32    ((p & 0xF) ^ 8) - 8 in integers, then int -> float (the TPU
//           kernel's and K6's unpack);
//   kMagic  K7's exact conversion (hopper_common.cuh nibbles_bf16x2: prmt,
//           one lop3 to bf16 128 + (n + 8), one bf16x2 subtract of 136);
//   kTwoDot x arrives column-permuted [even | odd] and the low and high
//           nibbles go into two dot products (kern_twodot_i16).
// Each warp streams whole rows (16-byte loads, 4 a lane a row) with its
// lane's x columns held in registers, so shared memory is not touched; a
// block owns ROWS output rows (16, 64 or 256: 2, 8 or 32 rows a warp, 896,
// 224 or 56 blocks), which varies the x reloads and the blocks in flight.
// What bounds it: the 29.4 MB of packed weights, 8.8 us at 3.35 TB/s.
//
// P4 replaces scripts/bench_q4g_unpack_probe.py's pallas_call (`run`, :90;
// kernel `kern`, :54): it streams a stacked q4g gate_proj, [32, 14336, 2048]
// int8 (0.94 GB; row b-th 128-byte block: group 2b low nibbles, 2b+1 high),
// in three modes:
//   kDma       load and integer-sum the signed bytes (dp4a);
//   kUnpack    load, unpack to bf16 (the kMagic conversion) and sum the
//              values;
//   kUnpackDot load, unpack, and take each row's per-group dot with a
//              [1, 4096] bf16 activation (fp32 sums), one value a row.
// The sums come back as exact 64-bit integers (one atomic a block), the dots
// as y [rows] fp32; probes/q4g_unpack.py forms the TPU kernel's
// [8, 128] checksum from them. Bound: the 0.94 GB stream, 0.28 ms.
#include "hopper_common.cuh"

namespace {

constexpr int kProbeK = 4096;                 // unpacked columns of a row (both probes)
constexpr int kRowBytes = kProbeK / 2;        // packed bytes of a row
constexpr int kIters = kRowBytes / (32 * 16); // 16-byte loads a lane a row
constexpr int kProbeThreads = 256;

enum { kI32 = 0, kMagic = 1, kTwoDot = 2 };
enum { kDma = 0, kUnpack = 1, kUnpackDot = 2 };

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ float nib_i32(uint32_t byte, int shift) {
  return (float)((int)(((byte >> shift) & 0xFu) ^ 8u) - 8);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// P1. Lane `lane`, load it: bytes p0 .. p0 + 15 with p0 = 16 (lane + 32 it).
// kI32 / kMagic: x columns 2 p0 .. 2 p0 + 31 in natural order (pair c =
// columns 2 p0 + 2c, + 1: byte c's low and high nibble). kTwoDot: pair c < 8
// = xp[p0 + 2c, + 1] (the even half: low nibbles of bytes 2c, 2c + 1), pair
// 8 + c = xp[K / 2 + p0 + 2c, + 1] (the odd half: their high nibbles).
template <int VARIANT, int ROWS>
__global__ void __launch_bounds__(kProbeThreads) p1_matvec_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ w, const float* __restrict__ s,
    bf16* __restrict__ y, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t xr[kIters][16];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int p0 = 16 * (lane + 32 * it);
    const uint4* src = reinterpret_cast<const uint4*>(x + 2 * p0);
    if (VARIANT == kTwoDot) {
      const uint4 e = *reinterpret_cast<const uint4*>(x + p0);
      const uint4 e2 = *reinterpret_cast<const uint4*>(x + p0 + 8);
      const uint4 od = *reinterpret_cast<const uint4*>(x + kRowBytes + p0);
      const uint4 od2 = *reinterpret_cast<const uint4*>(x + kRowBytes + p0 + 8);
      const uint32_t v[16] = {e.x, e.y, e.z, e.w, e2.x, e2.y, e2.z, e2.w,
                              od.x, od.y, od.z, od.w, od2.x, od2.y, od2.z, od2.w};
#pragma unroll
      for (int c = 0; c < 16; ++c) xr[it][c] = v[c];
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 v = src[q];
        xr[it][4 * q] = v.x; xr[it][4 * q + 1] = v.y;
        xr[it][4 * q + 2] = v.z; xr[it][4 * q + 3] = v.w;
      }
    }
  }
  for (int r = warp; r < ROWS; r += kProbeThreads / 32) {
    const int o = blockIdx.x * ROWS + r;
    if (o >= N) break;
    const uint4* row = reinterpret_cast<const uint4*>(w + (size_t)o * kRowBytes);
    float acc = 0.f, acc_odd = 0.f;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const uint4 pk = __ldcs(row + lane + 32 * it);
      const uint32_t wd[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {                          // bytes 4q + 2h, + 1
          const int c = 2 * q + h;                              // byte pair index 0..7
          const uint32_t two = (wd[q] >> (16 * h)) & 0xffffu;
          if (VARIANT == kMagic) {
            const uint32_t lo = nibbles_bf16x2<false>(two), hi = nibbles_bf16x2<true>(two);
            // byte 2c: columns (lo, hi) = x pair 2c; byte 2c + 1: x pair 2c + 1
            const uint32_t xa = xr[it][2 * c], xb = xr[it][2 * c + 1];
            acc = fmaf(bf_lo(xa), bf_lo(lo), acc);
            acc = fmaf(bf_hi(xa), bf_lo(hi), acc);
            acc = fmaf(bf_lo(xb), bf_hi(lo), acc);
            acc = fmaf(bf_hi(xb), bf_hi(hi), acc);
          } else if (VARIANT == kI32) {
            const uint32_t xa = xr[it][2 * c], xb = xr[it][2 * c + 1];
            const uint32_t b0 = two & 0xffu, b1 = two >> 8;
            acc = fmaf(bf_lo(xa), nib_i32(b0, 0), acc);
            acc = fmaf(bf_hi(xa), nib_i32(b0, 4), acc);
            acc = fmaf(bf_lo(xb), nib_i32(b1, 0), acc);
            acc = fmaf(bf_hi(xb), nib_i32(b1, 4), acc);
          } else {                                              // kTwoDot
            const uint32_t xe = xr[it][c], xo = xr[it][8 + c];
            const uint32_t b0 = two & 0xffu, b1 = two >> 8;
            acc = fmaf(bf_lo(xe), nib_i32(b0, 0), acc);
            acc = fmaf(bf_hi(xe), nib_i32(b1, 0), acc);
            acc_odd = fmaf(bf_lo(xo), nib_i32(b0, 4), acc_odd);
            acc_odd = fmaf(bf_hi(xo), nib_i32(b1, 4), acc_odd);
          }
        }
      }
    }
    const float total = warp_sum(acc + acc_odd);
    if (lane == 0) y[o] = __float2bfloat16_rn(total * s[o]);
  }
}

// P4. Lane `lane`, load it: bytes p0 .. p0 + 15 with p0 = 16 (lane + 32 it)
// lie in packed block b = p0 / 128 at j0 = p0 % 128: their low nibbles
// multiply x[256 b + j0 .. + 15] (xr pairs 0-7), their high nibbles x[256 b +
// 128 + j0 .. + 15] (pairs 8-15).
template <int MODE>
__global__ void __launch_bounds__(kProbeThreads) p4_stream_kernel(
    const uint8_t* __restrict__ w, long long rows, const bf16* __restrict__ x,
    unsigned long long* __restrict__ total, float* __restrict__ y) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t xr[kIters][16];
  if (MODE == kUnpackDot) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int p0 = 16 * (lane + 32 * it), b = p0 >> 7, j0 = p0 & 127;
      const uint4* lo = reinterpret_cast<const uint4*>(x + 256 * b + j0);
      const uint4* hi = reinterpret_cast<const uint4*>(x + 256 * b + 128 + j0);
      const uint4 v[4] = {lo[0], lo[1], hi[0], hi[1]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xr[it][4 * q] = v[q].x; xr[it][4 * q + 1] = v[q].y;
        xr[it][4 * q + 2] = v[q].z; xr[it][4 * q + 3] = v[q].w;
      }
    }
  }
  long long isum = 0;
  float fsum = 0.f;
  const long long nwarps = (long long)gridDim.x * (kProbeThreads / 32);
  for (long long r = (long long)blockIdx.x * (kProbeThreads / 32) + warp; r < rows;
       r += nwarps) {
    const uint4* row = reinterpret_cast<const uint4*>(w + r * kRowBytes);
    float dot = 0.f;
    int rsum = 0;
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const uint4 pk = __ldcs(row + lane + 32 * it);
      const uint32_t wd[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (MODE == kDma) {
          rsum = __dp4a((int)wd[q], 0x01010101, rsum);
          continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t two = (wd[q] >> (16 * h)) & 0xffffu;
          const uint32_t lo = nibbles_bf16x2<false>(two), hi = nibbles_bf16x2<true>(two);
          if (MODE == kUnpack) {
            fsum += (bf_lo(lo) + bf_hi(lo)) + (bf_lo(hi) + bf_hi(hi));
          } else {
            const int c = 2 * q + h;                           // bytes 2c, 2c + 1
            const uint32_t xl = xr[it][c], xh = xr[it][8 + c];
            dot = fmaf(bf_lo(xl), bf_lo(lo), dot);
            dot = fmaf(bf_hi(xl), bf_hi(lo), dot);
            dot = fmaf(bf_lo(xh), bf_lo(hi), dot);
            dot = fmaf(bf_hi(xh), bf_hi(hi), dot);
          }
        }
      }
    }
    if (MODE == kDma) isum += rsum;
    if (MODE == kUnpackDot) {
      dot = warp_sum(dot);
      if (lane == 0) y[r] = dot;
    }
  }
  if (MODE == kUnpackDot) return;
  if (MODE == kUnpack) isum = (long long)fsum;       // small integers: exact in fp32
  // block sum, then one atomic
  __shared__ long long part[kProbeThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) isum += __shfl_xor_sync(0xffffffffu, isum, o);
  if (lane == 0) part[warp] = isum;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long b = 0;
    for (int i = 0; i < kProbeThreads / 32; ++i) b += part[i];
    atomicAdd(total, (unsigned long long)b);
  }
}

template <int V>
int p1_launch(int rows, const void* x, const void* w, const void* s, void* y, int N,
              cudaStream_t st) {
  const dim3 grid((N + rows - 1) / rows);
#define SLIME_P1(R)                                                                    \
  p1_matvec_kernel<V, R><<<grid, kProbeThreads, 0, st>>>((const bf16*)x, (const uint8_t*)w, \
                                                          (const float*)s, (bf16*)y, N)
  if (rows == 16) SLIME_P1(16);
  else if (rows == 64) SLIME_P1(64);
  else if (rows == 256) SLIME_P1(256);
  else return (int)cudaErrorInvalidValue;
#undef SLIME_P1
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// P1: variant 0 = i32, 1 = magic, 2 = twodot (x column-permuted [even | odd]);
// rows 16, 64 or 256 output rows a block. x bf16 [4096], w int8 [N, 2048], s
// fp32 [N], y bf16 [N].
int slime_p1_matvec(int variant, int rows, const void* x, const void* w, const void* s,
                    void* y, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == kI32) return p1_launch<kI32>(rows, x, w, s, y, N, st);
  if (variant == kMagic) return p1_launch<kMagic>(rows, x, w, s, y, N, st);
  if (variant == kTwoDot) return p1_launch<kTwoDot>(rows, x, w, s, y, N, st);
  return (int)cudaErrorInvalidValue;
}

// P4: mode 0 = dma, 1 = unpack (both add into *total, an int64 the caller
// zeroes), 2 = unpack_dot (y fp32 [rows]); w int8 [rows, 2048], x bf16
// [4096]. `blocks` blocks of 256 threads stride over the rows.
int slime_p4_stream(int mode, const void* w, long long rows, const void* x, void* total,
                    void* y, int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* wp = (const uint8_t*)w;
  if (mode == kDma)
    p4_stream_kernel<kDma><<<blocks, kProbeThreads, 0, st>>>(
        wp, rows, (const bf16*)x, (unsigned long long*)total, (float*)y);
  else if (mode == kUnpack)
    p4_stream_kernel<kUnpack><<<blocks, kProbeThreads, 0, st>>>(
        wp, rows, (const bf16*)x, (unsigned long long*)total, (float*)y);
  else if (mode == kUnpackDot)
    p4_stream_kernel<kUnpackDot><<<blocks, kProbeThreads, 0, st>>>(
        wp, rows, (const bf16*)x, (unsigned long long*)total, (float*)y);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
