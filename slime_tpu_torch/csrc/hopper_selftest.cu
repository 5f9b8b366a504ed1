// Self-test of the Hopper tile vocabulary (hopper_common.cuh): one warpgroup
// loads A, B [64, 64] and V [64, 128] bf16 by TMA (128-byte swizzle, one
// mbarrier) and computes, in the operand forms the attention kernels use:
//   S  = A . B^T          SS wgmma, both K-major (Q.K^T in K4, K5, K5c)
//   T  = B . A^T          the same tiles with the roles swapped (K.Q^T in K5b)
//   O  = bf16(S) . V      RS wgmma, S's accumulator as register A fragments,
//                         V MN-major over two 64-column chunks, so LBO and SBO
//                         are both exercised (P.V in K4, K5)
//   P1 = bf16(S) . B      B, the tile S read K-major, now read MN-major
//                         (dS.K in K5c)
//   P2 = bf16(T) . A      A read MN-major (dS^T.Q and P^T.dO in K5b)
// and writes all five in fp32. tests/test_torch_kernels_cuda.py holds them to
// torch.matmul: a swizzle, descriptor or fragment mistake gives silently wrong
// numbers here, before any attention kernel is debugged.
#include "hopper_common.cuh"

namespace {

struct SelftestParams {
  CUtensorMap a, b, v;
  float* s;
  float* o;
  float* t;
  float* p1;
  float* p2;
};

// thread's accumulator element i of a 64 x N fp32 tile -> row-major offset
__device__ __forceinline__ int acc_offset(int i, int n) {
  const int t = threadIdx.x, warp = t >> 5, g = (t & 31) >> 2, q = t & 3;
  return (16 * warp + g + 8 * ((i >> 1) & 1)) * n + 8 * (i >> 2) + 2 * q + (i & 1);
}

__global__ void __launch_bounds__(128) hopper_selftest_kernel(
    const __grid_constant__ SelftestParams p) {
  extern __shared__ unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(align1024(smem_raw));   // [1][64][64]
  bf16* Bs = As + 64 * 64;                                    // [1][64][64]
  bf16* Vs = Bs + 64 * 64;                                    // [2][64][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(Vs + 2 * 64 * 64);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 4 * 64 * 64 * sizeof(bf16));
    tma_load(As, &p.a, bar, 0, 0, 0, 0);
    tma_load(Bs, &p.b, bar, 0, 0, 0, 0);
    tma_load(Vs, &p.v, bar, 0, 0, 0, 0);
    tma_load(Vs + 64 * 64, &p.v, bar, 64, 0, 0, 0);
  }
  mbar_wait(bar, 0);

  float s[32], t[32];
  qk_product<64, 64>(s, As, 64, Bs);
  qk_product<64, 64>(t, Bs, 64, As);
  uint32_t sa[4][4], ta[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    acc_to_a_frag(sa[kk], s, kk);
    acc_to_a_frag(ta[kk], t, kk);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p.s[acc_offset(i, 64)] = s[i];
    p.t[acc_offset(i, 64)] = t[i];
  }
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  pv_product<128, 64>(o, sa, Vs);
#pragma unroll
  for (int i = 0; i < 64; ++i) p.o[acc_offset(i, 128)] = o[i];
  float p1[32], p2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) p1[i] = p2[i] = 0.f;
  pv_product<64, 64>(p1, sa, Bs);
  pv_product<64, 64>(p2, ta, As);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    p.p1[acc_offset(i, 64)] = p1[i];
    p.p2[acc_offset(i, 64)] = p2[i];
  }
}

}  // namespace

extern "C" {

// a, b [64, 64] and v [64, 128] contiguous bf16; s = a . b^T, t = b . a^T,
// p1 = bf16(s) . b, p2 = bf16(t) . a [64, 64] and o = bf16(s) . v [64, 128],
// contiguous fp32.
int slime_hopper_selftest(const void* a, const void* b, const void* v, void* s, void* o,
                          void* t, void* p1, void* p2, void* stream) {
  SelftestParams p;
  int err = encode_bshd(&p.a, a, 1, 64, 1, 64, 64 * 64, 64, 64, 64);
  if (err == 0) err = encode_bshd(&p.b, b, 1, 64, 1, 64, 64 * 64, 64, 64, 64);
  if (err == 0) err = encode_bshd(&p.v, v, 1, 64, 1, 128, 64 * 128, 128, 128, 64);
  if (err != 0) return err;
  p.s = (float*)s;
  p.o = (float*)o;
  p.t = (float*)t;
  p.p1 = (float*)p1;
  p.p2 = (float*)p2;
  const size_t smem = 4 * 64 * 64 * sizeof(bf16) + sizeof(uint64_t) + 1024;
  cudaError_t e = cudaFuncSetAttribute(hopper_selftest_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  hopper_selftest_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
