// Self-test of the Hopper tile vocabulary (hopper_common.cuh): one warpgroup
// loads A, B [64, 64] and V [64, 128] bf16 by TMA (128-byte swizzle, one
// mbarrier), computes S = A . B^T with SS wgmmas (both K-major, k16 steps
// inside one swizzled chunk) and O = bf16(S) . V with RS wgmmas (S's
// accumulator turned into register A fragments; V MN-major over two 64-column
// chunks, so LBO and SBO are both exercised), and writes S and O in fp32.
// tests/test_torch_kernels_cuda.py holds both to torch.matmul: a swizzle,
// descriptor or fragment mistake gives silently wrong numbers here, before
// either attention kernel is debugged.
#include "hopper_common.cuh"

namespace {

struct SelftestParams {
  CUtensorMap a, b, v;
  float* s;
  float* o;
};

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

  const int t = threadIdx.x, warp = t >> 5, g = (t & 31) >> 2, q = t & 3;
  float s[32];
  qk_product<64, 64>(s, As, 64, Bs);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    p.s[(16 * warp + g + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * q + (i & 1)] = s[i];
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a_frag(pa[kk], s, kk);
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  pv_product<128, 64>(o, pa, Vs);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    p.o[(16 * warp + g + 8 * ((i >> 1) & 1)) * 128 + 8 * (i >> 2) + 2 * q + (i & 1)] = o[i];
}

}  // namespace

extern "C" {

// a, b [64, 64] and v [64, 128] contiguous bf16; s [64, 64] = a . b^T and
// o [64, 128] = bf16(s) . v, contiguous fp32.
int slime_hopper_selftest(const void* a, const void* b, const void* v, void* s, void* o,
                          void* stream) {
  SelftestParams p;
  int err = encode_bshd(&p.a, a, 1, 64, 1, 64, 64 * 64, 64, 64, 64);
  if (err == 0) err = encode_bshd(&p.b, b, 1, 64, 1, 64, 64 * 64, 64, 64, 64);
  if (err == 0) err = encode_bshd(&p.v, v, 1, 64, 1, 128, 64 * 128, 128, 128, 64);
  if (err != 0) return err;
  p.s = (float*)s;
  p.o = (float*)o;
  const size_t smem = 4 * 64 * 64 * sizeof(bf16) + sizeof(uint64_t) + 1024;
  cudaError_t e = cudaFuncSetAttribute(hopper_selftest_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  hopper_selftest_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
