// The int8 GEMM main loop for Hopper (sm_90a) shared by P3 (int8_dot.cu, the
// int8 dot probe) and K8 (w8a8_matmul.cu, the W8A8 matmul):
//   C[m, n] = sum_k A[m, k] B[n, k]     A int8 [M, K], B int8 [N, K] ("nt")
// or, in the "nn" form, B given as W^T [K, N]. The int32 sums are exact in any
// order; the epilogue (a template parameter) turns a tile of them into the
// caller's output.
//
// What bounds it: at K8's ViT shapes and P3's probe shape the products are
// above the card's ridge (int8 tensor-core operations), except P3's int32
// output, whose 512 MB make it bytes. The design:
//   - a persistent grid of one block an SM walks the 128 x BN output tiles,
//     N fastest (a wave of tiles shares its rows of A and reads all of B
//     once), so the producer loads the next tile while the consumers run the
//     last tile's epilogue; launched as a programmatic dependent (K8), it
//     sets up while the previous kernel of the stream ends;
//   - a producer warpgroup keeps a ring of stages in flight: each stage is
//     A [128 rows][128 bytes] and B [BN rows][128 bytes] (128 int8 of K),
//     loaded by TMA in the 128-byte swizzle with zero fill past M, N and K,
//     and completing on the stage's `full` mbarrier. It drops to few
//     registers (setmaxnreg) and hands the rest to the consumers;
//   - two consumer warpgroups, 64 rows each, issue four
//     wgmma.m64nBNk32.s32.s8.s8 a stage on int32 accumulators in registers
//     (BN / 2 a thread), keep one stage's wgmmas in flight and release the
//     stage before it to the producer (`empty`);
//   - "nn": s8 wgmma reads B only K-major, so the producer warpgroup builds
//     the K-major tile itself: each lane loads 4 rows of W^T (4 values of k)
//     x 16 columns (n) with 16-byte loads, transposes the 4 x 4 byte blocks
//     in registers (prmt) and stores one 4-byte word a column into the
//     swizzled tile (a warp's 32 words cover one 128-byte row: no bank
//     conflict). Its 128 threads arrive on `full` beside the TMA of A.
// Accumulator element i of a consumer thread (warp w of its warpgroup, g =
// lane / 4, q = lane % 4): row 16 w + g + 8 ((i >> 1) & 1) of the
// warpgroup's 64, column 8 (i >> 2) + 2 q + (i & 1) of the tile.
// The epilogue protocol (I8Ctx says where): Epi::smem_bytes<BN>() of shared
// memory for both warpgroups (named barriers 1 + wg are the epilogue's);
// Epi::load<BN>(ctx, M, N) runs before a tile's main loop and returns what
// the tile's epilogue reads from memory (its latency then hides under the
// products; loaded after the last tile's stores it would wait on them, which
// may alias); Epi::store<BN>(acc, pre, ctx, M, N) writes the warpgroup's
// block; Epi::finish(ctx) runs once at the end.
#pragma once

#include "hopper_common.cuh"

namespace {

constexpr int kI8BM = 128;          // rows of an output tile (two consumer warpgroups)
constexpr int kI8BK = 128;          // int8 of K a stage: one 128-byte swizzled row
constexpr int kI8Threads = 384;     // two consumer warpgroups and the producer

// The ring takes what the epilogue's staging (kEpi bytes) leaves of the
// block's 227 KB, at most 6 stages.
template <int BN, int kEpi>
struct I8Tile {
  static constexpr int kABytes = kI8BM * kI8BK;
  static constexpr int kBBytes = BN * kI8BK;
  static constexpr int kBudget = 232448 - 1024 - 256 - kEpi;
  static constexpr int kStages =
      kBudget / (kABytes + kBBytes) < 6 ? kBudget / (kABytes + kBBytes) : 6;
  static constexpr int kSmem = kStages * (kABytes + kBBytes) + kEpi + 2 * kStages * 8 + 1024;
};

// What the epilogue of a consumer thread works on.
struct I8Ctx {
  int m, n;                // the warpgroup's 64 x BN block of C: first row and column
  int r0, c0;              // this thread's first row (the second is r0 + 8) and column
  int wg;                  // consumer warpgroup 0 or 1 (named barrier 1 + wg)
  unsigned char* smem;     // its half of the epilogue's shared memory
};

// a: the map of A [M, K] int8 (box 128 bytes x 128 rows); b: of B [N, K]
// (box 128 bytes x BN rows), the "nt" form; bt: W^T [K, N] for "nn" (N a
// multiple of 16, rows 16-byte aligned); epi: the caller's epilogue.
template <class Epi>
struct I8Params {
  CUtensorMap a, b;
  const int8_t* bt;
  int M, N, K;
  Epi epi;
};

// Words 4w .. 4w + 3 of the 4 x 16-byte rows r (k .. k + 3) transposed: out[j]
// holds column 4w + j's four k bytes, k lowest.
__device__ __forceinline__ void transpose4x4(uint32_t (&out)[4], uint32_t x0, uint32_t x1,
                                             uint32_t x2, uint32_t x3) {
  const uint32_t t0 = __byte_perm(x0, x1, 0x5140), t1 = __byte_perm(x0, x1, 0x7362);
  const uint32_t t2 = __byte_perm(x2, x3, 0x5140), t3 = __byte_perm(x2, x3, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint4 ld_nc16(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Thread pt of the producer warpgroup builds its share of one "nn" stage: B's
// K-major swizzled tile [BN][128] for columns n0 .. n0 + BN - 1 and k0 .. k0 +
// 127 of W^T (zero past K and N).
template <int BN>
__device__ __forceinline__ void build_kmajor_tile(unsigned char* bs, const int8_t* bt, int N,
                                                  int K, int n0, int k0, int pt) {
  const int lane = pt & 31, warp = pt >> 5;
  const int k = k0 + 4 * lane;
  const int chunk = lane >> 2, within = (lane & 3) * 4;
#pragma unroll
  for (int ng = warp; ng < BN / 16; ng += 4) {
    const int n = n0 + 16 * ng;
    uint4 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = (n < N && k + i < K) ? ld_nc16(bt + (size_t)(k + i) * N + n)
                                  : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w0[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
    const uint32_t w1[4] = {r[1].x, r[1].y, r[1].z, r[1].w};
    const uint32_t w2[4] = {r[2].x, r[2].y, r[2].z, r[2].w};
    const uint32_t w3[4] = {r[3].x, r[3].y, r[3].z, r[3].w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t out[4];
      transpose4x4(out, w0[w], w1[w], w2[w], w3[w]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = 16 * ng + 4 * w + j;
        *reinterpret_cast<uint32_t*>(bs + row * 128 + ((chunk ^ (row & 7)) << 4) + within) =
            out[j];
      }
    }
  }
}

template <int BN, bool NN, class Epi>
__global__ void __launch_bounds__(kI8Threads, 1) int8_gemm_kernel(
    const __grid_constant__ I8Params<Epi> p) {
  constexpr int kEpi = Epi::template smem_bytes<BN>();
  using T = I8Tile<BN, kEpi>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = align1024(smem_raw);                     // [stages][128][128]
  unsigned char* Bs = As + T::kStages * T::kABytes;             // [stages][BN][128]
  unsigned char* Es = Bs + T::kStages * T::kBBytes;             // the epilogue's
  uint64_t* full = reinterpret_cast<uint64_t*>(Es + kEpi);
  uint64_t* empty = full + T::kStages;

  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = tiles_n * ((p.M + kI8BM - 1) / kI8BM);
  const int nkb = (p.K + kI8BK - 1) / kI8BK;
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(&full[i], NN ? 1 + 128 : 1);
      mbar_init(&empty[i], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();
  griddep_wait();                // K8: the row pass's q and xs are written

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {                                               // the producer warpgroup
    // 384 threads start at 168 registers (64512 in all): the producer keeps
    // 40 (88 for the nn transpose), the consumers take 232 (208)
    regs_dec<NN ? 88 : 40>();
    const int pt = threadIdx.x - 256;
    if (!NN && pt != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % tiles_n) * BN, m0 = (tile / tiles_n) * kI8BM;
      for (int kb = 0; kb < nkb; ++kb, ++it) {
        const int st = it % T::kStages;
        mbar_wait(&empty[st], ((it / T::kStages) & 1) ^ 1);
        if (pt == 0) {
          mbar_arrive_expect_tx(&full[st], T::kABytes + (NN ? 0 : T::kBBytes));
          tma_load_2d(As + st * T::kABytes, &p.a, &full[st], kb * kI8BK, m0);
          if (!NN) tma_load_2d(Bs + st * T::kBBytes, &p.b, &full[st], kb * kI8BK, n0);
        }
        if (NN) {
          build_kmajor_tile<BN>(Bs + st * T::kBBytes, p.bt, p.N, p.K, n0, kb * kI8BK, pt);
          fence_proxy_async();
          mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }

  regs_inc<NN ? 208 : 232>();
  const int tl = threadIdx.x & 127, warp = tl >> 5, g = (tl & 31) >> 2, q = tl & 3;
  I8Ctx ctx;
  ctx.wg = wg;
  ctx.smem = Es + wg * (kEpi / 2);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % tiles_n) * BN, m0 = (tile / tiles_n) * kI8BM;
    ctx.m = m0 + 64 * wg;
    ctx.n = n0;
    ctx.r0 = ctx.m + 16 * warp + g;
    ctx.c0 = n0 + 2 * q;
    // the epilogue's operands of this tile (scales, bias) load under the main loop
    const auto pre = p.epi.template load<BN>(ctx, p.M, p.N);
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kb = 0; kb < nkb; ++kb, ++it) {
      const int st = it % T::kStages;
      mbar_wait(&full[st], (it / T::kStages) & 1);
      const unsigned char* a = As + st * T::kABytes + wg * 64 * kI8BK;
      const unsigned char* b = Bs + st * T::kBBytes;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kI8BK / 32; ++kk)
        wgmma_s8<BN>(acc, sw128_desc(a + 32 * kk, 16, 1024), sw128_desc(b + 32 * kk, 16, 1024),
                     1);
      wgmma_commit();
      wgmma_wait<1>();                       // the last stage's products are done
      fence_acc(acc);
      if (kb > 0) mbar_arrive(&empty[(it - 1) % T::kStages]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(&empty[(it - 1) % T::kStages]);
    p.epi.template store<BN>(acc, pre, ctx, p.M, p.N);
  }
  p.epi.finish(ctx);
}

// Launch over `grid` persistent blocks (one an SM: the ring and the
// epilogue's staging take up to 227 KB of shared memory); with `pdl`, as a
// programmatic dependent of the stream's previous kernel (its set-up then
// overlaps that kernel's end). Returns the cudaError_t of the launch.
template <int BN, bool NN, class Epi>
int launch_int8_gemm(const I8Params<Epi>& p, int grid, cudaStream_t st, bool pdl = false) {
  static bool smem_set = false;              // once per instance
  const int smem = I8Tile<BN, Epi::template smem_bytes<BN>()>::kSmem;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(int8_gemm_kernel<BN, NN, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kI8Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, int8_gemm_kernel<BN, NN, Epi>, p);
}

// The map of a row-major int8 [rows, cols] operand with `pitch` bytes a row
// (a multiple of 16), box 128 bytes x box_rows rows.
inline int encode_i8(CUtensorMap* map, const void* ptr, int rows, int cols, long long pitch,
                     int box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, cols, rows, pitch, kI8BK, box_rows);
}

}  // namespace
