// The int8 / per-row q4 wgmma main loop of K6 (quant_matmul.cu) and K1
// (fused_decode.cu), and the split-K reduction both end with.
//
// K7's design (y^T = W . x^T, the integer weights as wgmma's register A
// operand, x by TMA as the K-major B operand) for per-row q4 and int8. A
// stage holds 128 bytes of every weight row of the block (q4: 256 columns,
// int8: 128) and those columns of x's TOK tokens, both in the 128-byte
// swizzle; the producer warpgroup streams them into a ring of stages.
//   - Per-row scales need no partial sums: the accumulator is scaled once,
//     in the epilogue. The registers K7 spends on `part` go to a taller
//     block: each consumer warpgroup owns MT m64 tiles (MT 2: 256 weight rows
//     a block), so one x tile, x being four times a q4 weight's bytes, feeds
//     twice the rows and x's traffic from L2, which bounds K7, halves.
//   - A fragments (lane (g, t): rows 16 w + g and + 8, k = 2t, 2t+1 and 2t+8,
//     2t+9 of a k16 step). q4: k 2t, 2t+1 are one byte, 8 kk + t, its low and
//     high nibble; (b * 0x1001) & 0x000F000F puts them in the two halves,
//     XOR 0x43084308 makes each bf16 128 + (n ^ 8) exactly and a bf16x2
//     subtract of 136 leaves n (K7's magic, one byte instead of two). int8:
//     one 16-bit load is the pair; bf16 cannot hold 256 integers under one
//     exponent, so each byte becomes fp32 by K1's prmt + FADD and the pair is
//     rounded to bf16x2 (exact for -128..127) by one cvt.
//   - Four k16 steps of fragments a group, two groups' registers: group q + 1
//     is converted while group q's wgmmas run (wgmma.wait_group 1), and a
//     stage goes back to the producer once its last group has retired.
//   - K past the last whole stage: TMA's zero fill; a zero nibble and a zero
//     byte convert to 0, so they add nothing.
//   - Dense bf16 weights (FMT kK6Bf16: K1's and K2's on a bf16 checkpoint)
//     need no conversion: the stage's 128 bytes of a row are 64 bf16
//     columns, which TMA writes K-major in the 128-byte swizzle, so each
//     m64 tile is wgmma's A operand straight from shared memory (SS wgmma,
//     a descriptor a k16 step, 32 bytes further each), and a stage is one
//     commit group of four k16 steps, handed back to the producer once it
//     has retired (wgmma.wait_group 1 after the next stage's group). A
//     dense stage moves twice int8's bytes a column, so its ring is
//     kK6DenseStages deep (five stages of 40 KB at MT 2, 200 KB), which an
//     H100 ran 1.2-4.5% faster than four. Dense weights have no scales (s
//     and s2 null): the epilogues and the reductions multiply by 1.
//   - TOK, the tokens a block (wgmma N): 128 for K6's prefill, 64 for K1-K3's
//     chunks (a block of rows beyond 64 loops over token tiles in
//     grid.y, each streaming the weights again).
//   - The epilogue (EPI):
//       kEpiScale: both warpgroups meet at a barrier, then stage their
//       tiles, scaled and rounded, as bf16 [tokens][rows] in the stages'
//       memory and write y in 16-byte rows; with a split over K (ws set) the
//       fp32 sums go to the workspace and splitk_reduce_kernel adds them in
//       order, scales and (K1's down, K3) adds the residual. The rows may
//       span up to three matrices (K2's [W_q; W_k; W_v]: w, w2, w3 from rows
//       0, n1, n2, each on a block boundary): the producer picks a block's
//       tensor map by its first row.
//       kEpiSwiGLU (K1's gate/up, MT 2): a warpgroup's two m64 tiles are 64
//       rows of W_gate and the same 64 rows of W_up (two tensor maps fill
//       each stage), so a thread holds g and u of the same (row, token): it
//       writes a = bf16(silu(g s_g) (u s_u)) as gate_up_kernel rounds it,
//       64 output rows a warpgroup.
#pragma once

#include "hopper_common.cuh"

namespace {

// the main loop's weight formats (K6's codes; kK6Bf16: dense bf16, K1's and K2's)
constexpr int kK6Q4 = 0, kK6Int8 = 1, kK6Bf16 = 2;
enum { kEpiScale = 0, kEpiSwiGLU = 1 };     // its epilogues
constexpr int kK6Threads = 384;             // two consumer warpgroups, one producer
constexpr int kK6SmemStages = 192 * 1024;   // shared memory for the ring of stages
constexpr int kK6DenseStages = 5;           // the dense ring's depth

// the ring's depth: kK6DenseStages for dense weights, else as many stages as
// kK6SmemStages holds, at most 4
template <int FMT, int MT, int TOK>
struct K6Cfg {
  static constexpr int BK = FMT == kK6Q4 ? 256 : FMT == kK6Int8 ? 128 : 64;  // columns a stage
  static constexpr int WCOL = FMT == kK6Bf16 ? 64 : 128;   // the weight map's columns a stage
  static constexpr int STEPS = BK / 16;                    // k16 steps a stage
  static constexpr int GROUPS = STEPS / 4;                 // fragment groups a stage
  static constexpr int XCH = BK / 64;                      // x chunks [tokens][64]
  static constexpr int ROWS = 128 * MT;                    // weight rows a block
  static constexpr int X_BYTES = XCH * TOK * 128;
  static constexpr int STAGE_BYTES = X_BYTES + ROWS * 128;
  static constexpr int STAGES = FMT == kK6Bf16 ? kK6DenseStages
      : kK6SmemStages / STAGE_BYTES < 4 ? kK6SmemStages / STAGE_BYTES : 4;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(SMEM <= 232448, "the ring exceeds a block's shared memory");
};

struct K6Params {
  CUtensorMap x, w;
  CUtensorMap w2;          // kEpiSwiGLU: W_up (w is W_gate); kEpiScale: the row space's
  CUtensorMap w3;          // second and third matrix (K2's W_k, W_v), from rows n1, n2
  const float* s;
  const float* s2;         // kEpiSwiGLU: W_up's scales
  bf16* y;
  float* ws;
  int M, N, K, kb_per_split;
  int n1, n2;              // kEpiScale: where w2's and w3's rows start (0: w alone)
};

// The A fragments of k16 steps k0 .. k0 + 3 for the warpgroup's MT m64
// tiles (rows row0 + 64 mt, + 8) from the stage's weight tile wt ([ROWS][128
// bytes], piece c of row r at c ^ (r % 8)).
template <int FMT, int MT>
__device__ __forceinline__ void k6_frags(uint32_t (&a)[MT][4][4], const unsigned char* wt,
                                         int row0, int t, int k0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int kk = k0 + s, row = row0 + 64 * mt + 8 * (x & 1);
        const unsigned char* r = wt + row * 128;
        if constexpr (FMT == kK6Q4) {
          const int byte = 8 * kk + t + 4 * (x >> 1);
          const uint32_t b = r[(((byte >> 4) ^ (row & 7)) << 4) + (byte & 15)];
          uint32_t v = ((b * 0x1001u) & 0x000F000Fu) ^ 0x43084308u;
          __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
          const uint32_t c = 0x43084308u;                       // bf16x2 (136, 136)
          h = __hsub2(h, *reinterpret_cast<const __nv_bfloat162*>(&c));
          a[mt][s][x] = *reinterpret_cast<uint32_t*>(&h);
        } else {
          const uint32_t w = (uint32_t)*reinterpret_cast<const uint16_t*>(
                                 r + ((kk ^ (row & 7)) << 4) + 2 * t + 8 * (x >> 1)) ^ 0x8080u;
          const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - 8388736.f;
          const float hi = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - 8388736.f;
          a[mt][s][x] = pack2_bf16(lo, hi);
        }
      }
}

// issue acc[mt] += A[mt] . x-tile over k16 steps k0 .. k0 + 3, one commit group
template <int MT, int TOK>
__device__ __forceinline__ void k6_issue(float (&acc)[MT][TOK / 2],
                                         const uint32_t (&a)[MT][4][4], const bf16* xs,
                                         int k0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int kk = k0 + s;
    const uint64_t desc = sw128_desc(xs + (kk >> 2) * TOK * 64 + (kk & 3) * 16, 16, 1024);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) wgmma_rs_kmajor<TOK>(acc[mt], a[mt][s], desc, 1);
  }
  wgmma_commit();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
}

// issue acc[mt] += W-tile[mt] . x-tile over a dense stage's four k16 steps,
// both operands from shared memory (wt: the warpgroup's first W-tile row,
// [64 MT][128 bytes] swizzled), one commit group
template <int MT, int TOK>
__device__ __forceinline__ void k6_issue_ss(float (&acc)[MT][TOK / 2], const unsigned char* wt,
                                            const bf16* xs) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = sw128_desc(xs + kk * 16, 16, 1024);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      wgmma_ss<TOK>(acc[mt], sw128_desc(wt + mt * 64 * 128 + kk * 32, 16, 1024), b, 1);
  }
  wgmma_commit();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
}

template <int MT>
__device__ __forceinline__ void k6_keep(uint32_t (&a)[MT][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) keep_frags(a[mt]);
}

template <int FMT, int MT, int TOK, int EPI>
__global__ void __launch_bounds__(kK6Threads, 1) qmm_wgmma_kernel(
    const __grid_constant__ K6Params p) {
  using C = K6Cfg<FMT, MT, TOK>;
  static_assert(EPI == kEpiScale || MT == 2, "the SwiGLU epilogue pairs two m64 tiles");
  constexpr int ACC = TOK / 2;                              // fp32 sums a thread a tile
  constexpr int OUT = EPI == kEpiSwiGLU ? 64 : 64 * MT;     // output rows a warpgroup
  constexpr int PITCH = OUT + 8;                            // bf16 pitch of its staged rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);       // stage i: x [XCH][TOK][64], W [ROWS][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;

  const int n0 = blockIdx.x * 2 * OUT, m0 = blockIdx.y * TOK, z = blockIdx.z;
  const int nkb = (p.K + C::BK - 1) / C::BK, kb0 = z * p.kb_per_split;
  const int kb1 = min(nkb, kb0 + p.kb_per_split);
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {                                                // the producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 256) {
      for (int kb = kb0; kb < kb1; ++kb) {
        const int j = kb - kb0, st = j % C::STAGES;
        unsigned char* stage = base + st * C::STAGE_BYTES;
        mbar_wait(&empty[st], ((j / C::STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], C::STAGE_BYTES);
        for (int c = 0; c < C::XCH; ++c)
          tma_load_2d(stage + c * TOK * 128, &p.x, &full[st], kb * C::BK + 64 * c, m0);
        if constexpr (EPI == kEpiSwiGLU) {
          // W-tile rows [64 q, 64 q + 64) are warpgroup q / 2's m64 tile q % 2:
          // W_gate's rows n0 + 64 (q / 2) .. + 63 (tile 0), then W_up's (tile 1)
          for (int q = 0; q < 4; ++q)
            tma_load_2d(stage + C::X_BYTES + q * 64 * 128, (q & 1) ? &p.w2 : &p.w, &full[st],
                        kb * C::WCOL, n0 + 64 * (q >> 1));
        } else {
          // the block's rows lie in one matrix (n1, n2 on block boundaries)
          const bool third = p.n2 > 0 && n0 >= p.n2, second = !third && p.n1 > 0 && n0 >= p.n1;
          tma_load_2d(stage + C::X_BYTES, third ? &p.w3 : second ? &p.w2 : &p.w, &full[st],
                      kb * C::WCOL, n0 - (third ? p.n2 : second ? p.n1 : 0));
        }
      }
    }
    return;
  }

  regs_inc<232>();
  const int tl = threadIdx.x & 127, warp = tl >> 5, g = (tl & 31) >> 2, tq = tl & 3;
  const int row0 = C::ROWS / 2 * wg + 16 * warp + g;          // the thread's first W-tile row
  const int orow = OUT * wg + 16 * warp + g;                   // and its first output row
  float acc[MT][ACC];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[mt][i] = 0.f;
  uint32_t fa[MT][4][4], fb[MT][4][4];         // two groups' fragments (not dense)
  for (int kb = kb0; kb < kb1; ++kb) {
    const int j = kb - kb0, st = j % C::STAGES;
    const unsigned char* stage = base + st * C::STAGE_BYTES;
    const bf16* xs = reinterpret_cast<const bf16*>(stage);
    mbar_wait(&full[st], (j / C::STAGES) & 1);
    if constexpr (FMT == kK6Bf16) {
      // the stage's one group; then the last stage's has retired
      k6_issue_ss<MT, TOK>(acc, stage + C::X_BYTES + (C::ROWS / 2 * wg) * 128, xs);
      wgmma_wait<1>();
      if (j > 0) mbar_arrive(&empty[(j - 1) % C::STAGES]);
    } else {
#pragma unroll
      for (int u = 0; u < C::GROUPS; u += 2) {
        // group u into fa (its last reader, group u - 2, has retired), then u + 1 into fb
        k6_frags<FMT, MT>(fa, stage + C::X_BYTES, row0, tq, 4 * u);
        k6_issue<MT, TOK>(acc, fa, xs, 4 * u);
        wgmma_wait<1>();                       // group u - 1 (fb) has retired
        k6_keep<MT>(fb);
        if (u == 0 && j > 0) mbar_arrive(&empty[(j - 1) % C::STAGES]);   // it was the last stage's
        k6_frags<FMT, MT>(fb, stage + C::X_BYTES, row0, tq, 4 * (u + 1));
        k6_issue<MT, TOK>(acc, fb, xs, 4 * (u + 1));
        wgmma_wait<1>();                       // group u (fa) has retired
        k6_keep<MT>(fa);
      }
    }
  }
  wgmma_wait_all();
  if constexpr (FMT != kK6Bf16) k6_keep<MT>(fb);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);

  // acc[mt][i]: W-tile row row0 + 64 mt + 8 ((i >> 1) & 1), token 8 (i >> 2) + 2 tq + (i & 1)
  if (EPI == kEpiScale && p.ws != nullptr) {
    float* ws = p.ws + (size_t)z * p.M * p.N;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int m = m0 + 8 * (i >> 2) + 2 * tq + (i & 1);
        const int o = n0 + orow + 64 * mt + ((i & 2) ? 8 : 0);
        if (m < p.M && o < p.N) ws[(size_t)m * p.N + o] = acc[mt][i];
      }
    return;
  }
  // the scales of the thread's rows: tile mt's (kEpiScale), or W_gate's and
  // W_up's of its one output row (kEpiSwiGLU); 1 for dense weights
  float sc[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = n0 + orow + (EPI == kEpiSwiGLU ? 0 : 64 * mt) + 8 * h;
      const float* s = EPI == kEpiSwiGLU && mt == 1 ? p.s2 : p.s;
      sc[mt][h] = o >= p.N ? 0.f : FMT == kK6Bf16 ? 1.f : s[o];
    }
  named_barrier(1, 256);                     // no wgmma of either warpgroup reads a stage now
  bf16* ys = reinterpret_cast<bf16*>(base) + wg * TOK * PITCH;
  if constexpr (EPI == kEpiSwiGLU) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int tok = 8 * (i >> 2) + 2 * tq + (i & 1), h = (i >> 1) & 1;
      const float gt = acc[0][i] * sc[0][h], up = acc[1][i] * sc[1][h];
      const float sig = 1.f / (1.f + expf(-gt));
      ys[tok * PITCH + 16 * warp + g + 8 * h] = __float2bfloat16_rn(gt * sig * up);
    }
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int tok = 8 * (i >> 2) + 2 * tq + (i & 1);
        const int r = 64 * mt + 16 * warp + g + ((i & 2) ? 8 : 0);
        ys[tok * PITCH + r] = __float2bfloat16_rn(acc[mt][i] * sc[mt][(i >> 1) & 1]);
      }
  }
  named_barrier(2 + wg, 128);
  const int ob = n0 + OUT * wg;
  for (int e = tl; e < TOK * OUT / 8; e += 128) {
    const int tok = e / (OUT / 8), c8 = (e % (OUT / 8)) * 8, m = m0 + tok, o = ob + c8;
    if (m >= p.M || o >= p.N) continue;
    bf16* dst = p.y + (size_t)m * p.N + o;
    const bf16* src = ys + tok * PITCH + c8;
    if (o + 8 <= p.N && p.N % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int c = 0; c < 8 && o + c < p.N; ++c) dst[c] = src[c];
    }
  }
}

// Lets the instance take its stages' dynamic shared memory: once a process
// for each instance, whichever caller launches it first. Returns the error.
template <int FMT, int MT, int TOK, int EPI>
int qmm_wgmma_smem() {
  static const cudaError_t e = cudaFuncSetAttribute(
      qmm_wgmma_kernel<FMT, MT, TOK, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K6Cfg<FMT, MT, TOK>::SMEM);
  return (int)e;
}

__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ float load_in(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_in(const float* p) { return *p; }

// y = TY(resid + sum_z ws[z] (* scale[o] when `s` is given)), z in order, the
// residual (K1's down: x) added in fp32 where it is given.
template <typename TY>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, int splits, int M, int N,
                                     const float* __restrict__ s,
                                     const TY* __restrict__ resid, TY* __restrict__ y) {
  const size_t MN = (size_t)M * N;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < MN;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[z * MN + e];
    if (s != nullptr) v *= s[e % N];
    if (resid != nullptr) v = load_in(resid + e) + v;
    store_out(y + e, v);
  }
}

// the reduction's grid: 256 threads a block, at most 4096 blocks
inline int reduce_blocks(int M, int N) {
  const size_t MN = (size_t)M * N;
  return (int)((MN + 255) / 256 < 4096 ? (MN + 255) / 256 : 4096);
}

}  // namespace
