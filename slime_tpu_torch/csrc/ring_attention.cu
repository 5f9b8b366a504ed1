// K9 on Hopper (sm_90a): one ring step of exact (causal) ring attention,
// merged into fp32 online-softmax state. It replaces the pallas_call of
// slime_tpu/ops/ring_attention_rdma.py (ring_attention_rdma :148, call :168):
// the body _ring_kernel (:79) and its per-block merge _attend_block (:43).
// The TPU kernel also moves the kv blocks between chips from inside the
// kernel (make_async_remote_copy with credit tokens); on the card that
// transport lives outside the kernel, in ops/ring_attention_rdma.py (a device
// copy for virtual ranks, NCCL point-to-point for a process group, on a side
// stream, double-buffered, with the credit an event), and this kernel runs
// once per ring step on the slot that has arrived.
//
// Inputs, for R ranks held by this process (all n virtual ranks, or the one
// rank of a process group) with Sq = Sk = S / n rows each (any Sq >= 1):
//   q       [B, H, R * Sq, D] through (batch, head, sequence) strides;
//   kv      one slot [R, 2, B, KVH, Sk, D], contiguous (k, then v);
//   src     [R] int32: the rank whose kv block rank r holds at this step;
//   m, l    [2][R, B, H, Sq] fp32 state: the step reads slot `first ? - :
//           rd` and writes slot 1 - rd (blocks that own column chunks of the
//           same rows never read what another has written);
//   acc     [B, H, R * Sq, D] fp32 state, read and written in place;
//   out     [B, H, R * Sq, D] in q's dtype through strides, on the last step.
// Rank r's query i sits at global position (rank0 + r) * Sq + i, key j of the
// block at src * Sk + j; causal attention keeps q >= k.
//
// Arithmetic, as _attend_block: s = (q . k) * scale in fp32, masked scores
// -1e30, the block's softmax statistics (bm, bl, bacc) with p = exp(s - bm)
// in fp32, then m = max(m0, bm), c0 = exp(m0 - m), c1 = exp(bm - m),
// l = l0 c0 + bl c1, acc = acc0 c0 + bacc c1; on the last step acc / (l == 0
// ? 1 : l) goes out in q's dtype, so no fp32 pass follows. Step 0 attends the
// rank's own block and reads no state (m0 = -1e30, l0 = 0, acc0 = 0). Within
// a block the statistics come from an online softmax over key tiles (the TPU
// forms them over the whole block at once: the same up to rounding).
//
// Fully masked blocks. Under causality a block from a later rank (src > rank)
// is masked whole. The TPU kernel computes it anyway; its contribution is
// exactly 0 in fp32 once a finite m is set: c1 = exp(-1e30 - m) = 0 and
// c0 = 1. Step 0 gives every row a finite m, so this kernel skips such blocks:
// it only carries m and l to the other slot, or on the last step writes the
// output.
//
// Two kernels, picked by dtype and D:
//   - bf16 at D = 128 and 256: K5's forward design and main loop
//     (hopper_attention.cuh: TMA into a 128-byte-swizzled mbarrier ring, SS
//     wgmma for S = Q.K^T, RS wgmma for P.V), 128 query rows a block, two
//     consumer warpgroups and a producer warpgroup; P.V carries p as two bf16
//     halves, hi = bf16(p) and lo = bf16(p - hi), both through the tensor
//     cores, so p keeps about 2^-17 relative instead of bf16's 2^-9 (the TPU
//     kernel keeps p in fp32). Scores and m in log2 units (one exp2 a
//     score). A row tile stops at its rank's Sq: rows past it (the next
//     rank's, or TMA's zero fill) are computed and never stored; keys past
//     Sk are TMA's zero fill and masked. The state epilogue runs from
//     registers: read (m0, l0, acc0), merge, write the state back or, on the
//     last step, the bf16 output.
//   - fp32 at any D, and bf16 at every other D: FFMA tiles in the style of
//     K5's fp32 forward (flash_attention.cu flash_fwd_f32_kernel), with the
//     TPU kernel's arithmetic: q, k, v and p in fp32, exp in natural units.
//     64 query rows a block, 64-key tiles, D staged in chunks of DC = 64 or
//     128 columns with the tail past D zero; a block owns one chunk of the
//     output's columns. Plain element loads, so rows need no alignment.
// Work items are (row tile, q head of the group, kv head, batch[, column
// chunk]) folded into gridDim.x, so B * KVH has no limit beyond the grid's
// 2^31 - 1 blocks; the G heads of a kv head's group are neighbouring blocks
// and share their kv reads in L2; the rank is blockIdx.z.
//
// Bound: the tensor cores. At q [1, 32, 8192, 128], kv [1, 8, 8192, 128]
// causal over 4 ranks, 4 B H D S (S + 1) / 2 = 5.50e11 operations (1.5x that
// through the two P.V chains), against 25 MB of kv sent and the 32 MB fp32
// acc state a rank reads and writes on each attended step.
#include "attention_common.cuh"
#include "hopper_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 at D = 128, 256: the wgmma kernel
// ---------------------------------------------------------------------------
struct RingParams {
  CUtensorMap q, kv;
  const int* src;
  const float* m_in; const float* l_in; float* m_out; float* l_out;
  float* acc; bf16* out;
  long long ob, oh, os;                       // element strides of out
  int R, B, H, KVH, Sq, nt, rank0, causal, first, last;
  float scale;
};

// K9's mask: keys inside the block, causal in global positions. Rows past Sq
// are never stored, so they need no mask.
struct RingMask {
  int Sk, causal;
  long long qpos0, qpos1, kpos;               // global positions: rows g, g + 8; key 0
  long long qw_first;                         // the warpgroup's first row's position
  __device__ bool edge(int k0, int k1) const {
    return k1 > Sk || (causal && kpos + k1 - 1 > qw_first);
  }
  __device__ bool ok(int, int, int key, bool second) const {
    return key < Sk && (!causal || kpos + key <= (second ? qpos1 : qpos0));
  }
};

// (row tile, head, batch) of blockIdx.x: the G heads of a group neighbour
// each other, the heavy (last) row tiles of a causal diagonal launch first
__device__ __forceinline__ void ring_item(int e, int nt, int G, int KVH, int& t, int& h,
                                          int& hk, int& b) {
  const int gh = e % G;
  e /= G;
  t = nt - 1 - e % nt;
  e /= nt;
  hk = e % KVH;
  b = e / KVH;
  h = hk * G + gh;
}

template <int D, int BN>
__global__ void __launch_bounds__(kAttnThreads, 1) ring_attend_kernel(const __grid_constant__ RingParams p) {
  constexpr int BM = 128, NCH = D / 64;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align1024(smem_raw));    // [NCH][BM][64]
  bf16* Ks = Qs + NCH * BM * 64;                                // [stages][NCH][BN][64]
  bf16* Vs = Ks + kRingStages * NCH * BN * 64;                  // [stages][NCH][BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kRingStages * NCH * BN * 64);
  uint64_t* empty = full + kRingStages;
  uint64_t* qbar = empty + kRingStages;

  const int G = p.H / p.KVH, Sq = p.Sq, Sk = p.Sq, r = blockIdx.z;
  int t, h, hk, b;
  ring_item(blockIdx.x, p.nt, G, p.KVH, t, h, hk, b);
  const int i0 = t * BM;
  const int rank = p.rank0 + r, src = p.src[r];
  const bool masked = p.causal && src > rank;
  const int kend = masked ? 0 : (p.causal && src == rank ? min(Sk, i0 + BM) : Sk);
  const int ntiles = (kend + BN - 1) / BN;

  const int wg = threadIdx.x >> 7;
  const int tl = threadIdx.x & 127, warp = tl >> 5, g = (tl & 31) >> 2, tq = tl & 3;
  const int qw = i0 + 64 * wg;                                  // the warpgroup's first row
  const int row0 = qw + 16 * warp + g, row1 = row0 + 8;
  const long long st_base = (((long long)r * p.B + b) * p.H + h) * Sq;
  if (masked && !p.last) {                      // adds exactly 0: carry m and l over
    if (wg < 2 && tq == 0) {
      for (int x = 0; x < 2; ++x) {
        const int row = x ? row1 : row0;
        if (row < Sq) {
          p.m_out[st_base + row] = p.m_in[st_base + row];
          p.l_out[st_base + row] = p.l_in[st_base + row];
        }
      }
    }
    return;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);                                // every consumer thread
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int kb_k = (r * 2 + 0) * p.B + b, kb_v = (r * 2 + 1) * p.B + b;   // slot "batches"
  if (wg == 2) {                                  // the producer warpgroup; one thread loads
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 256 && ntiles > 0) {
      mbar_arrive_expect_tx(qbar, NCH * BM * 128);
      for (int c = 0; c < NCH; ++c)
        tma_load(Qs + c * BM * 64, &p.q, qbar, 64 * c, r * Sq + i0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % kRingStages, k0 = j * BN;
        mbar_wait(&empty[st], ((j / kRingStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * NCH * BN * 128);
        for (int c = 0; c < NCH; ++c) {
          tma_load(Ks + (st * NCH + c) * BN * 64, &p.kv, &full[st], 64 * c, k0, hk, kb_k);
          tma_load(Vs + (st * NCH + c) * BN * 64, &p.kv, &full[st], 64 * c, k0, hk, kb_v);
        }
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();
  // causal diagonal: the last tile the block loads may lie wholly above this
  // warpgroup's rows; a warpgroup wholly past Sq computes nothing
  int my_tiles = qw >= Sq ? 0 : ntiles;
  if (p.causal && src == rank && qw < Sq) my_tiles = (min(Sk, qw + 64) + BN - 1) / BN;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float bm0 = kMaskedScore, bm1 = kMaskedScore, bl0 = 0.f, bl1 = 0.f;
  if (ntiles > 0) {
    mbar_wait(qbar, 0);
    const long long qbase = (long long)rank * Sq;
    const RingMask mask{Sk, p.causal, qbase + row0, qbase + row1, (long long)src * Sk,
                        qbase + qw};
    attend_tiles<D, BN, true>(o, bm0, bm1, bl0, bl1, Qs + 64 * wg * 64, BM, Ks, Vs, full,
                              empty, ntiles, my_tiles, p.scale * kLog2e, mask);
  }

  // merge the block's (bm, bl, bacc) into the state (_attend_block :68-76),
  // in log2 units
  bl0 = quad_sum4(bl0);
  bl1 = quad_sum4(bl1);
  float c0[2], c1[2], dn[2];
  long long arow[2], orow[2];
  const int rows[2] = {row0, row1};
  const float bms[2] = {bm0, bm1}, bls[2] = {bl0, bl1};
  float* ap = p.acc + ((long long)b * p.H + h) * ((long long)p.R * Sq) * D;
  bf16* op = p.out + b * p.ob + h * p.oh;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = min(rows[x], Sq - 1);               // rows past Sq are not stored
    const float m_old = p.first ? kMaskedScore : p.m_in[st_base + row];
    const float l_old = p.first ? 0.f : p.l_in[st_base + row];
    const float mm = fmaxf(m_old, bms[x]);
    c0[x] = exp2f(m_old - mm);
    c1[x] = exp2f(bms[x] - mm);
    const float nl = l_old * c0[x] + bls[x] * c1[x];
    dn[x] = nl == 0.f ? 1.f : nl;
    arow[x] = ((long long)r * Sq + row) * D;
    orow[x] = ((long long)r * Sq + row) * p.os;
    if (!p.last && tq == 0 && rows[x] < Sq) {
      p.m_out[st_base + row] = mm;
      p.l_out[st_base + row] = nl;
    }
  }
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8) {
    const int col = 8 * n8 + 2 * tq;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (rows[x] >= Sq) continue;
      float2 a0 = make_float2(0.f, 0.f);
      if (!p.first) a0 = *reinterpret_cast<const float2*>(ap + arow[x] + col);
      const float v0 = a0.x * c0[x] + o[4 * n8 + 2 * x] * c1[x];
      const float v1 = a0.y * c0[x] + o[4 * n8 + 2 * x + 1] * c1[x];
      if (p.last)
        *reinterpret_cast<__nv_bfloat162*>(op + orow[x] + col) =
            __floats2bfloat162_rn(v0 / dn[x], v1 / dn[x]);
      else
        *reinterpret_cast<float2*>(ap + arow[x] + col) = make_float2(v0, v1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 at any D, bf16 at D other than 128 and 256: the FFMA kernel
// ---------------------------------------------------------------------------
template <typename T>
struct RingArgs {
  const T* q; const T* kv; const int* src;
  const float* m_in; const float* l_in; float* m_out; float* l_out;
  float* acc; T* out;
  long long qb, qh, qs, ob, oh, os;
  int R, B, H, KVH, Sq, D, nt, nd, rank0, causal, first, last;
  float scale;
};

constexpr int kRingThreads = 256;      // 16 row groups of 4 rows x 16 columns
constexpr int kRingLdp = kTile + 1;    // row stride of the [64][64] p tile

// Rows [r0, r0 + 64) x columns [c0, c0 + DC) of one head's [rows, D] matrix
// (row stride rs, unit column stride) into dst [64][DC + 1] as fp32; rows at
// or past `nrows` and columns at or past D are 0.
template <int DC, typename T>
__device__ __forceinline__ void ring_stage(const T* src, long long rs, int r0, int nrows, int c0,
                                           int D, float* dst) {
  for (int e = threadIdx.x; e < kTile * DC; e += kRingThreads) {
    const int r = e / DC, c = e % DC;
    dst[r * (DC + 1) + c] = r0 + r < nrows && c0 + c < D
                                ? to_f32(src[(long long)(r0 + r) * rs + c0 + c]) : 0.f;
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kRingThreads) ring_attend_ffma_kernel(const RingArgs<T> a) {
  constexpr int LD = DC + 1, NO = DC / 16, kRows = 4, kCols = kTile / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);              // [64][LD]
  float* Ks = Qs + kTile * LD;                             // [64][LD]
  float* Vs = Ks + kTile * LD;                             // [64][LD]
  float* Ps = Vs + kTile * LD;                             // [64][kRingLdp]

  const int G = a.H / a.KVH, Sq = a.Sq, Sk = a.Sq, r = blockIdx.z;
  const int oc = blockIdx.x % a.nd;
  int t, h, hk, b;
  ring_item(blockIdx.x / a.nd, a.nt, G, a.KVH, t, h, hk, b);
  const int i0 = t * kTile;
  const int rank = a.rank0 + r, src = a.src[r];
  const bool masked = a.causal && src > rank;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long long st_base = (((long long)r * a.B + b) * a.H + h) * Sq;
  if (masked && !a.last) {                      // adds exactly 0: carry m and l over
    if (oc == 0 && tx == 0)
      for (int i = 0; i < kRows; ++i) {
        const int row = i0 + ty * kRows + i;
        if (row < Sq) {
          a.m_out[st_base + row] = a.m_in[st_base + row];
          a.l_out[st_base + row] = a.l_in[st_base + row];
        }
      }
    return;
  }
  const int kend = masked ? 0 : (a.causal && src == rank ? min(Sk, i0 + kTile) : Sk);
  const T* qp = a.q + b * a.qb + h * a.qh + (long long)r * Sq * a.qs;
  const long long kv_head = (long long)Sk * a.D;
  const T* kp = a.kv + ((((long long)r * 2 + 0) * a.B + b) * a.KVH + hk) * kv_head;
  const T* vp = a.kv + ((((long long)r * 2 + 1) * a.B + b) * a.KVH + hk) * kv_head;
  const long long qpos = (long long)rank * Sq, kpos = (long long)src * Sk;

  float o[kRows][NO], m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMaskedScore;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) o[i][n] = 0.f;
  }
  const int nchunks = (a.D + DC - 1) / DC;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();                              // the previous tile is consumed
    ring_stage<DC>(vp, a.D, k0, Sk, oc * DC, a.D, Vs);
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
    for (int dc = 0; dc < nchunks; ++dc) {
      if (dc > 0) __syncthreads();                // the previous chunk is consumed
      if (nchunks > 1 || k0 == 0) ring_stage<DC>(qp, a.qs, i0, Sq, dc * DC, a.D, Qs);
      ring_stage<DC>(kp, a.D, k0, Sk, dc * DC, a.D, Ks);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < DC; ++d) {
        float qv[kRows], kv[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty * kRows + i) * LD + d];
#pragma unroll
        for (int c = 0; c < kCols; ++c) kv[c] = Ks[(tx + 16 * c) * LD + d];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = i0 + ty * kRows + i;
      float mx = kMaskedScore;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int key = k0 + tx + 16 * c;
        const bool ok = key < Sk && (!a.causal || kpos + key <= qpos + row);
        const float x = ok ? s[i][c] * a.scale : kMaskedScore;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], max16(mx));
      const float al = expf(m[i] - mn);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float pv = expf(s[i][c] - mn);
        Ps[(ty * kRows + i) * kRingLdp + tx + 16 * c] = pv;
        ls += pv;
      }
      // per-thread partial row sums; the half-warp adds them up at the end
      l[i] = l[i] * al + ls;
      m[i] = mn;
#pragma unroll
      for (int n = 0; n < NO; ++n) o[i][n] *= al;
    }
    __syncwarp();                                 // a row's p is written by its half-warp
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[kRows], vv[NO];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty * kRows + i) * kRingLdp + kk];
#pragma unroll
      for (int n = 0; n < NO; ++n) vv[n] = Vs[kk * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int n = 0; n < NO; ++n) o[i][n] = fmaf(pv[i], vv[n], o[i][n]);
    }
  }

  // merge into the state (_attend_block :68-76)
  float* ap = a.acc + ((long long)b * a.H + h) * ((long long)a.R * Sq) * a.D;
  T* op = a.out + b * a.ob + h * a.oh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float bl = sum16(l[i]);
    const int row = i0 + ty * kRows + i;
    if (row >= Sq) continue;
    const float m_old = a.first ? kMaskedScore : a.m_in[st_base + row];
    const float l_old = a.first ? 0.f : a.l_in[st_base + row];
    const float mm = fmaxf(m_old, m[i]);
    const float c0 = expf(m_old - mm), c1 = expf(m[i] - mm);
    const float nl = l_old * c0 + bl * c1;
    const float dn = nl == 0.f ? 1.f : nl;
    if (!a.last && oc == 0 && tx == 0) {
      a.m_out[st_base + row] = mm;
      a.l_out[st_base + row] = nl;
    }
    const long long arow = ((long long)r * Sq + row) * a.D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = oc * DC + tx + 16 * n;
      if (col >= a.D) continue;
      const float x = (a.first ? 0.f : ap[arow + col]) * c0 + o[i][n] * c1;
      if (a.last) from_f32(op + ((long long)r * Sq + row) * a.os + col, x / dn);
      else ap[arow + col] = x;
    }
  }
}

template <typename K, typename P>
int launch(K kernel, int threads, size_t smem, dim3 grid, const P& p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

struct Step {
  const void* q; const void* kv; const void* src; const void* m_in; const void* l_in;
  void* m_out; void* l_out; void* acc; void* out; const long long* st;
  int R, B, H, KVH, Sq, D, rank0, causal, first, last;
  float scale;
  void* stream;
};

template <int D, int BN>
int run_wgmma(const Step& s) {
  constexpr int NCH = D / 64;
  RingParams p;
  // q [B, H, R * Sq, D]: (batch, head, seq) strides st[0..2]; the slot as
  // [R * 2 * B][Sk][KVH][D] "batches"
  int err = encode_bshd(&p.q, s.q, s.B, s.R * s.Sq, s.H, D, s.st[0], s.st[2], s.st[1], 128);
  if (err == 0)
    err = encode_bshd(&p.kv, s.kv, s.R * 2 * s.B, s.Sq, s.KVH, D, (long long)s.KVH * s.Sq * D,
                      D, (long long)s.Sq * D, BN);
  if (err != 0) return err;
  p.src = (const int*)s.src;
  p.m_in = (const float*)s.m_in;
  p.l_in = (const float*)s.l_in;
  p.m_out = (float*)s.m_out;
  p.l_out = (float*)s.l_out;
  p.acc = (float*)s.acc;
  p.out = (bf16*)s.out;
  p.ob = s.st[3]; p.oh = s.st[4]; p.os = s.st[5];
  p.R = s.R; p.B = s.B; p.H = s.H; p.KVH = s.KVH; p.Sq = s.Sq;
  p.nt = (s.Sq + 127) / 128;
  p.rank0 = s.rank0; p.causal = s.causal; p.first = s.first; p.last = s.last;
  p.scale = s.scale;
  const long long blocks = (long long)p.nt * s.H * s.B;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)NCH * 128 * 128 + (size_t)2 * kRingStages * NCH * BN * 128 +
                      (2 * kRingStages + 1) * sizeof(uint64_t) + 1024;
  return launch(ring_attend_kernel<D, BN>, kAttnThreads, smem, dim3((unsigned)blocks, 1, s.R), p,
                s.stream);
}

template <typename T, int DC>
int run_ffma(const Step& s) {
  RingArgs<T> a = {};
  a.q = (const T*)s.q;
  a.kv = (const T*)s.kv;
  a.src = (const int*)s.src;
  a.m_in = (const float*)s.m_in;
  a.l_in = (const float*)s.l_in;
  a.m_out = (float*)s.m_out;
  a.l_out = (float*)s.l_out;
  a.acc = (float*)s.acc;
  a.out = (T*)s.out;
  a.qb = s.st[0]; a.qh = s.st[1]; a.qs = s.st[2];
  a.ob = s.st[3]; a.oh = s.st[4]; a.os = s.st[5];
  a.R = s.R; a.B = s.B; a.H = s.H; a.KVH = s.KVH; a.Sq = s.Sq; a.D = s.D;
  a.nt = (s.Sq + kTile - 1) / kTile;
  a.nd = (s.D + DC - 1) / DC;
  a.rank0 = s.rank0; a.causal = s.causal; a.first = s.first; a.last = s.last;
  a.scale = s.scale;
  const long long blocks = (long long)a.nt * a.nd * s.H * s.B;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * kTile * (DC + 1) + kTile * kRingLdp) * sizeof(float);
  return launch(ring_attend_ffma_kernel<T, DC>, kRingThreads, smem,
                dim3((unsigned)blocks, 1, s.R), a, s.stream);
}

}  // namespace

extern "C" {

// One ring step (see above). `strides` holds the (batch, head, sequence)
// element strides of q, then of out; q has unit stride over D. fp32 == 1:
// q, kv and out fp32; else bf16. bf16 at D = 128 and 256 takes the wgmma
// kernel (q's data and strides 16-byte aligned), everything else the FFMA
// kernel. m and l: `m_in`/`l_in` are read unless `first`, `m_out`/`l_out`
// written unless `last`.
int slime_ring_attend(const void* q, const void* kv, const void* src, const void* m_in,
                      const void* l_in, void* m_out, void* l_out, void* acc, void* out,
                      const long long* strides, int R, int B, int H, int KVH, int Sq, int D,
                      int fp32, int rank0, int causal, int first, int last, float scale,
                      void* stream) {
  if (D < 1 || Sq < 1 || R < 1 || R > 65535 || B < 1 || KVH < 1 || H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  const Step s{q, kv, src, m_in, l_in, m_out, l_out, acc, out, strides, R, B, H, KVH, Sq, D,
               rank0, causal, first, last, scale, stream};
  if (fp32) return D > 64 ? run_ffma<float, 128>(s) : run_ffma<float, 64>(s);
  if (D == 128) return run_wgmma<128, 128>(s);
  if (D == 256) return run_wgmma<256, 64>(s);
  return D > 64 ? run_ffma<bf16, 128>(s) : run_ffma<bf16, 64>(s);
}

}  // extern "C"
