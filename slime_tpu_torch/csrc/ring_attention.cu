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
// rank of a process group) with Sq = Sk = S / n rows each:
//   q     [B, H, R * Sq, 128] bf16 through (batch, head, sequence) strides;
//   kv    one slot [R, 2, B, KVH, Sk, 128] bf16, contiguous (k, then v);
//   src   [R] int32: the rank whose kv block rank r holds at this step;
//   m, l  [R, B, H, Sq] fp32 state; acc [B, H, R * Sq, 128] fp32 state;
//   out   [B, H, R * Sq, 128] bf16 through strides, written on the last step.
// Rank r's query i sits at global position (rank0 + r) * Sq + i, key j of the
// block at src * Sk + j; causal attention keeps q >= k.
//
// Arithmetic, as _attend_block: s = (q . k) * scale in fp32 (bf16 products
// are exact in fp32), masked scores -1e30, the block's softmax statistics
// (bm, bl, bacc) with p = exp(s - bm) in fp32, then m = max(m0, bm),
// c0 = exp(m0 - m), c1 = exp(bm - m), l = l0 c0 + bl c1, acc = acc0 c0 +
// bacc c1; on the last step acc / (l == 0 ? 1 : l) goes out in bf16, so no
// fp32 pass follows. Within a block the statistics come from an online
// softmax over 64-key tiles (the TPU forms them over the whole block at once:
// the same up to rounding). The TPU kernel keeps p in fp32 for P.V; here p is
// split into two bf16 halves, hi = bf16(p) and lo = bf16(p - hi), and both go
// through the tensor cores, so P.V carries p to about 2^-17 relative instead
// of bf16's 2^-9.
//
// Fully masked blocks. Under causality a block from a later rank (src > rank)
// is masked whole. The TPU kernel computes it anyway; its contribution is
// exactly 0 in fp32 once a finite m is set: c1 = exp(-1e30 - m) = 0 and
// c0 = 1. Step 0 attends the rank's own block, which holds the diagonal and
// gives every row a finite m, so this kernel skips such blocks (on the last
// step it only writes the output).
//
// Design and bound. Work items are (64-row tile of the G * Sq query rows of a
// kv head's group, kv head and batch, rank): the G heads of a group are
// neighbouring blocks, so they share their kv reads in L2. 4 warps of 16
// rows; mma.sync m16n8k16 bf16 tiles with fp32 accumulation, K staged
// row-major and V transposed in padded shared memory, as K5's forward
// (attention_common.cuh). What bounds the whole call is the tensor cores: at
// q [1, 32, 8192, 128], kv [1, 8, 8192, 128] causal over 4 ranks, 4 B H D
// S (S + 1) / 2 = 5.50e11 operations, 0.556 ms at 989 TFLOP/s bf16; the kv
// each rank sends, (n - 1) x 2 x B KVH (S/n) D x 2 bytes = 25 MB, is small
// beside it, and so are the 2 x 128 MB of fp32 acc state read and written per
// step. This version does nothing about that bound beyond being right and
// skipping masked blocks: wgmma and TMA come with K5's redesign.
#include "attention_common.cuh"

namespace {

struct RingArgs {
  const bf16* q; const bf16* kv; const int* src;
  float* m; float* l; float* acc; bf16* out;
  long long qb, qh, qs, ob, oh, os;       // element strides of q and out
  int R, B, H, KVH, Sq, rank0, causal, last;
  float scale;
};

// hi = bf16(x, y) and lo = bf16 of what hi leaves out, as packed pairs
__device__ __forceinline__ void split_pair(uint32_t& hi, uint32_t& lo, float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&r);
}

template <int D>
__global__ void __launch_bounds__(kThreads) ring_attend_kernel(const RingArgs a) {
  constexpr int LD = D + kPad, LDT = kTile + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);         // [kBlock][LD]
  bf16* Ks = Qs + kBlock * LD;                      // [kTile][LD]
  bf16* Vt = Ks + kTile * LD;                       // [D][LDT]

  const int G = a.H / a.KVH, Sq = a.Sq, Sk = a.Sq;
  const int hk = blockIdx.y % a.KVH, b = blockIdx.y / a.KVH, r = blockIdx.z;
  const int gr0 = blockIdx.x * kBlock;              // first row of the group's G * Sq
  const int h = hk * G + gr0 / Sq, i0 = gr0 % Sq;   // Sq % 64 == 0: one head per tile
  const int rank = a.rank0 + r, src = a.src[r];
  const bool masked = a.causal && src > rank;
  if (masked && !a.last) return;                    // contributes exactly 0 (see above)
  const int kend = masked ? 0 : (a.causal && src == rank ? i0 + kBlock : Sk);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row0 = i0 + wr + g;                     // row within the rank's shard (and + 8)
  const int qpos0 = rank * Sq + row0, qpos1 = qpos0 + 8;
  const int kpos = src * Sk;

  const long long R_rows = (long long)a.R * Sq;
  const bf16* qp = a.q + b * a.qb + h * a.qh + (long long)r * Sq * a.qs;
  const long long kv_head = (long long)Sk * D;
  const bf16* kp = a.kv + ((((long long)r * 2 + 0) * a.B + b) * a.KVH + hk) * kv_head;
  const bf16* vp = a.kv + ((((long long)r * 2 + 1) * a.B + b) * a.KVH + hk) * kv_head;

  stage<D>(qp, a.qs, i0, Sq, Qs, nullptr);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qa[kk], Qs + wr * LD + kk * 16, LD, g, t);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float bm0 = kNegInf, bm1 = kNegInf, bl0 = 0.f, bl1 = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();                              // the previous tile is consumed
    stage<D>(kp, D, k0, Sk, Ks, nullptr);
    stage<D>(vp, D, k0, Sk, nullptr, Vt);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, Ks + n * 8 * LD + kk * 16, LD, g, t);
        mma16816(s[n], qa[kk], b0, b1);
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kpos + k0 + n * 8 + 2 * t + (i & 1);
        const bool ok = !a.causal || (i < 2 ? qpos0 : qpos1) >= key;
        const float x = ok ? s[n][i] * a.scale : kNegInf;
        s[n][i] = x;
        if (i < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(bm0, quad_max(mx0)), mn1 = fmaxf(bm1, quad_max(mx1));
    const float al0 = expf(bm0 - mn0), al1 = expf(bm1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[n][i] - (i < 2 ? mn0 : mn1));
        s[n][i] = p;
        if (i < 2) ls0 += p; else ls1 += p;
      }
    }
    // per-lane partial row sums; the quad adds them up at the end
    bl0 = bl0 * al0 + ls0;
    bl1 = bl1 * al1 + ls1;
    bm0 = mn0;
    bm1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= al0; o[n][1] *= al0;
      o[n][2] *= al1; o[n][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      // the A fragment of keys 16 kk .. 16 kk + 15 (acc_to_a's layout), twice
      const float (&c07)[4] = s[2 * kk];
      const float (&c815)[4] = s[2 * kk + 1];
      uint32_t ph[4], pl[4];
      split_pair(ph[0], pl[0], c07[0], c07[1]);
      split_pair(ph[1], pl[1], c07[2], c07[3]);
      split_pair(ph[2], pl[2], c815[0], c815[1]);
      split_pair(ph[3], pl[3], c815[2], c815[3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, Vt + n * 8 * LDT + kk * 16, LDT, g, t);
        mma16816(o[n], ph, b0, b1);
        mma16816(o[n], pl, b0, b1);
      }
    }
  }

  // merge the block's (bm, bl, bacc) into the state (_attend_block :68-76)
  bl0 = quad_sum(bl0);
  bl1 = quad_sum(bl1);
  const long long st0 = (((long long)r * a.B + b) * a.H + h) * Sq + row0, st1 = st0 + 8;
  const float m00 = a.m[st0], m01 = a.m[st1], l00 = a.l[st0], l01 = a.l[st1];
  __syncwarp();                                     // the quad has read m, l before t == 0 writes
  const float mm0 = fmaxf(m00, bm0), mm1 = fmaxf(m01, bm1);
  const float c00 = expf(m00 - mm0), c10 = expf(bm0 - mm0);
  const float c01 = expf(m01 - mm1), c11 = expf(bm1 - mm1);
  const float nl0 = l00 * c00 + bl0 * c10, nl1 = l01 * c01 + bl1 * c11;
  float* ap = a.acc + ((long long)b * a.H + h) * R_rows * D;
  const long long ar0 = ((long long)r * Sq + row0) * D, ar1 = ar0 + 8 * D;
  const float d0 = nl0 == 0.f ? 1.f : nl0, d1 = nl1 == 0.f ? 1.f : nl1;
  bf16* op = a.out + b * a.ob + h * a.oh;
  const long long or0 = ((long long)r * Sq + row0) * a.os, or1 = or0 + 8 * a.os;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    const float2 a0 = *reinterpret_cast<const float2*>(ap + ar0 + col);
    const float2 a1 = *reinterpret_cast<const float2*>(ap + ar1 + col);
    const float x0 = a0.x * c00 + o[n][0] * c10, y0 = a0.y * c00 + o[n][1] * c10;
    const float x1 = a1.x * c01 + o[n][2] * c11, y1 = a1.y * c01 + o[n][3] * c11;
    if (a.last) {
      *reinterpret_cast<__nv_bfloat162*>(op + or0 + col) = __floats2bfloat162_rn(x0 / d0, y0 / d0);
      *reinterpret_cast<__nv_bfloat162*>(op + or1 + col) = __floats2bfloat162_rn(x1 / d1, y1 / d1);
    } else {
      *reinterpret_cast<float2*>(ap + ar0 + col) = make_float2(x0, y0);
      *reinterpret_cast<float2*>(ap + ar1 + col) = make_float2(x1, y1);
    }
  }
  if (!a.last && t == 0) {
    a.m[st0] = mm0; a.l[st0] = nl0;
    a.m[st1] = mm1; a.l[st1] = nl1;
  }
}

}  // namespace

extern "C" {

// One ring step (see above). `strides` holds the (batch, head, sequence)
// element strides of q, then of out. D is 128 and Sq a multiple of 64.
int slime_ring_attend(const void* q, const void* kv, const void* src, void* m, void* l,
                      void* acc, void* out, const long long* strides, int R, int B, int H,
                      int KVH, int Sq, int D, int rank0, int causal, int last, float scale,
                      void* stream) {
  if (D != 128 || Sq < kBlock || Sq % kBlock != 0 || R < 1 || R > 65535 || B < 1 ||
      KVH < 1 || H % KVH != 0 || (long long)B * KVH > 65535)
    return (int)cudaErrorInvalidValue;
  RingArgs a = {};
  a.q = (const bf16*)q;
  a.kv = (const bf16*)kv;
  a.src = (const int*)src;
  a.m = (float*)m;
  a.l = (float*)l;
  a.acc = (float*)acc;
  a.out = (bf16*)out;
  a.qb = strides[0]; a.qh = strides[1]; a.qs = strides[2];
  a.ob = strides[3]; a.oh = strides[4]; a.os = strides[5];
  a.R = R; a.B = B; a.H = H; a.KVH = KVH; a.Sq = Sq;
  a.rank0 = rank0; a.causal = causal; a.last = last;
  a.scale = scale;
  const size_t smem = (size_t)(2 * kTile * (128 + kPad) + 128 * (kTile + kPad)) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(ring_attend_kernel<128>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H / KVH) * Sq / kBlock, KVH * B, R);
  ring_attend_kernel<128><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
