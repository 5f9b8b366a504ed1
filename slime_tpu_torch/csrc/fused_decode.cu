// Weight-streaming kernels for one decode step of a Llama layer, for Hopper
// (sm_90a). They replace three TPU kernels of the JAX package:
//   slime_tpu/ops/fused_qkvo.py  fused_qkv_decode  (_qkv_kernel)
//   slime_tpu/ops/fused_qkvo.py  fused_o_residual  (_o_kernel)
//   slime_tpu/ops/fused_mlp.py   fused_mlp_decode  (_kernel)
// and, through the weight ring below, K6's decode rows:
//   slime_tpu/ops/quant_matmul.py  quant_matmul  (:130; _kernel_int4 :23, _kernel_int8 :38)
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
//
// The weight ring (weight_ring_kernel): K1-K3's bf16 instances for int8 and
// q4g weights at B <= 8, the decode steps of the int8 and 4-bit serving
// paths, and those for dense bf16 weights (FMT kDense: the bf16
// checkpoints' decode steps; K1-K3 at B <= 4, where the ring beat row per
// warp on an H100), wherever a launch plan exists (the wrappers' routing
// rule).
// On an H100 the row-per-warp kernels above reach 47-57% of HBM's rate
// there, held by one I2F a weight (the conversion pipe does 16 a clock an
// SM) and by one dependent 16-byte load a lane in flight (dense bf16: 8
// weights a load, 27% of HBM's rate for K2 at B = 1). Instead:
//   - a persistent grid (one block an SM) walks contiguous bands of output
//     rows; one producer thread streams each band, R whole rows of every
//     matrix a stage (one contiguous range each, ~8 KB), into a ring of up
//     to 128 KB in shared memory by 1-D bulk copies on mbarriers;
//   - sixteen consumer warps take the band's rows in turn, each summing
//     whole rows on its own (no sums cross warps), sixteen rows at once, or
//     with one matrix of an even number of rows a stage (K2, K3) two rows a
//     warp, each activation load serving both;
//   - int8 and int4 become fp32 exactly without I2F: the byte (XOR 0x80) or
//     the nibble (XOR 8) is put into the low mantissa of 2^23 by one prmt,
//     and one FADD of -(2^23 + 128) or -(2^23 + 8) leaves its signed value;
//     a bf16 weight is the high half of its fp32 (a shift or a mask). A
//     dense lane's 16-byte vector c holds columns 8 c .. 8 c + 7, which is
//     activation chunk c: a quarter-warp reads eight chunks in a row, all
//     32 banks once under the swizzle below. A dense row is twice an int8
//     one (a stage at R = 1: 16 KB for gate/up at H = 4096, 28 KB for down
//     at I = 14336, so 8 and 4 stages). With so few stages in flight one
//     warp a row left most warps idle and each row's sum a long serial
//     chain (on an H100 down at B = 4 took 0.121 ms against a 0.035 ms
//     bound), so a dense plan splits each row's vectors over `split`
//     warps (16 / the rows in flight: 4 for down, 2 for gate/up, 1 for
//     K2's 16 stages), whose sums meet in shared memory: the fp32 sum of
//     exact products, in another order;
//   - the activations (h for gate/up, a for down, attn for o; for q/k/v x,
//     normalised by each block as it copies it: K2's input norm needs no
//     launch of its own; at most 8 rows, cut into launches of fewer rows
//     where they would not fit) are copied into shared memory once a block
//     by the consumers, with plain loads that do not queue behind the
//     weights' bulk copies, and read there, one load for gate and up; q4g
//     scales ride in the stage beside their rows, int8 scales and the
//     residual are read into shared memory once a band;
//   - rms_norm -> gate/up -> down (K1), and K2's and K3's one launch after
//     their caller's last kernel, are chained by programmatic dependent
//     launch: each block signals its dependents at its start, so the next
//     kernel's producer streams its first stages while the previous kernel
//     ends; its consumers wait (griddepcontrol.wait) before they read the
//     activations;
//   - one kernel serves all three: gate/up streams two matrices a stage
//     (MATS 2); down, o and q/k/v one (MATS 1), q/k/v over one row space of
//     three parts, [0, NQ) of W_q, then W_k and W_v, a stage's copies split
//     where it meets a part's end, so no copy crosses from one matrix into
//     the next;
//   - K6 (quant_matmul) at 1 <= B <= 8 bf16 rows is the MATS 1 instance with
//     no norm and no residual, y = bf16((x . w_int) * scale[row]), for int8
//     or per-row q4 weights (FMT kRowQ4: byte j of a row holds column 2j in its
//     low nibble and 2j + 1 in its high one). Its blocks stage x
//     de-interleaved, the even columns then the odd ones (each half
//     chunk-swizzled as a row), so a lane's 16 packed bytes meet two chunk
//     pairs read as q4g's and int8's are, without bank conflicts; the
//     nibbles convert as q4g's do. It is launched without PDL: in the
//     non-fused decode it follows plain PyTorch kernels.
// What bounds it: HBM's bytes for int8 and dense bf16 (the ring without its
// dot products streams the weights barely faster); for q4g, with two weights
// a byte, also the consumers' instructions (about five a weight). Where the
// 128 KB ring does not hold two stages, or two stages and the activations do
// not fit in shared memory, there is no plan (dense at B = 1: from K =
// 32784 columns with one matrix a stage, 16400 with two, about half of
// int8's; at more rows fewer) and the call takes the row-per-warp kernels.
// Sums stay fp32 FFMA of exact products, in another order than the plain
// version's; scales, silu, the bf16 intermediate and the fp32 residual are
// the row-per-warp kernels'.
//
// K1 at 9 and more bf16 rows with int8 weights (the engine's fused chunks
// and the speculative verify chunk) runs on tensor cores instead
// (slime_mlp_wgmma): the row-per-warp kernels re-read every weight row from
// L2 once per tile of 8 rows and convert each weight on every pass (64 rows:
// 2.49 ms against a 0.053 ms bytes bound on an H100), while the 22.5 GFLOP of
// a 64-row SliME-8B MLP take 0.023 ms at the bf16 tensor-core rate. It runs
// K6's int8 wgmma main loop (qmm_wgmma.cuh, 64 tokens a tile) twice: gate/up
// with the SwiGLU epilogue (W_gate's and W_up's same 64 rows are one
// warpgroup's two m64 tiles, so g and u of a (row, token) meet in one
// thread), then down split over I into an fp32 workspace that the
// reduction sums in order, scales and adds the residual to. The weights
// stream from HBM once a token tile; the sums stay fp32 over exact
// products, so the bf16 intermediate is the only rounding that can differ.
// K2 and K3 at those rows take the same down launch (split_wgmma): K3 with
// attn as the activations and x as the residual (slime_o_wgmma), K2 after
// the row norm over the row space [W_q; W_k; W_v], one tensor map a matrix
// (NQ and NQ + NKV on block boundaries, so a block's rows lie in one),
// whose reduction scales each part and writes q, k and v apart
// (slime_qkv_wgmma). Their row-per-warp kernels took 0.37 and 0.27 ms at 64
// rows on an H100, 2% of their bytes bound.
// K1 and K2 on dense bf16 weights (a bf16 checkpoint's fused chunks, its
// verify chunk, and its decode steps from the wrappers' DENSE_WGMMA_MIN_ROWS)
// run the same launches on the main loop's dense format (kK6Bf16): a
// weight tile is wgmma's A operand straight from shared memory, no scales.
// Their row-per-warp kernels re-read K1's 352 MB of bf16 weights once per
// tile of 8 rows: 2.26 ms at 64 rows on an H100 against 0.151 on tensor
// cores (one pass: 0.105 ms at the bytes rate). Dense K3 keeps its ring and
// row-per-warp kernels.
#include "hopper_common.cuh"
#include "qmm_wgmma.cuh"

namespace {

constexpr int kWarps = 8;                 // output rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kBT = 8;                    // batch rows per tile

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
// per-row int8, q4g, dense fp32 (with fp32 activations only), per-row q4
// (the weight ring's K6 instance only).
enum { kDense = 0, kInt8 = 1, kQ4G = 2, kDenseF32 = 3, kRowQ4 = 4 };

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
// (fused_qkvo.py:72-77, fused_mlp.py:227-233). The row-per-warp K1 and K2
// launch 256 threads a row; K1's weight-ring call 1024, so each thread's
// few loads are in flight at once (256 threads walk a 4096-wide row in 16
// dependent steps: 14 us at B = 1 on an H100, about a tenth of K1). K2's
// weight-ring call normalises x in the ring kernel's prologue instead.
template <typename TA, int THREADS = 256>
__global__ void __launch_bounds__(THREADS) rms_norm_kernel(const TA* __restrict__ x,
                                                           const float* __restrict__ w,
                                                           TA* __restrict__ h, int H,
                                                           float eps) {
  __shared__ float part[32];
  griddep_launch_dependents();   // the ring's gate/up may start streaming its weights
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

// ---------------------------------------------------------------------------
// The weight ring: K1-K3's bf16 instances for int8 and q4g weights, and K1's
// and K2's for dense bf16 weights, at B <= 8
// ---------------------------------------------------------------------------
constexpr int kRingMaxWarps = 16;                       // consumer warps a block, at most
constexpr int kRingMaxRows = 8;                         // activation rows a launch
constexpr int kRingSmemMax = 232448;                    // 227 KB, a block's most

// One launch of weight_ring_kernel (the wrapper's launch plan,
// weight_ring.ring_launch): y = f(act @ W^T) over N output rows, row_bytes
// of weights a row. MATS 2 (gate/up): two matrices of N rows, w[0] and
// w[1], streamed side by side, one output. MATS 1: the row space [0, N) is
// `parts` matrices one after another (K2: W_q, W_k, W_v; else one), part p
// rows [part_end[p - 1], part_end[p]) of w[p], written to out[p].
struct RingArgs {
  const unsigned char* w[3];   // weights [rows, row_bytes]: int8 [rows, K], q4g or q4
                               // [rows, K / 2], dense bf16 [rows, K] (2 K bytes)
  const float* s[3];           // scales: int8 and q4 [rows] (one a row), q4g [rows, K / 128];
                               // dense: none
  const bf16* act;             // [B, K] activations, copied into shared memory whole
  const bf16* resid;           // [B, N] added to the output (MATS == 1), or null
  bf16* out[3];                // [B, rows of the part] (MATS 2: out[0], [B, N])
  int part_end[3];             // MATS 1: where each part of the row space ends (the last N)
  int parts;                   // 1 to 3 (MATS 2: 1)
  const float* norm_w;         // [K] fp32: act is x, and the block stages rms_norm(x) * w
  float eps;                   //   (K2's input norm), or null: act is staged as it is
  int B, K, N;                 // activation rows (<= 8), contraction, output rows
  int row_bytes;               // weight bytes a row
  int rows_per_stage;          // R (1, 2, 4 or 8): a stage holds R rows of each matrix
  int stages;                  // S
  int stage_bytes;             // MATS * R * row_bytes (q4g: + MATS * R * K / 128 * 4)
  int align;                   // bands start at multiples of this many rows
  int band_cap;                // rows a band holds at most: ceil(N / grid) + align
  int split;                   // consumer warps that share a row's columns (dense; else 1)
};

// 16 int8 weights (one 16-byte vector) -> fp32, exactly and without I2F: each
// byte XOR 0x80 (its value + 128) goes into the low mantissa byte of 2^23
// (prmt with 0x4B000000), and one FADD of -(2^23 + 128) leaves its value.
__device__ __forceinline__ void int8x16_f32(const uint4 v, float* f) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u + j)) - 8388736.f;
}

// The low (HI false) or high nibbles of 16 packed q4g bytes -> 16 fp32 the
// same way: n ^ 8 (the signed nibble + 8) in the mantissa of 2^23, minus
// 2^23 + 8.
template <bool HI>
__device__ __forceinline__ void int4x16_f32(const uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t n = ((HI ? w[i] >> 4 : w[i]) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(n, 0x4B000000u, 0x7650u + j)) - 8388616.f;
  }
}

// The activations in shared memory: each row of K bf16 as K / 8 16-byte
// chunks, chunk j stored at j ^ ((j >> 3) & 1). The consumers read a pair
// of chunks (2 c, 2 c + 1: 16 columns) a lane, lanes c = 0..31 (or, for q4g,
// pairs 16 blk + (lane & 7)) at once: unswizzled, their first chunks would
// fall on half of the banks (a 2-way conflict); swizzled, eight lanes in a
// row cover all 32 banks. K is a multiple of 16.
__device__ __forceinline__ int act_chunk(int j) { return j ^ ((j >> 3) & 1); }

// 8 bf16 (one 16-byte chunk) -> 8 fp32
__device__ __forceinline__ void bf16x8_f32(const uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_lo(w[i]);
    f[2 * i + 1] = bf16_hi(w[i]);
  }
}

// columns 16 cc .. 16 cc + 15 of a swizzled activation row -> 16 fp32
__device__ __forceinline__ void load_act16(const bf16* row, int cc, float* f) {
  const uint4* q = reinterpret_cast<const uint4*>(row) + 2 * cc;
  const int sw = (cc >> 2) & 1;                // the pair's chunks swap places
  bf16x8_f32(q[sw], f);
  bf16x8_f32(q[sw ^ 1], f + 8);
}

// acc[m][b] += act[b, 16 c .. 16 c + 15] . W_m[row, same], for the int8 vector
// c of one row of each matrix in the stage (matrix m at wrow + m * mat_stride).
template <int MATS, int BT>
__device__ __forceinline__ void ring_dot_int8(const unsigned char* wrow, int mat_stride, int c,
                                              const bf16* act, int K, int B,
                                              float (&acc)[MATS][BT]) {
  float wf[MATS][16];
#pragma unroll
  for (int m = 0; m < MATS; ++m)
    int8x16_f32(*reinterpret_cast<const uint4*>(wrow + m * mat_stride + 16 * c), wf[m]);
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b < B) {
      float hf[16];
      load_act16(act + (size_t)b * K, c, hf);
#pragma unroll
      for (int m = 0; m < MATS; ++m)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[m][b] = fmaf(hf[j], wf[m][j], acc[m][b]);
    }
  }
}

// The q4g vector c (packed bytes 16 c .. 16 c + 15 of block blk = c / 8: the
// columns 256 blk + j .. + 15 in its low nibbles and 128 further in its high
// ones, j = 16 (c % 8)): one fp32 partial sum for each group's 16 columns,
// times the group's scale (s_m: the row's K / 128 scales in the stage),
// added to acc.
template <int MATS, int BT>
__device__ __forceinline__ void ring_dot_q4g(const unsigned char* wrow, int mat_stride, int c,
                                             const bf16* act, int K, int B,
                                             const float* const (&s)[MATS],
                                             float (&acc)[MATS][BT]) {
  const int blk = c >> 3, lo = 16 * blk + (c & 7);      // lo: a pair of chunks
  uint4 v[MATS];
#pragma unroll
  for (int m = 0; m < MATS; ++m)
    v[m] = *reinterpret_cast<const uint4*>(wrow + m * mat_stride + 16 * c);
  float d[MATS][BT];
  {
    float wf[MATS][16];
#pragma unroll
    for (int m = 0; m < MATS; ++m) int4x16_f32<false>(v[m], wf[m]);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b < B) {
        float hf[16];
        load_act16(act + (size_t)b * K, lo, hf);
#pragma unroll
        for (int m = 0; m < MATS; ++m) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) t = fmaf(hf[j], wf[m][j], t);
          d[m][b] = t;
        }
      }
    }
  }
  float s_lo[MATS], s_hi[MATS];
#pragma unroll
  for (int m = 0; m < MATS; ++m) {
    s_lo[m] = s[m][2 * blk];
    s_hi[m] = s[m][2 * blk + 1];
  }
  float wf[MATS][16];
#pragma unroll
  for (int m = 0; m < MATS; ++m) int4x16_f32<true>(v[m], wf[m]);
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b < B) {
      float hf[16];
      load_act16(act + (size_t)b * K, lo + 8, hf);
#pragma unroll
      for (int m = 0; m < MATS; ++m) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) t = fmaf(hf[j], wf[m][j], t);
        acc[m][b] += d[m][b] * s_lo[m] + t * s_hi[m];
      }
    }
  }
}

// The per-row q4 vector c (packed bytes 16 c .. 16 c + 15: columns 32 c ..
// 32 c + 31, column 2j in byte j's low nibble and 2j + 1 in its high one)
// against activations staged de-interleaved (stage_act_q4): the low
// nibbles meet columns 16 c .. 16 c + 15 of the even half, the high ones the
// same of the odd half (K / 2 further), both read as load_act16 reads a row.
template <int MATS, int BT>
__device__ __forceinline__ void ring_dot_q4(const unsigned char* wrow, int mat_stride, int c,
                                            const bf16* act, int K, int B,
                                            float (&acc)[MATS][BT]) {
  uint4 v[MATS];
#pragma unroll
  for (int m = 0; m < MATS; ++m)
    v[m] = *reinterpret_cast<const uint4*>(wrow + m * mat_stride + 16 * c);
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    float wf[MATS][16];
#pragma unroll
    for (int m = 0; m < MATS; ++m) {
      if (hi) int4x16_f32<true>(v[m], wf[m]);
      else int4x16_f32<false>(v[m], wf[m]);
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      if (b < B) {
        float hf[16];
        load_act16(act + (size_t)b * K + hi * (K / 2), c, hf);
#pragma unroll
        for (int m = 0; m < MATS; ++m)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[m][b] = fmaf(hf[j], wf[m][j], acc[m][b]);
      }
    }
  }
}

// acc[m][b] += act[b, 8 c .. 8 c + 7] . W_m[row, same], for the dense bf16
// vector c of one row of each matrix in the stage: the eight columns are
// activation chunk c, so lanes c .. c + 7 (a quarter-warp's 16-byte reads)
// read eight chunks of one swizzle group, 128 bytes on all 32 banks.
template <int MATS, int BT>
__device__ __forceinline__ void ring_dot_bf16(const unsigned char* wrow, int mat_stride, int c,
                                              const bf16* act, int K, int B,
                                              float (&acc)[MATS][BT]) {
  float wf[MATS][8];
#pragma unroll
  for (int m = 0; m < MATS; ++m)
    bf16x8_f32(*reinterpret_cast<const uint4*>(wrow + m * mat_stride + 16 * c), wf[m]);
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (b < B) {
      float hf[8];
      bf16x8_f32(reinterpret_cast<const uint4*>(act + (size_t)b * K)[act_chunk(c)], hf);
#pragma unroll
      for (int m = 0; m < MATS; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][b] = fmaf(hf[j], wf[m][j], acc[m][b]);
    }
  }
}

// Chunk j (columns 8 j .. 8 j + 7) of an activation row into shared memory
// for the q4 dot: its even columns to the even half, its odd ones to the odd
// half (K / 2 further), each half chunk-swizzled as a row of K / 2: the four
// values of either kind fill half of that half's chunk j / 2.
__device__ __forceinline__ void stage_act_q4(bf16* row, int K, int j, const uint4 u) {
  const uint2 ev = make_uint2(__byte_perm(u.x, u.y, 0x5410), __byte_perm(u.z, u.w, 0x5410));
  const uint2 od = make_uint2(__byte_perm(u.x, u.y, 0x7632), __byte_perm(u.z, u.w, 0x7632));
  uint2* e = reinterpret_cast<uint2*>(row) + 2 * act_chunk(j >> 1) + (j & 1);
  uint2* o = reinterpret_cast<uint2*>(row + K / 2) + 2 * act_chunk(j >> 1) + (j & 1);
  *e = ev;
  *o = od;
}

// Band g of a projection's N rows: [band_start(g), band_start(g + 1)), each
// start rounded down to a multiple of `align` rows (q4g: so that every
// stage's scales are whole 16-byte units), the last band ending at N.
__device__ __forceinline__ int band_start(int g, int G, int N, int align) {
  return g >= G ? N : (int)((long long)g * N / G) / align * align;
}

// The part of the row space that row `row` lies in, and (local) its row
// within that part's matrix.
__device__ __forceinline__ int part_of(const RingArgs& p, int row, int& local) {
  int q = 0, lo = 0;
  while (q + 1 < p.parts && row >= p.part_end[q]) lo = p.part_end[q++];
  local = row - lo;
  return q;
}

// Stage i of the block's band [r0, r1): rows r0 + R i .. (at most R, fewer
// at the band's end) of every matrix into ring slot i % S, one bulk copy a
// matrix and part of the row space the rows meet, and for q4g one more of
// those rows' scales (after the weights: [m][R][K / 128] fp32), all
// completing on full[i % S]. Matrix m of part q is w[MATS == 1 ? q : m].
template <int FMT, int MATS>
__device__ __forceinline__ void ring_load(const RingArgs& p, unsigned char* ring,
                                          uint64_t* full, int* issued, int i, int r0, int r1) {
  const int slot = i % p.stages, R = p.rows_per_stage, row = r0 + i * R;
  const int rows = min(R, r1 - row), kg = p.K / 128;
  const uint32_t sb = FMT == kQ4G ? (uint32_t)kg * 4 : 0;     // scale bytes a row
  unsigned char* dst = ring + (size_t)slot * p.stage_bytes;
  mbar_arrive_expect_tx(&full[slot], MATS * rows * (p.row_bytes + sb));
  for (int q = 0, lo = 0; q < p.parts; lo = p.part_end[q++]) {
    const int a = max(row, lo), b = min(row + rows, p.part_end[q]);
    if (a >= b) continue;
#pragma unroll
    for (int m = 0; m < MATS; ++m) {
      const int mi = MATS == 1 ? q : m, at = m * R + a - row;
      bulk_load(dst + (size_t)at * p.row_bytes, p.w[mi] + (size_t)(a - lo) * p.row_bytes,
                (uint32_t)(b - a) * p.row_bytes, &full[slot]);
      if (FMT == kQ4G)
        bulk_load(dst + (size_t)MATS * R * p.row_bytes + at * sb,
                  p.s[mi] + (size_t)(a - lo) * kg, (uint32_t)(b - a) * sb, &full[slot]);
    }
  }
  reinterpret_cast<volatile int*>(issued)[slot] = i;
}

// Row `row`, activation row b, from the scaled sums v: gate/up (MATS 2)
// a = bf16(silu(g) u); MATS 1 y = bf16(x + d) with res = x[b, row] (down,
// o), or bf16(d) with res 0 (q/k/v), into its part's output, as
// gate_up_kernel, resid_kernel and qkv_kernel round them.
template <int MATS>
__device__ __forceinline__ void ring_epilogue(const RingArgs& p, int row, int b,
                                              const float (&v)[MATS], float res) {
  if constexpr (MATS == 2) {
    const float g = v[0], u = v[1];
    const float sig = 1.f / (1.f + expf(-g));
    act_store(p.out[0] + (size_t)b * p.N + row, g * sig * u);
  } else {
    int local;
    const int q = part_of(p, row, local);
    const int n = p.part_end[q] - (q ? p.part_end[q - 1] : 0);
    act_store(p.out[q] + (size_t)b * n + local, res + v[0]);
  }
}

// Shared memory: the ring [S][stage_bytes], the activations [B][K] bf16
// (chunk-swizzled, act_chunk; for q4 de-interleaved, stage_act_q4), full[S],
// empty[S], issued[S], the norm's partial sums [8][16], then the epilogue's
// operands of the band: int8 and q4 row
// scales [MATS][band_cap] and the residual x [B][band_cap] (fp32, MATS 1
// with a residual), loaded once at the start so no row waits on global
// memory; for dense weights last the split rows' warp sums [2][W][MATS G][BT]. The producer streams only weights, from the block's start; the
// consumers wait (griddepcontrol.wait) for the previous kernel's writes,
// then stage the activations themselves with plain loads (a bulk copy
// behind the weights' would arrive only once the stages before it had: on
// a small band, all of them), normalising them first where norm_w is set
// (K2), and read the residual. The band's rows are dealt to the W =
// blockDim.x / 32 - 1 consumer warps G at a time (rows t .. t + G - 1 of a
// stage to warp (t / G) % W; G divides R and R / G divides W, so a warp
// keeps one position of the stages it takes): each warp sums whole rows on
// its own and writes their outputs, G W rows at once, one activation load
// serving its G rows (or gate's and up's), and releases a stage (empty, R
// / G arrivals) as soon as its rows are read. A warp may reach stage i
// before the producer has armed its slot for it, while the slot's barrier
// still waits for stage i - S: the parity wait would then see stage i - 2
// S's completed phase and return at once. So the producer writes i into
// issued[slot] once the stage is armed, and a warp waits for that before it
// waits on the barrier. Dense weights (p.split > 1) deal each row to a group
// of split warps instead, each summing a split-th of its vectors (lane
// vectors kp * 32 + lane, every 32 split further); the group adds its warp
// sums in shared memory in warp order, and its first warp writes the row.
template <int FMT, int MATS, int BT, int G>
__global__ void __launch_bounds__((kRingMaxWarps + 1) * 32) weight_ring_kernel(
    const __grid_constant__ RingArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.stages, R = p.rows_per_stage, W = blockDim.x / 32 - 1;
  unsigned char* ring = smem;
  bf16* act = reinterpret_cast<bf16*>(smem + (size_t)S * p.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(act + (size_t)p.B * p.K);
  uint64_t* empty = full + S;
  int* issued = reinterpret_cast<int*>(empty + S);                // the stage each slot holds
  float* red = reinterpret_cast<float*>(issued + S);              // norm: [rows][warps]
  float* ep_scale = red + kRingMaxRows * kRingMaxWarps;           // int8: [MATS][cap]
  constexpr bool kRowScale = FMT == kInt8 || FMT == kRowQ4;        // a scale a row
  float* ep_res = ep_scale + (kRowScale ? MATS * p.band_cap : 0);   // resid: [B][cap]
  // dense: the split rows' warp sums, [2][W][MATS * G][BT] (after the
  // epilogue's residual rows, which a MATS-2 plan does not reserve)
  float* part = ep_res + (MATS == 1 ? p.B * p.band_cap : 0);
  const int ks = FMT == kDense ? p.split : 1;                       // warps a row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = band_start(blockIdx.x, gridDim.x, p.N, p.align);
  const int r1 = band_start(blockIdx.x + 1, gridDim.x, p.N, p.align);
  const int band = r1 - r0, n_st = (band + R - 1) / R;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], R / G * ks);
      issued[s] = -1;
    }
    fence_barrier_init();
  }
  __syncthreads();
  griddep_launch_dependents();   // the next kernel's producers may start streaming

  if (warp == W) {               // the producer: the weights only, which no kernel writes
    if (lane == 0) {
      int i = 0;
      for (; i < n_st && i < S; ++i) ring_load<FMT, MATS>(p, ring, full, issued, i, r0, r1);
      for (; i < n_st; ++i) {
        mbar_wait(&empty[i % S], ((i / S) - 1) & 1);
        ring_load<FMT, MATS>(p, ring, full, issued, i, r0, r1);
      }
    }
    return;
  }

  // The consumers' prologue: the band's int8 / q4 scales (and K2's norm weight),
  // then, once the previous kernel's writes are visible, the activations and
  // the residual. Under the weights' stream a load's round trip takes
  // microseconds, so each thread issues its loads (up to eight 16-byte
  // chunks: all of a 4096-wide layer's activations) before it uses any.
  const int tid = threadIdx.x, nthr = W * 32, chunks = p.K / 8;
  const bool res = MATS == 1 && p.resid != nullptr, norm = p.norm_w != nullptr;
  const float4* nw = reinterpret_cast<const float4*>(p.norm_w);
  float sc = 0.f;                       // this thread's first row scale
  bf16 rv = {};                         // and residual value (converted once the loads are out)
  float4 w0 = {}, w1 = {};              // the norm weight of its first chunk
  if (kRowScale && tid < MATS * band) {
    int local;
    const int q = part_of(p, r0 + tid % band, local);
    sc = __ldg(p.s[MATS == 1 ? q : tid / band] + local);
  }
  if (norm && tid < chunks) {
    w0 = __ldg(nw + 2 * tid);
    w1 = __ldg(nw + 2 * tid + 1);
  }
  griddep_wait();
  if (res && tid < p.B * band) rv = p.resid[(size_t)(tid / band) * p.N + r0 + tid % band];
  const uint4* src = reinterpret_cast<const uint4*>(p.act);
  uint4* dst = reinterpret_cast<uint4*>(act);
  if (!norm) {
    // U rounds of loads in flight at once (K1's down: a is 14336 wide)
    constexpr int U = 8 / BT;
    for (int j0 = tid; j0 < chunks; j0 += U * nthr) {
      uint4 u[U][BT];
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < p.B && j0 + k * nthr < chunks)
            u[k][b] = src[(size_t)b * chunks + j0 + k * nthr];
#pragma unroll
      for (int k = 0; k < U; ++k)
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < p.B && j0 + k * nthr < chunks) {
            if constexpr (FMT == kRowQ4)
              stage_act_q4(act + (size_t)b * p.K, p.K, j0 + k * nthr, u[k][b]);
            else
              dst[b * chunks + act_chunk(j0 + k * nthr)] = u[k][b];
          }
    }
  } else {
    // h = bf16(x * rsqrt(mean(x^2) + eps) * w), as rms_norm_kernel rounds it:
    // each thread's sums of squares, then the block's over its warps
    uint4 v[BT];                        // chunk j of every activation row
    const auto load = [&](int j) {
#pragma unroll
      for (int b = 0; b < BT; ++b)
        if (b < p.B) v[b] = src[(size_t)b * chunks + j];
    };
    if (tid < chunks) load(tid);
    float ss[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) ss[b] = 0.f;
    for (int j = tid; j < chunks; j += nthr) {
      if (j != tid) load(j);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (b >= p.B) continue;
        float f[8];
        bf16x8_f32(v[b], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) ss[b] = fmaf(f[e], f[e], ss[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float t = warp_sum(ss[b]);
      if (lane == 0) red[b * kRingMaxWarps + warp] = t;
    }
    named_barrier(1, nthr);
    float r[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float t = 0.f;
      for (int w = 0; w < W; ++w) t += red[b * kRingMaxWarps + w];
      r[b] = 1.f / sqrtf(t / (float)p.K + p.eps);
    }
    // one round: this thread's chunk is still in v
    for (int j = tid; j < chunks; j += nthr) {
      if (chunks > nthr) {
        load(j);
        w0 = __ldg(nw + 2 * j);
        w1 = __ldg(nw + 2 * j + 1);
      }
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        if (b >= p.B) continue;
        float f[8];
        bf16x8_f32(v[b], f);
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[2 * e] * r[b] * w[2 * e],
                                                          f[2 * e + 1] * r[b] * w[2 * e + 1]);
          o[e] = *reinterpret_cast<const uint32_t*>(&h2);
        }
        dst[b * chunks + act_chunk(j)] = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  if (kRowScale)
    for (int t = tid; t < MATS * band; t += nthr) {
      if (t >= nthr) {
        int local;
        const int q = part_of(p, r0 + t % band, local);
        sc = __ldg(p.s[MATS == 1 ? q : t / band] + local);
      }
      ep_scale[(t / band) * p.band_cap + t % band] = sc;
    }
  if (res)
    for (int t = tid; t < p.B * band; t += nthr) {
      if (t >= nthr) rv = p.resid[(size_t)(t / band) * p.N + r0 + t % band];
      ep_res[(t / band) * p.band_cap + t % band] = act_f32(rv);
    }
  named_barrier(1, nthr);

  // a lane's weight vectors at once: one row of each of MATS matrices, or G
  // rows of one (MATS 1), vstride bytes apart in the stage; vector v is row
  // r + gv of matrix mv
  constexpr int NV = MATS * G;
  const int vecs = p.row_bytes >> 4, mat_stride = R * p.row_bytes, kg = p.K / 128;
  const int vstride = MATS == 2 ? mat_stride : p.row_bytes;
  // warp group grp (ks warps, each a ks-th of the row's vectors: kp) takes
  // rows t .. t + G - 1 of the band as one warp does when ks is 1
  const int grp = warp / ks, kp = warp % ks, NG = W / ks;
  for (int t = grp * G; t < band; t += NG * G) {
    const int i = t / R, r = t % R, slot = i % S;
    float acc[NV][BT];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[v][b] = 0.f;
    while (reinterpret_cast<volatile int*>(issued)[slot] != i) __nanosleep(32);
    mbar_wait(&full[slot], (i / S) & 1);
    const unsigned char* stage = ring + (size_t)slot * p.stage_bytes;
    const unsigned char* wrow = stage + (size_t)r * p.row_bytes;
    const float* s[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v)
      s[v] = reinterpret_cast<const float*>(stage + MATS * mat_stride) +
             ((MATS == 2 ? v : 0) * R + r + (MATS == 2 ? 0 : v)) * kg;
    const auto dot = [&](int c, float (&into)[NV][BT]) {
      if constexpr (FMT == kQ4G)
        ring_dot_q4g<NV, BT>(wrow, vstride, c, act, p.K, p.B, s, into);
      else if constexpr (FMT == kRowQ4)
        ring_dot_q4<NV, BT>(wrow, vstride, c, act, p.K, p.B, into);
      else if constexpr (FMT == kDense)
        ring_dot_bf16<NV, BT>(wrow, vstride, c, act, p.K, p.B, into);
      else
        ring_dot_int8<NV, BT>(wrow, vstride, c, act, p.K, p.B, into);
    };
    int c = kp * 32 + lane;
    if constexpr (BT == 1) {
      // two vectors at a time into two sets of sums: twice the loads and
      // FFMA chains in flight, where one activation row leaves few
      float acc2[NV][BT];
#pragma unroll
      for (int v = 0; v < NV; ++v) acc2[v][0] = 0.f;
      for (; c + 32 * ks < vecs; c += 64 * ks) {
        dot(c, acc);
        dot(c + 32 * ks, acc2);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v][0] += acc2[v][0];
    }
    for (; c < vecs; c += 32 * ks) dot(c, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);    // this warp's rows of the stage are read
    if constexpr (FMT == kDense) {
      if (ks > 1) {
        // the group's ks warp sums of each output through shared memory
        // (double-buffered by round: a buffer is written again only after
        // the group's next barrier, which its reader has passed), added in
        // warp order by warp kp 0 into its lane 0; the epilogue's warp_sum
        // then adds only zeros to it
        float* buf = part + (size_t)(((t / (NG * G)) & 1) * W + grp * ks) * NV * BT;
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            const float v = warp_sum(acc[k][b]);
            if (lane == 0) buf[(kp * NV + k) * BT + b] = v;
          }
        named_barrier(2 + grp, ks * 32);
        if (kp != 0) continue;
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            float v = 0.f;
            for (int q = 0; q < ks; ++q) v += buf[(q * NV + k) * BT + b];
            acc[k][b] = lane == 0 ? v : 0.f;
          }
      }
    }
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float v[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        v[k] = warp_sum(acc[k][b]);
        if (kRowScale)
          v[k] *= ep_scale[(MATS == 2 ? k * p.band_cap : k) + t];
      }
      if (lane != b || b >= p.B) continue;
      if constexpr (MATS == 2) {
        ring_epilogue<2>(p, r0 + t, b, v, 0.f);
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) {   // the band's last rows may not fill the group
          const float vg[1] = {v[g]};
          if (t + g < band)
            ring_epilogue<1>(p, r0 + t + g, b, vg,
                             p.resid ? ep_res[b * p.band_cap + t + g] : 0.f);
        }
      }
    }
  }
}

// Launch one weight_ring_kernel instance; with `pdl`, as a programmatic
// dependent of the stream's previous kernel.
template <int FMT, int MATS, int BT, int G>
int launch_ring_g(const RingArgs& a, int grid, int warps, int smem, bool pdl,
                  cudaStream_t st) {
  static bool attrs_set = false;               // once per instance
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(weight_ring_kernel<FMT, MATS, BT, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kRingSmemMax);
    // the most shared memory for the carveout: a block takes over half an SM's
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(weight_ring_kernel<FMT, MATS, BT, G>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attrs_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3((warps + 1) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, weight_ring_kernel<FMT, MATS, BT, G>, a);
}

// One matrix with an even number of rows a stage: each warp sums two rows of
// a stage at once (G 2), so each activation it loads serves both.
template <int FMT, int MATS, int BT>
int launch_ring_bt(const RingArgs& a, int grid, int warps, int smem, bool pdl,
                   cudaStream_t st) {
  if constexpr (MATS == 1)
    if (a.rows_per_stage % 2 == 0)
      return launch_ring_g<FMT, MATS, BT, 2>(a, grid, warps, smem, pdl, st);
  return launch_ring_g<FMT, MATS, BT, 1>(a, grid, warps, smem, pdl, st);
}

template <int FMT, int MATS>
int launch_ring(const RingArgs& a, int grid, int warps, int smem, bool pdl, cudaStream_t st) {
  if (a.B <= 1) return launch_ring_bt<FMT, MATS, 1>(a, grid, warps, smem, pdl, st);
  if (a.B <= 2) return launch_ring_bt<FMT, MATS, 2>(a, grid, warps, smem, pdl, st);
  if (a.B <= 4) return launch_ring_bt<FMT, MATS, 4>(a, grid, warps, smem, pdl, st);
  return launch_ring_bt<FMT, MATS, 8>(a, grid, warps, smem, pdl, st);
}

// The launches of one projection over activation rows [0, B) in groups of
// plan[4] (each group its own launch, streaming the weights again): plan =
// {grid, rows_per_stage, stages, stage_bytes, batch_rows, smem, align,
// consumer warps, split (warps a row: dense only)}, kPlanInts ints. The plan
// is checked against what the kernel needs; one it cannot run is refused.
constexpr int kPlanInts = 9;

template <int MATS>
int ring_projection(int wfmt, bool pdl, const int* plan, RingArgs a, int B, cudaStream_t st) {
  const int grid = plan[0], R = plan[1], S = plan[2], bg = plan[4], smem = plan[5];
  const int warps = plan[7], split = plan[8];
  const bool q4g = wfmt == kQ4G, q4 = wfmt == kRowQ4, dense = wfmt == kDense;
  a.rows_per_stage = R;
  a.stages = S;
  a.stage_bytes = plan[3];
  a.align = plan[6];
  a.band_cap = grid < 1 ? 0 : (a.N + grid - 1) / grid + a.align;
  a.split = split;
  const int kg = a.K / 128, G = MATS == 1 && R % 2 == 0 ? 2 : 1;    // launch_ring_bt's G
  const int bt = bg <= 1 ? 1 : bg <= 2 ? 2 : bg <= 4 ? 4 : 8;        // launch_ring's BT, at most
  // dense: a split row's warp sums, [2][warps][MATS * G][BT] fp32
  const long long part = dense ? 4LL * 2 * warps * MATS * G * bt : 0;
  const long long ep = (long long)((q4g || dense ? 0 : MATS) + (MATS == 1 ? bg : 0)) *
                       a.band_cap;
  const long long need = (long long)S * a.stage_bytes + (long long)bg * a.K * 2 + 8 * 2 * S +
                         4 * S + 4 * kRingMaxRows * kRingMaxWarps + 4 * ep + part;
  bool ok = (R == 1 || R == 2 || R == 4 || R == 8) && S >= 1 && bg >= 1 &&
            bg <= kRingMaxRows && grid >= 1 && grid <= a.N && a.row_bytes % 16 == 0 &&
            warps >= R && warps % R == 0 && warps <= kRingMaxWarps &&
            split >= 1 && (split == 1 || dense) && warps % split == 0 &&
            (warps / split) % (R / G) == 0 &&
            a.stage_bytes == MATS * R * (a.row_bytes + (q4g ? kg * 4 : 0)) &&
            need <= smem && smem <= kRingSmemMax && a.K % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.norm_w) % 16 == 0 &&
            (!q4 || (MATS == 1 && a.parts == 1 && a.norm_w == nullptr &&
                     a.row_bytes * 2 == a.K)) &&
            (!dense || a.row_bytes == 2 * a.K) &&
            (a.align == 1 || a.align == 2 || a.align == 4) && R % a.align == 0 &&
            (!q4g || (a.K % 256 == 0 && a.align * kg % 4 == 0)) &&
            a.parts >= 1 && a.parts <= (MATS == 1 ? 3 : 1) && a.part_end[a.parts - 1] == a.N;
  // every part non-empty, and for q4g starting on a row whose scales are
  // whole 16-byte units; every matrix 16-byte aligned
  int part_rows[3] = {0, 0, 0};
  for (int q = 0, lo = 0; ok && q < a.parts; lo = a.part_end[q++]) {
    part_rows[q] = a.part_end[q] - lo;
    ok = part_rows[q] >= 1 && (!q4g || a.part_end[q] % a.align == 0);
  }
  for (int m = 0; m < (MATS == 1 ? a.parts : MATS); ++m)
    ok = ok && reinterpret_cast<uintptr_t>(a.w[m]) % 16 == 0 &&
         (!q4g || reinterpret_cast<uintptr_t>(a.s[m]) % 16 == 0);
  if (!ok) return (int)cudaErrorInvalidValue;
  const bf16* act = a.act;
  const bf16* resid = a.resid;
  bf16* out[3] = {a.out[0], a.out[1], a.out[2]};
  for (int b0 = 0; b0 < B; b0 += bg) {
    a.B = min(bg, B - b0);
    a.act = act + (size_t)b0 * a.K;
    a.resid = resid == nullptr ? nullptr : resid + (size_t)b0 * a.N;
    for (int q = 0; q < 3; ++q)
      a.out[q] = out[q] == nullptr ? nullptr : out[q] + (size_t)b0 * part_rows[q];
    if (reinterpret_cast<uintptr_t>(a.act) % 16) return (int)cudaErrorInvalidValue;
    int e;
    if (q4g) e = launch_ring<kQ4G, MATS>(a, grid, warps, smem, pdl, st);
    else if (dense) e = launch_ring<kDense, MATS>(a, grid, warps, smem, pdl, st);
    else if (!q4) e = launch_ring<kInt8, MATS>(a, grid, warps, smem, pdl, st);
    else if constexpr (MATS == 1) e = launch_ring<kRowQ4, 1>(a, grid, warps, smem, pdl, st);
    else e = (int)cudaErrorInvalidValue;
    if (e != 0) return e;
  }
  return 0;
}

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

// K1 through the weight ring: h = rms_norm(x), a = silu(h Wg^T) (h Wu^T),
// y = x + a Wd^T, for bf16 x [B, H] (B <= 8) and dense bf16 (wfmt 0), int8
// (1) or q4g (2) weights. h [B, H] and a [B, I] are the caller's scratch.
// plan: the launch plans of gate/up (plan[0..8]) and down (plan[9..17]),
// ring_projection's layout. With pdl, gate/up and down are programmatic
// dependents of the kernel before them. Returns the first launch error, or 0.
int slime_mlp_ring(int wfmt, int pdl, const void* x, const void* norm_w, float eps, void* h,
                   void* a, void* y, int B, int H, int I, const void* wg, const void* sg,
                   const void* wu, const void* su, const void* wd, const void* sd,
                   const int* plan, void* stream) {
  if ((wfmt != kDense && wfmt != kInt8 && wfmt != kQ4G) || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  rms_norm_kernel<bf16, 1024><<<B, 1024, 0, st>>>((const bf16*)x, (const float*)norm_w,
                                                  (bf16*)h, H, eps);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  // weight bytes a row of `k` columns
  const auto row_bytes = [wfmt](int k) {
    return wfmt == kQ4G ? k / 2 : wfmt == kDense ? 2 * k : k;
  };
  RingArgs gu = {};
  gu.w[0] = (const unsigned char*)wg;
  gu.w[1] = (const unsigned char*)wu;
  gu.s[0] = (const float*)sg;
  gu.s[1] = (const float*)su;
  gu.act = (const bf16*)h;
  gu.out[0] = (bf16*)a;
  gu.part_end[0] = I;
  gu.parts = 1;
  gu.K = H;
  gu.N = I;
  gu.row_bytes = row_bytes(H);
  e = ring_projection<2>(wfmt, pdl != 0, plan, gu, B, st);
  if (e != 0) return e;
  RingArgs dn = {};
  dn.w[0] = (const unsigned char*)wd;
  dn.s[0] = (const float*)sd;
  dn.act = (const bf16*)a;
  dn.resid = (const bf16*)x;
  dn.out[0] = (bf16*)y;
  dn.part_end[0] = H;
  dn.parts = 1;
  dn.K = I;
  dn.N = H;
  dn.row_bytes = row_bytes(I);
  return ring_projection<1>(wfmt, pdl != 0, plan + kPlanInts, dn, B, st);
}

}  // extern "C"

namespace {

// q, k, v (parts 3) or y (parts 1) of a split projection: bf16(resid + sum_z
// ws[z] * s[p][row]) with ws [splits, B, N] over the row space [0, end[parts
// - 1]), the splits added in order, each part's scale on the fp32 sum (none
// for dense weights: s[0] null), the residual (K1's down, K3: x [B, N], one
// part) added in fp32, and one bf16 rounding into part p's own [B, end[p] -
// end[p - 1]] output.
struct SplitOut {
  const float* s[3];
  bf16* y[3];
  int end[3];
  int parts;
};

__global__ void split_reduce_kernel(const float* __restrict__ ws, int splits, int M, int N,
                                    const SplitOut o, const bf16* __restrict__ resid) {
  const size_t MN = (size_t)M * N;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < MN;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[z * MN + e];
    // the part by selects, not by an index into o (which would copy it to
    // local memory)
    const int m = (int)(e / N), n = (int)(e % N);
    const bool p1 = o.parts > 1 && n >= o.end[0], p2 = o.parts > 2 && n >= o.end[1];
    const int start = p2 ? o.end[1] : p1 ? o.end[0] : 0;
    const int width = (p2 ? o.end[2] : p1 ? o.end[1] : o.end[0]) - start, c = n - start;
    if (o.s[0] != nullptr) v *= (p2 ? o.s[2] : p1 ? o.s[1] : o.s[0])[c];
    if (resid != nullptr) v = __bfloat162float(resid[e]) + v;
    (p2 ? o.y[2] : p1 ? o.y[1] : o.y[0])[(size_t)m * width + c] = __float2bfloat16_rn(v);
  }
}

// Whether split_wgmma takes the operands: int8 (wfmt kInt8) or dense bf16
// (kDense) weights, K as TMA reads the rows (int8: a multiple of 16, dense:
// of 8; at least 256), 1-3 parts, every part end but the last on a 128-row
// block boundary, the residual with one part only, and splits of
// `kb_per_split` stages (128 int8 or 64 dense columns) that cover K's, none
// empty.
bool split_ok(int wfmt, int B, int K, const SplitOut& o, const void* resid, const void* ws,
              int splits, int kb_per_split) {
  const bool dense = wfmt == kDense;
  const int bk = dense ? K6Cfg<kK6Bf16, 1, 64>::BK : K6Cfg<kK6Int8, 1, 64>::BK;
  const int nkb = (K + bk - 1) / bk;
  bool ok = (wfmt == kInt8 || dense) && B >= 1 && K >= 256 && K % (dense ? 8 : 16) == 0 &&
            ws != nullptr && o.parts >= 1 && o.parts <= 3 && splits >= 1 && kb_per_split >= 1 &&
            (long long)splits * kb_per_split >= nkb &&
            (long long)(splits - 1) * kb_per_split < nkb && (resid == nullptr || o.parts == 1);
  for (int q = 0; ok && q < o.parts; ++q)
    ok = o.end[q] > (q > 0 ? o.end[q - 1] : 0) &&
         (q + 1 == o.parts || o.end[q] % K6Cfg<kK6Int8, 1, 64>::ROWS == 0);
  return ok;
}

// split_wgmma's launches for one weight format
template <int FMT>
int split_wgmma_fmt(const void* act, int B, int K, const void* const* w, const SplitOut& o,
                    const void* resid, void* ws, int splits, int kb_per_split,
                    cudaStream_t st) {
  using C = K6Cfg<FMT, 1, 64>;
  const int N = o.end[o.parts - 1];
  int err = qmm_wgmma_smem<FMT, 1, 64, kEpiScale>();
  K6Params p = {};
  CUtensorMap* maps[3] = {&p.w, &p.w2, &p.w3};
  if (err == 0)
    err = encode_2d(&p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, act, K, B, 2LL * K, 64, 64);
  for (int q = 0; err == 0 && q < o.parts; ++q)
    err = FMT == kK6Bf16
              ? encode_2d(maps[q], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w[q], K,
                          o.end[q] - (q > 0 ? o.end[q - 1] : 0), 2LL * K, 64, C::ROWS)
              : encode_2d(maps[q], CU_TENSOR_MAP_DATA_TYPE_UINT8, w[q], K,
                          o.end[q] - (q > 0 ? o.end[q - 1] : 0), K, 128, C::ROWS);
  if (err != 0) return err;
  p.n1 = o.parts > 1 ? o.end[0] : 0;
  p.n2 = o.parts > 2 ? o.end[1] : 0;
  p.ws = (float*)ws;
  p.M = B; p.N = N; p.K = K; p.kb_per_split = kb_per_split;
  qmm_wgmma_kernel<FMT, 1, 64, kEpiScale>
      <<<dim3((N + C::ROWS - 1) / C::ROWS, (B + 63) / 64, splits), kK6Threads, C::SMEM, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  split_reduce_kernel<<<reduce_blocks(B, N), 256, 0, st>>>((const float*)ws, splits, B, N, o,
                                                           (const bf16*)resid);
  return (int)cudaGetLastError();
}

// The scale-epilogue main loop over bf16 act [B, K] (qmm_wgmma_kernel<int8 or
// bf16, 1, 64, kEpiScale>: 128 rows a block, 64-token tiles in grid.y) and
// the row space [0, N = o.end[o.parts - 1]) of o.parts int8 (wfmt kInt8) or
// dense bf16 (kDense) matrices w[p] [end[p] - end[p - 1], K], split over K into `splits` ranges of `kb_per_split` stages whose
// fp32 sums go to ws [splits, B, N]; then split_reduce_kernel. The operands
// as split_ok asks. Returns the first launch error (or a tensor-map error
// code), or 0.
int split_wgmma(int wfmt, const void* act, int B, int K, const void* const* w,
                const SplitOut& o, const void* resid, void* ws, int splits, int kb_per_split,
                cudaStream_t st) {
  if (!split_ok(wfmt, B, K, o, resid, ws, splits, kb_per_split))
    return (int)cudaErrorInvalidValue;
  return wfmt == kInt8
             ? split_wgmma_fmt<kK6Int8>(act, B, K, w, o, resid, ws, splits, kb_per_split, st)
             : split_wgmma_fmt<kK6Bf16>(act, B, K, w, o, resid, ws, splits, kb_per_split, st);
}

// K1's gate/up launch with the SwiGLU epilogue into a [B, I] (128
// intermediate rows a block, token tiles of 64 in grid.y) for one weight
// format
template <int FMT>
int gate_up_wgmma(const void* h, void* a, int B, int H, int I, const void* wg, const void* sg,
                  const void* wu, const void* su, cudaStream_t st) {
  using GU = K6Cfg<FMT, 2, 64>;
  const bool dense = FMT == kK6Bf16;
  const CUtensorMapDataType wt = dense ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  int err = qmm_wgmma_smem<FMT, 2, 64, kEpiSwiGLU>();
  K6Params gu = {};
  if (err == 0)
    err = encode_2d(&gu.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, h, H, B, 2LL * H, 64, 64);
  if (err == 0) err = encode_2d(&gu.w, wt, wg, H, I, (dense ? 2LL : 1LL) * H, GU::WCOL, 64);
  if (err == 0) err = encode_2d(&gu.w2, wt, wu, H, I, (dense ? 2LL : 1LL) * H, GU::WCOL, 64);
  if (err != 0) return err;
  gu.s = (const float*)sg;
  gu.s2 = (const float*)su;
  gu.y = (bf16*)a;
  gu.M = B; gu.N = I; gu.K = H; gu.kb_per_split = (H + GU::BK - 1) / GU::BK;
  qmm_wgmma_kernel<FMT, 2, 64, kEpiSwiGLU>
      <<<dim3((I + 127) / 128, (B + 63) / 64, 1), kK6Threads, GU::SMEM, st>>>(gu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 on tensor cores: h = rms_norm(x), a = silu(h Wg^T) (h Wu^T), y = x + a
// Wd^T for bf16 x [B, H] (any B; the wrapper's rule sends 9 and more rows
// on int8 weights, DENSE_WGMMA_MIN_ROWS and more on dense ones) and int8
// weights with per-row fp32 scales (wfmt kInt8) or dense bf16 weights
// without (kDense, scales null), in four launches on the stream: the row
// norm (rms_norm_kernel, 1024 threads a row) into h [B, H]; gate/up, qmm_wgmma_kernel<int8 or bf16, 2,
// 64, kEpiSwiGLU> (128 intermediate rows a block, token tiles of 64 in
// grid.y) into a [B, I]; down, split_wgmma over W_down (K3's launch with a
// as the activations and x as the residual) split over I into `splits`
// ranges of `kb_per_split` stages in ws [splits, B, H], and its reduction
// into y [B, H]. H and I as TMA reads the rows (int8: multiples of 16,
// dense: of 8; at least 256: quant_matmul.k6_wgmma_strides and
// fused_mlp.wgmma_instance). h, a and ws are the caller's scratch. Returns
// the first launch error (or a tensor-map error code), or 0.
int slime_mlp_wgmma(int wfmt, const void* x, const void* norm_w, float eps, void* h, void* a,
                    void* ws, void* y, int B, int H, int I, const void* wg, const void* sg,
                    const void* wu, const void* su, const void* wd, const void* sd,
                    int splits, int kb_per_split, void* stream) {
  const SplitOut dn = {{(const float*)sd}, {(bf16*)y}, {H}, 1};
  const bool dense = wfmt == kDense;
  if (H < 256 || H % (dense ? 8 : 16) ||
      !split_ok(wfmt, B, I, dn, x, ws, splits, kb_per_split) ||
      (dense ? (sg != nullptr || su != nullptr || sd != nullptr)
             : (sg == nullptr || su == nullptr || sd == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  rms_norm_kernel<bf16, 1024><<<B, 1024, 0, st>>>((const bf16*)x, (const float*)norm_w,
                                                  (bf16*)h, H, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int err = dense ? gate_up_wgmma<kK6Bf16>(h, a, B, H, I, wg, sg, wu, su, st)
                        : gate_up_wgmma<kK6Int8>(h, a, B, H, I, wg, sg, wu, su, st);
  if (err != 0) return err;
  return split_wgmma(wfmt, a, B, I, &wd, dn, x, ws, splits, kb_per_split, st);
}

// K3 on tensor cores: y [B, H] = x + attn W_o^T for bf16 attn [B, NQ] and x
// [B, H] (any B; the wrapper's rule sends 9 and more rows on int8 weights,
// DENSE_WGMMA_MIN_ROWS and more on dense ones) and int8 W_o [H, NQ] with
// fp32 scales [H] (wfmt kInt8) or dense bf16 W_o without (kDense, so null):
// K1's down launch (split_wgmma) over attn, split over NQ into `splits`
// ranges of `kb_per_split` stages (128 int8 or 64 dense columns) in ws
// [splits, B, H], x the residual. NQ as TMA reads the rows (int8: a
// multiple of 16, dense: of 8; at least 256). Returns the first launch
// error (or a tensor-map error code), or 0.
int slime_o_wgmma(int wfmt, const void* attn, const void* x, void* ws, void* y, int B, int NQ,
                  int H, const void* wo, const void* so, int splits, int kb_per_split,
                  void* stream) {
  const SplitOut o = {{(const float*)so}, {(bf16*)y}, {H}, 1};
  if (wfmt == kDense ? so != nullptr : so == nullptr) return (int)cudaErrorInvalidValue;
  return split_wgmma(wfmt, attn, B, NQ, &wo, o, x, ws, splits, kb_per_split,
                     (cudaStream_t)stream);
}

// K2 on tensor cores: h = rms_norm(x) * norm_w, then q [B, NQ], k and v [B,
// NKV] = h W^T for bf16 x [B, H] (any B; the wrapper's rule sends 9 and
// more rows on int8 weights, DENSE_WGMMA_MIN_ROWS and more on dense ones)
// and int8 W_q [NQ, H], W_k and W_v [NKV, H] with fp32 scales (wfmt kInt8)
// or dense bf16 ones without (kDense, scales null): the row norm (1024
// threads a row) into h [B, H], then one split_wgmma over the row space
// [W_q; W_k; W_v] (NQ and NQ + NKV on 128-row block boundaries), split over
// H into `splits` ranges of `kb_per_split` stages in ws [splits, B, NQ + 2
// NKV], whose reduction writes q, k and v apart. H as TMA reads the rows
// (int8: a multiple of 16, dense: of 8; at least 256). h and ws are the
// caller's scratch. Returns the first launch error (or a tensor-map error
// code), or 0.
int slime_qkv_wgmma(int wfmt, const void* x, const void* norm_w, float eps, void* h, void* ws,
                    int B, int H, int NQ, int NKV, const void* wq, const void* sq,
                    const void* wk, const void* sk, const void* wv, const void* sv, void* q,
                    void* k, void* v, int splits, int kb_per_split, void* stream) {
  const SplitOut o = {{(const float*)sq, (const float*)sk, (const float*)sv},
                      {(bf16*)q, (bf16*)k, (bf16*)v},
                      {NQ, NQ + NKV, NQ + 2 * NKV},
                      3};
  const void* w[3] = {wq, wk, wv};
  const bool dense = wfmt == kDense;
  if (norm_w == nullptr || !split_ok(wfmt, B, H, o, nullptr, ws, splits, kb_per_split)
      || (dense ? (sq != nullptr || sk != nullptr || sv != nullptr)
                : (sq == nullptr || sk == nullptr || sv == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  rms_norm_kernel<bf16, 1024><<<B, 1024, 0, st>>>((const bf16*)x, (const float*)norm_w,
                                                  (bf16*)h, H, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return split_wgmma(wfmt, h, B, H, w, o, nullptr, ws, splits, kb_per_split, st);
}

// K2 through the weight ring: q [B, NQ], k and v [B, NKV] = h W^T (scaled)
// with h = rms_norm(x) * norm_w, in one launch over the row space [0, NQ +
// 2 NKV) of W_q, W_k, W_v; each block normalises x into its shared memory.
// bf16 x (B <= 8), fp32 norm_w [H], dense bf16 (wfmt 0), int8 (1) or q4g (2)
// weights; with pdl a programmatic dependent of the stream's previous
// kernel. plan: ring_projection's layout. Returns the launch error, or 0.
int slime_qkv_ring(int wfmt, int pdl, const void* x, const void* norm_w, float eps, int B,
                   int H, int NQ, int NKV, const void* wq, const void* sq, const void* wk,
                   const void* sk, const void* wv, const void* sv, void* q, void* k, void* v,
                   const int* plan, void* stream) {
  if ((wfmt != kDense && wfmt != kInt8 && wfmt != kQ4G) || B < 1 || norm_w == nullptr)
    return (int)cudaErrorInvalidValue;
  RingArgs a = {};
  const void* w[3] = {wq, wk, wv};
  const void* s[3] = {sq, sk, sv};
  void* out[3] = {q, k, v};
  for (int p = 0; p < 3; ++p) {
    a.w[p] = (const unsigned char*)w[p];
    a.s[p] = (const float*)s[p];
    a.out[p] = (bf16*)out[p];
  }
  a.part_end[0] = NQ;
  a.part_end[1] = NQ + NKV;
  a.part_end[2] = NQ + 2 * NKV;
  a.parts = 3;
  a.act = (const bf16*)x;
  a.norm_w = (const float*)norm_w;
  a.eps = eps;
  a.K = H;
  a.N = NQ + 2 * NKV;
  a.row_bytes = wfmt == kQ4G ? H / 2 : wfmt == kDense ? 2 * H : H;
  return ring_projection<1>(wfmt, pdl != 0, plan, a, B, (cudaStream_t)stream);
}

// K3 through the weight ring: y [B, H] = x + attn W_o^T (scaled), for bf16
// attn [B, NQ] and x (B <= 8), dense bf16 (wfmt 0: rows of 2 NQ bytes, each
// split over plan[8] warps, no scales), int8 (1) or q4g (2) weights; with
// pdl a programmatic dependent of the stream's previous kernel (which may
// have written attn or x: the consumers read both after
// griddepcontrol.wait). plan: ring_projection's layout. Returns the launch
// error, or 0.
int slime_o_ring(int wfmt, int pdl, const void* attn, const void* x, void* y, int B, int NQ,
                 int H, const void* wo, const void* so, const int* plan, void* stream) {
  if ((wfmt != kDense && wfmt != kInt8 && wfmt != kQ4G) || B < 1)
    return (int)cudaErrorInvalidValue;
  RingArgs a = {};
  a.w[0] = (const unsigned char*)wo;
  a.s[0] = (const float*)so;
  a.act = (const bf16*)attn;
  a.resid = (const bf16*)x;
  a.out[0] = (bf16*)y;
  a.part_end[0] = H;
  a.parts = 1;
  a.K = NQ;
  a.N = H;
  a.row_bytes = wfmt == kQ4G ? NQ / 2 : wfmt == kDense ? 2 * NQ : NQ;
  return ring_projection<1>(wfmt, pdl != 0, plan, a, B, (cudaStream_t)stream);
}

// K6 through the weight ring: y [B, N] = bf16((x W^T) * scale[row]) for bf16
// x [B, K] (B <= 8), int8 (wfmt 1, w [N, K]) or per-row q4 (wfmt 4, w [N, K /
// 2]) weights and fp32 scales [N]; with pdl a programmatic dependent of the
// stream's previous kernel. plan: ring_projection's layout. Returns the
// launch error, or 0.
int slime_quant_ring(int wfmt, int pdl, const void* x, int B, int K, int N, const void* w,
                     const void* s, void* y, const int* plan, void* stream) {
  if ((wfmt != kInt8 && wfmt != kRowQ4) || B < 1) return (int)cudaErrorInvalidValue;
  RingArgs a = {};
  a.w[0] = (const unsigned char*)w;
  a.s[0] = (const float*)s;
  a.act = (const bf16*)x;
  a.out[0] = (bf16*)y;
  a.part_end[0] = N;
  a.parts = 1;
  a.K = K;
  a.N = N;
  a.row_bytes = wfmt == kRowQ4 ? K / 2 : K;
  return ring_projection<1>(wfmt, pdl != 0, plan, a, B, (cudaStream_t)stream);
}

// cudaError_t's text, or that of the TMA tensor-map helpers' codes
// (hopper_common.cuh: 20000 no cuTensorMapEncodeTiled entry point, 20001 + a
// CUresult when it refused a map)
const char* slime_error_string(int err) {
  if (err == 20000) return "cuTensorMapEncodeTiled: no driver entry point";
  if (err > 20000) return "cuTensorMapEncodeTiled refused the tensor map (code - 20001 is its CUresult)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
