// Hopper (sm_90a) tile vocabulary of the wgmma kernels (K4 in
// encoder_attention.cu; K5's forward and the K5b / K5c backward in
// flash_attention.cu; K9's bf16 kernel in ring_attention.cu, which shares
// K5's main loop through hopper_attention.cuh; K7's wgmma instance in
// quant_matmul.cu; K6's and K1's int8 main loop in qmm_wgmma.cuh; the int8
// GEMM of P3 and K8 in int8_gemm.cuh), and its
// self-test (hopper_selftest.cu).
//
// A tile of R rows x W columns of bf16 lives in shared memory as W / 64 chunks,
// each [R][64] (128 bytes a row) in TMA's 128-byte swizzle: the 16-byte piece c
// of row r sits at piece c ^ (r % 8). Chunks are 1024-byte aligned (R % 8 ==
// 0), so the swizzle phase is the address's own bits, as both TMA and wgmma
// compute it.
//   - Host: encode_bshd() builds the TMA tensor map of a [B, S, H, D] bf16
//     tensor through its element strides, with a box of `rows` positions x 64
//     columns (one head, one batch), 128-byte swizzle and zero fill out of
//     bounds (rows past S,
//     columns past D). cuTensorMapEncodeTiled comes from the runtime's driver
//     entry point, so the library needs no -lcuda. A kernel takes the map as
//     a __grid_constant__ parameter.
//   - Host: encode_2d() builds the map of a row-major 2-D tensor (K7's x
//     [M, K] bf16 and packed weights [N, K / 2] bytes), 128-byte boxes.
//   - Device: mbarrier init / arrive / arrive.expect_tx / parity wait; TMA
//     tile loads (cp.async.bulk.tensor, 4-D and 2-D) and stores; 1-D bulk
//     copies of contiguous bytes (cp.async.bulk, the decode weight ring); the wgmma shared-memory
//     descriptor; wgmma.mma_async m64nNk16 bf16 -> fp32 with A from shared
//     memory (SS: S = Q.K^T or S^T = K.Q^T, both K-major) or from registers
//     (RS: O += P.V, dQ += dS.K, dV += P^T.dO, dK += dS^T.Q, the shared
//     operand MN-major through the transpose bit; K7's W . x^T with x
//     K-major, wgmma_rs_kmajor128; K6's and K1's at 64 or 128 tokens,
//     wgmma_rs_kmajor<N>); the scores' fp32 accumulator
//     rounded into P's register A fragment (acc_to_a_frag); the epilogue
//     store of a 64-row output tile by TMA.
//   - Device: wgmma.mma_async m64nNk32 s8 x s8 -> s32, both operands K-major
//     (P3 and K8, int8_gemm.cuh).
//
// Fragment layout of a warpgroup's m64nN fp32 accumulator d[N / 2]: thread t
// (warp w = t / 32, g = (t % 32) / 4, q = t % 4) holds, for i = 4 n8 + j,
// row 16 w + g + 8 (j / 2), column 8 n8 + 2 q + (j % 2): the mma.sync m16n8
// layout repeated over N / 8 column blocks, one 16-row slab per warp.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// error codes of the host helpers, beside cudaError_t's (< 10000)
constexpr int kErrNoTensorMapEncoder = 20000;
constexpr int kErrTensorMap = 20001;     // + the CUresult of cuTensorMapEncodeTiled

// ---------------------------------------------------------------------------
// Host: TMA tensor maps
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// The map of a [B, S, H, D] bf16 tensor at `ptr` with element strides (sb,
// ss, sh) and unit stride over D: dims (D, H, S, B) innermost first (the
// order of the [B, S, H, D] storage of llama's and the ViT's projections), a
// box of 64 columns x 1 head x `rows` positions x 1 batch, which lands in
// shared memory as [rows][64]. The caller keeps ptr and the strides 16-byte
// aligned (the wrappers copy a view that is not). Returns 0 or an error code.
inline int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
                       long long sb, long long ss, long long sh, int rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kErrNoTensorMapEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)r;
}

// The map of a row-major 2-D tensor of `inner` x `outer` elements of `type`
// (row stride `row_bytes`, a multiple of 16), a box of `box_inner` x
// `box_outer` in the 128-byte swizzle (box_inner elements are 128 bytes), zero
// fill out of bounds: x [M, K] bf16 and the packed q4g weights [N, K / 2]
// (bytes) of K7. Returns 0 or an error code.
inline int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                     long long inner, long long outer, long long row_bytes, int box_inner,
                     int box_outer) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return kErrNoTensorMapEncoder;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)r;
}

// Dynamic shared memory rounded up to the 1024-byte alignment of the tiles.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// ---------------------------------------------------------------------------
// Device: barriers and TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and expect `bytes` more of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}

// the box at (column, row, head, batch) of an encode_bshd map into shared
// memory at dst; its bytes complete on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// the box at (inner, outer) of an encode_2d map into shared memory at dst
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// A 1-D bulk copy of `bytes` from global memory at src into shared memory at
// dst, no tensor map: both addresses 16-byte aligned and bytes a multiple of
// 16 (the callers check). Its bytes complete on `bar` (the caller's
// arrive.expect_tx counts them). The decode weight ring (fused_decode.cu)
// streams bands of whole weight rows with it.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"((unsigned long long)__cvta_generic_to_global(src)), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

// the box at src to (column, row, head, batch); rows and columns out of
// bounds are dropped
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col,
                                          int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// the box at src to (inner, outer) of an encode_2d map; out of bounds dropped
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int inner,
                                             int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.tile.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(inner), "r"(outer)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's committed stores have read their shared memory (READ)
// or are complete and visible (all)
template <bool READ>
__device__ __forceinline__ void tma_store_wait() {
  if (READ)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  tma_store_commit();
  tma_store_wait<true>();
}

// generic-proxy writes to shared memory become visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Hand registers between the warpgroups of a block (all 128 threads of a
// warpgroup execute it): a producer warpgroup drops to N, the consumers grow
// to N, so a 384-thread block (168 registers a thread at launch) gives each
// consumer thread up to 232.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Programmatic dependent launch: a kernel launched with programmatic stream
// serialization starts while the previous kernel of its stream finishes
// and waits here until that kernel's writes are visible (a no-op for a
// kernel launched without it); the previous kernel lets it start early by
// signalling from each block as that block's work ends.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// barrier over `count` threads (a warpgroup: 128) under id 1..15
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1 =
// SWIZZLE_128B. K-major (Q, K): SBO = 1024 (the next 8 rows), LBO unused; a
// k16 step inside a 64-column chunk adds 32 bytes to the start. MN-major (V
// as P.V's B): LBO = the stride between 64-column chunks, SBO = 1024 (the
// next 8 keys); a k16 step adds 16 rows = 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps register A fragments alive and unmoved until this point (an RS wgmma
// reads them after its issue returns)
template <int R>
__device__ __forceinline__ void keep_frags(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(a[i][x])::"memory");
}

// keeps the compiler from moving accumulator registers while wgmma owns them
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N fp32) = [d if scale_d] + A (64 x 16, shared, K-major) . B (16 x N,
// shared, K-major)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
// d (64 x N fp32) += A (64 x 16 bf16, registers) . B (16 x N, shared, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 fp32) = [d if scale_d] + A (64 x 16 bf16, registers) . B (16 x
// 128, shared, K-major): K7's W . x^T with x [tokens][k] as B.
__device__ __forceinline__ void wgmma_rs_kmajor128(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 64 fp32) = [d if scale_d] + A (64 x 16 bf16, registers) . B (16 x
// 64, shared, K-major): K1's W . h^T over a tile of 64 tokens (qmm_wgmma.cuh).
__device__ __forceinline__ void wgmma_rs_kmajor64(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// the K-major RS product at N = 64 or 128 tokens
template <int N>
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[N / 2], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<64>(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  wgmma_rs_kmajor64(d, a, b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_rs_kmajor<128>(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t b, int scale_d) {
  wgmma_rs_kmajor128(d, a, b, scale_d);
}

// ---------------------------------------------------------------------------
// Device: int8 wgmma (P3's and K8's main loop in int8_gemm.cuh)
// ---------------------------------------------------------------------------
// s8 x s8 -> s32 takes both operands K-major from shared memory: PTX has the
// transpose bits for 16-bit types only. An int8 tile [R][128 bytes] in the
// 128-byte swizzle is a bf16 [R][64] tile byte for byte, so the descriptor is
// sw128_desc(p, 16, 1024) and a k32 step adds 32 bytes, as a bf16 k16 step.
// The accumulator d[N / 2] has the fp32 accumulator's fragment layout.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a, uint64_t b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// keeps the compiler from moving int accumulator registers while wgmma owns them
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wait until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Two packed int4 bytes (b0 low, b1) -> the bf16x2 of their low (HI = false)
// or high nibbles as signed values, exactly: spread to [b0, 0, b1, 0] (prmt),
// (v & 0x000F000F) ^ 0x43084308 (one lop3) = 0x4300 | (n ^ 8), bf16 128 + (n +
// 8) with an ulp of 1, then one bf16x2 subtract of 136. K7's wgmma instance
// and the int4 probes (int4_probes.cu) unpack with it.
template <bool HI>
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t two_bytes) {
  uint32_t v = __byte_perm(two_bytes, 0u, 0x4140);
  if (HI) v >>= 4;
  v = (v & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  const uint32_t c = 0x43084308u;                               // bf16x2 (136, 136)
  h = __hsub2(h, *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// The register A fragment of columns 16 kk .. 16 kk + 15 of an m64nN fp32
// accumulator, rounded to bf16: the same thread owns the same (row, column)
// pairs in both layouts, so no value leaves its thread.
template <int R>
__device__ __forceinline__ void acc_to_a_frag(uint32_t (&a)[4], const float (&s)[R], int kk) {
  a[0] = pack2_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack2_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack2_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack2_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// Issue (no commit, no wait) s (64 x BN fp32) = A . B^T over the W columns
// of both (columns past D are TMA's zero fill and add nothing). a: 64 rows
// inside a [W / 64][a_rows][64] tile; b: a [W / 64][BN][64] tile. Both are
// K-major, so the same call gives S = Q.K^T and S^T = K.Q^T. A compile-time
// step count keeps the accumulator in fixed registers across the chain.
template <int W, int BN>
__device__ __forceinline__ void ss_issue(float (&s)[BN / 2], const bf16* a, int a_rows,
                                         const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const int chunk = kk >> 2, col = (kk & 3) * 16;
    wgmma_ss<BN>(s, sw128_desc(a + chunk * a_rows * 64 + col, 16, 1024),
                 sw128_desc(b + chunk * BN * 64 + col, 16, 1024), kk > 0);
  }
}

// Issue o (64 x W fp32) += P (64 x BN bf16, register fragments) . B, b the
// first W / 64 chunks of a [.][BN][64] tile read MN-major (its BN rows are
// the depth): V in P.V, K in dS.K, dO and Q in P^T.dO and dS^T.Q.
template <int W, int BN>
__device__ __forceinline__ void rs_issue(float (&o)[W / 2], const uint32_t (&p)[BN / 16][4],
                                         const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<W>(o, p[kk], sw128_desc(b + kk * 16 * 64, BN * 128, 1024));
}

// s = Q . K^T (ss_issue), waited for
template <int W, int BN>
__device__ __forceinline__ void qk_product(float (&s)[BN / 2], const bf16* q, int q_rows,
                                           const bf16* k) {
  fence_acc(s);
  wgmma_fence();
  ss_issue<W, BN>(s, q, q_rows, k);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(s);
}

// o += P . V (rs_issue), waited for
template <int W, int BN>
__device__ __forceinline__ void pv_product(float (&o)[W / 2], const uint32_t (&p)[BN / 16][4],
                                           const bf16* v) {
  fence_acc(o);
  wgmma_fence();
  rs_issue<W, BN>(o, p, v);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(o);
}

// Epilogue of one warpgroup: o (64 x W fp32 accumulator) over the row
// divisors d0 (rows g) and d1 (rows g + 8), rounded to bf16, into `stage` (64
// rows of a [W / 64][stage_rows][64] swizzled tile, the warpgroup's own rows
// of its Q tile), then one TMA store per 64 columns at (row, head, batch).
// Rows past S and columns past D are dropped by the store. `bar_id` names the
// warpgroup's named barrier.
template <int W>
__device__ __forceinline__ void store_rows(const float (&o)[W / 2], float d0, float d1,
                                           bf16* stage, int stage_rows, const CUtensorMap* map,
                                           int row, int h, int b, int bar_id) {
  const int t = threadIdx.x & 127, warp = t >> 5, g = (t & 31) >> 2, q = t & 3;
#pragma unroll
  for (int n8 = 0; n8 < W / 8; ++n8) {
    bf16* chunk = stage + (n8 >> 3) * stage_rows * 64;
    const int piece = n8 & 7;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g + 8 * half;
      const float d = half ? d1 : d0;
      *reinterpret_cast<uint32_t*>(chunk + r * 64 + ((piece ^ (r & 7)) << 3) + 2 * q) =
          pack2_bf16(o[4 * n8 + 2 * half] / d, o[4 * n8 + 2 * half + 1] / d);
    }
  }
  fence_proxy_async();
  named_barrier(bar_id, 128);
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < W / 64; ++c) tma_store(map, stage + c * stage_rows * 64, 64 * c, row, h, b);
    tma_store_commit_and_wait();
  }
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float quad_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
