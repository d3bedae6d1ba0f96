// Hopper (sm_90a) building blocks shared by the scan kernels K1
// (adc_scan.cu), K2 and K3 (dense_scan.cu): mbarriers, 2-D TMA loads, the
// 128-byte-swizzled shared-memory layout that both TMA and wgmma use,
// the bf16 wgmma m64n128k16 with f32 accumulators and the s8 wgmma
// m64n128k32 with s32 accumulators, and the per-block selection read
// straight off the wgmma accumulator layout (f32 and s32 alike).
//
// Tiles. Operands are K-major with 128 bytes a row per chunk: a [rows][64]
// bf16 chunk or a [rows][128] int8 chunk, stored with the 128-byte
// swizzle (16-byte group g of row r at group g ^ (r % 8)), 1024-byte
// aligned. A wgmma k-step is 32 bytes of a row in both types. The scans
// put the queries on the wgmma M side (64 per warpgroup) and one 128-row
// selection block of the corpus on the N side, so a thread's accumulator
// d[4j + 2i + h] is query 16 * warp + lane / 4 + 8 i and corpus row
// 8 j + 2 (lane % 4) + h of the block: the block minimum of a query is a
// min over the thread's 32 values and two xor-shuffles across its lane
// quad, with no shared memory and no cross-warp step.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kRows = 128;               // one selection block (wgmma N)
constexpr int kChunk = 64;               // bf16 lanes of a 128-byte row
constexpr int kChunkBytes = kRows * 128;  // one [128 rows][128 bytes] chunk
constexpr int kSmemLimit = 232448;       // dynamic shared memory of a block
constexpr float kBig = 3.0e38f;          // a masked winner (the plain twin's _BIG)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the phase of parity `parity` to complete. The spin is one asm
// loop, so the compiler sees no divergent path around the wgmma that
// follows; like CUTLASS's, it has no time limit. A debug build
// (-DGULON_MBAR_WATCHDOG) traps after 2^26 tries instead, so that a
// protocol fault ends the kernel rather than hanging the card: a trap is
// a sticky error that ends the process's CUDA context.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  // labels inside { } are local to the block, so the asm may be inlined
  // many times
#ifdef GULON_MBAR_WATCHDOG
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni LAB_DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.gt.u32 p, n, 67108864;\n"
      "@p trap;\n"
      "bra.uni LAB_WAIT;\n"
      "LAB_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
#else
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni LAB_DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "LAB_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
#endif
}

// Frees a ring stage once this warp's wgmma reads of it are complete:
// one arrival per consumer warp.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// The warpgroup of this thread, provably the same in every lane of a warp
// (a broadcast), so branches on it do not count as divergent.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// ---- TMA --------------------------------------------------------------------

// 2-D tile load (c0 along the contiguous dimension), completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// generic-proxy shared-memory writes -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier of `threads` threads: wait at it, or arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major 128-byte-swizzled tile:
// 8-row groups 1024 bytes apart (SBO), swizzle mode 1. Advance along K
// by one k-step (32 bytes: 16 bf16 or 32 int8) by adding 2 to the
// descriptor.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A[64 x 16] . B[128 x 16]^T, bf16 operands from shared memory, f32
// accumulators; scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A[64 x 32] . B[128 x 32]^T, s8 operands from shared memory (both
// K-major, the only layout the integer form takes), s32 accumulators;
// scale_d == 0 overwrites d. The integer form has no scale or transpose
// immediates.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
        "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The narrow forms the one-hot decodes of the probe kernels use: d (+)=
// A[64 x k] . B[16 x k]^T, k = 16 bf16 (f32 accumulators) or 32 s8 (s32
// accumulators); a thread's d[4j + 2i + h] is row 16 * warp + lane / 4 + 8 i
// and column 8 j + 2 (lane % 4) + h, as for the wide forms.
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_m64n16k32_s8(int (&d)[8], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ---- selection ------------------------------------------------------------

// block row of accumulator register 4j + 2i + h: 8j + 2(lane % 4) + h
__device__ __forceinline__ int acc_row(int j, int h, int lane) {
  return 8 * j + 2 * (lane & 3) + h;
}

// the row in block rides the 7 low mantissa bits of the score
__device__ __forceinline__ void pack_rows(float (&d)[64], int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      d[4 * j + c] = __int_as_float((__float_as_int(d[4 * j + c]) & ~127) |
                                    acc_row(j, c & 1, lane));
}
__device__ __forceinline__ void pack_rows(int (&d)[64], int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) d[4 * j + c] = (d[4 * j + c] & ~127) | acc_row(j, c & 1, lane);
}

// minimum that returns the canonical NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Block minimum of query half i (rows 0..127) over packed values, the
// same in every lane of the quad: a tree over the thread's 32 values (up
// to eight independent mins in flight, not a 32-long chain), then the
// quad. A NaN wins, as with jnp.min; since min.NaN returns the canonical
// NaN, which has lost the row bits, a NaN result is replaced by the
// packed NaN of the lowest NaN row itself. That rare path is taken by
// whole warps (a vote), so no accumulator is read in a divergent branch.
template <int I>
__device__ __forceinline__ float block_min(const float (&d)[64], int lane) {
  float t[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) t[j] = min_nan(d[4 * j + 2 * I], d[4 * j + 2 * I + 1]);
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = min_nan(t[j], t[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = min_nan(t[j], t[j + 4]);
  t[0] = min_nan(min_nan(t[0], t[2]), min_nan(t[1], t[3]));
  float v = min_nan(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
  v = min_nan(v, __shfl_xor_sync(0xffffffffu, v, 2));
  if (__any_sync(0xffffffffu, v != v)) {
    float nan_v = 0.f;
    int key = 128;  // row of this thread's first NaN, 128 = none
#pragma unroll
    for (int j = 15; j >= 0; --j)
#pragma unroll
      for (int h = 1; h >= 0; --h) {
        const float x = d[4 * j + 2 * I + h];
        if (x != x) {
          nan_v = x;
          key = acc_row(j, h, lane);
        }
      }
    key = min(key, __shfl_xor_sync(0xffffffffu, key, 1));
    key = min(key, __shfl_xor_sync(0xffffffffu, key, 2));
    nan_v = __shfl_sync(0xffffffffu, nan_v, (lane & ~3) | ((key >> 1) & 3));
    if (v != v) v = nan_v;
  }
  return v;
}

// The same over packed integer scores: a plain min, no NaN to carry.
template <int I>
__device__ __forceinline__ int block_min(const int (&d)[64], int lane) {
  int t[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) t[j] = min(d[4 * j + 2 * I], d[4 * j + 2 * I + 1]);
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = min(t[j], t[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = min(t[j], t[j + 4]);
  int v = min(min(t[0], t[2]), min(t[1], t[3]));
  v = min(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return min(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// mask the winner of each query half to kBig before the next pass
__device__ __forceinline__ void mask_winner(float (&d)[64], float v0, float v1) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (d[4 * j + c] == ((c & 2) ? v1 : v0)) d[4 * j + c] = kBig;
}

// ---- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &status) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &status) != cudaSuccess)
      return nullptr;
#endif
    if (status != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a row-major bf16 (elem_bytes 2) or int8 (elem_bytes 1)
// matrix [dim1][dim0] (row stride `stride_bytes`), read in boxes of
// [box1][128 bytes] (64 bf16 or 128 int8 lanes) with the 128-byte
// swizzle. Reads past dim0 or dim1 fill zeros.
inline bool sw128_map(CUtensorMap* map, const void* base, int elem_bytes, uint64_t dim0,
                      uint64_t dim1, uint64_t stride_bytes, uint32_t box1) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || (elem_bytes != 1 && elem_bytes != 2)) return false;
  const cuuint64_t dims[2] = {dim0, dim1};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes), box1};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType type =
      elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  return fn(map, type, 2, const_cast<void*>(base), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int num_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace hopper
