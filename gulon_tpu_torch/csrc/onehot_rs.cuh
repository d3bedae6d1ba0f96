// The one-hot decode of the probe kernels P1 and P2 (adc_probes.cu), built
// for Hopper: the TPU's formulation (a one-hot of each row's code times
// the codebook slice of its subspace) with the one-hot never stored. A
// warpgroup decodes 64 rows of a 128-row block, one 64-column chunk at a
// time. For each subspace s and piece p of its lanes, the one-hot
// [64 rows x K] is built straight into the A registers of wgmma
// m64nNk16 in its register-operand (RS) form, and the codebook slice
// [N lanes x K] is the B operand, read from shared memory.
//
// The A fragment of m64nNk16 (bf16): thread `lane` of warp w of the
// warpgroup holds rows 16 w + lane / 4 (a[0], a[2]) and + 8 (a[1], a[3]),
// k columns 2 (lane % 4) + {0, 1} (a[0], a[1]) and + 8 (a[2], a[3]), the
// lower column in the low half of each 32-bit register. A thread's one-hot
// bits are then compares of its two rows' codes against its k columns: an
// int compare (kInt) or a compare on packed bf16 pairs (kBf16Cmp, K <= 256,
// where bf16 holds the codes exactly). A code outside [0, K) matches
// nothing and decodes to +0.
//
// N is the subspace's lanes rounded up to 8 (n8 at dsub 8, n16 at dsub
// 13), split into P pieces of at most 32 lanes. One commit group is one
// 64-code chunk of K: four k-steps on one accumulator. A warpgroup builds
// a group's A registers only once its last group has retired: a register
// of a running wgmma redefined (or its accumulators read) makes ptxas
// serialize every wgmma of the kernel, the contraction's too. The tensor
// cores overlap one warpgroup's compares with the other's groups (and,
// in P2, with the consumers' contraction). A one-hot row times bf16
// codewords sums one product and zeros in f32, so each decoded lane
// equals the gathered codeword, up to the sign of a zero: a -0.0 codeword
// decodes to +0.0 unless every term of its sum is -0.0.
//
// Slices in shared memory: [P][K / 64][N][64] bf16 a subspace
// (slice_bytes), each [N][64] chunk 128-byte swizzled, N * 128 bytes (a
// multiple of 1024), the layout of `cb_slices` in probes/adc_probes.py, so
// a subspace's slices are one contiguous copy. Codes in shared memory: a
// chunk's subspaces' [128] raw code elements of a block (code_bytes each).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "probes.cuh"

namespace onehot_rs {

using namespace hopper;

constexpr int kInt = 0;      // int compare of the code with each k column
constexpr int kBf16Cmp = 1;  // compare on packed bf16 pairs (K <= 256)

// ---- copies -------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The codes of subspaces s_lo .. s_lo + n_sub - 1 of the 128-row block at
// row0 ([n_sub][128] elements of code_bytes) into cs, by threads tid = 0
// .. nt - 1 (16-byte copies).
__device__ __forceinline__ void stage_codes(uint8_t* cs, const void* codes, int code_bytes,
                                            int64_t row0, int n_cols, int s_lo, int n_sub,
                                            int tid, int nt) {
  const int per = 8 * code_bytes;  // 16-byte pieces of a subspace's 128 codes
  for (int e = tid; e < n_sub * per; e += nt) {
    const int s = e / per, j = e - s * per;
    cp_async16(cs + 16 * e, static_cast<const uint8_t*>(codes) +
                                (static_cast<int64_t>(s_lo + s) * n_cols + row0) * code_bytes +
                                16 * j);
  }
}

// Subspaces s_lo .. s_lo + n_sub - 1 of the slices (global, contiguous)
// into dst, swizzled: 16-byte group e is row e / 8 (of 128 bytes), group
// e % 8 of that row, and the row's index mod 8 is its lane mod 8.
__device__ __forceinline__ void stage_slices(uint8_t* dst, const uint16_t* cbs, int s_lo,
                                             int n_sub, int slice_bytes, int tid, int nt) {
  const uint8_t* src =
      reinterpret_cast<const uint8_t*>(cbs) + static_cast<int64_t>(s_lo) * slice_bytes;
  const int n16 = n_sub * (slice_bytes / 16);
  for (int e = tid; e < n16; e += nt)
    cp_async16(dst + (e >> 3) * 128 + (((e & 7) ^ ((e >> 3) & 7)) << 4),
               src + 16 * static_cast<int64_t>(e));
}

// code of element idx of the staged codes, -1 outside [0, K)
__device__ __forceinline__ int smem_code(const uint8_t* cs, int code_bytes, int idx,
                                         int k_codes) {
  const int code = code_bytes == 1   ? static_cast<int>(reinterpret_cast<const int8_t*>(cs)[idx]) + 128
                   : code_bytes == 2 ? static_cast<int>(reinterpret_cast<const int16_t*>(cs)[idx])
                                     : reinterpret_cast<const int32_t*>(cs)[idx];
  return (code >= 0 && code < k_codes) ? code : -1;
}

// ---- wgmma, A from registers ------------------------------------------------

// d (+)= A[64 x 16] . B[N x 16]^T: A the thread's four bf16x2 registers
// (layout above), B a K-major 128-byte-swizzled tile in shared memory, f32
// accumulators (d[4j + 2i + h]: row 16 warp + lane / 4 + 8 i, lane 8 j +
// 2 (lane % 4) + h); scale_d == 0 overwrites d.
template <int N>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Mma<24> {
  static __device__ __forceinline__ void run(float (&d)[12], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};


// ---- the decode ------------------------------------------------------------

// one-hot bits of (code == k, code == k + 1), as a bf16 pair (low half k)
__device__ __forceinline__ uint32_t pair_int(int code, int k) {
  const unsigned d = static_cast<unsigned>(code - k);
  return d < 2u ? (0x3F80u << (16 * d)) : 0u;
}
__device__ __forceinline__ uint32_t pair_bf16(uint32_t code2, int k) {
  const __nv_bfloat162 e =
      __heq2(*reinterpret_cast<const __nv_bfloat162*>(&code2),
             __floats2bfloat162_rn(static_cast<float>(k), static_cast<float>(k + 1)));
  return *reinterpret_cast<const uint32_t*>(&e);
}

// The lanes of piece p of subspace s into the chunk tile dst (columns c0
// .. c1 - 1 of the block, c0 its column 0), as bf16x2 stores where dsub is
// even (a lane pair then starts on an even column of one 16-byte group).
template <int N>
__device__ __forceinline__ void store(uint8_t* dst, const float (&acc)[N / 2], int s, int p,
                                      int c0, int c1, int dsub, int r0, int warp, int g,
                                      int tq) {
  const int lane0 = p * N;
  const int col_s = s * dsub + lane0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 16 * warp + g + 8 * i;
      const int n = 8 * j + 2 * tq;
      const int col = col_s + n;
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      const bool ok0 = lane0 + n < dsub && col >= c0 && col < c1;
      if ((dsub & 1) == 0) {
        if (ok0) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<uint32_t*>(probes::tile_elem(dst, r, col - c0)) =
              *reinterpret_cast<const uint32_t*>(&v);
        }
      } else {
        const bool ok1 = lane0 + n + 1 < dsub && col + 1 >= c0 && col + 1 < c1;
        if (ok0) *probes::tile_elem(dst, r, col - c0) = __bfloat16_as_ushort(__float2bfloat16_rn(v0));
        if (ok1)
          *probes::tile_elem(dst, r, col + 1 - c0) = __bfloat16_as_ushort(__float2bfloat16_rn(v1));
      }
    }
}

// One warpgroup (t = 0 .. 127) decodes the codeword columns of chunk c
// (columns 64 c .. 64 c + 63, those below m * dsub) of block rows r0 ..
// r0 + 63 into the chunk tile dst, from the chunk's staged codes cs (its
// first subspace's 128 codes first) and the staged slices (subspace s at
// slices + (s - s_base) * slice_bytes).
// Columns past m * dsub are left to the caller. Ends with every group
// retired.
// The A registers of one 64-code chunk (k0 .. k0 + 63) of K: four k-steps.
template <int kImpl>
__device__ __forceinline__ void build_a(uint32_t (&a)[4][4], int code_a, int code_b,
                                        uint32_t c2a, uint32_t c2b, int k0, int tq) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int kb = k0 + 16 * ks + 2 * tq;
    if (kImpl == kInt) {
      a[ks][0] = pair_int(code_a, kb);
      a[ks][1] = pair_int(code_b, kb);
      a[ks][2] = pair_int(code_a, kb + 8);
      a[ks][3] = pair_int(code_b, kb + 8);
    } else {
      a[ks][0] = pair_bf16(c2a, kb);
      a[ks][1] = pair_bf16(c2b, kb);
      a[ks][2] = pair_bf16(c2a, kb + 8);
      a[ks][3] = pair_bf16(c2b, kb + 8);
    }
  }
}

// One warpgroup (t = 0 .. 127) decodes the codeword columns of chunk c
// (columns 64 c .. 64 c + 63, those below m * dsub) of block rows r0 ..
// r0 + 63 into the chunk tile dst, from the chunk's staged codes cs (its
// first subspace's 128 codes first) and the staged slices (subspace s at
// slices + (s - s_base) * slice_bytes). Columns past m * dsub are left to
// the caller. Ends with every group retired.
template <int kImpl, int N>
__device__ __forceinline__ void decode_rows_n(uint8_t* dst, int c, int r0, const uint8_t* cs,
                                              int code_bytes, int k_codes,
                                              const uint8_t* slices, int s_base,
                                              int slice_bytes, int pieces, int kc, int m,
                                              int dsub, int t) {
  const int md = m * dsub, c0 = kChunk * c, c1 = min(c0 + kChunk, md);
  if (c0 >= c1) return;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int ra = r0 + 16 * warp + g;  // the thread's rows ra, ra + 8
  float acc[N / 2] = {};
  uint32_t a[4][4];
  int js = -1, jp = 0;  // the job (subspace, piece) in acc, not yet stored
  for (int s = c0 / dsub; s <= (c1 - 1) / dsub; ++s) {
    const int code_a = smem_code(cs, code_bytes, (s - c0 / dsub) * kRows + ra, k_codes);
    const int code_b = smem_code(cs, code_bytes, (s - c0 / dsub) * kRows + ra + 8, k_codes);
    uint32_t c2a = 0, c2b = 0;
    if (kImpl == kBf16Cmp) {
      const __nv_bfloat162 x = __float2bfloat162_rn(static_cast<float>(code_a));
      const __nv_bfloat162 y = __float2bfloat162_rn(static_cast<float>(code_b));
      c2a = *reinterpret_cast<const uint32_t*>(&x);
      c2b = *reinterpret_cast<const uint32_t*>(&y);
    }
    const uint8_t* sb = slices + (s - s_base) * slice_bytes;
    for (int p = 0; p < pieces; ++p) {
      const int lo = s * dsub + p * N, hi = min(lo + N, (s + 1) * dsub);
      if (lo >= hi || hi <= c0 || lo >= c1) continue;
      for (int kch = 0; kch < kc; ++kch) {
        // the last group retires before its A registers are rebuilt (a
        // register of a running wgmma redefined, or its accumulators read,
        // makes ptxas serialize every wgmma of the kernel)
        wgmma_wait<0>();
        fence_regs(acc);
        if (kch == 0 && js >= 0) store<N>(dst, acc, js, jp, c0, c1, dsub, r0, warp, g, tq);
        build_a<kImpl>(a, code_a, code_b, c2a, c2b, 64 * kch, tq);
        const uint64_t desc = sw128_desc(sb + (p * kc + kch) * (N * 128));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          Mma<N>::run(acc, a[ks], desc + 2 * ks, (kch | ks) != 0);
        wgmma_commit();
        js = s;
        jp = p;
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (js >= 0) store<N>(dst, acc, js, jp, c0, c1, dsub, r0, warp, g, tq);
}

// The same for the piece width `lanes` (8, 16, 24 or 32) of the plan.
template <int kImpl>
__device__ __forceinline__ void decode_rows(uint8_t* dst, int c, int r0, const uint8_t* cs,
                                            int code_bytes, int k_codes, const uint8_t* slices,
                                            int s_base, int slice_bytes, int lanes, int pieces,
                                            int kc, int m, int dsub, int t) {
  switch (lanes) {
    case 8:
      decode_rows_n<kImpl, 8>(dst, c, r0, cs, code_bytes, k_codes, slices, s_base,
                              slice_bytes, pieces, kc, m, dsub, t);
      break;
    case 16:
      decode_rows_n<kImpl, 16>(dst, c, r0, cs, code_bytes, k_codes, slices, s_base,
                               slice_bytes, pieces, kc, m, dsub, t);
      break;
    case 24:
      decode_rows_n<kImpl, 24>(dst, c, r0, cs, code_bytes, k_codes, slices, s_base,
                               slice_bytes, pieces, kc, m, dsub, t);
      break;
    default:
      decode_rows_n<kImpl, 32>(dst, c, r0, cs, code_bytes, k_codes, slices, s_base,
                               slice_bytes, pieces, kc, m, dsub, t);
  }
}

}  // namespace onehot_rs
