// The one-hot decode of the probe kernels P1, P2 (adc_probes.cu) and P3
// (kernel_probe.cu), built for Hopper: the TPU's formulation (a one-hot of
// each row's code times the codebook slice of its subspace) with the
// one-hot never stored. A warpgroup decodes 64 rows of a 128-row block,
// one span of codeword columns at a time (P1 / P2: a 64-column chunk; P3:
// the block's m * dsub columns). For each subspace s and piece p of its
// lanes, the one-hot [64 rows x K] is built straight into the A registers
// of wgmma m64nNk16 (bf16; m64nNk32 for the s8 recipe) in its
// register-operand (RS) form, and the codebook slice [N lanes x K] is the
// B operand, read from shared memory.
//
// The A fragment of m64nNk16 (bf16): thread `lane` of warp w of the
// warpgroup holds rows 16 w + lane / 4 (a[0], a[2]) and + 8 (a[1], a[3]),
// k columns 2 (lane % 4) + {0, 1} (a[0], a[1]) and + 8 (a[2], a[3]), the
// lower column in the low half of each 32-bit register. Of m64nNk32 (s8):
// the same rows, k columns 4 (lane % 4) + {0 .. 3} (a[0], a[1]) and + 16
// (a[2], a[3]), the lowest column in the low byte. A thread's one-hot bits
// are then compares of its two rows' codes against its k columns, by one
// of five recipes:
//
//   kInt      an int compare of the code with each column;
//   kBf16Cmp  a compare on packed bf16 pairs (K <= 256, where bf16 holds
//             the codes exactly);
//   kNib      the hi-nibble match of the code with the pair's columns
//             ANDed with the lo-nibble match: the TPU's outer product of
//             two 16-row nibble one-hots (a product of 0 / 1 masks is
//             their AND);
//   kCmp8     the code's offset int8 byte (code - 128) against the four
//             columns of a row's two registers, four bytes a compare
//             (__vcmpeq4), each 0xFF byte widened to its column's bf16 1.0
//             (K <= 256);
//   kI8       an s8 one-hot (a byte 1 at the code's column) against s8
//             codewords, s32 sums, times the subspace's scale, rounded to
//             bf16 (K <= 256).
//
// A code outside [0, K) matches nothing (or a zero-padded slice column)
// and decodes to +0.
//
// N is the piece width: P1 / P2 take the subspace's lanes rounded up to 8
// (n8 at dsub 8, n16 at dsub 13), split into pieces of at most 32 lanes;
// P3 takes N = 16 always (one instantiation, eight accumulators, for its
// small decode warpgroups). A commit group is four k-steps on one
// accumulator, one chunk of K (64 codes, 128 for s8), for P1 / P2, and
// eight, two chunks, for P3 (half the waits). A warpgroup builds
// a group's A registers only once its last group has retired: a register
// of a running wgmma redefined (or its accumulators read) makes ptxas
// serialize every wgmma of the kernel, the contraction's too. The tensor
// cores overlap one warpgroup's compares with the other warpgroups'
// groups (P2 and P3: with the consumers' contraction). A one-hot row times
// bf16 codewords sums one product and zeros in f32, so each decoded lane
// equals the gathered codeword, up to the sign of a zero: a -0.0 codeword
// decodes to +0.0 unless every term of its sum is -0.0. The s8 sum is
// exact, so kI8 rounds the s8 codeword times its scale once, as the plain
// version does.
//
// Slices in shared memory: [P][K / C][N][C] a subspace (slice_bytes; C =
// 64 bf16 or 128 s8 codes, 128 bytes), each [N][C] chunk 128-byte
// swizzled, N * 128 bytes (a multiple of 1024), the layout of `cb_slices`
// in probes/adc_probes.py, so a subspace's slices are one contiguous copy.
// Codes: P1 / P2 stage a chunk's subspaces' [128] raw code elements of a
// block in shared memory; P3 loads each thread's two codes from global
// memory, a subspace ahead.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "probes.cuh"

namespace onehot_rs {

using namespace hopper;

// one-hot recipes (above)
constexpr int kInt = 0, kBf16Cmp = 1, kNib = 2, kCmp8 = 3, kI8 = 4;

// codes one 128-byte slice row (one commit group) covers
template <int kImpl>
constexpr int kGroupCodes = kImpl == kI8 ? 128 : 64;

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


// d (+)= A[64 x 32] . B[16 x 32]^T, s8 one-hot from registers (the k32
// layout above), s8 codewords from shared memory, s32 accumulators (the
// same d map); scale_d == 0 overwrites d. The integer form takes no scale
// or transpose immediates.
struct MmaS8 {
  static __device__ __forceinline__ void run(int (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
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
// (k even: k and k + 1 share their hi nibble)
__device__ __forceinline__ uint32_t pair_nib(int code, int k) {
  const uint32_t hi = (code >> 4) == (k >> 4) ? 0x3F803F80u : 0u;
  return hi & pair_int(code & 15, k & 15);
}
// s8 one-hot bytes of code == k .. k + 3 (low byte k)
__device__ __forceinline__ uint32_t quad_s8(int code, int k) {
  const unsigned d = static_cast<unsigned>(code - k);
  return d < 4u ? (1u << (8 * d)) : 0u;
}

// What a recipe computes once per code: kBf16Cmp the code as a bf16 pair,
// kCmp8 its offset int8 byte in all four bytes.
template <int kImpl>
__device__ __forceinline__ uint32_t code_word(int code) {
  if (kImpl == kBf16Cmp) {
    const __nv_bfloat162 x = __float2bfloat162_rn(static_cast<float>(code));
    return *reinterpret_cast<const uint32_t*>(&x);
  }
  if (kImpl == kCmp8) return (static_cast<uint32_t>(code - 128) & 0xFFu) * 0x01010101u;
  return 0u;
}

// The A registers of one commit group of S k-steps from code k0 of K (S /
// 4 slice chunks of kGroupCodes codes), for the thread's rows a and b
// (codes code_a / code_b, their code_word xa / xb).
template <int kImpl, int S>
__device__ __forceinline__ void build_a(uint32_t (&a)[S][4], int code_a, int code_b,
                                        uint32_t xa, uint32_t xb, int k0, int tq) {
#pragma unroll
  for (int ks = 0; ks < S; ++ks) {
    if (kImpl == kI8) {
      const int kb = k0 + 32 * ks + 4 * tq;
      a[ks][0] = quad_s8(code_a, kb);
      a[ks][1] = quad_s8(code_b, kb);
      a[ks][2] = quad_s8(code_a, kb + 16);
      a[ks][3] = quad_s8(code_b, kb + 16);
    } else if (kImpl == kCmp8) {
      // bytes: the offset columns kb, kb + 1, kb + 8, kb + 9 (a byte-wise
      // add, no carry between bytes)
      const int kb = k0 + 16 * ks + 2 * tq;
      const uint32_t cols =
          __vadd4((static_cast<uint32_t>(kb - 128) & 0xFFu) * 0x01010101u, 0x09080100u);
      const uint32_t ea = __vcmpeq4(xa, cols), eb = __vcmpeq4(xb, cols);
      a[ks][0] = __byte_perm(ea, 0, 0x1100) & 0x3F803F80u;
      a[ks][1] = __byte_perm(eb, 0, 0x1100) & 0x3F803F80u;
      a[ks][2] = __byte_perm(ea, 0, 0x3322) & 0x3F803F80u;
      a[ks][3] = __byte_perm(eb, 0, 0x3322) & 0x3F803F80u;
    } else {
      const int kb = k0 + 16 * ks + 2 * tq;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int code = (r & 1) ? code_b : code_a;
        const int k = kb + 8 * (r >> 1);
        a[ks][r] = kImpl == kBf16Cmp ? pair_bf16((r & 1) ? xb : xa, k)
                   : kImpl == kNib   ? pair_nib(code, k)
                                     : pair_int(code, k);
      }
    }
  }
}

// The lanes of piece p of subspace s into the tile dst (columns c0 .. c1 -
// 1 of the block; dst's column 0 is block column col0), as bf16x2 stores
// where dsub is even (a lane pair then starts on an even column of one
// 16-byte group). kI8: the s32 sum times scale[s], rounded once.
template <int kImpl, int N, typename Acc>
__device__ __forceinline__ void store(uint8_t* dst, const Acc (&acc)[N / 2], int s, int p,
                                      int col0, int c0, int c1, int dsub, int r0, int warp,
                                      int g, int tq, const float* scale) {
  const int lane0 = p * N;
  const int col_s = s * dsub + lane0;
  const float sc = kImpl == kI8 ? __ldg(scale + s) : 1.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 16 * warp + g + 8 * i;
      const int n = 8 * j + 2 * tq;
      const int col = col_s + n;
      const float v0 = kImpl == kI8 ? static_cast<float>(acc[4 * j + 2 * i]) * sc
                                    : static_cast<float>(acc[4 * j + 2 * i]);
      const float v1 = kImpl == kI8 ? static_cast<float>(acc[4 * j + 2 * i + 1]) * sc
                                    : static_cast<float>(acc[4 * j + 2 * i + 1]);
      const bool ok0 = lane0 + n < dsub && col >= c0 && col < c1;
      if ((dsub & 1) == 0) {
        if (ok0) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<uint32_t*>(probes::tile_elem(dst, r, col - col0)) =
              *reinterpret_cast<const uint32_t*>(&v);
        }
      } else {
        const bool ok1 = lane0 + n + 1 < dsub && col + 1 >= c0 && col + 1 < c1;
        if (ok0) *probes::tile_elem(dst, r, col - col0) = __bfloat16_as_ushort(__float2bfloat16_rn(v0));
        if (ok1)
          *probes::tile_elem(dst, r, col + 1 - col0) = __bfloat16_as_ushort(__float2bfloat16_rn(v1));
      }
    }
}

// One warpgroup (t = 0 .. 127) decodes the codeword columns [c0, c1) (c1 <=
// m * dsub) of block rows r0 .. r0 + 63 into the tile dst, whose column 0
// is block column col0 (chunk tiles of [128][64] side by side, kChunkBytes
// apart). code_at(s, r) is the code of subspace s at block row r, -1 for
// none (the next subspace's two codes are fetched while this one's groups
// run). Slices: subspace s at slices + (s - s_base) * slice_bytes, pieces
// of N lanes, kc chunks of kGroupCodes codes each (a multiple of kSteps /
// 4), kSteps k-steps a commit group (4 or 8: half the waits, twice the A
// registers). Columns past m * dsub are left to the caller. Ends with
// every group retired.
template <int kImpl, int N, int kSteps = 4, class CodeAt>
__device__ __forceinline__ void decode_span(uint8_t* dst, int col0, int c0, int c1, int r0,
                                            CodeAt code_at, const uint8_t* slices,
                                            int s_base, int slice_bytes, int pieces, int kc,
                                            int dsub, const float* scale, int t) {
  if (c0 >= c1) return;
  using Acc = typename std::conditional<kImpl == kI8, int, float>::type;
  const int warp = t >> 5, lane = t & 31, g = lane >> 2, tq = lane & 3;
  const int ra = r0 + 16 * warp + g;  // the thread's rows ra, ra + 8
  Acc acc[N / 2] = {};
  uint32_t a[kSteps][4];
  int js = -1, jp = 0;  // the job (subspace, piece) in acc, not yet stored
  const int s0 = c0 / dsub, s1 = (c1 - 1) / dsub;
  int next_a = code_at(s0, ra), next_b = code_at(s0, ra + 8);
  for (int s = s0; s <= s1; ++s) {
    const int code_a = next_a, code_b = next_b;
    if (s < s1) {
      next_a = code_at(s + 1, ra);
      next_b = code_at(s + 1, ra + 8);
    }
    const uint32_t xa = code_word<kImpl>(code_a), xb = code_word<kImpl>(code_b);
    const uint8_t* sb = slices + (s - s_base) * slice_bytes;
    for (int p = 0; p < pieces; ++p) {
      const int lo = s * dsub + p * N, hi = min(lo + N, (s + 1) * dsub);
      if (lo >= hi || hi <= c0 || lo >= c1) continue;
      for (int kch = 0; kch < kc; kch += kSteps / 4) {
        // the last group retires before its A registers are rebuilt (a
        // register of a running wgmma redefined, or its accumulators read,
        // makes ptxas serialize every wgmma of the kernel)
        wgmma_wait<0>();
        fence_regs(acc);
        if (kch == 0 && js >= 0)
          store<kImpl, N>(dst, acc, js, jp, col0, c0, c1, dsub, r0, warp, g, tq, scale);
        build_a<kImpl>(a, code_a, code_b, xa, xb, kGroupCodes<kImpl> * kch, tq);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          const uint64_t desc = sw128_desc(sb + (p * kc + kch + ks / 4) * (N * 128)) + 2 * (ks % 4);
          if constexpr (kImpl == kI8)
            MmaS8::run(acc, a[ks], desc, (kch | ks) != 0);
          else
            Mma<N>::run(acc, a[ks], desc, (kch | ks) != 0);
        }
        wgmma_commit();
        js = s;
        jp = p;
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (js >= 0) store<kImpl, N>(dst, acc, js, jp, col0, c0, c1, dsub, r0, warp, g, tq, scale);
}

// P1 / P2: one warpgroup decodes chunk c (columns 64 c .. 64 c + 63, those
// below m * dsub) of block rows r0 .. r0 + 63 into the chunk tile dst, from
// the chunk's staged codes cs (its first subspace's 128 codes first; raw
// elements of code_bytes) and the staged slices, for the piece width
// `lanes` (8, 16, 24 or 32) of the plan.
template <int kImpl>
__device__ __forceinline__ void decode_rows(uint8_t* dst, int c, int r0, const uint8_t* cs,
                                            int code_bytes, int k_codes, const uint8_t* slices,
                                            int s_base, int slice_bytes, int lanes, int pieces,
                                            int kc, int m, int dsub, int t) {
  const int c0 = kChunk * c, c1 = min(c0 + kChunk, m * dsub), s_lo = c0 / dsub;
  auto code_at = [=](int s, int r) {
    return smem_code(cs, code_bytes, (s - s_lo) * kRows + r, k_codes);
  };
  switch (lanes) {
    case 8:
      decode_span<kImpl, 8>(dst, c0, c0, c1, r0, code_at, slices, s_base, slice_bytes, pieces,
                            kc, dsub, nullptr, t);
      break;
    case 16:
      decode_span<kImpl, 16>(dst, c0, c0, c1, r0, code_at, slices, s_base, slice_bytes,
                             pieces, kc, dsub, nullptr, t);
      break;
    case 24:
      decode_span<kImpl, 24>(dst, c0, c0, c1, r0, code_at, slices, s_base, slice_bytes,
                             pieces, kc, dsub, nullptr, t);
      break;
    default:
      decode_span<kImpl, 32>(dst, c0, c0, c1, r0, code_at, slices, s_base, slice_bytes,
                             pieces, kc, dsub, nullptr, t);
  }
}

}  // namespace onehot_rs
