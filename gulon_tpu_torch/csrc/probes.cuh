// Pieces shared by the probe kernels P1/P2 (adc_probes.cu) and P3
// (kernel_probe.cu), the Hopper counterparts of the TPU's stage-ablation
// probes of the fused ADC scan:
//
// - the one-hot decode: a warpgroup decodes 64 rows of a 128-row block by
//   building the one-hot [64 rows x K] of their codes in shared memory and
//   contracting it on the tensor cores (wgmma m64n16) against the
//   codebook slice of one subspace, 16 codeword lanes at a time. That is
//   the TPU's decode formulation (a one-hot times codebook matmul); the
//   one-hot is built by one of five recipes (int compare, bf16 pair
//   compare, nibble outer product, byte-wise SIMD compare, s8 one-hot
//   against s8 codewords);
// - the block minimum of the natural orientation (corpus rows on wgmma M,
//   queries on N): a row block spans the 8 warps of two warpgroups, so the
//   minimum over its 128 rows folds in registers, then across the row
//   groups of a warp by shuffles, then across the warps through shared
//   memory, over integer keys ordered as the floats they stand for.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_decode.cuh"
#include "hopper.cuh"

namespace probes {

using namespace hopper;

// one-hot recipes
constexpr int kInt = 0;      // int32 compare of the code with each lane's code
constexpr int kBf16Cmp = 1;  // compare on packed bf16 pairs (K <= 256: exact integers)
constexpr int kNib = 2;      // 16-lane nibble one-hots, multiplied as bf16 pairs
constexpr int kCmp8 = 3;     // byte-wise SIMD compare of the int8 code (K <= 256)
constexpr int kI8 = 4;       // s8 one-hot against s8 codewords, dequantized

constexpr int kKc = 256;                       // codes a one-hot pass covers
constexpr int kOneHotBytes = 64 * kKc * 2;     // [64 rows][kKc] bf16 (s8: half used)
constexpr int kSliceBytes = 16 * kKc * 2;      // [16 lanes][kKc] codebook slice
constexpr int kScratchBytes = kOneHotBytes + kSliceBytes;  // one warpgroup's

// monotone int32 image of a float's bits (order of the floats, NaN aside);
// its own inverse
__device__ __forceinline__ int mono(int bits) { return bits >= 0 ? bits : bits ^ 0x7FFFFFFF; }

// 16 one-hot bytes of code `code` (-1: none): bf16 lanes k .. k + 7, or
// s8 lanes k .. k + 15 (kI8)
template <int kImpl>
__device__ __forceinline__ uint4 onehot_group(int code, int k) {
  uint32_t w[4];
  if (kImpl == kInt) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      w[p] = (code == k + 2 * p ? 0x3F80u : 0u) | (code == k + 2 * p + 1 ? 0x3F800000u : 0u);
  } else if (kImpl == kBf16Cmp) {
    const __nv_bfloat162 c2 = __float2bfloat162_rn(static_cast<float>(code));
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const __nv_bfloat162 e = __heq2(
          c2, __floats2bfloat162_rn(static_cast<float>(k + 2 * p),
                                    static_cast<float>(k + 2 * p + 1)));
      w[p] = *reinterpret_cast<const uint32_t*>(&e);
    }
  } else if (kImpl == kNib) {
    // lane k + l is hi(code) == hi(k) times lo(code) == lo(k) + l
    const uint32_t hi = (code >> 4) == (k >> 4) ? 0x3F803F80u : 0u;
    const int lo = code & 15, l0 = k & 15;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t lo2 =
          (lo == l0 + 2 * p ? 0x3F80u : 0u) | (lo == l0 + 2 * p + 1 ? 0x3F800000u : 0u);
      const __nv_bfloat162 e = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                                       *reinterpret_cast<const __nv_bfloat162*>(&lo2));
      w[p] = *reinterpret_cast<const uint32_t*>(&e);
    }
  } else if (kImpl == kCmp8) {
    // the code as its offset int8 byte (code - 128) in each byte, four
    // lanes a compare; a 0xFF byte widens to the bf16 1.0 of its lane
    const uint32_t c4 = (static_cast<uint32_t>(code - 128) & 0xFFu) * 0x01010101u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t lanes =
          ((static_cast<uint32_t>(k + 4 * h - 128) & 0xFFu) * 0x01010101u) + 0x03020100u;
      const uint32_t eq = code < 0 ? 0u : __vcmpeq4(c4, lanes);
      w[2 * h] = __byte_perm(eq, 0, 0x1100) & 0x3F803F80u;
      w[2 * h + 1] = __byte_perm(eq, 0, 0x3322) & 0x3F803F80u;
    }
  } else {  // kI8
    const uint32_t c4 = static_cast<uint32_t>(code & 0xFF) * 0x01010101u;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t lanes = static_cast<uint32_t>(k + 4 * p) * 0x01010101u + 0x03020100u;
      w[p] = code < 0 ? 0u : (__vcmpeq4(c4, lanes) & 0x01010101u);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bf16 element x (columns) of row r of a swizzled tile of [128][64] chunks
__device__ __forceinline__ uint16_t* tile_elem(uint8_t* tile, int r, int x) {
  return reinterpret_cast<uint16_t*>(tile + (x >> 6) * kChunkBytes + r * 128 +
                                     ((((x & 63) >> 3) ^ (r & 7)) << 4) + (x & 7) * 2);
}

// One warpgroup (t = 0 .. 127, named barrier `bar`) decodes rows r0 ..
// r0 + 63 of the row block at row0, decoded columns [c0, c1) (c1 <= m *
// dsub), into the swizzled tile dst whose column 0 is decoded column col0.
// For each subspace s and 16-lane piece p of it: the one-hot [64 rows][K]
// of the rows' codes, in passes of kKc codes, times the codebook slice
// cbT[s][16 p .. 16 p + 15][K] ([m][dpad][kpad], zero padded: bf16, or s8
// for kI8) on the tensor cores. One 1.0 in a row times bf16 codewords sums
// to the codeword exactly in f32, so the result equals the gathered
// codeword bit for bit (kI8: the s8 codeword times scale[s], rounded to
// bf16). scratch holds kScratchBytes, 1024-byte aligned.
template <int kImpl>
__device__ __forceinline__ void onehot_decode(
    uint8_t* dst, int col0, int c0, int c1, int r0, int64_t row0, const void* codes,
    int code_bytes, int n_cols, const void* cbT, const float* scale, int m, int k_codes,
    int kpad, int dsub, uint8_t* scratch, int bar, int t) {
  constexpr bool kS8 = kImpl == kI8;
  constexpr int kEsize = kS8 ? 1 : 2;
  constexpr int kLanes = 16 / kEsize;  // one-hot lanes of a 16-byte group
  if (c0 >= c1) return;
  uint8_t* oh = scratch;
  uint8_t* bt = scratch + kOneHotBytes;
  const int dpad = (dsub + 15) & ~15;
  const int warp = (t >> 5) & 3, lane = t & 31;
  const int rr = t & 63;  // the row whose one-hot this thread builds
  const int half = t >> 6;
  const int s_last = min(m - 1, (c1 - 1) / dsub);
  for (int s = c0 / dsub; s <= s_last; ++s) {
    const int code = adc_decode::load_code(
        codes, code_bytes, static_cast<int64_t>(s) * n_cols + row0 + r0 + rr, k_codes);
    for (int p = 0; 16 * p < dsub; ++p) {
      const int lo = s * dsub + 16 * p;
      if (lo >= c1 || min(lo + 16, (s + 1) * dsub) <= c0) continue;
      float acc[8] = {};
      int iacc[8] = {};
      for (int k0 = 0; k0 < kpad; k0 += kKc) {
        const int groups = min(kKc, kpad - k0) / kLanes;  // 16-byte groups a row
        bar_sync(bar, 128);  // the last pass's wgmma reads are done
        for (int g = half; g < groups; g += 2)
          *reinterpret_cast<uint4*>(oh + (g >> 3) * 8192 + rr * 128 +
                                    (((g & 7) ^ (rr & 7)) << 4)) =
              onehot_group<kImpl>(code, k0 + g * kLanes);
        for (int e = t; e < 16 * groups; e += 128) {
          const int n = e / groups, g = e - n * groups;
          const uint8_t* src = static_cast<const uint8_t*>(cbT) +
                               ((static_cast<int64_t>(s) * dpad + 16 * p + n) * kpad + k0) *
                                   kEsize +
                               g * 16;
          *reinterpret_cast<uint4*>(bt + (g >> 3) * 2048 + n * 128 +
                                    (((g & 7) ^ (n & 7)) << 4)) =
              __ldg(reinterpret_cast<const uint4*>(src));
        }
        fence_proxy_async();
        bar_sync(bar, 128);
        wgmma_fence();
        for (int ch = 0; ch < groups / 8; ++ch)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = sw128_desc(oh + ch * 8192) + 2 * kk;
            const uint64_t db = sw128_desc(bt + ch * 2048) + 2 * kk;
            if (kS8)
              wgmma_m64n16k32_s8(iacc, da, db, (k0 | ch | kk) != 0);
            else
              wgmma_m64n16k16(acc, da, db, (k0 | ch | kk) != 0);
          }
        wgmma_commit();
        wgmma_wait<0>();
        if (kS8)
          fence_regs(iacc);
        else
          fence_regs(acc);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = 8 * j + 2 * (lane & 3) + h;
            const int col = lo + n;
            if (16 * p + n >= dsub || col < c0 || col >= c1) continue;
            const int e = 4 * j + 2 * i + h;
            const float v = kS8 ? static_cast<float>(iacc[e]) * scale[s] : acc[e];
            *tile_elem(dst, r0 + 16 * warp + (lane >> 2) + 8 * i, col - col0) =
                __bfloat16_as_ushort(__float2bfloat16_rn(v));
          }
    }
  }
}

// Columns [c0, c1) at or past md = m * dsub of rows r0 .. r0 + 63 (t = 0 ..
// 127): with norm lanes (P1/P2) the row's hi and lo bf16 norm (norms [2,
// n_cols]), two ones, then zeros; without them (P3) zeros.
__device__ __forceinline__ void extra_columns(uint8_t* dst, int col0, int c0, int c1, int r0,
                                              int64_t row0, const uint16_t* norms,
                                              int n_cols, int md, bool norm_lanes, int t) {
  c0 = max(c0, md);
  const int width = c1 - c0;
  for (int e = t; e < 64 * width && width > 0; e += 128) {
    const int r = e / width, col = c0 + (e - r * width);
    uint16_t v = 0;
    if (norm_lanes) {
      if (col == md)
        v = __ldg(norms + row0 + r0 + r);
      else if (col == md + 1)
        v = __ldg(norms + n_cols + row0 + r0 + r);
      else if (col < md + 4)
        v = adc_decode::kOneBf16;
    }
    *tile_elem(dst, r0 + r, col - col0) = v;
  }
}

// Natural orientation: key[4 j + 2 i + h] is block row 64 wg + 16 warp +
// lane / 4 + 8 i and query 8 j + 2 (lane % 4) + h of the tile. The minimum
// over the block's 128 rows of each query, for all 256 threads of the two
// warpgroups (named barrier 1): over i in registers, over lane / 4 by xor
// shuffles, over the 8 warps through red ([8][128] keys); it lands in
// red[1024 + query].
template <typename Key>
__device__ __forceinline__ void natural_block_min(const Key (&key)[64], Key* red, int wg,
                                                  int warp, int lane, int tid) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Key v = min(key[4 * j + h], key[4 * j + 2 + h]);
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 16));
      if (lane < 4) red[(4 * wg + warp) * 128 + 8 * j + 2 * lane + h] = v;
    }
  bar_sync(1, 256);
  if (tid < 128) {
    Key v = red[tid];
#pragma unroll
    for (int w = 1; w < 8; ++w) v = min(v, red[w * 128 + tid]);
    red[1024 + tid] = v;
  }
  bar_sync(1, 256);
}

}  // namespace probes
