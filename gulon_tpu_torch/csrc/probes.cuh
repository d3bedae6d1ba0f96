// Pieces shared by the probe kernels P1/P2 (adc_probes.cu) and P3
// (kernel_probe.cu), the Hopper counterparts of the TPU's stage-ablation
// probes of the fused ADC scan:
//
// - the monotone integer image of a float's bits, which the selections of
//   both order their keys by;
// - the element address of a 128-byte-swizzled tile of [128][64] bf16
//   chunks, where the one-hot decodes (onehot_rs.cuh) store their lanes,
//   and the columns past the codewords (P1 / P2's norm lanes, or zeros);
// - the block minimum of P1's natural orientation (corpus rows on wgmma M,
//   queries on N): a row block spans the 8 warps of two warpgroups, so the
//   minimum over its 128 rows folds in registers, then across the row
//   groups of a warp by shuffles, then across the warps through shared
//   memory, over integer keys ordered as the floats they stand for. P3's
//   natural orientation gives each consumer warpgroup a whole block (two
//   m64 tiles), so its minimum stays inside the warpgroup
//   (kernel_probe.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_decode.cuh"
#include "hopper.cuh"

namespace probes {

using namespace hopper;

// monotone int32 image of a float's bits (order of the floats, NaN aside);
// its own inverse
__device__ __forceinline__ int mono(int bits) { return bits >= 0 ? bits : bits ^ 0x7FFFFFFF; }

// bf16 element x (columns) of row r of a swizzled tile of [128][64] chunks
__device__ __forceinline__ uint16_t* tile_elem(uint8_t* tile, int r, int x) {
  return reinterpret_cast<uint16_t*>(tile + (x >> 6) * kChunkBytes + r * 128 +
                                     ((((x & 63) >> 3) ^ (r & 7)) << 4) + (x & 7) * 2);
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
