// The gather decode of the fused ADC scan K1 (adc_scan.cu), shared with
// the probe kernels (adc_probes.cu, whose "take" mode is this decode): PQ
// codes -> bf16 decoded rows [128][depth padded to 64], written 16 bytes at
// a time in the 128-byte-swizzled layout that wgmma reads. Columns past the
// m * dsub codeword lanes hold the row's hi/lo bf16 norm, two ones and
// zeros. NT is the number of threads that decode together (a multiple of
// 128); tid runs over 0 .. NT - 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace adc_decode {

using hopper::kChunk;
using hopper::kChunkBytes;
using hopper::kRows;

constexpr uint16_t kOneBf16 = 0x3F80;
// decode-table kinds of the columns past the codewords
constexpr int kNormHi = -1, kNormLo = -2, kOne = -3, kZero = -4;

// code of element idx of the [m, n_cols] code operand, -1 outside [0, K)
__device__ __forceinline__ int load_code(const void* codes, int code_bytes, int64_t idx,
                                         int k_codes) {
  int code;
  if (code_bytes == 1)  // K <= 256: offset-encoded int8 (code - 128)
    code = static_cast<int>(__ldg(static_cast<const int8_t*>(codes) + idx)) + 128;
  else if (code_bytes == 2)
    code = __ldg(static_cast<const int16_t*>(codes) + idx);
  else
    code = __ldg(static_cast<const int32_t*>(codes) + idx);
  return (code >= 0 && code < k_codes) ? code : -1;
}

// Streamed mode: chunk c (columns 64c .. 64c + 63) of the row block at
// row0, decoded from the codes and norms in global memory into the
// swizzled [128][64] tile dst. Thread t decodes 1024 / NT 16-byte groups
// of row t % 128. Codewords are gathered VW lanes a load (VW = 8, 4, 2 or
// 1, the largest dividing dsub): the gathers' L1 wavefronts, not their
// bytes, set the decode's cost. All code loads are issued before the
// codebook loads that depend on them, so a chunk costs two memory round
// trips. Code is the code operand's element type; VW is gather_lanes(dsub).
// MaxGathers (0: no bound) bounds the gathers a thread has in flight, and
// so the registers they hold: the groups are then decoded in batches of
// MaxGathers / (8 / VW), each two round trips.
template <int VW> struct LanesOf;
template <> struct LanesOf<8> { using T = uint4; };
template <> struct LanesOf<4> { using T = uint2; };
template <> struct LanesOf<2> { using T = uint32_t; };
template <> struct LanesOf<1> { using T = uint16_t; };

template <int NT, typename Code, int VW, int MaxGathers>
__device__ __forceinline__ void decode_chunk(
    uint8_t* dst, int c, int64_t row0, const Code* codes, const uint16_t* norms,
    const uint16_t* cb, int n_cols, int m, int k_codes, int dsub, int tid) {
  using namespace hopper;
  using Lanes = typename LanesOf<VW>::T;
  constexpr int kGroups = 8 * kRows / NT;  // 16-byte groups a thread
  constexpr int kStride = NT / kRows;
  constexpr int kPer = 8 / VW;                     // gathers a group
  constexpr int kFit = MaxGathers / kPer > 0 ? MaxGathers / kPer : 1;
  constexpr int kBatch = MaxGathers == 0 || kFit > kGroups ? kGroups : kFit;  // groups a batch
  static_assert(kGroups % kBatch == 0, "whole batches of groups");
  constexpr int kOffset = sizeof(Code) == 1 ? 128 : 0;  // int8 holds code - 128
  const int md = m * dsub;
  const int r = tid & 127;
  const int64_t row = row0 + r;
  const int g0 = tid >> 7;  // group i of this thread is kStride i + g0
#pragma unroll
  for (int i0 = 0; i0 < kGroups; i0 += kBatch) {
    int code[kBatch * kPer];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int col = min(c * kChunk + 8 * (kStride * (i0 + i) + g0), md - 1);
      int sub = col / dsub, off = col - sub * dsub;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        code[kPer * i + t] = __ldg(codes + static_cast<int64_t>(min(sub, m - 1)) * n_cols + row);
        if ((off += VW) >= dsub) {
          off -= dsub;
          ++sub;
        }
      }
    }
    union {
      Lanes v;
      uint16_t h[VW];
    } x[kBatch * kPer];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int col = c * kChunk + 8 * (kStride * (i0 + i) + g0);
      const int start = min(col, md - 1);
      int sub = start / dsub, off = start - sub * dsub;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int k = code[kPer * i + t] + kOffset;
        const bool ok = col + VW * t < md && k >= 0 && k < k_codes;
        const Lanes v =
            *reinterpret_cast<const Lanes*>(cb + (ok ? (sub * k_codes + k) * dsub + off : 0));
        x[kPer * i + t].v = ok ? v : Lanes{};
        if ((off += VW) >= dsub) {
          off -= dsub;
          ++sub;
        }
      }
    }
    const bool has_norms = (md >> 6) == c || ((md + 1) >> 6) == c;
    const uint32_t n_hi = has_norms ? __ldg(norms + row) : 0u;
    const uint32_t n_lo = has_norms ? __ldg(norms + n_cols + row) : 0u;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int g = kStride * (i0 + i) + g0;
      uint32_t w[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lane = 2 * p + h;
          const int col = c * kChunk + 8 * g + lane;
          v[h] = col < md       ? x[kPer * i + lane / VW].h[lane % VW]
                 : col == md     ? n_hi
                 : col == md + 1 ? n_lo
                 : col < md + 4  ? kOneBf16
                                 : 0u;
        }
        w[p] = v[0] | (v[1] << 16);
      }
      *reinterpret_cast<uint4*>(dst + r * 128 + ((g ^ (r & 7)) << 4)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Codebook lanes one gather of decode_chunk loads at subspace width dsub:
// the largest of 8, 4, 2 and 1 that divides it (one lane, two bytes, at an
// odd dsub). K1's launch plan reports the same number.
__host__ __device__ constexpr int gather_lanes(int dsub) {
  return dsub % 8 == 0 ? 8 : dsub % 4 == 0 ? 4 : dsub % 2 == 0 ? 2 : 1;
}

template <int NT, typename Code, int MaxGathers>
__device__ __forceinline__ void decode_chunk(
    uint8_t* dst, int c, int64_t row0, const Code* codes, const uint16_t* norms,
    const uint16_t* cb, int n_cols, int m, int k_codes, int dsub, int tid) {
  switch (gather_lanes(dsub)) {
    case 8:
      decode_chunk<NT, Code, 8, MaxGathers>(dst, c, row0, codes, norms, cb, n_cols, m, k_codes,
                                            dsub, tid);
      break;
    case 4:
      decode_chunk<NT, Code, 4, MaxGathers>(dst, c, row0, codes, norms, cb, n_cols, m, k_codes,
                                            dsub, tid);
      break;
    case 2:
      decode_chunk<NT, Code, 2, MaxGathers>(dst, c, row0, codes, norms, cb, n_cols, m, k_codes,
                                            dsub, tid);
      break;
    default:
      decode_chunk<NT, Code, 1, MaxGathers>(dst, c, row0, codes, norms, cb, n_cols, m, k_codes,
                                            dsub, tid);
  }
}

// The same from the untyped code operand (code_bytes 1, 2 or 4).
template <int NT, int MaxGathers = 0>
__device__ __forceinline__ void decode_chunk(
    uint8_t* dst, int c, int64_t row0, const void* codes, int code_bytes,
    const uint16_t* norms, const uint16_t* cb, int n_cols, int m, int k_codes, int dsub,
    int tid) {
  if (code_bytes == 1)
    decode_chunk<NT, int8_t, MaxGathers>(dst, c, row0, static_cast<const int8_t*>(codes), norms,
                                         cb, n_cols, m, k_codes, dsub, tid);
  else if (code_bytes == 2)
    decode_chunk<NT, int16_t, MaxGathers>(dst, c, row0, static_cast<const int16_t*>(codes),
                                          norms, cb, n_cols, m, k_codes, dsub, tid);
  else
    decode_chunk<NT, int32_t, MaxGathers>(dst, c, row0, static_cast<const int32_t*>(codes),
                                          norms, cb, n_cols, m, k_codes, dsub, tid);
}

// Block held decoded: all nch chunks of the row block from its codes and
// norms in shared memory, one 16-byte group (8 lanes) of one row a step,
// lanes on consecutive rows; swizzled stores are bank-conflict free.
template <int NT>
__device__ __forceinline__ void decode_block(
    uint8_t* dec, int nch, const int2* tab, const int16_t* codes_s, const uint16_t* norms_s,
    const uint16_t* cb, const uint16_t* cb_s, int cb_smem, int dsub, int tid) {
  using namespace hopper;
  for (int task = tid; task < nch * 8 * kRows; task += NT) {
    const int g = task >> 7;
    const int r = task & 127;
    uint32_t w[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int2 t = tab[8 * g + 2 * p + h];
        uint32_t x = 0;
        if (t.x >= 0) {
          const int code = codes_s[t.y + r];
          if (code >= 0) {
            const int i = t.x + code * dsub;
            x = cb_smem ? cb_s[i] : __ldg(cb + i);
          }
        } else if (t.x == kNormHi) {
          x = norms_s[r];
        } else if (t.x == kNormLo) {
          x = norms_s[kRows + r];
        } else if (t.x == kOne) {
          x = kOneBf16;
        }
        v[h] = x;
      }
      w[p] = v[0] | (v[1] << 16);
    }
    *reinterpret_cast<uint4*>(dec + (g >> 3) * kChunkBytes + r * 128 +
                              (((g & 7) ^ (r & 7)) << 4)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Column table of a row block held decoded: column -> (codebook offset,
// code row), or the kind of extra lane. Built once per thread block.
template <int NT>
__device__ __forceinline__ void column_table(int2* tab, int nch, int m, int k_codes,
                                             int dsub, int tid) {
  const int md = m * dsub;
  for (int col = tid; col < nch * kChunk; col += NT) {
    int2 e = make_int2(kZero, 0);
    if (col < md) {
      const int s = col / dsub;
      e = make_int2(s * k_codes * dsub + (col - s * dsub), s * kRows);
    } else if (col == md) {
      e.x = kNormHi;
    } else if (col == md + 1) {
      e.x = kNormLo;
    } else if (col < md + 4) {
      e.x = kOne;
    }
    tab[col] = e;
  }
}

// Codes (valid or -1) and hi/lo norms of the row block at row0 into shared
// memory, for decode_block.
template <int NT>
__device__ __forceinline__ void stage_block(int16_t* codes_s, uint16_t* norms_s,
                                            const void* codes, int code_bytes,
                                            const uint16_t* norms, int64_t row0, int n_cols,
                                            int m, int k_codes, int tid) {
  for (int e = tid; e < m * kRows; e += NT) {
    const int64_t idx = static_cast<int64_t>(e >> 7) * n_cols + row0 + (e & 127);
    codes_s[e] = static_cast<int16_t>(load_code(codes, code_bytes, idx, k_codes));
  }
  for (int e = tid; e < 2 * kRows; e += NT)
    norms_s[e] = __ldg(norms + static_cast<int64_t>(e >> 7) * n_cols + row0 + (e & 127));
}

}  // namespace adc_decode
