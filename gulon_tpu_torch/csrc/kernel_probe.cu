// Probe kernel P3 for Hopper (sm_90a): the fused ADC scan K1 cut down stage
// by stage, to find where its time goes on this card.
//
// Replaces the TPU bisection probe benchmarks/kernel_probe.py (make_tdec,
// make_cached, make_i8dec, make). One kernel; template parameters select
// the stage it stops after, the one-hot recipe and the orientation:
//
//   noop     write zeros (no decode, no contraction)
//   grid     decode each 128-row block, write zeros
//   noselect + the contraction; tdec_noselect writes the first nblk score
//            rows of each row tile, no_select the tile's score [0, 0]
//            everywhere
//   min      + the block minimum of each query (no ids)
//   match    + the lowest row reaching it (min, then match)
//   packed   + the TPU's sign-folded int32 key (score order, the row in
//            the low 7 bits) and one integer minimum; not K1's f32 key
//
// Scores are norms[row] - 2 <q, dec(row)> from one f32 norm row: the
// contraction covers the decoded codewords only (mdp lanes, zero past
// m * dsub), no norm lanes. The decode is probes.cuh's one-hot times
// codebook slice on the tensor cores, the one-hot built by an int compare,
// nibble one-hots multiplied (":nib"), a byte-wise compare (":cmp8"), or
// as s8 against s8 codewords dequantized (tdec_i8); tdec_cached reads a
// decoded operand built beforehand ([N][mdp] bf16) instead. Orientation:
// "tdec" puts the queries on wgmma M and the block's rows on N, as K1
// does; "natural" the rows on M, with the block minimum across warps.
//
// Output, as the TPU writes it: vals [n_cols / 128][Q] f32 and ids
// [n_cols / 128][Q] int32, row r * nblk + b for row tile r (nblk = t / 128
// blocks of 128 rows) and block b: the global 128-row block, so only
// noselect depends on t, and no_select also on the TPU's query tile.
//
// What bounds it: at the headline shape (401,408 rows, m 8, K 256, dsub
// 13, mdp 128, 1024 queries) the contraction's work (m * dsub = 104
// lanes; the kernel also multiplies the 24 zero lanes up to mdp) is
// 0.086 ms on the tensor cores, the bytes (int32 codes, f32 norms, two
// outputs) 0.012 ms; the
// one-hot decode is 256 compares and 16 m64n16k16 steps per row and
// subspace. Each stage is a simple correct kernel: it measures.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see gulon_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "hopper.cuh"
#include "probes.cuh"

namespace {

using namespace hopper;

constexpr int kNoop = 0, kGrid = 1, kNoSelect = 2, kMin = 3, kMatch = 4, kPacked = 5;
constexpr int kCached = 5;  // a decoded operand read, not decoded (beside probes::kInt ..)
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxStages = 6;

struct Params {
  const void* codes;      // [m, n_cols] of code_bytes each
  const float* norms;     // [n_cols] f32
  const void* cbT;        // [m, dpad, kpad] bf16, or s8 (tdec_i8)
  const float* scale;     // [m] (tdec_i8)
  const uint16_t* cache;  // [n_cols, mdp] bf16 (tdec_cached)
  float* vals;            // [n_cols / 128, num_q]
  int* ids;               // [n_cols / 128, num_q]
  int code_bytes, n_cols, num_q, mdp, m, k_codes, kpad, dsub, nblk, qt_tpu, nch, nst;
};

struct Layout {
  int ring, scratch, bars, red, norms, total;
};

__host__ __device__ inline Layout layout(int nch, int nst, bool decodes) {
  Layout L;
  L.ring = nch * kChunkBytes;
  L.scratch = L.ring + nst * kChunkBytes;
  L.bars = L.scratch + (decodes ? 2 * probes::kScratchBytes : 0);
  L.red = L.bars + 2 * nst * 8;
  L.norms = L.red + 9 * 128 * 8;
  L.total = L.norms + kRows * 4;
  return L;
}

__device__ __forceinline__ float from_key(int k) { return __int_as_float(probes::mono(k)); }

template <int kStage, int kImpl, bool kNatural>
__global__ void __launch_bounds__(kThreads, 1)
    kernel_probe(const __grid_constant__ CUtensorMap qmap,  // queries [num_q][mdp] bf16
                 const __grid_constant__ Params P) {
  constexpr bool kDecodes = kImpl != kCached;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nch = P.nch, nst = P.nst, num_q = P.num_q;
  const Layout L = layout(nch, nst, kDecodes);
  uint8_t* dec = smem;
  uint8_t* ring = smem + L.ring;
  uint8_t* scratch = smem + L.scratch;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + nst;
  float* norms_s = reinterpret_cast<float*>(smem + L.norms);

  const int n_blocks = P.n_cols / kRows;
  const int b0 = static_cast<int>(static_cast<int64_t>(n_blocks) * blockIdx.x / gridDim.x);
  const int b1 = static_cast<int>(static_cast<int64_t>(n_blocks) * (blockIdx.x + 1) / gridDim.x);
  if (b0 >= b1) return;
  const int n_qt = (num_q + kRows - 1) / kRows;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == kConsumers / 128) {  // producer warp: the query chunks, when scored
    if (kStage >= kNoSelect && tid == kConsumers) {
      int it = 0;
      for (int blk = b0; blk < b1; ++blk)
        for (int qt = 0; qt < n_qt; ++qt)
          for (int c = 0; c < nch; ++c, ++it) {
            const int st = it % nst;
            mbar_wait(&empty[st], ((it / nst) & 1) ^ 1);
            mbar_expect_tx(&full[st], kChunkBytes);
            tma_load_2d(ring + st * kChunkBytes, &qmap, &full[st], c * kChunk, qt * kRows);
          }
    }
    return;
  }

  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int md = P.m * P.dsub;
  float acc[64];
  int it = 0;
  for (int blk = b0; blk < b1; ++blk) {
    const int64_t row0 = static_cast<int64_t>(blk) * kRows;
    if constexpr (kStage == kNoop || kStage == kGrid) {
      if constexpr (kStage == kGrid) {
        bar_sync(1, kConsumers);  // the last block's decode is done
        const int w = tid >> 7, t = tid & 127;
        probes::onehot_decode<kImpl>(dec, 0, 0, md, 64 * w, row0, P.codes, P.code_bytes,
                                     P.n_cols, P.cbT, P.scale, P.m, P.k_codes, P.kpad, P.dsub,
                                     scratch + w * probes::kScratchBytes, 2 + w, t);
        probes::extra_columns(dec, 0, md, nch * kChunk, 64 * w, row0, nullptr, P.n_cols, md,
                              false, t);
        fence_proxy_async();  // the decoded tile is written, as for a contraction
      }
      for (int q = tid; q < num_q; q += kConsumers) {
        P.vals[static_cast<int64_t>(blk) * num_q + q] = 0.f;
        P.ids[static_cast<int64_t>(blk) * num_q + q] = 0;
      }
      continue;
    }

    bar_sync(1, kConsumers);  // every wgmma read of the last block is done
    if (tid < kRows) norms_s[tid] = __ldg(P.norms + row0 + tid);
    if constexpr (kImpl == kCached) {
      for (int e = tid; e < kRows * nch * 8; e += kConsumers) {
        const int r = e / (nch * 8), g = e - r * nch * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (8 * g < P.mdp)
          v = __ldg(reinterpret_cast<const uint4*>(P.cache + (row0 + r) * P.mdp + 8 * g));
        *reinterpret_cast<uint4*>(dec + (g >> 3) * kChunkBytes + r * 128 +
                                  (((g & 7) ^ (r & 7)) << 4)) = v;
      }
    } else {
      const int w = tid >> 7, t = tid & 127;
      probes::onehot_decode<kImpl>(
          dec, 0, 0, md, 64 * w, row0, P.codes, P.code_bytes, P.n_cols, P.cbT, P.scale, P.m,
          P.k_codes, P.kpad, P.dsub, scratch + w * probes::kScratchBytes, 2 + w, t);
      probes::extra_columns(dec, 0, md, nch * kChunk, 64 * w, row0, nullptr, P.n_cols, md,
                            false, t);
    }
    fence_proxy_async();
    bar_sync(1, kConsumers);

    const bool tile_first = blk % P.nblk == 0;
    for (int qt = 0; qt < n_qt; ++qt) {
      int prev = 0;
      for (int c = 0; c < nch; ++c) {
        const int st = it % nst;
        mbar_wait(&full[st], (it / nst) & 1);
        uint8_t* q_tile = ring + st * kChunkBytes;
        uint8_t* d_tile = dec + c * kChunkBytes;
        const uint64_t desc_a = sw128_desc(kNatural ? d_tile + wg * 64 * 128 : q_tile + wg * 64 * 128);
        const uint64_t desc_b = sw128_desc(kNatural ? q_tile : d_tile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16(acc, desc_a + 2 * kk, desc_b + 2 * kk, (c | kk) != 0);
        wgmma_commit();
        ++it;
        if (c > 0) {
          wgmma_wait<1>();
          release(&empty[prev], lane);
        }
        prev = st;
      }
      wgmma_wait<0>();
      release(&empty[prev], lane);
      fence_regs(acc);

      // scores = norms - 2 ipt (2 ipt is exact, so one rounding, as the TPU's)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = kNatural ? 64 * wg + 16 * warp + (lane >> 2) + 8 * i
                                     : 8 * j + 2 * (lane & 3) + h;
            acc[4 * j + 2 * i + h] = fmaf(-2.f, acc[4 * j + 2 * i + h], norms_s[row]);
          }

      float* vals = P.vals + static_cast<int64_t>(blk) * num_q;
      int* ids = P.ids + static_cast<int64_t>(blk) * num_q;
      if constexpr (!kNatural) {
        const int q = qt * kRows + wg * 64 + warp * 16 + (lane >> 2);  // and q + 8
        if (kStage == kNoSelect) {
          if (tile_first)
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int row = 8 * j + 2 * (lane & 3) + h;
                  if (row < P.nblk && q + 8 * i < num_q)
                    vals[static_cast<int64_t>(row) * num_q + q + 8 * i] = acc[4 * j + 2 * i + h];
                }
          if ((lane & 3) == 0)
            for (int i = 0; i < 2; ++i)
              if (q + 8 * i < num_q) ids[q + 8 * i] = 0;
          continue;
        }
        float v[2];
        int r[2] = {0, 0};
        if (kStage == kPacked) {
          int key[64];
#pragma unroll
          for (int e = 0; e < 64; ++e) key[e] = probes::mono(__float_as_int(acc[e]));
          pack_rows(key, lane);
          r[0] = block_min<0>(key, lane);
          r[1] = block_min<1>(key, lane);
          v[0] = from_key(r[0]);
          v[1] = from_key(r[1]);
          r[0] &= 127;
          r[1] &= 127;
        } else {
          v[0] = block_min<0>(acc, lane);
          v[1] = block_min<1>(acc, lane);
          if (kStage == kMatch) {
            int cand[64];
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                cand[4 * j + c] =
                    acc[4 * j + c] == v[c >> 1] ? acc_row(j, c & 1, lane) : kRows;
            r[0] = block_min<0>(cand, lane);
            r[1] = block_min<1>(cand, lane);
          }
        }
        const int i = lane & 3;
        if (i < 2 && q + 8 * i < num_q) {
          vals[q + 8 * i] = v[i];
          ids[q + 8 * i] = kStage == kMin ? 0 : blk * kRows + r[i];
        }
        continue;
      }

      // natural orientation: rows on M, the minimum across warps
      if (kStage == kNoSelect) {
        const bool first_q = (qt * kRows) % P.qt_tpu == 0;
        float* red_f = reinterpret_cast<float*>(smem + L.red);
        if (tile_first && first_q) {
          if (tid == 0) red_f[0] = acc[0];  // row 0, query 0 of the tile
          bar_sync(1, kConsumers);
          const float x = red_f[0];
          const int width = min(P.qt_tpu, num_q - qt * kRows);
          for (int e = tid; e < P.nblk * width; e += kConsumers) {
            const int rr = e / width, c = e - rr * width;
            vals[static_cast<int64_t>(rr) * num_q + qt * kRows + c] = x;
          }
          bar_sync(1, kConsumers);
        }
        if (tid < kRows && qt * kRows + tid < num_q) ids[qt * kRows + tid] = 0;
        continue;
      }
      const int q = qt * kRows + tid;
      if (kStage == kMatch) {
        long long key[64];
        long long* red = reinterpret_cast<long long*>(smem + L.red);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = 4 * j + 2 * i + h;
              const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * i;
              key[e] = static_cast<long long>(probes::mono(__float_as_int(acc[e]))) * 128 + row;
            }
        probes::natural_block_min(key, red, wg, warp, lane, tid);
        if (tid < kRows && q < num_q) {
          const long long k = red[1024 + tid];
          vals[q] = from_key(static_cast<int>(k >> 7));
          ids[q] = blk * kRows + static_cast<int>(k & 127);
        }
      } else {
        int key[64];
        int* red = reinterpret_cast<int*>(smem + L.red);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = 4 * j + 2 * i + h;
              const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * i;
              const int k = probes::mono(__float_as_int(acc[e]));
              key[e] = kStage == kPacked ? ((k & ~127) | row)
                                         : (acc[e] != acc[e] ? INT_MIN : k);  // NaN wins
            }
        probes::natural_block_min(key, red, wg, warp, lane, tid);
        if (tid < kRows && q < num_q) {
          const int k = red[1024 + tid];
          vals[q] = kStage == kMin && k == INT_MIN ? __int_as_float(0x7FC00000) : from_key(k);
          ids[q] = kStage == kMin ? 0 : blk * kRows + (k & 127);
        }
      }
    }
  }
}

template <int kStage, int kImpl, bool kNatural>
int launch(const CUtensorMap& qmap, const Params& P, int grid, int smem, cudaStream_t stream) {
  auto kernel = kernel_probe<kStage, kImpl, kNatural>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(qmap, P);
  return static_cast<int>(cudaGetLastError());
}

template <int kStage>
int launch_stage(int impl, int natural, const CUtensorMap& qmap, const Params& P, int grid,
                 int smem, cudaStream_t st) {
  if (natural)
    return impl == probes::kInt ? launch<kStage, probes::kInt, true>(qmap, P, grid, smem, st)
                                : static_cast<int>(cudaErrorInvalidValue);
  switch (impl) {
    case probes::kInt: return launch<kStage, probes::kInt, false>(qmap, P, grid, smem, st);
    case probes::kNib: return launch<kStage, probes::kNib, false>(qmap, P, grid, smem, st);
    case probes::kCmp8: return launch<kStage, probes::kCmp8, false>(qmap, P, grid, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
// stage 0-5 = noop grid noselect min match packed; impl 0 int, 2 nib, 3
// cmp8, 4 i8 (match only), 5 cached (match only); natural: int only.
extern "C" int gulon_kernel_probe(int stage, int impl, int natural, const void* codes,
                                  int code_bytes, const void* norms, const void* q,
                                  const void* cbT, const void* scale, const void* cache,
                                  void* vals, void* ids, int n_cols, int num_q, int mdp, int m,
                                  int k_codes, int kpad, int dsub, int nblk, int qt_tpu,
                                  void* stream) {
  Params P{codes, static_cast<const float*>(norms), cbT, static_cast<const float*>(scale),
           static_cast<const uint16_t*>(cache), static_cast<float*>(vals),
           static_cast<int*>(ids), code_bytes, n_cols, num_q, mdp, m, k_codes, kpad, dsub,
           nblk, qt_tpu, 0, 0};
  const bool s8 = impl == probes::kI8;
  if (n_cols <= 0 || num_q <= 0 || nblk <= 0 || nblk > kRows || n_cols % (nblk * kRows) ||
      mdp % 8 || mdp < m * dsub || m <= 0 || dsub <= 0 || k_codes < 1 || k_codes > 1024 ||
      qt_tpu <= 0 || qt_tpu % kRows || stage < kNoop || stage > kPacked ||
      (code_bytes != 1 && code_bytes != 2 && code_bytes != 4) ||
      ((impl == probes::kCmp8 || s8) && k_codes > 256) ||
      ((s8 || impl == kCached) && stage != kMatch) ||
      (impl == kCached ? cache == nullptr
                       : (cbT == nullptr || kpad < k_codes || kpad % (s8 ? 128 : 64) ||
                          (s8 && scale == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  P.nch = (mdp + kChunk - 1) / kChunk;
  for (int s = kMaxStages; s >= 2 && P.nst == 0; --s)
    if (1024 + layout(P.nch, s, impl != kCached).total <= kSmemLimit) P.nst = s;
  if (P.nst == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + layout(P.nch, P.nst, impl != kCached).total;
  const int sms = num_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const int grid = std::min(n_cols / kRows, sms);
  CUtensorMap qmap;
  if (!sw128_map(&qmap, q, 2, mdp, num_q, static_cast<uint64_t>(mdp) * 2, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kNoop: return launch<kNoop, probes::kInt, false>(qmap, P, grid, smem, st);
    case kGrid: return launch_stage<kGrid>(impl, natural, qmap, P, grid, smem, st);
    case kNoSelect: return launch_stage<kNoSelect>(impl, natural, qmap, P, grid, smem, st);
    case kMin: return launch_stage<kMin>(impl, natural, qmap, P, grid, smem, st);
    case kPacked: return launch_stage<kPacked>(impl, natural, qmap, P, grid, smem, st);
    default:  // kMatch
      if (!natural && impl == probes::kI8)
        return launch<kMatch, probes::kI8, false>(qmap, P, grid, smem, st);
      if (!natural && impl == kCached)
        return launch<kMatch, kCached, false>(qmap, P, grid, smem, st);
      return launch_stage<kMatch>(impl, natural, qmap, P, grid, smem, st);
  }
}
