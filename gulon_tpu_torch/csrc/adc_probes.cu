// Probe kernels P1 and P2 for Hopper (sm_90a): the fused ADC scan K1
// (adc_scan.cu) with its in-kernel formulation selectable, to measure what
// each stage of K1 costs on this card.
//
// Replaces the TPU probes benchmarks/adc_probes.py::_adc_fused_kernel_probe
// (P1; decode _decode_columns_probe) and ::_adc_fused_kernel_pipe (P2).
// The contract is K1's, bit for bit in the decoded rows: per 128-row block
// and query the lane-packed minimum of the f32 scores over depth = m*dsub
// + 4 (codewords, hi/lo norm lanes, two ones), 1-4 winners, NaN carried as
// jnp.min carries it, winner w of block b in column
// (b / nblk) * W * nblk + w * nblk + b % nblk. Template parameters select:
//
// - the decode (kDec): kTake gathers codewords from the codebooks in
//   shared memory (K1's own decode, adc_decode.cuh: the anchor, which
//   should time with K1); kBase builds the one-hot of each subspace's codes
//   in shared memory and contracts it against the codebook slice on the
//   tensor cores (probes.cuh), the TPU's formulation; kBf16Cmp the same
//   with the compare done on packed bf16 pairs (K <= 256);
// - the orientation (kNatural): queries on wgmma M and the block's rows on
//   N, as K1 (each thread then folds a query's minimum over its own
//   registers and its lane quad), or rows on M and queries on N, where a
//   block's 128 rows span 8 warps and the minimum needs shuffles and shared
//   memory (probes.cuh natural_block_min) over integer keys that order as
//   the packed floats do, a NaN below every number and the lowest NaN row
//   first;
// - the schedule (kPipe, base orientation only): a decode warpgroup fills
//   a two-slot ring of decoded row blocks (one 64-column chunk at a time
//   when streamed) while the two consumer warpgroups contract the other
//   slot with async wgmma, where K1's consumers decode between their
//   contractions;
// - kStreamed: rows too deep to hold a decoded block beside the query ring
//   are decoded one 64-column chunk at a time for each query tile, as K1's
//   streamed mode does.
//
// What bounds it: the same work as K1 (tensor cores at glove100's shape)
// plus the decode formulation under test. The one-hot decode costs K
// compares and K/16 m64n16k16 steps per row and subspace, where the gather
// costs dsub loads: at K = 256 the decode, not the contraction, is the
// larger part. A simple kernel that is right comes first here; the probes
// measure, they do not serve.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see gulon_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "adc_decode.cuh"
#include "hopper.cuh"
#include "probes.cuh"

namespace {

using namespace hopper;
using namespace adc_decode;

constexpr int kTake = 0, kBase = 1, kBf16 = 2;  // decode formulations
constexpr int kConsumers = 256;                  // two consumer warpgroups
constexpr int kMaxStages = 6;
constexpr int kDecSlots = 3;  // decoded chunks of the streamed mode (not piped)

struct Params {
  const void* codes;       // [m, n_cols] of code_bytes each
  const uint16_t* norms;   // [2, n_cols] bf16 hi/lo
  const uint16_t* cb;      // [m, K, dsub] bf16 (gather)
  const uint16_t* cbT;     // [m, dpad, kpad] bf16 (one-hot)
  float* out;              // [num_q, n_blocks * winners]
  int code_bytes, n_cols, num_q, depth, m, k_codes, dsub, kpad, winners, nblk, nch, nst,
      cb_smem;
};

// Shared-memory offsets from the 1024-byte-aligned base: decoded chunks,
// the query ring, the one-hot scratch of each decoding warpgroup, the
// barriers (ring full / empty, then decoded-slot full / empty), the
// natural orientation's reduction, and for the gather the codebooks (when
// held there) and, when the block is held decoded, its codes, norms and
// column table.
struct Layout {
  int ring, scratch, bars, red, cb, codes, norms, tab, total;
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int dec_chunks, int nst, int n_scratch, bool natural,
                                         int cb_bytes, bool take_held, int m, int nch) {
  Layout L;
  L.ring = dec_chunks * kChunkBytes;
  L.scratch = L.ring + nst * kChunkBytes;
  L.bars = L.scratch + n_scratch * probes::kScratchBytes;
  L.red = round16(L.bars + (2 * nst + 4) * 8);
  L.cb = L.red + (natural ? 9 * 128 * 4 : 0);
  L.codes = L.cb + round16(cb_bytes);
  L.norms = L.codes + (take_held ? round16(m * kRows * 2) : 0);
  L.tab = L.norms + (take_held ? 2 * kRows * 2 : 0);
  L.total = L.tab + (take_held ? nch * kChunk * 8 : 0);
  return L;
}

template <int kDec>
constexpr int kOneHotOf = kDec == kBf16 ? probes::kBf16Cmp : probes::kInt;

// A row block held decoded: every column, by NT threads (tid 0 .. NT - 1,
// named barrier bar_all; warpgroup w of them uses barrier 2 + w, or
// bar_all when NT is one warpgroup). Starts with a barrier, so the staging
// and the tile may be reused block after block.
template <int kDec, int NT>
__device__ __forceinline__ void decode_held(uint8_t* dst, int64_t row0, const Params& P,
                                            const int2* tab, int16_t* codes_s,
                                            uint16_t* norms_s, const uint16_t* cb_s,
                                            uint8_t* scratch, int bar_all, int tid) {
  bar_sync(bar_all, NT);
  if (kDec == kTake) {
    stage_block<NT>(codes_s, norms_s, P.codes, P.code_bytes, P.norms, row0, P.n_cols, P.m,
                    P.k_codes, tid);
    bar_sync(bar_all, NT);
    decode_block<NT>(dst, P.nch, tab, codes_s, norms_s, P.cb, cb_s, P.cb_smem, P.dsub, tid);
    return;
  }
  const int md = P.m * P.dsub;
  const int w = tid >> 7, t = tid & 127;
  const int bar = NT == 128 ? bar_all : 2 + w;
  for (int r0 = 64 * w; r0 < kRows; r0 += NT / 2) {
    probes::onehot_decode<kOneHotOf<kDec>>(
        dst, 0, 0, md, r0, row0, P.codes, P.code_bytes, P.n_cols, P.cbT, nullptr, P.m,
        P.k_codes, P.kpad, P.dsub, scratch + w * probes::kScratchBytes, bar, t);
    probes::extra_columns(dst, 0, md, P.nch * kChunk, r0, row0, P.norms, P.n_cols, md, true, t);
  }
}

// Chunk c (columns 64c .. 64c + 63) of the row block at row0 into the
// one-chunk tile dst, by NT threads as above (no barrier before).
template <int kDec, int NT>
__device__ __forceinline__ void decode_streamed(uint8_t* dst, int c, int64_t row0,
                                                const Params& P, const uint16_t* cb_src,
                                                uint8_t* scratch, int bar_all, int tid) {
  if (kDec == kTake) {
    decode_chunk<NT>(dst, c, row0, P.codes, P.code_bytes, P.norms, cb_src, P.n_cols, P.m,
                     P.k_codes, P.dsub, tid);
    return;
  }
  const int md = P.m * P.dsub;
  const int w = tid >> 7, t = tid & 127;
  const int bar = NT == 128 ? bar_all : 2 + w;
  for (int r0 = 64 * w; r0 < kRows; r0 += NT / 2) {
    probes::onehot_decode<kOneHotOf<kDec>>(
        dst, kChunk * c, kChunk * c, min(kChunk * (c + 1), md), r0, row0, P.codes,
        P.code_bytes, P.n_cols, P.cbT, nullptr, P.m, P.k_codes, P.kpad, P.dsub,
        scratch + w * probes::kScratchBytes, bar, t);
    probes::extra_columns(dst, kChunk * c, kChunk * c, kChunk * (c + 1), r0, row0, P.norms,
                          P.n_cols, md, true, t);
  }
}

template <int kDec, bool kNatural, bool kStreamed, bool kPipe>
__global__ void __launch_bounds__(kConsumers + (kPipe ? 128 : 0) + 32, 1)
    adc_probe_kernel(const __grid_constant__ CUtensorMap qmap,  // queries [num_q][depth] bf16
                     const __grid_constant__ Params P) {
  static_assert(!(kPipe && kNatural), "the piped schedule runs the base orientation");
  constexpr int kDecoders = kPipe ? 128 : 0;
  constexpr bool kTakeHeld = kDec == kTake && !kStreamed;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nch = P.nch, nst = P.nst;
  const int cb_len = P.m * P.k_codes * P.dsub;
  const int slot_chunks = kStreamed ? 1 : nch;
  const int dec_chunks = kStreamed ? (kPipe ? 2 : kDecSlots) : (kPipe ? 2 : 1) * nch;
  const int n_scratch = kDec == kTake ? 0 : (kPipe ? 1 : 2);
  const Layout L = layout(dec_chunks, nst, n_scratch, kNatural,
                          kDec == kTake && P.cb_smem ? cb_len * 2 : 0, kTakeHeld, P.m, nch);
  uint8_t* dec = smem;
  uint8_t* ring = smem + L.ring;
  uint8_t* scratch = smem + L.scratch;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + nst;
  uint64_t* dfull = empty + nst;  // decoded slots (piped)
  uint64_t* dempty = dfull + 2;
  int* red = reinterpret_cast<int*>(smem + L.red);
  uint16_t* cb_s = reinterpret_cast<uint16_t*>(smem + L.cb);
  int16_t* codes_s = reinterpret_cast<int16_t*>(smem + L.codes);
  uint16_t* norms_s = reinterpret_cast<uint16_t*>(smem + L.norms);
  int2* tab = reinterpret_cast<int2*>(smem + L.tab);

  const int n_blocks = P.n_cols / kRows;
  const int b0 = static_cast<int>(static_cast<int64_t>(n_blocks) * blockIdx.x / gridDim.x);
  const int b1 = static_cast<int>(static_cast<int64_t>(n_blocks) * (blockIdx.x + 1) / gridDim.x);
  if (b0 >= b1) return;
  const int n_qt = (P.num_q + kRows - 1) / kRows;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&dfull[s], 128);
      mbar_init(&dempty[s], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == (kConsumers + kDecoders) / 128) {  // producer warp: the query chunks
    if (tid == kConsumers + kDecoders) {
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

  // the threads that decode: the consumers themselves, or the decode
  // warpgroup of the piped schedule; once per thread block, the codebooks
  // and the column table of the gather
  const int dtid = kPipe ? tid - kConsumers : tid;
  if ((!kPipe || wg == 2) && kDec == kTake) {
    constexpr int NT = kPipe ? 128 : kConsumers;
    if (P.cb_smem) {
      const int n16 = cb_len / 8;
      for (int i = dtid; i < n16; i += NT)
        reinterpret_cast<uint4*>(cb_s)[i] = __ldg(reinterpret_cast<const uint4*>(P.cb) + i);
      for (int i = n16 * 8 + dtid; i < cb_len; i += NT) cb_s[i] = __ldg(P.cb + i);
    }
    if (kTakeHeld) column_table<NT>(tab, nch, P.m, P.k_codes, P.dsub, dtid);
    bar_sync(kPipe ? 4 : 1, NT);
  }

  if (kPipe && wg == 2) {  // the decode warpgroup fills the two slots in turn
    int u = 0;
    for (int blk = b0; blk < b1; ++blk) {
      const int64_t row0 = static_cast<int64_t>(blk) * kRows;
      for (int qt = 0; qt < (kStreamed ? n_qt : 1); ++qt)
        for (int c = 0; c < (kStreamed ? nch : 1); ++c, ++u) {
          const int slot = u & 1;
          mbar_wait(&dempty[slot], ((u >> 1) & 1) ^ 1);
          uint8_t* dst = dec + slot * slot_chunks * kChunkBytes;
          if (kStreamed)
            decode_streamed<kDec, 128>(dst, c, row0, P, P.cb_smem ? cb_s : P.cb, scratch, 4,
                                       dtid);
          else
            decode_held<kDec, 128>(dst, row0, P, tab, codes_s, norms_s, cb_s, scratch, 4, dtid);
          fence_proxy_async();
          mbar_arrive(&dfull[slot]);
        }
    }
    return;
  }

  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_win = n_blocks * P.winners;
  float acc[64];
  int it = 0;
  int dk = 0;  // decoded chunks consumed (streamed) or blocks (piped, held)
  for (int blk = b0; blk < b1; ++blk) {
    const int64_t row0 = static_cast<int64_t>(blk) * kRows;
    uint8_t* held = dec;
    int held_slot = 0;
    if (!kStreamed) {
      if (kPipe) {
        held_slot = dk & 1;
        mbar_wait(&dfull[held_slot], (dk >> 1) & 1);
        held = dec + held_slot * nch * kChunkBytes;
        ++dk;
      } else {
        decode_held<kDec, kConsumers>(dec, row0, P, tab, codes_s, norms_s, cb_s, scratch, 1,
                                      tid);
        fence_proxy_async();
        bar_sync(1, kConsumers);
      }
    }

    const int col0 = (blk / P.nblk) * P.winners * P.nblk + (blk % P.nblk);
    for (int qt = 0; qt < n_qt; ++qt) {
      // chunk c's wgmma group is issued before chunk c-1's stage (and,
      // streamed and piped, its decoded slot) is freed; chunk 0 overwrites
      // the accumulators
      auto mma_chunk = [&](int c) {
        uint8_t* b = held + c * kChunkBytes;
        if (kStreamed) {
          if (kPipe) {
            const int slot = dk & 1;
            mbar_wait(&dfull[slot], (dk >> 1) & 1);
            b = dec + slot * kChunkBytes;
          } else {
            b = dec + (dk % kDecSlots) * kChunkBytes;
            decode_streamed<kDec, kConsumers>(b, c, row0, P, P.cb_smem ? cb_s : P.cb, scratch,
                                              1, tid);
            fence_proxy_async();
            bar_sync(1, kConsumers);
          }
          ++dk;
        }
        const int st = it % nst;
        mbar_wait(&full[st], (it / nst) & 1);
        uint8_t* q_tile = ring + st * kChunkBytes;
        const uint64_t desc_a = sw128_desc(kNatural ? b + wg * 64 * 128 : q_tile + wg * 64 * 128);
        const uint64_t desc_b = sw128_desc(kNatural ? q_tile : b);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // lanes past depth are zero in both operands
          wgmma_m64n128k16(acc, desc_a + 2 * kk, desc_b + 2 * kk, (c | kk) != 0);
        wgmma_commit();
        ++it;
        return st;
      };
      int prev = mma_chunk(0);
      for (int c = 1; c < nch; ++c) {
        const int st = mma_chunk(c);
        wgmma_wait<1>();
        release(&empty[prev], lane);
        if (kStreamed && kPipe) release(&dempty[(dk - 2) & 1], lane);
        prev = st;
      }
      wgmma_wait<0>();
      release(&empty[prev], lane);
      if (kStreamed && kPipe) release(&dempty[(dk - 1) & 1], lane);
      fence_regs(acc);

      if (!kNatural) {
        pack_rows(acc, lane);
        const int q = qt * kRows + wg * 64 + warp * 16 + (lane >> 2);
        for (int w = 0; w < P.winners; ++w) {
          const float v0 = block_min<0>(acc, lane);
          const float v1 = block_min<1>(acc, lane);
          const int64_t col = col0 + w * P.nblk;
          if ((lane & 3) == 0 && q < P.num_q) P.out[static_cast<int64_t>(q) * n_win + col] = v0;
          if ((lane & 3) == 1 && q + 8 < P.num_q)
            P.out[static_cast<int64_t>(q + 8) * n_win + col] = v1;
          if (w + 1 < P.winners) mask_winner(acc, v0, v1);
        }
      } else {
        // keys: the packed float's order; a NaN below every number, the
        // lowest NaN row first (jnp.min's NaN, with K1's row rule)
        int key[64];
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = 4 * j + 2 * i + h;
              const int row = 64 * wg + 16 * warp + (lane >> 2) + 8 * i;
              const int bits = (__float_as_int(acc[e]) & ~127) | row;
              const float v = __int_as_float(bits);
              key[e] = v != v ? (INT_MIN | row) : probes::mono(bits);
            }
        for (int w = 0; w < P.winners; ++w) {
          probes::natural_block_min(key, red, wg, warp, lane, tid);
          const int q = qt * kRows + tid;
          if (tid < kRows && q < P.num_q) {
            const int k = red[1024 + tid];
            const int bits = k <= INT_MIN + 127 ? (0x7FC00000 | (k & 127)) : probes::mono(k);
            P.out[static_cast<int64_t>(q) * n_win + col0 + w * P.nblk] = __int_as_float(bits);
          }
          if (w + 1 < P.winners) {
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int k = red[1024 + 8 * j + 2 * (lane & 3) + h];
                if (k <= INT_MIN + 127) continue;  // a NaN winner stays, as with jnp.min
#pragma unroll
                for (int i = 0; i < 2; ++i)
                  if (key[4 * j + 2 * i + h] == k) key[4 * j + 2 * i + h] = __float_as_int(kBig);
              }
          }
        }
      }
    }
    if (kPipe && !kStreamed) release(&dempty[held_slot], lane);
  }
}

// The decoded rows themselves: [n_cols][width] bf16 (width >= depth, zero
// past it), one block of threads per 128-row block, chunk by chunk through
// the decode under test; for holding each formulation's decode against the
// plain gather bit for bit.
template <int kDec>
__global__ void __launch_bounds__(kConsumers, 1)
    adc_probe_decode_kernel(const __grid_constant__ Params P, uint16_t* __restrict__ rows,
                            int width) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* tile = smem;
  uint8_t* scratch = smem + kChunkBytes;
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  for (int c = 0; c * kChunk < width; ++c) {
    bar_sync(1, kConsumers);  // the last chunk's copy-out is done
    decode_streamed<kDec, kConsumers>(tile, c, row0, P, P.cb, scratch, 1, tid);
    bar_sync(1, kConsumers);
    for (int e = tid; e < kRows * 8; e += kConsumers) {
      const int r = e >> 3, g = e & 7;
      const int col = c * kChunk + 8 * g;
      if (col < width)
        *reinterpret_cast<uint4*>(rows + (row0 + r) * width + col) =
            *reinterpret_cast<const uint4*>(tile + r * 128 + ((g ^ (r & 7)) << 4));
    }
  }
}

template <int kDec, bool kNatural, bool kStreamed, bool kPipe>
int launch(const CUtensorMap& qmap, const Params& P, int grid, int smem, cudaStream_t stream) {
  auto kernel = adc_probe_kernel<kDec, kNatural, kStreamed, kPipe>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kConsumers + (kPipe ? 128 : 0) + 32, smem, stream>>>(qmap, P);
  return static_cast<int>(cudaGetLastError());
}

template <int kDec>
int launch_decode(int natural, int streamed, int pipe, const CUtensorMap& qmap,
                  const Params& P, int grid, int smem, cudaStream_t stream) {
  if (pipe) {
    if (natural) return static_cast<int>(cudaErrorInvalidValue);
    return streamed ? launch<kDec, false, true, true>(qmap, P, grid, smem, stream)
                    : launch<kDec, false, false, true>(qmap, P, grid, smem, stream);
  }
  if (natural)
    return streamed ? launch<kDec, true, true, false>(qmap, P, grid, smem, stream)
                    : launch<kDec, true, false, false>(qmap, P, grid, smem, stream);
  return streamed ? launch<kDec, false, true, false>(qmap, P, grid, smem, stream)
                  : launch<kDec, false, false, false>(qmap, P, grid, smem, stream);
}

bool check(const Params& P, int decode) {
  const int64_t cb_len = static_cast<int64_t>(P.m) * P.k_codes * P.dsub;
  const int dpad = (P.dsub + 15) & ~15;
  return P.n_cols > 0 && P.n_cols % kRows == 0 && P.m > 0 && P.dsub > 0 &&
         P.depth == P.m * P.dsub + 4 && P.k_codes >= 1 && P.k_codes <= 1024 &&
         cb_len <= 0x7FFFFFFF && decode >= kTake && decode <= kBf16 &&
         (decode != kBf16 || P.k_codes <= 256) &&
         (decode == kTake || (P.kpad % 64 == 0 && P.kpad >= P.k_codes && P.cbT != nullptr &&
                              dpad > 0)) &&
         (P.code_bytes == 1 || P.code_bytes == 2 || P.code_bytes == 4);
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t (0 =
// launched). Shapes and alignment are checked by the Python wrapper; this
// re-checks what would make a launch read or write out of bounds.
//
// gulon_adc_probe: the scan. decode 0 = take (gather), 1 = base (one-hot,
// int compare), 2 = bf16cmp (one-hot, bf16 pair compare); natural and pipe
// as flags (not both). cbT is the zero-padded [m][dpad][kpad] transposed
// codebook of the one-hot modes (dpad = dsub rounded up to 16, kpad = K to
// 64), null for take.
extern "C" int gulon_adc_probe(const void* codes, int code_bytes, const void* norms,
                               const void* q, const void* cb, const void* cbT, void* out,
                               int n_cols, int num_q, int q_stride, int depth, int m,
                               int k_codes, int dsub, int kpad, int winners, int nblk,
                               int decode, int natural, int pipe, void* stream) {
  Params P{codes, static_cast<const uint16_t*>(norms), static_cast<const uint16_t*>(cb),
           static_cast<const uint16_t*>(cbT), static_cast<float*>(out), code_bytes, n_cols,
           num_q, depth, m, k_codes, dsub, kpad, winners, nblk, 0, 0, 0};
  if (!check(P, decode) || num_q <= 0 || nblk <= 0 || (n_cols / kRows) % nblk != 0 ||
      q_stride < depth || q_stride % 8 != 0 || winners < 1 || winners > 4 ||
      (natural && pipe))
    return static_cast<int>(cudaErrorInvalidValue);
  P.nch = (depth + kChunk - 1) / kChunk;
  const int64_t cb_bytes64 = static_cast<int64_t>(m) * k_codes * dsub * 2;
  const int n_scratch = decode == kTake ? 0 : (pipe ? 1 : 2);
  // the first plan that fits: held decoded before streamed, codebooks in
  // shared memory before global (gather only), then the most ring stages
  int streamed = 0, smem = 0;
  for (int plan = 0; plan < 4 && P.nst == 0; ++plan) {
    const int held_cb = !(plan & 1);
    if (held_cb && (decode != kTake || cb_bytes64 > kSmemLimit)) continue;
    const int s_mode = plan >> 1;
    const int dec_chunks = s_mode ? (pipe ? 2 : kDecSlots) : (pipe ? 2 : 1) * P.nch;
    for (int s = kMaxStages; s >= 2; --s) {
      const int total =
          1024 + layout(dec_chunks, s, n_scratch, natural, held_cb ? int(cb_bytes64) : 0,
                        decode == kTake && !s_mode, m, P.nch)
                     .total;
      if (total <= kSmemLimit) {
        P.nst = s;
        P.cb_smem = held_cb;
        streamed = s_mode;
        smem = total;
        break;
      }
    }
  }
  if (P.nst == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = num_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const int grid = std::min(n_cols / kRows, sms);
  CUtensorMap qmap;
  if (!sw128_map(&qmap, q, 2, depth, num_q, static_cast<uint64_t>(q_stride) * 2, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (decode == kTake) return launch_decode<kTake>(natural, streamed, pipe, qmap, P, grid, smem, st);
  if (decode == kBase) return launch_decode<kBase>(natural, streamed, pipe, qmap, P, grid, smem, st);
  return launch_decode<kBf16>(natural, streamed, pipe, qmap, P, grid, smem, st);
}

// gulon_adc_probe_decode: the decoded rows [n_cols][width] bf16 (width a
// multiple of 8, at least depth) through the same decode.
extern "C" int gulon_adc_probe_decode(const void* codes, int code_bytes, const void* norms,
                                      const void* cb, const void* cbT, void* rows, int n_cols,
                                      int width, int depth, int m, int k_codes, int dsub,
                                      int kpad, int decode, void* stream) {
  Params P{codes, static_cast<const uint16_t*>(norms), static_cast<const uint16_t*>(cb),
           static_cast<const uint16_t*>(cbT), nullptr, code_bytes, n_cols, 1, depth, m,
           k_codes, dsub, kpad, 1, 1, 0, 0, 0};
  if (!check(P, decode) || width < depth || width % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  P.nch = (depth + kChunk - 1) / kChunk;
  const int smem = 1024 + kChunkBytes + 2 * probes::kScratchBytes;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = decode == kTake   ? adc_probe_decode_kernel<kTake>
                : decode == kBase ? adc_probe_decode_kernel<kBase>
                                  : adc_probe_decode_kernel<kBf16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_cols / kRows, kConsumers, smem, st>>>(P, static_cast<uint16_t*>(rows), width);
  return static_cast<int>(cudaGetLastError());
}
