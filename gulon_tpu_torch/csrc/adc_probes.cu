// Probe kernels P1 and P2 for Hopper (sm_90a): the fused ADC scan K1
// (adc_scan.cu) with its in-kernel formulation selectable, to measure what
// each stage of K1 costs on this card.
//
// Replaces the TPU probes benchmarks/adc_probes.py::_adc_fused_kernel_probe
// (P1; decode _decode_columns_probe) and ::_adc_fused_kernel_pipe (P2).
// The contract is K1's: per 128-row block and query the lane-packed
// minimum of the f32 scores over depth = m*dsub + 4 (codewords, hi/lo norm
// lanes, two ones), 1-4 winners, a NaN winning its block as the packed NaN
// of its lowest NaN row, winner w of block b in column (b / nblk) * W *
// nblk + w * nblk + b % nblk. Template parameters select:
//
// - the decode (kDec): kTake gathers codewords (K1's own decode,
//   adc_decode.cuh: the anchor, which should time with K1); kBase builds
//   the one-hot of the codes straight into the A registers of wgmma and
//   contracts it against the codebook slices held in shared memory
//   (onehot_rs.cuh), the TPU's formulation; kBf16 the same with the
//   one-hot built by compares on packed bf16 pairs (K <= 256);
// - the orientation (kNatural): queries on wgmma M and the block's rows on
//   N, as K1, or rows on M and queries on N, where a block's 128 rows span
//   8 warps and the minimum needs shuffles and shared memory (probes.cuh
//   natural_block_min) over integer keys that order as the packed floats
//   do, a NaN below every number and the lowest NaN row first;
// - the schedule (kPipe, base orientation only): two decode warpgroups
//   fill a ring of decoded 64-column chunks (mbarrier full / empty
//   phases) while the two consumer warpgroups contract the chunks already
//   there, where P1's consumers decode between their contractions.
//   setmaxnreg moves registers from the producer warpgroup to the
//   consumers and the decoders;
// - kStreamed: rows too deep to hold a decoded block beside the query ring
//   are decoded one 64-column chunk at a time for each query tile, as K1's
//   streamed mode does.
//
// The plan (decoded slots, query-ring stages, held or streamed, the
// one-hot's lanes and pieces, codebook slices resident or staged per
// chunk) comes from the Python wrapper (probes/adc_probes.py
// probe_plan); the C entry checks it and that it fits 227 KB.
//
// What bounds it: the same work as K1 (tensor cores at glove100's shape)
// plus the decode under test. The one-hot decode's tensor-core work is
// K x N x 2 operations per row and piece, 8x below the contraction's at
// glove100 (26 GFLOP, 0.027 ms); its compares are K per row and subspace
// spread over the k columns of the fragment (8 a k-step per thread).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see gulon_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "adc_decode.cuh"
#include "hopper.cuh"
#include "onehot_rs.cuh"
#include "probes.cuh"

namespace {

using namespace hopper;
using namespace adc_decode;

constexpr int kTake = 0, kBase = 1, kBf16 = 2;  // decode formulations
constexpr int kConsumers = 256;                  // two consumer warpgroups
constexpr int kDecoders = 256;                   // P2's two decode warpgroups
constexpr int kMaxStages = 6;
// P2's threads beside the consumers and decoders: a whole producer
// warpgroup (setmaxnreg works on warpgroups; ptxas sizes the launch's
// registers by warpgroups too: 640 threads at 96 each), one thread of it
// issuing the TMA loads. The split 256 x 120 + 256 x 104 + 128 x 24 =
// 60,416 of the 61,440 the block launches with: the decoders rise above
// the launch's 96 (K1's gather spills at 96; on an H100, P2 `take` at
// deep768 ran 9 % faster at 104 than at 128 / 96, the rest unchanged).
constexpr int kRegLaunch = 96, kRegConsumer = 120, kRegDecoder = 104, kRegProducer = 24;
static_assert(kRegConsumer > kRegLaunch && kRegDecoder > kRegLaunch && kRegProducer < kRegLaunch,
              "consumers and decoders setmaxnreg.inc, the producer .dec");
template <bool kPipe>
constexpr int kThreads = kConsumers + (kPipe ? kDecoders + 128 : 32);

// the plan's fields, in the order of the wrapper's array
enum {
  kPlanStreamed, kPlanStages, kPlanSlots, kPlanLanes, kPlanPieces, kPlanKc,
  kPlanResident, kPlanChunkSubs, kPlanBufs, kPlanDecWgs, kPlanCbSmem, kPlanLen
};

struct Params {
  const void* codes;       // [m, n_cols] of code_bytes each
  const uint16_t* norms;   // [2, n_cols] bf16 hi/lo
  const uint16_t* cb;      // [m, K, dsub] bf16 (gather)
  const uint16_t* cbs;     // [m, pieces, kc, lanes, 64] bf16 slices (one-hot)
  float* out;              // [num_q, n_blocks * winners]
  int code_bytes, n_cols, num_q, depth, m, k_codes, dsub, winners, nblk, nch;
  int streamed, nst, slots, lanes, pieces, kc, resident, chunk_subs, bufs, dec_wgs, cb_smem;
  int slice_bytes, codes_stage;  // derived: one subspace's slices; a chunk's codes
};

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Shared-memory offsets from the 1024-byte-aligned base: decoded chunk
// slots, the query ring, the codebook slices (one-hot: all m resident, or
// `bufs` buffers of a chunk's subspaces), a chunk's codes (one-hot: `bufs`
// buffers), the gather's codebooks (when held there) and, when the block
// is held decoded by the gather, its codes, norms and column table; the
// barriers (ring full / empty, then slot full / empty); the natural
// orientation's reduction.
struct Layout {
  int ring, slices, codes, cb, tcodes, norms, tab, bars, red, total;
};

__host__ __device__ inline Layout layout(const Params& P, int dec, bool natural, bool pipe) {
  const bool onehot = dec != kTake;
  const bool take_held = dec == kTake && !P.streamed && !pipe;
  Layout L;
  L.ring = P.slots * kChunkBytes;
  L.slices = L.ring + P.nst * kChunkBytes;
  L.codes = L.slices + (onehot ? (P.resident ? P.m : P.bufs * P.chunk_subs) * P.slice_bytes : 0);
  L.cb = L.codes + (onehot ? P.bufs * P.codes_stage : 0);
  L.tcodes = L.cb + (dec == kTake && P.cb_smem ? round16(P.m * P.k_codes * P.dsub * 2) : 0);
  L.norms = L.tcodes + (take_held ? round16(P.m * kRows * 2) : 0);
  L.tab = L.norms + (take_held ? 2 * kRows * 2 : 0);
  L.bars = round16(L.tab + (take_held ? P.nch * kChunk * 8 : 0));
  L.red = round16(L.bars + (2 * P.nst + 2 * P.slots) * 8);
  L.total = L.red + (natural ? 9 * 128 * 4 : 0);
  return L;
}

// first subspace of chunk c and how many it touches (0 past m * dsub)
__host__ __device__ inline int chunk_s_lo(int c, int dsub) { return kChunk * c / dsub; }
__host__ __device__ inline int chunk_subs(int c, int m, int dsub) {
  const int md = m * dsub, c0 = kChunk * c, c1 = c0 + kChunk < md ? c0 + kChunk : md;
  return c0 >= c1 ? 0 : (c1 - 1) / dsub - c0 / dsub + 1;
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int kDec>
constexpr int kOneHotOf = kDec == kBf16 ? onehot_rs::kBf16Cmp : onehot_rs::kInt;

// The one-hot decode's staging, for a group of 256 threads (two
// warpgroups, named barrier `bar`) that decodes a sequence of items
// (block, chunk): each item's copies (the codes of the chunk's subspaces
// in the block, and their slices unless resident) go in with cp.async;
// with two buffers (bufs 2) one item ahead, into the buffer the item
// before last used, else just before the item.
struct Stager {
  uint8_t* codes;   // bufs buffers of codes_stage bytes
  uint8_t* slices;  // resident: m slices; else bufs buffers of chunk_subs slices

  __device__ void issue(const Params& P, int blk, int c, int u, int tid) const {
    const int b = u & (P.bufs - 1);
    if (u == 0 && P.resident)
      onehot_rs::stage_slices(slices, P.cbs, 0, P.m, P.slice_bytes, tid, 256);
    const int s_lo = chunk_s_lo(c, P.dsub), n_sub = chunk_subs(c, P.m, P.dsub);
    onehot_rs::stage_codes(codes + b * P.codes_stage, P.codes, P.code_bytes,
                           static_cast<int64_t>(blk) * kRows, P.n_cols, s_lo, n_sub, tid, 256);
    if (!P.resident)
      onehot_rs::stage_slices(slices + b * P.chunk_subs * P.slice_bytes, P.cbs, s_lo, n_sub,
                              P.slice_bytes, tid, 256);
    onehot_rs::cp_async_commit();
  }

  // item u (block blk, chunk c) is in shared memory and every thread of
  // the group is done with item u - 1; item u + 1 (next_blk, next_c; u + 1
  // < n) is on its way when there are two buffers
  __device__ void acquire(const Params& P, int blk, int c, int u, int n, int next_blk,
                          int next_c, int bar, int tid) const {
    if (P.bufs == 1) {
      bar_sync(bar, 256);
      issue(P, blk, c, u, tid);
    } else if (u == 0) {
      issue(P, blk, c, u, tid);
    }
    onehot_rs::cp_async_wait_all();
    fence_proxy_async();
    bar_sync(bar, 256);
    if (P.bufs == 2 && u + 1 < n) issue(P, next_blk, next_c, u + 1, tid);
  }

  // decode item u (block blk, chunk c) into the chunk tile dst: warpgroup
  // w of the group rows 64 w .. 64 w + 63, then its columns past m * dsub
  template <int kDec>
  __device__ void decode(uint8_t* dst, const Params& P, int blk, int c, int u, int tid) const {
    const int w = tid >> 7, t = tid & 127, b = u & (P.bufs - 1);
    const uint8_t* sl =
        P.resident ? slices : slices + b * P.chunk_subs * P.slice_bytes;
    onehot_rs::decode_rows<kOneHotOf<kDec>>(
        dst, c, 64 * w, codes + b * P.codes_stage, P.code_bytes, P.k_codes, sl,
        P.resident ? 0 : chunk_s_lo(c, P.dsub), P.slice_bytes, P.lanes, P.pieces, P.kc, P.m,
        P.dsub, t);
    probes::extra_columns(dst, kChunk * c, kChunk * c, kChunk * (c + 1), 64 * w,
                          static_cast<int64_t>(blk) * kRows, P.norms, P.n_cols, P.m * P.dsub,
                          true, t);
  }
};

// K1's gather decode of a held row block: every column, by the 256
// consumers (named barrier 1), codes and norms staged in shared memory.
// Starts with a barrier, so the staging and the tile may be reused block
// after block.
__device__ __forceinline__ void take_held(uint8_t* dst, int64_t row0, const Params& P,
                                          const int2* tab, int16_t* codes_s, uint16_t* norms_s,
                                          const uint16_t* cb_s, int tid) {
  bar_sync(1, kConsumers);
  stage_block<kConsumers>(codes_s, norms_s, P.codes, P.code_bytes, P.norms, row0, P.n_cols,
                          P.m, P.k_codes, tid);
  bar_sync(1, kConsumers);
  decode_block<kConsumers>(dst, P.nch, tab, codes_s, norms_s, P.cb, cb_s, P.cb_smem, P.dsub,
                           tid);
}

template <int kDec, bool kNatural, bool kStreamed, bool kPipe>
__global__ void __launch_bounds__(kThreads<kPipe>, 1)
    adc_probe_kernel(const __grid_constant__ CUtensorMap qmap,  // queries [num_q][depth] bf16
                     const __grid_constant__ Params P) {
  static_assert(!(kPipe && kNatural), "the piped schedule runs the base orientation");
  constexpr bool kOneHot = kDec != kTake;
  constexpr bool kTakeHeld = kDec == kTake && !kStreamed && !kPipe;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nch = P.nch, nst = P.nst, S = P.slots;
  const int cb_len = P.m * P.k_codes * P.dsub;
  const Layout L = layout(P, kDec, kNatural, kPipe);
  uint8_t* dec = smem;
  uint8_t* ring = smem + L.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + nst;
  uint64_t* dfull = empty + nst;  // decoded slots (piped)
  uint64_t* dempty = dfull + S;
  int* red = reinterpret_cast<int*>(smem + L.red);
  uint16_t* cb_s = reinterpret_cast<uint16_t*>(smem + L.cb);
  int16_t* codes_s = reinterpret_cast<int16_t*>(smem + L.tcodes);
  uint16_t* norms_s = reinterpret_cast<uint16_t*>(smem + L.norms);
  int2* tab = reinterpret_cast<int2*>(smem + L.tab);
  Stager stager;
  stager.codes = smem + L.codes;
  stager.slices = smem + L.slices;

  const int n_blocks = P.n_cols / kRows;
  const int b0 = static_cast<int>(static_cast<int64_t>(n_blocks) * blockIdx.x / gridDim.x);
  const int b1 = static_cast<int>(static_cast<int64_t>(n_blocks) * (blockIdx.x + 1) / gridDim.x);
  if (b0 >= b1) return;
  const int n_qt = (P.num_q + kRows - 1) / kRows;
  // decode items (block, chunk) in the order the consumers take them
  const int per_blk = kStreamed ? n_qt * nch : nch;
  const int n_items = (b1 - b0) * per_blk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&dfull[s], kDecoders);
      mbar_init(&dempty[s], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == (kConsumers + (kPipe ? kDecoders : 0)) / 128) {  // producer: the query chunks
    if (kPipe) regs_dec<kRegProducer>();
    if (tid == kConsumers + (kPipe ? kDecoders : 0)) {
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
  } else if (kPipe && wg >= 2) {  // P2's decoders: every item, into the slot ring
    regs_inc<kRegDecoder>();
    const int dtid = tid - kConsumers;
    if (kDec == kTake && P.cb_smem) {
      const int n16 = cb_len / 8;
      for (int i = dtid; i < n16; i += kDecoders)
        reinterpret_cast<uint4*>(cb_s)[i] = __ldg(reinterpret_cast<const uint4*>(P.cb) + i);
      for (int i = n16 * 8 + dtid; i < cb_len; i += kDecoders) cb_s[i] = __ldg(P.cb + i);
      bar_sync(2, kDecoders);
    }
    for (int u = 0; u < n_items; ++u) {
      const int blk = b0 + u / per_blk, c = u % nch;
      if (kOneHot)
        stager.acquire(P, blk, c, u, n_items, b0 + (u + 1) / per_blk, (u + 1) % nch, 2, dtid);
      const int slot = u % S;
      mbar_wait(&dempty[slot], ((u / S) & 1) ^ 1);
      uint8_t* dst = dec + slot * kChunkBytes;
      if constexpr (kDec == kTake)
        decode_chunk<kDecoders>(dst, c, static_cast<int64_t>(blk) * kRows, P.codes,
                                P.code_bytes, P.norms, P.cb_smem ? cb_s : P.cb, P.n_cols, P.m,
                                P.k_codes, P.dsub, dtid);
      else
        stager.decode<kDec>(dst, P, blk, c, u, dtid);
      fence_proxy_async();
      mbar_arrive(&dfull[slot]);
    }
  } else {  // the consumers (P1: they decode too)
    if (kPipe) regs_inc<kRegConsumer>();
    if (!kPipe && kDec == kTake) {  // once per thread block: the gather's codebooks, table
      if (P.cb_smem) {
        const int n16 = cb_len / 8;
        for (int i = tid; i < n16; i += kConsumers)
          reinterpret_cast<uint4*>(cb_s)[i] = __ldg(reinterpret_cast<const uint4*>(P.cb) + i);
        for (int i = n16 * 8 + tid; i < cb_len; i += kConsumers) cb_s[i] = __ldg(P.cb + i);
      }
      if (kTakeHeld) column_table<kConsumers>(tab, nch, P.m, P.k_codes, P.dsub, tid);
      bar_sync(1, kConsumers);
    }

    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int n_win = n_blocks * P.winners;
    float acc[64];
    int it = 0;
    int u = 0;  // decode items taken
    for (int blk = b0; blk < b1; ++blk) {
      const int64_t row0 = static_cast<int64_t>(blk) * kRows;
      const int u_blk = u;  // the block's first item (held)
      if (!kStreamed) {
        if (kPipe) {
          for (int c = 0; c < nch; ++c)
            mbar_wait(&dfull[(u_blk + c) % S], ((u_blk + c) / S) & 1);
          u += nch;
        } else if constexpr (kDec == kTake) {
          take_held(dec, row0, P, tab, codes_s, norms_s, cb_s, tid);
          fence_proxy_async();
          bar_sync(1, kConsumers);
        } else {
          for (int c = 0; c < nch; ++c, ++u) {
            stager.acquire(P, blk, c, u, n_items, b0 + (u + 1) / per_blk, (u + 1) % nch, 1,
                           tid);
            stager.decode<kDec>(dec + c * kChunkBytes, P, blk, c, u, tid);
          }
          fence_proxy_async();
          bar_sync(1, kConsumers);
        }
      }

      const int col0 = (blk / P.nblk) * P.winners * P.nblk + (blk % P.nblk);
      for (int qt = 0; qt < n_qt; ++qt) {
        // chunk c's wgmma group is issued before chunk c-1's stage (and,
        // streamed and piped, its decoded slot) is freed; chunk 0
        // overwrites the accumulators
        auto mma_chunk = [&](int c) {
          uint8_t* b;
          if (!kStreamed) {
            b = dec + (kPipe ? (u_blk + c) % S : c) * kChunkBytes;
          } else if (kPipe) {
            mbar_wait(&dfull[u % S], (u / S) & 1);
            b = dec + (u % S) * kChunkBytes;
          } else {
            b = dec + (u % S) * kChunkBytes;
            if constexpr (kDec == kTake) {
              decode_chunk<kConsumers>(b, c, row0, P.codes, P.code_bytes, P.norms,
                                       P.cb_smem ? cb_s : P.cb, P.n_cols, P.m, P.k_codes,
                                       P.dsub, tid);
            } else {
              stager.acquire(P, blk, c, u, n_items, b0 + (u + 1) / per_blk, (u + 1) % nch,
                             1, tid);
              stager.decode<kDec>(b, P, blk, c, u, tid);
            }
            fence_proxy_async();
            bar_sync(1, kConsumers);
          }
          if (kStreamed) ++u;
          const int st = it % nst;
          mbar_wait(&full[st], (it / nst) & 1);
          uint8_t* q_tile = ring + st * kChunkBytes;
          const uint64_t desc_a =
              sw128_desc(kNatural ? b + wg * 64 * 128 : q_tile + wg * 64 * 128);
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
          if (kStreamed && kPipe) release(&dempty[(u - 2) % S], lane);
          prev = st;
        }
        wgmma_wait<0>();
        release(&empty[prev], lane);
        if (kStreamed && kPipe) release(&dempty[(u - 1) % S], lane);
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
      if (kPipe && !kStreamed)  // the block's last groups retired above
        for (int c = 0; c < nch; ++c) release(&dempty[(u_blk + c) % S], lane);
    }
  }
}

// The decoded rows themselves: [n_cols][width] bf16 (width >= depth, zero
// past it), one block of threads per 128-row block, chunk by chunk through
// the decode under test; for holding each formulation's decode against the
// plain gather bit for bit. Shared memory: the chunk tile, then (one-hot)
// the slices and the codes as P1 lays them out.
template <int kDec>
__global__ void __launch_bounds__(kConsumers, 1)
    adc_probe_decode_kernel(const __grid_constant__ Params P, uint16_t* __restrict__ rows,
                            int width) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* tile = smem;
  Stager stager;
  stager.slices = smem + kChunkBytes;
  stager.codes = stager.slices + (P.resident ? P.m : P.bufs * P.chunk_subs) * P.slice_bytes;
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(blk) * kRows;
  const int n_c = (width + kChunk - 1) / kChunk;
  for (int c = 0; c < n_c; ++c) {
    if constexpr (kDec == kTake) {
      bar_sync(1, kConsumers);  // the last chunk's copy-out is done
      decode_chunk<kConsumers>(tile, c, row0, P.codes, P.code_bytes, P.norms, P.cb, P.n_cols,
                               P.m, P.k_codes, P.dsub, tid);
    } else {
      stager.acquire(P, blk, c, c, n_c, blk, c + 1, 1, tid);  // and the copy-out is done
      stager.decode<kDec>(tile, P, blk, c, c, tid);
    }
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
  if (kPipe) {  // setmaxnreg.inc waits forever for registers the block was not given
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs * kThreads<kPipe> <
        kConsumers * kRegConsumer + kDecoders * kRegDecoder + 128 * kRegProducer)
      return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  kernel<<<grid, kThreads<kPipe>, smem, stream>>>(qmap, P);
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
  return P.n_cols > 0 && P.n_cols % kRows == 0 && P.m > 0 && P.dsub > 0 &&
         P.depth == P.m * P.dsub + 4 && P.k_codes >= 1 && P.k_codes <= 1024 &&
         cb_len <= 0x7FFFFFFF && decode >= kTake && decode <= kBf16 &&
         (decode != kBf16 || P.k_codes <= 256) &&
         (decode == kTake || P.cbs != nullptr) &&
         (P.code_bytes == 1 || P.code_bytes == 2 || P.code_bytes == 4);
}

// Reads the plan into P and checks it: what the launch would index out of
// bounds with, and that its layout fits. Returns the dynamic shared memory
// (0 = refused). decode_only: the decoded-rows kernel's layout.
int read_plan(Params& P, const int* plan, int decode, int natural, int pipe, bool decode_only) {
  P.nch = (P.depth + kChunk - 1) / kChunk;
  P.streamed = plan[kPlanStreamed];
  P.nst = plan[kPlanStages];
  P.slots = plan[kPlanSlots];
  P.lanes = plan[kPlanLanes];
  P.pieces = plan[kPlanPieces];
  P.kc = plan[kPlanKc];
  P.resident = plan[kPlanResident];
  P.chunk_subs = plan[kPlanChunkSubs];
  P.bufs = plan[kPlanBufs];
  P.dec_wgs = plan[kPlanDecWgs];
  P.cb_smem = plan[kPlanCbSmem];
  P.slice_bytes = P.pieces * P.kc * P.lanes * 128;
  P.codes_stage = round16(P.chunk_subs * kRows * P.code_bytes);
  if (decode != kTake) {
    int most = 0;
    for (int c = 0; c < P.nch; ++c) most = std::max(most, chunk_subs(c, P.m, P.dsub));
    const bool lanes_ok = P.lanes == 8 || P.lanes == 16 || P.lanes == 24 || P.lanes == 32;
    if (!lanes_ok || P.pieces < 1 || P.pieces * P.lanes < P.dsub || P.kc < 1 ||
        64 * P.kc < P.k_codes || P.chunk_subs < most || (P.bufs != 1 && P.bufs != 2))
      return 0;
  }
  if (decode_only) {
    const int64_t total =
        1024 + kChunkBytes +
        (decode == kTake ? 0
                         : static_cast<int64_t>(P.resident ? P.m : P.bufs * P.chunk_subs) *
                                   P.slice_bytes +
                               P.bufs * P.codes_stage);
    return total <= kSmemLimit ? static_cast<int>(total) : 0;
  }
  const int min_slots = P.streamed ? (pipe ? 2 : (decode == kTake ? 3 : 2)) : P.nch;
  if (P.nst < 2 || P.nst > kMaxStages || P.slots < min_slots ||
      (!pipe && P.slots != min_slots) || (pipe && P.dec_wgs != kDecoders / 128) ||
      (P.cb_smem && (decode != kTake || P.m * P.k_codes * P.dsub * 2 > kSmemLimit)))
    return 0;
  const int64_t total = 1024 + static_cast<int64_t>(layout(P, decode, natural, pipe).total);
  return total <= kSmemLimit ? static_cast<int>(total) : 0;
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t (0 =
// launched). Shapes and alignment are checked by the Python wrapper; this
// re-checks what would make a launch read or write out of bounds.
//
// gulon_adc_probe: the scan. decode 0 = take (gather), 1 = base (one-hot,
// int compare), 2 = bf16cmp (one-hot, bf16 pair compare); natural and pipe
// as flags (not both). cbs is the codebook slices of the one-hot modes
// ([m][pieces][kc][lanes][64] bf16, zero padded), null for take; plan the
// kPlanLen ints of probe_plan.
extern "C" int gulon_adc_probe(const void* codes, int code_bytes, const void* norms,
                               const void* q, const void* cb, const void* cbs, void* out,
                               int n_cols, int num_q, int q_stride, int depth, int m,
                               int k_codes, int dsub, int winners, int nblk, int decode,
                               int natural, int pipe, const int* plan, void* stream) {
  Params P{};
  P.codes = codes;
  P.norms = static_cast<const uint16_t*>(norms);
  P.cb = static_cast<const uint16_t*>(cb);
  P.cbs = static_cast<const uint16_t*>(cbs);
  P.out = static_cast<float*>(out);
  P.code_bytes = code_bytes;
  P.n_cols = n_cols;
  P.num_q = num_q;
  P.depth = depth;
  P.m = m;
  P.k_codes = k_codes;
  P.dsub = dsub;
  P.winners = winners;
  P.nblk = nblk;
  if (!check(P, decode) || num_q <= 0 || nblk <= 0 || (n_cols / kRows) % nblk != 0 ||
      q_stride < depth || q_stride % 8 != 0 || winners < 1 || winners > 4 ||
      (natural && pipe) || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = read_plan(P, plan, decode, natural, pipe, false);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = num_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const int grid = std::min(n_cols / kRows, sms);
  CUtensorMap qmap;
  if (!sw128_map(&qmap, q, 2, depth, num_q, static_cast<uint64_t>(q_stride) * 2, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int streamed = P.streamed;
  if (decode == kTake) return launch_decode<kTake>(natural, streamed, pipe, qmap, P, grid, smem, st);
  if (decode == kBase) return launch_decode<kBase>(natural, streamed, pipe, qmap, P, grid, smem, st);
  return launch_decode<kBf16>(natural, streamed, pipe, qmap, P, grid, smem, st);
}

// gulon_adc_probe_decode: the decoded rows [n_cols][width] bf16 (width a
// multiple of 8, at least depth) through the same decode; plan as above
// (its slice fields only).
extern "C" int gulon_adc_probe_decode(const void* codes, int code_bytes, const void* norms,
                                      const void* cb, const void* cbs, void* rows, int n_cols,
                                      int width, int depth, int m, int k_codes, int dsub,
                                      int decode, const int* plan, void* stream) {
  Params P{};
  P.codes = codes;
  P.norms = static_cast<const uint16_t*>(norms);
  P.cb = static_cast<const uint16_t*>(cb);
  P.cbs = static_cast<const uint16_t*>(cbs);
  P.code_bytes = code_bytes;
  P.n_cols = n_cols;
  P.num_q = 1;
  P.depth = depth;
  P.m = m;
  P.k_codes = k_codes;
  P.dsub = dsub;
  P.winners = 1;
  P.nblk = 1;
  if (!check(P, decode) || width < depth || width % 8 != 0 || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = read_plan(P, plan, decode, 0, 0, true);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
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
