// Probe kernel P3 for Hopper (sm_90a): the fused ADC scan K1 cut down stage
// by stage in the TPU's formulation (a one-hot decode on the tensor cores),
// to find where its time goes on this card.
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
// contraction covers the decoded codewords only (zero past m * dsub), no
// norm lanes. The decode is onehot_rs.cuh's: the one-hot of each row's
// code built in the A registers of wgmma (RS form) against the codebook
// slices in shared memory, by an int compare, nibble matches ANDed
// (":nib"), a byte-wise compare of the offset int8 codes (":cmp8"), or as
// an s8 one-hot against s8 codewords, scaled (tdec_i8); tdec_cached loads
// a decoded operand built beforehand ([N][mdp] bf16) instead.
// Orientation: "tdec" puts 64 queries on wgmma M and the block's 128 rows
// on N, as K1 does; "natural" the block's rows on M (two m64 tiles) and 64
// queries on N, the minimum over the rows across the warps of one
// warpgroup.
//
// Output, as the TPU writes it: vals [n_cols / 128][Q] f32 and ids
// [n_cols / 128][Q] int32, row r * nblk + b for row tile r (nblk = t / 128
// blocks of 128 rows) and block b: the global 128-row block, so only
// noselect depends on t, and no_select also on the TPU's query tile.
//
// What bounds it: at the headline shape (401,408 rows, m 8, K 256, dsub
// 13, mdp 128, 1024 queries) the contraction over m * dsub = 104 lanes is
// 0.086 ms on the tensor cores, the one-hot decode's tensor-core work
// 0.022 ms (K x 16 lanes x 2 a row and subspace), the bytes (int32 codes,
// f32 norms, two outputs) 0.012 ms. What held the first port (PR 10) far
// above that: a one-hot written to shared memory with nothing in flight,
// decoded by the same warpgroups that contract, between two barriers; all
// 1024 queries streamed from L2 for each 128-row block; the selection run
// with no wgmma in flight; the zero lanes past m * dsub contracted.
//
// The design, for this card:
// - warp roles, as P2: a producer warpgroup (one thread issues the query
//   chunks by TMA into a ring, mbarrier full / empty; for tdec_cached a
//   second thread loads the decoded operand's rows by TMA), kDecodeWgs
//   decode warpgroups and two consumer warpgroups; setmaxnreg moves
//   registers from the producer and the decoders to the consumers;
// - the unit of work is a pair of 128-row blocks, held decoded in a ring
//   of `slots` pair slots (mbarrier dfull / dempty), so the decode of the
//   next pair runs under the contraction of this one. A pair's four
//   64-row groups go to the decode warpgroups, each group's codes loaded
//   from global memory a subspace ahead; the codebook slices stay
//   resident in shared memory;
// - the feed: a ring stage is 64 queries x 64 lanes, and consumer
//   warpgroup w contracts block w of the pair against it, so each query
//   chunk crosses L2 once per pair (half PR 10's query traffic) with 64
//   accumulators a thread;
// - the selection: the consumers take turns at the tensor cores
//   (ping-pong, as K2: named barriers 2 and 3), so one warpgroup's
//   epilogue runs while the other's wgmma runs; the natural orientation's
//   block minimum is inside one warpgroup (its own named barrier), so it
//   fits the turns;
// - the contraction stops at ceil(m * dsub / 16) k16 steps (each its own
//   commit group, no branch inside a group); the decoded lanes from m *
//   dsub up to there are zeros, written once per slot.
//
// Measured on an H100 (scripts/p3_ab.py and its ablations, at commit
// 772d785): the query feed is not what bounds the contraction path (a
// ring never refilled saves ~2 %);
// the selection epilogue is: without it tdec_cached runs at K2's time, and
// with it the epilogue of one warpgroup outlasts the other's wgmma.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see gulon_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "hopper.cuh"
#include "onehot_rs.cuh"
#include "probes.cuh"

namespace {

using namespace hopper;

constexpr int kNoop = 0, kGrid = 1, kNoSelect = 2, kMin = 3, kMatch = 4, kPacked = 5;
constexpr int kCached = 5;  // a decoded operand loaded, not decoded (beside onehot_rs::kInt ..)
// Two decode warpgroups: with four (896 threads) the launch gives each
// thread 72 registers, and ptxas refuses the kernel ("Insufficient
// registers (72) to compile instruction", C7602, asking for 90 or more);
// the two-warpgroup build's decode region uses 90 (R0-R89 in its SASS).
constexpr int kDecodeWgs = 2;
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kDecoders = 128 * kDecodeWgs;
constexpr int kThreads = kConsumers + kDecoders + 128;  // and a producer warpgroup
// Registers: the launch gives every thread kRegLaunch = 96 (ptxas sizes a
// launch by whole warpgroups); setmaxnreg then splits the block's
// registers as P2 does: 256 x 120 + 256 x 104 + 128 x 24 = 60,416 of
// 640 x 96.
constexpr int kRegLaunch = (65536 / kThreads) & ~7;
constexpr int kRegConsumer = 120;
constexpr int kRegDecoder = 104;
constexpr int kRegProducer = 24;
static_assert(kConsumers * kRegConsumer + kDecoders * kRegDecoder + 128 * kRegProducer <=
                  kRegLaunch * kThreads,
              "the split fits the registers the block launches with");
constexpr int kLanes = 16;                  // the one-hot's wgmma N: pieces of 16 lanes
constexpr int kDecodeSteps = 8;             // k-steps of a decode commit group
constexpr int kQRows = 64;                  // queries of a ring stage
constexpr int kStageBytes = kQRows * 128;   // [64 queries][64 lanes] bf16
constexpr int kMaxStages = 8;
constexpr int kNoRow = 1 << 30;             // no row matched (the plain version's _INT_BIG)
// named barriers: 1 the decoders, 2 + w consumer w's turn, 4 + w its own
constexpr int kBarDecoders = 1, kBarTurn = 2, kBarWg = 4;

struct Params {
  const void* codes;      // [m, n_cols]: int32, or offset int8 (cmp8)
  const float* norms;     // [n_cols] f32
  const uint8_t* slices;  // [m][pieces][kc][16][C] one-hot slices: bf16 (C 64) or s8 (C 128)
  const float* scale;     // [m] (tdec_i8)
  float* vals;            // [n_cols / 128, num_q]
  int* ids;               // [n_cols / 128, num_q]
  int code_bytes, n_cols, num_q, m, k_codes, dsub, nblk, qt_tpu, pieces;
  int kc, slice_bytes;    // C-code chunks of K a piece (even), one subspace's slices
  int nch, ksteps;        // 64-lane chunks and k16 steps contracted
  int nst, slots;         // ring stages, decoded pair slots
};

// Shared-memory offsets from the 1024-byte-aligned base: the decoded pair
// slots ([2 blocks][nch chunks][128 rows][128 bytes] each), the query ring,
// the resident slices, each consumer's 128 norms, the natural orientation's
// reduction ([2 warpgroups][4 warps + 1][64] keys), the barriers.
struct Layout {
  int pair, ring, slices, norms, red, bars, total;
};

__host__ __device__ inline Layout layout(const Params& P, bool decodes, bool natural) {
  Layout L;
  L.pair = 2 * P.nch * kChunkBytes;
  L.ring = P.slots * L.pair;
  L.slices = L.ring + P.nst * kStageBytes;
  L.norms = L.slices + (decodes ? P.m * P.slice_bytes : 0);
  L.red = L.norms + 2 * kRows * 4;
  L.bars = L.red + (natural ? 2 * 5 * kQRows * 4 : 0);
  L.total = L.bars + (2 * P.nst + 2 * P.slots) * 8;
  return L;
}

template <int R>
__device__ __forceinline__ void set_regs() {
  if constexpr (R > kRegLaunch)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
  else if constexpr (R < kRegLaunch)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ float from_key(int k) { return __int_as_float(probes::mono(k)); }

// d (+)= A[64 x 16] . B[64 x 16]^T, both from shared memory (K-major,
// 128-byte swizzle), f32 accumulators: d[4j + 2i + h] is row 16 warp +
// lane / 4 + 8 i and column 8 j + 2 (lane % 4) + h (j < 8)
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// A decode warpgroup's codes: code_at(s, r) of subspace s at row r of the
// block at row0, from global memory; -1 past the last row (the missing
// second block of an odd count) or outside [0, K). cmp8's offset int8
// codes are all in [0, 256): one at or past K meets a zero slice column.
template <int kImpl>
struct GlobalCodes {
  const void* codes;
  int64_t row0;
  int n_cols, k_codes;
  __device__ __forceinline__ int operator()(int s, int r) const {
    const int64_t row = row0 + r;
    if (row >= n_cols) return -1;
    const int64_t i = static_cast<int64_t>(s) * n_cols + row;
    if (kImpl == onehot_rs::kCmp8)
      return static_cast<int>(__ldg(static_cast<const signed char*>(codes) + i)) + 128;
    const int c = __ldg(static_cast<const int*>(codes) + i);
    return (c >= 0 && c < k_codes) ? c : -1;
  }
};

template <int kStage, int kImpl, bool kNatural>
__global__ void __launch_bounds__(kThreads, 1)
    kernel_probe(const __grid_constant__ CUtensorMap qmap,  // queries [num_q][mdp], boxes [64][64]
                 const __grid_constant__ CUtensorMap cmap,  // cached rows [n_cols][mdp], [128][64]
                 const __grid_constant__ Params P) {
  constexpr bool kHolds = kStage != kNoop;  // pairs pass to the consumers
  constexpr bool kDecodes = kHolds && kImpl != kCached;
  constexpr bool kScores = kStage >= kNoSelect;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = layout(P, kDecodes, kNatural);
  uint8_t* slots = smem;
  uint8_t* ring = smem + L.ring;
  uint8_t* slices = smem + L.slices;
  float* norms_s = reinterpret_cast<float*>(smem + L.norms);
  int* red = reinterpret_cast<int*>(smem + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + P.nst;
  uint64_t* dfull = empty + P.nst;
  uint64_t* dempty = dfull + P.slots;

  const int n_blocks = P.n_cols / kRows;
  const int n_pairs = (n_blocks + 1) / 2;
  const int p0 = static_cast<int>(static_cast<int64_t>(n_pairs) * blockIdx.x / gridDim.x);
  const int p1 = static_cast<int>(static_cast<int64_t>(n_pairs) * (blockIdx.x + 1) / gridDim.x);
  if (p0 >= p1) return;
  const int n_items = p1 - p0;
  const int n_qt = (P.num_q + kQRows - 1) / kQRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < P.nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int s = 0; s < P.slots; ++s) {
      mbar_init(&dfull[s], kDecodes ? kDecoders : 1);
      mbar_init(&dempty[s], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2 + kDecodeWgs) {  // the producer warpgroup
    set_regs<kRegProducer>();
    const int pw = (tid >> 5) & 3;
    if (kScores && pw == 0 && lane == 0) {  // the query chunks, for every pair
      int it = 0;
      for (int u = 0; u < n_items; ++u)
        for (int qt = 0; qt < n_qt; ++qt)
          for (int c = 0; c < P.nch; ++c, ++it) {
            const int st = it % P.nst;
            mbar_wait(&empty[st], ((it / P.nst) & 1) ^ 1);
            mbar_expect_tx(&full[st], kStageBytes);
            tma_load_2d(ring + st * kStageBytes, &qmap, &full[st], c * kChunk, qt * kQRows);
          }
    }
    if (kImpl == kCached && kHolds && pw == 1 && lane == 0) {  // the decoded operand's rows
      for (int u = 0; u < n_items; ++u) {
        const int slot = u % P.slots, blk0 = 2 * (p0 + u);
        const int nb = min(2, n_blocks - blk0);
        mbar_wait(&dempty[slot], ((u / P.slots) & 1) ^ 1);
        mbar_expect_tx(&dfull[slot], nb * P.nch * kChunkBytes);
        for (int b = 0; b < nb; ++b)
          for (int c = 0; c < P.nch; ++c)
            tma_load_2d(slots + slot * L.pair + (b * P.nch + c) * kChunkBytes, &cmap,
                        &dfull[slot], c * kChunk, (blk0 + b) * kRows);
      }
    }
    return;
  }

  if (wg >= 2) {  // the decode warpgroups
    set_regs<kRegDecoder>();
    if constexpr (kDecodes) {
      const int dt = tid - kConsumers, dw = dt >> 7, t = dt & 127;
      const int md = P.m * P.dsub, zw = 16 * P.ksteps - md;
      onehot_rs::stage_slices(slices, reinterpret_cast<const uint16_t*>(P.slices), 0, P.m,
                              P.slice_bytes, dt, kDecoders);
      onehot_rs::cp_async_commit();
      // lanes [m dsub, 16 ksteps) of every slot: zeros, once
      for (int e = dt; e < P.slots * 2 * kRows * zw; e += kDecoders) {
        const int r = e / zw, col = md + (e - r * zw);  // r: row of all the slots' blocks
        *probes::tile_elem(slots + (r / kRows) * P.nch * kChunkBytes, r % kRows, col) = 0;
      }
      onehot_rs::cp_async_wait_all();
      fence_proxy_async();
      bar_sync(kBarDecoders, kDecoders);
      for (int u = 0; u < n_items; ++u) {
        const int slot = u % P.slots;
        mbar_wait(&dempty[slot], ((u / P.slots) & 1) ^ 1);
        for (int grp = dw; grp < 4; grp += kDecodeWgs) {  // 64-row group grp of the pair
          const int b = grp >> 1;
          const GlobalCodes<kImpl> code_at{
              P.codes, static_cast<int64_t>(2 * (p0 + u) + b) * kRows, P.n_cols, P.k_codes};
          onehot_rs::decode_span<kImpl, kLanes, kDecodeSteps>(
              slots + slot * L.pair + b * P.nch * kChunkBytes, 0, 0, md, 64 * (grp & 1),
              code_at, slices, 0, P.slice_bytes, P.pieces, P.kc, P.dsub, P.scale, t);
        }
        fence_proxy_async();
        mbar_arrive(&dfull[slot]);
      }
    }
    return;
  }

  // the consumers: warpgroup w takes block w of each pair
  set_regs<kRegConsumer>();
  const int w = wg, t = tid & 127, warp = t >> 5, g = lane >> 2, tq = lane & 3;
  const int num_q = P.num_q;
  if constexpr (!kHolds) {  // noop
    for (int blk = 2 * p0 + w; blk < min(2 * p1, n_blocks); blk += 2)
      for (int q = t; q < num_q; q += 128) {
        P.vals[static_cast<int64_t>(blk) * num_q + q] = 0.f;
        P.ids[static_cast<int64_t>(blk) * num_q + q] = 0;
      }
    return;
  } else {
    float* nrm = norms_s + kRows * w;
    int* rw = red + 5 * kQRows * w;  // natural: [4 warps][64] partial minima, then [64]
    float acc[64];
    int it = 0, turn = 0;
    const int n_turns = n_items * n_qt;
    for (int u = 0; u < n_items; ++u) {
      const int slot = u % P.slots, blk = 2 * (p0 + u) + w;
      const bool real = blk < n_blocks;  // the same in the whole warpgroup
      float* vals = P.vals + static_cast<int64_t>(blk) * num_q;
      int* ids = P.ids + static_cast<int64_t>(blk) * num_q;
      if (kScores) {
        bar_sync(kBarWg + w, 128);  // the last pair's reads of nrm are done
        nrm[t] = real ? __ldg(P.norms + static_cast<int64_t>(blk) * kRows + t) : 0.f;
        bar_sync(kBarWg + w, 128);
      }
      mbar_wait(&dfull[slot], (u / P.slots) & 1);
      if constexpr (kStage == kGrid) {  // the decode ran in full: zeros
        if (real)
          for (int q = t; q < num_q; q += 128) {
            vals[q] = 0.f;
            ids[q] = 0;
          }
        release(&dempty[slot], lane);
        continue;
      } else {
        const uint8_t* tile = slots + slot * L.pair + w * P.nch * kChunkBytes;
        for (int qt = 0; qt < n_qt; ++qt, ++turn) {
          // ping-pong: warpgroup w waits at barrier 2 + w for its turn and
          // hands it on at 3 - w once its groups are issued; warpgroup 0
          // starts, and warpgroup 1 hands on no turn after its last
          if (w == 1 || turn > 0) bar_sync(kBarTurn + w, kConsumers);
          // k-step kk of chunk c against ring stage st: one commit group
          auto mma_step = [&](int st, int c, int kk) {
            const uint8_t* q_tile = ring + st * kStageBytes;
            const uint8_t* d_tile = tile + c * kChunkBytes;
            wgmma_fence();
            if constexpr (kNatural) {
              const uint64_t db = sw128_desc(q_tile) + 2 * kk;
              wgmma_m64n64k16(acc, sw128_desc(d_tile) + 2 * kk, db, (c | kk) != 0);
              wgmma_m64n64k16(acc + 32, sw128_desc(d_tile + 64 * 128) + 2 * kk, db,
                              (c | kk) != 0);
            } else {
              wgmma_m64n128k16(acc, sw128_desc(q_tile) + 2 * kk, sw128_desc(d_tile) + 2 * kk,
                               (c | kk) != 0);
            }
            wgmma_commit();
          };
          int prev = 0;
          for (int c = 0; c < P.nch; ++c) {
            const int st = it % P.nst;
            mbar_wait(&full[st], (it / P.nst) & 1);
            ++it;
            mma_step(st, c, 0);
            if (c > 0) {  // chunk c - 1's groups retired: free its stage
              wgmma_wait<1>();
              release(&empty[prev], lane);
            }
            for (int kk = 1; kk < min(4, P.ksteps - 4 * c); ++kk) mma_step(st, c, kk);
            prev = st;
          }
          if (w == 0 || turn + 1 < n_turns) bar_arrive(kBarTurn + 1 - w, kConsumers);
          wgmma_wait<0>();
          release(&empty[prev], lane);
          fence_regs(acc);
          if (!real) continue;

          if constexpr (!kNatural) {
            // scores = norms - 2 ipt (2 ipt is exact: one rounding, as the TPU's)
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[4 * j + c] = fmaf(-2.f, acc[4 * j + c], nrm[acc_row(j, c & 1, lane)]);
            const int q = qt * kQRows + 16 * warp + g;  // and q + 8
            if (kStage == kNoSelect) {
              if (blk % P.nblk == 0)
#pragma unroll
                for (int j = 0; j < 16; ++j)
#pragma unroll
                  for (int c = 0; c < 4; ++c) {
                    const int row = acc_row(j, c & 1, lane), qq = q + 8 * (c >> 1);
                    if (row < P.nblk && qq < num_q)
                      vals[static_cast<int64_t>(row) * num_q + qq] = acc[4 * j + c];
                  }
              if (tq == 0) {
                if (q < num_q) ids[q] = 0;
                if (q + 8 < num_q) ids[q + 8] = 0;
              }
              continue;
            }
            float v0, v1;
            int r0 = 0, r1 = 0;
            if (kStage == kPacked) {
              int key[64];
#pragma unroll
              for (int e = 0; e < 64; ++e) key[e] = probes::mono(__float_as_int(acc[e]));
              pack_rows(key, lane);
              r0 = block_min<0>(key, lane);
              r1 = block_min<1>(key, lane);
              v0 = from_key(r0);
              v1 = from_key(r1);
              r0 &= 127;
              r1 &= 127;
            } else {
              v0 = block_min<0>(acc, lane);
              v1 = block_min<1>(acc, lane);
              if (kStage == kMatch) {  // the lowest row equal to the minimum, by a tree
                int cand[64];
#pragma unroll
                for (int j = 0; j < 16; ++j)
#pragma unroll
                  for (int c = 0; c < 4; ++c)
                    cand[4 * j + c] =
                        acc[4 * j + c] == (c < 2 ? v0 : v1) ? acc_row(j, c & 1, lane) : kNoRow;
                r0 = block_min<0>(cand, lane);
                r1 = block_min<1>(cand, lane);
              }
            }
            if (tq < 2 && q + 8 * tq < num_q) {
              vals[q + 8 * tq] = tq ? v1 : v0;
              ids[q + 8 * tq] = kStage == kMin ? 0 : blk * kRows + (tq ? r1 : r0);
            }
            continue;
          } else {
            // natural: acc[32 mt + 4 j + 2 i + h] is block row 64 mt + 16
            // warp + g + 8 i and query 8 j + 2 tq + h of the stage's 64
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const float nr = nrm[64 * mt + 16 * warp + g + 8 * i];
#pragma unroll
                for (int j = 0; j < 8; ++j)
#pragma unroll
                  for (int h = 0; h < 2; ++h) {
                    float& x = acc[32 * mt + 4 * j + 2 * i + h];
                    x = fmaf(-2.f, x, nr);
                  }
              }
            if (kStage == kNoSelect) {  // the tile's scores[0, 0] over its (r, q) tile
              const int q0 = qt * kQRows;
              if (blk % P.nblk == 0 && q0 % P.qt_tpu == 0) {
                float* red_f = reinterpret_cast<float*>(rw);
                if (t == 0) red_f[0] = acc[0];  // row 0, query 0
                bar_sync(kBarWg + w, 128);
                const float x = red_f[0];
                const int width = min(P.qt_tpu, num_q - q0);
                for (int e = t; e < P.nblk * width; e += 128) {
                  const int rr = e / width, c = e - rr * width;
                  vals[static_cast<int64_t>(rr) * num_q + q0 + c] = x;
                }
                bar_sync(kBarWg + w, 128);
              }
              if (t < kQRows && q0 + t < num_q) ids[q0 + t] = 0;
              continue;
            }
            // the minimum over the block's rows of key_of(mt, j, i, h), for
            // each query of the stage, into rw[256 + query]: over mt and i
            // in registers, over g by shuffles, over the four warps through
            // shared memory
            auto reduce = [&](auto key_of) {
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  int v = min(min(key_of(0, j, 0, h), key_of(0, j, 1, h)),
                              min(key_of(1, j, 0, h), key_of(1, j, 1, h)));
                  v = min(v, __shfl_xor_sync(0xffffffffu, v, 4));
                  v = min(v, __shfl_xor_sync(0xffffffffu, v, 8));
                  v = min(v, __shfl_xor_sync(0xffffffffu, v, 16));
                  if (g == 0) rw[warp * kQRows + 8 * j + 2 * tq + h] = v;
                }
              bar_sync(kBarWg + w, 128);
              if (t < kQRows)
                rw[4 * kQRows + t] = min(min(rw[t], rw[kQRows + t]),
                                         min(rw[2 * kQRows + t], rw[3 * kQRows + t]));
              bar_sync(kBarWg + w, 128);
            };
            auto row_of = [&](int mt, int i) { return 64 * mt + 16 * warp + g + 8 * i; };
            if (kStage == kPacked) {
              reduce([&](int mt, int j, int i, int h) {
                return (probes::mono(__float_as_int(acc[32 * mt + 4 * j + 2 * i + h])) & ~127) |
                       row_of(mt, i);
              });
            } else {  // a NaN wins (jnp.min)
              reduce([&](int mt, int j, int i, int h) {
                const float x = acc[32 * mt + 4 * j + 2 * i + h];
                return x != x ? INT_MIN : probes::mono(__float_as_int(x));
              });
            }
            const int key = t < kQRows ? rw[4 * kQRows + t] : 0;
            int row = 0;
            if (kStage == kMatch) {  // the lowest row at or below the minimum
              reduce([&](int mt, int j, int i, int h) {
                const int k = rw[4 * kQRows + 8 * j + 2 * tq + h];
                const float vm = k == INT_MIN ? __int_as_float(0x7FC00000) : from_key(k);
                return acc[32 * mt + 4 * j + 2 * i + h] <= vm ? row_of(mt, i) : kNoRow;
              });
              row = t < kQRows ? rw[4 * kQRows + t] : 0;
            }
            const int q = qt * kQRows + t;
            if (t < kQRows && q < num_q) {
              if (kStage == kPacked) {
                vals[q] = from_key(key);
                ids[q] = blk * kRows + (key & 127);
              } else {
                vals[q] = key == INT_MIN ? __int_as_float(0x7FC00000) : from_key(key);
                ids[q] = kStage == kMin ? 0 : blk * kRows + row;
              }
            }
          }
        }
        release(&dempty[slot], lane);
      }
    }
  }
}

template <int kStage, int kImpl, bool kNatural>
int launch(const CUtensorMap& qmap, const CUtensorMap& cmap, const Params& P, int grid,
           int smem, cudaStream_t stream) {
  auto kernel = kernel_probe<kStage, kImpl, kNatural>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // setmaxnreg.inc waits forever for registers the block was not given
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kThreads <
      kConsumers * kRegConsumer + kDecoders * kRegDecoder + 128 * kRegProducer)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<grid, kThreads, smem, stream>>>(qmap, cmap, P);
  return static_cast<int>(cudaGetLastError());
}

template <int kStage>
int launch_scored(int impl, int natural, const CUtensorMap& qmap, const CUtensorMap& cmap,
                  const Params& P, int grid, int smem, cudaStream_t st) {
  if constexpr (kStage != kGrid)  // natural's grid is tdec's
    if (natural) return launch<kStage, onehot_rs::kInt, true>(qmap, cmap, P, grid, smem, st);
  switch (impl) {
    case onehot_rs::kInt:
      return launch<kStage, onehot_rs::kInt, false>(qmap, cmap, P, grid, smem, st);
    case onehot_rs::kNib:
      return launch<kStage, onehot_rs::kNib, false>(qmap, cmap, P, grid, smem, st);
    default:
      return launch<kStage, onehot_rs::kCmp8, false>(qmap, cmap, P, grid, smem, st);
  }
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
// stage 0-5 = noop grid noselect min match packed; impl 0 int, 2 nib, 3
// cmp8, 4 i8 (match only), 5 cached (match only); natural: int only (its
// grid is tdec's: the same decode, zeros). slices: the one-hot's codebook
// slices, [m][pieces][K/C][16][C] (C = 64 bf16, 128 s8 for i8), null for
// cached; K padded with zero codewords to an even count of C-code chunks;
// cache: the decoded rows [n_cols][mdp] bf16 (cached). Refuses a
// shape whose slots, ring and slices do not fit 227 KB.
extern "C" int gulon_kernel_probe(int stage, int impl, int natural, const void* codes,
                                  int code_bytes, const void* norms, const void* q,
                                  const void* slices, const void* scale, const void* cache,
                                  void* vals, void* ids, int n_cols, int num_q, int mdp, int m,
                                  int k_codes, int dsub, int pieces, int nblk, int qt_tpu,
                                  void* stream) {
  Params P{codes, static_cast<const float*>(norms), static_cast<const uint8_t*>(slices),
           static_cast<const float*>(scale), static_cast<float*>(vals), static_cast<int*>(ids),
           code_bytes, n_cols, num_q, m, k_codes, dsub, nblk, qt_tpu, pieces,
           0, 0, 0, 0, 0, 0};
  const bool s8 = impl == onehot_rs::kI8, cached = impl == kCached;
  const bool known = impl == onehot_rs::kInt || impl == onehot_rs::kNib ||
                     impl == onehot_rs::kCmp8 || s8 || cached;
  const bool decodes = stage != kNoop && !cached;
  if (!known || n_cols <= 0 || num_q <= 0 || nblk <= 0 || nblk > kRows ||
      n_cols % (nblk * kRows) || mdp % 8 || mdp < m * dsub || m <= 0 || dsub <= 0 ||
      k_codes < 1 || k_codes > 1024 || qt_tpu <= 0 || qt_tpu % kRows || stage < kNoop ||
      stage > kPacked || code_bytes != (impl == onehot_rs::kCmp8 ? 1 : 4) ||
      ((impl == onehot_rs::kCmp8 || s8) && k_codes > 256) ||
      ((s8 || cached) && stage != kMatch) || (natural && impl != onehot_rs::kInt) ||
      (cached && cache == nullptr) ||
      (decodes && (slices == nullptr || pieces < 1 || kLanes * pieces < dsub ||
                   (s8 && scale == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int md = m * dsub;
  P.kc = ((k_codes + (s8 ? 127 : 63)) / (s8 ? 128 : 64) + 1) & ~1;  // whole decode groups
  P.slice_bytes = pieces * P.kc * kLanes * 128;
  P.nch = (md + kChunk - 1) / kChunk;
  P.ksteps = (md + 15) / 16;
  const bool natural_red = natural && stage >= kNoSelect;  // runs kNatural
  if (stage != kNoop) {
    for (int slots = 2; slots >= 1 && P.slots == 0; --slots)
      for (int nst = stage >= kNoSelect ? kMaxStages : 0; nst >= (stage >= kNoSelect ? 2 : 0);
           --nst) {
        Params T = P;
        T.slots = slots;
        T.nst = nst;
        if (1024 + layout(T, decodes, natural_red).total <= kSmemLimit) {
          P.slots = slots;
          P.nst = nst;
          break;
        }
      }
    if (P.slots == 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = 1024 + layout(P, decodes, natural_red).total;
  const int sms = num_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const int grid = std::min((n_cols / kRows + 1) / 2, sms);
  CUtensorMap qmap, cmap;
  if (!sw128_map(&qmap, q, 2, mdp, num_q, static_cast<uint64_t>(mdp) * 2, kQRows) ||
      (cached && !sw128_map(&cmap, cache, 2, mdp, n_cols, static_cast<uint64_t>(mdp) * 2, kRows)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!cached) cmap = qmap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kNoop: return launch<kNoop, onehot_rs::kInt, false>(qmap, cmap, P, grid, smem, st);
    case kGrid:
      return launch_scored<kGrid>(natural ? onehot_rs::kInt : impl, 0, qmap, cmap, P, grid,
                                  smem, st);
    case kNoSelect: return launch_scored<kNoSelect>(impl, natural, qmap, cmap, P, grid, smem, st);
    case kMin: return launch_scored<kMin>(impl, natural, qmap, cmap, P, grid, smem, st);
    case kPacked: return launch_scored<kPacked>(impl, natural, qmap, cmap, P, grid, smem, st);
    default:  // kMatch
      if (s8) return launch<kMatch, onehot_rs::kI8, false>(qmap, cmap, P, grid, smem, st);
      if (cached) return launch<kMatch, kCached, false>(qmap, cmap, P, grid, smem, st);
      return launch_scored<kMatch>(impl, natural, qmap, cmap, P, grid, smem, st);
  }
}
