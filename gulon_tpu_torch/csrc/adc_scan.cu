// Fused ADC scan for Hopper (sm_90a): PQ decode + distances + per-block
// lane-packed minimum, in one pass over the codes.
//
// Replaces the TPU kernel gulon_tpu/ops/pallas/adc.py::_adc_fused_kernel
// (helpers _decode_columns and _block_select). The contract is the TPU
// kernel's, the layout is not: the TPU decodes with a transposed one-hot
// matmul because it has no fast vector gather; here each thread block
// gathers its codewords from codebooks held in shared memory.
//
// Contract, per corpus row n and query q:
//   score[n, q] = sum_d f32(dec_bf16[n, d]) * f32(q_bf16[q, d])   (f32 sum)
// over depth = m*dsub + 4: the m*dsub decoded codeword values, the hi/lo
// bf16 split of the row's reconstruction norm, and two ones facing the
// queries' hi/lo "||q||^2 + mean" lanes (zero lanes in the uncentered
// convention). The product of two bf16 values is exact in f32, so this
// kernel, its plain PyTorch twin and the TPU kernel differ only in how
// the f32 sums are ordered. Per 128-row block b and query q the kernel
// keeps
//   min over rows of bitcast_f32((bits(score) & ~127) | row_in_block)
// with NaN propagating like jnp.min, and for winners > 1 masks that
// winner to 3e38 and repeats. Winner w of block b lands in output column
//   (b / nblk) * W * nblk + w * nblk + (b % nblk)
// of row q -- the TPU kernel's rank-major column inside each row tile of
// nblk blocks -- so the epilogue's base_cols and tie order carry over.
//
// What bounds it on an H100: each (row, query) pair costs depth
// multiply-adds against m code bytes per row shared by the whole batch.
// At the glove100 shape (depth 108, batch 1024) that is ~2*108*1024 flop
// per 8 code bytes, far above the ~295 flop/byte ridge, so the tensor
// cores set the floor (0.09 ms a batch at 400,000 rows). Two things sit
// above it: decoding the codes into bf16 rows, and the selection, which
// runs on the CUDA cores (per query and row: a lane pack and a min, and
// per extra winner a compare, a select and another min). At 4 winners on
// the ivf1m layout (1.06M rows, depth 100) that is 11 operations a pair,
// 0.18 ms at the 67 TFLOP/s f32 rate against 0.22 ms for the contraction
// on the tensor cores: nearly a second floor, and it cannot overlap the
// contraction of the same accumulators.
//
// Design. The mma.sync version decoded every 128-row block once per
// 128-query tile (8 times at Q = 1024), element by element from L1. Here
// a persistent grid (one block per SM) walks contiguous ranges of row
// blocks and decodes each block exactly once:
// - the codebooks are staged in shared memory once per block of threads
//   (K <= 256: 49-53 KB at the glove100 and ivf1m shapes; K = 512 at
//   dsub 13: 106 KB); codebooks that do not fit beside the tiles are
//   gathered from global memory (L1) instead, still once per row block;
// - a row block's codes are read once (coalesced) and decoded 8 lanes at
//   a time into a bf16 [128][depth padded to 64] tile, stored 16 bytes at
//   a time in the 128-byte-swizzled layout that wgmma reads (zero lanes
//   pad depth to a multiple of 16 inside the kernel);
// - one producer warp streams the queries past the decoded block by TMA
//   ([kQTile][64] bf16 chunks, one box each, 128-byte swizzle, an mbarrier
//   ring); the query operand (~230 KB at Q = 1024) stays in L2;
// - two consumer warpgroups run wgmma m64n128k16 (kQTile / 2 queries each
//   on M, as kQTile / 128 m64 tiles; the block's 128 rows on N, f32
//   accumulators in registers) and select straight off the accumulators
//   (see hopper.cuh), one m64 tile after the other.
// A row block too deep to sit decoded in shared memory beside two ring
// stages (depth above ~700, or many code rows) takes the streamed
// instantiation of the same kernel: the consumers decode one [128][64]
// chunk at a time, straight from the codes in global memory, into a ring
// of three decoded chunks and contract it at once, re-decoding the block
// for every query tile. Its query tile is 256 where it fits (make_plan):
// each warpgroup then holds two m64 accumulator tiles (128 f32 registers
// a thread, given it by a producer warpgroup through setmaxnreg) and
// issues two wgmma a k-step on the same decoded chunk, so a block is
// decoded ceil(Q / 256) times, 4 at Q = 1024, and the decode of one chunk
// overlaps twice the wgmma work of the one before. An m64 tile wholly
// past the batch skips its selection and writes nothing (its wgmma run on
// the zeros TMA fills in: a branch around them serializes them all). Its
// decode bounds the gathers a thread has in flight (kGathers), so that
// one-lane gathers fit their registers beside the accumulators.
// One barrier a chunk: the slot a chunk is decoded into was last read by
// the chunk three before, which every warpgroup waited for before the
// previous chunk's barrier; the decode of one chunk overlaps the wgmma of
// the one before. The codebook gathers bound this mode (each warp load
// touches up to 32 lines), so it gathers up to 8 lanes a load: the largest
// of 8, 4, 2 and 1 that divides the operands' dsub (gather_lanes). An
// index whose plan streams at fewer than 8 lanes a gather has its
// codebooks and queries laid out at its dsub rounded up to 8, where that
// adds no 64-lane chunk (operand_width: gist-960's 39-lane subspaces at
// 40, zero lanes facing zero lanes), so it gathers 8 lanes, 16 bytes, a
// load; an odd dsub left as it is gathers one lane, two bytes.
//
// Plan. make_plan picks, per shape, held or streamed, codebooks in shared
// or global memory, the query tile, the ring stages, the lanes a gather
// and the operands' subspace width; the launch and the exported gulon_adc_scan_plan both
// call it, and the Python wrapper lays an index's operands out at that
// width and counts each launch by the plan the latter returns.
//
// Stages. The kernel is templated on how far it goes (kStage), so that
// K1's own time can be split: kDecode stages and decodes every row block
// as the full kernel does, streams no queries and writes zeros; kContract
// adds the query ring and the wgmma and writes each block's first row's
// score; kMin adds the block minimum of the raw scores; kFull is K1. Only
// kFull serves (gulon_adc_scan); gulon_adc_scan_stage runs the cut ones
// for gulon_tpu_torch/probes, winners = 1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see gulon_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "adc_decode.cuh"
#include "hopper.cuh"

namespace {

using namespace adc_decode;

constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kMaxStages = 6;
constexpr int kDecSlots = 3;  // decoded chunks of the streamed mode
constexpr int kGathers = 16;  // most codebook gathers a decoding thread has in flight
enum Stage { kDecode = 0, kContract = 1, kMin = 2, kFull = 3 };
__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// Threads of a block at query tile qtile: the consumers and one producer
// warp; at 256 a whole producer warpgroup, which hands its registers to
// the consumers (setmaxnreg 24 / 240): ptxas sizes a launch by whole
// warpgroups, 168 registers a thread at either count, too few for 128
// accumulators beside the decode.
__host__ __device__ constexpr int threads_of(int qtile) {
  return kConsumers + (qtile == 256 ? 128 : 32);
}

// Shared-memory offsets from the 1024-byte-aligned base: the decoded row
// block (nch [128][64] chunks; kDecSlots when streamed), the query ring
// (nst [qtile][64] chunks), the ring's barriers, the codebooks (when held
// there), and, when the block is held decoded, its codes and norms and the
// column table.
struct Layout {
  int ring, bars, cb, codes, norms, tab, total;
};

__host__ __device__ inline Layout layout(int nch, int nst, int m, int cb_bytes,
                                         int streamed, int qtile) {
  Layout L;
  L.ring = (streamed ? kDecSlots : nch) * hopper::kChunkBytes;
  L.bars = L.ring + nst * qtile * 128;
  L.cb = round16(L.bars + 2 * nst * 8);
  L.codes = L.cb + round16(cb_bytes);
  L.norms = L.codes + (streamed ? 0 : round16(m * hopper::kRows * 2));
  L.tab = L.norms + (streamed ? 0 : 2 * hopper::kRows * 2);
  L.total = L.tab + (streamed ? 0 : nch * hopper::kChunk * 8);
  return L;
}

// kQTile: queries a query tile, 128 or 256; each consumer warpgroup holds
// kQTile / 128 m64 accumulator tiles (warpgroup wg's tile t: queries
// qt kQTile + wg kQTile / 2 + 64 t + [0, 64)).
template <bool kStreamed, int kStage, int kQTile>
__global__ void __launch_bounds__(threads_of(kQTile), 1) adc_scan_kernel(
    const __grid_constant__ CUtensorMap qmap,  // queries [num_q][depth] bf16, [kQTile][64] boxes
    const void* __restrict__ codes,            // [m, n_cols] of code_bytes each
    int code_bytes,
    const uint16_t* __restrict__ norms,        // [2, n_cols] bf16 hi/lo
    const uint16_t* __restrict__ cb,           // [m, k_codes, dsub] bf16
    float* __restrict__ out,                   // [num_q, n_blocks * winners]
    int n_cols, int num_q, int depth, int m, int k_codes, int dsub,
    int winners, int nblk, int nch, int nst, int cb_smem) {
  using namespace hopper;
  constexpr int kTiles = kQTile / 128;        // m64 tiles a consumer warpgroup
  constexpr int kStageBytes = kQTile * 128;   // one [kQTile][64] bf16 query chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int cb_len = m * k_codes * dsub;
  const Layout L = layout(nch, nst, m, cb_smem ? cb_len * 2 : 0, kStreamed, kQTile);
  uint8_t* dec = smem;
  uint8_t* ring = smem + L.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + nst;
  uint16_t* cb_s = reinterpret_cast<uint16_t*>(smem + L.cb);
  int16_t* codes_s = reinterpret_cast<int16_t*>(smem + L.codes);
  uint16_t* norms_s = reinterpret_cast<uint16_t*>(smem + L.norms);
  int2* tab = reinterpret_cast<int2*>(smem + L.tab);

  const int n_blocks = n_cols / kRows;
  const int b0 = static_cast<int>(static_cast<int64_t>(n_blocks) * blockIdx.x / gridDim.x);
  const int b1 = static_cast<int>(static_cast<int64_t>(n_blocks) * (blockIdx.x + 1) / gridDim.x);
  if (b0 >= b1) return;
  const int n_qt = (num_q + kQTile - 1) / kQTile;
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
  if (wg == kConsumers / 128) {  // producer warp: the query chunks, block after block
    if constexpr (kTiles > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (kStage != kDecode && tid == kConsumers) {
      int it = 0;
      for (int blk = b0; blk < b1; ++blk)
        for (int qt = 0; qt < n_qt; ++qt)
          for (int c = 0; c < nch; ++c, ++it) {
            const int st = it % nst;
            mbar_wait(&empty[st], ((it / nst) & 1) ^ 1);
            mbar_expect_tx(&full[st], kStageBytes);
            tma_load_2d(ring + st * kStageBytes, &qmap, &full[st], c * kChunk, qt * kQTile);
          }
    }
    return;
  }

  // consumers, once per thread block: the codebooks and, for blocks held
  // decoded, the column table (column -> codebook offset and code row, or
  // the kind of extra lane)
  if constexpr (kTiles > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  if (cb_smem) {
    const int n16 = cb_len / 8;
    for (int i = tid; i < n16; i += kConsumers)
      reinterpret_cast<uint4*>(cb_s)[i] = __ldg(reinterpret_cast<const uint4*>(cb) + i);
    for (int i = n16 * 8 + tid; i < cb_len; i += kConsumers) cb_s[i] = __ldg(cb + i);
  }
  if (!kStreamed) column_table<kConsumers>(tab, nch, m, k_codes, dsub, tid);
  bar_sync(1, kConsumers);  // the codebooks are staged before any decode reads them

  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_win = n_blocks * winners;
  float acc[kTiles][64];
  int it = 0;
  int dk = 0;  // chunks decoded in the streamed mode
  for (int blk = b0; blk < b1; ++blk) {
    const int64_t row0 = static_cast<int64_t>(blk) * kRows;
    if (!kStreamed) {
      bar_sync(1, kConsumers);  // every wgmma read of the last block is done
      stage_block<kConsumers>(codes_s, norms_s, codes, code_bytes, norms, row0, n_cols, m,
                              k_codes, tid);
      bar_sync(1, kConsumers);
      decode_block<kConsumers>(dec, nch, tab, codes_s, norms_s, cb, cb_s, cb_smem, dsub, tid);
      fence_proxy_async();
      bar_sync(1, kConsumers);
    }

    const int col0 = (blk / nblk) * winners * nblk + (blk % nblk);
    for (int qt = 0; qt < n_qt; ++qt) {
      // this warpgroup's first query, and its m64 tiles that hold a query
      const int qw = qt * kQTile + wg * (kQTile / 2);
      const int live = kTiles == 1 ? 1 : min(kTiles, max(0, (num_q - qw + 63) / 64));
      const int q = qw + warp * 16 + (lane >> 2);  // + 64 t in tile t
      if constexpr (kStage == kDecode) {  // the decode alone, then zeros
        if (kStreamed)
          for (int c = 0; c < nch; ++c) {
            uint8_t* b = dec + (dk++ % kDecSlots) * kChunkBytes;
            decode_chunk<kConsumers, kGathers>(b, c, row0, codes, code_bytes, norms,
                                               cb_smem ? cb_s : cb, n_cols, m, k_codes, dsub,
                                               tid);
            fence_proxy_async();
            bar_sync(1, kConsumers);
          }
#pragma unroll
        for (int t = 0; t < kTiles; ++t) {
          const int qq = q + 64 * t;
          if ((lane & 3) == 0 && qq < num_q) out[static_cast<int64_t>(qq) * n_win + col0] = 0.f;
          if ((lane & 3) == 1 && qq + 8 < num_q)
            out[static_cast<int64_t>(qq + 8) * n_win + col0] = 0.f;
        }
        continue;
      }
      // chunk c's wgmma group is issued before chunk c-1's stage is freed;
      // chunk 0 overwrites the accumulators. Streamed, chunk c is first
      // decoded into the slot that chunk c-3 read. Each k-step's wgmma of
      // the kTiles tiles read the same decoded chunk. Every tile issues its
      // wgmma, a tile past the batch on the zeros TMA fills in: a branch
      // around them, inside the pipeline or around it, makes ptxas
      // serialize every wgmma (C7519, C7514) or spill.
      auto mma_chunk = [&](int c) {
        uint8_t* b = dec + c * kChunkBytes;
        if (kStreamed) {
          b = dec + (dk++ % kDecSlots) * kChunkBytes;
          decode_chunk<kConsumers, kGathers>(b, c, row0, codes, code_bytes, norms,
                                             cb_smem ? cb_s : cb, n_cols, m, k_codes, dsub, tid);
          fence_proxy_async();
          bar_sync(1, kConsumers);
        }
        const int st = it % nst;
        mbar_wait(&full[st], (it / nst) & 1);
        const uint8_t* qa = ring + st * kStageBytes + wg * (kQTile / 2) * 128;
        const uint64_t desc_b = sw128_desc(b);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // lanes past depth are zero in both operands
#pragma unroll
          for (int t = 0; t < kTiles; ++t)
            wgmma_m64n128k16(acc[t], sw128_desc(qa + t * 64 * 128) + 2 * kk, desc_b + 2 * kk,
                             (c | kk) != 0);
        wgmma_commit();
        ++it;
        return st;
      };
      int prev = mma_chunk(0);
      for (int c = 1; c < nch; ++c) {
        const int st = mma_chunk(c);
        wgmma_wait<1>();
        release(&empty[prev], lane);
        prev = st;
      }
      wgmma_wait<0>();
      release(&empty[prev], lane);
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        fence_regs(acc[t]);
        if (t >= live) continue;
        const int qq = q + 64 * t;
        if constexpr (kStage == kContract) {  // row 0's scores (acc_row(0, 0, lane & ~3))
          if ((lane & 3) == 0) {
            if (qq < num_q) out[static_cast<int64_t>(qq) * n_win + col0] = acc[t][0];
            if (qq + 8 < num_q) out[static_cast<int64_t>(qq + 8) * n_win + col0] = acc[t][2];
          }
          continue;
        }
        if constexpr (kStage == kFull) pack_rows(acc[t], lane);
        for (int w = 0; w < winners; ++w) {
          const float v0 = block_min<0>(acc[t], lane);
          const float v1 = block_min<1>(acc[t], lane);
          const int64_t col = col0 + w * nblk;
          if ((lane & 3) == 0 && qq < num_q) out[static_cast<int64_t>(qq) * n_win + col] = v0;
          if ((lane & 3) == 1 && qq + 8 < num_q)
            out[static_cast<int64_t>(qq + 8) * n_win + col] = v1;
          if (w + 1 < winners) mask_winner(acc[t], v0, v1);
        }
      }
    }
  }
}

// K1's launch plan for a shape: the first that fits a block's shared
// memory, in order: the row block held decoded before streamed, the
// codebooks in shared memory before gathered from global memory, then,
// streamed, a 256-query tile before a 128-query one (held: 128, the block
// is decoded once whatever the tile), then the most query-ring stages. So
// a streamed plan takes 256 wherever its three decoded slots, two ring
// stages of 32 KB and its codebooks (when in shared memory) fit. The
// launch and gulon_adc_scan_plan both take it from here, so what the
// wrapper counts is what runs.
struct Plan {
  int streamed;  // 1: each row block decoded a chunk at a time per query tile
  int cb_smem;   // 1: codebooks staged in shared memory; 0: gathered from global
  int nst;       // query-ring stages
  int lanes;     // codebook lanes one gather loads (1 when held decoded)
  int smem;      // dynamic shared memory, bytes (1024 of alignment included)
  int width;     // subspace width to lay the codebook and query operands out at
  int qtile;     // queries a query tile: 256 or 128
};

// The subspace width an index of this shape lays K1's operands out at:
// dsub rounded up to a whole 16-byte gather where the plan streams, a
// gather loads fewer lanes, and the zero lanes add no 64-lane chunk to the
// depth (so the wgmma work is the same and the plan at the wider width
// streams too, its codebooks where they were or in global memory); dsub
// otherwise. A held plan decodes from a column table, one lane at a time.
int operand_width(int m, int k_codes, int dsub, int streamed) {
  using namespace hopper;
  const int wide = (dsub + 7) / 8 * 8;
  if (!streamed || gather_lanes(dsub) == 8 ||
      static_cast<int64_t>(m) * k_codes * wide > 0x7FFFFFFF)
    return dsub;
  const int chunks = (m * dsub + 4 + kChunk - 1) / kChunk;
  return (m * wide + 4 + kChunk - 1) / kChunk == chunks ? wide : dsub;
}

// Fills *p; false for a shape K1 does not take or when no plan fits.
bool make_plan(int depth, int m, int k_codes, int dsub, Plan* p) {
  using namespace hopper;
  const int64_t cb_len64 = static_cast<int64_t>(m) * k_codes * dsub;
  if (m <= 0 || dsub <= 0 || depth != m * dsub + 4 || k_codes < 1 || k_codes > 32767 ||
      cb_len64 > 0x7FFFFFFF)
    return false;
  const int nch = (depth + kChunk - 1) / kChunk;
  for (int plan = 0; plan < 4; ++plan) {
    const int cb_smem = !(plan & 1);
    const int streamed = plan >> 1;
    if (cb_smem && cb_len64 * 2 > kSmemLimit) continue;
    const int cb_bytes = cb_smem ? static_cast<int>(cb_len64 * 2) : 0;
    for (int qtile = streamed ? 256 : 128; qtile >= 128; qtile -= 128)
      for (int s = kMaxStages; s >= 2; --s) {
        const int total = 1024 + layout(nch, s, m, cb_bytes, streamed, qtile).total;
        if (total <= kSmemLimit) {
          *p = Plan{streamed, cb_smem, s, streamed ? gather_lanes(dsub) : 1, total,
                    operand_width(m, k_codes, dsub, streamed), qtile};
          return true;
        }
      }
  }
  return false;
}

// Launch of stage kStage. Returns a cudaError_t (0 = launched). Shapes
// and alignment are checked by the Python wrapper; this re-checks what
// would make the launch read or write out of bounds. Any depth runs: the
// row block is held decoded when it fits beside two ring stages, and
// streamed otherwise (make_plan).
template <int kStage>
int launch(const void* codes, int code_bytes, const void* norms, const void* q,
           const void* cb, void* out, int n_cols, int num_q, int q_stride, int depth, int m,
           int k_codes, int dsub, int winners, int nblk, void* stream) {
  using namespace hopper;
  Plan plan;
  if (n_cols <= 0 || n_cols % kRows != 0 || num_q <= 0 || nblk <= 0 ||
      (n_cols / kRows) % nblk != 0 || q_stride < depth || q_stride % 8 != 0 ||
      winners < 1 || winners > 4 || (code_bytes != 1 && code_bytes != 2 && code_bytes != 4) ||
      !make_plan(depth, m, k_codes, dsub, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = (depth + kChunk - 1) / kChunk;
  const int sms = num_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const int grid = std::min(n_cols / kRows, sms);
  CUtensorMap qmap;
  if (!sw128_map(&qmap, q, 2, depth, num_q, static_cast<uint64_t>(q_stride) * 2, plan.qtile))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = !plan.streamed      ? adc_scan_kernel<false, kStage, 128>
                : plan.qtile == 256 ? adc_scan_kernel<true, kStage, 256>
                                    : adc_scan_kernel<true, kStage, 128>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads_of(plan.qtile), plan.smem, static_cast<cudaStream_t>(stream)>>>(
      qmap, codes, code_bytes, static_cast<const uint16_t*>(norms),
      static_cast<const uint16_t*>(cb), static_cast<float*>(out), n_cols, num_q,
      depth, m, k_codes, dsub, winners, nblk, nch, plan.nst, plan.cb_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes.
extern "C" int gulon_adc_scan(const void* codes, int code_bytes,
                              const void* norms, const void* q,
                              const void* cb, void* out, int n_cols,
                              int num_q, int q_stride, int depth, int m,
                              int k_codes, int dsub, int winners, int nblk,
                              void* stream) {
  return launch<kFull>(codes, code_bytes, norms, q, cb, out, n_cols, num_q, q_stride, depth,
                       m, k_codes, dsub, winners, nblk, stream);
}

// K1 cut after its decode (stage 0), its contraction (1) or its block
// minimum (2), one winner a block; the same operands and output shape.
extern "C" int gulon_adc_scan_stage(const void* codes, int code_bytes,
                                    const void* norms, const void* q,
                                    const void* cb, void* out, int n_cols,
                                    int num_q, int q_stride, int depth, int m,
                                    int k_codes, int dsub, int nblk, int stage,
                                    void* stream) {
  auto run = stage == kDecode ? launch<kDecode> : stage == kContract ? launch<kContract>
             : stage == kMin ? launch<kMin> : nullptr;
  if (run == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run(codes, code_bytes, norms, q, cb, out, n_cols, num_q, q_stride, depth, m, k_codes,
             dsub, 1, nblk, stream);
}

// The plan a launch at this shape takes (make_plan), as seven ints:
// streamed, codebooks in shared memory, ring stages, lanes a gather,
// dynamic shared memory bytes, the operands' subspace width and the query
// tile. Returns a cudaError_t (0 = a plan exists); needs no device.
extern "C" int gulon_adc_scan_plan(int depth, int m, int k_codes, int dsub, int* out) {
  Plan plan;
  if (out == nullptr || !make_plan(depth, m, k_codes, dsub, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = plan.streamed;
  out[1] = plan.cb_smem;
  out[2] = plan.nst;
  out[3] = plan.lanes;
  out[4] = plan.smem;
  out[5] = plan.width;
  out[6] = plan.qtile;
  return 0;
}
