// Fused dense scans for Hopper (sm_90a): one contraction per (row, query)
// pair of a dense operand and the per-block lane-packed minimum, in one
// pass over the rows.
//
// K2 (gulon_dense_scan_bf16) replaces the TPU kernel
// gulon_tpu/ops/pallas/dense.py::_dense_kernel, K3 (gulon_dense_scan_i8)
// replaces _dense_kernel_i8. Contract, per corpus row n and query q:
//   K2: score[n, q] = sum_d f32(x_bf16[n, d]) * f32(q_bf16[q, d])  (f32 sum)
//       over Dp lanes: the data lanes and the hi/lo bf16 norm lanes of
//       prepare_data against -2q and two unit lanes, so the score is
//       ||x||^2 - 2<x, q>. Products of two bf16 values are exact in f32:
//       kernel, plain twin and TPU kernel differ only in summation order.
//   K3: score[n, q] = sum_d int(x_i8[n, d]) * int(q_i8[q, d])  (int32 sum)
//       over Dp lanes: the data lanes and the base-127 norm digit pair of
//       prepare_data_i8 against the quantized -q and the lanes (127, 1).
//       Integer sums are exact, so K3 equals its plain twin bit for bit.
// Rows n >= n_rows of the last block score as the JAX padding rows do:
// K2 bits(bf16(3e38)) = 0x7F620000, K3 127*127 + 126 = 16255 (so in K3's
// last block a padding row beats a real row scoring above 16255, as on
// the TPU). Per 128-row block b and query q the kernel writes out[q, b] =
//   min over rows of ((bits(score) & ~127) | row_in_block)
// (as f32 with NaN propagating like jnp.min for K2; as int32 for K3).
// Unlike the TPU wrapper, no padded copy of the corpus is made per call.
//
// What bounds them on an H100: a batch of 1024 queries against the
// fasttext corpus (2M rows) is 2*2M*1024*Dp operations over Dp bytes (K3)
// or 2 Dp bytes (K2) a row, ~1,000-2,000 operations a byte, far above the
// ridge (~295 flop/byte in bf16, ~590 op/byte in int8): the tensor cores
// bound both. K2 at Dp 304: 1.26 ms at the 989 TFLOP/s bf16 peak; K3 at
// Dp 320: 0.66 ms at the 1,979 TOP/s int8 peak, which only wgmma reaches.
//
// Design (one kernel template for both; Op below names the element type).
// A persistent grid: each block owns a query tile of 256 queries (128
// where the operand is too deep), resident in shared memory for the whole
// kernel, and a contiguous range of 128-row blocks, which it walks once.
// One thread of a producer warpgroup (whose registers go to the
// consumers, setmaxnreg) streams the rows through a ring of [128 rows]
// [128 bytes] chunks (64 bf16 or 128 int8 lanes) by TMA (128-byte swizzle,
// mbarriers), so each row crosses L2 -> shared memory once per query
// tile (4 passes over the rows at 1024 queries) and the queries once per
// block; the blocks of the query tiles that share a row range run side by
// side, so the rows cross HBM about once. Two consumer warpgroups run wgmma (queries on M, the
// 128 rows of one selection block on N; K2 m64n128k16 bf16 into f32, K3
// m64n128k32 s8 into s32) and take the block minimum straight off the
// accumulators: a register min over each thread's 32 rows and two
// shuffles, no shared memory. Where a whole row block fits the ring, the
// two warpgroups take turns at the tensor cores (ping-pong), so one
// selects on the CUDA cores while the other contracts (PERF.md has the
// times with and without). Operands too deep for a resident query tile
// stream the query chunk beside each row chunk.
//
// K3's ragged depth: Dp is a multiple of 32 (one s8 k-step), not of 128,
// so the last chunk may carry 1-3 k-steps of lanes (Dp 320 = 2.5 chunks).
// Issuing all four k-steps there would contract zero lanes (384 instead
// of 320 at the fasttext shape, +20 % of the bound). The k-step count of
// that chunk is a template parameter (KL), and the ragged chunk is
// contracted FIRST (integer sums do not depend on the order), so every
// later chunk issues four k-steps and no branch around a wgmma depends
// on the depth: a runtime branch there makes ptxas serialise every
// wgmma (C7519/C7517). K2 keeps four k-steps a chunk, the ragged lanes
// zero-filled by TMA in both operands.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see gulon_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;    // + one producer warpgroup
constexpr int kMaxStages = 6;

// K2: bf16 lanes into f32 accumulators, four k-steps of 16 lanes a chunk
struct Bf16Scan {
  using Acc = float;
  static constexpr int kElemBytes = 2;
  static constexpr int kLanes = 64;     // lanes of a 128-byte chunk row
  static constexpr bool kRagged = false;  // always four k-steps a chunk
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    hopper::wgmma_m64n128k16(d, a, b, scale_d);
  }
  static __device__ __forceinline__ float tail() { return __int_as_float(0x7F620000); }
};

// K3: int8 lanes into s32 accumulators, up to four k-steps of 32 lanes
struct S8Scan {
  using Acc = int;
  static constexpr int kElemBytes = 1;
  static constexpr int kLanes = 128;
  static constexpr bool kRagged = true;  // the last chunk's k-steps: KL
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
    hopper::wgmma_m64n128k32_s8(d, a, b, scale_d);
  }
  static __device__ __forceinline__ int tail() { return 127 * 127 + 126; }
};

// One chunk's wgmma group: KS k-steps of 32 bytes over the warpgroup's MT
// query tiles (qa) and the 128 rows of the chunk; step 0 overwrites.
template <class Op, int MT, int KS>
__device__ __forceinline__ void mma_chunk(typename Op::Acc (&acc)[MT][64],
                                          const uint8_t* qa, const uint8_t* rows, int wg,
                                          int step) {
  using namespace hopper;
  const uint64_t desc_b = sw128_desc(rows);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int t = 0; t < MT; ++t)
      Op::mma(acc[t], sw128_desc(qa + (wg * MT + t) * 64 * 128) + 2 * kk, desc_b + 2 * kk,
              (step | kk) != 0);
  wgmma_commit();
}

// MT: m64 query tiles per consumer warpgroup, so a block's query tile is
// 128 * MT queries. KL: k-steps of the ragged last lane chunk, contracted
// first (0: every chunk has four). Shared memory (1024-byte aligned): the
// resident query tile as nch [qt][128 bytes] chunks (absent when
// stream_q), then nst ring stages of one [128][128 bytes] row chunk (+ the
// matching query chunk when stream_q), then the barriers.
template <class Op, int MT, int KL>
__global__ void __launch_bounds__(kThreads, 1) dense_kernel(
    const __grid_constant__ CUtensorMap xmap,  // rows [n_rows][dp]
    const __grid_constant__ CUtensorMap qmap,  // queries [num_q][dp]
    typename Op::Acc* __restrict__ out,        // [num_q, n_blocks]
    int n_rows, int num_q, int nch, int n_blocks, int n_qt, int nst, int stream_q) {
  using namespace hopper;
  using Acc = typename Op::Acc;
  const bool pingpong = nst >= nch;
  constexpr int kQt = 128 * MT;
  constexpr int kQChunk = kQt * 128;  // bytes of one [qt][128 bytes] query chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = kChunkBytes + (stream_q ? kQChunk : 0);
  uint8_t* q_res = smem;
  uint8_t* ring = smem + (stream_q ? 0 : nch * kQChunk);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nst * stage_bytes);
  uint64_t* empty = full + nst;
  uint64_t* q_full = empty + nst;
  // the lane chunk of contraction step i: the ragged one first
  auto chunk_at = [nch](int i) { return KL == 0 ? i : (i == 0 ? nch - 1 : i - 1); };

  const int tid = threadIdx.x;
  const int qt = blockIdx.x % n_qt;
  const int group = blockIdx.x / n_qt;
  const int groups = gridDim.x / n_qt;
  const int b0 = static_cast<int>(static_cast<int64_t>(n_blocks) * group / groups);
  const int b1 = static_cast<int>(static_cast<int64_t>(n_blocks) * (group + 1) / groups);
  if (b0 >= b1) return;
  const int q0 = qt * kQt;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == kConsumers / 128) {  // producer warpgroup: one lane issues every load
    // hand the registers to the consumers (128 accumulators a thread)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      if (!stream_q) {
        mbar_expect_tx(q_full, nch * kQChunk);
        for (int c = 0; c < nch; ++c)
          tma_load_2d(q_res + c * kQChunk, &qmap, q_full, c * Op::kLanes, q0);
      }
      int it = 0;
      for (int blk = b0; blk < b1; ++blk)
        for (int i = 0; i < nch; ++i, ++it) {
          const int st = it % nst;
          const int lane0 = chunk_at(i) * Op::kLanes;
          mbar_wait(&empty[st], ((it / nst) & 1) ^ 1);
          uint8_t* stage = ring + st * stage_bytes;
          mbar_expect_tx(&full[st], stage_bytes);
          tma_load_2d(stage, &xmap, &full[st], lane0, blk * kRows);
          if (stream_q) tma_load_2d(stage + kChunkBytes, &qmap, &full[st], lane0, q0);
        }
    }
  } else {
    // consumers: warpgroup wg scores queries q0 + 64 * (wg * MT + t) + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    if (!stream_q) mbar_wait(q_full, 0);
    Acc acc[MT][64];
    int it = 0;
    auto next_stage = [&]() {
      const int st = it % nst;
      mbar_wait(&full[st], (it / nst) & 1);
      ++it;
      return st;
    };
    auto queries = [&](int st, int i) -> const uint8_t* {
      return stream_q ? ring + st * stage_bytes + kChunkBytes : q_res + chunk_at(i) * kQChunk;
    };
    for (int blk = b0; blk < b1; ++blk) {
      // ping-pong: the warpgroups take turns at the tensor cores, so one
      // selects while the other contracts. Warpgroup wg waits at named
      // barrier 1 + wg for its turn and hands it on at 2 - wg; warpgroup
      // 0 starts, and warpgroup 1 hands on no turn after its last block.
      // Both read every stage, so a turn needs a whole block in the ring
      // (nst >= nch), or it would wait for a stage the other warpgroup,
      // waiting for its turn, never frees.
      if (pingpong && (wg == 1 || blk != b0)) bar_sync(1 + wg, kConsumers);
      // step i's wgmma group is issued before step i-1's stage is freed
      int prev = next_stage();
      mma_chunk<Op, MT, (KL == 0 ? 4 : KL)>(acc, queries(prev, 0), ring + prev * stage_bytes,
                                             wg, 0);
      for (int i = 1; i < nch; ++i) {
        const int st = next_stage();
        mma_chunk<Op, MT, 4>(acc, queries(st, i), ring + st * stage_bytes, wg, i);
        wgmma_wait<1>();
        release(&empty[prev], lane);
        prev = st;
      }
      // the turn passes once the last group is issued, so the other
      // warpgroup's first group queues right behind it
      if (pingpong && (wg == 0 || blk != b1 - 1)) bar_arrive(2 - wg, kConsumers);
      wgmma_wait<0>();
      release(&empty[prev], lane);

      const int n_valid = n_rows - blk * kRows;  // < 128 only in the last block
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        fence_regs(acc[t]);
        if (n_valid < kRows) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (acc_row(j, c & 1, lane) >= n_valid) acc[t][4 * j + c] = Op::tail();
        }
        pack_rows(acc[t], lane);
        const Acc v0 = block_min<0>(acc[t], lane);
        const Acc v1 = block_min<1>(acc[t], lane);
        const int q = q0 + (wg * MT + t) * 64 + warp * 16 + (lane >> 2);
        if ((lane & 3) == 0 && q < num_q) out[static_cast<int64_t>(q) * n_blocks + blk] = v0;
        if ((lane & 3) == 1 && q + 8 < num_q)
          out[static_cast<int64_t>(q + 8) * n_blocks + blk] = v1;
      }
    }
  }
}

template <class Op, int MT, int KL>
int launch(const void* data, const void* q, void* out, int n_rows, int num_q, int dp,
           int nst, int stream_q, int smem, cudaStream_t stream) {
  using namespace hopper;
  const int n_blocks = (n_rows + kRows - 1) / kRows;
  const int n_qt = (num_q + 128 * MT - 1) / (128 * MT);
  const int sms = num_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const int groups = std::max(1, std::min(n_blocks, sms / n_qt));
  const int64_t grid = static_cast<int64_t>(n_qt) * groups;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t stride = static_cast<uint64_t>(dp) * Op::kElemBytes;
  CUtensorMap xmap, qmap;
  if (!sw128_map(&xmap, data, Op::kElemBytes, dp, n_rows, stride, kRows) ||
      !sw128_map(&qmap, q, Op::kElemBytes, dp, num_q, stride, 128 * MT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dense_kernel<Op, MT, KL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_kernel<Op, MT, KL><<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      xmap, qmap, static_cast<typename Op::Acc*>(out), n_rows, num_q,
      (dp + Op::kLanes - 1) / Op::kLanes, n_blocks, n_qt, nst, stream_q);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for the ragged chunk's k-step count kl (K3 only)
template <class Op, int MT>
int launch_kl(int kl, const void* data, const void* q, void* out, int n_rows, int num_q,
              int dp, int nst, int stream_q, int smem, cudaStream_t stream) {
  if constexpr (Op::kRagged) {
    switch (kl) {
      case 1: return launch<Op, MT, 1>(data, q, out, n_rows, num_q, dp, nst, stream_q, smem, stream);
      case 2: return launch<Op, MT, 2>(data, q, out, n_rows, num_q, dp, nst, stream_q, smem, stream);
      case 3: return launch<Op, MT, 3>(data, q, out, n_rows, num_q, dp, nst, stream_q, smem, stream);
      default: break;
    }
  }
  return launch<Op, MT, 0>(data, q, out, n_rows, num_q, dp, nst, stream_q, smem, stream);
}

// The shared-memory plan: the deepest query tile that stays resident
// beside a ring of at least two row chunks, else query chunks streamed
// beside the row chunks.
template <class Op>
int dense_scan(const void* data, const void* q, void* out, int n_rows, int num_q, int dp,
               cudaStream_t stream) {
  using namespace hopper;
  const int nch = (dp + Op::kLanes - 1) / Op::kLanes;
  const int kl = Op::kRagged ? (dp % Op::kLanes) / 32 : 0;  // 32 bytes a k-step
  const int room = kSmemLimit - 1024 - (2 * kMaxStages + 1) * 8;
  for (int mt = 2; mt >= 1; --mt) {
    const int resident = nch * 128 * mt * 128;
    const int nst = std::min(kMaxStages, (room - resident) / kChunkBytes);
    if (nst < 2) continue;
    const int smem = 1024 + resident + nst * kChunkBytes + (2 * nst + 1) * 8;
    return mt == 2
               ? launch_kl<Op, 2>(kl, data, q, out, n_rows, num_q, dp, nst, 0, smem, stream)
               : launch_kl<Op, 1>(kl, data, q, out, n_rows, num_q, dp, nst, 0, smem, stream);
  }
  const int stage = kChunkBytes + 256 * 128;
  const int nst = std::min(kMaxStages, room / stage);
  const int smem = 1024 + nst * stage + (2 * nst + 1) * 8;
  return launch_kl<Op, 2>(kl, data, q, out, n_rows, num_q, dp, nst, 1, smem, stream);
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t (0 =
// launched). Shapes, dtypes and 16-byte alignment are checked by the
// Python wrapper; this re-checks what would make the launch read or
// write out of bounds.
extern "C" int gulon_dense_scan_bf16(const void* data, const void* q, void* out,
                                     int n_rows, int num_q, int dp, void* stream) {
  if (n_rows <= 0 || num_q <= 0 || dp <= 0 || dp % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dense_scan<Bf16Scan>(data, q, out, n_rows, num_q, dp,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int gulon_dense_scan_i8(const void* data, const void* q, void* out,
                                   int n_rows, int num_q, int dp, void* stream) {
  if (n_rows <= 0 || num_q <= 0 || dp <= 0 || dp % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dense_scan<S8Scan>(data, q, out, n_rows, num_q, dp, static_cast<cudaStream_t>(stream));
}
