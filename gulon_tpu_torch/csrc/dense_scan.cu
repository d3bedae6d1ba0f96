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
// K2 bits(bf16(3e38)) = 0x7F620000, K3 127*127 + 126 = 16255. Per 128-row
// block b and query q the kernel writes out[q, b] =
//   min over rows of ((bits(score) & ~127) | row_in_block)
// (as f32 with NaN propagating like jnp.min for K2; as int32 for K3).
// Unlike the TPU wrapper, no padded copy of the corpus is made per call.
//
// What bounds them on an H100: at the fasttext shape (2M x 300, Dp 304,
// 1024 queries) a batch is 2*2M*1024*304 = 1.25 TFLOP over 1.2 GB of bf16
// rows, ~1,000 flop per byte, far above the ~295 flop/byte ridge: the
// tensor cores bound it (1.26 ms at the 989 TFLOP/s bf16 peak).
//
// K2 design (wgmma). A persistent grid: each block owns a query tile of
// 256 queries (128 where the operand is too deep), resident in shared
// memory for the whole kernel, and a contiguous range of 128-row blocks,
// which it walks once. One thread of a producer warpgroup (whose
// registers go to the consumers, setmaxnreg) streams the rows through a
// ring of [128][64] bf16 chunks by TMA (128-byte swizzle, mbarriers), so each
// row crosses L2 -> shared memory once per query tile, not once per
// 128 x 128 tile as in the mma.sync version (19.5 -> 4.9 GB a batch at
// the fasttext shape); the blocks of the query tiles that share a row
// range run side by side, so the rows cross HBM about once. Two consumer
// warpgroups run wgmma m64n128k16 (queries on M, the 128 rows of one
// selection block on N, f32 accumulators in registers) and take the
// block minimum straight off the accumulators: a register min over each
// thread's 32 rows and two shuffles, no shared memory. Operands too deep
// for a resident query tile stream the query chunk beside each row chunk.
//
// K3 keeps the mma.sync version: 256 threads own 128 rows x 128 queries;
// warp w holds rows 32*(w%4) .. +31 and queries 64*(w/4) .. +63 as 2 x 8
// mma tiles of accumulators in registers. The contraction walks the row
// in 64-byte chunks, double-buffered in shared memory by cp.async 16-byte
// copies (rows padded to 80 bytes, so fragment loads hit 32 distinct
// banks; segments past Dp and rows past the end are zero-filled). Blocks
// are numbered query tile fastest, so the query tiles of one row block
// run together and re-read its rows from L2, not from HBM. Selection: a
// register min over each thread's 4 rows of a query, 3 xor-shuffles
// across the warp's 32 rows, and a 4-way shared-memory step across the
// warps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see gulon_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

// K3's tile: 128 rows x 128 queries, staged 64 bytes of a row at a time
constexpr int kK3Rows = 128;      // one selection block
constexpr int kK3Queries = 128;   // query tile of one thread block
constexpr int kK3Threads = 256;
constexpr int kK3ChunkBytes = 64;  // bytes of a row staged per step
constexpr int kK3Stride = kK3ChunkBytes + 16;  // bytes per shared-memory row
constexpr int kK3Segs = kK3ChunkBytes / 16;    // 16-byte copies per row and chunk

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int pack_lane(int v, int row) { return (v & ~127) | row; }

__device__ __forceinline__ void tail_score(int& v) { v = 127 * 127 + 126; }

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// K3: int8 lanes, int32 accumulators.
__global__ void __launch_bounds__(kK3Threads, 2) dense_i8_kernel(
    const uint8_t* __restrict__ data,  // [n_rows, row_bytes]
    const uint8_t* __restrict__ q,     // [num_q, row_bytes]
    int* __restrict__ out,             // [num_q, n_blocks]
    int n_rows, int num_q, int row_bytes, int n_qt, int n_blocks) {
  __shared__ __align__(16) uint8_t x_s[2][kK3Rows][kK3Stride];
  __shared__ __align__(16) uint8_t q_s[2][kK3Queries][kK3Stride];
  __shared__ int red_s[4][kK3Queries];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp & 3;   // 32-row slice of the block
  const int wc = warp >> 2;  // 64-query half of the tile
  const int g = lane >> 2;   // mma fragment group
  const int tig = lane & 3;  // thread in group
  const int blk = blockIdx.x / n_qt;
  const int64_t row0 = static_cast<int64_t>(blk) * kK3Rows;
  const int q0 = (blockIdx.x % n_qt) * kK3Queries;
  const int n_chunks = (row_bytes + kK3ChunkBytes - 1) / kK3ChunkBytes;

  auto stage = [&](int chunk, int buf) {
    const int c0 = chunk * kK3ChunkBytes;
#pragma unroll
    for (int i = 0; i < kK3Rows * kK3Segs / kK3Threads; ++i) {
      const int e = tid + i * kK3Threads;
      const int r = e / kK3Segs;
      const int off = c0 + (e % kK3Segs) * 16;
      const bool in = off < row_bytes && row0 + r < n_rows;
      cp_async16(&x_s[buf][r][(e % kK3Segs) * 16],
                 in ? data + (row0 + r) * row_bytes + off : data, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kK3Queries * kK3Segs / kK3Threads; ++i) {
      const int e = tid + i * kK3Threads;
      const int r = e / kK3Segs;
      const int off = c0 + (e % kK3Segs) * 16;
      const bool in = off < row_bytes && q0 + r < num_q;
      cp_async16(&q_s[buf][r][(e % kK3Segs) * 16],
                 in ? q + static_cast<int64_t>(q0 + r) * row_bytes + off : q,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;

  stage(0, 0);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int buf = chunk & 1;
    if (chunk + 1 < n_chunks) {
      stage(chunk + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // two mma k-steps of 32 int8 lanes (m16n8k32)
#pragma unroll
    for (int ks = 0; ks < kK3ChunkBytes; ks += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wr * 32 + mt * 16 + g;
        a[mt][0] = ld32(&x_s[buf][r][ks + tig * 4]);
        a[mt][1] = ld32(&x_s[buf][r + 8][ks + tig * 4]);
        a[mt][2] = ld32(&x_s[buf][r][ks + 16 + tig * 4]);
        a[mt][3] = ld32(&x_s[buf][r + 8][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int nq = wc * 64 + nt * 8 + g;
        const uint32_t b0 = ld32(&q_s[buf][nq][ks + tig * 4]);
        const uint32_t b1 = ld32(&q_s[buf][nq][ks + 16 + tig * 4]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();  // the buffer is refilled two chunks later
  }

  // tail rows score as padding rows; lane-pack the row-in-block. The
  // accumulator c of tile (mt, nt) is row 32*wr + 16*mt + g + 8*(c/2),
  // query 64*wc + 8*nt + 2*tig + c%2.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = wr * 32 + mt * 16 + g + ((c & 2) ? 8 : 0);
        if (row0 + row >= n_rows) tail_score(acc[mt][nt][c]);
        acc[mt][nt][c] = pack_lane(acc[mt][nt][c], row);
      }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = min(min(acc[0][nt][h], acc[0][nt][h + 2]),
                  min(acc[1][nt][h], acc[1][nt][h + 2]));
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (g == 0) red_s[wr][wc * 64 + nt * 8 + tig * 2 + h] = v;
    }
  __syncthreads();
  if (tid < kK3Queries) {
    const int qi = q0 + tid;
    if (qi < num_q)
      out[static_cast<int64_t>(qi) * n_blocks + blk] =
          min(min(red_s[0][tid], red_s[1][tid]), min(red_s[2][tid], red_s[3][tid]));
  }
}

int launch_i8(const void* data, const void* q, void* out, int n_rows, int num_q,
              int row_bytes, void* stream) {
  if (n_rows <= 0 || num_q <= 0 || row_bytes <= 0 || row_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (n_rows + kK3Rows - 1) / kK3Rows;
  const int n_qt = (num_q + kK3Queries - 1) / kK3Queries;
  const int64_t grid = static_cast<int64_t>(n_blocks) * n_qt;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  dense_i8_kernel<<<static_cast<unsigned>(grid), kK3Threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint8_t*>(q),
      static_cast<int*>(out), n_rows, num_q, row_bytes, n_qt, n_blocks);
  return static_cast<int>(cudaGetLastError());
}


// ---- K2: bf16 rows on wgmma -------------------------------------------------

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kK2Threads = kConsumers + 128;  // + one producer warpgroup
constexpr int kMaxStages = 6;

// MT: m64 query tiles per consumer warpgroup, so a block's query tile is
// 128 * MT queries. Shared memory (1024-byte aligned): the resident query
// tile as nch [qt][64] chunks (absent when stream_q), then nst ring stages
// of one [128][64] row chunk (+ the matching [qt][64] query chunk when
// stream_q), then the barriers.
template <int MT>
__global__ void __launch_bounds__(kK2Threads, 1) dense_bf16_kernel(
    const __grid_constant__ CUtensorMap xmap,  // rows [n_rows][dp] bf16
    const __grid_constant__ CUtensorMap qmap,  // queries [num_q][dp] bf16
    float* __restrict__ out,                   // [num_q, n_blocks]
    int n_rows, int num_q, int nch, int n_blocks, int n_qt, int nst, int stream_q) {
  using namespace hopper;
  constexpr int kQt = 128 * MT;
  constexpr int kQChunk = kQt * 128;  // bytes of one [qt][64] query chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = kChunkBytes + (stream_q ? kQChunk : 0);
  uint8_t* q_res = smem;
  uint8_t* ring = smem + (stream_q ? 0 : nch * kQChunk);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nst * stage_bytes);
  uint64_t* empty = full + nst;
  uint64_t* q_full = empty + nst;

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
          tma_load_2d(q_res + c * kQChunk, &qmap, q_full, c * kChunk, q0);
      }
      int it = 0;
      for (int blk = b0; blk < b1; ++blk)
        for (int c = 0; c < nch; ++c, ++it) {
          const int st = it % nst;
          mbar_wait(&empty[st], ((it / nst) & 1) ^ 1);
          uint8_t* stage = ring + st * stage_bytes;
          mbar_expect_tx(&full[st], stage_bytes);
          tma_load_2d(stage, &xmap, &full[st], c * kChunk, blk * kRows);
          if (stream_q)
            tma_load_2d(stage + kChunkBytes, &qmap, &full[st], c * kChunk, q0);
        }
    }
  } else {
    // consumers: warpgroup wg scores queries q0 + 64 * (wg * MT + t) + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    if (!stream_q) mbar_wait(q_full, 0);
    float acc[MT][64];
    int it = 0;
    for (int blk = b0; blk < b1; ++blk) {
      // chunk c's wgmma group is issued before chunk c-1's stage is
      // freed; chunk 0 overwrites the accumulators
      auto mma_chunk = [&](int c) {
        const int st = it % nst;
        mbar_wait(&full[st], (it / nst) & 1);
        const uint8_t* stage = ring + st * stage_bytes;
        const uint8_t* qa = stream_q ? stage + kChunkBytes : q_res + c * kQChunk;
        const uint64_t desc_b = sw128_desc(stage);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // lanes past Dp are zero in both operands
#pragma unroll
          for (int t = 0; t < MT; ++t)
            wgmma_m64n128k16(acc[t], sw128_desc(qa + (wg * MT + t) * 64 * 128) + 2 * kk,
                             desc_b + 2 * kk, (c | kk) != 0);
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

      const int n_valid = n_rows - blk * kRows;  // < 128 only in the last block
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        fence_regs(acc[t]);
        if (n_valid < kRows) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (acc_row(j, c & 1, lane) >= n_valid)
                acc[t][4 * j + c] = __int_as_float(0x7F620000);
        }
        pack_rows(acc[t], lane);
        const float v0 = block_min<0>(acc[t], lane);
        const float v1 = block_min<1>(acc[t], lane);
        const int q = q0 + (wg * MT + t) * 64 + warp * 16 + (lane >> 2);
        if ((lane & 3) == 0 && q < num_q) out[static_cast<int64_t>(q) * n_blocks + blk] = v0;
        if ((lane & 3) == 1 && q + 8 < num_q)
          out[static_cast<int64_t>(q + 8) * n_blocks + blk] = v1;
      }
    }
  }
}

template <int MT>
int launch_bf16(const void* data, const void* q, float* out, int n_rows, int num_q,
                int dp, int nst, int stream_q, int smem, cudaStream_t stream) {
  using namespace hopper;
  const int n_blocks = (n_rows + kRows - 1) / kRows;
  const int n_qt = (num_q + 128 * MT - 1) / (128 * MT);
  const int sms = num_sms();
  if (sms <= 0) return static_cast<int>(cudaErrorNoDevice);
  const int groups = std::max(1, std::min(n_blocks, sms / n_qt));
  const int64_t grid = static_cast<int64_t>(n_qt) * groups;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, qmap;
  if (!bf16_map(&xmap, data, dp, n_rows, static_cast<uint64_t>(dp) * 2, kRows) ||
      !bf16_map(&qmap, q, dp, num_q, static_cast<uint64_t>(dp) * 2, 128 * MT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dense_bf16_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_bf16_kernel<MT><<<static_cast<unsigned>(grid), kK2Threads, smem, stream>>>(
      xmap, qmap, out, n_rows, num_q, (dp + kChunk - 1) / kChunk, n_blocks,
      n_qt, nst, stream_q);
  return static_cast<int>(cudaGetLastError());
}

// K2's shared-memory plan: the deepest query tile that stays resident
// beside a ring of at least two row chunks, else query chunks streamed
// beside the row chunks.
int dense_bf16(const void* data, const void* q, void* out, int n_rows, int num_q,
               int dp, cudaStream_t stream) {
  using namespace hopper;
  if (n_rows <= 0 || num_q <= 0 || dp <= 0 || dp % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = (dp + kChunk - 1) / kChunk;
  const int room = kSmemLimit - 1024 - (2 * kMaxStages + 1) * 8;
  float* o = static_cast<float*>(out);
  for (int mt = 2; mt >= 1; --mt) {
    const int resident = nch * 128 * mt * 128;
    const int nst = std::min(kMaxStages, (room - resident) / kChunkBytes);
    if (nst < 2) continue;
    const int smem = 1024 + resident + nst * kChunkBytes + (2 * nst + 1) * 8;
    return mt == 2 ? launch_bf16<2>(data, q, o, n_rows, num_q, dp, nst, 0, smem, stream)
                   : launch_bf16<1>(data, q, o, n_rows, num_q, dp, nst, 0, smem, stream);
  }
  const int stage = kChunkBytes + 256 * 128;
  const int nst = std::min(kMaxStages, room / stage);
  const int smem = 1024 + nst * stage + (2 * nst + 1) * 8;
  return launch_bf16<2>(data, q, o, n_rows, num_q, dp, nst, 1, smem, stream);
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t (0 =
// launched). Shapes, dtypes and 16-byte alignment are checked by the
// Python wrapper; this re-checks what would make the launch read or
// write out of bounds.
extern "C" int gulon_dense_scan_bf16(const void* data, const void* q, void* out,
                                     int n_rows, int num_q, int dp, void* stream) {
  return dense_bf16(data, q, out, n_rows, num_q, dp, static_cast<cudaStream_t>(stream));
}

extern "C" int gulon_dense_scan_i8(const void* data, const void* q, void* out,
                                   int n_rows, int num_q, int dp, void* stream) {
  if (dp % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_i8(data, q, out, n_rows, num_q, dp, stream);
}
