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
// What bounds it on an H100: at the fasttext shape (2M x 300, Dp 304,
// 1024 queries) a batch is 2*2M*1024*304 = 1.25 TFLOP over 1.2 GB of bf16
// rows, ~1,000 flop per byte, far above the ~295 flop/byte ridge: the
// contraction bounds it, so it runs on the tensor cores
// (mma.sync m16n8k16 bf16 / m16n8k32 s8, f32 / s32 accumulation).
//
// Block: 256 threads (8 warps) own 128 rows x 128 queries; warp w holds
// rows 32*(w%4) .. +31 and queries 64*(w/4) .. +63 as 2 x 8 mma tiles of
// accumulators in registers. The contraction walks the row in 64-byte
// chunks (32 bf16 or 64 int8 lanes), double-buffered in shared memory by
// cp.async 16-byte copies (rows padded to 80 bytes, so fragment loads
// hit 32 distinct banks; segments past Dp and rows past the end are
// zero-filled). Both element types read their mma fragments at the same
// byte offsets, so one template serves K2 and K3. Blocks are numbered
// query tile fastest, so the query tiles of one row block run together
// and re-read its rows from L2, not from HBM. Selection: a register min
// over each thread's 4 rows of a query, 3 xor-shuffles across the warp's
// 32 rows, and a 4-way shared-memory step across the warps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see gulon_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;      // one selection block
constexpr int kQueries = 128;   // query tile of one thread block
constexpr int kThreads = 256;
constexpr int kChunk = 64;      // bytes of a row staged per step
constexpr int kStride = kChunk + 16;  // bytes per shared-memory row
constexpr int kSegs = kChunk / 16;    // 16-byte copies per row and chunk

__device__ __forceinline__ float min_keep_nan(float a, float b) {
  return (a < b || a != a) ? a : b;  // jnp.min semantics: a NaN wins
}
__device__ __forceinline__ int min_keep_nan(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float pack_lane(float v, int row) {
  return __int_as_float((__float_as_int(v) & ~127) | row);
}
__device__ __forceinline__ int pack_lane(int v, int row) { return (v & ~127) | row; }

__device__ __forceinline__ void tail_score(float& v) { v = __int_as_float(0x7F620000); }
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

// Acc = float: K2 over bf16 lanes; Acc = int: K3 over int8 lanes.
template <typename Acc>
__global__ void __launch_bounds__(kThreads, 2) dense_scan_kernel(
    const uint8_t* __restrict__ data,  // [n_rows, row_bytes]
    const uint8_t* __restrict__ q,     // [num_q, row_bytes]
    Acc* __restrict__ out,             // [num_q, n_blocks]
    int n_rows, int num_q, int row_bytes, int n_qt, int n_blocks) {
  __shared__ __align__(16) uint8_t x_s[2][kRows][kStride];
  __shared__ __align__(16) uint8_t q_s[2][kQueries][kStride];
  __shared__ Acc red_s[4][kQueries];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp & 3;   // 32-row slice of the block
  const int wc = warp >> 2;  // 64-query half of the tile
  const int g = lane >> 2;   // mma fragment group
  const int tig = lane & 3;  // thread in group
  const int blk = blockIdx.x / n_qt;
  const int64_t row0 = static_cast<int64_t>(blk) * kRows;
  const int q0 = (blockIdx.x % n_qt) * kQueries;
  const int n_chunks = (row_bytes + kChunk - 1) / kChunk;

  auto stage = [&](int chunk, int buf) {
    const int c0 = chunk * kChunk;
#pragma unroll
    for (int i = 0; i < kRows * kSegs / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kSegs;
      const int off = c0 + (e % kSegs) * 16;
      const bool in = off < row_bytes && row0 + r < n_rows;
      cp_async16(&x_s[buf][r][(e % kSegs) * 16],
                 in ? data + (row0 + r) * row_bytes + off : data, in ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < kQueries * kSegs / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kSegs;
      const int off = c0 + (e % kSegs) * 16;
      const bool in = off < row_bytes && q0 + r < num_q;
      cp_async16(&q_s[buf][r][(e % kSegs) * 16],
                 in ? q + static_cast<int64_t>(q0 + r) * row_bytes + off : q,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };

  Acc acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = Acc(0);

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
    // two mma k-steps of 32 bytes: 16 bf16 lanes (m16n8k16) or 32 int8
    // lanes (m16n8k32); both read a/b fragments at the same byte offsets
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 32) {
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
      Acc v = min_keep_nan(min_keep_nan(acc[0][nt][h], acc[0][nt][h + 2]),
                           min_keep_nan(acc[1][nt][h], acc[1][nt][h + 2]));
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        v = min_keep_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (g == 0) red_s[wr][wc * 64 + nt * 8 + tig * 2 + h] = v;
    }
  __syncthreads();
  if (tid < kQueries) {
    const int qi = q0 + tid;
    if (qi < num_q)
      out[static_cast<int64_t>(qi) * n_blocks + blk] =
          min_keep_nan(min_keep_nan(red_s[0][tid], red_s[1][tid]),
                       min_keep_nan(red_s[2][tid], red_s[3][tid]));
  }
}

template <typename Acc>
int launch(const void* data, const void* q, void* out, int n_rows, int num_q,
           int row_bytes, void* stream) {
  if (n_rows <= 0 || num_q <= 0 || row_bytes <= 0 || row_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (n_rows + kRows - 1) / kRows;
  const int n_qt = (num_q + kQueries - 1) / kQueries;
  const int64_t grid = static_cast<int64_t>(n_blocks) * n_qt;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  dense_scan_kernel<Acc><<<static_cast<unsigned>(grid), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint8_t*>(q),
      static_cast<Acc*>(out), n_rows, num_q, row_bytes, n_qt, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t (0 =
// launched). Shapes, dtypes and 16-byte alignment are checked by the
// Python wrapper; this re-checks what would make the launch read or
// write out of bounds.
extern "C" int gulon_dense_scan_bf16(const void* data, const void* q, void* out,
                                     int n_rows, int num_q, int dp, void* stream) {
  if (dp % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(data, q, out, n_rows, num_q, dp * 2, stream);
}

extern "C" int gulon_dense_scan_i8(const void* data, const void* q, void* out,
                                   int n_rows, int num_q, int dp, void* stream) {
  if (dp % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<int>(data, q, out, n_rows, num_q, dp, stream);
}
