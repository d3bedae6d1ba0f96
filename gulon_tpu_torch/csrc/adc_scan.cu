// Fused ADC scan for Hopper (sm_90a): PQ decode + distances + per-block
// lane-packed minimum, in one pass over the codes.
//
// Replaces the TPU kernel gulon_tpu/ops/pallas/adc.py::_adc_fused_kernel
// (helpers _decode_columns and _block_select). The contract is the TPU
// kernel's, the layout is not: the TPU decodes with a transposed one-hot
// matmul because it has no fast vector gather; here each thread block
// gathers its codewords straight from the (L1-resident) bf16 codebooks.
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
// At the glove100 shape (m*dsub = 104, batch 1024) that is ~2*108*1024
// flop per 8 code bytes, far above the ~295 flop/byte ridge: the scan is
// compute-bound, so the contraction runs on the bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulation). Every operand is exactly bf16
// (codewords are bf16-snapped, norms are hi/lo bf16 pairs, queries are
// the bf16 operand), so the tensor cores compute the contract's sum. What
// is left is the decode gather and the selection; a first version ran
// the same contraction as f32 FMAs on the CUDA cores at 4.4 ms a batch.
//
// Block: 256 threads (8 warps) own 128 rows x 128 queries; warp w holds
// rows 32*(w%4) .. +31 and queries 64*(w/4) .. +63 as 2 x 8 mma tiles of
// f32 accumulators in registers. The contraction walks depth in chunks
// of 32: each chunk's codewords are gathered into shared memory as bf16
// [row][depth] and the queries' chunk as bf16 [query][depth] (rows padded
// to 40 elements, so fragment loads hit 32 distinct banks). Selection:
// a register min over each thread's 4 rows of a query, 3 xor-shuffles
// across the warp's 32 rows, and a 4-way shared-memory step across the
// warps that share the query.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see gulon_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;     // one selection block
constexpr int kQueries = 128;  // query tile of one thread block
constexpr int kThreads = 256;
constexpr int kDepth = 32;     // contraction chunk staged in shared memory
constexpr int kStride = kDepth + 8;  // bf16 elements per shared-memory row
constexpr float kBig = 3.0e38f;
constexpr uint16_t kOneBf16 = 0x3F80;

template <typename CodeT>
__device__ __forceinline__ int load_code(const CodeT* p) {
  return static_cast<int>(__ldg(p));
}

// K <= 256 codes are stored offset-encoded as int8 (code - 128)
template <>
__device__ __forceinline__ int load_code<int8_t>(const int8_t* p) {
  return static_cast<int>(__ldg(p)) + 128;
}

// jnp.min semantics: a NaN operand wins
__device__ __forceinline__ float min_keep_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x16 bf16, row-major) * B(16x8 bf16, col-major), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename CodeT, int W>
__global__ void __launch_bounds__(kThreads, 2) adc_scan_kernel(
    const CodeT* __restrict__ codes,     // [m, n_cols]
    const uint16_t* __restrict__ norms,  // [2, n_cols] bf16 hi/lo
    const uint16_t* __restrict__ q,      // [num_q, q_stride] bf16
    const uint16_t* __restrict__ cb,     // [m, k_codes, dsub] bf16
    float* __restrict__ out,             // [num_q, n_win]
    int n_cols, int num_q, int q_stride, int depth, int m, int k_codes,
    int dsub, int nblk, int n_win) {
  __shared__ __align__(16) uint16_t dec_s[kRows][kStride];
  __shared__ __align__(16) uint16_t q_s[kQueries][kStride];
  __shared__ int seg_s[kDepth];  // subspace, or -1/-2 norm hi/lo, -3/-4 ones, -5 past the end
  __shared__ int off_s[kDepth];  // codebook offset of (subspace, dim)
  __shared__ float red_s[4][kQueries];
  __shared__ float fin_s[kQueries];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp & 3;   // 32-row slice of the block
  const int wc = warp >> 2;  // 64-query half of the tile
  const int g = lane >> 2;   // mma fragment group
  const int tig = lane & 3;  // thread in group
  const int blk = blockIdx.x;
  const int64_t row0 = static_cast<int64_t>(blk) * kRows;
  const int q0 = blockIdx.y * kQueries;
  const int md = m * dsub;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;

  for (int c0 = 0; c0 < depth; c0 += kDepth) {
    if (tid < kDepth) {
      const int d = c0 + tid;
      int seg = -5, off = 0;
      if (d < md) {
        seg = d / dsub;
        off = seg * k_codes * dsub + (d - seg * dsub);
      } else if (d < depth) {
        seg = -1 - (d - md);
      }
      seg_s[tid] = seg;
      off_s[tid] = off;
    }
    __syncthreads();
    // gather the chunk: dec_s[r][dl] = bf16 value of depth row c0+dl, row r
    for (int e = tid; e < kDepth * kRows; e += kThreads) {
      const int dl = e / kRows;
      const int r = e % kRows;
      const int seg = seg_s[dl];
      uint16_t v = 0;
      if (seg >= 0) {
        const int code = load_code(codes + static_cast<int64_t>(seg) * n_cols + row0 + r);
        if (static_cast<unsigned>(code) < static_cast<unsigned>(k_codes))
          v = __ldg(cb + off_s[dl] + code * dsub);
      } else if (seg >= -2) {
        v = __ldg(norms + static_cast<int64_t>(-1 - seg) * n_cols + row0 + r);
      } else if (seg >= -4) {
        v = kOneBf16;
      }
      dec_s[r][dl] = v;
    }
    for (int e = tid; e < kDepth * kQueries; e += kThreads) {
      const int qq = e / kDepth;
      const int dl = e % kDepth;
      const int d = c0 + dl;
      const int qi = q0 + qq;
      q_s[qq][dl] = (d < depth && qi < num_q)
                        ? __ldg(q + static_cast<int64_t>(qi) * q_stride + d)
                        : static_cast<uint16_t>(0);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kDepth; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wr * 32 + mt * 16 + g;
        a[mt][0] = ld_pair(&dec_s[r][ks + tig * 2]);
        a[mt][1] = ld_pair(&dec_s[r + 8][ks + tig * 2]);
        a[mt][2] = ld_pair(&dec_s[r][ks + 8 + tig * 2]);
        a[mt][3] = ld_pair(&dec_s[r + 8][ks + 8 + tig * 2]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = wc * 64 + nt * 8 + g;
        const uint32_t b0 = ld_pair(&q_s[n][ks + tig * 2]);
        const uint32_t b1 = ld_pair(&q_s[n][ks + 8 + tig * 2]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

  // lane-pack the row-in-block into the 7 low mantissa bits; accumulator
  // c of tile (mt, nt) is row 32*wr + 16*mt + g + 8*(c/2), query
  // 64*wc + 8*nt + 2*tig + c%2
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = wr * 32 + mt * 16 + g + ((c & 2) ? 8 : 0);
        acc[mt][nt][c] = __int_as_float((__float_as_int(acc[mt][nt][c]) & ~127) | row);
      }

  const int col0 = (blk / nblk) * W * nblk + (blk % nblk);
#pragma unroll
  for (int w = 0; w < W; ++w) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = min_keep_nan(min_keep_nan(acc[0][nt][h], acc[0][nt][h + 2]),
                               min_keep_nan(acc[1][nt][h], acc[1][nt][h + 2]));
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          v = min_keep_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (g == 0) red_s[wr][wc * 64 + nt * 8 + tig * 2 + h] = v;
      }
    __syncthreads();
    if (tid < kQueries) {
      const float v = min_keep_nan(min_keep_nan(red_s[0][tid], red_s[1][tid]),
                                   min_keep_nan(red_s[2][tid], red_s[3][tid]));
      fin_s[tid] = v;
      const int qi = q0 + tid;
      if (qi < num_q) out[static_cast<int64_t>(qi) * n_win + col0 + w * nblk] = v;
    }
    __syncthreads();
    if (w + 1 < W) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = fin_s[wc * 64 + nt * 8 + tig * 2 + (c & 1)];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (acc[mt][nt][c] == v) acc[mt][nt][c] = kBig;
        }
    }
  }
}

template <typename CodeT>
cudaError_t launch(const void* codes, const void* norms, const void* q,
                   const void* cb, void* out, int n_cols, int num_q,
                   int q_stride, int depth, int m, int k_codes, int dsub,
                   int winners, int nblk, cudaStream_t stream) {
  const dim3 grid(n_cols / kRows, (num_q + kQueries - 1) / kQueries);
  const int n_win = (n_cols / kRows) * winners;
  const CodeT* c = static_cast<const CodeT*>(codes);
  const uint16_t* nr = static_cast<const uint16_t*>(norms);
  const uint16_t* qq = static_cast<const uint16_t*>(q);
  const uint16_t* b = static_cast<const uint16_t*>(cb);
  float* o = static_cast<float*>(out);
#define GULON_ADC_LAUNCH(WW)                                                 \
  adc_scan_kernel<CodeT, WW><<<grid, kThreads, 0, stream>>>(               \
      c, nr, qq, b, o, n_cols, num_q, q_stride, depth, m, k_codes, dsub,   \
      nblk, n_win)
  switch (winners) {
    case 1: GULON_ADC_LAUNCH(1); break;
    case 2: GULON_ADC_LAUNCH(2); break;
    case 3: GULON_ADC_LAUNCH(3); break;
    case 4: GULON_ADC_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef GULON_ADC_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
// Shapes are checked by the Python wrapper; this re-checks what would
// make the launch read or write out of bounds.
extern "C" int gulon_adc_scan(const void* codes, int code_bytes,
                              const void* norms, const void* q,
                              const void* cb, void* out, int n_cols,
                              int num_q, int q_stride, int depth, int m,
                              int k_codes, int dsub, int winners, int nblk,
                              void* stream) {
  if (n_cols <= 0 || n_cols % kRows != 0 || num_q <= 0 || nblk <= 0 ||
      (n_cols / kRows) % nblk != 0 || depth != m * dsub + 4 ||
      q_stride < depth)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (code_bytes) {
    case 1: return static_cast<int>(launch<int8_t>(codes, norms, q, cb, out, n_cols, num_q, q_stride, depth, m, k_codes, dsub, winners, nblk, s));
    case 2: return static_cast<int>(launch<int16_t>(codes, norms, q, cb, out, n_cols, num_q, q_stride, depth, m, k_codes, dsub, winners, nblk, s));
    case 4: return static_cast<int>(launch<int32_t>(codes, norms, q, cb, out, n_cols, num_q, q_stride, depth, m, k_codes, dsub, winners, nblk, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
