// IVF winner selection for Hopper (sm_90a): the `fetch` smallest of K1's
// block winners over the columns of each query's probed partitions.
//
// Replaces no TPU kernel. The JAX package's IVF `pallas` epilogue
// (gulon_tpu/models/ivf.py) masks every winner column of K1's output
// with the probe and ranks them with lax.top_k under XLA; the port did
// the same with a stable torch.sort over all [Q, NW] columns, about 95 %
// of them unprobed and set to +inf first (at 9.99M rows, 9,990
// partitions and probe 499: 340M keys a batch, two segmented radix sorts
// and half a dozen elementwise passes, 32 ms a batch). This kernel reads
// only what the probe keeps.
//
// Contract, per query q (models/ivf.py::_pallas_ivf_query and its plain
// twin ops/cuda/ivf_topk.py::_select_plain):
//   - partition p owns the 128-row blocks [b0, b1) of the partition-padded
//     layout (ranges[p]); blocks past `real_blocks` (padding) belong to
//     blk_part[min(b, nbp - 1)], as the masked sort clamped them;
//   - winner w of block b sits in column (b / nblk) * W * nblk + w * nblk
//     + b % nblk of K1's packed output;
//   - the column of a probed partition is valid iff v = bits & ~127 (as
//     f32) is < 1e38; its key is (v + group_term[q, p]) + qn[q] in f32,
//     in that order, +inf where invalid;
//   - the keys rank on (key, column): NaN (either sign) after +inf, -0.0
//     equal to +0.0, equal keys by the lower column -- the order of a
//     stable torch.sort over every column (on the card the sort ranks
//     NaNs by their bits, but the card's arithmetic gives every NaN key
//     the same canonical bits, and no key is -0.0: qn[q] is a sum of
//     squares);
//   - the U = NW - (probed columns) unprobed columns are +inf, so the
//     output is the probed order's non-NaN part, then U times (+inf, -1),
//     then its NaN part, cut to `fetch`. Values are recomputed from the
//     column at the end, so a NaN keeps the bits the arithmetic gave it.
//
// What bounds it on an H100: the bytes it must read, about 4 B a probed
// column plus the query's mask row and group terms: 16.6K columns a query
// at 9,990 partitions and probe 499, about 80 MB a 1,024-query batch,
// 0.024 ms at 3.35 TB/s. The columns of one partition are W runs of
// (b1 - b0) consecutive floats per row tile, so the reads come in 32-byte
// sectors that are mostly used.
//
// Design: one block of 256 threads a query. The mask row is read 1,024
// partitions at a time (4 a thread); a block-wide scan of the probed
// partitions' column counts maps element e of the chunk to its partition
// by a binary search in shared memory, so every thread reads a column
// whatever the partitions' sizes. Each thread reads 4 columns a round and
// keeps a column whose 64-bit (order key, column) beats the running
// threshold, appending it to a candidate buffer; when fewer than a
// round's worth of slots are left, the block sorts the buffer (bitonic),
// keeps the `fetch` best and takes the last one as the threshold. After
// the first such sort almost nothing passes, so a query costs about one
// sort of the buffer and one small final sort. The buffer holds
// next_pow2(fetch + 1024) keys: in shared memory up to 8,192 (64 KB); a
// larger `fetch` takes the same code with the buffer in a global scratch
// slice of that size (gulon_ivf_topk_plan says which).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                  // columns a thread reads a round
constexpr int kRound = kThreads * kPer;  // columns a round
constexpr int kChunk = kThreads * 4;     // partitions (or tail blocks) a chunk
constexpr int kSharedCap = 8192;         // candidate keys held in shared memory
constexpr float kInvalidMin = 1.0e38f;
constexpr unsigned long long kEmpty = ~0ull;
constexpr unsigned kNanKey = 0xFFFFFFFFu;

struct Params {
  const float* packed;       // [Q, nw] K1's lane-packed winners
  const float* group_term;   // [Q, num_p]
  const float* qn;           // [Q]
  const uint8_t* mask;       // [Q, num_p] bool
  const int* ranges;         // [num_p, 2] block range of each partition
  const long long* blk_part; // [nbp] partition of each layout block
  float* best;               // [Q, fetch]
  int* cols;                 // [Q, fetch]
  unsigned long long* scratch;  // [Q, cap] in the global mode, else null
  int num_p, nw, winners, nblk, fetch, real_blocks, nbp, cap;
};

__host__ __device__ inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__device__ __forceinline__ float winner_key(unsigned bits, float g, float qn) {
  const float v = __uint_as_float(bits & ~127u);
  return v < kInvalidMin ? __fadd_rn(__fadd_rn(v, g), qn) : __int_as_float(0x7f800000);
}

// An unsigned key that orders as a stable torch.sort orders floats.
__device__ __forceinline__ unsigned order_key(float f) {
  if (f != f) return kNanKey;
  if (f == 0.0f) return 0x80000000u;
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ int column_of(int b, int w, int winners, int nblk) {
  return (b / nblk) * winners * nblk + w * nblk + b % nblk;
}

// Sorts buf[0, n2) ascending; n2 a power of two. Ends on a barrier.
__device__ void bitonic_sort(unsigned long long* buf, int n2) {
  for (int k = 2; k <= n2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n2; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = buf[i], b = buf[ixj];
          if ((a > b) == ((i & k) == 0)) {
            buf[i] = b;
            buf[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
}

// Sorts the n candidates (n uniform across the block, all written and
// visible) and pads the sorted run to a power of two with kEmpty.
__device__ void sort_candidates(unsigned long long* buf, int n) {
  const int n2 = next_pow2(n > 1 ? n : 1);
  for (int i = n + threadIdx.x; i < n2; i += kThreads) buf[i] = kEmpty;
  __syncthreads();
  bitonic_sort(buf, n2);
}

// Block-wide exclusive scan of one int a thread; *total gets the sum.
__device__ int exclusive_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += warp_sums[w];
    sum += warp_sums[w];
  }
  __syncthreads();  // warp_sums is reused by the next scan
  *total = sum;
  return before + incl - x;
}

__global__ void __launch_bounds__(kThreads) ivf_topk_kernel(Params p) {
  extern __shared__ unsigned long long dyn[];
  __shared__ int s_end[kChunk];  // inclusive end of each slot's columns in the chunk
  __shared__ int s_b0[kChunk];
  __shared__ int s_nb[kChunk];
  __shared__ float s_g[kChunk];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_count;

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  unsigned long long* buf = p.scratch ? p.scratch + static_cast<size_t>(q) * p.cap : dyn;
  const float* packed = p.packed + static_cast<size_t>(q) * p.nw;
  const float* gt = p.group_term + static_cast<size_t>(q) * p.num_p;
  const uint8_t* mask = p.mask + static_cast<size_t>(q) * p.num_p;
  const float qn = p.qn[q];
  const int nbc = p.nw / p.winners;  // blocks K1's columns cover
  const int tail = nbc - p.real_blocks;
  const int chunks_p = (p.num_p + kChunk - 1) / kChunk;
  const int chunks = chunks_p + (tail + kChunk - 1) / kChunk;

  if (tid == 0) s_count = 0;
  unsigned long long thresh = kEmpty;
  long long probed_cols = 0;  // uniform

  for (int c = 0; c < chunks; ++c) {
    // Slots of this chunk: partitions c * kChunk + s, or, past them,
    // padding blocks real_blocks + (c - chunks_p) * kChunk + s.
    int cnt = 0;
    for (int i = 0; i < 4; ++i) {
      const int s = tid * 4 + i;
      int part = -1, b0 = 0, nb = 0;
      if (c < chunks_p) {
        const int pp = c * kChunk + s;
        if (pp < p.num_p && mask[pp]) {
          part = pp;
          b0 = p.ranges[2 * pp];
          nb = p.ranges[2 * pp + 1] - b0;
        }
      } else {
        const int b = p.real_blocks + (c - chunks_p) * kChunk + s;
        const int pp = b < nbc ? static_cast<int>(p.blk_part[b < p.nbp ? b : p.nbp - 1]) : 0;
        if (b < nbc && mask[pp]) {
          part = pp;
          b0 = b;
          nb = 1;
        }
      }
      s_b0[s] = b0;
      s_nb[s] = nb;
      s_g[s] = nb > 0 ? gt[part] : 0.0f;
      cnt += nb * p.winners;
    }
    int total;
    int end = exclusive_scan(cnt, s_warp, &total);
    for (int i = 0; i < 4; ++i) {
      end += s_nb[tid * 4 + i] * p.winners;
      s_end[tid * 4 + i] = end;
    }
    probed_cols += total;
    __syncthreads();

    for (int e0 = 0; e0 < total; e0 += kRound) {
      unsigned bits[kPer];
      int col[kPer];
      float g[kPer];
      for (int i = 0; i < kPer; ++i) {
        const int e = e0 + i * kThreads + tid;
        col[i] = -1;
        if (e < total) {
          int lo = 0, hi = kChunk - 1;  // the first slot whose end passes e
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_end[mid] > e) hi = mid; else lo = mid + 1;
          }
          const int nb = s_nb[lo];
          const int local = e - (s_end[lo] - nb * p.winners);
          const int w = local / nb;
          col[i] = column_of(s_b0[lo] + local - w * nb, w, p.winners, p.nblk);
          g[i] = s_g[lo];
        }
      }
      for (int i = 0; i < kPer; ++i)
        bits[i] = col[i] >= 0 ? __float_as_uint(__ldg(packed + col[i])) : 0u;
      for (int i = 0; i < kPer; ++i) {
        if (col[i] < 0) continue;
        const unsigned long long key =
            (static_cast<unsigned long long>(order_key(winner_key(bits[i], g[i], qn))) << 32) |
            static_cast<unsigned>(col[i]);
        if (key < thresh) buf[atomicAdd(&s_count, 1)] = key;
      }
      __syncthreads();
      const int n = s_count;
      __syncthreads();  // every thread has read s_count
      if (n > p.cap - kRound) {
        sort_candidates(buf, n);
        const int keep = n < p.fetch ? n : p.fetch;
        thresh = n >= p.fetch ? buf[p.fetch - 1] : kEmpty;
        if (tid == 0) s_count = keep;
        __syncthreads();
      }
    }
  }

  const int n = s_count;
  sort_candidates(buf, n);
  const int len = n < p.fetch ? n : p.fetch;
  int lo = 0, hi = len;  // non-NaN keys come first
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<unsigned>(buf[mid] >> 32) != kNanKey) lo = mid + 1; else hi = mid;
  }
  const int n_lo = lo;
  const long long unprobed = static_cast<long long>(p.nw) - probed_cols;
  float* best = p.best + static_cast<size_t>(q) * p.fetch;
  int* cols = p.cols + static_cast<size_t>(q) * p.fetch;
  for (int i = tid; i < p.fetch; i += kThreads) {
    long long src = i;
    if (i >= n_lo) src = i < n_lo + unprobed ? -1 : i - unprobed;
    if (src < 0 || src >= len) {
      best[i] = __int_as_float(0x7f800000);
      cols[i] = -1;
      continue;
    }
    const int col = static_cast<int>(buf[src] & 0xffffffffu);
    const int tile = col / (p.winners * p.nblk);
    const int r = col - tile * p.winners * p.nblk;
    const int b = tile * p.nblk + r % p.nblk;
    const int part = static_cast<int>(p.blk_part[b < p.nbp ? b : p.nbp - 1]);
    best[i] = winner_key(__float_as_uint(packed[col]), gt[part], qn);
    cols[i] = col;
  }
}

// The candidate buffer of a launch at this fetch: its capacity in keys,
// and 1 where it lives in shared memory (0: a global scratch slice of
// `cap` keys a query, which the caller allocates).
void plan(int fetch, int* cap, int* shared) {
  *cap = next_pow2(fetch + kRound);
  *shared = *cap <= kSharedCap;
}

}  // namespace

extern "C" int gulon_ivf_topk_plan(int fetch, int* out) {
  if (out == nullptr || fetch < 1 || fetch > (1 << 29)) return static_cast<int>(cudaErrorInvalidValue);
  plan(fetch, &out[0], &out[1]);
  return 0;
}

// Launches the selection on `stream`. Returns a cudaError_t (0 =
// launched). The wrapper checks devices, types and shapes; this re-checks
// what would make the launch read or write out of bounds.
extern "C" int gulon_ivf_topk(const void* packed, const void* group_term, const void* qn,
                              const void* mask, const void* ranges, const void* blk_part,
                              void* best, void* cols, void* scratch, int num_q, int num_p,
                              int nw, int winners, int nblk, int fetch, int real_blocks,
                              int nbp, void* stream) {
  int cap, shared;
  if (num_q < 1 || num_p < 1 || winners < 1 || winners > 4 || nblk < 1 || fetch < 1 ||
      fetch > nw || nw % (winners * nblk) != 0 || nbp < 1 || real_blocks < 0 ||
      real_blocks > nbp || real_blocks > nw / winners)
    return static_cast<int>(cudaErrorInvalidValue);
  plan(fetch, &cap, &shared);
  if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<const float*>(packed), static_cast<const float*>(group_term),
           static_cast<const float*>(qn), static_cast<const uint8_t*>(mask),
           static_cast<const int*>(ranges), static_cast<const long long*>(blk_part),
           static_cast<float*>(best), static_cast<int*>(cols),
           shared ? nullptr : static_cast<unsigned long long*>(scratch),
           num_p, nw, winners, nblk, fetch, real_blocks, nbp, cap};
  const int smem = shared ? cap * static_cast<int>(sizeof(unsigned long long)) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(ivf_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ivf_topk_kernel<<<num_q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
