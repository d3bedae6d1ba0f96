// Probe kernel P4 for Hopper (sm_90a): the fixed cost of the fused ADC
// scan's launch and I/O, with no work in between.
//
// Replaces the TPU probe benchmarks/floor_probe.py::run_variant: an empty
// kernel over the headline shape's operands (codes [8, 401,408] int8,
// queries [1024, 112] bf16) that writes zeros to [rows, 1024] f32 values
// and, in one variant, int32 ids. On the TPU every BlockSpec copies its
// tile whether or not the body reads it; here nothing reads a pointer that
// goes unused, so the kernel reads every byte of each operand it is given
// itself: 16-byte loads, folded into a word that feeds a store behind a
// flag the caller always passes as 0. The compiler cannot drop the loads,
// and the outputs are zeros. Each byte is read once and written once, so
// the time is bounded by those bytes over the memory rate, and the launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see gulon_tpu_torch/ops/cuda/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

// XOR of every byte range [p, p + bytes), 16 bytes a load, grid-strided
__device__ __forceinline__ uint32_t fold(const void* p, int64_t bytes, int64_t i0,
                                         int64_t step) {
  uint32_t x = 0;
  if (p == nullptr) return x;
  const uint4* v = static_cast<const uint4*>(p);
  const int64_t n16 = bytes / 16;
  for (int64_t i = i0; i < n16; i += step) {
    const uint4 w = __ldg(v + i);
    x ^= w.x ^ w.y ^ w.z ^ w.w;
  }
  const uint8_t* b = static_cast<const uint8_t*>(p);
  for (int64_t i = n16 * 16 + i0; i < bytes; i += step) x ^= __ldg(b + i);
  return x;
}

__global__ void __launch_bounds__(kThreads) floor_probe_kernel(
    const void* __restrict__ codes, int64_t code_bytes, const void* __restrict__ q,
    int64_t q_bytes, float* __restrict__ vals, int* __restrict__ ids, int64_t n_out,
    int flag) {
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  const uint32_t x = fold(codes, code_bytes, i0, step) ^ fold(q, q_bytes, i0, step);
  float4* v4 = reinterpret_cast<float4*>(vals);
  int4* i4 = reinterpret_cast<int4*>(ids);
  for (int64_t i = i0; i < n_out / 4; i += step) {
    v4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ids != nullptr) i4[i] = make_int4(0, 0, 0, 0);
  }
  for (int64_t i = n_out / 4 * 4 + i0; i < n_out; i += step) {
    vals[i] = 0.f;
    if (ids != nullptr) ids[i] = 0;
  }
  if (flag) vals[i0 % n_out] = __int_as_float(static_cast<int>(x));  // never taken
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
// codes or q may be null (the variant has no such operand), ids too;
// vals and ids hold n_out elements, 16-byte aligned, as are the operands.
extern "C" int gulon_floor_probe(const void* codes, int64_t code_bytes, const void* q,
                                 int64_t q_bytes, void* vals, void* ids, int64_t n_out,
                                 int flag, void* stream) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (vals == nullptr || n_out <= 0 || code_bytes < 0 || q_bytes < 0 || !aligned(codes) ||
      !aligned(q) || !aligned(vals) || !aligned(ids))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaErrorNoDevice);
  const int64_t work = std::max(n_out / 4, std::max(code_bytes, q_bytes) / 16);
  const int grid = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(8 * sms, (work + kThreads - 1) / kThreads)));
  floor_probe_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      codes, code_bytes, q, q_bytes, static_cast<float*>(vals), static_cast<int*>(ids), n_out,
      flag);
  return static_cast<int>(cudaGetLastError());
}
