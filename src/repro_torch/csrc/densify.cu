// Densify IndexedSlices on Hopper: scatter-add rows into a dense tensor.
//
// Replaces: src/repro/kernels/densify.py::_densify_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.densify).  Same function: rows
// values[i] are added at row indices[i] of zeros(vocab, d); duplicate ids
// sum; ids < 0 or >= vocab are dropped; bf16 values accumulate in f32 and
// are cast back once at the end (densify.py:77,89).
//
// Design.  The TPU kernel recasts the scatter as a one-hot matmul on the
// MXU, vocab*n*d multiply-adds (33708*2048*1024 ~ 7.1e10 at the training
// step's shape, ~140 us of bf16 tensor-core time).  Here the rows are
// scattered directly: n*d f32 atomic adds, which is negligible work, so
// the kernel is bound by bytes:
//   output write vocab*d*itemsize + values read n*d*itemsize + indices 4n
//   (bf16, n = 2048, vocab = 33708, d = 1024: ~73.2 MB, ~21.9 us at
//   3.35 TB/s).
// What the design does about that bound: every value row is read once
// with neighbouring threads on neighbouring addresses, and the atomics
// land in L2 (their result is unused, so they compile to fire-and-forget
// reductions).  The bytes it spends beyond the bound are the f32
// accumulator: a memset of vocab*d*4 bytes and, for bf16, one pass that
// reads it back and writes the bf16 output.  For f32 values the rows add
// straight into the (zeroed) output and the cast pass is skipped.
//
// The order in which duplicate rows are summed follows the atomics and
// varies from run to run; results agree with a sequential sum to f32
// rounding.
//
// Interface: one plain C entry point, launched on the caller's stream,
// no synchronisation, no allocation (the caller passes output and
// scratch).  Returns the cudaError_t of its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Each block takes kRowsPerBlock consecutive rows; each thread strides
// over the row's d columns.  The row's index is loaded once per row.
template <typename T>
__global__ void scatter_rows(const int32_t* __restrict__ indices,
                             const T* __restrict__ values,
                             float* __restrict__ acc, int64_t n,
                             int64_t vocab, int64_t d) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  for (int r = 0; r < kRowsPerBlock; ++r) {
    const int64_t row = row0 + r;
    if (row >= n) return;
    const int32_t id = __ldg(indices + row);
    if (id < 0 || id >= vocab) continue;   // padding convention: dropped
    const T* src = values + row * d;
    float* dst = acc + static_cast<int64_t>(id) * d;
    for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
      atomicAdd(dst + c, to_f32(src[c]));
    }
  }
}

// f32 accumulator -> bf16 output, four elements a thread per step.
__global__ void cast_to_bf16(const float* __restrict__ acc,
                             __nv_bfloat16* __restrict__ out,
                             int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x * 4;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x) * 4;
       i < total; i += stride) {
    if (i + 3 < total) {
      const float4 v = *reinterpret_cast<const float4*>(acc + i);
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<__nv_bfloat162*>(out + i) = lo;
      *reinterpret_cast<__nv_bfloat162*>(out + i + 2) = hi;
    } else {
      for (int64_t j = i; j < total; ++j) out[j] = __float2bfloat16(acc[j]);
    }
  }
}

}  // namespace

// dtype: 0 = float32 (out is accumulated in place, scratch unused),
//        1 = bfloat16 (scratch holds vocab*d f32; out gets the cast).
// Pointers must be device pointers; out and scratch 16-byte aligned.
extern "C" int repro_densify(const void* indices, const void* values,
                             void* out, void* scratch, int64_t n,
                             int64_t vocab, int64_t d, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = vocab * d;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  float* acc = dtype == 0 ? static_cast<float*>(out)
                          : static_cast<float*>(scratch);
  cudaError_t err = cudaMemsetAsync(acc, 0, total * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && d > 0) {
    const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (dtype == 0) {
      scatter_rows<float><<<blocks, kThreads, 0, s>>>(
          static_cast<const int32_t*>(indices),
          static_cast<const float*>(values), acc, n, vocab, d);
    } else {
      scatter_rows<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          static_cast<const int32_t*>(indices),
          static_cast<const __nv_bfloat16*>(values), acc, n, vocab, d);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dtype == 1 && total > 0) {
    const int64_t want = (total / 4 + kThreads - 1) / kThreads + 1;
    const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    cast_to_bf16<<<blocks, kThreads, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(out), total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
