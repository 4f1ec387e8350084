// Densify IndexedSlices on Hopper: scatter-add rows into a dense tensor.
//
// Replaces: src/repro/kernels/densify.py::_densify_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.densify).  Same function: rows
// values[i] are added at row indices[i] of zeros(vocab, d); duplicate ids
// sum; ids < 0 or >= vocab are dropped; bf16 values accumulate in f32 and
// are cast back once at the end (densify.py:77,89).
//
// Design.  The TPU kernel recasts the scatter as a one-hot matmul on the
// MXU, vocab*n*d multiply-adds.  Here the work is n*d adds, negligible, so
// the kernel is bound by bytes:
//   output write vocab*d*itemsize + values read n*d*itemsize + indices 4n
//   (bf16, n = 2048, vocab = 33708, d = 1024: ~73.2 MB, ~21.9 us at
//   3.35 TB/s, H100 SXM data sheet).
// Three launches, and every output byte is written exactly once:
//
//   1. group_rows, one block of 1024 threads: a counting sort of the
//      input rows by output row.  It counts the valid ids in shared memory
//      (in the workspace when vocab + 1 ints do not fit), scans the counts
//      into CSR offsets row_ptr[vocab + 1] and drops each input row into
//      its id's slice of rows[n] with an atomic cursor.
//   2. rank_rows, a thread an input row: its rank in its slice (one pass
//      over the slice) places it in sorted[n], so every slice of sorted
//      holds its input rows in ascending order.
//   3. write_rows: one warp per output row, zeros or the f32 sum of its
//      input rows taken in ascending input-row order, written once in the
//      output dtype with 16-byte stores (element by element where d or
//      the pointers do not allow 16-byte vectors); the first blocks take
//      the rows of more than 8 input rows (group_rows lists them) one
//      element a thread, the values of 32 input rows in flight at once,
//      so a frequent token's row does not keep one warp waiting on
//      hundreds of loads in turn, and its chain runs beside the stores.
// The workspace is row_ptr, rows, sorted, the long-row list and the
// counts' spill: int32, 2 * n + 3 * (vocab + 1), ~420 KB at the main
// shape.
//
// No f32 scratch of vocab*d, no memset and no cast pass (the first design
// moved ~345 MB at the main shape).  The sum order is fixed, so the
// result is bitwise the same from run to run, and equals a sequential f32
// index_add_ in index order followed by one cast.
//
// Interface: one plain C entry point, launched on the caller's stream,
// no synchronisation, no allocation (the caller passes output and
// workspace).  Returns the cudaError_t of its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kGroupThreads = 1024;
constexpr int kWriteThreads = 256;
constexpr int kLongRow = 8;    // output rows with more input rows than this
                               // take write_long
constexpr int kLongBlocks = 264;   // two an H100 SM; they loop over the work
constexpr int64_t kMaxCountSmem = 200 * 1024;   // bytes of shared counts

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of values added into f32 sums, and f32 sums packed into 16
// bytes of output (bf16: the f32 bits are the bf16 bits shifted up, so
// the widening is exact; the narrowing rounds to nearest even).
__device__ __forceinline__ void add16(float (&acc)[4], uint4 u, float) {
  acc[0] += __uint_as_float(u.x);
  acc[1] += __uint_as_float(u.y);
  acc[2] += __uint_as_float(u.z);
  acc[3] += __uint_as_float(u.w);
}
__device__ __forceinline__ void add16(float (&acc)[8], uint4 u,
                                      __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack16(const float (&acc)[4], float) {
  return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                    __float_as_uint(acc[2]), __float_as_uint(acc[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint4 pack16(const float (&acc)[8],
                                        __nv_bfloat16) {
  return make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]),
                    pack2(acc[4], acc[5]), pack2(acc[6], acc[7]));
}

// Exclusive scan of one value per thread over the block.
__device__ __forceinline__ int block_exclusive_scan(int x) {
  __shared__ int warp_sums[kGroupThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;          // inclusive over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  return before + inc - x;
}

// Counting sort of the valid rows by id: row_ptr (vocab + 1), and each
// id's input rows dropped into its slice of rows (n) by an atomic cursor,
// in no fixed order (rank_rows orders them).  The long rows, more than
// kLongRow input rows, are listed in long_rows (count first).
// `global_counts` is null when the counts live in shared memory.
__global__ void __launch_bounds__(kGroupThreads)
    group_rows(const int32_t* __restrict__ indices, int n, int vocab,
               int* __restrict__ row_ptr, int* __restrict__ rows,
               int* __restrict__ long_rows, int* global_counts) {
  extern __shared__ int smem_counts[];
  __shared__ int n_long;
  int* counts = global_counts != nullptr ? global_counts : smem_counts;
  const int m = vocab + 1;
  for (int i = threadIdx.x; i < m; i += kGroupThreads) counts[i] = 0;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kGroupThreads) {
    const int id = __ldg(indices + i);
    if (id >= 0 && id < vocab) atomicAdd(counts + id, 1);
  }
  __syncthreads();
  // each thread scans one contiguous segment of the counts
  const int seg = (m + kGroupThreads - 1) / kGroupThreads;
  const int lo = min(m, static_cast<int>(threadIdx.x) * seg);
  const int hi = min(m, lo + seg);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  int run = block_exclusive_scan(sum);
  __syncthreads();              // every count read before it is rewritten
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;            // the offset, then the id's cursor
    run += c;
    if (c > kLongRow) long_rows[1 + atomicAdd(&n_long, 1)] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) long_rows[0] = n_long;
  for (int i = threadIdx.x; i < m; i += kGroupThreads) row_ptr[i] = counts[i];
  __syncthreads();              // offsets copied before the cursors move
  for (int i = threadIdx.x; i < n; i += kGroupThreads) {
    const int id = __ldg(indices + i);
    if (id >= 0 && id < vocab) rows[atomicAdd(counts + id, 1)] = i;
  }
}

// Each valid input row's place in its id's slice of sorted: its rank, the
// number of the slice's rows (in rows, unordered) below it.  One thread a
// row over many blocks: a frequent token's slice (~400 rows at the
// training step) makes the warps holding its rows walk it whole.
__global__ void __launch_bounds__(kWriteThreads)
    rank_rows(const int32_t* __restrict__ indices, int n, int vocab,
              const int* __restrict__ row_ptr, const int* __restrict__ rows,
              int* __restrict__ sorted) {
  const int i = blockIdx.x * kWriteThreads + threadIdx.x;
  if (i >= n) return;
  const int id = __ldg(indices + i);
  if (id < 0 || id >= vocab) return;
  const int j0 = __ldg(row_ptr + id), j1 = __ldg(row_ptr + id + 1);
  // eight running counts, so eight loads are in flight at once
  int part[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  int j = j0;
  for (; j + 8 <= j1; j += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) part[u] += __ldg(rows + j + u) < i;
  }
  for (; j < j1; ++j) part[0] += __ldg(rows + j) < i;
  int rank = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) rank += part[u];
  sorted[j0 + rank] = i;
}

// The output rows of more than kLongRow input rows (long_rows[1..n],
// n = long_rows[0]): one element a thread, a block a 256-column chunk of
// a row, the kLongBlocks blocks that take them looping over the (row,
// chunk) items.  A warp loads the values of 32 input rows at once (their
// indices a step ahead), so a row of hundreds of input rows (a frequent
// token) waits on a load latency every 32 of them, not every one.  The
// sum is the same f32 sum in ascending input-row order as write_row's.
template <typename T>
__device__ __forceinline__ void write_long(
    const T* __restrict__ values, const int* __restrict__ row_ptr,
    const int* __restrict__ sorted, const int* __restrict__ long_rows,
    T* __restrict__ out, int64_t d) {
  const int64_t chunks = (d + kWriteThreads - 1) / kWriteThreads;
  const int64_t items = static_cast<int64_t>(long_rows[0]) * chunks;
  const int lane = threadIdx.x % 32;
  for (int64_t item = blockIdx.x; item < items; item += kLongBlocks) {
    const int r = long_rows[1 + item / chunks];
    const int64_t c = (item % chunks) * kWriteThreads + threadIdx.x;
    const bool in = c < d;
    const int j0 = row_ptr[r], j1 = row_ptr[r + 1];
    float acc = 0.f;
    int next = j0 + lane < j1 ? sorted[j0 + lane] : 0;
    for (int b = j0; b < j1; b += 32) {
      const int mine = next;
      next = b + 32 + lane < j1 ? sorted[b + 32 + lane] : 0;
      const int nb = min(32, j1 - b);
      T buf[32];
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int src_row = __shfl_sync(0xffffffffu, mine, u);
        if (in && u < nb)
          buf[u] = values[static_cast<int64_t>(src_row) * d + c];
      }
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (in && u < nb) acc += to_f32(buf[u]);
    }
    if (in) store(out + static_cast<int64_t>(r) * d + c, acc);
  }
}

// One warp per output row of at most kLongRow input rows: zeros, or the
// sum of its input rows in f32 in ascending input-row order, one store of
// each output element.  A lane takes VEC elements (16 bytes) of each of
// kChunks column chunks 32 * VEC apart, so the loads of one input row are
// all in flight together; VEC = 1 is the element-by-element form.
template <typename T, int VEC>
__device__ __forceinline__ void write_row(
    const T* __restrict__ values, const int* __restrict__ row_ptr,
    const int* __restrict__ sorted, T* __restrict__ out, int vocab,
    int64_t d, int64_t r) {
  constexpr int kChunks = 4, kSpan = 32 * VEC * kChunks;
  if (r >= vocab) return;
  const int lane = threadIdx.x % 32;
  const int j0 = __ldg(row_ptr + r), j1 = __ldg(row_ptr + r + 1);
  if (j1 - j0 > kLongRow) return;          // write_long's
  T* dst = out + r * d;
  for (int64_t c0 = static_cast<int64_t>(lane) * VEC; c0 < d; c0 += kSpan) {
    float acc[kChunks][VEC];
#pragma unroll
    for (int u = 0; u < kChunks; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[u][e] = 0.f;
    for (int j = j0; j < j1; ++j) {
      const T* src = values + static_cast<int64_t>(__ldg(sorted + j)) * d;
#pragma unroll
      for (int u = 0; u < kChunks; ++u) {
        const int64_t c = c0 + u * 32 * VEC;
        if (c >= d) break;
        if constexpr (VEC == 1)
          acc[u][0] += to_f32(src[c]);
        else
          add16(acc[u], __ldg(reinterpret_cast<const uint4*>(src + c)), T());
      }
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int64_t c = c0 + u * 32 * VEC;
      if (c >= d) break;
      if constexpr (VEC == 1)
        store(dst + c, acc[u][0]);
      else
        *reinterpret_cast<uint4*>(dst + c) = pack16(acc[u], T());
    }
  }
}

// The write pass: the first kLongBlocks blocks take the long rows, the
// others a warp an output row, so the long rows' chains of loads run
// beside the stores of the rest.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWriteThreads)
    write_rows(const T* __restrict__ values, const int* __restrict__ row_ptr,
               const int* __restrict__ sorted,
               const int* __restrict__ long_rows, T* __restrict__ out,
               int vocab, int64_t d) {
  if (blockIdx.x < kLongBlocks) {
    write_long(values, row_ptr, sorted, long_rows, out, d);
  } else {
    const int64_t r =
        static_cast<int64_t>(blockIdx.x - kLongBlocks) * (kWriteThreads / 32)
        + threadIdx.x / 32;
    write_row<T, VEC>(values, row_ptr, sorted, out, vocab, d, r);
  }
}

template <typename T>
cudaError_t write_all(const void* values, const int* row_ptr,
                      const int* sorted, const int* long_rows, void* out,
                      int vocab, int64_t d, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(values) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int warps = kWriteThreads / 32;
  const int blocks = kLongBlocks + (vocab + warps - 1) / warps;
  const T* v = static_cast<const T*>(values);
  T* o = static_cast<T*>(out);
  if (vec)
    write_rows<T, VEC><<<blocks, kWriteThreads, 0, s>>>(
        v, row_ptr, sorted, long_rows, o, vocab, d);
  else
    write_rows<T, 1><<<blocks, kWriteThreads, 0, s>>>(
        v, row_ptr, sorted, long_rows, o, vocab, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (values and out).  workspace holds
// workspace_ints int32s, at least 2 * n + 3 * (vocab + 1): row_ptr,
// rows, sorted, the list of long rows and the spill of the counts (always
// reserved, so the size is one formula).
// Pointers must be device pointers.
extern "C" int repro_densify(const void* indices, const void* values,
                             void* out, void* workspace, int64_t n,
                             int64_t vocab, int64_t d,
                             int64_t workspace_ints, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || n < 0 || vocab < 0 || d < 0 ||
      n >= INT_MAX || vocab >= INT_MAX ||
      workspace_ints < 2 * n + 3 * (vocab + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vocab == 0 || d == 0) return static_cast<int>(cudaSuccess);
  int* row_ptr = static_cast<int*>(workspace);
  int* rows = row_ptr + vocab + 1;
  int* sorted = rows + n;
  int* long_rows = sorted + n;
  int* spill = long_rows + vocab + 1;
  const int64_t count_bytes = (vocab + 1) * sizeof(int);
  const bool in_smem = count_bytes <= kMaxCountSmem;
  const int smem = in_smem ? static_cast<int>(count_bytes) : 0;
  static int smem_allowed = 48 * 1024;     // raised once, as needed
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  group_rows<<<1, kGroupThreads, smem, s>>>(
      static_cast<const int32_t*>(indices), static_cast<int>(n),
      static_cast<int>(vocab), row_ptr, rows, long_rows,
      in_smem ? nullptr : spill);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    rank_rows<<<static_cast<int>((n + kWriteThreads - 1) / kWriteThreads),
                kWriteThreads, 0, s>>>(
        static_cast<const int32_t*>(indices), static_cast<int>(n),
        static_cast<int>(vocab), row_ptr, rows, sorted);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int nv = static_cast<int>(vocab);
  err = dtype == 0
            ? write_all<float>(values, row_ptr, sorted, long_rows, out, nv,
                               d, s)
            : write_all<__nv_bfloat16>(values, row_ptr, sorted, long_rows,
                                       out, nv, d, s);
  return static_cast<int>(err);
}
