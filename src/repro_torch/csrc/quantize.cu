// The int8 wire on Hopper: the codec's encode, fused with the pack cast
// and the error-feedback update, and the decode-sum after the allgather.
//
// Replaces: src/repro/kernels/quantize.py::_quantize_kernel (the Pallas
// TPU kernel behind repro.kernels.ops.quantize_int8(impl="pallas")),
// together with what XLA fuses around it in the reference: the absmax
// reduce and the scale (ops.py:73-80), the pack's cast to f32 and, under
// error feedback, the residual's add and the round trip's subtraction
// (src/repro/core/codecs.py:365-374).  Same function, bitwise:
//   c     = f32(x) [+ residual]                 (one f32 rounding)
//   scale = max(absmax(c), 1e-30) * f32(1/127)
//   inv   = 1 / scale                           (IEEE f32 division)
//   q     = int8(clip(rint(c * inv), -127, 127))     (round half to even)
//   residual = c - f32(q) * scale               (two roundings, no FMA)
// over a flat f32 or bf16 buffer (the gradient leaf itself; bf16 is
// widened to f32 exactly, as the pack's cast does).  The reference
// writes "/ 127", but XLA's algebraic simplifier rewrites a division by
// a constant as a multiplication by the constant's f32 reciprocal, so
// the product is its result.  The division for inv must stay IEEE: the
// build passes no --use_fast_math, -prec-div=false or -ftz.  The
// residual's product and difference are __fmul_rn and __fsub_rn, which
// nvcc never contracts into an FMA (a plain c - q * s would be, and
// would differ from the reference in the last bit).
//
// Bound.  A few f32 operations per element, so bytes bound it: read the
// leaf and the residual once, write q and the residual once.  For a bf16
// leaf with error feedback that is 2 + 4 + 1 + 4 = 11 B an element; for
// the stateless encode in_bytes + 1.  For the tied embedding of
// full-width transformer-big (34,516,992 elements) 11 B is 0.113 ms at
// 3.35 TB/s.
//
// Design.  Every q needs the absmax of all of c, so two passes on the
// caller's stream:
//   1. absmax: a grid-stride loop over groups of 4 elements (one vector
//      load of x and one of the residual a group; neighbouring threads
//      take neighbouring groups, so every warp access is one contiguous
//      run; 4 groups a thread per step, all loads issued before any is
//      used) forms c and keeps the max of |c|'s bits in registers, then
//      across the warp by shuffles and across the block in shared
//      memory; each block writes one partial to a scratch of gridDim
//      words.  Nothing else is written.  Non-negative floats order like
//      their bits, so the max is exact and order-free, and a NaN's bits
//      lie above those of inf, so a NaN anywhere in c comes out as the
//      absmax.  This replaces a zeroed 4-byte scratch and an atomicMax a
//      block: one launch (the memset) fewer.
//   2. encode: every block reduces the partials (at most kMaxBlocks
//      words, from L2), forms scale and inv, recomputes c from x and the
//      residual, and writes q (one 4-byte store a group) and the new
//      residual (one 16-byte store).  Block 0 writes the scale.
// Both grids are as large as the card holds at once, so every block is
// resident and the grid-stride loops sweep the buffer from its start to
// its end together.  Pass 2 walks the groups in the reverse order: the
// tail that pass 1 read last is still in the 50 MB L2 when pass 2 starts
// (a bf16 leaf and its residual up to about 40 MB are read from L2
// entirely the second time).  The design moves 2 * (in_bytes [+ 4]) + 1
// [+ 4] bytes an element from device memory at most: 17 B against the
// 11 B bound with a bf16 leaf and error feedback.  (Streaming cache
// hints on pass 2's loads and stores made it slower on the H100.)
//
// NaN and inf follow the reference: a NaN absmax gives a NaN scale (not
// the 1e-30 floor), an inf absmax an inf scale and inv = 0, and a
// product c * inv that is NaN quantises to 0, as XLA converts NaN to an
// integer.  Decoding then gives NaN (and a NaN residual), so a NaN
// gradient stays visible.
//
// Decode-sum.  After the allgather each worker holds P int8 chunks of n
// and P scales; the sum of their decodes is one pass that reads P * n
// bytes and P scales and writes n f32 (bound: P + 4 bytes an element).
// It sums in worker order starting from chunk 0's decoded value, each
// product and sum rounded once (__fmul_rn, __fadd_rn).  One word (4
// int8) a load, 8 groups a thread per step with the loads of a worker's
// groups issued together, one 16-byte store of 4 sums a group.
//
// Interface: plain C entry points, launched on the caller's stream, no
// synchronisation, no allocation (the caller passes the outputs and a
// scratch of kMaxBlocks words).  Each returns the cudaError_t of its
// launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;     // the scratch's size in words
constexpr int kGroup = 4;               // elements a vector access holds
constexpr int kUnroll = 4;              // groups a thread per step
constexpr int kDecodeUnroll = 8;
constexpr uint32_t kAbs = 0x7fffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Bits of |x|, which order like |x| itself (NaN above inf).
__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & kAbs;
}

// Group g of 4 consecutive elements, as f32.  Neighbouring threads take
// neighbouring groups, so every warp access is one contiguous run.
__device__ __forceinline__ float4 load4(const float* p, int64_t g) {
  return __ldg(reinterpret_cast<const float4*>(p) + g);
}
// bf16 -> f32 is the 16 bits moved to the top of the word (element 0 of
// each pair is the low half, little-endian).
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p,
                                        int64_t g) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + g);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// c + the residual's group g.  The residual is read and written by the
// same kernel (pass 2), so it takes coherent loads.
__device__ __forceinline__ float4 add4(float4 c, const float* r,
                                       int64_t g) {
  const float4 u = reinterpret_cast<const float4*>(r)[g];
  return make_float4(__fadd_rn(c.x, u.x), __fadd_rn(c.y, u.y),
                     __fadd_rn(c.z, u.z), __fadd_rn(c.w, u.w));
}

__device__ __forceinline__ uint32_t absmax4(float4 c) {
  return max(max(abs_bits(c.x), abs_bits(c.y)),
             max(abs_bits(c.z), abs_bits(c.w)));
}

__device__ __forceinline__ int8_t quant(float c, float inv) {
  const float r = rintf(__fmul_rn(c, inv));
  if (isnan(r)) return 0;             // fmaxf below would give -127
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// The round trip's error, as the reference rounds it: the decoded value
// f32(q) * scale, then c minus it.
__device__ __forceinline__ float residual_of(float c, int8_t q,
                                             float scale) {
  return __fsub_rn(c, __fmul_rn(static_cast<float>(q), scale));
}

__device__ __forceinline__ uint32_t byte_of(int8_t q) {
  return static_cast<uint32_t>(static_cast<uint8_t>(q));
}

// Max over the block of every thread's m; every thread gets the result.
__device__ __forceinline__ uint32_t block_max(uint32_t m) {
  __shared__ uint32_t warp_max[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  m = lane < (blockDim.x >> 5) ? warp_max[lane] : 0u;
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;
}

// Pass 1: one partial max of |c|'s bits a block.  `groups` 4-element
// groups take the vector loads (0 when a pointer is not 16-byte
// aligned), kUnroll of them a thread per step with every load issued
// before any is used; the elements after them are read one by one.
template <typename T, bool kEf>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, const float* __restrict__ r,
              int64_t n, int64_t groups, uint32_t* __restrict__ partials) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  uint32_t m = 0;
  for (int64_t g0 = tid; g0 < groups; g0 += stride * kUnroll) {
    float4 c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t g = g0 + u * stride;
      c[u] = g < groups ? load4(x, g) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (kEf) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t g = g0 + u * stride;
        if (g < groups) c[u] = add4(c[u], r, g);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m = max(m, absmax4(c[u]));
  }
  for (int64_t i = groups * kGroup + tid; i < n; i += stride) {
    float v = to_f32(x[i]);
    if (kEf) v = __fadd_rn(v, r[i]);
    m = max(m, abs_bits(v));
  }
  m = block_max(m);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

// Pass 2: the scale from the partials, then q and the residual, the
// groups in the reverse order of pass 1.
template <typename T, bool kEf>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ x, float* __restrict__ r, int64_t n,
              int64_t groups, const uint32_t* __restrict__ partials,
              int n_partials, int8_t* __restrict__ q,
              float* __restrict__ scale_out) {
  uint32_t m = 0;
  for (int i = threadIdx.x; i < n_partials; i += blockDim.x) {
    m = max(m, partials[i]);
  }
  const float a = __uint_as_float(block_max(m));
  // fmaxf would turn a NaN absmax into the floor
  const float scale = __fmul_rn(isnan(a) ? a : fmaxf(a, 1e-30f),
                                1.0f / 127.0f);
  const float inv = 1.0f / scale;
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  // the elements after the groups, which pass 1 read last, first
  for (int64_t i = groups * kGroup + tid; i < n; i += stride) {
    float c = to_f32(x[i]);
    if (kEf) c = __fadd_rn(c, r[i]);
    const int8_t qi = quant(c, inv);
    q[i] = qi;
    if (kEf) r[i] = residual_of(c, qi, scale);
  }
  for (int64_t j0 = tid; j0 < groups; j0 += stride * kUnroll) {
    float4 c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * stride;
      c[u] = j < groups ? load4(x, groups - 1 - j)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (kEf) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + u * stride;
        if (j < groups) c[u] = add4(c[u], r, groups - 1 - j);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * stride;
      if (j >= groups) break;
      const int64_t g = groups - 1 - j;
      const int8_t q0 = quant(c[u].x, inv), q1 = quant(c[u].y, inv);
      const int8_t q2 = quant(c[u].z, inv), q3 = quant(c[u].w, inv);
      reinterpret_cast<uint32_t*>(q)[g] = byte_of(q0) | (byte_of(q1) << 8)
                                          | (byte_of(q2) << 16)
                                          | (byte_of(q3) << 24);
      if (kEf) {
        reinterpret_cast<float4*>(r)[g] = make_float4(
            residual_of(c[u].x, q0, scale), residual_of(c[u].y, q1, scale),
            residual_of(c[u].z, q2, scale), residual_of(c[u].w, q3, scale));
      }
    }
  }
}

// The decodes f32(q) * s of 4 int8 packed in one word.
__device__ __forceinline__ float4 decode4(uint32_t w, float s) {
  return make_float4(
      __fmul_rn(static_cast<float>(static_cast<int8_t>(w)), s),
      __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 8)), s),
      __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 16)), s),
      __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> 24)), s));
}

// Decode-sum: out[i] = sum over p in order of f32(q[p * n + i]) * s[p].
// A thread takes kDecodeUnroll groups a step and issues the loads of a
// worker's groups before it uses any, so enough bytes are in flight.
__global__ void __launch_bounds__(kThreads)
decode_sum_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, int p, int64_t n,
                  int64_t groups, float* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g0 = tid; g0 < groups; g0 += stride * kDecodeUnroll) {
    float4 acc[kDecodeUnroll];
    for (int j = 0; j < p; ++j) {
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + j * n);
      const float s = __ldg(scales + j);
      uint32_t w[kDecodeUnroll];
#pragma unroll
      for (int u = 0; u < kDecodeUnroll; ++u) {
        const int64_t g = g0 + u * stride;
        w[u] = g < groups ? __ldg(qw + g) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kDecodeUnroll; ++u) {
        const float4 d = decode4(w[u], s);
        acc[u] = j == 0 ? d
                        : make_float4(__fadd_rn(acc[u].x, d.x),
                                      __fadd_rn(acc[u].y, d.y),
                                      __fadd_rn(acc[u].z, d.z),
                                      __fadd_rn(acc[u].w, d.w));
      }
    }
#pragma unroll
    for (int u = 0; u < kDecodeUnroll; ++u) {
      const int64_t g = g0 + u * stride;
      if (g >= groups) break;
      reinterpret_cast<float4*>(out)[g] = acc[u];
    }
  }
  for (int64_t i = groups * kGroup + tid; i < n; i += stride) {
    float acc = __fmul_rn(static_cast<float>(q[i]), __ldg(scales));
    for (int j = 1; j < p; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(q[j * n + i]),
                                     __ldg(scales + j)));
    }
    out[i] = acc;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Blocks for `work` threads' worth of steps, at most as many as the card
// holds at once (so every block is resident) and at most kMaxBlocks.
template <typename K>
int blocks_for(K kernel, int64_t work) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                0);
  int64_t cap = static_cast<int64_t>(sms) * per_sm;
  if (cap < 1 || cap > kMaxBlocks) cap = kMaxBlocks;
  const int64_t want = (work + kThreads - 1) / kThreads;
  if (want < 1) return 1;
  return static_cast<int>(want < cap ? want : cap);
}

template <typename T, bool kEf>
cudaError_t encode(const T* x, float* r, int64_t n, int8_t* q,
                   float* scale, uint32_t* partials, cudaStream_t s) {
  const bool vec = aligned16(x) && aligned16(q) && (!kEf || aligned16(r));
  const int64_t groups = vec ? n / kGroup : 0;
  const int64_t work = groups / kUnroll + (n - groups * kGroup);
  const int g1 = blocks_for(absmax_kernel<T, kEf>, work);
  absmax_kernel<T, kEf><<<g1, kThreads, 0, s>>>(x, r, n, groups, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int g2 = blocks_for(encode_kernel<T, kEf>, work);
  encode_kernel<T, kEf><<<g2, kThreads, 0, s>>>(x, r, n, groups, partials,
                                                g1, q, scale);
  return cudaGetLastError();
}

template <bool kEf>
int dispatch(const void* x, int dtype, int64_t n, float* r, void* q_out,
             void* scale_out, void* partials_scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int8_t* q = static_cast<int8_t*>(q_out);
  float* scale = static_cast<float*>(scale_out);
  uint32_t* partials = static_cast<uint32_t*>(partials_scratch);
  if (dtype == 0) {
    return static_cast<int>(encode<float, kEf>(
        static_cast<const float*>(x), r, n, q, scale, partials, s));
  }
  if (dtype == 1) {
    return static_cast<int>(encode<__nv_bfloat16, kEf>(
        static_cast<const __nv_bfloat16*>(x), r, n, q, scale, partials, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, q_out, scale_out and
// partials_scratch are device pointers; x must be aligned to its element
// size.  q_out holds n int8, scale_out one f32, partials_scratch
// kMaxBlocks (1056) 4-byte words.
extern "C" int repro_quantize_int8(const void* x, int dtype, int64_t n,
                                   void* q_out, void* scale_out,
                                   void* partials_scratch, void* stream) {
  return dispatch<false>(x, dtype, n, nullptr, q_out, scale_out,
                         partials_scratch, stream);
}

// The error-feedback encode: as repro_quantize_int8 on c = x + residual,
// and residual (n f32, updated in place) becomes c - f32(q) * scale.
extern "C" int repro_quantize_int8_ef(const void* x, int dtype, int64_t n,
                                      void* residual, void* q_out,
                                      void* scale_out,
                                      void* partials_scratch,
                                      void* stream) {
  return dispatch<true>(x, dtype, n, static_cast<float*>(residual), q_out,
                        scale_out, partials_scratch, stream);
}

// gathered_q holds p chunks of n int8 one after the other, scales p f32;
// out (n f32) gets the sum of their decodes in chunk order.
extern "C" int repro_int8_decode_sum(const void* gathered_q,
                                     const void* scales, int p, int64_t n,
                                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int8_t* q = static_cast<const int8_t*>(gathered_q);
  float* o = static_cast<float*>(out);
  // every worker's chunk must start on a word for the vector loads
  const bool vec = aligned16(q) && aligned16(o) && n % kGroup == 0;
  const int64_t groups = vec ? n / kGroup : 0;
  const int64_t work = groups / kDecodeUnroll + (n - groups * kGroup);
  decode_sum_kernel<<<blocks_for(decode_sum_kernel, work), kThreads, 0,
                      s>>>(q, static_cast<const float*>(scales), p, n,
                           groups, o);
  return static_cast<int>(cudaGetLastError());
}
