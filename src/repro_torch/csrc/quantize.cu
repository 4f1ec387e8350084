// int8 wire quantisation on Hopper: the int8 codec's encode.
//
// Replaces: src/repro/kernels/quantize.py::_quantize_kernel (the Pallas
// TPU kernel behind repro.kernels.ops.quantize_int8(impl="pallas")),
// together with the absmax reduce and the scale that the reference
// computes in XLA around it (ops.py:73-80).  Same function, bitwise:
//   scale = max(absmax(x), 1e-30) * f32(1/127)
//   inv   = 1 / scale                         (IEEE f32 division)
//   q     = int8(clip(rint(x * inv), -127, 127))   (round half to even)
// over a flat f32 or bf16 buffer; bf16 is widened to f32 first.  The
// reference writes "/ 127", but XLA's algebraic simplifier rewrites a
// division by a constant as a multiplication by the constant's f32
// reciprocal, so the product is its result.  The division for inv must
// stay IEEE: the build passes no --use_fast_math, -prec-div=false or
// -ftz.
//
// Bound.  The work is one reduction and one elementwise pass, a few f32
// operations per element, so bytes bound it: read x once, write q once,
// write the 4-byte scale: (in_bytes + 1) * n + 4 bytes.  For the largest
// dense bucket of full-width transformer-big under dense_reduce
// (34,516,992 f32, the tied embedding) that is 172,584,964 B, 51.5 us at
// 3.35 TB/s.
//
// Design.  Two passes on the caller's stream, because every element's
// q needs the absmax of all of them:
//   1. absmax: a grid-stride loop with 16-byte loads (scalar prologue up
//      to the first 16-byte boundary, scalar tail), max in registers,
//      then across the warp by shuffles, across the block in shared
//      memory, and one atomicMax per block.  Every max is taken on the
//      bit pattern of |x| (the sign bit cleared) as an unsigned int:
//      non-negative floats order like their bits, so the max is exact
//      and order-free, and a NaN's bits lie above those of inf, so a NaN
//      anywhere in x comes out as the absmax.
//   2. quantize: every block reads the absmax, computes scale and inv,
//      and quantises 16 elements a thread per step (16-byte store of q)
//      when x and q are both 16-byte aligned, element by element
//      otherwise.  Block 0 writes the scale.
// The second pass reads x again.  Every bucket of this model is larger
// than the 50 MB L2, so that read comes from device memory: the kernel
// moves (2 * in_bytes + 1) * n bytes and can reach at most about 5/9 of
// the bound for f32 input.  Fusing the absmax into the pack that
// produces x would remove the extra read.
//
// NaN and inf follow the reference: a NaN absmax gives a NaN scale (not
// the 1e-30 floor), an inf absmax an inf scale and inv = 0, and a
// product x * inv that is NaN quantises to 0, as XLA converts NaN to an
// integer.  Decoding then gives NaN, so a NaN gradient stays visible.
//
// Interface: one plain C entry point, launched on the caller's stream,
// no synchronisation, no allocation (the caller passes q, the scale and
// a 4-byte scratch).  Returns the cudaError_t of its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;     // a few waves on 132 SMs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr uint32_t kAbs = 0x7fffffffu;

// Bits of |x| as f32, which order like |x| itself (NaN above inf).
__device__ __forceinline__ uint32_t abs_bits(float x) {
  return __float_as_uint(x) & kAbs;
}
__device__ __forceinline__ uint32_t abs_bits(__nv_bfloat16 x) {
  return abs_bits(__bfloat162float(x));
}

// max |x| bits over the 16 bytes of one vector load.
__device__ __forceinline__ uint32_t vec_absmax(uint4 v, const float*) {
  return max(max(v.x & kAbs, v.y & kAbs), max(v.z & kAbs, v.w & kAbs));
}
// bf16 -> f32 is the 16 bits moved to the top of the word (element 0 of
// each pair is the low half, little-endian); the sign bit is cleared.
__device__ __forceinline__ uint32_t pair_absmax(uint32_t w) {
  return max((w << 16) & kAbs, w & 0x7fff0000u);
}
__device__ __forceinline__ uint32_t vec_absmax(uint4 v,
                                               const __nv_bfloat16*) {
  return max(max(pair_absmax(v.x), pair_absmax(v.y)),
             max(pair_absmax(v.z), pair_absmax(v.w)));
}

template <typename T>
__global__ void absmax_kernel(const T* __restrict__ x, int64_t n,
                              unsigned int* __restrict__ out) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  int64_t head = static_cast<int64_t>(((16 - (addr & 15)) & 15) / sizeof(T));
  if (head > n) head = n;
  const int64_t n_vec = (n - head) / kVec;
  const int64_t tail = head + n_vec * kVec;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  uint32_t m = 0;
  if (tid < head) m = abs_bits(x[tid]);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  for (int64_t i = tid; i < n_vec; i += stride) {
    m = max(m, vec_absmax(__ldg(xv + i), x));
  }
  for (int64_t i = tail + tid; i < n; i += stride) {
    m = max(m, abs_bits(x[i]));
  }

  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  __shared__ uint32_t warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (blockDim.x >> 5) ? warp_max[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) atomicMax(out, m);
  }
}

__device__ __forceinline__ int8_t quant(float x, float inv) {
  const float r = rintf(__fmul_rn(x, inv));
  if (isnan(r)) return 0;             // fmaxf below would give -127
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t quant_bits(float x, float inv) {
  return static_cast<uint32_t>(static_cast<uint8_t>(quant(x, inv)));
}

// Four quantised values packed into one word, element 0 in the low byte.
__device__ __forceinline__ uint32_t pack4(float a, float b, float c,
                                          float d, float inv) {
  return quant_bits(a, inv) | (quant_bits(b, inv) << 8)
         | (quant_bits(c, inv) << 16) | (quant_bits(d, inv) << 24);
}

// 16 consecutive elements from a 16-byte-aligned address, as f32.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 u = __ldg(v + k);
    f[4 * k + 0] = __uint_as_float(u.x);
    f[4 * k + 1] = __uint_as_float(u.y);
    f[4 * k + 2] = __uint_as_float(u.z);
    f[4 * k + 3] = __uint_as_float(u.w);
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint4 u = __ldg(v + k);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[8 * k + 2 * j] = __uint_as_float(w[j] << 16);
      f[8 * k + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, int64_t n,
                                const unsigned int* __restrict__ absmax,
                                int8_t* __restrict__ q,
                                float* __restrict__ scale_out,
                                bool vectorised) {
  const float a = __uint_as_float(*absmax);
  // fmaxf would turn a NaN absmax into the floor
  const float scale = __fmul_rn(isnan(a) ? a : fmaxf(a, 1e-30f),
                                1.0f / 127.0f);
  const float inv = 1.0f / scale;
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vectorised) {
    const int64_t chunks = n / 16;
    uint4* qv = reinterpret_cast<uint4*>(q);
    for (int64_t c = tid; c < chunks; c += stride) {
      float f[16];
      load16(x + c * 16, f);
      qv[c] = make_uint4(pack4(f[0], f[1], f[2], f[3], inv),
                         pack4(f[4], f[5], f[6], f[7], inv),
                         pack4(f[8], f[9], f[10], f[11], inv),
                         pack4(f[12], f[13], f[14], f[15], inv));
    }
    done = chunks * 16;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    q[i] = quant(to_f32(x[i]), inv);
  }
}

int blocks_for(int64_t work) {
  const int64_t want = (work + kThreads - 1) / kThreads;
  if (want < 1) return 1;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

template <typename T>
cudaError_t launch(const T* x, int64_t n, int8_t* q, float* scale,
                   unsigned int* absmax, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(absmax, 0, sizeof(unsigned int), s);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    absmax_kernel<T><<<blocks_for(n / (16 / sizeof(T)) + 1), kThreads, 0,
                       s>>>(x, n, absmax);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const bool vectorised = (reinterpret_cast<uintptr_t>(x) & 15) == 0
                          && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  quantize_kernel<T><<<blocks_for(vectorised ? n / 16 + 1 : n), kThreads,
                       0, s>>>(x, n, absmax, q, scale, vectorised);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, q_out, scale_out and
// absmax_scratch are device pointers; x must be aligned to its element
// size.  q_out holds n int8, scale_out one f32, absmax_scratch 4 bytes.
extern "C" int repro_quantize_int8(const void* x, int dtype, int64_t n,
                                   void* q_out, void* scale_out,
                                   void* absmax_scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  int8_t* q = static_cast<int8_t*>(q_out);
  float* scale = static_cast<float*>(scale_out);
  unsigned int* absmax = static_cast<unsigned int*>(absmax_scratch);
  if (dtype == 0) {
    return static_cast<int>(
        launch(static_cast<const float*>(x), n, q, scale, absmax, s));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch(static_cast<const __nv_bfloat16*>(x), n, q, scale, absmax, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
