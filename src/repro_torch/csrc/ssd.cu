// Chunked Mamba2 SSD scan on Hopper, f32 on the CUDA cores: the "simt"
// variant, for f32 inputs and the shapes csrc/ssd_sm90.cu does not take
// (the Python wrapper picks the variant).
//
// Replaces: src/repro/kernels/ssd.py::_ssd_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.ssd, impl "pallas").  Same function, chunk by
// chunk of L rows, for each (batch, head) with the state S (N x P, f32)
// starting at zero:
//
//   cum   = cumsum(dt * a)                     (L,), a < 0
//   pos   = exp(cum),  neg = exp(min(-cum, 60))
//   M     = tril(C B^T)                        (L, L), head-free
//   y     = pos * (M @ ((neg * dt) * x))
//         + ((1 - pos * neg) * dt * rowsum(C * B)) * x     exact diagonal
//         + pos * (C @ S)                      inter-chunk term
//   S     = exp(cum[L-1]) * S + (B * dt * exp(cum[L-1] - cum))^T @ x
//
// all in f32 from f32 or bf16 x, B, C and f32 dt, a.  y is written f32,
// and S after the last chunk.
//
// Layout: x (Bt, S, H, P), dt (Bt, S, H), a (H,), b/c (Bt, S, N), read
// through their strides (the last dim contiguous): B and C are shared by
// all heads of a batch entry and read per batch, never repeated per head.
// y is a contiguous (Bt, S, H, P) f32 tensor and the state a contiguous
// (Bt, H, N, P) f32 tensor.  S % L == 0 (the wrapper pads).
//
// Design.  The TPU runs the chunk axis of its (batch*heads, chunks) grid
// in order and carries S in VMEM.  Here one block owns one (batch, head)
// and loops over the chunks itself, keeping S in shared memory.  At
// zamba2-7b's prefill (1 x 32768 tokens, 112 heads) that is 112 blocks on
// 132 SMs: acceptable for a first kernel, a split of P or of the sequence
// is later work.  Each chunk's B (transposed) and x are loaded once into
// shared memory as f32 (2 x 64 KB at L = 256, 16-byte loads where rows
// allow).  An L = 256 chunk's score matrix would take 256 KB in f32, more
// than a block's 227 KB, so the queries are cut into 64-row tiles: for
// each query tile (its C loaded alone) the block walks the key tiles at
// or below the diagonal (those above are all masked) with a 64 x 64
// score tile in shared memory, and C @ S joins the same accumulator
// pass; the loops run over the full 64-wide tile, N and P zero-padded,
// so they unroll.  The last
// query tile sees every key tile of the chunk, so the state update is
// accumulated in registers beside it and applied once the chunk is done.
// The cumsum is a block-level scan (warp shuffles).  Everything is f32 on
// the CUDA cores, each thread owning a 4 x 4 register tile fed by 16-byte
// shared-memory reads: bf16 or TF32 tensor cores would not hold the
// reference's 2e-5 tolerance on f32 inputs (csrc/ssd_sm90.cu splits the
// f32 operands of bf16 inputs instead).  N and P up to 64 are zero-padded
// to the tile; L up to 256.
// Each block recomputes the head-free scores C B^T for its own head (H
// times the reference's count of that product).
//
// What bounds it on the H100: operations.  At the prefill shape, per
// launch, the head-free masked C B^T once per chunk plus, per head, the
// lower-triangle scores x (dt x), C S and the state update: 1.21e11 f32
// flops, 1.806 ms at 67 TFLOP/s, against 1.43e9 bytes read and written
// once, 0.428 ms at 3.35 TB/s (H100 SXM data sheet, 700 W).
//
// Interface: one plain C entry point, launched on the caller's stream, no
// synchronisation, no allocation.  Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kClip = 60.f;
constexpr int kThreads = 256;
constexpr int kTile = 64;               // rows of a query / key tile; max N, P
constexpr int kLd = kTile + 4;          // smem row stride (16-byte aligned)
constexpr int kMaxChunk = 256;          // one row of the chunk per thread
constexpr int kLdB = kMaxChunk + 4;     // row stride of the chunk's B^T

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  float* y;
  float* state;
  int Bt, S, H, P, N, L;
  int64_t x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss;
  int vec;      // 16-byte row loads allowed (full 64-wide rows, aligned)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// Eight consecutive elements of a row as f32 (one 16-byte load for bf16,
// two for f32).
__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// `rows` x kTile block of a (S, cols) matrix (row stride ld) into dst:
// transposed (dst[col * dld + r]) or not (dst[r * dld + col]); rows at or
// past rows_valid and columns at or past cols are zero.  With `vec` (64
// columns, 16-byte aligned rows), each thread moves eight columns of one
// row with 16-byte loads, lanes walking rows, so the stores hit distinct
// banks (scalar when transposed, 16-byte otherwise).
template <typename T, bool kTranspose>
__device__ __forceinline__ void load_rows(float* dst, int dld, const T* src,
                                          int64_t ld, int rows,
                                          int rows_valid, int cols,
                                          bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * (kTile / 8); idx += kThreads) {
      const int r = idx % rows, c0 = idx / rows * 8;
      float v[8];
      if (r < rows_valid) {
        load8(v, src + r * ld + c0);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = 0.f;
      }
      if (kTranspose) {
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[(c0 + k) * dld + r] = v[k];
      } else {
        float4* d4 = reinterpret_cast<float4*>(dst + r * dld + c0);
        d4[0] = make_float4(v[0], v[1], v[2], v[3]);
        d4[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * kTile; idx += kThreads) {
    const int r = idx % rows, col = idx / rows;
    const float v = (r < rows_valid && col < cols)
                        ? to_f32(src[r * ld + col]) : 0.f;
    if (kTranspose)
      dst[col * dld + r] = v;
    else
      dst[r * dld + col] = v;
  }
}

// Shared memory, in floats.
struct Smem {
  float* bt;     // the chunk's B, transposed: bt[n * kLdB + j]
  float* xs;     // the chunk's x: xs[j * kLd + p]
  float* ct;     // C of the query tile, transposed: ct[n * kLd + i]
  float* st;     // scaled masked scores, transposed: st[j * kLd + i]
  float* state;  // state[n * kLd + p]
  float* dt;     // per row of the chunk
  float* pos;
  float* neg;
  float* coef;   // neg * dt
  float* w;      // dt * exp(cum[L-1] - cum)
  float* diag;   // rowsum(C * B) of the current query tile
  float* warp_tot;
};

constexpr int kSmemFloats = kTile * kLdB + kMaxChunk * kLd +
                            3 * kTile * kLd + 5 * kMaxChunk + kTile +
                            kThreads / 32 + 1;

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunked(Args a) {
  extern __shared__ __align__(16) float smem[];
  Smem sm;
  sm.bt = smem;
  sm.xs = sm.bt + kTile * kLdB;
  sm.ct = sm.xs + kMaxChunk * kLd;
  sm.st = sm.ct + kTile * kLd;
  sm.state = sm.st + kTile * kLd;
  sm.dt = sm.state + kTile * kLd;
  sm.pos = sm.dt + kMaxChunk;
  sm.neg = sm.pos + kMaxChunk;
  sm.coef = sm.neg + kMaxChunk;
  sm.w = sm.coef + kMaxChunk;
  sm.diag = sm.w + kMaxChunk;
  sm.warp_tot = sm.diag + kTile;

  const int bh = blockIdx.x;
  const int bi = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;    // 4 x 4 register tile
  const int lane = tid % 32, warp = tid / 32;
  const int L = a.L;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int l_pad = n_tiles * kTile;
  const float a_h = a.a[h];

  const T* xg = static_cast<const T*>(a.x) + bi * a.x_sb + h * a.x_sh;
  const float* dtg = a.dt + bi * a.dt_sb + h * a.dt_sh;
  const T* bg = static_cast<const T*>(a.b) + bi * a.b_sb;
  const T* cg = static_cast<const T*>(a.c) + bi * a.c_sb;

  for (int idx = tid; idx < kTile * kLd; idx += kThreads) sm.state[idx] = 0.f;

  for (int c0 = 0; c0 < a.S; c0 += L) {
    // ---- per-row vectors: cumsum of dt * a by a block scan ----------------
    __syncthreads();   // the previous chunk is done with smem
    const bool row_ok = tid < L;
    const float dtv = row_ok ? dtg[(c0 + tid) * a.dt_ss] : 0.f;
    float cum = dtv * a_h;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float up = __shfl_up_sync(0xffffffffu, cum, off);
      if (lane >= off) cum += up;
    }
    if (lane == 31) sm.warp_tot[warp] = cum;
    // the chunk's B (transposed) and x, every row loaded once
    load_rows<T, true>(sm.bt, kLdB, bg + c0 * a.b_ss, a.b_ss, l_pad, L, a.N,
                       a.vec);
    load_rows<T, false>(sm.xs, kLd, xg + c0 * a.x_ss, a.x_ss, l_pad, L, a.P,
                        a.vec);
    __syncthreads();
    if (warp == 0) {
      float t = lane < kThreads / 32 ? sm.warp_tot[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < kThreads / 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, t, off);
        if (lane >= off) t += up;
      }
      if (lane < kThreads / 32) sm.warp_tot[lane] = t;   // inclusive
    }
    __syncthreads();
    if (warp > 0) cum += sm.warp_tot[warp - 1];
    if (tid == L - 1) sm.warp_tot[kThreads / 32] = cum;  // cum[L-1]
    __syncthreads();
    const float cum_last = sm.warp_tot[kThreads / 32];
    {
      const float pos = expf(cum);
      const float neg = expf(fminf(-cum, kClip));
      sm.dt[tid] = dtv;
      sm.pos[tid] = pos;
      sm.neg[tid] = neg;
      sm.coef[tid] = neg * dtv;
      sm.w[tid] = row_ok ? dtv * expf(cum_last - cum) : 0.f;
    }
    // (the first tile load below begins with a barrier)

    float upd[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) upd[r][c] = 0.f;

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = c0 + qt * kTile;
      const int q_rows = min(kTile, L - qt * kTile);
      __syncthreads();   // ct and st free
      load_rows<T, true>(sm.ct, kLd, cg + q0 * a.c_ss, a.c_ss, kTile,
                         q_rows, a.N, a.vec);
      __syncthreads();
      // inter-chunk term: C @ S (the state of the chunk's start)
      float inter[4][4], acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) inter[r][c] = acc[r][c] = 0.f;
#pragma unroll 8
      for (int n = 0; n < kTile; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(
            sm.ct + n * kLd + ty * 4);
        const float4 sv = *reinterpret_cast<const float4*>(
            sm.state + n * kLd + tx * 4);
        const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sb[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            inter[r][c] = fmaf(ca[r], sb[c], inter[r][c]);
      }

      const bool last_q = qt == n_tiles - 1;
      for (int kt = 0; kt <= qt; ++kt) {
        const float* btk = sm.bt + kt * kTile;
        const float* xsk = sm.xs + kt * kTile * kLd;
        // scores C B^T for this (query, key) tile pair
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
        for (int n = 0; n < kTile; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(
              sm.ct + n * kLd + ty * 4);
          const float4 bv = *reinterpret_cast<const float4*>(
              btk + n * kLdB + tx * 4);
          const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = fmaf(ca[r], bb[c], s[r][c]);
        }
        if (kt > 0) __syncthreads();   // the previous tile is done with st
        // mask (i >= j on the diagonal tile), scale key j by neg*dt, and
        // store transposed
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx * 4 + c;
          const float cj = sm.coef[kt * kTile + j];
          float v[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = ty * 4 + r;
            v[r] = (kt < qt || j <= i) ? s[r][c] * cj : 0.f;
          }
          *reinterpret_cast<float4*>(sm.st + j * kLd + ty * 4) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
        if (kt == qt && tid < kTile) {
          float d = 0.f;
          for (int n = 0; n < a.N; ++n)
            d = fmaf(sm.ct[n * kLd + tid], btk[n * kLdB + tid], d);
          sm.diag[tid] = d;
        }
        __syncthreads();
        // acc += st^T-tile @ xs
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) {
          const float4 sv = *reinterpret_cast<const float4*>(
              sm.st + j * kLd + ty * 4);
          const float4 xv = *reinterpret_cast<const float4*>(
              xsk + j * kLd + tx * 4);
          const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
          const float xb[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(sa[r], xb[c], acc[r][c]);
        }
        if (last_q) {
          // state update: upd[n][p] += sum_j (B[j][n] w[j]) x[j][p]
#pragma unroll 4
          for (int j = 0; j < kTile; ++j) {
            const float wj = sm.w[kt * kTile + j];
            const float4 xv = *reinterpret_cast<const float4*>(
                xsk + j * kLd + tx * 4);
            const float xb[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float bw = btk[(ty * 4 + r) * kLdB + j] * wj;
#pragma unroll
              for (int c = 0; c < 4; ++c)
                upd[r][c] = fmaf(bw, xb[c], upd[r][c]);
            }
          }
        }
      }
      // y = pos * acc + (1 - pos neg) dt diag x + pos * inter
      const float* xq = sm.xs + qt * kTile * kLd;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        if (i >= q_rows) continue;
        const int row = qt * kTile + i;
        const float pos = sm.pos[row];
        const float corr = (1.f - pos * sm.neg[row]) * sm.dt[row] *
                           sm.diag[i];
        float* dst = a.y + ((static_cast<int64_t>(bi) * a.S + c0 + row) *
                                a.H + h) * a.P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx * 4 + c;
          if (p < a.P) {
            float v = pos * acc[r][c];
            v = v + corr * xq[i * kLd + p];
            v = v + pos * inter[r][c];
            dst[p] = v;
          }
        }
      }
    }
    // S = exp(cum[L-1]) S + upd, once every query tile has read S
    __syncthreads();
    const float decay = expf(cum_last);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* sp = sm.state + (ty * 4 + r) * kLd + tx * 4 + c;
        *sp = decay * *sp + upd[r][c];
      }
  }
  __syncthreads();
  float* out = a.state + static_cast<int64_t>(bh) * a.N * a.P;
  for (int idx = tid; idx < a.N * a.P; idx += kThreads) {
    const int n = idx / a.P, p = idx % a.P;
    out[idx] = sm.state[n * kLd + p];
  }
}

bool vec16(const void* p, int64_t sb, int64_t ss, int64_t sh, int elems) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % elems == 0 &&
         ss % elems == 0 && sh % elems == 0;
}

}  // namespace

// x, b, c: float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1), one dtype for
// the three; dt, a float32.  Strides are in elements, the last dim of
// every input contiguous.  y: contiguous (Bt, S, H, P) f32; state:
// contiguous (Bt, H, N, P) f32.  S must be a multiple of chunk.
extern "C" int repro_ssd(const void* x, const float* dt, const float* a,
                         const void* b, const void* c, float* y,
                         float* state, int Bt, int S, int H, int P, int N,
                         int chunk, int64_t x_sb, int64_t x_ss, int64_t x_sh,
                         int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
                         int64_t b_sb, int64_t b_ss, int64_t c_sb,
                         int64_t c_ss, int x_bf16, void* stream) {
  if (Bt <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (P <= 0 || P > kTile || N <= 0 || N > kTile || chunk <= 0 ||
      chunk > kMaxChunk || S < 0 || S % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(Bt) * H;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  args.x = x;
  args.dt = dt;
  args.a = a;
  args.b = b;
  args.c = c;
  args.y = y;
  args.state = state;
  args.Bt = Bt;
  args.S = S;
  args.H = H;
  args.P = P;
  args.N = N;
  args.L = chunk;
  args.x_sb = x_sb;
  args.x_ss = x_ss;
  args.x_sh = x_sh;
  args.dt_sb = dt_sb;
  args.dt_ss = dt_ss;
  args.dt_sh = dt_sh;
  args.b_sb = b_sb;
  args.b_ss = b_ss;
  args.c_sb = c_sb;
  args.c_ss = c_ss;
  const int elems = x_bf16 ? 8 : 4;      // elements in 16 bytes
  args.vec = P == kTile && N == kTile && vec16(x, x_sb, x_ss, x_sh, elems) &&
             vec16(b, b_sb, b_ss, 0, elems) && vec16(c, c_sb, c_ss, 0, elems);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int smem = kSmemFloats * sizeof(float);
  cudaError_t err;
  if (x_bf16) {
    err = cudaFuncSetAttribute(ssd_chunked<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunked<bf16><<<static_cast<int>(blocks), kThreads, smem, s>>>(args);
  } else {
    err = cudaFuncSetAttribute(ssd_chunked<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunked<float><<<static_cast<int>(blocks), kThreads, smem, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}
