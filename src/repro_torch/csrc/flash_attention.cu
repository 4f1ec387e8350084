// Flash attention on Hopper: block-wise online-softmax attention.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// Pallas TPU kernel behind repro.kernels.ops.flash_attention, impl
// "pallas").  Same function: for each (batch, head) and query row i at
// position i + q_offset, scores (q . k) * scale in f32 (the scale applied
// after the dot); keys masked to -1e30 at or past kv_len, after the query
// (causal) or window or more positions behind it; running (acc, m, l) in
// f32 with masked probabilities forced to 0; out = acc / max(l, 1e-30) in
// q's dtype, so a fully masked row comes out 0.
//
// Head dims 16, 32, 48, 64, 112 (zamba2-7b: 3584 / 32; 7 x 16 fits the
// m16n8k16 tiles and a 224-byte row keeps 16-byte loads aligned) and 128.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, Hkv, D), read through their
// strides (the head dim contiguous), no transposed or padded copies; query
// head h reads kv head h / (H / Hkv).  The ragged query and key edges are
// masked here.  out is a contiguous (B, Sq, H, D) tensor.
//
// Design.  The TPU kernel walks a (batch*heads, q blocks, kv blocks) grid
// in order, carrying (acc, m, l) in VMEM across the kv axis.  Here one
// block owns one (batch*head, query tile) and loops over the key tiles
// itself; the key tiles that the causal or window mask leaves empty for
// the whole query tile are skipped (an empty tile is an exact no-op of the
// online softmax: alpha = 1, p = 0).  Blocks are issued latest query tile
// first, so the long causal rows start early.
//
// What bounds it on the H100: at transformer-big's causal prefill
// (32768 x 32768, 16 heads, D = 64, bf16) the two products, 4·D flops per
// unmasked (query, key) pair and head, ~2.2e12 flops, ~2.2 ms at the bf16
// tensor cores' 989 TFLOP/s (H100 SXM data sheet, 700 W); at one query
// row per sequence (the decode step's cross-attention) the bytes of k and
// v.  Two variants:
//
//   * bf16 q, k, v -> flash_mma: four warps, 64 query rows (16 a warp) by
//     64 keys a tile, q/k/v tiles in shared memory (rows padded by 8 so the
//     fragment loads are free of bank conflicts), both products on the
//     tensor cores with mma.sync.m16n8k16 (bf16 in, f32 accumulate), the
//     K and V fragments read with ldmatrix (V transposed on the way).
//     QK^T on bf16 inputs gives the exact products that the Pallas kernel's
//     f32 casts give.  For P.V the probabilities are rounded to bf16 (the
//     row sum l is kept from the f32 probabilities); that rounding, and
//     exp(s - m) taken as exp2 of scores scaled by log2(e) (a few f32 ulps),
//     are the kernel's departures from the f32 arithmetic of the reference
//     and lie well inside its bf16 tolerance (3e-2).  Tiles load with
//     16-byte vectors when pointers and strides allow, else element by
//     element.  At D <= 64, 128 registers a thread let four blocks share
//     an SM, so one block's loads overlap the others' arithmetic.
//   * f32 q, k, v, or bf16 q with f32 k, v (the decode step given f32
//     encoder states) -> flash_simt: scalar f32 arithmetic, 16 query rows
//     (4 a warp) by 32 keys a tile, one key per lane for the scores and
//     the head dim spread over the lanes for the accumulator, so the
//     products are the reference's f32 products (f32 tolerance 3e-5).
//   In both, a warp whose query rows all lie past Sq skips the arithmetic
//   (it still loads tiles and meets the barriers): with one query row a
//   sequence, only one warp of the block computes.
//
// Not yet done (a later PR's work): wgmma, TMA and a pipelined ring of key
// tiles (the tile loads are synchronous); a split over keys for one-row
// queries.
//
// Interface: one plain C entry point, launched on the caller's stream, no
// synchronisation, no allocation.  Returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;                  // four warps
constexpr int kMmaRows = 64, kMmaKeys = 64;    // flash_mma tile
constexpr int kSimtRows = 16, kSimtKeys = 32;  // flash_simt tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, Sq, Sk;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window;
  float scale;
  int q_offset;
  int kv_end;   // min(kv_len, Sk): keys at or past it are masked
  int n_qt;     // query tiles per (batch, head)
  int vec;      // 16-byte tile loads allowed (flash_mma)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Block -> (batch, head, query tile), latest query tile first.
__device__ __forceinline__ void block_coords(const Args& a, int& b, int& h,
                                             int& qt) {
  const int bh_count = a.B * a.H;
  const int bh = blockIdx.x % bh_count;
  qt = a.n_qt - 1 - blockIdx.x / bh_count;
  b = bh / a.H;
  h = bh % a.H;
}

// The keys [lo, hi) that any query row in [q0, q1) may see.
__device__ __forceinline__ void key_range(const Args& a, int q0, int q1,
                                          int& lo, int& hi) {
  long long top = a.kv_end;
  if (a.causal) top = min(top, static_cast<long long>(q1) + a.q_offset);
  long long bottom = static_cast<long long>(q0) + a.q_offset - a.window + 1;
  hi = static_cast<int>(max(top, 0LL));
  lo = static_cast<int>(min(max(bottom, 0LL), static_cast<long long>(hi)));
}

__device__ __forceinline__ bool keep(const Args& a, long long qpos, int key) {
  return key < a.kv_end && (!a.causal || qpos >= key) &&
         qpos - key < a.window;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// flash_simt: f32 arithmetic for f32 inputs (and bf16 q with f32 k, v)
// ---------------------------------------------------------------------------

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads) flash_simt(Args a) {
  constexpr int R = kSimtRows / (kThreads / 32);  // query rows a warp
  constexpr int NV = (D + 31) / 32;               // head dims a lane
  __shared__ float qs[kSimtRows][D];
  __shared__ float ks[kSimtKeys][D + 1];          // +1: lanes read rows
  __shared__ float vs[kSimtKeys][D];
  int b, h, qt;
  block_coords(a, b, h, qt);
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * kSimtRows, q1 = min(q0 + kSimtRows, a.Sq);
  const TQ* q = static_cast<const TQ*>(a.q) + b * a.q_sb + h * a.q_sh;
  const TKV* k = static_cast<const TKV*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const TKV* v = static_cast<const TKV*>(a.v) + b * a.v_sb + hk * a.v_sh;
  for (int i = threadIdx.x; i < kSimtRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[r][d] = q0 + r < a.Sq ? to_f32(q[(q0 + r) * a.q_ss + d]) : 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m[R], l[R], acc[R][NV];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < NV; ++t) acc[i][t] = 0.f;
  }
  int lo, hi;
  key_range(a, q0, q1, lo, hi);
  for (int kt = lo / kSimtKeys * kSimtKeys; kt < hi; kt += kSimtKeys) {
    __syncthreads();
    for (int i = threadIdx.x; i < kSimtKeys * D; i += kThreads) {
      const int j = i / D, d = i % D, key = kt + j;
      const bool in = key < a.Sk;
      ks[j][d] = in ? to_f32(k[key * a.k_ss + d]) : 0.f;
      vs[j][d] = in ? to_f32(v[key * a.v_ss + d]) : 0.f;
    }
    __syncthreads();
    const int key = kt + lane;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = warp * R + i;
      if (q0 + r >= a.Sq) break;   // warp-uniform: rows past Sq idle
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qs[r][d], ks[lane][d], s);
      const bool ok = keep(a, static_cast<long long>(q0) + r + a.q_offset,
                           key);
      s = ok ? s * a.scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int t = 0; t < NV; ++t) acc[i][t] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kSimtKeys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int t = 0; t < NV; ++t) {
          const int d = lane + 32 * t;
          if (D % 32 == 0 || d < D) acc[i][t] = fmaf(pj, vs[j][d], acc[i][t]);
        }
      }
      m[i] = m_new;
    }
  }
  TQ* out = static_cast<TQ*>(a.o);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + warp * R + i;
    if (row >= a.Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    TQ* dst = out + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int d = lane + 32 * t;
      if (D % 32 == 0 || d < D) store(dst + d, acc[i][t] / l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_mma: bf16 q, k, v on the tensor cores
// ---------------------------------------------------------------------------

// c += a * b for one m16n8k16 tile: a (16x16, row-major fragments), b
// (16x8, column fragments), c (16x8) f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands each thread a column pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ROWS x D tile from rows of src (row_stride apart) into dst (rows of
// D + 8); rows at or past `rows` are zero.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t row_stride, int rows,
                                          bool vec) {
  constexpr int LD = D + 8;
  if (vec) {
    constexpr int CH = D / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
      const int r = i / D, d = i % D;
      dst[r * LD + d] = r < rows ? src[r * row_stride + d]
                                 : __float2bfloat16(0.f);
    }
  }
}

// D <= 64 fits four blocks an SM in 128 registers a thread; D = 112 and
// D = 128 need more registers than that and run uncapped.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 4 : 1)
    flash_mma(Args a) {
  constexpr int LD = D + 8;
  constexpr int NT = kMmaKeys / 8;     // score tiles (n8) a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kMmaRows * LD;
  bf16* vs = ks + kMmaKeys * LD;
  int b, h, qt;
  block_coords(a, b, h, qt);
  const int hk = h / (a.H / a.Hkv);
  const int q0 = qt * kMmaRows, q1 = min(q0 + kMmaRows, a.Sq);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  load_tile<kMmaRows, D>(qs, q + q0 * a.q_ss, a.q_ss, a.Sq - q0, a.vec);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;
  const int ra = warp * 16 + g;        // this thread's rows: ra, ra + 8
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p0 = qs + ra * LD + kk * 16 + t2;
    qa[kk][0] = lds32(p0);
    qa[kk][1] = lds32(p0 + 8 * LD);
    qa[kk][2] = lds32(p0 + 8);
    qa[kk][3] = lds32(p0 + 8 * LD + 8);
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // scores are kept in log2 units (s * log2 e), so exp(s - m) is one
  // exp2; the mask value stays -1e30
  const float scale2 = a.scale * 1.4426950408889634f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const long long qpos0 = static_cast<long long>(q0) + ra + a.q_offset;
  const long long qpos1 = qpos0 + 8;
  const long long qpos_min = static_cast<long long>(q0) + a.q_offset;
  const long long qpos_max = static_cast<long long>(q1) - 1 + a.q_offset;

  int lo, hi;
  key_range(a, q0, q1, lo, hi);
  for (int kt = lo / kMmaKeys * kMmaKeys; kt < hi; kt += kMmaKeys) {
    __syncthreads();
    load_tile<kMmaKeys, D>(ks, k + kt * a.k_ss, a.k_ss, a.Sk - kt, a.vec);
    load_tile<kMmaKeys, D>(vs, v + kt * a.v_ss, a.v_ss, a.Sk - kt, a.vec);
    __syncthreads();
    if (q0 + warp * 16 >= a.Sq) continue;   // warp-uniform: no rows here

    // S = Q K^T: B[k][n] = K[key n][dim k]; one ldmatrix.x4 gives the B
    // fragments of score tiles n and n + 1 (keys n*8.., dims kk*16..)
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + ((n + lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                        (lane / 8 % 2) * 8);
        mma_bf16(s[n], qa[kk], kb[0], kb[1]);
        mma_bf16(s[n + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // scale, mask (skipped for a tile no mask reaches), row max
    const bool full = kt + kMmaKeys <= a.kv_end &&
                      (!a.causal || kt + kMmaKeys - 1 <= qpos_min) &&
                      qpos_max - kt < a.window;
    uint32_t kept = 0xffffffffu;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if (!full && !keep(a, e < 2 ? qpos0 : qpos1, kt + n * 8 + t2 + (e & 1))) {
          x = kNegInf;
          kept &= ~(1u << (n * 4 + e));
        }
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (kept >> (n * 4 + e)) & 1u;
        const float p = ok ? exp2f(s[n][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        s[n][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
    l0 = l0 * al0 + quad_sum(ps0);
    l1 = l1 * al1 + quad_sum(ps1);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += P V: P's score tiles 2kk, 2kk+1 are the A fragment of key step
    // kk; B[k][n] = V[key k][dim n], read transposed by ldmatrix.trans
    // (keys kk*16.., dims n*8.. for output tiles n and n + 1)
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                              pack(s[2 * kk][2], s[2 * kk][3]),
                              pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + (kk * 16 + (lane / 8 % 2) * 8 + lane % 8) * LD +
                              (n + lane / 16) * 8);
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
    m0 = mn0;
    m1 = mn1;
  }

  const float inv0 = fmaxf(l0, 1e-30f), inv1 = fmaxf(l1, 1e-30f);
  bf16* out = static_cast<bf16*>(a.o);
  const int row0 = q0 + ra, row1 = row0 + 8;
  bf16* dst0 = out + ((static_cast<int64_t>(b) * a.Sq + row0) * a.H + h) * D;
  bf16* dst1 = dst0 + static_cast<int64_t>(8) * a.H * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + t2;
    if (row0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(dst0 + d) =
          __floats2bfloat162_rn(o[n][0] / inv0, o[n][1] / inv0);
    if (row1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(dst1 + d) =
          __floats2bfloat162_rn(o[n][2] / inv1, o[n][3] / inv1);
  }
}

bool vec16(const void* p, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}

template <int D>
cudaError_t launch(Args a, int q_bf16, int kv_bf16, cudaStream_t s) {
  const int rows = q_bf16 && kv_bf16 ? kMmaRows : kSimtRows;
  a.n_qt = (a.Sq + rows - 1) / rows;
  const long long blocks = static_cast<long long>(a.n_qt) * a.B * a.H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(blocks);
  if (q_bf16 && kv_bf16) {
    constexpr int smem = (kMmaRows + 2 * kMmaKeys) * (D + 8) * sizeof(bf16);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    flash_mma<D><<<grid, kThreads, smem, s>>>(a);
  } else if (!q_bf16 && !kv_bf16) {
    flash_simt<float, float, D><<<grid, kThreads, 0, s>>>(a);
  } else if (q_bf16) {
    flash_simt<bf16, float, D><<<grid, kThreads, 0, s>>>(a);
  } else {
    return cudaErrorInvalidValue;   // f32 q with bf16 k, v: not taken
  }
  return cudaGetLastError();
}

}  // namespace

// q_bf16 / kv_bf16: 1 for bfloat16, 0 for float32.  window: INT_MAX for
// none.  Strides are in elements.  out is contiguous (B, Sq, H, D) in q's
// dtype.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Hkv, int Sq, int Sk, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int causal, int window, float scale, int q_offset,
    int kv_len, int q_bf16, int kv_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.q_offset = q_offset;
  a.kv_end = kv_len < Sk ? kv_len : Sk;
  a.n_qt = 0;
  a.vec = vec16(q, q_sb, q_ss, q_sh) && vec16(k, k_sb, k_ss, k_sh) &&
          vec16(v, v_sb, v_ss, v_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(a, q_bf16, kv_bf16, s); break;
    case 32: err = launch<32>(a, q_bf16, kv_bf16, s); break;
    case 48: err = launch<48>(a, q_bf16, kv_bf16, s); break;
    case 64: err = launch<64>(a, q_bf16, kv_bf16, s); break;
    case 112: err = launch<112>(a, q_bf16, kv_bf16, s); break;
    case 128: err = launch<128>(a, q_bf16, kv_bf16, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
