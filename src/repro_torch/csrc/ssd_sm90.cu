// Chunked Mamba2 SSD scan on Hopper: bf16 tensor cores (wgmma) with the
// f32 operand of each product split in two bf16 terms, chunks in parallel.
//
// Replaces: src/repro/kernels/ssd.py::_ssd_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.ssd, impl "pallas"), for bf16 x, B, C (the
// prefill path of zamba2-7b).  f32 inputs and shapes outside the limits
// below run ssd_chunked in csrc/ssd.cu; the Python wrapper picks the
// variant.  Same function, chunk by chunk of L rows for each (batch,
// head), with the state S (N x P, f32) starting at zero:
//
//   cum = cumsum(dt * a);  pos = exp(cum);  neg = exp(min(-cum, 60))
//   y   = pos * (tril(C B^T) @ ((neg * dt) * x))
//       + ((1 - pos * neg) * dt * rowsum(C * B)) * x      exact diagonal
//       + pos * (C @ S)                                   inter-chunk
//   S   = exp(cum[L-1]) * S + (B * dt * exp(cum[L-1] - cum))^T @ x
//
// y and the final state in f32.  Layout: x (Bt, S, H, P), dt (Bt, S, H),
// a (H,), b/c (Bt, S, N) shared by the heads of a batch entry, read
// through their strides (last dim contiguous; b and c may be column views
// of one packed tensor).  y is a contiguous (Bt, S, H, P) f32 tensor, the
// final state a contiguous (Bt, H, N, P) f32 tensor.  S % L == 0 (the
// wrapper pads), L a multiple of 64 up to 256, N and P up to 64.
//
// What bounds it on the H100: bytes.  At zamba2-7b's prefill (x 1 x 32768
// x 112 x 64 bf16, chunk 256) x, dt, a, b, c read once and y, the state
// written once are 1.43e9 bytes, 0.428 ms at 3.35 TB/s; the products with
// the two-term split are ~2.4e11 flops, ~0.25 ms at 989 TFLOP/s (H100 SXM
// data sheet, 700 W).  The design, against csrc/ssd.cu's limits (f32 on
// the CUDA cores, one block per (batch, head) walking 128 chunks in
// order, scores recomputed per head, synchronous loads):
//
//   * Tensor cores with a split operand.  x, B and C are exactly bf16.
//     The scores C B^T are one bf16 wgmma (f32 accumulation).  Each other
//     product has one f32 operand: tril(C B^T) * neg * dt (intra-chunk),
//     the state S (inter-chunk C S) and B * dt * exp(cum_L - cum) (state
//     update).  It is split as hi = bf16(v), lo = bf16(v - hi) and each
//     product runs twice, hi and lo, against the exact bf16 operand:
//     ~2^-17 relative error an element, against 2^-24 in f32 (bf16 keeps
//     f32's exponent range, so neg up to e^60 does not overflow).  A third
//     term was not needed (PERF.md).
//   * Chunks in parallel, three kernels on the stream:
//       (a) ssd_chunk_state: per (batch, chunk, pair of heads) the chunk's
//           own state dS = (B * w)^T x (A from registers, x from shared
//           memory) and its decay exp(cum_L), into a scratch of
//           (Bt, chunks, H, 64, 64) f32;
//       (b) ssd_state_pass: per (batch, head, state element) the serial
//           recurrence S_c+1 = exp(cum_L,c) S_c + dS_c over the chunks,
//           S_c written in place of dS_c, and the final state;
//       (c) ssd_chunk_scan: per (batch, chunk, pair of heads) the output.
//     x is read twice and the states (235 MB at the prefill shape)
//     written twice and read twice: ~2.8e9 bytes, ~0.85 ms at 3.35 TB/s,
//     twice the bound, in exchange for 7168 independent blocks a pass.
//     A variant that folded (b) into (a), each chunk's block taking a
//     ticket in chunk order and waiting behind a flag for its
//     predecessor's state, ran slower: its chain of 128 dependent steps,
//     not its bytes, bounded it (PERF.md).
//   * Scores shared across heads.  A pass-(c) block holds one chunk's C
//     and B and the x of two heads.  Its two consumer warpgroups take the
//     64-row query tiles {0, 3} and {1, 2} (5 of the 10 lower-triangle
//     tile pairs each at L = 256): for each tile pair the 64 x 64 score
//     tile is one wgmma chain into registers, masked on the diagonal, and
//     scaled by each head's neg * dt into that head's A fragments, so the
//     scores are computed once for two heads.  Two heads, not more: each
//     head holds a 64 x 64 f32 accumulator (32 registers a thread) next
//     to the scores (32) and the split fragments (32 a head).
//   * Asynchronous loads.  Tiles arrive by TMA (cp.async.bulk.tensor,
//     boxes of 64 rows x 64 columns in the 128-byte swizzle that wgmma
//     reads, zero-filled past N or P) on one mbarrier a 64-row tile, in
//     row order, while the block computes cum and its decays and splits
//     the f32 state into bf16 hi/lo tiles; a query tile's products start
//     once its rows and those before it are in.  bf16 stays bf16 in
//     shared memory.  Padding N and P to 64 costs work only at the small
//     widths of the tests.
//
// Not yet done (later work): overlapping one block's loads with the
// previous block's math (blocks are not persistent, and a pass-(c) block
// takes 169 KB of shared memory, so one runs per SM), a TMA store of y.
//
// Interface: one plain C entry point, launched on the caller's stream, no
// synchronisation, no allocation (the wrapper allocates the scratch).
// Returns the cudaError_t of the launches; cudaErrorInvalidValue for
// arguments TMA or the kernels cannot take.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr float kClip = 60.f;
constexpr int kThreads = 256;                 // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                     // rows of a tile; N, P padded
constexpr int kTileBytes = kTile * 128;       // 64 rows of 64 bf16
constexpr int kMaxChunk = 256;
constexpr int kChunkBytes = kMaxChunk * 128;  // one chunk's rows, 64 bf16
constexpr int kHeads = 2;                     // heads a block
constexpr int kStateElems = kTile * kTile;    // padded N x P state
// dynamic shared memory: B and x tiles (state pass), C, B, x tiles and the
// split state (scan), each behind a 1024-byte alignment slack
constexpr int kSmemState = (1 + kHeads) * kChunkBytes + 1024;
constexpr int kSmemScan = (2 + kHeads) * kChunkBytes +
                          2 * kHeads * kTileBytes + 1024;

struct Params {
  const float* dt;
  const float* a;
  float* y;
  float* state;
  float* states;   // (Bt, nc, H, 64, 64) f32: dS_c, then S_c
  float* decay;    // (Bt, nc, H) f32: exp(cum_L) of each chunk
  int Bt, S, H, P, N, L, nc, hp;   // hp: head pairs
  int64_t dt_sb, dt_ss, dt_sh;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of bf16 element (row, col) in a tile of 128-byte rows in
// TMA's 128-byte swizzle (16-byte chunk index XOR row % 8; the tile
// 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

// ---------------------------------------------------------------------------
// mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Waits for the phase of the given parity to complete; traps after ~2^24
// tries (a lost load) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int tries = 0; !done; ++tries) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (tries > (1 << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}
// K-major: the reduction dim runs along a 128-byte row, 8-row atoms 1024
// bytes apart; a k-step of 16 is 32 bytes on.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// N-major: the output columns run along a 128-byte row, the reduction dim
// down the rows in 8-row atoms 1024 bytes apart; a k-step of 16 is 16 rows
// (2048 bytes) on.  Tiles are 64 columns wide, so the leading offset (to
// the next 64 columns) is unused.
__device__ __forceinline__ uint64_t desc_n_major(uint32_t addr) {
  return smem_desc(addr, kTileBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching accumulators across an async wgmma.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define WGMMA_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
  "%28, %29, %30, %31}"
#define WGMMA_D32_OUT(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
      "+f"(d[30]), "+f"(d[31])

// d (+)= A B for one m64n64k16 step, A and B both K-major in shared
// memory; accumulate = 0 overwrites d.  (The scores C B^T.)
__device__ __forceinline__ void wgmma_ss_kk(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for one m64n64k16 step, A K-major and B N-major in shared
// memory.  (The inter-chunk C S.)
__device__ __forceinline__ void wgmma_ss_kn(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WGMMA_D32_OUT(d)
      : "l"(da), "l"(db), "r"(1));
}

// d += A B for one m64n64k16 step, A (bf16 fragments) in registers, B
// N-major in shared memory.  (The intra-chunk term and the chunk state.)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Two f32 values (consecutive columns of a fragment row) split as
// hi = bf16(v), lo = bf16(v - hi), each pair packed low column first.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Inclusive prefix sum of one value a thread over the block (rows in
// thread order), and the block's total.  Contains two barriers.
__device__ __forceinline__ float block_scan(float v, float* warp_tot,
                                            float& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += up;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  float base = 0.f;
  total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) base = total;
    total += warp_tot[w];
  }
  __syncthreads();
  return v + base;
}

// Block index -> (batch, chunk, first head); head pairs run fastest, so
// the blocks in flight share one chunk's B and C in L2.
struct Work {
  int b, c, h0, nh, row0;
};
__device__ __forceinline__ Work work_at(const Params& p) {
  Work w;
  int idx = blockIdx.x;
  w.h0 = (idx % p.hp) * kHeads;
  idx /= p.hp;
  w.c = idx % p.nc;
  w.b = idx / p.nc;
  w.nh = min(kHeads, p.H - w.h0);
  w.row0 = w.c * p.L;
  return w;
}

__device__ __forceinline__ float load_dt(const Params& p, const Work& w,
                                         int h) {
  return threadIdx.x < p.L
             ? p.dt[w.b * p.dt_sb + (w.row0 + threadIdx.x) * p.dt_ss +
                    h * p.dt_sh]
             : 0.f;
}

// ---------------------------------------------------------------------------
// (a) chunk states
// ---------------------------------------------------------------------------

// Warpgroup hh computes head h0 + hh's dS (64 x 64, rows n, columns p):
// A[n][j] = B[j][n] * w[j] split in registers, against x (rows j) in
// shared memory, 16 k-steps at L = 256.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_state(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tb, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kMaxChunk / kTile];
  __shared__ float w_s[kHeads][kMaxChunk];
  __shared__ float warp_tot[kWarps];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t b_s = base, x_s = base + kChunkBytes;
  const Work w = work_at(p);
  const int L = p.L, tiles = L / kTile;
  const uint32_t bar0 = smem_u32(bars);

  // one barrier a 64-row tile, so the products start on the first tiles
  if (threadIdx.x == 0)
    for (int t = 0; t < tiles; ++t) mbar_init(bar0 + 8 * t, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < tiles; ++t) {
      const uint32_t bar = bar0 + 8 * t;
      const int row = w.row0 + t * kTile;
      mbar_expect_tx(bar, (1 + w.nh) * kTileBytes);
      tma_load_3d(b_s + t * kTileBytes, &tb, bar, 0, row, w.b);
      for (int hh = 0; hh < w.nh; ++hh)
        tma_load_4d(x_s + hh * kChunkBytes + t * kTileBytes, &tx, bar, 0,
                    row, w.h0 + hh, w.b);
    }
  }
  // the weights w = dt exp(cum_L - cum) and the decay while tiles load
  float dtv[kHeads];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh)
    dtv[hh] = hh < w.nh ? load_dt(p, w, w.h0 + hh) : 0.f;
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    if (hh >= w.nh) break;
    const int h = w.h0 + hh;
    float cum_l;
    const float cum = block_scan(dtv[hh] * p.a[h], warp_tot, cum_l);
    if (threadIdx.x < L)
      w_s[hh][threadIdx.x] = dtv[hh] * expf(cum_l - cum);
    if (threadIdx.x == 0)
      p.decay[(static_cast<int64_t>(w.b) * p.nc + w.c) * p.H + h] =
          expf(cum_l);
  }
  __syncthreads();

  const int hh = threadIdx.x / 128;
  if (hh >= w.nh) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const float* wt = w_s[hh];
  const uint32_t xs = x_s + hh * kChunkBytes;
  auto bv = [&](int j, int n) {
    return __bfloat162float(
        *reinterpret_cast<const __nv_bfloat16*>(gbase + swz(j, n)));
  };
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < tiles; ++kb) {
    mbar_wait(bar0 + 8 * kb, 0);
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = kb * kTile + kk * 16 + t2;
      const float w0 = wt[j], w1 = wt[j + 1], w8 = wt[j + 8],
                  w9 = wt[j + 9];
      split2(bv(j, r0) * w0, bv(j + 1, r0) * w1, ahi[kk][0], alo[kk][0]);
      split2(bv(j, r1) * w0, bv(j + 1, r1) * w1, ahi[kk][1], alo[kk][1]);
      split2(bv(j + 8, r0) * w8, bv(j + 9, r0) * w9, ahi[kk][2],
             alo[kk][2]);
      split2(bv(j + 8, r1) * w8, bv(j + 9, r1) * w9, ahi[kk][3],
             alo[kk][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_n_major(xs + (kb * kTile + kk * 16) * 128);
      wgmma_rs(acc, ahi[kk], db);
      wgmma_rs(acc, alo[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  float* dst = p.states +
               ((static_cast<int64_t>(w.b) * p.nc + w.c) * p.H + w.h0 + hh) *
                   kStateElems;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + t2;
    *reinterpret_cast<float2*>(dst + r0 * kTile + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(dst + r1 * kTile + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// (b) state passing
// ---------------------------------------------------------------------------

// Four elements of the padded 64 x 64 state of one (batch, head) a thread:
// walks the chunks in order, leaving the state at each chunk's start in
// place of the chunk's dS, and writes the final state.  The loads do not
// depend on the running state, so each batch of kBatch chunks issues its
// 16-byte loads before any arithmetic: a thread keeps kBatch loads in
// flight, which the bytes in flight across the card need (with one load a
// thread in flight, this pass was bound by the loads' latency).
constexpr int kBatch = 16;
__global__ void __launch_bounds__(kThreads)
    ssd_state_pass(const Params p) {
  const int bh = blockIdx.x;
  const int e = (blockIdx.y * kThreads + threadIdx.x) * 4;
  const int bi = bh / p.H, h = bh % p.H;
  const int64_t step = static_cast<int64_t>(p.H) * kStateElems / 4;
  float4* __restrict__ sp = reinterpret_cast<float4*>(
      p.states + (static_cast<int64_t>(bi) * p.nc * p.H + h) * kStateElems +
      e);
  const float* __restrict__ dec =
      p.decay + static_cast<int64_t>(bi) * p.nc * p.H + h;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < p.nc; c0 += kBatch) {
    float4 d[kBatch];
    float dc[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < p.nc) {
        d[k] = sp[(c0 + k) * step];
        dc[k] = dec[static_cast<int64_t>(c0 + k) * p.H];
      }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (c0 + k < p.nc) {
        sp[(c0 + k) * step] = s;
        s = make_float4(dc[k] * s.x + d[k].x, dc[k] * s.y + d[k].y,
                        dc[k] * s.z + d[k].z, dc[k] * s.w + d[k].w);
      }
  }
  const int n = e / kTile, col = e % kTile;
  if (n >= p.N) return;
  float* out = p.state + (static_cast<int64_t>(bh) * p.N + n) * p.P;
  const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (col + k < p.P) out[col + k] = v[k];
}

// ---------------------------------------------------------------------------
// (c) chunk scan
// ---------------------------------------------------------------------------

// y for one chunk and two heads (with an odd H the last block's second
// head runs on unloaded x and is not stored: the wgmma sequence stays
// free of branches, which ptxas would otherwise fence with waits).
// Warpgroup q takes query tiles q and
// 3 - q (those below L / 64).  For each, y's accumulator starts with
// C S (S split hi/lo, N-major in shared memory), then for each key tile
// at or below it: scores C B^T (K-major both), masked on the diagonal
// tile, times each head's neg * dt, split into A fragments against x.
__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_scan(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tc, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kMaxChunk / kTile];
  __shared__ float pos_s[kHeads][kMaxChunk], neg_s[kHeads][kMaxChunk];
  __shared__ float coef_s[kHeads][kMaxChunk], dt_s[kHeads][kMaxChunk];
  __shared__ float warp_tot[kWarps];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t c_off = 0, b_off = kChunkBytes, x_off = 2 * kChunkBytes;
  const uint32_t hi_off = (2 + kHeads) * kChunkBytes;
  const uint32_t lo_off = hi_off + kHeads * kTileBytes;
  const Work w = work_at(p);
  const int L = p.L, tiles = L / kTile;
  const uint32_t bar0 = smem_u32(bars);

  // one barrier a 64-row tile (C, B and x rows), in row order, so query
  // tile q starts once tiles 0..q are in
  if (threadIdx.x == 0)
    for (int t = 0; t < tiles; ++t) mbar_init(bar0 + 8 * t, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < tiles; ++t) {
      const uint32_t bar = bar0 + 8 * t;
      const int row = w.row0 + t * kTile;
      mbar_expect_tx(bar, (2 + w.nh) * kTileBytes);
      tma_load_3d(base + c_off + t * kTileBytes, &tc, bar, 0, row, w.b);
      tma_load_3d(base + b_off + t * kTileBytes, &tb, bar, 0, row, w.b);
      for (int hh = 0; hh < w.nh; ++hh)
        tma_load_4d(base + x_off + hh * kChunkBytes + t * kTileBytes, &tx,
                    bar, 0, row, w.h0 + hh, w.b);
    }
  }
  // While the tiles load: every global load of the prologue is issued
  // before any of them is used (dt, and the state at the chunk's start;
  // zeros for a missing second head), then the per-row decays, then the
  // state split into bf16 hi/lo tiles (rows n, columns p, swizzled as TMA
  // would).
  constexpr int kQuads = kStateElems / 4 / kThreads;   // float4s a thread
  float dtv[kHeads];
  float4 sv[kHeads][kQuads];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    const float4* src = reinterpret_cast<const float4*>(
        p.states +
        ((static_cast<int64_t>(w.b) * p.nc + w.c) * p.H + w.h0 + hh) *
            kStateElems);
    dtv[hh] = hh < w.nh ? load_dt(p, w, w.h0 + hh) : 0.f;
#pragma unroll
    for (int k = 0; k < kQuads; ++k)
      sv[hh][k] = hh < w.nh ? src[threadIdx.x + k * kThreads]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    if (hh >= w.nh) break;
    float cum_l;
    const float cum =
        block_scan(dtv[hh] * p.a[w.h0 + hh], warp_tot, cum_l);
    if (threadIdx.x < L) {
      const float neg = expf(fminf(-cum, kClip));
      pos_s[hh][threadIdx.x] = expf(cum);
      neg_s[hh][threadIdx.x] = neg;
      coef_s[hh][threadIdx.x] = neg * dtv[hh];
      dt_s[hh][threadIdx.x] = dtv[hh];
    }
  }
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const int q = threadIdx.x + k * kThreads;
      const float4 v = sv[hh][k];
      uint2 hi, lo;
      split2(v.x, v.y, hi.x, lo.x);
      split2(v.z, v.w, hi.y, lo.y);
      const uint32_t o = hh * kTileBytes + swz(q / 16, (q % 16) * 4);
      *reinterpret_cast<uint2*>(gbase + hi_off + o) = hi;
      *reinterpret_cast<uint2*>(gbase + lo_off + o) = lo;
    }
  // the split state is read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, t2 = (lane % 4) * 2;
  const int r0 = warp * 16 + g, r1 = r0 + 8;   // rows within a query tile
  for (int qi = 0; qi < 2; ++qi) {
    const int qt = qi == 0 ? wg : 3 - wg;
    if (qt >= tiles) continue;
    for (int t = 0; t <= qt; ++t) mbar_wait(bar0 + 8 * t, 0);
    const uint32_t cq = base + c_off + qt * kTileBytes;
    float acc[kHeads][32];
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hh][i] = 0.f;

    // inter-chunk: C S, S as hi + lo
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_k_major(cq + kk * 32);
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        const uint32_t so = hh * kTileBytes + kk * 16 * 128;
        wgmma_ss_kn(acc[hh], da, desc_n_major(base + hi_off + so));
        wgmma_ss_kn(acc[hh], da, desc_n_major(base + lo_off + so));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) fence_regs(acc[hh]);

    float dg0 = 0.f, dg1 = 0.f;   // rowsum(C * B) of rows r0, r1
    for (int kt = 0; kt <= qt; ++kt) {
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_kk(s, desc_k_major(cq + kk * 32),
                    desc_k_major(base + b_off + kt * kTileBytes + kk * 32),
                    kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if (kt == qt) {
        // the diagonal (kept for the exact-diagonal term), then the mask
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + t2 + e;
            if (col == r0) dg0 = s[4 * j + e];
            if (col == r1) dg1 = s[4 * j + 2 + e];
            if (col > r0) s[4 * j + e] = 0.f;
            if (col > r1) s[4 * j + 2 + e] = 0.f;
          }
        dg0 = quad_sum(dg0);
        dg1 = quad_sum(dg1);
      }
      uint32_t ahi[kHeads][4][4], alo[kHeads][4][4];
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
        const float* cf = coef_s[hh] + kt * kTile;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = kk * 16 + t2;
          const float c0 = cf[j], c1 = cf[j + 1], c8 = cf[j + 8],
                      c9 = cf[j + 9];
          split2(s[8 * kk] * c0, s[8 * kk + 1] * c1, ahi[hh][kk][0],
                 alo[hh][kk][0]);
          split2(s[8 * kk + 2] * c0, s[8 * kk + 3] * c1, ahi[hh][kk][1],
                 alo[hh][kk][1]);
          split2(s[8 * kk + 4] * c8, s[8 * kk + 5] * c9, ahi[hh][kk][2],
                 alo[hh][kk][2]);
          split2(s[8 * kk + 6] * c8, s[8 * kk + 7] * c9, ahi[hh][kk][3],
                 alo[hh][kk][3]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = desc_n_major(
              base + x_off + hh * kChunkBytes + (kt * kTile + kk * 16) * 128);
          wgmma_rs(acc[hh], ahi[hh][kk], db);
          wgmma_rs(acc[hh], alo[hh][kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hh = 0; hh < kHeads; ++hh) fence_regs(acc[hh]);
    }

    // y = pos * acc + (1 - pos neg) dt diag x, columns past P dropped
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      if (hh >= w.nh) break;
      const unsigned char* xh = gbase + x_off + hh * kChunkBytes;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = qt * kTile + (half ? r1 : r0);
        const float pos = pos_s[hh][i];
        const float corr = (1.f - pos * neg_s[hh][i]) * dt_s[hh][i] *
                           (half ? dg1 : dg0);
        float* dst = p.y + ((static_cast<int64_t>(w.b) * p.S + w.row0 + i) *
                                p.H + w.h0 + hh) * p.P;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + t2;
          if (col >= p.P) continue;
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xh + swz(i, col)));
          const int k = 4 * j + 2 * half;
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(pos * acc[hh][k] + corr * xf.x,
                          pos * acc[hh][k + 1] + corr * xf.y);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: reached through the runtime's
// entry-point query, so the library links against the runtime alone.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A stride TMA can take: positive and a multiple of 16 bytes (any value
// does for a dimension of size 1, which is never stepped).
bool tma_stride(int64_t elems, int size) {
  return size == 1 || (elems > 0 && (elems * 2) % 16 == 0 &&
                       elems * 2 < (1LL << 40));
}

// A bf16 map of rank 3 (cols, S, Bt) or 4 (cols, S, H, Bt), boxes of 64
// columns by 64 rows in the 128-byte swizzle; out-of-bounds columns read
// as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const int* sizes, const int64_t* strides) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4], st[3];
  cuuint32_t box[4], unit[4];
  for (int i = 0; i < rank; ++i) {
    dims[i] = static_cast<cuuint64_t>(sizes[i]);
    box[i] = i == 0 ? 64 : (i == 1 ? kTile : 1);
    unit[i] = 1;
    if (i > 0)
      st[i - 1] = sizes[i] == 1 ? 16
                                : static_cast<cuuint64_t>(strides[i - 1]) * 2;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, st, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t set_smem() {
  static bool ready = false;
  if (ready) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemState);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_scan,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemScan);
  ready = err == cudaSuccess;
  return err;
}

}  // namespace

// bf16 x, b, c; f32 dt, a.  Strides are in elements, the last dim of every
// input contiguous; x, b, c 16-byte aligned and every stride of a
// dimension longer than 1 a positive multiple of 8 elements (TMA's rule).
// y: contiguous (Bt, S, H, P) f32; state: contiguous (Bt, H, N, P) f32;
// states: (Bt, S / chunk, H, 64, 64) f32 and decay (Bt, S / chunk, H) f32
// scratch.  S a multiple of chunk; chunk a multiple of 64 up to 256; N, P
// up to 64.
extern "C" int repro_ssd_sm90(const void* x, const float* dt, const float* a,
                              const void* b, const void* c, float* y,
                              float* state, float* states, float* decay,
                              int Bt, int S, int H, int P, int N, int chunk,
                              int64_t x_sb, int64_t x_ss, int64_t x_sh,
                              int64_t dt_sb, int64_t dt_ss, int64_t dt_sh,
                              int64_t b_sb, int64_t b_ss, int64_t c_sb,
                              int64_t c_ss, void* stream) {
  if (Bt <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (P <= 0 || P > kTile || N <= 0 || N > kTile || chunk < kTile ||
      chunk > kMaxChunk || chunk % kTile != 0 || S < 0 || S % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[3] = {x, b, c};
  for (const void* q : ptrs)
    if (reinterpret_cast<uintptr_t>(q) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  if (!tma_stride(x_ss, S) || !tma_stride(x_sh, H) || !tma_stride(x_sb, Bt) ||
      !tma_stride(b_ss, S) || !tma_stride(b_sb, Bt) || !tma_stride(c_ss, S) ||
      !tma_stride(c_sb, Bt))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.dt = dt;
  p.a = a;
  p.y = y;
  p.state = state;
  p.states = states;
  p.decay = decay;
  p.Bt = Bt;
  p.S = S;
  p.H = H;
  p.P = P;
  p.N = N;
  p.L = chunk;
  p.nc = S / chunk;
  p.hp = (H + kHeads - 1) / kHeads;
  p.dt_sb = dt_sb;
  p.dt_ss = dt_ss;
  p.dt_sh = dt_sh;
  const long long blocks = static_cast<long long>(Bt) * p.nc * p.hp;
  if (blocks > INT_MAX || static_cast<long long>(Bt) * H > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 pass_grid(Bt * H, kStateElems / 4 / kThreads);
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.nc > 0) {
    CUtensorMap tx, tb, tc;
    const int xs[4] = {P, S, H, Bt}, bs[3] = {N, S, Bt};
    const int64_t xst[3] = {x_ss, x_sh, x_sb}, bst[2] = {b_ss, b_sb},
                  cst[2] = {c_ss, c_sb};
    if (!make_map(&tx, x, 4, xs, xst) || !make_map(&tb, b, 3, bs, bst) ||
        !make_map(&tc, c, 3, bs, cst))
      return static_cast<int>(cudaErrorInvalidValue);
    ssd_chunk_state<<<static_cast<int>(blocks), kThreads, kSmemState, s>>>(
        tx, tb, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_state_pass<<<pass_grid, kThreads, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_scan<<<static_cast<int>(blocks), kThreads, kSmemScan, s>>>(
        tx, tb, tc, p);
  } else {
    ssd_state_pass<<<pass_grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
