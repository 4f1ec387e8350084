// Flash attention on Hopper, the prefill kernel: TMA ring, wgmma and
// warp specialisation.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel (the
// Pallas TPU kernel behind repro.kernels.ops.flash_attention, impl
// "pallas"), for bf16 q, k, v at head dims 64 (transformer-big), 112
// (zamba2-7b) and 128, with at least one 128-row query tile.  The other
// cases (head dims 16-48, one-row decode queries, f32 or mixed dtypes,
// pointers or strides that TMA cannot take) run flash_mma and flash_simt
// in csrc/flash_attention.cu; the Python wrapper picks the variant.
//
// Same function as there: scores (q . k) * scale in f32, the scale
// applied after the dot; keys masked to -1e30 at or past kv_len, after the
// query (causal) or window or more positions behind it; queries at
// i + q_offset; running (acc, m, l) in f32, masked probabilities 0;
// out = acc / max(l, 1e-30) in bf16, so a fully masked row comes out 0.
// Query head h reads kv head h / (H / Hkv).  q (B, Sq, H, D) and k, v
// (B, Sk, Hkv, D) are read through their strides (head dim contiguous);
// out is a contiguous (B, Sq, H, D).
//
// What bounds it on the H100: at the causal 32768-token prefills the two
// products, 4·D flops per unmasked (query, key) pair and head, on the
// bf16 tensor cores (989 TFLOP/s dense, H100 SXM data sheet, 700 W):
// ~2.2 ms at D = 64 (16 heads), ~7.8 ms at D = 112 (32 heads).  The
// design, for that bound:
//
//   * A work tile is 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows, and a producer warpgroup whose first thread
//     issues every load.  Tiles run head by head, latest query tile first
//     within a head, so the long causal rows start early and the blocks
//     in flight read one head's K and V from L2.  A block takes one tile,
//     or, where tiles see at most 1024 keys (the prefill's
//     cross-attention to 256 encoder states), blocks are persistent (one
//     an SM) and overlap one tile's output with the next tile's loads.
//   * Loads are TMA (cp.async.bulk.tensor, 4-D maps over (D, S, heads,
//     batch) with the tensors' own strides), completing on mbarriers.  The
//     Q tile loads once into one of two buffers; K and V tiles of 128
//     keys go through a ring of 3 stages (D = 64) or 2 (D = 112, 128) with
//     a full barrier each for K and V and one empty barrier that the 256
//     consumer threads release.
//   * Shared tiles are rows of 64 columns (128 bytes) in TMA's 128-byte
//     swizzle, the layout wgmma reads.  D = 112 is two such boxes, columns
//     0-63 and 64-127, and TMA's out-of-bounds fill writes zeros into
//     columns 112-127 (a 224-byte row is not a multiple of the swizzle
//     span; two boxes of one map keep one descriptor and one layout).  The
//     padding costs shared memory only: Q K^T runs 7 k-steps of 16, not 8,
//     and P V runs N = 64 and N = 48 on the two halves.
//   * S = Q K^T is wgmma m64n128k16 with Q and K both K-major in shared
//     memory; O += P V is wgmma with P from registers (the S accumulator
//     rounded to bf16 and re-packed as A fragments; l is kept from the f32
//     probabilities) and V read N-major from shared memory, the
//     transpose-B form.  Scores are kept in log2 units (one exp2 a
//     probability).
//   * setmaxnreg moves registers from the producer (40) to the consumers
//     (232): S (64), O (D/2) and P (32) of a thread stay in registers.
//   * Key tiles that the causal or window mask leaves empty for the whole
//     query tile are not loaded; the mask is evaluated only on tiles that
//     a mask reaches, and a consumer skips the products of a tile that is
//     empty for its 64 rows.
//
// Not yet done (a later PR's work): overlapping one warpgroup's softmax
// with its own next Q K^T (the two warpgroups overlap each other only;
// trial builds that held a second score tile spilled registers at
// D = 112, or had ptxas serialize the wgmmas, C7514), a TMA store of the
// output, a tile order that balances persistent blocks on long causal
// rows.
//
// Interface: one plain C entry point, launched on the caller's stream, no
// synchronisation, no allocation.  Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for arguments TMA or the kernel cannot take.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 128;                 // query rows a block
constexpr int kKeys = 128;                 // keys a tile
constexpr int kThreads = 384;              // producer + two consumer WGs
constexpr int kHalfBytes = kRows * 128;    // 128 rows of 64 bf16 columns
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kShortKeyTiles = 8;          // persistent up to 1024 keys

struct Params {
  void* o;
  int B, H, Hkv, Sq, Sk;
  int causal, window;
  float scale;
  int q_offset;
  int kv_end;   // min(kv_len, Sk): keys at or past it are masked
  int n_qt;     // query tiles per (batch, head)
};

template <int D>
struct Shape {
  static constexpr int kHalves = (D + 63) / 64;       // 64-column boxes
  static constexpr int kN1 = D - 64;                  // second box's width
  static constexpr int kTileBytes = kHalves * kHalfBytes;
  static constexpr int kStages = D > 64 ? 2 : 3;
  static constexpr int kSmem = kTileBytes * (2 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Waits for the phase of the given parity to complete.  A phase that
// never completes (a lost load) traps after ~2^24 tries rather than
// hanging the card.
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

// One box of a 4-D tensor map, coordinates innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
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
// K-major (rows of 64 columns, 8-row atoms 1024 bytes apart; the leading
// offset is unused within a 128-byte row).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// N-major (V: N runs along the 64 columns of a row, K down the rows in
// 8-row atoms 1024 bytes apart; the next 64 columns are a half tile on).
__device__ __forceinline__ uint64_t desc_n_major(uint32_t addr) {
  return smem_desc(addr, kHalfBytes, 1024);
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (+)= A B for one m64n128k16 step, A and B K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for one m64n64k16 step, A (bf16 fragments) in registers, B
// N-major in shared memory (the transpose-B form).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for one m64n48k16 step, A (bf16 fragments) in registers, B
// N-major in shared memory (the transpose-B form).
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The columns [lo, hi] of a key tile at kt that a query at qpos keeps:
// before kv_end, not after the query (causal), less than window behind.
__device__ __forceinline__ void kept_cols(const Params& a, long long qpos,
                                          int kt, int& lo, int& hi) {
  long long top = static_cast<long long>(a.kv_end) - 1 - kt;
  if (a.causal) top = min(top, qpos - kt);
  const long long bottom = qpos - kt - a.window + 1;
  hi = static_cast<int>(max(min(top, static_cast<long long>(kKeys)), -1LL));
  lo = static_cast<int>(max(min(bottom, static_cast<long long>(kKeys)), 0LL));
}

// One tile's scores (rows g and g + 8 of the thread's warp, columns
// 8j + t2 + {0, 1}) to probabilities in log2 units, masked outside
// [lo, hi] when kMasked, against the updated row maxima m (kept scaled,
// -1e30 while a row has seen only masked keys).  Returns each row's
// rescale factor for (acc, l); adds the thread's part of the
// probabilities' sum to l.  With kPositive (scale2 > 0, the attention
// scale) the maxima are taken on the raw scores and each probability is
// one fused multiply-add and one exp2, exp2(s * scale2 - m); otherwise
// the scores are scaled first.  A masked score's exp2 is 0 either way: a
// row with every key so far masked subtracts 0.
template <bool kMasked, bool kPositive>
__device__ __forceinline__ void softmax_tile(
    float (&s)[64], float scale2, int lo0, int hi0, int lo1, int hi1,
    int t2, float& m0, float& m1, float& l0, float& l1, float& al0,
    float& al1) {
  constexpr float kOff = kPositive ? -INFINITY : kNegInf;
  float mx0 = kOff, mx1 = kOff;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = kPositive ? s[4 * j + e] : s[4 * j + e] * scale2;
      if (kMasked) {
        const int c = 8 * j + t2 + (e & 1);
        const bool ok = e < 2 ? (c >= lo0 && c <= hi0)
                              : (c >= lo1 && c <= hi1);
        x = ok ? x : kOff;
      }
      s[4 * j + e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
    }
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  if (kPositive) {
    mx0 = mx0 == -INFINITY ? kNegInf : mx0 * scale2;
    mx1 = mx1 == -INFINITY ? kNegInf : mx1 * scale2;
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = ex2(m0 - mn0);
  al1 = ex2(m1 - mn1);
  const float sub0 = mn0 == kNegInf ? 0.f : mn0;
  const float sub1 = mn1 == kNegInf ? 0.f : mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sub = e < 2 ? sub0 : sub1;
      const float p = kPositive ? ex2(fmaf(s[4 * j + e], scale2, -sub))
                                : ex2(s[4 * j + e] - sub);
      s[4 * j + e] = p;
      if (e < 2) ps0 += p; else ps1 += p;
    }
  }
  l0 = l0 * al0 + ps0;
  l1 = l1 * al1 + ps1;
  m0 = mn0;
  m1 = mn1;
}

// softmax_tile for a tile that no mask reaches (full) or one that a mask
// does, at a positive scale or any other.
__device__ __forceinline__ void softmax_any(
    bool full, float (&s)[64], float scale2, const Params& a,
    long long qpos0, long long qpos1, int kt, int t2, float& m0, float& m1,
    float& l0, float& l1, float& al0, float& al1) {
  if (full) {
    if (scale2 > 0.f)
      softmax_tile<false, true>(s, scale2, 0, 0, 0, 0, t2, m0, m1, l0, l1,
                                al0, al1);
    else
      softmax_tile<false, false>(s, scale2, 0, 0, 0, 0, t2, m0, m1, l0, l1,
                                 al0, al1);
    return;
  }
  int lo0, hi0, lo1, hi1;
  kept_cols(a, qpos0, kt, lo0, hi0);
  kept_cols(a, qpos1, kt, lo1, hi1);
  if (scale2 > 0.f)
    softmax_tile<true, true>(s, scale2, lo0, hi0, lo1, hi1, t2, m0, m1, l0,
                             l1, al0, al1);
  else
    softmax_tile<true, false>(s, scale2, lo0, hi0, lo1, hi1, t2, m0, m1, l0,
                              l1, al0, al1);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Work tile t -> (batch, head, query tile), head by head and latest query
// tile first within a head (the tiles in flight share one head's K and V
// in L2), and the key tiles [t0, t0 + n_tiles) any of its rows may see.
struct Tile {
  int b, h, hk, q0, q1, t0, n_tiles;
};
__device__ __forceinline__ Tile tile_at(const Params& a, int t) {
  Tile w;
  const int bh = t / a.n_qt;
  const int qt = a.n_qt - 1 - t % a.n_qt;
  w.b = bh / a.H;
  w.h = bh % a.H;
  w.hk = w.h / (a.H / a.Hkv);
  w.q0 = qt * kRows;
  w.q1 = min(w.q0 + kRows, a.Sq);
  long long top = a.kv_end;
  if (a.causal) top = min(top, static_cast<long long>(w.q1) + a.q_offset);
  const int hi = static_cast<int>(max(top, 0LL));
  const long long bottom = static_cast<long long>(w.q0) + a.q_offset -
                           a.window + 1;
  const int lo = static_cast<int>(
      min(max(bottom, 0LL), static_cast<long long>(hi)));
  w.t0 = lo / kKeys;
  w.n_tiles = max(0, (hi + kKeys - 1) / kKeys - w.t0);
  return w;
}

// Block p takes work tiles p, p + gridDim.x, ...: one tile when the grid
// covers them all, several when the blocks are persistent.  The producer
// then loads the next tile's Q into the other of two Q buffers, and the
// ring of K and V runs on across tiles, while the consumers finish the
// current tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params a) {
  using S = Shape<D>;
  constexpr int kStages = S::kStages;
  extern __shared__ unsigned char smem_raw[];
  // barriers: q_full[2], q_empty[2], then per stage k_full, v_full, empty
  __shared__ __align__(8) uint64_t bars[4 + 3 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar0 = smem_u32(bars);
  auto q_full = [&](int qb) { return bar0 + 8u * qb; };
  auto q_empty = [&](int qb) { return bar0 + 8u * (2 + qb); };
  auto k_full = [&](int st) { return bar0 + 8u * (4 + 3 * st); };
  auto v_full = [&](int st) { return bar0 + 8u * (5 + 3 * st); };
  auto empty = [&](int st) { return bar0 + 8u * (6 + 3 * st); };
  auto q_tile = [&](int qb) { return base + S::kTileBytes * qb; };
  auto k_tile = [&](int st) { return base + S::kTileBytes * (2 + st); };
  auto v_tile = [&](int st) {
    return base + S::kTileBytes * (2 + kStages + st);
  };
  const int n_work = a.n_qt * a.B * a.H;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 2 * 128);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;                           // key tiles loaded so far
      for (int t = blockIdx.x, k = 0; t < n_work; t += gridDim.x, ++k) {
        const Tile w = tile_at(a, t);
        const int qb = k & 1;
        mbar_wait(q_empty(qb), ((k >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), S::kTileBytes);
#pragma unroll
        for (int hf = 0; hf < S::kHalves; ++hf)
          tma_load(q_tile(qb) + hf * kHalfBytes, &tq, q_full(qb), hf * 64,
                   w.q0, w.h, w.b);
        for (int i = 0; i < w.n_tiles; ++i, ++it) {
          const int st = it % kStages;
          const uint32_t phase = (it / kStages) & 1;
          const int kt = (w.t0 + i) * kKeys;
          mbar_wait(empty(st), phase ^ 1);
          mbar_expect_tx(k_full(st), S::kTileBytes);
#pragma unroll
          for (int hf = 0; hf < S::kHalves; ++hf)
            tma_load(k_tile(st) + hf * kHalfBytes, &tk, k_full(st), hf * 64,
                     kt, w.hk, w.b);
          mbar_expect_tx(v_full(st), S::kTileBytes);
#pragma unroll
          for (int hf = 0; hf < S::kHalves; ++hf)
            tma_load(v_tile(st) + hf * kHalfBytes, &tv, v_full(st), hf * 64,
                     kt, w.hk, w.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t2 = (lane % 4) * 2;
    const int r0 = cw * 64 + warp * 16 + g;   // this thread's rows r0, r0+8
    const float scale2 = a.scale * 1.4426950408889634f;   // log2 units
    int it = 0;                               // key tiles consumed so far
    for (int t = blockIdx.x, k = 0; t < n_work; t += gridDim.x, ++k) {
      const Tile w = tile_at(a, t);
      const int qb = k & 1;
      const uint32_t q_s = q_tile(qb);
      const long long qpos0 = static_cast<long long>(w.q0) + r0 + a.q_offset;
      const long long qpos1 = qpos0 + 8;
      const long long wq_min = static_cast<long long>(w.q0) + cw * 64 +
                               a.q_offset;
      const long long wq_max =
          min(static_cast<long long>(w.q0) + cw * 64 + 63,
              static_cast<long long>(a.Sq) - 1) + a.q_offset;

      float o0[32];
      float o1[S::kN1 > 0 ? S::kN1 / 2 : 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) o0[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (S::kN1 > 0 ? S::kN1 / 2 : 1); ++i) o1[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l per thread
      float s[64];
      mbar_wait(q_full(qb), (k >> 1) & 1);

      for (int i = 0; i < w.n_tiles; ++i, ++it) {
        const int st = it % kStages;
        const uint32_t phase = (it / kStages) & 1;
        const int kt = (w.t0 + i) * kKeys;
        const bool none = kt >= a.kv_end || (a.causal && kt > wq_max) ||
                          wq_min - (kt + kKeys - 1) >= a.window;
        mbar_wait(k_full(st), phase);
        if (!none) {
          // S = Q K^T: 64 rows x 128 keys, D/16 k-steps
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
            wgmma_ss_n128(s, desc_k_major(q_s + off + cw * 64 * 128),
                          desc_k_major(k_tile(st) + off), kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(s);

          // scale, mask (only where a mask reaches), online softmax
          const bool full = kt + kKeys <= a.kv_end &&
                            (!a.causal || kt + kKeys - 1 <= wq_min) &&
                            wq_max - kt < a.window;
          float al0, al1;
          softmax_any(full, s, scale2, a, qpos0, qpos1, kt, t2, m0, m1, l0,
                      l1, al0, al1);
          // rescale O only where a row's maximum moved (alpha != 1; once
          // the maxima settle, most tiles of a long row move none)
          if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              o0[4 * j] *= al0;
              o0[4 * j + 1] *= al0;
              o0[4 * j + 2] *= al1;
              o0[4 * j + 3] *= al1;
            }
            if constexpr (S::kN1 > 0) {
#pragma unroll
              for (int j = 0; j < S::kN1 / 8; ++j) {
                o1[4 * j] *= al0;
                o1[4 * j + 1] *= al0;
                o1[4 * j + 2] *= al1;
                o1[4 * j + 3] *= al1;
              }
            }
          }
          // P as bf16 A fragments: key step kk is score columns 16kk..+15
          uint32_t pa[8][4];
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
            pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
          }

          // O += P V: 8 key steps of 16, N = 64 (+ N = 48 or 64)
          mbar_wait(v_full(st), phase);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            const uint32_t v0 = v_tile(st) + kk * 16 * 128;
            wgmma_rs_n64(o0, pa[kk], desc_n_major(v0));
            if constexpr (S::kN1 == 48)
              wgmma_rs_n48(o1, pa[kk], desc_n_major(v0 + kHalfBytes));
            else if constexpr (S::kN1 == 64)
              wgmma_rs_n64(o1, pa[kk], desc_n_major(v0 + kHalfBytes));
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(o0);
          fence_regs(o1);
        } else {
          mbar_wait(v_full(st), phase);
        }
        mbar_arrive(empty(st));
      }
      mbar_arrive(q_empty(qb));      // every Q K^T of this tile is done

      // epilogue: out = o / max(l, 1e-30), rows past Sq dropped
      const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
      const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
      const int row0 = w.q0 + r0, row1 = row0 + 8;
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
      __nv_bfloat16* dst0 =
          out + ((static_cast<int64_t>(w.b) * a.Sq + row0) * a.H + w.h) * D;
      __nv_bfloat16* dst1 = dst0 + static_cast<int64_t>(8) * a.H * D;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 8 * j + t2;
        if (row0 < a.Sq)
          *reinterpret_cast<uint32_t*>(dst0 + d) =
              pack_bf16(o0[4 * j] * inv0, o0[4 * j + 1] * inv0);
        if (row1 < a.Sq)
          *reinterpret_cast<uint32_t*>(dst1 + d) =
              pack_bf16(o0[4 * j + 2] * inv1, o0[4 * j + 3] * inv1);
      }
      if constexpr (S::kN1 > 0) {
#pragma unroll
        for (int j = 0; j < S::kN1 / 8; ++j) {
          const int d = 64 + 8 * j + t2;
          if (row0 < a.Sq)
            *reinterpret_cast<uint32_t*>(dst0 + d) =
                pack_bf16(o1[4 * j] * inv0, o1[4 * j + 1] * inv0);
          if (row1 < a.Sq)
            *reinterpret_cast<uint32_t*>(dst1 + d) =
                pack_bf16(o1[4 * j + 2] * inv1, o1[4 * j + 3] * inv1);
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

// 4-D map over (D, S, heads, batch) of a bf16 tensor, boxes of 64 columns
// by 128 rows in the 128-byte swizzle; out-of-bounds rows and columns
// read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int heads,
              int B, int64_t ss, int64_t sh, int64_t sb) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  auto bytes = [](int64_t elems, int size) -> cuuint64_t {
    return size == 1 ? 16 : static_cast<cuuint64_t>(elems) * 2;
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(ss, S), bytes(sh, heads),
                                 bytes(sb, B)};
  const cuuint32_t box[4] = {64, kRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, Params a, cudaStream_t s) {
  static bool ready = false;
  if (!ready) {
    // setmaxnreg hands registers between warpgroups inside the block's
    // allocation: a build that allocated fewer than the consumers take
    // would stall them, so refuse it
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, flash_sm90<D>);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
      return cudaErrorInvalidConfiguration;
    err = cudaFuncSetAttribute(flash_sm90<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Shape<D>::kSmem);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  a.n_qt = (a.Sq + kRows - 1) / kRows;
  const long long work = static_cast<long long>(a.n_qt) * a.B * a.H;
  if (work > INT_MAX) return cudaErrorInvalidValue;
  // One work tile a block, so the blocks in flight are neighbours in the
  // tile order; persistent blocks (one an SM) where every tile sees few
  // key tiles, as cross-attention to a short encoder does, and a tile's
  // fixed cost (its Q load, its output store) is a large share of it.
  long long blocks = work;
  if ((a.kv_end + kKeys - 1) / kKeys <= kShortKeyTiles) {
    int device, sms;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    if (blocks > sms) blocks = sms;
  }
  flash_sm90<D><<<static_cast<int>(blocks), kThreads, Shape<D>::kSmem, s>>>(
      tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace

// bf16 q, k, v; D in {64, 112, 128}.  window: INT_MAX for none.  Strides
// are in elements; every pointer 16-byte aligned and every stride of a
// dimension longer than 1 a positive multiple of 8 elements (TMA's rule).
// out is contiguous (B, Sq, H, D) bf16.
extern "C" int repro_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int Hkv, int Sq, int Sk, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int causal, int window, float scale, int q_offset,
    int kv_len, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaSuccess);
  if (Hkv <= 0 || H % Hkv != 0 || Sk <= 0 ||
      (D != 64 && D != 112 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[3] = {q, k, v};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  if (!tma_stride(q_ss, Sq) || !tma_stride(q_sh, H) || !tma_stride(q_sb, B) ||
      !tma_stride(k_ss, Sk) || !tma_stride(k_sh, Hkv) ||
      !tma_stride(k_sb, B) || !tma_stride(v_ss, Sk) ||
      !tma_stride(v_sh, Hkv) || !tma_stride(v_sb, B))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Sq, H, B, q_ss, q_sh, q_sb) ||
      !make_map(&tk, k, D, Sk, Hkv, B, k_ss, k_sh, k_sb) ||
      !make_map(&tv, v, D, Sk, Hkv, B, v_ss, v_sh, v_sb))
    return static_cast<int>(cudaErrorInvalidValue);
  Params a;
  a.o = out;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.q_offset = q_offset;
  a.kv_end = kv_len < Sk ? kv_len : Sk;
  a.n_qt = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64: err = launch<64>(tq, tk, tv, a, s); break;
    case 112: err = launch<112>(tq, tk, tv, a, s); break;
    default: err = launch<128>(tq, tk, tv, a, s); break;
  }
  return static_cast<int>(err);
}
