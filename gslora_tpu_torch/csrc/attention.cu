// Fused multi-head attention for Hopper (sm_90a): forward and recompute
// backward over (BH, n, d) bf16 slices, with a plain C interface bound from
// Python by ctypes (gslora_tpu_torch/ops/attention.py).
//
// Replaces the Pallas TPU kernel K1 of gslora_tpu/ops/attention.py:
//   forward  -> _fwd_kernel, launched by _fwd_call (:149)
//   backward -> _bwd_kernel, launched by _fa_bwd   (:179)
// and computes what they compute, with the same rounding points:
//   fwd: dots = (q k^T in fp32) * scale; p = softmax_fp32(dots) over the full
//        row (max, exp, sum, then normalise); o = (bf16(p) v in fp32) -> bf16
//   bwd: recompute p; dv = bf16(p)^T g; dp = g v^T;
//        ddots = p * (dp - rowsum(dp * p))   (fp32 p and dp: the reference's
//                                             rowsum, not rowsum(g * o))
//        dq = bf16(ddots) k * scale; dk = bf16(ddots)^T q * scale
// No attention matrix is ever written to device memory.
//
// What bounds it: bytes. At the ViT-P8S8 shape (n = 197, d = 64) a slice
// moves 4 (forward) or 7 (backward) n x d bf16 tensors and does ~25 flop per
// byte, far below the H100's ~295 flop/byte ridge. So every n x n
// intermediate stays on chip, tiles move by TMA in both directions (no
// thread spends instructions on a copy or a store mask), and several blocks
// stay resident per SM so that one block's copies overlap another's math.
// After the bytes, the largest cost is the exact softmax's per-element
// work, so that work is cut to what the reference's numerics need: keys are
// padded to a multiple of 16, not 64, only the last block of 16 keys is
// masked, and the backward's keys kernel skips query blocks past n.
//
// Design. n_pad = 16 * ceil(n / 16) <= 256, so the score row of a 64-row
// query tile is at most 256 fp32 values and lives in registers: the softmax
// is the exact two-pass one the reference needs (normalise, then round p to
// bf16), with no online rescale and no score tile in shared memory.
//  * Every block is one warpgroup (128 threads). Products are Hopper wgmma
//    (m64nNk16, bf16 in, fp32 accumulate): operands from shared memory by
//    descriptor, or, for p and ddots, straight from the accumulator registers
//    as the A operand. Tiles reach shared memory by TMA (3-D tensor maps over
//    (BH, n, d), so rows past n of a slice arrive as zeros), completing on an
//    mbarrier, in the 32/64/128-byte swizzled layout that wgmma reads: one
//    row of a 64-column panel is one swizzle row (d = 64: 128 B).
//  * forward: one block per (slice, 64-row query tile). Q and K land on one
//    barrier, V on a second, which the scores and softmax overlap.
//    S = Q K^T into registers (m64n64 per 64 keys, m64n16/32/48 for the
//    rest); row max and sum by quad shuffles; O = bf16(p) V with p as
//    register A and V as an MN-major B operand. Outputs go out by stmatrix
//    into a tile that is no longer read (here Q's) and one TMA store, which
//    leaves rows past n unwritten.
//  * backward, two kernels, both deterministic (no atomics):
//    - rows: blocks as the forward's. Recomputes the score row as the forward
//      does, then dp = G V^T in chunks of up to 64 keys, once for
//      D = rowsum(dp * p) and once more for ddots, which feeds
//      dq = bf16(ddots) K from registers. Writes dq and the row statistics
//      m, l, 1 / l and D (4 fp32 per row, scratch from the wrapper).
//    - keys: one block per (slice, 64-key tile), as FlashAttention's
//      backward. K and V of the tile stay in shared memory; Q and G of each
//      query tile are double-buffered by TMA, its statistics by cp.async.
//      It recomputes S^T = K Q^T and dP^T = V G^T, forms p = exp(s - m) / l
//      and ddots from the statistics, and accumulates dv += bf16(p)^T G and
//      dk += bf16(ddots)^T Q in registers across the query tiles; a slice's
//      last query tile takes only its blocks of 16 queries that reach below
//      n (m64n16/32/48).
//    dq is owned by the rows kernel, so no partial sums cross blocks.
// Numerics that differ from a literal transcription, all within
// ops/attention.plain_mismatch: exp(x - m) is 2^(s * (scale log2 e) -
// m log2 e) by the special function unit (relative error ~2^-22), and
// p = e * (1 / l) with 1 / l correctly rounded (at most an ulp from e / l);
// m = max(s) * scale is the reference's max exactly (scale > 0). The keys
// kernel forms p with the same instructions from the same m and 1 / l, so
// both launches see the same p. Padded key columns are masked out of the
// softmax (-inf before the max); padded query rows read as zeros and are
// never stored. At head widths other than 64, keys are padded to 64 (fewer
// instantiations, a shorter build). The scale is a runtime argument.
// Faults planted by the mutation check sit on lines marked "mutation check".

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

using bf16 = __nv_bfloat16;

namespace {

constexpr int kThreads = 128;   // one warpgroup per block
constexpr int kTile = 64;       // rows of a query or key tile
constexpr int kBlock = 16;      // keys per score block: the k-step of P V
constexpr int kMaxBlocks = 16;  // n_pad <= 256: a score row stays in registers
constexpr int kMaxN = kBlock * kMaxBlocks;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// A tile of `rows` rows x D bf16 in shared memory: D / 64 panels of 64
// columns (one panel of D columns for D < 64), each panel row-major with one
// row per swizzle row (32, 64 or 128 bytes), 16-byte chunk c of row r stored
// at chunk c ^ (address bits 7..9): the Swizzle<B,4,3> that TMA writes and
// wgmma reads. Tiles start on 1024-byte boundaries and span whole 8-row atoms.
template <int D>
struct Smem {
  static constexpr int kRowBytes = D >= 64 ? 128 : 2 * D;
  static constexpr int kPanels = D >= 64 ? D / 64 : 1;
  static constexpr int kPanelCols = D >= 64 ? 64 : D;
  static constexpr uint64_t kMode = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr uint32_t kGroup = 8 * kRowBytes;  // one 8-row swizzle atom
  __host__ __device__ static constexpr uint32_t bytes(int rows) {
    return (uint32_t)rows * D * 2;
  }
};

// A 64 x D fp32 accumulator, one m64nN accumulator per panel.
template <int D>
using Acc = float[Smem<D>::kPanels][Smem<D>::kPanelCols / 2];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- TMA and mbarriers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// Makes initialised barriers visible to the TMA unit before first use.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of this phase, and the bytes its TMA copies will bring.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map (d, n, BH) at (col, row, slice) into shared
// memory at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int slice) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(slice)
      : "memory");
}

// Rows [row0, row0 + rows) of a slice into a tile of `rows` rows (the map's
// box), one box per 64-column panel; rows at or past n arrive as zeros.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row0, int rows, int slice) {
#pragma unroll
  for (int pb = 0; pb < Smem<D>::kPanels; ++pb)
    tma_load(dst + pb * rows * Smem<D>::kRowBytes, map, bar, pb * 64, row0, slice);
}

// A 64-row tile (one box per panel) out to rows [row0, row0 + 64) of a
// slice; rows at or past n are not written. Thread 0 waits until the tile
// has been read, so the block may exit and its shared memory be reused.
template <int D>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map, uint32_t src, int row0,
                                               int slice) {
#pragma unroll
  for (int pb = 0; pb < Smem<D>::kPanels; ++pb)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::
            "l"(reinterpret_cast<uint64_t>(map)),
        "r"(src + pb * kTile * Smem<D>::kRowBytes), "r"(pb * 64), "r"(row0), "r"(slice)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory (stmatrix) made visible to the
// async proxy (a TMA store) that reads them next.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Statistics arrive by 4-byte cp.async (a slice's rows need not be aligned).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- wgmma -----------------------------------------------------------------
// Accumulator of m64nN (fp32): thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 + 8 i (i = 0, 1) and columns 8 j + 2 (t % 4) + e
// (e = 0, 1) in register 4 j + 2 i + e. So an m64n64 accumulator is four
// m64n16 ones side by side: register 8 b + u of a score row is block b.

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t stride, uint64_t mode) {
  // Both byte offsets are set to the 8-row atom stride: for K-major swizzled
  // operands the leading one is unused, for MN-major ones every operand here
  // is one atom wide, so either reading of the two fields is right.
  const uint64_t s = (stride >> 4) & 0x3FFF;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (s << 16) | (s << 32) | (mode << 62);
}

// K-major operand: the rows from row0 of a tile of `rows` rows, k-step kk
// (columns 16 kk .. 16 kk + 15).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0, int kk) {
  using S = Smem<D>;
  const int cb = kk * 32;
  return make_desc(tile + (cb / S::kRowBytes) * rows * S::kRowBytes +
                       row0 * S::kRowBytes + cb % S::kRowBytes,
                   S::kGroup, S::kMode);
}

// MN-major operand: the 16 rows from row0 as the k-step, columns of panel pb.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int row0, int pb) {
  using S = Smem<D>;
  return make_desc(tile + pb * rows * S::kRowBytes + row0 * S::kRowBytes, S::kGroup,
                   S::kMode);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define GS_F8(d, i)                                                                \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d[OFF .. OFF + N / 2) (+)= A B, 64 x N x 16 (N = 16, 32, 48 or 64), A and
// B K-major in shared memory.
template <int N, int OFF, int M>
__device__ __forceinline__ void wgmma_ss(float (&d)[M], uint64_t a, uint64_t b, int acc) {
  static_assert(OFF + N / 2 <= M, "accumulator out of range");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : GS_F8(d, OFF), GS_F8(d, OFF + 8), GS_F8(d, OFF + 16), GS_F8(d, OFF + 24)
        : "l"(a), "l"(b), "r"(acc));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : GS_F8(d, OFF), GS_F8(d, OFF + 8), GS_F8(d, OFF + 16)
        : "l"(a), "l"(b), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : GS_F8(d, OFF), GS_F8(d, OFF + 8)
        : "l"(a), "l"(b), "r"(acc));
  } else {
    static_assert(N == 16, "N is 16, 32, 48 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : GS_F8(d, OFF)
        : "l"(a), "l"(b), "r"(acc));
  }
}

// d (+)= A B, 64 x N x 16, A from registers, B MN-major in shared memory;
// N = 64, 32 or 16 by the accumulator's size.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : GS_F8(d, 0), GS_F8(d, 8), GS_F8(d, 16), GS_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : GS_F8(d, 0), GS_F8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : GS_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef GS_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16 A operand for k-step b (columns 16 b .. 16 b + 15) of an accumulator:
// the accumulator's layout is the A fragment's.
template <int M>
__device__ __forceinline__ void to_frag(uint32_t (&a)[4], const float (&d)[M], int b) {
  a[0] = pack_bf16(d[8 * b + 0], d[8 * b + 1]);
  a[1] = pack_bf16(d[8 * b + 2], d[8 * b + 3]);
  a[2] = pack_bf16(d[8 * b + 4], d[8 * b + 5]);
  a[3] = pack_bf16(d[8 * b + 6], d[8 * b + 7]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Calls f(std::integral_constant<int, G>) for each group G of up to four
// blocks of 16 keys (64 keys) of NB blocks.
template <int NB, int G = 0, class F>
__device__ __forceinline__ void for_groups(F&& f) {
  if constexpr (4 * G < NB) {
    f(std::integral_constant<int, G>{});
    for_groups<NB, G + 1>(static_cast<F&&>(f));
  }
}

// Blocks of 16 keys in group G of NB blocks.
template <int NB, int G>
__host__ __device__ constexpr int group_blocks() {
  return NB - 4 * G < 4 ? NB - 4 * G : 4;
}

// S = Q K^T of a 64-row query tile against the NB blocks of 16 keys of a K
// tile of 16 NB rows.
template <int D, int NB>
__device__ __forceinline__ void scores(float (&s)[NB * 8], uint32_t aQ, uint32_t aK) {
  reg_fence(s);
  wg_fence();
  for_groups<NB>([&](auto g) {
    constexpr int G = decltype(g)::value, W = group_blocks<NB, G>();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<16 * W, 32 * G>(s, desc_k<D>(aQ, kTile, 0, kk),
                               desc_k<D>(aK, kBlock * NB, 64 * G, kk), kk);
  });
  wg_commit();
  wg_wait();
  reg_fence(s);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special function unit (relative error below 2^-22; results
// below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// In place: raw scores s of this thread's two rows -> fp32 probabilities,
// the exact two-pass softmax of x = s * scale over the keys below n: the row
// max m, e = exp(x - m) as 2^(s * scale log2 e - m log2 e), the row sum l,
// then p = e * (1 / l). Returns m, l and 1 / l per row. Only the last TAIL
// blocks of 16 keys can reach past n, so only they are masked.
template <int NB, int TAIL>
__device__ __forceinline__ void softmax_rows(float (&s)[NB * 8], int n, float scale,
                                             float (&m)[2], float (&l)[2], float (&rl)[2]) {
  const int c0 = 2 * (threadIdx.x % 4);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < NB * 8; ++t) {
    if (t >= 8 * (NB - TAIL)) {
      const int col = kBlock * (t / 8) + 8 * ((t % 8) / 4) + c0 + (t % 2);
      if (col >= n) s[t] = -INFINITY;  // mutation check: padded keys
    }
    mx[(t / 2) % 2] = fmaxf(mx[(t / 2) % 2], s[t]);
  }
  const float sl = scale * kLog2e;
  float ml[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = quad_max(mx[i]) * scale;
    ml[i] = m[i] * kLog2e;
    l[i] = 0.0f;
  }
#pragma unroll
  for (int t = 0; t < NB * 8; ++t) {
    const float e = ex2(fmaf(s[t], sl, -ml[(t / 2) % 2]));
    s[t] = e;
    l[(t / 2) % 2] += e;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    rl[i] = 1.0f / l[i];
  }
#pragma unroll
  for (int t = 0; t < NB * 8; ++t) s[t] *= rl[(t / 2) % 2];
}

// This thread's part of an accumulator of panel pb, times mul, rounded to
// bf16 and written by stmatrix into panel pb of a 64-row tile at `tile`, in
// the swizzled layout the tile's TMA map reads: each stmatrix.x4 writes four
// 8 x 8 blocks (rows +0 / +8, two groups of 8 columns).
template <int D>
__device__ __forceinline__ void stage_acc(uint32_t tile,
                                          const float (&d)[Smem<D>::kPanelCols / 2], int pb,
                                          float mul) {
  using S = Smem<D>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, mat = lane / 8;
  const int row = 16 * warp + 8 * (mat % 2) + lane % 8;  // the row this lane addresses
#pragma unroll
  for (int jj = 0; jj < S::kPanelCols / 16; ++jj) {
    const uint32_t o = row * S::kRowBytes + (2 * jj + mat / 2) * 16;
    const uint32_t addr = tile + pb * kTile * S::kRowBytes +
                          (o ^ ((o >> 3) & ((S::kRowBytes / 16 - 1) << 4)));
    const int j0 = 8 * jj, j1 = 8 * jj + 4;  // registers of column groups 2 jj, 2 jj + 1
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
                     "r"(addr), "r"(pack_bf16(d[j0] * mul, d[j0 + 1] * mul)),
                 "r"(pack_bf16(d[j0 + 2] * mul, d[j0 + 3] * mul)),
                 "r"(pack_bf16(d[j1] * mul, d[j1 + 1] * mul)),
                 "r"(pack_bf16(d[j1 + 2] * mul, d[j1 + 3] * mul))
                 : "memory");
  }
}

// Stages the panels of an accumulator in a free 64-row tile and stores it by
// TMA to rows [row0, row0 + 64) of the slice.
template <int D>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, uint32_t tile,
                                           const Acc<D>& d, int row0, int slice, float mul) {
#pragma unroll
  for (int pb = 0; pb < Smem<D>::kPanels; ++pb) stage_acc<D>(tile, d[pb], pb, mul);
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) tma_store_tile<D>(map, tile, row0, slice);
}

// ---- forward -----------------------------------------------------------------

// Blocks of 16 keys that padding can reach: the last one at d = 64, where
// n_pad is a multiple of 16; up to four at the other widths (a multiple of
// 64; see by_blocks).
template <int D>
__host__ __device__ constexpr int tail_blocks() {
  return D == 64 ? 1 : 4;
}

template <int D>
__host__ __device__ constexpr size_t fwd_smem(int nb) {
  return 1024 + Smem<D>::bytes(kTile) + 2 * Smem<D>::bytes(kBlock * nb) + 2 * 8;
}

template <int D, int NB>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 3)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to, int n, int tiles, float scale) {
  using S = Smem<D>;
  constexpr int kKeys = kBlock * NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  const uint32_t aQ = smem_u32(sQ), aK = aQ + S::bytes(kTile), aV = aK + S::bytes(kKeys);
  const uint32_t bar = aV + S::bytes(kKeys);  // [0] Q and K, [1] V

  const int slice = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * kTile;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(bar + 8);
    mbar_fence_init();
    mbar_expect(bar, S::bytes(kTile) + S::bytes(kKeys));
    tma_tile<D>(aQ, &tq, bar, q0, kTile, slice);
    tma_tile<D>(aK, &tk, bar, 0, kKeys, slice);
    mbar_expect(bar + 8, S::bytes(kKeys));
    tma_tile<D>(aV, &tv, bar + 8, 0, kKeys, slice);  // lands while the scores run
  }
  __syncthreads();  // the barriers are initialised
  mbar_wait(bar, 0);

  float s[NB * 8];
  scores<D, NB>(s, aQ, aK);
  float m[2], l[2], rl[2];
  softmax_rows<NB, tail_blocks<D>()>(s, n, scale, m, l, rl);
  uint32_t p[NB][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) to_frag(p[b], s, b);

  mbar_wait(bar + 8, 0);
  Acc<D> acc;
#pragma unroll
  for (int pb = 0; pb < S::kPanels; ++pb) reg_fence(acc[pb]);
  wg_fence();
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int pb = 0; pb < S::kPanels; ++pb)
      wgmma_rs(acc[pb], p[b], desc_mn<D>(aV, kKeys, kBlock * b, pb), b);
  wg_commit();
  wg_wait();
#pragma unroll
  for (int pb = 0; pb < S::kPanels; ++pb) reg_fence(acc[pb]);
  store_tile<D>(&to, aQ, acc, q0, slice, 1.0f);  // Q's tile is free since the scores
}

// ---- backward, rows: dq and the row statistics --------------------------------

// Planes of fp32 row statistics: m, l, 1 / l and D = rowsum(dp * p).
constexpr int kStats = 4;

template <int D>
__host__ __device__ constexpr size_t rows_smem(int nb) {
  return 1024 + 2 * Smem<D>::bytes(kTile) + 2 * Smem<D>::bytes(kBlock * nb) + 2 * 8;
}

// dp = G V^T for the keys of group G (W blocks of 16) into dp[0 .. 8 W).
template <int D, int NB, int G>
__device__ __forceinline__ void dp_group(float (&dp)[32], uint32_t aG, uint32_t aV) {
  reg_fence(dp);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<16 * group_blocks<NB, G>(), 0>(dp, desc_k<D>(aG, kTile, 0, kk),
                                          desc_k<D>(aV, kBlock * NB, 64 * G, kk), kk);
  wg_commit();
  wg_wait();
  reg_fence(dp);
}

template <int D, int NB>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
attn_bwd_rows_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tg,
                     const __grid_constant__ CUtensorMap tdq, float* __restrict__ stats, int n,
                     int tiles, long long total, float scale) {
  using S = Smem<D>;
  constexpr int kKeys = kBlock * NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  const uint32_t aQ = smem_u32(sQ), aG = aQ + S::bytes(kTile), aK = aG + S::bytes(kTile),
                 aV = aK + S::bytes(kKeys);
  const uint32_t bar = aV + S::bytes(kKeys);  // [0] Q and K, [1] G and V

  const int slice = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * kTile;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(bar + 8);
    mbar_fence_init();
    mbar_expect(bar, S::bytes(kTile) + S::bytes(kKeys));
    tma_tile<D>(aQ, &tq, bar, q0, kTile, slice);
    tma_tile<D>(aK, &tk, bar, 0, kKeys, slice);
    mbar_expect(bar + 8, S::bytes(kTile) + S::bytes(kKeys));
    tma_tile<D>(aG, &tg, bar + 8, q0, kTile, slice);
    tma_tile<D>(aV, &tv, bar + 8, 0, kKeys, slice);
  }
  __syncthreads();
  mbar_wait(bar, 0);

  float s[NB * 8];
  scores<D, NB>(s, aQ, aK);
  float m[2], l[2], rl[2];
  softmax_rows<NB, tail_blocks<D>()>(s, n, scale, m, l, rl);  // s now holds the fp32 p
  mbar_wait(bar + 8, 0);

  // D = rowsum(dp * p) over the whole row, dp in groups of up to 64 keys
  float dsum[2] = {0.0f, 0.0f};
  for_groups<NB>([&](auto g) {
    constexpr int G = decltype(g)::value;
    float dp[32];
    dp_group<D, NB, G>(dp, aG, aV);
#pragma unroll
    for (int t = 0; t < 8 * group_blocks<NB, G>(); ++t)
      dsum[(t >> 1) & 1] += dp[t] * s[32 * G + t];  // mutation check: rowsum(dp * p)
  });
#pragma unroll
  for (int i = 0; i < 2; ++i) dsum[i] = quad_sum(dsum[i]);

  // ddots = p * (dp - D), rounded to bf16 as the A operand of dq = ddots K
  Acc<D> acc;
  for_groups<NB>([&](auto g) {
    constexpr int G = decltype(g)::value, W = group_blocks<NB, G>();
    float dp[32];
    dp_group<D, NB, G>(dp, aG, aV);
#pragma unroll
    for (int t = 0; t < 8 * W; ++t) dp[t] = s[32 * G + t] * (dp[t] - dsum[(t >> 1) & 1]);
    uint32_t a[W][4];
#pragma unroll
    for (int b = 0; b < W; ++b) to_frag(a[b], dp, b);
#pragma unroll
    for (int pb = 0; pb < S::kPanels; ++pb) reg_fence(acc[pb]);
    wg_fence();
#pragma unroll
    for (int b = 0; b < W; ++b)
#pragma unroll
      for (int pb = 0; pb < S::kPanels; ++pb)
        wgmma_rs(acc[pb], a[b], desc_mn<D>(aK, kKeys, 64 * G + kBlock * b, pb), G + b);
    wg_commit();
    wg_wait();
#pragma unroll
    for (int pb = 0; pb < S::kPanels; ++pb) reg_fence(acc[pb]);
  });

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + 16 * warp + lane / 4 + 8 * i;
      if (r < n) {
        const long long idx = (long long)slice * n + r;
        stats[idx] = m[i];
        stats[total + idx] = l[i];
        stats[2 * total + idx] = rl[i];
        stats[3 * total + idx] = dsum[i];
      }
    }
  }
  store_tile<D>(&tdq, aQ, acc, q0, slice, scale);  // mutation check: dq = (ddots k) * scale
}

// ---- backward, keys: dk and dv ------------------------------------------------

constexpr int kKeyStats = 3;  // the planes the keys kernel reads: m, 1 / l, D

template <int D>
__host__ __device__ constexpr size_t keys_smem() {
  return 1024 + 6 * Smem<D>::bytes(kTile) + 2 * kKeyStats * kTile * sizeof(float) + 3 * 8;
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 3)
attn_bwd_keys_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tg,
                     const __grid_constant__ CUtensorMap tdk,
                     const __grid_constant__ CUtensorMap tdv, const float* __restrict__ stats,
                     int n, int tiles, long long total, float scale) {
  using S = Smem<D>;
  constexpr uint32_t kT = S::bytes(kTile);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  // stage st: Q at aQ0 + 2 st kT, G after it
  const uint32_t aK = smem_u32(sK), aV = aK + kT, aQ0 = aV + kT;
  float* sStat = reinterpret_cast<float*>(sK + 6 * kT);  // [2][3][64]
  const uint32_t bar = smem_u32(sStat + 2 * kKeyStats * kTile);  // [0] K, V; [1 + st]

  const int slice = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * kTile;
  const long long row_base = (long long)slice * n;

  auto load_stage = [&](int st, int it) {
    if (threadIdx.x == 0) {
      const uint32_t b = bar + 8 * (1 + st), aQ = aQ0 + 2 * st * kT;
      mbar_expect(b, 2 * kT);
      tma_tile<D>(aQ, &tq, b, kTile * it, kTile, slice);
      tma_tile<D>(aQ + kT, &tg, b, kTile * it, kTile, slice);
    }
    for (int t = threadIdx.x; t < kKeyStats * kTile; t += kThreads) {
      const int which = t / kTile, r = kTile * it + t % kTile;  // planes 0, 2, 3
      const bool ok = r < n;
      cp_async4(smem_u32(sStat + (st * kKeyStats + which) * kTile + t % kTile),
                stats + (which + (which > 0)) * total + row_base + (ok ? r : 0), ok);
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
    mbar_fence_init();
    mbar_expect(bar, 2 * kT);
    tma_tile<D>(aK, &tk, bar, k0, kTile, slice);
    tma_tile<D>(aV, &tv, bar, k0, kTile, slice);
  }
  __syncthreads();  // the barriers are initialised
  load_stage(0, 0);
  cp_commit();

  const int c0 = 2 * (threadIdx.x % 4);
  const float sl = scale * kLog2e;
  Acc<D> acc_v, acc_k;
#pragma unroll
  for (int pb = 0; pb < S::kPanels; ++pb)
#pragma unroll
    for (int t = 0; t < S::kPanelCols / 2; ++t) acc_v[pb][t] = acc_k[pb][t] = 0.0f;
  mbar_wait(bar, 0);

  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) load_stage(st ^ 1, it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // this stage's statistics
    mbar_wait(bar + 8 * (1 + st), (it >> 1) & 1);

    const uint32_t aQ = aQ0 + 2 * st * kT, aG = aQ + kT;
    const float* sm = sStat + st * kKeyStats * kTile;
    // One query tile of W blocks of 16 queries: the last tile of a slice
    // takes only the blocks that hold queries below n.
    auto step = [&](auto w) {
      constexpr int W = decltype(w)::value;
      // S^T = K Q^T and dP^T = V G^T: rows are this tile's keys, columns queries
      float sT[32], dpT[32];
      reg_fence(sT);
      reg_fence(dpT);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<16 * W, 0>(sT, desc_k<D>(aK, kTile, 0, kk), desc_k<D>(aQ, kTile, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<16 * W, 0>(dpT, desc_k<D>(aV, kTile, 0, kk), desc_k<D>(aG, kTile, 0, kk), kk);
      wg_commit();
      wg_wait();
      reg_fence(sT);
      reg_fence(dpT);

      // p = exp(x - m) / l and ddots = p * (dp - D) as the rows kernel forms
      // them; 0 for the padded queries
#pragma unroll
      for (int j = 0; j < 2 * W; ++j) {
        const int col = 8 * j + c0;  // and col + 1
        const float2 mm = *reinterpret_cast<const float2*>(sm + col);
        const float2 rr = *reinterpret_cast<const float2*>(sm + kTile + col);
        const float2 dd = *reinterpret_cast<const float2*>(sm + 2 * kTile + col);
        const float ml[2] = {mm.x * kLog2e, mm.y * kLog2e};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = 4 * j + u, hi = u % 2;
          const float e = ex2(fmaf(sT[t], sl, -ml[hi]));
          const float p = kTile * it + col + hi < n ? e * (hi ? rr.y : rr.x) : 0.0f;
          sT[t] = p;
          dpT[t] = p * (dpT[t] - (hi ? dd.y : dd.x));
        }
      }
      uint32_t pa[W][4], da[W][4];
#pragma unroll
      for (int b = 0; b < W; ++b) {
        to_frag(pa[b], sT, b);
        to_frag(da[b], dpT, b);
      }
#pragma unroll
      for (int pb = 0; pb < S::kPanels; ++pb) {
        reg_fence(acc_v[pb]);
        reg_fence(acc_k[pb]);
      }
      wg_fence();
#pragma unroll
      for (int b = 0; b < W; ++b)
#pragma unroll
        for (int pb = 0; pb < S::kPanels; ++pb) {
          wgmma_rs(acc_v[pb], pa[b], desc_mn<D>(aG, kTile, kBlock * b, pb), 1);
          wgmma_rs(acc_k[pb], da[b], desc_mn<D>(aQ, kTile, kBlock * b, pb), 1);
        }
      wg_commit();
      wg_wait();
#pragma unroll
      for (int pb = 0; pb < S::kPanels; ++pb) {
        reg_fence(acc_v[pb]);
        reg_fence(acc_k[pb]);
      }
    };
    const int left = cdiv(n - kTile * it, kBlock);  // blocks of 16 queries from this tile on
    if (left >= 4)
      step(std::integral_constant<int, 4>{});
    else if (left == 3)
      step(std::integral_constant<int, 3>{});
    else if (left == 2)
      step(std::integral_constant<int, 2>{});
    else
      step(std::integral_constant<int, 1>{});
    __syncthreads();  // this stage is refilled next iteration
  }

  // K's and V's tiles are free after the last iteration's barrier
#pragma unroll
  for (int pb = 0; pb < S::kPanels; ++pb) {
    stage_acc<D>(aK, acc_k[pb], pb, scale);
    stage_acc<D>(aV, acc_v[pb], pb, 1.0f);
  }
  fence_async_smem();
  __syncthreads();
  if (threadIdx.x == 0) {
    tma_store_tile<D>(&tdk, aK, k0, slice);
    tma_store_tile<D>(&tdv, aV, k0, slice);
  }
}

// ---- launches ------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up in libcuda at run time (the library
// links only the CUDA runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of a contiguous (bh, n, d) bf16 tensor whose box is `rows` rows of
// one 64-column panel (all d columns for d < 64), swizzled as Smem<d>;
// out-of-range rows of a slice read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int n, int d, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int cols = d >= 64 ? 64 : d;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                              dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct FwdCall {
  const void *q, *k, *v;
  void* o;
  int bh, n;
  float scale;
  cudaStream_t stream;
  template <int D, int NB>
  cudaError_t run() const {
    const auto kern = attn_fwd_kernel<D, NB>;
    const size_t smem = fwd_smem<D>(NB);
    CUtensorMap mq, mk, mv, mo;
    cudaError_t err = set_smem(kern, smem);
    if (err == cudaSuccess) err = make_map(&mq, q, bh, n, D, kTile);
    if (err == cudaSuccess) err = make_map(&mk, k, bh, n, D, kBlock * NB);
    if (err == cudaSuccess) err = make_map(&mv, v, bh, n, D, kBlock * NB);
    if (err == cudaSuccess) err = make_map(&mo, o, bh, n, D, kTile);
    if (err != cudaSuccess) return err;
    const int tiles = cdiv(n, kTile);
    kern<<<bh * tiles, kThreads, smem, stream>>>(mq, mk, mv, mo, n, tiles, scale);
    return cudaGetLastError();
  }
};

struct RowsCall {
  const void *q, *k, *v, *g;
  void *dq, *stats;
  int bh, n;
  float scale;
  cudaStream_t stream;
  template <int D, int NB>
  cudaError_t run() const {
    const auto kern = attn_bwd_rows_kernel<D, NB>;
    const size_t smem = rows_smem<D>(NB);
    CUtensorMap mq, mk, mv, mg, mdq;
    cudaError_t err = set_smem(kern, smem);
    if (err == cudaSuccess) err = make_map(&mq, q, bh, n, D, kTile);
    if (err == cudaSuccess) err = make_map(&mk, k, bh, n, D, kBlock * NB);
    if (err == cudaSuccess) err = make_map(&mv, v, bh, n, D, kBlock * NB);
    if (err == cudaSuccess) err = make_map(&mg, g, bh, n, D, kTile);
    if (err == cudaSuccess) err = make_map(&mdq, dq, bh, n, D, kTile);
    if (err != cudaSuccess) return err;
    const int tiles = cdiv(n, kTile);
    kern<<<bh * tiles, kThreads, smem, stream>>>(mq, mk, mv, mg, mdq,
                                                 static_cast<float*>(stats), n, tiles,
                                                 (long long)bh * n, scale);
    return cudaGetLastError();
  }
};

struct KeysCall {
  const void *q, *k, *v, *g, *stats;
  void *dk, *dv;
  int bh, n;
  float scale;
  cudaStream_t stream;
  template <int D, int NB>
  cudaError_t run() const {
    const auto kern = attn_bwd_keys_kernel<D>;
    const size_t smem = keys_smem<D>();
    CUtensorMap mq, mk, mv, mg, mdk, mdv;
    cudaError_t err = set_smem(kern, smem);
    if (err == cudaSuccess) err = make_map(&mq, q, bh, n, D, kTile);
    if (err == cudaSuccess) err = make_map(&mk, k, bh, n, D, kTile);
    if (err == cudaSuccess) err = make_map(&mv, v, bh, n, D, kTile);
    if (err == cudaSuccess) err = make_map(&mg, g, bh, n, D, kTile);
    if (err == cudaSuccess) err = make_map(&mdk, dk, bh, n, D, kTile);
    if (err == cudaSuccess) err = make_map(&mdv, dv, bh, n, D, kTile);
    if (err != cudaSuccess) return err;
    const int tiles = cdiv(n, kTile);
    kern<<<bh * tiles, kThreads, smem, stream>>>(mq, mk, mv, mg, mdk, mdv,
                                                 static_cast<const float*>(stats), n, tiles,
                                                 (long long)bh * n, scale);
    return cudaGetLastError();
  }
};

// Blocks per SM, registers per thread, local (spill) bytes per thread and
// dynamic shared memory per block of one kernel.
template <class Kern>
cudaError_t kernel_info(Kern kern, size_t smem, int* out) {
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, kThreads, smem);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)smem;
  return err;
}

struct InfoCall {
  int which;  // 0 forward, 1 backward rows, 2 backward keys
  int* out;
  template <int D, int NB>
  cudaError_t run() const {
    if (which == 0) return kernel_info(attn_fwd_kernel<D, NB>, fwd_smem<D>(NB), out);
    if (which == 1) return kernel_info(attn_bwd_rows_kernel<D, NB>, rows_smem<D>(NB), out);
    return kernel_info(attn_bwd_keys_kernel<D>, keys_smem<D>(), out);
  }
};

// The key blocks the kernels are instantiated for: every multiple of 16 keys
// at d = 64 (the models' head width), multiples of 64 at the other widths.
template <int D, class Call>
cudaError_t by_blocks(const Call& call, int n) {
  if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  const int nb = cdiv(n, kBlock);
  if constexpr (D == 64) {
    switch (nb) {
      case 1: return call.template run<D, 1>();
      case 2: return call.template run<D, 2>();
      case 3: return call.template run<D, 3>();
      case 4: return call.template run<D, 4>();
      case 5: return call.template run<D, 5>();
      case 6: return call.template run<D, 6>();
      case 7: return call.template run<D, 7>();
      case 8: return call.template run<D, 8>();
      case 9: return call.template run<D, 9>();
      case 10: return call.template run<D, 10>();
      case 11: return call.template run<D, 11>();
      case 12: return call.template run<D, 12>();
      case 13: return call.template run<D, 13>();
      case 14: return call.template run<D, 14>();
      case 15: return call.template run<D, 15>();
      default: return call.template run<D, 16>();
    }
  } else {
    switch (cdiv(nb, 4)) {
      case 1: return call.template run<D, 4>();
      case 2: return call.template run<D, 8>();
      case 3: return call.template run<D, 12>();
      default: return call.template run<D, 16>();
    }
  }
}

template <class Call>
int dispatch(const Call& call, int n, int d) {
  switch (d) {
    case 16: return (int)by_blocks<16>(call, n);
    case 32: return (int)by_blocks<32>(call, n);
    case 64: return (int)by_blocks<64>(call, n);
    case 128: return (int)by_blocks<128>(call, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

static_assert(kMaxBlocks == 16, "by_blocks instantiates 1..16 blocks");

}  // namespace

extern "C" {

// Largest n the kernels take (a 64-row tile's score row in registers).
int gslora_attn_max_n() { return kMaxN; }

// Planes of fp32 row statistics the backward's scratch holds (m, l, 1 / l, D).
int gslora_attn_stats() { return kStats; }

// o = softmax(q k^T * scale) v over bh contiguous (n, d) bf16 slices.
// Each entry point returns cudaGetLastError() after its launch (0 on success).
int gslora_attn_fwd(const void* q, const void* k, const void* v, void* o, int bh, int n,
                    int d, float scale, void* stream) {
  return dispatch(FwdCall{q, k, v, o, bh, n, scale, static_cast<cudaStream_t>(stream)},
                  n, d);
}

// Backward, first launch: dq, and the row statistics (fp32, kStats planes of
// bh * n) that the second launch reads.
int gslora_attn_bwd_rows(const void* q, const void* k, const void* v, const void* g,
                         void* dq, void* stats, int bh, int n, int d, float scale,
                         void* stream) {
  return dispatch(
      RowsCall{q, k, v, g, dq, stats, bh, n, scale, static_cast<cudaStream_t>(stream)}, n,
      d);
}

// Backward, second launch: dk and dv from the statistics.
int gslora_attn_bwd_keys(const void* q, const void* k, const void* v, const void* g,
                         const void* stats, void* dk, void* dv, int bh, int n, int d,
                         float scale, void* stream) {
  return dispatch(
      KeysCall{q, k, v, g, stats, dk, dv, bh, n, scale, static_cast<cudaStream_t>(stream)},
      n, d);
}

// out[4] = blocks per SM, registers per thread, spill bytes per thread and
// shared memory per block of kernel `which` (0 forward, 1 backward rows,
// 2 backward keys) at (n, d).
int gslora_attn_kernel_info(int which, int n, int d, int* out) {
  return dispatch(InfoCall{which, out}, n, d);
}

}  // extern "C"
