// Fused multi-head attention for Hopper (sm_90a) over (BH, n, d) float32
// slices: forward and recompute backward, with the plain C interface of
// attention.cu (the bfloat16 kernels), bound from Python by ctypes
// (gslora_tpu_torch/ops/attention.py picks the library by the inputs' dtype).
//
// Replaces the Pallas TPU kernel K1 of gslora_tpu/ops/attention.py on
// float32 inputs (the models' --compute_dtype float32):
//   forward  -> _fwd_kernel, launched by _fwd_call (:149)
//   backward -> _bwd_kernel, launched by _fa_bwd   (:179)
// and computes what they compute in fp32, where their casts of p and ddots
// to the input dtype do nothing:
//   fwd: dots = (q k^T) * scale; p = softmax(dots) over the full row (max,
//        exp, sum, then normalise); o = p v
//   bwd: recompute p; dv = p^T g; dp = g v^T;
//        ddots = p * (dp - rowsum(dp * p)); dq = ddots k * scale;
//        dk = ddots^T q * scale
// No attention matrix is written to device memory.
//
// Precision: three-pass TF32 on the tensor cores. Every operand x of every
// product is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and
// each product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b, the two
// small terms first, in the fp32 accumulator, a 64-key (or 64-query) chunk
// at a time (CUTLASS's 3xTF32). The dropped lo_a lo_b and lo's own rounding
// leave ~2^-22 of each term. Emulated on the CPU against the plain fp32
// version (tests/test_torch_attention.py), the four outputs sit 8.5e-7
// (max, of the largest element) and 4.4e-7 (L2) from it at (16, 197, 64)
// and 1.2e-6 / 5.4e-7 at (16, 256, 128); one pass (hi_a hi_b) lands at
// 4e-4 to 6e-4 and two (lo_a hi_b dropped) at 3e-4, far outside
// ops/attention.TOLERANCES (2^-16 max, 1e-5 L2). On the H100 (the
// accumulator's own rounding included) the kernels sit at most 3.2e-6 /
// 1.8e-6 from the plain version at every tested shape, up to (4, 256, 64)
// and (3, 256, 128). Softmax, statistics and every elementwise step stay
// in fp32: s * scale is rounded before the max and the exp in every kernel
// (__fmul_rn), exp is expf, 1 / l is correctly rounded, padded keys are
// -inf before the max, D = rowsum(dp * p) is an fp32 sum.
//
// What bounds it: operations. Three TF32 passes at the H100's 495 TFLOP/s
// (dense) are 165 TFLOP/s of fp32 products. At the ViT-P8S8 shape
// (384, 197, 64) the forward's two products take 0.0231 ms at that rate and
// its bytes (4 tensors at 3.35 TB/s) 0.0231 ms; the backward's five products
// 0.0578 ms against 0.0405 ms of bytes. Padding (64-row tiles, keys to a
// multiple of 8) adds 32 % at n = 197, the backward's rows kernel forms
// dp = G V^T twice, and each staged tile is split once per block, which
// reads it and writes two planes in shared memory: shared-memory bandwidth
// and the wait between split and product, not the tensor cores, set the
// time (4.3x the bound forward, 7.8x backward; PERF.md).
//
// Design. Every product is wgmma m64nNk8 tf32 with fp32 accumulation.
//  * wgmma reads tf32 operands from shared memory only K-major (no transpose
//    for 32-bit types); A may come from registers. Tiles of 64 rows x d
//    arrive by TMA (3-D maps over (BH, n, d), rows past n of a slice read as
//    zeros) into a ring of raw tiles (two; one in the keys kernel at d = 128),
//    each on its mbarrier, so the next tile lands while the current one is
//    split and multiplied. The threads split each raw tile once into a hi
//    and a lo plane. (The other choice, a split on fragment load, holds an
//    A operand in registers: 64 a thread at d = 64 beside a score row of up
//    to 128 and the products' own. It fits only for Q in the forward at
//    d <= 64; measured there against the planes, in one process on the
//    H100, it was 1.0-2.3 % faster at the fp32 paths' shapes (0.0973
//    against 0.0993 ms at (384, 197, 64)) and spilled 16 bytes at n = 256.
//    So every operand wgmma reads from shared memory is split into planes,
//    one design for all; p and ddots are split on fragment load.) A tile
//    is split
//    - as it is, where the sum runs along its rows (Q, K in S = Q K^T; G, V
//      in dp = G V^T; K, Q, V, G in the keys kernel's S^T and dP^T);
//    - transposed, where the sum runs down its columns (V in P V, K in
//      ddots K, G in P^T G, Q in ddots^T Q): position 8 (r / 8) + kPos[r % 8]
//      of row e holds element (r, e), kPos = {0, 4, 1, 5, 2, 6, 3, 7}.
//    Both planes keep TMA's swizzled layout (128 B rows, 64 B at d = 16),
//    which wgmma reads by descriptor.
//  * p and ddots never leave registers: an fp32 accumulator's block of 8
//    columns becomes a tf32 A fragment (hi and lo). The fragment holds
//    columns 2 k (k < 4) and 2 (k - 4) + 1 at its positions k, so the B
//    operand's rows are taken in that order: kPos above.
//  * A block is two warpgroups (one at d = 128, where two do not fit), each
//    with 64 rows of its own, sharing every staged tile: the split of a
//    tile serves 128 rows, and one warpgroup's products overlap the other's
//    (8 warps an SM at d = 64; a block of one warpgroup at two blocks an SM,
//    the same 8 warps, took the backward's rows launch 0.272 ms and its keys
//    launch 0.465 ms at (384, 197, 64), against 0.175 and 0.243).
//  * forward: one block per (slice, 128 query rows). S = Q K^T chunk by
//    chunk of 64 keys into registers (keys padded to 8: m64nN with N the
//    chunk's keys rounded up to 8, so n_pad = 200 at n = 197), the exact
//    softmax on the score rows in registers (quad shuffles), then O = P V
//    over the V chunks, stored from registers (rows below n only).
//  * backward, two kernels, both deterministic (no atomics, fixed order):
//    - rows: blocks as the forward's. Recomputes the scores and the softmax,
//      then dp = G V^T chunk by chunk twice: once for D = rowsum(dp * p),
//      once more for ddots = p * (dp - D), which feeds dq = ddots K; writes
//      dq and the row statistics m, l, 1 / l, D (4 fp32 planes of BH x n,
//      scratch from the wrapper).
//    - keys: one block per (slice, 128 keys). K's and V's planes stay; for
//      each query tile it forms S^T = K Q^T and dP^T = V G^T, then
//      p = exp(s * scale - m) * (1 / l) and ddots = p * (dp - D) from the
//      statistics (0 past n), and accumulates dv += p^T G and dk += ddots^T Q
//      in registers across the query tiles (the last one only as wide as
//      its queries below n, rounded up to 8).
// Shared memory at d = 64: 8 tiles of 16 KB in the forward and rows kernels,
// 12 in the keys kernel; one block an SM each.
// Faults planted by the mutation check sit on lines marked "mutation check".

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // a warpgroup
constexpr int kTile = 64;      // rows of a query tile, a key chunk and every staged tile
constexpr int kMaxN = 256;     // a 64-row tile's score row stays in registers
constexpr int kStats = 4;      // fp32 row statistics: m, l, 1 / l, D

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Warpgroups a block: two, each with 64 rows of its own (query rows; keys
// in the keys kernel), share every staged tile, except at d = 128, where
// two do not fit in shared memory.
template <int D>
__host__ __device__ constexpr int warpgroups() {
  return D == 128 ? 1 : 2;
}

// Bytes of a staged tile: 64 rows x D fp32, or its transpose.
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return (uint32_t)kTile * D * 4;
}

// A tile whose rows hold C fp32 values, in shared memory: panels of 32
// columns (one of 16 for C = 16), each row-major with one row per swizzle
// row (128 B; 64 B for C = 16), 16-byte chunk c of row r stored at chunk
// c ^ (address bits 7..9): what TMA writes under 128B (64B) swizzle and
// wgmma reads as a K-major operand. Tiles start on 1024-byte boundaries.
template <int C>
struct Layout {
  static constexpr int kRowBytes = C >= 32 ? 128 : 4 * C;
  static constexpr int kRowCols = kRowBytes / 4;
  static constexpr uint64_t kMode = kRowBytes == 128 ? 1 : 2;  // wgmma's 128B / 64B swizzle
  static constexpr uint32_t kAtom = 8 * kRowBytes;             // one 8-row swizzle atom
  // Byte offset of (row r, column c) in a tile of `rows` rows.
  __device__ static uint32_t at(int rows, int r, int c) {
    const uint32_t o = (c / kRowCols) * rows * kRowBytes + r * kRowBytes + (c % kRowCols) * 4;
    return o ^ ((o >> 3) & ((kRowBytes / 16 - 1) << 4));
  }
};

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

// Generic-proxy writes to shared memory (the split planes) made visible to
// the async proxy (wgmma) that reads them next.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The tiles a kernel uses, in the order it uses them: tile i lands by TMA in
// slot i % S of a ring of S raw 64 x D tiles, on barrier i % S, and tile
// i + S is requested as soon as the block's NT threads have split tile i.
template <int D, int S, int NT>
struct Ring {
  float* raw;    // slot 0
  uint32_t bar;  // barrier 0

  __device__ void init() const {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(bar + 8 * s);
    mbar_fence_init();
  }

  // Rows [row0, row0 + 64) of a slice, one box per panel of 32 columns.
  __device__ void request(int i, const CUtensorMap* map, int row0, int slice) const {
    using L = Layout<D>;
    const uint32_t b = bar + 8 * (i % S), dst = smem_u32(raw) + (i % S) * tile_bytes<D>();
    mbar_expect(b, tile_bytes<D>());
#pragma unroll
    for (int pb = 0; pb < D / L::kRowCols; ++pb)
      tma_load(dst + pb * kTile * L::kRowBytes, map, b, pb * L::kRowCols, row0, slice);
  }

  // Waits for tile i, hands it to split (which writes the planes some
  // product reads next: each warpgroup has waited for its own products, and
  // the first barrier for the other's), makes the planes visible to wgmma,
  // and has thread 0 request tile i + S (request(j) must ignore a j past
  // the kernel's last tile).
  template <class Request, class Split>
  __device__ void take(int i, Request&& request, Split&& split) const {
    mbar_wait(bar + 8 * (i % S), (i / S) & 1);
    if constexpr (NT > kThreads) __syncthreads();
    split(raw + (i % S) * kTile * D);
    fence_async_smem();
    __syncthreads();  // the planes are whole; the slot is free
    if (threadIdx.x == 0) request(i + S);
  }
};

// ---- the split into tf32 hi and lo ---------------------------------------------

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

// x = hi + lo + O(2^-22 |x|), hi and lo tf32 values.
__device__ __forceinline__ float2 split(float x) {
  const float hi = to_tf32(x);
  return make_float2(hi, to_tf32(x - hi));
}

// A raw 64 x D tile into hi and lo planes of the same layout, by NT threads.
template <int D, int NT>
__device__ __forceinline__ void split_plain(const float* raw, float* hi, float* lo) {
#pragma unroll
  for (int j = 0; j < kTile * D / 4 / NT; ++j) {
    const int i = threadIdx.x + NT * j;
    const float4 x = reinterpret_cast<const float4*>(raw)[i];
    const float2 a = split(x.x), b = split(x.y), c = split(x.z), d = split(x.w);
    reinterpret_cast<float4*>(hi)[i] = make_float4(a.x, b.x, c.x, d.x);
    reinterpret_cast<float4*>(lo)[i] = make_float4(a.y, b.y, c.y, d.y);
  }
}

// The transpose of a raw 64 x D tile (rows r, columns e) into hi and lo
// planes of D rows x 64 positions (Layout<64>, K-major over r): row e,
// position 8 (r / 8) + kPos[r % 8] holds (r, e), kPos = {0, 4, 1, 5, 2, 6,
// 3, 7}, the order of a fragment's columns (frag). A warp reads 32 rows'
// 16-byte chunks of one column group (8 consecutive rows: 8 distinct
// swizzled chunks) and writes 32 positions of one plane row. NT threads.
template <int D, int NT>
__device__ __forceinline__ void split_transposed(const float* raw, float* hi, float* lo) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(raw);
#pragma unroll
  for (int j = 0; j < kTile * D / 4 / NT; ++j) {
    const int u = threadIdx.x + NT * j, r = u % kTile, e0 = 4 * (u / kTile);
    const float4 x = *reinterpret_cast<const float4*>(src + Layout<D>::at(kTile, r, e0));
    const int p = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 s = split(v[c]);
      const uint32_t o = Layout<kTile>::at(D, e0 + c, p) / 4;
      hi[o] = s.x;
      lo[o] = s.y;
    }
  }
}

// ---- wgmma -----------------------------------------------------------------
// Accumulator of m64nN (fp32): thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 + 8 i (i = 0, 1) and columns 8 j + 2 (t % 4) + e
// (e = 0, 1) in register 4 j + 2 i + e, so a score row's block j of 8 keys is
// registers 4 j .. 4 j + 3. A tf32 A fragment of m64nNk8 holds (row, column)
// (g, k), (g + 8, k), (g, k + 4), (g + 8, k + 4), g = (t % 32) / 4, k = t % 4.

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t stride, uint64_t mode) {
  // Both byte offsets are set to the 8-row atom stride: for K-major swizzled
  // operands the leading one is unused.
  const uint64_t s = (stride >> 4) & 0x3FFF;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (s << 16) | (s << 32) | (mode << 62);
}

// K-major operand: k-step kk (columns 8 kk .. 8 kk + 7) of a tile of `rows`
// rows of C columns.
template <int C>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  using L = Layout<C>;
  const int cb = kk * 32;
  return make_desc(tile + (cb / L::kRowBytes) * rows * L::kRowBytes + cb % L::kRowBytes,
                   L::kAtom, L::kMode);
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

// Keeps the compiler from moving accumulator or fragment registers across
// the asynchronous wgmma (or reusing a fragment's before it has been read).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int W>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[W][4]) {
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[i][k])::"memory");
}

#define GS_F4(d, i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define GS_F8(d, i) GS_F4(d, i), GS_F4(d, (i) + 4)

// d[OFF ..) (+)= A B, 64 x N x 8 in tf32, A and B K-major in shared memory.
template <int N>
struct MmaSS;

template <>
struct MmaSS<8> {
  template <int OFF, int M>
  static __device__ __forceinline__ void run(float (&d)[M], uint64_t a, uint64_t b, int acc) {
    static_assert(OFF + 4 <= M, "accumulator out of range");
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : GS_F4(d, OFF + 0)
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct MmaSS<16> {
  template <int OFF, int M>
  static __device__ __forceinline__ void run(float (&d)[M], uint64_t a, uint64_t b, int acc) {
    static_assert(OFF + 8 <= M, "accumulator out of range");
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0)
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct MmaSS<24> {
  template <int OFF, int M>
  static __device__ __forceinline__ void run(float (&d)[M], uint64_t a, uint64_t b, int acc) {
    static_assert(OFF + 12 <= M, "accumulator out of range");
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0), GS_F4(d, OFF + 8)
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct MmaSS<32> {
  template <int OFF, int M>
  static __device__ __forceinline__ void run(float (&d)[M], uint64_t a, uint64_t b, int acc) {
    static_assert(OFF + 16 <= M, "accumulator out of range");
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0), GS_F8(d, OFF + 8)
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct MmaSS<40> {
  template <int OFF, int M>
  static __device__ __forceinline__ void run(float (&d)[M], uint64_t a, uint64_t b, int acc) {
    static_assert(OFF + 20 <= M, "accumulator out of range");
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19}, %20, %21, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0), GS_F8(d, OFF + 8), GS_F4(d, OFF + 16)
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct MmaSS<48> {
  template <int OFF, int M>
  static __device__ __forceinline__ void run(float (&d)[M], uint64_t a, uint64_t b, int acc) {
    static_assert(OFF + 24 <= M, "accumulator out of range");
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0), GS_F8(d, OFF + 8), GS_F8(d, OFF + 16)
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct MmaSS<56> {
  template <int OFF, int M>
  static __device__ __forceinline__ void run(float (&d)[M], uint64_t a, uint64_t b, int acc) {
    static_assert(OFF + 28 <= M, "accumulator out of range");
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, %28, %29, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0), GS_F8(d, OFF + 8), GS_F8(d, OFF + 16), GS_F4(d, OFF + 24)
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct MmaSS<64> {
  template <int OFF, int M>
  static __device__ __forceinline__ void run(float (&d)[M], uint64_t a, uint64_t b, int acc) {
    static_assert(OFF + 32 <= M, "accumulator out of range");
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0), GS_F8(d, OFF + 8), GS_F8(d, OFF + 16), GS_F8(d, OFF + 24)
      : "l"(a), "l"(b), "r"(acc));
  }
};

// d (+)= A B, 64 x D x 8 in tf32, A from registers (4 per thread), B K-major
// in shared memory; D = 16, 32, 64 or 128 by the accumulator's size.
__device__ __forceinline__ void mma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  constexpr int OFF = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  constexpr int OFF = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0), GS_F8(d, OFF + 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  constexpr int OFF = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0), GS_F8(d, OFF + 8), GS_F8(d, OFF + 16), GS_F8(d, OFF + 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  constexpr int OFF = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : GS_F8(d, OFF + 0), GS_F8(d, OFF + 8), GS_F8(d, OFF + 16), GS_F8(d, OFF + 24),
        GS_F8(d, OFF + 32), GS_F8(d, OFF + 40), GS_F8(d, OFF + 48), GS_F8(d, OFF + 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef GS_F8
#undef GS_F4

// d[OFF .. OFF + 4 W) = A B^T over the D columns of two 64 x D tiles, A's
// 64 rows against B's first 8 W rows, from their hi and lo planes: three
// passes, the small terms first.
template <int D, int W, int OFF, int M>
__device__ __forceinline__ void product_ss(float (&d)[M], const float* ah, const float* al,
                                           const float* bh, const float* bl) {
  using Mma = MmaSS<8 * W>;
  const uint32_t aH = smem_u32(ah), aL = smem_u32(al), bH = smem_u32(bh), bL = smem_u32(bl);
  reg_fence(d);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    Mma::template run<OFF>(d, desc_k<D>(aL, kTile, kk), desc_k<D>(bH, kTile, kk), kk);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)  // mutation check: cross term
    Mma::template run<OFF>(d, desc_k<D>(aH, kTile, kk), desc_k<D>(bL, kTile, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    Mma::template run<OFF>(d, desc_k<D>(aH, kTile, kk), desc_k<D>(bH, kTile, kk), 1);
  wg_commit();
  wg_wait();
  reg_fence(d);
}

// hi and lo tf32 A fragments of k-step b (columns 8 b .. 8 b + 7) of an
// accumulator: fragment position k takes column 2 k (k < 4), 2 (k - 4) + 1
// (k >= 4), the order split_transposed gives B's rows.
template <int M>
__device__ __forceinline__ void frag(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&d)[M],
                                     int b) {
  const float x[4] = {d[4 * b], d[4 * b + 2], d[4 * b + 1], d[4 * b + 3]};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 s = split(x[k]);
    hi[k] = __float_as_uint(s.x);
    lo[k] = __float_as_uint(s.y);
  }
}

// acc += A B over 8 W positions: A the fragments (hi, lo) of W k-steps, B a
// transposed tile's planes (D rows); three passes, the small terms first.
template <int D, int W>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2], uint32_t (&hi)[W][4],
                                           uint32_t (&lo)[W][4], const float* bh,
                                           const float* bl) {
  const uint32_t bH = smem_u32(bh), bL = smem_u32(bl);
  reg_fence(acc);
  reg_fence(hi);
  reg_fence(lo);
  wg_fence();
#pragma unroll
  for (int b = 0; b < W; ++b) mma_rs(acc, lo[b], desc_k<kTile>(bH, D, b));
#pragma unroll
  for (int b = 0; b < W; ++b) mma_rs(acc, hi[b], desc_k<kTile>(bL, D, b));
#pragma unroll
  for (int b = 0; b < W; ++b) mma_rs(acc, hi[b], desc_k<kTile>(bH, D, b));
  wg_commit();
  wg_wait();
  reg_fence(acc);
  reg_fence(hi);
  reg_fence(lo);
}

// acc += (the W blocks of 8 columns of d from block B0 on) B.
template <int D, int W, int B0, int M>
__device__ __forceinline__ void product_acc(float (&acc)[D / 2], const float (&d)[M],
                                            const float* bh, const float* bl) {
  uint32_t hi[W][4], lo[W][4];
#pragma unroll
  for (int b = 0; b < W; ++b) frag(hi[b], lo[b], d, B0 + b);
  product_rs<D, W>(acc, hi, lo, bh, bl);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Calls f(std::integral_constant<int, C>) for each chunk C of up to 8 blocks
// of 8 keys (64 keys) of NB blocks.
template <int NB, int C = 0, class F>
__device__ __forceinline__ void for_chunks(F&& f) {
  if constexpr (8 * C < NB) {
    f(std::integral_constant<int, C>{});
    for_chunks<NB, C + 1>(static_cast<F&&>(f));
  }
}

// Blocks of 8 keys in chunk C of NB blocks.
template <int NB, int C>
__host__ __device__ constexpr int chunk_blocks() {
  return NB - 8 * C < 8 ? NB - 8 * C : 8;
}

// Blocks of 8 keys that padding can reach: the last one at d = 64, where
// n_pad is a multiple of 8; up to eight at the other widths (a multiple of
// 64; see by_blocks).
template <int D>
__host__ __device__ constexpr int tail_blocks() {
  return D == 64 ? 1 : 8;
}

// In place: raw scores s of this thread's two rows -> fp32 probabilities,
// the exact two-pass softmax of x = s * scale (rounded) over the keys below
// n: the row max m, e = expf(x - m), the row sum l, p = e * (1 / l).
template <int NB, int TAIL>
__device__ __forceinline__ void softmax_rows(float (&s)[NB * 4], int n, float scale,
                                             float (&m)[2], float (&l)[2], float (&rl)[2]) {
  const int c0 = 2 * (threadIdx.x % 4);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < NB * 4; ++t) {
    s[t] = __fmul_rn(s[t], scale);
    if (t >= 4 * (NB - TAIL)) {
      const int col = 8 * (t / 4) + c0 + (t % 2);
      if (col >= n) s[t] = -INFINITY;  // mutation check: padded keys
    }
    mx[(t >> 1) & 1] = fmaxf(mx[(t >> 1) & 1], s[t]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = quad_max(mx[i]);
    l[i] = 0.0f;
  }
#pragma unroll
  for (int t = 0; t < NB * 4; ++t) {
    s[t] = expf(s[t] - m[(t >> 1) & 1]);
    l[(t >> 1) & 1] += s[t];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    rl[i] = 1.0f / l[i];
  }
#pragma unroll
  for (int t = 0; t < NB * 4; ++t) s[t] *= rl[(t >> 1) & 1];
}

// This thread's part of a 64 x D accumulator, times mul, to rows
// [row0, row0 + 64) of the slice whose first row is row_base; rows at or
// past n are not written.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, long long row_base, int row0,
                                           int n, const float (&acc)[D / 2], float mul) {
  const int warp = threadIdx.x % kThreads / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * warp + lane / 4 + 8 * i;
    if (r < n) {
      float* out = dst + (row_base + r) * D + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
    }
  }
}

// ---- forward -----------------------------------------------------------------

// Each warpgroup's Q planes, a chunk's two planes, two raw tiles, two
// barriers.
template <int D>
__host__ __device__ constexpr size_t fwd_smem() {
  return 1024 + (2 * warpgroups<D>() + 4) * tile_bytes<D>() + 2 * 8;
}

template <int D, int NB>
__global__ void __launch_bounds__(kThreads * warpgroups<D>(), 1)
attn_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int n,
                    int tiles, float scale) {
  constexpr int WG = warpgroups<D>(), NT = kThreads * WG;
  constexpr int NC = cdiv(NB, 8), T = kTile * D;  // chunks of 64 keys; floats a tile
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(align1024(smem_raw));
  const int wg = threadIdx.x / kThreads;
  const float *aH = sm + 2 * T * wg, *aL = aH + T;  // this warpgroup's Q
  float *bH = sm + 2 * T * WG, *bL = bH + T;
  const Ring<D, 2, NT> ring{bL + T, smem_u32(bL + 3 * T)};
  const int slice = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * kTile * WG;

  // tiles: Q of each warpgroup, the K chunks, the V chunks
  auto request = [&](int i) {
    if (i < WG)
      ring.request(i, &tq, q0 + kTile * i, slice);
    else if (i < WG + 2 * NC)
      ring.request(i, i < WG + NC ? &tk : &tv, kTile * ((i - WG) % NC), slice);
  };
  if (threadIdx.x == 0) {
    ring.init();
    request(0);
    request(1);
  }
  __syncthreads();  // the barriers are initialised
#pragma unroll
  for (int w = 0; w < WG; ++w)
    ring.take(w, request, [&](const float* r) {
      split_plain<D, NT>(r, sm + 2 * T * w, sm + 2 * T * w + T);
    });

  float s[NB * 4];
  for_chunks<NB>([&](auto c) {
    constexpr int C = decltype(c)::value;
    ring.take(WG + C, request, [&](const float* r) { split_plain<D, NT>(r, bH, bL); });
    product_ss<D, chunk_blocks<NB, C>(), 32 * C>(s, aH, aL, bH, bL);
  });
  float m[2], l[2], rl[2];
  softmax_rows<NB, tail_blocks<D>()>(s, n, scale, m, l, rl);

  float acc[D / 2];
#pragma unroll
  for (int t = 0; t < D / 2; ++t) acc[t] = 0.0f;
  for_chunks<NB>([&](auto c) {
    constexpr int C = decltype(c)::value;
    ring.take(WG + NC + C, request,
              [&](const float* r) { split_transposed<D, NT>(r, bH, bL); });
    product_acc<D, chunk_blocks<NB, C>(), 8 * C>(acc, s, bH, bL);
  });
  store_rows<D>(o, (long long)slice * n, q0 + kTile * wg, n, acc, 1.0f);
}

// ---- backward, rows: dq and the row statistics --------------------------------

template <int D>
__host__ __device__ constexpr size_t rows_smem() {
  return fwd_smem<D>();
}

template <int D, int NB>
__global__ void __launch_bounds__(kThreads * warpgroups<D>(), 1)
attn_bwd_rows_f32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg, float* __restrict__ dq,
                         float* __restrict__ stats, int n, int tiles, long long total,
                         float scale) {
  constexpr int WG = warpgroups<D>(), NT = kThreads * WG;
  constexpr int NC = cdiv(NB, 8), T = kTile * D;
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(align1024(smem_raw));
  const int wg = threadIdx.x / kThreads;
  const float *aH = sm + 2 * T * wg, *aL = aH + T;  // this warpgroup's Q, then G
  float *bH = sm + 2 * T * WG, *bL = bH + T;
  const Ring<D, 2, NT> ring{bL + T, smem_u32(bL + 3 * T)};
  const int slice = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * kTile * WG;

  // tiles: Q of each warpgroup, the K chunks (scores), G of each
  // warpgroup, the V chunks (D), then V and K of each chunk in turn (dp
  // again, and dq)
  auto request = [&](int i) {
    if (i < WG)
      ring.request(i, &tq, q0 + kTile * i, slice);
    else if (i < WG + NC)
      ring.request(i, &tk, kTile * (i - WG), slice);
    else if (i < 2 * WG + NC)
      ring.request(i, &tg, q0 + kTile * (i - WG - NC), slice);
    else if (i < 2 * WG + 2 * NC)
      ring.request(i, &tv, kTile * (i - 2 * WG - NC), slice);
    else if (i < 2 * WG + 4 * NC)
      ring.request(i, (i - 2 * WG) % 2 == 0 ? &tv : &tk, kTile * ((i - 2 * WG - 2 * NC) / 2),
                   slice);
  };
  if (threadIdx.x == 0) {
    ring.init();
    request(0);
    request(1);
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WG; ++w)
    ring.take(w, request, [&](const float* r) {
      split_plain<D, NT>(r, sm + 2 * T * w, sm + 2 * T * w + T);
    });

  float s[NB * 4];
  for_chunks<NB>([&](auto c) {
    constexpr int C = decltype(c)::value;
    ring.take(WG + C, request, [&](const float* r) { split_plain<D, NT>(r, bH, bL); });
    product_ss<D, chunk_blocks<NB, C>(), 32 * C>(s, aH, aL, bH, bL);
  });
  float m[2], l[2], rl[2];
  softmax_rows<NB, tail_blocks<D>()>(s, n, scale, m, l, rl);  // s now holds the fp32 p
#pragma unroll
  for (int w = 0; w < WG; ++w)
    ring.take(WG + NC + w, request, [&](const float* r) {
      split_plain<D, NT>(r, sm + 2 * T * w, sm + 2 * T * w + T);
    });

  // D = rowsum(dp * p) over the whole row, dp = G V^T a chunk at a time
  float dsum[2] = {0.0f, 0.0f};
  for_chunks<NB>([&](auto c) {
    constexpr int C = decltype(c)::value, W = chunk_blocks<NB, C>();
    ring.take(2 * WG + NC + C, request, [&](const float* r) { split_plain<D, NT>(r, bH, bL); });
    float dp[32];
    product_ss<D, W, 0>(dp, aH, aL, bH, bL);
#pragma unroll
    for (int t = 0; t < 4 * W; ++t)
      dsum[(t >> 1) & 1] += dp[t] * s[32 * C + t];  // mutation check: rowsum
  });
#pragma unroll
  for (int i = 0; i < 2; ++i) dsum[i] = quad_sum(dsum[i]);

  // ddots = p * (dp - D), the A operand of dq = ddots K
  float acc[D / 2];
#pragma unroll
  for (int t = 0; t < D / 2; ++t) acc[t] = 0.0f;
  for_chunks<NB>([&](auto c) {
    constexpr int C = decltype(c)::value, W = chunk_blocks<NB, C>();
    const int i = 2 * WG + 2 * NC + 2 * C;
    ring.take(i, request, [&](const float* r) { split_plain<D, NT>(r, bH, bL); });
    float dp[32];
    product_ss<D, W, 0>(dp, aH, aL, bH, bL);
#pragma unroll
    for (int t = 0; t < 4 * W; ++t) dp[t] = s[32 * C + t] * (dp[t] - dsum[(t >> 1) & 1]);
    ring.take(i + 1, request, [&](const float* r) { split_transposed<D, NT>(r, bH, bL); });
    product_acc<D, W, 0>(acc, dp, bH, bL);
  });

  const int lane = threadIdx.x % 32;
  const int row0 = q0 + kTile * wg + 16 * (threadIdx.x % kThreads / 32) + lane / 4;
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (r < n) {
        const long long idx = (long long)slice * n + r;
        stats[idx] = m[i];
        stats[total + idx] = l[i];
        stats[2 * total + idx] = rl[i];
        stats[3 * total + idx] = dsum[i];
      }
    }
  }
  store_rows<D>(dq, (long long)slice * n, q0 + kTile * wg, n, acc,
                scale);  // mutation check: dq = (ddots k) * scale
}

// ---- backward, keys: dk and dv ------------------------------------------------

// Raw tiles in the keys kernel's ring: one at d = 128, where two do not fit.
template <int D>
__host__ __device__ constexpr int keys_ring() {
  return D == 128 ? 1 : 2;
}

// Each warpgroup's K and V planes, a query tile's two planes, the ring, the
// statistics of a query tile (m, 1 / l, D), the ring's barriers.
template <int D>
__host__ __device__ constexpr size_t keys_smem() {
  return 1024 + (4 * warpgroups<D>() + 2 + keys_ring<D>()) * tile_bytes<D>() + 3 * kTile * 4 +
         keys_ring<D>() * 8;
}

template <int D>
__global__ void __launch_bounds__(kThreads * warpgroups<D>(), 1)
attn_bwd_keys_f32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const float* __restrict__ stats, float* __restrict__ dk,
                         float* __restrict__ dv, int n, int tiles, long long total,
                         float scale) {
  constexpr int WG = warpgroups<D>(), NT = kThreads * WG;
  constexpr int T = kTile * D, S = keys_ring<D>();
  extern __shared__ unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(align1024(smem_raw));
  const int wg = threadIdx.x / kThreads;
  const float *kH = sm + 4 * T * wg, *kL = kH + T, *vH = kH + 2 * T, *vL = kH + 3 * T;
  float *bH = sm + 4 * T * WG, *bL = bH + T;
  float* sStat = bL + (1 + S) * T;  // [3][64]: m, 1 / l, D of the query tile
  const Ring<D, S, NT> ring{bL + T, smem_u32(sStat + 3 * kTile)};
  const int slice = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * kTile * WG;
  const long long row_base = (long long)slice * n;
  const int qtiles = cdiv(n, kTile);

  // tiles: K and V of each warpgroup, then of each query tile Q, G (as they
  // are), G, Q (transposed)
  auto request = [&](int i) {
    if (i < 2 * WG) {
      ring.request(i, i % 2 == 0 ? &tk : &tv, k0 + kTile * (i / 2), slice);
    } else if (i < 2 * WG + 4 * qtiles) {
      const int j = (i - 2 * WG) % 4;
      ring.request(i, j == 0 || j == 3 ? &tq : &tg, kTile * ((i - 2 * WG) / 4), slice);
    }
  };
  if (threadIdx.x == 0) {
    ring.init();
#pragma unroll
    for (int i = 0; i < S; ++i) request(i);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2 * WG; ++i)
    ring.take(i, request, [&](const float* r) {
      float* h = sm + 4 * T * (i / 2) + 2 * T * (i % 2);
      split_plain<D, NT>(r, h, h + T);
    });

  float acc_v[D / 2], acc_k[D / 2];
#pragma unroll
  for (int t = 0; t < D / 2; ++t) acc_v[t] = acc_k[t] = 0.0f;
  const int c0 = 2 * (threadIdx.x % 4);

#pragma unroll 1
  for (int it = 0; it < qtiles; ++it) {
    const int r0 = kTile * it, i0 = 2 * WG + 4 * it;
    // the statistics of this query tile (planes 0, 2 and 3); the last
    // tile's reads of sStat ended before its transposed G was split
    for (int x = threadIdx.x; x < 3 * kTile; x += NT) {
      const int which = x / kTile, r = r0 + x % kTile;
      sStat[x] = r < n ? stats[(which == 0 ? 0 : which + 1) * total + row_base + r] : 0.0f;
    }
    // One query tile of W blocks of 8 queries: the last tile of a slice
    // takes only the blocks that hold queries below n.
    auto step = [&](auto w) {
      constexpr int W = decltype(w)::value;
      // S^T = K Q^T and dP^T = V G^T: rows are this warpgroup's keys, columns queries
      float sT[32], dpT[32];
      ring.take(i0, request, [&](const float* r) { split_plain<D, NT>(r, bH, bL); });
      product_ss<D, W, 0>(sT, kH, kL, bH, bL);
      ring.take(i0 + 1, request, [&](const float* r) { split_plain<D, NT>(r, bH, bL); });
      product_ss<D, W, 0>(dpT, vH, vL, bH, bL);
      // p = expf(s * scale - m) * (1 / l) and ddots = p * (dp - D) as the
      // rows kernel forms them; 0 for the padded queries
#pragma unroll
      for (int t = 0; t < 4 * W; ++t) {
        const int col = 8 * (t / 4) + c0 + (t % 2);
        const float p =
            r0 + col < n ? expf(__fmul_rn(sT[t], scale) - sStat[col]) * sStat[kTile + col]
                         : 0.0f;
        sT[t] = p;
        dpT[t] = p * (dpT[t] - sStat[2 * kTile + col]);
      }
      ring.take(i0 + 2, request,
                [&](const float* r) { split_transposed<D, NT>(r, bH, bL); });
      product_acc<D, W, 0>(acc_v, sT, bH, bL);  // dv += p^T G
      ring.take(i0 + 3, request,
                [&](const float* r) { split_transposed<D, NT>(r, bH, bL); });
      product_acc<D, W, 0>(acc_k, dpT, bH, bL);  // dk += ddots^T Q
    };
    switch (min(cdiv(n - r0, 8), 8)) {
      case 1: step(std::integral_constant<int, 1>{}); break;
      case 2: step(std::integral_constant<int, 2>{}); break;
      case 3: step(std::integral_constant<int, 3>{}); break;
      case 4: step(std::integral_constant<int, 4>{}); break;
      case 5: step(std::integral_constant<int, 5>{}); break;
      case 6: step(std::integral_constant<int, 6>{}); break;
      case 7: step(std::integral_constant<int, 7>{}); break;
      default: step(std::integral_constant<int, 8>{}); break;
    }
  }
  store_rows<D>(dk, row_base, k0 + kTile * wg, n, acc_k, scale);
  store_rows<D>(dv, row_base, k0 + kTile * wg, n, acc_v, 1.0f);
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

// A map of a contiguous (bh, n, d) fp32 tensor whose box is 64 rows of one
// panel of 32 columns (all 16 at d = 16), swizzled as Layout<d>; rows past
// n of a slice read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int n, int d) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int cols = d >= 32 ? 32 : d;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)n * d * 4};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)kTile, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Maps of the given tensors, in order.
template <int K>
cudaError_t make_maps(CUtensorMap (&maps)[K], const void* const (&ptrs)[K], int bh, int n,
                      int d) {
  for (int i = 0; i < K; ++i) {
    const cudaError_t err = make_map(&maps[i], ptrs[i], bh, n, d);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <class Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct FwdCall {
  const void *q, *k, *v;
  void* o;
  int bh, n;
  float scale;
  cudaStream_t stream;
  template <int D, int NB>
  cudaError_t run() const {
    const auto kern = attn_fwd_f32_kernel<D, NB>;
    CUtensorMap m[3];
    cudaError_t err = set_smem(kern, fwd_smem<D>());
    if (err == cudaSuccess) err = make_maps(m, {q, k, v}, bh, n, D);
    if (err != cudaSuccess) return err;
    const int tiles = cdiv(n, kTile * warpgroups<D>());
    kern<<<bh * tiles, kThreads * warpgroups<D>(), fwd_smem<D>(), stream>>>(
        m[0], m[1], m[2], static_cast<float*>(o), n, tiles, scale);
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
    const auto kern = attn_bwd_rows_f32_kernel<D, NB>;
    CUtensorMap m[4];
    cudaError_t err = set_smem(kern, rows_smem<D>());
    if (err == cudaSuccess) err = make_maps(m, {q, k, v, g}, bh, n, D);
    if (err != cudaSuccess) return err;
    const int tiles = cdiv(n, kTile * warpgroups<D>());
    kern<<<bh * tiles, kThreads * warpgroups<D>(), rows_smem<D>(), stream>>>(
        m[0], m[1], m[2], m[3], static_cast<float*>(dq), static_cast<float*>(stats), n, tiles,
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
    const auto kern = attn_bwd_keys_f32_kernel<D>;
    CUtensorMap m[4];
    cudaError_t err = set_smem(kern, keys_smem<D>());
    if (err == cudaSuccess) err = make_maps(m, {q, k, v, g}, bh, n, D);
    if (err != cudaSuccess) return err;
    const int tiles = cdiv(n, kTile * warpgroups<D>());
    kern<<<bh * tiles, kThreads * warpgroups<D>(), keys_smem<D>(), stream>>>(
        m[0], m[1], m[2], m[3], static_cast<const float*>(stats), static_cast<float*>(dk),
        static_cast<float*>(dv), n, tiles, (long long)bh * n, scale);
    return cudaGetLastError();
  }
};

// Blocks per SM, registers per thread, local (spill) bytes per thread and
// dynamic shared memory per block of one kernel (blocks of `threads`).
template <class Kern>
cudaError_t kernel_info(Kern kern, int threads, size_t smem, int* out) {
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, threads, smem);
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
    constexpr int threads = kThreads * warpgroups<D>();
    if (which == 0) return kernel_info(attn_fwd_f32_kernel<D, NB>, threads, fwd_smem<D>(), out);
    if (which == 1)
      return kernel_info(attn_bwd_rows_f32_kernel<D, NB>, threads, rows_smem<D>(), out);
    return kernel_info(attn_bwd_keys_f32_kernel<D>, threads, keys_smem<D>(), out);
  }
};

// The forward and rows kernels are instantiated for every multiple of 8
// keys at d = 64 (the models' head width) and for multiples of 64 keys at
// the other widths (fewer instantiations, a shorter build): NB blocks of 8.
template <int D, int NB, class Call>
cudaError_t by_blocks(const Call& call, int nb) {
  constexpr int kStep = D == 64 ? 1 : 8;
  if constexpr (NB + kStep > kMaxN / 8) {
    return call.template run<D, NB>();
  } else {
    if (nb <= NB) return call.template run<D, NB>();
    return by_blocks<D, NB + kStep>(call, nb);
  }
}

template <class Call>
int dispatch(const Call& call, int n, int d) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  const int nb = cdiv(n, 8);
  switch (d) {
    case 16: return (int)by_blocks<16, 8>(call, nb);
    case 32: return (int)by_blocks<32, 8>(call, nb);
    case 64: return (int)by_blocks<64, 1>(call, nb);
    case 128: return (int)by_blocks<128, 8>(call, nb);
    default: return (int)cudaErrorInvalidValue;
  }
}

static_assert(keys_smem<128>() <= 232448 && fwd_smem<128>() <= 232448 &&
                  keys_smem<64>() <= 232448 && fwd_smem<64>() <= 232448,
              "a block's shared memory fits the H100's 227 KB");

}  // namespace

extern "C" {

// Largest n the kernels take (a 64-row query tile's score row in registers).
int gslora_attn_max_n() { return kMaxN; }

// Planes of fp32 row statistics the backward's scratch holds (m, l, 1 / l, D).
int gslora_attn_stats() { return kStats; }

// o = softmax(q k^T * scale) v over bh contiguous (n, d) fp32 slices.
// Each entry point returns cudaGetLastError() after its launch (0 on success).
int gslora_attn_fwd(const void* q, const void* k, const void* v, void* o, int bh, int n,
                    int d, float scale, void* stream) {
  return dispatch(FwdCall{q, k, v, o, bh, n, scale, static_cast<cudaStream_t>(stream)}, n, d);
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
