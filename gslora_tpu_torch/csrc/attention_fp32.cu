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
// Every value is fp32 and no value is rounded below fp32. No attention
// matrix is written to device memory.
//
// What bounds it: operations. The products run as fp32 FFMA on the CUDA
// cores (67 TFLOP/s on the H100; tensor cores would need TF32, whose
// rounding is far above fp32's). At the ViT-P8S8 shape (384, 197, 64) the
// forward's two products take 0.057 ms at that rate and its bytes 0.023 ms;
// the backward's five products 0.142 ms against 0.041 ms of bytes.
//
// Design (a simple kernel that is right; keys and queries are padded to
// tiles of 64, so at n = 197 a quarter of the products is padding):
//  * Every block is 256 threads. Tiles of 64 rows x d reach shared memory
//    through registers (float4 loads, rows at or past n as zeros), the next
//    tile's load issued before the product on the current one. Rows of a
//    tile are d + 4 floats apart, so that 16 rows read at one column fall in
//    distinct banks.
//  * Every product is one of two shapes, each thread keeping its part of
//    the result in registers: C = A B^T with A and B both contiguous along
//    the sum (a 64 x 64 block, 4 x 4 per thread: rows 4 ty + i, columns
//    tx + 16 j), or C = A B with A contiguous along the sum and B along C's
//    columns (a 64 x d block, d / 16 rows x 4 columns per thread). Each
//    thread sums over k in order, one FFMA at a time: every launch is
//    deterministic (no atomics), and the scores of the keys kernel equal
//    those of the rows kernel to the bit (the same products in the same
//    order).
//  * forward: one block per (slice, 64-row query tile). S = Q K^T * scale
//    over the key tiles into a 64 x n_pad score tile in shared memory
//    (n_pad <= 256), the exact softmax row by row (a warp per row), then
//    O = P V over the key tiles, written rows below n only.
//  * backward, two kernels as attention.cu's:
//    - rows: blocks as the forward's. Recomputes the scores and the softmax
//      (writing m, l and 1 / l of each row), dp = G V^T into a second score
//      tile, D = rowsum(dp * p), ddots = p * (dp - D) in place of p, then
//      dq = ddots K * scale; writes dq and the row statistics m, l, 1 / l, D
//      (4 fp32 planes of BH x n, scratch from the wrapper).
//    - keys: one block per (slice, 64-key tile). K and V of the tile stay in
//      shared memory; for each query tile it recomputes S^T = K Q^T and
//      dP^T = V G^T, forms p = exp(s * scale - m) * (1 / l) and
//      ddots = p * (dp - D) from the statistics (0 past n), stores both as
//      64 x 64 blocks, and accumulates dv += p^T G and dk += ddots^T Q in
//      registers across the query tiles.
// exp is expf (within 2 ulp); 1 / l is correctly rounded; s * scale is
// rounded before the max and the exp in every kernel (__fmul_rn, never
// contracted into an FMA). Padded key columns are masked out of the softmax
// (-inf before the max). The scale is a runtime argument.
// Faults planted by the mutation check sit on lines marked "mutation check".

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // rows of a query or key tile
constexpr int kMaxTiles = 4;  // n_pad <= 256: a score tile of 64 x 256 fp32
constexpr int kMaxN = kTile * kMaxTiles;
constexpr int kStats = 4;     // fp32 row statistics: m, l, 1 / l, D

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Floats between rows of a 64 x D tile, of a 64-row score tile over NT key
// tiles, and of a 64 x 64 block: all 4 past a multiple of 32, so rows four
// apart sit half a bank row apart and 16 consecutive rows in distinct banks.
__host__ __device__ constexpr int tile_pitch(int d) { return d + 4; }
__host__ __device__ constexpr int score_pitch(int nt) { return kTile * nt + 4; }
constexpr int kBlockPitch = kTile + 4;

// Rows [row0, row0 + 64) of a slice's (n, D) rows, held in registers
// (fetch) and then written into a tile of shared memory (put); rows at or
// past n are zeros.
template <int D>
struct Tile {
  static constexpr int kRowVecs = D / 4;               // float4 per row
  static constexpr int kVecs = kTile * D / 4 / kThreads;  // per thread: D / 16
  float4 v[kVecs];

  __device__ __forceinline__ void fetch(const float* __restrict__ src, int row0, int n) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int e = threadIdx.x + kThreads * i, r = e / kRowVecs, c = 4 * (e % kRowVecs);
      v[i] = row0 + r < n
                 ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  __device__ __forceinline__ void put(float* dst) const {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int e = threadIdx.x + kThreads * i, r = e / kRowVecs, c = 4 * (e % kRowVecs);
      *reinterpret_cast<float4*>(dst + r * tile_pitch(D) + c) = v[i];
    }
  }
};

// For each of the NT tiles of 64 rows of `src` in turn: puts it (already
// fetched into r) into sT and calls f(t), fetching the following tile (or,
// after the last, rows [next0, next0 + 64) of `next`, unless it is null)
// while f runs.
template <int D, int NT, class F>
__device__ __forceinline__ void over_tiles(Tile<D>& r, float* sT, const float* src,
                                           const float* next, int next0, int n, F&& f) {
#pragma unroll 1
  for (int t = 0; t < NT; ++t) {
    __syncthreads();  // sT is free: every product on the last tile is done
    r.put(sT);
    __syncthreads();
    if (t + 1 < NT)
      r.fetch(src, kTile * (t + 1), n);
    else if (next != nullptr)
      r.fetch(next, next0, n);
    f(t);
  }
}

// acc[i][j] = sum over k < D of A[4 ty + i][k] * B[tx + 16 j][k], for this
// thread's ty = tid / 16 and tx = tid % 16; A and B 64 x D tiles.
template <int D>
__device__ __forceinline__ void product_abt(float (&acc)[4][4], const float* A, const float* B) {
  constexpr int P = tile_pitch(D);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * P + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * P + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += sum over k < 64 of A[R ty + i][k] * B[k][4 tx + c], for this
// thread's tx = tid % (D / 4) and ty = tid / (D / 4), R = D / 16 rows each;
// A 64 rows of pitch pa (a block of a score tile), B a 64 x D tile.
template <int D>
__device__ __forceinline__ void product_ab(float (&acc)[D / 16][4], const float* A, int pa,
                                           const float* B) {
  constexpr int R = D / 16, TX = D / 4, P = tile_pitch(D);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll 4
  for (int k = 0; k < kTile; k += 4) {
    float4 a[R], b[4];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = *reinterpret_cast<const float4*>(A + (R * ty + i) * pa + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) b[u] = *reinterpret_cast<const float4*>(B + (k + u) * P + 4 * tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[i][0] = fmaf(av[u], b[u].x, acc[i][0]);
        acc[i][1] = fmaf(av[u], b[u].y, acc[i][1]);
        acc[i][2] = fmaf(av[u], b[u].z, acc[i][2]);
        acc[i][3] = fmaf(av[u], b[u].w, acc[i][3]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 16][4]) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
}

// This thread's 4 x 4 of a product_abt block, times mul, into columns
// [col0, col0 + 64) of a 64-row tile of the given pitch.
__device__ __forceinline__ void store_block(float* dst, int pitch, int col0,
                                            const float (&acc)[4][4], float mul) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[(4 * ty + i) * pitch + col0 + tx + 16 * j] = __fmul_rn(acc[i][j], mul);
}

// This thread's rows of a product_ab result, times mul, to rows
// [row0, row0 + 64) of a slice's (n, D) rows; rows at or past n are not
// written.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int row0, int n,
                                           const float (&acc)[D / 16][4], float mul) {
  constexpr int R = D / 16, TX = D / 4;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + R * ty + i;
    if (r < n)
      *reinterpret_cast<float4*>(dst + (size_t)r * D + 4 * tx) =
          make_float4(acc[i][0] * mul, acc[i][1] * mul, acc[i][2] * mul, acc[i][3] * mul);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// In place over the 64 rows of a score tile (pitch score_pitch(NT)): the
// scaled scores x -> p = exp(x - m) * (1 / l), m the row max and l the row
// sum of exp(x - m) over the keys below n; p = 0 at the padded keys. Warp w
// takes rows 8 w .. 8 w + 7, each lane the columns lane + 32 c. Lane 0 calls
// rowstat(row, m, l, 1 / l) for each row.
template <int NT, class F>
__device__ __forceinline__ void softmax_rows(float* sS, int n, F&& rowstat) {
  constexpr int C = kTile * NT / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int rr = 0; rr < 8; ++rr) {
    const int row = 8 * warp + rr;
    float* s = sS + row * score_pitch(NT);
    float x[C];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = lane + 32 * c;
      x[c] = col < n ? s[col] : -INFINITY;  // mutation check: padded keys
      m = fmaxf(m, x[c]);
    }
    m = warp_max(m);
    float l = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      x[c] = expf(x[c] - m);
      l += x[c];
    }
    l = warp_sum(l);
    const float rl = 1.0f / l;
#pragma unroll
    for (int c = 0; c < C; ++c) s[lane + 32 * c] = x[c] * rl;
    if (lane == 0) rowstat(row, m, l, rl);
  }
}

// ---- forward -------------------------------------------------------------------

template <int D, int NT>
__host__ __device__ constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * kTile * tile_pitch(D) + kTile * score_pitch(NT));
}

template <int D, int NT>
__global__ void __launch_bounds__(kThreads)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int n, int tiles,
                    float scale) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sT = sQ + kTile * tile_pitch(D);  // a tile of K, then of V
  float* sS = sT + kTile * tile_pitch(D);  // scores, then p
  const int slice = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * kTile;
  const size_t base = (size_t)slice * n * D;
  q += base, k += base, v += base, o += base;

  Tile<D> r;
  r.fetch(q, q0, n);
  r.put(sQ);
  r.fetch(k, 0, n);
  over_tiles<D, NT>(r, sT, k, v, 0, n, [&](int t) {
    float acc[4][4];
    product_abt<D>(acc, sQ, sT);
    store_block(sS, score_pitch(NT), kTile * t, acc, scale);
  });
  __syncthreads();
  softmax_rows<NT>(sS, n, [](int, float, float, float) {});

  float acc[D / 16][4];
  zero<D>(acc);
  over_tiles<D, NT>(r, sT, v, nullptr, 0, n, [&](int t) {
    product_ab<D>(acc, sS + kTile * t, score_pitch(NT), sT);
  });
  store_rows<D>(o, q0, n, acc, 1.0f);
}

// ---- backward, rows: dq and the row statistics --------------------------------

template <int D, int NT>
__host__ __device__ constexpr size_t rows_smem() {
  return sizeof(float) * (2 * kTile * tile_pitch(D) + 2 * kTile * score_pitch(NT));
}

template <int D, int NT>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rows_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ g,
                         float* __restrict__ dq, float* __restrict__ stats, int n, int tiles,
                         long long total, float scale) {
  constexpr int SP = score_pitch(NT);
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // Q's tile, then G's
  float* sT = sA + kTile * tile_pitch(D);       // a tile of K or V
  float* sS = sT + kTile * tile_pitch(D);       // scores, p, then ddots
  float* sP = sS + kTile * SP;                  // dp
  const int slice = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * kTile;
  const size_t base = (size_t)slice * n * D;
  const long long row_base = (long long)slice * n + q0;
  q += base, k += base, v += base, g += base, dq += base;

  Tile<D> r;
  r.fetch(q, q0, n);
  r.put(sA);
  r.fetch(k, 0, n);
  over_tiles<D, NT>(r, sT, k, g, q0, n, [&](int t) {
    float acc[4][4];
    product_abt<D>(acc, sA, sT);
    store_block(sS, SP, kTile * t, acc, scale);
  });
  __syncthreads();  // the scores are done: Q's tile is free for G's
  r.put(sA);
  r.fetch(v, 0, n);
  softmax_rows<NT>(sS, n, [&](int row, float m, float l, float rl) {
    if (q0 + row < n) {
      stats[row_base + row] = m;
      stats[total + row_base + row] = l;
      stats[2 * total + row_base + row] = rl;
    }
  });
  over_tiles<D, NT>(r, sT, v, k, 0, n, [&](int t) {
    float acc[4][4];
    product_abt<D>(acc, sA, sT);
    store_block(sP, SP, kTile * t, acc, 1.0f);
  });
  __syncthreads();

  // D = rowsum(dp * p), then ddots = p * (dp - D) in place of p
  {
    constexpr int C = kTile * NT / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
    for (int rr = 0; rr < 8; ++rr) {
      const int row = 8 * warp + rr;
      float* s = sS + row * SP;
      const float* dp = sP + row * SP;
      float dsum = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) dsum += dp[lane + 32 * c] * s[lane + 32 * c];  // mutation check: rowsum
      dsum = warp_sum(dsum);
#pragma unroll
      for (int c = 0; c < C; ++c) s[lane + 32 * c] *= dp[lane + 32 * c] - dsum;
      if (lane == 0 && q0 + row < n) stats[3 * total + row_base + row] = dsum;
    }
  }

  float acc[D / 16][4];
  zero<D>(acc);
  over_tiles<D, NT>(r, sT, k, nullptr, 0, n, [&](int t) {
    product_ab<D>(acc, sS + kTile * t, SP, sT);
  });
  store_rows<D>(dq, q0, n, acc, scale);  // mutation check: dq = (ddots k) * scale
}

// ---- backward, keys: dk and dv ------------------------------------------------

template <int D>
__host__ __device__ constexpr size_t keys_smem() {
  return sizeof(float) * (4 * kTile * tile_pitch(D) + 2 * kTile * kBlockPitch + 3 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_keys_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ g,
                         const float* __restrict__ stats, float* __restrict__ dk,
                         float* __restrict__ dv, int n, int tiles, long long total,
                         float scale) {
  constexpr int TP = tile_pitch(D);
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile * TP;
  float* sQ = sV + kTile * TP;
  float* sG = sQ + kTile * TP;
  float* sPT = sG + kTile * TP;            // p^T: rows keys, columns queries
  float* sDT = sPT + kTile * kBlockPitch;  // ddots^T
  float* sStat = sDT + kTile * kBlockPitch;  // m, 1 / l, D of the query tile
  const int slice = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * kTile;
  const size_t base = (size_t)slice * n * D;
  const long long row_base = (long long)slice * n;
  q += base, k += base, v += base, g += base, dk += base, dv += base;

  Tile<D> r;
  r.fetch(k, k0, n);
  r.put(sK);
  r.fetch(v, k0, n);
  r.put(sV);
  float acc_k[D / 16][4], acc_v[D / 16][4];
  zero<D>(acc_k);
  zero<D>(acc_v);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

#pragma unroll 1
  for (int it = 0; it < tiles; ++it) {
    const int r0 = kTile * it;
    __syncthreads();  // the last query tile's products are done
    r.fetch(q, r0, n);
    r.put(sQ);
    r.fetch(g, r0, n);
    r.put(sG);
    if (threadIdx.x < 3 * kTile) {
      const int which = threadIdx.x / kTile, row = r0 + threadIdx.x % kTile;
      const int plane = which == 0 ? 0 : which + 1;  // planes m, 1 / l, D
      sStat[threadIdx.x] = row < n ? stats[plane * total + row_base + row] : 0.0f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    product_abt<D>(s, sK, sQ);  // S^T = K Q^T: rows keys 4 ty + i, columns queries tx + 16 j
    product_abt<D>(dp, sV, sG);  // dP^T = V G^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const float m = sStat[col], rl = sStat[kTile + col], dsum = sStat[2 * kTile + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = r0 + col < n ? expf(__fmul_rn(s[i][j], scale) - m) * rl : 0.0f;
        sPT[(4 * ty + i) * kBlockPitch + col] = p;
        sDT[(4 * ty + i) * kBlockPitch + col] = p * (dp[i][j] - dsum);
      }
    }
    __syncthreads();
    product_ab<D>(acc_v, sPT, kBlockPitch, sG);  // dv += p^T G
    product_ab<D>(acc_k, sDT, kBlockPitch, sQ);  // dk += ddots^T Q
  }
  store_rows<D>(dk, k0, n, acc_k, scale);
  store_rows<D>(dv, k0, n, acc_v, 1.0f);
}

// ---- launches ------------------------------------------------------------------

template <class Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct FwdCall {
  const float *q, *k, *v;
  float* o;
  int bh, n;
  float scale;
  cudaStream_t stream;
  template <int D, int NT>
  cudaError_t run() const {
    const auto kern = attn_fwd_f32_kernel<D, NT>;
    const size_t smem = fwd_smem<D, NT>();
    const cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    const int tiles = cdiv(n, kTile);
    kern<<<bh * tiles, kThreads, smem, stream>>>(q, k, v, o, n, tiles, scale);
    return cudaGetLastError();
  }
};

struct RowsCall {
  const float *q, *k, *v, *g;
  float *dq, *stats;
  int bh, n;
  float scale;
  cudaStream_t stream;
  template <int D, int NT>
  cudaError_t run() const {
    const auto kern = attn_bwd_rows_f32_kernel<D, NT>;
    const size_t smem = rows_smem<D, NT>();
    const cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    const int tiles = cdiv(n, kTile);
    kern<<<bh * tiles, kThreads, smem, stream>>>(q, k, v, g, dq, stats, n, tiles,
                                                 (long long)bh * n, scale);
    return cudaGetLastError();
  }
};

struct KeysCall {
  const float *q, *k, *v, *g, *stats;
  float *dk, *dv;
  int bh, n;
  float scale;
  cudaStream_t stream;
  template <int D, int NT>
  cudaError_t run() const {
    const auto kern = attn_bwd_keys_f32_kernel<D>;
    const size_t smem = keys_smem<D>();
    const cudaError_t err = set_smem(kern, smem);
    if (err != cudaSuccess) return err;
    const int tiles = cdiv(n, kTile);
    kern<<<bh * tiles, kThreads, smem, stream>>>(q, k, v, g, stats, dk, dv, n, tiles,
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
  template <int D, int NT>
  cudaError_t run() const {
    if (which == 0) return kernel_info(attn_fwd_f32_kernel<D, NT>, fwd_smem<D, NT>(), out);
    if (which == 1) return kernel_info(attn_bwd_rows_f32_kernel<D, NT>, rows_smem<D, NT>(), out);
    return kernel_info(attn_bwd_keys_f32_kernel<D>, keys_smem<D>(), out);
  }
};

// The kernels are instantiated for every count of 64-key tiles up to n_pad.
template <int D, class Call>
cudaError_t by_tiles(const Call& call, int n) {
  if (n < 1 || n > kMaxN) return cudaErrorInvalidValue;
  switch (cdiv(n, kTile)) {
    case 1: return call.template run<D, 1>();
    case 2: return call.template run<D, 2>();
    case 3: return call.template run<D, 3>();
    default: return call.template run<D, 4>();
  }
}

template <class Call>
int dispatch(const Call& call, int n, int d) {
  switch (d) {
    case 16: return (int)by_tiles<16>(call, n);
    case 32: return (int)by_tiles<32>(call, n);
    case 64: return (int)by_tiles<64>(call, n);
    case 128: return (int)by_tiles<128>(call, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

static_assert(kMaxTiles == 4, "by_tiles instantiates 1..4 key tiles");
static_assert(rows_smem<128, 4>() <= 232448 && keys_smem<128>() <= 232448,
              "a block's shared memory fits the H100's 227 KB");

}  // namespace

extern "C" {

// Largest n the kernels take (a 64-row query tile's scores in shared memory).
int gslora_attn_max_n() { return kMaxN; }

// Planes of fp32 row statistics the backward's scratch holds (m, l, 1 / l, D).
int gslora_attn_stats() { return kStats; }

// o = softmax(q k^T * scale) v over bh contiguous (n, d) fp32 slices.
// Each entry point returns cudaGetLastError() after its launch (0 on success).
int gslora_attn_fwd(const void* q, const void* k, const void* v, void* o, int bh, int n,
                    int d, float scale, void* stream) {
  return dispatch(FwdCall{static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<float*>(o), bh, n, scale,
                          static_cast<cudaStream_t>(stream)},
                  n, d);
}

// Backward, first launch: dq, and the row statistics (fp32, kStats planes of
// bh * n) that the second launch reads.
int gslora_attn_bwd_rows(const void* q, const void* k, const void* v, const void* g,
                         void* dq, void* stats, int bh, int n, int d, float scale,
                         void* stream) {
  return dispatch(RowsCall{static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<const float*>(g),
                           static_cast<float*>(dq), static_cast<float*>(stats), bh, n, scale,
                           static_cast<cudaStream_t>(stream)},
                  n, d);
}

// Backward, second launch: dk and dv from the statistics.
int gslora_attn_bwd_keys(const void* q, const void* k, const void* v, const void* g,
                         const void* stats, void* dk, void* dv, int bh, int n, int d,
                         float scale, void* stream) {
  return dispatch(KeysCall{static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<const float*>(g),
                           static_cast<const float*>(stats), static_cast<float*>(dk),
                           static_cast<float*>(dv), bh, n, scale,
                           static_cast<cudaStream_t>(stream)},
                  n, d);
}

// out[4] = blocks per SM, registers per thread, spill bytes per thread and
// shared memory per block of kernel `which` (0 forward, 1 backward rows,
// 2 backward keys) at (n, d).
int gslora_attn_kernel_info(int which, int n, int d, int* out) {
  return dispatch(InfoCall{which, out}, n, d);
}

}  // extern "C"
