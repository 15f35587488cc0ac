// Per-layer group-Lasso kernels for Hopper (sm_90a) over the stacked FFN
// LoRA factors A1 (L, r, d), B1 (L, m, r), A2 (L, r, m), B2 (L, d, r), with
// a plain C interface bound from Python by ctypes
// (gslora_tpu_torch/ops/group_lasso.py). Each kernel is instantiated for
// fp32 and bf16 parameters; every sum is taken in fp32.
//
// Replaces the Pallas TPU kernels of gslora_tpu/ops/group_lasso.py:
//   gslora_group_prox  -> _prox_kernel  (launched by group_prox_pallas, K2)
//     n_l = sqrt(sum a1^2 + sum b1^2 + sum a2^2 + sum b2^2)   (fp32)
//     s_l = T(max(0, 1 - thr / max(n_l, 1e-12)))   (rounded to the
//                                                    parameter type first)
//     theta_l <- theta_l * s_l for all four tensors
//   gslora_group_norms -> _sqsum_kernel (launched by _block_norms, K3)
//     norms[l] = n_l, no eps
//   gslora_group_scale -> _scale_kernel (launched by _scale_by_layer, K3)
//     out_l = theta_l * scales[l] (scales already in the parameter type)
//
// What bounds it: bytes, and below them the cost of one launch. At the
// flagship (L=6, r=8, d=512, m=2048) a layer holds 40,960 elements (160 KB
// in fp32); the prox reads and writes all of them once (1.97 MB in fp32,
// 0.59 us at 3.35 TB/s), the norms read them (0.29 us), the rescale reads
// and writes (0.59 us). One back-to-back launch of an empty kernel costs
// more than any of these (gslora_group_empty measures it).
//
// Design: spread each layer over C blocks, so that C times as many SMs
// pull its bytes, and reduce across them on chip.
//   - Grid (C, L). The prox and the norms launch one thread-block cluster
//     of C blocks per layer (C = 8, the portable size, or 16 where the
//     card allows it); the rescale needs no reduction and no cluster.
//   - Ownership (the launch plan, computed by ops/group_lasso.group_plan
//     and passed in). Each span of a layer (A1_l, B1_l, A2_l, B2_l) is a
//     scalar head up to its first 16-byte address, a body of 16-byte
//     vectors and a scalar tail of fewer than one vector. Rank k owns
//     vectors [k q_t, (k + 1) q_t) of span t's body; rank `edge_owner`
//     owns every head and tail. So every element has exactly one owner,
//     and a share's edges sit on 16-byte addresses.
//   - One read. On the on-chip path (the default while a share fits the
//     plan's shared-memory budget) one thread brings the block's four
//     shares into shared memory with 1-D bulk copies (TMA,
//     cp.async.bulk) on one mbarrier, issued as soon as it has set up
//     the barriers; the prox scales them from there. Where a share does
//     not fit, the prox streams it twice (sum, then re-read from L2 and
//     scale), now spread over C blocks. The prox and the norms are one
//     kernel template; the rescale streams 16-byte loads, the loads of
//     all four spans in flight together.
//   - Reduction. Each block sums its share of each span in fp32 in a
//     fixed order (threads, warp shuffles, warps). It then pushes its
//     four partials through distributed shared memory into its own slot
//     of every receiving block with one st.async, a remote store that
//     completes on the receiver's mbarrier transaction count (the
//     receiver expects C x 16 bytes); a receiver waits for them, reads
//     the C partials of each span in rank order and adds the four span
//     sums A1, B1, A2, B2 in that order, as _prox_kernel does. In the
//     prox every block receives (and forms the same bits); in the norms
//     only rank 0. No atomics: two launches give the same bits. One
//     cluster barrier, split into an arrive right after the mbarriers
//     are set up and a wait just before the first push, makes sure no
//     block pushes into a block that has not set up its barrier; its
//     wait comes after the loads, so it costs next to nothing. (The
//     first design pulled the partials between two full cluster
//     barriers, which cost more than the loads.)
//   - Exit. A receiver leaves only after its barrier has counted the
//     bytes of all C pushes, that is after every push into its shared
//     memory has landed; a block that only pushes may leave at once.
//   - Threads. 128 a block: the work per block is a few thousand
//     vectors, and every warp repeats the share's index arithmetic, so
//     more threads cost more than they hide.
//
// In place: the prox may be given out == in (the port's optimizer updates
// the LoRA parameters in place). That is safe because each element is
// read and written by one block only, its owner, and every read of a
// share comes before that block writes it: the edge elements are read
// first, the body by the bulk copy waited for on the mbarrier (on chip)
// or, on the streamed path, in the first pass before the reduction and
// in the second pass by the same thread that then writes it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// The launch plan (mirrors ops/group_lasso.GroupPlan, passed by ctypes;
// outside the anonymous namespace, as the C interface takes it).
struct Plan {
  int blocks;          // C: blocks per layer (the cluster size of K2, K3-norms)
  int edge_owner;      // rank that owns every span's scalar head and tail
  int onchip;          // 1: the prox and the norms hold the share on chip
  int smem_bytes;      // dynamic shared memory per block
  long long vecs[4];   // q_t: 16-byte vectors of span t's body per rank
};

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;           // non-portable above 8
constexpr int kMaxBlocks = 1024;          // blocks per layer of the rescale
constexpr int kMaxSmem = 220 * 1024;      // dynamic shared memory per block

// The four spans of one layer: base pointers of the stacked tensors and
// the per-layer element counts.
struct Spans {
  const void* in[4];
  void* out[4];
  long long n[4];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's cast
}

// x * s rounded once to T: the product of two bf16 values is exact in fp32,
// so this is the correctly rounded bf16 product, as XLA and torch give it.
__device__ __forceinline__ float mul(float x, float s) { return x * s; }
__device__ __forceinline__ bf16 mul(bf16 x, bf16 s) {
  return __float2bfloat16(__bfloat162float(x) * __bfloat162float(s));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float vec_sqsum(uint4 u, float) {
  const float* f = reinterpret_cast<const float*>(&u);
  return f[0] * f[0] + f[1] * f[1] + f[2] * f[2] + f[3] * f[3];
}

__device__ __forceinline__ float vec_sqsum(uint4 u, bf16) {
  const bf16* h = reinterpret_cast<const bf16*>(&u);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = __bfloat162float(h[i]);
    s += x * x;
  }
  return s;
}

// ---- the share a block owns ---------------------------------------------

// Span t of layer l as block `rank` of the plan sees it; mirrors
// ops/group_lasso.share_edges.
template <typename T>
struct Share {
  const T* in;      // the span in the input
  T* out;           // the span in the output (null for the norms)
  long long n;      // its elements
  long long head;   // elements before in's first 16-byte address
  long long tail0;  // first element after the vector body
  long long v0, v1; // this block's vectors [v0, v1) of the body
  bool vec_out;     // out has in's alignment: the body stores as vectors
};

template <typename T>
__device__ __forceinline__ Share<T> share_of(const Spans& sp, const Plan& pl, int t,
                                             int l, int rank) {
  constexpr long long V = 16 / sizeof(T);
  Share<T> s;
  s.n = sp.n[t];
  s.in = static_cast<const T*>(sp.in[t]) + (long long)l * s.n;
  s.out = sp.out[t] ? static_cast<T*>(sp.out[t]) + (long long)l * s.n : nullptr;
  const long long mis = (long long)((uintptr_t)s.in % 16);
  s.head = mis == 0 ? 0 : (16 - mis) / (long long)sizeof(T);
  if (s.head > s.n) s.head = s.n;
  const long long nv = (s.n - s.head) / V;
  s.tail0 = s.head + nv * V;
  s.v0 = min((long long)rank * pl.vecs[t], nv);
  s.v1 = min(s.v0 + pl.vecs[t], nv);
  s.vec_out = s.out != nullptr && (uintptr_t)s.in % 16 == (uintptr_t)s.out % 16;
  return s;
}

// What one thread needs of its block's shares of the four spans, computed
// once: where the body vectors are read and where they go scaled (as
// vectors where out has in's alignment, else element by element), and,
// for the edge owner's threads i < V, head element i and tail element
// tail0 + i of each span with where they go.
template <typename T>
struct Layer {
  const uint4* src[4];
  T* dst[4];
  long long cnt[4];
  bool vec[4];
  T eh[4], et[4];
  T* ph[4];
  T* pt[4];
};

template <typename T>
__device__ __forceinline__ Layer<T> layer_of(const Spans& sp, const Plan& pl, int l, int rank) {
  constexpr int V = 16 / sizeof(T);
  const bool owner = rank == pl.edge_owner;
  const long long i = threadIdx.x;
  Layer<T> y;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const Share<T> s = share_of<T>(sp, pl, t, l, rank);
    y.src[t] = reinterpret_cast<const uint4*>(s.in + s.head) + s.v0;
    y.cnt[t] = s.v1 - s.v0;
    y.dst[t] = s.out ? s.out + s.head + s.v0 * V : nullptr;
    y.vec[t] = s.vec_out;
    const bool h = owner && i < s.head, e = owner && s.tail0 + i < s.n;
    y.eh[t] = h ? s.in[i] : from_f<T>(0.0f);
    y.et[t] = e ? s.in[s.tail0 + i] : from_f<T>(0.0f);
    y.ph[t] = h && s.out ? s.out + i : nullptr;
    y.pt[t] = e && s.out ? s.out + s.tail0 + i : nullptr;
  }
  return y;
}

// Rounds of the four shares' vectors: round j covers vector j·kThreads +
// threadIdx.x of each span, kRounds rounds at a time, so that a thread
// has the loads of all four spans in flight together.
constexpr int kRounds = 2;

template <typename T>
__device__ __forceinline__ long long most(const Layer<T>& y) {
  return max(max(y.cnt[0], y.cnt[1]), max(y.cnt[2], y.cnt[3]));
}

// The kRounds x 4 vectors of the rounds from j on (zero past a share's end).
template <typename T>
__device__ __forceinline__ void load_rounds(const Layer<T>& y, long long j,
                                            uint4 (&u)[kRounds][4]) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long i = j + r * kThreads;
      u[r][t] = i < y.cnt[t] ? y.src[t][i] : make_uint4(0u, 0u, 0u, 0u);
    }
}

// acc[t] = this thread's fp32 sum of squares of span t's elements (edge
// elements first, then the body vectors in a fixed order, the same from
// shared memory as from device memory).
template <typename T>
__device__ __forceinline__ void sqsum_layer(const Layer<T>& y, float (&acc)[4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float h = to_f(y.eh[t]), e = to_f(y.et[t]);
    acc[t] = h * h + e * e;
  }
  const long long n = most(y);
  for (long long j = threadIdx.x; j < n; j += kRounds * kThreads) {
    uint4 u[kRounds][4];
    load_rounds(y, j, u);
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t] += vec_sqsum(u[r][t], T());
  }
}

// The share's elements times k into the output, in the same rounds.
template <typename T>
__device__ __forceinline__ void scale_layer(const Layer<T>& y, T k) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (y.ph[t]) *y.ph[t] = mul(y.eh[t], k);
    if (y.pt[t]) *y.pt[t] = mul(y.et[t], k);
  }
  const long long n = most(y);
  for (long long j = threadIdx.x; j < n; j += kRounds * kThreads) {
    uint4 u[kRounds][4];
    load_rounds(y, j, u);
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long i = j + r * kThreads;
        T* e = reinterpret_cast<T*>(&u[r][t]);
#pragma unroll
        for (int q = 0; q < V; ++q) e[q] = mul(e[q], k);
        if (i < y.cnt[t]) {  // mutation check: share tail
          if (y.vec[t]) {
            reinterpret_cast<uint4*>(y.dst[t])[i] = u[r][t];
          } else {
#pragma unroll
            for (int q = 0; q < V; ++q) y.dst[t][i * V + q] = e[q];
          }
        }
      }
  }
}

// ---- barriers, bulk copies, the cluster reduction --------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes initialised barriers visible to the cluster and the TMA unit.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of this phase, and the bytes its bulk copies will bring.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for phase `parity` of a barrier of this block; acquire at cluster
// scope, so that what other blocks stored here before arriving is seen.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from 16-byte aligned global src to shared dst,
// completing on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The cluster barrier, split: every thread arrives once its block's
// mbarriers are initialised and waits before it first touches another
// block's shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Stores this block's four partials into slot `slot` of parts[][4] in
// block `rank` of the cluster, as an asynchronous remote store that
// completes its 16 bytes on that block's barrier bar.
__device__ __forceinline__ void push_partials(const float (&p)[4], float (*parts)[4],
                                              int slot, uint32_t bar, uint32_t rank) {
  uint32_t dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(dst)
               : "r"(smem_u32(parts[slot])), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
      " [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "f"(p[0]), "f"(p[1]), "f"(p[2]), "f"(p[3]), "r"(rbar)
      : "memory");
}

// The block's fp32 partial of each span from acc (one per thread), in a
// fixed order: warp shuffles, then the warps in order. Every thread below
// `readers` gets all four.
__device__ __forceinline__ void block_partials(const float (&acc)[4], float (*red)[4],
                                               int readers, float (&p)[4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float v = warp_sum(acc[t]);
    if (lane == 0) red[warp][t] = v;
  }
  __syncthreads();
  if ((int)threadIdx.x < readers) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      p[t] = 0.0f;
      for (int w = 0; w < kWarps; ++w) p[t] += red[w][t];
    }
  }
}

// The layer's fp32 norm from the C partials pushed into parts: each span's
// C partials in rank order, then the four span sums A1, B1, A2, B2, as
// _prox_kernel adds them. Every block forms the same bits.
__device__ __forceinline__ float layer_norm(const float (*parts)[4], int C) {
  float total = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {  // A1, B1, A2, B2
    float span = 0.0f;
    for (int k = 0; k < C; ++k) span += parts[k][t];  // mutation check: remote partials
    total += span;
  }
  return sqrtf(total);
}

// ---- the kernels -----------------------------------------------------------

// K2 (kProx) and K3's norms. Grid (C, L), one cluster of C blocks per
// layer. The prox pushes every block's partials to every block (threads
// 0..C-1, one each) and scales; the norms push to rank 0, which writes
// the norm.
template <typename T, bool kProx>
__global__ void __launch_bounds__(kThreads)
group_norm_kernel(Spans sp, Plan pl, float thr, float* __restrict__ norms) {
  extern __shared__ __align__(128) uint4 stage[];  // the share, span by span
  __shared__ __align__(16) float parts[kMaxCluster][4];
  __shared__ float red[kWarps][4];
  __shared__ __align__(8) uint64_t bars[2];  // the bulk copy; the partials
  const int rank = (int)cg::this_cluster().block_rank(), l = blockIdx.y;
  const bool receives = kProx || rank == 0;
  const uint32_t copied = smem_u32(&bars[0]), pushed = smem_u32(&bars[1]);
  Layer<T> y = layer_of<T>(sp, pl, l, rank);
  if (threadIdx.x == 0) {
    mbar_init(copied, 1);
    mbar_init(pushed, 1);
    mbar_fence_init();
    if (receives) mbar_expect(pushed, 16u * pl.blocks);  // C partials of 16 bytes
    if (pl.onchip) {  // one bulk copy of each span's share into stage
      uint32_t bytes = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) bytes += (uint32_t)y.cnt[t] * 16u;
      mbar_expect(copied, bytes);
      long long off = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (y.cnt[t] > 0)
          bulk_load(smem_u32(stage + off), y.src[t], (uint32_t)y.cnt[t] * 16u, copied);
        off += pl.vecs[t];
      }
    }
  }
  __syncthreads();  // the barriers are initialised
  cluster_arrive();
  if (pl.onchip) {
    long long off = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      y.src[t] = stage + off;
      off += pl.vecs[t];
    }
    mbar_wait(copied, 0);
  }
  float acc[4], p[4];
  sqsum_layer(y, acc);
  const int pushers = kProx ? pl.blocks : 1;
  block_partials(acc, red, pushers, p);
  cluster_wait();  // every block's barriers are initialised
  if ((int)threadIdx.x < pushers)
    push_partials(p, parts, rank, pushed, kProx ? threadIdx.x : 0);
  if (!kProx) {
    if (rank == 0 && threadIdx.x == 0) {
      mbar_wait(pushed, 0);
      norms[l] = layer_norm(parts, pl.blocks);
    }
    return;
  }
  mbar_wait(pushed, 0);
  const float norm = layer_norm(parts, pl.blocks);
  const float scale = fmaxf(0.0f, 1.0f - thr / fmaxf(norm, 1e-12f));  // mutation check: max0
  scale_layer(y, from_f<T>(scale));
}

// K3 backward. Grid (C, L), no cluster: block (rank, l) scales its share.
template <typename T>
__global__ void __launch_bounds__(kThreads)
group_scale_kernel(Spans sp, Plan pl, const T* __restrict__ scales) {
  const Layer<T> y = layer_of<T>(sp, pl, blockIdx.y, blockIdx.x);
  scale_layer(y, scales[blockIdx.y]);
}

__global__ void empty_kernel(int) {}

// ---- launches --------------------------------------------------------------

Spans make_spans(const void* a1, const void* b1, const void* a2,
                 const void* b2, void* o1, void* o2, void* o3, void* o4,
                 long long n1, long long n2, long long n3, long long n4) {
  Spans sp;
  sp.in[0] = a1; sp.in[1] = b1; sp.in[2] = a2; sp.in[3] = b2;
  sp.out[0] = o1; sp.out[1] = o2; sp.out[2] = o3; sp.out[3] = o4;
  sp.n[0] = n1; sp.n[1] = n2; sp.n[2] = n3; sp.n[3] = n4;
  return sp;
}

// A plan the kernels can run: C blocks that cover every span's body at any
// alignment (nv <= n / V), an edge owner among them, and shared memory for
// the share on the on-chip path. cluster: C must be a cluster size.
bool plan_ok(const Plan& pl, const Spans& sp, int elem, int layers, bool cluster) {
  const int max_blocks = cluster ? kMaxCluster : kMaxBlocks;
  if (layers < 1 || layers > 65535 || pl.blocks < 1 || pl.blocks > max_blocks)
    return false;
  if (pl.edge_owner < 0 || pl.edge_owner >= pl.blocks) return false;
  long long share = 0;
  for (int t = 0; t < 4; ++t) {
    if (sp.n[t] < 1 || pl.vecs[t] < 0) return false;
    if (pl.vecs[t] * pl.blocks < sp.n[t] / (16 / elem)) return false;
    share += 16 * pl.vecs[t];
  }
  if (pl.smem_bytes < 0 || pl.smem_bytes > kMaxSmem) return false;
  return !pl.onchip || share <= pl.smem_bytes;
}

// Lets the kernel take up to kMaxSmem of dynamic shared memory and, for a
// cluster kernel, clusters above the portable 8 (once per instantiation).
template <typename K>
void set_attributes(K kernel, bool& done) {
  if (done) return;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = true;
}

cudaLaunchConfig_t config(int blocks, int layers, int cluster, int smem, cudaStream_t s,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, layers, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 1 : 0;
  return cfg;
}

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), bool& attrs, int blocks, int layers, int cluster,
           int smem, void* stream, Args&&... args) {
  set_attributes(kernel, attrs);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      config(blocks, layers, cluster, smem, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int run_prox(const Spans& sp, const Plan& pl, int layers, float thr, void* stream) {
  static bool attrs = false;
  return launch(group_norm_kernel<T, true>, attrs, pl.blocks, layers, pl.blocks,
                pl.onchip ? pl.smem_bytes : 0, stream, sp, pl, thr, (float*)nullptr);
}

template <typename T>
int run_norms(const Spans& sp, const Plan& pl, int layers, float* out, void* stream) {
  static bool attrs = false;
  return launch(group_norm_kernel<T, false>, attrs, pl.blocks, layers, pl.blocks,
                pl.onchip ? pl.smem_bytes : 0, stream, sp, pl, 0.0f, out);
}

template <typename T>
int run_scale(const Spans& sp, const Plan& pl, int layers, const void* scales, void* stream) {
  static bool attrs = false;
  return launch(group_scale_kernel<T>, attrs, pl.blocks, layers, 0, 0, stream, sp, pl,
                static_cast<const T*>(scales));
}

int elem_size(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : 0; }

// Clusters of cfg's shape that can be resident at once; 0 (and success)
// when such a cluster cannot be placed on the card at all.
template <typename... Params>
int active_clusters(void (*kernel)(Params...), bool& attrs, const cudaLaunchConfig_t& cfg,
                    int* active) {
  set_attributes(kernel, attrs);
  *active = 0;
  if (cudaOccupancyMaxActiveClusters(active, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // clear it: an answer, not a fault
    *active = 0;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; anything else is refused, as is a plan
// that does not cover the spans. Every function launches on `stream` and
// returns the launch's error code (0 on success).
extern "C" {

// K2: o_t = theta_t * T(max(0, 1 - thr / max(n_l, 1e-12))) per layer l;
// o_t may be the input itself (in place).
int gslora_group_prox(int dtype, const void* a1, const void* b1,
                      const void* a2, const void* b2, void* o1, void* o2,
                      void* o3, void* o4, int layers, long long n1,
                      long long n2, long long n3, long long n4, float thr,
                      const Plan* plan, void* stream) {
  const Spans sp = make_spans(a1, b1, a2, b2, o1, o2, o3, o4, n1, n2, n3, n4);
  const int elem = elem_size(dtype);
  if (!elem || !plan_ok(*plan, sp, elem, layers, true)) return (int)cudaErrorInvalidValue;
  return dtype == 0 ? run_prox<float>(sp, *plan, layers, thr, stream)
                    : run_prox<bf16>(sp, *plan, layers, thr, stream);
}

// K3 forward: norms[l] = n_l (fp32, no eps).
int gslora_group_norms(int dtype, const void* a1, const void* b1,
                       const void* a2, const void* b2, void* out,
                       int layers, long long n1, long long n2, long long n3,
                       long long n4, const Plan* plan, void* stream) {
  const Spans sp = make_spans(a1, b1, a2, b2, nullptr, nullptr, nullptr,
                              nullptr, n1, n2, n3, n4);
  const int elem = elem_size(dtype);
  if (!elem || !plan_ok(*plan, sp, elem, layers, true)) return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  return dtype == 0 ? run_norms<float>(sp, *plan, layers, o, stream)
                    : run_norms<bf16>(sp, *plan, layers, o, stream);
}

// K3 backward: o_t = theta_t * scales[l], scales (L,) in the parameter type.
int gslora_group_scale(int dtype, const void* a1, const void* b1,
                       const void* a2, const void* b2, const void* scales,
                       void* o1, void* o2, void* o3, void* o4, int layers,
                       long long n1, long long n2, long long n3, long long n4,
                       const Plan* plan, void* stream) {
  const Spans sp = make_spans(a1, b1, a2, b2, o1, o2, o3, o4, n1, n2, n3, n4);
  const int elem = elem_size(dtype);
  if (!elem || !plan_ok(*plan, sp, elem, layers, false)) return (int)cudaErrorInvalidValue;
  return dtype == 0 ? run_scale<float>(sp, *plan, layers, scales, stream)
                    : run_scale<bf16>(sp, *plan, layers, scales, stream);
}

// Clusters of the prox (which = 0) or the norms (1) kernel under `plan`
// that can be resident at once (cudaOccupancyMaxActiveClusters); 0 when
// such a cluster does not fit on the card.
int gslora_group_cluster_info(int dtype, int which, const Plan* plan, int layers,
                              int* active) {
  if (!elem_size(dtype) || which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  const int smem = plan->onchip ? plan->smem_bytes : 0;
  const cudaLaunchConfig_t cfg =
      config(plan->blocks, layers, plan->blocks, smem, nullptr, attr);
  static bool attrs[4] = {};
  const int i = 2 * which + dtype;
  if (i == 0) return active_clusters(group_norm_kernel<float, true>, attrs[i], cfg, active);
  if (i == 1) return active_clusters(group_norm_kernel<bf16, true>, attrs[i], cfg, active);
  if (i == 2) return active_clusters(group_norm_kernel<float, false>, attrs[i], cfg, active);
  return active_clusters(group_norm_kernel<bf16, false>, attrs[i], cfg, active);
}

// The launch floor: an empty kernel on grid (blocks, layers), as clusters
// of `cluster` blocks when cluster > 0.
int gslora_group_empty(int blocks, int layers, int cluster, void* stream) {
  static bool attrs = false;
  return launch(empty_kernel, attrs, blocks, layers, cluster, 0, stream, 0);
}

}  // extern "C"
