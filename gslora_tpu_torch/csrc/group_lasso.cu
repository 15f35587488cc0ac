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
// What bounds it: bytes. At the flagship (L=6, r=8, d=512, m=2048) a layer
// holds 40,960 elements (160 KB in fp32); the prox reads and writes all of
// them once (1.97 MB in fp32, 0.59 us at 3.35 TB/s), the norms read them
// (0.29 us), the scale reads and writes (0.59 us). At these sizes a launch
// costs more than the bytes, so the design is right and simple first.
//
// Design. The TPU runs a sequential grid over L with each layer's four
// slices in VMEM. Here one block owns one layer and reduces inside the
// block: pass 1 takes the fp32 sum of squares over the layer's four
// contiguous spans, each thread over a fixed strided subset, then a
// fixed-order warp-shuffle and shared-memory tree (no atomics, so the
// result is the same from run to run); after __syncthreads, pass 2 scales
// and stores. A layer is not assumed to fit in shared memory (ViT-B/16:
// 245 KB in fp32), so pass 2 reads the layer again, from L2.
//
// In place: the prox may be given out == in (the port's optimizer updates
// the LoRA parameters in place). That is safe only because one block owns
// a whole layer: every read of pass 1 is done before the barrier, and in
// pass 2 each element is read and written by the same thread.
//
// Ragged spans: the four spans of a layer have different sizes, down to 1
// element. Each span is walked as a scalar head up to the first 16-byte
// boundary, a body of 16-byte vectors, and a scalar tail; the vector body
// is used for a copy only where input and output share their alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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

// Sum of v over the block, in a fixed order; every thread gets the sum.
// `red` holds kWarps + 1 floats of shared memory.
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < kWarps ? red[lane] : 0.0f;
    x = warp_sum(x);
    if (lane == 0) red[kWarps] = x;
  }
  __syncthreads();
  const float total = red[kWarps];
  __syncthreads();  // red may be reused by the next call
  return total;
}

// Elements of T before the first 16-byte boundary of p, at most n.
template <typename T>
__device__ __forceinline__ long long head_len(const T* p, long long n) {
  const long long mis = (long long)((uintptr_t)p % 16);
  const long long head = mis == 0 ? 0 : (16 - mis) / (long long)sizeof(T);
  return head < n ? head : n;
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

// This thread's share of sum(p[i]^2, i < n), in fp32.
template <typename T>
__device__ float span_sqsum(const T* __restrict__ p, long long n) {
  constexpr int V = 16 / sizeof(T);
  const long long head = head_len(p, n);
  const long long nvec = (n - head) / V;
  const long long tail0 = head + nvec * V;
  float s = 0.0f;
  for (long long i = threadIdx.x; i < head; i += blockDim.x) {
    const float x = to_f(p[i]);
    s += x * x;
  }
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  for (long long i = threadIdx.x; i < nvec; i += blockDim.x)
    s += vec_sqsum(pv[i], T());
  for (long long i = tail0 + threadIdx.x; i < n; i += blockDim.x) {
    const float x = to_f(p[i]);
    s += x * x;
  }
  return s;
}

// out[i] = in[i] * s for i < n (out may be in).
template <typename T>
__device__ void span_scale(const T* in, T* out, long long n, T s) {
  constexpr int V = 16 / sizeof(T);
  long long head = head_len(in, n);
  long long nvec = (n - head) / V;
  if ((uintptr_t)in % 16 != (uintptr_t)out % 16) {
    head = n;  // no common alignment: all scalar
    nvec = 0;
  }
  const long long tail0 = head + nvec * V;
  for (long long i = threadIdx.x; i < head; i += blockDim.x)
    out[i] = mul(in[i], s);
  const uint4* iv = reinterpret_cast<const uint4*>(in + head);
  uint4* ov = reinterpret_cast<uint4*>(out + head);
  for (long long i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 u = iv[i];
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = mul(e[j], s);
    ov[i] = u;
  }
  for (long long i = tail0 + threadIdx.x; i < n; i += blockDim.x)
    out[i] = mul(in[i], s);
}

// The four spans of one layer: base pointers of the stacked tensors and
// the per-layer element counts.
struct Spans {
  const void* in[4];
  void* out[4];
  long long n[4];
};

// fp32 norm of layer l: the four span sums taken separately and added in
// order, as the Pallas kernels do.
template <typename T>
__device__ float layer_norm(const Spans& sp, int l, float* red) {
  float total = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {  // A1, B1, A2, B2
    const T* p = static_cast<const T*>(sp.in[t]) + (long long)l * sp.n[t];
    total += block_sum(span_sqsum(p, sp.n[t]), red);
  }
  return sqrtf(total);
}

template <typename T>
__device__ void layer_scale(const Spans& sp, int l, T s) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const long long off = (long long)l * sp.n[t];
    span_scale(static_cast<const T*>(sp.in[t]) + off,
               static_cast<T*>(sp.out[t]) + off, sp.n[t], s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_prox_kernel(Spans sp, float thr) {
  __shared__ float red[kWarps + 1];
  const int l = blockIdx.x;
  const float norm = layer_norm<T>(sp, l, red);  // ends in __syncthreads
  const float scale = fmaxf(0.0f, 1.0f - thr / fmaxf(norm, 1e-12f));
  layer_scale<T>(sp, l, from_f<T>(scale));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norms_kernel(Spans sp, float* __restrict__ norms) {
  __shared__ float red[kWarps + 1];
  const float norm = layer_norm<T>(sp, blockIdx.x, red);
  if (threadIdx.x == 0) norms[blockIdx.x] = norm;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_scale_kernel(Spans sp, const T* __restrict__ scales) {
  layer_scale<T>(sp, blockIdx.x, scales[blockIdx.x]);
}

Spans make_spans(const void* a1, const void* b1, const void* a2,
                 const void* b2, void* o1, void* o2, void* o3, void* o4,
                 long long n1, long long n2, long long n3, long long n4) {
  Spans sp;
  sp.in[0] = a1; sp.in[1] = b1; sp.in[2] = a2; sp.in[3] = b2;
  sp.out[0] = o1; sp.out[1] = o2; sp.out[2] = o3; sp.out[3] = o4;
  sp.n[0] = n1; sp.n[1] = n2; sp.n[2] = n3; sp.n[3] = n4;
  return sp;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; anything else is refused. Every
// function launches one block per layer on `stream` and returns
// cudaGetLastError() after the launch (0 on success).
extern "C" {

// K2: o_t = theta_t * T(max(0, 1 - thr / max(n_l, 1e-12))) per layer l;
// o_t may be the input itself (in place).
int gslora_group_prox(int dtype, const void* a1, const void* b1,
                      const void* a2, const void* b2, void* o1, void* o2,
                      void* o3, void* o4, int layers, long long n1,
                      long long n2, long long n3, long long n4, float thr,
                      void* stream) {
  if (layers < 1) return (int)cudaErrorInvalidValue;
  const Spans sp = make_spans(a1, b1, a2, b2, o1, o2, o3, o4, n1, n2, n3, n4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    group_prox_kernel<float><<<layers, kThreads, 0, s>>>(sp, thr);
  else if (dtype == 1)
    group_prox_kernel<bf16><<<layers, kThreads, 0, s>>>(sp, thr);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K3 forward: norms[l] = n_l (fp32, no eps).
int gslora_group_norms(int dtype, const void* a1, const void* b1,
                       const void* a2, const void* b2, void* norms,
                       int layers, long long n1, long long n2, long long n3,
                       long long n4, void* stream) {
  if (layers < 1) return (int)cudaErrorInvalidValue;
  const Spans sp = make_spans(a1, b1, a2, b2, nullptr, nullptr, nullptr,
                              nullptr, n1, n2, n3, n4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(norms);
  if (dtype == 0)
    group_norms_kernel<float><<<layers, kThreads, 0, s>>>(sp, out);
  else if (dtype == 1)
    group_norms_kernel<bf16><<<layers, kThreads, 0, s>>>(sp, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K3 backward: o_t = theta_t * scales[l], scales (L,) in the parameter type.
int gslora_group_scale(int dtype, const void* a1, const void* b1,
                       const void* a2, const void* b2, const void* scales,
                       void* o1, void* o2, void* o3, void* o4, int layers,
                       long long n1, long long n2, long long n3, long long n4,
                       void* stream) {
  if (layers < 1) return (int)cudaErrorInvalidValue;
  const Spans sp = make_spans(a1, b1, a2, b2, o1, o2, o3, o4, n1, n2, n3, n4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    group_scale_kernel<float><<<layers, kThreads, 0, s>>>(
        sp, static_cast<const float*>(scales));
  else if (dtype == 1)
    group_scale_kernel<bf16><<<layers, kThreads, 0, s>>>(
        sp, static_cast<const bf16*>(scales));
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
