// Fused instance norm + LeakyReLU forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel littlegan_tpu/ops/pallas/norm_lrelu.py
// (_fwd_kernel / _fwd_pallas). Per sample n of an NHWC tensor with
// M = H*W*C elements:
//
//     mean = sum(x)/M,  var = max(sum(x^2)/M - mean^2, 0)      (f32, one pass)
//     z    = (x - mean) * gamma/(sqrt(var) + eps) + beta       (scalar gamma, beta)
//     y    = z >= 0 ? z : alpha*z                              (stored in x's type)
//
// What bounds it on the H100: bytes. It does a few operations per element,
// so the least time is reading x once and writing y once over 3.35 TB/s.
// The TPU kernel held one whole sample in VMEM per sequential grid step; a
// 1 MiB bf16 sample does not fit one SM's shared memory, and one block per
// sample would leave most of the 132 SMs idle at batch 8. So the work is
// split into (sample x chunk) blocks in two launches:
//
//   pass 1 (stats_kernel): each block reduces its chunk to an f32 partial
//       (sum x, sum x^2) and writes it to an (N, chunks) buffer;
//   pass 2 (apply_kernel): each block reduces its sample's partials in a
//       fixed order (no float atomics, so the result is deterministic and
//       every block of a sample sees bit-identical stats), then normalises,
//       applies LeakyReLU and writes its chunk.
//
// Both passes read x with 16-byte vector loads (8 bf16 or 4 f32 per thread
// and load), and pass 2 writes with 16-byte stores. Pass 2 rereads x; a
// chunk set at these sizes (at most a few MB per call) mostly stays in the
// 50 MB L2 between the two launches. lg_norm_lrelu_apply is pass 2 alone,
// fed with per-sample sums from another kernel (the boundary conv's fused
// stats, boundary_conv.cu); lg_norm_stats is pass 1 alone. The backward
// (norm_lrelu_bwd.cu) reduces the same partials in the same order, so it
// sees the forward's mean and std bit for bit.
//
// C interface for ctypes: pointers and the stream are void*, every function
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Elements of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / sizeof(T); }

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
}

// Per-sample chunk [begin, end) of sample n; blockIdx = (chunk, sample).
struct Chunk {
  int64_t begin, end;
};

__device__ __forceinline__ Chunk chunk_of(int64_t m, int64_t chunk) {
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t end = begin + chunk < m ? begin + chunk : m;
  return {begin, end};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ x, float* __restrict__ psum, float* __restrict__ psq,
                 int64_t m, int64_t chunk, int vec_ok) {
  const int64_t n = blockIdx.y;
  const Chunk c = chunk_of(m, chunk);
  const T* xs = x + n * m;
  float s = 0.f, q = 0.f;
  if (vec_ok) {
    constexpr int V = vec_elems<T>();
    const uint4* xv = reinterpret_cast<const uint4*>(xs);
    for (int64_t i = c.begin / V + threadIdx.x; i < c.end / V; i += kThreads) {
      const uint4 raw = __ldg(xv + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float v = to_f32(e[k]);
        s += v;
        q += v * v;
      }
    }
  } else {
    for (int64_t i = c.begin + threadIdx.x; i < c.end; i += kThreads) {
      const float v = to_f32(xs[i]);
      s += v;
      q += v * v;
    }
  }
  __shared__ float ws[kThreads / 32], wq[kThreads / 32];
  warp_sum2(s, q);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = s;
    wq[warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tq = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      ts += ws[w];
      tq += wq[w];
    }
    psum[n * gridDim.x + blockIdx.x] = ts;
    psq[n * gridDim.x + blockIdx.x] = tq;
  }
}

template <typename T>
__device__ __forceinline__ T lrelu_norm(float v, float mean, float inv, float beta, float alpha) {
  const float z = (v - mean) * inv + beta;
  return from_f32<T>(z >= 0.f ? z : alpha * z);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ psum,
                 const float* __restrict__ psq, int parts, const float* __restrict__ gamma,
                 const float* __restrict__ beta, int64_t m, int64_t chunk, float alpha, float eps,
                 int vec_ok) {
  const int64_t n = blockIdx.y;
  __shared__ float stat[2];  // mean, gamma / (std + eps)
  if (threadIdx.x < 32) {
    // fixed-order reduce of this sample's partials: lane-strided sums, then
    // a shuffle tree; identical in every block of the sample
    float s = 0.f, q = 0.f;
    for (int p = threadIdx.x; p < parts; p += 32) {
      s += psum[n * parts + p];
      q += psq[n * parts + p];
    }
    warp_sum2(s, q);
    if (threadIdx.x == 0) {
      const float fm = static_cast<float>(m);
      const float mean = s / fm;
      const float var = fmaxf(q / fm - mean * mean, 0.f);
      stat[0] = mean;
      stat[1] = gamma[0] / (sqrtf(var) + eps);
    }
  }
  __syncthreads();
  const float mean = stat[0], inv = stat[1], b = beta[0];
  const Chunk c = chunk_of(m, chunk);
  const T* xs = x + n * m;
  T* ys = y + n * m;
  if (vec_ok) {
    constexpr int V = vec_elems<T>();
    const uint4* xv = reinterpret_cast<const uint4*>(xs);
    uint4* yv = reinterpret_cast<uint4*>(ys);
    for (int64_t i = c.begin / V + threadIdx.x; i < c.end / V; i += kThreads) {
      const uint4 raw = __ldg(xv + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = lrelu_norm<T>(to_f32(e[k]), mean, inv, b, alpha);
      yv[i] = out;
    }
  } else {
    for (int64_t i = c.begin + threadIdx.x; i < c.end; i += kThreads)
      ys[i] = lrelu_norm<T>(to_f32(xs[i]), mean, inv, b, alpha);
  }
}

int can_vectorize(const void* x, const void* y, int64_t m, int64_t chunk) {
  // 16-byte aligned, and chunks of whole vectors: 8 elements is a whole
  // number of vectors for both types
  return (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
         (m % 8 == 0) && (chunk % 8 == 0);
}

template <typename T>
void launch_apply(const void* x, void* y, const float* s1, const float* s2, int parts,
                  const float* gamma, const float* beta, int64_t n, int64_t m, int64_t chunk,
                  int chunks, float alpha, float eps, cudaStream_t stream) {
  apply_kernel<T><<<dim3(chunks, static_cast<unsigned>(n)), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), s1, s2, parts, gamma, beta, m, chunk, alpha,
      eps, can_vectorize(x, y, m, chunk));
}

template <typename T>
void launch_fused(const void* x, void* y, float* psum, float* psq, const float* gamma,
                  const float* beta, int64_t n, int64_t m, int64_t chunk, int chunks, float alpha,
                  float eps, cudaStream_t stream) {
  stats_kernel<T><<<dim3(chunks, static_cast<unsigned>(n)), kThreads, 0, stream>>>(static_cast<const T*>(x), psum, psq,
                                                             m, chunk, can_vectorize(x, x, m, chunk));
  launch_apply<T>(x, y, psum, psq, chunks, gamma, beta, n, m, chunk, chunks, alpha, eps, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. psum/psq: (n, chunks) f32 scratch.
// Each of the `chunks` blocks of a sample covers `chunk` elements
// (a multiple of 8) of its m = H*W*C.
int lg_norm_lrelu(int dtype, const void* x, void* y, float* psum, float* psq, const float* gamma,
                  const float* beta, int64_t n, int64_t m, int64_t chunk, int chunks, float alpha,
                  float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_fused<float>(x, y, psum, psq, gamma, beta, n, m, chunk, chunks, alpha, eps, s);
  else if (dtype == 1)
    launch_fused<__nv_bfloat16>(x, y, psum, psq, gamma, beta, n, m, chunk, chunks, alpha, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1 alone: the (n, chunks) f32 partials of sum(x) and sum(x^2) that
// lg_norm_lrelu leaves in psum/psq, for a backward given only x.
int lg_norm_stats(int dtype, const void* x, float* psum, float* psq, int64_t n, int64_t m,
                  int64_t chunk, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(chunks, static_cast<unsigned>(n));
  if (dtype == 0)
    stats_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), psum, psq, m, chunk,
                                                  can_vectorize(x, x, m, chunk));
  else if (dtype == 1)
    stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), psum,
                                                          psq, m, chunk, can_vectorize(x, x, m, chunk));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 alone, from per-sample sums s1 = sum(x), s2 = sum(x^2), shape (n,).
int lg_norm_lrelu_apply(int dtype, const void* x, void* y, const float* s1, const float* s2,
                        const float* gamma, const float* beta, int64_t n, int64_t m, int64_t chunk,
                        int chunks, float alpha, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_apply<float>(x, y, s1, s2, 1, gamma, beta, n, m, chunk, chunks, alpha, eps, s);
  else if (dtype == 1)
    launch_apply<__nv_bfloat16>(x, y, s1, s2, 1, gamma, beta, n, m, chunk, chunks, alpha, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* lg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
