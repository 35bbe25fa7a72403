// Fused instance norm + LeakyReLU forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel littlegan_tpu/ops/pallas/norm_lrelu.py
// (_fwd_kernel / _fwd_pallas). Per sample n of an NHWC tensor with
// M = H*W*C elements, f32 moments taken as the Pallas op's _moments takes
// them:
//
//     two_pass (where it holds the sample whole):
//         mean = sum(x)/M,  std = sqrt(sum((x - mean)^2)/M)
//     else (the maps it chunks, and those above its 8 MiB, which the JAX
//     model sends to its one-pass instance_norm):
//         mean = sum(x)/M,  std = sqrt(max(sum(x^2)/M - mean^2, 0))
//     z = (x - mean) * gamma/(std + eps) + beta          (scalar gamma, beta)
//     y = z >= 0 ? z : alpha*z                           (stored in x's type)
//
// What bounds it on the H100: bytes. It does a few operations per element,
// so the least time is reading x once and writing y once over 3.35 TB/s.
// The TPU kernel held one whole sample in VMEM per sequential grid step; a
// 1 MiB bf16 sample does not fit one SM's shared memory, and one block per
// sample would leave most of the 132 SMs idle at batch 8. Two routes, picked
// per shape by the wrapper (fwd_plan in ops/cuda/norm_lrelu.py):
//
// cluster (cluster_kernel), one launch, x read once: one thread block
// cluster per sample, of up to 16 blocks (8 but for the largest samples),
// that holds the sample in its blocks' shared memory:
//   - each block copies its share (a contiguous, 16-byte aligned chunk) into
//     shared memory with 16-byte cp.async; each thread then reduces the
//     vectors it copied itself (no block barrier between copy and use);
//   - warp partials of sum(x) (and sum(x^2) for one pass) go to shared
//     memory; after a cluster barrier every warp of every block adds all of
//     the cluster's warp partials, read through distributed shared memory
//     (all of a lane's loads in flight at once), in one fixed order, so all
//     of them hold the same sums bit for bit (no float atomics, no second
//     launch);
//   - two_pass: each thread sums (x - mean)^2 over its vectors in shared
//     memory and a second exchange gives the sample's sum of squared
//     deviations, at no extra traffic to device memory (the exchange, a
//     cluster barrier and a round of remote loads, is most of the time at
//     the small shapes: chip_smoke.py times the route without it);
//   - each thread normalises its vectors from shared memory and writes y
//     with 16-byte stores; block 0 writes the sample's (mean, std).
//   Unaligned tensors or a length not a multiple of 8 take the same steps
//   with scalar loads.
//
// two launches (stats_kernel, apply_kernel), for samples too large for one
// cluster's shared memory and for one-pass batches whose x the second
// launch finds in L2, split into (sample x chunk) blocks:
//   pass 1 (stats_kernel): each block reduces its chunk to an f32 partial
//       (sum x, sum x^2) and writes it to an (N, chunks) buffer;
//   pass 2 (apply_kernel): each block reduces its sample's partials in a
//       fixed order (every block of a sample sees bit-identical stats), then
//       normalises, applies LeakyReLU and writes its chunk, rereading x;
//       block 0 of each sample writes its (mean, std).
//   two_pass (a sample the Pallas op holds whole that does not fit 16
//   blocks' shared memory: 3.5 to 8 MiB with rows not a multiple of 8,
//   (92, 92, 128) f32 say) adds a launch between the two, dev_kernel: each
//   block reduces its sample's sum(x) partials in the same fixed order to
//   the mean and writes its chunk's sum((x - mean)^2) over the sum(x^2)
//   partial, which pass 2 then reads as the sample's squared deviations.
//   x is read three times; such a batch (tens of MB) outgrows L2, so this
//   costs two more reads of x than the bound (PERF.md).
//
// Both routes write the per-sample moments as a (2, N) f32 array, means
// then stds; the backward (norm_lrelu_bwd.cu) reads them, so it sees the
// forward's moments bit for bit. With y null a call writes the moments
// alone. lg_norm_lrelu_apply is pass 2 alone, fed with per-sample sums from
// another kernel (the boundary conv's fused stats, boundary_conv.cu).
//
// Every tensor is addressed through a Map (norm_map.cuh): x may be a
// window of a larger map (the decoder's, out of its transposed conv's full
// output) and y may be written inside a border of zeros (the encoder's, the
// next stride-2 conv's TF SAME padding), which the launch's blocks write
// too. A sample's elements keep their order, so the sums are those of a
// contiguous sample bit for bit.
//
// C interface for ctypes: pointers and the stream are void*, every function
// returns cudaGetLastError() as an int.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;

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

#include "norm_map.cuh"

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
}

// Butterfly sum: every lane ends with the same value (a + b == b + a).
__device__ __forceinline__ float warp_allsum(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  return a;
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
                 Map xm, int64_t m, int64_t chunk, int vec_ok) {
  const int64_t n = blockIdx.y;
  const Chunk c = chunk_of(m, chunk);
  float s = 0.f, q = 0.f;
  if (vec_ok) {
    constexpr int V = vec_elems<T>();
    for (int64_t i = c.begin / V + threadIdx.x; i < c.end / V; i += kThreads) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + at(xm, n, i * V)));
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
      const float v = to_f32(x[at(xm, n, i)]);
      s += v;
      q += v * v;
    }
  }
  __shared__ float ws[kWarps], wq[kWarps];
  warp_sum2(s, q);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = s;
    wq[warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tq = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      ts += ws[w];
      tq += wq[w];
    }
    psum[n * gridDim.x + blockIdx.x] = ts;
    psq[n * gridDim.x + blockIdx.x] = tq;
  }
}

// The sum of sample n's `parts` partials, lane-strided, then a shuffle
// tree: in lane 0 of the calling warp, in one fixed order, so every block
// of the sample gets it bit for bit.
__device__ __forceinline__ float sample_sum(const float* __restrict__ p, int64_t n, int parts) {
  float s = 0.f;
  for (int i = threadIdx.x & 31; i < parts; i += 32) s += p[n * parts + i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  return s;
}

// The two-pass route's middle launch: grid (chunks, n) as stats_kernel;
// block (c, n) writes sum((x - mean)^2) over its chunk to psq[n, c], the
// mean taken from the sample's psum partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dev_kernel(const T* __restrict__ x, const float* __restrict__ psum, float* __restrict__ psq,
               Map xm, int64_t m, int64_t chunk, int vec_ok) {
  const int64_t n = blockIdx.y;
  __shared__ float smean;
  __shared__ float wq[kWarps];
  if (threadIdx.x < 32) {
    const float s = sample_sum(psum, n, gridDim.x);
    if (threadIdx.x == 0) smean = s / static_cast<float>(m);
  }
  __syncthreads();
  const float mean = smean;
  const Chunk c = chunk_of(m, chunk);
  float q = 0.f;
  if (vec_ok) {
    constexpr int V = vec_elems<T>();
    for (int64_t i = c.begin / V + threadIdx.x; i < c.end / V; i += kThreads) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + at(xm, n, i * V)));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = to_f32(e[k]) - mean;
        q += d * d;
      }
    }
  } else {
    for (int64_t i = c.begin + threadIdx.x; i < c.end; i += kThreads) {
      const float d = to_f32(x[at(xm, n, i)]) - mean;
      q += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) q += __shfl_down_sync(0xffffffffu, q, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) wq[warp] = q;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tq = 0.f;
    for (int w = 0; w < kWarps; ++w) tq += wq[w];
    psq[n * gridDim.x + blockIdx.x] = tq;
  }
}

template <typename T>
__device__ __forceinline__ T lrelu_norm(float v, float mean, float inv, float beta, float alpha) {
  const float z = (v - mean) * inv + beta;
  return from_f32<T>(z >= 0.f ? z : alpha * z);
}

// y null: block 0 of each sample writes the moments and no block writes y
// (the grid may then be (1, n)). moments null: no moments written.
// two_pass: psq holds sum((x - mean)^2) partials (dev_kernel), else sum(x^2).
// ym with a border: the sample's blocks also write its zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ psum,
                 const float* __restrict__ psq, int parts, float* __restrict__ moments,
                 const float* __restrict__ gamma, const float* __restrict__ beta, Map xm, Map ym,
                 int64_t m, int64_t chunk, float alpha, float eps, int vec_ok, int two_pass) {
  const int64_t n = blockIdx.y;
  __shared__ float stat[2];  // mean, gamma / (std + eps)
  if (threadIdx.x < 32) {
    // fixed-order reduce of this sample's partials; identical in every
    // block of the sample, and in dev_kernel's
    const float s = sample_sum(psum, n, parts);
    const float q = sample_sum(psq, n, parts);
    if (threadIdx.x == 0) {
      const float fm = static_cast<float>(m);
      const float mean = s / fm;
      const float sd = two_pass ? sqrtf(q / fm) : sqrtf(fmaxf(q / fm - mean * mean, 0.f));
      stat[0] = mean;
      stat[1] = gamma[0] / (sd + eps);
      if (moments != nullptr && blockIdx.x == 0) {
        moments[n] = mean;
        moments[gridDim.y + n] = sd;
      }
    }
  }
  if (y == nullptr) return;
  zero_border(y, ym, n, m, vec_ok, blockIdx.x, gridDim.x);
  __syncthreads();
  const float mean = stat[0], inv = stat[1], b = beta[0];
  const Chunk c = chunk_of(m, chunk);
  if (vec_ok) {
    constexpr int V = vec_elems<T>();
    for (int64_t i = c.begin / V + threadIdx.x; i < c.end / V; i += kThreads) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + at(xm, n, i * V)));
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = lrelu_norm<T>(to_f32(e[k]), mean, inv, b, alpha);
      *reinterpret_cast<uint4*>(y + at(ym, n, i * V)) = out;
    }
  } else {
    for (int64_t i = c.begin + threadIdx.x; i < c.end; i += kThreads)
      y[at(ym, n, i)] = lrelu_norm<T>(to_f32(x[at(xm, n, i)]), mean, inv, b, alpha);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The cluster barrier in its two halves: a thread arrives once it is done
// with what others must see (release) and waits before it reads what they
// wrote (acquire); every thread of every block of the cluster takes part.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The sample's sums of K values from every thread of the cluster: warp
// partials into this block's `ex` (kWarps x K), a cluster barrier, then
// each warp adds all ranks x kWarps partials, lane-strided in (rank, warp)
// order and a butterfly, so every thread of every block returns the same
// sums. The caller arrives at the next cluster barrier only after this
// returns (a block must not leave while others read its `ex`).
template <int K>
__device__ __forceinline__ void cluster_sums(float (&v)[K], float* ex, int ranks) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float w = warp_allsum(v[k]);
    if (lane == 0) ex[warp * K + k] = w;
  }
  cluster_arrive();
  cluster_wait();
  // all of a lane's remote loads in flight at once, then added in order
  constexpr int kReads = kMaxCluster * kWarps / 32;
  float r[kReads][K];
#pragma unroll
  for (int j = 0; j < kReads; ++j) {
    const int p = lane + 32 * j;
    const bool in = p < ranks * kWarps;
    const float* src = cluster.map_shared_rank(ex, in ? p / kWarps : 0) + (in ? (p % kWarps) * K : 0);
#pragma unroll
    for (int k = 0; k < K; ++k) r[j][k] = in ? src[k] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kReads; ++j) acc += r[j][k];
    v[k] = warp_allsum(acc);
  }
}

// The cluster route: grid (chunks, n) in clusters of `chunks` blocks, one
// cluster per sample. Block `rank` owns elements [rank*chunk, +chunk) of its
// sample and holds them in dynamic shared memory (chunk * sizeof(T) bytes).
// vec_ok: x and y 16-byte aligned, m, chunk and the maps in whole vectors.
// ym with a border: the cluster's blocks also write the sample's zeros.
template <typename T, bool kTwoPass>
__global__ void __launch_bounds__(kThreads)
    cluster_kernel(const T* __restrict__ x, T* __restrict__ y, float* __restrict__ moments,
                   const float* __restrict__ gamma, const float* __restrict__ beta, Map xm, Map ym,
                   int64_t m, int64_t chunk, float alpha, float eps, int vec_ok) {
  constexpr int V = vec_elems<T>();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int64_t n = blockIdx.y;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  __shared__ float ex1[kWarps * 2];  // this block's warp partials, read by the cluster
  __shared__ float ex2[kWarps];

  const int64_t begin = rank * chunk;
  const int64_t end = begin + chunk < m ? begin + chunk : m;
  const int len = begin < end ? static_cast<int>(end - begin) : 0;
  // each thread copies, reduces and writes the same elements: vector i (or
  // element i) for i = threadIdx.x + k*kThreads
  const int nvec = vec_ok ? len / V : 0;
  float s = 0.f, q = 0.f;
  if (vec_ok)
    for (int i = threadIdx.x; i < nvec; i += kThreads) cp_async16(xs + i * V, x + at(xm, n, begin + i * V));
  if (y != nullptr) zero_border(y, ym, n, m, vec_ok, rank, ranks);
  if (vec_ok) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + i * V);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float v = to_f32(e[k]);
        s += v;
        q += v * v;
      }
    }
  } else {
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const T e = x[at(xm, n, begin + i)];
      xs[i] = e;
      const float v = to_f32(e);
      s += v;
      q += v * v;
    }
  }
  const float fm = static_cast<float>(m);
  float mean, sd;
  if (kTwoPass) {
    float t[1] = {s};
    cluster_sums<1>(t, ex1, ranks);
    mean = t[0] / fm;
    float d2 = 0.f;
    if (vec_ok) {
      for (int i = threadIdx.x; i < nvec; i += kThreads) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xs + i * V);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float dv = to_f32(e[k]) - mean;
          d2 += dv * dv;
        }
      }
    } else {
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const float dv = to_f32(xs[i]) - mean;
        d2 += dv * dv;
      }
    }
    float u[1] = {d2};
    cluster_sums<1>(u, ex2, ranks);
    sd = sqrtf(u[0] / fm);
  } else {
    float t[2] = {s, q};
    cluster_sums<2>(t, ex1, ranks);
    mean = t[0] / fm;
    sd = sqrtf(fmaxf(t[1] / fm - mean * mean, 0.f));
  }
  cluster_arrive();  // done reading the cluster's partials
  if (rank == 0 && threadIdx.x == 0 && moments != nullptr) {
    moments[n] = mean;
    moments[gridDim.y + n] = sd;
  }
  if (y != nullptr) {
    const float inv = gamma[0] / (sd + eps), b = beta[0];
    if (vec_ok) {
      for (int i = threadIdx.x; i < nvec; i += kThreads) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xs + i * V);
        const T* e = reinterpret_cast<const T*>(&raw);
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] = lrelu_norm<T>(to_f32(e[k]), mean, inv, b, alpha);
        *reinterpret_cast<uint4*>(y + at(ym, n, begin + i * V)) = out;
      }
    } else {
      for (int i = threadIdx.x; i < len; i += kThreads)
        y[at(ym, n, begin + i)] = lrelu_norm<T>(to_f32(xs[i]), mean, inv, b, alpha);
    }
  }
  cluster_wait();  // no block leaves while another may still read its partials
}

int can_vectorize(const void* x, const void* y, int64_t m, int64_t chunk, const Map& xm, const Map& ym) {
  // 16-byte aligned, and chunks and maps of whole vectors: 8 elements is a
  // whole number of vectors for both types
  return (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
         (m % 8 == 0) && (chunk % 8 == 0) && map_vec(xm) && map_vec(ym);
}

template <typename T>
void launch_apply(const void* x, void* y, const float* s1, const float* s2, int parts,
                  float* moments, const float* gamma, const float* beta, const Map& xm, const Map& ym,
                  int64_t n, int64_t m, int64_t chunk, int chunks, float alpha, float eps, int two_pass,
                  cudaStream_t stream) {
  const dim3 grid(y == nullptr ? 1 : chunks, static_cast<unsigned>(n));
  apply_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), s1, s2, parts, moments, gamma, beta, xm, ym, m,
      chunk, alpha, eps, can_vectorize(x, y == nullptr ? x : y, m, chunk, xm, ym), two_pass);
}

template <typename T>
void launch_two(const void* x, void* y, float* psum, float* psq, float* moments, const float* gamma,
                const float* beta, const Map& xm, const Map& ym, int64_t n, int64_t m, int64_t chunk,
                int chunks, int two_pass, float alpha, float eps, cudaStream_t stream) {
  const dim3 grid(chunks, static_cast<unsigned>(n));
  const int vec_ok = can_vectorize(x, x, m, chunk, xm, xm);
  stats_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), psum, psq, xm, m, chunk, vec_ok);
  if (two_pass)
    dev_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), psum, psq, xm, m, chunk, vec_ok);
  launch_apply<T>(x, y, psum, psq, chunks, moments, gamma, beta, xm, ym, n, m, chunk, chunks, alpha, eps,
                  two_pass, stream);
}

template <typename T, bool kTwoPass>
cudaError_t launch_cluster(const void* x, void* y, float* moments, const float* gamma,
                           const float* beta, const Map& xm, const Map& ym, int64_t n, int64_t m,
                           int64_t chunk, int chunks, float alpha, float eps, cudaStream_t stream) {
  if (chunks < 1 || chunks > kMaxCluster) return cudaErrorInvalidValue;
  const auto kernel = cluster_kernel<T, kTwoPass>;
  const int smem = static_cast<int>((chunk * sizeof(T) + 15) / 16 * 16);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && chunks > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, static_cast<unsigned>(n));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // clusters of 16 (a GPC's worth of SMs) ran faster placed for load
  // balance than spread (PERF.md, the K1 route table)
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      chunks > 8 ? cudaClusterSchedulingPolicyLoadBalancing : cudaClusterSchedulingPolicyDefault;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const int vec_ok = can_vectorize(x, y == nullptr ? x : y, m, chunk, xm, ym);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<T*>(y), moments,
                            gamma, beta, xm, ym, m, chunk, alpha, eps, vec_ok);
}

}  // namespace

extern "C" {

// Every entry takes `layout`: null, x and y contiguous; else eight int64,
// x's (sample, row, len, off) then y's, as norm_map.cuh's Map reads them
// (y's off >= 0: y is the interior of a padded buffer whose border the
// launch zeroes).

// The two-launch route. dtype: 0 = float32, 1 = bfloat16. psum/psq:
// (n, chunks) f32 scratch; moments: (2, n) f32 out (means, then stds). Each
// of the `chunks` blocks of a sample covers `chunk` elements (a multiple of
// 8) of its m = H*W*C. two_pass: the mean of squared deviations (a third
// launch between the two), else one pass. y null: the moments alone.
int lg_norm_lrelu(int dtype, const void* x, void* y, float* psum, float* psq, float* moments,
                  const float* gamma, const float* beta, int64_t n, int64_t m, int64_t chunk,
                  int chunks, int two_pass, float alpha, float eps, const int64_t* layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Map xm = make_map(layout, m), ym = make_map(layout ? layout + 4 : nullptr, m);
  if (dtype == 0)
    launch_two<float>(x, y, psum, psq, moments, gamma, beta, xm, ym, n, m, chunk, chunks, two_pass, alpha,
                      eps, s);
  else if (dtype == 1)
    launch_two<__nv_bfloat16>(x, y, psum, psq, moments, gamma, beta, xm, ym, n, m, chunk, chunks, two_pass,
                              alpha, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The cluster route, one launch: each sample one cluster of `chunks`
// (1..16) blocks, each holding `chunk` elements (a multiple of 8) in shared
// memory. two_pass: the mean of squared deviations, else one pass. moments
// and y null as in lg_norm_lrelu.
int lg_norm_lrelu_cluster(int dtype, const void* x, void* y, float* moments, const float* gamma,
                          const float* beta, int64_t n, int64_t m, int64_t chunk, int chunks,
                          int two_pass, float alpha, float eps, const int64_t* layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Map xm = make_map(layout, m), ym = make_map(layout ? layout + 4 : nullptr, m);
  cudaError_t e;
  if (dtype == 0)
    e = two_pass ? launch_cluster<float, true>(x, y, moments, gamma, beta, xm, ym, n, m, chunk, chunks, alpha,
                                               eps, s)
                 : launch_cluster<float, false>(x, y, moments, gamma, beta, xm, ym, n, m, chunk, chunks,
                                                alpha, eps, s);
  else if (dtype == 1)
    e = two_pass ? launch_cluster<__nv_bfloat16, true>(x, y, moments, gamma, beta, xm, ym, n, m, chunk,
                                                       chunks, alpha, eps, s)
                 : launch_cluster<__nv_bfloat16, false>(x, y, moments, gamma, beta, xm, ym, n, m, chunk,
                                                        chunks, alpha, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 alone, from per-sample sums s1 = sum(x), s2 = sum(x^2), shape (n,).
int lg_norm_lrelu_apply(int dtype, const void* x, void* y, const float* s1, const float* s2,
                        const float* gamma, const float* beta, int64_t n, int64_t m, int64_t chunk,
                        int chunks, float alpha, float eps, const int64_t* layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Map xm = make_map(layout, m), ym = make_map(layout ? layout + 4 : nullptr, m);
  if (dtype == 0)
    launch_apply<float>(x, y, s1, s2, 1, nullptr, gamma, beta, xm, ym, n, m, chunk, chunks, alpha, eps, 0, s);
  else if (dtype == 1)
    launch_apply<__nv_bfloat16>(x, y, s1, s2, 1, nullptr, gamma, beta, xm, ym, n, m, chunk, chunks, alpha,
                                eps, 0, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* lg_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
