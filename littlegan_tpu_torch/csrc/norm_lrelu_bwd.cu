// Fused instance norm + LeakyReLU backward for Hopper (sm_90a).
//
// Replaces the Pallas kernel littlegan_tpu/ops/pallas/norm_lrelu.py
// (_bwd_kernel / _bwd_pallas), the analytic VJP of the forward in
// norm_lrelu.cu. Per sample n of an NHWC tensor with M = H*W*C elements,
// from the forward's per-sample (mean, std), d = std + eps:
//
//     nrm = (x - mean)/d,  z = (x - mean)*gamma/d + beta
//     dz  = dy * (z >= 0 ? 1 : alpha),  dn = gamma*dz
//     dx  = (dn - mean(dn))/d - nrm * mean(dn*nrm)/max(std, 1e-20)
//     dgamma = sum(dz*nrm), dbeta = sum(dz)     (over the whole batch)
//
// What bounds it on the H100: bytes. A few operations per element, so the
// least time is reading x and dy once and writing dx once over 3.35 TB/s.
// The TPU kernel ran one sample per sequential grid step, held it in VMEM
// for both of its passes and carried dgamma and dbeta from step to step in
// SMEM. Here every sample needs two passes over x and dy (the sums of dz
// and dz*nrm first, then dx from them), and blocks run in no order. Two
// routes, picked per shape by the wrapper (bwd_plan in
// ops/cuda/norm_lrelu.py):
//
// cluster (cluster_kernel), for a batch whose x and dy outgrow L2 (the
// large train shapes): one thread block cluster per sample, of up to 16
// blocks, so that the second pass finds x and dy on the chip:
//   - each block copies the first `kept` elements of its chunk of x and dy
//     into shared memory with cp.async while it reads its sample's mean and
//     std from the (2, n) f32 moments the forward wrote (so they are the
//     forward's bit for bit, two-pass where the forward took two passes);
//   - each block sums dz and dz*nrm over its chunk, the kept part from
//     shared memory and the rest straight from device memory; after a
//     cluster barrier every block adds the cluster's block partials in rank
//     order through distributed shared memory, so all of them hold the
//     same sample sums;
//   - each block writes its chunk of dx with 16-byte stores, from shared
//     memory and, for the rest, from x and dy read again a few
//     microseconds after pass 1 read them, from L2. The wrapper picks
//     `kept` so that the rest of all blocks in flight fits L2: keeping less
//     puts more blocks in flight, keeping more spills less.
//   x and dy come from device memory once. A second launch (one warp) adds
//   the per-sample sums in a fixed order to dgamma and dbeta.
//
// two passes (sums_kernel, apply_kernel), for the rest (a batch whose x
// and dy fit L2 finds them there in pass 2), split into (sample x chunk)
// blocks:
//   pass 1 (sums_kernel): each block reads its sample's moments as above,
//       then writes the f32 partials sum(dz) and sum(dz*nrm) of its chunk;
//   pass 2 (apply_kernel): each block reduces its sample's partials of both
//       kinds in a fixed order, writes its chunk of dx with 16-byte stores,
//       and block (0, 0) also reduces all samples' partials, in a fixed
//       order, to dgamma and dbeta.
//   Pass 2 rereads x and dy. On a batch that outgrows L2 it would reread
//   them from device memory, 5/3 of the bound's bytes (2.1x the bound at
//   the largest train shapes): those take the cluster route.
//
// No float atomics on either route: every result is deterministic.
//
// The stats-in form (lg_norm_lrelu_from_stats_bwd) is the backward of
// lg_norm_lrelu_apply, whose mean and std come from per-sample sums s1, s2
// (the boundary conv's fused stats, one-pass) and not from x. It runs the
// same routes, reading s1 and s2 where the fused form reads the mean and
// std, writes dx = dn/d (the direct path) and, per sample, the cotangents
// of s1 and s2:
//
//     dstd = -sum(dn*nrm)/d,  dvar = var > 0 ? dstd/(2 std) : 0
//     ds1  = (-sum(dn)/d - 2*mean*dvar)/M,  ds2 = dvar/M
//
// Every tensor is addressed through a Map (norm_map.cuh): x and dy may be
// windows of larger maps (the decoder's x, the encoder's dy out of the next
// conv's gradient of the padded map) and dx may be written inside a border
// of zeros (the gradient of the decoder's transposed conv's full output),
// which the launch's blocks write too. A sample's elements keep their
// order, so the sums are those of a contiguous sample bit for bit.
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

// A sample's constants. The fused form reads the forward's (mean, std)
// from a = means, b = stds; the stats-in form (kFromStats) takes them from
// the sums a = s1, b = s2 as lg_norm_lrelu_apply does, with var for the
// clamp's cotangent.
struct Moments {
  float mean, var, std, d, inv;  // inv = gamma / d
};

template <bool kFromStats>
__device__ __forceinline__ Moments moments(const float* a, const float* b, int64_t n, float fm,
                                           float gamma, float eps) {
  Moments r;
  if (kFromStats) {
    r.mean = a[n] / fm;
    r.var = b[n] / fm - r.mean * r.mean;
    r.std = sqrtf(fmaxf(r.var, 0.f));
  } else {
    r.mean = a[n];
    r.std = b[n];
    r.var = r.std * r.std;
  }
  r.d = r.std + eps;
  r.inv = gamma / r.d;
  return r;
}

struct Chunk {
  int64_t begin, end;
};

__device__ __forceinline__ Chunk chunk_of(int64_t m, int64_t chunk) {
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t end = begin + chunk < m ? begin + chunk : m;
  return {begin, end};
}

// Per element: z's sign picks the LeakyReLU slope for dy; nrm as above.
struct Elem {
  float dz, nrm;
};

__device__ __forceinline__ Elem elem(float v, float g, float mean, float inv, float rd, float beta,
                                     float alpha) {
  const float z = (v - mean) * inv + beta;
  return {z >= 0.f ? g : alpha * g, (v - mean) * rd};
}

template <typename T, bool kFromStats>
__global__ void __launch_bounds__(kThreads)
    sums_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ fa,
                const float* __restrict__ fb, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ bsum, float* __restrict__ bsq,
                Map xm, Map gm, int64_t m, int64_t chunk, float alpha, float eps, int vec_ok) {
  const int64_t n = blockIdx.y;
  const Moments mo = moments<kFromStats>(fa, fb, n, static_cast<float>(m), gamma[0], eps);
  const float mean = mo.mean, inv = mo.inv, rd = 1.f / mo.d, b = beta[0];
  const Chunk c = chunk_of(m, chunk);
  float sdz = 0.f, sdzn = 0.f;
  if (vec_ok) {
    constexpr int V = vec_elems<T>();
    for (int64_t i = c.begin / V + threadIdx.x; i < c.end / V; i += kThreads) {
      const uint4 rx = __ldg(reinterpret_cast<const uint4*>(x + at(xm, n, i * V)));
      const uint4 rg = __ldg(reinterpret_cast<const uint4*>(dy + at(gm, n, i * V)));
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* eg = reinterpret_cast<const T*>(&rg);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const Elem e = elem(to_f32(ex[k]), to_f32(eg[k]), mean, inv, rd, b, alpha);
        sdz += e.dz;
        sdzn += e.dz * e.nrm;
      }
    }
  } else {
    for (int64_t i = c.begin + threadIdx.x; i < c.end; i += kThreads) {
      const Elem e = elem(to_f32(x[at(xm, n, i)]), to_f32(dy[at(gm, n, i)]), mean, inv, rd, b, alpha);
      sdz += e.dz;
      sdzn += e.dz * e.nrm;
    }
  }
  __shared__ float ws[kThreads / 32], wq[kThreads / 32];
  warp_sum2(sdz, sdzn);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = sdz;
    wq[warp] = sdzn;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tq = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      ts += ws[w];
      tq += wq[w];
    }
    bsum[n * gridDim.x + blockIdx.x] = ts;
    bsq[n * gridDim.x + blockIdx.x] = tq;
  }
}

// kFromStats = false: dx of the fused op. true: dx = dn/d and ds1/ds2.
// om with a border: the sample's blocks also write its zeros.
template <typename T, bool kFromStats>
__global__ void __launch_bounds__(kThreads)
    apply_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                 const float* __restrict__ fa, const float* __restrict__ fb,
                 const float* __restrict__ bsum, const float* __restrict__ bsq,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 float* __restrict__ dgamma, float* __restrict__ dbeta, float* __restrict__ ds1,
                 float* __restrict__ ds2, Map xm, Map gm, Map om, int64_t nsamples, int64_t m,
                 int64_t chunk, float alpha, float eps, int vec_ok) {
  const int64_t n = blockIdx.y;
  const int chunks = gridDim.x;
  const float g = gamma[0];
  const float fm = static_cast<float>(m);
  __shared__ float stat[5];  // mean, gamma/d, 1/d, mean(dn), mean(dn*nrm)/max(std, 1e-20)
  if (threadIdx.x < 32) {
    // this sample's partials of sum(dz), sum(dz*nrm): lane-strided sums,
    // then a shuffle tree, the same in every block of the sample
    float sdz = 0.f, sdzn = 0.f;
    for (int p = threadIdx.x; p < chunks; p += 32) {
      sdz += bsum[n * chunks + p];
      sdzn += bsq[n * chunks + p];
    }
    warp_sum2(sdz, sdzn);
    if (threadIdx.x == 0) {
      const Moments mo = moments<kFromStats>(fa, fb, n, fm, g, eps);
      stat[0] = mo.mean;
      stat[1] = mo.inv;
      stat[2] = 1.f / mo.d;
      stat[3] = g * sdz / fm;
      stat[4] = g * sdzn / fm / fmaxf(mo.std, 1e-20f);
      if (kFromStats && blockIdx.x == 0) {
        const float dstd = -g * sdzn / mo.d;
        const float dvar = mo.var > 0.f ? dstd * 0.5f / mo.std : 0.f;
        ds1[n] = (-g * sdz / mo.d - 2.f * mo.mean * dvar) / fm;
        ds2[n] = dvar / fm;
      }
    }
  }
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x >= 32 && threadIdx.x < 64) {
    // warp 1 of block (0, 0): the batch totals, in a fixed order
    float s = 0.f, q = 0.f;
    const int total = static_cast<int>(nsamples) * chunks;
    for (int p = threadIdx.x - 32; p < total; p += 32) {
      s += bsum[p];
      q += bsq[p];
    }
    warp_sum2(s, q);
    if (threadIdx.x == 32) {
      dbeta[0] = s;
      dgamma[0] = q;
    }
  }
  zero_border(dx, om, n, m, vec_ok, blockIdx.x, chunks);
  __syncthreads();
  const float mean = stat[0], inv = stat[1], rd = stat[2], mdn = stat[3], cn = stat[4];
  const float b = beta[0];
  const Chunk c = chunk_of(m, chunk);
  auto grad = [&](float v, float gv) -> float {
    const Elem e = elem(v, gv, mean, inv, rd, b, alpha);
    const float dn = g * e.dz;
    return kFromStats ? dn * rd : (dn - mdn) * rd - e.nrm * cn;
  };
  if (vec_ok) {
    constexpr int V = vec_elems<T>();
    for (int64_t i = c.begin / V + threadIdx.x; i < c.end / V; i += kThreads) {
      const uint4 rx = __ldg(reinterpret_cast<const uint4*>(x + at(xm, n, i * V)));
      const uint4 rg = __ldg(reinterpret_cast<const uint4*>(dy + at(gm, n, i * V)));
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* eg = reinterpret_cast<const T*>(&rg);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = from_f32<T>(grad(to_f32(ex[k]), to_f32(eg[k])));
      *reinterpret_cast<uint4*>(dx + at(om, n, i * V)) = out;
    }
  } else {
    for (int64_t i = c.begin + threadIdx.x; i < c.end; i += kThreads)
      dx[at(om, n, i)] = from_f32<T>(grad(to_f32(x[at(xm, n, i)]), to_f32(dy[at(gm, n, i)])));
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The cluster route: grid (chunks, n) in clusters of `chunks` blocks, one
// cluster per sample. Block `rank` owns elements [rank*chunk, +chunk) of
// its sample; it copies the first `kept` of them (x and dy) into shared
// memory and reads the rest from device memory in pass 1 and again, from
// L2, in pass 2. x, dy, dx 16-byte aligned; m, chunk, kept and the maps
// in whole vectors. ssum/ssq: (n,) the per-sample sum(dz), sum(dz*nrm).
// om with a border: the cluster's blocks also write the sample's zeros.
template <typename T, bool kFromStats>
__global__ void __launch_bounds__(kThreads)
    cluster_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                   const float* __restrict__ fa, const float* __restrict__ fb,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   float* __restrict__ ssum, float* __restrict__ ssq, float* __restrict__ ds1,
                   float* __restrict__ ds2, Map xm, Map gm, Map om, int64_t m, int64_t chunk,
                   int64_t kept, float alpha, float eps) {
  constexpr int V = vec_elems<T>();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int64_t n = blockIdx.y;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [kept] of x, then [kept] of dy
  T* gs = xs + kept;
  __shared__ float stat[7];  // mean, gamma/d, 1/d, std, var, d, mean(dn)
  __shared__ float cn_s;     // mean(dn*nrm)/max(std, 1e-20)
  __shared__ float part[2];  // this block's sum(dz), sum(dz*nrm), read by the cluster
  __shared__ float ws[kThreads / 32], wq[kThreads / 32];

  const int64_t begin = rank * chunk;
  const int64_t end = begin + chunk < m ? begin + chunk : m;
  const int nvec = begin < end ? static_cast<int>((end - begin) / V) : 0;
  const int kvec = nvec < kept / V ? nvec : static_cast<int>(kept / V);
  // vector i of this block's share of x and of dy
  auto xg = [&](int i) { return reinterpret_cast<const uint4*>(x + at(xm, n, begin + i * V)); };
  auto gg = [&](int i) { return reinterpret_cast<const uint4*>(dy + at(gm, n, begin + i * V)); };
  for (int i = threadIdx.x; i < kvec; i += kThreads) {
    cp_async16(xs + i * V, xg(i));
    cp_async16(gs + i * V, gg(i));
  }
  zero_border(dx, om, n, m, 1, rank, ranks);
  const float g = gamma[0], b = beta[0], fm = static_cast<float>(m);
  if (threadIdx.x == 0) {
    const Moments mo = moments<kFromStats>(fa, fb, n, fm, g, eps);
    stat[0] = mo.mean;
    stat[1] = mo.inv;
    stat[2] = 1.f / mo.d;
    stat[3] = mo.std;
    stat[4] = mo.var;
    stat[5] = mo.d;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const float mean = stat[0], inv = stat[1], rd = stat[2];
  float sdz = 0.f, sdzn = 0.f;
  auto sums = [&](const uint4 rx, const uint4 rg) {  // by value: one 16-byte load each
    const T* ex = reinterpret_cast<const T*>(&rx);
    const T* eg = reinterpret_cast<const T*>(&rg);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const Elem el = elem(to_f32(ex[e]), to_f32(eg[e]), mean, inv, rd, b, alpha);
      sdz += el.dz;
      sdzn += el.dz * el.nrm;
    }
  };
  // pass 1: the kept part from shared memory, the rest from device memory
  for (int i = threadIdx.x; i < kvec; i += kThreads)
    sums(*reinterpret_cast<const uint4*>(xs + i * V), *reinterpret_cast<const uint4*>(gs + i * V));
  for (int i = kvec + threadIdx.x; i < nvec; i += kThreads) sums(__ldg(xg(i)), __ldg(gg(i)));
  warp_sum2(sdz, sdzn);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    ws[warp] = sdz;
    wq[warp] = sdzn;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tq = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      ts += ws[w];
      tq += wq[w];
    }
    part[0] = ts;
    part[1] = tq;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    // the sample's sums: the cluster's block partials in rank order, the
    // same in every block
    float s = 0.f, q = 0.f;
    for (int r = 0; r < ranks; ++r) {
      const float* p = cluster.map_shared_rank(part, r);
      s += p[0];
      q += p[1];
    }
    stat[6] = g * s / fm;
    cn_s = g * q / fm / fmaxf(stat[3], 1e-20f);
    if (rank == 0) {
      ssum[n] = s;
      ssq[n] = q;
      if (kFromStats) {
        const float d = stat[5], sd = stat[3], var = stat[4];
        const float dstd = -g * q / d;
        const float dvar = var > 0.f ? dstd * 0.5f / sd : 0.f;
        ds1[n] = (-g * s / d - 2.f * stat[0] * dvar) / fm;
        ds2[n] = dvar / fm;
      }
    }
  }
  cluster.sync();  // the sums are in; no block reads another's partials after this
  const float mdn = stat[6], cn = cn_s;
  auto og = [&](int i) { return reinterpret_cast<uint4*>(dx + at(om, n, begin + i * V)); };
  auto grad = [&](const uint4 rx, const uint4 rg) -> uint4 {
    const T* ex = reinterpret_cast<const T*>(&rx);
    const T* eg = reinterpret_cast<const T*>(&rg);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const Elem el = elem(to_f32(ex[e]), to_f32(eg[e]), mean, inv, rd, b, alpha);
      const float dn = g * el.dz;
      o[e] = from_f32<T>(kFromStats ? dn * rd : (dn - mdn) * rd - el.nrm * cn);
    }
    return out;
  };
  // pass 2: dx, the kept part from shared memory, the rest again from L2
  for (int i = threadIdx.x; i < kvec; i += kThreads)
    *og(i) = grad(*reinterpret_cast<const uint4*>(xs + i * V), *reinterpret_cast<const uint4*>(gs + i * V));
  for (int i = kvec + threadIdx.x; i < nvec; i += kThreads) *og(i) = grad(__ldg(xg(i)), __ldg(gg(i)));
}

// dgamma, dbeta: the per-sample sums in a fixed order (one warp).
__global__ void totals_kernel(const float* __restrict__ ssum, const float* __restrict__ ssq,
                              int64_t n, float* __restrict__ dgamma, float* __restrict__ dbeta) {
  float s = 0.f, q = 0.f;
  for (int64_t p = threadIdx.x; p < n; p += 32) {
    s += ssum[p];
    q += ssq[p];
  }
  warp_sum2(s, q);
  if (threadIdx.x == 0) {
    dbeta[0] = s;
    dgamma[0] = q;
  }
}

template <typename T, bool kFromStats>
cudaError_t launch_cluster(const void* x, const void* dy, void* dx, const float* fa,
                           const float* fb, float* ssum, float* ssq,
                           const float* gamma, const float* beta, float* dgamma, float* dbeta,
                           float* ds1, float* ds2, const Map (&maps)[3], int64_t n, int64_t m,
                           int64_t chunk, int chunks, int64_t kept, float alpha, float eps,
                           cudaStream_t stream) {
  const auto kernel = cluster_kernel<T, kFromStats>;
  const int smem = static_cast<int>(2 * kept * sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && chunks > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, static_cast<unsigned>(n));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = chunks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(dy),
                         static_cast<T*>(dx), fa, fb, gamma, beta, ssum, ssq, ds1, ds2, maps[0], maps[1],
                         maps[2], m, chunk, kept, alpha, eps);
  if (e != cudaSuccess) return e;
  totals_kernel<<<1, 32, 0, stream>>>(ssum, ssq, n, dgamma, dbeta);
  return cudaGetLastError();
}

int can_vectorize(const void* a, const void* b, const void* c, int64_t m, int64_t chunk,
                  const Map (&maps)[3]) {
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return al(a) && al(b) && al(c) && (m % 8 == 0) && (chunk % 8 == 0) && map_vec(maps[0]) &&
         map_vec(maps[1]) && map_vec(maps[2]);
}

template <typename T, bool kFromStats>
cudaError_t launch_two_pass(const void* x, const void* dy, void* dx, const float* fa,
                            const float* fb, float* bsum, float* bsq,
                            const float* gamma, const float* beta, float* dgamma, float* dbeta,
                            float* ds1, float* ds2, const Map (&maps)[3], int64_t n, int64_t m,
                            int64_t chunk, int chunks, float alpha, float eps, cudaStream_t stream) {
  const dim3 grid(chunks, static_cast<unsigned>(n));
  const int vec_ok = can_vectorize(x, dy, dx, m, chunk, maps);
  sums_kernel<T, kFromStats><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), fa, fb, gamma, beta, bsum, bsq, maps[0], maps[1],
      m, chunk, alpha, eps, vec_ok);
  apply_kernel<T, kFromStats><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx), fa, fb,
      bsum, bsq, gamma, beta, dgamma, dbeta, ds1, ds2, maps[0], maps[1], maps[2], n, m, chunk, alpha, eps,
      vec_ok);
  return cudaGetLastError();
}

// kept > 0: the cluster route (chunks <= 16 blocks per sample, each
// keeping `kept` elements of x and of dy in shared memory); else the
// two-pass route. layout: null, or x's, dy's and dx's maps (twelve int64).
template <typename T, bool kFromStats>
cudaError_t launch(const void* x, const void* dy, void* dx, const float* fa, const float* fb,
                   float* bsum, float* bsq, const float* gamma, const float* beta,
                   float* dgamma, float* dbeta, float* ds1, float* ds2, int64_t n, int64_t m,
                   int64_t chunk, int chunks, int64_t kept, float alpha, float eps,
                   const int64_t* layout, cudaStream_t stream) {
  const Map maps[3] = {make_map(layout, m), make_map(layout ? layout + 4 : nullptr, m),
                       make_map(layout ? layout + 8 : nullptr, m)};
  if (kept > 0) {
    if (!can_vectorize(x, dy, dx, m, chunk, maps) || kept % 8 || chunks > 16) return cudaErrorInvalidValue;
    return launch_cluster<T, kFromStats>(x, dy, dx, fa, fb, bsum, bsq, gamma, beta,
                                         dgamma, dbeta, ds1, ds2, maps, n, m, chunk, chunks, kept, alpha,
                                         eps, stream);
  }
  return launch_two_pass<T, kFromStats>(x, dy, dx, fa, fb, bsum, bsq, gamma, beta,
                                        dgamma, dbeta, ds1, ds2, maps, n, m, chunk, chunks, alpha, eps,
                                        stream);
}

}  // namespace

extern "C" {

// Backward of lg_norm_lrelu / lg_norm_lrelu_cluster. dtype: 0 = float32,
// 1 = bfloat16 (x, dy, dx). mean/std: the forward's per-sample moments, (n,)
// f32 each (the rows of its (2, n) output); bsum/bsq: (n, chunks) f32
// scratch; dgamma/dbeta: one f32 each. Each sample in `chunks` blocks of
// `chunk` elements (a multiple of 8). kept > 0: the cluster route, those
// blocks one cluster (chunks <= 16), each keeping `kept` elements of x and
// of dy in shared memory; kept = 0: the two-pass route. layout: null, x,
// dy and dx contiguous; else twelve int64, x's, dy's and dx's (sample, row,
// len, off) as norm_map.cuh's Map reads them (dx's off >= 0: dx is the
// interior of a padded buffer whose border the launch zeroes).
int lg_norm_lrelu_bwd(int dtype, const void* x, const void* dy, void* dx, const float* mean,
                      const float* std, float* bsum, float* bsq, const float* gamma,
                      const float* beta, float* dgamma, float* dbeta, int64_t n, int64_t m,
                      int64_t chunk, int chunks, int64_t kept, float alpha, float eps,
                      const int64_t* layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float, false>(x, dy, dx, mean, std, bsum, bsq, gamma,
                                                 beta, dgamma, dbeta, nullptr, nullptr, n, m, chunk,
                                                 chunks, kept, alpha, eps, layout, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16, false>(x, dy, dx, mean, std, bsum, bsq,
                                                         gamma, beta, dgamma, dbeta, nullptr,
                                                         nullptr, n, m, chunk, chunks, kept, alpha,
                                                         eps, layout, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward of lg_norm_lrelu_apply: y the forward's input, dout its output's
// cotangent; writes dy (direct path), ds1/ds2 (n,) f32, dgamma, dbeta.
// Routes, chunks and layout (y's, dout's, dy's maps) as in lg_norm_lrelu_bwd.
int lg_norm_lrelu_from_stats_bwd(int dtype, const void* y, const void* dout, void* dy,
                                 const float* s1, const float* s2, float* bsum, float* bsq,
                                 const float* gamma, const float* beta, float* dgamma,
                                 float* dbeta, float* ds1, float* ds2, int64_t n, int64_t m,
                                 int64_t chunk, int chunks, int64_t kept, float alpha, float eps,
                                 const int64_t* layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float, true>(y, dout, dy, s1, s2, bsum, bsq, gamma, beta,
                                                dgamma, dbeta, ds1, ds2, n, m, chunk, chunks, kept,
                                                alpha, eps, layout, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16, true>(y, dout, dy, s1, s2, bsum, bsq, gamma,
                                                        beta, dgamma, dbeta, ds1, ds2, n, m, chunk,
                                                        chunks, kept, alpha, eps, layout, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
