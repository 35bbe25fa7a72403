// Per-(sample, channel) instance norm + LeakyReLU over NHWC maps, forward
// and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no StarGAN v2. It is added so
// that StarGAN v2's norms (models/stargan_v2.py: IN in every ResBlk and in
// to_rgb, AdaIN in every AdainResBlk, each followed by a LeakyReLU) read
// and write channels-last activations. PyTorch's batch_norm over the
// (1, B*C, H, W) view, which ran them before, exists only for NCHW memory,
// and an NCHW model made cuDNN transpose every bf16 convolution's input to
// NHWC and its output back. Per sample b and channel c of an NHWC tensor of
// P = H*W pixels, statistics in f32:
//
//     mean = sum_p x / P,   var = sum_p (x - mean)^2 / P      (biased)
//     a = (offset + scale[b,c]) * rsqrt(var + eps)
//     z = (x - mean) * a + shift[b,c]
//     y = z > 0 ? z : alpha * z                               (x's type)
//
// scale and shift are f32 with a batch stride (0: IN's (C,) weight shared
// by the samples; AdaIN's rows of its linear, with offset 1 for 1 + gamma).
// The backward, from dy and the forward's (mean, rstd) per (b, c):
//
//     dz = z > 0 ? dy : alpha * dy,   n = (x - mean) * rstd
//     dshift = sum_p dz,   dscale = rstd * sum_p dz * (x - mean)
//     dx = a * (dz - dshift / P) - (x - mean) * a * rstd * dscale / P
//        = a * (dz - dshift / P - n * dscale / P)
//
// What bounds it on the H100: bytes. A few operations per element, so the
// least time is a read of x and a write of y forward, and reads of x and dy
// and a write of dx backward, at 3.35 TB/s. StarGAN v2 at AFHQ 256², batch
// 8, runs 25 of these per generator pass over 214 M elements, 8 forward and
// 4 backward passes an iteration: about 12 GB, 3.6 ms.
//
// Design. A block owns a tile of 64 channels of one sample and a range of
// its pixels: 256 threads, each holding one 16-byte vector of channels (8
// bf16, 4 f32) of a pixel, so a pixel's 64 channels are one 128-byte line
// (bf16) read by neighbouring threads, and the block reads 32 (bf16) or 16
// (f32) pixels at a time. Unaligned tensors or channel counts that are not
// a multiple of the vector take the same steps one element a thread. The
// largest maps (256² at 64 channels, 67 MB in bf16) outgrow the 50 MB L2,
// so the reduction over H*W is split over blocks and takes two launches:
//   1. (stats) each block reduces its pixels to per-channel partial sums
//      and writes them to a (2, B, splits, C) f32 buffer;
//   2. (apply) each block adds its tile's partials over the splits in one
//      fixed order, its 256 threads a quarter of them each (every block of
//      a sample and tile gets the same moments bit for bit, and a graph
//      replay the eager run's), then normalises, applies the affine and the
//      LeakyReLU, and writes its pixels.
// The apply launch walks the blocks in the reverse order of the first, so
// that its first blocks reread the x the last blocks of the first launch
// left in L2. Below L2's size (every other map of the model) the reread
// comes from L2. The backward has the same two launches: sums of dz and
// dz * n, then dx; its second launch also writes dscale and dshift.
//
// The moments: sums of x - K, K = x[b, pixel 0, c], which every block of
// the sample reads; var = S2/P - (S1/P)^2 of these shifted sums, so a mean
// far from 0 (100 times the spread) does not cancel the variance away.
//
// C interface for ctypes: pointers and the stream are void*, every function
// returns cudaGetLastError() as an int. Every kernel's name holds
// "instance_norm".

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // channels of a block
constexpr int kMinBlocks = 4;  // resident blocks an SM: at most 64 registers a thread

#include "vec_io.cuh"

// V channels of one pixel, loaded and stored as one vector.
template <typename T, int V>
struct Pack {
  Raw<T, V> raw;
  __device__ __forceinline__ float operator[](int k) const { return to_f32(reinterpret_cast<const T*>(&raw)[k]); }
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return {*reinterpret_cast<const Raw<T, V>*>(p)};
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  Raw<T, V> raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = from_f32<T>(f[k]);
  *reinterpret_cast<Raw<T, V>*>(p) = raw;
}

// Where a block works: sample b, channels [c0, c0 + kTile), pixels
// [p0, p1); the thread's channels c .. c + V - 1 (none if c >= C) of the
// pixels p0 + row, p0 + row + kRows, ...
template <int V>
struct Place {
  static constexpr int kLanes = kTile / V;  // threads across a pixel's tile
  static constexpr int kRows = kThreads / kLanes;  // pixels a block reads at a time
  int64_t b, p0, p1;
  int c0, c, row, split;

  // reverse: number the blocks from the grid's end (the second launches)
  __device__ Place(int64_t p, int64_t chunk, bool reverse) {
    const int64_t gx = gridDim.x, gy = gridDim.y;
    int64_t lin = blockIdx.x + gx * (blockIdx.y + gy * blockIdx.z);
    if (reverse) lin = gx * gy * gridDim.z - 1 - lin;
    split = static_cast<int>(lin % gx);
    lin /= gx;
    c0 = static_cast<int>(lin % gy) * kTile;
    b = lin / gy;
    p0 = split * chunk;
    p1 = p0 + chunk < p ? p0 + chunk : p;
    row = threadIdx.x / kLanes;
    c = c0 + (threadIdx.x % kLanes) * V;
  }
};

// Per-thread sums of V channels into the block's per-channel sums, written
// as partial `split` of (2, B, splits, C): red holds kRows rows of the tile,
// added in row order.
template <int V>
__device__ __forceinline__ void write_partials(const Place<V>& pl, const float (&s1)[V], const float (&s2)[V],
                                               float* __restrict__ part, int64_t n, int splits, int C) {
  constexpr int kRows = Place<V>::kRows;
  __shared__ float red[2][kRows][kTile];
  const int lane = pl.c - pl.c0;
  if (pl.row < kRows) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[0][pl.row][lane + v] = s1[v];
      red[1][pl.row][lane + v] = s2[v];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kTile) {
    const int which = threadIdx.x / kTile, ch = threadIdx.x % kTile;
    if (pl.c0 + ch < C) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += red[which][r][ch];
      part[((which * n + pl.b) * splits + pl.split) * C + pl.c0 + ch] = s;
    }
  }
}

// The tile's two sums per channel over the splits, in one fixed order:
// each of kThreads / kTile groups of threads adds every kGroups-th split,
// then thread t < kTile adds the groups' sums of channel c0 + t, in group
// order, into s1 and s2. Every thread of the block calls it.
__device__ __forceinline__ void tile_totals(const float* __restrict__ part, int64_t n, int64_t b, int splits,
                                            int C, int c0, float& s1, float& s2) {
  constexpr int kGroups = kThreads / kTile;
  __shared__ float acc[2][kGroups][kTile];
  const int ch = threadIdx.x % kTile, g = threadIdx.x / kTile;
  float a1 = 0.f, a2 = 0.f;
  if (c0 + ch < C) {
#pragma unroll 4
    for (int s = g; s < splits; s += kGroups) {
      a1 += part[(b * splits + s) * C + c0 + ch];
      a2 += part[((n + b) * splits + s) * C + c0 + ch];
    }
  }
  acc[0][g][ch] = a1;
  acc[1][g][ch] = a2;
  __syncthreads();
  s1 = 0.f;
  s2 = 0.f;
  if (threadIdx.x < kTile) {
    for (int k = 0; k < kGroups; ++k) {
      s1 += acc[0][k][threadIdx.x];
      s2 += acc[1][k][threadIdx.x];
    }
  }
}

// Launch 1 of the forward: partial sums of x - K and (x - K)^2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    channel_instance_norm_lrelu_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int64_t p,
                                             int C, int64_t chunk) {
  const Place<V> pl(p, chunk, false);
  constexpr int kRows = Place<V>::kRows;
  float s1[V] = {}, s2[V] = {};
  if (pl.c < C && pl.row < kRows) {
    const T* xb = x + pl.b * p * C + pl.c;
    const Pack<T, V> k = load<T, V>(xb);
    float kf[V];
#pragma unroll
    for (int v = 0; v < V; ++v) kf[v] = k[v];
    auto add = [&](const Pack<T, V>& q) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = q[v] - kf[v];
        s1[v] += d;
        s2[v] += d * d;
      }
    };
    int64_t i = pl.p0 + pl.row;
    for (; i + 3 * kRows < pl.p1; i += 4 * kRows) {  // four loads in flight
      Pack<T, V> q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] = load<T, V>(xb + (i + u * kRows) * C);
#pragma unroll
      for (int u = 0; u < 4; ++u) add(q[u]);
    }
    for (; i < pl.p1; i += kRows) add(load<T, V>(xb + i * C));
  }
  write_partials<V>(pl, s1, s2, part, gridDim.z, gridDim.x, C);
}

// Launch 2 of the forward: the moments from the partials, then y. The
// blocks of split 0 write the (B, C) mean and rstd the backward reads.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    channel_instance_norm_lrelu_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                                           const float* __restrict__ part, const float* __restrict__ scale,
                                           const float* __restrict__ shift, int64_t sb, float offset,
                                           float* __restrict__ mean_out, float* __restrict__ rstd_out,
                                           int64_t p, int C, int64_t chunk, float alpha, float eps) {
  const Place<V> pl(p, chunk, true);
  constexpr int kRows = Place<V>::kRows;
  const int64_t n = gridDim.z;
  __shared__ float coef[3][kTile];  // mean, a, shift
  float s1, s2;
  tile_totals(part, n, pl.b, gridDim.x, C, pl.c0, s1, s2);
  if (threadIdx.x < kTile && pl.c0 + static_cast<int>(threadIdx.x) < C) {
    const int c = pl.c0 + threadIdx.x;
    const float inv = 1.f / static_cast<float>(p);
    const float d = s1 * inv;
    const float rstd = rsqrtf(fmaxf(s2 * inv - d * d, 0.f) + eps);
    const float mean = to_f32(x[pl.b * p * C + c]) + d;
    coef[0][threadIdx.x] = mean;
    coef[1][threadIdx.x] = (offset + scale[pl.b * sb + c]) * rstd;
    coef[2][threadIdx.x] = shift[pl.b * sb + c];
    if (pl.split == 0) {
      mean_out[pl.b * C + c] = mean;
      rstd_out[pl.b * C + c] = rstd;
    }
  }
  __syncthreads();
  if (pl.c >= C || pl.row >= kRows) return;
  const int lane = pl.c - pl.c0;
  float m[V], a[V], h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m[v] = coef[0][lane + v];
    a[v] = coef[1][lane + v];
    h[v] = coef[2][lane + v];
  }
  const int64_t base = pl.b * p * C + pl.c;
  auto apply = [&](const Pack<T, V>& q, int64_t i) {
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float z = (q[v] - m[v]) * a[v] + h[v];
      o[v] = z > 0.f ? z : alpha * z;
    }
    store<T, V>(y + base + i * C, o);
  };
  int64_t i = pl.p0 + pl.row;
  for (; i + 3 * kRows < pl.p1; i += 4 * kRows) {
    Pack<T, V> q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = load<T, V>(x + base + (i + u * kRows) * C);
#pragma unroll
    for (int u = 0; u < 4; ++u) apply(q[u], i + u * kRows);
  }
  for (; i < pl.p1; i += kRows) apply(load<T, V>(x + base + i * C), i);
}

// Launch 1 of the backward: partial sums of dz and dz * (x - mean) (the
// second launch multiplies the latter by rstd: sum_p dz * n).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    channel_instance_norm_lrelu_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                                 float* __restrict__ part, const float* __restrict__ mean,
                                                 const float* __restrict__ rstd, const float* __restrict__ scale,
                                                 const float* __restrict__ shift, int64_t sb, float offset,
                                                 int64_t p, int C, int64_t chunk, float alpha) {
  const Place<V> pl(p, chunk, false);
  constexpr int kRows = Place<V>::kRows;
  float s1[V] = {}, s2[V] = {};
  if (pl.c < C && pl.row < kRows) {
    float m[V], a[V], h[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int64_t bc = pl.b * C + pl.c + v;
      m[v] = mean[bc];
      a[v] = (offset + scale[pl.b * sb + pl.c + v]) * rstd[bc];
      h[v] = shift[pl.b * sb + pl.c + v];
    }
    const int64_t base = pl.b * p * C + pl.c;
    auto add = [&](const Pack<T, V>& q, const Pack<T, V>& g) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = q[v] - m[v];
        const float z = d * a[v] + h[v];
        const float dz = z > 0.f ? g[v] : alpha * g[v];
        s1[v] += dz;
        s2[v] += dz * d;
      }
    };
    int64_t i = pl.p0 + pl.row;
    for (; i + kRows < pl.p1; i += 2 * kRows) {  // four loads in flight
      Pack<T, V> q[2], g[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        q[u] = load<T, V>(x + base + (i + u * kRows) * C);
        g[u] = load<T, V>(dy + base + (i + u * kRows) * C);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) add(q[u], g[u]);
    }
    for (; i < pl.p1; i += kRows) add(load<T, V>(x + base + i * C), load<T, V>(dy + base + i * C));
  }
  write_partials<V>(pl, s1, s2, part, gridDim.z, gridDim.x, C);
}

// Launch 2 of the backward: dshift and dscale from the partials, then dx.
// The blocks of split 0 write the (B, C) dscale and dshift.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    channel_instance_norm_lrelu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                                           const float* __restrict__ part, const float* __restrict__ mean,
                                           const float* __restrict__ rstd, const float* __restrict__ scale,
                                           const float* __restrict__ shift, int64_t sb, float offset,
                                           float* __restrict__ dscale, float* __restrict__ dshift, int64_t p,
                                           int C, int64_t chunk, float alpha) {
  const Place<V> pl(p, chunk, true);
  constexpr int kRows = Place<V>::kRows;
  const int64_t n = gridDim.z;
  // mean, a, shift, dshift / P, a * rstd * dscale / P: dx = a (dz - dshift / P) - (x - mean) * the last
  __shared__ float coef[5][kTile];
  float s1, s2;
  tile_totals(part, n, pl.b, gridDim.x, C, pl.c0, s1, s2);
  if (threadIdx.x < kTile && pl.c0 + static_cast<int>(threadIdx.x) < C) {
    const int c = pl.c0 + threadIdx.x;
    const int64_t bc = pl.b * C + c;
    const float inv = 1.f / static_cast<float>(p);
    const float r = rstd[bc], a = (offset + scale[pl.b * sb + c]) * r, ds = s2 * r;
    coef[0][threadIdx.x] = mean[bc];
    coef[1][threadIdx.x] = a;
    coef[2][threadIdx.x] = shift[pl.b * sb + c];
    coef[3][threadIdx.x] = s1 * inv;
    coef[4][threadIdx.x] = a * r * (ds * inv);
    if (pl.split == 0) {
      dshift[bc] = s1;
      dscale[bc] = ds;
    }
  }
  __syncthreads();
  if (pl.c >= C || pl.row >= kRows) return;
  const int lane = pl.c - pl.c0;
  float m[V], a[V], h[V], mg[V], q2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m[v] = coef[0][lane + v];
    a[v] = coef[1][lane + v];
    h[v] = coef[2][lane + v];
    mg[v] = coef[3][lane + v];
    q2[v] = coef[4][lane + v];
  }
  const int64_t base = pl.b * p * C + pl.c;
  auto apply = [&](const Pack<T, V>& q, const Pack<T, V>& g, int64_t i) {
    float o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = q[v] - m[v];
      const float z = d * a[v] + h[v];
      const float dz = z > 0.f ? g[v] : alpha * g[v];
      o[v] = a[v] * (dz - mg[v]) - d * q2[v];
    }
    store<T, V>(dx + base + i * C, o);
  };
  int64_t i = pl.p0 + pl.row;
  for (; i + kRows < pl.p1; i += 2 * kRows) {
    Pack<T, V> q[2], g[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      q[u] = load<T, V>(x + base + (i + u * kRows) * C);
      g[u] = load<T, V>(dy + base + (i + u * kRows) * C);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) apply(q[u], g[u], i + u * kRows);
  }
  for (; i < pl.p1; i += kRows) apply(load<T, V>(x + base + i * C), load<T, V>(dy + base + i * C), i);
}

dim3 grid_of(int64_t n, int C, int splits) { return dim3(splits, (C + kTile - 1) / kTile, static_cast<unsigned>(n)); }

template <typename T, int V>
void fwd(const void* x, void* y, float* part, const float* scale, const float* shift, int64_t sb, float offset,
         float* mean, float* rstd, int64_t n, int64_t p, int C, int splits, int64_t chunk, float alpha, float eps,
         cudaStream_t s) {
  const dim3 grid = grid_of(n, C, splits);
  channel_instance_norm_lrelu_stats_kernel<T, V><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), part, p, C,
                                                                           chunk);
  channel_instance_norm_lrelu_fwd_kernel<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), part, scale, shift, sb, offset, mean, rstd, p, C, chunk, alpha,
      eps);
}

template <typename T, int V>
void bwd(const void* x, const void* dy, void* dx, float* part, const float* mean, const float* rstd,
         const float* scale, const float* shift, int64_t sb, float offset, float* dscale, float* dshift, int64_t n,
         int64_t p, int C, int splits, int64_t chunk, float alpha, cudaStream_t s) {
  const dim3 grid = grid_of(n, C, splits);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  channel_instance_norm_lrelu_bwd_stats_kernel<T, V><<<grid, kThreads, 0, s>>>(xt, gt, part, mean, rstd, scale,
                                                                               shift, sb, offset, p, C, chunk, alpha);
  channel_instance_norm_lrelu_bwd_kernel<T, V><<<grid, kThreads, 0, s>>>(
      xt, gt, static_cast<T*>(dx), part, mean, rstd, scale, shift, sb, offset, dscale, dshift, p, C, chunk, alpha);
}

}  // namespace

extern "C" {

// Forward over an NHWC x of n samples, p pixels and C channels; dtype 0
// float32, 1 bfloat16; vec 1 for 16-byte vectors (x and y 16-byte aligned,
// C a multiple of the vector), else one element a thread. scale and shift:
// f32, unit channel stride, batch stride sb. part: (2, n, splits, C) f32
// scratch; mean and rstd: (n, C) f32 outputs. Pixels [s * chunk, +chunk)
// go to split s.
int lg_channel_norm_lrelu(int dtype, int vec, const void* x, void* y, float* part, const float* scale,
                          const float* shift, int64_t sb, float offset, float* mean, float* rstd, int64_t n,
                          int64_t p, int C, int splits, int64_t chunk, float alpha, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec)
    fwd<float, 4>(x, y, part, scale, shift, sb, offset, mean, rstd, n, p, C, splits, chunk, alpha, eps, s);
  else if (dtype == 0)
    fwd<float, 1>(x, y, part, scale, shift, sb, offset, mean, rstd, n, p, C, splits, chunk, alpha, eps, s);
  else if (dtype == 1 && vec)
    fwd<__nv_bfloat16, 8>(x, y, part, scale, shift, sb, offset, mean, rstd, n, p, C, splits, chunk, alpha, eps, s);
  else if (dtype == 1)
    fwd<__nv_bfloat16, 1>(x, y, part, scale, shift, sb, offset, mean, rstd, n, p, C, splits, chunk, alpha, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dx in x's type, dscale and dshift (n, C) f32, from the
// forward's mean and rstd; arguments as lg_channel_norm_lrelu's.
int lg_channel_norm_lrelu_bwd(int dtype, int vec, const void* x, const void* dy, void* dx, float* part,
                              const float* mean, const float* rstd, const float* scale, const float* shift,
                              int64_t sb, float offset, float* dscale, float* dshift, int64_t n, int64_t p, int C,
                              int splits, int64_t chunk, float alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec)
    bwd<float, 4>(x, dy, dx, part, mean, rstd, scale, shift, sb, offset, dscale, dshift, n, p, C, splits, chunk,
                  alpha, s);
  else if (dtype == 0)
    bwd<float, 1>(x, dy, dx, part, mean, rstd, scale, shift, sb, offset, dscale, dshift, n, p, C, splits, chunk,
                  alpha, s);
  else if (dtype == 1 && vec)
    bwd<__nv_bfloat16, 8>(x, dy, dx, part, mean, rstd, scale, shift, sb, offset, dscale, dshift, n, p, C, splits,
                          chunk, alpha, s);
  else if (dtype == 1)
    bwd<__nv_bfloat16, 1>(x, dy, dx, part, mean, rstd, scale, shift, sb, offset, dscale, dshift, n, p, C, splits,
                          chunk, alpha, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
