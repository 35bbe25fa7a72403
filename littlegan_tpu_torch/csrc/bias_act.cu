// StyleGAN2's layer epilogue (S5) over NHWC maps, for Hopper (sm_90a): the
// forward, its backward, and the backward's backward. Over an (N, H*W, C)
// channels-last map y, per sample n, pixel p and channel c:
//
//     pre = ((y d[n, c]) + noise[n, p] ns) + b[c]     (pre = y + b[c] unmodulated)
//     s   = pre > 0 ? gain : again                     (the slope times the gain)
//     v   = pre s,   out = clamp(v, -bound, bound)
//
// b is the f32 bias. A modulated layer (the template flag D) also has d,
// its f32 (N, C) demodulation, noise, its (N, 1, H, W) noise map in y's
// type (read with its sample stride), and ns, the f32 noise strength. b and
// ns are read from device memory (they move at every Adam step inside a
// CUDA-graph replay). gain is sqrt(2) times the
// layer's gain and again alpha (0.2) times that for the LeakyReLU; both are
// the gain for a linear layer. bound is the clamp times the gain. Every op
// is rounded to f32 on its own (no FMA contraction), as PyTorch rounds the
// same ops of the plain version, and the output once to y's type.
//
// Backward, from the gradient g and the saved y alone: pre and v again in
// the forward's arithmetic, then, with the sign and the clamp's range as
// constants (the published bias_act.cu's rule; the bounds pass, as
// torch.clamp's do),
//
//     gpre = [-bound <= v <= bound] g s,     gy = gpre d (gpre without d)
//     gd[n, c] = sum_p gpre y,   gb[c] = sum_{n, p} gpre,   gns = sum gpre noise
//
// Backward's backward (the path-length penalty through G, R1 through D),
// from the gradients ggy, ggd, ggb, ggns of gy, gd, gb, gns, with
// k = [-bound <= v <= bound] s:
//
//     gg  = (ggy d + ggd[n, c] y + ggb[c] + ggns noise) k     (towards g)
//     gyy = ggd[n, c] (g k),   gdd[n, c] = sum_p ggy (g k)    (towards y, d)
//
// Replaces no TPU kernel: the JAX package has no StyleGAN2. Added because
// PyTorch ran these as a pass over the map each (demodulation, noise, bias,
// LeakyReLU, gain, clamp), saved three maps a layer, and ran their
// backwards as more passes: 126 of the 219 ms of a StyleGAN2 iteration at
// FFHQ 256², batch 64, on an H100.
//
// What bounds them on the H100: bytes. The forward reads y and writes out;
// the backward reads g and y and writes gy; the backward's backward reads
// g, y and ggy and writes gg (and gyy). The least time is those bytes at
// 3.35 TB/s. The noise map is one element a pixel, read through L1.
//
// Design, the same in the three kernels: a block owns sample n, a tile of
// 64 channels and a range of its pixels (a split); each thread holds one
// 16-byte vector of channels (8 bf16, 4 f32), so its d and b stay in
// registers, and walks every rows-th pixel of the range, four loads in
// flight, kept packed until used. In the backwards the block adds its
// rows' sums in row order into per-(sample, split, channel) partials (gd,
// gb) and its threads' scalars in a fixed tree into per-(sample, split,
// tile) partials (gns). A second launch adds the partials in one fixed
// order: gd over the splits, gb over the samples and splits, gns over all.
// Every sum is in a fixed order: the same bits on every call and in every
// CUDA-graph replay. Channel counts that are not a multiple of the vector
// (ToRGB's 3) and unaligned tensors take the same steps one element a
// thread.
//
// C interface for ctypes: pointers and the stream are void*, every function
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // channels of a block

#include "vec_io.cuh"

// V channels of one pixel, loaded as one access and kept packed until used.
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

// What every kernel reads beside the maps.
struct Epi {
  const float* d;     // (N, C) demodulation; read with D
  const void* noise;  // y's type: pixel p of sample n at noise + n * nstride + p; read with D
  int64_t nstride;
  const float* ns;    // the noise strength (one float); read with D
  const float* b;     // (C) bias
  float gain;         // the slope times the gain where pre > 0
  float again;        // the same elsewhere
  float bound;        // the clamp times the gain
};

__device__ __forceinline__ float slope(float pre, const Epi& e) { return pre > 0.f ? e.gain : e.again; }

// Whether the clamp passes v's gradient: -bound <= v <= bound.
__device__ __forceinline__ bool kept(float v, const Epi& e) { return v >= -e.bound && v <= e.bound; }

__device__ __forceinline__ float clamped(float v, const Epi& e) {
  return v < -e.bound ? -e.bound : (v > e.bound ? e.bound : v);
}

// Where a block works: sample n, channels [c0, c0 + min(64, C)), pixels
// [p0, p1); the thread's channels c .. c + V - 1 of the pixels p0 + row,
// p0 + row + rows, ... (none where c >= C or row >= rows).
template <int V>
struct Place {
  int n, tile, c0, c, lanes, lane, rows, row, p0, p1;
  bool on;

  __device__ Place(int hw, int C, int chunk) {
    const int width = C < kTile ? C : kTile;
    n = blockIdx.z;
    tile = blockIdx.y;
    c0 = tile * kTile;
    lanes = (width + V - 1) / V;
    rows = kThreads / lanes;
    lane = threadIdx.x % lanes;
    row = threadIdx.x / lanes;
    c = c0 + lane * V;
    p0 = blockIdx.x * chunk;
    p1 = p0 + chunk < hw ? p0 + chunk : hw;
    on = row < rows && c < C;
  }

  __device__ int64_t partial(int C) const { return (static_cast<int64_t>(n) * gridDim.x + blockIdx.x) * C; }
};

// A thread's fixed operands: its channels' b and, with D, d, its sample's
// noise row and the noise strength. pre() forms ((y d) + noise ns) + b (y +
// b without D) of its V channels at one pixel, each op rounded on its own,
// as PyTorch's ops round the plain version.
template <typename T, int V, bool D>
struct Lane {
  float d[V], b[V];
  const T* nz;
  float ns;

  __device__ Lane(const Place<V>& pl, const Epi& e, int C) {
    nz = D ? static_cast<const T*>(e.noise) + pl.n * e.nstride : nullptr;
    ns = D ? *e.ns : 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      d[k] = D ? e.d[static_cast<int64_t>(pl.n) * C + pl.c + k] : 1.f;
      b[k] = e.b[pl.c + k];
    }
  }

  __device__ __forceinline__ float noise(int p) const { return D ? to_f32(nz[p]) : 0.f; }

  __device__ __forceinline__ void pre(float (&x)[V], const Pack<T, V>& y, float nzv) const {
    const float nzs = __fmul_rn(nzv, ns);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float v = y[k];
      if (D) v = __fadd_rn(__fmul_rn(v, d[k]), nzs);
      x[k] = __fadd_rn(v, b[k]);
    }
  }
};

// Forward: out at the block's pixels, four loads in flight.
template <typename T, int V, bool D>
__global__ void __launch_bounds__(kThreads)
    bias_act_kernel(const T* __restrict__ y, T* __restrict__ out, const Epi e, int hw, int C, int chunk) {
  const Place<V> pl(hw, C, chunk);
  if (!pl.on) return;
  const Lane<T, V, D> ln(pl, e, C);
  const int64_t base = static_cast<int64_t>(pl.n) * hw * C + pl.c;
  auto put = [&](const Pack<T, V>& yv, int p) {
    float x[V];
    ln.pre(x, yv, ln.noise(p));
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = clamped(__fmul_rn(x[k], slope(x[k], e)), e);
    store<T, V>(out + base + static_cast<int64_t>(p) * C, x);
  };
  int p = pl.p0 + pl.row;
  for (; p + 3 * pl.rows < pl.p1; p += 4 * pl.rows) {
    Pack<T, V> yv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) yv[u] = load<T, V>(y + base + static_cast<int64_t>(p + u * pl.rows) * C);
#pragma unroll
    for (int u = 0; u < 4; ++u) put(yv[u], p + u * pl.rows);
  }
  for (; p < pl.p1; p += pl.rows) put(load<T, V>(y + base + static_cast<int64_t>(p) * C), p);
}

// The block's per-thread sums of V channels (s1, s2), added over its rows
// in row order, to part1 and part2 at the block's (sample, split) row;
// its per-thread scalars sn, added in a fixed tree, to partn at the
// block's (sample, split, tile). A null part skips its sum. Every thread
// of the block calls it.
template <int V>
__device__ __forceinline__ void write_partials(const Place<V>& pl, int C, const float (&s1)[V],
                                               float* __restrict__ part1, const float (&s2)[V],
                                               float* __restrict__ part2, float sn, float* __restrict__ partn) {
  __shared__ float red[2][kThreads * V];
  __shared__ float warps[kThreads / 32];
  const int cols = pl.lanes * V;
  if (pl.row < pl.rows) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][pl.row * cols + pl.lane * V + k] = s1[k];
      red[1][pl.row * cols + pl.lane * V + k] = s2[k];
    }
  }
  if (partn != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sn += __shfl_down_sync(0xffffffffu, sn, off);
    if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = sn;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < cols && pl.c0 + t < C) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < pl.rows; ++q) {
      a += red[0][q * cols + t];
      b += red[1][q * cols + t];
    }
    if (part1 != nullptr) part1[pl.partial(C) + pl.c0 + t] = a;
    if (part2 != nullptr) part2[pl.partial(C) + pl.c0 + t] = b;
  }
  if (partn != nullptr && t == 0) {
    float a = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) a += warps[w];
    partn[(static_cast<int64_t>(pl.n) * gridDim.x + blockIdx.x) * gridDim.y + pl.tile] = a;
  }
}

// Backward, launch 1: gy, and the partials of gd (part_d), gb (part_b) and
// gns (part_n), each where its pointer is set; four loads in flight.
template <typename T, int V, bool D>
__global__ void __launch_bounds__(kThreads)
    bias_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y, T* __restrict__ gy, const Epi e,
                        float* __restrict__ part_d, float* __restrict__ part_b, float* __restrict__ part_n, int hw,
                        int C, int chunk) {
  const Place<V> pl(hw, C, chunk);
  float sd[V] = {}, sb[V] = {}, sn = 0.f;
  if (pl.on) {
    const Lane<T, V, D> ln(pl, e, C);
    const int64_t base = static_cast<int64_t>(pl.n) * hw * C + pl.c;
    auto take = [&](const Pack<T, V>& yv, const Pack<T, V>& gv, int p) {
      const float nzv = ln.noise(p);
      float x[V];
      ln.pre(x, yv, nzv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float s = slope(x[k], e);
        const float gp = kept(__fmul_rn(x[k], s), e) ? __fmul_rn(gv[k], s) : 0.f;
        sb[k] += gp;
        if (D) sd[k] += gp * yv[k];
        if (D) sn += gp * nzv;
        x[k] = D ? __fmul_rn(gp, ln.d[k]) : gp;
      }
      store<T, V>(gy + base + static_cast<int64_t>(p) * C, x);
    };
    int p = pl.p0 + pl.row;
    for (; p + pl.rows < pl.p1; p += 2 * pl.rows) {
      Pack<T, V> yv[2], gv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        yv[u] = load<T, V>(y + base + static_cast<int64_t>(p + u * pl.rows) * C);
        gv[u] = load<T, V>(g + base + static_cast<int64_t>(p + u * pl.rows) * C);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) take(yv[u], gv[u], p + u * pl.rows);
    }
    for (; p < pl.p1; p += pl.rows)
      take(load<T, V>(y + base + static_cast<int64_t>(p) * C), load<T, V>(g + base + static_cast<int64_t>(p) * C), p);
  }
  write_partials<V>(pl, C, sd, part_d, sb, part_b, sn, part_n);
}

// Backward's backward, launch 1: gg (where set), gyy (where set) and the
// partials of gdd (part_d, where set). ggy, ggd, ggb and ggns may be null;
// ggd and ggns are read with D alone.
template <typename T, int V, bool D>
__global__ void __launch_bounds__(kThreads)
    bias_act_bwd2_kernel(const T* __restrict__ g, const T* __restrict__ y, const T* __restrict__ ggy,
                         T* __restrict__ gg, T* __restrict__ gyy, const Epi e, const float* __restrict__ ggd,
                         const float* __restrict__ ggb, const float* __restrict__ ggns, float* __restrict__ part_d,
                         int hw, int C, int chunk) {
  const Place<V> pl(hw, C, chunk);
  float sd[V] = {};
  if (pl.on) {
    const Lane<T, V, D> ln(pl, e, C);
    const int64_t base = static_cast<int64_t>(pl.n) * hw * C + pl.c;
    const float gns = ggns == nullptr ? 0.f : *ggns;
    float gdv[V], gbv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      gdv[k] = ggd == nullptr ? 0.f : ggd[static_cast<int64_t>(pl.n) * C + pl.c + k];
      gbv[k] = ggb == nullptr ? 0.f : ggb[pl.c + k];
    }
    for (int p = pl.p0 + pl.row; p < pl.p1; p += pl.rows) {
      const int64_t at = base + static_cast<int64_t>(p) * C;
      const Pack<T, V> yv = load<T, V>(y + at), gv = load<T, V>(g + at);
      Pack<T, V> hv = {};
      if (ggy != nullptr) hv = load<T, V>(ggy + at);
      const float nzv = ln.noise(p);
      float x[V], q[V];
      ln.pre(x, yv, nzv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float s = slope(x[k], e);
        const float kk = kept(__fmul_rn(x[k], s), e) ? s : 0.f;
        float t = 0.f;  // ggy d + ggd y + ggb + ggns noise, the terms present in that order
        if (ggy != nullptr) t = D ? __fmul_rn(hv[k], ln.d[k]) : hv[k];
        if (D && ggd != nullptr) t = __fadd_rn(t, __fmul_rn(gdv[k], yv[k]));
        if (ggb != nullptr) t = __fadd_rn(t, gbv[k]);
        if (D && ggns != nullptr) t = __fadd_rn(t, __fmul_rn(gns, nzv));
        x[k] = __fmul_rn(t, kk);
        const float gp = __fmul_rn(gv[k], kk);
        q[k] = __fmul_rn(gdv[k], gp);
        if (D && ggy != nullptr) sd[k] += hv[k] * gp;
      }
      if (gg != nullptr) store<T, V>(gg + at, x);
      if (gyy != nullptr) store<T, V>(gyy + at, q);
    }
  }
  write_partials<V>(pl, C, sd, part_d, sd, nullptr, 0.f, nullptr);
}

// One column total of launch 2: out[batch, c] = sum_r part[batch, r, c]
// over `rows` rows, for `batches` batches of `cols` columns; no job where
// part is null.
struct Sum {
  const float* part;
  float* out;
  int rows, cols, batches;
};

__host__ __device__ inline int blocks_of(const Sum& s) {
  return s.part == nullptr ? 0 : s.batches * ((s.cols + kTile - 1) / kTile);
}

// Block `blk` of job s: one batch and a tile of up to 64 columns. The
// block's threads are `width` columns by `groups` (a power of two) rows;
// each adds every groups-th row, then the groups' sums are added in a
// fixed tree.
__device__ __forceinline__ void column_total(const Sum& s, int blk) {
  __shared__ float acc[kThreads];
  const int tiles = (s.cols + kTile - 1) / kTile;
  const int batch = blk / tiles, c0 = (blk % tiles) * kTile;
  const int width = s.cols < kTile ? s.cols : kTile;
  int groups = 1;
  while (2 * groups * width <= kThreads) groups *= 2;
  const int ch = threadIdx.x % width, grp = threadIdx.x / width;
  const bool on = grp < groups && c0 + ch < s.cols;
  if (grp < groups) {
    float a[4] = {};
    if (on) {
      const float* src = s.part + static_cast<int64_t>(batch) * s.rows * s.cols + c0 + ch;
      int r = grp;
      for (; r + 3 * groups < s.rows; r += 4 * groups) {
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] += src[static_cast<int64_t>(r + u * groups) * s.cols];
      }
      for (; r < s.rows; r += groups) a[0] += src[static_cast<int64_t>(r) * s.cols];
    }
    acc[grp * width + ch] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  for (int half = groups / 2; half > 0; half /= 2) {
    __syncthreads();
    if (grp < half) acc[grp * width + ch] += acc[(grp + half) * width + ch];
  }
  if (grp == 0 && on) s.out[static_cast<int64_t>(batch) * s.cols + c0 + ch] = acc[ch];
}

__global__ void __launch_bounds__(kThreads) bias_act_total_kernel(const Sum a, const Sum b, const Sum c) {
  int blk = blockIdx.x;
  if (blk < blocks_of(a)) {
    column_total(a, blk);
    return;
  }
  blk -= blocks_of(a);
  if (blk < blocks_of(b)) {
    column_total(b, blk);
    return;
  }
  column_total(c, blk - blocks_of(b));
}

void totals(const Sum& a, const Sum& b, const Sum& c, cudaStream_t st) {
  const int blocks = blocks_of(a) + blocks_of(b) + blocks_of(c);
  if (blocks > 0) bias_act_total_kernel<<<blocks, kThreads, 0, st>>>(a, b, c);
}

template <typename T, int V, bool D>
void fwd(const void* y, void* out, const Epi& e, int n, int hw, int C, int splits, int chunk, cudaStream_t st) {
  const dim3 grid(splits, (C + kTile - 1) / kTile, n);
  bias_act_kernel<T, V, D><<<grid, kThreads, 0, st>>>(static_cast<const T*>(y), static_cast<T*>(out), e, hw, C,
                                                      chunk);
}

template <typename T, int V, bool D>
void bwd(const void* g, const void* y, void* gy, const Epi& e, float* part_d, float* part_b, float* part_n,
         int n, int hw, int C, int splits, int chunk, cudaStream_t st) {
  const dim3 grid(splits, (C + kTile - 1) / kTile, n);
  bias_act_bwd_kernel<T, V, D><<<grid, kThreads, 0, st>>>(static_cast<const T*>(g), static_cast<const T*>(y),
                                                          static_cast<T*>(gy), e, part_d, part_b, part_n, hw, C,
                                                          chunk);
}

template <typename T, int V, bool D>
void bwd2(const void* g, const void* y, const void* ggy, void* gg, void* gyy, const Epi& e, const float* ggd,
          const float* ggb, const float* ggns, float* part_d, int n, int hw, int C, int splits, int chunk,
          cudaStream_t st) {
  const dim3 grid(splits, (C + kTile - 1) / kTile, n);
  bias_act_bwd2_kernel<T, V, D><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), static_cast<const T*>(ggy), static_cast<T*>(gg),
      static_cast<T*>(gyy), e, ggd, ggb, ggns, part_d, hw, C, chunk);
}

// The instance of F<T, V, D> for (dtype, vec, d), called with args; false
// for a dtype the kernels do not take.
#define LG_DISPATCH(F, ...)                                              \
  do {                                                                   \
    const bool dm = d != nullptr;                                        \
    if (dtype == 0 && vec && dm) F<float, 4, true>(__VA_ARGS__);         \
    else if (dtype == 0 && vec) F<float, 4, false>(__VA_ARGS__);         \
    else if (dtype == 0 && dm) F<float, 1, true>(__VA_ARGS__);           \
    else if (dtype == 0) F<float, 1, false>(__VA_ARGS__);                \
    else if (dtype == 1 && vec && dm) F<__nv_bfloat16, 8, true>(__VA_ARGS__); \
    else if (dtype == 1 && vec) F<__nv_bfloat16, 8, false>(__VA_ARGS__); \
    else if (dtype == 1 && dm) F<__nv_bfloat16, 1, true>(__VA_ARGS__);   \
    else if (dtype == 1) F<__nv_bfloat16, 1, false>(__VA_ARGS__);        \
    else return static_cast<int>(cudaErrorInvalidValue);                 \
  } while (0)

}  // namespace

extern "C" {

// out = the epilogue of y over n samples of hw pixels and C channels (NHWC).
// dtype 0 float32, 1 bfloat16; vec 1 for 16-byte vectors (y and out
// 16-byte aligned, C a multiple of the vector), else one element a thread.
// d, noise, ns and b as in Epi: d, noise and ns all set (a modulated
// layer) or all null. Pixels [k * chunk, + chunk) of a sample go to
// split k.
int lg_bias_act(int dtype, int vec, const void* y, void* out, const float* d, const void* noise, int64_t nstride,
                const float* ns, const float* b, float gain, float again, float bound, int n, int hw, int C,
                int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epi e{d, noise, nstride, ns, b, gain, again, bound};
  LG_DISPATCH(fwd, y, out, e, n, hw, C, splits, chunk, st);
  return static_cast<int>(cudaGetLastError());
}

// gy, and gd (N, C), gb (C) and gns (one float), each where its partials
// are set: part_d and part_b (N, splits, C), part_n (N, splits, tiles) f32
// scratch. Pixels [k * chunk, + chunk) of a sample go to split k.
int lg_bias_act_bwd(int dtype, int vec, const void* g, const void* y, void* gy, const float* d, const void* noise,
                    int64_t nstride, const float* ns, const float* b, float gain, float again, float bound,
                    float* part_d, float* gd, float* part_b, float* gb, float* part_n, float* gns, int n, int hw,
                    int C, int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epi e{d, noise, nstride, ns, b, gain, again, bound};
  LG_DISPATCH(bwd, g, y, gy, e, part_d, part_b, part_n, n, hw, C, splits, chunk, st);
  const int tiles = (C + kTile - 1) / kTile;
  totals(Sum{part_d, gd, splits, C, n}, Sum{part_b, gb, n * splits, C, 1}, Sum{part_n, gns, n * splits * tiles, 1, 1},
         st);
  return static_cast<int>(cudaGetLastError());
}

// gg (where set), gyy (where set) and gdd (N, C) from its (N, splits, C)
// partials part_d (where set), from ggy (a map, or null), ggd (N, C), ggb
// (C) and ggns (one float), each f32 or null.
int lg_bias_act_bwd2(int dtype, int vec, const void* g, const void* y, const void* ggy, void* gg, void* gyy,
                     const float* d, const void* noise, int64_t nstride, const float* ns, const float* b, float gain,
                     float again, float bound, const float* ggd, const float* ggb, const float* ggns,
                     float* part_d, float* gdd, int n, int hw, int C, int splits, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epi e{d, noise, nstride, ns, b, gain, again, bound};
  LG_DISPATCH(bwd2, g, y, ggy, gg, gyy, e, ggd, ggb, ggns, part_d, n, hw, C, splits, chunk, st);
  totals(Sum{part_d, gdd, splits, C, n}, Sum{nullptr, nullptr, 0, 1, 0}, Sum{nullptr, nullptr, 0, 1, 0}, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
