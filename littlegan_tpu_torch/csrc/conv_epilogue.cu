// StarGAN v2's convolution epilogue over NHWC maps, forward and backward,
// for Hopper (sm_90a). Over the rows r of an (N*H*W, C) channels-last map:
//
//     out[r, c] = s * ((y[r, c] + b[c]) + sc[r, c])              (forward)
//     gs[r, c] = s * g[r, c],   db[c] = s * sum_r g[r, c]          (backward)
//
// y is a convolution's output without its bias, b the f32 bias (or none),
// sc the residual block's shortcut (or none), s 1/sqrt(2) after a residual
// block's second conv and 1 elsewhere. Sums in f32, one rounding at the
// output. The backward's gs is the gradient of both y and sc; where s is 1
// it is g itself and the backward writes nothing but db. Each is the
// other's adjoint: the adjoint of g -> (s g, s sum_r g) is
// (gg, gb) -> s (gg + gb[c]), the forward without sc, so R1's double
// backward through the discriminator's convs runs on these kernels too.
//
// Replaces no TPU kernel: the JAX package has no StarGAN v2. Added because
// PyTorch runs the bias of a channels-last cuDNN convolution as a separate
// add without 16-byte vectors, forms the bias gradient with aten::sum over
// the channels-last gradient at a tenth of HBM's rate, and the residual
// add and /sqrt(2) are two more passes; in StarGAN v2's iteration (AFHQ
// 256², batch 8, on an H100) those took 29.7 ms of 123.5.
//
// What bounds them on the H100: bytes. The forward reads y (and sc) and
// writes out once; the backward reads g once (and writes gs where s != 1).
// The least time is those bytes at 3.35 TB/s.
//
// Forward: a thread per 16-byte vector of the map (8 bf16, 4 f32 channels
// of one pixel), grid-stride, the bias read through L1. Backward: a block
// owns a tile of 64 channels and a range of rows (a split); each thread
// adds one vector of channels over every rows/block-th row of the range,
// four loads in flight, then the block adds its rows' sums in row order
// into the split's partial sum per channel. Where the plan has one split
// that sum is db; else a second launch of 1024 threads a 64-channel tile
// adds the (splits, C) partials over the splits in one fixed order. Every sum is in a fixed order: the same
// bits on every call and in every CUDA-graph replay. Channel counts that
// are not a multiple of the vector (to_rgb's 3, the discriminator's
// logits) and unaligned tensors take the same steps one element a thread.
//
// C interface for ctypes: pointers and the stream are void*, every function
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // channels of a backward block

#include "vec_io.cuh"

template <typename T, int V>
__device__ __forceinline__ void load_f32(float (&f)[V], const T* p) {
  const Raw<T, V> raw = *reinterpret_cast<const Raw<T, V>*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = to_f32(e[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store_f32(T* p, const float (&f)[V]) {
  Raw<T, V> raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = from_f32<T>(f[k]);
  *reinterpret_cast<Raw<T, V>*>(p) = raw;
}

// One thread per vector of V channels: grid-stride over the n / V of them.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(const T* __restrict__ y, const float* __restrict__ b, const T* __restrict__ sc,
                    T* __restrict__ out, int64_t nvec, int C, float s) {
  const int cv = C / V;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; t < nvec;
       t += static_cast<int64_t>(gridDim.x) * kThreads) {
    float o[V];
    load_f32<T, V>(o, y + t * V);
    if (b != nullptr) {
      const int c = static_cast<int>(t % cv) * V;
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] += __ldg(b + c + k);
    }
    if (sc != nullptr) {
      float r[V];
      load_f32<T, V>(r, sc + t * V);
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] += r[k];
    }
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] *= s;
    store_f32<T, V>(out + t * V, o);
  }
}

// Adds the V channels of v into acc, and stores s v at p where p is not null.
template <typename T, int V>
__device__ __forceinline__ void take(float (&acc)[V], float (&v)[V], T* p, float s) {
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] += v[k];
  if (p != nullptr) {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] *= s;
    store_f32<T, V>(p, v);
  }
}

// Backward, launch 1: block (split, tile) adds rows [split * chunk, + chunk)
// of the tile's channels (and writes s g there, gs not null). A tile is
// min(kTile, C) channels wide, `lanes` threads across a row, `rows` rows at
// a time. One split: db = s * the sum; else the sum is partial `split` of
// the (splits, C) part.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    epilogue_colsum_kernel(const T* __restrict__ g, T* __restrict__ gs, float* __restrict__ part,
                           float* __restrict__ db, int64_t R, int C, int64_t chunk, float s) {
  const int width = C < kTile ? C : kTile;
  const int lanes = (width + V - 1) / V, rows = kThreads / lanes;
  const int lane = threadIdx.x % lanes, row = threadIdx.x / lanes;
  const int c0 = blockIdx.y * kTile, c = c0 + lane * V;
  const int64_t r0 = blockIdx.x * chunk;
  const int64_t r1 = r0 + chunk < R ? r0 + chunk : R;
  float acc[V] = {};
  if (row < rows && c < C) {
    int64_t r = r0 + row;
    for (; r + 3 * rows < r1; r += 4 * rows) {  // four loads in flight
      float v[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) load_f32<T, V>(v[u], g + (r + u * rows) * C + c);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        take<T, V>(acc, v[u], gs == nullptr ? nullptr : gs + (r + u * rows) * C + c, s);
    }
    for (; r < r1; r += rows) {
      float v[V];
      load_f32<T, V>(v, g + r * C + c);
      take<T, V>(acc, v, gs == nullptr ? nullptr : gs + r * C + c, s);
    }
  }
  // the block's rows in row order: red[row][lane * V + k] is channel c0 + lane * V + k
  __shared__ float red[kThreads * V];
  const int cols = lanes * V;
  if (row < rows) {
#pragma unroll
    for (int k = 0; k < V; ++k) red[row * cols + lane * V + k] = acc[k];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < cols && c0 + static_cast<int>(threadIdx.x) < C) {
    float sum = 0.f;
    for (int q = 0; q < rows; ++q) sum += red[q * cols + threadIdx.x];
    const int ch = c0 + threadIdx.x;
    if (gridDim.x == 1)
      db[ch] = s * sum;
    else
      part[static_cast<int64_t>(blockIdx.x) * C + ch] = sum;
  }
}

// Backward, launch 2 (splits > 1): db = s * the partials' sum over the
// splits, per channel in one fixed order. Each of kTotalThreads / kTile
// groups adds every kGroups-th split into four sums in turn (four loads in
// flight), adds the four, then the groups' sums are added in group order.
constexpr int kTotalThreads = 1024;

__global__ void __launch_bounds__(kTotalThreads)
    epilogue_colsum_total_kernel(const float* __restrict__ part, float* __restrict__ db, int splits, int C,
                                 float s) {
  constexpr int kGroups = kTotalThreads / kTile;
  __shared__ float acc[kGroups][kTile];
  const int ch = threadIdx.x % kTile, grp = threadIdx.x / kTile;
  const int c = blockIdx.x * kTile + ch;
  float a[4] = {};
  if (c < C) {
    int q = grp;
    for (; q + 3 * kGroups < splits; q += 4 * kGroups) {
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] += part[static_cast<int64_t>(q + u * kGroups) * C + c];
    }
    for (; q < splits; q += kGroups) a[0] += part[static_cast<int64_t>(q) * C + c];
  }
  acc[grp][ch] = (a[0] + a[1]) + (a[2] + a[3]);
  __syncthreads();
  if (threadIdx.x < kTile && c < C) {
    float sum = 0.f;
    for (int k = 0; k < kGroups; ++k) sum += acc[k][threadIdx.x];
    db[c] = s * sum;
  }
}

template <typename T, int V>
void fwd(const void* y, const float* b, const void* sc, void* out, int64_t n, int C, float s, cudaStream_t st) {
  const int64_t nvec = n / V;
  const int64_t want = (nvec + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(want < (1 << 20) ? (want > 0 ? want : 1) : (1 << 20)));
  epilogue_kernel<T, V><<<grid, kThreads, 0, st>>>(static_cast<const T*>(y), b, static_cast<const T*>(sc),
                                                   static_cast<T*>(out), nvec, C, s);
}

template <typename T, int V>
void bwd(const void* g, void* gs, float* part, float* db, int64_t R, int C, int splits, int64_t chunk, float s,
         cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>((C + kTile - 1) / kTile));
  epilogue_colsum_kernel<T, V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<T*>(gs), part, db, R, C, chunk, s);
  if (splits > 1)
    epilogue_colsum_total_kernel<<<(C + kTile - 1) / kTile, kTotalThreads, 0, st>>>(part, db, splits, C, s);
}

}  // namespace

extern "C" {

// out = s * ((y + b[c]) + sc) over n elements of an NHWC map of C channels;
// b (f32, C) and sc (y's type and layout) may be null. dtype 0 float32, 1
// bfloat16; vec 1 for 16-byte vectors (y, sc and out 16-byte aligned, C a
// multiple of the vector), else one element a thread.
int lg_conv_epilogue(int dtype, int vec, const void* y, const float* b, const void* sc, void* out, int64_t n, int C,
                     float s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec)
    fwd<float, 4>(y, b, sc, out, n, C, s, st);
  else if (dtype == 0)
    fwd<float, 1>(y, b, sc, out, n, C, s, st);
  else if (dtype == 1 && vec)
    fwd<__nv_bfloat16, 8>(y, b, sc, out, n, C, s, st);
  else if (dtype == 1)
    fwd<__nv_bfloat16, 1>(y, b, sc, out, n, C, s, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// db = s * sum_r g[r, :] (f32, C) over the R rows of an NHWC g, and gs = s g
// where gs is not null; rows [k * chunk, + chunk) go to split k, part is a
// (splits, C) f32 scratch (unused at one split). dtype and vec as above.
int lg_conv_epilogue_bwd(int dtype, int vec, const void* g, void* gs, float* part, float* db, int64_t R, int C,
                         int splits, int64_t chunk, float s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec)
    bwd<float, 4>(g, gs, part, db, R, C, splits, chunk, s, st);
  else if (dtype == 0)
    bwd<float, 1>(g, gs, part, db, R, C, splits, chunk, s, st);
  else if (dtype == 1 && vec)
    bwd<__nv_bfloat16, 8>(g, gs, part, db, R, C, splits, chunk, s, st);
  else if (dtype == 1)
    bwd<__nv_bfloat16, 1>(g, gs, part, db, R, C, splits, chunk, s, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
