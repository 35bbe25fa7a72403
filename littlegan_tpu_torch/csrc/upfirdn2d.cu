// StyleGAN2's FIR resampling over NHWC maps, for Hopper (sm_90a): upfirdn2d
// with the separable [1, 3, 3, 1] / 8 filter (the 4x4 outer product, sum 1)
// and one padding p0 ahead of both axes:
//
//     y[b, i, j, c] = gain * sum_{a, e in 0..3} f[a] f[e] xz[b, i*down + a - p0, j*down + e - p0, c]
//
// where xz is x with up - 1 zeros inserted after every row and column (up 1
// or 2) and zero outside the map. The filter is symmetric, so the flip that
// upfirdn2d applies makes no difference. The three forms StyleGAN2 runs
// (torch_utils/ops/conv2d_resample.py and upfirdn2d.py of
// NVlabs/stylegan2-ada-pytorch):
//
//   up 2, down 1, p0 2: upsample2d (the skip generator's image, gain 4), and
//                       the adjoint of the down form;
//   up 1, down 1:       the filter over a padded map: p0 1 after a
//                       transposed stride-2 conv (gain 4), p0 2 ahead of a
//                       stride-2 conv, and each other's adjoint;
//   up 1, down 2, p0 1: downsample2d (the discriminator's 1x1 skip), and the
//                       adjoint of the up form.
//
// The wrapper (ops/cuda/upfirdn2d.py) works out the output size from the
// padding after the map, and the backward as this kernel in the adjoint
// form. Sums in f32, one rounding at the output.
//
// Replaces no TPU kernel: the JAX package has no StyleGAN2. Added because no
// kernel of the port computes a FIR resample, and its plain route, a
// depthwise 4x4 conv2d over a zero-inserted and padded copy, moves the map
// several times.
//
// What bounds it on the H100: bytes. The least time is x read once and y
// written once at 3.35 TB/s. A thread takes one 16-byte vector of channels
// (8 bf16, 4 f32) of R = 4 output rows in one column: it filters each
// source row that those rows touch horizontally once (4 taps, 2 where up is
// 2) and adds it into the rows that use it, so that a stride-1 form reads
// 28 vectors for 4 outputs in place of 64. Neighbouring threads take
// neighbouring channels, then columns, so a warp's accesses are contiguous
// lines and the rows it shares with the next warps meet in L1 and L2.
// Unaligned tensors and channel counts that are not a multiple of the
// vector (the 3 channels of an image) take the same steps one element a
// thread.
//
// C interface for ctypes: pointers and the stream are void*, every function
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // output rows a thread writes

#include "vec_io.cuh"

__device__ __forceinline__ float tap(int a) { return (a == 0 || a == 3) ? 0.125f : 0.375f; }

template <typename T, int V>
__device__ __forceinline__ void load_f32(float (&f)[V], const T* p) {
  const Raw<T, V> raw = *reinterpret_cast<const Raw<T, V>*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = to_f32(e[k]);
}

// One thread per (sample, block of kRows output rows, output column, vector
// of channels): grid-stride, channels fastest.
template <typename T, int V, int UP, int DOWN>
__global__ void __launch_bounds__(kThreads)
    upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n, int h, int w, int C, int oh, int ow,
                     int p0, float gain) {
  constexpr int kSpan = (kRows - 1) * DOWN + 4;  // rows of xz that kRows outputs touch
  const int cv = C / V, rb = (oh + kRows - 1) / kRows;
  const int64_t total = n * rb * ow * cv;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(t % cv) * V;
    int64_t q = t / cv;
    const int j = static_cast<int>(q % ow);
    q /= ow;
    const int i0 = static_cast<int>(q % rb) * kRows;
    const int64_t b = q / rb;
    const T* xb = x + b * h * static_cast<int64_t>(w) * C + c;
    float acc[kRows][V];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[r][k] = 0.f;
    const int t0 = i0 * DOWN - p0;  // first row of xz that output row i0 reads
#pragma unroll
    for (int s = 0; s < kSpan; ++s) {
      const int u = t0 + s;
      if (u < 0 || u >= h * UP || (UP == 2 && (u & 1))) continue;
      const T* xr = xb + static_cast<int64_t>(u / UP) * w * C;
      float hrow[V];
#pragma unroll
      for (int k = 0; k < V; ++k) hrow[k] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = j * DOWN + e - p0;
        if (v < 0 || v >= w * UP || (UP == 2 && (v & 1))) continue;
        float xv[V];
        load_f32<T, V>(xv, xr + static_cast<int64_t>(v / UP) * C);
#pragma unroll
        for (int k = 0; k < V; ++k) hrow[k] += tap(e) * xv[k];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int a = s - r * DOWN;  // the tap of row u in output row i0 + r
        if (a < 0 || a > 3) continue;
#pragma unroll
        for (int k = 0; k < V; ++k) acc[r][k] += tap(a) * hrow[k];
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r >= oh) break;
      Raw<T, V> raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) e[k] = from_f32<T>(gain * acc[r][k]);
      *reinterpret_cast<Raw<T, V>*>(y + ((b * oh + i0 + r) * static_cast<int64_t>(ow) + j) * C + c) = raw;
    }
  }
}

template <typename T, int V, int UP, int DOWN>
void launch(const void* x, void* y, int64_t n, int h, int w, int C, int oh, int ow, int p0, float gain,
            cudaStream_t st) {
  const int64_t threads = n * ((oh + kRows - 1) / kRows) * static_cast<int64_t>(ow) * (C / V);
  const int64_t want = (threads + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(want < (1 << 20) ? (want > 0 ? want : 1) : (1 << 20)));
  upfirdn2d_kernel<T, V, UP, DOWN><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<T*>(y), n, h, w,
                                                              C, oh, ow, p0, gain);
}

template <typename T, int V>
int dispatch(int up, int down, const void* x, void* y, int64_t n, int h, int w, int C, int oh, int ow, int p0,
             float gain, cudaStream_t st) {
  if (up == 1 && down == 1)
    launch<T, V, 1, 1>(x, y, n, h, w, C, oh, ow, p0, gain, st);
  else if (up == 2 && down == 1)
    launch<T, V, 2, 1>(x, y, n, h, w, C, oh, ow, p0, gain, st);
  else if (up == 1 && down == 2)
    launch<T, V, 1, 2>(x, y, n, h, w, C, oh, ow, p0, gain, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (n, oh, ow, C) = upfirdn2d(x (n, h, w, C)) with (up, down) one of (1, 1),
// (2, 1), (1, 2), p0 the padding ahead of both axes and gain the filter's
// scale; dtype 0 float32, 1 bfloat16; vec 1 for 16-byte vectors (x and y
// 16-byte aligned, C a multiple of the vector).
int lg_upfirdn2d(int dtype, int vec, int up, int down, const void* x, void* y, int64_t n, int h, int w, int C,
                 int oh, int ow, int p0, float gain, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec) return dispatch<float, 4>(up, down, x, y, n, h, w, C, oh, ow, p0, gain, st);
  if (dtype == 0) return dispatch<float, 1>(up, down, x, y, n, h, w, C, oh, ow, p0, gain, st);
  if (dtype == 1 && vec) return dispatch<__nv_bfloat16, 8>(up, down, x, y, n, h, w, C, oh, ow, p0, gain, st);
  if (dtype == 1) return dispatch<__nv_bfloat16, 1>(up, down, x, y, n, h, w, C, oh, ow, p0, gain, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
