// StarGAN v2's 2x2 resampling over NHWC maps, for Hopper (sm_90a):
//
//     down2(x, s)[b, i, j, c] = s * sum_{di, dj in {0, 1}} x[b, 2i + di, 2j + dj, c]
//     up2(x, s)[b, 2i + di, 2j + dj, c] = s * x[b, i, j, c]
//
// down2 with s = 1/4 is the 2x2 average pool (ops/resample.py's downsample,
// every downsampling ResBlk of the generator, style encoder and
// discriminator); up2 with s = 1 the nearest x2 upsample (the generator's
// AdainResBlks). Each is the other's adjoint at the same s, so the
// backwards are up2(g, 1/4) and down2(g, 1), and R1's double backward
// through the discriminator's pools runs on these kernels too. Sums in f32,
// one rounding at the output.
//
// Replaces no TPU kernel: the JAX package has no StarGAN v2. Added because
// PyTorch's channels-last kernels for avg_pool2d and upsample_nearest2d
// (avg_pool2d_out_cuda_frame_nhwc, upsample_nearest2d_nhwc_out_frame)
// compute every element's source index on its own and load one element at
// a time: in StarGAN v2's channels-last iteration (AFHQ 256², batch 8, on
// an H100) they took 23 and 30 ms, twice their NCHW kernels' time.
//
// What bounds them on the H100: bytes. down2 reads 4 values for each it
// writes, up2 writes 4 for each it reads; the least time is those bytes at
// 3.35 TB/s. A thread takes one 16-byte vector of channels (8 bf16, 4 f32)
// of one output pixel (down2) or of one input pixel (up2): its four loads or
// stores are whole 16-byte vectors, and neighbouring threads take
// neighbouring channels, then pixels, so a warp's accesses are contiguous
// lines. Unaligned tensors and channel counts that are not a multiple of the
// vector take the same steps one element a thread.
//
// C interface for ctypes: pointers and the stream are void*, every function
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

#include "vec_io.cuh"

template <typename T, int V>
__device__ __forceinline__ void add(float (&acc)[V], const T* p) {
  const Raw<T, V> raw = *reinterpret_cast<const Raw<T, V>*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] += to_f32(e[k]);
}

// One thread per (output pixel, vector of channels): grid-stride over
// n * (h/2) * (w/2) * (C/V) of them, channels fastest.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    resample_down2_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n, int h, int w, int C, float s) {
  const int cv = C / V, ho = h / 2, wo = w / 2;
  const int64_t total = n * ho * wo * cv;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(t % cv) * V;
    int64_t q = t / cv;
    const int j = static_cast<int>(q % wo);
    q /= wo;
    const int i = static_cast<int>(q % ho);
    const int64_t b = q / ho;
    const T* src = x + ((b * h + 2 * i) * w + 2 * j) * C + c;
    float acc[V] = {};
    add<T, V>(acc, src);
    add<T, V>(acc, src + C);
    add<T, V>(acc, src + static_cast<int64_t>(w) * C);
    add<T, V>(acc, src + static_cast<int64_t>(w) * C + C);
    Raw<T, V> raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_f32<T>(s * acc[k]);
    *reinterpret_cast<Raw<T, V>*>(y + t * V) = raw;
  }
}

// One thread per (input pixel, vector of channels): grid-stride over
// n * h * w * (C/V) of them; four stores each.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    resample_up2_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n, int h, int w, int C, float s) {
  const int cv = C / V;
  const int64_t total = n * h * w * cv;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x; t < total;
       t += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int c = static_cast<int>(t % cv) * V;
    int64_t q = t / cv;
    const int j = static_cast<int>(q % w);
    q /= w;
    const int i = static_cast<int>(q % h);
    const int64_t b = q / h;
    Raw<T, V> raw = *reinterpret_cast<const Raw<T, V>*>(x + t * V);
    if (s != 1.f) {
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < V; ++k) e[k] = from_f32<T>(s * to_f32(e[k]));
    }
    T* dst = y + ((b * 2 * h + 2 * i) * 2 * w + 2 * j) * C + c;
    const int64_t row = 2 * static_cast<int64_t>(w) * C;
    *reinterpret_cast<Raw<T, V>*>(dst) = raw;
    *reinterpret_cast<Raw<T, V>*>(dst + C) = raw;
    *reinterpret_cast<Raw<T, V>*>(dst + row) = raw;
    *reinterpret_cast<Raw<T, V>*>(dst + row + C) = raw;
  }
}

template <typename T, int V>
void launch(int up, const void* x, void* y, int64_t n, int h, int w, int C, float s, cudaStream_t st) {
  const int64_t threads = n * (up ? static_cast<int64_t>(h) * w : static_cast<int64_t>(h / 2) * (w / 2)) * (C / V);
  const int64_t want = (threads + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(want < (1 << 20) ? (want > 0 ? want : 1) : (1 << 20)));
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (up)
    resample_up2_kernel<T, V><<<grid, kThreads, 0, st>>>(xt, yt, n, h, w, C, s);
  else
    resample_down2_kernel<T, V><<<grid, kThreads, 0, st>>>(xt, yt, n, h, w, C, s);
}

}  // namespace

extern "C" {

// y = down2(x, s) (up = 0: x (n, h, w, C), y (n, h/2, w/2, C)) or up2(x, s)
// (up = 1: y (n, 2h, 2w, C)); dtype 0 float32, 1 bfloat16; vec 1 for
// 16-byte vectors (x and y 16-byte aligned, C a multiple of the vector).
int lg_resample2(int dtype, int vec, int up, const void* x, void* y, int64_t n, int h, int w, int C, float s,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec)
    launch<float, 4>(up, x, y, n, h, w, C, s, st);
  else if (dtype == 0)
    launch<float, 1>(up, x, y, n, h, w, C, s, st);
  else if (dtype == 1 && vec)
    launch<__nv_bfloat16, 8>(up, x, y, n, h, w, C, s, st);
  else if (dtype == 1)
    launch<__nv_bfloat16, 1>(up, x, y, n, h, w, C, s, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
