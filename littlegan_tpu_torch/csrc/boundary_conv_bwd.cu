// Stats-cotangent fold and bias gradient of the boundary conv, for Hopper (sm_90a).
//
// The backward of boundary_conv.cu's conv + fused stats. The JAX package's
// custom VJP (littlegan_tpu/ops/pallas/boundary_conv.py, _bwd) leaves it to
// XLA: it folds the cotangents of the per-sample stats into the output
// cotangent and sums that over (N, H, W) for the bias,
//
//     gy' = gy + gs1[n] + 2 * y * gs2[n]     (f32; y the cast output)
//     db  = sum over (N, H, W) of gy'         (f32)
//
// then takes dx and dw from gy' (in x's type) with two convolutions, which
// stay with PyTorch's convolution backward here as they stay with XLA there.
// This file is the elementwise part and the reduction, in one pass over y
// and gy instead of a chain of generic elementwise launches.
//
// What bounds it on the H100: bytes (read y and gy, write gy'; a few
// operations per element). Each block owns a run of pixels of all Cout
// channels: a thread keeps one 16-byte vector position (8 bf16 or 4 f32
// channels) fixed and strides over the pixels, so loads and stores are
// 16 bytes a thread on neighbouring addresses, and it keeps its channels'
// f32 sums in registers. The block reduces them per channel through shared
// memory to one partial row; a second launch reduces the rows per channel
// in a fixed order. No float atomics: db is deterministic.
//
// That layout needs Cout a multiple of the vector's elements (8 bf16, 4
// f32) and at most 256 vectors; where a pixel's vectors do not divide 256,
// the threads past the last whole pixel idle. Any other Cout (the Pallas
// kernel takes any; 6 and 12 in bf16, say) takes fold_scalar_kernel: the same pass
// element by element, the block's threads laid over a slab of up to 256
// channels and as many pixels as fill it, so that neighbouring threads
// still touch neighbouring addresses; a Cout above 256 takes several slabs
// one after another. The host picks the layout (fold_vectorised in
// ops/cuda/boundary_conv.py).
//
// C interface for ctypes: pointers and the stream are void*, the function
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

template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / sizeof(T); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const T* __restrict__ y, const T* __restrict__ gy, const float* __restrict__ gs1,
                const float* __restrict__ gs2, T* __restrict__ out, float* __restrict__ part,
                int64_t pixels, int hw, int cout, int block_pixels) {
  constexpr int V = vec_elems<T>();
  __shared__ float red[kThreads * V];
  const int groups = cout / V;          // vectors per pixel (at most kThreads)
  const int lanes = kThreads / groups;  // pixels in flight per block
  const int g = threadIdx.x % groups;
  const int lane = threadIdx.x / groups;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * block_pixels;
  const int64_t p1 = p0 + block_pixels < pixels ? p0 + block_pixels : pixels;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  // threads past lanes * groups (where groups does not divide kThreads) idle
  for (int64_t p = lane < lanes ? p0 + lane : p1; p < p1; p += lanes) {
    const int64_t n = p / hw;
    const float a = gs1[n], b2 = 2.f * gs2[n];
    const int64_t off = p * groups + g;
    const uint4 ry = __ldg(reinterpret_cast<const uint4*>(y) + off);
    const uint4 rg = __ldg(reinterpret_cast<const uint4*>(gy) + off);
    const T* ey = reinterpret_cast<const T*>(&ry);
    const T* eg = reinterpret_cast<const T*>(&rg);
    uint4 ro;
    T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = to_f32(eg[k]) + a + b2 * to_f32(ey[k]);
      acc[k] += v;
      eo[k] = from_f32<T>(v);
    }
    reinterpret_cast<uint4*>(out)[off] = ro;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) red[threadIdx.x * V + k] = acc[k];
  __syncthreads();
  // channel c sits at vector position c / V, element c % V of each lane
  for (int c = threadIdx.x; c < cout; c += kThreads) {
    const int cg = c / V, k = c % V;
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += red[(l * groups + cg) * V + k];
    part[static_cast<int64_t>(blockIdx.x) * cout + c] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fold_scalar_kernel(const T* __restrict__ y, const T* __restrict__ gy, const float* __restrict__ gs1,
                       const float* __restrict__ gs2, T* __restrict__ out, float* __restrict__ part,
                       int64_t pixels, int hw, int cout, int block_pixels) {
  __shared__ float red[kThreads];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * block_pixels;
  const int64_t p1 = p0 + block_pixels < pixels ? p0 + block_pixels : pixels;
  for (int c0 = 0; c0 < cout; c0 += kThreads) {
    // a slab of cw channels; thread t takes channel c0 + t % cw of every
    // lanes-th pixel from p0 + t / cw: element p * cout + c0 + t of a row
    const int cw = cout - c0 < kThreads ? cout - c0 : kThreads;
    const int lanes = kThreads / cw;
    const int c = c0 + threadIdx.x % cw, lane = threadIdx.x / cw;
    float acc = 0.f;
    if (lane < lanes) {
      for (int64_t p = p0 + lane; p < p1; p += lanes) {
        const int64_t n = p / hw;
        const int64_t i = p * cout + c;
        const float v = to_f32(gy[i]) + gs1[n] + 2.f * gs2[n] * to_f32(y[i]);
        acc += v;
        out[i] = from_f32<T>(v);
      }
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < cw) {
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += red[l * cw + threadIdx.x];
      part[static_cast<int64_t>(blockIdx.x) * cout + c0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// One thread per channel: the blocks' partial rows summed in block order.
__global__ void bias_grad_kernel(const float* __restrict__ part, int blocks, int cout,
                                 float* __restrict__ db) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cout) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[static_cast<int64_t>(b) * cout + c];
  db[c] = s;
}

template <typename T>
bool vector_layout_ok(int cout) {
  constexpr int V = vec_elems<T>();
  return cout % V == 0 && cout / V <= kThreads;
}

template <typename T>
cudaError_t launch(const void* y, const void* gy, const float* gs1, const float* gs2, void* out,
                   float* part, float* db, int64_t pixels, int hw, int cout, int block_pixels,
                   int blocks, int vec, cudaStream_t stream) {
  if (cout < 1 || (vec && !vector_layout_ok<T>(cout))) return cudaErrorInvalidValue;
  if (vec)
    fold_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(y), static_cast<const T*>(gy),
                                                    gs1, gs2, static_cast<T*>(out), part, pixels, hw,
                                                    cout, block_pixels);
  else
    fold_scalar_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(y),
                                                           static_cast<const T*>(gy), gs1, gs2,
                                                           static_cast<T*>(out), part, pixels, hw,
                                                           cout, block_pixels);
  bias_grad_kernel<<<(cout + 127) / 128, 128, 0, stream>>>(part, blocks, cout, db);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (y, gy and out share it). y, gy, out:
// (pixels = N*H*W, cout) contiguous and 16-byte aligned, any cout >= 1;
// vec: the 16-byte layout (cout a multiple of 16/sizeof(T), at most 256
// vectors), else element by element; gs1/gs2: (N,) f32; part: (blocks, cout) f32 scratch, blocks =
// ceil(pixels / block_pixels); db: (cout,) f32.
int lg_conv3x3_bwd_fold(int dtype, const void* y, const void* gy, const float* gs1,
                        const float* gs2, void* out, float* part, float* db, int64_t pixels,
                        int hw, int cout, int block_pixels, int blocks, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float>(y, gy, gs1, gs2, out, part, db, pixels, hw, cout, block_pixels, blocks, vec, s);
  else if (dtype == 1)
    e = launch<__nv_bfloat16>(y, gy, gs1, gs2, out, part, db, pixels, hw, cout, block_pixels, blocks,
                              vec, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
