// 3x3 stride-1 SAME conv + bias with fused per-sample stats, for Hopper (sm_90a).
//
// Replaces the Pallas kernel littlegan_tpu/ops/pallas/boundary_conv.py
// (_conv3x3_kernel / conv3x3_same_stats): encoder block1 in space-to-depth
// form, x (N, H, W, Cin<=16) NHWC, w (3, 3, Cin, Cout) HWIO, bias (Cout,).
// It writes y = conv(x, w) + bias in x's type and, from the f32 values
// before that cast, each sample's sum(y) and sum(y^2), which the instance
// norm that follows takes instead of a stats pass over y
// (lg_norm_lrelu_apply in norm_lrelu.cu).
//
// What bounds it on the H100: bytes. At the serve shape (8, 64, 64, 12) ->
// 64 channels it moves about 5 MB (y is 5/6 of it) for 0.45 GFLOP, far
// below the operations per byte at which the tensor cores would be the
// limit. The TPU kernel built a 144-wide im2col matrix per sample in VMEM
// for one MXU product; here each block owns a tile of output pixels x all
// Cout channels:
//
//   - it stages the (3*3*Cin) x Cout weights and its input rows plus a
//     one-pixel zero halo in shared memory, both as f32;
//   - each thread accumulates 4 pixels x 8 channels in f32 registers with a
//     plain FMA loop over the 9*Cin taps (no tensor cores yet: mma/wgmma and
//     TMA are later work), adds the bias, stores 8 channels per pixel as one
//     16-byte (bf16) or two 16-byte (f32) stores, neighbouring threads on
//     neighbouring channel groups and pixels;
//   - the block reduces its f32 sum(y), sum(y^2) to one partial;
//   - a second launch reduces each sample's partials in a fixed order (no
//     float atomics, so s1 and s2 are deterministic).
//
// C interface for ctypes: pointers and the stream are void*, the function
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;
constexpr int kChPerThread = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Store 8 f32 values as 8 elements of T at a 16-byte aligned address.
__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(dst) = out;
}

// Block geometry for a given Cout: Cout/8 channel groups, the rest of the
// 256 threads are pixel groups of kPixPerThread pixels each.
struct Tile {
  int ch_groups, pix_groups, pixels;
};

__host__ __device__ inline Tile tile_for(int cout) {
  const int cg = cout / kChPerThread;
  const int pg = kThreads / cg;
  return {cg, pg, pg * kPixPerThread};
}

// Rows of input a tile of `pixels` flat output pixels can touch, halo included.
__host__ __device__ inline int staged_rows(int pixels, int wd) {
  const int spanned = (pixels % wd == 0) ? pixels / wd : (pixels - 1) / wd + 2;
  return spanned + 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv3x3_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, T* __restrict__ y, float* __restrict__ psum,
                         float* __restrict__ psq, int h, int wd, int cin, int cout) {
  extern __shared__ float smem[];
  const Tile tile = tile_for(cout);
  const int rows = staged_rows(tile.pixels, wd);
  const int taps = 9 * cin;
  float* ws = smem;                 // [taps][cout]
  float* xs = smem + taps * cout;   // [rows][wd + 2][cin]

  const int64_t n = blockIdx.y;
  const int hw = h * wd;
  const int p0 = blockIdx.x * tile.pixels;
  const int r0 = p0 / wd - 1;  // global row of staged row 0

  for (int i = threadIdx.x; i < taps * cout; i += kThreads) ws[i] = to_f32(w[i]);
  const int row_elems = (wd + 2) * cin;
  const T* xn = x + n * hw * cin;
  for (int i = threadIdx.x; i < rows * row_elems; i += kThreads) {
    const int r = i / row_elems;
    const int rem = i - r * row_elems;
    const int col = rem / cin - 1;
    const int ci = rem - (col + 1) * cin;
    const int gr = r0 + r;
    float v = 0.f;
    if (gr >= 0 && gr < h && col >= 0 && col < wd) v = to_f32(xn[(gr * wd + col) * cin + ci]);
    xs[i] = v;
  }
  __syncthreads();

  const int cg = threadIdx.x % tile.ch_groups;
  const int pg = threadIdx.x / tile.ch_groups;
  const int co0 = cg * kChPerThread;
  int base[kPixPerThread];
  bool valid[kPixPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = p0 + pg + k * tile.pix_groups;
    valid[k] = p < hw;
    const int pr = p / wd, pc = p - (p / wd) * wd;
    // staged (row, col) of the tap (ky=0, kx=0): rows pr-1 and col pc-1
    base[k] = valid[k] ? ((pr - 1 - r0) * (wd + 2) + pc) * cin : 0;
  }

  float acc[kPixPerThread][kChPerThread];
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k)
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) acc[k][j] = 0.f;

  for (int ky = 0; ky < 3; ++ky) {
    for (int kx = 0; kx < 3; ++kx) {
      const int xoff = (ky * (wd + 2) + kx) * cin;
      const float* wt = ws + ((ky * 3 + kx) * cin) * cout + co0;
      for (int ci = 0; ci < cin; ++ci) {
        const float4 w0 = *reinterpret_cast<const float4*>(wt + ci * cout);
        const float4 w1 = *reinterpret_cast<const float4*>(wt + ci * cout + 4);
        const float wv[kChPerThread] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int k = 0; k < kPixPerThread; ++k) {
          const float xv = xs[base[k] + xoff + ci];
#pragma unroll
          for (int j = 0; j < kChPerThread; ++j) acc[k][j] = fmaf(xv, wv[j], acc[k][j]);
        }
      }
    }
  }

  float bv[kChPerThread];
#pragma unroll
  for (int j = 0; j < kChPerThread; ++j) bv[j] = to_f32(bias[co0 + j]);
  float s = 0.f, q = 0.f;
  T* yn = y + n * hw * cout;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    if (!valid[k]) continue;
    float v[kChPerThread];
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) {
      v[j] = acc[k][j] + bv[j];
      s += v[j];
      q += v[j] * v[j];
    }
    const int p = p0 + pg + k * tile.pix_groups;
    store8(yn + static_cast<int64_t>(p) * cout + co0, v);
  }

  __shared__ float red_s[kThreads / 32], red_q[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    q += __shfl_down_sync(0xffffffffu, q, o);
  }
  if ((threadIdx.x & 31) == 0) {
    red_s[threadIdx.x >> 5] = s;
    red_q[threadIdx.x >> 5] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tq = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) {
      ts += red_s[i];
      tq += red_q[i];
    }
    psum[n * gridDim.x + blockIdx.x] = ts;
    psq[n * gridDim.x + blockIdx.x] = tq;
  }
}

// One warp per sample: lane-strided sums of the tile partials, then a
// shuffle tree. Fixed order, so s1 and s2 are deterministic.
__global__ void reduce_partials_kernel(const float* __restrict__ psum,
                                       const float* __restrict__ psq, int parts,
                                       float* __restrict__ s1, float* __restrict__ s2) {
  const int64_t n = blockIdx.x;
  float s = 0.f, q = 0.f;
  for (int p = threadIdx.x; p < parts; p += 32) {
    s += psum[n * parts + p];
    q += psq[n * parts + p];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, o);
    q += __shfl_down_sync(0xffffffffu, q, o);
  }
  if (threadIdx.x == 0) {
    s1[n] = s;
    s2[n] = q;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, float* psum, float* psq,
                   float* s1, float* s2, int n, int h, int wd, int cin, int cout,
                   cudaStream_t stream) {
  const Tile tile = tile_for(cout);
  const int tiles = (h * wd + tile.pixels - 1) / tile.pixels;
  const size_t smem =
      sizeof(float) * (9 * cin * cout + staged_rows(tile.pixels, wd) * (wd + 2) * cin);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  conv3x3_stats_kernel<T><<<dim3(tiles, n), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), psum, psq, h, wd, cin, cout);
  reduce_partials_kernel<<<n, 32, 0, stream>>>(psum, psq, tiles, s1, s2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Output tiles per sample for (h, w, cout): the size of the partial buffers.
int lg_conv3x3_tiles(int h, int wd, int cout) {
  const Tile tile = tile_for(cout);
  return (h * wd + tile.pixels - 1) / tile.pixels;
}

// Dynamic shared memory one block needs, in bytes.
int lg_conv3x3_smem_bytes(int wd, int cin, int cout) {
  const Tile tile = tile_for(cout);
  return static_cast<int>(sizeof(float) *
                          (9 * cin * cout + staged_rows(tile.pixels, wd) * (wd + 2) * cin));
}

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and y share it). cout must be
// 8, 16, 32, 64 or 128; psum/psq: (n, tiles) f32 scratch; s1/s2: (n,) f32.
int lg_conv3x3_same_stats(int dtype, const void* x, const void* w, const void* b, void* y,
                          float* psum, float* psq, float* s1, float* s2, int n, int h, int wd,
                          int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(x, w, b, y, psum, psq, s1, s2, n, h, wd, cin, cout, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, w, b, y, psum, psq, s1, s2, n, h, wd, cin, cout, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
