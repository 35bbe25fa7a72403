// 3x3 stride-1 SAME conv + bias with fused per-sample stats, for Hopper (sm_90a).
//
// Replaces the Pallas kernel littlegan_tpu/ops/pallas/boundary_conv.py
// (_conv3x3_kernel / conv3x3_same_stats): encoder block1 in space-to-depth
// form, x (N, H, W, Cin<=16) NHWC, w (3, 3, Cin, Cout) HWIO, bias (Cout,),
// any Cout >= 1, as the Pallas kernel takes any.
// It writes y = conv(x, w) + bias in x's type and, from the f32 values
// before that cast, each sample's sum(y) and sum(y^2), which the instance
// norm that follows takes instead of a stats pass over y
// (lg_norm_lrelu_apply in norm_lrelu.cu).
//
// What bounds it on the H100: bytes. At the train shape (64, 64, 64, 12) ->
// 64 channels in bf16 it moves 40 MB (y is 5/6 of it, 12 us at 3.35 TB/s)
// for 3.6 GFLOP (4.8 with Cin padded to 16), 4-5 us on the tensor cores.
// The TPU kernel built a 144-wide im2col matrix per sample in VMEM for one
// MXU product. Two kernels here, routed by dtype:
//
// bf16: conv3x3_mma_kernel, an implicit GEMM on the tensor cores. M is
// output pixels, N is Cout, K is 9 taps x Cin padded to 16, so that each
// tap is exactly one k16 step of mma.sync.m16n8k16 (bf16 in, f32
// accumulate; bf16 x bf16 products are exact in f32, so only the order of
// summation differs from the plain version). A persistent grid (as many
// blocks as fit on the SMs) walks over tiles of 128 output pixels:
//
//   - each block packs the weights once into shared memory, per tap and
//     output channel 16 input channels contiguous (the .col B operand),
//     zero beyond Cin, 48 bytes apart so that ldmatrix has no bank
//     conflicts; the bias sits in registers;
//   - per tile it stages its input rows plus a one-pixel zero halo, each
//     pixel 16 channels (zero beyond Cin) at a 48-byte stride, so that the
//     16x16 A operand of a tap is one ldmatrix.x4 of 16 shifted pixel rows
//     (TMA cannot map the tensor: a 24-byte pixel stride breaks its 16-byte
//     stride rule; wgmma's shared-memory layouts do not fit a shifted 3x3
//     window, so mma.sync it is). The rows come in by cp.async, 8 bytes
//     of 4 channels at a time, into one of two buffers while the block
//     computes on the other; the halo and the channels past Cin are zeroed
//     once;
//   - 4 warps each own 32 pixels x 64 channels (8 warps for Cout 128) in
//     f32 registers; the epilogue adds the bias, takes the stats from the
//     f32 values, stages the bf16 tile in shared memory and writes it as
//     whole 16-byte vectors (a tile of 128 pixels is one contiguous run of
//     y);
//   - a tile takes one block barrier (its rows are in, the last tile's are
//     free); each warp then writes its own share of the tile to y and its
//     own f32 sum(y), sum(y^2) partial, behind warp barriers only.
//
// f32: conv3x3_stats_kernel, a plain FMA loop (tensor cores would mean
// TF32, which the f32 tolerance of 1e-5 rules out): a block owns 128
// output pixels x all Cout channels, stages the weights and its input
// rows with a zero halo in shared memory as f32, each thread accumulates
// 4 pixels x 8 channels and stores them as 16-byte vectors, and the block
// reduces its stats to one partial.
//
// Any Cout, in both: a block computes one Cout tile of ct = 8, 16, 32, 64
// or 128 channels (the least of these that holds Cout, or tiles of 128 for
// a Cout above 128 over a grid dimension of Cout tiles; the host picks ct,
// ops/cuda/boundary_conv.py::conv_plan). A tile's channels past Cout get
// zero weights and bias in shared memory; they stay out of the stores and
// of the stats. Where the one tile is the whole of Cout (8 ... 128, the
// model's 64 among them) the bf16 kernel is instantiated with every mask
// folded away (kExact); y's rows take 16-byte stores where Cout is a
// multiple of 8 (4 in f32), element stores elsewhere.
//
// Both end with a second launch that reduces each sample's partials (per
// pixel tile and Cout tile) in a fixed order (no float atomics, so s1 and
// s2 are deterministic).
//
// C interface for ctypes: pointers and the stream are void*, the function
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kPixPerThread = 4;
constexpr int kChPerThread = 8;

// Store 8 f32 values at a 16-byte aligned address.
__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Block geometry for a Cout tile of `ct` channels (8, 16, 32, 64 or 128):
// ct/8 channel groups, the rest of the 256 threads are pixel groups of
// kPixPerThread pixels each.
struct Tile {
  int ch_groups, pix_groups, pixels;
};

__host__ __device__ inline Tile tile_for(int ct) {
  const int cg = ct / kChPerThread;
  const int pg = kThreads / cg;
  return {cg, pg, pg * kPixPerThread};
}

// Rows of input a tile of `pixels` flat output pixels can touch, halo included.
__host__ __device__ inline int staged_rows(int pixels, int wd) {
  const int spanned = (pixels % wd == 0) ? pixels / wd : (pixels - 1) / wd + 2;
  return spanned + 2;
}

// grid (pixel tiles, n, Cout tiles): block (i, n, j) owns output pixels
// [i*pixels, +pixels) of sample n and channels [j*ct, +ct), the channels
// past cout zero weights and bias, kept out of y and of the stats.
__global__ void __launch_bounds__(kThreads)
    conv3x3_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ y, float* __restrict__ psum,
                         float* __restrict__ psq, int h, int wd, int cin, int cout, int ct) {
  extern __shared__ float smem[];
  const Tile tile = tile_for(ct);
  const int rows = staged_rows(tile.pixels, wd);
  const int taps = 9 * cin;
  float* ws = smem;               // [taps][ct]
  float* xs = smem + taps * ct;   // [rows][wd + 2][cin]

  const int64_t n = blockIdx.y;
  const int hw = h * wd;
  const int p0 = blockIdx.x * tile.pixels;
  const int r0 = p0 / wd - 1;  // global row of staged row 0
  const int cbase = blockIdx.z * ct;  // this block's first output channel

  for (int i = threadIdx.x; i < taps * ct; i += kThreads) {
    const int k = i / ct, c = cbase + i - (i / ct) * ct;
    ws[i] = c < cout ? w[k * cout + c] : 0.f;
  }
  const int row_elems = (wd + 2) * cin;
  const float* xn = x + n * hw * cin;
  for (int i = threadIdx.x; i < rows * row_elems; i += kThreads) {
    const int r = i / row_elems;
    const int rem = i - r * row_elems;
    const int col = rem / cin - 1;
    const int ci = rem - (col + 1) * cin;
    const int gr = r0 + r;
    float v = 0.f;
    if (gr >= 0 && gr < h && col >= 0 && col < wd) v = xn[(gr * wd + col) * cin + ci];
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
      const float* wt = ws + ((ky * 3 + kx) * cin) * ct + co0;
      for (int ci = 0; ci < cin; ++ci) {
        const float4 w0 = *reinterpret_cast<const float4*>(wt + ci * ct);
        const float4 w1 = *reinterpret_cast<const float4*>(wt + ci * ct + 4);
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

  const int gco = cbase + co0;  // this thread's first output channel
  float bv[kChPerThread];
#pragma unroll
  for (int j = 0; j < kChPerThread; ++j) bv[j] = gco + j < cout ? bias[gco + j] : 0.f;
  // 16-byte stores where the thread's 8 channels are all real and aligned
  const bool vec = (cout % 4 == 0) && gco + kChPerThread <= cout;
  float s = 0.f, q = 0.f;
  float* yn = y + n * hw * cout;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    if (!valid[k]) continue;
    float v[kChPerThread];
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) {
      v[j] = acc[k][j] + bv[j];
      if (gco + j < cout) {
        s += v[j];
        q += v[j] * v[j];
      }
    }
    const int p = p0 + pg + k * tile.pix_groups;
    float* dst = yn + static_cast<int64_t>(p) * cout + gco;
    if (vec) {
      store8(dst, v);
    } else {
#pragma unroll
      for (int j = 0; j < kChPerThread; ++j)
        if (gco + j < cout) dst[j] = v[j];
    }
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
    // (sample, Cout tile, pixel tile) row-major: a sample's partials are contiguous
    const int64_t part = (n * gridDim.z + blockIdx.z) * gridDim.x + blockIdx.x;
    psum[part] = ts;
    psq[part] = tq;
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

__host__ __device__ inline int fma_smem_bytes(int wd, int cin, int ct) {
  return static_cast<int>(sizeof(float)) *
         (9 * cin * ct + staged_rows(tile_for(ct).pixels, wd) * (wd + 2) * cin);
}

cudaError_t launch_fma(const float* x, const float* w, const float* b, float* y, float* psum,
                       float* psq, float* s1, float* s2, int n, int h, int wd, int cin, int cout,
                       int ct, cudaStream_t stream) {
  const Tile tile = tile_for(ct);
  const int tiles = (h * wd + tile.pixels - 1) / tile.pixels;
  const int ctiles = (cout + ct - 1) / ct;
  const int smem = fma_smem_bytes(wd, cin, ct);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(conv3x3_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  conv3x3_stats_kernel<<<dim3(tiles, n, ctiles), kThreads, smem, stream>>>(x, w, b, y, psum, psq, h, wd,
                                                                           cin, cout, ct);
  reduce_partials_kernel<<<n, 32, 0, stream>>>(psum, psq, tiles * ctiles, s1, s2);
  return cudaGetLastError();
}

// ---- bf16: implicit GEMM on the tensor cores ------------------------------

constexpr int kMmaPixels = 128;  // output pixels per tile (the GEMM's M per tile)
constexpr int kKPad = 16;        // Cin padded to one k16 step per tap
constexpr int kRowStride = 24;   // bf16 per staged pixel and per packed weight row (48 B)
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block can have

// Warps along Cout: a warp holds at most 64 output channels.
__host__ __device__ constexpr int mma_warps_n(int cout) { return cout > 64 ? 2 : 1; }

// A block computes one Cout tile of COUT channels (8, 16, 32, 64 or 128).
template <int COUT>
struct MmaCfg {
  static constexpr int kWarpsN = mma_warps_n(COUT);
  static constexpr int kWarpsM = 4;
  static constexpr int kWarps = kWarpsM * kWarpsN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kWarpPixels = kMmaPixels / kWarpsM;  // 32: two m16 tiles
  static constexpr int kMT = kWarpPixels / 16;
  static constexpr int kWarpCout = COUT / kWarpsN;          // at most 64
  static constexpr int kNT = kWarpCout / 8;                 // n8 tiles per warp
  static constexpr int kYStride = COUT + 8;                 // bf16 per pixel of the staged y tile
};

__host__ __device__ inline int mma_cols(int wd) { return wd + 2; }

// Dynamic shared memory of one block: packed weights, `nbuf` buffers of
// staged input rows, staged y tile (bf16).
__host__ __device__ inline int mma_smem_bytes(int wd, int cout, int nbuf) {
  return 2 * (9 * cout * kRowStride + nbuf * staged_rows(kMmaPixels, wd) * mma_cols(wd) * kRowStride +
              kMmaPixels * (cout + 8));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 bytes global -> shared without registers; src_bytes < 8 zero-fills.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One pixel's cin channels from global memory as 16 bf16 (zero beyond
// cin) in two 16-byte vectors, element by element (cin odd or x not
// 8-byte aligned).
__device__ __forceinline__ void load_pixel(const __nv_bfloat16* src, int cin, uint4& lo, uint4& hi) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  uint32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = pack_bf16(2 * j < cin ? src[2 * j] : zero, 2 * j + 1 < cin ? src[2 * j + 1] : zero);
  lo = make_uint4(v[0], v[1], v[2], v[3]);
  hi = make_uint4(v[4], v[5], v[6], v[7]);
}

// COUT: the Cout tile, blockIdx.y which one. kExact: the tile is the whole
// of Cout (cout == COUT, grid.y 1), and every mask below folds away; else
// channels cbase + [0, COUT) past cout have zero weights and bias and stay
// out of y and the stats, and y's rows are cout wide.
template <int COUT, bool kExact>
__global__ void __launch_bounds__(MmaCfg<COUT>::kThreads)
    conv3x3_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                       float* __restrict__ psum, float* __restrict__ psq, int n, int h, int wd,
                       int cin, int cout_arg, int tiles_per_sample, int nbuf) {
  using C = MmaCfg<COUT>;
  const int cout = kExact ? COUT : cout_arg;  // y's row length and w's
  const int cbase = kExact ? 0 : static_cast<int>(blockIdx.y) * COUT;
  auto real = [&](int c) { return kExact || cbase + c < cout; };
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cols = mma_cols(wd);
  const int rows = staged_rows(kMmaPixels, wd);
  const int xs_elems = rows * cols * kRowStride;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [9][COUT][kRowStride]
  __nv_bfloat16* xs0 = ws + 9 * COUT * kRowStride;                  // nbuf x [rows][cols][kRowStride]
  __nv_bfloat16* ys = xs0 + nbuf * xs_elems;                        // [kMmaPixels][kYStride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp % C::kWarpsM, warp_n = warp / C::kWarpsM;

  // This thread's output channels in the accumulator layout: co, co + 1 of
  // each n8 tile.
  const int g = lane >> 2, tq = lane & 3;
  float b0[C::kNT], b1[C::kNT];
#pragma unroll
  for (int nt = 0; nt < C::kNT; ++nt) {
    const int co = warp_n * C::kWarpCout + nt * 8 + 2 * tq;
    b0[nt] = real(co) ? __bfloat162float(bias[cbase + co]) : 0.f;
    b1[nt] = real(co + 1) ? __bfloat162float(bias[cbase + co + 1]) : 0.f;
  }
  // ldmatrix row addresses of the B operand: matrices (n 0-7, k 0-7),
  // (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) from lanes 0-7,
  // 8-15, 16-23, 24-31.
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;
  const uint32_t b_base = smem_u32(ws + (warp_n * C::kWarpCout + b_n) * kRowStride + b_k);

  const int hw = h * wd;
  // cin % 4 == 0 and x 8-byte aligned: 8-byte pieces of 4 channels by
  // cp.async; else plain loads and shared stores
  const bool async = (cin % 4 == 0) && ((reinterpret_cast<uintptr_t>(x) & 7) == 0);
  const int total = n * tiles_per_sample;
  // The halo columns and channels past cin stay zero from here on; every
  // tile writes the rest.
  for (int i = tid; i < nbuf * xs_elems / 8; i += C::kThreads)
    reinterpret_cast<uint4*>(xs0)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // Stage tile t's input rows r0 .. r0 + rows - 1 (zero outside the image)
  // into dst: staged column c + 1 is image column c.
  auto stage = [&](int t, __nv_bfloat16* dst) {
    const int sample = t / tiles_per_sample;
    const int r0 = (t - sample * tiles_per_sample) * kMmaPixels / wd - 1;
    const __nv_bfloat16* xn = x + static_cast<int64_t>(sample) * hw * cin;
    for (int r = 0; r < rows; ++r) {
      const int gr = r0 + r;
      const bool in = gr >= 0 && gr < h;
      const __nv_bfloat16* src = xn + static_cast<int64_t>(in ? gr : 0) * wd * cin;
      __nv_bfloat16* row = dst + (r * cols + 1) * kRowStride;
      if (async) {
        for (int i = tid; i < wd * 4; i += C::kThreads) {
          const int c = i >> 2, j = (i & 3) * 4;
          if (j < cin) cp_async8(smem_u32(row + c * kRowStride + j), src + c * cin + j, in ? 8 : 0);
        }
      } else {
        for (int c = tid; c < wd; c += C::kThreads) {
          uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
          if (in) load_pixel(src + c * cin, cin, lo, hi);
          uint4* d = reinterpret_cast<uint4*>(row + c * kRowStride);
          d[0] = lo;
          d[1] = hi;
        }
      }
    }
  };

  // With two buffers the next tile's rows load while this one computes;
  // with one (wide rows), while this tile's y is written out.
  int buf = 0;
  if (blockIdx.x < total) stage(blockIdx.x, xs0);
  cp_async_commit();
  // Weights, once per block, while the first rows load: ws[tap][co][k] =
  // w[tap][k][cbase + co] (w is (9*cin, cout) row-major), zero for k >= cin
  // and for channels past cout.
  {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int row = tid; row < 9 * COUT; row += C::kThreads) {
      const int tap = row / COUT, co = row - tap * COUT;
      const int kin = real(co) ? cin : 0;
      const __nv_bfloat16* wt = w + tap * cin * cout + cbase + co;
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = pack_bf16(2 * j < kin ? wt[2 * j * cout] : zero, 2 * j + 1 < kin ? wt[(2 * j + 1) * cout] : zero);
      uint4* d = reinterpret_cast<uint4*>(ws + row * kRowStride);
      d[0] = make_uint4(v[0], v[1], v[2], v[3]);
      d[1] = make_uint4(v[4], v[5], v[6], v[7]);
    }
  }
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int next = t + gridDim.x;
    __nv_bfloat16* xs = xs0 + buf * xs_elems;
    cp_async_wait_all();
    // The one block barrier of a tile: its rows are in, and every warp is
    // done with the last tile's, so the other buffer may take the next.
    __syncthreads();
    if (nbuf == 2) {
      if (next < total) stage(next, xs0 + (buf ^ 1) * xs_elems);
      cp_async_commit();
    }
    const int sample = t / tiles_per_sample;
    const int p0 = (t - sample * tiles_per_sample) * kMmaPixels;
    const int r0 = p0 / wd - 1;  // global row of staged row 0

    // A operand: lane l gives the address of pixel row (l & 15) of its m16
    // tile, channels (l >> 4) * 8 .. +7; tap (ky, kx) shifts it by
    // ky rows and kx pixels. Pixels past the sample's end read a valid
    // staged pixel; their results are dropped.
    uint32_t a_base[C::kMT];
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
      int p = p0 + warp_m * C::kWarpPixels + mt * 16 + (lane & 15);
      if (p >= hw) p = p0;
      const int pr = p / wd, pc = p - pr * wd;
      a_base[mt] = smem_u32(xs + ((pr - 1 - r0) * cols + pc) * kRowStride + (lane >> 4) * 8);
    }
    float acc[C::kMT][C::kNT][4];
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap - ky * 3;
      const uint32_t a_off = static_cast<uint32_t>((ky * cols + kx) * kRowStride * 2);
      uint32_t a[C::kMT][4];
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt) ldmatrix_x4(a[mt], a_base[mt] + a_off);
      uint32_t b[C::kNT][2];
      const uint32_t b_tap = b_base + static_cast<uint32_t>(tap * COUT * kRowStride * 2);
      if constexpr (C::kNT == 1) {
        ldmatrix_x2(b[0], b_tap);
      } else {
#pragma unroll
        for (int nt = 0; nt < C::kNT; nt += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, b_tap + static_cast<uint32_t>(nt * 8 * kRowStride * 2));
          b[nt][0] = r[0];
          b[nt][1] = r[1];
          b[nt + 1][0] = r[2];
          b[nt + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < C::kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
    if (nbuf == 1) {  // one buffer: the next rows load once every warp is done with these
      __syncthreads();
      if (next < total) stage(next, xs0);
      cp_async_commit();
    } else {
      buf ^= 1;
    }

    // Epilogue, per warp: bias, stats from the f32 values, the warp's bf16
    // pixels x channels to its own part of the staged y tile, then out to y
    // as whole 16-byte vectors (the tile's pixels are one contiguous run of
    // y, a warp's share of each pixel 16-byte aligned).
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pl = warp_m * C::kWarpPixels + mt * 16 + g + half * 8;
        const bool valid = p0 + pl < hw;
#pragma unroll
        for (int nt = 0; nt < C::kNT; ++nt) {
          const float v0 = acc[mt][nt][2 * half] + b0[nt];
          const float v1 = acc[mt][nt][2 * half + 1] + b1[nt];
          const int co = warp_n * C::kWarpCout + nt * 8 + 2 * tq;
          if (kExact) {
            if (valid) {
              s += v0 + v1;
              q += v0 * v0 + v1 * v1;
            }
          } else {
            if (valid && real(co)) {
              s += v0;
              q += v0 * v0;
            }
            if (valid && real(co + 1)) {
              s += v1;
              q += v1 * v1;
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(ys + pl * C::kYStride + co) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    __syncwarp();
    constexpr int kVecs = C::kWarpCout / 8;  // 16-byte vectors of a pixel's warp share
    __nv_bfloat16* yt = y + (static_cast<int64_t>(sample) * hw + p0) * cout + cbase;
    for (int i = lane; i < C::kWarpPixels * kVecs; i += 32) {
      const int pl = warp_m * C::kWarpPixels + i / kVecs;
      const int c8 = warp_n * C::kWarpCout + (i % kVecs) * 8;
      if (p0 + pl >= hw || !real(c8)) continue;
      if (kExact || cout % 8 == 0) {  // whole, 16-byte aligned vectors
        *reinterpret_cast<uint4*>(yt + static_cast<int64_t>(pl) * cout + c8) =
            *reinterpret_cast<const uint4*>(ys + pl * C::kYStride + c8);
      } else {
        for (int j = 0; j < 8 && real(c8 + j); ++j)
          yt[static_cast<int64_t>(pl) * cout + c8 + j] = ys[pl * C::kYStride + c8 + j];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, o);
      q += __shfl_down_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {  // (sample, pixel tile, Cout tile, warp) row-major
      const int64_t part = (static_cast<int64_t>(t) * gridDim.y + blockIdx.y) * C::kWarps + warp;
      psum[part] = s;
      psq[part] = q;
    }
  }
  cp_async_wait_all();
}

int g_sms = 0;  // SMs of the device, read once

// Staging buffers of the bf16 kernel: two where they fit beside the rest.
__host__ __device__ inline int mma_nbuf(int wd, int ct) { return mma_smem_bytes(wd, ct, 2) <= kMaxSmem ? 2 : 1; }

template <int COUT, bool kExact>
cudaError_t launch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* b,
                       __nv_bfloat16* y, float* psum, float* psq, float* s1, float* s2, int n, int h,
                       int wd, int cin, int cout, cudaStream_t stream) {
  using C = MmaCfg<COUT>;
  const auto kernel = conv3x3_mma_kernel<COUT, kExact>;
  const int tiles = (h * wd + kMmaPixels - 1) / kMmaPixels;
  const int ctiles = (cout + COUT - 1) / COUT;
  const int nbuf = mma_nbuf(wd, COUT);
  const int smem = mma_smem_bytes(wd, COUT, nbuf);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (g_sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // persistent blocks, as many as fit on the SMs, shared out over the Cout tiles
  const int grid = std::min(n * tiles, std::max(1, g_sms * per_sm / ctiles));
  kernel<<<dim3(grid, ctiles), C::kThreads, smem, stream>>>(x, w, b, y, psum, psq, n, h, wd, cin, cout,
                                                            tiles, nbuf);
  reduce_partials_kernel<<<n, 32, 0, stream>>>(psum, psq, tiles * ctiles * C::kWarps, s1, s2);
  return cudaGetLastError();
}

template <int COUT>
cudaError_t launch_tile(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* b,
                        __nv_bfloat16* y, float* psum, float* psq, float* s1, float* s2, int n, int h,
                        int wd, int cin, int cout, cudaStream_t stream) {
  return cout == COUT ? launch_mma<COUT, true>(x, w, b, y, psum, psq, s1, s2, n, h, wd, cin, cout, stream)
                      : launch_mma<COUT, false>(x, w, b, y, psum, psq, s1, s2, n, h, wd, cin, cout, stream);
}

cudaError_t launch_bf16(const void* x, const void* w, const void* b, void* y, float* psum, float* psq,
                        float* s1, float* s2, int n, int h, int wd, int cin, int cout, int ct,
                        cudaStream_t stream) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bb = static_cast<const __nv_bfloat16*>(b);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  switch (ct) {
    case 8: return launch_tile<8>(xb, wb, bb, yb, psum, psq, s1, s2, n, h, wd, cin, cout, stream);
    case 16: return launch_tile<16>(xb, wb, bb, yb, psum, psq, s1, s2, n, h, wd, cin, cout, stream);
    case 32: return launch_tile<32>(xb, wb, bb, yb, psum, psq, s1, s2, n, h, wd, cin, cout, stream);
    case 64: return launch_tile<64>(xb, wb, bb, yb, psum, psq, s1, s2, n, h, wd, cin, cout, stream);
    case 128: return launch_tile<128>(xb, wb, bb, yb, psum, psq, s1, s2, n, h, wd, cin, cout, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool tile_ok(int cout, int ct) {
  return (ct == 8 || ct == 16 || ct == 32 || ct == 64 || ct == 128) && cout >= 1;
}

}  // namespace

extern "C" {

// The host side's plan (ops/cuda/boundary_conv.py::conv_plan) computes
// these two as well; chip_smoke.py holds it to them.
// Stats partials per sample for (dtype, h, w, cout, Cout tile ct): the
// size of the partial buffers. dtype: 0 = float32 (FMA kernel: one per
// pixel tile and Cout tile), 1 = bfloat16 (tensor cores: one per pixel
// tile, Cout tile and warp).
int lg_conv3x3_partials(int dtype, int h, int wd, int cout, int ct) {
  const int ctiles = (cout + ct - 1) / ct;
  if (dtype == 1) return (h * wd + kMmaPixels - 1) / kMmaPixels * ctiles * 4 * mma_warps_n(ct);  // kWarps
  const int pixels = tile_for(ct).pixels;
  return (h * wd + pixels - 1) / pixels * ctiles;
}

// Dynamic shared memory one block of a launch takes, in bytes.
int lg_conv3x3_smem_bytes(int dtype, int wd, int cin, int ct) {
  if (dtype == 1) return mma_smem_bytes(wd, ct, mma_nbuf(wd, ct));
  return fma_smem_bytes(wd, cin, ct);
}

// dtype: 0 = float32, 1 = bfloat16 (x, w, b and y share it). cin <= 16,
// any cout >= 1, computed in Cout tiles of ct (8, 16, 32, 64 or 128)
// channels; psum/psq: (n, lg_conv3x3_partials) f32 scratch; s1/s2: (n,)
// f32. bfloat16 needs y 16-byte aligned.
int lg_conv3x3_same_stats(int dtype, const void* x, const void* w, const void* b, void* y,
                          float* psum, float* psq, float* s1, float* s2, int n, int h, int wd,
                          int cin, int cout, int ct, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!tile_ok(cout, ct)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch_fma(static_cast<const float*>(x), static_cast<const float*>(w),
                                       static_cast<const float*>(b), static_cast<float*>(y), psum, psq,
                                       s1, s2, n, h, wd, cin, cout, ct, s));
  if (dtype == 1)
    return static_cast<int>(launch_bf16(x, w, b, y, psum, psq, s1, s2, n, h, wd, cin, cout, ct, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
