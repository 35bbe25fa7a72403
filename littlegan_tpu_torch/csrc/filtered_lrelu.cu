// StyleGAN3's filtered LeakyReLU over NHWC maps, for Hopper (sm_90a): one
// kernel for the forward and one for the backward (S6), the same template
// in two modes. Along each axis a pass is
//
//     u[t]   = sum_a f1[a] xz[t + a - p0]           t in [0, T)
//     v[t]   = act(u[t])                            zero outside [0, T)
//     out[o] = sum_e f2[e] v[o * D + e + q0]        o in [0, O)
//
// with xz the input zero-inserted by U (and zero outside it). The forward
// (mode 0) reads the conv output y, forms y * d[n, c] + b[c], upsamples by
// U through fu (the gain up^2), applies lrelu(slope) * gain clamped at
// +-clamp, and downsamples by D through fd (q0 = 0); it writes the output
// and, for every intermediate sample, a 2-bit mask: whether the
// pre-activation was not above 0 and whether the clamp cut, 8 channels to a
// 16-bit word (the low byte the signs, the high byte the cuts). The
// backward (mode 1) is the adjoint: the gradient g up by D through fd
// (p0 = Kd - 1), times gain * up^2 and the slope where the mask's sign bit
// is set, zero where its cut bit is, then down by U through fu (q0 = p0 -
// Ku + 1); it writes gy = gx * d[n, c] and each block's f32 column sums of
// gx and gx * y (b's and d's gradients, added by the caller in one fixed
// order). ops/cuda/filtered_lrelu.py works out each axis's numbers; the
// filters are symmetric (Kaiser low-pass filters), so no flip is needed.
//
// Replaces no TPU kernel: the JAX package has no StyleGAN3. Added because
// the op's plain composition stores the upsampled intermediate and its
// pre-activation (up to 1074^2 x 144 channels a sample at 512^2), which at
// batch 32 would not fit the card; NVlabs wrote the op as a CUDA kernel for
// the same reason.
//
// How it runs: a block takes one sample, a tile of TO_h x TO_w outputs and
// 8 channels (the fastest index of the grid, so that the blocks of one
// tile read the same input lines from L2). The tile's input, the first
// pass's rows, the intermediate and the second pass's rows live in two
// shared-memory regions, float32, 8 channels innermost; every filter pass
// is separable, a thread filtering 4 (the up passes) or R2 (the down
// passes) neighbouring samples of one channel from registers, so that the
// up passes read ~K/U + 1 inputs for 4 outputs and touch none of the
// inserted zeros. Row pitches are odd multiples of 8 floats where a pass
// walks down rows, so the 4 positions of a warp fall in different banks.
// What bounds it: float32 arithmetic on the intermediate (two operations
// per nonzero tap), and the shared memory that feeds it.
//
// C interface for ctypes: pointers and the stream are void*, every function
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCh = 8;                // channels of a block, and of a mask word
constexpr int kPos = kThreads / kCh;  // positions one step of a pass takes
constexpr int kMaxTaps = 24;
constexpr int kGroupUp = 4;  // intermediate samples a thread filters at once

#include "vec_io.cuh"

struct AxisP {
  int L, p0, T, q0, O, to, tiles;
};

struct Params {
  const void* x;  // forward: y (n, hL, wL, C); backward: g (n, hL, wL, C)
  void* out;      // forward: the output; backward: gy, both (n, hO, wO, C)
  const float* d;
  const float* b;
  uint16_t* mask;   // (n, hT, wT, ncb)
  const void* yc;   // backward: y, for d's gradient (or null)
  float* part_b;    // backward: (n, tiles, C)
  float* part_d;    // backward: (n, tiles, C) or null
  int n, C, ncb;
  AxisP h, w;
  float f1[kMaxTaps], f2[kMaxTaps];
  float fgain, gain, slope, clamp;
  int sa, sb;  // floats per channel of the two shared-memory regions
};

__device__ __forceinline__ int pmod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// One axis of a block's tile: its outputs from o0, the intermediate samples
// it computes from ts (ts - p0 a multiple of U), their count trp (a
// multiple of kGroupUp), the inputs from i0 (ir of them) and the offset
// delta of the first output's window in the intermediate.
template <int U, int K1, int D, int K2>
struct Tile {
  int o0, ts, trp, i0, ir, delta;
  __device__ __forceinline__ Tile(const AxisP& a, int t) {
    o0 = t * a.to;
    const int ta = o0 * D + a.q0;
    ts = ta - pmod(ta - a.p0, U);
    delta = ta - ts;
    const int trn = delta + (a.to - 1) * D + K2;
    trp = (trn + kGroupUp - 1) / kGroupUp * kGroupUp;
    i0 = (ts - a.p0) / U;
    ir = (trp + K1 - 2) / U + 1;
  }
};

template <typename T, int MODE, int U, int K1, int D, int K2>
__global__ void __launch_bounds__(kThreads) filtered_lrelu_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ float red[2][kThreads / 32][kCh];
  constexpr int G1 = kGroupUp;
  constexpr int SP1 = (G1 - 1 + K1 - 1) / U + 1;  // inputs of G1 neighbouring up-pass outputs
  constexpr int R2 = D == 4 ? 2 : 4;              // outputs a thread takes in a down pass
  constexpr int SP2 = (R2 - 1) * D + K2;          // their window
  static_assert(G1 % U == 0, "the up group must hold whole input steps");
  float* const A = smem;
  float* const B = smem + p.sa * kCh;

  int bid = blockIdx.x;
  const int cb = bid % p.ncb;
  bid /= p.ncb;
  const int tw_i = bid % p.w.tiles;
  bid /= p.w.tiles;
  const int th_i = bid % p.h.tiles;
  const int n = bid / p.h.tiles;
  const Tile<U, K1, D, K2> th(p.h, th_i), tw(p.w, tw_i);
  const int tid = threadIdx.x, ch = tid % kCh, lp = tid / kCh;
  const int c = cb * kCh + ch;
  const bool cok = c < p.C;
  const int pitch_x = tw.ir, pitch_s1 = tw.ir | 1, pitch_v = tw.trp + 1;

  // 1. the input tile into A (the forward's y * d + b), zero outside the map
  {
    const T* x = static_cast<const T*>(p.x);
    float dc = 1.f, bc = 0.f;
    if (MODE == 0 && cok) {
      if (p.d != nullptr) dc = p.d[static_cast<int64_t>(n) * p.C + c];
      bc = p.b[c];
    }
    for (int pos = lp; pos < th.ir * tw.ir; pos += kPos) {
      const int r = pos / tw.ir, q = pos - r * tw.ir;
      const int gi = th.i0 + r, gj = tw.i0 + q;
      float v = 0.f;
      if (cok && gi >= 0 && gi < p.h.L && gj >= 0 && gj < p.w.L) {
        v = to_f32(x[((static_cast<int64_t>(n) * p.h.L + gi) * p.w.L + gj) * p.C + c]);
        if (MODE == 0) v = v * dc + bc;
      }
      A[(r * pitch_x + q) * kCh + ch] = v;
    }
  }
  __syncthreads();

  // 2. the up pass down the rows: A (ir_h x ir_w) -> B (trp_h x ir_w)
  for (int pos = lp; pos < th.trp / G1 * tw.ir; pos += kPos) {
    const int g = pos / tw.ir, q = pos - g * tw.ir;
    const float* src = A + ((g * (G1 / U)) * pitch_x + q) * kCh + ch;
    float in[SP1];
#pragma unroll
    for (int j = 0; j < SP1; ++j) in[j] = src[j * pitch_x * kCh];
#pragma unroll
    for (int r = 0; r < G1; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < K1; ++a)
        if ((r + a) % U == 0) acc += p.f1[a] * in[(r + a) / U];
      B[((g * G1 + r) * pitch_s1 + q) * kCh + ch] = acc;
    }
  }
  __syncthreads();

  // 3. the up pass along the columns and the activation: B -> A (trp_h x
  // trp_w). Every lane of a warp takes the same steps: the mask's words are
  // put together by ballots over the warp's 4 positions x 8 channels.
  {
    const int ng = tw.trp / G1, npos = th.trp * ng, lane = tid & 31;
    const int own_h0 = th.o0 * D, own_w0 = tw.o0 * D;
    const int own_h1 = th_i == p.h.tiles - 1 ? p.h.T : (th.o0 + p.h.to) * D;
    const int own_w1 = tw_i == p.w.tiles - 1 ? p.w.T : (tw.o0 + p.w.to) * D;
    for (int base = 0; base < npos; base += kPos) {
      const int pos = base + lp;
      const bool live = pos < npos;
      const int row = live ? pos % th.trp : 0, g = live ? pos / th.trp : 0;
      const float* src = B + (row * pitch_s1 + g * (G1 / U)) * kCh + ch;
      float in[SP1];
#pragma unroll
      for (int j = 0; j < SP1; ++j) in[j] = src[j * kCh];
      const int t_h = th.ts + row;
      const bool in_h = live && t_h >= 0 && t_h < p.h.T;
#pragma unroll
      for (int r = 0; r < G1; ++r) {
        float u = 0.f;
#pragma unroll
        for (int a = 0; a < K1; ++a)
          if ((r + a) % U == 0) u += p.f1[a] * in[(r + a) / U];
        const int t_w = tw.ts + g * G1 + r;
        const bool inside = in_h && t_w >= 0 && t_w < p.w.T;
        const int64_t word_at = ((static_cast<int64_t>(n) * p.h.T + t_h) * p.w.T + t_w) * p.ncb + cb;
        float v;
        if (MODE == 0) {
          const float z = u * p.fgain;
          const bool neg = !(z > 0.f);
          v = z * (neg ? p.gain * p.slope : p.gain);
          const bool cut = fabsf(v) > p.clamp;
          v = fminf(fmaxf(v, -p.clamp), p.clamp);
          const unsigned signs = __ballot_sync(0xffffffffu, inside && neg);
          const unsigned cuts = __ballot_sync(0xffffffffu, inside && cut);
          if (ch == 0 && inside && t_h >= own_h0 && t_h < own_h1 && t_w >= own_w0 && t_w < own_w1) {
            const int sh = lane & ~(kCh - 1);
            p.mask[word_at] = static_cast<uint16_t>(((signs >> sh) & 0xffu) | (((cuts >> sh) & 0xffu) << 8));
          }
        } else {
          const unsigned word = inside ? p.mask[word_at] : 0u;
          v = (word >> (kCh + ch)) & 1u ? 0.f : u * ((word >> ch) & 1u ? p.gain * p.slope : p.gain);
        }
        if (live) A[(row * pitch_v + g * G1 + r) * kCh + ch] = inside ? v : 0.f;
      }
    }
  }
  __syncthreads();

  // 4. the down pass down the rows: A -> B (to_h x trp_w)
  for (int pos = lp; pos < p.h.to / R2 * tw.trp; pos += kPos) {
    const int g = pos / tw.trp, q = pos - g * tw.trp;
    const float* src = A + ((g * R2 * D + th.delta) * pitch_v + q) * kCh + ch;
    float in[SP2];
#pragma unroll
    for (int j = 0; j < SP2; ++j) in[j] = src[j * pitch_v * kCh];
#pragma unroll
    for (int r = 0; r < R2; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < K2; ++e) acc += p.f2[e] * in[r * D + e];
      B[((g * R2 + r) * pitch_v + q) * kCh + ch] = acc;
    }
  }
  __syncthreads();

  // 5. the down pass along the columns, and the output
  float sum_b = 0.f, sum_d = 0.f;
  {
    T* out = static_cast<T*>(p.out);
    const T* yc = static_cast<const T*>(p.yc);
    const float dc = MODE == 1 && p.d != nullptr && cok ? p.d[static_cast<int64_t>(n) * p.C + c] : 1.f;
    for (int pos = lp; pos < p.h.to * (p.w.to / R2); pos += kPos) {
      const int row = pos % p.h.to, g = pos / p.h.to;
      const float* src = B + (row * pitch_v + g * R2 * D + tw.delta) * kCh + ch;
      float in[SP2];
#pragma unroll
      for (int j = 0; j < SP2; ++j) in[j] = src[j * kCh];
      const int oh = th.o0 + row;
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < K2; ++e) acc += p.f2[e] * in[r * D + e];
        const int ow = tw.o0 + g * R2 + r;
        if (!cok || oh >= p.h.O || ow >= p.w.O) continue;
        const int64_t at = ((static_cast<int64_t>(n) * p.h.O + oh) * p.w.O + ow) * p.C + c;
        if (MODE == 0) {
          out[at] = from_f32<T>(acc);
        } else {
          out[at] = from_f32<T>(acc * dc);
          sum_b += acc;
          if (p.part_d != nullptr) sum_d += acc * to_f32(yc[at]);
        }
      }
    }
  }
  if (MODE == 1) {  // the block's column sums, in one fixed order
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 8);
    sum_b += __shfl_xor_sync(0xffffffffu, sum_b, 16);
    sum_d += __shfl_xor_sync(0xffffffffu, sum_d, 8);
    sum_d += __shfl_xor_sync(0xffffffffu, sum_d, 16);
    if ((tid & 31) < kCh) {
      red[0][tid / 32][ch] = sum_b;
      red[1][tid / 32][ch] = sum_d;
    }
    __syncthreads();
    if (tid < kCh && cok) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int wi = 0; wi < kThreads / 32; ++wi) {
        s0 += red[0][wi][tid];
        s1 += red[1][wi][tid];
      }
      const int64_t at = (static_cast<int64_t>(n) * p.h.tiles * p.w.tiles + th_i * p.w.tiles + tw_i) * p.C + c;
      p.part_b[at] = s0;
      if (p.part_d != nullptr) p.part_d[at] = s1;
    }
  }
}

template <typename T, int MODE, int U, int K1, int D, int K2>
int launch(const Params& p, cudaStream_t st) {
  const auto kernel = filtered_lrelu_kernel<T, MODE, U, K1, D, K2>;
  const int smem = (p.sa + p.sb) * kCh * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = static_cast<int64_t>(p.ncb) * p.w.tiles * p.h.tiles * p.n;
  if (blocks <= 0) return 0;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int mode, int up, int k1, int down, int k2, const Params& p, cudaStream_t st) {
  if (mode == 0 && up == 2 && k1 == 12 && down == 2 && k2 == 12) return launch<T, 0, 2, 12, 2, 12>(p, st);
  if (mode == 0 && up == 4 && k1 == 24 && down == 2 && k2 == 12) return launch<T, 0, 4, 24, 2, 12>(p, st);
  if (mode == 1 && up == 2 && k1 == 12 && down == 2 && k2 == 12) return launch<T, 1, 2, 12, 2, 12>(p, st);
  if (mode == 1 && up == 2 && k1 == 12 && down == 4 && k2 == 24) return launch<T, 1, 2, 12, 4, 24>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One pass of the filtered LeakyReLU (mode 0 the forward, 1 the backward;
// see the top of this file), (up, k1, down, k2) the pass's factors and
// taps, dtype 0 float32, 1 bfloat16; per axis (rows, then columns) the
// input length, p0, the intermediate length, q0, the output length, the
// output tile and the tiles; f1 and f2 the filters (host arrays, copied into
// the launch's parameters); sa and sb the floats per channel of the two
// shared-memory regions.
int lg_filtered_lrelu(int dtype, int mode, int up, int k1, int down, int k2, const void* x, void* out,
                      const void* d, const void* b, void* mask, const void* yc, void* part_b, void* part_d, int n,
                      int C, int h_len, int h_p0, int h_t, int h_q0, int h_out, int h_tile, int h_tiles, int w_len,
                      int w_p0, int w_t, int w_q0, int w_out, int w_tile, int w_tiles, const float* f1,
                      const float* f2, float fgain, float gain, float slope, float clamp, int sa, int sb,
                      void* stream) {
  if (k1 > kMaxTaps || k2 > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.out = out;
  p.d = static_cast<const float*>(d);
  p.b = static_cast<const float*>(b);
  p.mask = static_cast<uint16_t*>(mask);
  p.yc = yc;
  p.part_b = static_cast<float*>(part_b);
  p.part_d = static_cast<float*>(part_d);
  p.n = n;
  p.C = C;
  p.ncb = (C + kCh - 1) / kCh;
  p.h = AxisP{h_len, h_p0, h_t, h_q0, h_out, h_tile, h_tiles};
  p.w = AxisP{w_len, w_p0, w_t, w_q0, w_out, w_tile, w_tiles};
  for (int i = 0; i < kMaxTaps; ++i) {
    p.f1[i] = i < k1 ? f1[i] : 0.f;
    p.f2[i] = i < k2 ? f2[i] : 0.f;
  }
  p.fgain = fgain;
  p.gain = gain;
  p.slope = slope;
  p.clamp = clamp;
  p.sa = sa;
  p.sb = sb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(mode, up, k1, down, k2, p, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(mode, up, k1, down, k2, p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
