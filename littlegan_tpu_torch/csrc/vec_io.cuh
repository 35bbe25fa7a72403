// Loads and stores of whole vectors of an NHWC map's channels, with f32
// arithmetic on float or bf16 elements. Included by channel_norm_lrelu.cu
// and resample.cu inside their anonymous namespaces, after cuda_bf16.h,
// cuda_runtime.h and stdint.h.

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

// The integer type of one access of `Bytes` bytes: a 16-byte vector (8 bf16
// or 4 f32), or one element where the map is not aligned to vectors.
template <int Bytes>
struct RawOf;
template <>
struct RawOf<16> {
  using type = uint4;
};
template <>
struct RawOf<4> {
  using type = unsigned int;
};
template <>
struct RawOf<2> {
  using type = unsigned short;
};

// V elements of type T as one access.
template <typename T, int V>
using Raw = typename RawOf<sizeof(T) * V>::type;
