// Where a norm kernel finds a sample's elements: contiguous, or the rows of
// an NHWC map inside a larger one. Included by norm_lrelu.cu and
// norm_lrelu_bwd.cu inside their anonymous namespaces, after kThreads,
// vec_elems and from_f32.
//
// TF SAME pads a stride-2 conv over an even map unevenly (one row and
// column before, two after), which cuDNN's symmetric padding cannot take,
// and crops a stride-2 transposed conv's full output the same way. So the
// encoder's norm writes its map inside that border (zeros around it, the
// buffer the next conv reads whole), its backward reads the interior of
// the conv's gradient of the whole buffer, the decoder's norm reads its map
// out of the transposed conv's full output, and its backward writes the
// gradient of the whole output (zeros around the interior): no pad, crop
// or copy between the conv and the norm. A sample's elements keep their
// order (the interior's row-major order), so every sum is taken in the
// same order as over a contiguous sample.

// Sample n's m elements, in elements: len > 0, rows of `len` contiguous
// elements `row` apart; len = 0, the sample contiguous. Samples `sample`
// apart. off >= 0 (an output): the sample is the interior of a padded
// sample of `sample` elements that starts `off` elements before it, and
// the launch writes zeros over the rest of the padded sample. magic and
// shift divide an element index by len (Granlund-Montgomery, for indices
// below 2^31).
struct Map {
  int64_t sample, row, off;
  uint32_t len, magic, shift;
};

// The map of a tensor from its four int64 (sample, row, len, off); null:
// a contiguous sample of m elements, no border.
inline Map make_map(const int64_t* d, int64_t m) {
  Map p{m, 0, -1, 0, 0, 0};
  if (d == nullptr) return p;
  p.sample = d[0];
  p.row = d[1];
  p.len = static_cast<uint32_t>(d[2]);
  p.off = d[3];
  if (p.len > 0) {
    uint32_t s = 0;
    while ((1ull << s) < p.len) ++s;
    p.shift = s;
    p.magic = static_cast<uint32_t>(((1ull << 32) * ((1ull << s) - p.len)) / p.len + 1);
  }
  return p;
}

// Whether 16-byte vectors of 8 bf16 (or two of 4 f32) cover the map's rows,
// samples and border whole.
inline bool map_vec(const Map& p) {
  return p.sample % 8 == 0 && p.row % 8 == 0 && p.len % 8 == 0 && (p.off < 0 || p.off % 8 == 0);
}

// The offset of element e (< 2^31) of sample n.
__device__ __forceinline__ int64_t at(const Map& p, int64_t n, uint32_t e) {
  if (p.len == 0) return n * p.sample + e;
  const uint32_t r = (__umulhi(e, p.magic) + e) >> p.shift;
  return n * p.sample + static_cast<int64_t>(r) * p.row + (e - r * p.len);
}

// Zeros over sample n's border where p has one (p.off >= 0): the head
// before the interior's first row, the gap after each row but the last,
// and the tail after the last row to the padded sample's end. Block `part`
// of the sample's `parts` blocks writes every parts-th run of kThreads
// vectors (elements where vec is 0).
template <typename T>
__device__ __forceinline__ void zero_border(T* y, const Map& p, int64_t n, int64_t m, int vec, int part,
                                            int parts) {
  if (p.off < 0) return;
  const int64_t u = vec ? vec_elems<T>() : 1;
  T* base = y + n * p.sample - p.off;
  const int64_t len = p.len ? p.len : m;
  const int64_t rows = m / len;
  const uint32_t gap = p.len ? static_cast<uint32_t>((p.row - p.len) / u) : 0u;
  const int64_t head = p.off / u, gaps = (rows - 1) * gap;
  const int64_t tail = p.off + (rows - 1) * p.row + len;
  const int64_t total = (p.sample - m) / u;
  for (int64_t j = static_cast<int64_t>(part) * kThreads + threadIdx.x; j < total;
       j += static_cast<int64_t>(parts) * kThreads) {
    int64_t e;
    if (j < head) {
      e = j * u;
    } else if (j - head < gaps) {
      const uint32_t k = static_cast<uint32_t>(j - head), r = k / gap;
      e = p.off + static_cast<int64_t>(r) * p.row + len + static_cast<int64_t>(k - r * gap) * u;
    } else {
      e = tail + (j - head - gaps) * u;
    }
    if (vec)
      *reinterpret_cast<uint4*>(base + e) = make_uint4(0u, 0u, 0u, 0u);
    else
      base[e] = from_f32<T>(0.f);
  }
}
