// The point batch shared by the 2D field kernels K1 (raster_field.cu), K10
// (grid_lookup.cu) and K11 (primitive_field.cu): points [B, L, 2] read
// through their strides (the planner passes a strided slice of its sample
// batch, so no copy is made), kPoints per thread dealt by warp.
// - Lane j of a warp takes points base + 32 k + j (k < kPoints), so each
//   load and store instruction of the warp covers 32 consecutive points.
// - A point's (b, l) comes from one 32-bit multiply-shift division by L
//   (FastDiv, exact below 2^31), not a 64-bit division; the launchers refuse
//   a batch or an offset of 2^31 or more (points_fit_32_bits), so every
//   index and offset is a 32-bit integer.
// - (x, y) is one float2 load where the coordinate stride is 1 and every
//   point is 8-byte aligned (the planner's [1920, 63, 2] slice of its
//   [1920, 64, 4] batch is: points_are_pairs); any other stride takes two
//   scalar loads.
#pragma once

#include <cuda_runtime.h>

// floor(n / d) = (n * m) >> shift for every n < 2^31, with shift = 31 +
// ceil(log2 d) and m = ceil(2^shift / d) < 2^32 (Granlund and Montgomery).
struct FastDiv {
  unsigned m;
  int shift;
};

inline FastDiv fast_div(unsigned d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned long long p = 1ull << (31 + l);
  return FastDiv{(unsigned)((p + d - 1) / d), 31 + l};
}

__device__ __forceinline__ unsigned div_by(unsigned n, FastDiv f) {
  return (unsigned)(((unsigned long long)n * f.m) >> f.shift);
}

// Whether B * L points at strides (sb, sl, sc) in floats have a count and a
// largest offset below 2^31.
inline bool points_fit_32_bits(int B, int L, int sb, int sl, int sc) {
  if (B < 1 || L < 1 || sb < 0 || sl < 0 || sc < 0) return false;
  const long long n = (long long)B * L;
  const long long last = (long long)(B - 1) * sb + (long long)(L - 1) * sl + sc;
  return n <= 0x7fffffffLL && last <= 0x7fffffffLL;
}

// Whether every point's (x, y) is one aligned float2.
inline bool points_are_pairs(const float* pts, int sb, int sl, int sc) {
  return sc == 1 && sb % 2 == 0 && sl % 2 == 0 &&
         reinterpret_cast<unsigned long long>(pts) % 8 == 0;
}

// The first point of this thread: points base + 32 k (k < kPoints) are its.
template <int kThreads, int kPoints>
__device__ __forceinline__ unsigned first_point() {
  // unsigned: with n < 2^31 the last block's indices stay below 2^31 + 32 kThreads kPoints
  return (blockIdx.x * kThreads + (threadIdx.x & ~31u)) * kPoints + (threadIdx.x & 31);
}

// The thread's points (x, y), (0, 0) past the last of the n points. Only
// loads: the caller issues them before anything that would wait on them.
template <bool kPairs, int kPoints>
__device__ __forceinline__ void load_points(const float* __restrict__ pts, unsigned base,
                                            unsigned n, int L, FastDiv div_l, int sb, int sl,
                                            int sc, float (&x)[kPoints], float (&y)[kPoints]) {
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const unsigned idx = base + 32 * k;
    x[k] = y[k] = 0.0f;
    if (idx < n) {
      const unsigned b = div_by(idx, div_l), l = idx - b * (unsigned)L;
      const float* p = pts + ((int)b * sb + (int)l * sl);
      if constexpr (kPairs) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        x[k] = v.x;
        y[k] = v.y;
      } else {
        x[k] = p[0];
        y[k] = p[sc];
      }
    }
  }
}
