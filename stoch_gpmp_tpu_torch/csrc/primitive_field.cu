// Analytic primitive field: the count of rectangles and circles containing
// each query point.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/fields.py
// primitive_field_cost (_primitive_kernel):
//   count += [|x - cx| <= w/2 and |y - cy| <= h/2]      per rectangle
//   count += [(x - cx)^2 + (y - cy)^2 <= r^2]           per circle
//
// Bound on the H100: memory and launch latency. A point reads 8 bytes and
// writes 4, with about 6 operations per primitive (120,960 points and 15
// primitives per StochGPMP iteration at the planar parity shape). In the
// planner's [B, 64, 4] batch a point's (x, y) shares its 16 bytes with the
// velocities, and memory moves whole 32-byte sectors, so the card reads 16
// bytes per point of that view (20 with the write: 7.8 us at 1.31 M points
// against 4.7 us for 12 bytes). Design:
// - Four points per thread, kPts = 4, dealt by warp: lane j of a warp takes
//   points base + 32 k + j (k < 4), so each load and store instruction of
//   the warp covers 32 consecutive points; every primitive read from shared
//   memory (a float4 broadcast) feeds four tests with no dependence between
//   them.
// - The [B, L, 2] points are read through their strides; a point's (b, l)
//   comes from one 32-bit multiply-shift division by L (the launcher's
//   magic number, exact below 2^31), not a 64-bit division; the launcher
//   refuses a batch or an offset of 2^31 or more.
// - (x, y) is one float2 load where the coordinate stride is 1 and every
//   point is 8-byte aligned (the planner's [1920, 63, 2] slice of its
//   [1920, 64, 4] batch is); any other stride takes two scalar loads in the
//   same kernel.
// - R = 0 or C = 0 is a loop count of zero (the TPU kernel pads an empty
//   class to one dummy row).
// Each test is exact on its rounded operands, so every step is an explicit
// IEEE round-to-nearest intrinsic: nvcc may not contract a product and a sum
// into one FMA here, and a point on a primitive's boundary counts as it does
// in the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128, kPts = 4;

// floor(n / d) = (n * m) >> shift for every n < 2^31, with shift = 31 +
// ceil(log2 d) and m = ceil(2^shift / d) < 2^32 (Granlund and Montgomery).
struct FastDiv {
  unsigned m;
  int shift;
};

FastDiv fast_div(unsigned d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned long long p = 1ull << (31 + l);
  return FastDiv{(unsigned)((p + d - 1) / d), 31 + l};
}

__device__ __forceinline__ unsigned div_by(unsigned n, FastDiv f) {
  return (unsigned)(((unsigned long long)n * f.m) >> f.shift);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    primitive_field_kernel(const float* __restrict__ pts, unsigned n, int L, FastDiv div_l, int sb,
                           int sl, int sc, const float* __restrict__ rects, int n_rects,
                           const float* __restrict__ circles, int n_circles,
                           float* __restrict__ out) {
  // the points first: their loads are in flight while the primitives are
  // staged
  // unsigned: with n < 2^31 the last block's indices stay below 2^31 + 512
  const unsigned lane = threadIdx.x & 31;
  const unsigned base = (blockIdx.x * kThreads + (threadIdx.x & ~31u)) * kPts + lane;
  float x[kPts], y[kPts], acc[kPts];
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const unsigned idx = base + 32 * k;
    x[k] = y[k] = acc[k] = 0.0f;
    if (idx < n) {
      const unsigned b = div_by(idx, div_l), l = idx - b * (unsigned)L;
      const float* p = pts + ((int)b * sb + (int)l * sl);
      if constexpr (kVec) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        x[k] = v.x;
        y[k] = v.y;
      } else {
        x[k] = p[0];
        y[k] = p[sc];
      }
    }
  }
  extern __shared__ float4 prim[];  // [R] (cx, cy, w/2, h/2), then [C] (cx, cy, r^2, 0)
  for (int i = threadIdx.x; i < n_rects; i += kThreads) {
    const float* r = rects + 4 * i;
    prim[i] = make_float4(r[0], r[1], __fmul_rn(0.5f, r[2]), __fmul_rn(0.5f, r[3]));
  }
  for (int i = threadIdx.x; i < n_circles; i += kThreads) {
    const float* c = circles + 3 * i;
    prim[n_rects + i] = make_float4(c[0], c[1], __fmul_rn(c[2], c[2]), 0.0f);
  }
  __syncthreads();
  for (int r = 0; r < n_rects; ++r) {
    const float4 q = prim[r];
#pragma unroll
    for (int k = 0; k < kPts; ++k)
      if (fabsf(__fsub_rn(x[k], q.x)) <= q.z && fabsf(__fsub_rn(y[k], q.y)) <= q.w)
        acc[k] += 1.0f;
  }
  for (int c = 0; c < n_circles; ++c) {
    const float4 q = prim[n_rects + c];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      const float dx = __fsub_rn(x[k], q.x), dy = __fsub_rn(y[k], q.y);
      if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= q.z) acc[k] += 1.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < kPts; ++k)
    if (base + 32 * k < n) out[base + 32 * k] = acc[k];
}

}  // namespace

// points [B, L, 2] at strides (sb, sl, sc) in floats; B * L and every offset
// must be below 2^31 (the kernel's point indices are unsigned 32-bit).
extern "C" int primitive_field_launch(const float* pts, int B, int L, int sb, int sl, int sc,
                                      const float* rects, int n_rects, const float* circles,
                                      int n_circles, float* out, void* stream) {
  if (B < 1 || L < 1 || sb < 0 || sl < 0 || sc < 0 || n_rects < 0 || n_circles < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * L;
  const long long last = (long long)(B - 1) * sb + (long long)(L - 1) * sl + sc;
  if (n > 0x7fffffffLL || last > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = sc == 1 && sb % 2 == 0 && sl % 2 == 0 &&
                   reinterpret_cast<unsigned long long>(pts) % 8 == 0;
  const int blocks = (int)((n + kThreads * kPts - 1) / (kThreads * kPts));
  const size_t smem = sizeof(float4) * (n_rects + n_circles);
  const FastDiv div_l = fast_div((unsigned)L);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    primitive_field_kernel<true><<<blocks, kThreads, smem, st>>>(
        pts, (unsigned)n, L, div_l, sb, sl, sc, rects, n_rects, circles, n_circles, out);
  else
    primitive_field_kernel<false><<<blocks, kThreads, smem, st>>>(
        pts, (unsigned)n, L, div_l, sb, sl, sc, rects, n_rects, circles, n_circles, out);
  return (int)cudaGetLastError();
}
