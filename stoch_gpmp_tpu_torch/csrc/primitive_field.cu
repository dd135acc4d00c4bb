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
// - Four points per thread, kPts = 4, dealt by warp and read through their
//   strides with 32-bit indices, one float2 load per aligned pair
//   (point_batch.cuh); every primitive read from shared memory (a float4
//   broadcast) feeds four tests with no dependence between them.
// - The points' loads are issued before the primitives are staged.
// - R = 0 or C = 0 is a loop count of zero (the TPU kernel pads an empty
//   class to one dummy row).
// Each test is exact on its rounded operands, so every step is an explicit
// IEEE round-to-nearest intrinsic: nvcc may not contract a product and a sum
// into one FMA here, and a point on a primitive's boundary counts as it does
// in the plain PyTorch version.

#include <cuda_runtime.h>

#include "point_batch.cuh"

namespace {

constexpr int kThreads = 128, kPts = 4;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    primitive_field_kernel(const float* __restrict__ pts, unsigned n, int L, FastDiv div_l, int sb,
                           int sl, int sc, const float* __restrict__ rects, int n_rects,
                           const float* __restrict__ circles, int n_circles,
                           float* __restrict__ out) {
  // the points first: their loads are in flight while the primitives are
  // staged
  const unsigned base = first_point<kThreads, kPts>();
  float x[kPts], y[kPts], acc[kPts] = {};
  load_points<kVec>(pts, base, n, L, div_l, sb, sl, sc, x, y);
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
  if (!points_fit_32_bits(B, L, sb, sl, sc) || n_rects < 0 || n_circles < 0)
    return (int)cudaErrorInvalidValue;
  const unsigned n = (unsigned)B * (unsigned)L;
  const bool vec = points_are_pairs(pts, sb, sl, sc);
  const int blocks = (int)((n + kThreads * kPts - 1) / (kThreads * kPts));
  const size_t smem = sizeof(float4) * (n_rects + n_circles);
  const FastDiv div_l = fast_div((unsigned)L);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    primitive_field_kernel<true><<<blocks, kThreads, smem, st>>>(
        pts, n, L, div_l, sb, sl, sc, rects, n_rects, circles, n_circles, out);
  else
    primitive_field_kernel<false><<<blocks, kThreads, smem, st>>>(
        pts, n, L, div_l, sb, sl, sc, rects, n_rects, circles, n_circles, out);
  return (int)cudaGetLastError();
}
