// Raster collision field: count of rasterized obstacles covering each
// query point's snapped grid cell.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/fields.py
// raster_primitive_cost (_raster_kernel), op for op (raster_common.cuh).
//
// Bound on the H100: memory and launch latency. A point reads 8 bytes and
// writes 4, with R + C tests (10 rectangles and 5 circles at parity, ~121k
// points per call), so a call moves ~1.5 MB. Design:
// - Four points per thread, kPts = 4, dealt by warp and read through their
//   strides with 32-bit indices, one float2 load per aligned pair
//   (point_batch.cuh).
// - The points' loads are issued before the primitives are staged, so the
//   two overlap.
// - The rectangles sit in shared memory as int4 (x0, x1, y0, y1) and the
//   circles as float4 (cx, cy, bound, 0): every read is one broadcast that
//   feeds four tests with no dependence between them.
// - The circle test takes no square root per point: sqrt_rn is monotonic,
//   so sqrt_rn(s) <= r holds exactly when s <= sqrt_le_bound(r), the largest
//   float whose rounded square root is at most r, found once per circle
//   while the CTA stages it (below).
// - R = 0 or C = 0 needs no dummy rows.
// Each point is snapped by raster_common.cuh's raster_snap, and s =
// dx*dx + dy*dy is rounded step by step as raster_count rounds it, so a
// point counts as in the plain PyTorch version, the JAX package and K2.

#include <cuda_runtime.h>

#include "point_batch.cuh"
#include "raster_common.cuh"

namespace {

constexpr int kThreads = 128, kPts = 4;

// The largest float t with sqrt_rn(t) <= r: for every s >= 0 (a rounded sum
// of squares), [sqrt_rn(s) <= r] == [s <= t], NaN s or r included. Starts at
// fl(r * r), a few ulps from t, and steps to it one float at a time.
__device__ float sqrt_le_bound(float r) {
  if (isnan(r) || isinf(r)) return r;  // nothing, or everything but NaN, passes
  if (r < 0.0f) return -INFINITY;      // sqrt_rn(s) >= +0 > r (r = -0 passes s = +0)
  float t = __fmul_rn(r, r);
  while (t < INFINITY && __fsqrt_rn(nextafterf(t, INFINITY)) <= r) t = nextafterf(t, INFINITY);
  while (__fsqrt_rn(t) > r) t = nextafterf(t, -INFINITY);
  return t;
}

template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
    raster_field_kernel(const float* __restrict__ pts, unsigned n, int L, FastDiv div_l, int sb,
                        int sl, int sc, const int* __restrict__ rects, int n_rects,
                        const float* __restrict__ circles, int n_circles, float cell_size,
                        float inv_cell_size, int nx, int ny, float* __restrict__ out) {
  // the points first: their loads are in flight while the primitives are
  // staged
  const unsigned base = first_point<kThreads, kPts>();
  float x[kPts], y[kPts], acc[kPts] = {};
  load_points<kPairs>(pts, base, n, L, div_l, sb, sl, sc, x, y);
  extern __shared__ int4 prim[];  // [R] int4 rectangles, then [C] float4 circles
  float4* circ = reinterpret_cast<float4*>(prim + n_rects);
  for (int i = threadIdx.x; i < n_rects; i += kThreads) {
    const int* r = rects + 4 * i;
    prim[i] = make_int4(r[0], r[1], r[2], r[3]);
  }
  for (int i = threadIdx.x; i < n_circles; i += kThreads) {
    const float* c = circles + 3 * i;
    circ[i] = make_float4(c[0], c[1], sqrt_le_bound(c[2]), 0.0f);
  }
  const int ox = nx / 2, oy = ny / 2;
  int jc[kPts], ic[kPts];
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    jc[k] = raster_snap(x[k], inv_cell_size, ox, nx);
    ic[k] = raster_snap(y[k], inv_cell_size, oy, ny);
  }
  __syncthreads();
  for (int r = 0; r < n_rects; ++r) {
    const int4 q = prim[r];
#pragma unroll
    for (int k = 0; k < kPts; ++k)
      if (jc[k] >= q.x && jc[k] < q.y && ic[k] >= q.z && ic[k] < q.w) acc[k] += 1.0f;
  }
  if (n_circles) {
    float wx[kPts], wy[kPts];
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      wx[k] = __fmul_rn((float)(jc[k] - ox), cell_size);
      wy[k] = __fmul_rn((float)(ic[k] - oy), cell_size);
    }
    for (int c = 0; c < n_circles; ++c) {
      const float4 q = circ[c];
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        const float dx = __fsub_rn(wx[k], q.x), dy = __fsub_rn(wy[k], q.y);
        if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= q.z) acc[k] += 1.0f;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPts; ++k)
    if (base + 32 * k < n) out[base + 32 * k] = acc[k];
}

}  // namespace

// points [B, L, 2] at strides (sb, sl, sc) in floats; B * L and every offset
// must be below 2^31 (the kernel's point indices are unsigned 32-bit);
// rects [R, 4] int32 cell ranges (x0, x1, y0, y1), circles [C, 3] float32
// (cx, cy, r), both contiguous.
extern "C" int raster_field_launch(const float* pts, int B, int L, int sb, int sl, int sc,
                                   const int* rects, int n_rects, const float* circles,
                                   int n_circles, float cell_size, float inv_cell_size, int nx,
                                   int ny, float* out, void* stream) {
  if (!points_fit_32_bits(B, L, sb, sl, sc) || n_rects < 0 || n_circles < 0 || nx < 1 ||
      ny < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned n = (unsigned)B * (unsigned)L;
  const int blocks = (int)((n + kThreads * kPts - 1) / (kThreads * kPts));
  const size_t smem = sizeof(int4) * (n_rects + n_circles);
  const FastDiv div_l = fast_div((unsigned)L);
  const cudaStream_t st = (cudaStream_t)stream;
  if (points_are_pairs(pts, sb, sl, sc))
    raster_field_kernel<true><<<blocks, kThreads, smem, st>>>(
        pts, n, L, div_l, sb, sl, sc, rects, n_rects, circles, n_circles, cell_size,
        inv_cell_size, nx, ny, out);
  else
    raster_field_kernel<false><<<blocks, kThreads, smem, st>>>(
        pts, n, L, div_l, sb, sl, sc, rects, n_rects, circles, n_circles, cell_size,
        inv_cell_size, nx, ny, out);
  return (int)cudaGetLastError();
}

extern "C" const char* stoch_gpmp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
