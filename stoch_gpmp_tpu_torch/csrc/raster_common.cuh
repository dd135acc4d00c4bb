// The raster collision rule at one point, shared by raster_field.cu and
// fused_planar_step.cu (the TPU kernels share it the same way:
// ops/pallas/fields.py _raster_kernel and ops/pallas/fused_step.py).
//
//   jc = clamp(floor(fma(x, inv_cell_size, nx/2)), 0, nx-1)   (and ic for y)
//   count += [x0 <= jc < x1 and y0 <= ic < y1]          per rectangle
//   count += [sqrt(dx*dx + dy*dy) <= r]                per circle, on the
//            snapped cell's world point ((jc - nx/2) * cell_size, ...)
//
// The TPU kernel writes floor(x / cell_size + nx/2); XLA compiles that as
// a fused multiply-add by the constant's reciprocal, rounded to the working
// precision, and so does this port: inv_cell_size is
// float32(1 / float32(cell_size)), computed by the caller. Every rounding
// step is an explicit IEEE round-to-nearest intrinsic (no other multiply-add
// is contracted), so a point on a cell edge lands in the same cell as in the
// plain PyTorch version and in the JAX package. The clamp runs on the
// floored float before the int conversion, which equals clamping the int
// for every coordinate inside the int range.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ int raster_snap(float v, float inv_cell_size,
                                           int origin, int n) {
  float f = floorf(__fmaf_rn(v, inv_cell_size, (float)origin));
  f = fminf(fmaxf(f, 0.0f), (float)(n - 1));
  return (int)f;
}

__device__ __forceinline__ float raster_count(float x, float y, const int* rects,
                                              int n_rects, const float* circles,
                                              int n_circles, float cell_size,
                                              float inv_cell_size, int nx, int ny) {
  const int ox = nx / 2, oy = ny / 2;
  const int jc = raster_snap(x, inv_cell_size, ox, nx);
  const int ic = raster_snap(y, inv_cell_size, oy, ny);
  float acc = 0.0f;
  for (int r = 0; r < n_rects; ++r) {
    const int* rb = rects + 4 * r;
    if (jc >= rb[0] && jc < rb[1] && ic >= rb[2] && ic < rb[3]) acc += 1.0f;
  }
  if (n_circles) {
    const float wx = __fmul_rn((float)(jc - ox), cell_size);
    const float wy = __fmul_rn((float)(ic - oy), cell_size);
    for (int c = 0; c < n_circles; ++c) {
      const float dx = __fsub_rn(wx, circles[3 * c]);
      const float dy = __fsub_rn(wy, circles[3 * c + 1]);
      const float d =
          __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      if (d <= circles[3 * c + 2]) acc += 1.0f;
    }
  }
  return acc;
}
