// Raster collision field: count of rasterized obstacles covering each
// query point's snapped grid cell.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/fields.py
// raster_primitive_cost (_raster_kernel), op for op (raster_common.cuh).
//
// Bound on the H100: memory and launch latency. A point reads 8 bytes and
// writes 4, with R + C compares (25 at parity, ~121k points per call), so a
// call moves ~1.5 MB. Design: one thread per point; the [B, L, 2] points are
// read through their strides (the planner passes a strided slice of the
// sample batch, so no copy is made); rectangles and circles sit in shared
// memory; R = 0 or C = 0 needs no dummy rows.

#include <cuda_runtime.h>

#include "raster_common.cuh"

__global__ void raster_field_kernel(const float* __restrict__ pts, long long B,
                                    long long L, long long sb, long long sl,
                                    long long sc, const int* __restrict__ rects,
                                    int n_rects, const float* __restrict__ circles,
                                    int n_circles, float cell_size,
                                    float inv_cell_size, int nx, int ny,
                                    float* __restrict__ out) {
  extern __shared__ float smem[];
  int* s_rects = reinterpret_cast<int*>(smem);
  float* s_circles = smem + 4 * n_rects;
  for (int i = threadIdx.x; i < 4 * n_rects; i += blockDim.x) s_rects[i] = rects[i];
  for (int i = threadIdx.x; i < 3 * n_circles; i += blockDim.x) s_circles[i] = circles[i];
  __syncthreads();
  const long long n = B * L;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / L, l = idx - b * L;
    const float* p = pts + b * sb + l * sl;
    out[idx] = raster_count(p[0], p[sc], s_rects, n_rects, s_circles, n_circles,
                            cell_size, inv_cell_size, nx, ny);
  }
}

extern "C" int raster_field_launch(const float* pts, long long B, long long L,
                                   long long sb, long long sl, long long sc,
                                   const int* rects, int n_rects,
                                   const float* circles, int n_circles,
                                   float cell_size, float inv_cell_size, int nx,
                                   int ny, float* out, void* stream) {
  const int threads = 256;
  long long blocks = (B * L + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  const size_t smem = sizeof(float) * (4 * n_rects + 3 * n_circles);
  raster_field_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      pts, B, L, sb, sl, sc, rects, n_rects, circles, n_circles, cell_size,
      inv_cell_size, nx, ny, out);
  return (int)cudaGetLastError();
}

extern "C" const char* stoch_gpmp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
