// Occupancy-grid lookup: grid[cell(y), cell(x)] for each query point.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/fields.py grid_lookup
// (_grid_lookup_kernel). The TPU kernel pads the grid to a square of 128
// lanes and reads it by 128-lane block gathers and a masked sublane
// reduction, because Mosaic's dynamic_gather only reaches within one vector
// register. None of that carries over: a GPU thread reads any address.
//
// Bound on the H100: memory and launch latency. A point reads 8 bytes and
// writes 4 (120,960 points per StochGPMP iteration at the planar parity
// shape, 12,096 per Gauss-Newton linearisation at P = 192), and the grid
// (200 x 200 float32, 160 KB) is read from L2 after its first touch. Design:
// one thread per point; the [B, L, 2] points are read through their strides
// (the planner passes a strided slice of its sample batch); each point is
// snapped by K1's rule (raster_common.cuh: floor(fma(x, 1/cell, n/2)),
// clamped), so a point on a cell edge lands in the same cell as in K1, the
// plain PyTorch version and the JAX package; the grid is read through the
// read-only data path.

#include <cuda_runtime.h>

#include "raster_common.cuh"

__global__ void grid_lookup_kernel(const float* __restrict__ grid, int nx, int ny,
                                   const float* __restrict__ pts, long long B,
                                   long long L, long long sb, long long sl,
                                   long long sc, float inv_cell_size,
                                   float* __restrict__ out) {
  const long long n = B * L;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / L, l = idx - b * L;
    const float* p = pts + b * sb + l * sl;
    const int cx = raster_snap(p[0], inv_cell_size, nx / 2, nx);
    const int cy = raster_snap(p[sc], inv_cell_size, ny / 2, ny);
    out[idx] = __ldg(grid + (long long)cy * nx + cx);
  }
}

extern "C" int grid_lookup_launch(const float* grid, int nx, int ny, const float* pts,
                                  long long B, long long L, long long sb, long long sl,
                                  long long sc, float inv_cell_size, float* out,
                                  void* stream) {
  const int threads = 256;
  long long blocks = (B * L + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  grid_lookup_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      grid, nx, ny, pts, B, L, sb, sl, sc, inv_cell_size, out);
  return (int)cudaGetLastError();
}
