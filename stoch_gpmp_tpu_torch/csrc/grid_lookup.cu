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
// shape, 12,096 per Gauss-Newton linearisation at P = 192); in the
// planner's [B, 64, 4] batch a point's (x, y) shares its 16 bytes with the
// velocities, and memory moves whole 32-byte sectors, so the card reads 16
// bytes per point of that view. The grid (200 x 200 float32, 160 KB) is
// read from L2 after its first touch. Each point is one chain: its load, the
// snap, a gather from the grid, the store. Design:
// - Two points per thread, kPts = 2, dealt by warp and read through their
//   strides with 32-bit indices, one float2 load per aligned pair
//   (point_batch.cuh). On one H100 at the planner's [1920, 63, 2] view, 2
//   points per thread took 2.5 us, 4 and 8 took 2.7 and 3.0 (more CTAs
//   keep more gathers in flight per SM there); at 1.31 M points all took
//   9.0-9.2 us.
// - Both points' loads are issued first, then both are snapped, then both
//   grid gathers (read-only data path) are issued, then the stores: the
//   gathers of a thread are in flight together.
// - Each point is snapped by K1's rule (raster_common.cuh: floor(fma(x,
//   1/cell, n/2)), clamped), so a point on a cell edge lands in the same
//   cell as in K1, the plain PyTorch version and the JAX package. A point
//   past the last reads the centre cell and stores nothing.
// The grid stays in L2: a copy into shared memory (the TPU kernel keeps it
// in VMEM) would cost each CTA 160 KB from L2, more than the whole kernel.

#include <cuda_runtime.h>

#include "point_batch.cuh"
#include "raster_common.cuh"

namespace {

constexpr int kThreads = 128, kPts = 2;

template <bool kPairs>
__global__ void __launch_bounds__(kThreads)
    grid_lookup_kernel(const float* __restrict__ grid, int nx, int ny,
                       const float* __restrict__ pts, unsigned n, int L, FastDiv div_l, int sb,
                       int sl, int sc, float inv_cell_size, float* __restrict__ out) {
  const unsigned base = first_point<kThreads, kPts>();
  float x[kPts], y[kPts], v[kPts];
  load_points<kPairs>(pts, base, n, L, div_l, sb, sl, sc, x, y);
  int cell[kPts];
#pragma unroll
  for (int k = 0; k < kPts; ++k)
    cell[k] = raster_snap(y[k], inv_cell_size, ny / 2, ny) * nx +
              raster_snap(x[k], inv_cell_size, nx / 2, nx);
#pragma unroll
  for (int k = 0; k < kPts; ++k) v[k] = __ldg(grid + cell[k]);
#pragma unroll
  for (int k = 0; k < kPts; ++k)
    if (base + 32 * k < n) out[base + 32 * k] = v[k];
}

}  // namespace

// grid [ny, nx] contiguous, below 2^31 cells; points [B, L, 2] at strides
// (sb, sl, sc) in floats; B * L and every offset must be below 2^31 (the
// kernel's point indices are unsigned 32-bit).
extern "C" int grid_lookup_launch(const float* grid, int nx, int ny, const float* pts, int B,
                                  int L, int sb, int sl, int sc, float inv_cell_size,
                                  float* out, void* stream) {
  if (!points_fit_32_bits(B, L, sb, sl, sc) || nx < 1 || ny < 1 ||
      (long long)nx * ny > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned n = (unsigned)B * (unsigned)L;
  const int blocks = (int)((n + kThreads * kPts - 1) / (kThreads * kPts));
  const FastDiv div_l = fast_div((unsigned)L);
  const cudaStream_t st = (cudaStream_t)stream;
  if (points_are_pairs(pts, sb, sl, sc))
    grid_lookup_kernel<true><<<blocks, kThreads, 0, st>>>(grid, nx, ny, pts, n, L, div_l, sb,
                                                         sl, sc, inv_cell_size, out);
  else
    grid_lookup_kernel<false><<<blocks, kThreads, 0, st>>>(grid, nx, ny, pts, n, L, div_l, sb,
                                                          sl, sc, inv_cell_size, out);
  return (int)cudaGetLastError();
}
