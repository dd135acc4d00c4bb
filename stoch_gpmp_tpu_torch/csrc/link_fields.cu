// K7: self + obstacle link RBF fields at given link positions.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/panda_fields.py
// fused_link_fields_cost (_kernel). Per point n of an [N0, N1] batch of link
// positions, pos[i0, i1, l, c] at pos + i0 * s0 + i1 * s1 + l * sl + c * sc
// (read through its strides, so the t >= 1 slice of an FK output is read in
// place):
//   out[n] = w_self * (2 sum_{i<j} exp(-|p_i - p_j|^2 / (2 margin^2)) + L)
//          + w_obst * sum_k sum_l exp(-0.5 |p_l - c_k|^2 / r_k^2)
// (fk_chain.cuh link_fields: the TPU kernel's terms).
//
// Bound on the H100: the bytes, 108 B read and 4 B written per point with 9
// links (43.5 us at 1.30 M points); at config 4's 10,080 points the launch
// and one thread's chain of 81 exp2 terms. Design:
// - Coalesced tiles. A CTA of 128 threads takes a tile of 128 consecutive
//   points: each thread finds its point's offset (one 32-bit division), then
//   the CTA copies the tile's 3L words per point into shared memory with
//   consecutive threads on consecutive words (on the main path's layout,
//   fk_compact positions sliced [:, 1:], a point's 27 words and a
//   trajectory's 63 points are contiguous), as cp.async copies, so that a
//   thread's 27 words are in flight at once (the same copy through
//   registers, a word at a time, moved 1.0 TB/s at 1.30 M points on an
//   H100, cp.async 1.7; CTAs of 128 threads beat 256 by 4% and 512 by 11%;
//   persistent CTAs that fetch the next tile into a second buffer while
//   computing one were 5% slower than single tiles). A point's record in
//   shared memory is 3L words padded to an odd count (27 for the Panda), so
//   threads reading one word of consecutive points hit distinct banks.
// - The Panda's 9 links at compile time (NL = 9): one thread per point holds
//   the 27 coordinates in registers and link_fields<9> unrolls both loops.
//   Any other link count takes the runtime-L instantiation (NL = 0).
// - One thread per point at every batch size: dealing a point's terms over
//   2, 4 or 8 lanes (a pair table and shuffles) was no faster on an H100 at
//   config 4's 10,080 points (one lane 0.0034 ms, 8 lanes 0.0033) and slower
//   at 2 and 4 lanes and at 1.30 M points (PERF.md, section 6).
// - 32-bit index arithmetic: the launcher refuses a batch or an offset of
//   2^31 or more.
// The TPU kernel's move to [L, 3, N] coordinate planes and its 1024-wide
// padding are Mosaic layout devices and have no counterpart here.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "fk_chain.cuh"

namespace {

constexpr int kThreads = 128;  // points per CTA

struct LinkFieldsArgs {
  const float* pos;
  int n1, n;                // points per row, points in all
  int s0, s1, sl, sc;       // strides in floats
  int n_links, n_obst;
  const float* spheres;     // [n_obst, 4]
  float inv_2m2, w_self, w_obst;
  float* out;               // [n]
};

__host__ __device__ constexpr int record_words(int n_links) { return (3 * n_links) | 1; }

// Dynamic shared memory: spheres, the tile's records and the points' offsets.
__host__ __device__ constexpr size_t smem_bytes(int n_links, int n_obst) {
  return sizeof(float4) * n_obst + sizeof(float) * (size_t)kThreads * record_words(n_links) +
         sizeof(int) * kThreads;
}

template <int NL>
__global__ void __launch_bounds__(kThreads)
    link_fields_kernel(const __grid_constant__ LinkFieldsArgs a) {
  const int L = NL > 0 ? NL : a.n_links;
  const int W = record_words(L);
  extern __shared__ float4 smem4[];
  float4* sph = smem4;                                       // [n_obst]
  float* rec = reinterpret_cast<float*>(sph + a.n_obst);     // [kThreads][W]
  int* base = reinterpret_cast<int*>(rec + kThreads * W);    // [kThreads]
  const int tid = threadIdx.x;
  const int first = blockIdx.x * kThreads;
  const int tile = min(kThreads, a.n - first);

  if (tid < tile) {
    const unsigned n = (unsigned)(first + tid), i0 = n / (unsigned)a.n1;
    base[tid] = (int)i0 * a.s0 + (int)(n - i0 * (unsigned)a.n1) * a.s1;
  }
  __syncthreads();
  // the tile's records, consecutive threads on consecutive words, as
  // asynchronous copies (all of a thread's words in flight at once); the
  // spheres' loads overlap them
  const bool packed = a.sc == 1 && a.sl == 3;
  for (int w = tid; w < tile * 3 * L; w += kThreads) {
    const int p = w / (3 * L), c = w - p * (3 * L);
    const int l = c / 3, k = c - 3 * l;
    __pipeline_memcpy_async(rec + p * W + c, a.pos + base[p] + (packed ? c : l * a.sl + k * a.sc),
                            sizeof(float));
  }
  __pipeline_commit();
  load_spheres(a.spheres, a.n_obst, sph);
  __pipeline_wait_prior(0);
  __syncthreads();

  if (tid >= tile) return;
  const float* r = rec + tid * W;
  float v;
  if constexpr (NL > 0) {
    float x[3 * NL];
#pragma unroll
    for (int c = 0; c < 3 * NL; ++c) x[c] = r[c];
    v = link_fields<NL>([&](int l, int c) { return x[3 * l + c]; }, NL, sph, a.n_obst,
                        a.inv_2m2, a.w_self, a.w_obst);
  } else {
    v = link_fields<0>([&](int l, int c) { return r[3 * l + c]; }, L, sph, a.n_obst, a.inv_2m2,
                       a.w_self, a.w_obst);
  }
  a.out[first + tid] = v;
}

template <int NL>
cudaError_t launch(const LinkFieldsArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.n_links, a.n_obst);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        link_fields_kernel<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (int)(((long long)a.n + kThreads - 1) / kThreads);
  link_fields_kernel<NL><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The batch [n0, n1] of points and every offset (strides in floats) must be
// below 2^31. The Panda's 9 links take the unrolled instantiation.
extern "C" int link_fields_launch(const float* pos, int n0, int n1, int s0, int s1, int sl,
                                  int sc, int n_links, const float* spheres, int n_obst,
                                  float inv_2m2, float w_self, float w_obst, float* out,
                                  void* stream) {
  if (n_links < 1 || n_obst < 0 || n0 < 1 || n1 < 1 || s0 < 0 || s1 < 0 || sl < 0 || sc < 0)
    return (int)cudaErrorInvalidValue;
  const long long last = (long long)(n0 - 1) * s0 + (long long)(n1 - 1) * s1 +
                         (long long)(n_links - 1) * sl + 2LL * sc;
  if ((long long)n0 * n1 > 0x7fffffffLL || last > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const LinkFieldsArgs a{pos, n1, n0 * n1, s0, s1, sl, sc, n_links, n_obst, spheres,
                         inv_2m2, w_self, w_obst, out};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(n_links == FkPanda::NL ? launch<FkPanda::NL>(a, st) : launch<0>(a, st));
}
