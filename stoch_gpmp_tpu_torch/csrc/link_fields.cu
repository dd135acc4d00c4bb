// K7: self + obstacle link RBF fields at given link positions.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/panda_fields.py
// fused_link_fields_cost (_kernel). Per point n of an [N0, N1] batch of link
// positions, pos[i0, i1, l, c] at pos + i0 * s0 + i1 * s1 + l * sl + c * sc
// (read through its strides, so the t >= 1 slice of an FK output is read in
// place):
//   out[n] = link_fields(pos[i0, i1])     (fk_chain.cuh: the TPU kernel's
//                                          terms)
// Bound on the H100: the bytes, 108 B read and 4 B written per point with 9
// links; at the config-4 size (10,080 points) the launch dominates. Design:
// one thread per point; the point's link positions go to a shared-memory
// column of its thread (the links are a runtime count), and the spheres to
// shared memory as the fields' constants (fk_chain.cuh load_spheres). The
// TPU kernel's move to [L, 3, N] coordinate planes and its 1024-wide padding
// are Mosaic layout devices and have no counterpart here.

#include <cuda_runtime.h>

#include "fk_chain.cuh"

__global__ void link_fields_kernel(const float* __restrict__ pos, long long n0, long long n1,
                                   long long s0, long long s1, long long sl, long long sc,
                                   int n_links, const float* __restrict__ spheres, int n_obst,
                                   float inv_2m2, float w_self, float w_obst,
                                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int nt = blockDim.x;
  float4* sph = smem4;                                   // [n_obst]
  float* pos_sh = reinterpret_cast<float*>(sph + n_obst);  // [3 * n_links][nt]
  load_spheres(spheres, n_obst, sph);
  __syncthreads();
  const long long n = (long long)blockIdx.x * nt + threadIdx.x;
  if (n >= n0 * n1) return;
  const long long i0 = n / n1, i1 = n - i0 * n1;
  const float* p = pos + i0 * s0 + i1 * s1;
  float* col = pos_sh + threadIdx.x;
  for (int l = 0; l < n_links; ++l)
#pragma unroll
    for (int c = 0; c < 3; ++c) col[(3 * l + c) * nt] = p[l * sl + c * sc];
  out[n] = link_fields<0>([&](int l, int c) { return col[(3 * l + c) * nt]; }, n_links, sph,
                         n_obst, inv_2m2, w_self, w_obst);
}

extern "C" int link_fields_launch(const float* pos, long long n0, long long n1, long long s0,
                                  long long s1, long long sl, long long sc, int n_links,
                                  const float* spheres, int n_obst, float inv_2m2,
                                  float w_self, float w_obst, float* out, void* stream) {
  if (n_links < 1 || n_obst < 0 || n0 < 1 || n1 < 1) return (int)cudaErrorInvalidValue;
  const int nt = 256;
  const long long blocks = (n0 * n1 + nt - 1) / nt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)3 * n_links * nt + 4 * n_obst);  // float4 spheres
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        link_fields_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  link_fields_kernel<<<(unsigned)blocks, nt, smem, (cudaStream_t)stream>>>(
      pos, n0, n1, s0, s1, sl, sc, n_links, spheres, n_obst, inv_2m2, w_self, w_obst, out);
  return (int)cudaGetLastError();
}
