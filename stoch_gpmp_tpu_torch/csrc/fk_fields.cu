// K4: forward kinematics + self/obstacle link RBF fields per trajectory;
// K8 (fk_fields_points_kernel below): the same per configuration.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/panda_fields.py
// fk_link_fields_cost_rows (_fk_fields_rows_kernel), and the one-hot
// selection matmul of fk_link_fields_cost_flat in front of it (a Mosaic
// layout device): q is read through its strides, q[i, b, t] at
// q + i * sd + b * sb + t * st, so the dof planes [d, B, 2T] and a flat
// [B, T, 2d] batch are both read in place.
//
//   out[b] = sum_{t = 1}^{T-1} link_fields(FK(q[:, b, t]))   (fk_chain.cuh)
//
// Bound on the H100: the special-function unit. At config 5 (B = 10240,
// T = 128, 9 links, 5 spheres) each of the 1.3 M points takes 81 exp and 7
// sincos; its reads are 37 MB. Design: one block per trajectory and one
// thread per (b, t) point, looping over t when T exceeds the block; the
// link positions of a point sit in a shared-memory column of its thread;
// t = 0 is skipped (the reference's collision slice starts at 1); a block
// reduction sums over t.

#include <cuda_runtime.h>

#include "fk_chain.cuh"
#include "kernel_common.cuh"

__global__ void fk_fields_kernel(const float* __restrict__ q, long long sd, long long sb,
                                 long long st, int T, const float* __restrict__ spheres,
                                 int n_obst, float inv_2m2, float w_self, float w_obst,
                                 const __grid_constant__ FkChain chain,
                                 float* __restrict__ out) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  float* pos_sh = smem;                           // [3 * n_links][nt]
  float* sph_sh = pos_sh + 3 * chain.n_links * nt;  // [n_obst][4]
  float* scratch = sph_sh + 4 * n_obst;           // [32]
  for (int i = threadIdx.x; i < 4 * n_obst; i += nt) sph_sh[i] = spheres[i];
  __syncthreads();
  const float* qb = q + (long long)blockIdx.x * sb;
  float ee_r[9];
  float acc = 0.0f;
  for (int t = threadIdx.x; t < T; t += nt) {
    if (t == 0) continue;
    const float* qt = qb + (long long)t * st;
    fk_walk(chain, [&](int i) { return qt[(long long)i * sd]; }, pos_sh + threadIdx.x, nt, ee_r);
    acc += link_fields(pos_sh + threadIdx.x, nt, chain.n_links, sph_sh, n_obst, inv_2m2,
                       w_self, w_obst);
  }
  acc = block_reduce<false>(acc, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// K8. Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/panda_fields.py
// fk_link_fields_cost (_fk_fields_kernel): per row n of q [N, d], read in
// place at q + n * sn + i * sd,
//   out[n] = link_fields(FK(q[n]))
// with no time mask and no sum. Bound on the H100 as K4's: the
// special-function unit (81 exp and 7 sincos per configuration). Design: one
// thread per row, the link positions in a shared-memory column of its
// thread; the TPU kernel's [n_dof, R, cols] tiling is a Mosaic layout device
// and has no counterpart here.
__global__ void fk_fields_points_kernel(const float* __restrict__ q, long long sn,
                                        long long sd, long long N,
                                        const float* __restrict__ spheres, int n_obst,
                                        float inv_2m2, float w_self, float w_obst,
                                        const __grid_constant__ FkChain chain,
                                        float* __restrict__ out) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  float* pos_sh = smem;                             // [3 * n_links][nt]
  float* sph_sh = pos_sh + 3 * chain.n_links * nt;  // [n_obst][4]
  for (int i = threadIdx.x; i < 4 * n_obst; i += nt) sph_sh[i] = spheres[i];
  __syncthreads();
  const long long n = (long long)blockIdx.x * nt + threadIdx.x;
  if (n >= N) return;
  const float* qn = q + n * sn;
  float ee_r[9];
  fk_walk(chain, [&](int i) { return qn[(long long)i * sd]; }, pos_sh + threadIdx.x, nt, ee_r);
  out[n] = link_fields(pos_sh + threadIdx.x, nt, chain.n_links, sph_sh, n_obst, inv_2m2,
                       w_self, w_obst);
}

extern "C" int fk_fields_points_launch(const float* q, long long sn, long long sd, long long N,
                                       const float* spheres, int n_obst, float inv_2m2,
                                       float w_self, float w_obst, const FkChain* chain,
                                       float* out, void* stream) {
  if (chain->n_joints > FK_MAX_JOINTS || chain->n_links < 1 || N < 1 || n_obst < 0)
    return (int)cudaErrorInvalidValue;
  const int nt = 256;
  const long long blocks = (N + nt - 1) / nt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)3 * chain->n_links * nt + 4 * n_obst);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fk_fields_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fk_fields_points_kernel<<<(unsigned)blocks, nt, smem, (cudaStream_t)stream>>>(
      q, sn, sd, N, spheres, n_obst, inv_2m2, w_self, w_obst, *chain, out);
  return (int)cudaGetLastError();
}

extern "C" int fk_fields_launch(const float* q, long long sd, long long sb, long long st,
                                int B, int T, const float* spheres, int n_obst,
                                float inv_2m2, float w_self, float w_obst,
                                const FkChain* chain, float* out, void* stream) {
  if (chain->n_joints > FK_MAX_JOINTS || chain->n_links < 1 || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  int nt = ((T + 31) / 32) * 32;
  if (nt > 256) nt = 256;
  const size_t smem = sizeof(float) * ((size_t)3 * chain->n_links * nt + 4 * n_obst + 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fk_fields_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fk_fields_kernel<<<B, nt, smem, (cudaStream_t)stream>>>(
      q, sd, sb, st, T, spheres, n_obst, inv_2m2, w_self, w_obst, *chain, out);
  return (int)cudaGetLastError();
}
