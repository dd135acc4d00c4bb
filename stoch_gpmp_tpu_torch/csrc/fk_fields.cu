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
// Bound on the H100: the arithmetic. At config 5 (B = 10240, T = 128, 9
// links, 5 spheres) each of the 1.30 M points takes 81 exp2 (the
// special-function unit: ~25 us for the card) and ~1,200 FP32 operations
// (the walk, 81 squared distances); its reads are 37 MB (11 us). Design:
// 256-thread blocks of one thread per (b, t) point, ceil32(T) threads per
// trajectory (two trajectories per block at T = 128, four at T = 64; at most
// 64 registers, so four blocks share an SM and hide the walk's latency),
// looping over t where T exceeds 256; t = 0
// is skipped (the reference's collision slice starts at 1). For a chain the
// kernels are specialised for (variant 1, the Panda: fk_spec.h FkPanda)
// the walk is unrolled and the link positions stay in registers; any other
// chain takes the generic walk (variant 0), its positions in a shared-memory
// column of the thread. The spheres are shared-memory constants; a warp sum
// and one sum over the trajectory's warps, in warp order, close each
// trajectory.

#include <cuda_runtime.h>

#include "fk_chain.cuh"
#include "kernel_common.cuh"

namespace {

constexpr int NT = 256;  // threads per block

// The fields at FK(q(i)) of one point; `col` is the thread's shared-memory
// column of link positions for the generic walk (stride NT).
template <int VARIANT, class Q>
__device__ __forceinline__ float point_fields(const FkChain& chain, Q q, float* col,
                                              const float4* sph, int n_obst, float inv_2m2,
                                              float w_self, float w_obst) {
  float ee_r[9];
  if constexpr (VARIANT == 1) {
    float pos[FkPanda::NL][3];
    fk_walk_spec<FkPanda>(chain, q, pos, ee_r);
    return link_fields<FkPanda::NL>([&](int l, int c) { return pos[l][c]; }, FkPanda::NL, sph,
                                    n_obst, inv_2m2, w_self, w_obst);
  } else {
    fk_walk(chain, q, col, NT, ee_r);
    return link_fields<0>([&](int l, int c) { return col[(3 * l + c) * NT]; }, chain.n_links,
                          sph, n_obst, inv_2m2, w_self, w_obst);
  }
}

template <int VARIANT>
__global__ void __launch_bounds__(NT, 4)
fk_fields_kernel(const float* __restrict__ q, long long sd, long long sb, long long st, int B,
                 int T, int lanes, const float* __restrict__ spheres, int n_obst, float inv_2m2,
                 float w_self, float w_obst, const __grid_constant__ FkChain chain,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* sph = smem4;                                        // [n_obst]
  float* red = reinterpret_cast<float*>(sph + n_obst);        // [NT / 32]
  float* pos_sh = red + NT / 32;                              // generic: [3 L][NT]
  load_spheres(spheres, n_obst, sph);
  __syncthreads();
  const int tid = threadIdx.x, g = tid / lanes, u = tid - g * lanes;
  const long long b = (long long)blockIdx.x * (NT / lanes) + g;
  float acc = 0.0f;
  if (b < B) {
    const float* qb = q + b * sb;
    for (int t = u; t < T; t += lanes) {
      if (t == 0) continue;
      const float* qt = qb + (long long)t * st;
      acc += point_fields<VARIANT>(chain, [&](int i) { return qt[(long long)i * sd]; },
                                   pos_sh + tid, sph, n_obst, inv_2m2, w_self, w_obst);
    }
  }
  acc = warp_sum(acc);
  if ((tid & 31) == 0) red[tid >> 5] = acc;
  __syncthreads();
  if (u == 0 && b < B) {
    float s = 0.0f;
    for (int w = 0; w < lanes / 32; ++w) s += red[tid / 32 + w];
    out[b] = s;
  }
}

// K8. Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/panda_fields.py
// fk_link_fields_cost (_fk_fields_kernel): per row n of q [N, d], read in
// place at q + n * sn + i * sd,
//   out[n] = link_fields(FK(q[n]))
// with no time mask and no sum. Bound on the H100 as K4's. Design: one thread
// per row, the walk and the positions as K4's; the TPU kernel's [n_dof, R,
// cols] tiling is a Mosaic layout device and has no counterpart here.
template <int VARIANT>
__global__ void __launch_bounds__(NT, 3)
fk_fields_points_kernel(const float* __restrict__ q, long long sn, long long sd, long long N,
                        const float* __restrict__ spheres, int n_obst, float inv_2m2,
                        float w_self, float w_obst, const __grid_constant__ FkChain chain,
                        float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float4* sph = smem4;                                   // [n_obst]
  float* pos_sh = reinterpret_cast<float*>(sph + n_obst);  // generic: [3 L][NT]
  load_spheres(spheres, n_obst, sph);
  __syncthreads();
  const long long n = (long long)blockIdx.x * NT + threadIdx.x;
  if (n >= N) return;
  const float* qn = q + n * sn;
  out[n] = point_fields<VARIANT>(chain, [&](int i) { return qn[(long long)i * sd]; },
                                 pos_sh + threadIdx.x, sph, n_obst, inv_2m2, w_self, w_obst);
}

// Shared memory of a launch: the spheres, the reduction's NT / 32 floats
// (K4), and the generic walk's position columns.
size_t smem_bytes(int variant, int n_obst, int n_links, bool reduce) {
  return sizeof(float4) * n_obst + sizeof(float) * (reduce ? NT / 32 : 0) +
         (variant == 0 ? sizeof(float) * 3 * n_links * NT : 0);
}

template <class Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(
                                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                          : cudaSuccess;
}

}  // namespace

extern "C" int fk_fields_points_launch(const float* q, long long sn, long long sd, long long N,
                                       const float* spheres, int n_obst, float inv_2m2,
                                       float w_self, float w_obst, const FkChain* chain,
                                       int variant, float* out, void* stream) {
  if (!fk_variant_valid(*chain, variant) || N < 1 || n_obst < 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (N + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(variant, n_obst, chain->n_links, false);
  const auto kernel = variant == 1 ? fk_fields_points_kernel<1> : fk_fields_points_kernel<0>;
  const cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, NT, smem, (cudaStream_t)stream>>>(
      q, sn, sd, N, spheres, n_obst, inv_2m2, w_self, w_obst, *chain, out);
  return (int)cudaGetLastError();
}

extern "C" int fk_fields_launch(const float* q, long long sd, long long sb, long long st,
                                int B, int T, const float* spheres, int n_obst,
                                float inv_2m2, float w_self, float w_obst,
                                const FkChain* chain, int variant, float* out, void* stream) {
  if (!fk_variant_valid(*chain, variant) || B < 1 || T < 1 || n_obst < 0)
    return (int)cudaErrorInvalidValue;
  int lanes = T >= NT ? NT : (T + 31) / 32 * 32;  // threads per trajectory
  while (NT % lanes) lanes += 32;  // NT / lanes trajectories per block
  const int per_block = NT / lanes;
  const size_t smem = smem_bytes(variant, n_obst, chain->n_links, true);
  const auto kernel = variant == 1 ? fk_fields_kernel<1> : fk_fields_kernel<0>;
  const cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + per_block - 1) / per_block, NT, smem, (cudaStream_t)stream>>>(
      q, sd, sb, st, B, T, lanes, spheres, n_obst, inv_2m2, w_self, w_obst, *chain, out);
  return (int)cudaGetLastError();
}
