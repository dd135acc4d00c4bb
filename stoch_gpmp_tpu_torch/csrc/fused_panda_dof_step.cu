// K5: one whole dof-factored Panda StochGPMP iteration per particle, in one
// kernel.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/panda_step_dof.py
// make_fused_panda_dof_step (_kernel). Per particle p, dof d, sample s,
// with the means and Sigma^{-1} mu as dof planes [D, P, 2T]:
//   x_{d,s} = mu_d + eps_{d,s} @ W_dof                 (eps: operand or Philox)
//   cost_s  = sum_d stencil energy of x_{d,s} + anchors (as dof_quad_eval.cu)
//           + tau * sum_d x_{d,s} . pu_d
//           + sum_{t>=1} link_fields(FK(x_{:,s}[t]))    (fk_chain.cuh)
//           + w_goal (w_pos |p_ee - p*| + w_rot acos_poly(c))^2   at t = T-1
//   w       = softmax_s(-cost / tau)
//   mu_d   += step * sum_s w_s (x_{d,s} - mu_d)
// The SE(3) angle uses the TPU kernel's Abramowitz & Stegun 4.4.46
// polynomial (|err| <= 2e-8 rad); the plain version does too.
//
// Bound on the H100: the FP32 sampling product, 2 D P S (2T)^2 = 9.4 GFLOP
// at config 5 (P = 1280, S = 8, D = 7, T = 128), ~140 us at 67 TFLOP/s;
// the fields add ~1 M points x 81 exp. No TF32: the stencil weights reach
// ~2e11. Design, simple first: one block per particle (1280 blocks fill the
// 132 SMs) and one thread per plane lane m < 2T. The D * S sample rows sit
// in shared memory; they are multiplied by W_dof in tiles of RT rows, W
// streamed in K-tiles of KT rows by cp.async (W is 256 KB, more than a
// block's 227 KB; kernel_common.cuh, shared with K2). The stencil energy
// and importance are per-row warp sums; the fields run one thread per
// (sample, t) point with the link positions in the shared memory the W
// tiles used; the thread at t = T-1 also computes the SE(3) goal; the
// softmax over the S samples and the mean update close the iteration.
// Philox4x32-10 is keyed on the seed with the counter (lane, sample pair,
// particle, dof), two normals per draw by the dual-output Box-Muller.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fk_chain.cuh"
#include "kernel_common.cuh"

// Outside the anonymous namespace: the exported launcher takes a pointer
// to it, and a parameter of an internal type would hide the launcher.
struct DofStepParams {
  int P, S, T, D, n_obst, ppg;  // ppg: particles per goal
  float dt, q11, q12, q22, ks11, ks12, ks22, kg11, kg12, kg22;
  float s_pd[2 * FK_MAX_JOINTS];  // start (pos, vel) per dof
  float target[16];               // SE(3) goal, row-major 4x4
  float inv_2m2, w_self, w_obst, w_goal, w_pos, w_rot, temperature, step_size;
  unsigned int key_lo, key_hi;
};

namespace {

constexpr int RT = 32;  // sample rows per sampling tile
constexpr int KT = 16;  // K rows of W per shared-memory tile
constexpr int MAX_LANES = 512;

__device__ __forceinline__ float quad2(float a11, float a12, float a22, float r, float s) {
  return a11 * r * r + 2.0f * a12 * r * s + a22 * s * s;
}

__host__ __device__ __forceinline__ int round_up(int v, int k) { return (v + k - 1) / k * k; }

__global__ void __launch_bounds__(MAX_LANES)
fused_panda_dof_step_kernel(const float* __restrict__ means, const float* __restrict__ prec_u,
                            const float* __restrict__ g_pd, const float* __restrict__ W,
                            const float* __restrict__ spheres, const float* __restrict__ eps,
                            float* __restrict__ new_means, float* __restrict__ costs,
                            const __grid_constant__ DofStepParams prm,
                            const __grid_constant__ FkChain chain) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = blockDim.x, T = prm.T, S = prm.S, D = prm.D, P = prm.P;
  const int p = blockIdx.x, m = threadIdx.x, lane = m & 31, warp = m >> 5;
  const int nwarps = M >> 5, wpr = T >> 5;  // warps per block, per sample row of T points
  const int R = D * S, R_pad = round_up(R, RT), L = chain.n_links;
  float* x_sh = smem;                                    // [R_pad][M], row r = d * S + s
  float* un_sh = x_sh + (size_t)R_pad * M;               // W K-tiles, then link positions
  float* red_sh = un_sh + max(2 * KT * M, 3 * L * M);    // [nwarps][R]
  float* field_sh = red_sh + nwarps * R;                 // [S][wpr]
  float* goal_sh = field_sh + S * nwarps;                // [S]
  float* cost_sh = goal_sh + S;                          // [S]
  float* w_sh = cost_sh + S;                             // [S]
  float* sph_sh = w_sh + S + 32;                         // [n_obst][4]
  for (int i = m; i < 4 * prm.n_obst; i += M) sph_sh[i] = spheres[i];

  // --- 1. eps rows ------------------------------------------------------------
  for (int r = R; r < R_pad; ++r) x_sh[r * M + m] = 0.0f;
  if (eps != nullptr) {
    for (int r = 0; r < R; ++r) {
      const int d = r / S, s = r - d * S;
      x_sh[r * M + m] = eps[(((size_t)d * P + p) * S + s) * M + m];
    }
  } else {
    const uint2 key = make_uint2(prm.key_lo, prm.key_hi);
    for (int d = 0; d < D; ++d) {
      for (int j = 0; 2 * j < S; ++j) {
        const uint4 bits = philox4x32_10(
            make_uint4((uint32_t)m, (uint32_t)j, (uint32_t)p, (uint32_t)d), key);
        const float2 z = box_muller(bits.x, bits.y);
        x_sh[(d * S + 2 * j) * M + m] = z.x;
        if (2 * j + 1 < S) x_sh[(d * S + 2 * j + 1) * M + m] = z.y;
      }
    }
  }

  // --- 2. x = mu + eps @ W, RT rows at a time (in place) -------------------------
  for (int r0 = 0; r0 < R_pad; r0 += RT) {
    float acc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i] = 0.0f;
    tile_matmul<RT, KT>(x_sh + (size_t)r0 * M, W, un_sh, M, acc);
    // tile_matmul ends on a barrier: every read of these eps rows is done
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = r0 + i;
      if (r < R) x_sh[r * M + m] = means[((size_t)(r / S) * P + p) * M + m] + acc[i];
    }
  }
  __syncthreads();

  // --- 3. stencil energy + anchors + importance, per row -----------------------
  const float* gp = g_pd + (size_t)(p / prm.ppg) * D * 2;
  for (int r = 0; r < R; ++r) {
    const int d = r / S;
    const float* row = x_sh + (size_t)r * M;
    float v = 0.0f;
    if (m < T - 1) {
      const float rp = row[m] + prm.dt * row[T + m] - row[m + 1];
      const float rv = row[T + m] - row[T + m + 1];
      v = quad2(prm.q11, prm.q12, prm.q22, rp, rv);
    }
    if (m == 0)
      v += quad2(prm.ks11, prm.ks12, prm.ks22, row[0] - prm.s_pd[2 * d],
                 row[T] - prm.s_pd[2 * d + 1]);
    if (m == T - 1)
      v += quad2(prm.kg11, prm.kg12, prm.kg22, row[T - 1] - gp[2 * d],
                 row[2 * T - 1] - gp[2 * d + 1]);
    v += prm.temperature * row[m] * prec_u[((size_t)d * P + p) * M + m];
    v = warp_sum(v);
    if (lane == 0) red_sh[warp * R + r] = v;
  }

  // --- 4. FK + link fields per (sample, t); SE(3) goal at t = T-1 ---------------
  // S * T points in whole warps (T % 32 == 0): a warp's points share s.
  float* pos_sh = un_sh;  // the W tiles are consumed
  for (int pt = m; pt < S * T; pt += M) {
    const int s = pt / T, t = pt - s * T;
    float ee_r[9];
    fk_walk(chain, [&](int i) { return x_sh[(size_t)(i * S + s) * M + t]; }, pos_sh + m, M,
            ee_r);
    float f = 0.0f;
    if (t >= 1)
      f = link_fields(pos_sh + m, M, L, sph_sh, prm.n_obst, prm.inv_2m2, prm.w_self,
                      prm.w_obst);
    if (t == T - 1) {
      float g = 0.0f;
      if (prm.w_goal != 0.0f) {
        const float dist =
            ee_goal_distance(pos_sh + m, M, L, ee_r, prm.target, prm.w_pos, prm.w_rot);
        g = prm.w_goal * (dist * dist);
      }
      goal_sh[s] = g;
    }
    f = warp_sum(f);
    if (lane == 0) field_sh[s * wpr + (t >> 5)] = f;
  }
  __syncthreads();

  // --- 5. per-sample cost -------------------------------------------------------
  if (m < S) {
    float c = 0.0f;
    for (int d = 0; d < D; ++d)
      for (int w = 0; w < nwarps; ++w) c += red_sh[w * R + d * S + m];
    for (int k = 0; k < wpr; ++k) c += field_sh[m * wpr + k];
    c += goal_sh[m];
    cost_sh[m] = c;
    costs[(size_t)p * S + m] = c;
  }
  __syncthreads();

  // --- 6. softmax over the particle's S samples, then the mean update --------
  if (m < S) {
    float mx = __int_as_float(0xff800000);  // -inf
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, -cost_sh[s] / prm.temperature);
    float sum = 0.0f;
    for (int s = 0; s < S; ++s) sum += expf(-cost_sh[s] / prm.temperature - mx);
    w_sh[m] = expf(-cost_sh[m] / prm.temperature - mx) / sum;
  }
  __syncthreads();
  for (int d = 0; d < D; ++d) {
    const size_t idx = ((size_t)d * P + p) * M + m;
    const float mu = means[idx];
    float grad = 0.0f;
    for (int s = 0; s < S; ++s) grad = fmaf(w_sh[s], x_sh[(size_t)(d * S + s) * M + m] - mu, grad);
    new_means[idx] = mu + prm.step_size * grad;
  }
}

}  // namespace

extern "C" int fused_panda_dof_step_launch(const float* means, const float* prec_u,
                                           const float* g_pd, const float* W,
                                           const float* spheres, const float* eps,
                                           float* new_means, float* costs,
                                           const DofStepParams* prm, const FkChain* chain,
                                           void* stream) {
  const int M = 2 * prm->T;
  if (M % 64 != 0 || M > MAX_LANES || prm->D < 1 || prm->D > FK_MAX_JOINTS || prm->S < 1 ||
      prm->ppg < 1 || prm->P < 1 || chain->n_links < 1 || chain->n_joints > FK_MAX_JOINTS)
    return (int)cudaErrorInvalidValue;
  const int R = prm->D * prm->S, nwarps = M / 32;
  const int un = 2 * KT * M > 3 * chain->n_links * M ? 2 * KT * M : 3 * chain->n_links * M;
  const size_t smem = sizeof(float) * ((size_t)round_up(R, RT) * M + un + nwarps * R +
                                       prm->S * (nwarps + 3) + 32 + 4 * prm->n_obst);
  cudaError_t err = cudaFuncSetAttribute(fused_panda_dof_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_panda_dof_step_kernel<<<prm->P, M, smem, (cudaStream_t)stream>>>(
      means, prec_u, g_pd, W, spheres, eps, new_means, costs, *prm, *chain);
  return (int)cudaGetLastError();
}
