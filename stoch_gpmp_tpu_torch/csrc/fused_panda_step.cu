// K6: one whole flat-layout Panda StochGPMP iteration per particle, in one
// kernel.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/panda_step.py
// make_fused_panda_step (_kernel). Per particle p and sample s, with
// M = T * 2d lanes in the flat t-major layout (lane t * 2d + j holds pos_j(t),
// lane t * 2d + d + j holds vel_j(t)):
//   x      = mu_p + eps_s @ W                      (eps: operand or Philox)
//   cost_s = the factor-graph stencil energy of x with the start and goal
//            anchors (stencil.py flat_quad_cost)
//          + tau * x . (Sigma^{-1} mu_p)
//          + sum_{t>=1} link_fields(FK(pos(t)))           (fk_chain.cuh)
//          + w_goal (w_pos |p_ee - p*| + w_rot acos_poly(c))^2   at t = T-1
//   w      = softmax_s(-cost / tau)
//   mu_p  += step * sum_s w_s (x_s - mu_p)
// The TPU kernel's one-hot selection matmul (x @ sel, to lay the dof planes
// onto lanes) and its lane rolls do not exist here: a thread reads pos(t),
// vel(t), pos(t+1) and vel(t+1) of a lane directly, and FK reads the 7
// positions of step t at x[t * 2d + i]; the SE(3) goal reads them exactly at
// t = T-1, as the TPU kernel does. The stencil keeps the residual form (the
// weights reach ~2e11; an expanded x A x^T form cancels).
//
// Bound on the H100: the FP32 sampling product, 2 P S M^2 = 257 MFLOP at
// config 4 (P = 5, S = 32, T = 64, M = 896), 3.8 us over the whole card but
// ~100 us on the 5 SMs that the 5 blocks occupy; the fields add 10,080
// points x ~1,200 operations. No TF32. Design, simple first: one block per
// particle and two lanes per thread (448 threads: one thread per lane would
// need 896 threads at <= 72 registers each). The S sample rows stay in
// shared memory (114,688 B at config 4); they are multiplied by W in tiles
// of ST rows, in place (a tile's eps rows become its x rows once its product
// is done), with W streamed in K-tiles of KT = 8 rows by cp.async
// (kernel_common.cuh, shared with K2 and K5): two 16-row K-tiles beside the
// sample rows would not fit in a block's 227 KB. The stencil, anchors and
// importance are per-row warp sums; FK and the fields run one thread per
// (sample, t) point with the link positions in the shared memory the W
// tiles used; the thread at t = T-1 also computes the SE(3) goal; the
// softmax over the S samples and the mean update close the iteration.
// Philox4x32-10 is keyed on the seed with the counter (lane, sample pair,
// particle, 0), two normals per draw by the dual-output Box-Muller.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fk_chain.cuh"
#include "kernel_common.cuh"

// Outside the anonymous namespace: the exported launcher takes a pointer
// to it, and a parameter of an internal type would hide the launcher.
struct PandaStepParams {
  int P, S, T, D, n_obst;
  float dt, q11, q12, q22, ks11, ks12, ks22, kg11, kg12, kg22;
  float target[16];  // SE(3) goal, row-major 4x4
  float inv_2m2, w_self, w_obst, w_goal, w_pos, w_rot, temperature, step_size;
  unsigned int key_lo, key_hi;
};

namespace {

constexpr int ST = 16;  // sample rows per sampling tile
constexpr int KT = 8;   // K rows of W per shared-memory tile
constexpr int C = 2;    // lanes per thread: lane m = threadIdx.x + c * blockDim.x
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ float quad2(float a11, float a12, float a22, float r, float s) {
  return a11 * r * r + 2.0f * a12 * r * s + a22 * s * s;
}

__host__ __device__ __forceinline__ int round_up(int v, int k) { return (v + k - 1) / k * k; }

// minimum one block per SM: ptxas may then use up to 128 registers (65,536 /
// 512) and needs no spills
__global__ void __launch_bounds__(MAX_THREADS, 1)
fused_panda_step_kernel(const float* __restrict__ means, const float* __restrict__ prec_u,
                        const float* __restrict__ anchors, const float* __restrict__ W,
                        const float* __restrict__ spheres, const float* __restrict__ eps,
                        float* __restrict__ new_means, float* __restrict__ costs,
                        const __grid_constant__ PandaStepParams prm,
                        const __grid_constant__ FkChain chain) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NT = blockDim.x, M = C * NT, T = prm.T, S = prm.S, D = prm.D, sd = 2 * D;
  const int p = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = NT >> 5, wpr = T >> 5;  // warps per block, per sample row of T points
  const int S_pad = round_up(S, ST), L = chain.n_links;
  float* x_sh = smem;                                    // [S_pad][M]: eps, then samples
  float* un_sh = x_sh + (size_t)S_pad * M;               // W K-tiles, then link positions
  float* red_sh = un_sh + max(2 * KT * M, 3 * L * NT);   // [nwarps][S]
  float* field_sh = red_sh + nwarps * S;                 // [S][wpr]
  float* goal_sh = field_sh + S * wpr;                   // [S]
  float* cost_sh = goal_sh + S;                          // [S]
  float* w_sh = cost_sh + S;                             // [S]
  float* sph_sh = w_sh + S;                              // [n_obst][4]
  for (int i = tid; i < 4 * prm.n_obst; i += NT) sph_sh[i] = spheres[i];

  // --- 1. eps rows ----------------------------------------------------------------
  for (int s = S; s < S_pad; ++s)
#pragma unroll
    for (int c = 0; c < C; ++c) x_sh[(size_t)s * M + tid + c * NT] = 0.0f;
  if (eps != nullptr) {
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int m = tid + c * NT;
        x_sh[(size_t)s * M + m] = eps[((size_t)p * S + s) * M + m];
      }
  } else {
    const uint2 key = make_uint2(prm.key_lo, prm.key_hi);
    for (int j = 0; 2 * j < S; ++j)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int m = tid + c * NT;
        const uint4 bits =
            philox4x32_10(make_uint4((uint32_t)m, (uint32_t)j, (uint32_t)p, 0u), key);
        const float2 z = box_muller(bits.x, bits.y);
        x_sh[(size_t)(2 * j) * M + m] = z.x;
        if (2 * j + 1 < S) x_sh[(size_t)(2 * j + 1) * M + m] = z.y;
      }
  }

  // --- 2. x = mu + eps @ W, ST rows at a time (in place) ---------------------------
  float mu[C];
#pragma unroll
  for (int c = 0; c < C; ++c) mu[c] = means[(size_t)p * M + tid + c * NT];
  for (int s0 = 0; s0 < S_pad; s0 += ST) {
    float acc[C][ST];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < ST; ++i) acc[c][i] = 0.0f;
    tile_matmul_cols<ST, KT, C>(x_sh + (size_t)s0 * M, W, un_sh, M, acc);
    // tile_matmul_cols ends on a barrier: every read of these eps rows is done
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      if (s0 + i < S) {
#pragma unroll
        for (int c = 0; c < C; ++c) x_sh[(size_t)(s0 + i) * M + tid + c * NT] = mu[c] + acc[c][i];
      }
    }
  }
  __syncthreads();

  // --- 3. stencil energy + anchors + importance, per sample row --------------------
  float pu[C], anc[C], ancd[C];
  bool m_gp[C], m_s[C], m_g[C], is_pos[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int m = tid + c * NT;
    is_pos[c] = (m % sd) < D;
    m_gp[c] = is_pos[c] && m < M - sd;  // a GP factor between t and t + 1
    m_s[c] = is_pos[c] && m < sd;       // the start anchor at t = 0
    m_g[c] = is_pos[c] && m >= M - sd;  // the goal anchor at t = T-1
    pu[c] = prec_u[(size_t)p * M + m];
    anc[c] = anchors[(size_t)p * M + m];
    ancd[c] = is_pos[c] ? anchors[(size_t)p * M + m + D] : 0.0f;
  }
  for (int s = 0; s < S; ++s) {
    const float* row = x_sh + (size_t)s * M;
    float v = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int m = tid + c * NT;
      const float x = row[m];
      if (is_pos[c]) {
        const float xd = row[m + D];
        if (m_gp[c]) {
          const float rp = x + prm.dt * xd - row[m + sd];
          const float rv = xd - row[m + sd + D];
          v += quad2(prm.q11, prm.q12, prm.q22, rp, rv);
        }
        if (m_s[c]) v += quad2(prm.ks11, prm.ks12, prm.ks22, x - anc[c], xd - ancd[c]);
        if (m_g[c]) v += quad2(prm.kg11, prm.kg12, prm.kg22, x - anc[c], xd - ancd[c]);
      }
      v += prm.temperature * x * pu[c];
    }
    v = warp_sum(v);
    if (lane == 0) red_sh[warp * S + s] = v;
  }

  // --- 4. FK + link fields per (sample, t); SE(3) goal at t = T-1 -----------------
  // S * T points in whole warps (T % 32 == 0, NT % 32 == 0): a warp's points
  // share s.
  float* pos_sh = un_sh;  // the W tiles are consumed
  for (int pt = tid; pt < S * T; pt += NT) {
    const int s = pt / T, t = pt - s * T;
    const float* xt = x_sh + (size_t)s * M + t * sd;
    float ee_r[9];
    fk_walk(chain, [&](int i) { return xt[i]; }, pos_sh + tid, NT, ee_r);
    float f = 0.0f;
    if (t >= 1)
      f = link_fields(pos_sh + tid, NT, L, sph_sh, prm.n_obst, prm.inv_2m2, prm.w_self,
                      prm.w_obst);
    if (t == T - 1) {
      float g = 0.0f;
      if (prm.w_goal != 0.0f) {
        const float dist =
            ee_goal_distance(pos_sh + tid, NT, L, ee_r, prm.target, prm.w_pos, prm.w_rot);
        g = prm.w_goal * (dist * dist);
      }
      goal_sh[s] = g;
    }
    f = warp_sum(f);
    if (lane == 0) field_sh[s * wpr + (t >> 5)] = f;
  }
  __syncthreads();

  // --- 5. per-sample cost ------------------------------------------------------------
  if (tid < S) {
    float c = 0.0f;
    for (int w = 0; w < nwarps; ++w) c += red_sh[w * S + tid];
    for (int k = 0; k < wpr; ++k) c += field_sh[tid * wpr + k];
    c += goal_sh[tid];
    cost_sh[tid] = c;
    costs[(size_t)p * S + tid] = c;
  }
  __syncthreads();

  // --- 6. softmax over the particle's S samples, then the mean update -------------
  if (tid < S) {
    float mx = __int_as_float(0xff800000);  // -inf
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, -cost_sh[s] / prm.temperature);
    float sum = 0.0f;
    for (int s = 0; s < S; ++s) sum += expf(-cost_sh[s] / prm.temperature - mx);
    w_sh[tid] = expf(-cost_sh[tid] / prm.temperature - mx) / sum;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int m = tid + c * NT;
    float grad = 0.0f;
    for (int s = 0; s < S; ++s) grad = fmaf(w_sh[s], x_sh[(size_t)s * M + m] - mu[c], grad);
    new_means[(size_t)p * M + m] = mu[c] + prm.step_size * grad;
  }
}

}  // namespace

extern "C" int fused_panda_step_launch(const float* means, const float* prec_u,
                                       const float* anchors, const float* W,
                                       const float* spheres, const float* eps,
                                       float* new_means, float* costs,
                                       const PandaStepParams* prm, const FkChain* chain,
                                       void* stream) {
  const int M = 2 * prm->D * prm->T, NT = M / C;
  if (M % (32 * C) != 0 || NT > MAX_THREADS || prm->T % 32 != 0 || prm->D < 1 ||
      prm->D > FK_MAX_JOINTS || prm->S < 1 || prm->S > NT || prm->P < 1 || prm->n_obst < 0 ||
      chain->n_links < 1 || chain->n_joints > FK_MAX_JOINTS)
    return (int)cudaErrorInvalidValue;
  const int nwarps = NT / 32;
  const int un = 2 * KT * M > 3 * chain->n_links * NT ? 2 * KT * M : 3 * chain->n_links * NT;
  const size_t smem = sizeof(float) * ((size_t)round_up(prm->S, ST) * M + un + nwarps * prm->S +
                                       prm->S * (prm->T / 32 + 3) + 4 * prm->n_obst);
  cudaError_t err = cudaFuncSetAttribute(fused_panda_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_panda_step_kernel<<<prm->P, NT, smem, (cudaStream_t)stream>>>(
      means, prec_u, anchors, W, spheres, eps, new_means, costs, *prm, *chain);
  return (int)cudaGetLastError();
}
