// One whole planar StochGPMP iteration per particle, in one kernel.
//
// Replaces two TPU kernels of stoch_gpmp_tpu/ops/pallas/fused_step.py:
// make_fused_planar_step_batched (_kernel_batched, _box_muller, and the
// stencil quadratic of ops/pallas/stencil.py flat_quad_cost) through
// fused_planar_step_launch, and make_fused_planar_step (_kernel, one program
// per particle with its own seed pair) through
// fused_planar_step_per_particle_launch. On this card the two differ only in
// where the Philox key comes from: one 64-bit seed per launch, with the
// particle in the counter, or one int32 seed pair per particle (seeds
// [P, 2]), with the particle's stream a function of its pair alone. The eps
// operand mode is the same function for both. Per particle p and sample s,
// with M = T * 2 * n_dof lanes:
//   x      = mu_p + eps_s @ W                       (eps: operand or Philox)
//   cost_s = x A x - 2 b_p.x                        (matmul branch; the
//            per-goal constant c cancels in the softmax), or the exact
//            factor-graph stencil energy of x        (stencil branch)
//          + k_coll * sum_{t>=1} raster(x_t, y_t)   (raster_common.cuh)
//          + tau * x.(Sigma^{-1} mu_p)
//   w      = softmax_s(-cost / tau)
//   mu_p  += step * sum_s w_s (x_s - mu_p)
//
// Bound on the H100: at parity (P = 15, S = 128, M = 256) the two
// [S, M] x [M, M] products are 2 x 16.8 MFLOP per particle in plain FP32
// FMA (no TF32: the quadratic carries 1.5e8 weights), and only 15 blocks
// run, so the kernel is latency bound on 15 of 132 SMs, not bound by
// FLOPs or bytes. Design, simple first: one block per particle with one
// thread per lane m; samples go in tiles of ST rows; W (and A) stream in
// K-tiles of KT rows through two shared-memory buffers by cp.async, the next
// K-tile in flight while the current one is multiplied (W alone is 256 KB,
// more than a block's 227 KB; kernel_common.cuh); block reductions give each row's
// quadratic, linear, collision and importance sums; sample rows go to a
// scratch [P, S, M] buffer (2 MB at parity, L2 resident) for the final
// weighted update. No selection or segment matmuls: the position lanes
// t*2d and t*2d+1 are read directly. Filling the card (more than one block
// per particle) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"
#include "raster_common.cuh"

namespace {

constexpr int ST = 16;  // sample rows per tile
constexpr int KT = 32;  // K rows of W / A per shared-memory tile
constexpr int MAX_LANES = 512;

struct StepParams {
  int P, S, M, n_dof, use_stencil, n_rects, n_circles, nx, ny;
  float dt, q11, q12, q22, ks11, ks12, ks22, kg11, kg12, kg22;
  float cell_size, inv_cell_size, k_coll, temperature, step_size;
  uint2 key;
};

// kSeedPerParticle: Philox keyed on the particle's own int32 seed pair
// (seeds [P, 2], K9) instead of the launch's key with the particle in the
// counter (K2). A template parameter, so that K2's instantiation carries no
// trace of K9's branch.
template <bool kSeedPerParticle>
__global__ void __launch_bounds__(MAX_LANES)
fused_planar_step_kernel(const float* __restrict__ means, const float* __restrict__ prec_u,
                         const float* __restrict__ W, const float* __restrict__ lin_rows,
                         const float* __restrict__ A, const int* __restrict__ rects,
                         const float* __restrict__ circles, const float* __restrict__ eps,
                         const int* __restrict__ seeds, float* __restrict__ new_means,
                         float* __restrict__ costs, float* __restrict__ xs, StepParams prm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = prm.M, S = prm.S, p = blockIdx.x, m = threadIdx.x;
  const int nwarps = M >> 5, lane = m & 31, warp = m >> 5;
  float* x_sh = smem;                    // [ST][M]: eps tile, then x tile
  float* g_sh = x_sh + ST * M;           // [2][KT][M]: K-tiles of W or A
  float* red_sh = g_sh + 2 * KT * M;     // [nwarps][ST][4]
  float* cost_sh = red_sh + nwarps * ST * 4;  // [S]
  float* scratch = cost_sh + S;          // [32]
  int* rects_sh = reinterpret_cast<int*>(scratch + 32);  // [R][4]
  float* circ_sh = scratch + 32 + 4 * prm.n_rects;       // [C][3]
  for (int i = m; i < 4 * prm.n_rects; i += M) rects_sh[i] = rects[i];
  for (int i = m; i < 3 * prm.n_circles; i += M) circ_sh[i] = circles[i];

  const int sd = 2 * prm.n_dof;
  const float mu = means[(size_t)p * M + m];
  const float pu = prec_u[(size_t)p * M + m];
  const float lr = lin_rows[(size_t)p * M + m];
  const int md = (m + prm.n_dof) % M;  // lane of vel(t) for a pos lane
  const float lr_d = lin_rows[(size_t)p * M + md];
  const bool is_pos = (m % sd) < prm.n_dof;
  const bool mask_gp = is_pos && m < M - sd;
  const bool mask_s = is_pos && m < sd;
  const bool mask_g = is_pos && m >= M - sd;
  const bool coll_lane = (m % sd) == 0 && m >= sd;  // x of step t >= 1
  uint2 key = prm.key;         // Philox key and counter word
  uint32_t pc = (uint32_t)p;
  if (kSeedPerParticle) {
    key = make_uint2((uint32_t)seeds[2 * p], (uint32_t)seeds[2 * p + 1]);
    pc = 0u;
  }
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += ST) {
    const int nr = min(ST, S - s0);
    // --- 1. eps tile ------------------------------------------------------
    if (eps != nullptr) {
      for (int i = 0; i < ST; ++i)
        x_sh[i * M + m] = i < nr ? eps[((size_t)p * S + s0 + i) * M + m] : 0.0f;
    } else {
      for (int j = 0; j < ST / 2; ++j) {
        const uint4 bits =
            philox4x32_10(make_uint4((uint32_t)m, (uint32_t)(s0 + j), pc, 0u), key);
        const float2 z = box_muller(bits.x, bits.y);
        x_sh[j * M + m] = z.x;
        x_sh[(j + ST / 2) * M + m] = z.y;
      }
    }
    // --- 2. x = mu + eps @ W ------------------------------------------------
    float acc[ST];
#pragma unroll
    for (int i = 0; i < ST; ++i) acc[i] = 0.0f;
    tile_matmul<ST, KT>(x_sh, W, g_sh, M, acc);
    __syncthreads();  // every thread is done reading the eps tile
    float xv[ST];
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      xv[i] = mu + acc[i];
      x_sh[i * M + m] = xv[i];
      if (i < nr) xs[((size_t)p * S + s0 + i) * M + m] = xv[i];
    }
    __syncthreads();
    // --- 3. quadratic: x A (matmul branch) --------------------------------
    if (!prm.use_stencil) {
#pragma unroll
      for (int i = 0; i < ST; ++i) acc[i] = 0.0f;
      tile_matmul<ST, KT>(x_sh, A, g_sh, M, acc);
    }
    // --- 4./5. per-row sums: quad, linear, collision, importance ------------
#pragma unroll  // acc and xv stay in registers only under full unrolling
    for (int i = 0; i < ST; ++i) {
      const float x = xv[i];
      float v0, v1;
      if (!prm.use_stencil) {
        v0 = acc[i] * x;
        v1 = x * lr;
      } else {  // flat_quad_cost: residuals at the pos lanes, rolled lanes
        const float* row = x_sh + i * M;
        const float xd = row[md];
        const float x1 = row[(m + sd) % M];
        const float x1d = row[(m + sd + prm.n_dof) % M];
        const float rp = x + prm.dt * xd - x1;
        const float rv = xd - x1d;
        v0 = mask_gp ? prm.q11 * rp * rp + 2.0f * prm.q12 * rp * rv + prm.q22 * rv * rv
                     : 0.0f;
        const float df = x - lr, dfd = xd - lr_d;
        const float es = prm.ks11 * df * df + 2.0f * prm.ks12 * df * dfd + prm.ks22 * dfd * dfd;
        const float eg = prm.kg11 * df * df + 2.0f * prm.kg12 * df * dfd + prm.kg22 * dfd * dfd;
        v1 = (mask_s ? es : 0.0f) + (mask_g ? eg : 0.0f);
      }
      const float v2 = coll_lane
          ? raster_count(x, x_sh[i * M + m + 1], rects_sh, prm.n_rects, circ_sh,
                         prm.n_circles, prm.cell_size, prm.inv_cell_size, prm.nx,
                         prm.ny)
          : 0.0f;
      const float v3 = x * pu;
      const float r0 = warp_sum(v0), r1 = warp_sum(v1), r2 = warp_sum(v2), r3 = warp_sum(v3);
      if (lane == 0) {
        float* dst = red_sh + (warp * ST + i) * 4;
        dst[0] = r0; dst[1] = r1; dst[2] = r2; dst[3] = r3;
      }
    }
    __syncthreads();
    if (m < nr) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      for (int w = 0; w < nwarps; ++w) {
        const float* src = red_sh + (w * ST + m) * 4;
        a0 += src[0]; a1 += src[1]; a2 += src[2]; a3 += src[3];
      }
      float c = prm.use_stencil ? a0 + a1 : a0 - 2.0f * a1;
      c = c + prm.k_coll * a2;
      c = c + prm.temperature * a3;
      cost_sh[s0 + m] = c;
    }
    __syncthreads();
  }

  // --- 6. softmax over the particle's S samples, then the mean update ------
  float mx = __int_as_float(0xff800000);  // -inf
  for (int s = m; s < S; s += M) {
    costs[(size_t)p * S + s] = cost_sh[s];
    mx = fmaxf(mx, -cost_sh[s] / prm.temperature);
  }
  mx = block_reduce<true>(mx, scratch);
  float sum = 0.0f;
  for (int s = m; s < S; s += M) {
    const float e = expf(-cost_sh[s] / prm.temperature - mx);
    cost_sh[s] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, scratch);
  __syncthreads();  // every e_s is in cost_sh
  float grad = 0.0f;
  for (int s = 0; s < S; ++s)
    grad = fmaf(cost_sh[s] / sum, xs[((size_t)p * S + s) * M + m] - mu, grad);
  new_means[(size_t)p * M + m] = mu + prm.step_size * grad;
}

int launch(const float* means, const float* prec_u, const float* W,
           const float* lin_rows, const float* A, const int* rects, int n_rects,
           const float* circles, int n_circles, const float* eps, const int* seeds,
           unsigned long long seed, float* new_means, float* costs, float* xs, int P,
           int S, int M, int n_dof, int use_stencil, float dt, float q11, float q12,
           float q22, float ks11, float ks12, float ks22, float kg11, float kg12,
           float kg22, float cell_size, float inv_cell_size, int nx, int ny,
           float k_coll, float temperature, float step_size, void* stream) {
  if (M % 32 != 0 || M > MAX_LANES || (!use_stencil && A == nullptr))
    return (int)cudaErrorInvalidValue;
  StepParams prm{P, S, M, n_dof, use_stencil, n_rects, n_circles, nx, ny,
                 dt, q11, q12, q22, ks11, ks12, ks22, kg11, kg12, kg22,
                 cell_size, inv_cell_size, k_coll, temperature, step_size,
                 make_uint2((uint32_t)seed, (uint32_t)(seed >> 32))};
  const size_t smem = sizeof(float) * ((size_t)ST * M + (size_t)2 * KT * M +
                                       (size_t)(M / 32) * ST * 4 + S + 32 +
                                       4 * n_rects + 3 * n_circles);
  // with eps the key is unused: K9's eps mode runs K2's instantiation
  const auto kernel = seeds != nullptr ? fused_planar_step_kernel<true>
                                       : fused_planar_step_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<P, M, smem, (cudaStream_t)stream>>>(means, prec_u, W, lin_rows, A, rects, circles,
                                               eps, seeds, new_means, costs, xs, prm);
  return (int)cudaGetLastError();
}

}  // namespace

// K2: eps (or null) and one 64-bit seed per launch
extern "C" int fused_planar_step_launch(
    const float* means, const float* prec_u, const float* W, const float* lin_rows,
    const float* A, const int* rects, int n_rects, const float* circles, int n_circles,
    const float* eps, unsigned long long seed, float* new_means, float* costs, float* xs,
    int P, int S, int M, int n_dof, int use_stencil, float dt, float q11, float q12,
    float q22, float ks11, float ks12, float ks22, float kg11, float kg12, float kg22,
    float cell_size, float inv_cell_size, int nx, int ny, float k_coll,
    float temperature, float step_size, void* stream) {
  return launch(means, prec_u, W, lin_rows, A, rects, n_rects, circles, n_circles, eps,
                nullptr, seed, new_means, costs, xs, P, S, M, n_dof, use_stencil, dt, q11,
                q12, q22, ks11, ks12, ks22, kg11, kg12, kg22, cell_size, inv_cell_size, nx,
                ny, k_coll, temperature, step_size, stream);
}

// K9: eps (or null) and one int32 seed pair per particle (seeds [P, 2], or
// null with eps)
extern "C" int fused_planar_step_per_particle_launch(
    const float* means, const float* prec_u, const float* W, const float* lin_rows,
    const float* A, const int* rects, int n_rects, const float* circles, int n_circles,
    const float* eps, const int* seeds, float* new_means, float* costs, float* xs,
    int P, int S, int M, int n_dof, int use_stencil, float dt, float q11, float q12,
    float q22, float ks11, float ks12, float ks22, float kg11, float kg12, float kg22,
    float cell_size, float inv_cell_size, int nx, int ny, float k_coll,
    float temperature, float step_size, void* stream) {
  if ((eps == nullptr) == (seeds == nullptr)) return (int)cudaErrorInvalidValue;
  return launch(means, prec_u, W, lin_rows, A, rects, n_rects, circles, n_circles, eps,
                seeds, 0ULL, new_means, costs, xs, P, S, M, n_dof, use_stencil, dt, q11,
                q12, q22, ks11, ks12, ks22, kg11, kg12, kg22, cell_size, inv_cell_size, nx,
                ny, k_coll, temperature, step_size, stream);
}
