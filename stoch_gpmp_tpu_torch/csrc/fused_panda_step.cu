// K6: one whole flat-layout Panda StochGPMP iteration per particle, in one
// kernel launch: each particle is a thread-block cluster of c CTAs that
// split its samples.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/panda_step.py
// make_fused_panda_step (_kernel). Per particle p and sample s, with
// M = T * 2d lanes in the flat t-major layout (lane t * 2d + j holds pos_j(t),
// lane t * 2d + d + j holds vel_j(t)):
//   pu     = Sigma^{-1} mu_p, the sampling prior's stencil (prec_u_lane)
//   x      = mu_p + eps_s @ W                      (eps: operand or Philox)
//   cost_s = the factor-graph stencil energy of x with the start and goal
//            anchors (stencil.py flat_quad_cost)
//          + tau * x . pu
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
// Split: the c CTAs of a particle's cluster own whole tiles of ST = 4 sample
// rows, ceil(tiles / c) each (config 4, P = 5, S = 32, T = 64, M = 896,
// c = 8: one tile per CTA, 40 CTAs). A CTA draws its rows' eps (Philox
// counter (lane, sample pair, particle, 0): the tiles hold whole pairs, so
// the draws do not depend on c), computes Sigma^{-1} mu from mu, forms
// x = mu + eps @ W (M / 2 threads in KS = 4 K groups, each thread 4 rows x 8
// columns of a quarter of every K-tile; W streamed in K-tiles of KT rows
// through a ring of up to six buffers, as many as the shared memory holds,
// one TMA bulk copy each; kernel_common.cuh KtileRing, tile_matmul_splitk),
// keeps its x rows in shared memory, sums
// each row's stencil energy, anchors and importance (one warp per row) and
// runs FK, the link fields and the SE(3) goal per (sample, t) point of its
// rows, one thread per point (the walk specialised for the Panda, the link
// positions in registers; the generic walk's in the shared memory the W
// tiles used, fk_chain.cuh). The softmax over the S samples and the mean update run
// across the cluster through distributed shared memory
// (cluster_softmax_update), so no sample row goes to device memory.
//
// Bound on the H100: each CTA multiplies 4 rows by W, 2 x 4 x 896^2 = 6.4
// MFLOP of IEEE FP32 FMA (~13 us at one SM's share of 67 TFLOP/s; no TF32),
// and streams all of W, 3.2 MB, from L2 (128 MB of L2 reads per launch
// across 40 CTAs). The stream sets the pace: by the clock64 phase timing of
// tools/fused_timing.py (phases) the product takes ~73% of the time, ~27 B
// per cycle into each SM, and a 4-row tile takes as long with 5 CTAs on the
// card as with 40, so the limit is per SM (the same ring filled by cp.async
// was slower). FK, the link fields and the goal (256 points of ~1,200
// operations per CTA, ~17%) and the cluster combine (~6%) add the rest.
// Cutting the stream needs a lane split (each CTA 1/8 of W's columns, all
// samples) or a TMA multicast of each K-tile to the cluster.

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
  PriorStencil prior;  // the sampling prior's Sigma^{-1}
  unsigned int key_lo, key_hi;
};

namespace {

constexpr int ST = 4;  // sample rows per tile: the rows of one product
constexpr int KT = 8;  // K rows of W per shared-memory tile
constexpr int MAX_STAGES = 6;  // K-tile buffers at most
constexpr int C = 2;   // lanes per thread: blockDim.x = M / C
constexpr int KS = 4;  // K groups of the product: M / 8 threads, 4 rows x 8 columns each
constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

__device__ __forceinline__ float quad2(float a11, float a12, float a22, float r, float s) {
  return a11 * r * r + 2.0f * a12 * r * s + a22 * s * s;
}

// Floats of dynamic shared memory besides the W K-tiles: mu, pu and the
// anchor row [M] each; the CTA's x rows [tiles_per_cta * ST][M]; one eps
// tile [ST][M] (then the partial update); per own row its stencil sum,
// field sums [T / 32], goal, cost and weight; 32 floats of reduction
// scratch; the spheres. The K-tiles [stages][KT][M] come after, and the
// link positions [3 L][M / C] take their place once they are consumed.
size_t fixed_floats(int M, int T, int tiles_per_cta, int n_obst) {
  const size_t rows = (size_t)tiles_per_cta * ST;
  return 3 * (size_t)M + (rows + ST) * M + rows * (T / 32 + 4) + 32 + 4 * (size_t)n_obst;
}

size_t union_floats(int M, int stages, int n_links) {
  const size_t tiles = (size_t)stages * KT * M, pos = 3 * (size_t)n_links * (M / C);
  return tiles > pos ? tiles : pos;
}

// minimum one block per SM: ptxas may then use up to 128 registers (65,536 /
// 512) and needs no spills. VARIANT: the chain's FK spec (fk_spec.h; 1
// FkPanda, link positions in registers; 0 the generic walk).
template <int VARIANT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
fused_panda_step_kernel(const float* __restrict__ means, const float* __restrict__ anchors,
                        const float* __restrict__ W, const float* __restrict__ spheres,
                        const float* __restrict__ eps, float* __restrict__ new_means,
                        float* __restrict__ costs, int ctas, int tiles_per_cta, int stages,
                        const __grid_constant__ PandaStepParams prm,
                        const __grid_constant__ FkChain chain) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NT = blockDim.x, M = C * NT, T = prm.T, S = prm.S, D = prm.D, sd = 2 * D;
  const int p = blockIdx.x / ctas, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int nwarps = NT >> 5, wpr = T >> 5;  // warps per block, per sample row of T points
  const int tpc = tiles_per_cta, n_tiles = (S + ST - 1) / ST, L = chain.n_links;
  const int t0 = rank * tpc, t1 = min(n_tiles, t0 + tpc), row0 = t0 * ST;
  const int nrows = max(0, min(S, t1 * ST) - row0), rows = tpc * ST;
  float* mu_sh = smem;                                  // [M]
  float* pu_sh = mu_sh + M;                             // [M]
  float* anc_sh = pu_sh + M;                            // [M]
  float* rows_sh = anc_sh + M;                          // [rows][M]: the CTA's x rows
  float* tile_sh = rows_sh + (size_t)rows * M;          // [ST][M]: eps
  float* un_sh = tile_sh + ST * M;                      // W K-tiles, then link positions
  float* rowq_sh = un_sh + max(stages * KT * M, 3 * L * NT);  // [rows]
  float* field_sh = rowq_sh + rows;                     // [rows][wpr]
  float* goal_sh = field_sh + rows * wpr;               // [rows]
  float* cost_sh = goal_sh + rows;                      // [rows]
  float* w_sh = cost_sh + rows;                         // [rows]
  float* scratch = w_sh + rows;                         // [32]
  float4* sph = reinterpret_cast<float4*>(scratch + 32);  // [n_obst]
  load_spheres(spheres, prm.n_obst, sph);
  for (int m = tid; m < M; m += NT) {
    mu_sh[m] = means[(size_t)p * M + m];
    anc_sh[m] = anchors[(size_t)p * M + m];
  }
  __syncthreads();
  for (int m = tid; m < M; m += NT) pu_sh[m] = prec_u_lane(mu_sh, m, M, D, prm.prior);

  // --- 1./2. per tile: eps rows, then x = mu + eps @ W ----------------------------
  const uint2 key = make_uint2(prm.key_lo, prm.key_hi);
  __shared__ uint64_t ring_bars[MAX_STAGES];
  const KtileRing<KT> ring{un_sh, W, M, stages, ring_bars};
  for (int tile = t0; tile < t1; ++tile) {
    const int s0 = tile * ST, nr = min(ST, S - s0);
    if (eps != nullptr) {
      for (int k = tid; k < ST * M; k += NT) {
        const int i = k / M;
        tile_sh[k] = i < nr ? eps[((size_t)p * S + s0 + i) * M + (k - i * M)] : 0.0f;
      }
    } else {
      for (int j = 0; j < ST / 2; ++j)
        for (int m = tid; m < M; m += NT) {
          const uint4 bits = philox4x32_10(
              make_uint4((uint32_t)m, (uint32_t)(s0 / 2 + j), (uint32_t)p, 0u), key);
          const float2 z = box_muller(bits.x, bits.y);
          tile_sh[(2 * j) * M + m] = z.x;
          tile_sh[(2 * j + 1) * M + m] = z.y;
        }
    }
    tile_matmul_splitk<KT, KS, ST, ST>(tile_sh, M, ring, mu_sh,
                                       rows_sh + (size_t)(tile - t0) * ST * M, M);
  }

  // --- 3. stencil energy + anchors + importance, one warp per sample row ----------
  for (int i = warp; i < nrows; i += nwarps) {
    const float* row = rows_sh + (size_t)i * M;
    float v = 0.0f;
    for (int m = lane; m < M; m += 32) {
      const float x = row[m];
      if (m % sd < D) {
        const float xd = row[m + D];
        if (m < M - sd) {  // a GP factor between t and t + 1
          const float rp = x + prm.dt * xd - row[m + sd];
          const float rv = xd - row[m + sd + D];
          v += quad2(prm.q11, prm.q12, prm.q22, rp, rv);
        }
        if (m < sd)  // the start anchor at t = 0
          v += quad2(prm.ks11, prm.ks12, prm.ks22, x - anc_sh[m], xd - anc_sh[m + D]);
        if (m >= M - sd)  // the goal anchor at t = T-1
          v += quad2(prm.kg11, prm.kg12, prm.kg22, x - anc_sh[m], xd - anc_sh[m + D]);
      }
      v += prm.temperature * x * pu_sh[m];
    }
    v = warp_sum(v);
    if (lane == 0) rowq_sh[i] = v;
  }

  // --- 4. FK + link fields per (sample, t); SE(3) goal at t = T-1 -----------------
  // nrows * T points in whole warps (T % 32 == 0, NT % 32 == 0): a warp's
  // points share s.
  float* pos_sh = un_sh;  // the W tiles are consumed
  for (int pt = tid; pt < nrows * T; pt += NT) {
    const int s = pt / T, t = pt - s * T;
    const float* xt = rows_sh + (size_t)s * M + t * sd;
    auto q = [&](int i) { return xt[i]; };
    float f = 0.0f, g = 0.0f;
    float ee_r[9];
    if constexpr (VARIANT == 1) {
      float pos[FkPanda::NL][3];
      fk_walk_spec<FkPanda>(chain, q, pos, ee_r);
      if (t >= 1)
        f = link_fields<FkPanda::NL>([&](int l, int c) { return pos[l][c]; }, FkPanda::NL, sph,
                                     prm.n_obst, prm.inv_2m2, prm.w_self, prm.w_obst);
      if (t == T - 1 && prm.w_goal != 0.0f) {
        const float dist = ee_goal_distance(pos[FkPanda::NL - 1], ee_r, prm.target, prm.w_pos,
                                            prm.w_rot);
        g = prm.w_goal * (dist * dist);
      }
    } else {
      float* col = pos_sh + tid;
      fk_walk(chain, q, col, NT, ee_r);
      auto pos = [&](int l, int c) { return col[(3 * l + c) * NT]; };
      if (t >= 1)
        f = link_fields<0>(pos, L, sph, prm.n_obst, prm.inv_2m2, prm.w_self, prm.w_obst);
      if (t == T - 1 && prm.w_goal != 0.0f) {
        const float ee[3] = {pos(L - 1, 0), pos(L - 1, 1), pos(L - 1, 2)};
        const float dist = ee_goal_distance(ee, ee_r, prm.target, prm.w_pos, prm.w_rot);
        g = prm.w_goal * (dist * dist);
      }
    }
    if (t == T - 1) goal_sh[s] = g;
    f = warp_sum(f);
    if (lane == 0) field_sh[s * wpr + (t >> 5)] = f;
  }
  __syncthreads();

  // --- 5. per-sample cost ------------------------------------------------------------
  for (int i = tid; i < nrows; i += NT) {
    float c = rowq_sh[i];
    for (int k = 0; k < wpr; ++k) c += field_sh[i * wpr + k];
    c += goal_sh[i];
    cost_sh[i] = c;
    costs[(size_t)p * S + row0 + i] = c;
  }

  // --- 6. softmax over the particle's S samples and the mean update, across
  // the cluster; the eps tile holds this CTA's partial update
  cluster_softmax_update(cost_sh, nrows, rows, S, rows_sh, M, mu_sh, w_sh, tile_sh, scratch, M,
                         prm.temperature, prm.step_size, new_means + (size_t)p * M);
}

bool valid(const PandaStepParams* prm, const FkChain* chain, int ctas, int variant) {
  const int M = 2 * prm->D * prm->T;
  return M % (32 * C) == 0 && M / C <= MAX_THREADS && prm->T % 32 == 0 && prm->D >= 1 &&
         prm->D <= FK_MAX_JOINTS && prm->S >= 1 && prm->P >= 1 && prm->n_obst >= 0 &&
         ctas >= 1 && ctas <= MAX_CLUSTER && fk_variant_valid(*chain, variant);
}

using KernelFn = decltype(&fused_panda_step_kernel<0>);

KernelFn kernel_for(int variant) {
  return variant == 1 ? fused_panda_step_kernel<1> : fused_panda_step_kernel<0>;
}

// The launch at this shape: tiles per CTA, K-tile buffers and the dynamic
// shared memory per CTA in bytes; refuses a CTA whose shared memory exceeds
// kSmemLimit.
cudaError_t configure(const PandaStepParams* prm, const FkChain* chain, int ctas, int variant,
                      int* tiles_per_cta, int* stages, size_t* smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, cudaStream_t stream) {
  const int M = 2 * prm->D * prm->T, tiles = (prm->S + ST - 1) / ST;
  *tiles_per_cta = (tiles + ctas - 1) / ctas;
  const size_t fixed = sizeof(float) * fixed_floats(M, prm->T, *tiles_per_cta, prm->n_obst);
  *stages = pick_stages(fixed, KT, M, MAX_STAGES);
  *smem = fixed + sizeof(float) * union_floats(M, *stages, chain->n_links);
  if (*smem > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_for(variant), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(prm->P * ctas);
  cfg->blockDim = dim3(M / C);
  cfg->dynamicSmemBytes = *smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" int fused_panda_step_launch(const float* means, const float* anchors,
                                       const float* W, const float* spheres, const float* eps,
                                       float* new_means, float* costs, int ctas, int variant,
                                       const PandaStepParams* prm, const FkChain* chain,
                                       void* stream) {
  if (!valid(prm, chain, ctas, variant)) return (int)cudaErrorInvalidValue;
  int tpc, stages;
  size_t smem;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      configure(prm, chain, ctas, variant, &tpc, &stages, &smem, &cfg, &attr,
                (cudaStream_t)stream);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, kernel_for(variant), means, anchors, W, spheres, eps,
                             new_means, costs, ctas, tpc, stages, *prm, *chain);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch at this shape, into shape[4]: the clusters resident at once (0
// where a CTA's shared memory exceeds kSmemLimit or not even one cluster
// fits), the dynamic shared memory per CTA in bytes, the K-tile buffers and
// the tiles per CTA, as configure lays the CTA out.
extern "C" int fused_panda_step_max_clusters(const PandaStepParams* prm, const FkChain* chain,
                                             int ctas, int variant, int* shape) {
  if (!valid(prm, chain, ctas, variant)) return (int)cudaErrorInvalidValue;
  int tpc, stages;
  size_t smem;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err =
      configure(prm, chain, ctas, variant, &tpc, &stages, &smem, &cfg, &attr, nullptr);
  shape[0] = 0;
  shape[1] = (int)smem;
  shape[2] = stages;
  shape[3] = tpc;
  if (smem > kSmemLimit) return (int)cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(shape, (void*)kernel_for(variant), &cfg);
}
