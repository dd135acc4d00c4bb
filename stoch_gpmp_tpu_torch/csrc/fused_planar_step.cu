// One whole planar StochGPMP iteration per particle, in one kernel launch:
// each particle is a thread-block cluster of c CTAs that split its samples.
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
//   pu     = Sigma^{-1} mu_p, the sampling prior's stencil (prec_u_lane)
//   x      = mu_p + eps_s @ W                       (eps: operand or Philox)
//   cost_s = x A x - 2 b_p.x                        (matmul branch; the
//            per-goal constant c cancels in the softmax), or the exact
//            factor-graph stencil energy of x        (stencil branch)
//          + k_coll * sum_{t>=1} raster(x_t, y_t)   (raster_common.cuh)
//          + tau * x.pu
//   w      = softmax_s(-cost / tau)
//   mu_p  += step * sum_s w_s (x_s - mu_p)
//
// Split: the c CTAs of a particle's cluster own whole 16-row sample tiles,
// ceil(tiles / c) each (at parity, P = 15, S = 128, M = 256, c = 8: one tile
// per CTA, 120 CTAs). A CTA draws its tiles' eps (the Philox counter
// (lane, tile row pair, particle, 0) does not depend on c), forms x = mu +
// eps @ W and, in the matmul branch, x A, keeps its x rows in shared memory
// and writes its row costs; the softmax and the update then run across the
// cluster through distributed shared memory (cluster_softmax_update,
// kernel_common.cuh), so no sample row goes to device memory. Each CTA also
// computes Sigma^{-1} mu from mu itself. The two [16, M] x [M, M] products
// are register-blocked (kernel_common.cuh tile_matmul_2d): thread (warp w,
// lane l) owns the columns 4 (8 w + l % 8) .. +3 and the rows l / 8 + 4 i
// (i < 4), so a warp reads each 16-byte segment of W (A) once for four rows
// and each row segment once for eight column groups; the x rows are padded
// to M + 4 floats so the four rows a warp reads at once fall in distinct
// banks. W and A stream in K-tiles of KT rows through a ring of up to four
// buffers, one TMA bulk copy per K-tile (KtileRing).
//
// Bound on the H100: 2 x 2.1 MFLOP of IEEE FP32 FMA per CTA at parity (no
// TF32: the quadratic carries 1.5e8 weights), ~9 us at one SM's share of
// 67 TFLOP/s; each CTA also streams W and A (512 KB) from L2 (W alone is
// 256 KB, more than a block's 227 KB). By the clock64 phase timing of
// tools/fused_timing.py (phases) the two products take ~57% of the time at
// ~40% of the FP32 peak: the 4 x 4 block reads 8 shared-memory wavefronts
// per 16 FMAs per thread per K step, so the shared-memory pipe, not the FP32
// pipes, sets their pace (an 8 x 8 split-K block spilled and was slower).
// The per-row sums (~17%: the raster loop over the obstacles), the cluster
// combine (~13%: three cluster barriers, S + M distributed reads per CTA)
// and the draws (~6%) add the rest.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_common.cuh"
#include "raster_common.cuh"

namespace {

constexpr int ST = 16;  // sample rows per tile; Philox draws rows j and j + 8
constexpr int KT = 32;  // K rows of W / A per shared-memory tile
constexpr int MAX_STAGES = 4;  // K-tile buffers at most
constexpr int MAX_LANES = 512;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

struct StepParams {
  int P, S, M, n_dof, use_stencil, n_rects, n_circles, nx, ny, ctas, tiles_per_cta, stages;
  float dt, q11, q12, q22, ks11, ks12, ks22, kg11, kg12, kg22;
  float cell_size, inv_cell_size, k_coll, temperature, step_size;
  PriorStencil prior;
  uint2 key;
};

// Floats of dynamic shared memory besides the K-tiles: mu, pu and lin rows
// [M] each; the CTA's x rows [tiles_per_cta * ST][M + 4]; one tile
// [ST][M + 4] (eps, then x A, then the partial update); costs and weights
// of the CTA's rows; 32 floats of reduction scratch; the rectangles and
// circles. The K-tiles [stages][KT][M] come after.
size_t fixed_floats(int M, int tiles_per_cta, int n_rects, int n_circles) {
  const size_t lda = (size_t)M + 4, rows = (size_t)tiles_per_cta * ST;
  return 3 * (size_t)M + (rows + ST) * lda + 2 * rows + 32 + 4 * (size_t)n_rects +
         3 * (size_t)n_circles;
}

// kSeedPerParticle: Philox keyed on the particle's own int32 seed pair
// (seeds [P, 2], K9) instead of the launch's key with the particle in the
// counter (K2). A template parameter, so that K2's instantiation carries no
// trace of K9's branch.
template <bool kSeedPerParticle>
__global__ void __launch_bounds__(MAX_LANES, 1)
fused_planar_step_kernel(const float* __restrict__ means, const float* __restrict__ W,
                         const float* __restrict__ lin_rows, const float* __restrict__ A,
                         const int* __restrict__ rects, const float* __restrict__ circles,
                         const float* __restrict__ eps, const int* __restrict__ seeds,
                         float* __restrict__ new_means, float* __restrict__ costs,
                         const __grid_constant__ StepParams prm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = prm.M, S = prm.S, m = threadIdx.x, lda = M + 4;
  const int p = blockIdx.x / prm.ctas;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int tpc = prm.tiles_per_cta, n_tiles = (S + ST - 1) / ST;
  const int t0 = rank * tpc, t1 = min(n_tiles, t0 + tpc);
  const int nrows = max(0, min(S, t1 * ST) - t0 * ST);
  float* mu_sh = smem;                      // [M]
  float* pu_sh = mu_sh + M;                 // [M]
  float* lr_sh = pu_sh + M;                 // [M]
  float* rows_sh = lr_sh + M;               // [tpc * ST][lda]: the CTA's x rows
  float* tile_sh = rows_sh + tpc * ST * lda;  // [ST][lda]: eps, then x A
  float* g_sh = tile_sh + ST * lda;         // [stages][KT][M]: K-tiles of W or A
  float* cost_sh = g_sh + prm.stages * KT * M;  // [tpc * ST]
  float* w_sh = cost_sh + tpc * ST;         // [tpc * ST]
  float* scratch = w_sh + tpc * ST;         // [32]
  int* rects_sh = reinterpret_cast<int*>(scratch + 32);  // [R][4]
  float* circ_sh = scratch + 32 + 4 * prm.n_rects;       // [C][3]
  for (int i = m; i < 4 * prm.n_rects; i += M) rects_sh[i] = rects[i];
  for (int i = m; i < 3 * prm.n_circles; i += M) circ_sh[i] = circles[i];
  mu_sh[m] = means[(size_t)p * M + m];
  lr_sh[m] = lin_rows[(size_t)p * M + m];

  const int nd = prm.n_dof, sd = 2 * nd, T = M / sd;
  const int lane = m & 31, warp = m >> 5, nwarps = M >> 5;
  const int rg = lane >> 3, col0 = 4 * (8 * warp + (lane & 7));  // product layout
  __shared__ uint64_t ring_bars[MAX_STAGES];
  const KtileRing<KT> ring_w{g_sh, W, M, prm.stages, ring_bars};
  const KtileRing<KT> ring_a{g_sh, A, M, prm.stages, ring_bars};
  uint2 key = prm.key;  // Philox key and counter word
  uint32_t pc = (uint32_t)p;
  if (kSeedPerParticle) {
    key = make_uint2((uint32_t)seeds[2 * p], (uint32_t)seeds[2 * p + 1]);
    pc = 0u;
  }
  __syncthreads();
  pu_sh[m] = prec_u_lane(mu_sh, m, M, nd, prm.prior);  // read after the next barrier

  for (int tile = t0; tile < t1; ++tile) {
    const int s0 = tile * ST, nr = min(ST, S - s0);
    float* xt = rows_sh + (tile - t0) * ST * lda;
    // --- 1. eps tile ------------------------------------------------------
    if (eps != nullptr) {
      for (int i = 0; i < ST; ++i)
        tile_sh[i * lda + m] = i < nr ? eps[((size_t)p * S + s0 + i) * M + m] : 0.0f;
    } else {
      for (int j = 0; j < ST / 2; ++j) {
        const uint4 bits =
            philox4x32_10(make_uint4((uint32_t)m, (uint32_t)(s0 + j), pc, 0u), key);
        const float2 z = box_muller(bits.x, bits.y);
        tile_sh[j * lda + m] = z.x;
        tile_sh[(j + ST / 2) * lda + m] = z.y;
      }
    }
    // --- 2. x = mu + eps @ W ------------------------------------------------
    float acc[4][4] = {};
    tile_matmul_2d<KT, 4>(tile_sh, lda, rg, 4, ring_w, col0, acc);
    const float4 mu4 = *reinterpret_cast<const float4*>(mu_sh + col0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(xt + (rg + 4 * i) * lda + col0) =
          make_float4(mu4.x + acc[i][0], mu4.y + acc[i][1], mu4.z + acc[i][2],
                      mu4.w + acc[i][3]);
    // --- 3. x A into the tile buffer (matmul branch) -------------------------
    if (!prm.use_stencil) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
      tile_matmul_2d<KT, 4>(xt, lda, rg, 4, ring_a, col0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(tile_sh + (rg + 4 * i) * lda + col0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    // --- 4. per-row sums, one warp per row: quad, linear, collision, importance
    for (int i = warp; i < nr; i += nwarps) {
      const float* row = xt + i * lda;
      const float* xa = tile_sh + i * lda;
      float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
      for (int l = lane; l < M; l += 32) {
        const float x = row[l];
        if (!prm.use_stencil) {
          v0 += xa[l] * x;
          v1 += x * lr_sh[l];
        } else if (l % sd < nd) {  // flat_quad_cost: residuals at the pos lanes
          const float xd = row[l + nd];
          if (l < M - sd) {
            const float rp = x + prm.dt * xd - row[l + sd];
            const float rv = xd - row[l + sd + nd];
            v0 += prm.q11 * rp * rp + 2.0f * prm.q12 * rp * rv + prm.q22 * rv * rv;
          }
          const float df = x - lr_sh[l], dfd = xd - lr_sh[l + nd];
          if (l < sd)
            v1 += prm.ks11 * df * df + 2.0f * prm.ks12 * df * dfd + prm.ks22 * dfd * dfd;
          if (l >= M - sd)
            v1 += prm.kg11 * df * df + 2.0f * prm.kg12 * df * dfd + prm.kg22 * dfd * dfd;
        }
        v3 += x * pu_sh[l];
      }
      for (int t = 1 + lane; t < T; t += 32)  // positions of steps t >= 1
        v2 += raster_count(row[t * sd], row[t * sd + 1], rects_sh, prm.n_rects, circ_sh,
                           prm.n_circles, prm.cell_size, prm.inv_cell_size, prm.nx, prm.ny);
      v0 = warp_sum(v0);
      v1 = warp_sum(v1);
      v2 = warp_sum(v2);
      v3 = warp_sum(v3);
      if (lane == 0) {
        float c = prm.use_stencil ? v0 + v1 : v0 - 2.0f * v1;
        c = c + prm.k_coll * v2;
        c = c + prm.temperature * v3;
        cost_sh[(tile - t0) * ST + i] = c;
        costs[(size_t)p * S + s0 + i] = c;
      }
    }
    __syncthreads();  // the tile buffer is free for the next tile
  }

  // --- 5. softmax over the particle's S samples and the mean update, across
  // the cluster; the tile buffer holds this CTA's partial update
  cluster_softmax_update(cost_sh, nrows, tpc * ST, S, rows_sh, lda, mu_sh, w_sh, tile_sh,
                         scratch, M, prm.temperature, prm.step_size,
                         new_means + (size_t)p * M);
}

// The launch at prm's shape; refuses a CTA whose shared memory exceeds
// kSmemLimit. *smem: the dynamic shared memory per CTA in bytes.
template <bool kSeedPerParticle>
cudaError_t configure(const StepParams& prm, size_t* smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, cudaStream_t stream) {
  *smem = sizeof(float) * (fixed_floats(prm.M, prm.tiles_per_cta, prm.n_rects, prm.n_circles) +
                           (size_t)prm.stages * KT * prm.M);
  if (*smem > kSmemLimit) return cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(fused_planar_step_kernel<kSeedPerParticle>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(prm.P * prm.ctas);
  cfg->blockDim = dim3(prm.M);
  cfg->dynamicSmemBytes = *smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = prm.ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// shape[4]: the clusters of the launch resident at once (0 where a CTA's
// shared memory exceeds kSmemLimit or not even one cluster fits), the
// dynamic shared memory per CTA in bytes, the K-tile buffers and the tiles
// per CTA, as configure and make_params lay the CTA out.
template <bool kSeedPerParticle>
cudaError_t query_shape(const StepParams& prm, int* shape) {
  size_t smem;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = configure<kSeedPerParticle>(prm, &smem, &cfg, &attr, nullptr);
  shape[0] = 0;
  shape[1] = (int)smem;
  shape[2] = prm.stages;
  shape[3] = prm.tiles_per_cta;
  if (smem > kSmemLimit) return cudaSuccess;
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(shape, fused_planar_step_kernel<kSeedPerParticle>, &cfg);
}

StepParams make_params(int P, int S, int M, int n_dof, int use_stencil, int n_rects,
                       int n_circles, int ctas, float dt, float q11, float q12, float q22,
                       float ks11, float ks12, float ks22, float kg11, float kg12, float kg22,
                       float cell_size, float inv_cell_size, int nx, int ny, float k_coll,
                       float temperature, float step_size, const PriorStencil* prior,
                       unsigned long long seed) {
  const int tiles = (S + ST - 1) / ST, tpc = (tiles + ctas - 1) / ctas;
  const int stages = pick_stages(sizeof(float) * fixed_floats(M, tpc, n_rects, n_circles), KT,
                                 M, MAX_STAGES);
  return StepParams{P, S, M, n_dof, use_stencil, n_rects, n_circles, nx, ny, ctas, tpc, stages,
                    dt, q11, q12, q22, ks11, ks12, ks22, kg11, kg12, kg22, cell_size,
                    inv_cell_size, k_coll, temperature, step_size, *prior,
                    make_uint2((uint32_t)seed, (uint32_t)(seed >> 32))};
}

bool valid(int P, int S, int M, int n_dof, int ctas) {
  return P >= 1 && S >= 1 && M % 32 == 0 && M <= MAX_LANES && n_dof >= 1 &&
         M % (2 * n_dof) == 0 && ctas >= 1 && ctas <= MAX_CLUSTER;
}

int launch(const float* means, const float* W, const float* lin_rows, const float* A,
           const int* rects, int n_rects, const float* circles, int n_circles,
           const float* eps, const int* seeds, unsigned long long seed, float* new_means,
           float* costs, int P, int S, int M, int n_dof, int use_stencil, int ctas, float dt,
           float q11, float q12, float q22, float ks11, float ks12, float ks22, float kg11,
           float kg12, float kg22, const PriorStencil* prior, float cell_size,
           float inv_cell_size, int nx, int ny, float k_coll, float temperature,
           float step_size, void* stream) {
  if (!valid(P, S, M, n_dof, ctas) || (!use_stencil && A == nullptr))
    return (int)cudaErrorInvalidValue;
  const StepParams prm = make_params(P, S, M, n_dof, use_stencil, n_rects, n_circles, ctas, dt,
                                     q11, q12, q22, ks11, ks12, ks22, kg11, kg12, kg22,
                                     cell_size, inv_cell_size, nx, ny, k_coll, temperature,
                                     step_size, prior, seed);
  size_t smem;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  // with eps the key is unused: K9's eps mode runs K2's instantiation
  if (seeds != nullptr) {
    err = configure<true>(prm, &smem, &cfg, &attr, (cudaStream_t)stream);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, fused_planar_step_kernel<true>, means, W, lin_rows, A,
                               rects, circles, eps, seeds, new_means, costs, prm);
  } else {
    err = configure<false>(prm, &smem, &cfg, &attr, (cudaStream_t)stream);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, fused_planar_step_kernel<false>, means, W, lin_rows, A,
                               rects, circles, eps, seeds, new_means, costs, prm);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// K2: eps (or null) and one 64-bit seed per launch; ctas CTAs per particle
extern "C" int fused_planar_step_launch(
    const float* means, const float* W, const float* lin_rows, const float* A,
    const int* rects, int n_rects, const float* circles, int n_circles, const float* eps,
    unsigned long long seed, float* new_means, float* costs, int P, int S, int M, int n_dof,
    int use_stencil, int ctas, float dt, float q11, float q12, float q22, float ks11,
    float ks12, float ks22, float kg11, float kg12, float kg22, const PriorStencil* prior,
    float cell_size, float inv_cell_size, int nx, int ny, float k_coll, float temperature,
    float step_size, void* stream) {
  return launch(means, W, lin_rows, A, rects, n_rects, circles, n_circles, eps, nullptr, seed,
                new_means, costs, P, S, M, n_dof, use_stencil, ctas, dt, q11, q12, q22, ks11,
                ks12, ks22, kg11, kg12, kg22, prior, cell_size, inv_cell_size, nx, ny, k_coll,
                temperature, step_size, stream);
}

// K9: eps (or null) and one int32 seed pair per particle (seeds [P, 2], or
// null with eps)
extern "C" int fused_planar_step_per_particle_launch(
    const float* means, const float* W, const float* lin_rows, const float* A,
    const int* rects, int n_rects, const float* circles, int n_circles, const float* eps,
    const int* seeds, float* new_means, float* costs, int P, int S, int M, int n_dof,
    int use_stencil, int ctas, float dt, float q11, float q12, float q22, float ks11,
    float ks12, float ks22, float kg11, float kg12, float kg22, const PriorStencil* prior,
    float cell_size, float inv_cell_size, int nx, int ny, float k_coll, float temperature,
    float step_size, void* stream) {
  if ((eps == nullptr) == (seeds == nullptr)) return (int)cudaErrorInvalidValue;
  return launch(means, W, lin_rows, A, rects, n_rects, circles, n_circles, eps, seeds, 0ULL,
                new_means, costs, P, S, M, n_dof, use_stencil, ctas, dt, q11, q12, q22, ks11,
                ks12, ks22, kg11, kg12, kg22, prior, cell_size, inv_cell_size, nx, ny, k_coll,
                temperature, step_size, stream);
}

// The launch at this shape (query_shape: clusters resident at once, shared
// memory per CTA, K-tile buffers, tiles per CTA into shape[4]); per_particle
// picks K9's instantiation.
extern "C" int fused_planar_step_max_clusters(int P, int S, int M, int n_dof, int ctas,
                                              int n_rects, int n_circles, int per_particle,
                                              int* shape) {
  if (!valid(P, S, M, n_dof, ctas)) return (int)cudaErrorInvalidValue;
  const PriorStencil prior{};
  const StepParams prm = make_params(P, S, M, n_dof, 0, n_rects, n_circles, ctas, 0, 0, 0, 0,
                                     0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, &prior, 0);
  return (int)(per_particle ? query_shape<true>(prm, shape) : query_shape<false>(prm, shape));
}
