// Device helpers shared by the fused iteration kernels
// (fused_planar_step.cu, fused_panda_step.cu, fused_panda_dof_step.cu): the
// Philox4x32-10 counter-based generator with a dual-output Box-Muller, warp
// and block reductions, the K-tile pipeline that multiplies a tile of rows
// in shared memory by a matrix streamed from device memory (TMA bulk copies
// into a ring, register-blocked 4 x 4 or split-K 4 x 8), the sampling
// prior's Sigma^{-1} mu at one lane (flat t-major rows and dof plane rows),
// and the thread-block-cluster softmax and mean update of the cluster-split
// kernels (K2/K9, K6).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Sigma^{-1} of the sampling prior as its factor-graph stencil
// (DofFactoredPrior: q_i2, k_s2, k_g2 row-major, and dt). Outside the
// anonymous namespace: launchers take a pointer to it from ctypes.
struct PriorStencil {
  float q11, q12, q21, q22, ks11, ks12, ks21, ks22, kg11, kg12, kg21, kg22, dt;
};

namespace {

// Philox4x32-10 (Salmon et al., SC'11) on a 128-bit counter and 64-bit key.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Dual-output Box-Muller on the top 24 bits, u1 in (0, 1) as in the TPU
// kernels' _box_muller (ops/pallas/fused_step.py): r cos and r sin are both
// used.
__device__ __forceinline__ float2 box_muller(uint32_t b1, uint32_t b2) {
  const float u1 = (float)(b1 >> 8) * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
  const float u2 = (float)(b2 >> 8) * (1.0f / 16777216.0f);
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(6.283185307179586f * u2, &s, &c);
  return make_float2(r * c, r * s);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum or max; every thread gets the result. scratch: 32 floats.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < nwarps; ++w) r = IS_MAX ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Hopper's bulk copy (TMA without a tensor map) of `bytes` (a multiple of
// 16) from device memory into this CTA's shared memory, completing as a
// transaction count on the mbarrier bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Orders this thread's generic-proxy accesses of shared memory before the
// async proxy's (the bulk copies) that a later barrier lets start.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A ring of `stages` (2..8) buffers of KT rows of G [M, M] in shared memory,
// filled by one bulk copy (TMA) per K-tile that thread 0 issues, each
// awaited on its buffer's mbarrier: stages - 1 K-tiles are in flight while
// one is multiplied. Every thread of the block calls begin(), tile(kt) for
// kt = 0 .. M / KT - 1 in order, then end(). tile(kt) returns K-tile kt once
// it has landed, after a block barrier that frees the buffer of K-tile
// kt - 1 for K-tile kt + stages - 1; end() waits until every read is done.
template <int KT>
struct KtileRing {
  float* buf;
  const float* G;
  int M, stages;
  uint64_t* full;  // [stages] mbarriers

  __device__ __forceinline__ void issue(int kt) const {
    const unsigned bytes = sizeof(float) * KT * M;
    uint64_t* bar = full + kt % stages;
    mbar_expect_tx(bar, bytes);
    bulk_copy(buf + (kt % stages) * KT * M, G + (size_t)kt * KT * M, bytes, bar);
  }

  __device__ __forceinline__ void begin() const {
    fence_proxy_async();
    __syncthreads();  // every earlier reader and writer of buf is done
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int kt = 0; kt < stages - 1 && kt < M / KT; ++kt) issue(kt);
    }
    __syncthreads();  // the mbarriers are initialised before anyone waits on them
  }

  __device__ __forceinline__ const float* tile(int kt) const {
    mbar_wait(full + kt % stages, (kt / stages) & 1);
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0 && kt + stages - 1 < M / KT) issue(kt + stages - 1);
    return buf + (kt % stages) * KT * M;
  }

  __device__ __forceinline__ void end() const {
    __syncthreads();
    if (threadIdx.x == 0)
      for (int s = 0; s < stages; ++s) mbar_inval(full + s);
  }
};

// Register-blocked product: acc[i][c] += sum_k a[row0 + i * rstride][k] *
// G[k][col0 + c] for the thread's R rows of a tile in shared memory (row
// stride lda, a multiple of 4) and its 4 adjacent columns (col0 a multiple
// of 4), G streamed through the ring. Per four K steps a thread loads four
// 16-byte column segments of G and R 16-byte row segments, for 16 R FMAs:
// the threads of a warp that share columns get G by broadcast, those that
// share rows get the rows by broadcast.
template <int KT, int R>
__device__ __forceinline__ void tile_matmul_2d(const float* a_sh, int lda, int row0, int rstride,
                                               const KtileRing<KT>& ring, int col0,
                                               float (&acc)[R][4]) {
  ring.begin();
  for (int kt = 0; kt < ring.M / KT; ++kt) {
    const float* gt = ring.tile(kt) + col0;
    const float* at = a_sh + row0 * lda + kt * KT;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 4) {
      float4 g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) g[j] = *reinterpret_cast<const float4*>(gt + (kk + j) * ring.M);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(at + i * rstride * lda + kk);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][0] = fmaf(av[j], g[j].x, acc[i][0]);
          acc[i][1] = fmaf(av[j], g[j].y, acc[i][1]);
          acc[i][2] = fmaf(av[j], g[j].z, acc[i][2]);
          acc[i][3] = fmaf(av[j], g[j].w, acc[i][3]);
        }
      }
    }
  }
  ring.end();
}

// Split-K, register-blocked product of a tile of ROWS rows in shared memory
// by G [M, M] streamed through the ring: dst[r][m] = (add ? add[m] : 0) +
// sum_k a[r][k] G[k][m]. The block's threads form KS groups; group g takes
// the K rows [g KT / KS, (g + 1) KT / KS) of every K-tile, and a thread of it
// holds R rows by 8 columns, 4 u .. 4 u + 3 and M / 2 + 4 u .. + 3, in
// registers. Per K step a thread reads two 16-byte column segments of G
// (its warp reads 512 contiguous bytes) and R row values (broadcast to the
// warp). The KS partial tiles meet in the ring's buffers (KS ROWS <= 2 KT)
// and are summed in group order, so the result does not depend on the
// schedule. blockDim.x must be KS * (M / 8) * (ROWS / R).
template <int KT, int KS, int R, int ROWS>
__device__ __forceinline__ void tile_matmul_splitk(const float* a_sh, int lda,
                                                   const KtileRing<KT>& ring, const float* add,
                                                   float* dst, int ldd) {
  constexpr int KG = KT / KS;  // K rows of a K-tile per group
  const int M = ring.M, ncg = M / 8, gs = ncg * (ROWS / R);
  const int t = threadIdx.x, kg = t / gs, u = t - kg * gs, rg = u / ncg, cg = u - rg * ncg;
  const int c0 = 4 * cg, c1 = c0 + M / 2, r0 = rg * R;
  float acc[R][8] = {};
  ring.begin();
  for (int kt = 0; kt < M / KT; ++kt) {
    const float* gt = ring.tile(kt) + kg * KG * M;
    const float* at = a_sh + r0 * lda + kt * KT + kg * KG;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float4 ga = *reinterpret_cast<const float4*>(gt + k * M + c0);
      const float4 gb = *reinterpret_cast<const float4*>(gt + k * M + c1);
      const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float a = at[i * lda + k];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a, g[c], acc[i][c]);
      }
    }
  }
  ring.end();  // every read of the ring and of a_sh is done: the ring takes the partials
  float* part = ring.buf;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float* row = part + (kg * ROWS + r0 + i) * M;
    *reinterpret_cast<float4*>(row + c0) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + c1) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  for (int e = t; e < ROWS * M; e += blockDim.x) {
    float v = part[e];
#pragma unroll
    for (int g = 1; g < KS; ++g) v += part[g * ROWS * M + e];
    const int r = e / M, m = e - r * M;
    dst[r * ldd + m] = add != nullptr ? add[m] + v : v;
  }
  __syncthreads();  // dst is complete and the ring's buffers are free
}

// Dynamic shared memory a block may use on the H100 (227 KB) beside the
// split-K product's static mbarriers.
constexpr size_t kSmemLimit = 232448 - 256;

// K-tile buffers of KT * M floats that fit beside `used` bytes of other
// shared memory: at most max_stages, at least 2 (then the caller's check of
// the total fails).
__host__ __device__ inline int pick_stages(size_t used, int KT, int M, int max_stages) {
  const size_t per = sizeof(float) * (size_t)KT * M, limit = kSmemLimit;
  int s = used + 2 * per <= limit ? (int)((limit - used) / per) : 2;
  return s < 2 ? 2 : (s > max_stages ? max_stages : s);
}

// (Sigma^{-1} mu)_m at lane m of a flat t-major row mu [M] (lane t*2d + j
// holds pos_j(t), t*2d + d + j vel_j(t)): the factor-graph stencil of
// DofFactoredPrior.matvec_flat, per lane. With l the position lane of m's
// dof and step t and r_t = (mu[l] + dt mu[l+d] - mu[l+2d], mu[l+d] -
// mu[l+3d]) the residual of the factor between t and t+1:
//   pos lane: (Q^{-1} r_t)_p - (Q^{-1} r_{t-1})_p
//   vel lane: dt (Q^{-1} r_t)_p + (Q^{-1} r_t)_v - (Q^{-1} r_{t-1})_v
// (terms of a factor that does not exist are 0), plus K_s (pos, vel)(0) at
// t = 0 and K_g (pos, vel)(T-1) at t = T-1. Reads the lanes m +- d, m +- 2d,
// m + 3d (pos) or m - 3d (vel).
__device__ __forceinline__ float prec_u_lane(const float* mu, int m, int M, int d,
                                             const PriorStencil& k) {
  const int sd = 2 * d, t = m / sd, T = M / sd;
  const bool pos = m - t * sd < d;
  const int l = pos ? m : m - d;
  float ya = 0.0f, yb = 0.0f;
  if (t < T - 1) {
    const float rp = mu[l] + k.dt * mu[l + d] - mu[l + sd];
    const float rv = mu[l + d] - mu[l + sd + d];
    const float a = k.q11 * rp + k.q12 * rv;
    ya = pos ? a : k.dt * a + (k.q21 * rp + k.q22 * rv);
  }
  if (t > 0) {
    const int lp = l - sd;
    const float rp = mu[lp] + k.dt * mu[lp + d] - mu[l];
    const float rv = mu[lp + d] - mu[l + d];
    yb = pos ? k.q11 * rp + k.q12 * rv : k.q21 * rp + k.q22 * rv;
  }
  float y = ya - yb;
  const float p = mu[l], v = mu[l + d];
  if (t == 0) y += pos ? k.ks11 * p + k.ks12 * v : k.ks21 * p + k.ks22 * v;
  if (t == T - 1) y += pos ? k.kg11 * p + k.kg12 * v : k.kg21 * p + k.kg22 * v;
  return y;
}

// (Sigma^{-1} mu)_m at lane m of one dof's plane row mu [2T] (lanes [0, T)
// the positions, [T, 2T) the velocities): the plane twin of prec_u_lane,
// DofFactoredPrior.matvec_planes per lane. With r_t = (p_t + dt v_t -
// p_{t+1}, v_t - v_{t+1}):
//   position lane t: (Q^{-1} r_t)_p - (Q^{-1} r_{t-1})_p
//   velocity lane t: dt (Q^{-1} r_t)_p + (Q^{-1} r_t)_v - (Q^{-1} r_{t-1})_v
// (terms of a factor that does not exist are 0), plus K_s (p, v)(0) at t = 0
// and K_g (p, v)(T-1) at t = T-1. Reads lanes t - 1 .. t + 1 of both planes.
__device__ __forceinline__ float prec_u_plane(const float* __restrict__ mu, int m, int T,
                                              const PriorStencil& k) {
  const bool pos = m < T;
  const int t = pos ? m : m - T;
  float ya = 0.0f, yb = 0.0f;
  if (t < T - 1) {
    const float rp = mu[t] + k.dt * mu[T + t] - mu[t + 1];
    const float rv = mu[T + t] - mu[T + t + 1];
    const float a = k.q11 * rp + k.q12 * rv;
    ya = pos ? a : k.dt * a + (k.q21 * rp + k.q22 * rv);
  }
  if (t > 0) {
    const float rp = mu[t - 1] + k.dt * mu[T + t - 1] - mu[t];
    const float rv = mu[T + t - 1] - mu[T + t];
    yb = pos ? k.q11 * rp + k.q12 * rv : k.q21 * rp + k.q22 * rv;
  }
  float y = ya - yb;
  const float p = mu[t], v = mu[T + t];
  if (t == 0) y += pos ? k.ks11 * p + k.ks12 * v : k.ks21 * p + k.ks22 * v;
  if (t == T - 1) y += pos ? k.kg11 * p + k.kg12 * v : k.kg21 * p + k.kg22 * v;
  return y;
}

// The softmax over a particle's S sample costs and its mean update,
// across the thread-block cluster that holds the particle (one CTA is a
// cluster of 1). The CTA of rank r holds the samples [r * rows_per_cta,
// r * rows_per_cta + nrows): their costs in cost_sh[0, nrows) and their rows
// x at rows_sh + i * ld. Every CTA reads all S costs through distributed
// shared memory and reduces them in the same threads and order, so every
// CTA holds the same max, sum and weights; each forms sum_i w_i (x_i - mu)
// over its own rows in part_sh [M]; rank r then sums the c partials in rank
// order for its slice of the lanes and writes mu + step * sum to
// new_means [M]. w_sh holds nrows floats, scratch 32. Starts with a cluster
// barrier (the costs are published) and ends with one (no CTA leaves while a
// peer still reads its shared memory).
__device__ void cluster_softmax_update(const float* cost_sh, int nrows, int rows_per_cta, int S,
                                       const float* rows_sh, int ld, const float* mu_sh,
                                       float* w_sh, float* part_sh, float* scratch, int M,
                                       float temperature, float step_size,
                                       float* __restrict__ new_means) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x;
  cluster.sync();
  float mx = __int_as_float(0xff800000);  // -inf
  for (int s = tid; s < S; s += nt)
    mx = fmaxf(mx, -cluster.map_shared_rank(cost_sh, s / rows_per_cta)[s % rows_per_cta] /
                       temperature);
  mx = block_reduce<true>(mx, scratch);
  float sum = 0.0f;
  for (int s = tid; s < S; s += nt)
    sum += expf(-cluster.map_shared_rank(cost_sh, s / rows_per_cta)[s % rows_per_cta] /
                    temperature - mx);
  sum = block_reduce<false>(sum, scratch);
  for (int i = tid; i < nrows; i += nt) w_sh[i] = expf(-cost_sh[i] / temperature - mx) / sum;
  __syncthreads();
  for (int m = tid; m < M; m += nt) {
    const float mu = mu_sh[m];
    float g = 0.0f;
    for (int i = 0; i < nrows; ++i) g = fmaf(w_sh[i], rows_sh[(size_t)i * ld + m] - mu, g);
    part_sh[m] = g;
  }
  cluster.sync();
  const int per = (M + c - 1) / c, end = min(M, (rank + 1) * per);
  for (int m = rank * per + tid; m < end; m += nt) {
    float g = 0.0f;
    for (int q = 0; q < c; ++q) g += cluster.map_shared_rank(part_sh, q)[m];
    new_means[m] = mu_sh[m] + step_size * g;
  }
  cluster.sync();
}

}  // namespace
