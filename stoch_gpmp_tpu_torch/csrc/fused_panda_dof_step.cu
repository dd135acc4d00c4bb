// K5: one whole dof-factored Panda StochGPMP iteration per particle, in one
// kernel.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/panda_step_dof.py
// make_fused_panda_dof_step (_kernel). Per particle p, dof d, sample s,
// with the means as dof planes [D, P, 2T] (lanes [0, T) positions, [T, 2T)
// velocities):
//   pu_d    = Sigma^{-1} mu_d, the sampling prior's stencil (prec_u_plane)
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
// at config 5 (P = 1280, S = 8, D = 7, T = 128), 140 us at 67 TFLOP/s, of
// which half multiplies exact zeros; FK and the fields add ~1,200
// operations and 81 exp2 at each of 1.3 M points. No TF32: the stencil
// weights reach ~2e11. Design:
// - W_dof = L^{-1} of the banded precision in plane order is lower
//   triangular in time within each of its four T x T blocks: W[k, m] = 0
//   where t(k) < t(m). The host checks this once (TRI) and packs, per window
//   of 32 columns of one plane starting at time t0, the rows of time >= t0
//   of both planes: 2T(T + 32) floats (160 KB at T = 128), which stay in
//   shared memory for the whole launch. Skipped entries are exact zeros
//   (fmaf(a, 0, acc) == acc), and the rows kept are summed in the dense
//   order, so the TRI and the dense instantiations agree bit for bit on
//   such a W. A W without the zeros (an override) runs the dense
//   instantiation, which reads W through L1 from device memory.
// - Persistent CTAs, one per SM (the W windows and one particle's rows fill
//   the shared memory), loop over particles: W is read from L2 once per CTA,
//   not once per particle.
// - The product: each thread holds a 7-row x 8-column block in registers;
//   per K step it reads 7 row values (4-byte loads, the warp's 8 row blocks
//   in distinct banks) and 8 values of W's row (two 16-byte loads, broadcast
//   to the warp's row blocks) for 56 FMAs. A warp takes one item: a
//   32-column window and, at T <= 128, one K part (the position rows or the
//   velocity rows; the parts are added to mu in that order), so a window
//   starting at t0 runs T - t0 K steps per part; the items are dealt to
//   warps so that each SM sub-partition (warp % 4) gets the same steps. By
//   the clock64 phases (tools/fused_timing.py) it issues ~2 FFMA warp
//   instructions per cycle per SM, half the FP32 rate, as a 7 x 4 block
//   with 16-column windows did, and worse with 32 warps of 7 x 4 blocks.
//   The eps rows sit lane-major (56 floats per lane) and the x rows
//   overwrite them once the product is done.
// - Sigma^{-1} mu per lane from the means (prec_u_plane), the stencil energy
//   and importance one warp per row, FK + fields + goal one thread per
//   (sample, t) point with the walk specialised for the chain where
//   fk_spec.h has a spec for it (positions in registers), else the
//   generic walk (positions in shared memory; dense instantiation only),
//   then the costs and the softmax in one warp and the mean update.
// Philox4x32-10 is keyed on the seed with the counter (lane, sample pair,
// particle, dof), two normals per draw by the dual-output Box-Muller, so the
// draws do not depend on the CTA that runs the particle.

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
  PriorStencil prior;  // the sampling prior's Sigma^{-1}
  unsigned int key_lo, key_hi;
};

namespace {

constexpr int RB = 7;           // rows per thread: one row block
constexpr int CB = 8;           // columns per thread
constexpr int PASS = RB * 8;    // 56 rows per pass of the product: 8 row blocks
constexpr int WIN = 4 * CB;     // 32 columns per window: 4 column groups
constexpr int MAX_WARPS = 16;
constexpr int MAX_LANES = 512;

__device__ __forceinline__ float quad2(float a11, float a12, float a22, float r, float s) {
  return a11 * r * r + 2.0f * a12 * r * s + a22 * s * s;
}

// Floats of shared memory: the packed W windows (TRI), the rows (eps
// lane-major, [M][56] per pass of 56 rows, then x [R][M] in their place),
// Sigma^{-1} mu [D][M], per row its stencil + importance sum, per sample the
// field sums [T / 32], goal, cost and weight; then the spheres (float4) and,
// for the generic walk, its position columns [3 L][threads].
struct Layout {
  size_t win, rows, pu, rowq, field, goal, cost, w, sph, pos, total;
};

__host__ __device__ inline Layout layout(int T, int D, int S, int n_obst, int n_links,
                                         bool tri, bool generic, int threads) {
  const int M = 2 * T, R = D * S, passes = (R + PASS - 1) / PASS;
  Layout l;
  l.win = 0;
  l.rows = l.win + (tri ? (size_t)2 * T * (T + WIN) : 0);
  l.pu = l.rows + (size_t)passes * PASS * M;
  l.rowq = l.pu + (size_t)D * M;
  l.field = l.rowq + R;
  l.goal = l.field + (size_t)S * (T / 32);
  l.cost = l.goal + S;
  l.w = l.cost + S;
  l.sph = (l.w + S + 3) / 4 * 4;  // 16-byte aligned
  l.pos = l.sph + 4 * (size_t)n_obst;
  l.total = l.pos + (generic ? (size_t)3 * n_links * threads : 0);
  return l;
}

// K parts of a window: 2 (the position rows, the velocity rows) while two
// items per window fit in MAX_WARPS warps (T <= 128), else 1.
__host__ __device__ inline int k_parts(int T) { return 2 * (2 * T / WIN) <= MAX_WARPS ? 2 : 1; }

// The product items (a window and its K part), one warp each: at most
// MAX_WARPS for 2T <= MAX_LANES.
__host__ __device__ inline int items_for(int T) { return 2 * T / WIN * k_parts(T); }

// The product item of warp w < items: ranks r by work (window j of its
// plane runs T - 32 j K steps per part), per j its planes and K parts (half:
// 0 the position rows, 1 the velocity rows, -1 both), dealt to the warps in a
// snake over the 4 SM sub-partitions (warp % 4) so that each gets the same
// work; a last block of fewer than 4 warps takes its ranks in order.
__device__ __forceinline__ void item_of(int w, int items, int ks, int& plane, int& half,
                                        int& j) {
  const int blk = w >> 2, sub = w & 3;
  const bool back = (blk & 1) && 4 * blk + 4 <= items;
  const int r = 4 * blk + (back ? 3 - sub : sub);
  j = r / (2 * ks);
  const int c = r - j * 2 * ks;
  plane = c & 1;
  half = ks == 2 ? c >> 1 : -1;
}

__device__ __forceinline__ float warp_allmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// minimum one block per SM: ptxas may use up to 128 registers (65,536 / 512)
template <bool TRI, int VARIANT>
__global__ void __launch_bounds__(MAX_LANES, 1)
fused_panda_dof_step_kernel(const float* __restrict__ means, const float* __restrict__ g_pd,
                            const float* __restrict__ W, const float* __restrict__ spheres,
                            const float* __restrict__ eps, float* __restrict__ new_means,
                            float* __restrict__ costs, const __grid_constant__ DofStepParams prm,
                            const __grid_constant__ FkChain chain) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = prm.T, M = 2 * T, S = prm.S, D = prm.D, P = prm.P, R = D * S;
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = NT >> 5, wpr = T >> 5, passes = (R + PASS - 1) / PASS;
  const int L = chain.n_links;
  const Layout lo = layout(T, D, S, prm.n_obst, L, TRI, VARIANT == 0, NT);
  float* win_sh = smem + lo.win;
  float* rows_sh = smem + lo.rows;
  float* pu_sh = smem + lo.pu;
  float* rowq_sh = smem + lo.rowq;
  float* field_sh = smem + lo.field;
  float* goal_sh = smem + lo.goal;
  float* cost_sh = smem + lo.cost;
  float* w_sh = smem + lo.w;
  float4* sph = reinterpret_cast<float4*>(smem + lo.sph);
  float* pos_sh = smem + lo.pos;
  load_spheres(spheres, prm.n_obst, sph);
  if constexpr (TRI) {  // the packed W windows, once per CTA
    const float4* src = reinterpret_cast<const float4*>(W);
    float4* dst = reinterpret_cast<float4*>(win_sh);
    for (int i = tid; i < T * (T + WIN) / 2; i += NT) dst[i] = __ldg(src + i);
  }
  const uint2 key = make_uint2(prm.key_lo, prm.key_hi);
  const int rb = lane >> 2, cg = lane & 3;  // the thread's row block and column group
  const int ks = k_parts(T), items = items_for(T);

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    __syncthreads();  // the previous particle's rows are consumed
    // --- 1. eps rows, lane-major: eps of row r = d S + s at lane k goes to
    // rows_sh[(pass * M + k) * 56 + r % 56], pass = r / 56
    const int npairs = (S + 1) / 2, dj = D * npairs;
    auto put = [&](int k, int d, int j, float2 z) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = d * S + 2 * j + h;
        if (2 * j + h < S) rows_sh[((size_t)(r / PASS) * M + k) * PASS + r % PASS] = h ? z.y : z.x;
      }
    };
    if (eps != nullptr) {
      for (int i = tid; i < M * dj; i += NT) {
        const int k = i / dj, e = i - k * dj, d = e / npairs, j = e - d * npairs;
        const float* er = eps + (((size_t)d * P + p) * S + 2 * j) * M + k;
        put(k, d, j, make_float2(er[0], 2 * j + 1 < S ? er[M] : 0.0f));
      }
    } else {
#pragma unroll 2
      for (int i = tid; i < M * dj; i += NT) {
        const int k = i / dj, e = i - k * dj, d = e / npairs, j = e - d * npairs;
        const uint4 bits =
            philox4x32_10(make_uint4((uint32_t)k, (uint32_t)j, (uint32_t)p, (uint32_t)d), key);
        put(k, d, j, box_muller(bits.x, bits.y));
      }
    }
    // Sigma^{-1} mu of each dof plane
    for (int i = tid; i < D * M; i += NT) {
      const int d = i / M;
      pu_sh[i] = prec_u_plane(means + ((size_t)d * P + p) * M, i - d * M, T, prm.prior);
    }
    __syncthreads();

    // --- 2. x = mu + eps @ W, a pass of 56 rows at a time -------------------------
    for (int pass = 0; pass < passes; ++pass) {
      float acc[RB][CB] = {};
      int plane, half, j;
      item_of(warp, items, ks, plane, half, j);
      const int col = plane * T + j * WIN + CB * cg;
      const bool active = warp < items;
      if (active) {
        const int t0 = TRI ? j * WIN : 0, n = T - t0;
        const float* e_pass = rows_sh + (size_t)pass * M * PASS + rb * RB;
        const float* w_item =
            TRI ? win_sh + (size_t)plane * T * (T + WIN) +
                      (size_t)2 * WIN * (j * T - WIN / 2 * j * (j - 1)) + CB * cg
                : W + col;
        for (int kh = half < 0 ? 0 : half; kh <= (half < 0 ? 1 : half); ++kh) {
          const float* e = e_pass + (size_t)(kh * T + t0) * PASS;
          const float* g = TRI ? w_item + (size_t)kh * n * WIN : w_item + (size_t)kh * T * M;
          const int gs = TRI ? WIN : M;  // W row stride
#pragma unroll 2
          for (int k = 0; k < n; ++k) {
            float ev[RB];
#pragma unroll
            for (int i = 0; i < RB; ++i) ev[i] = e[(size_t)k * PASS + i];
            const float4* gk = reinterpret_cast<const float4*>(g + (size_t)k * gs);
            const float4 w0 = TRI ? gk[0] : __ldg(gk), w1 = TRI ? gk[1] : __ldg(gk + 1);
            const float wv[CB] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int i = 0; i < RB; ++i)
#pragma unroll
              for (int c = 0; c < CB; ++c) acc[i][c] = fmaf(ev[i], wv[c], acc[i][c]);
          }
        }
      }
      __syncthreads();  // every read of this pass's eps is done: x takes its place
      // x = mu + (the position rows' part) + (the velocity rows' part), in this order
      for (int stage = 0; stage < 2; ++stage) {
        if (active && (half < 0 ? 0 : half) == stage) {
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            const int r = pass * PASS + rb * RB + i;
            if (r < R) {
              float4* x = reinterpret_cast<float4*>(rows_sh + (size_t)r * M + col);
              const float4* mu = reinterpret_cast<const float4*>(
                  means + ((size_t)(r / S) * P + p) * M + col);
              const float4 a = stage == 0 ? __ldg(mu) : x[0];
              const float4 b = stage == 0 ? __ldg(mu + 1) : x[1];
              x[0] = make_float4(a.x + acc[i][0], a.y + acc[i][1], a.z + acc[i][2],
                                 a.w + acc[i][3]);
              x[1] = make_float4(b.x + acc[i][4], b.y + acc[i][5], b.z + acc[i][6],
                                 b.w + acc[i][7]);
            }
          }
        }
        __syncthreads();
      }
    }

    // --- 3. stencil energy + anchors + importance, one warp per row ---------------
    const float* gp = g_pd + (size_t)(p / prm.ppg) * D * 2;
    for (int r = warp; r < R; r += nwarps) {
      const int d = r / S;
      const float* row = rows_sh + (size_t)r * M;
      float v = 0.0f;
#pragma unroll 4
      for (int m = lane; m < M; m += 32) {
        if (m < T - 1) {
          const float rp = row[m] + prm.dt * row[T + m] - row[m + 1];
          const float rv = row[T + m] - row[T + m + 1];
          v += quad2(prm.q11, prm.q12, prm.q22, rp, rv);
        }
        if (m == 0)
          v += quad2(prm.ks11, prm.ks12, prm.ks22, row[0] - prm.s_pd[2 * d],
                     row[T] - prm.s_pd[2 * d + 1]);
        if (m == T - 1)
          v += quad2(prm.kg11, prm.kg12, prm.kg22, row[T - 1] - gp[2 * d],
                     row[2 * T - 1] - gp[2 * d + 1]);
        v += prm.temperature * row[m] * pu_sh[d * M + m];
      }
      v = warp_sum(v);
      if (lane == 0) rowq_sh[r] = v;
    }

    // --- 4. FK + link fields per (sample, t); SE(3) goal at t = T-1 -------------
    // S * T points in whole warps (T % 32 == 0): a warp's points share s.
    for (int pt = tid; pt < S * T; pt += NT) {
      const int s = pt / T, t = pt - s * T;
      auto q = [&](int i) { return rows_sh[(size_t)(i * S + s) * M + t]; };
      float f = 0.0f, g = 0.0f;
      float ee_r[9];
      if constexpr (VARIANT == 1) {
        float pos[FkPanda::NL][3];
        fk_walk_spec<FkPanda>(chain, q, pos, ee_r);
        if (t >= 1)
          f = link_fields<FkPanda::NL>([&](int l, int c) { return pos[l][c]; }, FkPanda::NL,
                                       sph, prm.n_obst, prm.inv_2m2, prm.w_self, prm.w_obst);
        if (t == T - 1 && prm.w_goal != 0.0f) {
          const float dist = ee_goal_distance(pos[FkPanda::NL - 1], ee_r, prm.target,
                                              prm.w_pos, prm.w_rot);
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

    // --- 5. per-sample cost, the softmax over the S samples ------------------------
    if (warp == 0) {  // lane l holds the samples l, l + 32, ...
      float mx = __int_as_float(0xff800000);  // -inf
      for (int s = lane; s < S; s += 32) {
        float c = 0.0f;
        for (int d = 0; d < D; ++d) c += rowq_sh[d * S + s];
        for (int k = 0; k < wpr; ++k) c += field_sh[s * wpr + k];
        c += goal_sh[s];
        cost_sh[s] = c;
        costs[(size_t)p * S + s] = c;
        mx = fmaxf(mx, -c / prm.temperature);
      }
      mx = warp_allmax(mx);
      float sum = 0.0f;
      for (int s = lane; s < S; s += 32) sum += expf(-cost_sh[s] / prm.temperature - mx);
      sum = warp_allsum(sum);
      for (int s = lane; s < S; s += 32) w_sh[s] = expf(-cost_sh[s] / prm.temperature - mx) / sum;
    }
    __syncthreads();

    // --- 6. the mean update -----------------------------------------------------------
#pragma unroll 4
    for (int i = tid; i < D * M; i += NT) {
      const int d = i / M, m = i - d * M;
      const size_t idx = ((size_t)d * P + p) * M + m;
      const float mu = means[idx];
      float grad = 0.0f;
      for (int s = 0; s < S; ++s)
        grad = fmaf(w_sh[s], rows_sh[(size_t)(d * S + s) * M + m] - mu, grad);
      new_means[idx] = mu + prm.step_size * grad;
    }
  }
}

bool valid(const DofStepParams* prm, const FkChain* chain, int tri, int variant) {
  const int M = 2 * prm->T;
  if (prm->T % 32 != 0 || M > MAX_LANES || items_for(prm->T) > MAX_WARPS || prm->D < 1 ||
      prm->D > FK_MAX_JOINTS || prm->S < 1 || prm->ppg < 1 || prm->P < 1 || prm->n_obst < 0 ||
      !fk_variant_valid(*chain, variant))
    return false;
  return variant != 0 || !tri;  // the generic walk's positions need the W windows' room
}

template <bool TRI, int VARIANT>
void* kernel_of() {
  return reinterpret_cast<void*>(fused_panda_dof_step_kernel<TRI, VARIANT>);
}

void* pick(int tri, int variant) {
  if (variant == 0) return kernel_of<false, 0>();
  return tri ? kernel_of<true, 1>() : kernel_of<false, 1>();
}

// The launch at this shape: threads and shared memory per CTA; refuses a
// CTA whose shared memory exceeds kSmemLimit.
cudaError_t configure(const DofStepParams* prm, const FkChain* chain, int tri, int variant,
                      int* threads, size_t* smem) {
  *threads = 32 * items_for(prm->T);
  *smem = sizeof(float) * layout(prm->T, prm->D, prm->S, prm->n_obst, chain->n_links, tri,
                                 variant == 0, *threads).total;
  if (*smem > kSmemLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(pick(tri, variant), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

// One launch of `ctas` persistent CTAs (each loops over the particles
// blockIdx.x, blockIdx.x + ctas, ...). tri: W is packed in windows
// (2T(T + 32) floats, see above); variant: the chain's FK spec (1: FkPanda,
// 0: the generic walk).
extern "C" int fused_panda_dof_step_launch(const float* means, const float* g_pd,
                                           const float* W, const float* spheres,
                                           const float* eps, float* new_means, float* costs,
                                           int ctas, int tri, int variant,
                                           const DofStepParams* prm, const FkChain* chain,
                                           void* stream) {
  if (!valid(prm, chain, tri, variant) || ctas < 1) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  cudaError_t err = configure(prm, chain, tri, variant, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0)
    fused_panda_dof_step_kernel<false, 0><<<ctas, threads, smem, st>>>(
        means, g_pd, W, spheres, eps, new_means, costs, *prm, *chain);
  else if (tri)
    fused_panda_dof_step_kernel<true, 1><<<ctas, threads, smem, st>>>(
        means, g_pd, W, spheres, eps, new_means, costs, *prm, *chain);
  else
    fused_panda_dof_step_kernel<false, 1><<<ctas, threads, smem, st>>>(
        means, g_pd, W, spheres, eps, new_means, costs, *prm, *chain);
  return (int)cudaGetLastError();
}

// The launch at this shape, into shape[3]: the CTAs resident on one SM (0
// where the shared memory exceeds kSmemLimit), the dynamic shared memory per
// CTA in bytes and the threads per CTA.
extern "C" int fused_panda_dof_step_config(const DofStepParams* prm, const FkChain* chain,
                                           int tri, int variant, int* shape) {
  if (!valid(prm, chain, tri, variant)) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  const cudaError_t err = configure(prm, chain, tri, variant, &threads, &smem);
  shape[0] = 0;
  shape[1] = (int)smem;
  shape[2] = threads;
  if (smem > kSmemLimit) return (int)cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(shape, pick(tri, variant), threads,
                                                            smem);
}
