// K5: one whole dof-factored Panda StochGPMP iteration per particle, in one
// kernel.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/panda_step_dof.py
// make_fused_panda_dof_step (_kernel). Per particle p, dof d, sample s,
// with the means as dof planes [D, P, 2T] (lanes [0, T) positions, [T, 2T)
// velocities):
//   pu_d    = Sigma^{-1} mu_d, the sampling prior's stencil (prec_u_plane)
//   x_{d,s} = mu_d + y_{d,s},  L^T y_{d,s} = eps_{d,s}  (eps: operand or Philox;
//                                                    L: the prior's factor)
//   cost_s  = sum_d stencil energy of x_{d,s} + anchors (as dof_quad_eval.cu)
//           + tau * sum_d x_{d,s} . pu_d
//           + sum_{t>=1} link_fields(FK(x_{:,s}[t]))    (fk_chain.cuh)
//           + w_goal (w_pos |p_ee - p*| + w_rot acos_poly(c))^2   at t = T-1
//   w       = softmax_s(-cost / tau)
//   mu_d   += step * sum_s w_s (x_{d,s} - mu_d)
// The SE(3) angle uses the TPU kernel's Abramowitz & Stegun 4.4.46
// polynomial (|err| <= 2e-8 rad); the plain version does too.
//
// Bound on the H100: FK and the link fields, ~1,200 operations and 81 exp2
// at each of 1.3 M points at config 5 (P = 1280, S = 8, D = 7, T = 128), and
// the Philox draws; the sampling itself is ~7 FMAs a lane. No TF32: the
// stencil weights reach ~2e11. Design:
// - The sampling correction y = eps @ L^{-1}, with L the per-dof prior's
//   lower block-bidiagonal Cholesky factor (2 x 2 blocks in time-major
//   order), is the backward substitution L^T y = eps: y_t = D_t^{-T} eps_t
//   + A_t y_{t+1}, y_T = 0, with eps_t = (eps[t], eps[T + t]) and y_t =
//   (y[t], y[T + t]) in plane order. The host forms the tables (D_t^{-T}:
//   3 numbers, A_t: 4) in float64 from the factor and rounds them to
//   float32, [7][T] (ops/kernels/panda_step_dof.py backward_tables); they
//   sit in shared memory for the whole launch, chunk-interleaved so that a
//   warp's reads are free of bank conflicts.
// - The substitution: one thread per (dof, sample pair, chunk of CH time
//   steps), a pair's T / CH chunks in consecutive lanes of one warp.
//   Pass 1 draws the thread's normals in registers (the Philox counter
//   (lane, sample pair, particle, dof) and the dual-output Box-Muller: the
//   draws do not depend on the CTA that runs a particle) and runs the
//   chunk's recurrence from a zero carry, keeping it in registers; a
//   shuffle scan over the pair's chunks composes each chunk's affine map
//   (its local result and its transition Phi_c = A_t0 ... A_{t0 + CH - 1},
//   formed once per CTA) into the true y at each chunk's first step; pass 2
//   adds the carry's homogeneous part Phi(t, t1) y_{t1} step by step and
//   writes x = mu + y as float4 rows.
// - Each row's quadratic term is summed where the substitution makes the
//   row, from the same registers: the thread adds its chunk's stencil
//   residuals (step t0 + CH, the next chunk's first, comes from lane c + 1
//   by a shuffle, as the carries do; the last chunk has none at T - 1), the
//   start anchor at t = 0, the goal anchor at t = T - 1 and tau x . pu over
//   its 16 lanes; a suffix sum over the pair's T / CH lanes (any count up
//   to 32, in a fixed order: no atomics, so a launch repeats bit for bit)
//   leaves the two rows' sums in the pair's first lane. No pass re-reads
//   the rows for them; FK and the update still read the rows from shared
//   memory.
// - CTAs loop over particles (blockIdx.x, + gridDim.x, ...); the wrapper
//   launches one a particle, which the block scheduler balances better than
//   2 resident CTAs an SM looping over ~5 particles each (0.228 against
//   0.236 ms at config 5 on an H100). Two CTAs of 512 threads an SM, 64
//   registers a thread (FK spills ~0.4 KB a thread; 256 x 3 at 80
//   registers, 448 x 2 and 480 x 2 measured no faster), 69 KB of shared
//   memory at config 5.
// - Sigma^{-1} mu per lane from the means (prec_u_plane), before the barrier
//   that opens a particle (the substitution's sums read it), FK + fields +
//   goal one thread per (sample, t) point with the walk specialised for the
//   chain where fk_spec.h has a spec for it (positions in registers), else
//   the generic walk (positions in shared memory), then the costs and the
//   softmax in one warp and the mean update.

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

constexpr int MAX_LANES = 512;  // 2T
constexpr int CH = 8;           // time steps per chunk; a pair's T / CH <= 32 chunks share a warp
constexpr int TAB = 7;          // table entries per step, D^{-T} (3) and A (4)
constexpr int SUB_THREADS = 512, SUB_MIN_CTAS = 2;  // threads per CTA, CTAs per SM
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float quad2(float a11, float a12, float a22, float r, float s) {
  return a11 * r * r + 2.0f * a12 * r * s + a22 * s * s;
}

// Floats of shared memory: the tables (chunk-interleaved, [TAB][CH][T /
// CH]) and each chunk's transition ([4][T / CH]); the rows x [R][M];
// Sigma^{-1} mu [D][M], per row its quadratic + importance sum, per sample
// the field sums [T / 32], goal, cost and weight; then the spheres
// (float4) and, for the generic walk, its position columns [3 L]
// [threads].
struct Layout {
  size_t tab, phi, rows, pu, rowq, field, goal, cost, w, sph, pos, total;
};

__host__ __device__ inline Layout layout(int T, int D, int S, int n_obst, int n_links,
                                         bool generic, int threads) {
  const int M = 2 * T, R = D * S;
  Layout l;
  l.tab = 0;
  l.phi = l.tab + (size_t)TAB * T;
  l.rows = l.phi + (size_t)4 * (T / CH);  // 16-byte aligned: T % 32 == 0
  l.pu = l.rows + (size_t)R * M;
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

__device__ __forceinline__ float warp_allmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The normals of a sample pair at one lane: .x sample 2j, .y sample 2j + 1.
__device__ __forceinline__ float2 normals(int k, int j, int p, int d, uint2 key) {
  const uint4 bits =
      philox4x32_10(make_uint4((uint32_t)k, (uint32_t)j, (uint32_t)p, (uint32_t)d), key);
  return box_muller(bits.x, bits.y);
}

template <int VARIANT>
__global__ void __launch_bounds__(SUB_THREADS, SUB_MIN_CTAS)
fused_panda_dof_step_kernel(const float* __restrict__ means, const float* __restrict__ g_pd,
                            const float* __restrict__ tables, const float* __restrict__ spheres,
                            const float* __restrict__ eps, float* __restrict__ new_means,
                            float* __restrict__ costs, const __grid_constant__ DofStepParams prm,
                            const __grid_constant__ FkChain chain) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = prm.T, M = 2 * T, S = prm.S, D = prm.D, P = prm.P;
  const int NT = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = NT >> 5, wpr = T >> 5;
  const int L = chain.n_links, NC = T / CH;
  const Layout lo = layout(T, D, S, prm.n_obst, L, VARIANT == 0, NT);
  float* tab_sh = smem + lo.tab;
  float* phi_sh = smem + lo.phi;
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
  // the tables [TAB][T] as tab_sh[(k CH + i) NC + c] for t = c CH + i
  for (int i = tid; i < TAB * T; i += NT) {
    const int k = i / T, t = i - k * T;
    tab_sh[k * T + (t % CH) * NC + t / CH] = __ldg(tables + i);
  }
  __syncthreads();
  if (tid < NC) {  // chunk c's transition Phi_c = A_{c CH} ... A_{c CH + CH - 1}
    float f00 = 1.0f, f01 = 0.0f, f10 = 0.0f, f11 = 1.0f;
    for (int i = CH - 1; i >= 0; --i) {
      const float* a = tab_sh + 3 * T + i * NC + tid;
      const float a00 = a[0], a01 = a[T], a10 = a[2 * T], a11 = a[3 * T];
      const float n00 = a00 * f00 + a01 * f10, n01 = a00 * f01 + a01 * f11;
      const float n10 = a10 * f00 + a11 * f10, n11 = a10 * f01 + a11 * f11;
      f00 = n00, f01 = n01, f10 = n10, f11 = n11;
    }
    phi_sh[tid] = f00, phi_sh[NC + tid] = f01, phi_sh[2 * NC + tid] = f10;
    phi_sh[3 * NC + tid] = f11;
  }
  const uint2 key = make_uint2(prm.key_lo, prm.key_hi);
  const int npairs = (S + 1) / 2, dj = D * npairs;

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
    // Sigma^{-1} mu of each dof plane (no reader of the previous particle's is left)
    for (int i = tid; i < D * M; i += NT) {
      const int d = i / M;
      pu_sh[i] = prec_u_plane(means + ((size_t)d * P + p) * M, i - d * M, T, prm.prior);
    }
    __syncthreads();  // pu is complete; the previous particle's rows are consumed
    {  // --- 2. x = mu + y, L^T y = eps, by chunks of CH steps --------------------------
      // Lane (g, c) of a warp: sample pair q0 + g, chunk c (steps t0 .. t0 + CH - 1).
      const int gpw = 32 / NC, g = lane / NC, c = lane - g * NC, t0 = c * CH;
      const float* tb = tab_sh + c;  // entry k of step t0 + i at tb[k T + i NC]
      for (int q0 = warp * gpw; q0 < dj; q0 += nwarps * gpw) {  // uniform in a warp
        const int q = q0 + g;
        const bool on = g < gpw && q < dj;
        const int d = on ? q / npairs : 0, j = on ? q - d * npairs : 0;
        const bool two = 2 * j + 1 < S;
        // pass 1: the draws and the chunk's recurrence from a zero carry
        float z[CH][4];  // y of rows 2j (p, v) and 2j + 1 (p, v) at step t0 + i
        float y0p = 0.0f, y0v = 0.0f, y1p = 0.0f, y1v = 0.0f;
#pragma unroll
        for (int i = CH - 1; i >= 0; --i) {
          const int t = t0 + i;
          float2 ep, ev;  // the pair's normals at lanes t and T + t
          if (eps != nullptr) {
            const float* er = eps + (((size_t)d * P + p) * S + 2 * j) * M;
            ep = make_float2(on ? er[t] : 0.0f, on && two ? er[M + t] : 0.0f);
            ev = make_float2(on ? er[T + t] : 0.0f, on && two ? er[M + T + t] : 0.0f);
          } else {
            ep = normals(t, j, p, d, key);
            ev = normals(T + t, j, p, d, key);
          }
          const float* tt = tb + i * NC;
          const float d00 = tt[0], d01 = tt[T], d11 = tt[2 * T];
          const float a00 = tt[3 * T], a01 = tt[4 * T], a10 = tt[5 * T], a11 = tt[6 * T];
          const float n0p = fmaf(d00, ep.x, fmaf(d01, ev.x, fmaf(a00, y0p, a01 * y0v)));
          const float n0v = fmaf(d11, ev.x, fmaf(a10, y0p, a11 * y0v));
          const float n1p = fmaf(d00, ep.y, fmaf(d01, ev.y, fmaf(a00, y1p, a01 * y1v)));
          const float n1v = fmaf(d11, ev.y, fmaf(a10, y1p, a11 * y1v));
          y0p = n0p, y0v = n0v, y1p = n1p, y1v = n1v;
          z[i][0] = n0p, z[i][1] = n0v, z[i][2] = n1p, z[i][3] = n1v;
        }
        // the carries: y at step t0 is y0 + Phi_c y(t0 + CH); a suffix scan of the
        // chunks' affine maps over the pair's lanes
        float f00 = phi_sh[c], f01 = phi_sh[NC + c], f10 = phi_sh[2 * NC + c];
        float f11 = phi_sh[3 * NC + c];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          if (o >= NC) break;
          const float g00 = __shfl_down_sync(FULL, f00, o), g01 = __shfl_down_sync(FULL, f01, o);
          const float g10 = __shfl_down_sync(FULL, f10, o), g11 = __shfl_down_sync(FULL, f11, o);
          const float u0p = __shfl_down_sync(FULL, y0p, o), u0v = __shfl_down_sync(FULL, y0v, o);
          const float u1p = __shfl_down_sync(FULL, y1p, o), u1v = __shfl_down_sync(FULL, y1v, o);
          if (c + o < NC) {
            y0p = fmaf(f00, u0p, fmaf(f01, u0v, y0p)), y0v = fmaf(f10, u0p, fmaf(f11, u0v, y0v));
            y1p = fmaf(f00, u1p, fmaf(f01, u1v, y1p)), y1v = fmaf(f10, u1p, fmaf(f11, u1v, y1v));
            const float n00 = f00 * g00 + f01 * g10, n01 = f00 * g01 + f01 * g11;
            const float n10 = f10 * g00 + f11 * g10, n11 = f10 * g01 + f11 * g11;
            f00 = n00, f01 = n01, f10 = n10, f11 = n11;
          }
        }
        // the carry into the chunk: y at the next chunk's first step (0 past the last)
        const bool last = c + 1 == NC;
        float h0p = __shfl_down_sync(FULL, y0p, 1), h0v = __shfl_down_sync(FULL, y0v, 1);
        float h1p = __shfl_down_sync(FULL, y1p, 1), h1v = __shfl_down_sync(FULL, y1v, 1);
        if (last) h0p = h0v = h1p = h1v = 0.0f;
        // pass 2: y_t = z_t + A_t ... A_{t0 + CH - 1} carry
#pragma unroll
        for (int i = CH - 1; i >= 0; --i) {
          const float* tt = tb + i * NC;
          const float a00 = tt[3 * T], a01 = tt[4 * T], a10 = tt[5 * T], a11 = tt[6 * T];
          const float n0p = fmaf(a00, h0p, a01 * h0v), n0v = fmaf(a10, h0p, a11 * h0v);
          const float n1p = fmaf(a00, h1p, a01 * h1v), n1v = fmaf(a10, h1p, a11 * h1v);
          h0p = n0p, h0v = n0v, h1p = n1p, h1v = n1v;
          z[i][0] += n0p, z[i][1] += n0v, z[i][2] += n1p, z[i][3] += n1v;
        }
        // x = mu + y in place (mu = 0 on an idle lane), written as float4 rows
        const float* mu = means + ((size_t)d * P + p) * M + t0;
        float* x = rows_sh + (size_t)(d * S + 2 * j) * M + t0;
#pragma unroll
        for (int h = 0; h < 2; ++h)  // the position lanes, the velocity lanes
#pragma unroll
          for (int k = 0; k < CH; k += 4) {
            const float4 m = on ? __ldg(reinterpret_cast<const float4*>(mu + h * T + k))
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            z[k][h] += m.x, z[k + 1][h] += m.y, z[k + 2][h] += m.z, z[k + 3][h] += m.w;
            z[k][2 + h] += m.x, z[k + 1][2 + h] += m.y, z[k + 2][2 + h] += m.z;
            z[k + 3][2 + h] += m.w;
            if (on)
              *reinterpret_cast<float4*>(x + h * T + k) =
                  make_float4(z[k][h], z[k + 1][h], z[k + 2][h], z[k + 3][h]);
            if (on && two)
              *reinterpret_cast<float4*>(x + M + h * T + k) =
                  make_float4(z[k][2 + h], z[k + 1][2 + h], z[k + 2][2 + h], z[k + 3][2 + h]);
          }
        // the rows' quadratic terms: the chunk's stencil residuals, the anchors and
        // tau x . pu; x at step t0 + CH is lane c + 1's first step (none past T - 1)
        const float x0p = __shfl_down_sync(FULL, z[0][0], 1);
        const float x0v = __shfl_down_sync(FULL, z[0][1], 1);
        const float x1p = __shfl_down_sync(FULL, z[0][2], 1);
        const float x1v = __shfl_down_sync(FULL, z[0][3], 1);
        const float* pu = pu_sh + d * M + t0;
        float e0 = 0.0f, e1 = 0.0f, u0 = 0.0f, u1 = 0.0f;  // energies, x . pu of both rows
#pragma unroll
        for (int k = 0; k < CH; k += 4) {
          const float4 pp = *reinterpret_cast<const float4*>(pu + k);
          const float4 pv = *reinterpret_cast<const float4*>(pu + T + k);
          const float pk[2][4] = {{pp.x, pp.y, pp.z, pp.w}, {pv.x, pv.y, pv.z, pv.w}};
#pragma unroll
          for (int i = k; i < k + 4; ++i) {
            u0 = fmaf(z[i][0], pk[0][i - k], fmaf(z[i][1], pk[1][i - k], u0));
            u1 = fmaf(z[i][2], pk[0][i - k], fmaf(z[i][3], pk[1][i - k], u1));
            const bool in = i + 1 < CH;
            if (in || !last) {
              const float n0p = in ? z[(i + 1) % CH][0] : x0p;
              const float n0v = in ? z[(i + 1) % CH][1] : x0v;
              const float n1p = in ? z[(i + 1) % CH][2] : x1p;
              const float n1v = in ? z[(i + 1) % CH][3] : x1v;
              e0 += quad2(prm.q11, prm.q12, prm.q22, z[i][0] + prm.dt * z[i][1] - n0p,
                          z[i][1] - n0v);
              e1 += quad2(prm.q11, prm.q12, prm.q22, z[i][2] + prm.dt * z[i][3] - n1p,
                          z[i][3] - n1v);
            }
          }
        }
        if (c == 0) {  // the start anchor at t = 0
          const float sp = prm.s_pd[2 * d], sv = prm.s_pd[2 * d + 1];
          e0 += quad2(prm.ks11, prm.ks12, prm.ks22, z[0][0] - sp, z[0][1] - sv);
          e1 += quad2(prm.ks11, prm.ks12, prm.ks22, z[0][2] - sp, z[0][3] - sv);
        }
        if (last) {  // the goal anchor at t = T - 1; the goal's (pos, vel) per dof
          const float* gp = g_pd + ((size_t)(p / prm.ppg) * D + d) * 2;
          const float gq = gp[0], gv = gp[1];
          e0 += quad2(prm.kg11, prm.kg12, prm.kg22, z[CH - 1][0] - gq, z[CH - 1][1] - gv);
          e1 += quad2(prm.kg11, prm.kg12, prm.kg22, z[CH - 1][2] - gq, z[CH - 1][3] - gv);
        }
        e0 = fmaf(prm.temperature, u0, e0), e1 = fmaf(prm.temperature, u1, e1);
        // a suffix sum over the pair's lanes: lane c ends with chunks c .. NC - 1
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          if (o >= NC) break;
          const float v0 = __shfl_down_sync(FULL, e0, o), v1 = __shfl_down_sync(FULL, e1, o);
          if (c + o < NC) e0 += v0, e1 += v1;
        }
        if (on && c == 0) {
          rowq_sh[d * S + 2 * j] = e0;
          if (two) rowq_sh[d * S + 2 * j + 1] = e1;
        }
      }
      __syncthreads();
    }

    // --- 3. FK + link fields per (sample, t); SE(3) goal at t = T-1 -------------
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

    // --- 4. per-sample cost, the softmax over the S samples ------------------------
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

    // --- 5. the mean update -----------------------------------------------------------
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

// The substitution's limits: whole warps of time steps, 2T lanes of a row
// within MAX_LANES, and a pair's chunks within one warp.
bool valid(const DofStepParams* prm, const FkChain* chain, int variant) {
  const int T = prm->T;
  return T % 32 == 0 && 2 * T <= MAX_LANES && T / CH <= 32 && prm->D >= 1 &&
         prm->D <= FK_MAX_JOINTS && prm->S >= 1 && prm->ppg >= 1 && prm->P >= 1 &&
         prm->n_obst >= 0 && fk_variant_valid(*chain, variant);
}

void* pick(int variant) {
  return variant ? reinterpret_cast<void*>(fused_panda_dof_step_kernel<1>)
                 : reinterpret_cast<void*>(fused_panda_dof_step_kernel<0>);
}

// The launch at this shape: threads and shared memory per CTA; refuses a
// CTA whose shared memory exceeds kSmemLimit.
cudaError_t configure(const DofStepParams* prm, const FkChain* chain, int variant, int* threads,
                      size_t* smem) {
  *threads = SUB_THREADS;
  *smem = sizeof(float) *
          layout(prm->T, prm->D, prm->S, prm->n_obst, chain->n_links, variant == 0, *threads).total;
  if (*smem > kSmemLimit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(pick(variant), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

// One launch of `ctas` CTAs (each loops over the particles blockIdx.x,
// blockIdx.x + ctas, ...). tables: the prior factor's backward tables
// [7][T] (D_t^{-T}: (0,0), (0,1), (1,1); A_t: (0,0), (0,1), (1,0), (1,1));
// variant: the chain's FK spec (1: FkPanda, 0: the generic walk).
extern "C" int fused_panda_dof_step_launch(const float* means, const float* g_pd,
                                           const float* tables, const float* spheres,
                                           const float* eps, float* new_means, float* costs,
                                           int ctas, int variant, const DofStepParams* prm,
                                           const FkChain* chain, void* stream) {
  if (!valid(prm, chain, variant) || ctas < 1) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  cudaError_t err = configure(prm, chain, variant, &threads, &smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (variant)
    fused_panda_dof_step_kernel<1><<<ctas, threads, smem, st>>>(
        means, g_pd, tables, spheres, eps, new_means, costs, *prm, *chain);
  else
    fused_panda_dof_step_kernel<0><<<ctas, threads, smem, st>>>(
        means, g_pd, tables, spheres, eps, new_means, costs, *prm, *chain);
  return (int)cudaGetLastError();
}

// The launch at this shape, into shape[3]: the CTAs resident on one SM (0
// where the shared memory exceeds kSmemLimit), the dynamic shared memory per
// CTA in bytes and the threads per CTA.
extern "C" int fused_panda_dof_step_config(const DofStepParams* prm, const FkChain* chain,
                                           int variant, int* shape) {
  if (!valid(prm, chain, variant)) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  const cudaError_t err = configure(prm, chain, variant, &threads, &smem);
  shape[0] = 0;
  shape[1] = (int)smem;
  shape[2] = threads;
  if (smem > kSmemLimit) return (int)cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(shape, pick(variant), threads, smem);
}
