// K3: factor-graph (stencil) GP energy of dof-plane sample rows, with the
// start/goal anchors and the planner's importance term fused in.
//
// Replaces the TPU kernel stoch_gpmp_tpu/ops/pallas/stencil.py
// dof_quad_eval_pallas (_dof_quad_kernel). For row b of x [D, B, 2T]
// (per dof: positions p[0..T-1], velocities v[0..T-1]):
//   out[b] = sum_d [ sum_{t<T-1} q11 rp^2 + 2 q12 rp rv + q22 rv^2
//                    (rp = p_t + dt v_t - p_{t+1}, rv = v_t - v_{t+1})
//                  + K_s quadratic of (p_0, v_0) - start anchor of dof d
//                  + K_g quadratic of (p_{T-1}, v_{T-1}) - goal anchor of
//                    dof d for row b's goal (rows goal-major)
//                  + tau * x_d[b] . pu_d[b / S] ]      (when pu is given)
// No cancellation: the large weights (~2e11 at the Panda sigmas) multiply
// small residuals, so FP32 is exact enough.
//
// Bound on the H100: device memory. At config 5 it reads the 73 MB sample
// planes once, plus pu (9 MB, L2-resident across the S rows of a
// particle): ~84 MB, ~25 us at 3.35 TB/s. Design: one warp per row; each
// lane loads four consecutive steps of p and v as float4; the t+1
// neighbour of a lane's last step is the next lane's first, by a shuffle
// (lane 31 reads it from the next chunk); the dofs are summed in the
// kernel, so the TPU kernel's [B, d] column table (a Mosaic tiling
// workaround) does not exist.

#include <cuda_runtime.h>

#include "kernel_common.cuh"

namespace {

struct QuadWeights {
  float q11, q12, q22, ks11, ks12, ks22, kg11, kg12, kg22, dt;
};

__device__ __forceinline__ float quad2(float a11, float a12, float a22, float r, float s) {
  return a11 * r * r + 2.0f * a12 * r * s + a22 * s * s;
}

__global__ void dof_quad_eval_kernel(const float* __restrict__ x, const float* __restrict__ pu,
                                     const float* __restrict__ s_pd,
                                     const float* __restrict__ g_pd, float* __restrict__ out,
                                     int D, int B, int T, int rows_per_goal, int S,
                                     QuadWeights w, float temperature) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together
  const int goal = row / rows_per_goal;
  const size_t t2 = 2 * (size_t)T;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float e = 0.0f, imp = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float* xr = x + ((size_t)d * B + row) * t2;
    const float* pr = pu == nullptr ? nullptr : pu + ((size_t)d * (B / S) + row / S) * t2;
    for (int base = 0; base < T; base += 128) {
      const int c = base + 4 * lane;
      const bool valid = c < T;
      const float4 p4 = valid ? *reinterpret_cast<const float4*>(xr + c) : zero;
      const float4 v4 = valid ? *reinterpret_cast<const float4*>(xr + T + c) : zero;
      float pn = __shfl_down_sync(0xffffffffu, p4.x, 1);
      float vn = __shfl_down_sync(0xffffffffu, v4.x, 1);
      if (lane == 31) {
        pn = c + 4 < T ? xr[c + 4] : 0.0f;
        vn = c + 4 < T ? xr[T + c + 4] : 0.0f;
      }
      if (!valid) continue;
      const float pp[5] = {p4.x, p4.y, p4.z, p4.w, pn};
      const float vv[5] = {v4.x, v4.y, v4.z, v4.w, vn};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c + k < T - 1) {
          const float rp = pp[k] + w.dt * vv[k] - pp[k + 1];
          const float rv = vv[k] - vv[k + 1];
          e += quad2(w.q11, w.q12, w.q22, rp, rv);
        }
      }
      if (c == 0)
        e += quad2(w.ks11, w.ks12, w.ks22, p4.x - s_pd[2 * d], v4.x - s_pd[2 * d + 1]);
      if (c + 3 == T - 1) {
        const float* g = g_pd + ((size_t)goal * D + d) * 2;
        e += quad2(w.kg11, w.kg12, w.kg22, p4.w - g[0], v4.w - g[1]);
      }
      if (pr != nullptr) {
        const float4 a = *reinterpret_cast<const float4*>(pr + c);
        const float4 b = *reinterpret_cast<const float4*>(pr + T + c);
        imp += p4.x * a.x + p4.y * a.y + p4.z * a.z + p4.w * a.w;
        imp += v4.x * b.x + v4.y * b.y + v4.z * b.z + v4.w * b.w;
      }
    }
  }
  const float total = warp_sum(e + temperature * imp);
  if (lane == 0) out[row] = total;
}

}  // namespace

extern "C" int dof_quad_eval_launch(const float* x, const float* pu, const float* s_pd,
                                    const float* g_pd, float* out, int D, int B, int T,
                                    int rows_per_goal, int S, float q11, float q12, float q22,
                                    float ks11, float ks12, float ks22, float kg11, float kg12,
                                    float kg22, float dt, float temperature, void* stream) {
  if (T % 4 != 0 || B < 1 || rows_per_goal < 1 || S < 1 || B % S != 0)
    return (int)cudaErrorInvalidValue;
  const QuadWeights w{q11, q12, q22, ks11, ks12, ks22, kg11, kg12, kg22, dt};
  const int warps = 8;
  const int blocks = (B + warps - 1) / warps;
  dof_quad_eval_kernel<<<blocks, 32 * warps, 0, (cudaStream_t)stream>>>(
      x, pu, s_pd, g_pd, out, D, B, T, rows_per_goal, S, w, temperature);
  return (int)cudaGetLastError();
}
