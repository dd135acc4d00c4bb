// Forward kinematics of a serial chain, the link RBF fields and the SE(3)
// goal distance at one configuration, shared by fk_fields.cu (K4, K8),
// link_fields.cu (K7), fused_panda_step.cu (K6) and fused_panda_dof_step.cu
// (K5).
//
// The TPU kernels fold the chain into their trace (KinematicChain
// .fk_planes_from_scalars: Python-float constants, 0/+-1 entries dropped).
// Here the chain is a small joint table (FkChain, built on the host by
// KinematicChain.joint_table) walked by a generic loop: per joint
//   p <- p + R t_j,  R <- R A_j,  then R <- R Rodrigues(axis_j, q_dof)
//   (revolute) or p <- p + q_dof R axis_j (prismatic),
// so results agree with the folded FK to float32 roundoff, not bit for bit.
// The table rides in a __grid_constant__ kernel parameter: every thread
// reads the same entry at once (a constant-bank broadcast).
//
// Link positions go to the caller's shared-memory scratch, one column per
// thread (pos[(3 * link + c) * stride]), because the output slot of a joint
// is data: a register array indexed by it would spill to local memory.
#pragma once

#include <cuda_runtime.h>

#define FK_MAX_JOINTS 16

struct FkChain {
  int n_joints, n_links;
  int type[FK_MAX_JOINTS];  // 0 fixed, 1 revolute, 2 prismatic
  int dof[FK_MAX_JOINTS];   // joint-angle index, -1 for a fixed joint
  int slot[FK_MAX_JOINTS];  // output link index, -1 when not selected
  float rot[9 * FK_MAX_JOINTS];    // origin rotation, row-major
  float trans[3 * FK_MAX_JOINTS];  // origin translation
  float axis[3 * FK_MAX_JOINTS];
};

namespace {

// Walks the chain at q (q(i) returns joint angle i). Writes each selected
// link's position to pos[(3 * slot + c) * stride] and the rotation of the
// last selected link (the end-effector) to ee_r.
template <class Q>
__device__ __forceinline__ void fk_walk(const FkChain& ch, Q q, float* pos, int stride,
                                        float (&ee_r)[9]) {
  float R[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float p[3] = {0.f, 0.f, 0.f};
  for (int j = 0; j < ch.n_joints; ++j) {
    const float* A = ch.rot + 9 * j;
    const float* tr = ch.trans + 3 * j;
    float np[3], nr[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      np[i] = p[i] + R[3 * i] * tr[0] + R[3 * i + 1] * tr[1] + R[3 * i + 2] * tr[2];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        nr[3 * i + k] = R[3 * i] * A[k] + R[3 * i + 1] * A[3 + k] + R[3 * i + 2] * A[6 + k];
    }
    const int type = ch.type[j];
    if (type == 1) {
      const float kx = ch.axis[3 * j], ky = ch.axis[3 * j + 1], kz = ch.axis[3 * j + 2];
      float s, c;
      sincosf(q(ch.dof[j]), &s, &c);
      const float oc = 1.0f - c;
      // Rodrigues M = I + s K + (1 - c) K^2
      const float M[9] = {c + oc * kx * kx,      oc * kx * ky - s * kz, oc * kx * kz + s * ky,
                          oc * ky * kx + s * kz, c + oc * ky * ky,      oc * ky * kz - s * kx,
                          oc * kz * kx - s * ky, oc * kz * ky + s * kx, c + oc * kz * kz};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          R[3 * i + k] = nr[3 * i] * M[k] + nr[3 * i + 1] * M[3 + k] + nr[3 * i + 2] * M[6 + k];
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = nr[i];
      if (type == 2) {
        const float qj = q(ch.dof[j]);
        const float* ax = ch.axis + 3 * j;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          np[i] += qj * (R[3 * i] * ax[0] + R[3 * i + 1] * ax[1] + R[3 * i + 2] * ax[2]);
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) p[i] = np[i];
    const int slot = ch.slot[j];
    if (slot >= 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) pos[(3 * slot + c) * stride] = p[c];
      if (slot == ch.n_links - 1) {
#pragma unroll
        for (int i = 0; i < 9; ++i) ee_r[i] = R[i];
      }
    }
  }
}

// Self RBF (all ordered link pairs with the diagonal, as the reference) and
// obstacle-sphere RBF at the link positions of one point, in the TPU
// kernel's order of terms:
//   w_self * (sum_{i<j} 2 exp(-d2_ij * inv_2m2) + L)
// + w_obst * sum_l sum_k exp(-0.5 d2_lk / r_k^2)
__device__ __forceinline__ float link_fields(const float* pos, int stride, int n_links,
                                             const float* spheres, int n_obst,
                                             float inv_2m2, float w_self, float w_obst) {
  float acc = 0.0f;
  if (w_self != 0.0f) {
    float s = 0.0f;
    for (int i = 0; i < n_links; ++i) {
      const float xi = pos[(3 * i) * stride], yi = pos[(3 * i + 1) * stride],
                  zi = pos[(3 * i + 2) * stride];
      for (int j = i + 1; j < n_links; ++j) {
        const float dx = xi - pos[(3 * j) * stride];
        const float dy = yi - pos[(3 * j + 1) * stride];
        const float dz = zi - pos[(3 * j + 2) * stride];
        s += 2.0f * expf(-(dx * dx + dy * dy + dz * dz) * inv_2m2);
      }
    }
    acc += w_self * (s + (float)n_links);
  }
  if (w_obst != 0.0f && n_obst > 0) {
    float o = 0.0f;
    for (int l = 0; l < n_links; ++l) {
      const float x = pos[(3 * l) * stride], y = pos[(3 * l + 1) * stride],
                  z = pos[(3 * l + 2) * stride];
      for (int k = 0; k < n_obst; ++k) {
        const float dx = x - spheres[4 * k], dy = y - spheres[4 * k + 1],
                    dz = z - spheres[4 * k + 2], r = spheres[4 * k + 3];
        o += expf(-0.5f * (dx * dx + dy * dy + dz * dz) / (r * r));
      }
    }
    acc += w_obst * o;
  }
  return acc;
}

// arccos by Abramowitz & Stegun 4.4.46 (|err| <= 2e-8 rad), as the TPU
// kernels (ops/pallas/panda_step.py, panda_step_dof.py) compute it.
__device__ __forceinline__ float acos_poly(float x) {
  const float az = fabsf(x);
  const float poly =
      1.5707963050f +
      az * (-0.2145988016f +
            az * (0.0889789874f +
                  az * (-0.0501743046f +
                        az * (0.0308918810f +
                              az * (-0.0170881256f +
                                    az * (0.0066700901f + az * -0.0012624911f))))));
  const float r = sqrtf(1.0f - az) * poly;
  return x >= 0.0f ? r : 3.14159265358979323846f - r;
}

// w_pos |p_ee - p*| + w_rot acos_poly(clamp((tr(R_ee^T R*) - 1) / 2)) with
// the end-effector position in the last link's column of pos (as fk_walk
// writes it), its rotation ee_r and the row-major 4x4 target.
__device__ __forceinline__ float ee_goal_distance(const float* pos, int stride, int n_links,
                                                  const float (&ee_r)[9], const float* target,
                                                  float w_pos, float w_rot) {
  float sq = 0.0f, tr = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float dd = pos[(3 * (n_links - 1) + c) * stride] - target[4 * c + 3];
    sq += dd * dd;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) tr += ee_r[3 * i + j] * target[4 * i + j];
  const float cosang = fminf(fmaxf((tr - 1.0f) * 0.5f, -1.0f + 1e-7f), 1.0f - 1e-7f);
  return w_pos * sqrtf(sq) + w_rot * acos_poly(cosang);
}

}  // namespace
