// Forward kinematics of a serial chain and the link RBF fields at one
// configuration, shared by fk_fields.cu (K4) and fused_panda_dof_step.cu (K5).
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

}  // namespace
