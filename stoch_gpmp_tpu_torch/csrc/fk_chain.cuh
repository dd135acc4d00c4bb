// Forward kinematics of a serial chain, the link RBF fields and the SE(3)
// goal distance at one configuration, shared by fk_fields.cu (K4, K8),
// link_fields.cu (K7), fused_panda_step.cu (K6) and fused_panda_dof_step.cu
// (K5).
//
// The TPU kernels fold the chain into their trace (KinematicChain
// .fk_planes_from_scalars: Python-float constants, 0/+-1 entries dropped).
// Here the chain is a small joint table (FkChain, built on the host by
// KinematicChain.joint_table), walked per joint as
//   p <- p + R t_j,  R <- R A_j,  then R <- R Rot(axis_j, q_dof)
//   (revolute) or p <- p + q_dof R axis_j (prismatic),
// so results agree with the folded FK to float32 roundoff, not bit for bit.
// The table rides in a __grid_constant__ kernel parameter: every thread
// reads the same entry at once (a constant-bank broadcast).
//
// Two walks:
// - fk_walk_spec<Spec>, for a chain whose structure is known when the
//   kernel is compiled (FkSpec: joint count, selected joints, revolute
//   joints, the origin rotations that are I or Rx(+-90 deg)): unrolled,
//   every link position in a register of its own, R A_j a signed swap of
//   two columns where A_j is Rx(+-90 deg), and the revolute step about +-z
//   (R <- R Rz(q): 12 operations where Rodrigues' general product takes 27).
//   The specs, the joint table and the rule that matches them are in
//   fk_spec.h; the host asks that rule (fk_chain_variant, through
//   ops/kernels/panda_fields.py fk_variant) and the launchers check the
//   variant they are given with it. The Panda (franka_panda(link_names=PANDA_FK_LINKS))
//   is FkPanda.
// - fk_walk, the generic walk of any serial chain (prismatic joints, any
//   axis): a runtime loop over the table that writes each selected link's
//   position to the caller's shared-memory column (pos[(3 * slot + c) *
//   stride]), because the output slot is data and a register array indexed
//   by it would go to local memory.
//
// link_fields evaluates the fields at either: a position accessor pos(l, c)
// (registers when the link count is a template argument, shared memory
// otherwise) and the spheres as shared-memory constants (load_spheres):
// exp(-0.5 d^2 / r^2) = exp2(d^2 k) with k = -0.5 log2(e) / r^2 computed once
// per CTA, so no division per term.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "fk_spec.h"

namespace {

// One joint of the specialised walk, then the next (J < NJ). RI: R is still
// the identity (no rotation so far), so p <- p + t_j and R <- A_j need no
// products.
template <class Spec, int J, bool RI, class Q>
__device__ __forceinline__ void fk_joint(const FkChain& ch, Q q, float (&R)[9], float (&p)[3],
                                         float (&pos)[Spec::NL][3], float (&ee_r)[9]) {
  if constexpr (J < Spec::NJ) {
    constexpr unsigned code = (Spec::ROT >> (2 * J)) & 3u;
    constexpr bool rev = (Spec::REV >> J) & 1u, sel = (Spec::SEL >> J) & 1u;
    const float* tr = ch.trans + 3 * J;
    if constexpr (RI) {
#pragma unroll
      for (int i = 0; i < 3; ++i) p[i] += tr[i];
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        p[i] += R[3 * i] * tr[0] + R[3 * i + 1] * tr[1] + R[3 * i + 2] * tr[2];
    }
    if constexpr (code == 3) {  // R <- R A_j (R = I: R <- A_j)
      const float* A = ch.rot + 9 * J;
      float nr[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          nr[3 * i + k] = RI ? A[3 * i + k]
                             : R[3 * i] * A[k] + R[3 * i + 1] * A[3 + k] + R[3 * i + 2] * A[6 + k];
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = nr[i];
    } else if constexpr (code != 0) {
      // R Rx(+90): (c1, c2) <- (c2, -c1); R Rx(-90): (c1, c2) <- (-c2, c1)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float c1 = R[3 * i + 1], c2 = R[3 * i + 2];
        R[3 * i + 1] = code == 1 ? c2 : -c2;
        R[3 * i + 2] = code == 1 ? -c1 : c1;
      }
    }
    constexpr bool ri_after = RI && code == 0 && !rev;
    if constexpr (rev) {  // R <- R Rz(+-q)
      float s, c;
      sincosf(q(ch.dof[J]), &s, &c);
      s *= ch.axis[3 * J + 2];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float c0 = R[3 * i], c1 = R[3 * i + 1];
        R[3 * i] = c * c0 + s * c1;
        R[3 * i + 1] = c * c1 - s * c0;
      }
    }
    if constexpr (sel) {
      constexpr int slot = fk_popc(Spec::SEL & ((1u << J) - 1u));
#pragma unroll
      for (int c = 0; c < 3; ++c) pos[slot][c] = p[c];
      if constexpr (slot == Spec::NL - 1) {
#pragma unroll
        for (int i = 0; i < 9; ++i) ee_r[i] = R[i];
      }
    }
    fk_joint<Spec, J + 1, ri_after>(ch, q, R, p, pos, ee_r);
  }
}

// The specialised walk at q (q(i) returns joint angle i): every selected
// link's position to pos[slot], the end-effector rotation (the last
// selected link's) to ee_r. The table must match Spec (fk_spec_matches).
template <class Spec, class Q>
__device__ __forceinline__ void fk_walk_spec(const FkChain& ch, Q q, float (&pos)[Spec::NL][3],
                                             float (&ee_r)[9]) {
  float R[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float p[3] = {0.f, 0.f, 0.f};
  fk_joint<Spec, 0, true>(ch, q, R, p, pos, ee_r);
}

// The generic walk at q (q(i) returns joint angle i). Writes each selected
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

// The spheres [n][4] (centre, radius) as the fields' constants (centre,
// -0.5 log2(e) / r^2) in shared memory, by the CTA's threads; the caller
// synchronises before they are read.
__device__ __forceinline__ void load_spheres(const float* __restrict__ spheres, int n,
                                             float4* sph) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float r = spheres[4 * k + 3];
    sph[k] = make_float4(spheres[4 * k], spheres[4 * k + 1], spheres[4 * k + 2],
                         -0.72134752044448170f / (r * r));  // -0.5 log2(e)
  }
}

// Self RBF (all ordered link pairs with the diagonal, as the reference) and
// obstacle-sphere RBF at the link positions pos(l, c) of one point:
//   w_self * (2 sum_{i<j} exp(-d2_ij * inv_2m2) + L)
// + w_obst * sum_k sum_l exp(-0.5 d2_lk / r_k^2)
// NL > 0: NL links, the loops unrolled (pos in registers); NL = 0: n_links.
template <int NL, class Pos>
__device__ __forceinline__ float link_fields(Pos pos, int n_links, const float4* sph, int n_obst,
                                             float inv_2m2, float w_self, float w_obst) {
  const int L = NL > 0 ? NL : n_links;
  float acc = 0.0f;
  if (w_self != 0.0f) {
    const float k = -1.4426950408889634f * inv_2m2;  // -log2(e) / (2 margin^2)
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < (NL > 0 ? NL : L); ++i) {
      const float xi = pos(i, 0), yi = pos(i, 1), zi = pos(i, 2);
#pragma unroll
      for (int j = i + 1; j < (NL > 0 ? NL : L); ++j) {
        const float dx = xi - pos(j, 0), dy = yi - pos(j, 1), dz = zi - pos(j, 2);
        s += exp2f((dx * dx + dy * dy + dz * dz) * k);
      }
    }
    acc += w_self * (2.0f * s + (float)L);
  }
  if (w_obst != 0.0f && n_obst > 0) {
    float o = 0.0f;
    for (int k = 0; k < n_obst; ++k) {
      const float4 c = sph[k];
#pragma unroll
      for (int l = 0; l < (NL > 0 ? NL : L); ++l) {
        const float dx = pos(l, 0) - c.x, dy = pos(l, 1) - c.y, dz = pos(l, 2) - c.z;
        o += exp2f((dx * dx + dy * dy + dz * dz) * c.w);
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
// the end-effector position ee (the last link's), its rotation ee_r and the
// row-major 4x4 target.
__device__ __forceinline__ float ee_goal_distance(const float (&ee)[3], const float (&ee_r)[9],
                                                  const float* target, float w_pos,
                                                  float w_rot) {
  float sq = 0.0f, tr = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float dd = ee[c] - target[4 * c + 3];
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
