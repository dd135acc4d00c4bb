// The FK kernels' joint table (FkChain) and the chain structures their walk
// is specialised for (FkSpec), with the one rule that matches a table to a
// spec. Plain C++ (no CUDA): fk_chain.cuh builds the walks on it, and
// fk_spec.cpp exports the match to the host (fk_chain_variant), so the
// wrappers and the launchers ask the same code.
//
// Variants, the launchers' `variant` argument: 0 the generic walk (any
// serial chain), 1 FkPanda.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define FK_HD __host__ __device__
#else
#define FK_HD
#endif

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

FK_HD constexpr int fk_popc(unsigned v) { return v ? int(v & 1u) + fk_popc(v >> 1) : 0; }

// A chain structure known at compile time: NJ joints; bit j of SEL set when
// joint j's child link is selected (the slots rise with j); bit j of REV set
// when joint j is revolute about +z or -z (else fixed); two bits per joint of
// ROT, its origin rotation: 0 the identity, 1 Rx(+90 deg), 2 Rx(-90 deg), 3
// any (read from the table).
template <int NJ_, unsigned SEL_, unsigned REV_, unsigned ROT_>
struct FkSpec {
  static constexpr int NJ = NJ_;
  static constexpr unsigned SEL = SEL_, REV = REV_, ROT = ROT_;
  static constexpr int NL = fk_popc(SEL_);
};

// franka_panda(link_names=PANDA_FK_LINKS): a fixed base joint, 7 revolute joints about
// +z with origin rotations I, I, Rx(-90), Rx(+90), Rx(+90), Rx(-90),
// Rx(+90), Rx(+90), and two fixed joints (hand, end-effector) with general
// rotations; 9 links, joints 1..9.
using FkPanda = FkSpec<10, 0x3FEu, 0x0FEu,
                       (2u << 4) | (1u << 6) | (1u << 8) | (2u << 10) | (1u << 12) |
                           (1u << 14) | (3u << 16) | (3u << 18)>;

namespace {

// 0 / 1 / 2: the entries of I, Rx(+90 deg), Rx(-90 deg) within 1e-6 (a URDF
// rpy of +-pi/2 leaves cos = 6e-17, below float32 roundoff of the walk's
// sums); 3: any.
inline bool rot_matches(const float* A, unsigned code) {
  if (code == 3) return true;
  const float s = code == 1 ? 1.0f : (code == 2 ? -1.0f : 0.0f), c = code == 0 ? 1.0f : 0.0f;
  const float want[9] = {1.0f, 0.0f, 0.0f, 0.0f, c, -s, 0.0f, s, c};
  for (int i = 0; i < 9; ++i)
    if (!(fabsf(A[i] - want[i]) <= 1e-6f)) return false;
  return true;
}

// Whether the table `ch` has the structure of Spec.
template <class Spec>
bool fk_spec_matches(const FkChain& ch) {
  if (ch.n_joints != Spec::NJ || ch.n_links != Spec::NL) return false;
  int slot = 0;
  for (int j = 0; j < Spec::NJ; ++j) {
    const bool sel = (Spec::SEL >> j) & 1u, rev = (Spec::REV >> j) & 1u;
    if (ch.slot[j] != (sel ? slot++ : -1)) return false;
    if (ch.type[j] != (rev ? 1 : 0)) return false;
    if (rev && (ch.axis[3 * j] != 0.0f || ch.axis[3 * j + 1] != 0.0f ||
                (ch.axis[3 * j + 2] != 1.0f && ch.axis[3 * j + 2] != -1.0f)))
      return false;
    if (!rot_matches(ch.rot + 9 * j, (Spec::ROT >> (2 * j)) & 3u)) return false;
  }
  return true;
}

// The walk the kernels take for `ch`: the first spec it matches, else 0.
inline int fk_variant_of(const FkChain& ch) { return fk_spec_matches<FkPanda>(ch) ? 1 : 0; }

// Whether a launch may take `variant` on `ch`: the generic walk takes any
// chain within FK_MAX_JOINTS, a specialised one only the chain it matches.
inline bool fk_variant_valid(const FkChain& ch, int variant) {
  if (ch.n_joints < 0 || ch.n_joints > FK_MAX_JOINTS || ch.n_links < 1) return false;
  return variant == 0 || variant == fk_variant_of(ch);
}

}  // namespace
