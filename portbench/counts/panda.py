"""Work of one fused dof Panda iteration (K5), from the configuration's
shapes.

P particles, S samples, n degrees of freedom, T steps; each dof's
trajectory is a plane of ``2T`` lanes (positions, then velocities).
Floating-point operations (a multiply-add is 2) of the arithmetic the
iteration needs, with the structural zeros of its matrices left out, as
``counts/planar.py`` counts K2; the random draw (Philox and Box-Muller) is
not counted.

- Sampling, ``x = mu + eps W_dof`` per dof plane: ``W_dof`` is ``L^{-1}`` of
  one dof's ``[2T, 2T]`` precision, lower triangular in time order, so
  ``2T (2T + 1) / 2`` non-zeros (``w_nnz``; tests count them in the
  reference's own factor). ``2 nnz + 2T`` per dof and sample. K5 skips
  the zero half of ``W_dof``'s four ``T x T`` blocks and multiplies the
  ``T`` zeros on one block's diagonal; they are not counted.
- ``Sigma^{-1} mu`` once per dof and particle (``2 nnz(Lambda_s)``, block
  tridiagonal: ``3T - 2`` blocks of 2 x 2), then ``x . Sigma^{-1} mu`` per
  dof and sample (``2 * 2T``).
- The quadratic in residual form per dof and sample: per transition the
  residual (4) and its 2 x 2 form (12), the two anchors 6 each.
- Forward kinematics at the points the costs read (steps 1..T-1 of each
  sample): per joint the translation of its origin in the parent's frame
  (6 per non-zero component: 3 products, 3 adds), per turn about z (a
  revolute joint's ``Rz(q)``, the hand's and the end-effector's fixed
  turns) 18 for the two columns it mixes, and a sine and a cosine (1
  each) per revolute joint; the origins' quarter turns are permutations
  and cost nothing. Counted from ``reference/panda.py``'s joint table.
- Link fields per point: per link pair (36 for 9 links, each counted once
  and doubled, the diagonal a constant) and per link and sphere, 11: the
  difference (3), its square (5), the exponent's scale (1), ``exp`` (1)
  and the sum (1); then the two weights and their sum (3).
- The SE(3) goal at the last step of each sample, 51: the position's
  distance (9), the trace of ``R^T R*`` (17), the cosine and its clamp (4),
  the angle's polynomial (18) and the square times the weight (3).
- Softmax and update: per sample ``-c / tau``, the max, ``exp`` and the sum
  (4); per dof and particle ``mu + a sum_s w_s (x_s - mu)`` (``3 S 2T + 2
  * 2T``).

Bytes: each input read once and each output written once, float32: the
means in and out, ``W_dof``'s non-zeros, the costs ``[P, S]`` written, the
goals' start and end states and the scene's spheres (4 words each).
"""

from __future__ import annotations

from portbench.reference.panda import PANDA_JOINTS

PAIR, GOAL = 11, 51


def shapes(cfg: dict) -> dict:
    return dict(P=cfg["particles_per_goal"] * len(cfg["goals"]), S=cfg["num_samples"],
                T=cfg["traj_len"], n=cfg["n_dof"], G=len(cfg["goals"]))


def w_nnz(cfg: dict) -> int:
    """Non-zeros of one dof's sampling map ``W_dof``."""
    k = 2 * cfg["traj_len"]
    return k * (k + 1) // 2


def fk_flops() -> int:
    """Operations of the Panda's forward kinematics at one configuration."""
    flops = 0
    for kind, rpy, xyz in PANDA_JOINTS:
        flops += 6 * sum(1 for v in xyz if v != 0.0)
        if kind == "revolute":
            flops += 18 + 2
        elif rpy[2] != 0.0:
            flops += 18
    return flops


def point_flops(n_obst: int, n_links: int = len(PANDA_JOINTS)) -> int:
    """Operations of FK and the link fields at one point."""
    pairs = n_links * (n_links - 1) // 2
    return fk_flops() + PAIR * (pairs + n_links * n_obst) + 3


def iteration(cfg: dict, n_obst: int) -> dict:
    """``{"flops", "bytes"}`` of one iteration over all particles."""
    s = shapes(cfg)
    p, smp, t, n = s["P"], s["S"], s["T"], s["n"]
    m = 2 * t
    rows = n * p * smp  # one per dof and sample
    sampling = rows * (2 * w_nnz(cfg) + m)
    prior = n * p * 2 * 4 * (3 * t - 2) + rows * 2 * m
    quadratic = rows * ((t - 1) * 16 + 2 * 6)
    fields = p * smp * ((t - 1) * point_flops(n_obst) + GOAL)
    update = p * smp * 4 + n * p * (3 * smp * m + 2 * m)
    flops = sampling + prior + quadratic + fields + update
    nbytes = 4 * (2 * n * p * m + w_nnz(cfg) + p * smp + s["G"] * n * 2 + 4 * n_obst)
    return {"flops": float(flops), "bytes": float(nbytes)}


def iteration_of(cfg: dict, plan) -> dict:
    """:func:`iteration` in the scene of ``plan``."""
    return iteration(cfg, len(plan.spheres))
