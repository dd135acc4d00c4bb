"""Work of one planar StochGPMP iteration, from the configuration's shapes.

P particles, S samples, T steps of state ``d = 2 n`` (n degrees of
freedom), ``M = T d`` lanes. Floating-point operations (a multiply-add is
2) of the arithmetic the iteration needs, with the structural zeros of its
matrices left out; the random draw (Philox and Box-Muller) is not counted.

- Sampling, ``x = mu + eps L^{-1}``: the prior treats each degree of freedom
  alike and apart, so ``L^{-1}`` couples only lanes of one degree of
  freedom, and within one it is lower triangular: ``n * 2T (2T + 1) / 2``
  non-zeros (``W_NNZ``; tests count them in the reference's own factor).
  ``2 * nnz + M`` per sample.
- Smoothness cost in residual form: per transition, ``e = x_{t+1} - Phi
  x_t`` (``d`` for ``Phi x``, whose velocity rows are copies, plus ``d``),
  and ``e^T Q^{-1} e`` with ``Q^{-1}``'s ``4 n`` non-zeros (``2 * 4n + 2d``);
  the start and goal anchors ``3 d`` each.
- Collision: per point after the first step, the cell ``floor(v / cell +
  o)`` of two coordinates (4), and per circle of the scene ``dx, dy, dx^2 +
  dy^2`` and the compare (6). Rectangles are integer compares, not counted.
- Importance term: ``Lambda_s mu`` once per particle (``2 * nnz(Lambda_s)``,
  block tridiagonal, ``2n`` non-zeros per 2 x 2 block, ``3T - 2`` blocks per
  degree of freedom), then ``x . Lambda_s mu`` per sample (``2M``).
- Softmax and update: per sample ``-c / tau``, the max, ``exp`` and the sum
  (4); per particle ``mu + a sum_s w_s (x_s - mu)`` (``3 S M + 2 M``).

Bytes: each input read once and each output written once, float32: the
means in and out, ``L^{-1}``'s non-zeros, the costs ``[P, S]`` written, and
the scene's primitives (4 words a rectangle, 3 a circle).
"""

from __future__ import annotations


def shapes(cfg: dict) -> dict:
    n = cfg["n_dof"]
    t = cfg["traj_len"]
    return dict(P=cfg["particles_per_goal"] * len(cfg["goals"]), S=cfg["num_samples"],
                T=t, n=n, d=2 * n, M=2 * n * t)


def w_nnz(cfg: dict) -> int:
    """Non-zeros of the sampling map ``L^{-1}``."""
    s = shapes(cfg)
    k = 2 * s["T"]
    return s["n"] * k * (k + 1) // 2


def iteration(cfg: dict, n_rects: int, n_circles: int) -> dict:
    """``{"flops", "bytes"}`` of one iteration over all particles."""
    s = shapes(cfg)
    p, smp, t, n, d, m = s["P"], s["S"], s["T"], s["n"], s["d"], s["M"]
    rows = p * smp
    sampling = rows * (2 * w_nnz(cfg) + m)
    smooth = rows * ((t - 1) * (d + d + 8 * n + 2 * d) + 2 * 3 * d)
    collision = rows * (t - 1) * (4 + 6 * n_circles)
    lam_nnz = n * 4 * (3 * t - 2)
    importance = p * 2 * lam_nnz + rows * 2 * m
    update = rows * 4 + p * (3 * smp * m + 2 * m)
    flops = sampling + smooth + collision + importance + update
    nbytes = 4 * (2 * p * m + w_nnz(cfg) + rows + 4 * n_rects + 3 * n_circles)
    return {"flops": float(flops), "bytes": float(nbytes)}


def iteration_of(cfg: dict, plan) -> dict:
    """:func:`iteration` in the scene of ``plan``."""
    rects = sum(1 for o in plan.obstacles if o[0] == "rect")
    return iteration(cfg, rects, len(plan.obstacles) - rects)
