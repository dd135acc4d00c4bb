"""Per-dof factored, plane-ordered form of the constant-velocity GP stack.

PyTorch counterpart of ``stoch_gpmp_tpu/gp/dof_factored.py``. Under the
reference's scalar sigmas the lifted trajectory Gaussian factorizes exactly
across dofs: the dense ``[M, M]`` precision/cost/sampling matrices are
permuted block-diagonals of ``n_dof`` identical ``[2T, 2T]`` blocks, kept
here in plane order (per dof ``[p_0..p_{T-1}, v_0..v_{T-1}]``).

The planar main path takes two things from it: the exact O(T) factor-graph
stencil ``Sigma^{-1} mu`` (``DofFactoredPrior.matvec_flat``, the importance
term's input) and the per-dof ``[2, 2]`` weights the fused kernels read
(``DofQuadraticCost``). The dof path (``planners/stoch_gpmp.py``) runs in
the dof-leading plane layout ``[d, ..., 2T]`` (``to_dof_planes``): sampling
against the shared ``[2T, 2T]`` factor (``sample_planes``), the plane
stencil ``matvec_planes`` and the residual-form quadratic
``DofQuadraticCost.eval_dof_planes`` (kernel K3 on the card).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import cached_property

import numpy as np
import torch

from stoch_gpmp_tpu_torch.gp.lift import q_inv_block, unary_weight
from stoch_gpmp_tpu_torch.gp.tridiag import BlockBidiagChol, BlockTridiag


def plane_perm(traj_len: int) -> np.ndarray:
    """Permutation taking a per-dof t-major ``[p(0), v(0), p(1), ...]``
    vector to plane order: ``x_plane = x_tmajor[perm]``."""
    t = traj_len
    return np.concatenate([2 * np.arange(t), 2 * np.arange(t) + 1])


def _perm2(mat: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    idx = torch.as_tensor(perm, device=mat.device)
    return mat[idx][:, idx]


def _assert_isotropic(k: torch.Tensor, n_dof: int, name: str) -> None:
    """Check ``k [2d, 2d]`` has the per-dof-decoupled form
    ``[[a I, b I], [c I, e I]]``; raises otherwise."""
    k = k.detach().cpu().double().numpy()
    d = n_dof
    a, b, c, e = k[0, 0], k[0, d], k[d, 0], k[d, d]
    expect = np.block([
        [a * np.eye(d), b * np.eye(d)],
        [c * np.eye(d), e * np.eye(d)],
    ])
    scale = max(1.0, float(np.abs(k).max()))
    if not np.allclose(k, expect, rtol=1e-5, atol=1e-6 * scale):
        raise ValueError(
            f"{name} is not per-dof isotropic; the dof-factored fast path "
            "requires scalar sigmas (the reference's only API)"
        )


def _dof2_block(k: torch.Tensor, n_dof: int) -> torch.Tensor:
    """The per-dof ``[2, 2]`` block of a ``[[aI, bI], [cI, eI]]`` weight."""
    d = n_dof
    return torch.stack([
        torch.stack([k[0, 0], k[0, d]]), torch.stack([k[d, 0], k[d, d]]),
    ])


def to_dof_planes(x: torch.Tensor) -> torch.Tensor:
    """``[..., T, 2d] -> [d, ..., 2T]``: per dof its position plane then its
    velocity plane, dof axis leading (contiguous)."""
    t, d2 = x.shape[-2], x.shape[-1]
    d = d2 // 2
    y = x.reshape(x.shape[:-2] + (t, 2, d))
    nb = y.dim() - 3
    y = y.permute((y.dim() - 1,) + tuple(range(nb)) + (y.dim() - 2, y.dim() - 3))
    return y.reshape((d,) + x.shape[:-2] + (2 * t,))


def from_dof_planes(x_planes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_dof_planes`: ``[d, ..., 2T] -> [..., T, 2d]``."""
    d, t2 = x_planes.shape[0], x_planes.shape[-1]
    t = t2 // 2
    y = x_planes.reshape((d,) + x_planes.shape[1:-1] + (2, t))
    nb = y.dim() - 3
    y = y.permute(tuple(range(1, nb + 1)) + (y.dim() - 1, y.dim() - 2, 0))
    return y.reshape(x_planes.shape[1:-1] + (t, 2 * d))


def _plane_residuals(x_planes, dt, t):
    """Per-factor residuals of ``[..., 2T]`` planes: ``r_t = phi x_t -
    x_{t+1}`` as ``(rp, rv)`` of ``[..., T-1]``, with the positions ``p`` and
    velocities ``v``."""
    p = x_planes[..., :t]
    v = x_planes[..., t:]
    rp = p[..., :-1] + dt * v[..., :-1] - p[..., 1:]
    rv = v[..., :-1] - v[..., 1:]
    return p, v, rp, rv


def _lane_slices(x, n_dof):
    """Shifted flat-lane views for the t-major layout (lane ``t*2d + j`` =
    pos_j(t), ``t*2d + d + j`` = vel_j(t)): at a position lane ``l`` of step
    ``t < T-1``, ``(pos(t), vel(t), pos(t+1), vel(t+1))`` as ``[..., L]``
    slices with ``L = M - 3d``, plus the pos-lane mask."""
    m = x.shape[-1]
    sd = 2 * n_dof
    lng = m - 3 * n_dof
    x0 = x[..., :lng]
    xd = x[..., n_dof : lng + n_dof]
    x1 = x[..., sd : lng + sd]
    x1d = x[..., sd + n_dof : lng + sd + n_dof]
    lanes = torch.arange(lng, device=x.device)
    mask = ((lanes % sd) < n_dof).to(x.dtype)
    return x0, xd, x1, x1d, mask


def stencil_matvec_flat(x, q_i2, k_s2, k_g2, dt):
    """``A x`` for the factor-graph block-tridiagonal ``A`` (start anchor +
    CV-GP chain + goal anchor, per-dof-isotropic 2x2 weights) on flat
    ``[..., T, 2d]`` trajectories: the exact O(T) stencil, with no ``[M, M]``
    product, in the per-lane form the fused kernels compute
    (``prec_u_lane`` of ``csrc/kernel_common.cuh``). With ``r_t = (p_t + dt
    v_t - p_{t+1}, v_t - v_{t+1})`` the residual of the factor between steps
    t and t+1: a position lane gets ``(Q^{-1} r_t)_p - (Q^{-1} r_{t-1})_p``,
    a velocity lane ``dt (Q^{-1} r_t)_p + (Q^{-1} r_t)_v - (Q^{-1}
    r_{t-1})_v`` (terms of a factor that does not exist are 0), plus ``K_s
    (p, v)`` at t = 0 and ``K_g (p, v)`` at t = T-1."""
    d = x.shape[-1] // 2
    pos, vel = x[..., :d], x[..., d:]  # [..., T, d]
    rp = pos[..., :-1, :] + dt * vel[..., :-1, :] - pos[..., 1:, :]
    rv = vel[..., :-1, :] - vel[..., 1:, :]
    a = q_i2[0, 0] * rp + q_i2[0, 1] * rv  # (Q^{-1} r_t)_p
    b = q_i2[1, 0] * rp + q_i2[1, 1] * rv  # (Q^{-1} r_t)_v
    pad = torch.nn.functional.pad
    after, before = (0, 0, 0, 1), (0, 0, 1, 0)  # the factor of step t, of t-1
    yp = pad(a, after) - pad(a, before)
    yv = pad(dt * a + b, after) - pad(b, before)
    p0, v0, pl, vl = pos[..., 0, :], vel[..., 0, :], pos[..., -1, :], vel[..., -1, :]
    yp[..., 0, :] += k_s2[0, 0] * p0 + k_s2[0, 1] * v0
    yv[..., 0, :] += k_s2[1, 0] * p0 + k_s2[1, 1] * v0
    yp[..., -1, :] += k_g2[0, 0] * pl + k_g2[0, 1] * vl
    yv[..., -1, :] += k_g2[1, 0] * pl + k_g2[1, 1] * vl
    return torch.cat([yp, yv], dim=-1)


def prec_u_planes(x_planes, q_i2, k_s2, k_g2, dt):
    """``A x`` for the factor-graph block-tridiagonal ``A`` (start anchor +
    CV-GP chain + goal anchor) per dof on ``[d, ..., 2T]`` planes (positions
    then velocities): per factor ``r_t = phi x_t - x_{t+1}``, ``y_t += phi^T
    Q^{-1} r_t``, ``y_{t+1} -= Q^{-1} r_t``, plus the two anchors. The plane
    twin of :func:`stencil_matvec_flat`, in the per-lane form K5 computes
    (``prec_u_plane`` of ``csrc/kernel_common.cuh``)."""
    t = x_planes.shape[-1] // 2
    p, v, rp, rv = _plane_residuals(x_planes, dt, t)
    a = q_i2[0, 0] * rp + q_i2[0, 1] * rv  # (Q^{-1} r)_p
    b = q_i2[1, 0] * rp + q_i2[1, 1] * rv  # (Q^{-1} r)_v
    pad = torch.nn.functional.pad
    yp = pad(a, (0, 1)) - pad(a, (1, 0))
    yv = pad(dt * a + b, (0, 1)) - pad(b, (1, 0))  # (phi^T Q^{-1} r)_v
    yp[..., 0] += k_s2[0, 0] * p[..., 0] + k_s2[0, 1] * v[..., 0]
    yv[..., 0] += k_s2[1, 0] * p[..., 0] + k_s2[1, 1] * v[..., 0]
    yp[..., -1] += k_g2[0, 0] * p[..., -1] + k_g2[0, 1] * v[..., -1]
    yv[..., -1] += k_g2[1, 0] * p[..., -1] + k_g2[1, 1] * v[..., -1]
    return torch.cat([yp, yv], dim=-1)


@dataclass
class DofFactoredPrior:
    """Shared per-dof sampling factor + precision in plane order.

    ``w_dof [2T, 2T]`` with ``x_d = mu_d + eps_d @ w_dof``; ``prec_dof``
    the per-dof ``Sigma^{-1}``; ``q_i2``/``k_s2``/``k_g2`` the factor-graph
    stencil weights of the same precision (``k_g2`` zeros without goals);
    ``chol`` the per-dof precision's block Cholesky factor ``L`` (time-major,
    2 x 2 blocks; ``w_dof`` is ``L^{-1}`` in plane order), which K5 samples
    with by substitution: required, by keyword (the JAX package's prior has
    no such field, and its positional fields lead).
    """

    w_dof: torch.Tensor
    prec_dof: torch.Tensor
    traj_len: int
    q_i2: torch.Tensor | None = None
    k_s2: torch.Tensor | None = None
    k_g2: torch.Tensor | None = None
    dt: float = 0.0
    chol: BlockBidiagChol = field(kw_only=True)

    def matvec_flat(self, x: torch.Tensor) -> torch.Tensor:
        """``Sigma^{-1} x`` on flat ``[..., T, 2d]`` trajectories by the
        exact O(T) stencil."""
        return stencil_matvec_flat(x, self.q_i2, self.k_s2, self.k_g2, self.dt)

    def sample_planes(self, generator, mu_planes: torch.Tensor, num_samples: int,
                      eps: torch.Tensor | None = None):
        """Draw ``[d, P, S, 2T]`` samples around ``mu_planes [d, P, 2T]``;
        returns ``(samples, corr)`` with ``corr = eps @ w_dof``. ``eps
        [d, P, S, 2T]`` replaces the draw from ``generator``."""
        d, p, t2 = mu_planes.shape
        if eps is None:
            eps = torch.randn((d, p, num_samples, t2), generator=generator,
                              dtype=mu_planes.dtype, device=mu_planes.device)
        corr = (eps.reshape(-1, t2) @ self.w_dof).reshape(eps.shape)
        return mu_planes[:, :, None] + corr, corr

    def matvec_planes(self, x_planes: torch.Tensor) -> torch.Tensor:
        """``Sigma^{-1} x`` per dof on ``[d, ..., 2T]`` planes by the
        factor-graph stencil (:func:`prec_u_planes`)."""
        return prec_u_planes(x_planes, self.q_i2, self.k_s2, self.k_g2, self.dt)


def make_dof_factored_prior(
    traj_len: int,
    dt: float,
    sigma_start: float,
    sigma_gp: float,
    sigma_goal: float | None = None,
    dtype=torch.float32,
    device=None,
) -> DofFactoredPrior:
    """Per-dof ``[2T, 2T]`` sampling factor and precision (plane order),
    built by the same structured block Cholesky as ``make_gp_prior`` at
    ``n_dof=1`` and permuted from t-major to plane order."""
    from stoch_gpmp_tpu_torch.gp.prior import build_precision

    k_s_inv = unary_weight(2, sigma_start, dtype=dtype, device=device)
    q_inv = q_inv_block(1, dt, sigma=sigma_gp, dtype=dtype, device=device)
    k_g_inv = (
        None if sigma_goal is None
        else unary_weight(2, sigma_goal, dtype=dtype, device=device)
    )
    prec1 = build_precision(
        1, traj_len, dt, k_s_inv, q_inv, k_g_inv=k_g_inv, dtype=dtype, device=device
    )
    chol1, w1 = prec1.cholesky_inverse()  # L and [2T, 2T] L^{-1}
    perm = plane_perm(traj_len)
    k_g2 = torch.zeros((2, 2), dtype=dtype, device=device) if k_g_inv is None else k_g_inv
    return DofFactoredPrior(
        w_dof=_perm2(w1, perm),
        prec_dof=_perm2(prec1.to_dense(), perm),
        traj_len=traj_len,
        q_i2=q_inv,
        k_s2=k_s_inv,
        k_g2=k_g2,
        dt=float(dt),
        chol=chol1,
    )


@dataclass
class DofQuadraticCost:
    """``CostGP + CostGoalPrior`` as per-dof plane-order quadratics:
    ``cost(x) = sum_d x_d^T a_dof x_d - 2 b_planes[g, d] . x_d + c[g]``,
    plus the factor-graph stencil parameters the fused kernel reads."""

    a_dof: torch.Tensor  # [2T, 2T]
    b_planes: torch.Tensor  # [G, d, 2T]
    c: torch.Tensor  # [G]
    num_goals: int
    n_dof: int
    traj_len: int
    q_i2: torch.Tensor | None = None  # [2, 2] CV-factor Q^{-1}
    k_s2: torch.Tensor | None = None  # [2, 2] start anchor weight
    k_g2: torch.Tensor | None = None  # [2, 2] goal anchor weight (zeros if none)
    s_pd: torch.Tensor | None = None  # [d, 2] start (pos, vel) per dof
    g_pd: torch.Tensor | None = None  # [G, d, 2] goals (zeros if none)
    dt: float = 0.0

    @classmethod
    def from_gp_and_goal_prior(cls, gp, goal_prior, traj_len: int) -> "DofQuadraticCost":
        """Per-dof analogue of ``QuadraticCost.from_gp_and_goal_prior``."""
        d2 = gp.start_state.shape[-1]
        n_dof = d2 // 2
        dtype = gp.start_state.dtype
        _assert_isotropic(gp.k_start, n_dof, "k_start")
        _assert_isotropic(gp.q_inv, n_dof, "q_inv")
        _assert_isotropic(gp.phi, n_dof, "phi")
        if goal_prior is not None:
            _assert_isotropic(goal_prior.k_goal, n_dof, "k_goal")

        k_s = _dof2_block(gp.k_start, n_dof)
        q_i = _dof2_block(gp.q_inv, n_dof)
        phi = _dof2_block(gp.phi, n_dof)
        k_g = _dof2_block(goal_prior.k_goal, n_dof) if goal_prior is not None else None
        pqp = phi.T @ q_i @ phi
        diag = (q_i + pqp).repeat(traj_len, 1, 1)
        diag[0] = k_s + pqp
        diag[traj_len - 1] = q_i if k_g is None else q_i + k_g
        lower = (-(q_i @ phi)).repeat(traj_len - 1, 1, 1)
        a_dof = _perm2(BlockTridiag(diag=diag, lower=lower).to_dense(), plane_perm(traj_len))

        goals = goal_prior.multi_goal_states if goal_prior is not None else None
        start_state = gp.start_state
        g = goals.shape[0] if goals is not None else 1
        t = traj_len
        b_planes = start_state.new_zeros((g, n_dof, 2 * t))
        # start anchor: linear term K_s s on state 0 -> (pos_0, vel_0)
        s_pd = torch.stack([start_state[:n_dof], start_state[n_dof:]], dim=-1)  # [d, 2]
        bs = s_pd @ k_s.T  # [d, 2]
        b_planes[:, :, 0] = bs[:, 0]
        b_planes[:, :, t] = bs[:, 1]
        c = torch.full((g,), float(torch.sum(s_pd * bs)), dtype=dtype, device=start_state.device)
        if goals is not None:
            g_pd = torch.stack([goals[:, :n_dof], goals[:, n_dof:]], dim=-1)  # [G, d, 2]
            bg = torch.einsum("gdk,jk->gdj", g_pd, k_g)
            b_planes[:, :, t - 1] += bg[..., 0]
            b_planes[:, :, 2 * t - 1] += bg[..., 1]
            c = c + torch.einsum("gdk,gdk->g", g_pd, bg)
        else:
            g_pd = start_state.new_zeros((g, n_dof, 2))
        k_g2 = start_state.new_zeros((2, 2)) if k_g is None else k_g
        return cls(
            a_dof=a_dof, b_planes=b_planes, c=c, num_goals=g,
            n_dof=n_dof, traj_len=traj_len,
            q_i2=q_i, k_s2=k_s, k_g2=k_g2, s_pd=s_pd, g_pd=g_pd,
            dt=float(phi[0, 1]),
        )

    def supports_dof_planes(self) -> bool:
        return True

    def particle_block(self, start: int, count: int, total: int) -> "DofQuadraticCost":
        """The same cost on particles ``start .. start + count`` of a
        goal-major batch of ``total``: ``b_planes``, ``c`` and ``g_pd``
        gathered to one entry per particle, so K3 reads each row's own goal
        (``rows_per_goal`` = the samples per particle)."""
        from stoch_gpmp_tpu_torch.costs.costs import particle_goals

        idx = particle_goals(start, count, total, self.num_goals, self.c.device)
        return replace(self, b_planes=self.b_planes[idx], c=self.c[idx], num_goals=count,
                       g_pd=None if self.g_pd is None else self.g_pd[idx])

    @cached_property
    def stencil_weights(self) -> tuple[float, ...]:
        """``(q11, q12, q22, ks11, ks12, ks22, kg11, kg12, kg22)`` as Python
        floats, read from the device once per object (the kernels take them
        as launch arguments)."""
        w = torch.stack([self.q_i2, self.k_s2, self.k_g2]).detach().double().cpu()
        return tuple(float(w[k][i, j]) for k in range(3) for i, j in ((0, 0), (0, 1), (1, 1)))

    def eval(self, trajs, x_trajs=None, observation=None) -> torch.Tensor:
        """Flat-batch ``eval`` (``[B, T, 2d]`` or ``[B, M]``) through the
        plane layout: the quadratic without a dense ``[M, M]`` matrix."""
        trajs = trajs.reshape(-1, self.traj_len, 2 * self.n_dof)
        return self.eval_dof_planes(to_dof_planes(trajs), observation=observation)

    def eval_dof_planes(self, x_planes: torch.Tensor, observation=None) -> torch.Tensor:
        """``x_planes [d, B, 2T]`` (goal-major batch) -> ``[B]`` costs in
        factor-graph residual form: the quadratic ``x A x - 2 b x + c``
        rewritten as sums of local quadratics, with no cancellation. Kernel
        K3 on a CUDA tensor, its plain version on a CPU tensor; a cost
        without the stencil constants takes :meth:`eval_dof_planes_dense`."""
        if self.q_i2 is None:
            return self.eval_dof_planes_dense(x_planes)
        from stoch_gpmp_tpu_torch.ops.kernels.stencil import dof_quad_eval

        return dof_quad_eval(self, x_planes)

    def eval_dof_planes_dense(self, x_planes: torch.Tensor) -> torch.Tensor:
        """The matmul form ``x A x - 2 b x + c`` of the same quadratic,
        algebraically equal to the stencil form; it cancels two large
        terms, so at the Panda sigmas it loses the digits the stencil keeps."""
        d, b, t2 = x_planes.shape
        xa = (x_planes.reshape(-1, t2) @ self.a_dof).reshape(d, b, t2)
        quad = torch.sum(xa * x_planes, dim=(0, -1))
        xg = x_planes.reshape(d, self.num_goals, -1, t2)
        lin = torch.einsum("dgbk,gdk->gb", xg, self.b_planes).reshape(b)
        cg = torch.repeat_interleave(self.c, b // self.num_goals)
        return quad - 2.0 * lin + cg

    def grad_dof_planes(self, x_planes: torch.Tensor) -> torch.Tensor:
        """``b - A x`` per dof on ``[d, B, 2T]`` planes (goal-major batch),
        half the negative cost gradient, in factor-graph residual form: each
        factor's ``J^T W r`` with the small residual ``r`` formed before the
        large weight touches it."""
        d, bsz, _ = x_planes.shape
        t = self.traj_len
        p, v, rp, rv = _plane_residuals(x_planes, self.dt, t)
        a = self.q_i2[0, 0] * rp + self.q_i2[0, 1] * rv
        b = self.q_i2[1, 0] * rp + self.q_i2[1, 1] * rv
        pad = torch.nn.functional.pad
        yp = pad(a, (0, 1)) - pad(a, (1, 0))
        yv = pad(self.dt * a + b, (0, 1)) - pad(b, (1, 0))
        ks, kg = self.k_s2, self.k_g2
        r0p = p[..., 0] - self.s_pd[:, None, 0]
        r0v = v[..., 0] - self.s_pd[:, None, 1]
        yp[..., 0] += ks[0, 0] * r0p + ks[0, 1] * r0v
        yv[..., 0] += ks[1, 0] * r0p + ks[1, 1] * r0v
        ppg = bsz // self.num_goals
        rgp = p[..., -1].reshape(d, self.num_goals, ppg) - self.g_pd[..., 0].T[:, :, None]
        rgv = v[..., -1].reshape(d, self.num_goals, ppg) - self.g_pd[..., 1].T[:, :, None]
        yp[..., -1] += (kg[0, 0] * rgp + kg[0, 1] * rgv).reshape(d, bsz)
        yv[..., -1] += (kg[1, 0] * rgp + kg[1, 1] * rgv).reshape(d, bsz)
        return -torch.cat([yp, yv], dim=-1)
