"""Fused dense quadratic cost ``x^T A x - 2 b^T x + c``.

PyTorch counterpart of ``stoch_gpmp_tpu/costs/quadratic.py``: ``CostGP`` +
``CostGoalPrior`` as one quadratic in the flattened trajectory with a
shared ``A`` and per-goal ``(b, c)``. ``eval`` uses the one-matmul form
at mild weights and the exact factor-graph residual (stencil) form when
``stencil_required`` (any weight above ``needs_stencil``'s threshold). The
block-tridiagonal blocks of ``A`` are kept beside the dense matrix for the
Gauss-Newton contribution (``gn_contrib``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from stoch_gpmp_tpu_torch.costs.costs import (
    Cost,
    CostGP,
    CostGoalPrior,
    GNContrib,
    particle_goals,
)
from stoch_gpmp_tpu_torch.gp.tridiag import BlockTridiag
from stoch_gpmp_tpu_torch.utils.profiling import annotate


@dataclass
class QuadraticCost(Cost):
    a_dense: torch.Tensor  # [M, M]
    a_diag: torch.Tensor  # [T, d, d] block-tridiagonal form of A
    a_lower: torch.Tensor  # [T-1, d, d]
    b: torch.Tensor  # [G, M]
    c: torch.Tensor  # [G]
    num_goals: int
    traj_len: int
    state_dim: int
    dof_form: object | None = None  # DofQuadraticCost under scalar sigmas
    # decided at construction from the concrete weights (needs_stencil)
    stencil_required: bool = True

    @classmethod
    @annotate("costs.quadratic")
    def from_gp_and_goal_prior(
        cls, gp: CostGP, goal_prior: CostGoalPrior | None, traj_len: int
    ) -> "QuadraticCost":
        """Fuse a ``CostGP`` and optionally a ``CostGoalPrior`` into one
        dense quadratic."""
        d = gp.start_state.shape[-1]
        dtype = gp.start_state.dtype
        k_g = goal_prior.k_goal if goal_prior is not None else None
        pqp = gp.phi.T @ gp.q_inv @ gp.phi
        diag = (gp.q_inv + pqp).repeat(traj_len, 1, 1)
        diag[0] = gp.k_start + pqp
        diag[traj_len - 1] = gp.q_inv if k_g is None else gp.q_inv + k_g
        lower = (-(gp.q_inv @ gp.phi)).repeat(traj_len - 1, 1, 1)
        a_dense = BlockTridiag(diag=diag, lower=lower).to_dense()

        m = traj_len * d
        g = goal_prior.multi_goal_states.shape[0] if goal_prior is not None else 1
        b = gp.start_state.new_zeros((g, m))
        # start anchor: e0 = s - x0 -> linear term K_s s in block 0
        b[:, :d] = gp.k_start @ gp.start_state
        c = torch.full(
            (g,), float(gp.start_state @ gp.k_start @ gp.start_state),
            dtype=dtype, device=gp.start_state.device,
        )
        if goal_prior is not None:
            goals = goal_prior.multi_goal_states  # [G, d]
            b[:, -d:] += torch.einsum("ij,gj->gi", k_g, goals)
            c = c + torch.einsum("gi,ij,gj->g", goals, k_g, goals)

        from stoch_gpmp_tpu_torch.gp.dof_factored import DofQuadraticCost
        from stoch_gpmp_tpu_torch.ops.kernels.stencil import needs_stencil

        try:
            dof_form = DofQuadraticCost.from_gp_and_goal_prior(gp, goal_prior, traj_len)
        except ValueError:  # non-isotropic weights: dense form only
            dof_form = None
        return cls(
            a_dense=a_dense, a_diag=diag, a_lower=lower, b=b, c=c,
            num_goals=g, traj_len=traj_len, state_dim=d, dof_form=dof_form,
            stencil_required=dof_form is None or needs_stencil(dof_form),
        )

    def supports_dof_planes(self) -> bool:
        return self.dof_form is not None

    def particle_block(self, start: int, count: int, total: int) -> "QuadraticCost":
        """The same cost on particles ``start .. start + count`` of a
        goal-major batch of ``total``: ``b`` and ``c`` (and the dof form's
        goal tables) gathered to one entry per particle
        (``CostGoalPrior.particle_block``)."""
        idx = particle_goals(start, count, total, self.num_goals, self.b.device)
        dof = None if self.dof_form is None else self.dof_form.particle_block(start, count, total)
        return replace(self, b=self.b[idx], c=self.c[idx], num_goals=count, dof_form=dof)

    def eval_dof_planes(self, x_planes, observation=None):
        """``x_planes [d, B, 2T]`` -> ``[B]`` through the dof form (kernel K3
        on the card)."""
        return self.dof_form.eval_dof_planes(x_planes, observation=observation)

    def eval(self, trajs, x_trajs=None, observation=None):
        batch = trajs.shape[0]
        if self.dof_form is not None and self.stencil_required:
            return self._eval_stencil(trajs)
        x = trajs.reshape(batch, -1)  # [B, M]
        quad = torch.sum((x @ self.a_dense) * x, dim=-1)
        xg = x.reshape(self.num_goals, -1, x.shape[-1])
        lin = torch.einsum("gbm,gm->gb", xg, self.b).reshape(batch)
        cg = torch.repeat_interleave(self.c, batch // self.num_goals)
        return quad - 2.0 * lin + cg

    def _eval_stencil(self, trajs):
        """Factor-graph residual form of the same quadratic on flat-lane
        slices of the t-major ``[B, M]`` row: algebraically identical to
        ``x A x - 2 b x + c`` without the massive cancellation."""
        from stoch_gpmp_tpu_torch.gp.dof_factored import _lane_slices

        df = self.dof_form
        batch = trajs.shape[0]
        d = self.state_dim // 2
        sd = self.state_dim
        m = self.traj_len * sd
        x = trajs.reshape(batch, m)
        x0, xd, x1, x1d, mask = _lane_slices(x, d)
        q11, q12, q22 = df.q_i2[0, 0], df.q_i2[0, 1], df.q_i2[1, 1]
        rp = (x0 + df.dt * xd - x1) * mask
        rv = (xd - x1d) * mask
        e = torch.sum(q11 * rp * rp + 2.0 * q12 * rp * rv + q22 * rv * rv, dim=-1)
        ks11, ks12, ks22 = df.k_s2[0, 0], df.k_s2[0, 1], df.k_s2[1, 1]
        r0p = x[:, :d] - df.s_pd[None, :, 0]
        r0v = x[:, d:sd] - df.s_pd[None, :, 1]
        e = e + torch.sum(
            ks11 * r0p * r0p + 2.0 * ks12 * r0p * r0v + ks22 * r0v * r0v, dim=-1
        )
        kg11, kg12, kg22 = df.k_g2[0, 0], df.k_g2[0, 1], df.k_g2[1, 1]
        ppg = batch // self.num_goals
        rgp = x[:, m - sd : m - d].reshape(self.num_goals, ppg, d) - df.g_pd[:, None, :, 0]
        rgv = x[:, m - d :].reshape(self.num_goals, ppg, d) - df.g_pd[:, None, :, 1]
        return e + torch.sum(
            kg11 * rgp * rgp + 2.0 * kg12 * rgp * rgv + kg22 * rgv * rgv, dim=-1
        ).reshape(batch)

    def gn_contrib(self, trajs, x_trajs=None, observation=None):
        """The constant blocks of ``A`` and ``g = b - A x``, with ``A x`` by
        the exact O(T) factor-graph stencil when the dof form exists (the
        dense ``[M, M]`` product cancels at the reference's sigmas)."""
        batch = trajs.shape[0]
        t, d = self.traj_len, self.state_dim
        trajs = trajs.reshape(batch, t, d)
        df = self.dof_form
        if df is not None and df.q_i2 is not None:
            from stoch_gpmp_tpu_torch.gp.dof_factored import stencil_matvec_flat

            ax = stencil_matvec_flat(trajs, df.q_i2, df.k_s2, df.k_g2, df.dt).reshape(batch, -1)
        else:
            ax = trajs.reshape(batch, -1) @ self.a_dense
        bg = torch.repeat_interleave(self.b, batch // self.num_goals, dim=0)
        return GNContrib(
            diag=self.a_diag.expand(batch, t, d, d),
            lower=self.a_lower.expand(batch, t - 1, d, d),
            g=(bg - ax).reshape(batch, t, d),
        )
