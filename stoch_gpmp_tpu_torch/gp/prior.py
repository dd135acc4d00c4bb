"""Multi-modal constant-velocity GP trajectory prior in structured form.

PyTorch counterpart of ``stoch_gpmp_tpu/gp/prior.py``: the precision
``Sigma^{-1}`` is built directly in block-tridiagonal form and factored once
by the structured block Cholesky (kernel C1 on the card). Up to ``M = 2048``
sampling is ``x = mu + eps @ L^{-1}`` with ``L^{-1}`` materialized once, by
the factor's launch (one matmul per draw batch); beyond, the prior holds the
parallel-in-time solver (``ParallelBidiagSolver``, kernel S1 on the card)
and sampling is ``x = mu + L^{-T} eps``. All modes share the precision;
means differ per mode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from stoch_gpmp_tpu_torch.gp.lift import phi_matrix, q_inv_block, unary_weight
from stoch_gpmp_tpu_torch.gp.tridiag import BlockBidiagChol, BlockTridiag, ParallelBidiagSolver
from stoch_gpmp_tpu_torch.utils.profiling import annotate


def build_precision(
    dof: int,
    traj_len: int,
    dt: float,
    k_s_inv: torch.Tensor,
    q_inv: torch.Tensor,
    k_g_inv: torch.Tensor | None = None,
    dtype=torch.float32,
    device=None,
) -> BlockTridiag:
    """Block-tridiagonal ``Sigma^{-1}`` of the lifted constant-velocity system:
    ``diag[0] = K_s + Phi^T Q^{-1} Phi``, ``diag[t] = Q^{-1} + Phi^T Q^{-1} Phi``,
    ``diag[T-1] = Q^{-1} (+ K_g)``, ``lower[t] = -Q^{-1} Phi``."""
    phi = phi_matrix(dof, dt, dtype=dtype, device=device)
    q_inv = torch.as_tensor(q_inv, dtype=dtype, device=device)
    k_s_inv = torch.as_tensor(k_s_inv, dtype=dtype, device=device)
    pqp = phi.T @ q_inv @ phi
    diag = (q_inv + pqp).repeat(traj_len, 1, 1)
    diag[0] = k_s_inv + pqp
    diag[traj_len - 1] = (
        q_inv if k_g_inv is None
        else q_inv + torch.as_tensor(k_g_inv, dtype=dtype, device=device)
    )
    lower = (-(q_inv @ phi)).repeat(traj_len - 1, 1, 1)
    return BlockTridiag(diag=diag, lower=lower)


def const_vel_trajectory(start_state, goal_state, num_steps: int, dt: float, dof: int):
    """Straight-line positions over ``num_steps + 1`` states with constant
    velocity ``(goal - start) / (num_steps * dt)``: ``[num_steps+1, 2*dof]``."""
    alpha = torch.linspace(
        0.0, 1.0, num_steps + 1, dtype=start_state.dtype, device=start_state.device
    )[:, None]
    pos = start_state[:dof][None] * (1.0 - alpha) + goal_state[:dof][None] * alpha
    vel = ((goal_state[:dof] - start_state[:dof])[None] / (num_steps * dt)).repeat(
        num_steps + 1, 1
    )
    return torch.cat([pos, vel], dim=-1)


def const_vel_means(start_state, goal_states, num_steps: int, dt: float, dof: int):
    """Per-mode straight-line means ``[num_modes, num_steps+1, 2*dof]``;
    the goal-free case repeats the start state."""
    if goal_states is None:
        return start_state[None, None, :].repeat(1, num_steps + 1, 1)
    return torch.stack([
        const_vel_trajectory(start_state, g, num_steps, dt, dof) for g in goal_states
    ])


@dataclass
class GPPrior:
    """Gaussians over trajectories with a shared structured precision.

    ``means [num_modes, T, d]``; ``precision`` shared by all modes; ``chol``
    its block Cholesky; ``weight_t`` the dense ``L^{-1}`` (``[M, M]``) of the
    one-matmul sampler, or None in long-horizon mode, where ``psolver`` (the
    parallel-in-time solver) takes its place; ``dof`` the per-dof factored
    form, built while its ``[2T, 2T]`` factor is small enough."""

    means: torch.Tensor
    precision: BlockTridiag
    chol: BlockBidiagChol
    weight_t: torch.Tensor | None
    psolver: ParallelBidiagSolver | None = None
    dof: object | None = None

    @property
    def num_modes(self) -> int:
        return self.means.shape[0]

    @property
    def traj_len(self) -> int:
        return self.means.shape[-2]

    @property
    def state_dim(self) -> int:
        return self.means.shape[-1]

    def set_means(self, means: torch.Tensor) -> "GPPrior":
        """The same prior around ``means`` (reshaped to this prior's)."""
        return replace(self, means=means.reshape(self.means.shape))

    def set_sigma_inv(self, precision: BlockTridiag) -> "GPPrior":
        """Swap the sampling precision and rebuild the Cholesky and the form
        this prior samples with: the dense ``L^{-1}`` or the
        parallel-in-time solver. The per-dof factored form cannot be rebuilt
        from an arbitrary precision, so it is dropped."""
        if self.weight_t is not None:
            chol, weight_t = precision.cholesky_inverse()
            return replace(self, precision=precision, chol=chol, weight_t=weight_t,
                           psolver=None, dof=None)
        chol = precision.cholesky()
        return replace(self, precision=precision, chol=chol, weight_t=None,
                       psolver=ParallelBidiagSolver.from_chol(chol), dof=None)

    def sample(self, generator: torch.Generator | None, num_samples: int,
               method: str = "auto", eps: torch.Tensor | None = None) -> torch.Tensor:
        """Draw ``[num_modes, num_samples, T, d]`` samples.

        ``method``: see :func:`sample_correction`. ``eps [num_modes,
        num_samples, T, d]`` replaces the draw from ``generator``."""
        t, d = self.traj_len, self.state_dim
        if eps is None:
            eps = torch.randn((self.num_modes, num_samples, t, d), generator=generator,
                              dtype=self.means.dtype, device=self.means.device)
        return self.means[:, None] + sample_correction(self, eps, method)

    def precision_matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Apply ``Sigma^{-1}`` to ``x [..., T, d]`` in O(T d^2)."""
        return self.precision.matvec(x)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Gaussian log-density of ``x [..., num_modes, T, d]`` under each mode."""
        m = self.traj_len * self.state_dim
        diff = x - self.means
        quad = torch.sum(diff * self.precision.matvec(diff), dim=(-2, -1))
        return 0.5 * (self.chol.logdet() - m * math.log(2.0 * math.pi) - quad)


def sample_correction(model, eps: torch.Tensor, method: str = "auto") -> torch.Tensor:
    """The correction ``L^{-T} eps`` that turns standard normal draws ``eps
    [B, S, T, d]`` into draws around zero under the precision ``L L^T`` of
    ``model`` (a ``GPPrior`` or a planner's ``SamplerModel``: anything with
    ``weight_t``, ``psolver`` and ``chol``). ``method``: ``"dense"`` (one
    matmul against the dense ``L^{-1}``), ``"scan"`` (the sequential
    structured backward substitution of ``chol``), ``"pscan"`` (the
    parallel-in-time solver, S1 on the card, built from ``chol`` when the
    model has none) or ``"auto"``: dense when the model has the dense
    factor, else pscan when it has the solver, else scan."""
    b, s, t, d = eps.shape
    if method == "auto":
        if model.weight_t is not None:
            method = "dense"
        else:
            method = "pscan" if model.psolver is not None else "scan"
    if method == "dense":
        if model.weight_t is None:
            raise ValueError("dense sampling requires materialize_dense=True")
        return (eps.reshape(b, s, t * d) @ model.weight_t).reshape(b, s, t, d)
    if method == "scan":
        return model.chol.solve_LT(eps)
    if method == "pscan":
        solver = model.psolver or ParallelBidiagSolver.from_chol(model.chol)
        return solver.solve_LT(eps)
    raise ValueError(f"unknown sampling method: {method}")


@annotate("gp.prior")
def make_gp_prior(
    dof: int,
    traj_len: int,
    dt: float,
    start_state,
    sigma_start: float,
    sigma_gp: float,
    sigma_goal: float | None = None,
    goal_states=None,
    means=None,
    dtype=torch.float32,
    materialize_dense: bool | None = None,
    device=None,
) -> GPPrior:
    """Build a ready-to-sample GP prior from sigma hyper-parameters: unary
    start/goal weights ``I/sigma^2`` and the closed-form CV-GP ``Q^{-1}``
    assembled into the structured precision, its block Cholesky, the
    sampler, the per-dof factor (when ``2T <= 2048``), and straight-line
    constant-velocity means when none are given.

    ``materialize_dense``: the dense ``[M, M]`` ``L^{-1}`` (one-matmul
    sampling) or the parallel-in-time solver; None means dense exactly when
    ``M <= 2048``."""
    d = 2 * dof
    m = d * traj_len
    if materialize_dense is None:
        materialize_dense = m <= 2048
    k_s_inv = unary_weight(d, sigma_start, dtype=dtype, device=device)
    q_inv = q_inv_block(dof, dt, sigma=sigma_gp, dtype=dtype, device=device)
    k_g_inv = None
    if goal_states is not None:
        if sigma_goal is None:
            raise ValueError("sigma_goal required when goal_states given")
        k_g_inv = unary_weight(d, sigma_goal, dtype=dtype, device=device)

    precision = build_precision(
        dof, traj_len, dt, k_s_inv, q_inv, k_g_inv=k_g_inv, dtype=dtype, device=device
    )
    weight_t = psolver = None
    if materialize_dense:
        chol, weight_t = precision.cholesky_inverse()  # weight_t [M, M] = L^{-1}
    else:
        chol = precision.cholesky()
        psolver = ParallelBidiagSolver.from_chol(chol)

    dof_factor = None
    if 2 * traj_len <= 2048:
        from stoch_gpmp_tpu_torch.gp.dof_factored import make_dof_factored_prior

        dof_factor = make_dof_factored_prior(
            traj_len, dt, sigma_start, sigma_gp,
            sigma_goal=sigma_goal if goal_states is not None else None,
            dtype=dtype, device=device,
        )

    if means is None:
        means = const_vel_means(
            torch.as_tensor(start_state, dtype=dtype, device=device),
            None if goal_states is None
            else torch.as_tensor(goal_states, dtype=dtype, device=device),
            traj_len - 1, dt, dof,
        )
    else:
        means = torch.as_tensor(means, dtype=dtype, device=device).reshape(-1, traj_len, d)
    return GPPrior(
        means=means, precision=precision, chol=chol, weight_t=weight_t, psolver=psolver,
        dof=dof_factor,
    )
