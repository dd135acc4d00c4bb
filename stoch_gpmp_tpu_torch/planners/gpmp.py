"""GPMP: deterministic Gauss-Newton trajectory optimization.

PyTorch counterpart of ``stoch_gpmp_tpu/planners/gpmp.py`` (reference
``stoch_gpmp/planner.py:352-661``). Every cost contributes its
normal-equation blocks in block-tridiagonal form (``gn_contrib``), and each
particle's damped system is solved one of three ways:

- ``cholesky``: the O(T d^3) structured block Cholesky and its two
  triangular solves, batched over particles (the JAX ``vmap``; a Python loop
  over the ``T`` blocks of small batched operations);
- ``inverse``: the dense ``[T d, T d]`` system by ``torch.linalg.solve``
  (the reference's dense path);
- ``woodbury``: the parallel-in-time split ``H = H0 + U D U^T``
  (``build_woodbury``, ``gpmp_step_woodbury``): per-dof ``[2T, 2T]``
  products against ``H0^{-1}``, inverted once on the host in float64, and
  one batched Cholesky of the Jacobi-equilibrated ``[P, R, R]``
  capacitance.

Reference semantics kept: damping ``J^T J + delta I``; the trust-region
branch's second-assignment-wins damping by the particle-averaged diagonal;
the update ``means += step_size * d_theta``. ``gpmp_optimize`` is a Python
loop for the JAX ``lax.scan``; the ``GPMP`` class keeps the reference's API
with an explicit ``torch.Generator`` for the JAX key; its
``sample_trajectories`` draws through the dense ``L^{-1}`` or, beyond M =
2048, the parallel-in-time solver. ``mesh=`` is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
from stoch_gpmp_tpu_torch.gp.tridiag import BlockTridiag, cholesky_nan
from stoch_gpmp_tpu_torch.utils.device import resolve_device


@dataclass
class GPMPState:
    """Planner state: particle means and the generator every draw takes."""

    particle_means: torch.Tensor  # [P, T, d]
    generator: torch.Generator


@dataclass
class WoodburyGN:
    """Constant pieces of the Woodbury GN solve.

    The normal matrix splits as ``H = H0 + U D U^T``: ``H0 = A_quad + delta
    I`` is the particle-independent, per-dof-decoupled quadratic part, and
    each field cost adds one rank-1 term per timestep, column ``e_t (x) h``
    with weight ``k`` (``gn_rank1``). Then

        x = H0i g - H0i U (D^{-1} + U^T H0i U)^{-1} U^T H0i g

    with ``H0i`` inverted once in float64 on the host (``H0``'s condition
    number of ~1e8-1e10 makes a float32 inverse meaningless)."""

    h0i: torch.Tensor  # [2T, 2T] per-dof (A_dof + delta I)^{-1}, symmetric
    a_dof: torch.Tensor  # [2T, 2T]
    b_planes: torch.Tensor  # [G, n_dof, 2T]
    dq: Any  # DofQuadraticCost: the stencil-form gradient
    wpp_tiled: torch.Tensor  # [R, R] = tile(h0i[:T, :T], (nf, nf))
    cdiag: torch.Tensor  # [R] capacitance diagonal 1/k_r
    num_goals: int
    n_dof: int
    traj_len: int
    n_fields: int


def build_woodbury(cost: Any, delta: float) -> WoodburyGN | None:
    """Classify a ``CostComposite``'s children and build the Woodbury model;
    None when the stack does not decompose (a non-isotropic quadratic or a
    child without rank-1 GN structure)."""
    from stoch_gpmp_tpu_torch.costs.costs import CostGP, CostGoalPrior
    from stoch_gpmp_tpu_torch.costs.quadratic import QuadraticCost
    from stoch_gpmp_tpu_torch.gp.dof_factored import DofQuadraticCost

    gp = goal_prior = dq = None
    fields = []
    for c in getattr(cost, "costs", ()):
        if isinstance(c, QuadraticCost):
            dq = c.dof_form
            if dq is None:
                return None
        elif isinstance(c, CostGP):
            gp = c
        elif isinstance(c, CostGoalPrior):
            goal_prior = c
        elif hasattr(c, "gn_rank1"):
            fields.append(c)
        else:
            return None
    if dq is None:
        if gp is None:
            return None
        try:
            dq = DofQuadraticCost.from_gp_and_goal_prior(gp, goal_prior, cost.traj_len)
        except ValueError:
            return None
    t = cost.traj_len
    dtype, device = dq.a_dof.dtype, dq.a_dof.device
    h0 = dq.a_dof.detach().cpu().double().numpy() + delta * np.eye(2 * t)
    h0i = np.linalg.inv(h0)
    h0i = 0.5 * (h0i + h0i.T)
    nf = len(fields)
    wpp_tiled = np.tile(h0i[:t, :t], (max(nf, 1), max(nf, 1)))
    cdiag = np.concatenate([
        np.full(t, c.sigma_coll**2 if hasattr(c, "sigma_coll") else c.sigma_goal**2)
        for c in fields
    ]) if nf else np.zeros(0)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return WoodburyGN(
        h0i=as_t(h0i), a_dof=dq.a_dof, b_planes=dq.b_planes, dq=dq,
        wpp_tiled=as_t(wpp_tiled), cdiag=as_t(cdiag), num_goals=dq.num_goals,
        n_dof=dq.n_dof, traj_len=t, n_fields=nf,
    )


def gpmp_step_woodbury(wb: WoodburyGN, cost: Any, state: GPMPState, observation: dict, *,
                       step_size: float = 1.0) -> GPMPState:
    """One GN update through the Woodbury split, with no sequential-over-T
    factorization; equal to ``gpmp_step(method='cholesky')`` up to
    rounding."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import from_dof_planes, to_dof_planes

    means = state.particle_means
    p, t, _ = means.shape
    nd, t2 = wb.n_dof, 2 * t
    fk_trajs = cost._fk_trajs if cost.fk is not None else None
    field_costs = [c for c in cost.costs if hasattr(c, "gn_rank1")]

    mu_planes = to_dof_planes(means)  # [nd, P, 2T]
    if wb.dq.q_i2 is not None:
        g_planes = wb.dq.grad_dof_planes(mu_planes)  # b - A mu, residual form
    else:  # a converted dof form without the stencil constants
        bg = torch.repeat_interleave(wb.b_planes, p // wb.num_goals, dim=0).transpose(0, 1)
        g_planes = bg - (mu_planes.reshape(-1, t2) @ wb.a_dof).reshape(nd, p, t2)

    if wb.n_fields:
        hs, gs_pos = [], None
        for c in field_costs:  # the field Jacobians differentiate through FK themselves
            h, e, k = c.gn_rank1(means, observation=observation, fk_trajs=fk_trajs)
            hs.append(h)  # [P, T, nd]
            term = k * h * e[..., None]
            gs_pos = term if gs_pos is None else gs_pos + term
        g_planes = g_planes.clone()
        g_planes[..., :t] += gs_pos.permute(2, 0, 1)
        h_all = torch.cat(hs, dim=1)  # [P, R, nd], R = nf * T

    y0 = (g_planes.reshape(-1, t2) @ wb.h0i).reshape(nd, p, t2)
    if not wb.n_fields:
        return replace(state, particle_means=means + step_size * from_dof_planes(y0))

    nf = wb.n_fields
    gram = torch.einsum("pri,psi->prs", h_all, h_all)
    c_mat = gram * wb.wpp_tiled + torch.diag(wb.cdiag)
    rhs = torch.einsum("pri,ipr->pr", h_all, y0[..., :t].repeat(1, 1, nf))
    # Jacobi-equilibrate the capacitance before factoring: rows where the
    # field gradient vanishes sit at the bare 1/k floor while active rows
    # reach ~1e4 (the JAX package measured an indefinite factor without it)
    s = torch.rsqrt(torch.diagonal(c_mat, dim1=-2, dim2=-1))  # [P, R]
    chol = cholesky_nan(c_mat * s[:, :, None] * s[:, None, :])
    z = torch.linalg.solve_triangular(chol, (rhs * s)[..., None], upper=False)
    z = torch.linalg.solve_triangular(chol.mT, z, upper=True)[..., 0] * s
    uz_pos = torch.einsum("pft,pfti->ipt", z.reshape(p, nf, t), h_all.reshape(p, nf, t, nd))
    uz = torch.zeros_like(y0)
    uz[..., :t] = uz_pos
    x = y0 - (uz.reshape(-1, t2) @ wb.h0i).reshape(nd, p, t2)
    return replace(state, particle_means=means + step_size * from_dof_planes(x))


def gpmp_step(cost: Any, state: GPMPState, observation: dict, *, delta: float,
              trust_region: bool, method: str = "cholesky",
              step_size: float = 1.0) -> GPMPState:
    """One Gauss-Newton update of all particle means."""
    means = state.particle_means
    p, t, d = means.shape
    contrib = cost.gn_contrib(means, observation=observation)
    diag, lower, g = contrib.diag, contrib.lower, contrib.g  # [P,T,d,d], [P,T-1,d,d], [P,T,d]
    eye = torch.eye(d, dtype=means.dtype, device=means.device)
    if not trust_region:
        diag = diag + delta * eye
    else:  # reference planner.py:612-615: the second assignment wins
        mean_diag = torch.diagonal(diag.mean(dim=0), dim1=-2, dim2=-1)  # [T, d]
        diag = diag + delta * mean_diag[..., None] * eye
    system = BlockTridiag(diag=diag, lower=lower)
    if method == "cholesky":
        d_theta = system.cholesky().solve(g)
    elif method == "inverse":  # dense fallback (reference planner.py:624-625)
        d_theta = torch.linalg.solve(system.to_dense(), g.reshape(p, -1, 1)).reshape(p, t, d)
    else:
        raise ValueError(f"unknown solve method: {method}")
    return replace(state, particle_means=means + step_size * d_theta)


def gpmp_optimize(cost: Any, state: GPMPState, observation: dict, *, opt_iters: int,
                  delta: float, trust_region: bool, method: str = "cholesky",
                  step_size: float = 1.0, woodbury: WoodburyGN | None = None) -> GPMPState:
    """``opt_iters`` Gauss-Newton updates. ``method='woodbury'`` needs
    ``woodbury=build_woodbury(cost, delta)`` and ``trust_region=False``."""
    if method == "woodbury":
        if woodbury is None:
            raise ValueError("method='woodbury' needs woodbury=build_woodbury(cost, delta)")
        if trust_region:
            raise ValueError("woodbury path supports trust_region=False only (the "
                             "trust-region damping re-dampens H0 per iteration)")
        for _ in range(opt_iters):
            state = gpmp_step_woodbury(woodbury, cost, state, observation, step_size=step_size)
        return state
    for _ in range(opt_iters):
        state = gpmp_step(cost, state, observation, delta=delta, trust_region=trust_region,
                          method=method, step_size=step_size)
    return state


class GPMP:
    """Stateful wrapper with the reference's API surface (``reset``,
    ``optimize``, ``get_recent_samples``, ``sample_trajectories``).

    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` for the plain PyTorch versions on the CPU."""

    def __init__(
        self,
        num_particles_per_goal,
        traj_len,
        opt_iters,
        dt=None,
        n_dof=None,
        step_size=1.0,
        temperature=1.0,
        start_state=None,
        multi_goal_states=None,
        initial_particle_means=None,
        cost=None,
        sigma_start_init=None,
        sigma_start_sample=None,
        sigma_goal_init=None,
        sigma_goal_sample=None,
        sigma_gp_init=None,
        sigma_gp_sample=None,
        solver_params=None,
        seed: int = 0,
        dtype=torch.float32,
        mesh=None,
        device=None,
        **kwargs,
    ):
        if mesh is not None:
            raise NotImplementedError("mesh= is not ported yet (multi-device slice)")
        self.device = resolve_device(device)
        self.n_dof = n_dof
        self.d_state_opt = 2 * n_dof
        self.dt = dt
        self.traj_len = traj_len
        self.goal_directed = multi_goal_states is not None
        self.num_goals = len(multi_goal_states) if self.goal_directed else 1
        self.num_particles_per_goal = num_particles_per_goal
        self.num_particles = num_particles_per_goal * self.num_goals
        self.opt_iters = opt_iters
        self.step_size = step_size
        self.temperature = temperature
        self.sigma_start_init = sigma_start_init
        self.sigma_start_sample = sigma_start_sample
        self.sigma_goal_init = sigma_goal_init
        self.sigma_goal_sample = sigma_goal_sample
        self.sigma_gp_init = sigma_gp_init
        self.sigma_gp_sample = sigma_gp_sample
        self.solver_params = dict(solver_params or {})
        self.solver_params.setdefault("delta", 0.0)
        self.solver_params.setdefault("trust_region", False)
        self.solver_params.setdefault("method", "cholesky")
        self.cost = cost
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.reset(start_state, multi_goal_states, initial_particle_means)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def reset(self, start_state=None, multi_goal_states=None, initial_particle_means=None):
        if start_state is not None:
            self.start_state = self._tensor(start_state)
        if multi_goal_states is not None:
            self.multi_goal_states = self._tensor(multi_goal_states)
        elif not self.goal_directed:
            self.multi_goal_states = None
        goals = self.multi_goal_states if self.goal_directed else None
        prior = lambda s_start, s_gp, s_goal: make_gp_prior(  # noqa: E731
            self.n_dof, self.traj_len, self.dt, self.start_state, s_start, s_gp,
            sigma_goal=s_goal if self.goal_directed else None, goal_states=goals,
            dtype=self.dtype, device=self.device)

        if initial_particle_means is not None:
            means = self._tensor(initial_particle_means)
        else:
            means = prior(self.sigma_start_init, self.sigma_gp_init,
                          self.sigma_goal_init).sample(self.generator, self.num_particles_per_goal)
        particle_means = means.reshape(self.num_particles, self.traj_len, self.d_state_opt)
        self.state = GPMPState(particle_means=particle_means, generator=self.generator)
        # the sampling prior of sample_trajectories
        self._sample_prior = prior(
            self.sigma_start_sample, self.sigma_gp_sample, self.sigma_goal_sample)
        self._wb = None
        if self.solver_params["method"] == "woodbury":
            self._wb = build_woodbury(self.cost, float(self.solver_params["delta"]))
            if self._wb is None:
                raise ValueError("cost stack does not decompose for method='woodbury' "
                                 "(need isotropic quadratics + rank-1 field costs)")

    @property
    def particle_means(self) -> torch.Tensor:
        return self.state.particle_means

    def optimize(self, opt_iters=None, debug=False, observation=None, **obs_kwargs):
        """Returns ``(velocity_means, position_means, costs)`` as the
        reference does; the costs are ``cost.eval`` at the final means."""
        observation = dict(observation or {})
        observation.update(obs_kwargs)
        iters = self.opt_iters if opt_iters is None else opt_iters
        self.state = gpmp_optimize(
            self.cost, self.state, observation, opt_iters=iters,
            delta=float(self.solver_params["delta"]),
            trust_region=bool(self.solver_params["trust_region"]),
            method=self.solver_params["method"], step_size=self.step_size, woodbury=self._wb,
        )
        means = self.state.particle_means
        costs = self.cost.eval(means.reshape(self.num_particles, -1), observation=observation)
        n = self.n_dof
        return means[..., n:], means[..., :n], costs

    def get_recent_samples(self):
        n = self.n_dof
        means = self.state.particle_means
        return means[..., :n], means[..., n:]

    def sample_trajectories(self, num_samples_per_particle: int):
        """Fresh draws around the current means: (positions, velocities);
        through the dense ``L^{-1}``, or beyond M = 2048 the
        parallel-in-time solver (S1 on the card)."""
        from stoch_gpmp_tpu_torch.planners.stoch_gpmp import sample_around

        samples = sample_around(self._sample_prior, self.state.particle_means,
                                num_samples_per_particle, self.generator)
        n = self.n_dof
        return samples[..., :n], samples[..., n:]
