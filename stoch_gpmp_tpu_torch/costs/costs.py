"""Composable trajectory cost stack.

PyTorch counterpart of ``stoch_gpmp_tpu/costs/costs.py`` (reference
``stoch_gpmp/costs/cost_functions.py``). Conventions match:

- ``trajs``: ``[batch, traj_len, 2*n_dof]`` (positions then velocities);
- ``x_trajs``: optional FK link poses of every timestep, homogeneous
  ``[batch, traj_len, L, 4, 4]`` or a compact ``LinkState``, computed once
  by a ``CostComposite`` with ``fk`` and passed to every child;
- ``observation``: dict of runtime data;
- collision costs skip timestep 0; field goal costs read only the final
  timestep; the goal prior anchors the final state of a goal-major batch.

``eval_dof_planes`` evaluates on the dof-leading plane batch ``[d, B, 2T]``
of the dof path, ``eval_planes`` on the per-dim time planes (tuple_d of
``[..., T]``) of the long-horizon plane path, where ``supports_planes``
says a cost has it. ``gn_contrib`` gives each cost's Gauss-Newton
normal-equation contribution in block-tridiagonal form (``GNContrib``) and
``gn_rank1`` the rank-1 form of a field cost, for ``planners/gpmp.py``. A
field's Jacobian is ``torch.autograd.grad`` of its summed errors with
respect to the trajectories (the JAX package's ``jax.grad``), through FK
when the composite has one. The 2D fields are piecewise constant and give a
zero Jacobian, as in JAX (their kernel wrappers carry a zero backward,
``ops/kernels/fields.py``); a field with no backward at all raises.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Sequence

import torch

from stoch_gpmp_tpu_torch.costs.factors import gp_error, quadratic_cost, unary_error
from stoch_gpmp_tpu_torch.gp.lift import phi_matrix, q_inv_block, unary_weight
from stoch_gpmp_tpu_torch.gp.tridiag import stack_planes


@dataclass
class GNContrib:
    """One cost's contribution to the Gauss-Newton normal equations in
    block form: ``J^T K J ~ (diag, lower)`` and ``g = A^T K b`` (the
    reference's ``A = -dE/dx`` sign). ``diag [..., T, d, d]`` or None,
    ``lower [..., T-1, d, d]`` or None, ``g [..., T, d]``."""

    diag: torch.Tensor | None
    lower: torch.Tensor | None
    g: torch.Tensor


def _field_jacobian(err_fn, trajs, fk_trajs):
    """``(errors, -d sum(errors) / d trajs)`` of a field cost: one forward
    on a copy of ``trajs`` that requires grad, FK included when
    ``fk_trajs`` is given, then ``torch.autograd.grad``."""
    tr = trajs.detach().requires_grad_(True)
    with torch.enable_grad():
        err = err_fn(tr, fk_trajs(tr) if fk_trajs is not None else None)
        (grad,) = torch.autograd.grad(err.sum(), tr)
    return err.detach(), -grad


def particle_goals(start: int, count: int, total: int, num_goals: int, device) -> torch.Tensor:
    """The goal of each particle ``start .. start + count`` of a goal-major
    batch of ``total`` particles over ``num_goals`` goals."""
    if total % num_goals or not 0 <= start <= start + count <= total:
        raise ValueError(f"particles {start}..{start + count} of {total} in {num_goals} "
                         "goal groups")
    return torch.arange(start, start + count, device=device) // (total // num_goals)


class Cost:
    """Protocol-ish base of the cost classes."""

    def __call__(self, trajs, **kwargs):
        return self.eval(trajs, **kwargs)

    def eval(self, trajs, x_trajs=None, observation=None):  # pragma: no cover
        raise NotImplementedError

    def gn_contrib(self, trajs, x_trajs=None, observation=None):
        raise NotImplementedError

    def supports_dof_planes(self) -> bool:
        return False


@dataclass
class CostGP(Cost):
    """Start anchor + GP smoothness:
    ``e_0^T K_s e_0 + sum_t e_t^T Q^{-1} e_t``."""

    start_state: torch.Tensor  # [d]
    k_start: torch.Tensor  # [d, d]
    q_inv: torch.Tensor  # [d, d]
    phi: torch.Tensor  # [d, d]

    @classmethod
    def create(cls, n_dof, traj_len, start_state, dt, sigma_params,
               dtype=torch.float32, device=None):
        del traj_len  # shape-free; kept for reference API parity
        d = 2 * n_dof
        return cls(
            start_state=torch.as_tensor(start_state, dtype=dtype, device=device),
            k_start=unary_weight(d, sigma_params["sigma_start"], dtype=dtype, device=device),
            q_inv=q_inv_block(n_dof, dt, sigma=sigma_params["sigma_gp"], dtype=dtype,
                              device=device),
            phi=phi_matrix(n_dof, dt, dtype=dtype, device=device),
        )

    def eval(self, trajs, x_trajs=None, observation=None):
        err0 = unary_error(trajs[..., 0, :], self.start_state)
        err = gp_error(trajs, self.phi)
        return quadratic_cost(err0, self.k_start) + torch.sum(
            quadratic_cost(err, self.q_inv), dim=-1
        )

    def supports_planes(self) -> bool:
        return True

    def eval_planes(self, planes, observation=None):
        """``eval`` on per-dim time planes (tuple_d of ``[..., T]``), read
        as one ``[d, ..., T]`` tensor (a view where they share a storage):
        each ``[d, d]`` weight applies as one matrix product over the planes,
        and the quadratic forms are elementwise products summed over d (the
        three-operand ``einsum`` of ``quadratic_cost`` runs as a batched
        GEMV on the card)."""
        x = stack_planes(planes)
        err0 = self.start_state.reshape((-1,) + (1,) * (x.dim() - 2)) - x[..., 0]
        start = torch.sum(err0 * torch.tensordot(self.k_start, err0, dims=1), dim=0)
        e = x[..., 1:] - torch.tensordot(self.phi, x[..., :-1], dims=1)
        return start + torch.sum(e * torch.tensordot(self.q_inv, e, dims=1), dim=(0, -1))

    def gn_contrib(self, trajs, x_trajs=None, observation=None):
        """Constant blocks (the prior precision's) and the gradient of the
        start row (``A = +I`` on block 0) and the GP rows (``A = (+Phi,
        -I)``)."""
        t, d = trajs.shape[-2], trajs.shape[-1]
        pqp = self.phi.T @ self.q_inv @ self.phi
        diag = (self.q_inv + pqp).repeat(t, 1, 1)
        diag[0] = self.k_start + pqp
        diag[t - 1] = self.q_inv
        lower = (-(self.q_inv @ self.phi)).repeat(t - 1, 1, 1)
        lead = trajs.shape[:-2]
        err0 = unary_error(trajs[..., 0, :], self.start_state)
        qe = torch.einsum("ij,...tj->...ti", self.q_inv, gp_error(trajs, self.phi))
        g = torch.zeros_like(trajs)
        g[..., 0, :] += torch.einsum("ij,...j->...i", self.k_start, err0)
        g[..., :-1, :] += torch.einsum("ji,...tj->...ti", self.phi, qe)
        g[..., 1:, :] -= qe
        return GNContrib(diag=diag.expand(lead + (t, d, d)),
                         lower=lower.expand(lead + (t - 1, d, d)), g=g)


@dataclass
class CostGPTrajectory(Cost):
    """GP smoothness only, no start anchor. Like the reference, it has no
    linear system: ``gn_contrib`` raises."""

    q_inv: torch.Tensor  # [d, d]
    phi: torch.Tensor  # [d, d]

    @classmethod
    def create(cls, n_dof, traj_len, start_state, dt, sigma_params,
               dtype=torch.float32, device=None):
        del traj_len, start_state
        return cls(
            q_inv=q_inv_block(n_dof, dt, sigma=sigma_params["sigma_gp"], dtype=dtype,
                              device=device),
            phi=phi_matrix(n_dof, dt, dtype=dtype, device=device),
        )

    def eval(self, trajs, x_trajs=None, observation=None):
        return torch.sum(quadratic_cost(gp_error(trajs, self.phi), self.q_inv), dim=-1)

    def gn_contrib(self, trajs, x_trajs=None, observation=None):
        raise NotImplementedError("reference parity: no linear system for this cost")


@dataclass
class CostGoalPrior(Cost):
    """Per-goal quadratic anchor on the final state of a goal-major batch
    (``batch = num_goals * per_goal``)."""

    multi_goal_states: torch.Tensor  # [G, d]
    k_goal: torch.Tensor  # [d, d]
    num_goals: int

    @classmethod
    def create(cls, n_dof, traj_len, multi_goal_states, sigma_goal_prior,
               dtype=torch.float32, device=None, **kw):
        del traj_len, kw
        goals = torch.as_tensor(multi_goal_states, dtype=dtype, device=device)
        return cls(
            multi_goal_states=goals,
            k_goal=unary_weight(2 * n_dof, sigma_goal_prior, dtype=dtype, device=device),
            num_goals=goals.shape[0],
        )

    def particle_block(self, start: int, count: int, total: int) -> "CostGoalPrior":
        """The same cost on particles ``start .. start + count`` of a
        goal-major batch of ``total`` particles: one goal per particle (its
        global goal ``i // (total // num_goals)``), so a rank's block that
        starts inside a goal scores each particle against its own goal."""
        idx = particle_goals(start, count, total, self.num_goals, self.multi_goal_states.device)
        return replace(self, multi_goal_states=self.multi_goal_states[idx], num_goals=count)

    def eval(self, trajs, x_trajs=None, observation=None):
        batch, d = trajs.shape[0], trajs.shape[-1]
        x_final = trajs[..., -1, :].reshape(self.num_goals, -1, d)
        err = unary_error(x_final, self.multi_goal_states[:, None])
        return quadratic_cost(err, self.k_goal).reshape(batch)

    def supports_planes(self) -> bool:
        return True

    def eval_planes(self, planes, observation=None):
        """Plane-layout ``eval``: goal-major grouping on the leading axis of
        the ``[..., T]`` planes; only their last step is read."""
        last = stack_planes(planes)[..., -1:]  # [d, ..., 1]
        return self.eval(last.movedim(0, -1).reshape(-1, 1, len(planes))).reshape(
            last.shape[1:-1])

    def gn_contrib(self, trajs, x_trajs=None, observation=None):
        """The goal anchor on the final state of the goal-major batch."""
        batch, t, d = trajs.shape[0], trajs.shape[-2], trajs.shape[-1]
        x_final = trajs[..., -1, :].reshape(self.num_goals, -1, d)
        err = unary_error(x_final, self.multi_goal_states[:, None])  # [G, B/G, d]
        g = torch.zeros_like(trajs)
        g[..., -1, :] = torch.einsum("ij,...j->...i", self.k_goal, err).reshape(batch, d)
        diag = trajs.new_zeros(trajs.shape[:-2] + (t, d, d))
        diag[..., -1, :, :] = self.k_goal
        return GNContrib(diag=diag, lower=None, g=g)


@dataclass
class CostCollision(Cost):
    """Obstacle cost of a field over the timestep slice ``traj_range``
    (default ``1..T-1``): ``k * sum_t field(.)`` with ``k = 1 /
    sigma_coll^2``. The field evaluates on the FK link poses when the
    composite passes them, otherwise on the configuration positions."""

    field: Any
    sigma_coll: float
    n_dof: int
    traj_range: tuple

    @classmethod
    def create(cls, n_dof, traj_len, field, sigma_coll, traj_range=None, **kw):
        del kw
        if traj_range is None:
            traj_range = (1, traj_len)
        return cls(field=field, sigma_coll=sigma_coll, n_dof=n_dof,
                   traj_range=tuple(traj_range))

    def _field_errors(self, trajs, x_trajs, observation):
        spheres = (observation or {}).get("obstacle_spheres", None)
        sl = slice(*self.traj_range)
        # strided views: the fields read them in place
        states = x_trajs[:, sl] if x_trajs is not None else trajs[:, sl, : self.n_dof]
        return self.field.compute_cost(states, obstacle_spheres=spheres)

    def eval(self, trajs, x_trajs=None, observation=None):
        err = self._field_errors(trajs, x_trajs, observation)  # [B, T-1]
        return (1.0 / self.sigma_coll**2) * torch.sum(err, dim=-1)

    def supports_planes(self) -> bool:
        return hasattr(self.field, "compute_cost_planes")

    def eval_planes(self, planes, observation=None):
        """Plane-layout ``eval`` for 2D coordinate fields: the field reads
        the first two planes (in place when they are views of one tensor)."""
        vals = self.field.compute_cost_planes(planes[0], planes[1])
        return (1.0 / self.sigma_coll**2) * torch.sum(vals[..., slice(*self.traj_range)], dim=-1)

    def supports_dof_planes(self) -> bool:
        return self.n_dof == 2 and hasattr(self.field, "compute_cost_planes")

    def eval_dof_planes(self, x_planes, observation=None):
        """``x_planes [d, B, 2T]``: the 2D field evaluates on the two
        position planes, read in place."""
        t = x_planes.shape[-1] // 2
        vals = self.field.compute_cost_planes(x_planes[0, :, :t], x_planes[1, :, :t])
        return (1.0 / self.sigma_coll**2) * torch.sum(vals[..., slice(*self.traj_range)], dim=-1)

    def gn_rank1(self, trajs, x_trajs=None, observation=None, fk_trajs=None):
        """Rank-1 structure of the GN contribution: per timestep the
        diagonal block is ``k h_t h_t^T`` and the gradient ``k h_t e_t``.
        Returns ``(h [B, T, n_dof], e [B, T], k)``, positions only, zero
        outside ``traj_range``."""
        sl = slice(*self.traj_range)
        t = trajs.shape[-2]
        err, grad = _field_jacobian(
            lambda tr, x: self._field_errors(tr, x, observation), trajs, fk_trajs)
        if fk_trajs is None and x_trajs is not None:  # errors on the given poses
            err = self._field_errors(trajs, x_trajs, observation)
        h = trajs.new_zeros(trajs.shape[:-2] + (t, self.n_dof))
        h[..., sl, :] = grad[..., sl, : self.n_dof]
        e = trajs.new_zeros(trajs.shape[:-2] + (t,))
        e[..., sl] = err
        return h, e, 1.0 / self.sigma_coll**2

    def gn_contrib(self, trajs, x_trajs=None, observation=None, fk_trajs=None):
        """``diag = k h h^T`` per timestep and ``g = k h e`` (the field's
        Jacobian ``h`` on the positions)."""
        h, e, k = self.gn_rank1(trajs, x_trajs, observation, fk_trajs)
        return _rank1_contrib(trajs, h, e, k, self.n_dof)


@dataclass
class CostGoal(Cost):
    """Field cost of the final timestep only, ``k * field(.)`` with ``k = 1
    / sigma_goal^2`` (the SE(3) end-effector target): on the last link poses
    when the composite passes them, otherwise on the last positions."""

    field: Any
    sigma_goal: float
    n_dof: int

    @classmethod
    def create(cls, n_dof, traj_len, field, sigma_goal, **kw):
        del traj_len, kw
        return cls(field=field, sigma_goal=sigma_goal, n_dof=n_dof)

    def _field_error(self, trajs, x_trajs):
        if x_trajs is not None:
            return self.field.compute_cost(x_trajs[:, -1])
        return self.field.compute_cost(trajs[:, -1, : self.n_dof])

    def eval(self, trajs, x_trajs=None, observation=None):
        return (1.0 / self.sigma_goal**2) * self._field_error(trajs, x_trajs)

    def gn_rank1(self, trajs, x_trajs=None, observation=None, fk_trajs=None):
        """Rank-1 GN structure (see ``CostCollision.gn_rank1``): one active
        column at the final timestep."""
        t = trajs.shape[-2]
        err, grad = _field_jacobian(self._field_error, trajs, fk_trajs)
        if fk_trajs is None and x_trajs is not None:
            err = self._field_error(trajs, x_trajs)
        h = trajs.new_zeros(trajs.shape[:-2] + (t, self.n_dof))
        h[..., -1, :] = grad[..., -1, : self.n_dof]
        e = trajs.new_zeros(trajs.shape[:-2] + (t,))
        e[..., -1] = err
        return h, e, 1.0 / self.sigma_goal**2

    def gn_contrib(self, trajs, x_trajs=None, observation=None, fk_trajs=None):
        h, e, k = self.gn_rank1(trajs, x_trajs, observation, fk_trajs)
        return _rank1_contrib(trajs, h, e, k, self.n_dof)


def _rank1_contrib(trajs, h, e, k, n_dof) -> GNContrib:
    """``GNContrib`` of a rank-1 field cost: ``h [B, T, n_dof]`` padded to
    the state's velocity dims with zeros, ``diag = k h h^T``, ``g = k h e``."""
    h_full = torch.zeros_like(trajs)
    h_full[..., :n_dof] = h
    diag = k * torch.einsum("...ti,...tj->...tij", h_full, h_full)
    return GNContrib(diag=diag, lower=None, g=k * h_full * e[..., None])


@dataclass
class CostComposite(Cost):
    """Sums child costs on a ``[B, T, 2*n_dof]`` batch. With ``fk`` (a
    chain's ``fk`` or ``fk_compact``) it computes the link poses of every
    timestep once and passes them to every child."""

    costs: tuple
    n_dof: int
    traj_len: int
    fk: Callable | None = None

    @classmethod
    def create(cls, n_dof, traj_len, cost_list: Sequence[Cost], fk=None):
        return cls(costs=tuple(cost_list), n_dof=n_dof, traj_len=traj_len, fk=fk)

    def supports_planes(self) -> bool:
        """Whether every child evaluates on per-dim time planes (a child
        without ``supports_planes`` counts when it has ``eval_planes``, as
        in the JAX package)."""
        return self.fk is None and all(
            getattr(c, "supports_planes", lambda c=c: hasattr(c, "eval_planes"))()
            for c in self.costs)

    def eval_planes(self, planes, observation=None):
        """Sum of child costs on per-dim time planes ``tuple_d of [..., T]``."""
        total = None
        for c in self.costs:
            v = c.eval_planes(planes, observation=observation)
            total = v if total is None else total + v
        return total

    def supports_dof_planes(self) -> bool:
        return self.fk is None and all(c.supports_dof_planes() for c in self.costs)

    def eval_dof_planes(self, x_planes, observation=None):
        """Sum of child costs on the dof-factored batch ``[d, B, 2T]``."""
        total = None
        for c in self.costs:
            v = c.eval_dof_planes(x_planes, observation=observation)
            total = v if total is None else total + v
        return total

    def _fk_trajs(self, trajs):
        """Link poses of ``trajs [B, T, 2d]``: ``[B, T, L, 4, 4]`` from
        ``fk``, or a ``[B, T]``-batched ``LinkState`` from ``fk_compact``;
        None without ``fk``."""
        if self.fk is None:
            return None
        batch = trajs.shape[0]
        out = self.fk(trajs.reshape(-1, trajs.shape[-1])[:, : self.n_dof])
        if hasattr(out, "positions"):
            return out.reshape(batch, self.traj_len)
        return out.reshape(batch, self.traj_len, -1, 4, 4)

    def eval(self, trajs, x_trajs=None, observation=None):
        trajs = trajs.reshape(-1, self.traj_len, 2 * self.n_dof)
        if x_trajs is None:
            x_trajs = self._fk_trajs(trajs)
        total = trajs.new_zeros(trajs.shape[0])
        for cost in self.costs:
            total = total + cost.eval(trajs, x_trajs=x_trajs, observation=observation)
        return total

    def gn_contrib(self, trajs, x_trajs=None, observation=None):
        """Sum of the children's ``GNContrib``; the field costs differentiate
        through ``fk`` when the composite has one (and so compute the link
        poses themselves)."""
        trajs = trajs.reshape(-1, self.traj_len, 2 * self.n_dof)
        t, d = self.traj_len, 2 * self.n_dof
        diag = trajs.new_zeros(trajs.shape[:-2] + (t, d, d))
        lower = trajs.new_zeros(trajs.shape[:-2] + (t - 1, d, d))
        g = torch.zeros_like(trajs)
        fk_trajs = self._fk_trajs if self.fk is not None else None
        for cost in self.costs:
            if isinstance(cost, (CostGoal, CostCollision)):
                c = cost.gn_contrib(trajs, x_trajs=x_trajs, observation=observation,
                                    fk_trajs=fk_trajs)
            else:
                c = cost.gn_contrib(trajs, x_trajs=x_trajs, observation=observation)
            if c.diag is not None:
                diag = diag + c.diag
            if c.lower is not None:
                lower = lower + c.lower
            g = g + c.g
        return GNContrib(diag=diag, lower=lower, g=g)
