"""Composable trajectory cost stack.

PyTorch counterpart of the ``eval`` half of ``stoch_gpmp_tpu/costs/costs.py``
(reference ``stoch_gpmp/costs/cost_functions.py``). Conventions match:

- ``trajs``: ``[batch, traj_len, 2*n_dof]`` (positions then velocities);
- ``x_trajs``: optional FK link poses of every timestep, homogeneous
  ``[batch, traj_len, L, 4, 4]`` or a compact ``LinkState``, computed once
  by a ``CostComposite`` with ``fk`` and passed to every child;
- ``observation``: dict of runtime data;
- collision costs skip timestep 0; field goal costs read only the final
  timestep; the goal prior anchors the final state of a goal-major batch.

``eval_dof_planes`` evaluates on the dof-leading plane batch ``[d, B, 2T]``
of the dof path. The Gauss-Newton contributions (``gn_contrib``/
``gn_rank1``) and the per-dim plane evaluators of the long-horizon path are
not ported yet (GN and long-horizon slices).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from stoch_gpmp_tpu_torch.costs.factors import gp_error, quadratic_cost, unary_error
from stoch_gpmp_tpu_torch.gp.lift import phi_matrix, q_inv_block, unary_weight


class Cost:
    """Protocol-ish base of the cost classes."""

    def __call__(self, trajs, **kwargs):
        return self.eval(trajs, **kwargs)

    def eval(self, trajs, x_trajs=None, observation=None):  # pragma: no cover
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

    def eval(self, trajs, x_trajs=None, observation=None):
        batch, d = trajs.shape[0], trajs.shape[-1]
        x_final = trajs[..., -1, :].reshape(self.num_goals, -1, d)
        err = unary_error(x_final, self.multi_goal_states[:, None])
        return quadratic_cost(err, self.k_goal).reshape(batch)


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

    def supports_dof_planes(self) -> bool:
        return self.n_dof == 2 and hasattr(self.field, "compute_cost_planes")

    def eval_dof_planes(self, x_planes, observation=None):
        """``x_planes [d, B, 2T]``: the 2D field evaluates on the two
        position planes, read in place."""
        t = x_planes.shape[-1] // 2
        vals = self.field.compute_cost_planes(x_planes[0, :, :t], x_planes[1, :, :t])
        return (1.0 / self.sigma_coll**2) * torch.sum(vals[..., slice(*self.traj_range)], dim=-1)


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

    def eval(self, trajs, x_trajs=None, observation=None):
        if x_trajs is not None:
            err = self.field.compute_cost(x_trajs[:, -1])
        else:
            err = self.field.compute_cost(trajs[:, -1, : self.n_dof])
        return (1.0 / self.sigma_goal**2) * err


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
