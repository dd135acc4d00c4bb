"""Fused forms of the Panda link-field costs.

PyTorch counterpart of ``stoch_gpmp_tpu/costs/fused_fields.py``:

- ``FusedLinkFieldsCost``: the pair ``CostCollision(LinkSelfDistanceField
  (margin)) + CostCollision(LinkDistanceField('rbf'))`` in a
  ``CostComposite`` with ``fk``, in one pass over the link positions of
  timesteps ``1..T-1`` (kernel K7, ``ops/kernels/panda_fields.py``);
- ``PlaneFieldsCost``: self-collision RBF + obstacle RBF + terminal SE(3)
  goal on the joint angles, equal in value to

    CostCollision(LinkSelfDistanceField(margin), sigma_self)
  + CostCollision(LinkDistanceField('rbf'), sigma_coll)
  + CostGoal(EESE3DistanceField(target_h), sigma_goal)

in a ``CostComposite`` without FK. The collision terms (timesteps 1..T-1)
run in kernel K4 (``ops/kernels/panda_fields.py``) on the position planes,
read in place through their strides; the SE(3) term (last step only) is
plain PyTorch, one FK per trajectory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from stoch_gpmp_tpu_torch.costs.costs import Cost
from stoch_gpmp_tpu_torch.costs.fields import _link_pos
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (
    fk_link_fields_cost_rows,
    fused_link_fields_cost,
)
from stoch_gpmp_tpu_torch.utils.profiling import annotate


def ee_goal_distance(chain, q_last, target_h, *, w_pos: float, w_rot: float, acos=torch.arccos):
    """``w_pos * |p_ee - p*| + w_rot * angle(R_ee, R*)`` at ``q_last
    [d, B]`` against the ``[4, 4]`` target, the angle clamped as in
    ``se3.rotation_angle``; ``acos`` lets the fused step's plain version use
    the kernel's polynomial."""
    (r_ee, p_ee) = chain.fk_planes_from_scalars([q_last[i] for i in range(chain.n_dofs)])[-1]
    th = target_h
    sq = 0.0
    for c in range(3):
        dd = p_ee[c] - th[c, 3]
        sq = sq + dd * dd
    tr = 0.0
    for i in range(3):
        for j in range(3):
            tr = tr + r_ee[i][j] * th[i, j]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    return w_pos * torch.sqrt(sq) + w_rot * acos(cos)


@dataclass
class FusedLinkFieldsCost(Cost):
    """Self RBF + obstacle RBF over timesteps 1..T-1 from the FK link poses
    that a ``CostComposite`` with ``fk`` passes, summed over time."""

    margin: float = 0.03
    sigma_self: float = 0.01
    sigma_coll: float = 0.01

    @classmethod
    def create(cls, n_dof, traj_len, margin=0.03, sigma_self=0.01, sigma_coll=0.01, **kw):
        del n_dof, traj_len, kw
        return cls(margin=margin, sigma_self=sigma_self, sigma_coll=sigma_coll)

    def eval(self, trajs, x_trajs=None, observation=None):
        if x_trajs is None:
            raise ValueError("FusedLinkFieldsCost requires FK link poses")
        spheres = (observation or {}).get("obstacle_spheres", None)
        vals = fused_link_fields_cost(
            _link_pos(x_trajs)[:, 1:], spheres, margin=self.margin,  # [B, T-1, L, 3], a view
            w_self=1.0 / self.sigma_self**2,
            w_obst=1.0 / self.sigma_coll**2 if spheres is not None else 0.0,
        )
        return torch.sum(vals, dim=-1)

    def gn_contrib(self, trajs, x_trajs=None, observation=None, fk_trajs=None):
        raise NotImplementedError(
            "use the separate CostCollision fields for the Gauss-Newton path")


@dataclass
class PlaneFieldsCost(Cost):
    """Self RBF + obstacle RBF over timesteps 1..T-1 and the terminal SE(3)
    goal, on the joint positions of a trajectory batch."""

    chain: Any  # kinematics.KinematicChain
    target_h: torch.Tensor  # [4, 4] SE(3) goal of the end-effector
    n_dof: int
    traj_len: int
    margin: float = 0.03
    sigma_self: float = 0.01
    sigma_coll: float = 0.01
    sigma_goal: float = 0.00007
    w_pos: float = 1.0
    w_rot: float = 1.0

    @classmethod
    @annotate("costs.plane_fields")
    def create(cls, n_dof, traj_len, chain, target_h, *, margin=0.03, sigma_self=0.01,
               sigma_coll=0.01, sigma_goal=0.00007, w_pos=1.0, w_rot=1.0):
        """The obstacle term takes every sphere of the observation, as the
        JAX package's kernel paths do (its ``num_obstacles`` is read only by
        its ``use_pallas=False`` path)."""
        return cls(chain=chain, target_h=target_h, n_dof=n_dof, traj_len=traj_len,
                   margin=margin, sigma_self=sigma_self, sigma_coll=sigma_coll,
                   sigma_goal=sigma_goal, w_pos=w_pos, w_rot=w_rot)

    def supports_planes(self) -> bool:
        return True

    def supports_dof_planes(self) -> bool:
        return True

    def _eval_q(self, q, observation):
        """``q [d, B, T]`` joint-angle planes (any strides) -> ``[B]``."""
        spheres = (observation or {}).get("obstacle_spheres", None)
        coll = fk_link_fields_cost_rows(
            self.chain, q, spheres, margin=self.margin, w_self=1.0 / self.sigma_self**2,
            w_obst=1.0 / self.sigma_coll**2 if spheres is not None else 0.0,
        )
        target = self.target_h.to(device=q.device, dtype=q.dtype)
        dist = ee_goal_distance(self.chain, q[:, :, -1], target,
                                w_pos=self.w_pos, w_rot=self.w_rot)
        return coll + dist * dist / self.sigma_goal**2

    def eval(self, trajs, x_trajs=None, observation=None):
        """Flat ``[B, T, 2d]`` (or ``[B, M]``) batch: the position columns
        are read in place as ``[d, B, T]`` planes."""
        trajs = trajs.reshape(-1, self.traj_len, 2 * self.n_dof)
        return self._eval_q(trajs[..., : self.n_dof].permute(2, 0, 1), observation)

    def eval_dof_planes(self, x_planes, observation=None):
        """Dof planes ``[d, B, 2T]``: the position planes are the first T
        lanes of each dof, read in place."""
        t = x_planes.shape[-1] // 2
        return self._eval_q(x_planes[: self.n_dof, :, :t], observation)

    def eval_planes(self, planes, observation=None):
        """Per-dof time planes ``tuple_d of [..., T]`` -> ``[...]``."""
        batch_shape = planes[0].shape[:-1]
        t = planes[0].shape[-1]
        q = torch.stack([p.reshape(-1, t) for p in planes[: self.n_dof]])
        return self._eval_q(q, observation).reshape(batch_shape)

    def gn_contrib(self, trajs, x_trajs=None, observation=None, fk_trajs=None):
        raise NotImplementedError(
            "use the separate CostCollision/CostGoal fields for Gauss-Newton")
