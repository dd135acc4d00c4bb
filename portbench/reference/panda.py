"""Plain reference of the Panda StochGPMP problem, float64.

Written from the upstream definitions (anindex/stoch_gpmp,
``examples/panda_environment.py`` and the costs it composes): the 7-DOF
Franka Panda's state ``[q, qdot]`` at ``T`` steps of ``dt``.

- Forward kinematics from the arm's own joint table (``PANDA_JOINTS``,
  franka_description's Panda without gripper): per joint its origin
  (``Rz(yaw) Ry(pitch) Rx(roll)`` and a translation, in the parent's frame)
  and, for a revolute joint, ``Rz(q)``; the 9 frames after link 1 .. link
  7, the hand and the end-effector.
- Cost of a trajectory, as upstream sums it: ``CostGP`` (the start anchor
  ``I / sigma_start^2`` and the constant-velocity GP transitions ``e_t =
  x_{t+1} - Phi x_t`` with ``Q^{-1}``) and ``CostGoalPrior`` (``I /
  sigma_goal_prior^2`` on the last state, against the particle's goal) as
  the residuals of a dense factor matrix ``J`` per dof, so ``J^T K J`` is
  the quadratic's dense precision; the self RBF over all ordered pairs of
  the 9 link positions and the obstacle RBF of each link and sphere at
  steps 1..T-1, each times ``1 / sigma^2``; the end-effector's SE(3)
  distance to the target at step T-1, ``|p - p*| + arccos((tr(R^T R*) -
  1) / 2)``, squared, times ``1 / sigma_goal^2``; and the importance term
  ``tau x . Lambda_s mu`` of the sampling precision.
- Sampling: ``x = mu + eps @ L^{-1}`` with ``L`` the lower Cholesky factor
  of the sampling precision. Under scalar sigmas that precision is one
  ``[2T, 2T]`` block per dof, and the whole ``[M, M]`` factor is that
  block's factor, permuted: draws are whitened per dof by it.
- One iteration: softmax of ``-cost / tau`` over a particle's samples and
  ``mu += step_size * sum_s w_s (x_s - mu)``.

Layout: the program's dof planes ``[n, ..., 2T]`` (per dof the positions
of the T steps, then the velocities) are the working layout here;
:func:`tmajor` orders a plane by time (``[p_0, v_0, p_1, ...]``), the order
of the per-dof precision.

Departures from upstream, each far below the check's limits:
- the fused kernel (K5) takes the SE(3) angle by the Abramowitz & Stegun
  4.4.46 polynomial (|err| <= 2e-8 rad, ~4e-8 of the goal term at the
  cell's distances); here the exact ``arccos``, as upstream;
- the angle's cosine is clamped to ``[-1 + 1e-7, 1 - 1e-7]``, as the
  program clamps it;
- float64 throughout; TF32 products are off while the reference computes
  (they touch only float32 products, which the precision controls of
  ``portbench/tests/test_portbench_panda_cuda.py`` use).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.planar import const_vel_means, phi, precision, q_inv

F64 = torch.float64
HALF_PI = math.pi / 2
# franka_description's Panda without gripper: (kind, origin rpy, origin xyz);
# every revolute joint turns about its frame's z axis
PANDA_JOINTS = (
    ("revolute", (0.0, 0.0, 0.0), (0.0, 0.0, 0.333)),
    ("revolute", (-HALF_PI, 0.0, 0.0), (0.0, 0.0, 0.0)),
    ("revolute", (HALF_PI, 0.0, 0.0), (0.0, -0.316, 0.0)),
    ("revolute", (HALF_PI, 0.0, 0.0), (0.0825, 0.0, 0.0)),
    ("revolute", (-HALF_PI, 0.0, 0.0), (-0.0825, 0.384, 0.0)),
    ("revolute", (HALF_PI, 0.0, 0.0), (0.0, 0.0, 0.0)),
    ("revolute", (HALF_PI, 0.0, 0.0), (0.088, 0.0, 0.0)),
    ("fixed", (0.0, 0.0, -math.pi / 4), (0.0, 0.0, 0.107)),  # panda_hand
    ("fixed", (0.0, 0.0, -1.57), (0.0, 0.0, 0.1)),  # ee_link
)
COS_CLAMP = 1e-7
CHUNK = 1 << 16  # configurations a field evaluation holds at once


class tf32_off:
    """TF32 products off inside the block, restored after."""

    def __enter__(self):
        self.keep = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.keep
        return False


def origin(rpy, xyz) -> tuple:
    """A joint origin: ``(Rz(yaw) Ry(pitch) Rx(roll), xyz)``, float64."""
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = (math.cos(r), math.sin(r), math.cos(p), math.sin(p),
                              math.cos(y), math.sin(y))
    rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    ry = np.array([[cp, 0.0, sp], [0.0, 1.0, 0.0], [-sp, 0.0, cp]])
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cr, -sr], [0.0, sr, cr]])
    return torch.as_tensor(rz @ ry @ rx), torch.as_tensor(xyz, dtype=F64)


def fk(q: torch.Tensor):
    """``q [..., 7]`` -> the 9 frames' positions ``[..., 9, 3]`` and the
    end-effector's rotation ``[..., 3, 3]``, in ``q``'s dtype."""
    kw = dict(dtype=q.dtype, device=q.device)
    rot = torch.eye(3, **kw).expand(q.shape[:-1] + (3, 3))
    pos = torch.zeros(q.shape[:-1] + (3,), **kw)
    out, k = [], 0
    for kind, rpy, xyz in PANDA_JOINTS:
        a_rot, a_xyz = (v.to(**kw) for v in origin(rpy, xyz))
        pos = pos + rot @ a_xyz
        rot = rot @ a_rot
        if kind == "revolute":
            c, s = torch.cos(q[..., k, None]), torch.sin(q[..., k, None])
            c0, c1 = rot[..., 0], rot[..., 1]
            rot = torch.stack([c0 * c + c1 * s, c1 * c - c0 * s, rot[..., 2]], dim=-1)
            k += 1
        out.append(pos)
    return torch.stack(out, dim=-2), rot


def link_fields(pos: torch.Tensor, spheres: torch.Tensor, margin: float, w_self: float,
                w_obst: float) -> tuple:
    """Self RBF over all ordered link pairs (the diagonal included) and the
    obstacle RBF of each link and sphere ``[O, 4]`` at link positions
    ``[..., L, 3]``: both terms, ``[...]``, and the obstacle term alone."""
    sq = ((pos[..., :, None, :] - pos[..., None, :, :]) ** 2).sum(-1)
    self_term = torch.exp(-sq / (2.0 * margin * margin)).sum((-1, -2))
    sq = ((pos[..., :, None, :] - spheres[:, :3]) ** 2).sum(-1)
    obst = w_obst * torch.exp(-0.5 * sq / spheres[:, 3] ** 2).sum((-1, -2))
    return w_self * self_term + obst, obst


def tmajor(x: torch.Tensor) -> torch.Tensor:
    """Dof planes ``[..., 2T]`` (positions, then velocities) in time order
    ``[p_0, v_0, p_1, v_1, ...]``."""
    return x.unflatten(-1, (2, x.shape[-1] // 2)).transpose(-1, -2).flatten(-2)


def planes(x: torch.Tensor) -> torch.Tensor:
    """A trajectory batch ``[..., T, 2n]`` (positions, then velocities, per
    step) as dof planes ``[n, ..., 2T]``."""
    n = x.shape[-1] // 2
    y = x.unflatten(-1, (2, n))  # [..., T, 2, n]
    return y.movedim(-1, 0).movedim(-1, -2).flatten(-2)


def factor_matrix(traj_len: int, dt: float, sigma_start: float, sigma_gp: float,
                  sigma_goal: float) -> tuple:
    """One dof's factors, time-ordered lanes: ``J [2T + 2, 2T]`` (the start
    state, the ``T - 1`` transitions ``x_{t+1} - Phi x_t``, the last state)
    and their weights ``K [T + 1, 2, 2]``; the quadratic is ``(J x - y)^T K
    (J x - y)`` with ``y`` the start and the goal in their rows."""
    t = traj_len
    eye = torch.eye(2, dtype=F64)
    jac = torch.zeros(2 * t + 2, 2 * t, dtype=F64)
    jac[:2, :2] = eye
    for i in range(t - 1):
        jac[2 + 2 * i:4 + 2 * i, 2 * i:2 * i + 2] = -phi(1, dt)
        jac[2 + 2 * i:4 + 2 * i, 2 * i + 2:2 * i + 4] = eye
    jac[2 * t:, 2 * t - 2:] = eye
    weights = torch.stack([eye / sigma_start**2] + [q_inv(1, dt, sigma_gp)] * (t - 1)
                          + [eye / sigma_goal**2])
    return jac, weights


class PandaProblem:
    """The reference's view of one Panda problem: the configuration's
    sizes, sigmas, goals and target; costs take the scene's spheres."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.n = cfg["n_dof"]
        self.T = cfg["traj_len"]
        self.dt = cfg["dt"]
        self.ppg = cfg["particles_per_goal"]
        self.start = torch.tensor(cfg["start"], dtype=F64)
        self.goals = torch.tensor(cfg["goals"], dtype=F64)
        s = cfg["sample_sigmas"]
        self.lam1 = precision(1, self.T, self.dt, s["start"], s["gp"], s["goal"])
        self.chol1 = torch.linalg.cholesky(self.lam1)
        self.init_sigmas = cfg["init_sigmas"]
        self._chol_init = None
        c, f = cfg["cost"], cfg["fields"]
        self.jac, self.kw = factor_matrix(self.T, self.dt, c["sigma_start"], c["sigma_gp"],
                                          c["sigma_goal_prior"])
        self.target = torch.tensor(cfg["target_h"], dtype=F64)
        self.margin = f["margin"]
        self.w_self = 1.0 / f["sigma_self"] ** 2
        self.w_obst = 1.0 / f["sigma_coll"] ** 2
        self.w_goal = 1.0 / f["sigma_goal"] ** 2
        self.temperature = cfg["temperature"]
        self.step_size = cfg["step_size"]

    def init_means(self) -> torch.Tensor:
        """The init prior's mean per goal: ``[G, T, 2n]``."""
        return const_vel_means(self.start, self.goals, self.T, self.dt, self.n)

    @property
    def chol_init(self) -> torch.Tensor:
        """The lower Cholesky factor of the init prior's whole ``[M, M]``
        precision (time-major states ``[q, qdot]``)."""
        if self._chol_init is None:
            s = self.init_sigmas
            self._chol_init = torch.linalg.cholesky(
                precision(self.n, self.T, self.dt, s["start"], s["gp"], s["goal"]))
        return self._chol_init

    @property
    def w_plane(self) -> torch.Tensor:
        """The sampling map ``L^{-1}`` of one dof in plane order: ``x = mu +
        eps @ w_plane`` per dof plane."""
        w = torch.linalg.solve_triangular(self.chol1, torch.eye(2 * self.T, dtype=F64),
                                          upper=False)
        perm = tmajor(torch.arange(2 * self.T)[None]).reshape(-1).argsort()
        return w[perm][:, perm]

    def whiten(self, d: torch.Tensor) -> torch.Tensor:
        """Deviations ``[n, ..., 2T]`` (dof planes) whitened by the sampling
        factor: ``[..., n 2T]``, one row per trajectory, in the lane order of
        :meth:`rows`."""
        with tf32_off():
            z = tmajor(d.to(F64)) @ self.chol1.to(d.device)
        return z.movedim(0, -2).flatten(-2)

    @staticmethod
    def rows(eps: torch.Tensor) -> torch.Tensor:
        """Normals ``[n, ..., 2T]`` (dof planes) in the lane order of
        :meth:`whiten`."""
        return tmajor(eps.to(F64)).movedim(0, -2).flatten(-2)

    def particle_goals(self, num_particles: int) -> torch.Tensor:
        return self.goals[torch.arange(num_particles) // self.ppg]

    def weights(self, costs: torch.Tensor) -> torch.Tensor:
        return torch.softmax(-costs.to(F64) / self.temperature, dim=-1)

    def quadratic(self, x: torch.Tensor, dtype=F64) -> torch.Tensor:
        """``CostGP + CostGoalPrior`` of ``x [n, P, S, 2T]``: ``[P, S]``."""
        n, p, t = self.n, x.shape[1], self.T
        kw = dict(dtype=dtype, device=x.device)
        y = torch.zeros(n, p, 1, 2 * t + 2, **kw)
        y[..., :2] = self.start.reshape(2, n).T.to(**kw)[:, None, None]
        goals = self.particle_goals(p).reshape(p, 2, n).permute(2, 0, 1).to(**kw)
        y[..., 2 * t:] = goals[:, :, None]
        r = (tmajor(x.to(dtype)) @ self.jac.T.to(**kw) - y).unflatten(-1, (t + 1, 2))
        return torch.einsum("dpski,kij,dpskj->ps", r, self.kw.to(**kw), r)

    def importance(self, x: torch.Tensor, mu: torch.Tensor, dtype=F64) -> torch.Tensor:
        """``tau x . Lambda_s mu`` of ``x [n, P, S, 2T]`` around ``mu [n, P,
        2T]``: ``[P, S]``."""
        pu = tmajor(mu.to(dtype)) @ self.lam1.to(dtype=dtype, device=mu.device)
        return self.temperature * torch.einsum("dpsk,dpk->ps", tmajor(x.to(dtype)), pu)

    def fields(self, q: torch.Tensor, spheres: torch.Tensor) -> tuple:
        """The link fields of configurations ``q [B, 7]``, ``[B]``, and their
        obstacle term alone, ``[B]``."""
        sp = spheres.to(dtype=q.dtype, device=q.device)
        parts = [link_fields(fk(c)[0], sp, self.margin, self.w_self, self.w_obst)
                 for c in q.split(CHUNK)]
        return tuple(torch.cat(k) for k in zip(*parts))

    def goal(self, q: torch.Tensor) -> torch.Tensor:
        """The end-effector's SE(3) cost at configurations ``q [B, 7]``:
        ``[B]``."""
        pos, rot = fk(q)
        tgt = self.target.to(dtype=q.dtype, device=q.device)
        dp = (pos[..., -1, :] - tgt[:3, 3]).norm(dim=-1)
        cos = ((rot * tgt[:3, :3]).sum((-1, -2)) - 1.0) * 0.5
        angle = torch.arccos(cos.clamp(-1.0 + COS_CLAMP, 1.0 - COS_CLAMP))
        return self.w_goal * (dp + angle) ** 2

    def costs(self, x: torch.Tensor, mu: torch.Tensor, spheres, dtype=F64) -> torch.Tensor:
        """The planner's cost of samples ``x [n, P, S, 2T]`` around means
        ``mu [n, P, 2T]`` in the scene of ``spheres [O, 4]``: ``[P, S]``, in
        ``dtype`` on ``x``'s device (float32 only for a precision control, under the
        caller's TF32 setting)."""
        if dtype != F64:
            return self._costs(x, mu, spheres, dtype)[0]
        return self.costs_and_scene(x, mu, spheres)[0]

    def costs_and_scene(self, x: torch.Tensor, mu: torch.Tensor, spheres) -> tuple:
        """:meth:`costs` in float64 and the part of them that the scene's
        spheres make, the obstacle term summed over steps 1..T-1: both
        ``[P, S]``."""
        with tf32_off():
            return self._costs(x, mu, spheres, F64)

    def _costs(self, x, mu, spheres, dtype):
        x = x.to(dtype)
        n, p, s, t = self.n, x.shape[1], x.shape[2], self.T
        q = x[..., :t].permute(1, 2, 3, 0)  # [P, S, T, n]
        sp = torch.as_tensor(np.asarray(spheres), dtype=dtype).reshape(-1, 4)
        fields, scene = (f.reshape(p, s, t - 1).sum(-1)
                         for f in self.fields(q[:, :, 1:].reshape(-1, n), sp))
        total = (self.quadratic(x, dtype) + self.importance(x, mu, dtype) + fields
                 + self.goal(q[:, :, -1].reshape(-1, n)).reshape(p, s))
        return total, scene

