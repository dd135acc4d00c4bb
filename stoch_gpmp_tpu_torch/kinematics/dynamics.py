"""Rigid-body dynamics over a URDF-derived tree: batched RNEA, mass matrix,
forward dynamics.

PyTorch counterpart of ``stoch_gpmp_tpu/kinematics/dynamics.py``: the
recursive Newton-Euler algorithm (two passes over the joint tree,
link-frame 3-vector recursions), batched over arbitrary leading axes, for
revolute/continuous, prismatic and fixed joints, with gravity entering
through the base acceleration (``a_base = -g``).

The math is the JAX package's; the layout is not. ``mass_matrix`` runs its
``n`` unit accelerations as one RNEA pass over an extra batch axis (the
JAX package runs ``n`` passes), and :meth:`ChainDynamics.mass_and_bias`
adds the bias row ``h(q, qd)`` to that same pass, so a forward-dynamics
step costs one pass. Linear systems in ``M(q)`` (symmetric positive
definite) are solved by Cholesky without an error check (``cholesky_ex``),
so nothing in a step waits on the host and the step can be captured in a
CUDA graph (``envs/objects.py``).

Tensors live on the dynamics' device (the CUDA card unless asked
otherwise) in its dtype, float64 by default.
"""

from __future__ import annotations

import numpy as np
import torch

from stoch_gpmp_tpu_torch.kinematics.chain import _origin_np, _topo_sort
from stoch_gpmp_tpu_torch.kinematics.urdf import RobotModel
from stoch_gpmp_tpu_torch.utils.device import resolve_device

GRAVITY = (0.0, 0.0, -9.81)


def _rpy_matrix(rpy) -> np.ndarray:
    return _origin_np(rpy, (0.0, 0.0, 0.0))[:3, :3]


def _skew(a) -> np.ndarray:
    """``K`` with ``K v = a x v``."""
    return np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])


# 3-vector algebra, broadcast over leading axes; in the forward pass None
# stands for an exact zero vector (a link at rest relative to the base, or
# no velocity at all), so its terms are not launched
def _cross(a, b):
    """``a x b`` over the last axis."""
    if a is None or b is None:
        return None
    return torch.linalg.cross(*torch.broadcast_tensors(a, b))


def _rot(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R v`` for ``r [..., 3, 3]``, ``v [..., 3]``."""
    return (r * v.unsqueeze(-2)).sum(-1)


def _rot_t(r: torch.Tensor, v):
    """``R^T v``."""
    return None if v is None else (r * v.unsqueeze(-1)).sum(-2)


def _add(*terms):
    """The sum of the terms that are not None, in order."""
    out = None
    for t in terms:
        if t is not None:
            out = t if out is None else out + t
    return out


def _stack(vs: list, zero: torch.Tensor) -> torch.Tensor:
    """``[..., len(vs), 3]`` from 3-vectors of broadcastable shapes (None:
    ``zero``)."""
    return torch.stack(torch.broadcast_tensors(*[zero if v is None else v for v in vs]), dim=-2)


def solve_spd(m: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``m^{-1} rhs`` for symmetric positive definite ``m [..., n, n]`` and
    ``rhs [..., n]`` by Cholesky, with no error check: a factor that fails
    gives non-finite values, which the caller gates."""
    chol, _ = torch.linalg.cholesky_ex(m)
    return torch.cholesky_solve(rhs.unsqueeze(-1), chol).squeeze(-1)


class ChainDynamics:
    """Batched inverse/forward dynamics for a fixed-topology joint tree.

    Per-link inertial parameters (mass, COM in the link frame, rotational
    inertia about the COM in the link frame) are resolved at construction
    from ``model.inertials``; links without an ``<inertial>`` block are
    massless. ``dtype`` defaults to float64; ``device`` None means the
    CUDA card."""

    def __init__(self, model: RobotModel, dtype=torch.float64, device=None):
        self.model = model
        self.dtype = dtype
        self.device = resolve_device(device)
        self._joints = _topo_sort(model)
        self.n_dofs = model.n_dofs
        names = [j.child_link for j in self._joints]
        # parent joint index per joint (-1 = attached to the root link)
        self._parent = [names.index(j.parent_link) if j.parent_link in names else -1
                        for j in self._joints]
        self._types = [j.joint_type for j in self._joints]
        self._dof_index = []
        dof = 0
        for j in self._joints:
            self._dof_index.append(dof if j.actuated else -1)
            dof += int(j.actuated)

        # static frame data, float64 numpy
        self._origin_r = np.stack([_rpy_matrix(j.origin_rpy) for j in self._joints])
        self._origin_p = np.stack([np.asarray(j.origin_xyz, dtype=np.float64)
                                   for j in self._joints])
        self._axes = np.stack([np.asarray(j.axis, dtype=np.float64) for j in self._joints])

        # per-link inertials in the LINK frame: mass, COM, inertia about COM
        mass, com, inertia = [], [], []
        for j in self._joints:
            spec = model.inertial_for(j.child_link)
            if spec is None:
                mass.append(0.0)
                com.append(np.zeros(3))
                inertia.append(np.zeros((3, 3)))
                continue
            i_local = np.array([[spec.ixx, spec.ixy, spec.ixz],
                                [spec.ixy, spec.iyy, spec.iyz],
                                [spec.ixz, spec.iyz, spec.izz]])
            r = _rpy_matrix(spec.com_rpy)
            mass.append(spec.mass)
            com.append(np.asarray(spec.com_xyz, dtype=np.float64))
            inertia.append(r @ i_local @ r.T)
        self._mass = np.asarray(mass)
        self._com = np.stack(com)
        self._inertia = np.stack(inertia)
        self.total_mass = float(self._mass.sum())

        # the same tables on the device: per joint, and stacked where the
        # work runs for all joints at once (the revolute joints' rotations,
        # the links' forces, the joint torques)
        t = self._t
        self._r0 = [t(r) for r in self._origin_r]
        self._p0 = [t(p) for p in self._origin_p]
        self._a = [t(a) for a in self._axes]
        self._r0a = [t(r @ a) for r, a in zip(self._origin_r, self._axes)]
        self._rev = [k for k, jt in enumerate(self._types) if jt in ("revolute", "continuous")]
        self._rev_dofs = torch.tensor([self._dof_index[k] for k in self._rev], dtype=torch.long,
                                      device=self.device)
        self._rev_r0 = t(self._origin_r[self._rev])
        self._rev_k = t(np.array([_skew(self._axes[k]) for k in self._rev]).reshape(-1, 3, 3))
        self._rev_kk = self._rev_k @ self._rev_k
        self._com_all = t(self._com)
        self._inertia_all = t(self._inertia)
        self._mass_col = t(self._mass[:, None])
        act = [k for k, d in enumerate(self._dof_index) if d >= 0]
        self._act = act
        self._act_axes = t(self._axes[act])
        # a link's wrench reaches a torque only through an actuated joint on
        # its path to the root: others are not accumulated
        self._wrench_used = []
        for k, j in enumerate(self._joints):
            p_idx = self._parent[k]
            self._wrench_used.append(j.actuated or (p_idx >= 0 and self._wrench_used[p_idx]))
        self._eye3 = t(np.eye(3))
        self._zero3 = t(np.zeros(3))
        n = self.n_dofs
        # rows of the one-pass mass matrix (+ bias): unit accelerations, then
        # the bias row's zero acceleration; qd enters the bias row only
        self._bias_rows = t(np.vstack([np.eye(n), np.zeros((1, n))]))
        self._bias_mask = t(np.vstack([np.zeros((n, 1)), np.ones((1, 1))]))
        self._base = {}  # gravity -> (a_base [3], one-pass a_base [n + 1, 3])

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _base_acc(self, gravity):
        """``(-g [3], [0] * n + [-g] [n + 1, 3])``, made once per gravity."""
        key = tuple(float(g) for g in gravity)
        if key not in self._base:
            a = -np.asarray(key, dtype=np.float64)
            rows = np.vstack([np.zeros((self.n_dofs, 3)), a[None]])
            self._base[key] = (self._t(a), self._t(rows))
        return self._base[key]

    # ------------------------------------------------------------------ #
    def _joint_frames(self, q: torch.Tensor):
        """Per joint: rotation ``R [..., 3, 3]`` of the child frame in the
        parent frame and child-origin position ``p [..., 3]`` in the parent
        frame (prismatic displacement included). The revolute joints'
        rotations ``R0 (I + sin(q) K + (1 - cos(q)) K^2)`` are formed for
        all of them at once."""
        batch = q.shape[:-1]
        if self._rev:
            qr = q.index_select(-1, self._rev_dofs)[..., None, None]
            rev_r = self._rev_r0 @ (self._eye3 + torch.sin(qr) * self._rev_k
                                    + (1.0 - torch.cos(qr)) * self._rev_kk)
        frames = []
        for k, jtype in enumerate(self._types):
            if jtype in ("revolute", "continuous"):
                r = rev_r[..., self._rev.index(k), :, :]
                p = self._p0[k].expand(batch + (3,))
            elif jtype == "prismatic":
                qk = q[..., self._dof_index[k], None]
                r = self._r0[k].expand(batch + (3, 3))
                p = self._p0[k] + qk * self._r0a[k]
            else:  # fixed
                r = self._r0[k].expand(batch + (3, 3))
                p = self._p0[k].expand(batch + (3,))
            frames.append((r, p))
        return frames

    def _rnea(self, frames, qd, qdd, base_acc) -> torch.Tensor:
        """The two RNEA passes on given joint frames; ``qd`` (None: at
        rest), ``qdd`` and ``base_acc`` broadcast against the frames' batch
        axes."""
        cross = _cross
        omega, domega, acc = [], [], []
        for k, jtype in enumerate(self._types):
            p_idx = self._parent[k]
            w_p = omega[p_idx] if p_idx >= 0 else None
            dw_p = domega[p_idx] if p_idx >= 0 else None
            a_p = acc[p_idx] if p_idx >= 0 else base_acc
            r, p = frames[k]
            a_hat = self._a[k]
            w_in = _rot_t(r, w_p)
            dw_in = _rot_t(r, dw_p)
            a_in = _rot_t(r, _add(a_p, cross(dw_p, p), cross(w_p, cross(w_p, p))))
            if jtype == "fixed":
                w, dw, a = w_in, dw_in, a_in
            else:
                qdk = None if qd is None else a_hat * qd[..., self._dof_index[k], None]
                qddk = a_hat * qdd[..., self._dof_index[k], None]
                if jtype == "prismatic":
                    w, dw = w_in, dw_in
                    a = _add(a_in, None if qdk is None else 2.0 * cross(w_in, qdk), qddk)
                else:
                    w = _add(w_in, qdk)
                    dw = _add(dw_in, cross(w_in, qdk), qddk)
                    a = a_in
            omega.append(w)
            domega.append(dw)
            acc.append(a)

        # every link's net force at the COM and moment about the link
        # origin, in the link frame, at once: [..., J, 3]
        om, dom = _stack(omega, self._zero3), _stack(domega, self._zero3)
        c, inertia = self._com_all, self._inertia_all
        a_c = _stack(acc, self._zero3) + cross(dom, c) + cross(om, cross(om, c))
        f = self._mass_col * a_c
        n = _rot(inertia, dom) + cross(om, _rot(inertia, om)) + cross(c, f)

        # backward pass: f_k / n_k = wrench exerted on link k by its parent,
        # at the link-k origin, in the link-k frame; reversed topological
        # order folds every child into its parent after its own children
        f_acc, n_acc = list(f.unbind(-2)), list(n.unbind(-2))
        for k in reversed(range(len(self._joints))):
            r, p = frames[k]
            p_idx = self._parent[k]
            if p_idx >= 0 and self._wrench_used[p_idx]:
                rf = _rot(r, f_acc[k])
                f_acc[p_idx] = f_acc[p_idx] + rf
                n_acc[p_idx] = n_acc[p_idx] + _rot(r, n_acc[k]) + cross(p, rf)
        src = [f_acc[k] if self._types[k] == "prismatic" else n_acc[k] for k in self._act]
        return (_stack(src, self._zero3) * self._act_axes).sum(-1)

    def rnea(self, q, qd, qdd, gravity=GRAVITY) -> torch.Tensor:
        """Inverse dynamics: joint torques/forces ``tau [..., n_dofs]`` such
        that ``M(q) qdd + C(q, qd) qd + g(q) = tau``. Batched over leading
        axes of ``q/qd/qdd``."""
        q = self._t(q)
        return self._rnea(self._joint_frames(q), self._t(qd), self._t(qdd),
                          self._base_acc(gravity)[0])

    # ------------------------------------------------------------------ #
    def gravity_torques(self, q, gravity=GRAVITY) -> torch.Tensor:
        """g(q): torques that statically hold the configuration."""
        z = torch.zeros_like(self._t(q))
        return self.rnea(q, z, z, gravity=gravity)

    def _row_frames(self, q: torch.Tensor):
        """The joint frames of ``q [..., n]`` with an axis for the rows of
        a one-pass mass matrix inserted before the coordinate axes."""
        return [(r.unsqueeze(-3), p.unsqueeze(-2)) for r, p in self._joint_frames(q)]

    def mass_matrix(self, q) -> torch.Tensor:
        """M(q) ``[..., n, n]``: one RNEA pass over the ``n`` unit
        accelerations (no velocity, no gravity), column ``i`` from row ``i``."""
        q = self._t(q)
        tau = self._rnea(self._row_frames(q), None, self._bias_rows[:self.n_dofs], None)
        return tau.mT

    def mass_and_bias(self, q, qd, gravity=GRAVITY):
        """``(M(q) [..., n, n], h(q, qd) [..., n])`` from one RNEA pass of
        ``n + 1`` rows: the unit accelerations of ``mass_matrix`` and the
        bias row (``qd``, zero acceleration, gravity)."""
        q, qd = self._t(q), self._t(qd)
        n = self.n_dofs
        tau = self._rnea(self._row_frames(q), self._bias_mask * qd.unsqueeze(-2),
                         self._bias_rows, self._base_acc(gravity)[1])
        return tau[..., :n, :].mT, tau[..., n, :]

    def bias_forces(self, q, qd, gravity=GRAVITY) -> torch.Tensor:
        """h(q, qd) = C(q, qd) qd + g(q)."""
        z = torch.zeros_like(self._t(q))
        return self.rnea(q, qd, z, gravity=gravity)

    def forward_dynamics(self, q, qd, tau, gravity=GRAVITY) -> torch.Tensor:
        """qdd = M(q)^{-1} (tau - h(q, qd)), the torque-control
        integrator's core."""
        m, h = self.mass_and_bias(q, qd, gravity=gravity)
        return solve_spd(m, self._t(tau) - h)

    # ------------------------------------------------------------------ #
    def _world_frames(self, q):
        """World pose of every joint's child-link frame: rotations and
        origins, lists of ``[..., 3, 3]`` / ``[..., 3]``."""
        q = self._t(q)
        batch = q.shape[:-1]
        world_r, world_p = [], []
        for k, (r, p) in enumerate(self._joint_frames(q)):
            p_idx = self._parent[k]
            pr = world_r[p_idx] if p_idx >= 0 else self._eye3.expand(batch + (3, 3))
            pp = world_p[p_idx] if p_idx >= 0 else self._zero3.expand(batch + (3,))
            world_r.append(pr @ r)
            world_p.append(pp + _rot(pr, p))
        return world_r, world_p

    def link_world_rotations(self, q) -> torch.Tensor:
        """``[..., L, 3, 3]`` world rotation per joint's child link."""
        world_r, _ = self._world_frames(q)
        return torch.stack(world_r, dim=-3)

    def com_positions(self, q) -> torch.Tensor:
        """World-frame COM position of every joint's child link
        ``[..., L, 3]`` (the energy and Lagrangian oracles read it)."""
        world_r, world_p = self._world_frames(q)
        return torch.stack([p + _rot(r, c) for r, p, c in zip(world_r, world_p, self._com_all)],
                           dim=-2)

    def kinetic_energy(self, q, qd) -> torch.Tensor:
        """T = 1/2 qd^T M(q) qd."""
        qd = self._t(qd)
        return 0.5 * torch.einsum("...i,...ij,...j->...", qd, self.mass_matrix(q), qd)

    def potential_energy(self, q, gravity=GRAVITY) -> torch.Tensor:
        """V = -sum_i m_i g . r_com_i."""
        g = self._t(np.asarray(gravity, dtype=np.float64))
        return -torch.einsum("l,...lc,c->...", self._mass_col[:, 0], self.com_positions(q), g)
