"""Simulation bodies: spheres and the Panda arm, without a physics engine.

PyTorch counterpart of ``stoch_gpmp_tpu/envs/objects.py``. The bodies are
state containers whose bookkeeping (joint positions and velocities, sphere
poses and velocities) stays numpy on the host, as in the JAX package. What
the JAX package runs through ``jnp`` / ``jax.jit`` runs on the Panda's
device here: FK (``link_poses``, the end-effector pose), IK, inverse
dynamics and the dynamics steppers.

The steppers (computed-torque PD position control and torque control over
the rigid-body dynamics of ``kinematics/dynamics.py``) are built once per
gain and limit set and shared across ``Panda`` instances. On the CUDA card
each substep is one captured ``torch.cuda.CUDAGraph`` replayed with ``dt``
and the state in a static input buffer; on the CPU it runs eagerly.
Dynamics run in float64, what the JAX package computes under its tests'
x64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from stoch_gpmp_tpu_torch.kinematics.dynamics import solve_spd
from stoch_gpmp_tpu_torch.kinematics.ik import solve_ik_multistart
from stoch_gpmp_tpu_torch.kinematics.panda_model import franka_panda, panda_dynamics
from stoch_gpmp_tpu_torch.kinematics.se3 import (
    homogeneous,
    matrix_to_quaternion,
    quaternion_to_matrix,
)
from stoch_gpmp_tpu_torch.utils.device import resolve_device


class BodyCore:
    """Pose state of a rigid body: position and quaternion ``[x, y, z, w]``."""

    def __init__(self, base_position, base_orientation=(0.0, 0.0, 0.0, 1.0)):
        self.init_base_position = np.asarray(base_position, dtype=float)
        self.init_base_orientation = np.asarray(base_orientation, dtype=float)
        self.reset()

    def reset(self):
        self.base_position = self.init_base_position.copy()
        self.base_orientation = self.init_base_orientation.copy()


class DynamicBodyCore(BodyCore):
    """Adds linear and angular velocity."""

    def __init__(
        self,
        base_position=(0.0, 0.0, 0.0),
        base_orientation=(0.0, 0.0, 0.0, 1.0),
        base_linear_velocity=(0.0, 0.0, 0.0),
        base_angular_velocity=(0.0, 0.0, 0.0),
    ):
        self.init_base_linear_velocity = np.asarray(base_linear_velocity, dtype=float)
        self.init_base_angular_velocity = np.asarray(base_angular_velocity, dtype=float)
        super().__init__(base_position, base_orientation)

    def reset(self):
        super().reset()
        self.base_linear_velocity = self.init_base_linear_velocity.copy()
        self.base_angular_velocity = self.init_base_angular_velocity.copy()


class Sphere(DynamicBodyCore):
    """Sphere obstacle with radius ``scale`` and a static (0) or dynamic
    (1) ``role``."""

    def __init__(self, base_position, base_linear_velocity=(0.0, 0.0, 0.0),
                 scale=0.1, role=0):
        self.scale = float(scale)
        self.role = int(role)
        super().__init__(base_position=base_position, base_linear_velocity=base_linear_velocity)

    def integrate(self, dt: float):
        self.base_position = self.base_position + self.base_linear_velocity * dt


@functools.lru_cache(maxsize=4)
def _shared_panda_dynamics(gripper: bool = False, device: str = "cuda"):
    return panda_dynamics(gripper=gripper, dtype=torch.float64, device=device)


GEAR_MAX_FORCE = 50.0  # the finger gear constraint's maxForce
GEAR_ERP = 0.1  # and its error reduction
_FINGER_MASS = 0.1  # kg (prismatic => effective inertia)


class _GraphStep:
    """One substep ``step(q, dq, u, dt) -> (q2, dq2)`` as a captured CUDA
    graph: the state, the control ``u`` and ``dt`` go into one static
    input buffer (one copy from pinned host memory), the graph replays, and
    ``[q2, dq2]`` comes back in one copy. Captured on the first call, from
    that call's inputs; a capture that fails raises."""

    def __init__(self, step, n: int, dtype, device: torch.device):
        self._step, self.n, self.device = step, n, device
        self._in = torch.zeros(3 * n + 1, dtype=dtype, device=device)
        self._host_in = torch.zeros(3 * n + 1, dtype=dtype).pin_memory()
        self._host_out = torch.zeros(2 * n, dtype=dtype).pin_memory()
        self._graph = None
        self._out = None

    def _run(self) -> torch.Tensor:
        n = self.n
        q, dq, u, dt = self._in[:n], self._in[n:2 * n], self._in[2 * n:3 * n], self._in[3 * n]
        return torch.cat(self._step(q, dq, u, dt))

    def _capture(self):
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):  # warm-up: library handles, workspaces
            self._run()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self._graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self._graph):
            self._out = self._run()

    def __call__(self, q, dq, u, dt: float):
        n = self.n
        buf = self._host_in.numpy()
        buf[:n], buf[n:2 * n], buf[2 * n:3 * n], buf[3 * n] = q, dq, u, dt
        self._in.copy_(self._host_in, non_blocking=True)
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self._host_out.copy_(self._out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        out = self._host_out.numpy().copy()
        return out[:n], out[n:]


class _Steppers:
    """The computed-torque-PD and torque-mode substeps of one gain and limit
    set: ``pd_eager(q, dq, q_target, dt)`` and ``tau_eager(q, dq, tau, dt)``
    on tensors of the dynamics' device (batched over leading axes), and
    ``pd_step`` / ``tau_step`` on numpy states, one CUDA graph each on the
    card, eager on the CPU.

    With ``gripper=True`` (9 DOF) both substeps couple the finger joints by
    a velocity-level gear constraint after integration: the relative finger
    velocity is driven to zero plus an ERP positional correction, by an
    impulse capped at ``GEAR_MAX_FORCE * dt``. (A stiff coupling force is
    unstable against the velocity clamp at 240 Hz.)"""

    def __init__(self, kp, kd, effort, vel, lo, hi, gripper, device: torch.device):
        self.dyn = dyn = _shared_panda_dynamics(gripper, str(device))
        t = dyn._t
        self.kp, self.kd = float(kp), float(kd)
        self.effort, self.vel, self.lo, self.hi = t(effort), t(vel), t(lo), t(hi)
        self.gripper = gripper
        self.device = device
        n = dyn.n_dofs
        # the gear impulse's direction: +1 on finger 7, -1 on finger 8
        self._gear = t(np.r_[np.zeros(n - 2), 1.0, -1.0]) if gripper else None
        if device.type == "cuda":
            self.pd_step = _GraphStep(self.pd_eager, n, dyn.dtype, device)
            self.tau_step = _GraphStep(self.tau_eager, n, dyn.dtype, device)
        else:
            self.pd_step = functools.partial(self._on_host, self.pd_eager)
            self.tau_step = functools.partial(self._on_host, self.tau_eager)

    def _on_host(self, step, q, dq, u, dt: float):
        t = self.dyn._t
        q2, dq2 = step(t(q), t(dq), t(u), t(dt))
        return q2.numpy(), dq2.numpy()

    def _integrate(self, q, dq, qdd, dt):
        dq2 = torch.clamp(dq + qdd * dt, -self.vel, self.vel)
        if self.gripper:
            c = q[..., 7] - q[..., 8]  # drive q7 - q8 -> 0 (fingers symmetric)
            cdot = dq2[..., 7] - dq2[..., 8]
            mu = _FINGER_MASS / 2.0  # reduced mass of the two fingers
            j = torch.clamp(mu * (-cdot - GEAR_ERP * c / dt),
                            -GEAR_MAX_FORCE * dt, GEAR_MAX_FORCE * dt)
            dq2 = torch.clamp(dq2 + self._gear * (j / _FINGER_MASS)[..., None],
                              -self.vel, self.vel)
        q2 = torch.clamp(q + dq2 * dt, self.lo, self.hi)
        return q2, dq2

    def tau_eager(self, q, dq, tau, dt):
        """Semi-implicit Euler under the torques ``tau``:
        ``qdd = M(q)^{-1} (tau - h(q, dq))``."""
        m, h = self.dyn.mass_and_bias(q, dq)
        return self._integrate(q, dq, solve_spd(m, tau - h), dt)

    def pd_eager(self, q, dq, q_target, dt):
        """Computed-torque PD: ``tau = M(q) (kp e - kd dq) + h(q, dq)``,
        clamped to the effort limits, then forward dynamics under the
        clamp."""
        m, h = self.dyn.mass_and_bias(q, dq)
        qdd_des = self.kp * (q_target - q) - self.kd * dq
        tau = torch.clamp((m @ qdd_des.unsqueeze(-1)).squeeze(-1) + h, -self.effort, self.effort)
        return self._integrate(q, dq, solve_spd(m, tau - h), dt)


@functools.lru_cache(maxsize=8)
def _panda_integrators(kp, kd, effort, vel, lo, hi, gripper=False, device="cuda"):
    """The :class:`_Steppers` of one gain and limit set on ``device``,
    shared across ``Panda`` instances (each CUDA graph is captured once)."""
    return _Steppers(kp, kd, effort, vel, lo, hi, gripper, torch.device(device))


class Panda:
    """Panda arm: joint state, velocity-limited position tracking (or
    computed-torque PD over the rigid-body dynamics with
    ``use_dynamics=True``), torque control, FK-backed end-effector pose and
    multi-start IK.

    ``dtype`` is FK's and IK's, float64 by default; the dynamics run in
    float64. ``device`` None means the CUDA card; the joint state stays
    numpy on the host."""

    HOME = np.asarray([0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785])
    HOME_FINGERS = np.asarray([0.04, 0.04])  # open

    def __init__(self, dtype=None, use_dynamics: bool = False,
                 kp: float = 400.0, kd: float | None = None,
                 gripper: bool = False, *, device=None):
        self.device = resolve_device(device)
        self.dtype = torch.float64 if dtype is None else dtype
        # ``gripper=True``: the 9-DOF variant (two prismatic fingers), coupled
        # by the gear constraint of ``_Steppers`` in dynamics and torque mode
        # and held symmetric (its infinite-stiffness limit) in kinematic mode
        self.gripper = bool(gripper)
        self.chain = franka_panda(dtype=self.dtype, gripper=gripper)
        self.dof = self.chain.n_dofs
        self.jl_lower = self.chain.limits_lower.numpy()
        self.jl_upper = self.chain.limits_upper.numpy()
        self.velocity_limit = self.chain.limits_velocity.numpy()
        # effort limits: 87 Nm joints 1-4, 12 Nm 5-7, 20 N fingers
        self.effort_limit = np.array([87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0])
        if gripper:
            self.effort_limit = np.concatenate([self.effort_limit, [20.0, 20.0]])
        # position control through the rigid-body dynamics: a computed-torque
        # PD motor, critically damped by default
        self.use_dynamics = bool(use_dynamics)
        self.kp = float(kp)
        self.kd = float(kd) if kd is not None else 2.0 * float(np.sqrt(kp))
        self._steppers = None
        self.reset()

    @property
    def dynamics(self):
        return _shared_panda_dynamics(self.gripper, str(self.device))

    def reset(self, q=None):
        if q is None:
            q = np.concatenate([self.HOME, self.HOME_FINGERS]) if self.gripper else self.HOME
        self.q = np.asarray(q, dtype=float).copy()
        self.dq = np.zeros(self.dof)
        self.target_joint_positions = self.q.copy()
        self.target_torques = np.zeros(self.dof)
        self.control_mode = "position"

    def setTargetPositions(self, target_joint_positions):
        t = np.asarray(target_joint_positions, dtype=float).reshape(-1)[: self.dof]
        self.target_joint_positions = np.clip(t, self.jl_lower, self.jl_upper)
        self.control_mode = "position"

    def setTargetTorques(self, target_torques):
        """Torque control: subsequent ``step`` calls integrate the forward
        dynamics under these clamped joint torques."""
        t = np.asarray(target_torques, dtype=float).reshape(-1)[: self.dof]
        self.target_torques = np.clip(t, -self.effort_limit, self.effort_limit)
        self.control_mode = "torque"

    def step(self, dt: float):
        if self.control_mode == "torque":
            return self._step_torque(dt)
        if self.use_dynamics:
            return self._step_position_dynamics(dt)
        # first-order tracking toward the target under velocity limits
        err = self.target_joint_positions - self.q
        max_step = self.velocity_limit * dt
        dq = np.clip(err, -max_step, max_step)
        self.q = self.q + dq
        self.dq = dq / dt if dt > 0 else np.zeros_like(dq)
        if self.gripper:
            # infinite-stiffness limit of the finger gear constraint
            m = 0.5 * (self.q[7] + self.q[8])
            self.q[7] = self.q[8] = m

    def _integrators(self) -> _Steppers:
        """The shared steppers of this gain and limit set."""
        if self._steppers is None:
            self._steppers = _panda_integrators(
                self.kp, self.kd, tuple(self.effort_limit), tuple(self.velocity_limit),
                tuple(self.jl_lower), tuple(self.jl_upper), gripper=self.gripper,
                device=str(self.device))
        return self._steppers

    def _advance(self, step, u, dt: float):
        q, dq = step(self.q, self.dq, u, dt)
        if not (np.isfinite(q).all() and np.isfinite(dq).all()):
            raise FloatingPointError(f"non-finite joint state after a dynamics substep: "
                                     f"q {q}, dq {dq}")
        self.q, self.dq = q, dq

    def _step_position_dynamics(self, dt: float):
        """Computed-torque PD position motor over the forward dynamics."""
        self._advance(self._integrators().pd_step, self.target_joint_positions, dt)

    def _step_torque(self, dt: float):
        """Semi-implicit Euler under the commanded torques:
        ``qdd = M(q)^{-1}(tau - h(q, qd))`` via RNEA."""
        self._advance(self._integrators().tau_step, self.target_torques, dt)

    def getJointStates(self):
        return list(self.q), list(self.dq)

    def _q(self) -> torch.Tensor:
        return torch.as_tensor(self.q, dtype=self.dtype, device=self.device)

    def link_poses(self) -> np.ndarray:
        return self.chain.fk(self._q()).cpu().numpy()

    def getEEPositionAndOrientation(self):
        ee = self.chain.ee_pose(self._q())
        out = torch.cat([ee[:3, 3], matrix_to_quaternion(ee[:3, :3])]).cpu().numpy()
        return out[:3], out[3:]

    def solveInverseDynamics(self, pos, vel, acc):
        """Joint torques realising ``acc`` at state ``(pos, vel)`` under
        gravity, by the batched RNEA in float64."""
        n = self.dof
        tau = self.dynamics.rnea(np.asarray(pos, dtype=np.float64)[..., :n],
                                 np.asarray(vel, dtype=np.float64)[..., :n],
                                 np.asarray(acc, dtype=np.float64)[..., :n])
        return list(tau.cpu().numpy())

    def solveInverseKinematics(self, pos, ori=None, seed: int = 0, *, starts=None):
        """IK to a position (and a quaternion ``[x, y, z, w]``, else the
        current orientation): :func:`solve_ik_multistart` from 16 starts
        plus the current ``q``, 150 iterations, in float64. The starts come
        from a ``torch.Generator`` seeded with ``seed`` on the Panda's
        device, or from ``starts`` (``[16, dof]`` in ``[0, 1)``, as
        :func:`solve_ik_multistart` takes them)."""
        f64, dev = torch.float64, self.device
        pos = torch.as_tensor(np.asarray(pos, dtype=np.float64), dtype=f64, device=dev)
        if ori is not None:
            rot = quaternion_to_matrix(torch.as_tensor(np.asarray(ori, dtype=np.float64),
                                                       dtype=f64, device=dev))
        else:  # keep the current orientation
            rot = self.chain.ee_pose(self._q())[:3, :3].to(f64)
        q = solve_ik_multistart(
            self.chain, homogeneous(rot, pos), torch.Generator(device=dev).manual_seed(seed),
            num_starts=16, q_init=self._q(), num_iters=150,
            starts=None if starts is None else torch.as_tensor(starts, dtype=f64, device=dev),
        )
        return list(q.cpu().numpy())
