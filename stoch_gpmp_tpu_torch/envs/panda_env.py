"""Closed-loop Panda simulation environment, without a physics engine.

PyTorch counterpart of ``stoch_gpmp_tpu/envs/panda_env.py``: the arm
tracks position targets kinematically under its velocity limits (default)
or through the rigid-body dynamics (``physics="dynamics"``: a
computed-torque PD motor over RNEA forward dynamics); spheres in the
``motion_obstacles`` mode integrate and bounce inside their box; and the
contact, goal, reward and trajectory-buffer semantics are the JAX
package's:

- collision = floor contact OR self-collision OR obstacle contact, on the
  92-sphere decomposition of the collision meshes (``contact_model=
  "spheres"``, default) or on link origins plus interpolated forearm points
  (``"points"``), both recorded per step in ``contact_verdicts``;
- success = end-effector within 0.125 m of the current goal;
- reward ``-gain / (dist + eps)``, ``+1e2`` on contact;
- ring-buffer snapshots at t == 1, every 50 steps and on terminal events;
- on a static contact the recorded state is the arm deflected to the
  contact surface (damped least squares along each contact normal, through
  the FK Jacobian by forward-mode dual tensors).

The bookkeeping (joint state, spheres, the contact arithmetic, the buffer)
is numpy on the host; FK, the self-collision field, the interpolated
contact points, the deflection Jacobian and the dynamics run on the
environment's device: the CUDA card unless ``device`` says otherwise. The
planner never steps this environment; it is for closed-loop evaluation.
Also here: ``random_init_static_sphere``, the sphere draw the Panda example
and the success-rate evaluation use for their obstacles.
"""

from __future__ import annotations

import time
from copy import copy
from typing import Union

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from stoch_gpmp_tpu_torch.costs.fields import LinkSelfDistanceField, _interpolate_links
from stoch_gpmp_tpu_torch.envs.objects import Panda, Sphere
from stoch_gpmp_tpu_torch.kinematics.panda_collision import PANDA_COLLISION_SPHERES

BOX_SCALE = 0.3
BOX_CENTER = 0.5
SPHERE_SCALE = {"MIN": 0.08, "MAX": 0.1}
SPHERE_VELOCITY = {"MIN": 0.0, "MAX": 0.1}

_SPHERE_MIN = np.array(
    [BOX_CENTER - 0.6 * BOX_SCALE, -abs(BOX_CENTER - 0.5 * BOX_SCALE), 0.05]
)
_SPHERE_MAX = np.array(
    [BOX_CENTER + 0.6 * BOX_SCALE, abs(BOX_CENTER - 0.5 * BOX_SCALE), 0.5]
)


def random_init_static_sphere(
    scale_min: float,
    scale_max: float,
    base_position_min: np.ndarray,
    base_position_max: np.ndarray,
    base_offset: float,
    rng: np.random.Generator | None = None,
) -> tuple:
    """A random radius in ``[scale_min, scale_max]`` and a position: one
    coordinate (picked at random) interpolated inside the box, the others
    raw ``rng.random()`` draws, x and y given random signs, then every
    coordinate's magnitude clipped to ``[base_offset, base_position_max]``.
    ``rng`` is required: the draws come only from an explicit generator."""
    if rng is None:
        raise TypeError("random_init_static_sphere needs an explicit np.random.Generator")
    alpha_scale = rng.uniform()
    scale = alpha_scale * scale_min + (1 - alpha_scale) * scale_max

    idx = rng.permutation([1, 0, 0])
    base_position = rng.random(3)
    alpha = rng.random(1)
    base_position[idx == 1] = (
        alpha * base_position_min[idx == 1] + (1 - alpha) * base_position_max[idx == 1]
    )
    signs = rng.integers(2, size=2)
    base_position[:-1] *= signs * 2 - 1
    base_position = np.sign(base_position) * np.clip(
        np.abs(base_position), a_min=base_offset, a_max=base_position_max
    )
    return scale, base_position


def update_linear_velocity_sphere(
    base_position: Union[np.ndarray, list],
    base_linear_velocity: Union[np.ndarray, list],
    base_position_min: np.ndarray,
    base_position_max: np.ndarray,
    z_offset: float,
) -> tuple:
    """Bounce a sphere off its min/max box walls and the floor."""
    base_position = np.asarray(base_position, dtype=float)
    base_linear_velocity = np.asarray(base_linear_velocity, dtype=float)
    pos = base_position.copy()
    vel = base_linear_velocity.copy()

    ratios_min = np.abs(base_position) / base_position_min
    ratios_max = np.abs(base_position) / base_position_max
    if np.max(ratios_min) <= 1 or np.max(ratios_max) >= 1:
        if np.max(ratios_min) <= 1:
            idx = int(np.argmin(1 - ratios_min))
            pos[idx] = np.sign(pos[idx]) * base_position_min[idx]
            vel[idx] = -vel[idx]
        else:
            idx = int(np.argmax(ratios_max - 1))
            pos[idx] = np.sign(pos[idx]) * base_position_max[idx]
            vel[idx] = -vel[idx]

    if pos[-1] <= z_offset:
        pos[-1] = z_offset
        vel[-1] = abs(vel[-1])
    return pos, vel


def update_linear_velocity_sphere_simple(
    scale: float,
    base_position: Union[np.ndarray, list],
    base_linear_velocity: Union[np.ndarray, list],
    base_position_min: np.ndarray,
    base_position_max: np.ndarray,
    shift_order: list,
    loc: str = None,
) -> tuple:
    """Quadrant-aware wall bounce, the variant ``PandaEnv.step`` calls.

    ``shift_order = [location, order]``: ``location`` picks the quadrant
    (0=north, 1=east, 2=south, 3=west) and ``order`` its half-band. Quirks
    kept exactly as in the JAX package and the system it mirrors: the
    cross-axis flip probes at east and south test ``pos[1]`` / ``pos[0]``
    for the other axis's flip, and east ``order == 1`` tests
    ``min[1] - scale`` where the clip uses ``max[1] - scale``. All flip
    conditions read the ORIGINAL position; clips likewise apply to it.
    """
    del loc  # unused
    pos0 = np.asarray(base_position, dtype=float)
    vel0 = np.asarray(base_linear_velocity, dtype=float)
    pos, vel = pos0.copy(), vel0.copy()
    mn = np.asarray(base_position_min, dtype=float)
    mx = np.asarray(base_position_max, dtype=float)
    location, order = shift_order

    def bounce(axis, clip_lo, clip_hi, flip_hi=None, hi_idx=None):
        # flip the velocity when the (possibly cross-axis) probe leaves the
        # (possibly different) flip band; clip the position to the band
        flip_hi = clip_hi if flip_hi is None else flip_hi
        hi_idx = axis if hi_idx is None else hi_idx
        if pos0[axis] < clip_lo or pos0[hi_idx] > flip_hi:
            vel[axis] = -vel0[axis]
        pos[axis] = np.clip(pos0[axis], clip_lo, clip_hi)

    neg_half = (mn[1] + scale, -scale)  # [-wall, 0) band along the swept axis
    pos_half = (scale, mx[1] - scale)  # (0, +wall] band
    span = (mn[0] + scale, mx[0] - scale)  # full cross band
    mirrored = (-(mx[0] - scale), -(mn[0] + scale))

    if location == 0:  # north
        bounce(0, *(neg_half if order == 0 else pos_half))
        bounce(1, *span)
    elif location == 1:  # east
        bounce(0, *mirrored, hi_idx=1)  # quirk: probes pos[1] for the flip
        if order == 0:
            bounce(1, *neg_half)
        else:  # quirk: flip band max[1]-scale -> min[1]-scale mismatch
            bounce(1, scale, mx[1] - scale, flip_hi=mn[1] - scale)
    elif location == 2:  # south
        bounce(0, *(pos_half if order == 0 else neg_half))
        bounce(1, *mirrored, hi_idx=0)  # quirk: probes pos[0] for the flip
    else:  # west
        bounce(0, *span)
        bounce(1, *(pos_half if order == 0 else neg_half))
    bounce(2, mn[2] + scale, mx[2] - scale)
    return pos, vel


class PandaEnv:
    """Gym-like closed-loop environment. ``device`` None means the CUDA
    card; the tests pass ``device="cpu"``."""

    def __init__(self, render: bool = False, goal_offset: float = 0.08, *, device=None,
                 **kwargs):
        # ``render=True``: every step records a light frame (arm skeleton,
        # spheres, goal, contact flag); ``render_frame(ax)`` draws one 3D
        # matplotlib view and ``save_animation(path)`` writes the episode as
        # a GIF. ``render="live"`` also redraws a persistent matplotlib 3D
        # figure every ``live_render_every`` steps (interactive backends show
        # it; Agg redraws offscreen). The simulation is the same either way.
        self.render_mode = bool(render)
        self._live_render = render == "live"
        self._live_every = int(kwargs.get("live_render_every", 1))
        self._live_ax = None
        self._frames = []
        self._max_frames = int(kwargs.get("max_render_frames", 2000))
        self._seed = kwargs.get("seed", None)
        self.t_step = 0
        self._t_start = time.time()
        self._t_H = kwargs.get("horizon", 10000)
        self._frequency = kwargs.get("frequency", 10)
        self.realtime = kwargs.get("realtime", False)
        self._dt_sim = kwargs.get("dt_sim", 1.0 / 240.0)

        self.a_t = None
        self.s_t = None
        self._s_T = [None, None]
        self._goal_offset = np.array([0.0, 0.0, goal_offset])
        self._goal_idx = 0
        self.goal_reached = [False, False]
        self.is_contact = False
        self._done = False

        self.num_obst = kwargs.get("num_obst", 2)
        self.max_obs_dist = kwargs.get("max_obs_dist", 0.0)
        self.max_floor_dist = kwargs.get("max_floor_dist", 0.0)
        self.motion_obstacles = kwargs.get("motion_obstacles", 0)
        # quadrant and half-band of the dynamic-sphere bounce
        self.shift = kwargs.get("shift", 0)
        self.order = kwargs.get("order", 0)

        self._buffer_goal_counter = 1
        self._max_buffer_len = int(kwargs.get("buffer_length", 1000))
        self._init_buffer()

        # ``physics="dynamics"``: the position targets drive a computed-torque
        # PD motor over the rigid-body forward dynamics; ``"kinematic"``
        # (default) is the velocity-limited tracker
        physics = kwargs.get("physics", "kinematic")
        if physics not in ("kinematic", "dynamics"):
            raise ValueError(f"unknown physics mode: {physics!r}")
        self.panda = Panda(use_dynamics=(physics == "dynamics"), device=device)
        self.device = self.panda.device
        self._self_field = LinkSelfDistanceField(margin=0.03)
        # the point model checks link origins plus interpolated points along
        # the forearm segments (links 5-7)
        self._contact_interpolate = int(kwargs.get("contact_interpolate", 2))
        self._contact_model = kwargs.get("contact_model", "spheres")
        if self._contact_model not in ("spheres", "points"):
            raise ValueError(f"unknown contact_model: {self._contact_model!r}")

        names = list(self.panda.chain.link_names)
        self._mesh_spheres = []  # (frame idx | None = world/base, centers, radii)
        for frame, sph in PANDA_COLLISION_SPHERES.items():
            idx = names.index(frame) if frame in names else None
            self._mesh_spheres.append((idx, np.asarray(sph[:, :3]), np.asarray(sph[:, 3])))
        # base and link-1 column spheres rest at the floor legitimately
        self._floor_exempt_frames = {None, names.index("panda_link1")}
        # flat per-sphere frame index (-1 = world-fixed base spheres, never
        # deflected) and local centers, for the contact-deflection Jacobians
        self._mesh_sphere_frames = np.concatenate([
            np.full(len(r), -1 if idx is None else idx, dtype=int)
            for idx, _, r in self._mesh_spheres
        ])
        self._mesh_sphere_locals = np.concatenate([c for _, c, _ in self._mesh_spheres])
        # terminal-step contact deflection: the recorded state on a contact
        # step is the arm blocked at the contact, resolved to a linear slop
        # so the contact flag still trips at the defaults
        self._contact_deflection = bool(kwargs.get("contact_deflection", True))
        self._contact_slop = float(kwargs.get("contact_slop", 1e-3))
        self.contact_verdicts = {"spheres": False, "points": False}
        self._obstacles = {"spheres": [], "boxes": []}
        self._rng = np.random.default_rng(self._seed)
        self._init_spheres()

    # ------------------------------------------------------------------ #
    @property
    def buffer(self):
        return self._buffer[: self._buffer_idx]

    @property
    def obstacles(self):
        return self._obstacles

    @property
    def spheres(self):
        return self._obstacles.get("spheres", [])

    @property
    def boxes(self):
        return self._obstacles.get("boxes", [])

    @property
    def done(self):
        return self._done

    @property
    def s_T(self):
        if self._s_T[self._goal_idx] is not None:
            return np.asarray(self._s_T[self._goal_idx])[None, None, :]
        return self._s_T[self._goal_idx]

    def set_goals(self, goals):
        """Set the (up to two) end-effector goal positions."""
        goals = list(goals)
        self._s_T = [np.asarray(g, dtype=float) if g is not None else None for g in goals]
        while len(self._s_T) < 2:
            self._s_T.append(None)

    def seed(self, seed=None):
        self._rng = np.random.default_rng(seed)
        return [seed]

    def not_t_horizon(self):
        if self.realtime:
            return abs(time.time() - self._t_start) < self._t_H
        return self.t_step < self._t_H

    # ------------------------------------------------------------------ #
    def _spawn_sphere_params(self):
        return random_init_static_sphere(
            scale_min=SPHERE_SCALE["MIN"],
            scale_max=SPHERE_SCALE["MAX"],
            base_position_min=_SPHERE_MIN,
            base_position_max=_SPHERE_MAX,
            base_offset=0.0,
            rng=self._rng,
        )

    def _init_spheres(self):
        if self.motion_obstacles == 0:
            roles = np.zeros(self.num_obst, dtype=int)
        elif self.motion_obstacles == 1:
            roles = np.ones(self.num_obst, dtype=int)
        else:
            roles = self._rng.integers(0, 2, size=self.num_obst)
        spheres = []
        for role in roles:
            scale, pos = self._spawn_sphere_params()
            vel = np.zeros(3)
            if role == 1:
                vel = self._rng.uniform(SPHERE_VELOCITY["MIN"], SPHERE_VELOCITY["MAX"], 3)
            spheres.append(Sphere(base_position=pos, base_linear_velocity=vel, scale=scale,
                                  role=int(role)))
        self._obstacles["spheres"] = spheres

    def reset(self, seed=None):
        seed = self._seed if seed is None else seed
        self.seed(seed=seed)
        self.panda.reset()
        for sphere in self.spheres:
            scale, pos = self._spawn_sphere_params()
            sphere.init_base_position = pos
            if sphere.role == 0:
                sphere.init_base_linear_velocity = np.zeros(3)
            else:
                sphere.init_base_linear_velocity = self._rng.uniform(
                    SPHERE_VELOCITY["MIN"], SPHERE_VELOCITY["MAX"], 3)
            sphere.reset()

        obs_state = self._state_obstacles()
        self._goal_idx = 0
        self.goal_reached = [False, False]
        self.is_contact = False
        self._done = False
        self.t_step = 0
        self._t_start = time.time()
        self.s_t = [np.array(self.panda.getJointStates()).reshape(1, 1, -1), obs_state]
        self._init_buffer()
        self._frames = []
        self._record_frame()
        return self.s_t

    def step(self, a_t=None):
        self.t_step += 1
        if a_t is None:
            a_t = np.array(self.panda.q)
        self.panda.setTargetPositions(np.asarray(a_t).squeeze())

        # bounce the dynamic spheres once per env step, before the substeps
        for sphere in self.spheres:
            if sphere.role == 1:
                pos, vel = update_linear_velocity_sphere_simple(
                    scale=sphere.scale,
                    base_position=sphere.base_position,
                    base_linear_velocity=sphere.base_linear_velocity,
                    base_position_min=_SPHERE_MIN,
                    base_position_max=_SPHERE_MAX,
                    shift_order=[self.shift, self.order],
                )
                sphere.base_position, sphere.base_linear_velocity = pos, vel

        dt = self._dt_sim
        for _ in range(self._frequency):
            self.panda.step(dt)
            for sphere in self.spheres:
                if sphere.role == 1:
                    sphere.integrate(dt)
        self._resolve_obstacle_contacts()
        # FK of the (possibly deflected) pose, shared with the contact check
        lp = self._deflect_arm_contacts()

        self.s_t = [
            np.array(self.panda.getJointStates()).reshape(1, 1, -1).copy(),
            self._state_obstacles().copy(),
        ]
        self.a_t = np.asarray(a_t).copy()
        self.is_contact = self._check_contact(link_poses=lp)

        if self.s_T is not None:
            ee_pos, _ = self.panda.getEEPositionAndOrientation()
            dist2goal = float(np.sqrt(np.sum((ee_pos - self.s_T.squeeze()) ** 2)))
            self.goal_reached[self._goal_idx] = dist2goal < 0.125
            if self.goal_reached[0] and self._goal_idx == 0:
                self._goal_idx = 1

        if self.is_contact or all(self.goal_reached):
            self._done = True

        costs = self.cost_function()
        self._update_buffer()
        self._record_frame()
        return (
            self.s_t,
            costs,
            self.done,
            [self.s_T, self.goal_reached, self.is_contact],
        )

    def close(self):
        pass

    # ------------------------------------------------------------------ #
    @property
    def frames(self):
        """Recorded render frames (``render=True`` only)."""
        return self._frames

    def _record_frame(self):
        if not self.render_mode or len(self._frames) >= self._max_frames:
            return
        lp = self.panda.link_poses()
        goal = self.s_T
        self._frames.append({
            "skeleton": lp[:, :3, 3].copy(),
            "spheres": [
                (np.asarray(s.base_position, dtype=float).copy(), float(s.scale),
                 int(s.role or 0))
                for s in self.spheres
            ],
            "goal": None if goal is None else np.asarray(goal).reshape(3).copy(),
            "t": self.t_step,
            "contact": bool(self.is_contact),
            "reached": list(self.goal_reached),
        })
        if self._live_render and self.t_step % self._live_every == 0:
            self._draw_live()

    def _draw_live(self):
        """Redraw the persistent live figure from the latest frame, with
        whatever matplotlib backend is active: interactive backends display
        and update a window via ``plt.pause``; Agg redraws offscreen."""
        import matplotlib.pyplot as plt

        if self._live_ax is None:
            fig = plt.figure(figsize=(6, 6))
            self._live_ax = fig.add_subplot(projection="3d")
            if plt.isinteractive() or plt.get_backend().lower() != "agg":
                plt.ion()
        self._live_ax.cla()
        self.render_frame(ax=self._live_ax)
        fig = self._live_ax.figure
        fig.canvas.draw_idle()
        if plt.get_backend().lower() != "agg":
            plt.pause(1e-3)

    def render_frame(self, ax=None, frame=None):
        """Draw one recorded frame (default: the latest) as a 3D view: arm
        skeleton polyline, obstacle spheres (static red, dynamic dark red),
        current goal star. Returns the axis."""
        import matplotlib.pyplot as plt

        if frame is None:
            if not self._frames:
                raise ValueError("no frames recorded (construct with render=True)")
            frame = self._frames[-1]
        if ax is None:
            fig = plt.figure(figsize=(6, 6))
            ax = fig.add_subplot(projection="3d")
        sk = frame["skeleton"]
        ax.plot(sk[:, 0], sk[:, 1], sk[:, 2], "o-", color="tab:blue", lw=2.5, ms=3)
        u = np.linspace(0, 2 * np.pi, 12)
        v = np.linspace(0, np.pi, 7)
        cu, su = np.cos(u), np.sin(u)
        sv, cv = np.sin(v), np.cos(v)
        for pos, r, role in frame["spheres"]:
            color = (1.0, 0.0, 0.0) if role == 0 else (0.5, 0.0, 0.0)
            ax.plot_surface(
                pos[0] + r * np.outer(cu, sv),
                pos[1] + r * np.outer(su, sv),
                pos[2] + r * np.outer(np.ones_like(u), cv),
                color=color, alpha=0.35, linewidth=0,
            )
        if frame["goal"] is not None:
            g = frame["goal"]
            ax.plot([g[0]], [g[1]], [g[2]], "g*", markersize=12)
        ax.set_xlim(-0.9, 0.9)
        ax.set_ylim(-0.9, 0.9)
        ax.set_zlim(0.0, 1.2)
        ax.set_box_aspect((1, 1, 2.0 / 3.0))
        status = "CONTACT" if frame["contact"] else ("reached" if all(frame["reached"]) else "")
        ax.set_title(f"t={frame['t']} {status}".rstrip())
        return ax

    def save_animation(self, path, fps=20, stride=1):
        """Write the recorded episode as a GIF (``render=True`` episodes)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation, PillowWriter

        frames = self._frames[:: max(1, int(stride))]
        if not frames:
            raise ValueError("no frames recorded (construct with render=True)")
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")

        def draw(i):
            ax.cla()
            self.render_frame(ax=ax, frame=frames[i])

        anim = FuncAnimation(fig, draw, frames=len(frames))
        anim.save(path, writer=PillowWriter(fps=fps))
        plt.close(fig)
        return path

    # ------------------------------------------------------------------ #
    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.panda.dtype, device=self.device)

    def _fk(self, q) -> np.ndarray:
        return self.panda.chain.fk(self._to_device(q)).cpu().numpy()

    def _fk_jacobian(self, q) -> np.ndarray:
        """``d fk(q) / dq`` ``[L, 4, 4, n]`` by forward mode: one FK pass
        on dual tensors over ``n`` copies of ``q``, copy ``k`` carrying the
        tangent ``e_k``."""
        qt = self._to_device(q)
        n = qt.shape[0]
        tangents = torch.eye(n, dtype=qt.dtype, device=qt.device)
        with fwAD.dual_level():
            out = fwAD.unpack_dual(self.panda.chain.fk(fwAD.make_dual(qt.repeat(n, 1),
                                                                      tangents)))
        return out.tangent.permute(1, 2, 3, 0).cpu().numpy()

    def _deflect_arm_contacts(self):
        """Record the arm DEFLECTED by static contacts on a contact step:
        resolve the penetration of the mesh-decomposition collision spheres
        into STATIC obstacle spheres and the floor by damped-least-squares
        joint corrections along each contact normal (deepest contact first,
        up to 8 passes), then remove the joint-velocity component
        approaching each resolved contact. Penetration is resolved to
        ``contact_slop``, so the contact flag (distance below
        ``max_obs_dist``, 0 at the defaults) still trips and the episode
        still ends; only the recorded state changes. Self-collision stays
        flag-only. Dynamic spheres are moved by
        ``_resolve_obstacle_contacts`` instead.

        Returns the link poses of the (possibly deflected) final joint
        state, so the caller's contact check reuses the FK.
        """
        if not self._contact_deflection:
            return self.panda.link_poses()
        static = [s for s in self.spheres if s.role == 0]
        slop = self._contact_slop
        obst = (np.stack([np.concatenate([s.base_position, [s.scale]]) for s in static])
                if static else None)
        q = np.asarray(self.panda.q, dtype=float)
        resolved = []  # (jn [ndof], denom) per handled contact normal
        for _ in range(8):
            link_poses = self._fk(q)
            cw, rw, fmask = self._world_collision_spheres(link_poses)
            movable = self._mesh_sphere_frames >= 0

            # deepest geometric penetration across obstacle + floor contacts
            best = (slop, None, None)  # (pen, sphere idx, normal)
            if obst is not None:
                vec = cw[:, None, :] - obst[None, :, :3]  # away from the obstacle
                dist = np.linalg.norm(vec, axis=-1)
                pen = rw[:, None] + obst[None, :, 3] - dist
                pen[~movable] = -np.inf
                i, j = np.unravel_index(np.argmax(pen), pen.shape)
                if pen[i, j] > best[0] and dist[i, j] > 1e-9:
                    best = (pen[i, j], i, vec[i, j] / dist[i, j])
            pen_floor = rw - cw[:, 2]
            pen_floor[~(fmask & movable)] = -np.inf
            i = int(np.argmax(pen_floor))
            if pen_floor[i] > best[0]:
                best = (pen_floor[i], i, np.array([0.0, 0.0, 1.0]))
            if best[1] is None:
                break

            pen, i, n = best
            jac_all = self._fk_jacobian(q)
            f = int(self._mesh_sphere_frames[i])
            c_loc = self._mesh_sphere_locals[i]
            jc = (np.einsum("abn,b->an", jac_all[f, :3, :3, :], c_loc)
                  + jac_all[f, :3, 3, :])  # [3, ndof]
            jn = n @ jc
            denom = float(jn @ jn) + 1e-8
            q = np.clip(q + jn * ((pen - slop) / denom), self.panda.jl_lower,
                        self.panda.jl_upper)
            resolved.append((jn, denom))

        if not resolved:
            return link_poses  # current with q: no correction was applied
        self.panda.q = q
        if self.panda.gripper:
            m = 0.5 * (self.panda.q[7] + self.panda.q[8])
            self.panda.q[7] = self.panda.q[8] = m
        # inelastic: remove the approach velocity along each resolved normal
        dq = np.asarray(self.panda.dq, dtype=float)
        for jn, denom in resolved:
            vn = float(jn @ dq)
            if vn < 0.0:
                dq = dq - jn * (vn / denom)
        self.panda.dq = dq
        # one more FK so the caller checks the DEFLECTED pose (the loop's
        # last link_poses can be one correction stale on loop exhaustion)
        return self.panda.link_poses()

    def _resolve_obstacle_contacts(self):
        """Keep DYNAMIC spheres from interpenetrating the arm: a penetrating
        sphere is pushed out along the contact normal with its approaching
        velocity removed (inelastic, against an effectively infinitely
        stiff position-controlled arm). Only ``motion_obstacles != 0`` has
        such spheres; the contact flag is unchanged."""
        dyn = [s for s in self.spheres if s.role == 1]
        if not dyn:
            return
        cw, rw, _ = self._world_collision_spheres(self.panda.link_poses())
        for s in dyn:
            vec = s.base_position - cw  # [N, 3] from arm spheres to obstacle
            dist = np.linalg.norm(vec, axis=-1)
            pen = rw + s.scale - dist
            worst = int(np.argmax(pen))
            if pen[worst] > 0.0 and dist[worst] > 1e-9:
                n = vec[worst] / dist[worst]
                s.base_position = s.base_position + n * pen[worst]
                vn = float(np.dot(s.base_linear_velocity, n))
                if vn < 0.0:
                    s.base_linear_velocity = s.base_linear_velocity - vn * n

    def _world_collision_spheres(self, link_poses):
        """Mesh-decomposition spheres in the world frame: ``(centers
        [N, 3], radii [N], floor_check_mask [N])``."""
        cs, rs, fm = [], [], []
        for idx, c, r in self._mesh_spheres:
            if idx is None:
                cs.append(c)
            else:
                h = link_poses[idx]
                cs.append(c @ h[:3, :3].T + h[:3, 3])
            rs.append(r)
            fm.append(np.full(len(r), idx not in self._floor_exempt_frames))
        return np.concatenate(cs), np.concatenate(rs), np.concatenate(fm)

    def _check_contact(self, link_poses=None) -> bool:
        """Contact with the floor, the arm itself or the obstacles, by both
        geometry models (mesh-sphere decomposition and origin points) into
        ``contact_verdicts``; returns the configured one.

        ``link_poses``: precomputed FK of the current joint state; None
        recomputes."""
        if link_poses is None:
            link_poses = self.panda.link_poses()  # [L, 4, 4]
        self_hit = bool(self._self_field.compute_collision(
            self._to_device(link_poses)[None], buffer=0.05)[0])
        obst = (np.stack([np.concatenate([s.base_position, [s.scale]]) for s in self.spheres])
                if self.spheres else None)

        # point model: link origins + interpolated forearm points
        pts_floor = bool(np.any(link_poses[2:, 2, 3] <= self.max_floor_dist))
        pts_obst = False
        if obst is not None:
            pts = link_poses[:, :3, 3]  # [L, 3]
            if self._contact_interpolate > 0:
                pts = _interpolate_links(self._to_device(pts), self._contact_interpolate,
                                         (5, 7)).cpu().numpy()
            d = np.linalg.norm(pts[:, None, :] - obst[None, :, :3], axis=-1) - obst[None, :, 3]
            pts_obst = bool(np.any(d < self.max_obs_dist + 0.02))
        self.contact_verdicts["points"] = pts_floor or self_hit or pts_obst

        # mesh-sphere model: the collision-mesh decomposition
        cw, rw, fmask = self._world_collision_spheres(link_poses)
        sph_floor = bool(np.any(cw[fmask, 2] - rw[fmask] <= self.max_floor_dist))
        sph_obst = False
        if obst is not None:
            d = (np.linalg.norm(cw[:, None, :] - obst[None, :, :3], axis=-1)
                 - rw[:, None] - obst[None, :, 3])
            sph_obst = bool(np.any(d < self.max_obs_dist))
        self.contact_verdicts["spheres"] = sph_floor or self_hit or sph_obst

        return self.contact_verdicts[self._contact_model]

    def cost_function(self) -> np.ndarray:
        gain = 1e2
        eps = 1e-6
        if self.s_T is None:
            return np.asarray(0.0)
        ee_position = self.panda.getEEPositionAndOrientation()[0]
        dist2goal = np.sqrt(np.sum((ee_position - self.s_T.squeeze()) ** 2))
        costs = -gain / (dist2goal + eps)
        return np.where(self.is_contact, np.ones_like(costs) * 1e2, costs)

    def _state_obstacles(self) -> np.ndarray:
        if not self.spheres:
            return np.zeros((1, 0, 7))
        return np.concatenate(
            (
                np.array([s.base_position for s in self.spheres]),
                np.array([s.base_linear_velocity for s in self.spheres]),
                np.array([s.scale for s in self.spheres])[:, None],
            ),
            axis=-1,
        )[None, :]

    # --- trajectory ring buffer --------------------------------------- #
    def _init_buffer(self):
        self._buffer_idx = 0
        self._buffer = [dict() for _ in range(self._max_buffer_len)]

    def _snapshot(self, t):
        return {
            "s_robot": self.s_t[0].copy(),
            "a_robot": self.a_t.copy() if self.a_t is not None else None,
            "s_obs": self.s_t[1].copy(),
            "s_goal": self.s_T.copy() if self.s_T is not None else None,
            "is_contact": copy(self.is_contact),
            "goal_reached": copy(self.goal_reached),
            "time_horizon": copy(not self.not_t_horizon()),
            "time": t,
        }

    def _update_buffer(self):
        if self.t_step == 1:
            self._buffer[self._buffer_idx].update(self._snapshot(self.t_step - 1))
            self._buffer_idx += 1
        if self.t_step % 50 == 0:
            self._buffer[self._buffer_idx].update(self._snapshot(self.t_step))
            self._buffer_idx += 1
        if (
            self.is_contact
            or (sum(self.goal_reached) == self._buffer_goal_counter)
            or not self.not_t_horizon()
        ):
            self._buffer[self._buffer_idx].update(self._snapshot(self.t_step))
            self._buffer_idx += 1
            if sum(self.goal_reached) == self._buffer_goal_counter:
                self._buffer_goal_counter += 1
        if self._buffer_idx >= self._max_buffer_len:
            self._buffer_idx = 0
