"""The port's workloads, built natively (no JAX).

- ``build_planar_problem``: counterpart of
  ``__graft_entry__._build_problem(fast=True)``, the reference's
  ``examples/planar_environment.py`` at 3 goals x 5 particles per goal,
  T = 64, 2 DOF, 15 random obstacles from ``generate_obstacle_map(rng=0)``,
  with ``CostComposite([QuadraticCost, CostCollision(RasterPrimitive2DField)])``.
  ``sigma_goal_prior`` is the goal anchor of the cost (1e-3 gives weights of
  1e6, the matmul quadratic; 1e-5 gives 1e10 and the stencil quadratic).
  ``fast=False`` builds the reference-shaped stack of that example run
  without ``--fast``: ``CostComposite([CostGP, CostGoalPrior,
  CostCollision(field)])``, with ``field`` the occupancy grid
  (``"grid"``, ``ObstacleMap.as_field()``, kernel K10, the example's field),
  the analytic primitives (``"primitive"``, ``Primitive2DField``, K11) or the
  raster field (``"raster"``, K1).
- ``build_long_horizon_problem``: counterpart of ``benchmarks/long_horizon.py
  _problem``, the long-horizon planar workload: 1 goal x 15 particles, 32
  samples, T = 1024 or 4096, ``CostComposite([CostGP, CostGoalPrior,
  CostCollision(RasterPrimitive2DField)])`` over the parity map, and a
  sampling prior without the dense factor (the parallel-in-time solver).
- ``build_planar_gpmp_problem``: ``examples/planar_gpmp.py``, Gauss-Newton
  ``GPMP`` on 2 goals x ``ppg`` particles, T = 64, dt = 0.05, 10 random
  obstacles from ``generate_obstacle_map(rng=seed)``, with
  ``CostComposite([CostGP, CostGoalPrior, CostCollision(grid)])``.
- ``build_panda_problem``: counterpart of ``benchmarks/run.py
  _panda_problem``, the Panda 7-DOF problem with the same start, goals and
  obstacle spheres from ``numpy.random.default_rng(0)``. ``fast=True``
  builds the fast stack ``CostComposite([QuadraticCost, PlaneFieldsCost])``;
  ``fast=False`` the reference-shaped stack of
  ``examples/panda_environment.py``: ``CostGP``, ``CostGoalPrior``, the
  self and obstacle ``CostCollision``s and ``CostGoal(EESE3DistanceField)``
  on the link poses of ``fk=chain.fk_compact``. The defaults are config 4
  (1 goal x 5 particles, T = 64, 32 samples); config 5 is 10 goals x 128
  particles, T = 128, 8 samples.
- ``build_long_horizon_gpmp``: Gauss-Newton ``GPMP`` on the long-horizon
  stack, ``benchmarks/long_horizon.py gn_bench``'s problem.
- ``build_panda_example``: ``examples/panda_environment.py`` (its IK goal,
  ``panda_ik_goal``; its spheres, ``panda_spheres``; ``StochGPMP`` on the
  reference-shaped or the fast stack).
- ``build_panda_mesh``: ``benchmarks/success_rate_panda.py``'s planning
  problem on the mesh-sphere fields, with its "clean" rule
  (``panda_mesh_clean``).
- ``build_panda_gpmp``: Gauss-Newton ``GPMP`` on the Panda through FK.

``device=None`` means the CUDA card (raises without one); pass
``device="cpu"`` to build on the CPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from stoch_gpmp_tpu_torch.utils.device import resolve_device

START = [-9.0, -9.0, 0.0, 0.0]
GOALS = [[9.0, 6.0, 0.0, 0.0], [9.0, -3.0, 0.0, 0.0], [-3.0, 9.0, 0.0, 0.0]]
DT = 0.02
# the sampling prior's sigmas: (start, gp, goal)
SAMPLE_SIGMAS = (1e-3, 3.0, 1e-3)


def _planar_field(kind, obst_map, obst_list, dtype, device):
    """The collision field of a planar map: ``"raster"``, ``"grid"`` or
    ``"primitive"``."""
    from stoch_gpmp_tpu_torch.costs import Primitive2DField, RasterPrimitive2DField

    if kind == "raster":
        return RasterPrimitive2DField.from_map(obst_map, obst_list, dtype=dtype, device=device)
    if kind == "grid":
        return obst_map.as_field()
    if kind == "primitive":
        return Primitive2DField.from_obstacles(obst_list, dtype=dtype, device=device)
    raise ValueError(f"unknown planar field {kind!r}: raster, grid or primitive")


def build_planar_cost(traj_len=64, dtype=torch.float32, device=None,
                      with_obstacles=True, sigma_goal_prior=1e-3, *, fast=True, field=None):
    """The parity cost stack; returns ``(cost, field_or_None)``. ``fast``:
    the fused quadratic, else the reference-shaped ``CostGP`` +
    ``CostGoalPrior``; ``field``: ``"raster"`` (the default with ``fast``),
    ``"grid"`` (the default without) or ``"primitive"``."""
    device = resolve_device(device)
    from stoch_gpmp_tpu_torch.costs import (
        CostCollision,
        CostComposite,
        CostGP,
        CostGoalPrior,
        QuadraticCost,
    )
    from stoch_gpmp_tpu_torch.envs import generate_obstacle_map

    n_dof = 2
    cost_gp = CostGP.create(
        n_dof, traj_len, START, DT, {"sigma_start": 0.001, "sigma_gp": 0.1},
        dtype=dtype, device=device,
    )
    cost_goal = CostGoalPrior.create(
        n_dof, traj_len, GOALS, sigma_goal_prior=sigma_goal_prior, dtype=dtype,
        device=device,
    )
    costs = ([QuadraticCost.from_gp_and_goal_prior(cost_gp, cost_goal, traj_len)] if fast
             else [cost_gp, cost_goal])
    coll_field = None
    if with_obstacles:
        obst_map, obst_list = generate_obstacle_map(
            map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
            rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2],
            rng=0, dtype=dtype, device=device,
        )
        kind = field or ("raster" if fast else "grid")
        coll_field = _planar_field(kind, obst_map, obst_list, dtype, device)
        costs.append(CostCollision.create(n_dof, traj_len, coll_field, sigma_coll=1e-5))
    return CostComposite.create(n_dof, traj_len, costs), coll_field


def build_planar_problem(traj_len=64, ppg=5, dtype=torch.float32, device=None,
                         with_obstacles=True, sigma_goal_prior=1e-3, seed=0, *,
                         fast=True, field=None):
    """``(sampler, cost, state)`` of the parity workload; the state's means
    are the straight start-to-goal lines, ``ppg`` per goal, and its
    generator is seeded with ``seed``. ``fast``, ``field``: the cost stack
    (:func:`build_planar_cost`)."""
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
    from stoch_gpmp_tpu_torch.planners import SamplerModel, StochGPMPState

    device = resolve_device(device)
    cost, _ = build_planar_cost(traj_len, dtype, device, with_obstacles, sigma_goal_prior,
                                fast=fast, field=field)
    s_start, s_gp, s_goal = SAMPLE_SIGMAS
    prior = make_gp_prior(
        2, traj_len, DT, START, s_start, s_gp, sigma_goal=s_goal,
        goal_states=GOALS, dtype=dtype, device=device,
    )
    state = StochGPMPState(
        particle_means=prior.means.repeat_interleave(ppg, dim=0),
        generator=torch.Generator(device=device).manual_seed(seed),
    )
    return SamplerModel.from_prior(prior), cost, state


# benchmarks/long_horizon.py: one goal, 15 particles x 32 samples,
# temperature 1.0, step 0.5
LONG_HORIZON_GOALS = [[9.0, 6.0, 0.0, 0.0]]
LONG_HORIZON = dict(particles=15, num_samples=32, temperature=1.0, step_size=0.5)


def build_long_horizon_problem(traj_len, with_obstacles=True, dtype=torch.float32,
                               device=None, seed=0):
    """``(sampler, cost, state)`` of ``benchmarks/long_horizon.py _problem``:
    start ``START``, goal ``LONG_HORIZON_GOALS``, ``CostGP(sigma_start 1e-3,
    sigma_gp 0.1)``, ``CostGoalPrior(1e-3)`` and, ``with_obstacles``,
    ``CostCollision(RasterPrimitive2DField, sigma_coll=1e-5)`` over the 15
    obstacles of ``generate_obstacle_map(rng=0)``; the sampling prior
    ``make_gp_prior(2, T, 0.02, START, 1e-3, 3.0, sigma_goal=1e-3,
    materialize_dense=False)`` (the parallel-in-time solver at every
    horizon); the means its straight line, once per particle
    (``LONG_HORIZON["particles"]``); the generator seeded with ``seed``."""
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
    from stoch_gpmp_tpu_torch.planners import SamplerModel, StochGPMPState

    device = resolve_device(device)
    t = traj_len
    prior = make_gp_prior(2, t, DT, START, 1e-3, 3.0, sigma_goal=1e-3,
                          goal_states=LONG_HORIZON_GOALS, dtype=dtype, device=device,
                          materialize_dense=False)
    state = StochGPMPState(
        particle_means=prior.means.repeat(LONG_HORIZON["particles"], 1, 1),
        generator=torch.Generator(device=device).manual_seed(seed),
    )
    return (SamplerModel.from_prior(prior), _long_horizon_cost(t, with_obstacles, dtype, device),
            state)


def _long_horizon_cost(t, with_obstacles, dtype, device):
    """``benchmarks/long_horizon.py _problem``'s stack: ``CostGP(1e-3,
    0.1)``, ``CostGoalPrior(1e-3)`` and, ``with_obstacles``, the raster
    field of ``generate_obstacle_map(rng=0)`` at ``sigma_coll=1e-5``."""
    from stoch_gpmp_tpu_torch.costs import CostCollision, CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu_torch.envs import generate_obstacle_map

    costs = [
        CostGP.create(2, t, START, DT, {"sigma_start": 1e-3, "sigma_gp": 0.1},
                      dtype=dtype, device=device),
        CostGoalPrior.create(2, t, LONG_HORIZON_GOALS, sigma_goal_prior=1e-3, dtype=dtype,
                             device=device),
    ]
    if with_obstacles:
        obst_map, obst_list = generate_obstacle_map(
            map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
            rand_limits=[[-7.5, 7.5]] * 2, rand_rect_shape=[2, 2], rng=0,
            dtype=dtype, device=device,
        )
        field = _planar_field("raster", obst_map, obst_list, dtype, device)
        costs.append(CostCollision.create(2, t, field, sigma_coll=1e-5))
    return CostComposite.create(2, t, costs)


def build_long_horizon_gpmp(traj_len=1024, *, method="cholesky", with_obstacles=True,
                            particles=None, delta=None, dtype=torch.float32, device=None,
                            seed=0):
    """Gauss-Newton ``GPMP`` on ``benchmarks/long_horizon.py gn_bench``'s
    problem: the stack of :func:`build_long_horizon_problem`, 1 goal x
    ``particles`` (default ``LONG_HORIZON["particles"]``, 15), step 0.5,
    ``delta`` 10 at ``traj_len >= 512`` and 1e-2 below (``gn_bench``'s
    default), no trust region, ``method`` the solve (``cholesky``,
    ``inverse`` or ``woodbury``). The initial means are the planner's own
    draw from the init prior at the cost's sigmas (1e-3, 0.1, 1e-3): past M
    = 2048 the parallel-in-time solver (S1 on the card) draws them, by the
    generator seeded with ``seed``. The sampling prior is
    :func:`build_long_horizon_problem`'s."""
    from stoch_gpmp_tpu_torch.planners import GPMP

    device = resolve_device(device)
    if delta is None:
        delta = 10.0 if traj_len >= 512 else 1e-2
    return GPMP(
        num_particles_per_goal=particles or LONG_HORIZON["particles"], traj_len=traj_len,
        opt_iters=1, dt=DT, n_dof=2, step_size=0.5, start_state=START,
        multi_goal_states=LONG_HORIZON_GOALS,
        cost=_long_horizon_cost(traj_len, with_obstacles, dtype, device),
        sigma_start_init=1e-3, sigma_goal_init=1e-3, sigma_gp_init=0.1,
        sigma_start_sample=1e-3, sigma_goal_sample=1e-3, sigma_gp_sample=3.0,
        solver_params={"delta": delta, "trust_region": False, "method": method},
        seed=seed, dtype=dtype, device=device,
    )


GPMP_GOALS = [[9.0, 6.0, 0.0, 0.0], [9.0, -3.0, 0.0, 0.0]]
GPMP_DT = 0.05


def build_planar_gpmp_problem(ppg=3, *, method="cholesky", traj_len=64, dtype=torch.float32,
                              device=None, seed=0, initial_particle_means=None):
    """The ``GPMP`` planner of ``examples/planar_gpmp.py``: start ``START``,
    the goals ``GPMP_GOALS``, ``ppg`` particles per goal, a 20 x 20 map at
    cell 0.1 with 10 random obstacles from ``rng=seed``, ``CostGP(0.01,
    0.5)``, ``CostGoalPrior(0.01)``, ``CostCollision(obst_map.as_field(),
    0.05)``, step 0.3, ``delta`` 1e-2 without trust region, ``method`` the
    solve (``cholesky``, ``inverse`` or ``woodbury``). The initial means are
    drawn from the init prior (sigmas 0.01 / 5.0 / 0.01) by the planner's
    generator (seeded with ``seed``) unless ``initial_particle_means`` is
    given."""
    from stoch_gpmp_tpu_torch.costs import CostCollision, CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu_torch.envs import generate_obstacle_map
    from stoch_gpmp_tpu_torch.planners import GPMP

    device = resolve_device(device)
    n_dof = 2
    obst_map, _ = generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=10,
        rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2],
        rng=seed, dtype=dtype, device=device,
    )
    cost = CostComposite.create(n_dof, traj_len, [
        CostGP.create(n_dof, traj_len, START, GPMP_DT, {"sigma_start": 0.01, "sigma_gp": 0.5},
                      dtype=dtype, device=device),
        CostGoalPrior.create(n_dof, traj_len, GPMP_GOALS, sigma_goal_prior=0.01, dtype=dtype,
                             device=device),
        CostCollision.create(n_dof, traj_len, obst_map.as_field(), sigma_coll=0.05),
    ])
    return GPMP(
        num_particles_per_goal=ppg, traj_len=traj_len, opt_iters=1, dt=GPMP_DT, n_dof=n_dof,
        step_size=0.3, start_state=START, multi_goal_states=GPMP_GOALS,
        initial_particle_means=initial_particle_means, cost=cost,
        sigma_start_init=0.01, sigma_goal_init=0.01, sigma_gp_init=5.0,
        sigma_start_sample=0.01, sigma_goal_sample=0.01, sigma_gp_sample=0.5,
        solver_params={"delta": 1e-2, "trust_region": False, "method": method},
        seed=seed, dtype=dtype, device=device,
    )


PANDA_START_Q = [0.012, -0.57, 0.0, -2.81, 0.0, 3.037, 0.741]
PANDA_DT = 0.05
# the sampling prior's sigmas: (start, gp, goal)
PANDA_SAMPLE_SIGMAS = (0.001, 0.1, 0.07)


def build_panda_problem(num_goals=1, ppg=5, traj_len=64, num_samples=32, *,
                        dtype=torch.float32, device=None, seed=0, fast=True):
    """``(sampler, cost, state, observation, num_samples)`` of the Panda
    workload: goals ``start_q + U(-0.3, 0.3)`` and five spheres (centres
    ``U([0.6, -0.2, 0.6], [1.0, 0.2, 1.0])``, radii ``U(0.1, 0.2)``), both
    from ``default_rng(0)``; the target pose ``Rz(-pi) Ry(-pi)`` at
    ``(0.3, 0.3, 0.3)``; the state's means are the straight start-to-goal
    lines, ``ppg`` per goal, and its generator is seeded with ``seed``."""
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
    from stoch_gpmp_tpu_torch.planners import SamplerModel, StochGPMPState

    device = resolve_device(device)
    chain, target_h, start_q, start_state = _panda_setup(dtype, device)
    n_dof = chain.n_dofs
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
    rng = np.random.default_rng(0)
    goals_q = start_q[None] + as_t(rng.uniform(-0.3, 0.3, (num_goals, n_dof)))
    goals = torch.cat([goals_q, torch.zeros_like(goals_q)], dim=-1)
    cost = _panda_stack(chain, target_h, start_state, goals, traj_len, fast=fast,
                        fk=chain.fk_compact)
    s_start, s_gp, s_goal = PANDA_SAMPLE_SIGMAS
    prior = make_gp_prior(n_dof, traj_len, PANDA_DT, start_state, s_start, s_gp,
                          sigma_goal=s_goal, goal_states=goals, dtype=dtype, device=device)
    state = StochGPMPState(
        particle_means=prior.means.repeat_interleave(ppg, dim=0),
        generator=torch.Generator(device=device).manual_seed(seed),
    )
    spheres = np.zeros((1, 5, 4))
    spheres[0, :, :3] = rng.uniform([0.6, -0.2, 0.6], [1.0, 0.2, 1.0], (5, 3))
    spheres[0, :, 3] = rng.uniform(0.1, 0.2, 5)
    observation = {"obstacle_spheres": as_t(spheres)}
    return SamplerModel.from_prior(prior), cost, state, observation, num_samples


# examples/panda_environment.py: the SE(3) target, the obstacle spawn box
PANDA_TARGET_POS = (0.3, 0.3, 0.3)
PANDA_OBST_BOX = ((0.6, -0.2, 0.6), (1.0, 0.2, 1.0))


def panda_target(pos=PANDA_TARGET_POS, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """The example's target pose ``Frame(Rz(-pi) Ry(-pi), pos)`` as ``[4,
    4]``."""
    from stoch_gpmp_tpu_torch.kinematics import Frame, y_rot, z_rot

    pi = torch.tensor(-math.pi, dtype=dtype, device=device)
    return Frame(rot=z_rot(pi) @ y_rot(pi),
                 trans=torch.as_tensor(pos, dtype=dtype, device=device)).get_transform_matrix()


def _panda_setup(dtype, device, pos=PANDA_TARGET_POS):
    """``(chain, target_h, start_q, start_state)`` of the Panda problems:
    the 7-DOF chain, the example's target pose at ``pos``, the start
    configuration and its state at rest."""
    from stoch_gpmp_tpu_torch.kinematics import franka_panda

    start_q = torch.tensor(PANDA_START_Q, dtype=dtype, device=device)
    return (franka_panda(dtype), panda_target(pos, dtype=dtype, device=device), start_q,
            torch.cat([start_q, torch.zeros_like(start_q)]))


def _panda_stack(chain, target_h, start_state, goals, traj_len, *, fast=False, fk=None,
                 obstacles=None):
    """The Panda planning stack of the example scripts on ``start_state
    [2n]`` and ``goals [G, 2n]``: ``CostGP(1e-4, 7e-4)`` and
    ``CostGoalPrior(20)``, then with ``fast`` their ``QuadraticCost`` and
    ``PlaneFieldsCost`` (kernel K4 on the card), else the two, the self
    field, one ``CostCollision`` (sigma 0.01) per field of ``obstacles``
    (default a ``LinkDistanceField``) and ``CostGoal(EESE3DistanceField)``
    on ``fk`` (default ``chain.fk``)."""
    from stoch_gpmp_tpu_torch.costs import (
        CostCollision,
        CostComposite,
        CostGP,
        CostGoal,
        CostGoalPrior,
        EESE3DistanceField,
        LinkDistanceField,
        LinkSelfDistanceField,
        PlaneFieldsCost,
        QuadraticCost,
    )

    n_dof = chain.n_dofs
    kw = dict(dtype=start_state.dtype, device=start_state.device)
    cost_gp = CostGP.create(n_dof, traj_len, start_state, PANDA_DT,
                            {"sigma_start": 0.0001, "sigma_gp": 0.0007}, **kw)
    cost_goal = CostGoalPrior.create(n_dof, traj_len, goals, sigma_goal_prior=20.0, **kw)
    if fast:
        return CostComposite.create(n_dof, traj_len, [
            QuadraticCost.from_gp_and_goal_prior(cost_gp, cost_goal, traj_len),
            PlaneFieldsCost.create(n_dof, traj_len, chain, target_h, margin=0.03,
                                   sigma_self=0.01, sigma_coll=0.01, sigma_goal=0.00007),
        ])
    return CostComposite.create(n_dof, traj_len, [
        cost_gp,
        cost_goal,
        CostCollision.create(n_dof, traj_len, LinkSelfDistanceField(margin=0.03),
                             sigma_coll=0.01),
        *(CostCollision.create(n_dof, traj_len, f, sigma_coll=0.01)
          for f in (obstacles or [LinkDistanceField()])),
        CostGoal.create(n_dof, traj_len, EESE3DistanceField(target_h=target_h),
                        sigma_goal=0.00007),
    ], fk=fk or chain.fk)


def panda_ik_goal(chain, target_h, start_q, seed=0, *, num_starts=16, num_iters=150):
    """The example's goal configuration: ``solve_ik_multistart`` from
    ``num_starts`` uniform starts (a generator on ``start_q``'s device seeded
    with ``seed``) plus ``start_q``, ``num_iters`` iterations."""
    from stoch_gpmp_tpu_torch.kinematics.ik import solve_ik_multistart

    gen = torch.Generator(device=start_q.device).manual_seed(seed)
    return solve_ik_multistart(chain, target_h, gen, num_starts=num_starts, q_init=start_q,
                               num_iters=num_iters)


def panda_spheres(rng, num, *, chain=None, start_q=None, clearance=None) -> np.ndarray:
    """``[1, num, 4]`` obstacle spheres from ``random_init_static_sphere``
    (radii 0.1-0.2, ``PANDA_OBST_BOX``, offset 0.01) on the numpy generator
    ``rng``. With ``clearance``: each redrawn up to 50 times until its
    surface is more than ``clearance`` from the mesh-sphere surface of the
    arm at ``start_q`` (``benchmarks/success_rate_panda.py:99-121``)."""
    from stoch_gpmp_tpu_torch.envs.panda_env import random_init_static_sphere

    lo, hi = (np.array(b) for b in PANDA_OBST_BOX)
    if clearance is not None:
        poses = chain.fk(start_q.detach().cpu().double()[None])[0]
        cw, rw = (v.numpy() for v in panda_mesh_spheres(chain, poses))
    spheres = np.zeros((1, num, 4))
    for i in range(num):
        for _ in range(50 if clearance is not None else 1):
            r, pos = random_init_static_sphere(0.1, 0.2, lo, hi, 0.01, rng=rng)
            if clearance is None or (
                    (np.linalg.norm(cw - pos, axis=-1) - rw).min() - r > clearance):
                break
        spheres[0, i, :3] = pos
        spheres[0, i, 3] = r
    return spheres


def panda_mesh_spheres(chain, link_poses):
    """World centres ``[..., N, 3]`` and radii ``[N]`` of all 92 mesh
    spheres at link poses ``[..., L, 4, 4]``: the static base's
    (``panda_link0``, not a chain output) as given in the world frame, then
    the moving links' (``MeshSphereDistanceField.world_spheres``)."""
    from stoch_gpmp_tpu_torch.costs import MeshSphereDistanceField
    from stoch_gpmp_tpu_torch.kinematics.panda_collision import PANDA_COLLISION_SPHERES

    kw = dict(dtype=link_poses.dtype, device=link_poses.device)
    base = torch.as_tensor(PANDA_COLLISION_SPHERES["panda_link0"], **kw)
    cw, rw = MeshSphereDistanceField.for_panda(chain, **kw).world_spheres(link_poses)
    return (torch.cat([base[:, :3].expand(cw.shape[:-2] + (len(base), 3)), cw], dim=-2),
            torch.cat([base[:, 3], rw]))


def panda_mesh_clean(chain, means, spheres, n_dof=7):
    """``benchmarks/success_rate_panda.py:183-197``'s rule for a clean plan,
    per particle of ``means [P, T, 2 n]``, in float64 on the CPU: every mesh
    sphere's surface more than 0.03 from every (true-radius) obstacle's at
    every step, and the moving arm's spheres (all but the base column's,
    ``panda_link0`` and ``panda_link1``) more than 0.02 above the floor."""
    from stoch_gpmp_tpu_torch.kinematics.panda_collision import PANDA_COLLISION_SPHERES

    q = means[..., :n_dof].detach().cpu().double()
    p, t = q.shape[:2]
    poses = chain.fk(q.reshape(-1, n_dof)).reshape(p, t, -1, 4, 4)
    cw, rw = panda_mesh_spheres(chain, poses)  # [P, T, N, 3], [N]
    sp = torch.as_tensor(spheres, dtype=torch.float64).reshape(-1, 4)
    d = (torch.linalg.norm(cw[..., None, :] - sp[:, :3], dim=-1)
         - rw[None, None, :, None] - sp[:, 3])
    n_base = len(PANDA_COLLISION_SPHERES["panda_link0"]) + len(
        PANDA_COLLISION_SPHERES["panda_link1"])
    floor_clear = (cw[..., 2] - rw)[:, :, n_base:].amin(dim=(1, 2))
    return (d.amin(dim=(1, 2, 3)) > 0.03) & (floor_clear > 0.02)


@dataclass
class PandaPlan:
    """A Panda planning problem built as the example scripts build it: the
    planner, its observation and what the gates read."""

    planner: object  # StochGPMP or GPMP
    observation: dict
    chain: object
    target_h: torch.Tensor
    start_q: torch.Tensor
    q_goal: torch.Tensor | None
    spheres: np.ndarray  # [1, n, 4] the obstacles as spawned


def _panda_stochgpmp(cost, start_state, goals, ppg, traj_len, dtype, device, seed):
    """The ``StochGPMP`` of the Panda example: 32 samples, dt 0.05, step
    0.1, init sigmas (1e-4, 0.1, 0.8) and sampling sigmas (1e-3, 0.07,
    0.1) for (start, goal, gp)."""
    from stoch_gpmp_tpu_torch.planners import StochGPMP

    return StochGPMP(
        num_particles_per_goal=ppg, num_samples=32, traj_len=traj_len, dt=PANDA_DT,
        n_dof=7, opt_iters=1, temperature=1.0, start_state=start_state,
        multi_goal_states=goals, cost=cost, step_size=0.1, sigma_start_init=0.0001,
        sigma_goal_init=0.1, sigma_gp_init=0.8, sigma_start_sample=0.001,
        sigma_goal_sample=0.07, sigma_gp_sample=0.1, seed=seed, dtype=dtype, device=device,
    )


def build_panda_example(seed=0, *, fast=False, num_obst=5, q_goal=None, dtype=torch.float32,
                        device=None) -> PandaPlan:
    """``examples/panda_environment.py``: the goal configuration from
    :func:`panda_ik_goal` (unless ``q_goal`` is given), ``num_obst``
    spheres from ``default_rng(seed)``, and ``StochGPMP`` with 1 goal x 5
    particles, 32 samples, T = 64 on :func:`_panda_stack`'s reference-shaped
    stack (``fast=False``, on ``fk=chain.fk``) or its ``QuadraticCost`` +
    ``PlaneFieldsCost`` (``fast=True``, kernel K4 on the card)."""
    device = resolve_device(device)
    traj_len = 64
    rng = np.random.default_rng(seed)
    chain, target_h, start_q, start_state = _panda_setup(dtype, device)
    if q_goal is None:
        q_goal = panda_ik_goal(chain, target_h, start_q, seed)
    goals = torch.cat([q_goal, torch.zeros_like(q_goal)])[None]
    cost = _panda_stack(chain, target_h, start_state, goals, traj_len, fast=fast)
    planner = _panda_stochgpmp(cost, start_state, goals, 5, traj_len, dtype, device, seed)
    spheres = panda_spheres(rng, num_obst)
    return PandaPlan(planner=planner,
                     observation={"obstacle_spheres": torch.as_tensor(spheres, dtype=dtype,
                                                                      device=device)},
                     chain=chain, target_h=target_h, start_q=start_q, q_goal=q_goal,
                     spheres=spheres)


def build_panda_mesh(seed=0, *, q_goal=None, dtype=torch.float32, device=None) -> PandaPlan:
    """``benchmarks/success_rate_panda.py``'s planning problem (``:47-147``):
    the example's target moved by ``U(-0.05, 0.05)`` per axis and its IK
    goal, 5 spheres spawned at least 0.1 from the arm's mesh-sphere surface
    at the start and inflated by 0.05 for planning, and ``StochGPMP`` with
    1 goal x 4 particles, 32 samples, T = 32 on ``CostGP``,
    ``CostGoalPrior``, the self field, ``MeshSphereDistanceField.for_panda``,
    ``MeshSphereFloorField`` and the SE(3) goal on ``fk=chain.fk``. All
    draws come from ``default_rng(seed)`` and a generator seeded with
    ``seed``. ``spheres`` holds the true radii."""
    from stoch_gpmp_tpu_torch.costs import MeshSphereDistanceField, MeshSphereFloorField

    device = resolve_device(device)
    traj_len = 32
    rng = np.random.default_rng(seed)
    chain, target_h, start_q, start_state = _panda_setup(
        dtype, device, np.array(PANDA_TARGET_POS) + rng.uniform(-0.05, 0.05, 3))
    if q_goal is None:
        q_goal = panda_ik_goal(chain, target_h, start_q, seed)
    goals = torch.cat([q_goal, torch.zeros_like(q_goal)])[None]
    spheres = panda_spheres(rng, 5, chain=chain, start_q=start_q, clearance=0.1)
    plan = spheres.copy()
    plan[0, :, 3] += 0.05
    mesh = MeshSphereDistanceField.for_panda(chain, dtype=dtype, device=device)
    cost = _panda_stack(chain, target_h, start_state, goals, traj_len,
                        obstacles=[mesh, MeshSphereFloorField(mesh=mesh)])
    planner = _panda_stochgpmp(cost, start_state, goals, 4, traj_len, dtype, device, seed)
    return PandaPlan(planner=planner,
                     observation={"obstacle_spheres": torch.as_tensor(plan, dtype=dtype,
                                                                      device=device)},
                     chain=chain, target_h=target_h, start_q=start_q, q_goal=q_goal,
                     spheres=spheres)


def build_panda_gpmp(seed=0, *, method="cholesky", ppg=5, traj_len=64, dtype=torch.float32,
                     device=None) -> PandaPlan:
    """Gauss-Newton ``GPMP`` on the Panda through FK, the stack of
    ``tests/test_gpmp.py test_gpmp_panda_with_fk_fields``: ``CostGP(1e-3,
    0.1)``, ``CostCollision(LinkDistanceField, 0.1)`` and
    ``CostGoal(EESE3DistanceField, 0.05)`` on ``fk=chain.fk``, delta 1e-2,
    step 0.2, no goal prior; at the Panda example's start, target, T = 64
    and spheres, and ``ppg`` particles at the start plus 0.1 times standard
    normal noise (``tests/test_gpmp.py test_woodbury_panda_fk_fields``'s
    initial means), all from ``default_rng(seed)``. ``method``:
    ``cholesky``, ``inverse`` or ``woodbury`` (two rank-1 fields)."""
    from stoch_gpmp_tpu_torch.costs import (
        CostCollision,
        CostComposite,
        CostGP,
        CostGoal,
        EESE3DistanceField,
        LinkDistanceField,
    )
    from stoch_gpmp_tpu_torch.planners import GPMP

    device = resolve_device(device)
    n_dof = 7
    rng = np.random.default_rng(seed)
    chain, target_h, start_q, start_state = _panda_setup(dtype, device)
    cost = CostComposite.create(n_dof, traj_len, [
        CostGP.create(n_dof, traj_len, start_state, PANDA_DT,
                      {"sigma_start": 0.001, "sigma_gp": 0.1}, dtype=dtype, device=device),
        CostCollision.create(n_dof, traj_len, LinkDistanceField(), sigma_coll=0.1),
        CostGoal.create(n_dof, traj_len, EESE3DistanceField(target_h=target_h), sigma_goal=0.05),
    ], fk=chain.fk)
    spheres = panda_spheres(rng, 5)
    means = start_state + 0.1 * torch.as_tensor(
        rng.standard_normal((ppg, traj_len, 2 * n_dof)), dtype=dtype, device=device)
    planner = GPMP(
        num_particles_per_goal=ppg, traj_len=traj_len, opt_iters=1, dt=PANDA_DT, n_dof=n_dof,
        step_size=0.2, start_state=start_state, initial_particle_means=means, cost=cost,
        sigma_start_init=1e-4, sigma_gp_init=0.1, sigma_start_sample=1e-3, sigma_gp_sample=0.1,
        solver_params={"delta": 1e-2, "trust_region": False, "method": method},
        seed=seed, dtype=dtype, device=device,
    )
    return PandaPlan(planner=planner,
                     observation={"obstacle_spheres": torch.as_tensor(spheres, dtype=dtype,
                                                                      device=device)},
                     chain=chain, target_h=target_h, start_q=start_q, q_goal=None,
                     spheres=spheres)
