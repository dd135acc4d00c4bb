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

``device=None`` means the CUDA card (raises without one); pass
``device="cpu"`` to build on the CPU.
"""

from __future__ import annotations

import math

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
    from stoch_gpmp_tpu_torch.costs import CostCollision, CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu_torch.envs import generate_obstacle_map
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
    from stoch_gpmp_tpu_torch.planners import SamplerModel, StochGPMPState

    device = resolve_device(device)
    t = traj_len
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
    prior = make_gp_prior(2, t, DT, START, 1e-3, 3.0, sigma_goal=1e-3,
                          goal_states=LONG_HORIZON_GOALS, dtype=dtype, device=device,
                          materialize_dense=False)
    state = StochGPMPState(
        particle_means=prior.means.repeat(LONG_HORIZON["particles"], 1, 1),
        generator=torch.Generator(device=device).manual_seed(seed),
    )
    return SamplerModel.from_prior(prior), CostComposite.create(2, t, costs), state


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
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
    from stoch_gpmp_tpu_torch.kinematics import franka_panda, homogeneous, y_rot, z_rot
    from stoch_gpmp_tpu_torch.planners import SamplerModel, StochGPMPState

    device = resolve_device(device)
    chain = franka_panda()
    n_dof = chain.n_dofs
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
    target_h = homogeneous(z_rot(as_t(-math.pi)) @ y_rot(as_t(-math.pi)), as_t([0.3, 0.3, 0.3]))
    start_q = as_t(PANDA_START_Q)
    start_state = torch.cat([start_q, torch.zeros_like(start_q)])
    rng = np.random.default_rng(0)
    goals_q = start_q[None] + as_t(rng.uniform(-0.3, 0.3, (num_goals, n_dof)))
    goals = torch.cat([goals_q, torch.zeros_like(goals_q)], dim=-1)

    cost_gp = CostGP.create(n_dof, traj_len, start_state, PANDA_DT,
                            {"sigma_start": 0.0001, "sigma_gp": 0.0007}, dtype=dtype, device=device)
    cost_goal = CostGoalPrior.create(n_dof, traj_len, goals, sigma_goal_prior=20.0,
                                     dtype=dtype, device=device)
    if fast:
        cost = CostComposite.create(n_dof, traj_len, [
            QuadraticCost.from_gp_and_goal_prior(cost_gp, cost_goal, traj_len),
            PlaneFieldsCost.create(n_dof, traj_len, chain, target_h, margin=0.03,
                                   sigma_self=0.01, sigma_coll=0.01, sigma_goal=0.00007),
        ])
    else:
        cost = CostComposite.create(n_dof, traj_len, [
            cost_gp,
            cost_goal,
            CostCollision.create(n_dof, traj_len, LinkSelfDistanceField(margin=0.03),
                                 sigma_coll=0.01),
            CostCollision.create(n_dof, traj_len, LinkDistanceField(), sigma_coll=0.01),
            CostGoal.create(n_dof, traj_len, EESE3DistanceField(target_h=target_h),
                            sigma_goal=0.00007),
        ], fk=chain.fk_compact)
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
