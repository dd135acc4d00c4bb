"""The planar parity workload, built natively in the port.

Counterpart of ``__graft_entry__._build_problem(fast=True)``: the reference's
``examples/planar_environment.py`` at 3 goals x 5 particles per goal,
T = 64, 2 DOF, 15 random obstacles from ``generate_obstacle_map(rng=0)``,
with the fused quadratic ``CostComposite([QuadraticCost,
CostCollision(RasterPrimitive2DField)])``. ``sigma_goal_prior`` is the
goal anchor of the cost (1e-3 gives weights of 1e6, the matmul quadratic;
1e-5 gives 1e10 and the stencil quadratic).
"""

from __future__ import annotations

import torch

START = [-9.0, -9.0, 0.0, 0.0]
GOALS = [[9.0, 6.0, 0.0, 0.0], [9.0, -3.0, 0.0, 0.0], [-3.0, 9.0, 0.0, 0.0]]
DT = 0.02
# the sampling prior's sigmas: (start, gp, goal)
SAMPLE_SIGMAS = (1e-3, 3.0, 1e-3)


def build_planar_cost(traj_len=64, dtype=torch.float32, device=None,
                      with_obstacles=True, sigma_goal_prior=1e-3):
    """The parity cost stack; returns ``(cost, field_or_None)``."""
    from stoch_gpmp_tpu_torch.costs import (
        CostCollision,
        CostComposite,
        CostGP,
        CostGoalPrior,
        QuadraticCost,
        RasterPrimitive2DField,
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
    costs = [QuadraticCost.from_gp_and_goal_prior(cost_gp, cost_goal, traj_len)]
    field = None
    if with_obstacles:
        obst_map, obst_list = generate_obstacle_map(
            map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
            rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2],
            rng=0, dtype=dtype, device=device,
        )
        field = RasterPrimitive2DField.from_map(obst_map, obst_list, dtype=dtype, device=device)
        costs.append(CostCollision.create(n_dof, traj_len, field, sigma_coll=1e-5))
    return CostComposite.create(n_dof, traj_len, costs), field


def build_planar_problem(traj_len=64, ppg=5, dtype=torch.float32, device=None,
                         with_obstacles=True, sigma_goal_prior=1e-3, seed=0):
    """``(sampler, cost, state)`` of the parity workload; the state's means
    are the straight start-to-goal lines, ``ppg`` per goal, and its
    generator is seeded with ``seed``."""
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
    from stoch_gpmp_tpu_torch.planners import SamplerModel, StochGPMPState

    cost, _ = build_planar_cost(traj_len, dtype, device, with_obstacles, sigma_goal_prior)
    s_start, s_gp, s_goal = SAMPLE_SIGMAS
    prior = make_gp_prior(
        2, traj_len, DT, START, s_start, s_gp, sigma_goal=s_goal,
        goal_states=GOALS, dtype=dtype, device=device,
    )
    state = StochGPMPState(
        particle_means=prior.means.repeat_interleave(ppg, dim=0),
        generator=torch.Generator(device=device or "cpu").manual_seed(seed),
    )
    return SamplerModel.from_prior(prior), cost, state
