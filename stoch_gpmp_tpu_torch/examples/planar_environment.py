"""Planar multi-goal StochGPMP demo, the port's twin of
``examples/planar_environment.py``: a 2-DOF point mass plans from a fixed
start to 3 goals through a random 20x20 obstacle map.

Run: ``python -m stoch_gpmp_tpu_torch.examples.planar_environment [--iters
500] [--fast] [--traj-len 64] [--plot out.png] [--animate out.gif] [--live]
[--device cpu]``

The cost stacks are the JAX example's:

- ``--fast`` with M = 2 T d <= 2048: ``QuadraticCost`` (the GP prior and
  the goal anchor in one quadratic) + ``CostCollision`` on the occupancy
  grid (kernel K10 on the card);
- ``--fast`` with M > 2048 (``--traj-len`` above 512): ``CostGP`` +
  ``CostGoalPrior`` + ``CostCollision`` on the exact raster field
  (``RasterPrimitive2DField``, kernel K1). The sampling prior then has no
  dense factor and ``StochGPMP`` takes the ``"planes"`` route: each
  iteration one plane solve (kernel S1) and one K1 launch;
- without ``--fast``: ``CostGP`` + ``CostGoalPrior`` + ``CostCollision`` on
  the occupancy grid (K10).

``--fast`` selects only the cost stack here. The JAX example's ``--fast``
also picks the one-hot grid lookup and the hardware PRNG
(``prng_impl="unsafe_rbg"``), TPU execution choices the port does not have:
it has one grid kernel, and draws from a ``torch.Generator`` seeded with
``--seed``.

``--animate`` saves the sample clouds (red) and means (blue) every 25
iterations as a GIF; ``--live`` replays them in a window (needs a display).
The plot flags import matplotlib, and fail where it is not installed.
``--device`` defaults to the CUDA card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from stoch_gpmp_tpu_torch.problems import DT, GOALS, START

N_DOF = 2
PPG, NUM_SAMPLES = 5, 128
# M = 2 T d above which the planner runs in long-horizon mode (no dense
# factor of the sampling prior)
DENSE_MAX_M = 2048


def long_horizon(traj_len: int) -> bool:
    return 2 * N_DOF * traj_len > DENSE_MAX_M


def build_map(seed, *, device, dtype=torch.float32):
    """``(obst_map, obst_list)``: 15 random obstacles on a 20 x 20 map at
    cell 0.1, from ``rng=seed``, the grid on ``device``."""
    from stoch_gpmp_tpu_torch.envs import generate_obstacle_map

    return generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
        rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2], rng=seed,
        dtype=dtype, device=device,
    )


def build_cost(obst_map, obst_list, traj_len: int, fast: bool, *, device,
               dtype=torch.float32):
    """The example's cost stack for ``traj_len`` (module docstring)."""
    from stoch_gpmp_tpu_torch.costs import (
        CostCollision,
        CostComposite,
        CostGP,
        CostGoalPrior,
        QuadraticCost,
        RasterPrimitive2DField,
    )

    field = obst_map.as_field()
    if fast and long_horizon(traj_len):
        field = RasterPrimitive2DField.from_map(obst_map, obst_list, dtype=dtype, device=device)
    cost_prior = CostGP.create(N_DOF, traj_len, START, DT,
                               {"sigma_start": 0.001, "sigma_gp": 0.1}, dtype=dtype,
                               device=device)
    cost_goal_prior = CostGoalPrior.create(N_DOF, traj_len, GOALS, sigma_goal_prior=0.001,
                                           dtype=dtype, device=device)
    if fast and not long_horizon(traj_len):
        cost_list = [QuadraticCost.from_gp_and_goal_prior(cost_prior, cost_goal_prior, traj_len)]
    else:
        cost_list = [cost_prior, cost_goal_prior]
    cost_list.append(CostCollision.create(N_DOF, traj_len, field, sigma_coll=1e-5))
    return CostComposite.create(N_DOF, traj_len, cost_list)


def build_planner(cost, traj_len: int, seed: int, *, device, dtype=torch.float32):
    """The example's ``StochGPMP``: 3 goals x 5 particles, 128 samples."""
    from stoch_gpmp_tpu_torch.planners import StochGPMP

    return StochGPMP(
        num_particles_per_goal=PPG, num_samples=NUM_SAMPLES, traj_len=traj_len, dt=DT,
        n_dof=N_DOF, opt_iters=1, temperature=1.0, start_state=START,
        multi_goal_states=GOALS, cost=cost, step_size=0.5, sigma_start_init=1e-3,
        sigma_goal_init=1e-3, sigma_gp_init=20.0, sigma_start_sample=1e-3,
        sigma_goal_sample=1e-3, sigma_gp_sample=3.0, seed=seed, dtype=dtype, device=device,
    )


def _draw_frames(obst_map, traj_history, chunk, animate, live):
    import matplotlib

    if not live:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.linspace(-10, 10, obst_map.map.shape[1])
    y = np.linspace(-10, 10, obst_map.map.shape[0])
    g = np.asarray(GOALS)
    fig, ax = plt.subplots(figsize=(6, 6))

    def draw(frame):
        pos, means = traj_history[frame]
        ax.clear()
        ax.contourf(x, y, obst_map.map, 20)
        for p in range(pos.shape[0]):
            for s in range(0, pos.shape[1], max(1, pos.shape[1] // 8)):
                ax.plot(pos[p, s, :, 0], pos[p, s, :, 1], "r", alpha=0.15)
        for p in range(means.shape[0]):
            ax.plot(means[p, :, 0], means[p, :, 1], "b")
        ax.plot(g[:, 0], g[:, 1], "g*", markersize=12)
        ax.set_title(f"iteration {(frame + 1) * chunk}")

    if animate:
        from matplotlib.animation import FuncAnimation, PillowWriter

        anim = FuncAnimation(fig, draw, frames=len(traj_history))
        anim.save(animate, writer=PillowWriter(fps=4))
        print(f"saved animation to {animate}")
    if live:  # pragma: no cover - needs a display
        plt.ion()
        for f in range(len(traj_history)):
            draw(f)
            plt.draw()
            plt.pause(0.1)
        plt.ioff()
        plt.show()


def _plot(obst_map, planner, path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    x = np.linspace(-10, 10, obst_map.map.shape[1])
    y = np.linspace(-10, 10, obst_map.map.shape[0])
    ax.contourf(x, y, obst_map.map, 20)
    trajs = planner.get_recent_samples()[0].cpu().numpy()
    for p in range(trajs.shape[0]):
        for s in range(0, trajs.shape[1], 16):
            ax.plot(trajs[p, s, :, 0], trajs[p, s, :, 1], "r", alpha=0.15)
    means = planner.particle_means.cpu().numpy()
    for p in range(means.shape[0]):
        ax.plot(means[p, :, 0], means[p, :, 1], "b")
    g = np.asarray(GOALS)
    ax.plot(g[:, 0], g[:, 1], "g*", markersize=12)
    fig.savefig(path, dpi=120)
    print(f"saved plot to {path}")


def main(argv=None):
    """Run the demo; returns the planner."""
    from stoch_gpmp_tpu_torch.utils import print_info
    from stoch_gpmp_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--traj-len", type=int, default=64,
                    help="horizon; >512 engages long-horizon mode (plane solve, plane pipeline)")
    ap.add_argument("--seed", type=int, default=int(time.time()))
    ap.add_argument("--fast", action="store_true",
                    help="fused quadratic cost (raster field in long-horizon mode)")
    ap.add_argument("--plot", type=str, default=None, help="save trajectory plot to this file")
    ap.add_argument("--animate", type=str, default=None,
                    help="save the optimization animation (gif) to this file")
    ap.add_argument("--live", action="store_true",
                    help="replay the animation in an interactive window")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    obst_map, obst_list = build_map(args.seed, device=device)
    cost = build_cost(obst_map, obst_list, args.traj_len, args.fast, device=device)
    planner = build_planner(cost, args.traj_len, args.seed, device=device)

    start_time = time.time()
    record = args.animate or args.live
    # the reference snapshots samples every 25 iterations for its live
    # animation (planar_environment.py:105-111)
    chunk = 25 if record else 50
    traj_history = []
    for i in range(0, args.iters, chunk):
        t0 = time.time()
        costs = planner.optimize(opt_iters=min(chunk, args.iters - i))[4]
        print_info(min(i + chunk, args.iters), args.iters, t0, start_time, costs)
        if record:
            pos, _ = planner.get_recent_samples()
            traj_history.append((pos.cpu().numpy(), planner.particle_means.cpu().numpy()))

    if record:
        _draw_frames(obst_map, traj_history, chunk, args.animate, args.live)
    if args.plot:
        _plot(obst_map, planner, args.plot)
    return planner


if __name__ == "__main__":
    main()
