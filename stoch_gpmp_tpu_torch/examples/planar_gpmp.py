"""Planar GPMP (deterministic Gauss-Newton) demo, the port's twin of
``examples/planar_gpmp.py``: ``GPMP`` on the planar obstacle workload
(``problems.build_planar_gpmp_problem``: 2 goals x 3 particles, T = 64,
10 random obstacles on the occupancy grid, kernel K10 on the card) descends
from its init-prior draw to collision-aware trajectories.

Run: ``python -m stoch_gpmp_tpu_torch.examples.planar_gpmp [--iters 100]
[--seed 0] [--method cholesky|woodbury] [--plot out.png] [--device cpu]``.
``--device`` defaults to the CUDA card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from stoch_gpmp_tpu_torch import problems


def main(argv=None):
    """Run the demo; returns ``(vel, pos, costs)`` of the final iteration."""
    from stoch_gpmp_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plot", type=str, default=None)
    ap.add_argument("--method", choices=["cholesky", "woodbury"], default="cholesky",
                    help="GN solve: structured Cholesky, or the parallel-in-time Woodbury "
                    "split (equal results; see planners/gpmp.py)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    planner = problems.build_planar_gpmp_problem(3, method=args.method, seed=args.seed,
                                                 device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    t0 = time.time()
    vel, pos, costs = planner.optimize(opt_iters=args.iters)
    sync()
    print(f"{args.iters} GN iterations in {time.time() - t0:.2f}s "
          f"| final mean cost {float(costs.mean()):.2f}")
    goals = np.asarray(problems.GPMP_GOALS)
    end_err = np.linalg.norm(
        pos[:, -1].cpu().numpy().reshape(2, 3, 2) - goals[:, None, :2], axis=-1)
    print(f"final goal distances: {np.round(end_err, 3)}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        obst_map = planner.cost.costs[2].field.grid.cpu().numpy()
        fig, ax = plt.subplots(figsize=(7, 7))
        x = np.linspace(-10, 10, obst_map.shape[1])
        y = np.linspace(-10, 10, obst_map.shape[0])
        ax.contourf(x, y, obst_map, 20)
        p = pos.cpu().numpy()
        for i in range(p.shape[0]):
            ax.plot(p[i, :, 0], p[i, :, 1], "b")
        ax.plot(goals[:, 0], goals[:, 1], "g*", markersize=12)
        fig.savefig(args.plot, dpi=120)
        print(f"saved plot to {args.plot}")
    return vel, pos, costs


if __name__ == "__main__":
    main()
