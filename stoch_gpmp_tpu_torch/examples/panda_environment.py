"""Panda 7-DOF StochGPMP demo, the port's twin of
``examples/panda_environment.py``: plan to an SE(3) end-effector target
among random sphere obstacles, with FK + collision + self-collision + SE(3)
goal costs and the goal configuration from multi-start IK
(``problems.build_panda_example``).

Run: ``python -m stoch_gpmp_tpu_torch.examples.panda_environment [--iters
400] [--fast] [--plot out.png] [--device cpu]``

``--fast`` swaps in the fast stack, ``QuadraticCost + PlaneFieldsCost``
(kernel K4 on the card). ``--device`` defaults to the CUDA card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from stoch_gpmp_tpu_torch.problems import PANDA_TARGET_POS, build_panda_example


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--seed", type=int, default=int(time.time()))
    ap.add_argument("--num-obst", type=int, default=5)
    ap.add_argument("--fast", action="store_true",
                    help="fused quadratic + FK-in-kernel link fields")
    ap.add_argument("--plot", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    ex = build_panda_example(args.seed, fast=args.fast, num_obst=args.num_obst,
                             device=args.device)
    planner, obs, chain = ex.planner, ex.observation, ex.chain
    n_dof = chain.n_dofs
    sync = torch.cuda.synchronize if planner.particle_means.is_cuda else (lambda: None)

    t_start = time.time()
    chunk = 50
    for i in range(0, args.iters, chunk):
        t0 = time.time()
        costs = planner.optimize(opt_iters=min(chunk, args.iters - i), observation=obs)[4]
        sync()
        print(f"iter {min(i + chunk, args.iters):4d}/{args.iters} | chunk "
              f"{time.time() - t0:.3f}s | total {time.time() - t_start:.2f}s | mean cost "
              f"{float(costs.mean()):.1f}")

    # report the final EE distance to the target
    means = planner.particle_means
    ee = chain.ee_pose(means[:, -1, :n_dof])[:, :3, 3].cpu().numpy()
    target_pos = np.asarray(PANDA_TARGET_POS)
    dist = np.linalg.norm(ee - target_pos, axis=-1)
    print(f"final EE->target distances: {np.round(dist, 4)}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        spheres = ex.spheres
        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
        for p_idx in range(means.shape[0]):
            for t in range(0, means.shape[1], 8):
                pts = chain.fk(means[p_idx, t, :n_dof])[:, :3, 3].cpu().numpy()
                ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], "b-", alpha=0.3)
        ax.plot([target_pos[0]], [target_pos[1]], [target_pos[2]], "r*", markersize=10)
        ax.scatter(spheres[0, :, 0], spheres[0, :, 1], spheres[0, :, 2],
                   s=spheres[0, :, 3] * 2000, color="r")
        fig.savefig(args.plot, dpi=120)
        print(f"saved plot to {args.plot}")


if __name__ == "__main__":
    main()
