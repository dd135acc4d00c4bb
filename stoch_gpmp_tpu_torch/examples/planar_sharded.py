"""Multi-device planar StochGPMP, the port's twin of
``examples/planar_sharded.py``: the planar parity workload
(``problems.build_sharded_planar_problem``) sharded over a mesh of ranks,
particles data-parallel over the ``p`` axis and Monte-Carlo samples over
``s`` (the softmax and the weighted mean reduced across ranks), started by
``parallel.launch``: one process per rank, NCCL with a card per rank, gloo
otherwise (the CPU, or ranks sharing a card).

Run: ``python -m stoch_gpmp_tpu_torch.examples.planar_sharded [--devices
4] [--iters 200] [--device cpu]``. ``--device`` defaults to the CUDA card;
ranks beyond the card count share cards.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _rank(iters: int, seed: int, device) -> dict:
    """One rank: the default mesh over every rank on ``device`` (None: the
    rank's card), ``iters`` sharded iterations, the gathered means'
    distances to the goals."""
    import torch

    from stoch_gpmp_tpu_torch.parallel import (
        make_mesh,
        make_sharded_optimize,
        shard_planner_state,
    )
    from stoch_gpmp_tpu_torch.problems import GOALS, build_sharded_planar_problem

    mesh = make_mesh(device=device)
    n_p, n_s = mesh.shape["p"], mesh.shape["s"]
    sampler, cost, state = build_sharded_planar_problem(n_p, seed=seed, device=mesh.device)
    run = make_sharded_optimize(mesh, opt_iters=iters, num_samples=16 * n_s, temperature=1.0,
                                step_size=0.5)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    st, aux = run(sampler, cost, shard_planner_state(mesh, state), {})
    means = run.shard.gather_particles(st.particle_means)
    costs = run.shard.gather_samples(aux.costs)
    sync()
    seconds = time.perf_counter() - t0
    final = means[:, -1, :2].cpu().numpy()
    goals = np.asarray(GOALS)[:, :2]
    return dict(rank=mesh.rank, shape=(n_p, n_s), device=str(mesh.device),
                backend=mesh.backend, seconds=seconds, finite=bool(torch.isfinite(means).all()),
                mean_cost=float(costs.mean()), particles=means.shape[0],
                dists=np.linalg.norm(final[:, None] - goals[None], axis=-1).min(axis=1))


def main(argv=None):
    from stoch_gpmp_tpu_torch.parallel.launch import launch
    from stoch_gpmp_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4, help="ranks in the mesh")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="'cuda' or 'cpu' (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type

    out = launch(_rank, args.devices, (args.iters, args.seed, "cpu" if device == "cpu" else None),
                 device=device)
    r = out[0]
    if not all(x["finite"] for x in out):
        raise RuntimeError("non-finite means")
    print(f"mesh: {r['shape']} over {args.devices} ranks on {device} ({r['backend']})")
    print(f"{args.iters} sharded iterations over {args.devices} ranks in {r['seconds']:.2f}s | "
          f"{r['particles']} particles | mean cost {r['mean_cost']:.1f}")
    print(f"final distance to nearest goal per particle: {np.round(r['dists'], 3)}")


if __name__ == "__main__":
    main()
