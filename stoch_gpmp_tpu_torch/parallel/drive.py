"""Rank programs: run the sharded paths on given problems, return numpy.

``run_cases(cases, device)`` runs in every rank of a ``parallel.launch``
call; each case names a path, a mesh shape and its inputs (the port's
objects on the CPU, the global initial means, the global draws), and every
rank returns each case's global outputs as numpy arrays. ``device`` None
means the CUDA card, as at every entry point of the port. The CPU tests run
it on four gloo ranks against the JAX package's sharded results:

    from stoch_gpmp_tpu_torch.parallel.launch import launch
    from stoch_gpmp_tpu_torch.parallel.drive import run_cases
    out = launch(run_cases, 4, (cases, "cpu"), device="cpu")

Kinds: ``"mesh"`` (the rank's place), ``"optimize"``
(``make_sharded_optimize``, ``layout`` ``"flat"`` or ``"dof"``), ``"gpmp"``
(``make_sharded_gpmp_optimize``), ``"stochgpmp"`` and ``"gpmp_class"`` (the
classes with ``mesh=``; a ``"stochgpmp"`` case may carry the global draws of
its optimize, ``eps``). A rank outside a case's mesh returns None for it.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def _inject(planner, eps: list) -> None:
    """Make ``planner``'s sharded optimize take the global draws ``eps``
    (one per iteration; the tests inject the JAX package's) in place of its
    generator's."""
    make = planner._sharded_runner

    def runner(iters, collect_metrics):
        return functools.partial(make(iters, collect_metrics), eps=eps)

    planner._sharded_runner = runner


def run_cases(cases: list, device=None) -> list:
    """Each case's global outputs (a dict of numpy arrays) on this rank, on
    ``device`` (None: the CUDA card; raises before any collective when
    there is none)."""
    from stoch_gpmp_tpu_torch.parallel import make_mesh
    from stoch_gpmp_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    meshes, out = {}, []
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:  # every rank makes every mesh, in the same order
            meshes[shape] = make_mesh(shape[0] * shape[1], axis_shape=shape, device=device)
        mesh = meshes[shape]
        out.append(_run(case, mesh) if mesh.is_member else None)
    return [dict(r, jax_loaded="jax" in sys.modules) if r is not None else None for r in out]


def _run(case: dict, mesh) -> dict:
    from stoch_gpmp_tpu_torch.parallel import (
        make_sharded_gpmp_optimize,
        make_sharded_optimize,
        replicate,
        shard_gpmp_state,
        shard_planner_state,
    )
    from stoch_gpmp_tpu_torch.planners import GPMP, GPMPState, StochGPMP, StochGPMPState

    kind = case["kind"]
    dev = mesh.device
    if kind == "mesh":
        return dict(devices=mesh.devices, coords=np.asarray(mesh.coords),
                    shape=np.asarray([mesh.shape["p"], mesh.shape["s"]]))
    if kind == "optimize":
        sampler, cost = replicate(mesh, (case["sampler"], case["cost"]))
        state = StochGPMPState(particle_means=case["means"].to(dev),
                               generator=torch.Generator(device=dev).manual_seed(0))
        run = make_sharded_optimize(mesh, layout=case.get("layout", "flat"), **case["kwargs"])
        res = run(sampler, cost, shard_planner_state(mesh, state), {},
                  eps=[e.to(dev) for e in case["eps"]])
        st, aux = res[:2]
        out = dict(means=run.shard.gather_particles(st.particle_means),
                   costs=run.shard.gather_samples(aux.costs),
                   weights=run.shard.gather_samples(aux.weights),
                   block=st.particle_means)
        if len(res) == 3:
            out.update({f"metric_{k}": getattr(res[2], k) for k in
                        ("cost_mean", "cost_min", "weight_entropy", "update_norm")})
        return {k: _np(v) for k, v in out.items()}
    if kind == "gpmp":
        cost = replicate(mesh, case["cost"])
        kw = dict(case["kwargs"])
        if kw.get("method") == "woodbury":
            from stoch_gpmp_tpu_torch.planners import build_woodbury

            kw["woodbury"] = build_woodbury(cost, kw["delta"])
        state = GPMPState(particle_means=case["means"].to(dev),
                          generator=torch.Generator(device=dev))
        run = make_sharded_gpmp_optimize(mesh, **kw)
        st = run(cost, shard_gpmp_state(mesh, state), {})
        return dict(means=_np(run.shard.gather_particles(st.particle_means)))
    if kind == "stochgpmp":
        planner = StochGPMP(cost=replicate(mesh, case["cost"]), mesh=mesh, **case["kwargs"])
        if "eps" in case:
            _inject(planner, [e.to(dev) for e in case["eps"]])
        res = planner.optimize(collect_metrics=case.get("collect_metrics", False))
        pos, vel = planner.sample_trajectories(2)
        out = {f"out{i}": _np(r) for i, r in enumerate(res)}
        out.update(means=_np(planner.particle_means), best=_np(planner.get_traj("best")),
                   recent=_np(planner.get_recent_samples()[0]), drawn=_np(pos))
        if planner.last_metrics is not None:
            out.update({f"metric_{k}": _np(getattr(planner.last_metrics, k)) for k in
                        ("cost_mean", "cost_min", "weight_entropy", "update_norm")})
        return out
    if kind == "gpmp_class":
        planner = GPMP(cost=replicate(mesh, case["cost"]), mesh=mesh, **case["kwargs"])
        vel, pos, costs = planner.optimize()
        return dict(vel=_np(vel), pos=_np(pos), costs=_np(costs),
                    means=_np(planner.particle_means))
    raise ValueError(f"unknown case kind: {kind}")
