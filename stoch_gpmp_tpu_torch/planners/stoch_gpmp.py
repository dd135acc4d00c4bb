"""StochGPMP: importance-weighted stochastic trajectory optimization.

PyTorch counterpart of ``stoch_gpmp_tpu/planners/stoch_gpmp.py`` (reference
``stoch_gpmp/planner.py``). One iteration samples ``x = mu + eps @ L^{-1}``
for every particle, evaluates the cost stack, adds the importance term
``tau * x . Sigma^{-1} mu``, takes a softmax over each particle's samples and
moves the mean by the weighted average of ``x - mu``.

``stoch_gpmp_optimize`` routes a problem as the JAX package does
(``_route``): the dof-factored path (``_stoch_gpmp_optimize_dof``: means and
samples as dof-leading planes ``[d, P(, S), 2T]``, sampling against the
shared ``[2T, 2T]`` factor, the quadratic and importance term in kernel K3,
the rest of the stack on the planes) for every dof-capable stack with a
128-aligned horizon; the plane path (``_stoch_gpmp_optimize_planes``: per-dim
time planes ``[d, P(, S), T]``, sampling by the parallel-in-time solver,
kernel S1, and the stack's ``eval_planes``) for a long-horizon sampler (no
dense factor) with d <= 8 and a plane-capable stack; otherwise the flat path
(``stoch_gpmp_step`` in a Python loop, the JAX ``lax.scan``), which samples
with the dense ``L^{-1}`` or a structured solve. Each returns the final
state and the last iteration's aux.

State layout matches the reference: ``particle_means [P, T, d]`` with
``P = num_goals * num_particles_per_goal`` goal-major.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from stoch_gpmp_tpu_torch.gp.prior import GPPrior, make_gp_prior, sample_correction
from stoch_gpmp_tpu_torch.gp.tridiag import (
    BlockBidiagChol,
    BlockTridiag,
    ParallelBidiagSolver,
    stack_planes,
)
from stoch_gpmp_tpu_torch.utils.device import resolve_device
from stoch_gpmp_tpu_torch.utils.profiling import annotate, count


@dataclass
class SamplerModel:
    """The shared-precision Gaussian sampler around particle means:
    structured precision and its Cholesky, the dense ``L^{-1}`` and
    precision (when the prior materialized the dense factor) or the
    parallel-in-time solver (long horizons), and the per-dof factor (exact
    stencil ``Sigma^{-1}`` matvec)."""

    precision: BlockTridiag
    chol: BlockBidiagChol | None
    weight_t: torch.Tensor | None  # [M, M] = L^{-1}; samples = eps @ weight_t
    precision_dense: torch.Tensor | None  # [M, M], with weight_t only
    psolver: ParallelBidiagSolver | None = None
    dof: object | None = None

    @classmethod
    def from_prior(cls, prior: GPPrior) -> "SamplerModel":
        dense = prior.weight_t is not None
        return cls(
            precision=prior.precision, weight_t=prior.weight_t,
            precision_dense=prior.precision.to_dense() if dense else None, dof=prior.dof,
            chol=prior.chol, psolver=prior.psolver,
        )


@dataclass
class StochGPMPState:
    """Planner state: particle means and the generator every draw takes."""

    particle_means: torch.Tensor  # [P, T, d]
    generator: torch.Generator


@dataclass
class StochGPMPAux:
    """Per-call outputs mirroring the reference optimize() return tuple."""

    samples: torch.Tensor  # [P, S, T, d]
    costs: torch.Tensor  # [P, S]
    weights: torch.Tensor  # [P, S]
    grad: torch.Tensor  # [P, T, d]


@dataclass
class IterMetrics:
    """Per-iteration observability, stacked over iterations."""

    cost_mean: torch.Tensor
    cost_min: torch.Tensor
    weight_entropy: torch.Tensor
    update_norm: torch.Tensor

    @classmethod
    def from_aux(cls, aux: StochGPMPAux, step_size: float) -> "IterMetrics":
        w = aux.weights
        return cls(
            cost_mean=aux.costs.mean(),
            cost_min=aux.costs.min(),
            weight_entropy=-torch.sum(w * torch.log(w + 1e-30), dim=1).mean(),
            update_norm=(step_size * torch.linalg.norm(
                aux.grad.reshape(aux.grad.shape[0], -1), dim=-1
            )).mean(),
        )

    @classmethod
    def stack(cls, items: list["IterMetrics"]) -> "IterMetrics":
        return cls(*(torch.stack([getattr(i, f) for i in items]) for f in
                     ("cost_mean", "cost_min", "weight_entropy", "update_norm")))


def _eps_at(eps, i):
    """The ``i``-th injected draw: ``eps[i]`` of a list or a stacked tensor,
    ``eps(i)`` of a callable, None when nothing is injected."""
    if eps is None:
        return None
    return eps(i) if callable(eps) else eps[i]


def stoch_gpmp_step(
    sampler: SamplerModel,
    cost: Any,
    state: StochGPMPState,
    observation: dict,
    *,
    num_samples: int,
    temperature: float,
    step_size: float,
    sample_method: str = "dense",
    shard_samples=None,
    sample_dtype=None,
    plane_stream: bool = False,
    eps: torch.Tensor | None = None,
) -> tuple[StochGPMPState, StochGPMPAux]:
    """One importance-weighted update of all particle means. ``eps``
    replaces the draw from ``state.generator`` (tests inject the JAX
    package's draw): ``[P, S, M]``, or ``[d, P, S, T]`` with
    ``plane_stream``.

    Sampling: one matmul against the dense ``L^{-1}`` (``sample_method
    "dense"`` with the dense factor), else the structured solve ``L^{-T}
    eps`` of the parallel-in-time solver (S1 on the card) or, without one,
    of the Cholesky. ``sample_dtype`` (e.g. ``torch.bfloat16``) draws eps
    and runs the sampling matmul in that precision, a different stream from
    the full-precision one; the correction returns to the means' dtype, so
    the costs, weights and means stay in full precision. ``plane_stream``
    draws and solves in the plane order of the plane path, so this step
    reproduces that path's iteration.

    ``shard_samples``: this rank's place in a mesh
    (``parallel.sharding.Shard``; in the JAX package a sharding constraint
    on the sample batch). ``state`` then holds the rank's particle block,
    ``num_samples`` stays the global count, each rank keeps its block of the
    global draw (or of the injected global ``eps``), the goal-dependent
    costs are viewed on its particles, and the softmax and the update are
    reduced over the ranks of its samples. The aux is the rank's block."""
    means = state.particle_means  # [P, T, d]
    p, t, d = means.shape
    m = t * d
    means_flat = means.reshape(p, m)
    eps_dtype = sample_dtype if sample_dtype is not None else means.dtype
    shard = shard_samples
    if shard is not None:
        num_samples = shard.local_samples(num_samples)
        cost = shard.rows(cost, p)
    with annotate("step.draw"):
        if plane_stream and sampler.psolver is not None:
            if shard is not None:
                eps = shard.draw(state.generator, (d, p, num_samples, t), 1, 2, dtype=eps_dtype,
                                 device=means.device, eps=eps)
            elif eps is None:
                eps = torch.randn((d, p, num_samples, t), generator=state.generator,
                                  dtype=eps_dtype, device=means.device)
            corr_planes = sampler.psolver.solve_LT_planes(
                tuple(eps[i].to(means.dtype) for i in range(d)))
            corr = torch.stack(corr_planes, dim=-1).reshape(p, num_samples, m)
        else:
            if shard is not None:
                eps = shard.draw(state.generator, (p, num_samples, m), 0, 1, dtype=eps_dtype,
                                 device=means.device, eps=eps)
            elif eps is None:
                eps = torch.randn((p, num_samples, m), generator=state.generator,
                                  dtype=eps_dtype, device=means.device)
            eps = eps.to(eps_dtype)
            if sample_method == "dense" and sampler.weight_t is not None:
                # x = mu + eps @ L^{-1}
                corr = (eps @ sampler.weight_t.to(eps_dtype)).to(means.dtype)
            else:
                solver = sampler.psolver if sampler.psolver is not None else sampler.chol
                corr = solver.solve_LT(eps.to(means.dtype).reshape(p, num_samples, t, d)).reshape(
                    p, num_samples, m)
        flat = means_flat[:, None] + corr  # [P, S, M]
        samples = flat.reshape(p, num_samples, t, d)

    with annotate("step.cost"):
        costs = cost.eval(
            samples.reshape(p * num_samples, t, d), observation=observation
        ).reshape(p, num_samples)

    # --- importance correction + tau * x . Sigma^{-1} mu, Sigma^{-1} mu by
    # the exact O(T) factor-graph stencil when the prior is dof-factored ---
    with annotate("step.prior_term"):
        if sampler.dof is not None and sampler.dof.q_i2 is not None:
            prec_u = sampler.dof.matvec_flat(means).reshape(p, m)
        elif sampler.precision_dense is not None:
            prec_u = means_flat @ sampler.precision_dense
        else:
            prec_u = sampler.precision.matvec(means).reshape(p, m)
        costs = costs + temperature * torch.sum(flat * prec_u[:, None], dim=-1)

    # --- softmax re-weighting and mean update ---
    with annotate("step.update"):
        if shard is None:
            weights = torch.softmax(-costs / temperature, dim=1)
            grad_flat = torch.einsum("ps,psm->pm", weights, flat - means_flat[:, None])
        else:
            weights = shard.softmax(-costs / temperature)
            grad_flat = shard.sum_samples(
                torch.einsum("ps,psm->pm", weights, flat - means_flat[:, None]))
        new_means = (means_flat + step_size * grad_flat).reshape(p, t, d)
    return (
        replace(state, particle_means=new_means),
        StochGPMPAux(samples=samples, costs=costs, weights=weights,
                     grad=grad_flat.reshape(p, t, d)),
    )


def _route(sampler, cost, traj_len: int, sample_method: str = "dense",
           sample_dtype=None) -> str:
    """``"dof"``, ``"planes"`` or ``"flat"``, by the JAX package's gates
    (``stoch_gpmp_optimize``'s ``dof_eligible`` and ``plane_eligible``):
    the dof path for a sampler with the per-dof factor and a dof-capable
    stack, opted in by ``sample_method="dof"`` or by a horizon that is a
    multiple of 128; the plane path for a long-horizon sampler (no dense
    factor, a parallel-in-time solver) with d <= 8 and a plane-capable
    stack under ``sample_method="dense"``; the flat path otherwise, and
    always with a ``sample_dtype``."""
    if sample_dtype is not None:
        return "flat"
    if (sampler.dof is not None and cost.supports_dof_planes()
            and (sample_method == "dof" or (sample_method == "dense" and traj_len % 128 == 0))):
        return "dof"
    if _plane_eligible(sampler, cost, sample_method):
        return "planes"
    return "flat"


def _plane_eligible(sampler, cost, sample_method: str) -> bool:
    """The JAX package's ``plane_eligible``: a long-horizon sampler (no
    dense factor, a parallel-in-time solver), d <= 8, a plane-capable
    stack, ``sample_method="dense"``."""
    return (sampler.precision.block_dim <= 8 and sampler.weight_t is None
            and sampler.psolver is not None and sample_method == "dense"
            and getattr(cost, "supports_planes", lambda: False)())


def _plane_metrics(costs, weights, grads, step_size) -> IterMetrics:
    """``IterMetrics`` of plane-layout quantities (``grads [d, P, T]``)."""
    return IterMetrics(
        cost_mean=costs.mean(), cost_min=costs.min(),
        weight_entropy=-torch.sum(weights * torch.log(weights + 1e-30), dim=1).mean(),
        update_norm=(step_size * torch.sqrt(torch.sum(grads * grads, dim=(0, -1)))).mean(),
    )


def _stoch_gpmp_optimize_planes(
    sampler, cost, state, observation, *, opt_iters, num_samples, temperature,
    step_size, collect_metrics=False, eps=None,
):
    """The long-horizon plane path: means ``[d, P, T]`` and samples ``[d,
    P, S, T]`` as per-dim time planes, one tensor each. Per iteration: eps
    ``[d, P, S, T]`` (drawn plane-major, as the JAX package draws it), the
    correction ``L^{-T} eps`` by the parallel-in-time solver (one S1 launch
    on the card), the stack's ``eval_planes`` on the planes of ``x = mu +
    corr`` (a 2D field reads the two position planes in place), the
    importance term against ``Sigma^{-1} mu`` by the structured
    ``matvec_planes``, softmax and update. ``eps``: optional per-iteration
    draws (``[iters, d, P, S, T]``, a list, or a callable of the
    iteration)."""
    p, t, d = state.particle_means.shape
    psolver = sampler.psolver

    def step(mu, eps_i):
        if eps_i is None:
            eps_i = torch.randn((d, p, num_samples, t), generator=state.generator,
                                dtype=mu.dtype, device=mu.device)
        corr = torch.empty_like(eps_i)
        psolver.solve_LT_planes(tuple(eps_i), out=tuple(corr))
        x = mu[:, :, None] + corr  # [d, P, S, T]
        costs = cost.eval_planes(tuple(x), observation=observation)  # [P, S]
        pu = stack_planes(sampler.precision.matvec_planes(tuple(mu)))  # [d, P, T]
        costs = costs + temperature * torch.sum(x * pu[:, :, None], dim=(0, -1))
        weights = torch.softmax(-costs / temperature, dim=1)
        grads = torch.einsum("ps,dpst->dpt", weights, corr)
        return mu + step_size * grads, costs, weights, grads, x

    mu = state.particle_means.permute(2, 0, 1).contiguous()
    metrics = []
    for i in range(opt_iters):
        mu, costs, weights, grads, x = step(mu, _eps_at(eps, i))
        if collect_metrics:
            metrics.append(_plane_metrics(costs, weights, grads, step_size))
    out_state = replace(state, particle_means=mu.permute(1, 2, 0).contiguous())
    aux = StochGPMPAux(samples=x.permute(1, 2, 3, 0).contiguous(), costs=costs,
                       weights=weights, grad=grads.permute(1, 2, 0).contiguous())
    if collect_metrics:
        return out_state, aux, IterMetrics.stack(metrics)
    return out_state, aux


def _dof_quad_split(cost):
    """``(DofQuadraticCost, rest)`` when the stack holds exactly one
    quadratic component (bare or with a ``dof_form``), else ``(None, None)``."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import DofQuadraticCost

    comps = list(getattr(cost, "costs", None) or [cost])
    quads = [
        (i, c if isinstance(c, DofQuadraticCost) else c.dof_form)
        for i, c in enumerate(comps)
        if isinstance(c, DofQuadraticCost) or getattr(c, "dof_form", None) is not None
    ]
    if len(quads) != 1:
        return None, None
    i, dq = quads[0]
    return dq, [c for j, c in enumerate(comps) if j != i]


def _stoch_gpmp_optimize_dof(
    sampler, cost, state, observation, *, opt_iters, num_samples, temperature,
    step_size, collect_metrics=False, shard_dof=None, shard_dof_quad=None, eps=None,
):
    """The dof-factored path: means and samples as dof-leading planes
    ``[d, P(, S), 2T]``; per iteration ``x = mu + eps @ w_dof`` per dof, the
    quadratic and ``tau * x . Sigma^{-1} mu`` in one pass (kernel K3; the
    JAX package runs its kernel only on the TPU, the port on every CUDA
    tensor), the rest of the stack on the planes, softmax, mean update.
    ``eps``: optional per-iteration ``[d, P, S, 2T]`` draws (a list, a
    stacked tensor or a callable of the iteration).

    ``shard_dof``: this rank's place in a mesh (``parallel.sharding.Shard``;
    in the JAX package a sharding constraint on the planes): the state holds
    the rank's particle block, each rank keeps its block of the global draw,
    the softmax and the update are reduced over the ranks of its samples,
    and the cost is viewed on the rank's particles (``Shard.rows``), so K3
    runs on the rank's rows as it runs unsharded. ``shard_dof_quad``: the
    K3 call to use in place of ``stencil.dof_quad_eval`` (same signature;
    ``parallel.sharding._make_shard_dof_quad`` checks the view)."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import from_dof_planes, to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.stencil import dof_quad_eval

    p, t, _ = state.particle_means.shape
    dof = sampler.dof
    shard = shard_dof
    if shard is not None:
        num_samples = shard.local_samples(num_samples)
        cost = shard.rows(cost, p)
    dq, rest = _dof_quad_split(cost)
    quad_eval = shard_dof_quad or dof_quad_eval

    def step(mu, eps_i):
        with annotate("dof.draw"):
            if shard is not None:
                eps_i = shard.draw(state.generator, (mu.shape[0], p, num_samples, 2 * t), 1, 2,
                                   dtype=mu.dtype, device=mu.device, eps=eps_i)
            x, corr = dof.sample_planes(state.generator, mu, num_samples, eps=eps_i)
            x_flat = x.reshape(x.shape[0], p * num_samples, 2 * t)
        with annotate("dof.quad"):
            pu = dof.matvec_planes(mu)  # exact stencil Sigma^{-1} mu, [d, P, 2T]
            if dq is not None:
                costs = quad_eval(dq, x_flat, pu=pu, temperature=temperature,
                                  num_samples=num_samples)
            else:
                costs = temperature * torch.sum(x * pu[:, :, None], dim=(0, -1)).reshape(-1)
        with annotate("dof.fields"):
            for c in rest if dq is not None else [cost]:
                costs = costs + c.eval_dof_planes(x_flat, observation=observation)
            costs = costs.reshape(p, num_samples)
        with annotate("dof.update"):
            if shard is None:
                weights = torch.softmax(-costs / temperature, dim=1)
                grad = torch.einsum("ps,dpsk->dpk", weights, corr)
            else:
                weights = shard.softmax(-costs / temperature)
                grad = shard.sum_samples(torch.einsum("ps,dpsk->dpk", weights, corr))
            new_mu = mu + step_size * grad
        return new_mu, costs, weights, grad, x

    mu = to_dof_planes(state.particle_means)
    metrics = []
    for i in range(opt_iters):
        mu, costs, weights, grad, x = step(mu, _eps_at(eps, i))
        if collect_metrics and shard is not None:
            metrics.append(shard.metrics(costs, weights,
                                         torch.sqrt(torch.sum(grad * grad, dim=(0, -1))),
                                         step_size))
        elif collect_metrics:
            metrics.append(IterMetrics(
                cost_mean=costs.mean(), cost_min=costs.min(),
                weight_entropy=-torch.sum(weights * torch.log(weights + 1e-30), dim=1).mean(),
                update_norm=(step_size * torch.sqrt(torch.sum(grad * grad, dim=(0, -1)))).mean(),
            ))
    out_state = replace(state, particle_means=from_dof_planes(mu))
    aux = StochGPMPAux(samples=from_dof_planes(x), costs=costs, weights=weights,
                       grad=from_dof_planes(grad))
    if collect_metrics:
        return out_state, aux, IterMetrics.stack(metrics)
    return out_state, aux


def stoch_gpmp_optimize(
    sampler: SamplerModel,
    cost: Any,
    state: StochGPMPState,
    observation: dict,
    *,
    opt_iters: int,
    num_samples: int,
    temperature: float,
    step_size: float,
    sample_method: str = "dense",
    shard_samples=None,
    sample_dtype=None,
    collect_metrics: bool = False,
    shard_dof=None,
    shard_dof_quad=None,
    eps=None,
):
    """Run ``opt_iters`` updates on the route ``_route`` picks; returns the
    final state and the last iteration's aux (plus stacked ``IterMetrics``
    with ``collect_metrics``). ``sample_dtype``: the reduced-precision draw
    of ``stoch_gpmp_step``, on the flat path only (as in the JAX package,
    the dof and plane routes refuse it). ``eps``: optional per-iteration
    draws (a list, a stacked tensor or a callable of the iteration): ``[P,
    S, M]`` on the flat path, ``[d, P, S, 2T]`` on the dof path and ``[d, P,
    S, T]`` on the plane path (global draws under a shard hook).

    Sharded (``parallel.sharding``; JAX's sharding constraints become this
    rank's place in a mesh): ``shard_samples`` runs the flat step on the
    rank's block, drawing plane-major (``plane_stream``) where the problem
    is plane-eligible, as the JAX package does, so the trajectories do not
    change with the mesh; ``shard_dof`` (with ``sample_method="dof"``) the
    dof path, K3 on the rank's rows (``shard_dof_quad``: the K3 call, as
    ``parallel.sharding._make_shard_dof_quad`` makes it). A problem the dof
    path cannot take raises under ``shard_dof``, as in the JAX package."""
    if opt_iters < 1:
        raise ValueError(f"opt_iters must be >= 1, got {opt_iters}")
    if eps is not None and not callable(eps) and len(eps) != opt_iters:
        raise ValueError(f"eps holds {len(eps)} draws for {opt_iters} iterations")
    t = state.particle_means.shape[1]
    if shard_samples is not None or shard_dof is not None:
        route = "flat"
        if shard_dof is not None:
            if not (sampler.dof is not None and sample_dtype is None and shard_samples is None
                    and sample_method == "dof" and cost.supports_dof_planes()):
                raise ValueError(
                    "shard_dof requires the dof-factored path: sample_method='dof', a "
                    "sampler with .dof, a dof-capable cost stack, and no "
                    "shard_samples/sample_dtype")
            route = "dof"
    else:
        route = _route(sampler, cost, t, sample_method, sample_dtype)
    count("iterations." + route, opt_iters)
    if route != "flat":
        run = _stoch_gpmp_optimize_dof if route == "dof" else _stoch_gpmp_optimize_planes
        extra = dict(shard_dof=shard_dof, shard_dof_quad=shard_dof_quad) if route == "dof" else {}
        with annotate("planner." + route, n=opt_iters):
            return run(
                sampler, cost, state, observation, opt_iters=opt_iters, num_samples=num_samples,
                temperature=temperature, step_size=step_size, collect_metrics=collect_metrics,
                eps=eps, **extra,
            )
    plane_stream = (shard_samples is not None and sample_dtype is None
                    and _plane_eligible(sampler, cost, sample_method))
    metrics = []
    aux = None
    with annotate("planner.flat", n=opt_iters):
        for i in range(opt_iters):
            state, aux = stoch_gpmp_step(
                sampler, cost, state, observation, num_samples=num_samples,
                temperature=temperature, step_size=step_size, sample_method=sample_method,
                shard_samples=shard_samples, sample_dtype=sample_dtype,
                plane_stream=plane_stream, eps=_eps_at(eps, i),
            )
            if collect_metrics and shard_samples is not None:
                g = aux.grad.reshape(aux.grad.shape[0], -1)
                metrics.append(shard_samples.metrics(aux.costs, aux.weights,
                                                     torch.linalg.norm(g, dim=-1), step_size))
            elif collect_metrics:
                metrics.append(IterMetrics.from_aux(aux, step_size))
    if collect_metrics:
        return state, aux, IterMetrics.stack(metrics)
    return state, aux


class StochGPMP:
    """Stateful wrapper with the reference's API surface (``reset``,
    ``optimize``, ``get_recent_samples``, ``get_traj``,
    ``sample_trajectories``).

    ``fused_kernel=True`` runs ``opt_iters - 1`` iterations through a
    fused iteration kernel (``planners/fused_exec.py``: the dof Panda step
    K5 or the planar step K2, each its CUDA kernel on the card and its plain
    version on the CPU) and the final iteration on the normal path, so the
    reference-shaped 6-tuple comes from a real iteration.

    ``mesh`` (``parallel.make_mesh``, one process per rank): ``optimize``
    runs sharded (``parallel.make_sharded_optimize``; ``sample_method="dof"``
    the dof layout), each rank holding its particle block and samples, and
    returns the global results on every rank, the same as without a mesh up
    to the order of the sums; ``particle_means``, ``get_recent_samples``,
    ``get_traj`` and ``sample_trajectories`` are global too.

    ``device=None`` means the CUDA card (the mesh's device with ``mesh``;
    raises without one); pass ``device="cpu"`` for the plain PyTorch
    versions on the CPU."""

    @annotate("planner.init")
    def __init__(
        self,
        num_particles_per_goal,
        num_samples,
        traj_len,
        opt_iters,
        dt=None,
        n_dof=None,
        step_size=1.0,
        temperature=1.0,
        start_state=None,
        multi_goal_states=None,
        initial_particle_means=None,
        cost=None,
        sigma_start_init=None,
        sigma_start_sample=None,
        sigma_goal_init=None,
        sigma_goal_sample=None,
        sigma_gp_init=None,
        sigma_gp_sample=None,
        seed: int = 0,
        dtype=torch.float32,
        sample_method: str = "dense",
        prng_impl: str | None = None,
        mesh=None,
        fused_kernel: bool = False,
        device=None,
        **kwargs,
    ):
        if prng_impl is not None:
            raise ValueError("prng_impl= names a JAX PRNG implementation; the port draws "
                             "from a torch.Generator seeded with seed=")
        if fused_kernel and mesh is not None:
            raise ValueError("fused_kernel=True is single-chip only (no mesh=)")
        self.mesh = mesh
        self._sharded = None  # (key, run): one slot, rebuilt when the key changes
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        self.fused_kernel = fused_kernel
        self._fused = None  # (key, run): one slot, rebuilt when the key changes
        self.n_dof = n_dof
        self.d_state_opt = 2 * n_dof
        self.dt = dt
        self.traj_len = traj_len
        self.goal_directed = multi_goal_states is not None
        self.num_goals = len(multi_goal_states) if self.goal_directed else 1
        self.num_particles_per_goal = num_particles_per_goal
        self.num_particles = num_particles_per_goal * self.num_goals
        self.num_samples = num_samples
        self.opt_iters = opt_iters
        self.step_size = step_size
        self.temperature = temperature
        self.sigma_start_init = sigma_start_init
        self.sigma_start_sample = sigma_start_sample
        self.sigma_goal_init = sigma_goal_init
        self.sigma_goal_sample = sigma_goal_sample
        self.sigma_gp_init = sigma_gp_init
        self.sigma_gp_sample = sigma_gp_sample
        self.cost = cost
        self.dtype = dtype
        self.sample_method = sample_method
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._recent_aux: StochGPMPAux | None = None
        self.reset(start_state, multi_goal_states, initial_particle_means)

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    @annotate("planner.reset")
    def reset(self, start_state=None, multi_goal_states=None, initial_particle_means=None):
        if start_state is not None:
            self.start_state = self._tensor(start_state)
        if multi_goal_states is not None:
            self.multi_goal_states = self._tensor(multi_goal_states)
        elif not self.goal_directed:
            self.multi_goal_states = None
        goals = self.multi_goal_states if self.goal_directed else None

        if initial_particle_means is not None:
            if isinstance(initial_particle_means, str):
                if initial_particle_means != "const_vel":
                    raise ValueError(initial_particle_means)
                from stoch_gpmp_tpu_torch.gp.prior import const_vel_means

                means = const_vel_means(
                    self.start_state, goals, self.traj_len - 1, self.dt, self.n_dof
                )
                means = means[:, None].repeat(1, self.num_particles_per_goal, 1, 1)
            else:
                means = self._tensor(initial_particle_means)
        else:
            init_prior = make_gp_prior(
                self.n_dof, self.traj_len, self.dt, self.start_state,
                self.sigma_start_init, self.sigma_gp_init,
                sigma_goal=self.sigma_goal_init if self.goal_directed else None,
                goal_states=goals, dtype=self.dtype, device=self.device,
            )
            with annotate("gp.prior_sample"):
                means = init_prior.sample(self.generator, self.num_particles_per_goal)
        particle_means = means.reshape(self.num_particles, self.traj_len, self.d_state_opt)

        sample_prior = make_gp_prior(
            self.n_dof, self.traj_len, self.dt, self.start_state,
            self.sigma_start_sample, self.sigma_gp_sample,
            sigma_goal=self.sigma_goal_sample if self.goal_directed else None,
            goal_states=goals, dtype=self.dtype, device=self.device,
        )
        self.sampler = SamplerModel.from_prior(sample_prior)
        self.state = StochGPMPState(particle_means=particle_means, generator=self.generator)
        self._fused = None  # the executor closes over the sampler
        self._means = particle_means
        if self.mesh is not None:
            from stoch_gpmp_tpu_torch.parallel import shard_planner_state

            self.state = shard_planner_state(self.mesh, self.state)
            self._sharded = None
        self.last_metrics: IterMetrics | None = None

    @property
    def particle_means(self) -> torch.Tensor:
        """The means ``[P, T, d]`` (all particles on every rank under a
        mesh)."""
        return self.state.particle_means if self.mesh is None else self._means

    @property
    def Sigma_inv(self) -> BlockTridiag:
        """The sampling distribution's structured precision (``.to_dense()``
        gives the reference's dense ``Sigma_inv``)."""
        return self.sampler.precision

    def optimize(self, opt_iters=None, debug=False, observation=None, collect_metrics=False,
                 **obs_kwargs):
        """Returns the reference's 6-tuple ``(state_particles,
        control_particles, state_trajectories, control_samples, costs, grad)``;
        with ``collect_metrics`` the per-iteration ``IterMetrics`` land in
        ``self.last_metrics``. ``debug`` is accepted in the JAX package's
        position and, as there, changes nothing."""
        observation = dict(observation or {})
        observation.update(obs_kwargs)
        iters = self.opt_iters if opt_iters is None else opt_iters
        with annotate("planner.optimize", n=iters):
            return self._optimize(observation, iters, collect_metrics)

    def _optimize(self, observation: dict, iters: int, collect_metrics: bool):
        if self.fused_kernel and not collect_metrics and iters > 1:
            run = self._fused_runner(observation)
            with annotate("planner.fused_loop", n=iters - 1, device=self.device.type == "cuda"):
                self.state = run(self.state, iters - 1)
            count("iterations.fused", iters - 1)
            iters = 1  # final iteration on the flat path -> full aux
        if self.mesh is not None:
            out = self._sharded_runner(iters, collect_metrics)(
                self.sampler, self.cost, self.state, observation)
        else:
            out = stoch_gpmp_optimize(
                self.sampler, self.cost, self.state, observation, opt_iters=iters,
                num_samples=self.num_samples, temperature=self.temperature,
                step_size=self.step_size, sample_method=self.sample_method,
                collect_metrics=collect_metrics,
            )
        if collect_metrics:
            self.state, aux, self.last_metrics = out
        else:
            self.state, aux = out
        if self.mesh is not None:  # the global results, on every rank
            shard = self._sharded[1].shard
            self._means = shard.gather_particles(self.state.particle_means)
            aux = StochGPMPAux(samples=shard.gather_samples(aux.samples),
                               costs=shard.gather_samples(aux.costs),
                               weights=shard.gather_samples(aux.weights),
                               grad=shard.gather_particles(aux.grad))
        self._recent_aux = aux
        n = self.n_dof
        means = self.particle_means
        return (
            means[..., :n], means[..., n:],
            aux.samples[..., :n], aux.samples[..., n:],
            aux.costs, aux.grad,
        )

    def _fused_runner(self, observation: dict):
        """The fused executor, kept in one slot keyed on what it bakes in:
        the cost object, the obstacle spheres and the statics (the sampler is
        reset with it)."""
        spheres = observation.get("obstacle_spheres", None)
        skey = None if spheres is None else torch.as_tensor(spheres).cpu().numpy().tobytes()
        key = (id(self.cost), skey, self.num_samples, self.temperature, self.step_size)
        if self._fused is None or self._fused[0] != key:
            from stoch_gpmp_tpu_torch.planners.fused_exec import build_fused_executor

            with annotate("planner.fused_build"):
                run, reason = build_fused_executor(
                    self.sampler, self.cost, observation,
                    num_particles=self.num_particles, num_samples=self.num_samples,
                    temperature=self.temperature, step_size=self.step_size,
                )
            if run is None:
                raise ValueError(f"fused_kernel=True but the stack is ineligible: {reason}")
            count("executor_builds")
            self._fused = (key, run)
        return self._fused[1]

    def _sharded_runner(self, iters: int, collect_metrics: bool):
        """The sharded optimize (``mesh=``), kept in one slot keyed, as the
        JAX package keys its cache, on every static the unsharded path reads
        per call."""
        key = (iters, collect_metrics, self.num_samples, self.temperature, self.step_size,
               self.sample_method)
        if self._sharded is None or self._sharded[0] != key:
            from stoch_gpmp_tpu_torch.parallel import make_sharded_optimize

            layout = "dof" if self.sample_method == "dof" else "flat"
            kw = {} if layout == "dof" else {"sample_method": self.sample_method}
            self._sharded = (key, make_sharded_optimize(
                self.mesh, layout=layout, opt_iters=iters, num_samples=self.num_samples,
                temperature=self.temperature, step_size=self.step_size,
                collect_metrics=collect_metrics, **kw))
        return self._sharded[1]

    def get_recent_samples(self):
        """(sample positions, sample velocities) of the last optimize call,
        ``[P, S, T, n_dof]`` each."""
        n = self.n_dof
        return self._recent_aux.samples[..., :n], self._recent_aux.samples[..., n:]

    @annotate("planner.get_traj")
    def get_traj(self, mode: str = "best"):
        """The globally highest-weight sample of the last call, or the means."""
        if mode == "best":
            aux = self._recent_aux
            p, s = divmod(int(torch.argmax(aux.weights.reshape(-1))), self.num_samples)
            return aux.samples[p, s]
        if mode == "mean":
            return self.particle_means
        raise ValueError(f"unknown mode: {mode}")

    def sample_trajectories(self, num_samples_per_particle: int):
        """Fresh draws around the current means: (positions, velocities);
        through the dense ``L^{-1}``, or the structured solve in long-horizon
        mode."""
        samples = sample_around(self.sampler, self.particle_means,
                                num_samples_per_particle, self.generator)
        n = self.n_dof
        return samples[..., :n], samples[..., n:]


def sample_around(sampler, means, num_samples: int, generator) -> torch.Tensor:
    """``[P, S, T, d]`` draws around ``means [P, T, d]`` from ``sampler``
    (a ``SamplerModel`` or a ``GPPrior``), corrected by
    ``gp.prior.sample_correction``'s automatic choice."""
    p, t, d = means.shape
    eps = torch.randn((p, num_samples, t, d), generator=generator,
                      dtype=means.dtype, device=means.device)
    return means[:, None] + sample_correction(sampler, eps)
