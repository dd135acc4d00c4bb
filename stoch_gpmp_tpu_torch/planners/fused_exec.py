"""Class-level executors for the fused iteration kernels.

PyTorch counterpart of ``stoch_gpmp_tpu/planners/fused_exec.py``.
``StochGPMP(fused_kernel=True)`` runs ``opt_iters - 1`` iterations through
a fused step and the final iteration on the normal path:

- the dof Panda step K5 (``ops/kernels/panda_step_dof.py``) for
  ``CostComposite([QuadraticCost, PlaneFieldsCost])``;
- the planar step K2 (``ops/kernels/fused_step.py``) for
  ``CostComposite([QuadraticCost, CostCollision(RasterPrimitive2DField)])``.

Each is its CUDA kernel on the card and its plain version on the CPU. A
fused step draws its own random numbers (in-kernel Philox on the card), a
different stream from the normal path's; the per-iteration aux is never
materialized, which is why it is the fast path.

``build_*`` return ``(run, None)`` or ``(None, reason)`` so the caller can
say why a stack is ineligible.
"""

from __future__ import annotations

from dataclasses import replace

from stoch_gpmp_tpu_torch.costs.costs import CostCollision, CostComposite
from stoch_gpmp_tpu_torch.costs.fields import RasterPrimitive2DField
from stoch_gpmp_tpu_torch.costs.fused_fields import PlaneFieldsCost
from stoch_gpmp_tpu_torch.costs.quadratic import QuadraticCost

_PANDA_STACK = "cost must be CostComposite([QuadraticCost, PlaneFieldsCost])"


def build_fused_dof_executor(
    sampler, cost, observation: dict, *, num_particles: int, num_samples: int,
    temperature: float, step_size: float,
):
    """The fused dof Panda iteration for the stack
    ``CostComposite([QuadraticCost, PlaneFieldsCost])``. Returns ``(run,
    None)`` or ``(None, reason)``; ``run(state, opt_iters)`` returns the
    state after ``opt_iters`` fused iterations."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import from_dof_planes, to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import (
        fused_panda_dof_optimize,
        make_fused_panda_dof_step,
    )

    if sampler.dof is None:
        return None, "sampler has no dof factor (needs scalar sigmas, 2T <= 2048)"
    if not isinstance(cost, CostComposite) or len(cost.costs) != 2:
        return None, _PANDA_STACK
    quad = next((c for c in cost.costs if isinstance(c, QuadraticCost)), None)
    fields = next((c for c in cost.costs if isinstance(c, PlaneFieldsCost)), None)
    if quad is None or fields is None:
        return None, _PANDA_STACK
    if quad.dof_form is None:
        return None, "QuadraticCost has no dof form (needs scalar sigmas)"
    t = fields.traj_len
    if t % 128 != 0:
        return None, f"traj_len={t} not a multiple of 128 (plane lanes)"
    spheres = (observation or {}).get("obstacle_spheres", None)
    if spheres is None:
        return None, "observation['obstacle_spheres'] required"
    if quad.dof_form.num_goals and num_particles % quad.dof_form.num_goals:
        return None, "num_particles must divide evenly across goals"

    step = make_fused_panda_dof_step(
        chain=fields.chain, dof_prior=sampler.dof, dof_quad=quad.dof_form,
        num_particles=num_particles, spheres=spheres, target_h=fields.target_h,
        n_dof=fields.n_dof, traj_len=t, num_samples=num_samples, margin=fields.margin,
        w_self=1.0 / fields.sigma_self**2, w_obst=1.0 / fields.sigma_coll**2,
        w_goal=1.0 / fields.sigma_goal**2, w_pos=fields.w_pos, w_rot=fields.w_rot,
        temperature=temperature, step_size=step_size,
    )

    def run(state, opt_iters: int):
        mu = fused_panda_dof_optimize(
            step, to_dof_planes(state.particle_means), state.generator, opt_iters)
        return replace(state, particle_means=from_dof_planes(mu))

    run.step = step
    return run, None

_STACK = "cost must be CostComposite([QuadraticCost, CostCollision(RasterPrimitive2DField)])"


def build_fused_planar_executor(
    sampler, cost, observation: dict, *, num_particles: int, num_samples: int,
    temperature: float, step_size: float,
):
    """The fused planar iteration for the stack
    ``CostComposite([QuadraticCost, CostCollision(RasterPrimitive2DField)])``
    at d=2. Returns ``(run, None)`` or ``(None, reason)``; ``run(state,
    opt_iters)`` returns the state after ``opt_iters`` fused iterations."""
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (
        fused_planar_optimize_batched,
        make_fused_planar_step_batched,
    )

    if not isinstance(cost, CostComposite) or len(cost.costs) != 2:
        return None, _STACK
    quad = next((c for c in cost.costs if isinstance(c, QuadraticCost)), None)
    coll = next((c for c in cost.costs if isinstance(c, CostCollision)), None)
    if quad is None or coll is None or not isinstance(coll.field, RasterPrimitive2DField):
        return None, _STACK
    if quad.dof_form is None:
        return None, "QuadraticCost has no dof form (needs scalar sigmas)"
    if coll.n_dof != 2:
        return None, "planar fused kernel is d=2 only"
    if sampler.weight_t is None:
        return None, "sampler has no dense factor (long-horizon mode)"
    if sampler.dof is None:
        return None, "sampler has no dof factor (needs scalar sigmas)"
    t = cost.traj_len
    if coll.traj_range != (1, t):
        return None, ("collision slice must be the reference default (1, T) "
                      "— the kernel masks exactly t=0")
    if (4 * t) % 32 != 0 or 4 * t > 512:
        return None, (f"traj_len={t}: the kernel runs one thread per lane and "
                      "needs M=4T a multiple of 32 and at most 512")

    field = coll.field
    step = make_fused_planar_step_batched(
        weight_t=sampler.weight_t, dof_prior=sampler.dof, dof_quad=quad.dof_form,
        num_particles=num_particles, rect_bounds=field.rect_bounds,
        circles=field.circles, cell_size=field.cell_size, nx=field.nx, ny=field.ny,
        traj_len=t, state_dim=4, num_samples=num_samples,
        k_coll=1.0 / coll.sigma_coll**2, temperature=temperature, step_size=step_size,
    )

    def run(state, opt_iters: int):
        means = fused_planar_optimize_batched(
            step, state.particle_means, state.generator, opt_iters
        )
        return replace(state, particle_means=means)

    run.step = step
    return run, None


def build_fused_executor(sampler, cost, observation, **kw):
    """Try every fused-kernel executor for this stack, the dof Panda one
    first; returns ``(run, None)`` on the first match or ``(None, combined
    reasons)``."""
    run, r_panda = build_fused_dof_executor(sampler, cost, observation, **kw)
    if run is not None:
        return run, None
    run, r_planar = build_fused_planar_executor(sampler, cost, observation, **kw)
    if run is not None:
        return run, None
    return None, f"panda kernel: {r_panda}; planar kernel: {r_planar}"
