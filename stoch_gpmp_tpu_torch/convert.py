"""Carry a problem built by the JAX package over to the port.

``sampler_from_jax``, ``cost_from_jax`` and ``state_from_jax`` read the JAX
objects' fields through ``np.asarray`` and rebuild the port's objects on a
given device and dtype. They dispatch on class names, so this module never
imports JAX. The PRNG key does not cross: the port's generator is seeded
separately.
"""

from __future__ import annotations

import numpy as np
import torch

from stoch_gpmp_tpu_torch.costs.costs import CostCollision, CostComposite, CostGP, CostGoalPrior
from stoch_gpmp_tpu_torch.costs.fields import OccupancyGridField, RasterPrimitive2DField
from stoch_gpmp_tpu_torch.costs.quadratic import QuadraticCost
from stoch_gpmp_tpu_torch.gp.dof_factored import DofFactoredPrior, DofQuadraticCost
from stoch_gpmp_tpu_torch.gp.tridiag import BlockTridiag
from stoch_gpmp_tpu_torch.planners.stoch_gpmp import SamplerModel, StochGPMPState


def _kind(obj) -> str:
    return type(obj).__name__


def _t(x, dtype, device):
    return None if x is None else torch.as_tensor(np.array(x), dtype=dtype, device=device)


def sampler_from_jax(sampler, *, device=None, dtype=torch.float64) -> SamplerModel:
    """``SamplerModel`` (flat-path sampler: dense factor + per-dof factor)."""
    if sampler.weight_t is None:
        raise NotImplementedError("long-horizon samplers are not ported yet")
    t = lambda x: _t(x, dtype, device)  # noqa: E731
    dof = sampler.dof
    return SamplerModel(
        precision=BlockTridiag(t(sampler.precision.diag), t(sampler.precision.lower)),
        weight_t=t(sampler.weight_t),
        precision_dense=t(sampler.precision_dense),
        dof=None if dof is None else DofFactoredPrior(
            w_dof=t(dof.w_dof), prec_dof=t(dof.prec_dof), traj_len=int(dof.traj_len),
            q_i2=t(dof.q_i2), k_s2=t(dof.k_s2), k_g2=t(dof.k_g2), dt=float(dof.dt),
        ),
    )


def _field_from_jax(field, dtype, device):
    kind = _kind(field)
    if kind == "RasterPrimitive2DField":
        return RasterPrimitive2DField(
            rect_bounds=torch.as_tensor(np.array(field.rect_bounds, dtype=np.int32),
                                        device=device),
            circles=_t(field.circles, dtype, device),
            cell_size=float(field.cell_size), nx=int(field.nx), ny=int(field.ny),
        )
    if kind == "OccupancyGridField":
        return OccupancyGridField(grid=_t(field.grid, dtype, device),
                                  cell_size=float(field.cell_size))
    raise NotImplementedError(f"field {kind} is not ported yet")


def _dof_quad_from_jax(dq, dtype, device):
    t = lambda x: _t(x, dtype, device)  # noqa: E731
    return DofQuadraticCost(
        a_dof=t(dq.a_dof), b_planes=t(dq.b_planes), c=t(dq.c),
        num_goals=int(dq.num_goals), n_dof=int(dq.n_dof), traj_len=int(dq.traj_len),
        q_i2=t(dq.q_i2), k_s2=t(dq.k_s2), k_g2=t(dq.k_g2), s_pd=t(dq.s_pd),
        g_pd=t(dq.g_pd), dt=float(dq.dt),
    )


def cost_from_jax(cost, *, device=None, dtype=torch.float64):
    """``CostComposite`` of ``QuadraticCost`` / ``CostGP`` / ``CostGoalPrior``
    / ``CostCollision(RasterPrimitive2DField | OccupancyGridField)``, or one
    of those alone."""
    t = lambda x: _t(x, dtype, device)  # noqa: E731
    kind = _kind(cost)
    if kind == "CostComposite":
        if cost.fk is not None:
            raise NotImplementedError("forward-kinematics stacks are not ported yet")
        return CostComposite(
            costs=tuple(cost_from_jax(c, device=device, dtype=dtype) for c in cost.costs),
            n_dof=int(cost.n_dof), traj_len=int(cost.traj_len),
        )
    if kind == "QuadraticCost":
        return QuadraticCost(
            a_dense=t(cost.a_dense), b=t(cost.b), c=t(cost.c), num_goals=int(cost.num_goals),
            traj_len=int(cost.traj_len), state_dim=int(cost.state_dim),
            dof_form=None if cost.dof_form is None
            else _dof_quad_from_jax(cost.dof_form, dtype, device),
            stencil_required=bool(cost.stencil_required),
        )
    if kind == "CostGP":
        return CostGP(start_state=t(cost.start_state), k_start=t(cost.k_start),
                      q_inv=t(cost.q_inv), phi=t(cost.phi))
    if kind == "CostGoalPrior":
        return CostGoalPrior(multi_goal_states=t(cost.multi_goal_states),
                             k_goal=t(cost.k_goal), num_goals=int(cost.num_goals))
    if kind == "CostCollision":
        return CostCollision(
            field=_field_from_jax(cost.field, dtype, device),
            sigma_coll=float(cost.sigma_coll), n_dof=int(cost.n_dof),
            traj_range=tuple(cost.traj_range),
        )
    raise NotImplementedError(f"cost {kind} is not ported yet")


def state_from_jax(state, *, seed: int = 0, device=None, dtype=torch.float64) -> StochGPMPState:
    """``StochGPMPState``: the particle means cross; the key does not, the
    port's generator is seeded with ``seed``."""
    return StochGPMPState(
        particle_means=_t(state.particle_means, dtype, device),
        generator=torch.Generator(device=device or "cpu").manual_seed(seed),
    )
