"""Carry a problem built by the JAX package over to the port.

``sampler_from_jax``, ``cost_from_jax``, ``state_from_jax``,
``gpmp_state_from_jax``, ``chain_from_jax``, ``link_state_from_jax`` and
``observation_from_jax`` read the JAX objects' fields through ``np.asarray`` and rebuild the port's
objects on a given device and dtype. They dispatch on class names, so this
module never imports JAX. A composite's ``fk=`` (a JAX chain's ``fk`` or
``fk_compact``) becomes the same method of the converted chain. An
``OccupancyGridField``'s ``lookup=`` (a TPU execution choice with equal
results) does not cross: the port has one grid field. The PRNG key does not
cross: the port's generator is seeded separately.
``device=None`` means the CUDA card (raises without one); pass
``device="cpu"`` to build on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from stoch_gpmp_tpu_torch.costs.costs import (
    CostCollision,
    CostComposite,
    CostGoal,
    CostGoalPrior,
    CostGP,
    CostGPTrajectory,
)
from stoch_gpmp_tpu_torch.costs.fields import (
    EESE3DistanceField,
    LinkDistanceField,
    LinkSelfDistanceField,
    MeshSphereDistanceField,
    MeshSphereFloorField,
    OccupancyGridField,
    Primitive2DField,
    RasterPrimitive2DField,
)
from stoch_gpmp_tpu_torch.costs.fused_fields import FusedLinkFieldsCost, PlaneFieldsCost
from stoch_gpmp_tpu_torch.costs.quadratic import QuadraticCost
from stoch_gpmp_tpu_torch.gp.dof_factored import DofFactoredPrior, DofQuadraticCost
from stoch_gpmp_tpu_torch.gp.tridiag import BlockBidiagChol, BlockTridiag, ParallelBidiagSolver
from stoch_gpmp_tpu_torch.kinematics import JointSpec, KinematicChain, LinkState, RobotModel
from stoch_gpmp_tpu_torch.planners.gpmp import GPMPState
from stoch_gpmp_tpu_torch.planners.stoch_gpmp import SamplerModel, StochGPMPState
from stoch_gpmp_tpu_torch.utils.device import resolve_device


def _kind(obj) -> str:
    return type(obj).__name__


def _t(x, dtype, device):
    return None if x is None else torch.as_tensor(np.array(x), dtype=dtype, device=device)


def sampler_from_jax(sampler, *, device=None, dtype=torch.float64) -> SamplerModel:
    """``SamplerModel``: the dense factor or, for a long-horizon sampler,
    the parallel-in-time solver (its ``dinv``, ``a_fwd`` and ``a_bwd``
    carried across, the kernel's chunk tables built from them), the
    Cholesky and the per-dof factor."""
    device = resolve_device(device)
    t = lambda x: _t(x, dtype, device)  # noqa: E731
    dof, ps = sampler.dof, sampler.psolver
    return SamplerModel(
        precision=BlockTridiag(t(sampler.precision.diag), t(sampler.precision.lower)),
        weight_t=t(sampler.weight_t),
        precision_dense=t(sampler.precision_dense),
        dof=None if dof is None else DofFactoredPrior(
            w_dof=t(dof.w_dof), prec_dof=t(dof.prec_dof), traj_len=int(dof.traj_len),
            q_i2=t(dof.q_i2), k_s2=t(dof.k_s2), k_g2=t(dof.k_g2), dt=float(dof.dt),
        ),
        chol=BlockBidiagChol(t(sampler.chol.diag), t(sampler.chol.lower)),
        psolver=None if ps is None else ParallelBidiagSolver.from_tables(
            t(ps.dinv), t(ps.a_fwd), t(ps.a_bwd)),
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
    if kind == "Primitive2DField":
        return Primitive2DField(rects=_t(field.rects, dtype, device),
                                circles=_t(field.circles, dtype, device))
    if kind == "OccupancyGridField":
        return OccupancyGridField(grid=_t(field.grid, dtype, device),
                                  cell_size=float(field.cell_size))
    if kind == "LinkDistanceField":
        return LinkDistanceField(
            field_type=field.field_type, clamp_sdf=bool(field.clamp_sdf),
            num_interpolate=int(field.num_interpolate),
            link_interpolate_range=tuple(field.link_interpolate_range))
    if kind == "LinkSelfDistanceField":
        return LinkSelfDistanceField(
            margin=float(field.margin), num_interpolate=int(field.num_interpolate),
            link_interpolate_range=tuple(field.link_interpolate_range))
    if kind == "MeshSphereDistanceField":
        return MeshSphereDistanceField(
            link_indices=tuple(int(i) for i in field.link_indices),
            centers=tuple(_t(c, dtype, device) for c in field.centers),
            radii=tuple(_t(r, dtype, device) for r in field.radii))
    if kind == "MeshSphereFloorField":
        return MeshSphereFloorField(mesh=_field_from_jax(field.mesh, dtype, device),
                                    floor_z=float(field.floor_z), width=float(field.width))
    if kind == "EESE3DistanceField":
        return EESE3DistanceField(target_h=_t(field.target_h, dtype, device),
                                  w_pos=float(field.w_pos), w_rot=float(field.w_rot),
                                  square=bool(field.square))
    raise NotImplementedError(f"field {kind} is not ported yet")


def _fk_from_jax(fk):
    """A JAX chain's bound ``fk`` / ``fk_compact`` as the same method of the
    converted chain."""
    if fk is None:
        return None
    name = getattr(fk, "__name__", None)
    if name not in ("fk", "fk_compact") or not hasattr(fk, "__self__"):
        raise NotImplementedError(f"fk={fk!r}: only a chain's fk or fk_compact is ported")
    return getattr(chain_from_jax(fk.__self__), name)


def _dof_quad_from_jax(dq, dtype, device):
    t = lambda x: _t(x, dtype, device)  # noqa: E731
    return DofQuadraticCost(
        a_dof=t(dq.a_dof), b_planes=t(dq.b_planes), c=t(dq.c),
        num_goals=int(dq.num_goals), n_dof=int(dq.n_dof), traj_len=int(dq.traj_len),
        q_i2=t(dq.q_i2), k_s2=t(dq.k_s2), k_g2=t(dq.k_g2), s_pd=t(dq.s_pd),
        g_pd=t(dq.g_pd), dt=float(dq.dt),
    )


def cost_from_jax(cost, *, device=None, dtype=torch.float64):
    """``CostComposite`` (with its ``fk``) of ``QuadraticCost`` / ``CostGP``
    / ``CostGPTrajectory`` / ``CostGoalPrior`` / ``CostCollision`` (a 2D, a
    link or a mesh-sphere field) /
    ``CostGoal(EESE3DistanceField)`` / ``FusedLinkFieldsCost`` /
    ``PlaneFieldsCost``, or one of those alone."""
    device = resolve_device(device)
    t = lambda x: _t(x, dtype, device)  # noqa: E731
    kind = _kind(cost)
    if kind == "CostComposite":
        return CostComposite(
            costs=tuple(cost_from_jax(c, device=device, dtype=dtype) for c in cost.costs),
            n_dof=int(cost.n_dof), traj_len=int(cost.traj_len), fk=_fk_from_jax(cost.fk),
        )
    if kind == "QuadraticCost":
        return QuadraticCost(
            a_dense=t(cost.a_dense), a_diag=t(cost.a_diag), a_lower=t(cost.a_lower),
            b=t(cost.b), c=t(cost.c), num_goals=int(cost.num_goals),
            traj_len=int(cost.traj_len), state_dim=int(cost.state_dim),
            dof_form=None if cost.dof_form is None
            else _dof_quad_from_jax(cost.dof_form, dtype, device),
            stencil_required=bool(cost.stencil_required),
        )
    if kind == "CostGP":
        return CostGP(start_state=t(cost.start_state), k_start=t(cost.k_start),
                      q_inv=t(cost.q_inv), phi=t(cost.phi))
    if kind == "CostGPTrajectory":
        return CostGPTrajectory(q_inv=t(cost.q_inv), phi=t(cost.phi))
    if kind == "CostGoalPrior":
        return CostGoalPrior(multi_goal_states=t(cost.multi_goal_states),
                             k_goal=t(cost.k_goal), num_goals=int(cost.num_goals))
    if kind == "CostCollision":
        return CostCollision(
            field=_field_from_jax(cost.field, dtype, device),
            sigma_coll=float(cost.sigma_coll), n_dof=int(cost.n_dof),
            traj_range=tuple(cost.traj_range),
        )
    if kind == "CostGoal":
        return CostGoal(field=_field_from_jax(cost.field, dtype, device),
                        sigma_goal=float(cost.sigma_goal), n_dof=int(cost.n_dof))
    if kind == "FusedLinkFieldsCost":
        return FusedLinkFieldsCost(margin=float(cost.margin), sigma_self=float(cost.sigma_self),
                                   sigma_coll=float(cost.sigma_coll))
    if kind == "PlaneFieldsCost":
        return PlaneFieldsCost(
            chain=chain_from_jax(cost.chain), target_h=t(cost.target_h),
            n_dof=int(cost.n_dof), traj_len=int(cost.traj_len), margin=float(cost.margin),
            sigma_self=float(cost.sigma_self), sigma_coll=float(cost.sigma_coll),
            sigma_goal=float(cost.sigma_goal), w_pos=float(cost.w_pos), w_rot=float(cost.w_rot),
        )
    raise NotImplementedError(f"cost {kind} is not ported yet")


def chain_from_jax(chain) -> KinematicChain:
    """``KinematicChain`` rebuilt from the JAX chain's model joints (the
    gripper's prismatic fingers included), its selected links and its dtype
    (that of the joint-limit tensors; FK runs in ``q``'s dtype)."""
    model = chain.model
    joints = tuple(
        JointSpec(name=j.name, joint_type=j.joint_type, parent_link=j.parent_link,
                  child_link=j.child_link, origin_xyz=tuple(j.origin_xyz),
                  origin_rpy=tuple(j.origin_rpy), axis=tuple(j.axis),
                  limit_lower=j.limit_lower, limit_upper=j.limit_upper,
                  limit_velocity=j.limit_velocity, limit_effort=j.limit_effort)
        for j in model.joints
    )
    return KinematicChain(RobotModel(name=model.name, joints=joints, links=tuple(model.links)),
                          link_names=list(chain.link_names),
                          dtype=getattr(torch, np.dtype(chain.dtype).name))


def link_state_from_jax(links, *, device=None, dtype=torch.float64) -> LinkState:
    """A JAX ``LinkState`` (link positions and end-effector rotation)."""
    device = resolve_device(device)
    return LinkState(positions=_t(links.positions, dtype, device),
                     ee_rot=_t(links.ee_rot, dtype, device))


def observation_from_jax(observation: dict, *, device=None, dtype=torch.float64) -> dict:
    """The observation dict with its arrays (e.g. ``obstacle_spheres``) as
    tensors."""
    device = resolve_device(device)
    return {k: _t(v, dtype, device) for k, v in observation.items()}


def state_from_jax(state, *, seed: int = 0, device=None, dtype=torch.float64) -> StochGPMPState:
    """``StochGPMPState``: the particle means cross; the key does not, the
    port's generator is seeded with ``seed``."""
    device = resolve_device(device)
    return StochGPMPState(
        particle_means=_t(state.particle_means, dtype, device),
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def gpmp_state_from_jax(state, *, seed: int = 0, device=None, dtype=torch.float64) -> GPMPState:
    """``GPMPState``: the particle means cross; the key does not, the port's
    generator is seeded with ``seed``."""
    device = resolve_device(device)
    return GPMPState(
        particle_means=_t(state.particle_means, dtype, device),
        generator=torch.Generator(device=device).manual_seed(seed),
    )
