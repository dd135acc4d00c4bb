"""Damped-least-squares inverse kinematics.

PyTorch counterpart of ``stoch_gpmp_tpu/kinematics/ik.py``: Gauss-Newton on
the 6D pose error (translation and the SO(3) log-map rotation vector) with
joint-limit clamping, batched over starts, and the multi-start solve that
keeps, among the near-best solutions, the one closest to ``q_init``.

Each iteration takes the Jacobian of every start's error by forward-mode
autodiff (the JAX package's ``jax.jacfwd`` under ``jax.vmap``): one FK pass
on dual tensors over ``n`` copies of the batch, copy ``k`` carrying the
tangent ``e_k``, so the ``[B, 6, n]`` Jacobian comes from a single batched
evaluation. Then the batched damped ``[n, n]`` normal equations are solved.
"""

from __future__ import annotations

import math

import torch
import torch.autograd.forward_ad as fwAD

from stoch_gpmp_tpu_torch.kinematics.chain import KinematicChain
from stoch_gpmp_tpu_torch.kinematics.se3 import se3_distance


def pose_error(h: torch.Tensor, target_h: torch.Tensor) -> torch.Tensor:
    """6D error ``[..., 6]`` between poses ``[..., 4, 4]``: ``target - p``
    and the log map ``theta * axis`` of ``R_target R^T``. The bare skew part
    ``sin(theta) * axis`` vanishes at 180-degree flips; the log map does
    not, and the clamps keep it finite near ``theta = pi``."""
    dt = target_h[..., :3, 3] - h[..., :3, 3]
    r_err = target_h[..., :3, :3] @ h[..., :3, :3].transpose(-1, -2)
    skew = 0.5 * torch.stack([
        r_err[..., 2, 1] - r_err[..., 1, 2],
        r_err[..., 0, 2] - r_err[..., 2, 0],
        r_err[..., 1, 0] - r_err[..., 0, 1],
    ], dim=-1)  # = sin(theta) * axis
    tr = r_err[..., 0, 0] + r_err[..., 1, 1] + r_err[..., 2, 2]
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos)
    sin = torch.sqrt(torch.clamp(1.0 - cos * cos, min=1e-12))
    return torch.cat([dt, skew * (theta / sin)[..., None]], dim=-1)


def _error_and_jacobian(err_fn, q):
    """``(e [B, 6], J = de/dq [B, 6, n])`` of ``err_fn`` at ``q [B, n]`` by
    forward mode: the batch repeated ``n`` times with one-hot tangents."""
    b, n = q.shape
    tangents = torch.eye(n, dtype=q.dtype, device=q.device).repeat_interleave(b, dim=0)
    with fwAD.dual_level():
        out = fwAD.unpack_dual(err_fn(fwAD.make_dual(q.repeat(n, 1), tangents)))
    return out.primal[:b], out.tangent.reshape(n, b, -1).permute(1, 2, 0)


def _limits(chain: KinematicChain, q: torch.Tensor):
    return (chain.limits_lower.to(device=q.device, dtype=q.dtype),
            chain.limits_upper.to(device=q.device, dtype=q.dtype))


def solve_ik(
    chain: KinematicChain,
    target_h: torch.Tensor,
    q_init: torch.Tensor,
    *,
    num_iters: int = 100,
    damping: float = 1e-2,
    step_size: float = 1.0,
    clamp_limits: bool = True,
) -> torch.Tensor:
    """Solve ``fk(q) ~= target_h`` from ``q_init [n_dof]`` or a batch of
    starts ``[B, n_dof]``: ``num_iters`` steps ``q += step_size * dq`` with
    ``dq = -(J^T J + damping I)^{-1} J^T e``, ``e = pose_error(ee_pose(q),
    target_h)`` and ``J = de/dq``, clamped to the joint limits."""
    target_h = target_h.to(device=q_init.device, dtype=q_init.dtype)

    def err_fn(q):  # [B, n] -> [B, 6]
        return pose_error(chain.ee_pose(q), target_h)

    single = q_init.dim() == 1
    q = q_init[None] if single else q_init
    lo, hi = _limits(chain, q)
    eye = torch.eye(chain.n_dofs, dtype=q.dtype, device=q.device)
    for _ in range(num_iters):
        e, j = _error_and_jacobian(err_fn, q)  # [B, 6], [B, 6, n]
        jt = j.transpose(-1, -2)
        dq = -torch.linalg.solve(jt @ j + damping * eye, (jt @ e[..., None]))[..., 0]
        q = q + step_size * dq
        if clamp_limits:
            q = torch.minimum(torch.maximum(q, lo), hi)
    return q[0] if single else q


def solve_ik_multistart(
    chain: KinematicChain,
    target_h: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    num_starts: int = 16,
    q_init: torch.Tensor | None = None,
    num_iters: int = 100,
    damping: float = 1e-2,
    step_size: float = 1.0,
    starts: torch.Tensor | None = None,
) -> torch.Tensor:
    """Random-restart IK: :func:`solve_ik` from ``num_starts`` configurations
    drawn uniformly inside the joint limits (``[-pi, pi]`` where a limit is
    infinite), plus ``q_init`` first when given, all solved as one batch.
    Returns the solution with the lowest ``se3_distance`` to the target; with
    ``q_init``, among the solutions within 0.05 of the best, the one closest
    to ``q_init`` in joint space.

    The draw comes from ``generator``; ``starts`` (``[num_starts, n_dof]``
    in ``[0, 1)``) replaces it, as the JAX package's ``jax.random.uniform(
    key, (num_starts, n_dof))``. Dtype and device follow ``q_init``, else
    ``starts``, else the chain's dtype and the generator's device (the
    CPU without one)."""
    ref = q_init if q_init is not None else starts
    if ref is not None:
        dtype, device = ref.dtype, ref.device
    else:
        dtype = chain.dtype
        device = generator.device if generator is not None else torch.device("cpu")
    lo = chain.limits_lower.to(dtype=dtype, device=device)
    hi = chain.limits_upper.to(dtype=dtype, device=device)
    lo = torch.where(torch.isfinite(lo), lo, torch.full_like(lo, -math.pi))
    hi = torch.where(torch.isfinite(hi), hi, torch.full_like(hi, math.pi))
    if starts is None:
        starts = torch.rand((num_starts, chain.n_dofs), generator=generator, dtype=dtype,
                            device=device)
    qs0 = lo + (hi - lo) * starts.to(dtype=dtype, device=device)
    if q_init is not None:
        qs0 = torch.cat([q_init[None].to(dtype), qs0], dim=0)
    target_h = target_h.to(dtype=dtype, device=device)
    qs = solve_ik(chain, target_h, qs0, num_iters=num_iters, damping=damping,
                  step_size=step_size)
    # the geodesic SE(3) distance sees 180-degree flips
    errs = se3_distance(chain.ee_pose(qs), target_h)
    if q_init is None:
        return qs[torch.argmin(errs)]
    # among near-best solutions prefer the one closest to q_init: a distant
    # elbow-flipped optimum forces wide swings through the workspace
    ok = errs <= errs.min() + 0.05
    jdist = torch.linalg.norm(qs - q_init[None].to(qs.dtype), dim=-1)
    return qs[torch.argmin(torch.where(ok, jdist, torch.full_like(jdist, math.inf)))]
