"""The whole flat-layout Panda iteration as one kernel (K6): wrapper, plain
version and the host loop.

Replaces the TPU kernel ``stoch_gpmp_tpu/ops/pallas/panda_step.py``
``make_fused_panda_step`` (``_kernel``), the Panda parity workload of
``benchmarks/run.py`` config 4. Per particle, with the means as flat
t-major rows ``[P, M]``, ``M = T * 2d``:

    pu     = Sigma^{-1} mu of the sampling prior        (prec_u_lanes)
    x_s    = mu + eps_s @ W                         (eps: operand or Philox)
    cost_s = flat stencil energy of x_s with the start/goal anchors
           + sum_{t >= 1} link fields at FK(pos_t(x_s))          (as K4)
           + w_goal * (w_pos |p_ee - p*| + w_rot acos_poly(...))^2 at t = T-1
           + tau * x_s . pu
    w      = softmax_s(-cost / tau)
    mu    += step * sum_s w_s (x_s - mu)

The SE(3) angle uses the Abramowitz & Stegun 4.4.46 polynomial of the TPU
kernel (|err| <= 2e-8 rad) in both the kernel and the plain version. The
CUDA source is ``csrc/fused_panda_step.cu`` (sm_90a): each particle is a
thread-block cluster of ``ctas_per_particle(P, S, 4)`` CTAs that split its
samples in 4-row tiles (8 CTAs of 4 rows at config 4, 40 in all); each CTA
computes ``Sigma^{-1} mu`` itself, multiplies its rows by ``W`` (streamed in
K-tiles, ``csrc/kernel_common.cuh``), runs FK and the fields on its rows,
and the softmax and mean update run across the cluster through distributed
shared memory. Every CTA streams all of ``W`` (3.2 MB at config 4) from
L2, which sets its pace.

The random draws are an ``eps [P, S, M]`` operand in the flat path's layout
(the tests inject the JAX package's draw) or a 64-bit seed per launch:
in-kernel Philox4x32-10 keyed on ``(seed, particle, sample pair, lane)``
with the dual-output Box-Muller of K2 (a CTA holds whole sample pairs, so
the draws do not depend on the split); the plain version on a CPU tensor
draws from a ``torch.Generator`` seeded with the same seed. The streams
differ by design; the moments agree.

``fused_panda_step`` launches the kernel for CUDA tensors and runs
``fused_panda_step_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build
from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (
    PriorStencilC,
    cluster_launch,
    prec_u_lanes,
    prior_stencil_c,
    query_shape,
)
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (
    FK_MAX_JOINTS,
    fk_chain_c,
    fk_link_fields_cost_rows_plain,
    fk_variant,
)
from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import (
    acos_poly,
    fused_panda_dof_optimize,
)
from stoch_gpmp_tpu_torch.ops.kernels.stencil import (
    anchor_rows_and_masks,
    flat_quad_cost,
    quad_stencil_consts,
)

# csrc/fused_panda_step.cu: sample rows per tile, lanes per thread, threads per
# block at most
_ST, _C, _MAX_THREADS = 4, 2, 512


class PandaStepParamsC(ctypes.Structure):
    """``struct PandaStepParams`` of ``csrc/fused_panda_step.cu``."""

    _fields_ = [
        ("P", ctypes.c_int), ("S", ctypes.c_int), ("T", ctypes.c_int), ("D", ctypes.c_int),
        ("n_obst", ctypes.c_int),
        ("dt", ctypes.c_float), ("q11", ctypes.c_float), ("q12", ctypes.c_float),
        ("q22", ctypes.c_float), ("ks11", ctypes.c_float), ("ks12", ctypes.c_float),
        ("ks22", ctypes.c_float), ("kg11", ctypes.c_float), ("kg12", ctypes.c_float),
        ("kg22", ctypes.c_float), ("target", ctypes.c_float * 16),
        ("inv_2m2", ctypes.c_float), ("w_self", ctypes.c_float), ("w_obst", ctypes.c_float),
        ("w_goal", ctypes.c_float), ("w_pos", ctypes.c_float), ("w_rot", ctypes.c_float),
        ("temperature", ctypes.c_float), ("step_size", ctypes.c_float),
        ("prior", PriorStencilC), ("key_lo", ctypes.c_uint), ("key_hi", ctypes.c_uint),
    ]


@dataclass
class FusedPandaStep:
    """Constant operands and statics of one flat Panda problem, built once.
    ``__call__(means [P, T, 2d], *, seed= | eps=)`` returns
    ``(new_means [P, T, 2d], costs [P, S])``."""

    chain: Any
    weight_t: torch.Tensor  # [M, M]; x = mu + eps @ weight_t
    dof_prior: Any  # DofFactoredPrior: the exact stencil Sigma^{-1} mu
    dof_quad: Any  # DofQuadraticCost: stencil weights and anchors
    anchors: torch.Tensor  # [P, M] start/goal anchor values on their lanes, 0 elsewhere
    masks: torch.Tensor  # [3, M] lane masks of flat_quad_cost
    quad_stencil: tuple
    spheres: torch.Tensor  # [O, 4]
    target_h: np.ndarray  # [4, 4] float64
    num_particles: int
    num_samples: int
    n_dof: int
    traj_len: int
    margin: float
    w_self: float
    w_obst: float
    w_goal: float
    w_pos: float
    w_rot: float
    temperature: float
    step_size: float
    params: PandaStepParamsC  # the kernel's constants; a launch copies it and sets the key

    def __call__(self, means: torch.Tensor, *, seed: int | None = None, eps=None):
        p, t, sd = means.shape
        new_flat, costs = fused_panda_step(self, means.reshape(p, t * sd), eps=eps, seed=seed)
        return new_flat.reshape(p, t, sd), costs


def make_fused_panda_step(
    *, chain, weight_t, dof_prior, dof_quad, num_particles, spheres, target_h, n_dof, traj_len,
    num_samples, margin, w_self, w_obst, w_goal, w_pos=1.0, w_rot=1.0, temperature=1.0,
    step_size=0.1,
) -> FusedPandaStep:
    """Build the step for one problem (the JAX builder's arguments, without
    its TPU block heuristic: the kernel splits each particle's samples over
    a cluster of CTAs)."""
    dtype, device = weight_t.dtype, weight_t.device
    target = np.asarray(target_h.cpu() if torch.is_tensor(target_h) else target_h,
                        dtype=np.float64)
    spheres = torch.as_tensor(spheres, dtype=dtype, device=device).reshape(-1, 4)
    anchors, masks = anchor_rows_and_masks(dof_quad, num_particles, traj_len, n_dof)
    quad_stencil = quad_stencil_consts(dof_quad)
    (q, ks, kg, dt) = quad_stencil
    prm = PandaStepParamsC(
        P=num_particles, S=num_samples, T=traj_len, D=n_dof, n_obst=int(spheres.shape[0]),
        dt=dt, q11=q[0, 0], q12=q[0, 1], q22=q[1, 1], ks11=ks[0, 0], ks12=ks[0, 1],
        ks22=ks[1, 1], kg11=kg[0, 0], kg12=kg[0, 1], kg22=kg[1, 1],
        inv_2m2=1.0 / (2.0 * margin * margin), w_self=w_self, w_obst=w_obst, w_goal=w_goal,
        w_pos=w_pos, w_rot=w_rot, temperature=temperature, step_size=step_size,
        prior=prior_stencil_c(dof_prior),
    )
    prm.target[:] = target.ravel().tolist()
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return FusedPandaStep(
        chain=chain, weight_t=weight_t.contiguous(), dof_prior=dof_prior, dof_quad=dof_quad,
        anchors=as_t(anchors), masks=as_t(masks), quad_stencil=quad_stencil, spheres=spheres,
        target_h=target, num_particles=num_particles, num_samples=num_samples, n_dof=n_dof,
        traj_len=traj_len, margin=float(margin), w_self=float(w_self), w_obst=float(w_obst),
        w_goal=float(w_goal), w_pos=float(w_pos), w_rot=float(w_rot),
        temperature=float(temperature), step_size=float(step_size), params=prm,
    )


def fused_panda_step_plain(step: FusedPandaStep, means, eps):
    """Plain PyTorch version of K6: ``means [P, M]``, ``eps [P, S, M]`` ->
    ``(new_means [P, M], costs [P, S])``, with the TPU kernel's order of
    terms (``Sigma^{-1} mu`` by ``prec_u_lanes``)."""
    from stoch_gpmp_tpu_torch.costs.fused_fields import ee_goal_distance

    p, m = means.shape
    s, t, d = step.num_samples, step.traj_len, step.n_dof
    prior = step.dof_prior
    prec_u = prec_u_lanes(means.reshape(p, t, 2 * d), prior.q_i2, prior.k_s2, prior.k_g2,
                          prior.dt).reshape(p, m)
    x = means[:, None] + eps @ step.weight_t  # [P, S, M]
    cost = flat_quad_cost(x, step.anchors[:, None], step.masks, step.quad_stencil, d)
    q = x.reshape(p * s, t, 2 * d)[..., :d].permute(2, 0, 1)  # [d, P*S, T], a view
    cost = cost + fk_link_fields_cost_rows_plain(
        step.chain, q, step.spheres.to(means.dtype), margin=step.margin, w_self=step.w_self,
        w_obst=step.w_obst).reshape(p, s)
    if step.w_goal != 0.0:
        target = torch.as_tensor(step.target_h, dtype=means.dtype, device=means.device)
        dist = ee_goal_distance(step.chain, q[:, :, -1], target, w_pos=step.w_pos,
                                w_rot=step.w_rot, acos=acos_poly)
        cost = cost + (step.w_goal * (dist * dist)).reshape(p, s)
    cost = cost + step.temperature * torch.sum(x * prec_u[:, None], dim=-1)
    w = torch.softmax(-cost / step.temperature, dim=1)
    grad = torch.einsum("ps,psm->pm", w, x - means[:, None])
    return means + step.step_size * grad, cost


def _params(step: FusedPandaStep, seed: int) -> PandaStepParamsC:
    """The step's kernel constants with the Philox key of ``seed``."""
    prm = PandaStepParamsC.from_buffer_copy(step.params)
    prm.key_lo, prm.key_hi = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    return prm


_SHAPES: dict = {}  # launch shape -> cluster_launch


def launch_shape(step: FusedPandaStep, ctas: int | None = None) -> dict:
    """``cluster_launch`` at this step's shape (4-row tiles), asked once per
    shape."""
    p, s = step.num_particles, step.num_samples
    dev = step.weight_t.device
    key = (p, s, step.traj_len, step.n_dof, len(step.chain.link_names),
           int(step.spheres.shape[0]), ctas, dev)
    if key not in _SHAPES:
        lib = _build.load_library()
        _SHAPES[key] = cluster_launch(
            "fused panda step kernel", p, s, _ST, ctas, dev,
            lambda c: query_shape(lib.fused_panda_step_max_clusters, ctypes.byref(step.params),
                                  ctypes.byref(fk_chain_c(step.chain)), c,
                                  fk_variant(step.chain)))
    return _SHAPES[key]


def _check_cuda(step: FusedPandaStep, means, eps):
    p, s, t, d = step.num_particles, step.num_samples, step.traj_len, step.n_dof
    m = 2 * d * t
    dev = means.device
    want = {"means": (means, (p, m)),
            "anchors": (step.anchors, (p, m)), "weight_t": (step.weight_t, (m, m)),
            "spheres": (step.spheres, (step.spheres.shape[0], 4))}
    if eps is not None:
        want["eps"] = (eps, (p, s, m))
    for name, (ten, shape) in want.items():
        if (ten.device != dev or ten.dtype != torch.float32 or tuple(ten.shape) != shape
                or not ten.is_contiguous() or ten.data_ptr() % 16):
            raise ValueError(
                f"fused panda step kernel: {name} must be contiguous 16-byte aligned float32 "
                f"{shape} on {dev}, got {ten.dtype} {tuple(ten.shape)} on {ten.device}")
    if (m % (32 * _C) or m // _C > _MAX_THREADS or t % 32 or d > FK_MAX_JOINTS
            or d != step.chain.n_dofs):
        raise ValueError(
            f"fused panda step kernel: M = {m} lanes must be a multiple of {32 * _C} and at "
            f"most {_C * _MAX_THREADS} ({_C} lanes per thread), T = {t} a multiple of 32, "
            f"d = the chain's dofs <= {FK_MAX_JOINTS}")


def fused_panda_step(step: FusedPandaStep, means, *, eps=None, seed=None,
                     ctas: int | None = None):
    """One fused iteration: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``means [P, M]``; exactly one of ``eps [P, S,
    M]`` and ``seed`` (an int in ``[0, 2**63)``) is given. ``ctas`` sets the
    kernel's CTAs per particle (default ``ctas_per_particle``)."""
    if (eps is None) == (seed is None):
        raise ValueError("give exactly one of eps and seed")
    p, m = means.shape
    if means.device.type == "cpu":
        if eps is None:
            gen = torch.Generator().manual_seed(int(seed))
            eps = torch.randn((p, step.num_samples, m), generator=gen, dtype=means.dtype)
        return fused_panda_step_plain(step, means, eps)
    if means.device.type != "cuda":
        raise ValueError(f"fused panda step: unsupported device {means.device}")
    _check_cuda(step, means, eps)
    shape = launch_shape(step, ctas)
    dev = means.device
    new_means = torch.empty_like(means)
    costs = torch.empty((p, step.num_samples), dtype=torch.float32, device=dev)
    variant = fk_variant(step.chain)
    lib = _build.load_library()
    err = lib.fused_panda_step_launch(
        means.data_ptr(), step.anchors.data_ptr(), step.weight_t.data_ptr(),
        step.spheres.data_ptr(), None if eps is None else eps.data_ptr(),
        new_means.data_ptr(), costs.data_ptr(), shape["ctas"], variant,
        ctypes.byref(_params(step, 0 if seed is None else int(seed))),
        ctypes.byref(fk_chain_c(step.chain)), _build.stream_ptr(dev),
    )
    _build.check(err, "fused_panda_step_launch")
    fused_panda_step.launches += 1
    fused_panda_step.generic_launches += int(variant == 0)  # the generic FK walk's
    return new_means, costs


fused_panda_step.launches = 0
fused_panda_step.generic_launches = 0


# ``opt_iters`` fused iterations on ``means [P, T, 2d]``: the dof step's host
# loop, which takes any step called with ``seed=`` (one seed per iteration,
# all drawn from the generator up front)
fused_panda_optimize = fused_panda_dof_optimize
