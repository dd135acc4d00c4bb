"""The whole dof-factored Panda iteration as one kernel (K5): wrapper, plain
version and the host loop.

Replaces the TPU kernel ``stoch_gpmp_tpu/ops/pallas/panda_step_dof.py``
``make_fused_panda_dof_step`` (``_kernel``). Per particle, with the means
and ``Sigma^{-1} mu`` as dof planes ``[d, P, 2T]``:

    x_{d,s}  = mu_d + eps_{d,s} @ W_dof            (eps: operand or Philox)
    cost_s   = sum_d stencil energy of x_{d,s} + tau * x_{d,s} . pu_d   (as K3)
             + sum_{t >= 1} link fields at FK(x_{:,s}[t])               (as K4)
             + w_goal * (w_pos |p_ee - p*| + w_rot acos_poly(...))^2 at t = T-1
    w        = softmax_s(-cost / tau)
    mu_d    += step * sum_s w_s (x_{d,s} - mu_d)

The SE(3) angle uses the Abramowitz & Stegun 4.4.46 polynomial of the TPU
kernel (|err| <= 2e-8 rad) in both the kernel and the plain version. The
CUDA source is ``csrc/fused_panda_dof_step.cu``: one block per particle,
one thread per plane lane; the ``d * S`` sample rows are multiplied by
``W_dof`` in tiles of 32 rows with ``W`` streamed through shared memory in
K-tiles (``csrc/kernel_common.cuh``, shared with K2). It is bound by the
FP32 sampling product: 2 d P S (2T)^2 = 9.4 GFLOP at config 5.

The random draws are an ``eps [d, P, S, 2T]`` operand (the tests' mode) or
a 64-bit seed per launch: in-kernel Philox4x32-10 keyed on ``(seed,
particle, dof, sample pair, lane)`` with the dual-output Box-Muller of K2;
the plain version on a CPU tensor draws from a ``torch.Generator`` seeded
with the same seed. The streams differ by design; the moments agree.

``fused_panda_dof_step`` launches the kernel for CUDA tensors and runs
``fused_panda_dof_step_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (
    FK_MAX_JOINTS,
    fk_chain_c,
    fk_link_fields_cost_rows_plain,
)
from stoch_gpmp_tpu_torch.ops.kernels.stencil import dof_quad_eval_plain

_SEED_HIGH = 2**63 - 1
_MAX_SMEM = 232448  # bytes of shared memory a block may opt into on the H100
_RT, _KT = 32, 16  # csrc/fused_panda_dof_step.cu: sample rows per tile, K rows of W per tile


class DofStepParamsC(ctypes.Structure):
    """``struct DofStepParams`` of ``csrc/fused_panda_dof_step.cu``."""

    _fields_ = [
        ("P", ctypes.c_int), ("S", ctypes.c_int), ("T", ctypes.c_int), ("D", ctypes.c_int),
        ("n_obst", ctypes.c_int), ("ppg", ctypes.c_int),
        ("dt", ctypes.c_float), ("q11", ctypes.c_float), ("q12", ctypes.c_float),
        ("q22", ctypes.c_float), ("ks11", ctypes.c_float), ("ks12", ctypes.c_float),
        ("ks22", ctypes.c_float), ("kg11", ctypes.c_float), ("kg12", ctypes.c_float),
        ("kg22", ctypes.c_float),
        ("s_pd", ctypes.c_float * (2 * FK_MAX_JOINTS)), ("target", ctypes.c_float * 16),
        ("inv_2m2", ctypes.c_float), ("w_self", ctypes.c_float), ("w_obst", ctypes.c_float),
        ("w_goal", ctypes.c_float), ("w_pos", ctypes.c_float), ("w_rot", ctypes.c_float),
        ("temperature", ctypes.c_float), ("step_size", ctypes.c_float),
        ("key_lo", ctypes.c_uint), ("key_hi", ctypes.c_uint),
    ]


def acos_poly(x: torch.Tensor) -> torch.Tensor:
    """``arccos`` by the Abramowitz & Stegun 4.4.46 polynomial of the TPU
    kernel (``panda_step_dof.py:184-200``), |err| <= 2e-8 rad on [-1, 1]."""
    az = torch.abs(x)
    poly = 1.5707963050 + az * (-0.2145988016 + az * (0.0889789874 + az * (
        -0.0501743046 + az * (0.0308918810 + az * (-0.0170881256 + az * (
            0.0066700901 + az * -0.0012624911))))))
    r = torch.sqrt(1.0 - az) * poly
    return torch.where(x >= 0.0, r, math.pi - r)


@dataclass
class FusedPandaDofStep:
    """Constant operands and statics of one dof Panda problem, built once.
    ``__call__(means_planes [d, P, 2T], *, seed= | eps=)`` returns
    ``(new_means_planes, costs [P, S])``."""

    chain: Any
    w_dof: torch.Tensor  # [2T, 2T]; x = mu + eps @ w_dof
    dof_prior: Any  # DofFactoredPrior: the exact stencil Sigma^{-1} mu
    dof_quad: Any  # DofQuadraticCost: stencil weights and anchors
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
    params: DofStepParamsC  # the kernel's constants; a launch copies it and sets the key

    def __call__(self, means_planes: torch.Tensor, *, seed: int | None = None, eps=None):
        prec_u = self.dof_prior.matvec_planes(means_planes)
        return fused_panda_dof_step(self, means_planes, prec_u, eps=eps, seed=seed)


def make_fused_panda_dof_step(
    *, chain, dof_prior, dof_quad, num_particles, spheres, target_h, n_dof, traj_len,
    num_samples, margin, w_self, w_obst, w_goal, w_pos=1.0, w_rot=1.0, temperature=1.0,
    step_size=0.1, w_dof=None,
) -> FusedPandaDofStep:
    """Build the step for one problem. ``w_dof`` overrides the sampling
    factor (zeros give the RNG-free check)."""
    w = dof_prior.w_dof if w_dof is None else w_dof
    target = np.asarray(target_h.cpu() if torch.is_tensor(target_h) else target_h,
                        dtype=np.float64)
    spheres = torch.as_tensor(spheres, dtype=w.dtype, device=w.device).reshape(-1, 4)
    prm = DofStepParamsC(
        P=num_particles, S=num_samples, T=traj_len, D=n_dof, n_obst=int(spheres.shape[0]),
        ppg=num_particles // dof_quad.num_goals, dt=float(dof_quad.dt),
        inv_2m2=1.0 / (2.0 * margin * margin), w_self=w_self, w_obst=w_obst, w_goal=w_goal,
        w_pos=w_pos, w_rot=w_rot, temperature=temperature, step_size=step_size,
    )
    (prm.q11, prm.q12, prm.q22, prm.ks11, prm.ks12, prm.ks22,
     prm.kg11, prm.kg12, prm.kg22) = dof_quad.stencil_weights
    prm.s_pd[: 2 * n_dof] = dof_quad.s_pd.detach().double().cpu().numpy().ravel().tolist()
    prm.target[:] = target.ravel().tolist()
    return FusedPandaDofStep(
        chain=chain, w_dof=w.contiguous(), dof_prior=dof_prior, dof_quad=dof_quad,
        spheres=spheres, target_h=target, num_particles=num_particles,
        num_samples=num_samples, n_dof=n_dof, traj_len=traj_len, margin=float(margin),
        w_self=float(w_self), w_obst=float(w_obst), w_goal=float(w_goal), w_pos=float(w_pos),
        w_rot=float(w_rot), temperature=float(temperature), step_size=float(step_size),
        params=prm,
    )


def fused_panda_dof_step_plain(step: FusedPandaDofStep, means, prec_u, eps):
    """Plain PyTorch version of K5: ``means``/``prec_u [d, P, 2T]``, ``eps
    [d, P, S, 2T]`` -> ``(new_means [d, P, 2T], costs [P, S])``."""
    from stoch_gpmp_tpu_torch.costs.fused_fields import ee_goal_distance

    d, p, t2 = means.shape
    t, s = t2 // 2, step.num_samples
    corr = (eps.reshape(-1, t2) @ step.w_dof).reshape(eps.shape)
    x = means[:, :, None] + corr  # [d, P, S, 2T]
    rows = x.reshape(d, p * s, t2)
    cost = dof_quad_eval_plain(step.dof_quad, rows, pu=prec_u, temperature=step.temperature,
                               num_samples=s)
    q = rows[:, :, :t]
    cost = cost + fk_link_fields_cost_rows_plain(
        step.chain, q, step.spheres.to(means.dtype), margin=step.margin, w_self=step.w_self,
        w_obst=step.w_obst)
    if step.w_goal != 0.0:
        target = torch.as_tensor(step.target_h, dtype=means.dtype, device=means.device)
        dist = ee_goal_distance(step.chain, q[:, :, -1], target, w_pos=step.w_pos,
                                w_rot=step.w_rot, acos=acos_poly)
        cost = cost + step.w_goal * (dist * dist)
    cost = cost.reshape(p, s)
    w = torch.softmax(-cost / step.temperature, dim=1)
    grad = torch.einsum("ps,dpsk->dpk", w, corr)
    return means + step.step_size * grad, cost


def _params(step: FusedPandaDofStep, seed: int) -> DofStepParamsC:
    """The step's kernel constants with the Philox key of ``seed``."""
    prm = DofStepParamsC.from_buffer_copy(step.params)
    prm.key_lo, prm.key_hi = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    return prm


def _smem_bytes(step: FusedPandaDofStep) -> int:
    """Dynamic shared memory of one block, as the CUDA launcher computes it."""
    m = 2 * step.traj_len
    r = step.n_dof * step.num_samples
    r_pad = -(-r // _RT) * _RT
    union = max(2 * _KT * m, 3 * len(step.chain.link_names) * m)
    return 4 * (r_pad * m + union + (m // 32) * r + step.num_samples * (m // 32 + 3) + 32
                + 4 * int(step.spheres.shape[0]))


def _check_cuda(step: FusedPandaDofStep, means, prec_u, eps):
    d, p, s, t = step.n_dof, step.num_particles, step.num_samples, step.traj_len
    m = 2 * t
    dev = means.device
    want = {"means": (means, (d, p, m)), "prec_u": (prec_u, (d, p, m)),
            "w_dof": (step.w_dof, (m, m)), "spheres": (step.spheres, (step.spheres.shape[0], 4))}
    if eps is not None:
        want["eps"] = (eps, (d, p, s, m))
    for name, (ten, shape) in want.items():
        if (ten.device != dev or ten.dtype != torch.float32 or tuple(ten.shape) != shape
                or not ten.is_contiguous() or ten.data_ptr() % 16):
            raise ValueError(
                f"fused panda dof step kernel: {name} must be contiguous 16-byte aligned "
                f"float32 {shape} on {dev}, got {ten.dtype} {tuple(ten.shape)} on {ten.device}")
    if (t % 32 or m > 512 or d > FK_MAX_JOINTS or d != step.chain.n_dofs
            or p % step.dof_quad.num_goals):
        raise ValueError(
            f"fused panda dof step kernel: 2T = {m} lanes must be a multiple of 64 and at "
            f"most 512 (one thread per lane), d = the chain's dofs <= {FK_MAX_JOINTS}, "
            "goals dividing P")
    smem = _smem_bytes(step)
    if smem > _MAX_SMEM:
        raise ValueError(f"fused panda dof step kernel: {smem} B of shared memory > {_MAX_SMEM}")


def fused_panda_dof_step(step: FusedPandaDofStep, means, prec_u, *, eps=None, seed=None):
    """One fused iteration: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Exactly one of ``eps [d, P, S, 2T]`` and
    ``seed`` (an int in ``[0, 2**63)``) is given."""
    if (eps is None) == (seed is None):
        raise ValueError("give exactly one of eps and seed")
    d, p, m = means.shape
    s = step.num_samples
    if means.device.type == "cpu":
        if eps is None:
            gen = torch.Generator().manual_seed(int(seed))
            eps = torch.randn((d, p, s, m), generator=gen, dtype=means.dtype)
        return fused_panda_dof_step_plain(step, means, prec_u, eps)
    if means.device.type != "cuda":
        raise ValueError(f"fused panda dof step: unsupported device {means.device}")
    _check_cuda(step, means, prec_u, eps)
    dev = means.device
    g_pd = step.dof_quad.g_pd.to(device=dev, dtype=torch.float32).contiguous()
    new_means = torch.empty_like(means)
    costs = torch.empty((p, s), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    err = lib.fused_panda_dof_step_launch(
        means.data_ptr(), prec_u.data_ptr(), g_pd.data_ptr(), step.w_dof.data_ptr(),
        step.spheres.data_ptr(), None if eps is None else eps.data_ptr(),
        new_means.data_ptr(), costs.data_ptr(),
        ctypes.byref(_params(step, 0 if seed is None else int(seed))),
        ctypes.byref(fk_chain_c(step.chain)), _build.stream_ptr(dev),
    )
    _build.check(err, "fused_panda_dof_step_launch")
    fused_panda_dof_step.launches += 1
    return new_means, costs


fused_panda_dof_step.launches = 0


def fused_panda_dof_optimize(step, means, generator, opt_iters: int):
    """``opt_iters`` iterations of a fused step called as ``step(means,
    seed=...)`` (K5's on dof planes, K6's on ``[P, T, 2d]`` means); one seed
    per iteration, all drawn from ``generator`` up front (one host read, not
    one per iteration)."""
    seeds = torch.randint(
        0, _SEED_HIGH, (opt_iters,), generator=generator, device=generator.device
    ).tolist()
    for seed in seeds:
        means, _ = step(means, seed=seed)
    return means
