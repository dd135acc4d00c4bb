"""The whole dof-factored Panda iteration as one kernel (K5): wrapper, plain
version and the host loop.

Replaces the TPU kernel ``stoch_gpmp_tpu/ops/pallas/panda_step_dof.py``
``make_fused_panda_dof_step`` (``_kernel``). Per particle, with the means
as dof planes ``[d, P, 2T]``:

    pu_d     = Sigma^{-1} mu_d of the sampling prior   (prec_u_planes)
    x_{d,s}  = mu_d + eps_{d,s} @ W_dof            (eps: operand or Philox)
             = mu_d + y_{d,s},  L^T y_{d,s} = eps_{d,s}   (L: the prior's factor)
    cost_s   = sum_d stencil energy of x_{d,s} + tau * x_{d,s} . pu_d   (as K3)
             + sum_{t >= 1} link fields at FK(x_{:,s}[t])               (as K4)
             + w_goal * (w_pos |p_ee - p*| + w_rot acos_poly(...))^2 at t = T-1
    w        = softmax_s(-cost / tau)
    mu_d    += step * sum_s w_s (x_{d,s} - mu_d)

The SE(3) angle uses the Abramowitz & Stegun 4.4.46 polynomial of the TPU
kernel (|err| <= 2e-8 rad) in both the kernel and the plain version. The
CUDA source is ``csrc/fused_panda_dof_step.cu``: CTAs that loop over
particles, one particle each by default. The kernel draws by the backward
substitution ``L^T y = eps`` on the prior factor's tables
(:func:`backward_tables`, formed when the step is built); the plain
version multiplies by ``W_dof``. See the source for the design and its
bound. The CTA's layout lives in the source alone: :func:`kernel_config`
asks the kernel for its shared memory, threads and resident CTAs.

The random draws are an ``eps [d, P, S, 2T]`` operand (the tests' mode) or
a 64-bit seed per launch: in-kernel Philox4x32-10 keyed on ``(seed,
particle, dof, sample pair, lane)`` with the dual-output Box-Muller of K2
(the same draws whichever CTA runs a particle); the plain version on a CPU
tensor draws from a ``torch.Generator`` seeded with the same seed. The
streams differ by design; the moments agree.

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

from stoch_gpmp_tpu_torch.gp.dof_factored import prec_u_planes
from stoch_gpmp_tpu_torch.ops.kernels import _build
from stoch_gpmp_tpu_torch.ops.kernels.fused_step import PriorStencilC, prior_stencil_c
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (
    FK_MAX_JOINTS,
    fk_chain_c,
    fk_link_fields_cost_rows_plain,
    fk_variant,
)
from stoch_gpmp_tpu_torch.ops.kernels.stencil import dof_quad_eval_plain

_SEED_HIGH = 2**63 - 1


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
        ("prior", PriorStencilC), ("key_lo", ctypes.c_uint), ("key_hi", ctypes.c_uint),
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
    w_dof: torch.Tensor  # [2T, 2T]; x = mu + eps @ w_dof (the plain version's)
    tables: torch.Tensor  # [7, T] the factor's backward tables (backward_tables; the kernel's)
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
        return fused_panda_dof_step(self, means_planes, eps=eps, seed=seed)


def backward_tables(chol) -> torch.Tensor:
    """The backward substitution ``L^T y = eps`` of a per-dof factor ``chol``
    (``BlockBidiagChol``, 2 x 2 blocks, time-major) as the kernel reads it:
    ``[7, T]``, per step ``t`` the upper triangle of ``D_t^{-T}`` ((0, 0),
    (0, 1), (1, 1)) and ``A_t = -D_t^{-T} L_{t+1}^T`` ((0, 0), (0, 1), (1, 0),
    (1, 1); ``A_{T-1} = 0``), so that ``y_t = D_t^{-T} eps_t + A_t y_{t+1}``
    with ``eps_t = (eps[t], eps[T + t])`` in plane order. Formed in float64
    and rounded to the factor's dtype, as ``ParallelBidiagSolver.from_chol``
    forms its transitions and for the reason it gives; elementwise, on the
    factor's device, with no read back."""
    diag, lower = chol.diag.double(), chol.lower.double()
    a, b, c = diag[:, 0, 0], diag[:, 1, 0], diag[:, 1, 1]  # D_t = [[a, 0], [b, c]]
    i00, i01, i11 = 1.0 / a, -b / (a * c), 1.0 / c  # D_t^{-T} = [[i00, i01], [0, i11]]
    l00, l01, l10, l11 = (lower[:, r, k] for r in (0, 1) for k in (0, 1))
    zero = diag.new_zeros(1)

    def last0(v):  # A_t for t < T - 1, then A_{T-1} = 0
        return torch.cat([v, zero])

    a00 = last0(-(i00[:-1] * l00 + i01[:-1] * l01))  # L_{t+1}^T = [[l00, l10], [l01, l11]]
    a01 = last0(-(i00[:-1] * l10 + i01[:-1] * l11))
    a10 = last0(-(i11[:-1] * l01))
    a11 = last0(-(i11[:-1] * l11))
    return torch.stack([i00, i01, i11, a00, a01, a10, a11]).to(chol.diag.dtype).contiguous()


def make_fused_panda_dof_step(
    *, chain, dof_prior, dof_quad, num_particles, spheres, target_h, n_dof, traj_len,
    num_samples, margin, w_self, w_obst, w_goal, w_pos=1.0, w_rot=1.0, temperature=1.0,
    step_size=0.1,
) -> FusedPandaDofStep:
    """Build the step for one problem: it samples with the prior's factor,
    as its backward tables (:func:`backward_tables`)."""
    w = dof_prior.w_dof
    target = np.asarray(target_h.cpu() if torch.is_tensor(target_h) else target_h,
                        dtype=np.float64)
    spheres = torch.as_tensor(spheres, dtype=w.dtype, device=w.device).reshape(-1, 4)
    prm = DofStepParamsC(
        P=num_particles, S=num_samples, T=traj_len, D=n_dof, n_obst=int(spheres.shape[0]),
        ppg=num_particles // dof_quad.num_goals, dt=float(dof_quad.dt),
        inv_2m2=1.0 / (2.0 * margin * margin), w_self=w_self, w_obst=w_obst, w_goal=w_goal,
        w_pos=w_pos, w_rot=w_rot, temperature=temperature, step_size=step_size,
        prior=prior_stencil_c(dof_prior),
    )
    (prm.q11, prm.q12, prm.q22, prm.ks11, prm.ks12, prm.ks22,
     prm.kg11, prm.kg12, prm.kg22) = dof_quad.stencil_weights
    prm.s_pd[: 2 * n_dof] = dof_quad.s_pd.detach().double().cpu().numpy().ravel().tolist()
    prm.target[:] = target.ravel().tolist()
    return FusedPandaDofStep(
        chain=chain, w_dof=w.contiguous(), tables=backward_tables(dof_prior.chol),
        dof_prior=dof_prior, dof_quad=dof_quad, spheres=spheres, target_h=target,
        num_particles=num_particles,
        num_samples=num_samples, n_dof=n_dof, traj_len=traj_len, margin=float(margin),
        w_self=float(w_self), w_obst=float(w_obst), w_goal=float(w_goal), w_pos=float(w_pos),
        w_rot=float(w_rot), temperature=float(temperature), step_size=float(step_size),
        params=prm,
    )


def fused_panda_dof_step_plain(step: FusedPandaDofStep, means, eps):
    """Plain PyTorch version of K5: ``means [d, P, 2T]``, ``eps [d, P, S,
    2T]`` -> ``(new_means [d, P, 2T], costs [P, S])``, ``Sigma^{-1} mu`` by
    :func:`prec_u_planes`."""
    from stoch_gpmp_tpu_torch.costs.fused_fields import ee_goal_distance

    d, p, t2 = means.shape
    t, s = t2 // 2, step.num_samples
    prior = step.dof_prior
    prec_u = prec_u_planes(means, prior.q_i2, prior.k_s2, prior.k_g2, prior.dt)
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


def kernel_config(params: DofStepParamsC, chain) -> tuple[int, int, int]:
    """The kernel's own launch configuration at ``params``' shape for the
    chain's FK walk (its ``fused_panda_dof_step_config``): CTAs resident on
    one SM (0 where the CTA does not fit or the kernel refuses the shape),
    shared memory per CTA in bytes and threads per CTA."""
    out = (ctypes.c_int * 3)()
    err = _build.load_library().fused_panda_dof_step_config(
        ctypes.byref(params), ctypes.byref(fk_chain_c(chain)), fk_variant(chain),
        ctypes.byref(out))
    return (int(out[0]) if err == 0 else 0), int(out[1]), int(out[2])


_SHAPES: dict = {}  # launch shape -> launch_shape's dict


def launch_shape(step: FusedPandaDofStep, ctas: int | None = None) -> dict:
    """The kernel's launch at this step's shape, as :func:`kernel_config`
    reports it (asked once per shape): the FK ``variant``, threads and
    shared memory per CTA, the CTAs resident on one SM and the CTAs
    launched (``ctas``, default one per particle; fewer loop over the
    particles). Raises where a CTA does not fit."""
    dev = step.w_dof.device
    variant = fk_variant(step.chain)
    key = (step.num_particles, step.num_samples, step.traj_len, step.n_dof,
           int(step.spheres.shape[0]), variant, ctas, dev)
    if key not in _SHAPES:
        per_sm, smem, threads = kernel_config(step.params, step.chain)
        if per_sm < 1:
            raise ValueError(f"fused panda dof step kernel: a CTA of {threads} threads and "
                             f"{smem} B of shared memory does not fit on the device")
        _SHAPES[key] = dict(
            variant=variant, threads=threads, smem_bytes=smem, ctas_per_sm=per_sm,
            ctas=ctas if ctas is not None else step.num_particles)
    return _SHAPES[key]


def _check_cuda(step: FusedPandaDofStep, means, eps):
    d, p, s, t = step.n_dof, step.num_particles, step.num_samples, step.traj_len
    m = 2 * t
    dev = means.device
    want = {"means": (means, (d, p, m)), "tables": (step.tables, (7, t)),
            "spheres": (step.spheres, (step.spheres.shape[0], 4))}
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
            f"most 512, d = the chain's dofs <= {FK_MAX_JOINTS}, goals dividing P")


def fused_panda_dof_step(step: FusedPandaDofStep, means, *, eps=None, seed=None,
                         ctas: int | None = None):
    """One fused iteration: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Exactly one of ``eps [d, P, S, 2T]`` and
    ``seed`` (an int in ``[0, 2**63)``) is given; ``ctas`` sets the number
    of CTAs, each looping over the particles ``c, c + ctas, ...`` (default
    :func:`launch_shape`'s: one particle per CTA)."""
    if (eps is None) == (seed is None):
        raise ValueError("give exactly one of eps and seed")
    d, p, m = means.shape
    s = step.num_samples
    if means.device.type == "cpu":
        if eps is None:
            gen = torch.Generator().manual_seed(int(seed))
            eps = torch.randn((d, p, s, m), generator=gen, dtype=means.dtype)
        return fused_panda_dof_step_plain(step, means, eps)
    if means.device.type != "cuda":
        raise ValueError(f"fused panda dof step: unsupported device {means.device}")
    _check_cuda(step, means, eps)
    shape = launch_shape(step, ctas)
    dev = means.device
    g_pd = step.dof_quad.g_pd.to(device=dev, dtype=torch.float32).contiguous()
    new_means = torch.empty_like(means)
    costs = torch.empty((p, s), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    err = lib.fused_panda_dof_step_launch(
        means.data_ptr(), g_pd.data_ptr(), step.tables.data_ptr(), step.spheres.data_ptr(),
        None if eps is None else eps.data_ptr(), new_means.data_ptr(), costs.data_ptr(),
        shape["ctas"], shape["variant"],
        ctypes.byref(_params(step, 0 if seed is None else int(seed))),
        ctypes.byref(fk_chain_c(step.chain)), _build.stream_ptr(dev),
    )
    _build.check(err, "fused_panda_dof_step_launch")
    fused_panda_dof_step.launches += 1
    fused_panda_dof_step.generic_launches += int(shape["variant"] == 0)  # the generic FK walk's
    return new_means, costs


fused_panda_dof_step.launches = 0
fused_panda_dof_step.generic_launches = 0


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
