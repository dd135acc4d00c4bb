"""The whole planar StochGPMP iteration as one kernel: wrappers, plain
version and the host loops.

Replaces two TPU kernels of ``stoch_gpmp_tpu/ops/pallas/fused_step.py``,
both through ``csrc/fused_planar_step.cu`` (one block per particle and one
thread per lane, sample tiles, ``W``/``A`` streamed in K-tiles through
shared memory; at the planar parity shape only 15 blocks run, so it is
latency bound on 15 of the card's 132 SMs; see the source for the design):

- K2, ``make_fused_planar_step_batched`` (``_kernel_batched``):
  ``fused_planar_step``, one 64-bit seed per launch;
- K9, ``make_fused_planar_step`` (``_kernel``, one program per particle with
  its own seed pair): ``fused_planar_step_per_particle``, one int32 seed
  pair per particle, and its loop ``fused_planar_optimize``.

The random draws are either an ``eps [P, S, M]`` operand (the tests' mode;
the same function for K2 and K9) or seeds. With seeds the kernel draws
N(0, 1) in-kernel from Philox4x32-10 keyed on the launch seed, or on the
particle's seed pair, with a dual-output Box-Muller; the plain version on a
CPU tensor draws from ``torch.Generator``s seeded with the same seeds. The
streams differ by design from each other and from the JAX package's; the
moments agree.

Each wrapper launches the kernel for CUDA tensors and runs
``fused_planar_step_plain`` only for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build
from stoch_gpmp_tpu_torch.ops.kernels.fields import inv_cell_size, raster_primitive_cost_plain
from stoch_gpmp_tpu_torch.ops.kernels.stencil import (
    anchor_rows_and_masks,
    dense_quad_from_dof,
    flat_quad_cost,
    needs_stencil,
    quad_stencil_consts,
)

_SEED_HIGH = 2**63 - 1
_MAX_SMEM = 232448  # bytes of shared memory a block may opt into on the H100


@dataclass
class FusedPlanarStep:
    """Constant operands and statics of one planar problem, built once.

    ``lin_rows [P, M]`` carries the per-particle ``b`` rows (matmul branch)
    or the start/goal anchor rows (stencil branch); ``quad_a [M, M]`` is
    ``A`` in the matmul branch and None in the stencil branch, where
    ``masks [3, M]`` and ``quad_stencil`` drive :func:`flat_quad_cost`."""

    weight_t: torch.Tensor  # [M, M] = L^{-1}; x = mu + eps @ weight_t
    dof_prior: object  # DofFactoredPrior: exact stencil Sigma^{-1} mu
    lin_rows: torch.Tensor
    quad_a: torch.Tensor | None
    masks: torch.Tensor
    quad_stencil: tuple
    rect_bounds: torch.Tensor  # [R, 4] int32
    circles: torch.Tensor  # [C, 3]
    num_particles: int
    num_samples: int
    traj_len: int
    state_dim: int
    cell_size: float
    nx: int
    ny: int
    k_coll: float
    temperature: float
    step_size: float

    @property
    def use_stencil(self) -> bool:
        return self.quad_a is None

    def __call__(self, means: torch.Tensor, *, seed: int | None = None, eps=None):
        """``means [P, T, d]`` -> ``(new_means [P, T, d], costs [P, S])``.
        In the matmul branch the costs omit the per-goal constant ``c``
        (it cancels in the softmax)."""
        p, t, d = means.shape
        prec_u = self.dof_prior.matvec_flat(means).reshape(p, t * d)
        new_flat, costs = fused_planar_step(
            self, means.reshape(p, t * d), prec_u, eps=eps, seed=seed
        )
        return new_flat.reshape(p, t, d), costs


class FusedPlanarStepPerParticle(FusedPlanarStep):
    """K9's step: ``step(means, seeds)`` with ``seeds [P, 2]`` int32, one
    seed pair per particle, or ``step(means, eps=eps)``."""

    def __call__(self, means: torch.Tensor, seeds=None, *, eps=None):
        p, t, d = means.shape
        prec_u = self.dof_prior.matvec_flat(means).reshape(p, t * d)
        new_flat, costs = fused_planar_step_per_particle(
            self, means.reshape(p, t * d), prec_u, eps=eps, seeds=seeds
        )
        return new_flat.reshape(p, t, d), costs


def make_fused_planar_step_batched(**kw) -> FusedPlanarStep:
    """Build K2's step for one problem (keywords as
    :func:`make_fused_planar_step`)."""
    return _make_step(FusedPlanarStep, **kw)


def make_fused_planar_step(**kw) -> FusedPlanarStepPerParticle:
    """Build K9's step for one problem: one seed pair per particle."""
    return _make_step(FusedPlanarStepPerParticle, **kw)


def _make_step(
    cls, *, weight_t, dof_prior, dof_quad, num_particles, rect_bounds, circles,
    cell_size, nx, ny, traj_len, state_dim, num_samples, k_coll,
    temperature, step_size,
):
    """The step's constant operands; the conditioning gate
    (``needs_stencil``) picks the stencil or the matmul quadratic."""
    dtype, device = weight_t.dtype, weight_t.device
    p = num_particles
    n_dof = state_dim // 2
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)  # noqa: E731
    anchors, masks = anchor_rows_and_masks(dof_quad, p, traj_len, n_dof)
    if needs_stencil(dof_quad):
        lin_rows, quad_a = anchors, None
    else:
        a, b_g = dense_quad_from_dof(dof_quad, traj_len, n_dof)
        lin_rows, quad_a = np.repeat(b_g, p // dof_quad.num_goals, axis=0), as_t(a)
    return cls(
        weight_t=weight_t.contiguous(), dof_prior=dof_prior,
        lin_rows=as_t(lin_rows), quad_a=quad_a, masks=as_t(masks),
        quad_stencil=quad_stencil_consts(dof_quad),
        rect_bounds=rect_bounds.to(device=device, dtype=torch.int32).contiguous(),
        circles=circles.to(device=device, dtype=dtype).contiguous(),
        num_particles=p, num_samples=num_samples, traj_len=traj_len,
        state_dim=state_dim, cell_size=float(cell_size), nx=int(nx), ny=int(ny),
        k_coll=float(k_coll), temperature=float(temperature), step_size=float(step_size),
    )


def fused_planar_step_plain(step: FusedPlanarStep, means, prec_u, eps):
    """Plain PyTorch version of the kernel: ``means``/``prec_u [P, M]``,
    ``eps [P, S, M]`` -> ``(new_means [P, M], costs [P, S])``, with the
    kernel's order of terms."""
    sd = step.state_dim
    x = means[:, None] + eps @ step.weight_t  # [P, S, M]
    if step.quad_a is not None:
        cost = torch.sum((x @ step.quad_a) * x, dim=-1)
        cost = cost - 2.0 * torch.sum(x * step.lin_rows[:, None], dim=-1)
    else:
        cost = flat_quad_cost(
            x, step.lin_rows[:, None], step.masks, step.quad_stencil, sd // 2
        )
    pos = torch.stack([x[..., 0::sd], x[..., 1::sd]], dim=-1)  # [P, S, T, 2]
    occ = raster_primitive_cost_plain(
        step.rect_bounds, step.circles, pos,
        cell_size=step.cell_size, nx=step.nx, ny=step.ny,
    )
    cost = cost + step.k_coll * torch.sum(occ[..., 1:], dim=-1)  # skip t=0
    cost = cost + step.temperature * torch.sum(x * prec_u[:, None], dim=-1)
    w = torch.softmax(-cost / step.temperature, dim=1)
    grad = torch.einsum("ps,psm->pm", w, x - means[:, None])
    return means + step.step_size * grad, cost


def _check_cuda(step: FusedPlanarStep, means, prec_u, eps):
    p, m, s = step.num_particles, step.traj_len * step.state_dim, step.num_samples
    dev = means.device
    want = {
        "means": (means, (p, m)), "prec_u": (prec_u, (p, m)),
        "weight_t": (step.weight_t, (m, m)), "lin_rows": (step.lin_rows, (p, m)),
        "circles": (step.circles, (step.circles.shape[0], 3)),
    }
    if step.quad_a is not None:
        want["quad_a"] = (step.quad_a, (m, m))
    if eps is not None:
        want["eps"] = (eps, (p, s, m))
    for name, (t, shape) in want.items():
        if (t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"fused planar step kernel: {name} must be contiguous float32 "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    rb = step.rect_bounds
    if rb.device != dev or rb.dtype != torch.int32 or rb.shape[-1] != 4:
        raise ValueError("fused planar step kernel: rect_bounds must be int32 [R, 4]")
    if m % 32 or m > 512 or step.state_dim < 4:
        raise ValueError(
            f"fused planar step kernel: M = {m} lanes must be a multiple of 32, "
            "at most 512 (one thread per lane), with n_dof >= 2"
        )
    smem = 4 * (16 * m + 2 * 32 * m + (m // 32) * 64 + s + 32
                + 4 * rb.shape[0] + 3 * step.circles.shape[0])
    if smem > _MAX_SMEM:
        raise ValueError(f"fused planar step kernel: {smem} B of shared memory > {_MAX_SMEM}")


def _launch(step: FusedPlanarStep, means, prec_u, eps, launcher: str, rng):
    """Launch ``launcher`` on CUDA tensors; ``rng`` is its seed argument."""
    _check_cuda(step, means, prec_u, eps)
    p, m, s = step.num_particles, means.shape[-1], step.num_samples
    new_means = torch.empty_like(means)
    costs = torch.empty((p, s), dtype=torch.float32, device=means.device)
    xs = torch.empty((p, s, m), dtype=torch.float32, device=means.device)
    (q, ks, kg, dt) = step.quad_stencil
    lib = _build.load_library()
    err = getattr(lib, launcher)(
        means.data_ptr(), prec_u.data_ptr(), step.weight_t.data_ptr(),
        step.lin_rows.data_ptr(),
        None if step.quad_a is None else step.quad_a.data_ptr(),
        step.rect_bounds.data_ptr(), int(step.rect_bounds.shape[0]),
        step.circles.data_ptr(), int(step.circles.shape[0]),
        None if eps is None else eps.data_ptr(), rng,
        new_means.data_ptr(), costs.data_ptr(), xs.data_ptr(),
        p, s, m, step.state_dim // 2, int(step.use_stencil), dt,
        q[0, 0], q[0, 1], q[1, 1], ks[0, 0], ks[0, 1], ks[1, 1],
        kg[0, 0], kg[0, 1], kg[1, 1],
        step.cell_size, inv_cell_size(step.cell_size, torch.float32), step.nx, step.ny,
        step.k_coll, step.temperature,
        step.step_size, _build.stream_ptr(means.device),
    )
    _build.check(err, launcher)
    return new_means, costs


def fused_planar_step(step: FusedPlanarStep, means, prec_u, *, eps=None, seed=None):
    """One fused iteration (K2): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Exactly one of ``eps [P, S, M]`` and ``seed``
    (an int in ``[0, 2**63)``) is given."""
    if (eps is None) == (seed is None):
        raise ValueError("give exactly one of eps and seed")
    p, m, s = step.num_particles, means.shape[-1], step.num_samples
    if means.device.type == "cpu":
        if eps is None:
            gen = torch.Generator().manual_seed(int(seed))
            eps = torch.randn((p, s, m), generator=gen, dtype=means.dtype)
        return fused_planar_step_plain(step, means, prec_u, eps)
    if means.device.type != "cuda":
        raise ValueError(f"fused planar step: unsupported device {means.device}")
    out = _launch(step, means, prec_u, eps, "fused_planar_step_launch",
                  0 if seed is None else int(seed))
    fused_planar_step.launches += 1
    return out


fused_planar_step.launches = 0


def _seed_pair(s0: int, s1: int) -> int:
    """One int32 seed pair as the 64-bit seed of a ``torch.Generator``."""
    return (s0 & 0xFFFFFFFF) | ((s1 & 0xFFFFFFFF) << 32)


def fused_planar_step_per_particle(step: FusedPlanarStep, means, prec_u, *, eps=None,
                                   seeds=None):
    """One fused iteration with one seed pair per particle (K9): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Exactly one
    of ``eps [P, S, M]`` and ``seeds [P, 2]`` (int32) is given."""
    if (eps is None) == (seeds is None):
        raise ValueError("give exactly one of eps and seeds")
    p, m, s = step.num_particles, means.shape[-1], step.num_samples
    if seeds is not None and (tuple(seeds.shape) != (p, 2) or seeds.dtype != torch.int32):
        raise ValueError(f"seeds must be int32 [{p}, 2], got {seeds.dtype} {tuple(seeds.shape)}")
    if means.device.type == "cpu":
        if eps is None:
            eps = torch.stack([
                torch.randn((s, m), generator=torch.Generator().manual_seed(_seed_pair(a, b)),
                            dtype=means.dtype)
                for a, b in seeds.tolist()
            ])
        return fused_planar_step_plain(step, means, prec_u, eps)
    if means.device.type != "cuda":
        raise ValueError(f"fused planar step: unsupported device {means.device}")
    if seeds is not None and (seeds.device != means.device or not seeds.is_contiguous()):
        raise ValueError("fused planar step kernel: seeds must be contiguous on the means' device")
    out = _launch(step, means, prec_u, eps, "fused_planar_step_per_particle_launch",
                  None if seeds is None else seeds.data_ptr())
    fused_planar_step_per_particle.launches += 1
    return out


fused_planar_step_per_particle.launches = 0


def fused_planar_optimize(step: FusedPlanarStepPerParticle, means, generator, opt_iters: int):
    """``opt_iters`` iterations of K9's step; the seeds ``[opt_iters, P, 2]``
    are drawn from ``generator`` up front, on its device, so the loop reads
    nothing back."""
    seeds = torch.randint(
        -(2**31), 2**31, (opt_iters, means.shape[0], 2), generator=generator,
        device=generator.device, dtype=torch.int32,
    ).to(means.device)
    for i in range(opt_iters):
        means, _ = step(means, seeds[i])
    return means


def fused_planar_optimize_batched(step: FusedPlanarStep, means, generator, opt_iters: int):
    """``opt_iters`` fused iterations; one seed per iteration, all drawn from
    ``generator`` up front (one host read, not one per iteration)."""
    seeds = torch.randint(
        0, _SEED_HIGH, (opt_iters,), generator=generator, device=generator.device
    ).tolist()
    for seed in seeds:
        means, _ = step(means, seed=seed)
    return means
