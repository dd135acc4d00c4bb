"""The whole planar StochGPMP iteration as one kernel: wrappers, plain
version and the host loops.

Replaces two TPU kernels of ``stoch_gpmp_tpu/ops/pallas/fused_step.py``,
both through ``csrc/fused_planar_step.cu``:

- K2, ``make_fused_planar_step_batched`` (``_kernel_batched``):
  ``fused_planar_step``, one 64-bit seed per launch;
- K9, ``make_fused_planar_step`` (``_kernel``, one program per particle with
  its own seed pair): ``fused_planar_step_per_particle``, one int32 seed
  pair per particle, and its loop ``fused_planar_optimize``.

The kernel (sm_90a) runs each particle as a thread-block cluster of
``ctas_per_particle`` CTAs that split its samples in 16-row tiles (at the
planar parity shape 8 CTAs of 16 rows, 120 CTAs in all). Each CTA computes
``Sigma^{-1} mu`` of the sampling prior from the means itself (the plain
version's ``prec_u_lanes``, which is the prior's ``stencil_matvec_flat``),
multiplies its rows by ``W`` (and ``A``) with register-blocked FP32
products from K-tiles in shared memory, and the softmax and mean update run
across the cluster through distributed shared memory: one launch per
iteration and no sample rows in device memory. See the source for the
design and its bound. The CTA's shared-memory layout lives in the source
alone: :func:`launch_shape` asks the kernel's launch configuration for the
shared memory, K-tile buffers and resident clusters of a split.

The random draws are either an ``eps [P, S, M]`` operand (the tests' mode;
the same function for K2 and K9) or seeds. With seeds the kernel draws
N(0, 1) in-kernel from Philox4x32-10 keyed on the launch seed, or on the
particle's seed pair, with a dual-output Box-Muller; the counter (lane,
tile row pair, particle) does not depend on the split, so the draws are
the same for every ``ctas``. The plain version on a CPU tensor draws from
``torch.Generator``s seeded with the same seeds. The streams differ by
design from each other and from the JAX package's; the moments agree.

Each wrapper launches the kernel for CUDA tensors and runs
``fused_planar_step_plain`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from stoch_gpmp_tpu_torch.gp.dof_factored import stencil_matvec_flat as prec_u_lanes
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
_MAX_CLUSTER = 8  # the portable thread-block cluster size
_ST = 16  # sample rows per tile of csrc/fused_planar_step.cu


class PriorStencilC(ctypes.Structure):
    """``struct PriorStencil`` of ``csrc/kernel_common.cuh``: the sampling
    prior's ``q_i2``, ``k_s2``, ``k_g2`` (row-major) and ``dt``."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "q11", "q12", "q21", "q22", "ks11", "ks12", "ks21", "ks22",
        "kg11", "kg12", "kg21", "kg22", "dt")]


def prior_stencil_c(prior) -> PriorStencilC:
    """The kernels' copy of a ``DofFactoredPrior``'s stencil weights (one
    read from the device, at build time)."""
    w = torch.stack([prior.q_i2, prior.k_s2, prior.k_g2]).detach().double().cpu()
    return PriorStencilC(*w.reshape(-1).tolist(), float(prior.dt))


def ctas_per_particle(num_particles: int, num_samples: int, rows_per_tile: int, sms: int,
                      fits) -> int:
    """CTAs per particle (the cluster size) of the cluster-split fused
    kernels on a card of ``sms`` streaming multiprocessors: the largest power
    of two ``c <= 8`` with ``num_particles * c <= sms`` and at least one tile
    of ``rows_per_tile`` samples per CTA; 1 where even ``c = 1`` fills the
    card. Where ``fits(c)`` is false (a CTA of that split does not fit on the
    device), ``c`` doubles further, up to 8 and the tile count; a shape that
    never fits raises ``ValueError``."""
    if num_particles < 1 or num_samples < 1:
        raise ValueError(f"no work: {num_particles} particles x {num_samples} samples")
    tiles = -(-num_samples // rows_per_tile)
    top = min(_MAX_CLUSTER, tiles)
    c = 1
    while 2 * c <= top and num_particles * 2 * c <= sms:
        c *= 2
    while not fits(c) and 2 * c <= top:
        c *= 2
    if not fits(c):
        raise ValueError(
            f"{num_samples} samples in {tiles} tiles of {rows_per_tile} rows: no split into "
            f"at most {top} CTAs per particle fits a CTA's shared memory")
    return c


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
    prior_c: PriorStencilC  # the kernel's copy of dof_prior's stencil weights
    inv_cell: float  # float32(1 / float32(cell_size)), the kernel's snap factor

    @property
    def use_stencil(self) -> bool:
        return self.quad_a is None

    def __call__(self, means: torch.Tensor, *, seed: int | None = None, eps=None):
        """``means [P, T, d]`` -> ``(new_means [P, T, d], costs [P, S])``.
        In the matmul branch the costs omit the per-goal constant ``c``
        (it cancels in the softmax)."""
        p, t, d = means.shape
        new_flat, costs = fused_planar_step(self, means.reshape(p, t * d), eps=eps, seed=seed)
        return new_flat.reshape(p, t, d), costs


class FusedPlanarStepPerParticle(FusedPlanarStep):
    """K9's step: ``step(means, seeds)`` with ``seeds [P, 2]`` int32, one
    seed pair per particle, or ``step(means, eps=eps)``."""

    def __call__(self, means: torch.Tensor, seeds=None, *, eps=None):
        p, t, d = means.shape
        new_flat, costs = fused_planar_step_per_particle(
            self, means.reshape(p, t * d), eps=eps, seeds=seeds)
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
        prior_c=prior_stencil_c(dof_prior), inv_cell=inv_cell_size(cell_size, torch.float32),
    )


def fused_planar_step_plain(step: FusedPlanarStep, means, eps):
    """Plain PyTorch version of the kernel: ``means [P, M]``, ``eps [P, S,
    M]`` -> ``(new_means [P, M], costs [P, S])``, with the kernel's order of
    terms (``Sigma^{-1} mu`` by :func:`prec_u_lanes`)."""
    p, m = means.shape
    sd = step.state_dim
    prior = step.dof_prior
    prec_u = prec_u_lanes(means.reshape(p, step.traj_len, sd), prior.q_i2, prior.k_s2,
                          prior.k_g2, prior.dt).reshape(p, m)
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


def cluster_launch(what: str, num_particles: int, num_samples: int, rows_per_tile: int,
                   ctas: int | None, device, query) -> dict:
    """The cluster launch of a split fused kernel at one shape: CTAs per
    particle (``ctas``, else :func:`ctas_per_particle` on the device's SMs),
    CTAs launched, and what the kernel's own launch configuration reports
    through ``query(c)`` (its ``*_max_clusters`` entry, see
    :func:`query_shape`): the clusters resident at once, the shared memory
    and K-tile buffers per CTA and the tiles per CTA. Raises where no
    cluster of the split fits on the device."""
    shapes: dict = {}

    def shape(c: int) -> list:
        if c not in shapes:
            shapes[c] = query(c)
        return shapes[c]

    if ctas is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        ctas = ctas_per_particle(num_particles, num_samples, rows_per_tile, sms,
                                 fits=lambda c: shape(c)[0] >= 1)
    resident, smem, stages, tiles_per_cta = shape(ctas)
    if resident < 1:
        raise ValueError(f"{what}: no cluster of {ctas} CTAs with {smem} B of shared memory "
                         "each fits on the device")
    return dict(ctas=ctas, ctas_launched=num_particles * ctas, tiles_per_cta=tiles_per_cta,
                smem_bytes=smem, stages=stages, max_active_clusters=resident)


def query_shape(fn, *args) -> list:
    """Call a kernel's ``*_max_clusters(*args, int shape[4])`` entry: the
    clusters of the launch resident at once (0 where a CTA does not fit),
    the dynamic shared memory per CTA in bytes, the K-tile buffers and the
    tiles per CTA."""
    out = (ctypes.c_int * 4)()
    _build.check(fn(*args, ctypes.byref(out)), fn.__name__)
    return list(out)


_SHAPES: dict = {}  # launch shape -> cluster_launch


def launch_shape(step: FusedPlanarStep, ctas: int | None = None,
                 per_particle: bool = False) -> dict:
    """:func:`cluster_launch` at this step's shape (16-row tiles), asked
    once per shape."""
    p, s, m = step.num_particles, step.num_samples, step.traj_len * step.state_dim
    n_rects, n_circles = int(step.rect_bounds.shape[0]), int(step.circles.shape[0])
    dev = step.weight_t.device
    key = (p, s, m, step.state_dim, n_rects, n_circles, ctas, per_particle, dev)
    if key not in _SHAPES:
        lib = _build.load_library()
        _SHAPES[key] = cluster_launch(
            "fused planar step kernel", p, s, _ST, ctas, dev,
            lambda c: query_shape(lib.fused_planar_step_max_clusters, p, s, m,
                                  step.state_dim // 2, c, n_rects, n_circles, int(per_particle)))
    return _SHAPES[key]


def _check_cuda(step: FusedPlanarStep, means, eps):
    p, m, s = step.num_particles, step.traj_len * step.state_dim, step.num_samples
    dev = means.device
    want = {
        "means": (means, (p, m)),
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


def _launch(step: FusedPlanarStep, means, eps, launcher: str, rng, ctas):
    """Launch ``launcher`` on CUDA tensors; ``rng`` is its seed argument."""
    _check_cuda(step, means, eps)
    shape = launch_shape(step, ctas, per_particle=launcher != "fused_planar_step_launch")
    p, m, s = step.num_particles, means.shape[-1], step.num_samples
    new_means = torch.empty_like(means)
    costs = torch.empty((p, s), dtype=torch.float32, device=means.device)
    (q, ks, kg, dt) = step.quad_stencil
    lib = _build.load_library()
    err = getattr(lib, launcher)(
        means.data_ptr(), step.weight_t.data_ptr(), step.lin_rows.data_ptr(),
        None if step.quad_a is None else step.quad_a.data_ptr(),
        step.rect_bounds.data_ptr(), int(step.rect_bounds.shape[0]),
        step.circles.data_ptr(), int(step.circles.shape[0]),
        None if eps is None else eps.data_ptr(), rng,
        new_means.data_ptr(), costs.data_ptr(),
        p, s, m, step.state_dim // 2, int(step.use_stencil), shape["ctas"], dt,
        q[0, 0], q[0, 1], q[1, 1], ks[0, 0], ks[0, 1], ks[1, 1],
        kg[0, 0], kg[0, 1], kg[1, 1], ctypes.byref(step.prior_c),
        step.cell_size, step.inv_cell, step.nx, step.ny,
        step.k_coll, step.temperature,
        step.step_size, _build.stream_ptr(means.device),
    )
    _build.check(err, launcher)
    return new_means, costs


def fused_planar_step(step: FusedPlanarStep, means, *, eps=None, seed=None,
                      ctas: int | None = None):
    """One fused iteration (K2): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``means [P, M]``; exactly one of ``eps [P, S,
    M]`` and ``seed`` (an int in ``[0, 2**63)``) is given. ``ctas`` sets the
    CTAs per particle of the kernel (default :func:`ctas_per_particle`)."""
    if (eps is None) == (seed is None):
        raise ValueError("give exactly one of eps and seed")
    p, m, s = step.num_particles, means.shape[-1], step.num_samples
    if means.device.type == "cpu":
        if eps is None:
            gen = torch.Generator().manual_seed(int(seed))
            eps = torch.randn((p, s, m), generator=gen, dtype=means.dtype)
        return fused_planar_step_plain(step, means, eps)
    if means.device.type != "cuda":
        raise ValueError(f"fused planar step: unsupported device {means.device}")
    out = _launch(step, means, eps, "fused_planar_step_launch",
                  0 if seed is None else int(seed), ctas)
    fused_planar_step.launches += 1
    return out


fused_planar_step.launches = 0


def _seed_pair(s0: int, s1: int) -> int:
    """One int32 seed pair as the 64-bit seed of a ``torch.Generator``."""
    return (s0 & 0xFFFFFFFF) | ((s1 & 0xFFFFFFFF) << 32)


def fused_planar_step_per_particle(step: FusedPlanarStep, means, *, eps=None, seeds=None,
                                   ctas: int | None = None):
    """One fused iteration with one seed pair per particle (K9): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Exactly one
    of ``eps [P, S, M]`` and ``seeds [P, 2]`` (int32) is given; ``ctas`` as
    in :func:`fused_planar_step`."""
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
        return fused_planar_step_plain(step, means, eps)
    if means.device.type != "cuda":
        raise ValueError(f"fused planar step: unsupported device {means.device}")
    if seeds is not None and (seeds.device != means.device or not seeds.is_contiguous()):
        raise ValueError("fused planar step kernel: seeds must be contiguous on the means' device")
    out = _launch(step, means, eps, "fused_planar_step_per_particle_launch",
                  None if seeds is None else seeds.data_ptr(), ctas)
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
