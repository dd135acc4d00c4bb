"""Factor-graph (stencil) quadratic: the fused planar step's helpers and
kernel K3, the per-dof plane energy of the dof path.

PyTorch counterpart of ``stoch_gpmp_tpu/ops/pallas/stencil.py``:

- host helpers that turn a ``DofQuadraticCost`` into the fused steps'
  operands (numpy, float64 assembly), the ``needs_stencil`` conditioning
  gate, and the plain version of ``flat_quad_cost`` (the exact GP + anchor
  energy of flat t-major rows, which ``csrc/fused_planar_step.cu`` evaluates
  per lane in its stencil branch);
- K3, ``dof_quad_eval``: replaces the TPU kernel ``dof_quad_eval_pallas``
  (``_dof_quad_kernel``). The CUDA source is ``csrc/dof_quad_eval.cu``: one
  warp per sample row, the ``t+1`` neighbour by a warp shuffle, the dofs
  summed in the kernel, so the TPU kernel's ``[B, d]`` column table (a
  Mosaic tiling workaround) does not exist. Memory bound: it reads the
  ``[d, B, 2T]`` planes once (73 MB at config 5).

``dof_quad_eval`` launches the kernel for a CUDA tensor and runs
``dof_quad_eval_plain`` only for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from stoch_gpmp_tpu_torch.gp.dof_factored import _plane_residuals
from stoch_gpmp_tpu_torch.ops.kernels import _build


def _np64(t) -> np.ndarray:
    return t.detach().cpu().double().numpy() if torch.is_tensor(t) else np.asarray(t, np.float64)


def quad_stencil_consts(dof_quad):
    """Constant stencil parameters ``(q_i2, k_s2, k_g2, dt)`` as float64
    numpy ``[2, 2]`` arrays and a float."""
    return (_np64(dof_quad.q_i2), _np64(dof_quad.k_s2), _np64(dof_quad.k_g2),
            float(dof_quad.dt))


STENCIL_CONDITION_THRESHOLD = 1e9
"""Weight magnitude above which the quadratic takes the stencil form.

Fitted on the TPU, where the matmul form runs through bf16 MXU passes:
planar parity (max weight 1.5e8) was accurate in matmul form and Panda
(~2e11) was not. The H100 kernel computes the matmul form in IEEE FP32, so
this threshold is kept as it is until it is re-decided from H100 data."""


def needs_stencil(dof_quad) -> bool:
    return max(
        float(np.abs(_np64(dof_quad.q_i2)).max()),
        float(np.abs(_np64(dof_quad.k_s2)).max()),
        float(np.abs(_np64(dof_quad.k_g2)).max()),
    ) > STENCIL_CONDITION_THRESHOLD


def anchor_rows_and_masks(dof_quad, num_particles: int, traj_len: int, n_dof: int):
    """Per-particle anchor-value rows ``[P, M]`` (start values on the t=0
    block, the particle's goal values on the t=T-1 block, zeros elsewhere)
    and the ``[3, M]`` lane masks (gp pos-lanes t<T-1, start pos-lanes, goal
    pos-lanes) of :func:`flat_quad_cost`, as float64 numpy."""
    state_dim = 2 * n_dof
    m = traj_len * state_dim
    p = num_particles
    s_pd = _np64(dof_quad.s_pd)  # [d, 2]
    g_pd = _np64(dof_quad.g_pd)  # [G, d, 2]
    anchors = np.zeros((p, m))
    anchors[:, :n_dof] = s_pd[:, 0]
    anchors[:, n_dof:state_dim] = s_pd[:, 1]
    gp_rep = np.repeat(g_pd, p // dof_quad.num_goals, axis=0)  # [P, d, 2]
    anchors[:, m - state_dim : m - n_dof] = gp_rep[..., 0]
    anchors[:, m - n_dof :] = gp_rep[..., 1]
    lanes = np.arange(m)
    is_pos = (lanes % state_dim) < n_dof
    masks = np.zeros((3, m))
    masks[0] = is_pos & (lanes < m - state_dim)
    masks[1] = is_pos & (lanes < state_dim)
    masks[2] = is_pos & (lanes >= m - state_dim)
    return anchors, masks


def dense_quad_from_dof(dof_quad, traj_len: int, n_dof: int):
    """The t-major dense ``(A [M, M], b [G, M])`` of the quadratic, rebuilt
    from the per-dof stencil parameters in float64 numpy (the fused step's
    matmul branch). Equal to ``QuadraticCost.from_gp_and_goal_prior``'s
    ``a_dense``/``b`` (tested)."""
    d = n_dof
    sd = 2 * d
    m = traj_len * sd
    eye = np.eye(d)
    q2, ks2, kg2, dt = quad_stencil_consts(dof_quad)
    q_full = np.kron(q2, eye)
    ks_full = np.kron(ks2, eye)
    kg_full = np.kron(kg2, eye)
    phi = np.kron(np.asarray([[1.0, dt], [0.0, 1.0]]), eye)
    pqp = phi.T @ q_full @ phi
    a = np.zeros((m, m))
    for t in range(traj_len):
        blk = slice(t * sd, (t + 1) * sd)
        if t == 0:
            a[blk, blk] = ks_full + pqp
        elif t == traj_len - 1:
            a[blk, blk] = q_full + kg_full
        else:
            a[blk, blk] = q_full + pqp
        if t < traj_len - 1:
            nxt = slice((t + 1) * sd, (t + 2) * sd)
            low = -(q_full @ phi)
            a[nxt, blk] = low
            a[blk, nxt] = low.T
    s_pd = _np64(dof_quad.s_pd)  # [d, 2]
    g_pd = _np64(dof_quad.g_pd)  # [G, d, 2]
    b = np.zeros((g_pd.shape[0], m))
    b[:, :sd] = ks_full @ np.concatenate([s_pd[:, 0], s_pd[:, 1]])
    g_vecs = np.concatenate([g_pd[..., 0], g_pd[..., 1]], axis=-1)  # [G, 2d]
    b[:, m - sd :] += g_vecs @ kg_full.T
    return a, b


def flat_quad_cost(x, anch_rows, masks, quad_stencil, n_dof: int):
    """Exact GP + anchor quadratic of flat t-major sample rows ``x [..., M]``
    by shifted-lane residuals (plain version of the stencil branch of the
    fused step). ``anch_rows`` broadcasts against ``x``; ``masks [3, M]``.
    Returns ``[...]``."""
    m = x.shape[-1]
    q_i2, k_s2, k_g2, dt = quad_stencil
    q11, q12, q22 = float(q_i2[0, 0]), float(q_i2[0, 1]), float(q_i2[1, 1])
    ks11, ks12, ks22 = float(k_s2[0, 0]), float(k_s2[0, 1]), float(k_s2[1, 1])
    kg11, kg12, kg22 = float(k_g2[0, 0]), float(k_g2[0, 1]), float(k_g2[1, 1])
    sd = 2 * n_dof
    # left shift by k lanes == roll by m - k; wrapped lanes are masked
    xd = torch.roll(x, m - n_dof, dims=-1)  # vel(t) at pos lanes
    x1 = torch.roll(x, m - sd, dims=-1)  # pos(t+1)
    x1d = torch.roll(x, m - sd - n_dof, dims=-1)  # vel(t+1)
    rp = x + dt * xd - x1
    rv = xd - x1d
    cost = torch.sum((q11 * rp * rp + 2.0 * q12 * rp * rv + q22 * rv * rv) * masks[0], dim=-1)
    diff = x - anch_rows
    diffd = torch.roll(diff, m - n_dof, dims=-1)
    es = (ks11 * diff * diff + 2.0 * ks12 * diff * diffd + ks22 * diffd * diffd) * masks[1]
    eg = (kg11 * diff * diff + 2.0 * kg12 * diff * diffd + kg22 * diffd * diffd) * masks[2]
    return cost + torch.sum(es + eg, dim=-1)


def dof_anchor_rows(dof_quad, b: int) -> torch.Tensor:
    """Per-(dof, row) anchor values ``[d, B, 4]`` (start pos/vel, goal
    pos/vel) of a goal-major batch of ``B`` rows."""
    d = dof_quad.n_dof
    s_rows = dof_quad.s_pd[:, None, :].expand(d, b, 2)
    g_rows = dof_quad.g_pd.permute(1, 0, 2).repeat_interleave(b // dof_quad.num_goals, dim=1)
    return torch.cat([s_rows, g_rows], dim=-1)


def dof_quad_eval_plain(dof_quad, x_planes, *, pu=None, temperature=None, num_samples=None):
    """Plain PyTorch version of K3: the factor-graph residual energy of
    ``x_planes [d, B, 2T]`` (goal-major rows) per dof, summed over dofs ->
    ``[B]``. With ``pu [d, P, 2T]`` (``B = P * num_samples``, samples minor)
    it adds the importance term ``temperature * x . pu`` of each row's
    particle."""
    d, b, t2 = x_planes.shape
    t = t2 // 2
    q, ks, kg = dof_quad.q_i2, dof_quad.k_s2, dof_quad.k_g2
    p, v, rp, rv = _plane_residuals(x_planes, dof_quad.dt, t)
    e = torch.sum(q[0, 0] * rp * rp + 2.0 * q[0, 1] * rp * rv + q[1, 1] * rv * rv, dim=-1)
    anch = dof_anchor_rows(dof_quad, b)
    r0p, r0v = p[..., 0] - anch[..., 0], v[..., 0] - anch[..., 1]
    e = e + (ks[0, 0] * r0p * r0p + 2.0 * ks[0, 1] * r0p * r0v + ks[1, 1] * r0v * r0v)
    rgp, rgv = p[..., -1] - anch[..., 2], v[..., -1] - anch[..., 3]
    e = e + (kg[0, 0] * rgp * rgp + 2.0 * kg[0, 1] * rgp * rgv + kg[1, 1] * rgv * rgv)
    if pu is not None:
        xs = x_planes.reshape(d, -1, num_samples, t2)
        e = e + temperature * torch.sum(xs * pu[:, :, None], dim=-1).reshape(d, b)
    return e.sum(0)


def _check_f32(name, t, shape, dev):
    if (t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(
            f"dof quad kernel: {name} must be contiguous 16-byte aligned float32 "
            f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def dof_quad_eval(dof_quad, x_planes, *, pu=None, temperature=None, num_samples=None):
    """``DofQuadraticCost.eval_dof_planes`` (plus the fused importance term
    with ``pu``): kernel K3 for a CUDA tensor (contiguous float32 planes,
    ``T % 4 == 0``), the plain version for a CPU tensor."""
    if pu is not None and (temperature is None or num_samples is None):
        raise ValueError("pu needs temperature and num_samples")
    if x_planes.device.type == "cpu":
        return dof_quad_eval_plain(dof_quad, x_planes, pu=pu, temperature=temperature,
                                   num_samples=num_samples)
    if x_planes.device.type != "cuda":
        raise ValueError(f"dof quad kernel: unsupported device {x_planes.device}")
    d, b, t2 = x_planes.shape
    t = t2 // 2
    dev = x_planes.device
    if t % 4 or b % dof_quad.num_goals or (pu is not None and b % num_samples):
        raise ValueError(f"dof quad kernel: T = {t} must be a multiple of 4 and the "
                         f"{b} rows whole goal (and sample) groups")
    _check_f32("x_planes", x_planes, (d, b, t2), dev)
    if pu is not None:
        _check_f32("pu", pu, (d, b // num_samples, t2), dev)
    s_pd = dof_quad.s_pd.to(device=dev, dtype=torch.float32).contiguous()
    g_pd = dof_quad.g_pd.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    lib = _build.load_library()
    err = lib.dof_quad_eval_launch(
        x_planes.data_ptr(), None if pu is None else pu.data_ptr(), s_pd.data_ptr(),
        g_pd.data_ptr(), out.data_ptr(), d, b, t, b // dof_quad.num_goals,
        1 if pu is None else int(num_samples), *dof_quad.stencil_weights, float(dof_quad.dt),
        0.0 if pu is None else float(temperature), _build.stream_ptr(dev),
    )
    _build.check(err, "dof_quad_eval_launch")
    dof_quad_eval.launches += 1
    return out


dof_quad_eval.launches = 0
