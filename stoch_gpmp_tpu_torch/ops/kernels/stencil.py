"""Factor-graph (stencil) quadratic shared by the fused planar step.

PyTorch counterpart of the planar half of ``stoch_gpmp_tpu/ops/pallas/stencil.py``:
host helpers that turn a ``DofQuadraticCost`` into the fused step's
operands (numpy, float64 assembly), the ``needs_stencil`` conditioning
gate, and the plain version of ``flat_quad_cost`` — the exact GP + anchor
energy of flat t-major sample rows, which ``csrc/fused_planar_step.cu``
evaluates per lane in its stencil branch.

The per-dof plane kernel (``dof_quad_eval_pallas``) belongs to the dof
path and is not ported yet (dof slice).
"""

from __future__ import annotations

import numpy as np
import torch


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
