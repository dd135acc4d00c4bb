"""Constant-velocity (white-noise-on-acceleration) GP lift matrices.

PyTorch counterpart of ``stoch_gpmp_tpu/gp/lift.py``: the closed-form
state transition ``Phi = [[I, dt I], [0, I]]``, the inverse one-step
covariance ``Q^{-1}`` of the CV-GP factor and the isotropic unary anchor
weight ``I / sigma^2``. Small dense matrices built once at planner
construction.
"""

from __future__ import annotations

import torch


def phi_matrix(dof: int, dt: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """State transition over one step: ``[[I, dt*I], [0, I]]``, ``[2*dof, 2*dof]``."""
    eye = torch.eye(dof, dtype=dtype, device=device)
    zero = torch.zeros((dof, dof), dtype=dtype, device=device)
    top = torch.cat([eye, dt * eye], dim=1)
    bot = torch.cat([zero, eye], dim=1)
    return torch.cat([top, bot], dim=0)


def qc_inv_matrix(dof: int, sigma: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """Inverse power-spectral density of the white-noise acceleration: ``I / sigma^2``."""
    return torch.eye(dof, dtype=dtype, device=device) / (sigma ** 2)


def q_inv_block(
    dof: int,
    dt: float,
    sigma: float | None = None,
    qc_inv: torch.Tensor | None = None,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """``Q^{-1} = [[12/dt^3 Qc^-1, -6/dt^2 Qc^-1], [-6/dt^2 Qc^-1, 4/dt Qc^-1]]``."""
    if qc_inv is None:
        if sigma is None:
            raise ValueError("one of sigma / qc_inv is required")
        qc_inv = qc_inv_matrix(dof, sigma, dtype=dtype, device=device)
    qc_inv = torch.as_tensor(qc_inv, dtype=dtype, device=device)
    m1 = 12.0 * (dt ** -3.0) * qc_inv
    m2 = -6.0 * (dt ** -2.0) * qc_inv
    m3 = 4.0 * (dt ** -1.0) * qc_inv
    top = torch.cat([m1, m2], dim=-1)
    bot = torch.cat([m2, m3], dim=-1)
    return torch.cat([top, bot], dim=-2)


def unary_weight(dim: int, sigma: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """Isotropic Gaussian anchor weight ``K = I / sigma^2``, ``[dim, dim]``."""
    return torch.eye(dim, dtype=dtype, device=device) / (sigma ** 2)
