"""Probabilistic factor evaluators as pure functions.

PyTorch counterpart of ``stoch_gpmp_tpu/costs/factors.py``; sign
conventions follow the reference: the unary error is ``mean - x`` and the
GP error is ``x_{t+1} - Phi x_t``.
"""

from __future__ import annotations

import torch


def gp_error(trajs: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Constant-velocity transition errors ``e_t = x_{t+1} - Phi x_t``:
    ``[..., T, d] -> [..., T-1, d]``."""
    pred = torch.einsum("ij,...tj->...ti", phi, trajs[..., :-1, :])
    return trajs[..., 1:, :] - pred


def unary_error(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Anchor error ``mean - x`` (broadcasting over leading axes)."""
    return mean - x


def quadratic_cost(err: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``e^T W e`` over the last axis: ``[..., d] -> [...]``."""
    return torch.einsum("...i,ij,...j->...", err, weight, err)


def gp_quadratic_cost(trajs, phi, q_inv) -> torch.Tensor:
    """Summed GP smoothness cost ``sum_t e_t^T Q^{-1} e_t`` -> ``[...]``."""
    return torch.sum(quadratic_cost(gp_error(trajs, phi), q_inv), dim=-1)
