"""SE(3) / SO(3) helpers of the Panda slice.

PyTorch counterpart of part of ``stoch_gpmp_tpu/kinematics/se3.py``:
axis rotations, URDF roll-pitch-yaw, homogeneous assembly, the clamped
geodesic rotation angle and the weighted SE(3) pose distance. Batched over
leading axes.
"""

from __future__ import annotations

import torch


def _rot(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def x_rot(theta: torch.Tensor) -> torch.Tensor:
    """Rotation about x by ``theta`` (batched): ``[..., 3, 3]``."""
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rot([[o, z, z], [z, c, -s], [z, s, c]])


def y_rot(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rot([[c, z, s], [z, o, z], [-s, z, c]])


def z_rot(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rot([[c, -s, z], [s, c, z], [z, z, o]])


def rpy_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """URDF fixed-axis roll-pitch-yaw to rotation matrix: ``R = Rz Ry Rx``."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    return z_rot(y) @ y_rot(p) @ x_rot(r)


def homogeneous(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Assemble ``[..., 4, 4]`` from ``rot [..., 3, 3]`` and ``trans [..., 3]``."""
    batch = torch.broadcast_shapes(rot.shape[:-2], trans.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    trans = trans.expand(batch + (3,))
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype, device=rot.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def rotation_angle(r1: torch.Tensor, r2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle between rotations, ``arccos((tr(R1^T R2) - 1)/2)``,
    clamped away from +-1."""
    tr = torch.einsum("...ji,...ji->...", r1, r2)
    cos = torch.clamp((tr - 1.0) * 0.5, -1.0 + eps, 1.0 - eps)
    return torch.arccos(cos)


def se3_distance(h1: torch.Tensor, h2: torch.Tensor, w_pos: float = 1.0,
                 w_rot: float = 1.0) -> torch.Tensor:
    """Weighted SE(3) pose distance between homogeneous transforms:
    ``w_pos * |t1 - t2| + w_rot * geodesic_angle(R1, R2)``."""
    pos = torch.linalg.norm(h1[..., :3, -1] - h2[..., :3, -1], dim=-1)
    return w_pos * pos + w_rot * rotation_angle(h1[..., :3, :3], h2[..., :3, :3])
