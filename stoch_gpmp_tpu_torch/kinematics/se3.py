"""SE(3) / SO(3) helpers.

PyTorch counterpart of ``stoch_gpmp_tpu/kinematics/se3.py``: axis
rotations, URDF roll-pitch-yaw, Rodrigues' formula, homogeneous assembly,
the clamped geodesic rotation angle, the weighted SE(3) pose distance,
rotation matrix <-> quaternion ``[x, y, z, w]`` and ``Frame``. Batched over
leading axes.
"""

from __future__ import annotations

from dataclasses import dataclass

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


def axis_angle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula; ``axis``: unit ``[..., 3]``, ``angle``: ``[...]``."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    z = torch.zeros_like(kx)
    k = _rot([[z, -kz, ky], [kz, z, -kx], [-ky, kx, z]])
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(k.shape)
    return eye + s * k + (1.0 - c) * (k @ k)


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


def matrix_to_quaternion(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix to quaternion ``[x, y, z, w]``: all four branches
    (the trace and each diagonal entry leading) are formed and the one with
    the largest of ``tr, m00, m11, m22`` is kept, then normalised."""
    m = rot
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]

    def case(qw2, x, y, z, w):
        s = torch.sqrt(torch.clamp(qw2, min=1e-12)) * 2.0
        return torch.stack([x / s, y / s, z / s, w / s], dim=-1)

    d0 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]
    d1 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]
    d2 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]
    qs = torch.stack([
        case(1.0 + tr, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
             m[..., 1, 0] - m[..., 0, 1], 1.0 + tr),
        case(d0, d0, m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
             m[..., 2, 1] - m[..., 1, 2]),
        case(d1, m[..., 0, 1] + m[..., 1, 0], d1, m[..., 1, 2] + m[..., 2, 1],
             m[..., 0, 2] - m[..., 2, 0]),
        case(d2, m[..., 0, 2] + m[..., 2, 0], m[..., 1, 2] + m[..., 2, 1], d2,
             m[..., 1, 0] - m[..., 0, 1]),
    ], dim=-2)  # [..., 4 branches, 4]
    idx = torch.argmax(torch.stack([tr, m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], dim=-1),
                       dim=-1)
    q = torch.take_along_dim(qs, idx[..., None, None], dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion ``[x, y, z, w]`` (normalised first) to rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _rot([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


@dataclass
class Frame:
    """A rigid-body frame: ``rot [..., 3, 3]`` and ``trans [..., 3]``."""

    rot: torch.Tensor
    trans: torch.Tensor

    def get_transform_matrix(self) -> torch.Tensor:
        return homogeneous(self.rot, self.trans)

    def get_quaternion(self) -> torch.Tensor:
        return matrix_to_quaternion(self.rot)
