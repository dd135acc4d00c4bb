"""Fixed-topology batched forward kinematics.

PyTorch counterpart of ``stoch_gpmp_tpu/kinematics/chain.py``:

- ``fk(q)``: all selected link poses ``[..., L, 4, 4]``;
- ``fk_compact(q)``: a ``LinkState`` (link positions ``[..., L, 3]`` and the
  end-effector rotation ``[..., 3, 3]``);
- ``fk_scalar_planes(q)`` / ``fk_planes_from_scalars(qs)``: the
  structure-of-arrays core, per link a ``(r, p)`` pair of entry grids that
  are Python floats (constants folded on the host) or tensors.

The chain topology is resolved at construction on the host, in float64.
FK runs in the dtype and on the device of ``q``. ``joint_table`` hands the
same chain to the CUDA kernels (``csrc/fk_chain.cuh``), which walk it with a
generic per-joint Rodrigues step instead of the folded algebra; the two
agree to float32 roundoff.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from stoch_gpmp_tpu_torch.kinematics.se3 import homogeneous
from stoch_gpmp_tpu_torch.kinematics.urdf import RobotModel

JOINT_FIXED, JOINT_REVOLUTE, JOINT_PRISMATIC = 0, 1, 2


@dataclass
class LinkState:
    """Compact FK output: ``positions [..., L, 3]``, ``ee_rot [..., 3, 3]``."""

    positions: torch.Tensor
    ee_rot: torch.Tensor

    @property
    def shape(self):
        return self.positions.shape

    def __getitem__(self, idx):
        """Index the leading (batch) axes of both fields."""
        return LinkState(positions=self.positions[idx], ee_rot=self.ee_rot[idx])

    def reshape(self, *batch):
        """Reshape the leading (batch) axes; the link and coordinate axes
        stay."""
        n_links = self.positions.shape[-2]
        return LinkState(positions=self.positions.reshape(*batch, n_links, 3),
                         ee_rot=self.ee_rot.reshape(*batch, 3, 3))

    def ee_pose(self) -> torch.Tensor:
        return homogeneous(self.ee_rot, self.positions[..., -1, :])


def _origin_np(rpy, xyz) -> np.ndarray:
    """URDF joint origin as a float64 homogeneous transform."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    ry = np.array([[cp, 0, sp], [0, 1.0, 0], [-sp, 0, cp]])
    rx = np.array([[1.0, 0, 0], [0, cr, -sr], [0, sr, cr]])
    t = np.eye(4)
    t[:3, :3] = rz @ ry @ rx
    t[:3, 3] = xyz
    return t


def _topo_sort(model: RobotModel):
    """Joints ordered so every parent link is resolved before its children."""
    by_parent: dict[str, list] = {}
    for j in model.joints:
        by_parent.setdefault(j.parent_link, []).append(j)
    ordered = []
    stack = [model.root_link]
    while stack:
        link = stack.pop(0)
        for j in by_parent.get(link, []):
            ordered.append(j)
            stack.append(j.child_link)
    if len(ordered) != len(model.joints):
        raise ValueError("joint graph is not a connected tree")
    return ordered


# --- scalar algebra over (Python float | tensor), constants folded -------------
def _is_const(x) -> bool:
    return isinstance(x, float)


def _mul(x, y):
    if _is_const(x) and abs(x) < 1e-12:
        return 0.0
    if _is_const(y) and abs(y) < 1e-12:
        return 0.0
    if _is_const(x) and _is_const(y):
        return x * y
    if _is_const(x):
        x, y = y, x
    if _is_const(y):
        if y == 1.0:
            return x
        if y == -1.0:
            return -x
    return x * y


def _add(*terms):
    const = 0.0
    traced = []
    for t in terms:
        if _is_const(t):
            const += t
        else:
            traced.append(t)
    if not traced:
        return const
    out = traced[0]
    for t in traced[1:]:
        out = out + t
    if const != 0.0:
        out = out + const
    return out


def _compose(r, m):
    """3x3 product of entry grids (lists of lists of scalars)."""
    return [[_add(*(_mul(r[i][k], m[k][j]) for k in range(3))) for j in range(3)]
            for i in range(3)]


class KinematicChain:
    """Batched FK over a URDF-derived kinematic tree: ``q [..., n_dofs]`` ->
    the selected links (all child links in topological order by default; the
    last is the end-effector for a serial chain).

    ``limits_lower``, ``limits_upper`` and ``limits_velocity`` are the
    actuated joints' limits as ``[n_dofs]`` CPU tensors of ``dtype`` (+-inf
    where the model gives none). FK itself runs in ``q``'s dtype."""

    def __init__(self, model: RobotModel, link_names: list[str] | None = None,
                 dtype=torch.float32):
        self.model = model
        self._joints = _topo_sort(model)
        self.n_dofs = model.n_dofs
        self._origins = np.stack([_origin_np(j.origin_rpy, j.origin_xyz) for j in self._joints])
        self._axes = np.stack([np.asarray(j.axis, dtype=np.float64) for j in self._joints])
        self._dof_index = []
        dof = 0
        for j in self._joints:
            self._dof_index.append(dof if j.actuated else -1)
            dof += int(j.actuated)
        self.all_link_names = [j.child_link for j in self._joints]
        if link_names is None:
            link_names = self.all_link_names
        missing = set(link_names) - set(self.all_link_names)
        if missing:
            raise ValueError(f"unknown links: {missing}")
        self.link_names = list(link_names)
        self._out_idx = [self.all_link_names.index(n) for n in self.link_names]
        self.dtype = dtype
        act = [j for j in self._joints if j.actuated]
        limit = lambda v, inf: inf if v is None else v  # noqa: E731
        self.limits_lower = torch.tensor([limit(j.limit_lower, -np.inf) for j in act],
                                         dtype=dtype)
        self.limits_upper = torch.tensor([limit(j.limit_upper, np.inf) for j in act],
                                         dtype=dtype)
        self.limits_velocity = torch.tensor([limit(j.limit_velocity, np.inf) for j in act],
                                            dtype=dtype)

    def fk_planes_from_scalars(self, qs):
        """The FK plane composition over a list of per-dof scalars (Python
        floats or tensors of one common shape): per selected link a
        ``(r, p)`` pair, ``r`` a 3x3 and ``p`` a 3-list of entries.
        Constant entries (the root frame, fixed joints, the 0/+-1 entries of
        +-90-degree origins) stay Python floats; coefficients below 1e-12 are
        pruned, as in the JAX package."""
        root_r = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        frames = {self.model.root_link: (root_r, [0.0, 0.0, 0.0])}
        out = []
        for k, joint in enumerate(self._joints):
            pr, pp = frames[joint.parent_link]
            a = self._origins[k]
            a_r = [[float(a[i, j]) for j in range(3)] for i in range(3)]
            r = _compose(pr, a_r)
            p = [_add(pp[i], *(_mul(pr[i][m], float(a[m, 3])) for m in range(3)))
                 for i in range(3)]
            if joint.joint_type in ("revolute", "continuous"):
                qj = qs[self._dof_index[k]]
                c, s = torch.cos(qj), torch.sin(qj)
                kx, ky, kz = (float(v) for v in self._axes[k])
                one_c = 1.0 - c
                # Rodrigues M = I + s K + (1-c) K^2 with a constant axis
                kmat = [
                    [_add(c, _mul(one_c, kx * kx)), _add(_mul(one_c, kx * ky), _mul(s, -kz)),
                     _add(_mul(one_c, kx * kz), _mul(s, ky))],
                    [_add(_mul(one_c, ky * kx), _mul(s, kz)), _add(c, _mul(one_c, ky * ky)),
                     _add(_mul(one_c, ky * kz), _mul(s, -kx))],
                    [_add(_mul(one_c, kz * kx), _mul(s, -ky)),
                     _add(_mul(one_c, kz * ky), _mul(s, kx)), _add(c, _mul(one_c, kz * kz))],
                ]
                r = _compose(r, kmat)
            elif joint.joint_type == "prismatic":
                qj = qs[self._dof_index[k]]
                p = [_add(p[i], _mul(qj, _add(*(_mul(r[i][m], float(self._axes[k][m]))
                                                for m in range(3)))))
                     for i in range(3)]
            elif joint.joint_type != "fixed":
                raise ValueError(f"unsupported joint type {joint.joint_type}")
            frames[joint.child_link] = (r, p)
            out.append((r, p))
        return [out[i] for i in self._out_idx]

    def fk_scalar_planes(self, q: torch.Tensor):
        """Structure-of-arrays FK of ``q [..., n_dofs]``: the per-link
        ``(r, p)`` entry grids plus ``as_array``, which turns an entry into a
        ``[...]`` tensor of ``q``'s dtype and device."""
        batch = q.shape[:-1]
        out = self.fk_planes_from_scalars([q[..., i] for i in range(self.n_dofs)])

        def as_array(x):
            if isinstance(x, float):
                return torch.full(batch, x, dtype=q.dtype, device=q.device)
            return x.expand(batch)

        return out, as_array

    def fk(self, q: torch.Tensor) -> torch.Tensor:
        """All selected link poses: ``q [..., n_dofs] -> [..., L, 4, 4]``."""
        planes, as_array = self.fk_scalar_planes(q)
        zero, one = as_array(0.0), as_array(1.0)
        mats = []
        for r, p in planes:
            rows = [torch.stack([as_array(r[j][0]), as_array(r[j][1]), as_array(r[j][2]),
                                 as_array(p[j])], dim=-1) for j in range(3)]
            rows.append(torch.stack([zero, zero, zero, one], dim=-1))
            mats.append(torch.stack(rows, dim=-2))
        return torch.stack(mats, dim=-3)

    def fk_compact(self, q: torch.Tensor) -> LinkState:
        """Positions of all selected links + the end-effector rotation."""
        planes, as_array = self.fk_scalar_planes(q)
        positions = torch.stack(
            [torch.stack([as_array(v) for v in p], dim=-1) for _, p in planes], dim=-2)
        r_ee, _ = planes[-1]
        ee_rot = torch.stack(
            [torch.stack([as_array(v) for v in row], dim=-1) for row in r_ee], dim=-2)
        return LinkState(positions=positions, ee_rot=ee_rot)

    def ee_pose(self, q: torch.Tensor) -> torch.Tensor:
        """End-effector (last selected link) pose: ``[..., 4, 4]``, the last
        entry of ``fk(q)`` assembled alone."""
        planes, as_array = self.fk_scalar_planes(q)
        r, p = planes[-1]
        rows = [torch.stack([as_array(r[j][0]), as_array(r[j][1]), as_array(r[j][2]),
                             as_array(p[j])], dim=-1) for j in range(3)]
        zero, one = as_array(0.0), as_array(1.0)
        rows.append(torch.stack([zero, zero, zero, one], dim=-1))
        return torch.stack(rows, dim=-2)

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        return self.fk(q)

    def joint_table(self) -> dict:
        """The chain as the CUDA kernels' joint table, float64 numpy: per
        joint in order its ``type`` (``JOINT_*``), ``dof`` index (-1 for a
        fixed joint), output ``slot`` (-1 when the link is not selected), the
        origin rotation ``rot [J, 3, 3]`` and translation ``trans [J, 3]``,
        and the ``axis [J, 3]``. The kernels walk a serial chain, carrying one
        frame: every joint's parent link must be the previous joint's child
        (the first joint's, the root); raises ``ValueError`` otherwise."""
        prev = self.model.root_link
        for j in self._joints:
            if j.parent_link != prev:
                raise ValueError(
                    f"joint {j.name!r}: the FK kernels take a serial chain; its parent "
                    f"{j.parent_link!r} is not the previous joint's child {prev!r}")
            prev = j.child_link
        kinds = {"fixed": JOINT_FIXED, "revolute": JOINT_REVOLUTE,
                 "continuous": JOINT_REVOLUTE, "prismatic": JOINT_PRISMATIC}
        slot = np.full(len(self._joints), -1, dtype=np.int32)
        for s, k in enumerate(self._out_idx):
            slot[k] = s
        return {
            "type": np.asarray([kinds[j.joint_type] for j in self._joints], dtype=np.int32),
            "dof": np.asarray(self._dof_index, dtype=np.int32),
            "slot": slot,
            "rot": self._origins[:, :3, :3].copy(),
            "trans": self._origins[:, :3, 3].copy(),
            "axis": self._axes.copy(),
        }
