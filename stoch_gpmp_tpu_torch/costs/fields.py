"""Distance fields: task-space collision and goal costs.

PyTorch counterpart of ``stoch_gpmp_tpu/costs/fields.py``:

- the link fields of the reference-shaped Panda stack, evaluated on FK
  link poses (homogeneous ``[..., L, 4, 4]`` or a compact ``LinkState``):
  ``LinkDistanceField`` (robot links against obstacle spheres),
  ``LinkSelfDistanceField`` (all link pairs) and ``EESE3DistanceField``
  (the end-effector pose against a target), in plain PyTorch;
- ``OccupancyGridField``: ``grid[cell(y), cell(x)]`` (what
  ``ObstacleMap.as_field`` returns), through the grid-lookup kernel K10;
- ``RasterPrimitive2DField``: the same occupancy, evaluated analytically
  from the primitives the grid was rasterized from (exact grid parity),
  through the raster-field kernel K1;
- ``Primitive2DField``: the count of analytic rectangles and circles
  containing each point, through the primitive-field kernel K11.

The three 2D fields' kernels are in ``ops/kernels/fields.py``; their
gradient with respect to the points is zero, as in the JAX package.

- ``MeshSphereDistanceField`` and ``MeshSphereFloorField``: the obstacle
  and floor RBF fields measured from a sphere decomposition of the robot's
  collision meshes (``kinematics/panda_collision.py``), on homogeneous link
  poses.

The fused forms of the link fields live in ``costs/fused_fields.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from math import ceil
from typing import Sequence

import numpy as np
import torch

from stoch_gpmp_tpu_torch.kinematics.se3 import se3_distance
from stoch_gpmp_tpu_torch.utils.profiling import annotate


def _link_pos(link_tensor) -> torch.Tensor:
    """Link positions ``[..., L, 3]`` from homogeneous ``[..., L, 4, 4]``
    poses or a compact ``LinkState``."""
    if hasattr(link_tensor, "positions"):
        return link_tensor.positions
    return link_tensor[..., :3, -1]


def _ee_pose(link_tensor) -> torch.Tensor:
    """End-effector pose ``[..., 4, 4]`` from either representation (the
    last link is the end-effector)."""
    if hasattr(link_tensor, "ee_pose"):
        return link_tensor.ee_pose()
    return link_tensor[..., -1, :, :]


def _interpolate_links(link_pos: torch.Tensor, num_interpolate: int,
                       interpolate_range: Sequence[int]) -> torch.Tensor:
    """Append ``num_interpolate`` points along each consecutive link segment
    in ``interpolate_range``: ``[..., L, 3] -> [..., L + n_extra, 3]``."""
    if num_interpolate <= 0:
        return link_pos
    alpha = torch.linspace(0.0, 1.0, num_interpolate + 2, dtype=link_pos.dtype,
                           device=link_pos.device)[1: num_interpolate + 1][:, None]
    extras = []
    for i in range(interpolate_range[0], interpolate_range[1]):
        x1 = link_pos[..., i, None, :]
        x2 = link_pos[..., i + 1, None, :]
        extras.append(x1 + (x2 - x1) * alpha)
    return torch.cat([link_pos] + extras, dim=-2)


@dataclass
class LinkDistanceField:
    """Robot links against obstacle spheres. ``field_type``: ``'rbf'``
    (Gaussian bumps summed), ``'sdf'`` (largest signed penetration,
    optionally clamped at 0) or ``'occupancy'`` (links inside a sphere)."""

    field_type: str = "rbf"
    clamp_sdf: bool = False
    num_interpolate: int = 0
    link_interpolate_range: tuple = (5, 7)

    def _link_positions(self, link_tensor) -> torch.Tensor:
        return _interpolate_links(_link_pos(link_tensor), self.num_interpolate,
                                  self.link_interpolate_range)

    def distances(self, link_tensor, obstacle_spheres: torch.Tensor) -> torch.Tensor:
        """Centre distances minus radii: ``[..., L, n_obst]``."""
        link_pos = _link_pos(link_tensor)[..., None, :]
        return (torch.linalg.norm(link_pos - obstacle_spheres[..., :3], dim=-1)
                - obstacle_spheres[..., 3])

    def compute_collision(self, link_tensor, obstacle_spheres=None, buffer: float = 0.02):
        if obstacle_spheres is None:
            return torch.zeros(_link_pos(link_tensor).shape[:-2], dtype=torch.bool,
                               device=_link_pos(link_tensor).device)
        d = self.distances(link_tensor, obstacle_spheres)
        return (d < buffer).flatten(-2).any(dim=-1)

    def compute_distance(self, link_tensor, obstacle_spheres=None, **kw):
        lp = _link_pos(link_tensor)
        if obstacle_spheres is None:
            return torch.tensor(1e10, dtype=lp.dtype, device=lp.device)
        return self.distances(link_tensor, obstacle_spheres).sum((-1, -2))

    def compute_cost(self, link_tensor, obstacle_spheres=None, **kw) -> torch.Tensor:
        """Link poses and ``obstacle_spheres [..., n_obst, 4]`` (centre,
        radius) -> ``[...]``, reduced over links and obstacles."""
        if obstacle_spheres is None:
            lp = _link_pos(link_tensor)
            return lp.new_zeros(lp.shape[:-2])
        link_pos = self._link_positions(link_tensor)[..., None, :]  # [..., L, 1, 3]
        centers, radii = obstacle_spheres[..., :3], obstacle_spheres[..., 3]
        if self.field_type == "rbf":
            sq = torch.sum(torch.square(link_pos - centers), dim=-1)
            return torch.exp(-0.5 * sq / torch.square(radii)).sum((-1, -2))
        if self.field_type == "sdf":
            sdf = -torch.linalg.norm(link_pos - centers, dim=-1) + radii
            if self.clamp_sdf:
                sdf = torch.clamp(sdf, max=0.0)
            return sdf.amax(dim=(-1, -2))
        if self.field_type == "occupancy":
            inside = torch.linalg.norm(link_pos - centers, dim=-1) < radii
            return inside.sum((-1, -2)).to(link_pos.dtype)
        raise ValueError(f"unknown field_type: {self.field_type}")


@dataclass
class LinkSelfDistanceField:
    """Self-collision RBF over all ordered link pairs, the diagonal
    included."""

    margin: float = 0.03
    num_interpolate: int = 0
    link_interpolate_range: tuple = (5, 7)

    def distances(self, link_tensor) -> torch.Tensor:
        pos = _link_pos(link_tensor)
        return torch.linalg.norm(pos[..., None, :] - pos[..., None, :, :], dim=-1)

    def compute_collision(self, link_tensor, buffer: float = 0.05) -> torch.Tensor:
        """Any pair of links at least two apart (``rows >= cols + 2``)
        closer than ``buffer``."""
        d = self.distances(link_tensor)
        n = d.shape[-1]
        idx = torch.arange(n, device=d.device)
        mask = idx[:, None] >= idx[None, :] + 2
        return ((d < buffer) & mask).flatten(-2).any(dim=-1)

    def compute_distance(self, link_tensor) -> torch.Tensor:
        return self.distances(link_tensor).sum((-1, -2))

    def compute_cost(self, link_tensor, **kw) -> torch.Tensor:
        pos = _interpolate_links(_link_pos(link_tensor), self.num_interpolate,
                                 self.link_interpolate_range)
        sq = torch.sum(torch.square(pos[..., None, :] - pos[..., None, :, :]), dim=-1)
        return torch.exp(sq / (-(self.margin**2) * 2.0)).sum((-1, -2))


@dataclass
class MeshSphereDistanceField:
    """Obstacle field at a sphere decomposition of the robot's collision
    meshes instead of the link origins: each sphere (centre ``c`` in its
    link's frame, radius ``r_s``) adds ``exp(-0.5 * max(|R c + p - o| -
    r_s, 0)^2 / r_o^2)`` per obstacle ``(o, r_o)``. Spheres of a link the
    chain does not output (the static base) are left out: they do not move
    with ``q``. Needs each link's rotation, so it takes homogeneous link
    poses ``[..., L, 4, 4]`` (``chain.fk``); a ``LinkState`` holds only the
    end-effector's and is refused, except by the obstacle-free branch."""

    link_indices: tuple  # the chain's output slot of each link group
    centers: tuple  # per link group: [K_i, 3]
    radii: tuple  # per link group: [K_i]

    @classmethod
    def for_panda(cls, chain, dtype=torch.float32, device=None) -> "MeshSphereDistanceField":
        from stoch_gpmp_tpu_torch.kinematics.panda_collision import PANDA_COLLISION_SPHERES

        names = list(chain.link_names)
        idxs, cs, rs = [], [], []
        for frame, sph in PANDA_COLLISION_SPHERES.items():
            if frame in names:
                idxs.append(names.index(frame))
                cs.append(torch.as_tensor(sph[:, :3], dtype=dtype, device=device))
                rs.append(torch.as_tensor(sph[:, 3], dtype=dtype, device=device))
        return cls(link_indices=tuple(idxs), centers=tuple(cs), radii=tuple(rs))

    def world_spheres(self, link_tensor):
        """World centres ``[..., N, 3]`` and radii ``[N]`` of all the mesh
        spheres at link poses ``[..., L, 4, 4]``."""
        if hasattr(link_tensor, "positions"):
            raise TypeError("the mesh spheres need every link's rotation: pass homogeneous "
                            "link poses [..., L, 4, 4] (chain.fk), not a LinkState")
        cws = []
        for idx, c in zip(self.link_indices, self.centers):
            h = link_tensor[..., idx, :, :]
            c = c.to(h.dtype)
            # cw[k, i] = sum_j rot[i, j] c[k, j] + p[i]
            cws.append(torch.sum(h[..., None, :3, :3] * c[:, None, :], dim=-1)
                       + h[..., None, :3, 3])
        return torch.cat(cws, dim=-2), torch.cat(self.radii)

    def compute_cost(self, link_tensor, obstacle_spheres=None, **kw) -> torch.Tensor:
        if obstacle_spheres is None:
            lp = _link_pos(link_tensor)
            return lp.new_zeros(lp.shape[:-2])
        cw, rw = self.world_spheres(link_tensor)  # [..., N, 3], [N]
        d = torch.linalg.norm(cw[..., :, None, :] - obstacle_spheres[..., None, :, :3], dim=-1)
        d_surf = torch.clamp(d - rw.to(d.dtype)[:, None], min=0.0)
        o_r = obstacle_spheres[..., None, :, 3]
        return torch.exp(-0.5 * torch.square(d_surf) / torch.square(o_r)).sum((-1, -2))

    def compute_collision(self, link_tensor, obstacle_spheres=None, buffer=0.0,
                          **kw) -> torch.Tensor:
        """Any mesh sphere's surface within ``buffer`` of an obstacle's."""
        if obstacle_spheres is None:
            lp = _link_pos(link_tensor)
            return torch.zeros(lp.shape[:-2], dtype=torch.bool, device=lp.device)
        cw, rw = self.world_spheres(link_tensor)
        d = torch.linalg.norm(cw[..., :, None, :] - obstacle_spheres[..., None, :, :3], dim=-1)
        gap = d - rw.to(d.dtype)[:, None] - obstacle_spheres[..., None, :, 3]
        return (gap < buffer).flatten(-2).any(dim=-1)


@dataclass
class MeshSphereFloorField:
    """Floor field on the mesh-sphere decomposition: the RBF of each
    sphere's clearance ``max(z - r_s - floor_z, 0)`` at width ``width``,
    summed over the spheres."""

    mesh: MeshSphereDistanceField
    floor_z: float = 0.0
    width: float = 0.05

    def compute_cost(self, link_tensor, **kw) -> torch.Tensor:
        cw, rw = self.mesh.world_spheres(link_tensor)
        clear = torch.clamp(cw[..., 2] - rw.to(cw.dtype) - self.floor_z, min=0.0)
        return torch.exp(-0.5 * torch.square(clear) / self.width**2).sum(-1)


@dataclass
class EESE3DistanceField:
    """End-effector SE(3) pose distance to a target transform (the last
    link is the end-effector), squared unless ``square`` is False."""

    target_h: torch.Tensor  # [4, 4]
    w_pos: float = 1.0
    w_rot: float = 1.0
    square: bool = True

    def update_target(self, target_h: torch.Tensor) -> "EESE3DistanceField":
        return replace(self, target_h=target_h)

    def compute_distance(self, link_tensor) -> torch.Tensor:
        return se3_distance(_ee_pose(link_tensor), self.target_h, w_pos=self.w_pos,
                            w_rot=self.w_rot)

    def compute_cost(self, link_tensor, **kw) -> torch.Tensor:
        dist = self.compute_distance(link_tensor)
        return torch.square(dist) if self.square else dist


class _Occupancy2D:
    """Collision and distance of a 2D occupancy-count field."""

    def compute_collision(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return self.compute_cost(x) > 0

    def compute_distance(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return -self.compute_cost(x)


@dataclass
class OccupancyGridField(_Occupancy2D):
    """Occupancy-grid lookup: ``floor(world / cell_size) + center offset``,
    clamped to the grid, then ``grid[y, x]``. The JAX package's ``lookup=``
    (``'gather'``/``'onehot'``) is a TPU execution choice with equal
    results; the port has the one kernel."""

    grid: torch.Tensor  # [ny, nx]
    cell_size: float = 1.0

    def compute_cost(self, x: torch.Tensor, **kw) -> torch.Tensor:
        """``x [..., 2]`` world positions -> ``[...]`` occupancy cost (the
        grid-lookup kernel on a CUDA tensor)."""
        from stoch_gpmp_tpu_torch.ops.kernels.fields import grid_lookup

        return grid_lookup(self.grid, x, self.cell_size)


@dataclass
class RasterPrimitive2DField(_Occupancy2D):
    """Gather-free field with exact rasterized-occupancy-grid semantics: a
    rectangle's footprint is an integer cell-range test and a circle's a
    norm-vs-radius test of the snapped cell's world point, both evaluated on
    the clamped cell index of each query point."""

    rect_bounds: torch.Tensor  # [R, 4] int32 — x0, x1, y0, y1 cell ranges
    circles: torch.Tensor  # [C, 3] float — cx, cy, r (world units)
    cell_size: float
    nx: int
    ny: int

    @classmethod
    @annotate("costs.raster_field")
    def from_map(cls, obst_map, obstacles, dtype=torch.float32, device=None):
        """``obst_map``: an ``envs.ObstacleMap``; ``obstacles``: the primitive
        list it was rasterized from (``generate_obstacle_map`` returns both)."""
        from stoch_gpmp_tpu_torch.envs.obst_map import ObstacleCircle, ObstacleRectangle

        cs = obst_map.cell_size
        ox, oy = obst_map.origin_xi, obst_map.origin_yi
        rects, circles = [], []
        for o in obstacles:
            if isinstance(o, ObstacleRectangle):
                w = ceil(o.width / cs)
                h = ceil(o.height / cs)
                c_x = ceil(o.center_x / cs)
                c_y = ceil(o.center_y / cs)
                rects.append([
                    c_x - ceil(w / 2.0) + ox, c_x + ceil(w / 2.0) + ox,
                    c_y - ceil(h / 2.0) + oy, c_y + ceil(h / 2.0) + oy,
                ])
            elif isinstance(o, ObstacleCircle):
                circles.append([o.center_x, o.center_y, o.radius])
            else:
                raise TypeError(f"unsupported obstacle type {type(o)}")
        return cls(
            rect_bounds=torch.as_tensor(
                np.asarray(rects, dtype=np.int32).reshape(-1, 4), device=device
            ),
            circles=torch.as_tensor(
                np.asarray(circles, dtype=float).reshape(-1, 3), dtype=dtype, device=device
            ),
            cell_size=cs, nx=obst_map.x_dim, ny=obst_map.y_dim,
        )

    def compute_cost(self, x: torch.Tensor, **kw) -> torch.Tensor:
        """``x [..., 2]`` -> ``[...]`` count of primitives covering each
        point's snapped cell (the raster-field kernel on a CUDA tensor)."""
        from stoch_gpmp_tpu_torch.ops.kernels.fields import raster_primitive_cost

        return raster_primitive_cost(
            self.rect_bounds, self.circles, x,
            cell_size=self.cell_size, nx=self.nx, ny=self.ny,
        )

    def compute_cost_planes(self, x: torch.Tensor, y: torch.Tensor, **kw) -> torch.Tensor:
        """``compute_cost`` on separate coordinate planes ``x``, ``y [..., L]``
        (views of one tensor, as the dof and plane paths pass them): the
        kernel reads them in place as one strided ``[B, L, 2]`` point set."""
        if x.shape != y.shape or x.dim() < 1:
            raise ValueError("compute_cost_planes takes two [..., L] planes of one shape")
        shape = x.shape
        x, y = x.reshape(-1, shape[-1]), y.reshape(-1, shape[-1])
        offset = y.storage_offset() - x.storage_offset()
        if (x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()
                and x.stride() == y.stride() and offset > 0):
            pts = x.as_strided(x.shape + (2,), x.stride() + (offset,))
        else:
            pts = torch.stack([x, y], dim=-1)
        return self.compute_cost(pts).reshape(shape)


@dataclass
class Primitive2DField(_Occupancy2D):
    """Analytic 2D obstacle field over rectangle and circle primitives: the
    count of primitives containing each point, with no grid (equal to the
    rasterized grid up to cell quantization)."""

    rects: torch.Tensor  # [R, 4] cx, cy, width, height (R may be 0)
    circles: torch.Tensor  # [C, 3] cx, cy, radius (C may be 0)

    @classmethod
    def from_obstacles(cls, obstacles, dtype=torch.float32, device=None) -> "Primitive2DField":
        from stoch_gpmp_tpu_torch.envs.obst_map import ObstacleCircle, ObstacleRectangle

        rects, circles = [], []
        for o in obstacles:
            if isinstance(o, ObstacleRectangle):
                rects.append([o.center_x, o.center_y, o.width, o.height])
            elif isinstance(o, ObstacleCircle):
                circles.append([o.center_x, o.center_y, o.radius])
            else:
                raise TypeError(f"unsupported obstacle type {type(o)}")
        as_t = lambda v, k: torch.as_tensor(  # noqa: E731
            np.asarray(v, dtype=float).reshape(-1, k), dtype=dtype, device=device)
        return cls(rects=as_t(rects, 4), circles=as_t(circles, 3))

    def compute_cost(self, x: torch.Tensor, **kw) -> torch.Tensor:
        """``x [..., 2]`` -> ``[...]`` number of primitives containing each
        point (the primitive-field kernel on a CUDA tensor)."""
        from stoch_gpmp_tpu_torch.ops.kernels.fields import primitive_field_cost

        return primitive_field_cost(self.rects, self.circles, x)
