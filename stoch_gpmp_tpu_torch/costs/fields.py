"""2D collision fields of the planar main path.

PyTorch counterpart of the 2D fields of ``stoch_gpmp_tpu/costs/fields.py``:

- ``OccupancyGridField``: ``grid[cell(y), cell(x)]`` by a gather, which a
  GPU serves directly (what ``ObstacleMap.as_field`` returns);
- ``RasterPrimitive2DField``: the same occupancy, evaluated analytically
  from the primitives the grid was rasterized from (exact grid parity),
  through the raster-field kernel (``ops/kernels/fields.py``).

The link fields of the Panda stack live in ``costs/fused_fields.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import ceil

import numpy as np
import torch


@dataclass
class OccupancyGridField:
    """Occupancy-grid lookup: ``floor(world / cell_size) + center offset``,
    clamped to the grid, then ``grid[y, x]``."""

    grid: torch.Tensor  # [ny, nx]
    cell_size: float = 1.0

    def _cells(self, x: torch.Tensor):
        from stoch_gpmp_tpu_torch.ops.kernels.fields import snap_cells

        ny, nx = self.grid.shape
        cx = snap_cells(x[..., 0], self.cell_size, nx // 2, nx).long()
        cy = snap_cells(x[..., 1], self.cell_size, ny // 2, ny).long()
        return cy, cx

    def compute_cost(self, x: torch.Tensor, **kw) -> torch.Tensor:
        """``x [..., 2]`` world positions -> ``[...]`` occupancy cost."""
        cy, cx = self._cells(x)
        return self.grid[cy, cx]


@dataclass
class RasterPrimitive2DField:
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
        """``compute_cost`` on separate coordinate planes ``x``, ``y [B, L]``
        (views of one tensor, as the dof path passes them): the kernel reads
        them in place as one strided ``[B, L, 2]`` point set."""
        if x.shape != y.shape or x.dim() != 2:
            raise ValueError("compute_cost_planes takes two [B, L] planes")
        offset = y.storage_offset() - x.storage_offset()
        if (x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()
                and x.stride() == y.stride() and offset > 0):
            pts = x.as_strided(x.shape + (2,), x.stride() + (offset,))
        else:
            pts = torch.stack([x, y], dim=-1)
        return self.compute_cost(pts)
