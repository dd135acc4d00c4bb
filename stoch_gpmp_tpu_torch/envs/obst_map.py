"""2D occupancy-grid obstacle maps and obstacle primitives.

PyTorch counterpart of ``stoch_gpmp_tpu/envs/obst_map.py`` (reference
``stoch_gpmp/envs/obst_map.py``). Map construction is host-side numpy, the
same code as the JAX package's, so one seed gives the identical grid; the
built grid is handed to the device as an ``OccupancyGridField``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from copy import deepcopy
from math import ceil

import numpy as np
import torch

from stoch_gpmp_tpu_torch.costs.fields import OccupancyGridField


class Obstacle(ABC):
    """Base 2D obstacle (reference ``obst_map.py:11-40``)."""

    def __init__(self, center_x: float, center_y: float):
        self.center_x = center_x
        self.center_y = center_y
        self.origin = np.array([center_x, center_y])

    def obstacle_collision_check(self, obst_map: "ObstacleMap") -> bool:
        """True iff adding this obstacle would NOT overlap an existing one."""
        test = self.add_to_map(deepcopy(obst_map))
        return not np.any(test.map > 1)

    def point_collision_check(self, obst_map: "ObstacleMap", pts) -> bool:
        """True iff none of the given cell points fall inside this obstacle."""
        if pts is None:
            return True
        test = self.add_to_map(deepcopy(obst_map))
        for pt in pts:
            if test.map[ceil(pt[0]), ceil(pt[1])] >= 1:
                return False
        return True

    @abstractmethod
    def add_to_map(self, obst_map: "ObstacleMap") -> "ObstacleMap":
        ...


class ObstacleRectangle(Obstacle):
    """Axis-aligned rectangle (reference ``obst_map.py:43-72``)."""

    def __init__(self, center_x=0.0, center_y=0.0, width=None, height=None):
        super().__init__(center_x, center_y)
        self.width = width
        self.height = height

    def add_to_map(self, obst_map):
        cs = obst_map.cell_size
        w = ceil(self.width / cs)
        h = ceil(self.height / cs)
        c_x = ceil(self.center_x / cs)
        c_y = ceil(self.center_y / cs)
        y0 = c_y - ceil(h / 2.0) + obst_map.origin_yi
        y1 = c_y + ceil(h / 2.0) + obst_map.origin_yi
        x0 = c_x - ceil(w / 2.0) + obst_map.origin_xi
        x1 = c_x + ceil(w / 2.0) + obst_map.origin_xi
        obst_map.map[y0:y1, x0:x1] += 1
        return obst_map


class ObstacleCircle(Obstacle):
    """Disc (reference ``obst_map.py:75-105``), rasterized vectorized: a cell
    is occupied when its world-frame corner point lies inside the circle."""

    def __init__(self, center_x=0.0, center_y=0.0, radius=1.0):
        super().__init__(center_x, center_y)
        self.radius = radius

    def is_inside(self, p: np.ndarray) -> bool:
        return bool(np.linalg.norm(p - self.origin) <= self.radius)

    def add_to_map(self, obst_map):
        cs = obst_map.cell_size
        c_r = ceil(self.radius / cs)
        c_x = ceil(self.center_x / cs)
        c_y = ceil(self.center_y / cs)
        ii = np.arange(c_y - 2 * c_r + obst_map.origin_yi, c_y + 2 * c_r + obst_map.origin_yi)
        jj = np.arange(c_x - 2 * c_r + obst_map.origin_xi, c_x + 2 * c_r + obst_map.origin_xi)
        px = (jj - obst_map.origin_xi) * cs
        py = (ii - obst_map.origin_yi) * cs
        # sqrt-then-compare matches the reference's norm(p - c) <= r at
        # boundary-exact cells (squared comparison flips a few of them)
        inside = (
            np.sqrt(
                (px[None, :] - self.center_x) ** 2
                + (py[:, None] - self.center_y) ** 2
            )
            <= self.radius
        )
        iw, jw = np.meshgrid(ii, jj, indexing="ij")
        sel = inside & (iw >= 0) & (iw < obst_map.map.shape[0]) & (jw >= 0) & (
            jw < obst_map.map.shape[1]
        )
        obst_map.map[iw[sel], jw[sel]] += 1
        return obst_map


class ObstacleMap:
    """Occupancy grid over a centered world frame
    (reference ``obst_map.py:108-188``)."""

    def __init__(self, map_dim, cell_size: float, dtype=torch.float32, device=None):
        assert map_dim[0] % 2 == 0 and map_dim[1] % 2 == 0, "map dims must be even"
        self.cell_size = cell_size
        self.dtype = dtype
        self.device = device
        nx = ceil(map_dim[0] / cell_size)
        ny = ceil(map_dim[1] / cell_size)
        self.map = np.zeros((ny, nx))
        self.origin_xi = nx // 2
        self.origin_yi = ny // 2
        self.y_dim, self.x_dim = self.map.shape
        self.xlim = [-cell_size * self.x_dim / 2, cell_size * self.x_dim / 2]
        self.ylim = [-cell_size * self.y_dim / 2, cell_size * self.y_dim / 2]
        self._grid_device = None

    def convert_map(self) -> torch.Tensor:
        """Move the built grid to the device (reference ``convert_map``)."""
        self._grid_device = torch.as_tensor(self.map, dtype=self.dtype, device=self.device)
        return self._grid_device

    def as_field(self) -> OccupancyGridField:
        if self._grid_device is None:
            self.convert_map()
        return OccupancyGridField(grid=self._grid_device, cell_size=self.cell_size)

    # --- the field's API on the map (the grid lookup, K10 on a CUDA tensor) ---
    def get_collisions(self, x, **kw):
        """``x [..., 2]`` world positions -> ``[...]`` occupancy, through
        ``as_field()``."""
        field = self.as_field()
        return field.compute_cost(torch.as_tensor(x, dtype=self.dtype, device=field.grid.device))

    def compute_cost(self, x, **kw):
        return self.get_collisions(x, **kw)

    def __call__(self, x, **kw):
        return self.compute_cost(x, **kw)

    def get_xy_grid(self) -> torch.Tensor:
        """``[x_dim, y_dim, 2]`` world coordinates spanning the map."""
        xv = np.linspace(self.xlim[0], self.xlim[1], self.x_dim)
        yv = np.linspace(self.ylim[0], self.ylim[1], self.y_dim)
        gx, gy = np.meshgrid(xv, yv, indexing="ij")
        return torch.as_tensor(np.stack([gx, gy], axis=2), dtype=self.dtype, device=self.device)

    def plot(self, save_dir=None, filename="obst_map.png"):
        import matplotlib.pyplot as plt

        fig = plt.figure()
        plt.imshow(self.map)
        plt.gca().invert_yaxis()
        if save_dir is not None:
            import os.path as osp

            plt.savefig(osp.join(save_dir, filename))
        return fig
