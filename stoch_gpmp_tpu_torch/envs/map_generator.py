"""Random obstacle-map generation with seeded rejection sampling.

Host numpy, identical to ``stoch_gpmp_tpu/envs/map_generator.py``: one
``rng`` gives the identical grid and obstacle list. Capability parity with
reference ``stoch_gpmp/envs/map_generator.py:9-92``: fixed obstacles are
placed first, then random rect/circle obstacles are rejection-sampled (up
to 25 attempts each) so that no two obstacles overlap. Randomness comes
from an explicit ``numpy.random.Generator`` (or seed).
"""

from __future__ import annotations

import copy
import warnings

import numpy as np
import torch

from stoch_gpmp_tpu_torch.envs.obst_map import ObstacleMap
from stoch_gpmp_tpu_torch.envs.obst_utils import random_circle, random_rect
from stoch_gpmp_tpu_torch.utils.profiling import annotate


@annotate("envs.obstacle_map")
def generate_obstacle_map(
    map_dim=(10, 10),
    obst_list=(),
    cell_size: float = 1.0,
    random_gen: bool = False,
    num_obst: int = 0,
    rand_limits=None,
    rand_rect_shape=(2, 2),
    rand_circle_radius: float = 1.0,
    max_attempts: int = 25,
    rng: np.random.Generator | int | None = None,
    dtype=None,
    device=None,
):
    """Build an ``ObstacleMap``; returns ``(obst_map, obst_list)``.

    Mirrors the reference signature; ``rng`` may be a seed int or a numpy
    Generator. ``dtype``/``device`` place the device grid.
    """
    obst_map = ObstacleMap(
        map_dim, cell_size, dtype=dtype if dtype is not None else torch.float32,
        device=device,
    )
    num_fixed = len(obst_list)
    for obst in obst_list:
        obst.add_to_map(obst_map)

    obst_list = list(copy.deepcopy(list(obst_list)))
    if random_gen:
        assert num_fixed <= num_obst, (
            "num_obst must be >= the number of fixed obstacles"
        )
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)
        xlim, ylim = rand_limits[0], rand_limits[1]
        width, height = rand_rect_shape[0], rand_rect_shape[1]
        for _ in range(num_obst - num_fixed):
            for attempt in range(max_attempts + 1):
                if rng.integers(2):
                    obst = random_rect(rng, xlim, ylim, width, height)
                else:
                    obst = random_circle(rng, xlim, ylim, rand_circle_radius)
                if obst.obstacle_collision_check(obst_map):
                    obst.add_to_map(obst_map)
                    obst_list.append(obst)
                    break
                if attempt == max_attempts:
                    warnings.warn(
                        "Obstacle generation: max attempts reached; "
                        f"placed {len(obst_list)} obstacles "
                        f"({len(obst_list) - num_fixed} random)."
                    )

    obst_map.convert_map()
    return obst_map, obst_list

