"""Random obstacle helpers: host numpy, identical to
``stoch_gpmp_tpu/envs/obst_utils.py`` (reference ``stoch_gpmp/envs/obst_utils.py``)."""

from __future__ import annotations

from math import ceil

import numpy as np

from stoch_gpmp_tpu_torch.envs.obst_map import ObstacleCircle, ObstacleRectangle


def round_up(n: float, decimals: int = 0) -> float:
    multiplier = 10**decimals
    return ceil(n * multiplier) / multiplier


def random_rect(rng: np.random.Generator, xlim=(0, 0), ylim=(0, 0), width=2, height=2):
    """Rectangle at a uniformly random center (seeded via ``rng``)."""
    cx = rng.uniform(xlim[0], xlim[1])
    cy = rng.uniform(ylim[0], ylim[1])
    return ObstacleRectangle(cx, cy, width, height)


def random_circle(rng: np.random.Generator, xlim=(0, 0), ylim=(0, 0), radius=2.0):
    """Circle at a uniformly random center (seeded via ``rng``)."""
    cx = rng.uniform(xlim[0], xlim[1])
    cy = rng.uniform(ylim[0], ylim[1])
    return ObstacleCircle(cx, cy, radius)
