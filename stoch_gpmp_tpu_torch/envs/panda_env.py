"""Obstacle spawning of the Panda environment.

PyTorch-package counterpart of part of ``stoch_gpmp_tpu/envs/panda_env.py``
(numpy only): the spawn-box constants and ``random_init_static_sphere``,
the sphere draw that the Panda example and the success-rate evaluation use
for their obstacles. The simulated environment itself is not ported yet.
"""

from __future__ import annotations

import numpy as np

BOX_SCALE = 0.3
BOX_CENTER = 0.5
SPHERE_SCALE = {"MIN": 0.08, "MAX": 0.1}
SPHERE_VELOCITY = {"MIN": 0.0, "MAX": 0.1}

_SPHERE_MIN = np.array(
    [BOX_CENTER - 0.6 * BOX_SCALE, -abs(BOX_CENTER - 0.5 * BOX_SCALE), 0.05]
)
_SPHERE_MAX = np.array(
    [BOX_CENTER + 0.6 * BOX_SCALE, abs(BOX_CENTER - 0.5 * BOX_SCALE), 0.5]
)


def random_init_static_sphere(
    scale_min: float,
    scale_max: float,
    base_position_min: np.ndarray,
    base_position_max: np.ndarray,
    base_offset: float,
    rng: np.random.Generator | None = None,
) -> tuple:
    """A random radius in ``[scale_min, scale_max]`` and a position: one
    coordinate (picked at random) interpolated inside the box, the others
    raw ``rng.random()`` draws, x and y given random signs, then every
    coordinate's magnitude clipped to ``[base_offset, base_position_max]``.
    ``rng`` is required: the draws come only from an explicit generator."""
    if rng is None:
        raise TypeError("random_init_static_sphere needs an explicit np.random.Generator")
    alpha_scale = rng.uniform()
    scale = alpha_scale * scale_min + (1 - alpha_scale) * scale_max

    idx = rng.permutation([1, 0, 0])
    base_position = rng.random(3)
    alpha = rng.random(1)
    base_position[idx == 1] = (
        alpha * base_position_min[idx == 1] + (1 - alpha) * base_position_max[idx == 1]
    )
    signs = rng.integers(2, size=2)
    base_position[:-1] *= signs * 2 - 1
    base_position = np.sign(base_position) * np.clip(
        np.abs(base_position), a_min=base_offset, a_max=base_position_max
    )
    return scale, base_position
