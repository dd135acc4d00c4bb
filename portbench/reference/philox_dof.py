"""The fused dof Panda kernel's draw (K5), in NumPy.

For launch seed ``s`` (key ``(s mod 2**32, s >> 32)``), dof ``d``, particle
``p`` and sample pair ``j``, the counter ``(lane m, j, p, d)`` gives the
normals of samples ``2 j`` and ``2 j + 1`` at lane ``m`` of dof ``d``'s
plane, from the top 24 bits of its first two words by the dual-output
Box-Muller of K2 (``philox.py``). Lanes are the plane's: ``[0, T)`` the
positions, ``[T, 2T)`` the velocities.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.philox import box_muller, philox4x32_10


def dof_normals_at(seed: int, n_dof: int, lanes: int, particles, pairs) -> np.ndarray:
    """The normals of samples ``2 j`` and ``2 j + 1`` of particle ``p`` for
    each ``(p, j)`` of ``zip(particles, pairs)``: ``[D, K, 2, M]``
    float64."""
    seed = int(seed)
    k0, k1 = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    p = np.asarray(particles, dtype=np.uint32)[None, :, None]
    j = np.asarray(pairs, dtype=np.uint32)[None, :, None]
    d = np.arange(n_dof, dtype=np.uint32)[:, None, None]
    m = np.arange(lanes, dtype=np.uint32)[None, None, :]
    shape = (n_dof, p.shape[1], lanes)
    bits = philox4x32_10(*(np.broadcast_to(c, shape) for c in (m, j, p, d)), k0, k1)
    z0, z1 = box_muller(bits[0], bits[1])
    return np.stack([z0, z1], axis=2)


def dof_normals(seed: int, n_dof: int, num_particles: int, num_samples: int,
                lanes: int) -> np.ndarray:
    """The kernel's whole draw for launch ``seed``: ``[D, P, S, M]``
    float64."""
    pairs = -(-num_samples // 2)
    pp, jj = np.meshgrid(np.arange(num_particles), np.arange(pairs), indexing="ij")
    z = dof_normals_at(seed, n_dof, lanes, pp.ravel(), jj.ravel())
    return z.reshape(n_dof, num_particles, 2 * pairs, lanes)[:, :, :num_samples]
