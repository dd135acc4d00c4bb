"""Philox4x32-10 and the dual-output Box-Muller transform, in NumPy.

The fused planar kernel (K2) draws its standard normals in the kernel: for
launch seed ``s`` (key ``(s mod 2**32, s >> 32)``), particle ``p`` and
16-row sample tile starting at ``s0``, the counter ``(lane m, s0 + j, p,
0)`` for ``j < 8`` gives the pair of normals of rows ``s0 + j`` and
``s0 + j + 8`` at lane ``m``, from the top 24 bits of its first two words
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11).
"""

from __future__ import annotations

import numpy as np

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint32(0x9E3779B9), np.uint32(0xBB67AE85)
_MASK = np.uint64(0xFFFFFFFF)
_TILE = 16


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Ten Philox rounds on counter words ``c0..c3`` (uint32 arrays of one
    shape) under key ``(k0, k1)``; returns the four output words."""
    c = [np.asarray(w, dtype=np.uint32) for w in (c0, c1, c2, c3)]
    k0, k1 = np.uint32(k0), np.uint32(k1)
    with np.errstate(over="ignore"):
        for _ in range(10):
            p0 = _M0 * c[0].astype(np.uint64)
            p1 = _M1 * c[2].astype(np.uint64)
            hi0, lo0 = (p0 >> np.uint64(32)).astype(np.uint32), (p0 & _MASK).astype(np.uint32)
            hi1, lo1 = (p1 >> np.uint64(32)).astype(np.uint32), (p1 & _MASK).astype(np.uint32)
            c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
            k0 = np.uint32(k0 + _W0)
            k1 = np.uint32(k1 + _W1)
    return c


def box_muller(b1, b2):
    """Two standard normals per pair of 32-bit words: ``u1 = (b1 >> 8 +
    1/2) / 2**24`` in (0, 1) and ``u2 = (b2 >> 8) / 2**24``, both and the
    angle ``2 pi u2`` rounded to float32 as the kernel rounds them, then
    ``sqrt(-2 log u1) (cos, sin)`` in float64."""
    f32 = np.float32
    u1 = (b1 >> np.uint32(8)).astype(f32) * f32(1.0 / 16777216.0) + f32(0.5 / 16777216.0)
    u2 = (b2 >> np.uint32(8)).astype(f32) * f32(1.0 / 16777216.0)
    a = (f32(6.283185307179586) * u2).astype(np.float64)
    r = np.sqrt(-2.0 * np.log(u1.astype(np.float64)))
    return r * np.cos(a), r * np.sin(a)


def fused_normals(seed: int, num_particles: int, num_samples: int, lanes: int) -> np.ndarray:
    """The fused planar kernel's draw for launch ``seed``: ``[P, S, M]``
    float64."""
    seed = int(seed)
    k0, k1 = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    tiles = -(-num_samples // _TILE)
    half = _TILE // 2
    m = np.arange(lanes, dtype=np.uint32)[None, None, None, :]
    p = np.arange(num_particles, dtype=np.uint32)[:, None, None, None]
    t = np.arange(tiles, dtype=np.uint32)[None, :, None, None]
    j = np.arange(half, dtype=np.uint32)[None, None, :, None]
    shape = (num_particles, tiles, half, lanes)
    bits = philox4x32_10(np.broadcast_to(m, shape), np.broadcast_to(t * _TILE + j, shape),
                         np.broadcast_to(p, shape), np.zeros(shape, np.uint32), k0, k1)
    z0, z1 = box_muller(bits[0], bits[1])
    out = np.concatenate([z0, z1], axis=2).reshape(num_particles, tiles * _TILE, lanes)
    return out[:, :num_samples]
