"""Map, cost stack and the raster-field kernel's plain version against the
JAX package.

- The obstacle map: one ``rng`` gives the identical grid and obstacle list.
- K1 (``raster_primitive_cost``): the port's plain version equals the JAX
  kernel, run in interpret mode as the JAX tests run it on the CPU, exactly:
  float32 on ~121k random points, points on and next to every cell edge,
  points outside the map (clamping), and empty rectangle / circle sets;
  float64 on the random points.

The cost stack and the native build of the whole problem are compared in
``test_torch_planner.py``, which builds the JAX problem once.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from stoch_gpmp_tpu.ops.pallas.fields import raster_primitive_cost as jax_raster  # noqa: E402
from stoch_gpmp_tpu_torch.ops.kernels.fields import (  # noqa: E402
    raster_primitive_cost,
    raster_primitive_cost_plain,
)
from stoch_gpmp_tpu_torch.problems import build_planar_cost  # noqa: E402

MAP_KW = dict(map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
              rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2])


@pytest.mark.parametrize("rng", [0, 3, 11])
def test_obstacle_map_identical(rng):
    from stoch_gpmp_tpu.envs import generate_obstacle_map as jgen
    from stoch_gpmp_tpu_torch.envs import generate_obstacle_map as tgen

    jm, jl = jgen(rng=rng, **MAP_KW)
    tm, tl = tgen(rng=rng, **MAP_KW)
    np.testing.assert_array_equal(tm.map, jm.map)
    assert [(type(o).__name__, vars(o).keys()) for o in tl] == [
        (type(o).__name__, vars(o).keys()) for o in jl]
    for a, b in zip(tl, jl):
        for k, v in vars(b).items():
            np.testing.assert_array_equal(getattr(a, k), v)
    # the grid field of the map reads the same occupancy in both packages
    pts = np.random.default_rng(rng).uniform(-11, 11, (4096, 2))
    np.testing.assert_array_equal(
        tm.as_field().compute_cost(torch.from_numpy(pts)).numpy(),
        np.asarray(jm.as_field().compute_cost(jnp.asarray(pts, jnp.float32))))


def _edge_points(dtype):
    k = np.arange(-110, 111).astype(dtype) * dtype(0.1)
    e = np.stack(np.meshgrid(k, k), -1).reshape(-1, 2)
    far = np.asarray([[50, -50], [-1e6, 1e6], [10.0, 10.0], [-10.0, -10.0]], dtype)
    return np.concatenate(
        [e, np.nextafter(e, dtype(1e9)), np.nextafter(e, dtype(-1e9)), far])


@pytest.mark.parametrize("case", ["random", "edges", "no_rects", "no_circles"])
def test_raster_plain_equals_jax_float32(case):
    _, field = build_planar_cost(dtype=torch.float32, device="cpu")
    rb, ci = field.rect_bounds, field.circles
    if case == "no_rects":
        rb = rb[:0]
    if case == "no_circles":
        ci = ci[:0]
    rng = np.random.default_rng(0)
    pts = (_edge_points(np.float32) if case == "edges"
           else rng.uniform(-11, 11, (1920, 63, 2)).astype(np.float32))
    want = np.asarray(jax_raster(jnp.asarray(rb.numpy()), jnp.asarray(ci.numpy()),
                                 jnp.asarray(pts), cell_size=0.1, nx=200, ny=200))
    got = raster_primitive_cost(rb, ci, torch.from_numpy(pts), cell_size=0.1, nx=200, ny=200)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_raster_plain_equals_jax_float64_strided():
    """float64, and the strided ``[B, T-1, 2]`` slice the planner passes."""
    _, field = build_planar_cost(dtype=torch.float64, device="cpu")
    trajs = np.random.default_rng(1).uniform(-11, 11, (1920, 64, 4))
    want = np.asarray(jax_raster(
        jnp.asarray(field.rect_bounds.numpy()), jnp.asarray(field.circles.numpy()),
        jnp.asarray(trajs[:, 1:, :2]), cell_size=0.1, nx=200, ny=200))
    view = torch.from_numpy(trajs)[:, 1:, :2]
    assert not view.is_contiguous()
    got = raster_primitive_cost_plain(field.rect_bounds, field.circles, view,
                                      cell_size=0.1, nx=200, ny=200)
    np.testing.assert_array_equal(got.numpy(), want)


def test_raster_wrapper_rejects_other_devices():
    _, field = build_planar_cost(dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        raster_primitive_cost(field.rect_bounds, field.circles,
                              torch.zeros((2, 2), device="meta"), cell_size=0.1, nx=200, ny=200)


@pytest.mark.parametrize("layout", ["dof_planes", "separate"])
def test_raster_planes_match_jax(layout):
    """``RasterPrimitive2DField.compute_cost_planes`` and
    ``CostCollision.eval_dof_planes`` against JAX's, float64, exactly: the
    dof path's position planes ``x_planes[0/1, :, :T]`` (read in place as one
    strided point set) and two separate planes (stacked)."""
    from stoch_gpmp_tpu.costs import CostCollision as JColl
    from stoch_gpmp_tpu.costs.fields import RasterPrimitive2DField as JField
    from stoch_gpmp_tpu_torch.costs import CostCollision

    _, field = build_planar_cost(dtype=torch.float64, device="cpu")
    jfield = JField(rect_bounds=jnp.asarray(field.rect_bounds.numpy()),
                    circles=jnp.asarray(field.circles.numpy()), cell_size=0.1, nx=200, ny=200)
    xp = torch.from_numpy(np.random.default_rng(2).uniform(-11, 11, (2, 96, 256)))
    x, y = xp[0, :, :128], xp[1, :, :128]
    if layout == "separate":
        x, y = x.clone(), y.clone()
    want = np.asarray(jfield.compute_cost_planes(jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    np.testing.assert_array_equal(field.compute_cost_planes(x, y).numpy(), want)
    coll = CostCollision.create(2, 128, field, sigma_coll=1e-5)
    jcoll = JColl.create(2, 128, jfield, sigma_coll=1e-5)
    np.testing.assert_array_equal(coll.eval_dof_planes(xp).numpy(),
                                  np.asarray(jcoll.eval_dof_planes(jnp.asarray(xp.numpy()))))
    assert coll.supports_dof_planes() and want.sum() > 0
