"""The 2D collision fields of the PyTorch port against the JAX package: the
plain versions of K10 (grid lookup) and K11 (primitive field) against the
JAX Pallas kernels (interpret mode on the CPU) and fields, their zero
Gauss-Newton Jacobians, and the reference-shaped planar stack on each field
through ``stoch_gpmp_optimize`` with the JAX draws injected.

Tolerances: the field values are counts or grid entries, compared with
exact equality (points drawn at random, so none sits within an ulp of a
cell edge or a primitive's boundary, where the two packages may round a
product differently). The planner's means, costs and weights: rtol 1e-9 in
float64 (only the summation order differs).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stoch_gpmp_tpu_torch import convert  # noqa: E402
from stoch_gpmp_tpu_torch.ops.kernels.fields import (  # noqa: E402
    grid_lookup,
    grid_lookup_plain,
    primitive_field_cost,
    primitive_field_cost_plain,
    raster_primitive_cost,
)

RTOL = 1e-9
S, TAU, STEP = 128, 1.0, 0.5


def _jax_map(dtype=jnp.float32, rng=0, num_obst=15):
    from stoch_gpmp_tpu.envs import generate_obstacle_map

    return generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=num_obst,
        rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2], rng=rng, dtype=dtype)


def _strided_points(rng, dtype, b=40, t=64, scale=11.0):
    """The planner's collision slice: ``trajs[:, 1:, :2]`` of a ``[B, T, 4]``
    batch, a strided view, plus the same points as numpy."""
    trajs = rng.uniform(-scale, scale, (b, t, 4)).astype(dtype)
    return torch.from_numpy(trajs)[:, 1:, :2], trajs[:, 1:, :2]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_grid_lookup_plain_matches_jax_exactly(dtype):
    """K10's plain version against the JAX Pallas ``grid_lookup`` and
    ``OccupancyGridField.compute_cost`` on a random 200 x 200 grid, at the
    planner's strided slice and at off-map points."""
    from stoch_gpmp_tpu.costs.fields import OccupancyGridField
    from stoch_gpmp_tpu.ops.pallas import grid_lookup as jgrid

    rng = np.random.default_rng(0)
    grid = rng.random((200, 200)).astype(dtype)
    view, pts = _strided_points(rng, dtype, b=24)
    far = np.array([[50.0, -50.0], [-1e6, 1e6], [0.0, 0.0]], dtype=dtype)
    tgrid = torch.from_numpy(grid)
    for t_pts, j_pts in ((view, pts), (torch.from_numpy(far), far)):
        want = np.asarray(OccupancyGridField(grid=jnp.asarray(grid), cell_size=0.1)
                          .compute_cost(jnp.asarray(j_pts)))
        got = grid_lookup_plain(tgrid, t_pts, 0.1).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(grid_lookup(tgrid, t_pts, 0.1).numpy(), want)
    if dtype == "float32":  # the Pallas kernel in interpret mode
        np.testing.assert_array_equal(
            grid_lookup_plain(tgrid, view, 0.1).numpy(),
            np.asarray(jgrid(jnp.asarray(grid), jnp.asarray(pts), 0.1)))


@pytest.mark.parametrize("kind", ["both", "rects", "circles", "none"])
def test_primitive_field_plain_matches_jax_exactly(kind):
    """K11's plain version against the JAX Pallas ``primitive_field_cost``
    and ``Primitive2DField.compute_cost``, including rect-only, circle-only
    and empty maps."""
    from stoch_gpmp_tpu.costs.fields import Primitive2DField
    from stoch_gpmp_tpu.ops.pallas import primitive_field_cost as jprim

    rng = np.random.default_rng(1)
    rects = rng.uniform(-5, 5, (4, 4)).astype(np.float32)
    rects[:, 2:] = 2.0
    circles = rng.uniform(-5, 5, (3, 3)).astype(np.float32)
    circles[:, 2] = 1.5
    if kind in ("circles", "none"):
        rects = rects[:0]
    if kind in ("rects", "none"):
        circles = circles[:0]
    view, pts = _strided_points(rng, np.float32, b=20, scale=8.0)
    want = np.asarray(Primitive2DField(rects=jnp.asarray(rects), circles=jnp.asarray(circles))
                      .compute_cost(jnp.asarray(pts)))
    tr, tc = torch.from_numpy(rects), torch.from_numpy(circles)
    got = primitive_field_cost_plain(tr, tc, view).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(primitive_field_cost(tr, tc, view).numpy(), want)
    np.testing.assert_array_equal(
        got, np.asarray(jprim(jnp.asarray(rects), jnp.asarray(circles), jnp.asarray(pts))))
    if kind == "both":
        assert want.max() >= 1  # the points do hit primitives
        # float64, the points on rectangle edges and circle rims included
        edge = np.concatenate([rects[:, :2] + 0.5 * rects[:, 2:],
                               circles[:, :2] + circles[:, 2:] * [1.0, 0.0]]).astype(np.float64)
        p64 = np.concatenate([pts.reshape(-1, 2).astype(np.float64), edge])
        want64 = np.asarray(Primitive2DField(
            rects=jnp.asarray(rects, jnp.float64), circles=jnp.asarray(circles, jnp.float64),
        ).compute_cost(jnp.asarray(p64)))
        got64 = primitive_field_cost_plain(tr.double(), tc.double(), torch.from_numpy(p64))
        np.testing.assert_array_equal(got64.numpy(), want64)


def test_fields_from_the_map_equal_jax():
    """``ObstacleMap.as_field()``, ``Primitive2DField.from_obstacles`` and
    the raster field of the port's own map against the JAX package's, with
    ``compute_collision`` and ``compute_distance``, and the grid and raster
    fields equal on every point (exact grid parity)."""
    from stoch_gpmp_tpu.costs.fields import Primitive2DField as JPrim
    from stoch_gpmp_tpu_torch.costs import Primitive2DField, RasterPrimitive2DField
    from stoch_gpmp_tpu_torch.envs import generate_obstacle_map

    jmap, jlist = _jax_map()
    tmap, tlist = generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
        rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2], rng=0, device="cpu")
    pts = np.random.default_rng(2).uniform(-12, 12, (3000, 2)).astype(np.float32)
    tp = torch.from_numpy(pts)
    fields = {
        "grid": (tmap.as_field(), jmap.as_field()),
        "primitive": (Primitive2DField.from_obstacles(tlist, device="cpu"),
                      JPrim.from_obstacles(jlist)),
    }
    for name, (tf, jf) in fields.items():
        want = np.asarray(jf.compute_cost(jnp.asarray(pts)))
        np.testing.assert_array_equal(tf.compute_cost(tp).numpy(), want, err_msg=name)
        np.testing.assert_array_equal(tf.compute_collision(tp).numpy(),
                                      np.asarray(jf.compute_collision(jnp.asarray(pts))))
        np.testing.assert_array_equal(tf.compute_distance(tp).numpy(),
                                      np.asarray(jf.compute_distance(jnp.asarray(pts))))
        conv = convert._field_from_jax(jf, torch.float32, torch.device("cpu"))
        np.testing.assert_array_equal(conv.compute_cost(tp).numpy(), want, err_msg=name)
    raster = RasterPrimitive2DField.from_map(tmap, tlist, device="cpu")
    np.testing.assert_array_equal(raster.compute_cost(tp).numpy(),
                                  fields["grid"][0].compute_cost(tp).numpy())
    assert bool(raster.compute_collision(tp).any())


def test_field_wrappers_contract():
    """A CPU tensor takes the plain version and counts no launch; another
    device raises; the gradient with respect to the points is zero (the JAX
    package's ``jax.grad`` through the ``int32`` cell index)."""
    rng = np.random.default_rng(3)
    grid = torch.from_numpy(rng.random((200, 200)).astype(np.float32))
    rects = torch.tensor([[0.0, 0.0, 2.0, 2.0]])
    circles = torch.tensor([[1.0, 1.0, 1.5]])
    rb = torch.tensor([[90, 110, 90, 110]], dtype=torch.int32)
    pts = torch.from_numpy(rng.uniform(-3, 3, (50, 2)).astype(np.float32)).requires_grad_(True)
    calls = {
        "grid": lambda x: grid_lookup(grid, x, 0.1),
        "primitive": lambda x: primitive_field_cost(rects, circles, x),
        "raster": lambda x: raster_primitive_cost(rb, circles, x, cell_size=0.1, nx=200, ny=200),
    }
    for name, fn in calls.items():
        out = fn(pts)
        assert out.requires_grad, name
        (g,) = torch.autograd.grad(out.sum(), pts)
        assert g.shape == pts.shape and not bool(g.any()), name
        with pytest.raises(ValueError, match="unsupported device"):
            fn(pts.detach().to("meta"))
    assert grid_lookup.launches == primitive_field_cost.launches == 0


def _jax_coll(field, n_dof=2, t=24, sigma=0.1):
    from stoch_gpmp_tpu.costs import CostCollision

    return CostCollision.create(n_dof, t, field, sigma_coll=sigma)


@pytest.mark.parametrize("kind", ["grid", "primitive", "raster"])
def test_collision_gn_zero_jacobian_matches_jax(kind):
    """``CostCollision.gn_contrib``/``gn_rank1`` on each 2D field against
    JAX: the Jacobian is zero on all three (piecewise-constant fields), so
    the GN collision term is inert, and the errors are the field's."""
    from stoch_gpmp_tpu.costs.fields import Primitive2DField, RasterPrimitive2DField

    jmap, jlist = _jax_map(jnp.float64)
    jfield = {
        "grid": jmap.as_field(),
        "primitive": Primitive2DField.from_obstacles(jlist, dtype=jnp.float64),
        "raster": RasterPrimitive2DField.from_map(jmap, jlist, dtype=jnp.float64,
                                                  use_pallas=False),
    }[kind]
    jc = _jax_coll(jfield, t=64)
    tc = convert.cost_from_jax(jc, device="cpu")
    trajs = np.random.default_rng(4).uniform(-8, 8, (6, 64, 4))
    jt, tt = jnp.asarray(trajs), torch.from_numpy(trajs)
    h, e, k = tc.gn_rank1(tt)
    jh, je, jk = jc.gn_rank1(jt)
    assert k == jk and not bool(h.any()) and not np.asarray(jh).any()
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert float(e.max()) >= 1.0  # some points are inside obstacles
    c, jcn = tc.gn_contrib(tt), jc.gn_contrib(jt)
    np.testing.assert_array_equal(c.diag.numpy(), np.asarray(jcn.diag))
    np.testing.assert_array_equal(c.g.numpy(), np.asarray(jcn.g))


def test_gn_over_raster_field_matches_jax():
    """Gauss-Newton over ``RasterPrimitive2DField`` (K1's wrapper carries the
    zero backward): three steps of the structured solve against JAX, rtol
    1e-9 in float64."""
    from stoch_gpmp_tpu.costs import CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.costs.fields import RasterPrimitive2DField
    from stoch_gpmp_tpu.planners.gpmp import GPMPState as JState
    from stoch_gpmp_tpu.planners.gpmp import gpmp_optimize as jopt
    from stoch_gpmp_tpu_torch.planners import gpmp_optimize

    jmap, jlist = _jax_map(jnp.float64, num_obst=10)
    field = RasterPrimitive2DField.from_map(jmap, jlist, dtype=jnp.float64, use_pallas=False)
    start = jnp.asarray([-9.0, -9.0, 0.0, 0.0])
    goals = jnp.asarray([[9.0, 6.0, 0.0, 0.0], [9.0, -3.0, 0.0, 0.0]])
    jc = CostComposite.create(2, 64, [
        CostGP.create(2, 64, start, 0.05, {"sigma_start": 0.01, "sigma_gp": 0.5},
                      dtype=jnp.float64),
        CostGoalPrior.create(2, 64, goals, sigma_goal_prior=0.01, dtype=jnp.float64),
        _jax_coll(field, t=64, sigma=0.05),
    ])
    means = np.random.default_rng(5).normal(scale=2.0, size=(4, 64, 4))
    js = JState(particle_means=jnp.asarray(means), key=jax.random.PRNGKey(0))
    want = np.asarray(jopt(jc, js, {}, opt_iters=3, delta=1e-2, trust_region=False,
                           step_size=0.3).particle_means)
    ts = convert.gpmp_state_from_jax(js, device="cpu")
    got = gpmp_optimize(convert.cost_from_jax(jc, device="cpu"), ts, {}, opt_iters=3,
                        delta=1e-2, trust_region=False, step_size=0.3).particle_means.numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.fixture(scope="module")
def reference_problems():
    """The reference-shaped parity stacks (``CostGP + CostGoalPrior +
    CostCollision(field)``, 3 goals x 5 particles, T = 64) on the grid and
    on the primitives, in float64, in both packages."""
    from __graft_entry__ import _build_problem
    from stoch_gpmp_tpu.costs.fields import Primitive2DField

    js, jgrid, jst = _build_problem(fast=False, dtype=jnp.float64)
    _, jlist = _jax_map(jnp.float64)
    coll = jgrid.costs[2]
    jprim = jgrid.replace(costs=jgrid.costs[:2] + (coll.replace(
        field=Primitive2DField.from_obstacles(jlist, dtype=jnp.float64)),))
    return js, {"grid": jgrid, "primitive": jprim}, jst


@pytest.mark.parametrize("kind", ["grid", "primitive"])
def test_reference_planar_route_matches_jax(reference_problems, kind):
    """Three flat-path iterations of the reference-shaped planar stack with
    the JAX draws injected, against JAX ``stoch_gpmp_optimize``; the port's
    natively built stack evaluates equal to the converted one."""
    from stoch_gpmp_tpu.planners import stoch_gpmp_optimize as jopt
    from stoch_gpmp_tpu_torch.planners import stoch_gpmp_optimize
    from stoch_gpmp_tpu_torch.problems import build_planar_cost

    js, jcosts, jst = reference_problems
    jc = jcosts[kind]
    p, t, d = jst.particle_means.shape
    eps, key = [], jst.key
    for _ in range(3):
        key, sub = jax.random.split(key)
        eps.append(torch.from_numpy(np.array(jax.random.normal(sub, (p, S, t * d),
                                                               dtype=jnp.float64))))
    jn, ja = jax.jit(lambda s, c, st: jopt(
        s, c, st, {}, opt_iters=3, num_samples=S, temperature=TAU,
        step_size=STEP))(js, jc, jst)
    tc = convert.cost_from_jax(jc, device="cpu")
    tn, ta = stoch_gpmp_optimize(
        convert.sampler_from_jax(js, device="cpu"), tc, convert.state_from_jax(jst, device="cpu"),
        {}, opt_iters=3, num_samples=S, temperature=TAU, step_size=STEP, eps=eps)
    for got, want in ((tn.particle_means, jn.particle_means), (ta.costs, ja.costs),
                      (ta.weights, ja.weights)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    native, field = build_planar_cost(dtype=torch.float64, device="cpu", fast=False, field=kind)
    assert type(field).__name__ == type(tc.costs[2].field).__name__
    x = ta.samples.reshape(-1, t, d)
    want = tc.eval(x)
    np.testing.assert_allclose(native.eval(x).numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))
