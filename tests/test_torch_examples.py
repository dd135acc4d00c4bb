"""The port's example twins (``stoch_gpmp_tpu_torch/examples``) run end to
end on the CPU at small sizes, under the gates of ``tests/test_examples.py``
(the JAX package's examples): they exit normally and print their lines.

The planar twins are also held to the JAX package, in float32 as the
examples run:

- the obstacle map: the grid equal to the JAX ``generate_obstacle_map``'s,
  bit for bit;
- each of ``planar_environment``'s three cost stacks on a fixed numpy batch
  of trajectories: within rtol 1e-5 of the stack built with JAX calls as
  ``examples/planar_environment.py`` builds it (float32 sums in another
  order; the collision term is a count times 1e10 in both);
- ``planar_gpmp``, 10 iterations of each method from the JAX planner's
  initial means: the positions within 1e-3 of the JAX ``GPMP``'s at the
  example's constants (float32 solves of a system with weights of 1e4 to
  4e5 against a damping of 1e-2).
"""

import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STACK_RTOL = 1e-5
GN_ATOL = 1e-3


def test_panda_example(capsys, tmp_path):
    from stoch_gpmp_tpu_torch.examples import panda_environment

    panda_environment.main(["--iters", "20", "--seed", "0", "--device", "cpu", "--fast",
                            "--plot", str(tmp_path / "p.png")])
    out = capsys.readouterr().out
    assert "final EE->target distances" in out and "iter   20/20" in out
    assert (tmp_path / "p.png").exists()


def test_planar_sharded_example(capsys):
    """Four gloo ranks on the CPU, mesh (2, 2), reach the goals."""
    from stoch_gpmp_tpu_torch.examples import planar_sharded

    planar_sharded.main(["--devices", "4", "--iters", "40", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "over 4 ranks" in out and "mesh: (2, 2)" in out
    line = out.split("final distance to nearest goal per particle:")[1]
    dists = np.array(line.replace("[", " ").replace("]", " ").split(), dtype=float)
    assert dists.size == 18 and dists.max() < 0.3


@pytest.mark.parametrize("extra", [[], ["--fast"]])
def test_planar_example(extra, capsys, tmp_path):
    from stoch_gpmp_tpu_torch.examples import planar_environment

    planner = planar_environment.main(["--iters", "20", "--seed", "0", "--device", "cpu",
                                       "--plot", str(tmp_path / "out.png"), *extra])
    out = capsys.readouterr().out
    assert "Iteration:    20/   20" in out
    assert (tmp_path / "out.png").exists()
    assert planner.particle_means.shape == (15, 64, 4)


def test_planar_example_animation(capsys, tmp_path):
    """``--animate``: a frame every 25 iterations, saved as a GIF."""
    from stoch_gpmp_tpu_torch.examples import planar_environment

    planar_environment.main(["--iters", "50", "--seed", "0", "--device", "cpu",
                             "--animate", str(tmp_path / "a.gif")])
    out = capsys.readouterr().out
    assert out.count("Iteration:") == 2 and "saved animation" in out
    assert (tmp_path / "a.gif").read_bytes()[:6] == b"GIF89a"


def test_planar_example_long_horizon_takes_the_plane_route(monkeypatch, capsys):
    """``--fast --traj-len 520`` (M = 2080): the raster stack on the
    ``"planes"`` route; on the CPU each iteration runs S1's plain scan once
    and K1's plain version once (and the init draw one more scan)."""
    from stoch_gpmp_tpu_torch.examples import planar_environment
    from stoch_gpmp_tpu_torch.ops.kernels import bidiag_scan, fields
    from stoch_gpmp_tpu_torch.planners.stoch_gpmp import _route

    calls = {"S1": 0, "K1": 0}

    def counted(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(bidiag_scan, "plain_solve", counted("S1", bidiag_scan.plain_solve))
    monkeypatch.setattr(fields, "raster_primitive_cost_plain",
                        counted("K1", fields.raster_primitive_cost_plain))
    planner = planar_environment.main(["--fast", "--traj-len", "520", "--iters", "2", "--seed",
                                       "0", "--device", "cpu"])
    assert "Iteration:     2/    2" in capsys.readouterr().out
    assert _route(planner.sampler, planner.cost, 520) == "planes"
    assert type(planner.cost.costs[-1].field).__name__ == "RasterPrimitive2DField"
    assert calls == {"S1": 3, "K1": 2}
    assert bool(torch.isfinite(planner.particle_means).all())


def _jax_map(seed):
    from stoch_gpmp_tpu.envs import generate_obstacle_map

    return generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
        rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2], rng=seed,
        dtype=jnp.float32)


@pytest.mark.parametrize("seed", [0, 1729])
def test_planar_example_map_equals_jax(seed):
    from stoch_gpmp_tpu_torch.examples.planar_environment import build_map

    jmap, jlist = _jax_map(seed)
    tmap, tlist = build_map(seed, device="cpu")
    assert len(tlist) == len(jlist) == 15
    np.testing.assert_array_equal(tmap.as_field().grid.numpy(), np.asarray(jmap.as_field().grid))
    np.testing.assert_array_equal(tmap.map, np.asarray(jmap.map))


def _jax_stack(jmap, jlist, traj_len, fast):
    """The cost stack as ``examples/planar_environment.py`` builds it."""
    from stoch_gpmp_tpu.costs import CostCollision, CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.costs.fields import OccupancyGridField, RasterPrimitive2DField
    from stoch_gpmp_tpu.costs.quadratic import QuadraticCost
    from stoch_gpmp_tpu_torch.problems import DT, GOALS, START

    f32 = jnp.float32
    start, goals = jnp.asarray(START, f32), jnp.asarray(GOALS, f32)
    field = jmap.as_field()
    long_horizon = 2 * 2 * traj_len > 2048
    if fast:
        if long_horizon:
            field = RasterPrimitive2DField.from_map(jmap, jlist, dtype=f32)
        else:
            field = OccupancyGridField(grid=field.grid, cell_size=field.cell_size,
                                       lookup="onehot")
    prior = CostGP.create(2, traj_len, start, DT, {"sigma_start": 0.001, "sigma_gp": 0.1},
                          dtype=f32)
    goal = CostGoalPrior.create(2, traj_len, goals, sigma_goal_prior=0.001, dtype=f32)
    costs = ([QuadraticCost.from_gp_and_goal_prior(prior, goal, traj_len)]
             if fast and not long_horizon else [prior, goal])
    costs.append(CostCollision.create(2, traj_len, field, sigma_coll=1e-5))
    return CostComposite.create(2, traj_len, costs)


@pytest.mark.parametrize("fast, traj_len", [(True, 64), (True, 520), (False, 64)],
                         ids=["fast-grid", "fast-raster-planes", "reference-grid"])
def test_planar_example_stacks_match_jax(fast, traj_len):
    """Each stack of the twin on a fixed float32 batch (3 goals x 4
    trajectories: straight start-to-goal lines plus noise, so some points
    fall in obstacles) within STACK_RTOL of the JAX example's stack."""
    from stoch_gpmp_tpu_torch.examples.planar_environment import build_cost, build_map
    from stoch_gpmp_tpu_torch.problems import GOALS, START

    jmap, jlist = _jax_map(0)
    tmap, tlist = build_map(0, device="cpu")
    tcost = build_cost(tmap, tlist, traj_len, fast, device="cpu")
    assert type(tcost.costs[-1].field).__name__ == (
        "RasterPrimitive2DField" if traj_len == 520 else "OccupancyGridField")
    rng = np.random.default_rng(3)
    s = np.linspace(0.0, 1.0, traj_len)[None, :, None]
    lines = np.asarray(START)[None, None] + s * (np.asarray(GOALS) - START)[:, None]
    trajs = (np.repeat(lines, 4, axis=0)
             + rng.normal(scale=0.3, size=(12, traj_len, 4))).astype(np.float32)
    want = np.asarray(_jax_stack(jmap, jlist, traj_len, fast).eval(jnp.asarray(trajs)))
    got = tcost.eval(torch.from_numpy(trajs)).numpy()
    assert want.shape == (12,) and (want >= 1e10).any()  # the batch does hit obstacles
    np.testing.assert_allclose(got, want, rtol=STACK_RTOL)


@pytest.mark.parametrize("method", ["cholesky", "woodbury"])
def test_planar_gpmp_example_matches_jax(method, monkeypatch, capsys):
    """10 iterations of the twin from the JAX planner's initial means (its
    own init-prior draw at seed 0) against the JAX ``GPMP`` built with
    ``examples/planar_gpmp.py``'s constants."""
    from stoch_gpmp_tpu.costs import CostCollision, CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.envs import generate_obstacle_map
    from stoch_gpmp_tpu.planners import GPMP
    from stoch_gpmp_tpu_torch import problems
    from stoch_gpmp_tpu_torch.examples import planar_gpmp

    f32 = jnp.float32
    start = jnp.asarray([-9.0, -9.0, 0.0, 0.0], dtype=f32)
    goals = jnp.asarray([[9.0, 6.0, 0.0, 0.0], [9.0, -3.0, 0.0, 0.0]], dtype=f32)
    obst_map, _ = generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=10,
        rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2], rng=0, dtype=f32)
    cost = CostComposite.create(2, 64, [
        CostGP.create(2, 64, start, 0.05, {"sigma_start": 0.01, "sigma_gp": 0.5}, dtype=f32),
        CostGoalPrior.create(2, 64, goals, sigma_goal_prior=0.01, dtype=f32),
        CostCollision.create(2, 64, obst_map.as_field(), sigma_coll=0.05),
    ])
    jp = GPMP(num_particles_per_goal=3, traj_len=64, opt_iters=1, dt=0.05, n_dof=2,
              step_size=0.3, start_state=start, multi_goal_states=goals, cost=cost,
              sigma_start_init=0.01, sigma_goal_init=0.01, sigma_gp_init=5.0,
              sigma_start_sample=0.01, sigma_goal_sample=0.01, sigma_gp_sample=0.5,
              solver_params={"delta": 1e-2, "trust_region": False, "method": method},
              seed=0, dtype=f32)
    init = np.asarray(jp.particle_means)
    _, jpos, jcosts = jp.optimize(opt_iters=10)

    monkeypatch.setattr(problems, "build_planar_gpmp_problem", functools.partial(
        problems.build_planar_gpmp_problem, initial_particle_means=init))
    vel, pos, costs = planar_gpmp.main(["--iters", "10", "--device", "cpu", "--method", method])
    out = capsys.readouterr().out
    assert "10 GN iterations in" in out and "final goal distances:" in out
    assert pos.shape == (6, 64, 2) and vel.shape == (6, 64, 2)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), rtol=0, atol=GN_ATOL)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jcosts), rtol=1e-4)
