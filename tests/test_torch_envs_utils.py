"""The ``ObstacleMap`` methods and the ``utils`` modules of the PyTorch port
against the JAX package's: the same map, obstacles and points (numpy from a
seed), exact equality where both packages run the same host code or look up
the same cells (float32 points, float32 grids, as the JAX package's map
keeps them); a checkpoint round trip that resumes the draw stream; a
``trace`` that writes its file; the path helpers."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _maps():
    """The same seeded map from both packages and 500 points over it (a
    third on cell edges)."""
    from stoch_gpmp_tpu.envs import generate_obstacle_map as jgen
    from stoch_gpmp_tpu_torch.envs import generate_obstacle_map as tgen

    kw = dict(map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=10,
              rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2],
              rand_circle_radius=1.0, rng=3)
    jm, jl = jgen(**kw)
    tm, tl = tgen(**kw, device="cpu")
    rng = np.random.default_rng(0)
    pts = rng.uniform(-11, 11, (500, 2))
    pts[::3] = np.round(pts[::3] * 10) / 10
    return jm, jl, tm, tl, pts.astype(np.float32)


def test_obstacle_map_cost_and_collisions_match_jax():
    """``get_collisions``, ``compute_cost`` and ``__call__`` (through
    ``as_field()``: K10's plain version on the CPU) equal JAX's on the same
    points; ``get_xy_grid`` equals JAX's grid."""
    jm, _, tm, _, pts = _maps()
    want = np.asarray(jm.compute_cost(jnp.asarray(pts)))
    assert want.max() > 0  # some points hit an obstacle
    for fn in (tm.get_collisions, tm.compute_cost, tm):
        np.testing.assert_array_equal(fn(pts).numpy(), want)
    np.testing.assert_array_equal(tm.get_xy_grid().numpy(), np.asarray(jm.get_xy_grid()))


def test_obstacle_checks_match_jax():
    """``Obstacle.point_collision_check`` on cell points inside and outside
    each obstacle, and ``ObstacleCircle.is_inside``, as JAX's."""
    jm, jl, tm, tl, _ = _maps()
    rng = np.random.default_rng(1)
    cells = rng.integers(0, 200, (40, 2)).astype(float)
    for jo, to in zip(jl, tl):
        centre = np.array([[to.center_y / 0.1 + tm.origin_yi, to.center_x / 0.1 + tm.origin_xi]])
        for pts in (None, cells, centre, np.concatenate([cells, centre])):
            assert to.point_collision_check(tm, pts) == jo.point_collision_check(jm, pts)
        if hasattr(jo, "is_inside"):
            for p in rng.uniform(-9, 9, (20, 2)):
                assert to.is_inside(p) == jo.is_inside(p)
    assert not tl[0].point_collision_check(
        tm, np.array([[tl[0].center_y / 0.1 + tm.origin_yi, tl[0].center_x / 0.1 + tm.origin_xi]]))


def test_obstacle_map_plot(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    _, _, tm, _, _ = _maps()
    fig = tm.plot(save_dir=str(tmp_path), filename="m.png")
    assert (tmp_path / "m.png").stat().st_size > 0 and fig is not None


@pytest.mark.parametrize("kind", ["stochgpmp", "gpmp"])
def test_checkpoint_round_trip_resumes_the_stream(tmp_path, kind):
    """``save_planner_state`` / ``load_planner_state``: the loaded state
    has the saved means, and a planner resumed from it takes the same next
    iterations (the generator's state comes back with it)."""
    from stoch_gpmp_tpu_torch.planners import gpmp_optimize, stoch_gpmp_optimize
    from stoch_gpmp_tpu_torch.problems import build_planar_gpmp_problem, build_planar_problem
    from stoch_gpmp_tpu_torch.utils import load_planner_state, save_planner_state

    if kind == "stochgpmp":
        sampler, cost, state = build_planar_problem(traj_len=16, ppg=2, device="cpu")
        step = lambda st: stoch_gpmp_optimize(  # noqa: E731
            sampler, cost, st, {}, opt_iters=2, num_samples=8, temperature=1.0,
            step_size=0.5)[0]
    else:
        planner = build_planar_gpmp_problem(2, traj_len=16, device="cpu")
        cost, state = planner.cost, planner.state
        step = lambda st: gpmp_optimize(cost, st, {}, opt_iters=2, delta=1e-2,  # noqa: E731
                                        trust_region=False, step_size=0.3)
    state = step(state)
    path = str(tmp_path / "state.pt")
    save_planner_state(path, state)
    fresh = type(state)(particle_means=torch.zeros_like(state.particle_means),
                        generator=torch.Generator().manual_seed(123))
    loaded = load_planner_state(path, fresh)
    assert torch.equal(loaded.particle_means, state.particle_means)
    assert torch.equal(step(loaded).particle_means, step(state).particle_means)


def test_trace_writes_its_file(tmp_path):
    """``trace(log_dir)`` writes a Chrome trace holding the ``annotate``
    region."""
    from stoch_gpmp_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path)):
        with annotate("planner-step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    text = (tmp_path / "trace.json").read_text()
    assert "planner-step" in text


def test_paths_match_jax():
    from stoch_gpmp_tpu.utils import get_assets_path as ja, get_root_path as jr
    from stoch_gpmp_tpu_torch.utils import get_assets_path, get_root_path

    assert get_root_path() == jr() == ROOT
    assert get_assets_path() == ja()
