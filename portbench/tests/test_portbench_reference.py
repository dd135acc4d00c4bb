"""The plain reference against the program on the CPU, in float64, where
both must agree to rounding: the scene's grid, the prior, the costs and
one iteration; and the Philox draw against its published answers."""

import numpy as np
import pytest
import torch

from portbench.problems.planar import make_scene
from portbench.reference import philox
from portbench.reference.planar import PlanarProblem, const_vel_means, precision
from portbench.tests.helpers import config, obstacles_of

F64 = torch.float64


def test_philox_known_answers():
    # Random123's known-answer vectors of philox4x32-10
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = philox.philox4x32_10(*(np.uint32(c) for c in ctr), *key)
        assert [int(w) for w in got] == list(want)


def test_fused_normals_layout():
    seed = (7 << 32) | 12345
    z = philox.fused_normals(seed, 3, 40, 64)
    assert z.shape == (3, 40, 64)
    # particle 2, tile 1 (rows 16..31), pair j = 5: rows 21 and 29, lane 9
    bits = philox.philox4x32_10(np.uint32(9), np.uint32(16 + 5), np.uint32(2), np.uint32(0),
                                12345, 7)
    a, b = philox.box_muller(bits[0], bits[1])
    assert z[2, 21, 9] == a and z[2, 29, 9] == b
    big = philox.fused_normals(seed, 15, 128, 256)
    assert abs(big.mean()) < 0.01 and abs(big.std() - 1) < 0.01


def _program_scene(obstacles, dtype=F64):
    from stoch_gpmp_tpu_torch.costs import RasterPrimitive2DField
    from stoch_gpmp_tpu_torch.envs import ObstacleCircle, ObstacleRectangle, generate_obstacle_map

    prims = [ObstacleRectangle(*o[1:]) if o[0] == "rect" else ObstacleCircle(*o[1:])
             for o in obstacles]
    om, prims = generate_obstacle_map(map_dim=(20, 20), obst_list=prims, cell_size=0.1,
                                      dtype=dtype, device="cpu")
    return om, RasterPrimitive2DField.from_map(om, prims, dtype=dtype, device="cpu")


@pytest.mark.parametrize("seed", [1, 2, 2**40 + 3])
def test_scene_grid_matches_program(seed):
    cfg = config()
    obstacles = make_scene(cfg, seed)
    kinds = [o[0] for o in obstacles]
    assert kinds.count("rect") == cfg["scene"]["num_rects"]
    assert kinds.count("circle") == cfg["scene"]["num_circles"]
    om, field = _program_scene(obstacles, torch.float32)
    ref = PlanarProblem(cfg, obstacles)
    assert np.array_equal(ref.grid.map, om.map)
    assert ref.grid.map.max() <= 1
    # every cell's centre and a cloud of points, through the program's field
    pts = torch.rand(50000, 2, dtype=F64, generator=torch.Generator().manual_seed(seed)) * 24 - 12
    pts = pts.float()
    assert torch.equal(field.compute_cost(pts).double(), ref.grid.occupancy(pts))


def test_scene_is_the_upstream_rule_on_the_seed():
    cfg = config()
    assert make_scene(cfg, 5) == make_scene(cfg, 5)
    assert make_scene(cfg, 5) != make_scene(cfg, 6)
    for o in make_scene(cfg, 5):
        assert float(np.float32(o[1])) == o[1] and -7.5 <= o[1] <= 7.5


def _program_problem(cfg, seed=0):
    from stoch_gpmp_tpu_torch.problems import build_planar_problem

    return build_planar_problem(dtype=F64, device="cpu", seed=seed)


def test_prior_matches_program():
    cfg = config()
    sampler, _, state = _program_problem(cfg)
    ref = PlanarProblem(cfg, [])
    s = cfg["sample_sigmas"]
    lam = precision(2, 64, 0.02, s["start"], s["gp"], s["goal"])
    assert torch.allclose(lam, sampler.precision_dense, rtol=1e-13, atol=1e-7)
    assert torch.allclose(ref.wt, sampler.weight_t, rtol=1e-10, atol=1e-12)
    means = const_vel_means(cfg["start"], cfg["goals"], 64, 0.02, 2).repeat_interleave(5, 0)
    assert torch.allclose(means, state.particle_means, atol=1e-12)


def test_costs_and_step_match_program():
    from stoch_gpmp_tpu_torch.envs import generate_obstacle_map
    from stoch_gpmp_tpu_torch.planners import stoch_gpmp_step

    cfg = config()
    sampler, cost, state = _program_problem(cfg)
    _, prims = generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
        rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2], rng=0,
        dtype=F64, device="cpu")
    ref = PlanarProblem(cfg, obstacles_of(prims))
    eps = torch.randn(15, 16, 256, dtype=F64, generator=torch.Generator().manual_seed(1))
    new_state, aux = stoch_gpmp_step(sampler, cost, state, {}, num_samples=16,
                                     temperature=1.0, step_size=0.5, eps=eps)
    new_mu, x, c = ref.step(state.particle_means, eps)
    assert torch.allclose(x, aux.samples, rtol=1e-12, atol=1e-12)
    assert torch.allclose(c, aux.costs, rtol=1e-10)
    assert torch.allclose(new_mu, new_state.particle_means, rtol=1e-10, atol=1e-10)
