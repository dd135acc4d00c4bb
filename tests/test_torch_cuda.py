"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (a CUDA kernel has no
CPU mode). On a machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

The checks and their tolerances are those of ``chip_smoke.py`` (see its
module constants): K1 exact; K2 per-sample costs within a relative 2e-4, at
most 1% of samples off by a multiple of k_coll (a position within float32
roundoff of an obstacle's cell edge), new means within 1e-3 where the best
sample agrees; Philox moments within (0.85, 1.15); K2, K9 and K6 in seed
mode at 1 CTA per particle against their cluster split (8 CTAs per
particle at parity and config 4): costs within 2e-4 (K6 1e-4), new means
within 1e-5. At config 5: K3 within
1e-3 and K4 within 1e-4 relative of float64 oracles; K5 costs within 1e-4 of
its plain version with the best sample agreeing, the RNG-free tiers within
3e-4 / 1e-3 of float64 oracles, Philox moments within (0.85, 1.15), its
persistent launch equal to one particle per CTA (costs to the last bit,
means within 1e-5), its dense instantiation equal to the last bit on the
prior's W and under K5's gates on a W without the zero half, and K5 under
its gates at T = 224, T = 192 and S = 16 (the dense instantiation where the
packed W does not fit); K4 and K8 through the generic FK walk on a non-Panda
chain within 1e-4 of float64 oracles, each counted as a generic launch, and
K5 and K6 through it on a tilted Panda under K5's gates; the Panda main
path's descent, start-anchor, launch-count (none through the generic walk)
and loop (at most 2 device operations per fused iteration) gates. At config 4:
K6 as K5 (every particle's best sample agreeing); K7 and K8 within 1e-4
relative of float64 oracles and K8 of K7, K7 also on
three layouts, at 9 links and at 5 (the runtime link count, counted as
generic); the four routes' descent, start-anchor, launch-count and
stack-equality (1e-4) gates. K9 as K2, with
one seed pair per particle, and its 500-iteration loop under the planar
goal (0.3) and start (0.15) gates; K1, K10 and K11 exact (also at ragged
counts, on unaligned views and cell or primitive edges; K1 and K11 with no
rectangles or circles, K10 on grids with an odd side); the reference-shaped
planar routes on the grid and the primitives under the same gates; GN
``GPMP`` at P = 192 with its goal (0.05), start (0.02) and method-agreement
(1e-4) gates. S1 within 1e-5 (float32) and 1e-12 (float64) of the float64
serial substitution relative to the largest entry, and its plain version
likewise; the long-horizon path at T = 4096 and 1024 with one S1 and one K1
launch per iteration, starts and end points within 0.05, and the kernels'
means within 1e-3 of their plain versions' where the best sample agrees;
the class API at T = 1024 and the quadratic stack's dof route there. The
Panda planning paths at reduced iteration counts: the example (IK goal
within 1e-2 and the near-best rule in float64, descent, starts within 2e-2,
final EE within 0.05 of the target, K4 once per iteration on the fast
stack), the mesh-sphere stack (descent, starts, its fields within 1e-4 of
float64), GN through FK (EE distance falling, starts within 0.05, one
float64 woodbury step within rtol 1e-7 / atol 1e-9 of cholesky) and GN at
T = 1024 (one S1 launch for the init draw, one K1 launch per
linearisation, the float64 pair under the same bounds).
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda", 0)


def test_raster_kernel_exact(dev):
    import chip_smoke

    assert chip_smoke.raster_check(dev)["max_abs_err"] == 0.0


@pytest.mark.parametrize("branch", ["matmul", "stencil"])
def test_fused_step_kernel_matches_plain(dev, branch):
    import chip_smoke

    assert chip_smoke.fused_check(dev, branch)["argmax_agree"] >= 8


@pytest.mark.parametrize("kname", ["K2", "K9", "K6"])
def test_fused_step_split_matches_one_cta(dev, kname):
    """Seed mode at 1 CTA per particle against ``ctas_per_particle``'s
    cluster split: the same draws, costs within COST_RTOL (K6
    K5_COST_RTOL), new means within SPLIT_MEAN_ATOL."""
    import chip_smoke

    r = chip_smoke.split_check(dev, kname)
    assert r["ctas"] == 8 and r["mean_max_err"] <= chip_smoke.SPLIT_MEAN_ATOL


def test_fused_step_philox_moments(dev):
    import chip_smoke

    r = chip_smoke.moments_check(dev)
    assert 0.85 < r["var_ratio_median"] < 1.15


def test_dof_quad_kernel_matches_oracle(dev):
    import chip_smoke

    assert chip_smoke.dof_quad_check(dev)["max_rel"] <= chip_smoke.K3_RTOL


def test_fk_fields_kernel_matches_oracle(dev):
    import chip_smoke

    r = chip_smoke.fk_fields_check(dev)
    assert r["max_rel"] <= chip_smoke.K4_RTOL and r["flat_rel"] <= 1e-6


@pytest.mark.parametrize("check", ["eps", "rng_free", "moments"])
def test_fused_dof_step_kernel(dev, check):
    import chip_smoke

    fn = {"eps": chip_smoke.fused_dof_check, "rng_free": chip_smoke.fused_dof_rng_free_check,
          "moments": chip_smoke.fused_dof_moments_check}[check]
    assert fn(dev)  # each check raises on failure


def test_fused_dof_step_split_and_dense(dev):
    import chip_smoke

    r = chip_smoke.fused_dof_split_check(dev)  # raises unless the costs are equal
    assert r["mean_max_err"] <= chip_smoke.SPLIT_MEAN_ATOL


def test_fused_dof_step_other_shapes(dev):
    import chip_smoke

    r = chip_smoke.fused_dof_shapes_check(dev)  # raises unless under K5's gates
    assert len(r) == len(chip_smoke.K5_SHAPES)
    assert not r["T=192,S=8"]["launch"]["triangular"]
    assert not r["T=128,S=16"]["launch"]["triangular"]


def test_fk_generic_walk_matches_oracle(dev):
    import chip_smoke

    r = chip_smoke.fk_generic_check(dev)
    assert max(r["k4_max_rel"], r["k8_max_rel"]) <= chip_smoke.K4_RTOL
    r = chip_smoke.fused_generic_walk_check(dev)  # K5 and K6 on a tilted Panda
    assert max(r["k5_cost_max_rel"], r["k6_cost_max_rel"]) <= chip_smoke.K5_COST_RTOL


def test_panda_main_path(dev):
    import chip_smoke

    r = chip_smoke.panda_main_path(dev)
    assert r["fused"]["launches"]["fused_panda_dof_step"] == chip_smoke.PANDA_ITERS - 1


@pytest.mark.parametrize("check", ["eps", "rng_free", "moments"])
def test_fused_flat_step_kernel(dev, check):
    import chip_smoke

    fn = {"eps": chip_smoke.fused_flat_check, "rng_free": chip_smoke.fused_flat_rng_free_check,
          "moments": chip_smoke.fused_flat_moments_check}[check]
    assert fn(dev)  # each check raises on failure


def test_link_fields_kernels_match_oracles(dev):
    import chip_smoke

    r = chip_smoke.link_fields_check(dev)
    assert max(r["K7"]["max_rel"], r["K7"]["config4_max_rel"], r["K8"]["max_rel"],
               r["K8"]["k7_rel"]) <= chip_smoke.K4_RTOL


def test_link_fields_kernel_layouts_and_groups(dev):
    import chip_smoke

    r = chip_smoke.link_fields_layouts_check(dev)  # raises beyond K4_RTOL
    assert r["max_rel"] <= chip_smoke.K4_RTOL
    assert r["generic_launches"] == r["generic_cases"] > 0


def test_panda4_routes(dev):
    import chip_smoke

    r = chip_smoke.panda4_main_path(dev)
    assert r["a"]["launches"]["fused_panda_step"] == chip_smoke.PANDA4_ITERS
    assert r["d"]["launches"]["link_fields"] == chip_smoke.PANDA4_ITERS
    assert max(r["stack_rel"].values()) <= chip_smoke.STACK_RTOL


@pytest.mark.parametrize("branch", ["matmul", "stencil"])
def test_fused_step_per_particle_kernel_matches_plain(dev, branch):
    import chip_smoke

    assert chip_smoke.fused_check(dev, branch, per_particle=True)["argmax_agree"] >= 8


def test_fused_step_per_particle_philox_and_loop(dev):
    import chip_smoke

    r = chip_smoke.moments_check(dev, per_particle=True)
    assert 0.85 < r["var_ratio_median"] < 1.15
    loop = chip_smoke.k9_loop(dev)
    assert loop["launches"]["fused_planar_step_per_particle"] == chip_smoke.ITERS


def test_grid_and_primitive_kernels_exact(dev):
    import chip_smoke

    r = chip_smoke.field2d_check(dev)
    assert r["K10"]["max_abs_err"] == r["K11"]["max_abs_err"] == 0.0


def test_primitive_field_kernel_edge_shapes(dev):
    import chip_smoke

    r = chip_smoke.field_shapes_check(dev, "K11")  # raises unless torch.equal
    assert r["hits"]["R = C = 0"] == 0 and r["cases"] == 11


def test_raster_kernel_edge_shapes(dev):
    import chip_smoke

    r = chip_smoke.field_shapes_check(dev, "K1")  # raises unless torch.equal
    assert r["hits"]["R = C = 0"] == 0 and r["cases"] == 12


def test_grid_kernel_edge_shapes(dev):
    import chip_smoke

    r = chip_smoke.field_shapes_check(dev, "K10")  # raises unless torch.equal
    # one cell of a value in (0, 1): every point reads it
    assert r["cases"] == 12
    assert r["hits"]["[1, 1] grid, edge points"] == chip_smoke._cell_edges(dev).shape[0]


def test_planar_reference_routes(dev):
    import chip_smoke

    r = chip_smoke.planar_ref_main(dev)
    assert r["g"]["launches"]["grid_lookup"] == chip_smoke.ITERS
    assert r["p"]["launches"]["primitive_field"] == chip_smoke.ITERS


def test_gauss_newton_main_path(dev):
    import chip_smoke

    r = chip_smoke.gn_main(dev)
    assert r["woodbury_vs_cholesky"] <= chip_smoke.GN_METHOD_ATOL
    assert r["cholesky"]["launches"]["grid_lookup"] == chip_smoke.GN_ITERS + 1


def test_bidiag_scan_kernel_matches_oracle(dev):
    import chip_smoke

    r = chip_smoke.s1_check(dev)
    assert r["worst"]["float32 s1_rel"] <= chip_smoke.S1_RTOL[torch.float32]
    assert r["worst"]["float64 s1_rel"] <= chip_smoke.S1_RTOL[torch.float64]


@pytest.mark.parametrize("t", [4096, 1024])
def test_long_horizon_main_path(dev, t):
    import chip_smoke

    r = chip_smoke.long_horizon_main(dev, t)
    assert r["launches"] == {"bidiag_scan": chip_smoke.LH_ITERS,
                             "raster_field": chip_smoke.LH_ITERS}
    assert r["goal_err"] < chip_smoke.LH_TOL


def test_long_horizon_api(dev):
    import chip_smoke

    assert chip_smoke.long_horizon_api(dev)["quad_route"] == "dof"


def test_panda_example_path(dev):
    import chip_smoke

    r = chip_smoke.panda_example(dev, iters=100)
    assert r["a"]["launches"] == {} and r["b"]["launches"] == {"fk_fields": 100}
    assert r["stack_rel"] <= chip_smoke.STACK_RTOL


def test_panda_mesh_path(dev):
    import chip_smoke

    assert chip_smoke.panda_mesh(dev, iters=100)["cost"] > 0


@pytest.mark.parametrize("path", ["panda_gn", "gn_long"])
def test_gauss_newton_panda_and_long_horizon(dev, path):
    import chip_smoke

    r = getattr(chip_smoke, path)(dev, iters=20 if path == "panda_gn" else 1)
    assert r["woodbury_vs_cholesky_64"] <= 1e-6
    if path == "gn_long":
        assert all(r[m]["k1_held"] == 2 and len(r[m]["s1_held"]) == 1
                   for m in ("cholesky", "woodbury"))
