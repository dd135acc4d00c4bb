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
means within 1e-5), its draws whitened against the float64 factor no worse
than the plain version's float32 product ``eps @ W``, and K5 under its
gates at T = 224, T = 192 and S = 16; K4 and K8 through the generic FK walk
on a non-Panda chain within 1e-4 of float64 oracles, each counted as a
generic launch, and K5 and K6 through it on a tilted Panda under K5's
gates; the Panda main path's descent, start-anchor, launch-count (none
through the generic walk) and loop (at most 2 device operations per fused iteration) gates. At config 4:
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
linearisation, the float64 pair under the same bounds). Multi-device: the
dof layout at config 5 on a (4, 1) mesh of 4 gloo ranks sharing the card
(``parallel.launch``; means within 1e-5 / 1e-5 and costs 1e-4 / 1e-4 of the
single-rank run, every K3 and K4 launch within 1e-3 / 1e-4 of float64), and
a world of one NCCL rank whose means equal the unsharded run's. The planar
example twins through their ``main()`` (planar-examples, at reduced
iteration counts): K10 once an iteration on ``--fast`` and the reference
stack, S1 and K1 once an iteration on the ``"planes"`` route at
``--traj-len 2048`` with every iteration's S1 launch by TMA, GN on both
methods; the planar and GN gates, woodbury within 1e-4 of cholesky, and
every K10, K1 and S1 launch of the held windows against its plain version.
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


def test_fused_dof_step_split(dev):
    import chip_smoke

    r = chip_smoke.fused_dof_split_check(dev)  # raises unless the costs are equal
    assert r["mean_max_err"] <= chip_smoke.SPLIT_MEAN_ATOL
    assert r["draw_whitened_sub"] <= r["draw_whitened_plain"]


def test_fused_dof_step_other_shapes(dev):
    import chip_smoke

    r = chip_smoke.fused_dof_shapes_check(dev)  # raises unless under K5's gates
    assert len(r) == len(chip_smoke.K5_SHAPES)
    assert all(v["launch"]["variant"] == 1 for v in r.values())  # the Panda's FK walk


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


def test_sharded_dof_layout_four_ranks(dev):
    """sharded-dof's (4, 1) case: 320 particles a rank (blocks that start
    inside goals), K3 and K4 launched and held in every rank."""
    import chip_smoke
    from stoch_gpmp_tpu_torch.parallel.launch import launch

    ranks = launch(chip_smoke.sharded_rank, 4, (("dof",), ((4, 1),)), device="cuda",
                   timeout=600)
    for r in ranks:
        row = r["dof"]["(4, 1)"]
        assert row["launches"] == {"dof_quad_eval": chip_smoke.SH_CHECK_ITERS,
                                   "fk_fields": chip_smoke.SH_CHECK_ITERS}
        assert row["mean_ratio"] <= 1.0 and row["cost_ratio"] <= 1.0 and row["block"] == 320


def test_nccl_world_of_one(dev):
    """nccl-1 at 2 iterations: a world of one NCCL rank gives the unsharded
    means exactly."""
    import chip_smoke
    from stoch_gpmp_tpu_torch.parallel.launch import launch

    (r,) = launch(chip_smoke.nccl_rank, 1, (2,), device="cuda", timeout=300)
    assert r["backend"] == "nccl" and r["launches"] == {"raster_field": 2}


def test_planar_example_twins(dev, monkeypatch):
    """planar-examples at 100 / 50 / 100 iterations: each run's launches and
    gates, and its held window."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "PE_ITERS", 100)
    monkeypatch.setattr(chip_smoke, "PE_LONG_ITERS", 50)
    r = chip_smoke.planar_examples(dev)
    runs = r["runs"]
    assert runs["a"]["launches"] == {"grid_lookup": 100, "block_chol": 4}
    assert runs["c"]["launches"] == {"bidiag_scan": 51, "raster_field": 50, "block_chol": 2}
    assert runs["c"]["iteration_staged"] == 0 and runs["c"]["held"] == {"K1": 5, "S1": 6}
    assert r["woodbury_vs_cholesky"] <= chip_smoke.GN_METHOD_ATOL


# --- C1: the GP prior's block Cholesky and dense L^{-1} ---------------------


@pytest.mark.parametrize("case", ["planar", "dof", "panda", "gn32", "gn64", "long"])
def test_block_chol_kernel(dev, case):
    """C1 (``ops/kernels/block_chol.py``) at the planar, per-dof and Panda
    priors' shapes with ``L^{-1}``, the long-horizon Gauss-Newton batch in
    float32 and float64 and the long-horizon prior: ``chip_smoke.c1_check``'s
    gates (within C1_RTOL32, C1_RTOL32_LONG or C1_RTOL64 of the float64 loop
    and, in float32, no further than the loops; exact zeros above the
    diagonal of ``L^{-1}``; NaN from a block that is not positive definite
    on; one launch a call), held here again; one line of readings per
    system. At the planar and Panda shapes, ``make_gp_prior`` takes two
    launches (the prior and its per-dof factor, each with ``L^{-1}``)."""
    import json

    import chip_smoke
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
    from stoch_gpmp_tpu_torch.ops.kernels.block_chol import block_chol

    t, dtype = chip_smoke.C1_CASES[case][1], chip_smoke.C1_CASES[case][3]
    rtol = (chip_smoke.C1_RTOL64 if dtype == torch.float64
            else chip_smoke.C1_RTOL32_LONG if t > 1024 else chip_smoke.C1_RTOL32)
    for row in chip_smoke.c1_check(dev, case):
        print(json.dumps(row), flush=True)
        for mine in ("factor", "inverse"):
            if mine in row:
                assert row[mine] <= rtol
                assert dtype == torch.float64 or row[mine] <= row[f"loop_{mine}"]
    if case in ("planar", "panda"):
        n, dof = block_chol.launches, chip_smoke.C1_CASES[case][0] // 2
        prior = make_gp_prior(dof, 64, 0.02, [0.0] * (2 * dof), 1e-3, 3.0, sigma_goal=1e-3,
                              goal_states=[[1.0] * (2 * dof)], device=dev)
        assert block_chol.launches - n == 2 == chip_smoke.c1_per_prior(64)
        assert prior.weight_t is not None and prior.dof is not None
