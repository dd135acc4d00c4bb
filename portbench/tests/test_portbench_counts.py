"""The counts and the window arithmetic."""

import pytest

from portbench.counts import peaks, planar
from portbench.reference.planar import PlanarProblem
from portbench.tests.helpers import config


def test_structural_zeros_as_the_reference_builds_them():
    cfg = config()
    ref = PlanarProblem(cfg, [])
    assert int((ref.wt != 0).sum()) == planar.w_nnz(cfg) == 16512
    # the sampling precision: 3T - 2 blocks of 2 x 2 per degree of freedom
    assert int((ref.lam_sample != 0).sum()) == 2 * 4 * (3 * 64 - 2)


def test_iteration_counts_by_hand():
    cfg = config()
    work = planar.iteration(cfg, n_rects=8, n_circles=7)
    rows = 15 * 128
    sampling = rows * (2 * 16512 + 256)  # 63,897,600
    smooth = rows * (63 * (4 + 4 + 16 + 8) + 2 * 12)  # 3,916,800
    collision = rows * 63 * (4 + 6 * 7)  # 5,564,160
    importance = 15 * 2 * 1520 + rows * 512  # 1,028,640
    update = rows * 4 + 15 * (3 * 128 * 256 + 512)  # 1,489,920
    assert work["flops"] == sampling + smooth + collision + importance + update == 75_897_120
    assert work["bytes"] == 4 * (2 * 15 * 256 + 16512 + rows + 4 * 8 + 3 * 7) == 104_660
    assert peaks.least_seconds(work["flops"], work["bytes"]) == pytest.approx(1.13279e-6, rel=1e-5)


def test_rate_and_tail_take_every_request_and_the_whole_window():
    from portbench.harness import load_module

    lat = [0.010] * 95 + [0.050] * 4 + [1.0]
    window = {"latencies": lat, "updates": 7500 * len(lat), "seconds": 12.5}
    ctx = {"window": window}
    assert load_module("metrics", "updates_per_s").read(ctx) == 7500 * 100 / 12.5
    # rank 95.05 of 100: between the 95th (10 ms) and 96th (50 ms) values
    assert load_module("metrics", "request_ms_p95").read(ctx) == pytest.approx(12.0)
    window["latencies"] = lat[:-1] + [2.0]
    assert load_module("metrics", "request_ms_p95").read(ctx) == pytest.approx(12.0)
    window["latencies"] = [0.050] * 10 + [0.010] * 90
    assert load_module("metrics", "request_ms_p95").read(ctx) == pytest.approx(50.0)


def test_trace_reduction():
    from portbench.harness import union

    assert union([(5, 7), (0, 2), (1, 3), (6, 9)]) == [[0, 3], [5, 9]]
    # 10 iterations traced with 0.25 s busy; the untraced window ran 40
    # iterations of 15 particles in 4 s: 25 ms busy of each 100 ms
    ctx = {"trace": {"ops": [("k", 0.0, 1.0)] * 30, "iters": 10, "busy_s": 0.25,
                     "window_s": 2.0},
           "window": {"updates": 40 * 15, "seconds": 4.0},
           "problem": type("P", (), {"num_particles": 15})}
    from portbench.harness import load_module

    assert load_module("metrics", "launches_per_iter").read(ctx) == 3.0
    assert load_module("metrics", "device_idle").read(ctx) == pytest.approx(75.0)
    ctx["trace"] = None
    assert load_module("metrics", "device_idle").read(ctx) is None


def test_no_fused_kernel_no_roofline():
    from portbench.harness import load_module

    ctx = {"trace": {"ops": [("gemm", 0.0, 3.0)], "iters": 1}, "cfg": config(),
           "plan": object()}
    assert load_module("metrics", "k2_roofline").read(ctx) is None
