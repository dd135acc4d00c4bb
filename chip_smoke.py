"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--log-dir DIR]

Phases, one line each; any failure exits non-zero before the result line:

1. the device: its name, ``nvidia-smi``'s name and power limit, and the
   float32 matmul settings (TF32 must be off);
2. build every CUDA kernel from ``stoch_gpmp_tpu_torch/csrc`` (one nvcc per
   source, all started together) and print each one's ptxas registers and
   spills;
3. K1, the raster collision field, against its plain PyTorch version at the
   planner's shape (a strided ``[1920, 63, 2]`` slice) plus cell-edge and
   off-map points: exact equality; then K1-shapes: K1 equal to its plain
   version on K10-shapes' point sets (below), with no rectangles, no
   circles or neither, and on circles whose rims pass through snapped cells
   (at the rim and one float inside and outside it) and of radius 0, -0,
   -1, the smallest float, inf and NaN;
4. K2, the fused planar iteration (each particle a thread-block cluster of
   CTAs that split its samples, ``Sigma^{-1} mu`` computed in the kernel),
   with an eps operand against its plain version at the parity shape, matmul
   branch (parity) and stencil branch (goal anchor sigma 1e-5); its launch
   (CTAs per particle, CTAs launched, clusters resident at once, the bound on
   the SMs it fills) and seed mode at 1 CTA per particle against the split;
5. K2 with in-kernel Philox draws: the update's moments with uniform weights;
6. the planar main path: ``StochGPMP(fused_kernel=True)`` on the parity
   problem for 500 iterations, with launch counts, goal reaching and
   updates/s of the kernel loop beside the same loop with the plain K2 on
   the card, and the device's busy share and device operations per
   iteration (at most 2) over a window of the kernel loop;
7. K3, the dof-plane stencil energy, against a float64 plain oracle at
   config-5 shapes (``[7, 10240, 256]``), with and without the fused
   importance term;
8. K4, FK + link fields, against a float64 plain oracle at config-5 shapes,
   with planner-regime rows, rows drawn across the joint limits and spheres
   placed on links, through the FK walk specialised for the Panda; the
   flat-stride entry against the plane entry; then K4 and K8 through the
   generic FK walk on a chain with an x-axis and a prismatic joint
   (``generic_chain``) against float64 oracles, each counted as a generic
   launch (``.generic_launches``), and K5 and K6 through it on a tilted
   Panda;
9. K5, the fused dof Panda iteration (persistent CTAs, ``Sigma^{-1} mu``
   in the kernel, ``W_dof``'s zero half skipped): eps operand against its
   plain version at config 5 with its launch; seed mode at the persistent
   launch against one particle per CTA (equal to the last bit); the dense
   instantiation on the prior's W (equal to the last bit) and on a W
   without the zero half (against the plain version); at the other shapes
   of ``K5_SHAPES`` (T = 224, 192; S = 16) against the plain version; the
   RNG-free tier (``W = 0``) against float64 oracles, and the Philox
   moments;
10. the Panda main path: ``build_panda_problem`` at config 5 through
    ``StochGPMP(fused_kernel=True)`` and ``StochGPMP`` on the dof path, 200
    iterations each, with descent, start-anchor and launch-count gates (no
    launch through the generic FK walk; at most 2 device operations per
    fused iteration) and updates/s, wall and
    device ms and device operations per iteration and the busy share;
11. K6, the fused flat Panda iteration at config 4 (cluster-split as K2):
    eps operand against its plain version, its launch and seed mode at 1
    CTA per particle against the split, the RNG-free tiers (``W = 0``)
    against float64 oracles, and the Philox moments;
12. K7, the link fields at link positions, and K8, FK + link fields per
    configuration, against float64 oracles at 1.30 M points (config 5's
    planner-regime and joint-range rows, spheres on links), K7 also at
    config 4's strided ``[160, 63, 9, 3]`` view, and K8 per point against
    K7 on ``chain.fk_compact`` positions of the same joint angles; then
    K7-layouts: K7 against the float64 oracle on config 4's rows, for
    ``fk_compact`` positions contiguous and sliced ``[:, 1:]`` and ``fk``'s
    homogeneous poses sliced ``[..., :3, -1]``, at 9 links (unrolled) and 5 (the runtime link count,
    each a generic launch), with spheres, without and with ``w_self = 0``;
13. the Panda parity main path, config 4 (1 goal x 5 particles, 32 samples,
    T = 64), ``PANDA4_ITERS`` iterations on each route: (a) the fused K6 loop
    (``make_fused_panda_step`` + ``fused_panda_optimize``), and through
    ``StochGPMP`` (b) the fast stack ``QuadraticCost + PlaneFieldsCost``
    (K4), (c) the reference-shaped stack on ``fk=chain.fk_compact`` and (d)
    the same with ``FusedLinkFieldsCost`` (K7); descent, start-anchor,
    launch-count (none through the generic FK walk or K7's runtime link
    count) and stack-equality gates, updates/s, wall and device ms and
    device operations per iteration (at most 2 on route (a)), the busy share
    and the largest kernels;
14. K9, the planar iteration with one seed pair per particle
    (``make_fused_planar_step``): eps operand against its plain version at
    the parity shape on both quadratic branches under K2's gates, its launch
    and split check as K2's, the Philox moments with per-particle seeds, and
    ``fused_planar_optimize`` for 500 iterations at parity with the main
    path's goal and start gates (at most 2 device operations per iteration);
15. K10, the occupancy-grid lookup, and K11, the analytic primitive field,
    against their plain versions with exact equality at the planner's
    strided ``[1920, 63, 2]`` slice plus off-map, cell-edge and
    primitive-boundary points (K10 also on a random 200 x 200 grid), timed
    at that shape and at 1.31 M points; then K10-shapes: K10 equal to its
    plain version at point counts that are no multiple of a thread's
    points, on views whose coordinates are not aligned pairs (odd strides,
    coordinate stride 2), on cell edges and off-map points, at 1.31 M points
    with those inside, and on grids of [37, 200], [200, 37] and [1, 1]
    cells; and K11-shapes: K11 equal to its plain version with no
    rectangles, no circles or neither, and on the same point sets with the
    primitives' corners and rims for edge points;
16. planar-ref-main: ``StochGPMP`` on the reference-shaped planar stack
    (``CostGP + CostGoalPrior + CostCollision(field)``) at parity, 500
    iterations on two routes, (g) the occupancy grid (K10) and (p) the
    primitives (K11), with the main path's gates and launch counts;
17. gn-main: Gauss-Newton ``GPMP`` on ``build_planar_gpmp_problem(96)``
    (P = 192, T = 64), 100 iterations with ``cholesky`` and with
    ``woodbury`` from the same initial means, and 3 iterations of
    ``inverse`` against ``cholesky``; finite means, goal and start gates,
    the methods' agreement and K10's launches per iteration, with
    particle-updates/s, wall and device ms per iteration, the busy share
    and the largest kernels;
18. S1, the block-bidiagonal plane solve of the long-horizon sampler,
    against the float64 serial substitution on the same factor and against
    its plain version (the log-step scan) on the card, forward and
    backward, float32 and float64, on planes ``[d, 480, T]`` (d = 4 at T =
    1, 2, 77, 1024, 4096; d = 2 and 6, the runtime-d instantiation, at T =
    77), ``[4, 482, 77]``, ``[4, 482, 1056]`` and ``[14, 15, 150]``, and on
    ``[15, 32, T, 4]`` batches through ``solve_LT`` (stride-d planes, T = 77
    and 4096); each launch's load path (the planes by TMA where the time
    stride is 1 and a row is whole 128-byte lines: T = 1024, 1056 and 4096,
    the main path's solve; staged by the kernel's threads, counted in
    ``bidiag_scan.staged_launches``, at T = 1, 2, 77 and for the stride-d
    batches); its times at ``[4, 480, 4096]`` beside the plain version, the
    bound and ``torch.linalg.solve_triangular`` against the dense ``L^T``
    (the library call), and the largest entry of its chunk tables;
19. long-horizon-main: ``build_long_horizon_problem`` (1 goal x 15
    particles, 32 samples, the raster field) at T = 4096 and 1024 through
    ``stoch_gpmp_optimize`` on the ``"planes"`` route, 200 iterations after
    a warm-up, with launch (S1 and K1 once per iteration, every S1 launch
    by TMA), finite, start
    and goal gates, updates/s, wall and device ms, device operations per
    iteration, the busy share and the largest kernels; then 5 iterations
    with the same draws through the kernels and through their plain
    versions on the card: K1 equal to its plain version on each point set
    the path gives it, costs, every particle's best sample and the means;
20. long-horizon-api: at T = 1024, ``StochGPMP`` ``reset``, ``optimize``
    (with and without ``collect_metrics``) and ``sample_trajectories``,
    ``GPMP.sample_trajectories``, and the quadratic stack on the
    long-horizon sampler taking the ``"dof"`` route (K3);
21. panda-example: ``examples/panda_environment.py`` at its own sizes. The
    IK goal (``solve_ik_multistart``, 16 starts plus ``q_init``, 150
    iterations; timed, its SE(3) distance to the target gated and its
    choice held to the near-best rule in float64 on the same 17
    solutions), 5 spheres from ``random_init_static_sphere``, then
    ``StochGPMP`` (1 goal x 5 particles, 32 samples, T = 64) for 400
    iterations in chunks of 50 on (a) the reference-shaped stack and (b)
    the fast stack (K4 once per iteration): descent, starts, the final EE
    within 0.05 of the target, updates/s, device ms and operations per
    iteration and the busy share;
22. panda-mesh: ``benchmarks/success_rate_panda.py``'s stack (the
    mesh-sphere obstacle and floor fields, obstacles spawned clear of the
    arm's mesh surface and inflated by 0.05), 1 goal x 4 particles, T = 32,
    300 iterations: descent, starts, both fields on the path's own link
    poses against float64 on the CPU, the share of "clean" particles;
23. panda-gn: Gauss-Newton ``GPMP`` through FK on the Panda (``CostGP +
    CostCollision(LinkDistanceField) + CostGoal(EESE3DistanceField)``, T =
    64, 5 particles), 50 iterations each of ``cholesky`` and ``woodbury`` in
    float64: EE distance falling, starts, one woodbury step against one
    cholesky step (rtol 1e-7, atol 1e-9); the same iterations in float32 as
    a probe (the first non-finite iteration, not gated);
24. gn-long: Gauss-Newton past M = 2048 (``benchmarks/long_horizon.py
    gn_bench``'s problem at T = 1024, 15 particles, delta 10), 3
    iterations each of ``cholesky`` and ``woodbury`` with S1 (the init
    draw) and K1 (each linearisation) counted, their times and device
    operations per iteration, and the float64 pair of one step each.

Times: ``ms``/``plain_ms`` are per call over back-to-back calls through
the wrapper (CUDA events), which includes the host's launch cost where it
exceeds the device's; the device time per call comes from
``torch.profiler`` and, for K1, K10 and K11, also from CUDA events around
calls queued behind a sleeping kernel (the profiler can lose a kernel's
records). ``bound_ms`` is the least time the card could take for
the same work: the larger of the bytes each function must move over 3.35
TB/s and its FP32 operations over 67 TFLOP/s (the H100 SXM data sheet),
counted from this run's shapes. The line before the last is the kernels'
JSON record; the last line is ``{"ok": true, "device": {...}}``.
``--log-dir`` also writes the nvcc logs and the per-phase details there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

T, PPG, S, TAU, STEP = 64, 5, 128, 1.0, 0.5
ITERS = 500
K_COLL = 1e10
# K2 against its plain version on the card (float32 both, summed in another
# order): a sample's cost agrees within COST_RTOL of the plain cost. The
# quadratic carries 1.5e8 weights on |x| ~ 10 and cancels, so float32
# roundoff is ~1e5 on costs of 1e9..1e11. A sample may instead differ by a
# multiple of k_coll when one of its 63 positions sits within float32
# roundoff of an obstacle's cell edge; at most EDGE_SHARE of the samples may.
# New means are compared only for particles whose best sample (argmax
# weight) agrees: at temperature 1 the weights are one-hot, so a flipped
# argmax moves a mean by a whole step.
COST_RTOL = 2e-4
EDGE_SHARE = 0.01
MEAN_ATOL = 1e-3
MIN_ARGMAX_AGREE = 0.5
# The main path's gates: end points within 0.3 of their goals, as the JAX
# package's own fused-kernel test requires (tests/test_fused_step_tpu.py),
# and the start within 0.15 of its anchor. The start drifts under the
# sampler's 1e-3 start sigma: the JAX package's flat path moves it 0.084 and
# 0.090 over the same 500 iterations on the CPU (seeds 0 and 1).
GOAL_TOL, START_TOL = 0.3, 0.15

# The Panda slice at benchmarks/run.py config 5: 10 goals x 128 particles,
# 8 samples, T = 128, 7 DOF, 5 spheres.
PANDA = dict(num_goals=10, ppg=128, traj_len=128, num_samples=8)
PANDA_ITERS = 200
PANDA_TAU, PANDA_STEP = 1.0, 0.1
# K3 per-row energy against a float64 plain oracle on the same float32
# inputs: rtol 1e-3, the JAX package's gate for its own kernel on the chip
# (tests/test_fused_panda_dof_tpu.py). Importance term with tau = 0.25 as there.
K3_RTOL, K3_TAU = 1e-3, 0.25
# K4 per-trajectory field sums against a float64 plain oracle: the kernel
# walks the chain generically where the plain FK folds constants, so link
# positions differ by float32 roundoff (~1e-7 m); an RBF term moves by about
# 2 d |delta d| / (2 margin^2) ~ 1e-5 of itself.
K4_RTOL = 1e-4
# K5, eps operand, against its plain version (float32 both): per-sample costs
# within K5_COST_RTOL; the best sample agrees for at least MIN_ARGMAX_AGREE
# of the particles, and there the new means within K5_MEAN_ATOL (the weights
# are near one-hot at temperature 1, so a flipped argmax moves a mean by a
# whole step). RNG-free tier (W = 0) as the JAX package's TPU test: fields +
# goal + importance within 3e-4 of the float64 oracle, the full stack within
# 1e-3, means unchanged within 1e-5.
K5_COST_RTOL, K5_MEAN_ATOL = 1e-4, 1e-3
K5_TIER1_RTOL, K5_TIER2_RTOL, K5_STILL_ATOL = 3e-4, 1e-3, 1e-5
# Panda main-path gates, from the JAX package's TPU-only tests
# (tests/test_fused_panda_dof_tpu.py:178-273): the mean cost falls on both
# paths, the fused descent is more than half the dof path's, and every
# particle's t = 0 position stays within 2e-2 of the start.
PANDA_DESCENT_SHARE, PANDA_START_TOL = 0.5, 2e-2
# The Panda parity workload, benchmarks/run.py config 4: 1 goal x 5
# particles, 32 samples, T = 64, the same spheres; its gates are config 5's
# (the JAX package's tests/test_fused_panda_tpu.py:97-160), K6's tolerances
# K5's. On the same means the reference-shaped stacks (c) and (d) equal the
# fast stack (b) within STACK_RTOL: they are the same function, summed in
# another order in float32 (tests/test_fused_fields.py:94-120).
PANDA4 = dict(num_goals=1, ppg=5, traj_len=64, num_samples=32)
PANDA4_ITERS = 500
STACK_RTOL = 1e-4
# The fields K10/K11 are timed at the planner's shape and at BIG_POINTS
# (20480 x 64) points.
BIG_POINTS = 20480 * 64
# K7-layouts: K7 on every layout against the float64 oracle under K4_RTOL.
# An obstacle term of a far link underflows float32 (exp(-112) at 1.5 m
# from a 0.1 m sphere) where float64 keeps it, so a value below
# float32's smallest normal number times the largest weight counts as
# absolute: K7_FLOOR.
K7_FLOOR = torch.finfo(torch.float32).tiny
# Gauss-Newton GPMP on examples/planar_gpmp.py at the GN parity scale of
# docs/PERFORMANCE.md: 2 goals x 96 particles, T = 64, 100 iterations. Gates:
# end points within GN_GOAL_TOL of the goals (the example prints ~1e-2; the
# JAX package in float32 on the CPU ends 0.0036 from them, start 0.0028),
# starts within GN_START_TOL, and cholesky and woodbury means within
# GN_METHOD_ATOL of each other after GN_ITERS: the JAX package in float32 on
# the CPU, same configuration and initial means, puts them 2.9e-6 apart on
# means of up to 9; the card sums in other orders, so the gate is ~35x that.
# After 3 iterations the float32 solves of the ill-conditioned system (delta
# 1e-2 against weights of 1e4..4e5) still disagree: inverse and cholesky
# 0.016 apart in the JAX package (0.021 in the port), so that gate,
# GN_INVERSE3_ATOL, is ~3x the JAX package's. Measured by
# `python tests/test_torch_gpmp.py`.
GN_PPG, GN_ITERS = 96, 100
GN_GOAL_TOL, GN_START_TOL, GN_METHOD_ATOL, GN_INVERSE3_ATOL = 0.05, 0.02, 1e-4, 0.05
# K2, K9 and K6 with 1 CTA per particle against their split launch (same
# draws): the cluster sums the mean update in another order, float32
# roundoff on means of up to ~10.
SPLIT_MEAN_ATOL = 1e-5
# K5 away from config 5 (T, S), 2 goals x 32 particles each, under K5's
# gates: T = 224 (one K part per window, a last block of 2 warps) and T =
# 192 (the packed W does not fit: the dense instantiation), and S = 16 at T =
# 128 (two passes of 56 rows: the dense instantiation).
K5_SHAPES = ((224, 8), (192, 8), (128, 16))
# The fused loops (main, K9-loop, panda4-main (a)) launch one kernel per
# iteration; the seeds' draw adds one or two operations per window.
MAX_LOOP_OPS = 2
# S1, the plane solve, against the float64 serial substitution
# (BlockBidiagChol.solve_L / solve_LT) on the same factor (a float32 factor
# promoted): relative to the largest |y| of the case. float32 roundoff
# through T steps of the recurrence puts the plain scan and S1's chunked
# order ~1e-6 from it on the CPU at T = 4096
# (tests/test_torch_long_horizon.py's emulation of S1); the card's gate is
# 10x that. S1 and its plain version within the sum of their gates.
S1_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# (d, rows, T) of the S1 phase: the main path's 480 rows (15 particles x 32
# samples) and a batch that fills no CTA at d = 4 (staged at T = 77; by TMA
# at T = 1056, whose last time segment is partial), the Panda's d = 14 (the
# two block sizes compiled in), d = 2 and 6 through the runtime-d
# instantiation, and the [15, 32, T, 4] batches solve_LT reads as stride-d
# planes
S1_SHAPES = ((4, 480, 1), (4, 480, 2), (4, 480, 77), (4, 480, 1024), (4, 480, 4096),
             (4, 482, 77), (4, 482, 1056), (14, 15, 150), (2, 480, 77), (6, 480, 77))
S1_STRIDED = (77, 4096)
# the main path's solve: d, rows (15 x 32), T
S1_MAIN = (4, 480, 4096)
# The long-horizon main path (benchmarks/long_horizon.py): 1 goal x 15
# particles, 32 samples, T = 4096 and 1024, LH_ITERS iterations after
# LH_WARMUP. Gates: finite means, starts and end points within LH_TOL of the
# start and the goal (the JAX package's own long-horizon test,
# tests/test_planner_planar.py test_long_horizon_plane_mode_plans). Then
# LH_CHECK_ITERS iterations with the same injected draws through the card's
# kernels and through their plain versions on the card. Every K1 launch of
# the kernel run is held against the plain version on the same points, the
# path's two coordinate planes read in place (torch.equal). Costs: a
# sample's cost within COST_RTOL of the plain run's, or (at most EDGE_SHARE
# of the samples) apart by a multiple of the collision weight where S1's
# roundoff moves a position across a cell edge (one sample of 2,400 in an
# emulation on the CPU at T = 512, the solve in float64 against float32:
# the rest within 1.1e-7 at the 99th percentile). Every particle's best
# sample agrees in every iteration (all 15 did in this path's first runs on
# the card), and the means within MEAN_ATOL.
LH_HORIZONS, LH_ITERS, LH_WARMUP, LH_CHECK_ITERS, LH_TOL = (4096, 1024), 200, 5, 5, 0.05
# long-horizon-api: the class API at T = LH_API_T, LH_API_ITERS iterations
# per optimize() call
LH_API_T, LH_API_ITERS = 1024, 20
# panda-example: examples/panda_environment.py end to end at its own sizes
# (IK goal from 16 starts + q_init, 150 iterations; 5 spheres; 1 goal x 5
# particles, 32 samples, T = 64; PX_ITERS iterations in chunks of
# PX_CHUNK), on (a) the reference-shaped stack and (b) the fast stack (K4).
# Gates: the IK goal's SE(3) distance to the target under IK_TOL (the JAX
# package's IK test holds a single solve to 1e-3 in position and 1e-2 in
# rotation, tests/test_kinematics.py), the chosen solution within the
# near-best rule recomputed in float64 (its distance within 0.05 of the
# best, plus RULE_SLACK for the float32 solve, and no other such solution
# closer to q_init by more than RULE_SLACK), the mean cost falling, starts
# within PANDA_START_TOL, and every particle's final EE within PX_EE_TOL of
# the target (the figure the JAX example prints).
PX_ITERS, PX_CHUNK, IK_TOL, RULE_SLACK, PX_EE_TOL = 400, 50, 1e-2, 1e-4, 0.05
# panda-mesh: benchmarks/success_rate_panda.py's stack (mesh-sphere obstacle
# and floor fields) at its defaults, 1 goal x 4 particles, 32 samples, T =
# 32, PM_ITERS iterations. The card's float32 mesh and floor field values
# on the path's own link poses against the same fields in float64 on the
# CPU: within PM_RTOL of the float64 value, or PM_ATOL absolute (terms that
# float32 rounds near zero).
PM_ITERS, PM_RTOL, PM_ATOL = 300, 1e-4, 1e-9
# panda-gn: GPMP through FK (tests/test_gpmp.py's Panda stack) at the
# example's T = 64, 5 particles, PG_ITERS iterations of cholesky and of
# woodbury, in float64 as the JAX package's own tests run this stack: in
# float32 the card's batched Cholesky has met a block that was not positive
# definite, so float32 runs as a probe only, beside gn_float32_witness's
# reading of how far the float32 system's last Schur complement is from
# indefinite, in float32 units of its block (no goal anchor: the last
# blocks hold ~1e7 GP weights against delta 1e-2 and the EE goal's term).
# Gates: the final EE's SE(3) distance falls, starts within PG_START_TOL
# (the JAX test's bound), and one woodbury step equals one cholesky step
# within GN64_RTOL / GN64_ATOL (the JAX package's own bounds,
# tests/test_gpmp.py:181-184).
PG_ITERS, PG_START_TOL, GN64_RTOL, GN64_ATOL = 50, 0.05, 1e-7, 1e-9
# gn-long: benchmarks/long_horizon.py gn_bench's problem at T = GNL_T, 15
# particles, delta 10: GNL_ITERS iterations of cholesky and of woodbury,
# finite, starts within PG_START_TOL, the init draw's S1 launch (stride-4
# planes) held against its plain version and the float64 recurrence under
# S1_RTOL and every K1 launch equal to its plain version; an un-held
# window of one iteration for the times; in float64, one woodbury
# step against one cholesky step under GN64_RTOL / GN64_ATOL. K1 takes
# float32 only, so the float64 pair runs the stack without the raster field
# (whose GN Jacobian is zero: the step is the same function).
GNL_T, GNL_ITERS = 1024, 3
# Peak rates of one H100 SXM (data sheet) for the bound_ms column.
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12
FP32_FLOP_PER_SM = FP32_FLOP_PER_S / 132


def fail(msg: str) -> None:
    """A failed check: the uncaught error ends the run with a non-zero code."""
    raise RuntimeError(msg)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Time per call of ``fn()`` over ``reps`` back-to-back calls, CUDA
    events: the device's time, or the host's where launching is slower."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float | None:
    """Device time per call of ``fn()`` over ``reps`` calls under
    ``torch.profiler``: the summed time of the device's kernels and copies
    (device activity only, so no time is counted twice). None when the
    profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages())
    return busy_us / 1e3 / reps if busy_us > 0 else None


def queued_ms(fn) -> float | None:
    """Device time per call of ``fn()`` by CUDA events around 200 calls
    queued behind a sleeping kernel (``tools/fused_timing.py queued_ms``):
    the cross-check of :func:`device_ms`, whose profiler can lose a kernel's
    records. None when the host did not keep ahead of the device."""
    from stoch_gpmp_tpu_torch.tools.fused_timing import queued_ms as queued

    ms, held = queued(fn)
    return ms if held else None


def device_breakdown(fn, reps: int, top: int = 8) -> tuple[float | None, list, float]:
    """Like :func:`device_ms`, plus the ``top`` device kernels by time and
    the number of device operations (kernels and copies) per call:
    ``(total ms per call or None, [(name, ms per call), ...], ops per call)``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    rows = [(e.key, e.self_device_time_total / 1e3 / reps) for e in events]
    busy = sum(ms for _, ms in rows)
    rows = sorted(rows, key=lambda r: -r[1])[:top]
    ops = sum(e.count for e in events) / reps
    return (busy if busy > 0 else None), [(name[:48], ms) for name, ms in rows], ops


def kernel_counters() -> dict:
    """Every kernel wrapper of the port by its JSON name; each counts its
    launches in ``.launches``."""
    from stoch_gpmp_tpu_torch.ops.kernels.fields import (
        grid_lookup,
        primitive_field_cost,
        raster_primitive_cost,
    )
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (
        fused_planar_step,
        fused_planar_step_per_particle,
    )
    from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (
        fk_link_fields_cost,
        fk_link_fields_cost_rows,
        fused_link_fields_cost,
    )
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step import fused_panda_step
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import fused_panda_dof_step
    from stoch_gpmp_tpu_torch.ops.kernels.stencil import dof_quad_eval
    from stoch_gpmp_tpu_torch.ops.kernels.bidiag_scan import bidiag_scan

    return {"bidiag_scan": bidiag_scan, "raster_field": raster_primitive_cost, "fused_planar_step": fused_planar_step,
            "dof_quad_eval": dof_quad_eval, "fk_fields": fk_link_fields_cost_rows,
            "fused_panda_dof_step": fused_panda_dof_step, "fused_panda_step": fused_panda_step,
            "link_fields": fused_link_fields_cost, "fk_fields_points": fk_link_fields_cost,
            "fused_planar_step_per_particle": fused_planar_step_per_particle,
            "grid_lookup": grid_lookup, "primitive_field": primitive_field_cost}


def reset_counters() -> None:
    """Set every kernel's launch count (and the count of generic or
    runtime-size launches of the FK kernels, K7 and S1, and S1's launches
    whose planes did not go by TMA) to 0, just before a main path runs."""
    for fn in kernel_counters().values():
        fn.launches = 0
        if hasattr(fn, "generic_launches"):
            fn.generic_launches = 0
        if hasattr(fn, "staged_launches"):
            fn.staged_launches = 0


def generic_walks(counters: dict) -> dict:
    """The launches through a generic FK walk or a runtime size (K7's link
    count, S1's block size), by JSON name."""
    return {k: fn.generic_launches for k, fn in counters.items()
            if hasattr(fn, "generic_launches")}


def fmt_ms(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def fmt_list(xs) -> str:
    return "[" + ", ".join(f"{x:.3g}" for x in xs) + "]"


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory
    rate and the FP32 operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _cast(obj, dtype, device):
    """A copy of dataclass ``obj`` with its floating tensor fields moved."""
    from dataclasses import fields

    return replace(obj, **{
        f.name: getattr(obj, f.name).to(device=device, dtype=dtype) for f in fields(obj)
        if torch.is_tensor(getattr(obj, f.name)) and getattr(obj, f.name).is_floating_point()})


def planar_gates(what: str, means, out=None) -> tuple[float, float]:
    """The planar paths' gates on the final ``means [15, T, 4]`` (and the
    planner's 6-tuple ``out``, when given: its shapes and finite values):
    end points within GOAL_TOL of their goals, starts within START_TOL.
    Returns ``(goal_err, start_err)``."""
    from stoch_gpmp_tpu_torch.problems import GOALS, START

    p = means.shape[0]
    if out is not None:
        shapes = [tuple(o.shape) for o in out]
        if shapes != [(p, T, 2), (p, T, 2), (p, S, T, 2), (p, S, T, 2), (p, S), (p, T, 4)]:
            fail(f"{what}: unexpected 6-tuple shapes {shapes}")
    if not all(bool(torch.isfinite(o).all()) for o in (out or (means,))):
        fail(f"{what}: non-finite output")
    ends = means.reshape(3, PPG, T, 4)[:, :, -1, :2].cpu()
    goal_err = float((ends - torch.tensor(GOALS)[:, None, :2]).norm(dim=-1).max())
    start_err = float((means[:, 0, :2].cpu() - torch.tensor(START[:2])).abs().max())
    if goal_err >= GOAL_TOL or start_err >= START_TOL:
        fail(f"{what}: end points {goal_err:.3g} from the goals, start {start_err:.3g}")
    return goal_err, start_err


def raster_check(dev) -> dict:
    """K1 vs plain, exact, at the planner's strided shape plus edge points."""
    from stoch_gpmp_tpu_torch.ops.kernels.fields import (
        raster_primitive_cost,
        raster_primitive_cost_plain,
    )
    from stoch_gpmp_tpu_torch.problems import build_planar_cost

    _, field = build_planar_cost(dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    trajs = torch.rand((PPG * 3 * S, T, 4), generator=gen, device=dev) * 22 - 11
    view = trajs[:, 1:, :2]  # what CostCollision passes: no copy
    edges = _cell_edges(dev)
    kw = dict(cell_size=field.cell_size, nx=field.nx, ny=field.ny)
    args = (field.rect_bounds, field.circles)
    errs = []
    for pts in (view, edges):
        got = raster_primitive_cost(*args, pts, **kw)
        want = raster_primitive_cost_plain(*args, pts, **kw)
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
        if not torch.equal(got, want):
            n = int((got != want).sum())
            fail(f"K1 differs from its plain version at {n} of {want.numel()} points")
    kernel = lambda: raster_primitive_cost(*args, view, **kw)  # noqa: E731
    plain = lambda: raster_primitive_cost_plain(*args, view, **kw)  # noqa: E731
    return dict(points=view.shape[0] * view.shape[1], edge_points=edges.shape[0],
                max_abs_err=max(errs), ms=cuda_ms(kernel, 200), plain_ms=cuda_ms(plain, 50),
                device_ms=device_ms(kernel, 100), queued_ms=queued_ms(kernel),
                plain_device_ms=device_ms(plain, 20))


def make_step(dev, sigma_goal_prior=1e-3, zero_quad=False, per_particle=False):
    """K2's (or with ``per_particle`` K9's) step object for the parity
    problem (or the pure sampler of the moments check: quadratic,
    importance and obstacles removed)."""
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (
        make_fused_planar_step,
        make_fused_planar_step_batched,
    )
    from stoch_gpmp_tpu_torch.problems import build_planar_problem

    sampler, cost, state = build_planar_problem(
        dtype=torch.float32, device=dev, sigma_goal_prior=sigma_goal_prior)
    quad, coll = cost.costs
    dq, prior = quad.dof_form, sampler.dof
    rects, circles, k_coll, tau, step_size = (
        coll.field.rect_bounds, coll.field.circles, K_COLL, TAU, STEP)
    if zero_quad:
        z = torch.zeros((2, 2), device=dev)
        dq = replace(dq, q_i2=z, k_s2=z, k_g2=z)
        prior = replace(prior, q_i2=z, k_s2=z, k_g2=z)
        rects, circles = rects[:0], circles[:0]
        k_coll, tau, step_size = 0.0, 1e30, 1.0
    make = make_fused_planar_step if per_particle else make_fused_planar_step_batched
    step = make(
        weight_t=sampler.weight_t, dof_prior=prior, dof_quad=dq,
        num_particles=state.particle_means.shape[0], rect_bounds=rects, circles=circles,
        cell_size=coll.field.cell_size, nx=coll.field.nx, ny=coll.field.ny,
        traj_len=T, state_dim=4, num_samples=S, k_coll=k_coll,
        temperature=tau, step_size=step_size,
    )
    return step, state


def fused_check(dev, branch: str, per_particle: bool = False) -> dict:
    """K2 (or with ``per_particle`` K9), eps operand, vs its plain version
    on the card."""
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (
        fused_planar_step,
        fused_planar_step_per_particle,
        fused_planar_step_plain,
    )

    kname = "K9" if per_particle else "K2"
    step, state = make_step(dev, sigma_goal_prior=1e-5 if branch == "stencil" else 1e-3,
                            per_particle=per_particle)
    if step.use_stencil != (branch == "stencil"):
        fail(f"{kname} {branch}: the gate picked the other quadratic")
    p = state.particle_means.shape[0]
    means = state.particle_means.reshape(p, -1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(1)
    eps = torch.randn((p, S, means.shape[1]), generator=gen, device=dev)
    wrapper = fused_planar_step_per_particle if per_particle else fused_planar_step
    new_k, cost_k = wrapper(step, means, eps=eps)
    new_p, cost_p = fused_planar_step_plain(step, means, eps)
    torch.cuda.synchronize()
    if not (torch.isfinite(cost_k).all() and torch.isfinite(new_k).all()):
        fail(f"{kname} {branch}: non-finite output")
    diff = (cost_k - cost_p).abs()
    tol = COST_RTOL * cost_p.abs()
    near = diff <= tol
    flips = torch.round(diff / step.k_coll) if step.k_coll else torch.zeros_like(diff)
    edge = (~near) & (flips >= 1) & ((diff - flips * step.k_coll).abs() <= tol)
    bad = ~(near | edge)
    edge_share = float(edge.float().mean())
    if bool(bad.any()):
        fail(f"{kname} {branch}: {int(bad.sum())} costs off by more than rtol {COST_RTOL} "
             f"(max rel {float((diff / cost_p.abs()).max()):.3g})")
    if edge_share > EDGE_SHARE:
        fail(f"{kname} {branch}: {edge_share:.3%} of the samples flipped a cell edge")
    agree = cost_k.argmin(1) == cost_p.argmin(1)
    if float(agree.float().mean()) < MIN_ARGMAX_AGREE:
        fail(f"{kname} {branch}: best sample agrees for only {int(agree.sum())}/{p} particles")
    mean_err = float((new_k - new_p)[agree].abs().max())
    if mean_err > MEAN_ATOL:
        fail(f"{kname} {branch}: new means differ by {mean_err:.3g} where the best sample agrees")
    out = dict(cost_max_rel=float((diff[near] / cost_p.abs()[near]).max()),
               edge_flips=int(edge.sum()), argmax_agree=int(agree.sum()), particles=p,
               max_abs_err=mean_err)
    if branch == "matmul":  # time the main path's branch: seed mode vs plain + its draw
        rng = (dict(seeds=torch.randint(-(2**31), 2**31, (p, 2), generator=gen, device=dev,
                                        dtype=torch.int32)) if per_particle else dict(seed=3))
        kernel = lambda: wrapper(step, means, **rng)  # noqa: E731
        plain = lambda: fused_planar_step_plain(  # noqa: E731
            step, means, torch.randn((p, S, means.shape[1]), generator=gen, device=dev))
        out.update(ms=cuda_ms(kernel, 200), plain_ms=cuda_ms(plain, 50),
                   device_ms=device_ms(kernel, 50), plain_device_ms=device_ms(plain, 20),
                   **planar_launch(step, per_particle))
    return out


def planar_launch(step, per_particle: bool) -> dict:
    """K2's (K9's) launch at the step's shape, the matmul branch's bound on
    the SMs its CTAs occupy (its two [S, M] x [M, M] products per particle
    at the FP32 peak of those SMs) and how many waves of clusters the grid
    runs in."""
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import launch_shape

    shape = launch_shape(step, per_particle=per_particle)
    p, m = step.num_particles, step.traj_len * step.state_dim
    flops = 2 * 2 * p * S * m * m
    sms = min(132, shape["ctas_launched"])
    return dict(shape, waves=-(-p // shape["max_active_clusters"]),
                bound_on_sms_ms=flops / (FP32_FLOP_PER_SM * sms) * 1e3)


def split_check(dev, kname: str) -> dict:
    """K2, K9 or K6 in seed mode with 1 CTA per particle and with
    ``ctas_per_particle``'s split, on the same means and seeds: the draws
    do not depend on the split, so the costs agree within COST_RTOL
    (K6: K5_COST_RTOL) and the new means within SPLIT_MEAN_ATOL (the
    cluster sums the update in another order)."""
    from stoch_gpmp_tpu_torch.ops.kernels import fused_step, panda_step

    if kname == "K6":
        sampler, cost, state, obs, s = panda4_problem(dev)
        p = state.particle_means.shape[0]
        step = make_flat_step(sampler, cost, obs, p, s)
        run = lambda c: panda_step.fused_panda_step(step, means, seed=17, ctas=c)  # noqa: E731
        split, rtol = panda_step.launch_shape(step)["ctas"], K5_COST_RTOL
    else:
        step, state = make_step(dev, per_particle=kname == "K9")
        p = state.particle_means.shape[0]
        if kname == "K9":
            seeds = torch.arange(2 * p, device=dev, dtype=torch.int32).reshape(p, 2) * 7919 - 5
            run = lambda c: fused_step.fused_planar_step_per_particle(  # noqa: E731
                step, means, seeds=seeds, ctas=c)
        else:
            run = lambda c: fused_step.fused_planar_step(step, means, seed=17, ctas=c)  # noqa: E731
        split = fused_step.launch_shape(step, per_particle=kname == "K9")["ctas"]
        rtol = COST_RTOL
    means = state.particle_means.reshape(p, -1).contiguous()
    new_1, cost_1 = run(1)
    new_c, cost_c = run(split)
    torch.cuda.synchronize()
    if not (torch.isfinite(cost_c).all() and torch.isfinite(new_c).all()):
        fail(f"{kname} split: non-finite output")
    cost_rel = float(((cost_c - cost_1).abs() / cost_1.abs()).max())
    mean_err = float((new_c - new_1).abs().max())
    if cost_rel > rtol or mean_err > SPLIT_MEAN_ATOL:
        fail(f"{kname}: {split} CTAs per particle against 1: costs {cost_rel:.3g} relative "
             f"(> {rtol}) or new means {mean_err:.3g} apart (> {SPLIT_MEAN_ATOL})")
    return dict(ctas=split, cost_max_rel=cost_rel, mean_max_err=mean_err)


def moments_check(dev, per_particle: bool = False) -> dict:
    """K2 (or with ``per_particle`` K9, the configuration of the JAX
    package's tests/test_fused_step_tpu.py:63-96) with Philox draws and
    uniform weights (the cost's and the sampling prior's stencil weights
    zeroed, so the in-kernel importance term is 0): the update is the sample
    mean of ``eps @ W``, so its per-lane variance is diag(W^T W) / S."""
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (
        fused_planar_step,
        fused_planar_step_per_particle,
    )

    step, state = make_step(dev, zero_quad=True, per_particle=per_particle)
    p = state.particle_means.shape[0]
    means = state.particle_means.reshape(p, -1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(7)
    diffs = []
    for seed in range(100):
        if per_particle:
            seeds = torch.randint(-(2**31), 2**31, (p, 2), generator=gen, device=dev,
                                  dtype=torch.int32)
            new, _ = fused_planar_step_per_particle(step, means, seeds=seeds)
        else:
            new, _ = fused_planar_step(step, means, seed=1000 + seed)
        diffs.append(new - means)
    d = torch.stack(diffs).double()  # [seeds, P, M]
    emp_var = d.var(dim=(0, 1))
    want_var = (step.weight_t.double() ** 2).sum(0) / S
    ratio = float((emp_var / want_var).median())
    max_mean = float(d.mean(dim=(0, 1)).abs().max())
    kname = "K9" if per_particle else "K2"
    if not 0.85 < ratio < 1.15:
        fail(f"{kname} Philox: median variance ratio {ratio:.4f} outside (0.85, 1.15)")
    if not max_mean < 0.02:
        fail(f"{kname} Philox: largest per-lane mean {max_mean:.4f} >= 0.02")
    return dict(var_ratio_median=ratio, max_lane_mean=max_mean)


def main_path(dev) -> dict:
    """StochGPMP(fused_kernel=True) on the parity problem, built natively."""
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (
        fused_planar_optimize_batched,
        fused_planar_step_plain,
    )
    from stoch_gpmp_tpu_torch.planners import StochGPMP
    from stoch_gpmp_tpu_torch.problems import DT, GOALS, SAMPLE_SIGMAS, START, build_planar_cost

    cost, _ = build_planar_cost(dtype=torch.float32, device=dev)
    s_start, s_gp, s_goal = SAMPLE_SIGMAS
    planner = StochGPMP(
        num_particles_per_goal=PPG, num_samples=S, traj_len=T, opt_iters=ITERS, dt=DT,
        n_dof=2, step_size=STEP, temperature=TAU, start_state=START,
        multi_goal_states=GOALS, initial_particle_means="const_vel", cost=cost,
        sigma_start_sample=s_start, sigma_gp_sample=s_gp, sigma_goal_sample=s_goal,
        seed=0, dtype=torch.float32, device=dev, fused_kernel=True,
    )
    p = planner.num_particles
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = planner.optimize()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernel_counters().items()
                if k in ("raster_field", "fused_planar_step")}
    if min(launches.values()) < 1:
        fail(f"main path did not launch every kernel: {launches}")
    goal_err, start_err = planar_gates("main path", planner.particle_means, out)

    # the fused loop, kernel vs plain K2 on the card: plain, kernel, kernel, plain
    run = planner._fused_runner({})
    step = run.step
    means0 = planner.particle_means.clone()
    gen = torch.Generator(device=dev).manual_seed(5)

    def kernel_loop():
        return fused_planar_optimize_batched(step, means0, gen, ITERS - 1)

    def plain_loop():
        m = means0.reshape(p, -1)
        for _ in range(ITERS - 1):
            eps = torch.randn((p, S, m.shape[1]), generator=gen, device=dev)
            m, _ = fused_planar_step_plain(step, m, eps)
        return m

    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_loop if name == "kernel" else plain_loop
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t1)
    per_s = {k: p * (ITERS - 1) / (sum(v) / len(v)) for k, v in times.items()}
    # device busy share of the kernel loop: device time per iteration from a
    # profiled 50-iteration window over the wall time per iteration of the
    # unprofiled runs above (the profiler slows the host, not the device)
    busy, _, ops = device_breakdown(lambda: fused_planar_optimize_batched(step, means0, gen, 50),
                                    1)
    iter_ms = 1e3 * sum(times["kernel"]) / len(times["kernel"]) / (ITERS - 1)
    loop_gate("main", ops / 50)
    return dict(launches=launches, goal_err=goal_err, start_err=start_err,
                optimize_seconds=seconds, optimize_updates_per_s=p * ITERS / seconds,
                loop_updates_per_s_kernel=per_s["kernel"],
                loop_updates_per_s_plain=per_s["plain"],
                loop_iter_wall_ms=iter_ms, loop_device_ops_per_iter=ops / 50,
                loop_iter_device_ms=None if busy is None else busy / 50,
                loop_device_busy=None if busy is None else busy / 50 / iter_ms)


def split_line(r: dict, split: dict, smi: str) -> str:
    """The cluster-split phase line of K2, K9 or K6: the launch, the bound
    on the SMs it fills, and seed mode at 1 CTA per particle against the
    split."""
    return (f"{r['ctas']} CTAs per particle, {r['ctas_launched']} CTAs launched in clusters "
            f"of {r['ctas']} ({r['smem_bytes']} B of shared memory each), "
            f"{r['max_active_clusters']} clusters resident at once ({r['waves']} wave(s)); "
            f"bound {r['bound_on_sms_ms']:.4f} ms on the {min(132, r['ctas_launched'])} SMs "
            f"used; seed mode at {split['ctas']} CTAs per particle against 1: costs within "
            f"{split['cost_max_rel']:.2e} relative, new means within {split['mean_max_err']:.2e}"
            f" on {smi}")


def loop_gate(what: str, ops_per_iter: float) -> None:
    """A fused loop runs one kernel launch per iteration (plus the seeds'
    draw, once per window): at most MAX_LOOP_OPS device operations each."""
    if not ops_per_iter <= MAX_LOOP_OPS:
        fail(f"{what}: {ops_per_iter:.2f} device operations per iteration (> {MAX_LOOP_OPS})")


def panda_problem(dev, dtype=torch.float32):
    from stoch_gpmp_tpu_torch.problems import build_panda_problem

    return build_panda_problem(**PANDA, dtype=dtype, device=dev)


def _planner_rows(means, s, scale, seed, dev):
    """``[P * S, T, 2d]`` sample trajectories: each particle mean plus
    normal noise of ``scale``, rows sample-minor."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = means.repeat_interleave(s, dim=0)
    return rows + scale * torch.randn(rows.shape, generator=gen, device=dev, dtype=rows.dtype)


def dof_quad_check(dev) -> dict:
    """K3 vs a float64 plain oracle at config 5, in the planner regime (the
    particle means + 1e-3 spreads), without and with the importance term."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.stencil import dof_quad_eval, dof_quad_eval_plain

    sampler, cost, state, _, s = panda_problem(dev)
    dq = cost.costs[0].dof_form
    dq64 = _cast(dq, torch.float64, dev)
    xp = to_dof_planes(_planner_rows(state.particle_means, s, 1e-3, 3, dev)).contiguous()
    pu = sampler.dof.matvec_planes(to_dof_planes(state.particle_means))
    kw = dict(pu=pu, temperature=K3_TAU, num_samples=s)
    errs = []
    for extra in ({}, kw):
        got = dof_quad_eval(dq, xp, **extra)
        want = dof_quad_eval_plain(dq64, xp.double(), **{
            k: v.double() if torch.is_tensor(v) else v for k, v in extra.items()})
        torch.cuda.synchronize()
        rel = float(((got.double() - want).abs() / want.abs()).max())
        if not (torch.isfinite(got).all() and rel <= K3_RTOL):
            fail(f"K3 differs from the float64 oracle by {rel:.3g} relative (> {K3_RTOL})")
        errs.append((rel, float((got.double() - want).abs().max())))
    d, b, t2 = xp.shape
    nb, ops = 4 * (xp.numel() + pu.numel() + b), d * b * (t2 // 2) * 14
    kernel = lambda: dof_quad_eval(dq, xp, **kw)  # noqa: E731
    plain = lambda: dof_quad_eval_plain(dq, xp, **kw)  # noqa: E731
    return dict(rows=b, max_rel=max(e[0] for e in errs), max_abs_err=max(e[1] for e in errs),
                ms=cuda_ms(kernel, 100), plain_ms=cuda_ms(plain, 20),
                device_ms=device_ms(kernel, 50), plain_device_ms=device_ms(plain, 10),
                bound=bound(nb, ops))


def _field_check_rows(state, s, dev):
    """``[P * S, T, 2d]`` rows of the field checks: half the planner regime
    (the means + 0.05 spreads), half drawn uniformly across the joint limits
    (links within the 3 cm margin of each other)."""
    rows = _planner_rows(state.particle_means, s, 0.05, 4, dev)
    half = rows.shape[0] // 2
    lo = torch.tensor([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973], device=dev)
    hi = torch.tensor([2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973], device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    u = torch.rand((rows.shape[0] - half, rows.shape[1], 7), generator=gen, device=dev)
    rows[half:, :, :7] = lo + (hi - lo) * u
    return rows


def _spheres_on_links(spheres, links):
    """The spheres with the last two moved onto link positions of ``links
    [>= 2, >= 5, L, 3]`` (radius 0.1), so some points sit inside a sphere."""
    sp = spheres.reshape(-1, 4).clone()
    sp[3, :3], sp[4, :3] = links[0, 0, -1].to(sp.dtype), links[1, 4, 3].to(sp.dtype)
    sp[3:, 3] = 0.1
    return sp


# FP32 operations per (trajectory, t) point of K4, as counted for bound_ms:
# 36 self pairs and 45 sphere pairs of ~10 operations each (differences,
# squared norm, scale, exp, accumulate) and ~45 per joint of the FK walk.
K4_OPS_PER_POINT = (36 + 45) * 10 + 9 * 45


def fk_fields_check(dev) -> dict:
    """K4 vs a float64 plain oracle at config-5 shapes. Half the rows are the
    planner regime (means + 0.05 spreads), half are drawn uniformly across
    the joint limits (links within the 3 cm margin of each other); two of
    the five spheres sit on link positions of the first rows, so those
    points are inside a sphere. Then the flat-stride entry
    (``PlaneFieldsCost.eval`` on ``[B, T, 2d]``) against the plane entry."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (
        fk_link_fields_cost_rows,
        fk_link_fields_cost_rows_plain,
        fk_variant,
    )

    _, cost, state, obs, s = panda_problem(dev)
    fields = cost.costs[1]
    chain = fields.chain
    if fk_variant(chain) != 1:
        fail("K4: the Panda chain did not take the specialised FK walk")
    rows = _field_check_rows(state, s, dev)
    xp = to_dof_planes(rows).contiguous()  # [7, B, 2T]
    t = xp.shape[-1] // 2
    q = xp[:, :, :t]  # the dof path's strided view
    spheres = _spheres_on_links(obs["obstacle_spheres"],
                                chain.fk_compact(rows[:2, 5:10, :7].double()).positions)
    kw = dict(margin=fields.margin, w_self=1.0 / fields.sigma_self**2,
              w_obst=1.0 / fields.sigma_coll**2)
    got = fk_link_fields_cost_rows(chain, q, spheres, **kw)
    want = fk_link_fields_cost_rows_plain(chain, q.double(), spheres.double(), **kw)
    torch.cuda.synchronize()
    rel = float(((got.double() - want).abs() / want.abs()).max())
    if not (torch.isfinite(got).all() and rel <= K4_RTOL):
        fail(f"K4 differs from the float64 oracle by {rel:.3g} relative (> {K4_RTOL})")
    obs2 = {"obstacle_spheres": spheres}
    flat = fields.eval(rows, observation=obs2)
    planes = fields.eval_dof_planes(xp, observation=obs2)
    torch.cuda.synchronize()
    flat_rel = float(((flat - planes).abs() / planes.abs()).max())
    if flat_rel > 1e-6:
        fail(f"K4 flat-stride entry differs from the plane entry by {flat_rel:.3g} relative")
    d, b, _ = q.shape
    nb = 4 * (d * b * t + b + spheres.numel())
    kernel = lambda: fk_link_fields_cost_rows(chain, q, spheres, **kw)  # noqa: E731
    plain = lambda: fk_link_fields_cost_rows_plain(chain, q, spheres, **kw)  # noqa: E731
    return dict(rows=b, points=b * (t - 1), max_rel=rel,
                max_abs_err=float((got.double() - want).abs().max()), flat_rel=flat_rel,
                ms=cuda_ms(kernel, 50), plain_ms=cuda_ms(plain, 10),
                device_ms=device_ms(kernel, 20), plain_device_ms=device_ms(plain, 5),
                bound=bound(nb, b * (t - 1) * K4_OPS_PER_POINT))


def generic_chain():
    """A serial chain that no FK spec of the kernels matches: a fixed base,
    a revolute joint about z, one about x under a general origin rotation, a
    prismatic joint along y, a revolute joint about a tilted axis and a
    fixed end-effector; 4 dofs, 5 links."""
    from stoch_gpmp_tpu_torch.kinematics.chain import KinematicChain
    from stoch_gpmp_tpu_torch.kinematics.urdf import JointSpec, RobotModel

    joints = (
        JointSpec("j0", "fixed", "base", "l0", origin_xyz=(0.0, 0.0, 0.1)),
        JointSpec("j1", "revolute", "l0", "l1", origin_xyz=(0.0, 0.0, 0.2)),
        JointSpec("j2", "revolute", "l1", "l2", origin_xyz=(0.1, 0.0, 0.15),
                  origin_rpy=(0.3, 0.0, 0.2), axis=(1.0, 0.0, 0.0)),
        JointSpec("j3", "prismatic", "l2", "l3", origin_xyz=(0.0, 0.05, 0.1),
                  axis=(0.0, 1.0, 0.0)),
        JointSpec("j4", "revolute", "l3", "l4", origin_xyz=(0.08, 0.0, 0.0),
                  origin_rpy=(0.0, -0.4, 0.1), axis=(0.6, 0.0, 0.8)),
        JointSpec("j5", "fixed", "l4", "ee", origin_xyz=(0.0, 0.0, 0.1)),
    )
    return KinematicChain(RobotModel("generic", joints), ["l1", "l2", "l3", "l4", "ee"])


def fk_generic_check(dev) -> dict:
    """K4 and K8 through the generic FK walk on ``generic_chain`` against
    float64 oracles: 2048 trajectories of T = 64 joint values (revolute
    U(-2.5, 2.5) rad, prismatic U(-0.2, 0.2) m), spheres on links of the
    first rows, K4_RTOL."""
    from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (
        fk_link_fields_cost,
        fk_link_fields_cost_plain,
        fk_link_fields_cost_rows,
        fk_link_fields_cost_rows_plain,
        fk_variant,
    )

    chain = generic_chain()
    if fk_variant(chain) != 0:
        fail("the test chain took a specialised FK walk")
    gen = torch.Generator(device=dev).manual_seed(9)
    scale = torch.tensor([2.5, 2.5, 0.2, 2.5], device=dev)
    q = (2 * torch.rand((2048, 64, 4), generator=gen, device=dev) - 1) * scale  # [B, T, d]
    pos = chain.fk_compact(q[:2, :5].double()).positions  # [2, 5, L, 3]
    spheres = torch.tensor([[0.3, 0.1, 0.4, 0.15], [0.0, 0.0, 0.3, 0.1], [0.1, -0.1, 0.5, 0.2],
                            [0.0, 0.0, 0.0, 0.1], [0.0, 0.0, 0.0, 0.1]], device=dev)
    spheres[3, :3], spheres[4, :3] = pos[0, 0, -1].float(), pos[1, 4, 2].float()
    kw = dict(margin=0.03, w_self=1e4, w_obst=1e4)
    planes = q.permute(2, 0, 1)  # [d, B, T], a view
    before = (fk_link_fields_cost_rows.generic_launches, fk_link_fields_cost.generic_launches)
    k4 = fk_link_fields_cost_rows(chain, planes, spheres, **kw)
    want4 = fk_link_fields_cost_rows_plain(chain, planes.double(), spheres.double(), **kw)
    flat = q.reshape(-1, 4)
    k8 = fk_link_fields_cost(chain, flat, spheres, **kw)
    walks = (fk_link_fields_cost_rows.generic_launches - before[0],
             fk_link_fields_cost.generic_launches - before[1])
    if walks != (1, 1):
        fail(f"generic FK walk: K4 and K8 counted {walks} generic launches, expected (1, 1)")
    want8 = fk_link_fields_cost_plain(chain, flat.double(), spheres.double(), **kw)
    torch.cuda.synchronize()
    rel4 = float(((k4.double() - want4).abs() / want4.abs()).max())
    rel8 = float(((k8.double() - want8).abs() / want8.abs()).max())
    if not (torch.isfinite(k4).all() and torch.isfinite(k8).all() and max(rel4, rel8) <= K4_RTOL):
        fail(f"generic FK walk: K4 {rel4:.3g}, K8 {rel8:.3g} relative from the float64 oracle "
             f"(> {K4_RTOL})")
    return dict(trajectories=q.shape[0], points=flat.shape[0], k4_max_rel=rel4, k8_max_rel=rel8)


def tilted_panda():
    """The Panda with one Rx(90 deg) origin rotation tilted by 1e-3 rad: no
    FK spec matches it, so the fused Panda kernels take the generic walk."""
    from dataclasses import replace as dc_replace

    from stoch_gpmp_tpu_torch.kinematics.chain import KinematicChain
    from stoch_gpmp_tpu_torch.kinematics.panda_model import PANDA_FK_LINKS, franka_panda

    panda = franka_panda(link_names=PANDA_FK_LINKS)
    joints = list(panda.model.joints)
    k = next(i for i, j in enumerate(joints) if j.joint_type == "revolute" and
             abs(abs(j.origin_rpy[0]) - 1.5707963267948966) < 1e-9)
    joints[k] = dc_replace(joints[k], origin_rpy=(joints[k].origin_rpy[0] + 1e-3, 0.0, 0.0))
    return KinematicChain(dc_replace(panda.model, joints=tuple(joints)), PANDA_FK_LINKS)


def fused_generic_walk_check(dev) -> dict:
    """K5 (config 5) and K6 (config 4) with the eps operand on a chain no FK
    spec matches (``tilted_panda``: the generic walk, K5's dense
    instantiation) against their plain versions on the same chain, under
    K5's gates (K6: every particle's best sample agreeing)."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import fk_variant
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step import (
        fused_panda_step,
        fused_panda_step_plain,
    )
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import (
        fused_panda_dof_step,
        fused_panda_dof_step_plain,
    )

    chain = tilted_panda()
    if fk_variant(chain) != 0:
        fail("the tilted Panda took a specialised FK walk")
    gen = torch.Generator(device=dev).manual_seed(10)
    before = (fused_panda_dof_step.generic_launches, fused_panda_step.generic_launches)
    sampler, cost, state, obs, s = panda_problem(dev)
    p = state.particle_means.shape[0]
    step = make_dof_step(sampler, cost, obs, p, s, chain=chain)
    means = to_dof_planes(state.particle_means).contiguous()
    eps = torch.randn((7, p, s, means.shape[-1]), generator=gen, device=dev)
    k5 = _k5_gates("K5 generic walk", *fused_panda_dof_step(step, means, eps=eps),
                   *fused_panda_dof_step_plain(step, means, eps))
    sampler4, cost4, state4, obs4, s4 = panda4_problem(dev)
    p4 = state4.particle_means.shape[0]
    step4 = make_flat_step(sampler4, cost4, obs4, p4, s4, chain=chain)
    means4 = state4.particle_means.reshape(p4, -1).contiguous()
    eps4 = torch.randn((p4, s4, means4.shape[1]), generator=gen, device=dev)
    k6 = _k5_gates("K6 generic walk", *fused_panda_step(step4, means4, eps=eps4),
                   *fused_panda_step_plain(step4, means4, eps4))
    torch.cuda.synchronize()
    if k6[1] != p4:
        fail(f"K6 generic walk: best sample agrees for only {k6[1]}/{p4} particles")
    walks = (fused_panda_dof_step.generic_launches - before[0],
             fused_panda_step.generic_launches - before[1])
    if walks != (1, 1):
        fail(f"generic FK walk: K5 and K6 counted {walks} generic launches, expected (1, 1)")
    return dict(k5_cost_max_rel=k5[0], k5_mean_max_err=k5[2], k6_cost_max_rel=k6[0],
                k6_mean_max_err=k6[2])


def make_dof_step(sampler, cost, obs, p, s, **over):
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import make_fused_panda_dof_step

    quad, fields = cost.costs
    kw = dict(
        chain=fields.chain, dof_prior=sampler.dof, dof_quad=quad.dof_form, num_particles=p,
        spheres=obs["obstacle_spheres"], target_h=fields.target_h, n_dof=fields.n_dof,
        traj_len=fields.traj_len, num_samples=s, margin=fields.margin,
        w_self=1.0 / fields.sigma_self**2, w_obst=1.0 / fields.sigma_coll**2,
        w_goal=1.0 / fields.sigma_goal**2, temperature=PANDA_TAU, step_size=PANDA_STEP)
    kw.update(over)
    return make_fused_panda_dof_step(**kw)


def _k5_gates(what: str, new_k, cost_k, new_p, cost_p) -> tuple[float, int, float]:
    """K5's gates against its plain version: finite, costs within
    K5_COST_RTOL, the best sample agreeing for MIN_ARGMAX_AGREE of the
    particles and there the new means (dof planes [d, P, 2T], or K6's [P, M])
    within K5_MEAN_ATOL."""
    p = cost_k.shape[0]
    if not (torch.isfinite(cost_k).all() and torch.isfinite(new_k).all()):
        fail(f"{what}: non-finite output")
    rel = float(((cost_k - cost_p).abs() / cost_p.abs()).max())
    if rel > K5_COST_RTOL:
        fail(f"{what}: costs differ from the plain version by {rel:.3g} relative "
             f"(> {K5_COST_RTOL})")
    agree = cost_k.argmin(1) == cost_p.argmin(1)
    if float(agree.float().mean()) < MIN_ARGMAX_AGREE:
        fail(f"{what}: best sample agrees for only {int(agree.sum())}/{p} particles")
    diff = new_k - new_p
    mean_err = float((diff[:, agree] if diff.dim() == 3 else diff[agree]).abs().max())
    if mean_err > K5_MEAN_ATOL:
        fail(f"{what}: new means differ by {mean_err:.3g} where the best sample agrees")
    return rel, int(agree.sum()), mean_err


def fused_dof_check(dev) -> dict:
    """K5 with an eps operand vs its plain version at config 5, through the
    instantiation that skips W_dof's zero half (the prior's W), with its
    launch; the bound counts the dense product, ``nonzero_bound`` only the
    half of W the kernel reads."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import (
        fused_panda_dof_step,
        fused_panda_dof_step_plain,
        launch_shape,
    )

    sampler, cost, state, obs, s = panda_problem(dev)
    p = state.particle_means.shape[0]
    step = make_dof_step(sampler, cost, obs, p, s)
    if not step.triangular:
        fail("K5: the prior's W_dof did not take the instantiation that skips its zero half")
    means = to_dof_planes(state.particle_means).contiguous()
    gen = torch.Generator(device=dev).manual_seed(6)
    eps = torch.randn((7, p, s, means.shape[-1]), generator=gen, device=dev)
    new_k, cost_k = fused_panda_dof_step(step, means, eps=eps)
    new_p, cost_p = fused_panda_dof_step_plain(step, means, eps)
    torch.cuda.synchronize()
    rel, agree, mean_err = _k5_gates("K5", new_k, cost_k, new_p, cost_p)
    kernel = lambda: fused_panda_dof_step(step, means, seed=3)  # noqa: E731
    plain = lambda: fused_panda_dof_step_plain(  # noqa: E731
        step, means, torch.randn(eps.shape, generator=gen, device=dev))
    m, t = means.shape[-1], means.shape[-1] // 2
    fields = p * s * (t - 1) * K4_OPS_PER_POINT
    nb = 4 * (3 * means.numel() + m * m + p * s)
    # the non-zero half: per row, 2 (T - t(m)) products per column m
    nonzero_macs = 7 * p * s * 2 * t * (t + 1)
    return dict(cost_max_rel=rel, argmax_agree=agree, particles=p,
                max_abs_err=mean_err, ms=cuda_ms(kernel, 50), plain_ms=cuda_ms(plain, 10),
                device_ms=device_ms(kernel, 20), plain_device_ms=device_ms(plain, 5),
                bound=bound(nb, 2 * 7 * p * s * m * m + fields),
                nonzero_bound=bound(4 * (3 * means.numel() + step.w_windows.numel() + p * s),
                                    2 * nonzero_macs + fields),
                launch=launch_shape(step))


def fused_dof_split_check(dev) -> dict:
    """K5 in seed mode at the persistent launch against one particle per CTA
    (the same draws: the Philox counter does not depend on the CTA): costs
    and new means equal to the last bit, and the means within SPLIT_MEAN_ATOL
    in any case. Then the dense instantiation: on the prior's W (its zero
    half multiplied, summed in the same order) equal to the last bit to the
    instantiation that skips it, and on a W without the zeros (the prior's
    plus noise of 1e-4 of its largest entry) against the plain version under
    K5's gates."""
    from dataclasses import replace as dc_replace

    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import (
        fused_panda_dof_step,
        fused_panda_dof_step_plain,
        launch_shape,
    )

    sampler, cost, state, obs, s = panda_problem(dev)
    p = state.particle_means.shape[0]
    step = make_dof_step(sampler, cost, obs, p, s)
    means = to_dof_planes(state.particle_means).contiguous()
    split = launch_shape(step)["ctas"]
    new_1, cost_1 = fused_panda_dof_step(step, means, seed=17, ctas=p)
    new_c, cost_c = fused_panda_dof_step(step, means, seed=17)
    dense = dc_replace(step, w_windows=None)
    new_d, cost_d = fused_panda_dof_step(dense, means, seed=17)
    torch.cuda.synchronize()
    mean_err = float((new_c - new_1).abs().max())
    if not (torch.equal(cost_c, cost_1) and mean_err <= SPLIT_MEAN_ATOL):
        fail(f"K5: {split} persistent CTAs against one per particle: costs "
             f"{float((cost_c - cost_1).abs().max()):.3g} apart, new means {mean_err:.3g}")
    if not (torch.equal(cost_d, cost_c) and torch.equal(new_d, new_c)):
        fail("K5: the dense instantiation on the prior's W differs from the one that skips "
             f"its zeros by {float((cost_d - cost_c).abs().max()):.3g}")
    gen = torch.Generator(device=dev).manual_seed(8)
    w = sampler.dof.w_dof
    w_noisy = w + 1e-4 * w.abs().max() * torch.randn(w.shape, generator=gen, device=dev)
    over = make_dof_step(sampler, cost, obs, p, s, w_dof=w_noisy)
    if over.triangular:
        fail("K5: a W without the zero half took the triangular instantiation")
    eps = torch.randn((7, p, s, means.shape[-1]), generator=gen, device=dev)
    new_k, cost_k = fused_panda_dof_step(over, means, eps=eps)
    new_p, cost_p = fused_panda_dof_step_plain(over, means, eps)
    torch.cuda.synchronize()
    rel, agree, err = _k5_gates("K5 dense", new_k, cost_k, new_p, cost_p)
    return dict(ctas=split, particles=p, mean_max_err=mean_err, dense_cost_max_rel=rel,
                dense_argmax_agree=agree, dense_mean_max_err=err)


def fused_dof_shapes_check(dev) -> dict:
    """K5 with an eps operand against its plain version at the shapes of
    ``K5_SHAPES``, under K5's gates, with the launch each took. The Panda
    problem's stencil weights, anchors, fields and spheres (2 goals x 32
    particles), the dof-factored sampling prior built at each horizon (the
    planner's flat prior refuses 14 T > 2048) and straight start-to-goal
    means."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import make_dof_factored_prior
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import (
        fused_panda_dof_step,
        fused_panda_dof_step_plain,
        launch_shape,
    )
    from stoch_gpmp_tpu_torch.problems import (
        PANDA_DT,
        PANDA_SAMPLE_SIGMAS,
        build_panda_problem,
    )

    out = {}
    for t, s in K5_SHAPES:
        sampler, cost, state, obs, s = build_panda_problem(num_goals=2, ppg=32, num_samples=s,
                                                           traj_len=128, device=dev)
        p = state.particle_means.shape[0]
        prior = make_dof_factored_prior(t, PANDA_DT, *PANDA_SAMPLE_SIGMAS, device=dev)
        step = make_dof_step(sampler, cost, obs, p, s, traj_len=t, dof_prior=prior)
        dq = cost.costs[0].dof_form
        s0 = dq.s_pd[:, :1, None]  # [d, 1, 1] start positions
        goal = dq.g_pd[..., 0].repeat_interleave(p // dq.num_goals, 0).T[:, :, None]  # [d, P, 1]
        frac = torch.arange(t, device=dev) / (t - 1)
        vel = ((goal - s0) / ((t - 1) * PANDA_DT)).expand(-1, -1, t)
        means = torch.cat([s0 + (goal - s0) * frac, vel], dim=-1).contiguous()  # [d, P, 2T]
        gen = torch.Generator(device=dev).manual_seed(11)
        eps = torch.randn((7, p, s, 2 * t), generator=gen, device=dev)
        rel, agree, err = _k5_gates(f"K5 at T = {t}, S = {s}",
                                    *fused_panda_dof_step(step, means, eps=eps),
                                    *fused_panda_dof_step_plain(step, means, eps))
        out[f"T={t},S={s}"] = dict(cost_max_rel=rel, argmax_agree=agree, particles=p,
                                   mean_max_err=err, launch=launch_shape(step))
    return out


def fused_dof_rng_free_check(dev) -> dict:
    """K5 with ``W = 0`` (every sample is its particle's mean), the tiers of
    the JAX package's TPU test: fields + goal + importance with the
    quadratic zeroed, then the full stack, against float64 oracles built on
    the CPU; the means must not move."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.stencil import dof_quad_eval_plain

    sampler, cost, state, obs, s = panda_problem(dev)
    _, cost64, _, obs64, _ = panda_problem("cpu", torch.float64)
    p = state.particle_means.shape[0]
    means = to_dof_planes(state.particle_means).contiguous()
    prec_u = sampler.dof.matvec_planes(means)  # the kernel computes it from the means
    m64 = means.double().cpu()
    imp = torch.einsum("dpk,dpk->p", m64, prec_u.double().cpu())
    ref_f = cost64.costs[1].eval_dof_planes(m64, observation=obs64) + imp
    ref = dof_quad_eval_plain(cost64.costs[0].dof_form, m64) + ref_f
    dq = cost.costs[0].dof_form
    z = torch.zeros((2, 2), device=dev)
    zero_w = torch.zeros_like(sampler.dof.w_dof)
    out = {}
    for tier, dquad, want, rtol in (("tier1", replace(dq, q_i2=z, k_s2=z, k_g2=z), ref_f,
                                     K5_TIER1_RTOL), ("tier2", dq, ref, K5_TIER2_RTOL)):
        step = make_dof_step(sampler, cost, obs, p, s, w_dof=zero_w, dof_quad=dquad)
        new, costs = step(means, seed=0)
        torch.cuda.synchronize()
        rel = float(((costs.double().cpu() - want[:, None]).abs() / want.abs()[:, None]).max())
        still = float((new - means).abs().max())
        if rel > rtol or still > K5_STILL_ATOL:
            fail(f"K5 RNG-free {tier}: costs {rel:.3g} relative from the float64 oracle "
                 f"(> {rtol}) or means moved {still:.3g}")
        out[tier] = dict(max_rel=rel, means_moved=still)
    return out


def fused_dof_moments_check(dev) -> dict:
    """K5 with Philox draws and uniform weights (quadratic, fields and the
    sampling prior's stencil weights zeroed, so the in-kernel importance
    term is 0; temperature 1e30, step 1): the update is the sample mean of
    ``eps @ W_dof``, so its per-lane variance is ``diag(W^T W) / S`` and its
    per-lane mean is 0 within a few standard errors."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import fused_panda_dof_step

    sampler, cost, state, obs, s = panda_problem(dev)
    p = state.particle_means.shape[0]
    z = torch.zeros((2, 2), device=dev)
    step = make_dof_step(sampler, cost, obs, p, s, dof_quad=replace(
        cost.costs[0].dof_form, q_i2=z, k_s2=z, k_g2=z), w_self=0.0, w_obst=0.0, w_goal=0.0,
        dof_prior=replace(sampler.dof, q_i2=z, k_s2=z, k_g2=z), temperature=1e30,
        step_size=1.0)
    means = to_dof_planes(state.particle_means).contiguous()
    d = torch.stack([fused_panda_dof_step(step, means, seed=2000 + k)[0] - means
                     for k in range(10)]).double()  # [seeds, d, P, 2T]
    n = d.shape[0] * d.shape[1] * d.shape[2]
    want_var = (step.w_dof.double() ** 2).sum(0) / s
    ratio = float((d.var(dim=(0, 1, 2)) / want_var).median())
    z_max = float((d.mean(dim=(0, 1, 2)).abs() / (want_var / n).sqrt()).max())
    if not 0.85 < ratio < 1.15:
        fail(f"K5 Philox: median variance ratio {ratio:.4f} outside (0.85, 1.15)")
    if not z_max < 5.0:
        fail(f"K5 Philox: a lane mean is {z_max:.2f} standard errors from 0")
    return dict(var_ratio_median=ratio, max_lane_mean_z=z_max)


def panda_main_path(dev) -> dict:
    """``build_panda_problem`` at config 5 through ``StochGPMP(fused_kernel=
    True)`` and ``StochGPMP`` on the dof path, ``PANDA_ITERS`` each, through
    the class API."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import fused_panda_dof_optimize
    from stoch_gpmp_tpu_torch.planners import StochGPMP, stoch_gpmp_optimize
    from stoch_gpmp_tpu_torch.problems import PANDA_DT, PANDA_START_Q

    _, cost, _, obs, s = panda_problem(dev)
    quad, fields = cost.costs
    g_pd = quad.dof_form.g_pd  # [G, d, 2] goal anchors
    goals = torch.cat([g_pd[..., 0], g_pd[..., 1]], dim=-1)
    start_q = torch.tensor(PANDA_START_Q, device=dev)
    start = torch.cat([start_q, torch.zeros_like(start_q)])
    counters = {k: fn for k, fn in kernel_counters().items()
                if k in ("dof_quad_eval", "fk_fields", "fused_panda_dof_step")}

    def cost_of(means):
        return float(cost.eval_dof_planes(to_dof_planes(means), observation=obs).mean())

    out = {}
    for name, fused in (("fused", True), ("dof", False)):
        planner = StochGPMP(
            num_particles_per_goal=PANDA["ppg"], num_samples=s, traj_len=PANDA["traj_len"],
            dt=PANDA_DT, n_dof=7, opt_iters=PANDA_ITERS, temperature=PANDA_TAU,
            start_state=start, multi_goal_states=goals, cost=cost, step_size=PANDA_STEP,
            sigma_start_init=1e-3, sigma_goal_init=0.07, sigma_gp_init=0.1,
            sigma_start_sample=1e-3, sigma_goal_sample=0.07, sigma_gp_sample=0.1, seed=0,
            dtype=torch.float32, device=dev, fused_kernel=fused)
        p = planner.num_particles
        c0 = cost_of(planner.particle_means)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = planner.optimize(observation=obs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        generic = generic_walks(counters)
        t, n = PANDA["traj_len"], 7
        shapes = [tuple(o.shape) for o in res]
        if shapes != [(p, t, n), (p, t, n), (p, s, t, n), (p, s, t, n), (p, s), (p, t, 2 * n)]:
            fail(f"panda {name}: unexpected 6-tuple shapes {shapes}")
        if not all(bool(torch.isfinite(o).all()) for o in res):
            fail(f"panda {name}: non-finite output")
        c1 = cost_of(planner.particle_means)
        start_err = float((planner.particle_means[:, 0, :n] - start_q).abs().max())
        want = ({"dof_quad_eval": 1, "fk_fields": 1, "fused_panda_dof_step": PANDA_ITERS - 1}
                if fused else
                {"dof_quad_eval": PANDA_ITERS, "fk_fields": PANDA_ITERS, "fused_panda_dof_step": 0})
        if launches != want:
            fail(f"panda {name}: launches {launches}, expected {want}")
        if any(generic.values()):
            fail(f"panda {name}: generic FK walks {generic}: the Panda takes the specialised one")
        if not c1 < c0 or start_err > PANDA_START_TOL:
            fail(f"panda {name}: mean cost {c0:.6g} -> {c1:.6g}, start moved {start_err:.3g}")
        # device time per iteration over a profiled window of the same loop
        if fused:
            step = planner._fused_runner(obs).step
            mu = to_dof_planes(planner.particle_means).contiguous()
            window = lambda: fused_panda_dof_optimize(step, mu, planner.generator, 20)  # noqa: E731
        else:
            window = lambda: stoch_gpmp_optimize(  # noqa: E731
                planner.sampler, cost, planner.state, obs, opt_iters=20, num_samples=s,
                temperature=PANDA_TAU, step_size=PANDA_STEP)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) / 20 * 1e3
        dev_ms, top, ops = device_breakdown(window, 1)
        if fused:
            loop_gate("panda fused", ops / 20)
        out[name] = dict(
            top_kernels_ms_per_iter=[(k, ms / 20) for k, ms in top],
            device_ops_per_iter=ops / 20,
            launches=launches, generic_launches=generic, cost0=c0, cost=c1,
            start_err=start_err, optimize_seconds=seconds,
            updates_per_s=p * PANDA_ITERS / seconds,
            iter_wall_ms=wall, window_updates_per_s=p / wall * 1e3,
            iter_device_ms=None if dev_ms is None else dev_ms / 20,
            device_busy=None if dev_ms is None else dev_ms / 20 / wall)
    fused_drop = out["fused"]["cost0"] - out["fused"]["cost"]
    dof_drop = out["dof"]["cost0"] - out["dof"]["cost"]
    if not fused_drop > PANDA_DESCENT_SHARE * dof_drop:
        fail(f"panda: fused descent {fused_drop:.6g} not above {PANDA_DESCENT_SHARE} x "
             f"the dof path's {dof_drop:.6g}")
    return out


def panda4_problem(dev, dtype=torch.float32, fast=True):
    from stoch_gpmp_tpu_torch.problems import build_panda_problem

    return build_panda_problem(**PANDA4, dtype=dtype, device=dev, fast=fast)


def make_flat_step(sampler, cost, obs, p, s, **over):
    """K6's step object for config 4's fast stack."""
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step import make_fused_panda_step

    quad, fields = cost.costs
    kw = dict(
        chain=fields.chain, weight_t=sampler.weight_t, dof_prior=sampler.dof,
        dof_quad=quad.dof_form, num_particles=p, spheres=obs["obstacle_spheres"],
        target_h=fields.target_h, n_dof=fields.n_dof, traj_len=fields.traj_len, num_samples=s,
        margin=fields.margin, w_self=1.0 / fields.sigma_self**2,
        w_obst=1.0 / fields.sigma_coll**2, w_goal=1.0 / fields.sigma_goal**2,
        temperature=PANDA_TAU, step_size=PANDA_STEP)
    kw.update(over)
    return make_fused_panda_step(**kw)


def fused_flat_check(dev) -> dict:
    """K6 with an eps operand vs its plain version at config 4."""
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step import (
        fused_panda_step,
        fused_panda_step_plain,
        launch_shape,
    )

    sampler, cost, state, obs, s = panda4_problem(dev)
    p = state.particle_means.shape[0]
    step = make_flat_step(sampler, cost, obs, p, s)
    means = state.particle_means.reshape(p, -1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(7)
    m = means.shape[1]
    eps = torch.randn((p, s, m), generator=gen, device=dev)
    new_k, cost_k = fused_panda_step(step, means, eps=eps)
    new_p, cost_p = fused_panda_step_plain(step, means, eps)
    torch.cuda.synchronize()
    if not (torch.isfinite(cost_k).all() and torch.isfinite(new_k).all()):
        fail("K6: non-finite output")
    rel = float(((cost_k - cost_p).abs() / cost_p.abs()).max())
    if rel > K5_COST_RTOL:
        fail(f"K6: costs differ from the plain version by {rel:.3g} relative (> {K5_COST_RTOL})")
    agree = cost_k.argmin(1) == cost_p.argmin(1)
    if not bool(agree.all()):
        fail(f"K6: best sample agrees for only {int(agree.sum())}/{p} particles")
    mean_err = float((new_k - new_p).abs().max())
    if mean_err > K5_MEAN_ATOL:
        fail(f"K6: new means differ by {mean_err:.3g} (> {K5_MEAN_ATOL})")
    kernel = lambda: fused_panda_step(step, means, seed=3)  # noqa: E731
    plain = lambda: fused_panda_step_plain(  # noqa: E731
        step, means, torch.randn(eps.shape, generator=gen, device=dev))
    t = step.traj_len
    flops = 2 * p * s * m * m + p * s * (t - 1) * K4_OPS_PER_POINT
    nb = 4 * (m * m + 3 * p * m + p * s)  # W, means, anchors, new means, costs
    shape = launch_shape(step)
    # the same operations on the SMs that the kernel's CTAs occupy
    sms_ms = flops / (FP32_FLOP_PER_SM * min(132, shape["ctas_launched"])) * 1e3
    return dict(cost_max_rel=rel, argmax_agree=int(agree.sum()), particles=p,
                max_abs_err=mean_err, ms=cuda_ms(kernel, 100), plain_ms=cuda_ms(plain, 20),
                device_ms=device_ms(kernel, 50), plain_device_ms=device_ms(plain, 10),
                bound=bound(nb, flops), bound_on_sms_ms=sms_ms, **shape,
                waves=-(-p // shape["max_active_clusters"]))


def fused_flat_rng_free_check(dev) -> dict:
    """K6 with ``W = 0`` (every sample is its particle's mean), the tiers of
    the JAX package's TPU test: fields + goal + importance with the
    quadratic zeroed, then the full stack, against float64 oracles built on
    the CPU; the means must not move."""
    sampler, cost, state, obs, s = panda4_problem(dev)
    _, cost64, _, obs64, _ = panda4_problem("cpu", torch.float64)
    means = state.particle_means
    p = means.shape[0]
    prec_u = sampler.dof.matvec_flat(means).reshape(p, -1)
    m64 = means.double().cpu()
    imp = torch.sum(m64.reshape(p, -1) * prec_u.double().cpu(), dim=-1)
    ref_f = cost64.costs[1].eval(m64, observation=obs64) + imp
    ref = cost64.costs[0].eval(m64) + ref_f  # the float64 stencil quadratic
    dq = cost.costs[0].dof_form
    z = torch.zeros((2, 2), device=dev)
    zero_w = torch.zeros_like(sampler.weight_t)
    out = {}
    for tier, dquad, want, rtol in (("tier1", replace(dq, q_i2=z, k_s2=z, k_g2=z), ref_f,
                                     K5_TIER1_RTOL), ("tier2", dq, ref, K5_TIER2_RTOL)):
        step = make_flat_step(sampler, cost, obs, p, s, weight_t=zero_w, dof_quad=dquad)
        new, costs = step(means, seed=0)
        torch.cuda.synchronize()
        rel = float(((costs.double().cpu() - want[:, None]).abs() / want.abs()[:, None]).max())
        still = float((new - means).abs().max())
        if rel > rtol or still > K5_STILL_ATOL:
            fail(f"K6 RNG-free {tier}: costs {rel:.3g} relative from the float64 oracle "
                 f"(> {rtol}) or means moved {still:.3g}")
        out[tier] = dict(max_rel=rel, means_moved=still)
    return out


def fused_flat_moments_check(dev) -> dict:
    """K6 with Philox draws and uniform weights (quadratic, fields and the
    sampling prior's stencil weights zeroed, so the in-kernel importance
    term is 0; temperature 1e30, step 1): the update is the sample mean of
    ``eps @ W``, so its per-lane variance is ``diag(W^T W) / S`` and its
    per-lane mean is 0 within a few standard errors."""
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step import fused_panda_step

    sampler, cost, state, obs, s = panda4_problem(dev)
    p = state.particle_means.shape[0]
    z = torch.zeros((2, 2), device=dev)
    step = make_flat_step(sampler, cost, obs, p, s, dof_quad=replace(
        cost.costs[0].dof_form, q_i2=z, k_s2=z, k_g2=z), w_self=0.0, w_obst=0.0, w_goal=0.0,
        dof_prior=replace(sampler.dof, q_i2=z, k_s2=z, k_g2=z), temperature=1e30,
        step_size=1.0)
    means = state.particle_means.reshape(p, -1).contiguous()
    d = torch.stack([fused_panda_step(step, means, seed=3000 + k)[0] - means
                     for k in range(40)]).double()  # [seeds, P, M]
    n = d.shape[0] * d.shape[1]
    want_var = (step.weight_t.double() ** 2).sum(0) / s
    ratio = float((d.var(dim=(0, 1)) / want_var).median())
    z_max = float((d.mean(dim=(0, 1)).abs() / (want_var / n).sqrt()).max())
    if not 0.85 < ratio < 1.15:
        fail(f"K6 Philox: median variance ratio {ratio:.4f} outside (0.85, 1.15)")
    if not z_max < 5.0:
        fail(f"K6 Philox: a lane mean is {z_max:.2f} standard errors from 0")
    return dict(var_ratio_median=ratio, max_lane_mean_z=z_max)


def link_fields_check(dev) -> dict:
    """K7 and K8 against float64 oracles at config 5's 1.30 M points (the
    planner-regime rows and rows drawn across the joint limits of the K4
    check, two spheres on links), K7 also at config 4's strided ``[160, 63,
    9, 3]`` view; and K8 per point against K7 on ``chain.fk_compact``
    positions of the same joint angles."""
    from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (
        fk_link_fields_cost,
        fk_link_fields_cost_plain,
        fused_link_fields_cost,
        fused_link_fields_cost_plain,
    )

    _, cost, state, obs, s = panda_problem(dev)
    fields = cost.costs[1]
    chain = fields.chain
    rows = _field_check_rows(state, s, dev)
    b, t, _ = rows.shape
    q = rows[..., :7].reshape(-1, 7)  # [B * T, 7], a strided view
    positions = chain.fk_compact(q).positions  # [B * T, L, 3]
    pos = positions.reshape(b, t, -1, 3)[:, 1:]  # what FusedLinkFieldsCost passes: a view
    spheres = _spheres_on_links(obs["obstacle_spheres"], pos)
    kw = dict(margin=fields.margin, w_self=1.0 / fields.sigma_self**2,
              w_obst=1.0 / fields.sigma_coll**2)
    sp64 = spheres.double()

    def rel_to(got, want):
        return float(((got.double() - want).abs() / want.abs()).max())

    k7 = fused_link_fields_cost(pos, spheres, **kw)
    k7_rel = rel_to(k7, fused_link_fields_cost_plain(pos.double(), sp64, **kw))
    k8 = fk_link_fields_cost(chain, q, spheres, **kw)
    want8 = fk_link_fields_cost_plain(chain, q.double(), sp64, **kw)
    k8_rel = rel_to(k8, want8)
    k8_k7 = rel_to(k8, fused_link_fields_cost(positions, spheres, **kw).double())
    # config 4's main-path size: planner-regime rows around config 4's means
    _, _, state4, obs4, s4 = panda4_problem(dev)
    rows4 = _planner_rows(state4.particle_means, s4, 0.05, 6, dev)
    b4, t4, _ = rows4.shape
    pos4 = chain.fk_compact(rows4[..., :7].reshape(-1, 7)).positions.reshape(b4, t4, -1, 3)[:, 1:]
    sp4 = obs4["obstacle_spheres"].reshape(-1, 4)
    k7_4 = fused_link_fields_cost(pos4, sp4, **kw)
    want7_4 = fused_link_fields_cost_plain(pos4.double(), sp4.double(), **kw)
    k7_4_rel = rel_to(k7_4, want7_4)
    torch.cuda.synchronize()
    for name, r in (("K7", k7_rel), ("K7 at config 4", k7_4_rel), ("K8", k8_rel),
                    ("K8 against K7", k8_k7)):
        if not r <= K4_RTOL:
            fail(f"{name} differs from its reference by {r:.3g} relative (> {K4_RTOL})")
    if not (torch.isfinite(k7).all() and torch.isfinite(k8).all()):
        fail("K7/K8: non-finite output")
    n_links, n_obst = pos.shape[-2], spheres.shape[0]
    ops = (n_links * (n_links - 1) // 2 + n_links * n_obst) * 10  # K4_OPS_PER_POINT less FK
    k7_kernel = lambda: fused_link_fields_cost(pos4, sp4, **kw)  # noqa: E731
    k7_plain = lambda: fused_link_fields_cost_plain(pos4, sp4, **kw)  # noqa: E731
    big_kernel = lambda: fused_link_fields_cost(pos, spheres, **kw)  # noqa: E731
    k8_kernel = lambda: fk_link_fields_cost(chain, q, spheres, **kw)  # noqa: E731
    k8_plain = lambda: fk_link_fields_cost_plain(chain, q, spheres, **kw)  # noqa: E731
    n4, n_big, n_q = pos4.shape[0] * pos4.shape[1], pos.shape[0] * pos.shape[1], q.shape[0]
    return {
        "K7": dict(points=n_big, max_rel=k7_rel, config4_points=n4, config4_max_rel=k7_4_rel,
                   max_abs_err=float((k7_4.double() - want7_4).abs().max()),
                   ms=cuda_ms(k7_kernel, 200), plain_ms=cuda_ms(k7_plain, 50),
                   device_ms=device_ms(k7_kernel, 100), plain_device_ms=device_ms(k7_plain, 20),
                   big_ms=cuda_ms(big_kernel, 20), big_device_ms=device_ms(big_kernel, 10),
                   bound=bound(n4 * (12 * n_links + 4), n4 * ops),
                   big_bound=bound(n_big * (12 * n_links + 4), n_big * ops)),
        "K8": dict(points=n_q, max_rel=k8_rel, k7_rel=k8_k7,
                   max_abs_err=float((k8.double() - want8).abs().max()),
                   ms=cuda_ms(k8_kernel, 20), plain_ms=cuda_ms(k8_plain, 5),
                   device_ms=device_ms(k8_kernel, 10), plain_device_ms=device_ms(k8_plain, 3),
                   bound=bound(n_q * (4 * q.shape[1] + 4), n_q * K4_OPS_PER_POINT)),
    }


def link_fields_layouts_check(dev) -> dict:
    """K7 against the float64 oracle on config 4's rows (half planner
    regime, half across the joint limits, two spheres on links): the
    layouts ``chain.fk_compact`` positions contiguous and sliced ``[:, 1:]``
    (the main path's) and ``chain.fk``'s homogeneous poses sliced ``[...,
    :3, -1]``; all 9 links (the unrolled instantiation) and the first 5 (the
    runtime-L one, each launch counted in ``.generic_launches``); with the
    spheres, with none, and with ``w_self = 0``."""
    from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (
        fused_link_fields_cost,
        fused_link_fields_cost_plain,
    )

    _, cost, state4, obs4, s4 = panda4_problem(dev)
    fields = cost.costs[1]
    chain = fields.chain
    rows = _field_check_rows(state4, s4, dev)
    b, t, _ = rows.shape
    q = rows[..., :7].reshape(-1, 7)
    compact = chain.fk_compact(q).positions.reshape(b, t, -1, 3)
    homogeneous = chain.fk(q).reshape(b, t, -1, 4, 4)
    layouts = {"contiguous": compact.contiguous(), "[:, 1:]": compact[:, 1:],
               "[..., :3, -1]": homogeneous[:, 1:, :, :3, -1]}
    spheres = _spheres_on_links(obs4["obstacle_spheres"], compact[:, 1:])
    w_self, w_obst = 1.0 / fields.sigma_self**2, 1.0 / fields.sigma_coll**2
    weights = {"spheres": (spheres, w_self, w_obst), "no spheres": (None, w_self, 0.0),
               "w_self = 0": (spheres, 0.0, w_obst)}
    generic0, cases, generic_cases, worst = fused_link_fields_cost.generic_launches, 0, 0, {}
    for lname, pos in layouts.items():
        for n_links in (9, 5):
            view = pos[..., :n_links, :]
            for wname, (sp, ws, wo) in weights.items():
                kw = dict(margin=fields.margin, w_self=ws, w_obst=wo)
                want = fused_link_fields_cost_plain(
                    view.double(), None if sp is None else sp.double(), **kw)
                floor = K7_FLOOR * max(ws, wo)
                got = fused_link_fields_cost(view, sp, **kw).double()
                rel = float(((got - want).abs() / want.abs().clamp_min(floor)).max())
                key = f"{lname}, L = {n_links}, {wname}"
                worst[key] = rel
                if not (torch.isfinite(got).all() and rel <= K4_RTOL):
                    fail(f"K7-layouts: {key}: {rel:.3g} relative from the float64 oracle "
                         f"(> {K4_RTOL})")
                cases += 1
                generic_cases += int(n_links != 9)
    generic = fused_link_fields_cost.generic_launches - generic0
    if generic != generic_cases:
        fail(f"K7-layouts: {generic} generic launches, expected {generic_cases} (L = 5)")
    return dict(cases=cases, points=b * (t - 1), generic_launches=generic,
                generic_cases=generic_cases, max_rel=max(worst.values()), worst=worst)


def panda4_main_path(dev) -> dict:
    """Config 4 through its four routes, ``PANDA4_ITERS`` iterations each
    from the same straight-line means: (a) the fused K6 loop, and through
    ``StochGPMP`` (b) the fast stack, (c) the reference-shaped stack and (d)
    the same with ``FusedLinkFieldsCost``."""
    from stoch_gpmp_tpu_torch.costs import CostComposite, FusedLinkFieldsCost
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step import fused_panda_optimize
    from stoch_gpmp_tpu_torch.planners import StochGPMP, stoch_gpmp_optimize
    from stoch_gpmp_tpu_torch.problems import PANDA_DT, PANDA_START_Q

    sampler, fast, state, obs, s = panda4_problem(dev)
    _, ref, _, _, _ = panda4_problem(dev, fast=False)
    stacks = {"b": fast, "c": ref, "d": CostComposite.create(
        ref.n_dof, ref.traj_len,
        [ref.costs[0], ref.costs[1], FusedLinkFieldsCost.create(ref.n_dof, ref.traj_len),
         ref.costs[4]], fk=ref.fk)}
    p, t, n = state.particle_means.shape[0], PANDA4["traj_len"], 7
    means0 = state.particle_means
    start_q = torch.tensor(PANDA_START_Q, device=dev)
    dq = fast.costs[0].dof_form
    goals = torch.cat([dq.g_pd[..., 0], dq.g_pd[..., 1]], dim=-1)
    names = ("fk_fields", "fused_panda_step", "link_fields", "fk_fields_points")
    counters = {k: fn for k, fn in kernel_counters().items() if k in names}
    expect = {"a": "fused_panda_step", "b": "fk_fields", "c": None, "d": "link_fields"}

    def cost_of(means):
        return float(fast.eval(means, observation=obs).mean())

    c0 = cost_of(means0)
    step = make_flat_step(sampler, fast, obs, p, s)
    out = {}
    for route in ("a", "b", "c", "d"):
        gen = torch.Generator(device=dev).manual_seed(0)
        if route != "a":
            planner = StochGPMP(
                num_particles_per_goal=PANDA4["ppg"], num_samples=s, traj_len=t, dt=PANDA_DT,
                n_dof=n, opt_iters=PANDA4_ITERS, temperature=PANDA_TAU, step_size=PANDA_STEP,
                start_state=torch.cat([start_q, torch.zeros_like(start_q)]),
                multi_goal_states=goals, initial_particle_means=means0, cost=stacks[route],
                sigma_start_sample=1e-3, sigma_goal_sample=0.07, sigma_gp_sample=0.1, seed=0,
                dtype=torch.float32, device=dev)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "a":
            means = fused_panda_optimize(step, means0, gen, PANDA4_ITERS)
        else:
            res = planner.optimize(observation=obs)
            means = planner.particle_means
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        generic = generic_walks(counters)
        want = {k: PANDA4_ITERS if k == expect[route] else 0 for k in names}
        if launches != want:
            fail(f"panda4 ({route}): launches {launches}, expected {want}")
        if any(generic.values()):
            fail(f"panda4 ({route}): generic launches {generic}: the Panda takes the "
                 "specialised FK walk and K7's unrolled 9 links")
        if route != "a":
            shapes = [tuple(o.shape) for o in res]
            if shapes != [(p, t, n), (p, t, n), (p, s, t, n), (p, s, t, n), (p, s), (p, t, 2 * n)]:
                fail(f"panda4 ({route}): unexpected 6-tuple shapes {shapes}")
            if not all(bool(torch.isfinite(o).all()) for o in res):
                fail(f"panda4 ({route}): non-finite output")
        if not bool(torch.isfinite(means).all()):
            fail(f"panda4 ({route}): non-finite means")
        c1 = cost_of(means)
        start_err = float((means[:, 0, :n] - start_q).abs().max())
        if not c1 < c0 or start_err > PANDA_START_TOL:
            fail(f"panda4 ({route}): mean cost {c0:.6g} -> {c1:.6g}, start moved {start_err:.3g}")
        if route == "a":
            window = lambda: fused_panda_optimize(step, means, gen, 20)  # noqa: E731
        else:
            window = lambda: stoch_gpmp_optimize(  # noqa: E731
                planner.sampler, stacks[route], planner.state, obs, opt_iters=20,
                num_samples=s, temperature=PANDA_TAU, step_size=PANDA_STEP)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) / 20 * 1e3
        dev_ms, top, ops = device_breakdown(window, 1)
        if route == "a":
            loop_gate("panda4 (a)", ops / 20)
        out[route] = dict(
            top_kernels_ms_per_iter=[(k, ms / 20) for k, ms in top], launches=launches,
            generic_launches=generic, device_ops_per_iter=ops / 20,
            cost0=c0, cost=c1, start_err=start_err, optimize_seconds=seconds,
            updates_per_s=p * PANDA4_ITERS / seconds, iter_wall_ms=wall,
            iter_device_ms=None if dev_ms is None else dev_ms / 20,
            device_busy=None if dev_ms is None else dev_ms / 20 / wall)
        if route == "b":
            means_b = means
    drop = {r: c0 - out[r]["cost"] for r in out}
    if not drop["a"] > PANDA_DESCENT_SHARE * drop["b"]:
        fail(f"panda4: the K6 loop's descent {drop['a']:.6g} not above {PANDA_DESCENT_SHARE} x "
             f"the fast stack's {drop['b']:.6g}")
    want = fast.eval(means_b, observation=obs).double()
    stack_rel = {r: float(((stacks[r].eval(means_b, observation=obs).double() - want).abs()
                           / want.abs()).max()) for r in ("c", "d")}
    if max(stack_rel.values()) > STACK_RTOL:
        fail(f"panda4: stacks (c), (d) differ from (b) on its means by {stack_rel} (> {STACK_RTOL})")
    out["stack_rel"] = stack_rel
    return out


def k9_loop(dev) -> dict:
    """K9's loop, ``fused_planar_optimize`` (one seed pair per particle, all
    drawn up front), for ``ITERS`` iterations at parity from the straight
    lines, as the JAX package's tests/test_fused_step_tpu.py drives it:
    the main path's goal and start gates."""
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import fused_planar_optimize

    step, state = make_step(dev, per_particle=True)
    means0 = state.particle_means
    p = means0.shape[0]
    gen = torch.Generator(device=dev).manual_seed(1)
    counters = {k: fn for k, fn in kernel_counters().items()
                if k in ("fused_planar_step", "fused_planar_step_per_particle")}
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means = fused_planar_optimize(step, means0, gen, ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if launches != {"fused_planar_step": 0, "fused_planar_step_per_particle": ITERS}:
        fail(f"K9 loop: launches {launches}")
    goal_err, start_err = planar_gates("K9 loop", means)
    busy, _, ops = device_breakdown(lambda: fused_planar_optimize(step, means0, gen, 50), 1)
    iter_ms = 1e3 * seconds / ITERS
    loop_gate("K9 loop", ops / 50)
    return dict(launches=launches, goal_err=goal_err, start_err=start_err,
                updates_per_s=p * ITERS / seconds, iter_wall_ms=iter_ms,
                device_ops_per_iter=ops / 50,
                iter_device_ms=None if busy is None else busy / 50,
                device_busy=None if busy is None else busy / 50 / iter_ms)


def _edge_points(k, dev):
    """``k [N, 2]`` points and their float32 neighbours on both sides."""
    return torch.cat([k, torch.nextafter(k, torch.full_like(k, 1e9)),
                      torch.nextafter(k, torch.full_like(k, -1e9)),
                      torch.tensor([[50.0, -50.0], [-1e6, 1e6]], device=dev)])


def _cell_edges(dev):
    """The 0.1-cell edges over [-11, 11]^2 (the planar map and past it),
    their float32 neighbours and two off-map points (``_edge_points``)."""
    k = torch.arange(-110, 111, device=dev, dtype=torch.float32) * 0.1
    return _edge_points(torch.stack(torch.meshgrid(k, k, indexing="ij"), -1).reshape(-1, 2),
                        dev)


def _primitive_edges(pfield, dev):
    """The rectangles' corners and the circles' rims (at 0, 90, 180 and 270
    degrees) of ``pfield`` and their float32 neighbours (``_edge_points``)."""
    r, c = pfield.rects, pfield.circles
    sx, sy = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev), torch.tensor(
        [1.0, 1.0, -1.0, -1.0], device=dev)
    corners = torch.stack([r[:, None, 0] + sx * 0.5 * r[:, None, 2],
                           r[:, None, 1] + sy * 0.5 * r[:, None, 3]], -1).reshape(-1, 2)
    ux, uy = torch.tensor([1.0, -1.0, 0.0, 0.0], device=dev), torch.tensor(
        [0.0, 0.0, 1.0, -1.0], device=dev)
    rims = torch.stack([c[:, None, 0] + ux * c[:, None, 2],
                        c[:, None, 1] + uy * c[:, None, 2]], -1).reshape(-1, 2)
    return _edge_points(torch.cat([corners, rims]), dev)


def field2d_check(dev) -> dict:
    """K10 and K11 vs their plain versions, exact, at the planner's strided
    ``[1920, 63, 2]`` slice plus off-map points, cell edges (K10) and
    primitive boundaries (K11); K10 on the map's grid and on a random
    200 x 200 grid. Timed at that shape and at ``BIG_POINTS``."""
    from stoch_gpmp_tpu_torch.ops.kernels.fields import (
        grid_lookup,
        grid_lookup_plain,
        primitive_field_cost,
        primitive_field_cost_plain,
    )
    from stoch_gpmp_tpu_torch.problems import build_planar_cost

    _, gfield = build_planar_cost(dtype=torch.float32, device=dev, fast=False, field="grid")
    _, pfield = build_planar_cost(dtype=torch.float32, device=dev, fast=False,
                                  field="primitive")
    gen = torch.Generator(device=dev).manual_seed(0)
    view = (torch.rand((PPG * 3 * S, T, 4), generator=gen, device=dev) * 22 - 11)[:, 1:, :2]
    big = (torch.rand((BIG_POINTS // T, T, 4), generator=gen, device=dev) * 22 - 11)[..., :2]
    cell_edges = _cell_edges(dev)
    r, c = pfield.rects, pfield.circles
    prim_edges = _primitive_edges(pfield, dev)
    rand_grid = torch.rand((200, 200), generator=gen, device=dev)
    cases = {
        "K10": (grid_lookup, grid_lookup_plain,
                [(g, pts, 0.1) for g in (gfield.grid, rand_grid) for pts in (view, cell_edges)]),
        "K11": (primitive_field_cost, primitive_field_cost_plain,
                [(r, c, pts) for pts in (view, prim_edges)]),
    }
    out = {}
    for name, (kernel, plain, arg_sets) in cases.items():
        for args in arg_sets:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{name} differs from its plain version at {int((got != want).sum())} of "
                     f"{want.numel()} points")
        args = arg_sets[0]
        big_args = args[:-1] + (big,) if name == "K11" else (args[0], big, args[2])
        n, n_prims = view.shape[0] * view.shape[1], r.shape[0] + c.shape[0]
        grid_bytes = 4 * gfield.grid.numel() if name == "K10" else 4 * (4 * r.shape[0]
                                                                       + 3 * c.shape[0])
        ops = 0.0 if name == "K10" else 6.0 * n_prims
        out[name] = dict(
            points=n, edge_points=(cell_edges if name == "K10" else prim_edges).shape[0],
            max_abs_err=0.0, ms=cuda_ms(lambda: kernel(*args), 200),
            plain_ms=cuda_ms(lambda: plain(*args), 50),
            device_ms=device_ms(lambda: kernel(*args), 100),
            queued_ms=queued_ms(lambda: kernel(*args)),
            plain_device_ms=device_ms(lambda: plain(*args), 20),
            big_points=BIG_POINTS, big_ms=cuda_ms(lambda: kernel(*big_args), 50),
            big_device_ms=device_ms(lambda: kernel(*big_args), 20),
            big_queued_ms=queued_ms(lambda: kernel(*big_args)),
            bound=bound(12 * n + grid_bytes, ops * n),
            big_bound=bound(12 * BIG_POINTS + grid_bytes, ops * BIG_POINTS),
            hits=int((kernel(*args) > 0).sum()))
    return out


def _raster_rim_circles(field, dev):
    """Circles of K1's ``field`` that put snapped cells exactly on their rim
    and one float inside and outside it: about each circle's centre, for the
    cells nearest its rim at 16 angles, three circles of radius ``d`` (the
    cell's distance, rounded as the plain version rounds it) and ``d``'s two
    float32 neighbours; then radii 0, -0, -1, the smallest float, inf and
    NaN about a cell's centre."""
    c, cs = field.circles, field.cell_size
    ang = torch.arange(16, device=dev) * (torch.pi / 8)
    jc = torch.round((c[:, None, 0] + c[:, None, 2] * torch.cos(ang)) / cs)
    ic = torch.round((c[:, None, 1] + c[:, None, 2] * torch.sin(ang)) / cs)
    dx, dy = jc * cs - c[:, None, 0], ic * cs - c[:, None, 1]
    d = torch.sqrt(dx * dx + dy * dy)
    radii = torch.stack([d, torch.nextafter(d, torch.zeros_like(d)),
                         torch.nextafter(d, torch.full_like(d, float("inf")))], -1)
    centres = c[:, None, None, :2].expand(-1, 16, 3, 2)
    rims = torch.cat([centres, radii[..., None]], -1).reshape(-1, 3)
    special = torch.tensor([[0.0, 0.0, r] for r in (0.0, -0.0, -1.0, 1e-45, float("inf"),
                                                   float("nan"))], device=dev)
    return torch.cat([rims, special]).contiguous()


def field_shapes_check(dev, kname: str) -> dict:
    """K1, K10 or K11 (``kname``) equal to its plain version
    (``torch.equal``) away from the planner's view: point counts that are no
    multiple of the points a thread takes or of a CTA's (512, K10 256); views
    whose coordinates are not 8-byte aligned pairs (odd strides, a coordinate
    stride of 2: the scalar loads); edge points (``_cell_edges`` for K1 and
    K10, the primitives' corners and rims for K11); and ``BIG_POINTS`` with
    those edge points inside. K1 and K11 also with no rectangles, no circles
    or neither; K1 also on circles with cells on their rims and with special
    radii (``_raster_rim_circles``); K10 also on grids with an odd side
    ([37, 200], [200, 37]), a [1, 1] grid and a random one."""
    from stoch_gpmp_tpu_torch.ops.kernels.fields import (
        grid_lookup,
        grid_lookup_plain,
        primitive_field_cost,
        primitive_field_cost_plain,
        raster_primitive_cost,
        raster_primitive_cost_plain,
    )
    from stoch_gpmp_tpu_torch.problems import build_planar_cost

    kind = {"K1": "raster", "K10": "grid", "K11": "primitive"}[kname]
    _, field = build_planar_cost(dtype=torch.float32, device=dev, fast=False, field=kind)
    if kname == "K1":
        kw = dict(cell_size=field.cell_size, nx=field.nx, ny=field.ny)
        kernel = lambda ops, p: raster_primitive_cost(*ops, p, **kw)  # noqa: E731
        plain = lambda ops, p: raster_primitive_cost_plain(*ops, p, **kw)  # noqa: E731
        ops = (field.rect_bounds, field.circles)
    elif kname == "K10":
        kernel = lambda ops, p: grid_lookup(*ops, p, field.cell_size)  # noqa: E731
        plain = lambda ops, p: grid_lookup_plain(*ops, p, field.cell_size)  # noqa: E731
        ops = (field.grid,)
    else:
        kernel = lambda ops, p: primitive_field_cost(*ops, p)  # noqa: E731
        plain = lambda ops, p: primitive_field_cost_plain(*ops, p)  # noqa: E731
        ops = (field.rects, field.circles)
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 22 - 11

    edges = _primitive_edges(field, dev) if kname == "K11" else _cell_edges(dev)
    view = rand(PPG * 3 * S, T, 4)[:, 1:, :2]
    big = rand(BIG_POINTS // T, T, 4)[..., :2]
    rows = edges.shape[0] // T  # edge points inside the big view too
    n_in = rows * T
    big[:rows] = edges[:n_in].reshape(rows, T, 2)
    cases = {
        "[7, 13, 2]": (ops, rand(7, 13, 2)), "[1, 1, 2]": (ops, rand(1, 1, 2)),
        "[1001, 2]": (ops, rand(1001, 2)), "[3, 171, 2]": (ops, rand(3, 171, 2)),
        "odd strides [1920, 63, 5][..., 1:3]": (ops, rand(1920, 63, 5)[..., 1:3]),
        "coordinate stride 2": (ops, rand(64, 63, 6)[..., 1:5:2]),
        "edge points": (ops, edges),
        f"BIG_POINTS [{BIG_POINTS // T}, {T}, 2] with {n_in} edge points": (ops, big),
    }
    if kname in ("K1", "K11"):
        r, c = ops
        cases.update({"R = 0": ((r[:0], c), view), "C = 0": ((r, c[:0]), view),
                      "R = C = 0": ((r[:0], c[:0]), view)})
    if kname == "K1":
        cases["circle rims, special radii"] = ((r, _raster_rim_circles(field, dev)), edges)
    if kname == "K10":
        for shape in ((37, 200), (200, 37), (1, 1)):
            grid = torch.rand(shape, generator=gen, device=dev)
            cases[f"[{shape[0]}, {shape[1]}] grid, edge points"] = ((grid,), edges)
        grid = torch.rand((200, 200), generator=gen, device=dev)
        cases["random [200, 200] grid, planner's view"] = ((grid,), view)
    hits = {}
    for name, (args, pts) in cases.items():
        got, want = kernel(args, pts), plain(args, pts)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{kname}-shapes: {name}: differs from the plain version at "
                 f"{int((got != want).sum())} of {want.numel()} points")
        hits[name] = int((got > 0).sum())
    return dict(cases=len(cases), hits=hits)


def planar_ref_main(dev) -> dict:
    """``StochGPMP`` on the reference-shaped planar stack at parity,
    ``ITERS`` iterations from the straight lines on two routes: (g) the
    occupancy grid (K10) and (p) the analytic primitives (K11)."""
    from stoch_gpmp_tpu_torch.planners import StochGPMP, stoch_gpmp_optimize
    from stoch_gpmp_tpu_torch.problems import DT, GOALS, SAMPLE_SIGMAS, START, build_planar_cost

    s_start, s_gp, s_goal = SAMPLE_SIGMAS
    names = ("raster_field", "grid_lookup", "primitive_field")
    counters = {k: fn for k, fn in kernel_counters().items() if k in names}
    out = {}
    for route, field, kname in (("g", "grid", "grid_lookup"),
                                ("p", "primitive", "primitive_field")):
        cost, _ = build_planar_cost(dtype=torch.float32, device=dev, fast=False, field=field)
        planner = StochGPMP(
            num_particles_per_goal=PPG, num_samples=S, traj_len=T, opt_iters=ITERS, dt=DT,
            n_dof=2, step_size=STEP, temperature=TAU, start_state=START,
            multi_goal_states=GOALS, initial_particle_means="const_vel", cost=cost,
            sigma_start_sample=s_start, sigma_gp_sample=s_gp, sigma_goal_sample=s_goal,
            seed=0, dtype=torch.float32, device=dev)
        p = planner.num_particles
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = planner.optimize()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {k: ITERS if k == kname else 0 for k in names}
        if launches != want:
            fail(f"planar-ref ({route}): launches {launches}, expected {want}")
        goal_err, start_err = planar_gates(f"planar-ref ({route})", planner.particle_means, res)
        window = lambda: stoch_gpmp_optimize(  # noqa: E731
            planner.sampler, cost, planner.state, {}, opt_iters=20, num_samples=S,
            temperature=TAU, step_size=STEP)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) / 20 * 1e3
        dev_ms, top, ops = device_breakdown(window, 1)
        out[route] = dict(
            top_kernels_ms_per_iter=[(k, ms / 20) for k, ms in top], launches=launches,
            device_ops_per_iter=ops / 20,
            goal_err=goal_err, start_err=start_err, optimize_seconds=seconds,
            updates_per_s=p * ITERS / seconds, iter_wall_ms=wall,
            iter_device_ms=None if dev_ms is None else dev_ms / 20,
            device_busy=None if dev_ms is None else dev_ms / 20 / wall)
    return out


def gn_main(dev) -> dict:
    """Gauss-Newton ``GPMP`` on ``build_planar_gpmp_problem(GN_PPG)``:
    ``GN_ITERS`` iterations with ``cholesky`` and with ``woodbury`` from the
    same initial means (the cholesky planner's init-prior draw), then 3
    iterations of ``inverse`` against 3 of ``cholesky``."""
    from stoch_gpmp_tpu_torch.planners import gpmp_optimize
    from stoch_gpmp_tpu_torch.problems import GPMP_GOALS, START, build_planar_gpmp_problem

    first = build_planar_gpmp_problem(GN_PPG, method="cholesky", device=dev)
    init = first.particle_means.clone()
    goals = torch.tensor(GPMP_GOALS, device=dev)[:, None, :2]
    out, means = {}, {}
    for method in ("cholesky", "woodbury"):
        planner = first if method == "cholesky" else build_planar_gpmp_problem(
            GN_PPG, method=method, device=dev, initial_particle_means=init)
        p = planner.num_particles
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vel, pos, costs = planner.optimize(opt_iters=GN_ITERS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernel_counters().items() if fn.launches}
        # one field evaluation per linearisation, one for the returned costs
        if launches != {"grid_lookup": GN_ITERS + 1}:
            fail(f"gn ({method}): launches {launches}, expected grid_lookup {GN_ITERS + 1}")
        if not all(bool(torch.isfinite(o).all()) for o in (vel, pos, costs)):
            fail(f"gn ({method}): non-finite output")
        goal_err = float((pos[:, -1].reshape(2, GN_PPG, 2) - goals).norm(dim=-1).max())
        start_err = float((pos[:, 0] - torch.tensor(START[:2], device=dev)).abs().max())
        if goal_err >= GN_GOAL_TOL or start_err >= GN_START_TOL:
            fail(f"gn ({method}): end points {goal_err:.3g} from the goals, start "
                 f"{start_err:.3g}")
        means[method] = planner.particle_means
        state = planner.state
        window = lambda: gpmp_optimize(  # noqa: E731
            planner.cost, state, {}, opt_iters=10, delta=1e-2, trust_region=False,
            method=method, step_size=0.3, woodbury=planner._wb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) / 10 * 1e3
        dev_ms, top, ops = device_breakdown(window, 1)
        out[method] = dict(
            top_kernels_ms_per_iter=[(k, ms / 10) for k, ms in top], launches=launches,
            device_ops_per_iter=ops / 10,
            goal_err=goal_err, start_err=start_err, mean_cost=float(costs.mean()),
            optimize_seconds=seconds, updates_per_s=p * GN_ITERS / seconds, iter_wall_ms=wall,
            iter_device_ms=None if dev_ms is None else dev_ms / 10,
            device_busy=None if dev_ms is None else dev_ms / 10 / wall)
    diff = float((means["cholesky"] - means["woodbury"]).abs().max())
    three = {}
    for method in ("cholesky", "inverse"):
        planner = build_planar_gpmp_problem(GN_PPG, method=method, device=dev,
                                            initial_particle_means=init)
        planner.optimize(opt_iters=3)
        three[method] = planner.particle_means
    diff3 = float((three["cholesky"] - three["inverse"]).abs().max())
    if not diff <= GN_METHOD_ATOL or not diff3 <= GN_INVERSE3_ATOL:
        fail(f"gn: cholesky vs woodbury means {diff:.3g} (atol {GN_METHOD_ATOL}), vs inverse "
             f"after 3 iterations {diff3:.3g} (atol {GN_INVERSE3_ATOL})")
    out.update(woodbury_vs_cholesky=diff, inverse_vs_cholesky_3=diff3)
    return out


def _s1_prior(d, t, dtype, dev):
    """The long-horizon sampling prior at block size ``d`` (the solver's
    factor; the goal state 9 on every position)."""
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior

    n = d // 2
    return make_gp_prior(n, t, 0.02, [0.0] * d, 1e-3, 3.0, sigma_goal=1e-3,
                         goal_states=[[9.0] * n + [0.0] * n], dtype=dtype, device=dev,
                         materialize_dense=False)


def s1_check(dev) -> dict:
    """S1 against the float64 serial substitution on the same factor and
    against its plain version (both on the card), forward and backward,
    float32 and float64, on ``S1_SHAPES`` planes ``[d, rows, T]`` and on
    ``[15, 32, T, 4]`` batches through ``solve_LT`` (stride-d planes); then
    its times at the main path's shape (``[4, 480, 4096]`` float32,
    backward) beside the plain version, the bound and
    ``torch.linalg.solve_triangular`` against the dense ``L^T``."""
    from stoch_gpmp_tpu_torch.gp.tridiag import BlockBidiagChol
    from stoch_gpmp_tpu_torch.ops.kernels.bidiag_scan import UNROLLED, bidiag_scan, plain_solve

    gen = torch.Generator(device=dev).manual_seed(0)
    cases, worst = [], {}
    for dtype in (torch.float32, torch.float64):
        for d, rows, t in S1_SHAPES:
            prior = _s1_prior(d, t, dtype, dev)
            ps = prior.psolver
            oracle = BlockBidiagChol(prior.chol.diag.double(), prior.chol.lower.double())
            x = torch.randn((d, rows, t), generator=gen, device=dev, dtype=dtype)
            for backward in (False, True):
                g0, s0 = bidiag_scan.generic_launches, bidiag_scan.staged_launches
                got = torch.stack(bidiag_scan(ps, tuple(x), backward=backward))
                if bidiag_scan.generic_launches - g0 != int(d not in UNROLLED):
                    fail(f"S1 [{d}, {rows}, {t}]: {bidiag_scan.generic_launches - g0} runtime-d "
                         f"launches, expected {int(d not in UNROLLED)} (compiled in: {UNROLLED})")
                _s1_load_path(f"[{d}, {rows}, {t}] {str(dtype)[6:]}",
                              bidiag_scan.staged_launches - s0, s1_by_tma(t, dtype))
                plain = torch.stack(plain_solve(ps, tuple(x), backward=backward))
                solve = oracle.solve_LT if backward else oracle.solve_L
                want = solve(x.double().permute(1, 2, 0)).permute(2, 0, 1)
                cases.append(_s1_errors(f"[{d}, {rows}, {t}] {str(dtype)[6:]} "
                                        f"{'backward' if backward else 'forward'}",
                                        dtype, got, plain, want))
            if t in S1_STRIDED and d == 4:
                b = torch.randn((15, 32, t, 4), generator=gen, device=dev, dtype=dtype)
                s0 = bidiag_scan.staged_launches
                got, want = ps.solve_LT(b), oracle.solve_LT(b.double())
                _s1_load_path(f"solve_LT [15, 32, {t}, 4] {str(dtype)[6:]}",
                              bidiag_scan.staged_launches - s0, False)
                plain = torch.stack(plain_solve(ps, tuple(b.unbind(-1)), backward=True), -1)
                cases.append(_s1_errors(f"solve_LT [15, 32, {t}, 4] {str(dtype)[6:]}", dtype,
                                        got, plain, want))
    for c in cases:
        key = c["dtype"]
        for k in ("s1_rel", "plain_rel", "s1_vs_plain_rel"):
            worst[f"{key} {k}"] = max(worst.get(f"{key} {k}", 0.0), c[k])
    # times at the main path's shape, float32, backward (the sampling solve)
    d, b, t = S1_MAIN
    prior = _s1_prior(d, t, torch.float32, dev)
    ps = prior.psolver
    x = torch.randn((d, b, t), generator=gen, device=dev)
    out = torch.empty_like(x)
    kernel = lambda: bidiag_scan(ps, tuple(x), backward=True, out=tuple(out))  # noqa: E731
    plain = lambda: plain_solve(ps, tuple(x), backward=True)  # noqa: E731
    # the dense L^T ([M, M], M = T d: 1.07 GB at T = 4096) and the same
    # right-hand sides as [M, b] columns, lane t * d + i: built once,
    # outside the timing
    lt = prior.chol.to_dense().T.contiguous()
    rhs = x.permute(2, 0, 1).reshape(t * d, b).contiguous()
    library = lambda: torch.linalg.solve_triangular(lt, rhs, upper=True)  # noqa: E731
    s0 = bidiag_scan.staged_launches
    kernel()
    _s1_load_path(f"{list(S1_MAIN)} (the main path's solve)", bidiag_scan.staged_launches - s0,
                  True)
    lib_err = float((library().reshape(t, d, b).permute(1, 2, 0) - out).abs().max())
    big = max(float(out.abs().max()), 1e-30)
    if not lib_err <= 2 * S1_RTOL[torch.float32] * big:
        fail(f"S1: solve_triangular against the dense L^T {lib_err:.3g} from S1")
    # each plane read once and written once, the three tables read once;
    # per (b, t): d (d + 1) / 2 + 2 d^2 FMAs
    bd = bound(4 * (2 * d * b * t + 3 * t * d * d), 2 * b * t * (d * (d + 1) // 2 + 2 * d * d))
    phi_max = {n: float(getattr(ps, n).abs().max()) for n in ("phi_fwd", "phi_bwd")}
    return dict(cases=cases, worst=worst, phi_max=phi_max,
                max_abs_err=max(c["s1_vs_plain_abs"] for c in cases if c["dtype"] == "float32"),
                ms=cuda_ms(kernel, 100), plain_ms=cuda_ms(plain, 5),
                device_ms=device_ms(kernel, 50), queued_ms=queued_ms(kernel),
                plain_device_ms=device_ms(plain, 3), library_ms=cuda_ms(library, 5),
                library_err=lib_err, bound=bd)


def s1_by_tma(t: int, dtype) -> bool:
    """Whether S1 moves contiguous ``[d, rows, t]`` planes by TMA: the time
    stride is 1 and a row a whole number of 128-byte lines
    (``csrc/bidiag_scan.cu tma_layout``); else its threads stage them."""
    return t % (128 // (torch.finfo(dtype).bits // 8)) == 0


def _s1_load_path(what: str, staged: int, by_tma: bool) -> None:
    """Fails unless the one launch just made moved its planes by TMA
    (``by_tma``) or by the kernel's threads (counted in
    ``bidiag_scan.staged_launches``)."""
    if staged != int(not by_tma):
        fail(f"S1 {what}: {staged} staged launches, expected {int(not by_tma)} (planes by "
             f"{'TMA' if by_tma else 'the threads'})")


def _s1_errors(what, dtype, got, plain, want) -> dict:
    """S1's and the plain version's errors against the float64 oracle,
    relative to its largest |y|, under S1_RTOL."""
    scale = max(float(want.abs().max()), 1e-30)
    r = dict(case=what, dtype=str(dtype)[6:],
             s1_rel=float((got.double() - want).abs().max()) / scale,
             plain_rel=float((plain.double() - want).abs().max()) / scale,
             s1_vs_plain_abs=float((got - plain).abs().max()))
    r["s1_vs_plain_rel"] = r["s1_vs_plain_abs"] / scale
    tol = S1_RTOL[dtype]
    if not (r["s1_rel"] <= tol and r["plain_rel"] <= tol and r["s1_vs_plain_rel"] <= 2 * tol):
        fail(f"S1 {what}: {r['s1_rel']:.3g} (plain {r['plain_rel']:.3g}) from the float64 "
             f"oracle, {r['s1_vs_plain_rel']:.3g} from the plain version (rtol {tol})")
    return r


@contextlib.contextmanager
def recorded(module, name: str, seen: list):
    """Within the block, ``module.name`` appends each result it returns to
    ``seen``."""
    fn = getattr(module, name)

    def rec(*args, **kw):
        res = fn(*args, **kw)
        seen.append(res)
        return res

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def held_k1(field, seen: list):
    """Within the block, every K1 launch the path makes on ``field`` (the
    ``RasterPrimitive2DField`` of its collision cost) is held against the
    plain version on the same points (``torch.equal``); ``seen`` gets each
    call's point shape, strides and hits."""
    from stoch_gpmp_tpu_torch.ops.kernels.fields import raster_primitive_cost_plain

    kernel = field.compute_cost  # the bound method: K1 on a CUDA tensor

    def held(pts, **kw):
        got = kernel(pts, **kw)
        want = raster_primitive_cost_plain(field.rect_bounds, field.circles, pts,
                                           cell_size=field.cell_size, nx=field.nx, ny=field.ny)
        if not torch.equal(got, want):
            fail(f"K1 on the long-horizon path's points {list(pts.shape)} at strides "
                 f"{list(pts.stride())}: differs from the plain version at "
                 f"{int((got != want).sum())} of {want.numel()} points")
        seen.append(dict(shape=list(pts.shape), strides=list(pts.stride()),
                         hits=int((got > 0).sum())))
        return got

    field.compute_cost = held  # an instance attribute: compute_cost_planes calls it
    try:
        yield
    finally:
        del field.compute_cost


def _serial_s1(solver, x: torch.Tensor, backward: bool) -> torch.Tensor:
    """The float64 serial recurrence of ``solver``'s substitution on planes
    ``x [d, ..., T]``: ``y_t = A_t y_{t-1} + D_t^{-1} b_t`` (forward) or
    ``y_t = A_t y_{t+1} + D_t^{-T} b_t`` (backward), on its transitions
    promoted, one step at a time."""
    dinv = solver.dinv.double()
    a = (solver.a_bwd if backward else solver.a_fwd).double()
    b = x.double().movedim(0, -1)  # [..., T, d]
    t_len = b.shape[-2]
    ys = [None] * t_len
    prev = None
    for t in (range(t_len - 1, -1, -1) if backward else range(t_len)):
        c = b[..., t, :] @ (dinv[t] if backward else dinv[t].T)
        ys[t] = c if prev is None else c + prev @ a[t].T
        prev = ys[t]
    return torch.stack(ys, dim=-2).movedim(-1, 0)


@contextlib.contextmanager
def held_s1(seen: list):
    """Within the block, every solve the path makes through
    ``ParallelBidiagSolver.solve_L`` / ``solve_LT`` (one S1 launch on the
    stride-d planes of a ``[..., T, d]`` tensor) is held against the plain
    version and the float64 serial recurrence on the same planes
    (``_s1_errors`` under S1_RTOL); ``seen`` gets each solve's plane shape,
    strides, direction and errors."""
    from stoch_gpmp_tpu_torch.gp.tridiag import ParallelBidiagSolver
    from stoch_gpmp_tpu_torch.ops.kernels.bidiag_scan import plain_solve

    solve = ParallelBidiagSolver._solve

    def held(self, b, *, backward):
        got = solve(self, b, backward=backward)
        x = b.movedim(-1, 0)  # the d planes, as the solve reads them
        plain = torch.stack(plain_solve(self, tuple(x), backward=backward))
        shape, strides = list(x.shape[1:]), list(x[0].stride())
        err = _s1_errors(f"on the path's planes {shape} at strides {strides}", b.dtype,
                         got.movedim(-1, 0), plain, _serial_s1(self, x, backward))
        seen.append(dict(err, shape=shape, strides=strides, backward=backward))
        return got

    ParallelBidiagSolver._solve = held
    try:
        yield
    finally:
        ParallelBidiagSolver._solve = solve


@contextlib.contextmanager
def plain_kernels():
    """Within the block, S1 and K1 run their plain versions on the card's
    tensors (the wrappers the plane path calls are swapped and restored)."""
    from stoch_gpmp_tpu_torch.ops.kernels import bidiag_scan as s1, fields

    saved = s1.bidiag_scan, fields.raster_primitive_cost
    s1.bidiag_scan, fields.raster_primitive_cost = (s1.plain_solve,
                                                    fields.raster_primitive_cost_plain)
    try:
        yield
    finally:
        s1.bidiag_scan, fields.raster_primitive_cost = saved


def long_horizon_main(dev, t: int) -> dict:
    """``build_long_horizon_problem(t)`` through ``stoch_gpmp_optimize`` on
    the ``"planes"`` route: LH_ITERS iterations after LH_WARMUP, with the
    launch counts, updates/s, a profiled 10-iteration window and the gates;
    then LH_CHECK_ITERS iterations with injected draws through the kernels
    and through their plain versions."""
    from stoch_gpmp_tpu_torch.planners import stoch_gpmp_optimize
    from stoch_gpmp_tpu_torch.planners.stoch_gpmp import _route
    from stoch_gpmp_tpu_torch.problems import (
        LONG_HORIZON,
        LONG_HORIZON_GOALS,
        START,
        build_long_horizon_problem,
    )

    sampler, cost, state = build_long_horizon_problem(t, device=dev)
    if _route(sampler, cost, t) != "planes":
        fail(f"long-horizon T = {t}: route {_route(sampler, cost, t)}, expected planes")
    s, p = LONG_HORIZON["num_samples"], LONG_HORIZON["particles"]
    kw = dict(num_samples=s, temperature=LONG_HORIZON["temperature"],
              step_size=LONG_HORIZON["step_size"])
    state, _ = stoch_gpmp_optimize(sampler, cost, state, {}, opt_iters=LH_WARMUP, **kw)
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, aux = stoch_gpmp_optimize(sampler, cost, state, {}, opt_iters=LH_ITERS, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counters = kernel_counters()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    generic = {k: n for k, n in generic_walks(counters).items() if n}
    staged = counters["bidiag_scan"].staged_launches
    if launches != {"bidiag_scan": LH_ITERS, "raster_field": LH_ITERS} or generic or staged:
        fail(f"long-horizon T = {t}: launches {launches} ({generic} runtime-d or generic, "
             f"{staged} S1 launches without TMA), expected bidiag_scan and raster_field "
             f"{LH_ITERS} each, compiled-in block sizes, every S1 launch by TMA")
    means = state.particle_means
    if not (bool(torch.isfinite(means).all()) and bool(torch.isfinite(aux.costs).all())):
        fail(f"long-horizon T = {t}: non-finite output")
    start_err = float((means[:, 0, :2].cpu() - torch.tensor(START[:2])).abs().max())
    goal_err = float((means[:, -1, :2].cpu() - torch.tensor(LONG_HORIZON_GOALS[0][:2]))
                     .norm(dim=-1).max())
    if not (start_err < LH_TOL and goal_err < LH_TOL):
        fail(f"long-horizon T = {t}: starts {start_err:.3g} from the start, end points "
             f"{goal_err:.3g} from the goal (tol {LH_TOL})")
    window = lambda: stoch_gpmp_optimize(sampler, cost, state, {}, opt_iters=10, **kw)  # noqa: E731
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) / 10 * 1e3
    dev_ms, top, ops = device_breakdown(window, 1, top=10)

    # kernels against their plain versions over LH_CHECK_ITERS iterations
    gen = torch.Generator(device=dev).manual_seed(7)
    eps = torch.randn((LH_CHECK_ITERS, 4, p, s, t), generator=gen, device=dev)
    runs, k1_seen = {}, []
    for name in ("kernel", "plain"):
        st, best, costs = state, [], []
        with plain_kernels() if name == "plain" else held_k1(cost.costs[-1].field, k1_seen):
            for i in range(LH_CHECK_ITERS):
                st, a = stoch_gpmp_optimize(sampler, cost, st, {}, opt_iters=1, eps=eps[i:i + 1],
                                            **kw)
                best.append(a.weights.argmax(dim=1))
                costs.append(a.costs)
        runs[name] = (st.particle_means, torch.stack(best), torch.stack(costs))
    if len(k1_seen) != LH_CHECK_ITERS or any(k["shape"][:-1] != [p * s, t] for k in k1_seen):
        fail(f"long-horizon T = {t}: K1 held on {k1_seen}, expected {LH_CHECK_ITERS} launches "
             f"on [{p * s}, {t}, 2] points")
    ck, cp = runs["kernel"][2], runs["plain"][2]
    cost_rel = (ck - cp).abs() / cp.abs().clamp_min(1e-30)
    off = cost_rel > COST_RTOL
    flips = (ck - cp)[off] / K_COLL
    n_off = int(off.sum())
    if n_off > EDGE_SHARE * cp.numel() or not bool(
            (flips.round() != 0).all() and ((flips - flips.round()).abs() <= 1e-3).all()):
        fail(f"long-horizon T = {t}: kernels vs plain versions: {n_off} of {cp.numel()} costs "
             f"beyond rtol {COST_RTOL}, in multiples of the collision weight {flips.tolist()}")
    agree = (runs["kernel"][1] == runs["plain"][1]).all(dim=0)
    n_agree = int(agree.sum())
    mean_err = float((runs["kernel"][0] - runs["plain"][0]).abs().max())
    if n_agree < p or not mean_err <= MEAN_ATOL:
        fail(f"long-horizon T = {t}: kernels vs plain versions over {LH_CHECK_ITERS} "
             f"iterations: best sample agrees for {n_agree}/{p}, means {mean_err:.3g} apart "
             f"(atol {MEAN_ATOL})")
    return dict(launches=launches, start_err=start_err, goal_err=goal_err,
                optimize_seconds=seconds, updates_per_s=p * LH_ITERS / seconds,
                iter_wall_ms=wall, iter_device_ms=None if dev_ms is None else dev_ms / 10,
                device_ops_per_iter=ops / 10,
                device_busy=None if dev_ms is None else dev_ms / 10 / wall,
                top_kernels_ms_per_iter=[(k, ms / 10) for k, ms in top],
                plain_agree=n_agree, plain_mean_err=mean_err, particles=p, k1_held=k1_seen,
                cost_rel_max_in_tol=float(cost_rel[~off].max()), cost_edge_flips=n_off)


def long_horizon_api(dev) -> dict:
    """At T = 1024 on the card: ``StochGPMP`` ``reset``, ``optimize`` with
    and without ``collect_metrics`` and ``sample_trajectories``, and
    ``GPMP.sample_trajectories``, through the solver sampler (S1); and the
    quadratic stack on the long-horizon sampler, which takes the ``"dof"``
    route (K3)."""
    from stoch_gpmp_tpu_torch.costs import CostComposite, QuadraticCost
    from stoch_gpmp_tpu_torch.planners import GPMP, StochGPMP, stoch_gpmp_optimize
    from stoch_gpmp_tpu_torch.planners.stoch_gpmp import _route
    from stoch_gpmp_tpu_torch.problems import (
        LONG_HORIZON,
        LONG_HORIZON_GOALS,
        START,
        build_long_horizon_problem,
    )

    t, iters = LH_API_T, LH_API_ITERS
    sampler, cost, state = build_long_horizon_problem(t, device=dev)
    sig = dict(sigma_start_init=1e-3, sigma_gp_init=3.0, sigma_goal_init=1e-3,
               sigma_start_sample=1e-3, sigma_gp_sample=3.0, sigma_goal_sample=1e-3)
    common = dict(traj_len=t, opt_iters=iters, dt=0.02, n_dof=2, start_state=START,
                  multi_goal_states=LONG_HORIZON_GOALS, cost=cost, device=dev, **sig)
    p, s = LONG_HORIZON["particles"], LONG_HORIZON["num_samples"]
    reset_counters()
    planner = StochGPMP(num_particles_per_goal=p, num_samples=s,
                        step_size=LONG_HORIZON["step_size"],
                        temperature=LONG_HORIZON["temperature"], **common)
    out = planner.optimize()
    planner.optimize(collect_metrics=True)
    metrics = planner.last_metrics
    pos, vel = planner.sample_trajectories(4)
    planner.reset(start_state=START)
    gn = GPMP(num_particles_per_goal=4, solver_params={
        "delta": 1e-2, "trust_region": False, "method": "cholesky"}, **common)
    gpos, _ = gn.sample_trajectories(4)
    torch.cuda.synchronize()
    shapes = [tuple(o.shape) for o in out] + [tuple(pos.shape), tuple(gpos.shape)]
    want = [(p, t, 2), (p, t, 2), (p, s, t, 2), (p, s, t, 2), (p, s), (p, t, 4), (p, 4, t, 2),
            (4, 4, t, 2)]
    finite = all(bool(torch.isfinite(o).all()) for o in (*out, pos, vel, gpos,
                                                         metrics.cost_mean))
    # init prior draws (two resets), 2 x iters optimize iterations, the
    # trajectory draws, GPMP's init draw and its trajectory draws
    api_launches = {k: fn.launches for k, fn in kernel_counters().items() if fn.launches}
    if (shapes != want or not finite or planner.sampler.psolver is None
            or api_launches.get("bidiag_scan", 0) != 2 * iters + 5):
        fail(f"long-horizon-api: shapes {shapes} (expected {want}), finite {finite}, "
             f"launches {api_launches}")
    start_err = float((gpos[:, :, 0] - torch.tensor(START[:2], device=dev)).abs().max())
    gp, goal, coll = cost.costs
    quad = CostComposite.create(2, t, [QuadraticCost.from_gp_and_goal_prior(gp, goal, t), coll])
    route = _route(sampler, quad, t)
    reset_counters()
    st, aux = stoch_gpmp_optimize(sampler, quad, state, {}, opt_iters=10, num_samples=s,
                                  temperature=1.0, step_size=0.5)
    dof_launches = {k: fn.launches for k, fn in kernel_counters().items() if fn.launches}
    if (route != "dof" or dof_launches != {"dof_quad_eval": 10, "raster_field": 10}
            or not bool(torch.isfinite(st.particle_means).all())):
        fail(f"long-horizon-api: the quadratic stack at T = {t} took route {route}, launches "
             f"{dof_launches}")
    return dict(api_launches=api_launches, gn_start_err=start_err, shapes=shapes,
                quad_route=route, quad_launches=dof_launches)


def _windowed(run, iters: int):
    """Wall ms per iteration of ``run()`` (``iters`` iterations), then the
    same window under the profiler: ``(wall, device ms or None, top kernels,
    operations)``, all per iteration."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters * 1e3
    dev_ms, top, ops = device_breakdown(run, 1)
    return (wall, None if dev_ms is None else dev_ms / iters,
            [(k, ms / iters) for k, ms in top], ops / iters)


def _path_row(wall, dev_ms, top, ops, **extra) -> dict:
    return dict(extra, iter_wall_ms=wall, iter_device_ms=dev_ms, top_kernels_ms_per_iter=top,
                device_ops_per_iter=ops,
                device_busy=None if dev_ms is None else dev_ms / wall)


def panda_example(dev, iters: int = PX_ITERS) -> dict:
    """``examples/panda_environment.py`` on the card: the IK goal (timed;
    its SE(3) distance and the near-best rule in float64 gated), then
    ``StochGPMP`` for ``iters`` iterations in chunks of ``PX_CHUNK`` on (a)
    the reference-shaped stack and (b) the fast stack (K4 once per
    iteration)."""
    from stoch_gpmp_tpu_torch.kinematics import ik
    from stoch_gpmp_tpu_torch.kinematics.se3 import se3_distance
    from stoch_gpmp_tpu_torch.planners import stoch_gpmp_optimize
    from stoch_gpmp_tpu_torch.problems import (
        PANDA_TARGET_POS,
        build_panda_example,
        panda_ik_goal,
    )

    probe = build_panda_example(0, q_goal=torch.zeros(7, device=dev), device=dev)
    chain, target_h, start_q = probe.chain, probe.target_h, probe.start_q
    solved = []  # the 17 solutions the goal was chosen from, as solve_ik returned them
    with recorded(ik, "solve_ik", solved):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q_goal = panda_ik_goal(chain, target_h, start_q, 0)
        torch.cuda.synchronize()
        ik_s = time.perf_counter() - t0
    if len(solved) != 1 or list(solved[0].shape) != [17, 7]:
        fail(f"panda-example: IK solved {[list(q.shape) for q in solved]}, expected one "
             f"batch of 17 starts")
    qs = solved[0].double().cpu()
    errs = se3_distance(chain.ee_pose(qs), target_h.double().cpu())
    q64 = q_goal.double().cpu()
    ik_err = float(se3_distance(chain.ee_pose(q64), target_h.double().cpu()))
    jdist = torch.linalg.norm(qs - start_q.double().cpu(), dim=-1)
    ok = errs <= errs.min() + 0.05 - RULE_SLACK
    chosen_jdist = float(torch.linalg.norm(q64 - start_q.double().cpu()))
    if (not any(torch.equal(q_goal, q) for q in solved[0]) or not ik_err < IK_TOL
            or ik_err > float(errs.min()) + 0.05 + RULE_SLACK
            or (ok.any() and chosen_jdist > float(jdist[ok].min()) + RULE_SLACK)):
        fail(f"panda-example: IK goal {ik_err:.3g} from the target (tol {IK_TOL}), joint "
             f"distance {chosen_jdist:.4g} against the solutions' {errs.tolist()} / "
             f"{jdist.tolist()}, or not one of them")
    target_pos = torch.tensor(PANDA_TARGET_POS, device=dev)
    out = dict(ik_seconds=ik_s, ik_err=ik_err, q_goal=q_goal.tolist(),
               near_best=int(ok.sum()))
    planners = {}
    for route, fast in (("a", False), ("b", True)):
        ex = build_panda_example(0, fast=fast, q_goal=q_goal, device=dev)
        planner, obs = ex.planner, ex.observation
        planners[route] = planner
        p = planner.num_particles
        c0 = float(planner.cost.eval(planner.particle_means, observation=obs).mean())
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, iters, PX_CHUNK):
            res = planner.optimize(opt_iters=min(PX_CHUNK, iters - i), observation=obs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernel_counters().items() if fn.launches}
        generic = generic_walks(kernel_counters())
        want = {"fk_fields": iters} if fast else {}
        if launches != want or any(generic.values()):
            fail(f"panda-example ({route}): launches {launches}, generic {generic}, "
                 f"expected {want}")
        means = planner.particle_means
        if not all(bool(torch.isfinite(o).all()) for o in (*res, means)):
            fail(f"panda-example ({route}): non-finite output")
        c1 = float(planner.cost.eval(means, observation=obs).mean())
        start_err = float((means[:, 0, :7] - start_q).abs().max())
        ee = chain.ee_pose(means[:, -1, :7])[:, :3, 3]
        ee_dist = (ee - target_pos).norm(dim=-1)
        if not c1 < c0 or start_err > PANDA_START_TOL or float(ee_dist.max()) >= PX_EE_TOL:
            fail(f"panda-example ({route}): mean cost {c0:.6g} -> {c1:.6g}, start moved "
                 f"{start_err:.3g}, EE to target {ee_dist.tolist()}")
        state = planner.state
        wall, dev_ms, top, ops = _windowed(lambda: stoch_gpmp_optimize(  # noqa: B023
            planner.sampler, planner.cost, state, obs, opt_iters=10,
            num_samples=planner.num_samples, temperature=1.0, step_size=0.1), 10)
        out[route] = _path_row(wall, dev_ms, top, ops, launches=launches, cost0=c0, cost=c1,
                               start_err=start_err, ee_dist=ee_dist.tolist(),
                               optimize_seconds=seconds, updates_per_s=p * iters / seconds)
    # the two stacks are one function: (a)'s cost on (b)'s final means
    means_b = planners["b"].particle_means
    want = planners["b"].cost.eval(means_b, observation=obs).double()
    got = planners["a"].cost.eval(means_b, observation=obs).double()
    out["stack_rel"] = float(((got - want).abs() / want.abs()).max())
    out["means_apart"] = float((planners["a"].particle_means - means_b).abs().max())
    if not out["stack_rel"] <= STACK_RTOL:
        fail(f"panda-example: stack (a) differs from (b) on (b)'s final means by "
             f"{out['stack_rel']:.3g} (> {STACK_RTOL})")
    return out


def panda_mesh(dev, iters: int = PM_ITERS) -> dict:
    """``benchmarks/success_rate_panda.py``'s planning problem on the card:
    ``iters`` iterations of ``StochGPMP`` on the mesh-sphere stack; then the
    card's mesh and floor fields on the path's own link poses against
    float64 on the CPU, and the share of particles its "clean" rule
    accepts (a figure, not a gate)."""
    from stoch_gpmp_tpu_torch.costs import MeshSphereDistanceField, MeshSphereFloorField
    from stoch_gpmp_tpu_torch.planners import stoch_gpmp_optimize
    from stoch_gpmp_tpu_torch.problems import build_panda_mesh, panda_mesh_clean

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pb = build_panda_mesh(0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    planner, obs, chain = pb.planner, pb.observation, pb.chain
    p, t = planner.num_particles, planner.traj_len
    c0 = float(planner.cost.eval(planner.particle_means, observation=obs).mean())
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = planner.optimize(opt_iters=iters, observation=obs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernel_counters().items() if fn.launches}
    means = planner.particle_means
    if launches or not all(bool(torch.isfinite(o).all()) for o in (*res, means)):
        fail(f"panda-mesh: launches {launches} (none expected) or non-finite output")
    c1 = float(planner.cost.eval(means, observation=obs).mean())
    start_err = float((means[:, 0, :7] - pb.start_q).abs().max())
    if not c1 < c0 or start_err > PANDA_START_TOL:
        fail(f"panda-mesh: mean cost {c0:.6g} -> {c1:.6g}, start moved {start_err:.3g}")
    mesh, floor = planner.cost.costs[3].field, planner.cost.costs[4].field
    poses = chain.fk(means[..., :7].reshape(-1, 7)).reshape(p, t, -1, 4, 4)
    sp = obs["obstacle_spheres"]
    mesh64 = MeshSphereDistanceField.for_panda(chain, dtype=torch.float64)
    p64 = poses.double().cpu()
    rel = {}
    for name, got, want in (
            ("mesh", mesh.compute_cost(poses, sp), mesh64.compute_cost(p64, sp.double().cpu())),
            ("floor", floor.compute_cost(poses), MeshSphereFloorField(mesh=mesh64).compute_cost(p64))):
        err = (got.double().cpu() - want).abs()
        if not bool((err <= PM_ATOL + PM_RTOL * want.abs()).all()):
            fail(f"panda-mesh: the {name} field on the card {float(err.max()):.3g} from "
                 f"float64 (rtol {PM_RTOL}, atol {PM_ATOL})")
        rel[name] = float((err / want.abs().clamp_min(PM_ATOL)).max())
    clean = panda_mesh_clean(chain, means, pb.spheres)
    state = planner.state
    wall, dev_ms, top, ops = _windowed(lambda: stoch_gpmp_optimize(
        planner.sampler, planner.cost, state, obs, opt_iters=10,
        num_samples=planner.num_samples, temperature=1.0, step_size=0.1), 10)
    return _path_row(wall, dev_ms, top, ops, build_seconds=build_s, cost0=c0, cost=c1,
                     start_err=start_err, field_rel=rel, clean_share=float(clean.double().mean()),
                     optimize_seconds=seconds, updates_per_s=p * iters / seconds)


def schur_margins(diag: torch.Tensor, lower: torch.Tensor) -> dict:
    """How close a float32 block-tridiagonal system ``(diag [..., T, d, d],
    lower [..., T-1, d, d])`` is to a factor that float32 cannot take: the
    block Cholesky in float64 on the blocks promoted and, step for step as
    ``BlockTridiag.cholesky`` takes it, in float32. Per system (leading
    dimensions flattened), lists of: ``margin``, the smallest over t of
    lambda_min(S_t) / (eps ||B_t||_2), where S_t = B_t - L_t L_t^T is the
    float64 Schur complement, B_t the block before the subtraction and eps
    float32's; ``block``, the t where it is smallest; ``first_bad``, the
    first t whose float32 Schur complement is not positive definite (None
    when none is); ``err``, ||S_t^32 - S_t||_2 / (eps ||B_t||_2) at
    ``first_bad``, else at ``block``. An ``err`` above the ``margin`` means
    float32 rounding alone can carry the smallest eigenvalue across zero."""
    eps = torch.finfo(torch.float32).eps
    diag, lower = diag.reshape(-1, *diag.shape[-3:]), lower.reshape(-1, *lower.shape[-3:])
    margins, errs, bad = [], [], []
    d32 = d64 = None
    for t in range(diag.shape[1]):
        b32 = diag[:, t]
        s32, s64 = b32, b32.double()
        if t:
            c = lower[:, t - 1]
            l32 = torch.linalg.solve_triangular(d32, c.mT, upper=False).mT
            l64 = torch.linalg.solve_triangular(d64, c.double().mT, upper=False).mT
            s32, s64 = b32 - l32 @ l32.mT, s64 - l64 @ l64.mT
        scale = eps * torch.linalg.matrix_norm(b32.double(), ord=2)
        margins.append(torch.linalg.eigvalsh(s64)[:, 0] / scale)
        errs.append(torch.linalg.matrix_norm(s32.double() - s64, ord=2) / scale)
        d32, info = torch.linalg.cholesky_ex(s32)
        bad.append(info != 0)
        d64 = torch.linalg.cholesky_ex(s64)[0]
    margin, err, bad = (torch.stack(v, -1).cpu() for v in (margins, errs, bad))
    out = dict(margin=[], block=[], first_bad=[], err=[])
    for m, e, b in zip(margin, err, bad):
        first = int(b.nonzero()[0]) if bool(b.any()) else None
        at = int(m.argmin())
        out["margin"].append(float(m[at]))
        out["block"].append(at)
        out["first_bad"].append(first)
        out["err"].append(float(e[at if first is None else first]))
    return out


def _gn_pair_64(build) -> float:
    """One ``woodbury`` and one ``cholesky`` step in float64 on the card from
    the same initial means (``build(method)`` -> a ``GPMP``, its init draw
    seeded alike): fails beyond GN64_RTOL / GN64_ATOL; returns the largest
    ``|woodbury - cholesky|``."""
    got = {}
    for method in ("cholesky", "woodbury"):
        planner, obs = build(method)
        got[method] = (planner.particle_means.clone(), planner)
        planner.optimize(opt_iters=1, observation=obs)
    init_c, pc = got["cholesky"]
    init_w, pw = got["woodbury"]
    if not torch.equal(init_c, init_w):
        fail("float64 GN pair: the two planners drew different initial means")
    a, b = pw.particle_means, pc.particle_means
    if not bool(((a - b).abs() <= GN64_ATOL + GN64_RTOL * b.abs()).all()):
        fail(f"float64 GN pair: woodbury {float((a - b).abs().max()):.3g} from cholesky "
             f"(rtol {GN64_RTOL}, atol {GN64_ATOL})")
    return float((a - b).abs().max())


def gn_float32_witness(dev) -> dict:
    """``schur_margins`` of ``build_panda_gpmp``'s float32 problem, built on
    the card and on the CPU: its first Gauss-Newton system (at the initial
    means, delta added) and the precision of the planner's own init prior
    (no goal), with whether that prior's float32 factor and the planner's
    own init draw (``GPMP.reset()`` without means) are finite."""
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
    from stoch_gpmp_tpu_torch.problems import build_panda_gpmp

    out = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        pb = build_panda_gpmp(0, device=device)
        pl = pb.planner
        c = pl.cost.gn_contrib(pl.particle_means, observation=pb.observation)
        eye = torch.eye(c.diag.shape[-1], dtype=c.diag.dtype, device=device)
        prior = make_gp_prior(pl.n_dof, pl.traj_len, pl.dt, pl.start_state,
                              pl.sigma_start_init, pl.sigma_gp_init, dtype=pl.dtype,
                              device=device)
        pl.reset()
        out[where] = dict(
            gn=schur_margins(c.diag + float(pl.solver_params["delta"]) * eye, c.lower),
            init=schur_margins(prior.precision.diag, prior.precision.lower),
            init_factor_finite=bool(torch.isfinite(prior.chol.diag).all()),
            init_draw_finite=bool(torch.isfinite(pl.particle_means).all()))
    return out


def panda_gn(dev, iters: int = PG_ITERS) -> dict:
    """Gauss-Newton ``GPMP`` on the Panda through FK (``build_panda_gpmp``):
    ``iters`` iterations of ``cholesky`` and of ``woodbury`` in float64
    (gated and timed), the same in float32 one iteration at a time as a
    probe (the first iteration whose means are not finite, or None, and the
    time; not gated), then the float64 pair of one step each."""
    from stoch_gpmp_tpu_torch.kinematics.se3 import se3_distance
    from stoch_gpmp_tpu_torch.planners import gpmp_optimize
    from stoch_gpmp_tpu_torch.problems import build_panda_gpmp

    out = {}
    for method in ("cholesky", "woodbury"):
        pb = build_panda_gpmp(0, method=method, dtype=torch.float64, device=dev)
        planner, obs = pb.planner, pb.observation

        def ee_dist(m):
            return float(se3_distance(pb.chain.ee_pose(m[:, -1, :7]), pb.target_h).mean())

        d0 = ee_dist(planner.particle_means)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vel, pos, costs = planner.optimize(opt_iters=iters, observation=obs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernel_counters().items() if fn.launches}
        means = planner.particle_means
        d1 = ee_dist(means)
        start_err = float((means[:, 0, :7] - pb.start_q).abs().max())
        if (launches or not all(bool(torch.isfinite(o).all()) for o in (vel, pos, costs))
                or not d1 < d0 or start_err > PG_START_TOL):
            fail(f"panda-gn ({method}): launches {launches}, EE distance {d0:.4g} -> {d1:.4g}, "
                 f"start moved {start_err:.3g}")
        state = planner.state
        wall, dev_ms, top, ops = _windowed(lambda: gpmp_optimize(  # noqa: B023
            planner.cost, state, obs, opt_iters=5, delta=1e-2, trust_region=False,
            method=method, step_size=0.2, woodbury=planner._wb), 5)
        probe = build_panda_gpmp(0, method=method, device=dev)
        first_nan = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            probe.planner.optimize(opt_iters=1, observation=probe.observation)
            if first_nan is None and not bool(torch.isfinite(probe.planner.particle_means).all()):
                first_nan = i + 1
        f32_seconds = time.perf_counter() - t0
        out[method] = _path_row(wall, dev_ms, top, ops, ee_dist0=d0, ee_dist=d1,
                                start_err=start_err, mean_cost=float(costs.mean()),
                                optimize_seconds=seconds,
                                updates_per_s=planner.num_particles * iters / seconds,
                                float32_first_nonfinite=first_nan,
                                float32_updates_per_s=planner.num_particles * iters / f32_seconds)

    def build64(method):
        pb = build_panda_gpmp(0, method=method, dtype=torch.float64, device=dev)
        return pb.planner, pb.observation

    out["woodbury_vs_cholesky_64"] = _gn_pair_64(build64)
    out["float32_witness"] = gn_float32_witness(dev)
    return out


def gn_long(dev, iters: int = GNL_ITERS) -> dict:
    """Gauss-Newton past M = 2048: ``build_long_horizon_gpmp(GNL_T)``,
    ``iters`` iterations of ``cholesky`` and of ``woodbury`` with S1 (the
    init draw) and K1 (each linearisation and the returned costs) counted,
    every launch of both held against its plain version on the path's own
    inputs (``held_s1``, ``held_k1``); an un-held window of one iteration
    for the times; then the float64 pair of one step each."""
    from stoch_gpmp_tpu_torch.planners import gpmp_optimize
    from stoch_gpmp_tpu_torch.problems import START, build_long_horizon_gpmp

    out = {}
    for method in ("cholesky", "woodbury"):
        reset_counters()
        s1_seen, k1_seen = [], []
        with held_s1(s1_seen):
            planner = build_long_horizon_gpmp(GNL_T, method=method, device=dev)
        p = planner.num_particles
        with held_k1(planner.cost.costs[-1].field, k1_seen):
            vel, pos, costs = planner.optimize(opt_iters=iters)
        launches = {k: fn.launches for k, fn in kernel_counters().items() if fn.launches}
        staged = kernel_counters()["bidiag_scan"].staged_launches
        want = {"bidiag_scan": 1, "raster_field": iters + 1}
        if launches != want:
            fail(f"gn-long ({method}): launches {launches}, expected {want}")
        # the init draw: L^{-T} eps on [1, P, T, 4] through its stride-4 planes
        if len(s1_seen) != 1 or not s1_seen[0]["backward"] or s1_seen[0]["shape"] != [1, p, GNL_T]:
            fail(f"gn-long ({method}): S1 held on {s1_seen}, expected the init draw's one "
                 f"backward solve on [1, {p}, {GNL_T}] planes")
        # the collision cost reads steps 1..T-1
        if len(k1_seen) != iters + 1 or any(k["shape"][:-1] != [p, GNL_T - 1] for k in k1_seen):
            fail(f"gn-long ({method}): K1 held on {k1_seen}, expected {iters + 1} launches on "
                 f"[{p}, {GNL_T - 1}, 2] points")
        start_err = float((pos[:, 0] - torch.tensor(START[:2], device=dev)).abs().max())
        if (not all(bool(torch.isfinite(o).all()) for o in (vel, pos, costs))
                or start_err > PG_START_TOL):
            fail(f"gn-long ({method}): non-finite output or start moved {start_err:.3g}")
        state = planner.state
        wall, dev_ms, top, ops = _windowed(lambda: gpmp_optimize(  # noqa: B023
            planner.cost, state, {}, opt_iters=1, delta=float(planner.solver_params["delta"]),
            trust_region=False, method=method, step_size=0.5, woodbury=planner._wb), 1)
        out[method] = _path_row(wall, dev_ms, top, ops, launches=launches, staged=staged,
                                start_err=start_err, mean_cost=float(costs.mean()),
                                s1_held=s1_seen, k1_held=len(k1_seen),
                                updates_per_s=p / wall * 1e3)

    def build64(method):
        return build_long_horizon_gpmp(GNL_T, method=method, with_obstacles=False,
                                       dtype=torch.float64, device=dev), {}

    out["woodbury_vs_cholesky_64"] = _gn_pair_64(build64)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", default=None, help="write the nvcc log and details here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one NVIDIA GPU")
    # imported only now: a directory without the package fails here
    from stoch_gpmp_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    phase("device", f"{name} | torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    if torch.backends.cuda.matmul.allow_tf32 is not False:
        fail("torch.backends.cuda.matmul.allow_tf32 must be False")
    if torch.get_float32_matmul_precision() != "highest":
        fail("the float32 matmul precision must be 'highest'")

    t0 = time.perf_counter()
    _build.load_library()
    phase("build", f"{len(_build.build_info)} sources, nvcc sm_90a in parallel, "
                   f"{time.perf_counter() - t0:.1f} s")
    for src, info in _build.build_info.items():
        used = [ln.split(":", 1)[-1].strip() for ln in info["log"].splitlines()
                if "Used" in ln or "spill" in ln]
        phase("ptxas", f"{src}: {' | '.join(used) or info['log']}")
    details = {"device": name, "nvidia_smi": smi, "build": _build.build_info}

    k1 = raster_check(dev)
    phase("K1", f"raster field exact on {k1['points']} + {k1['edge_points']} edge points; "
                f"per call kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms; device "
                f"time kernel {fmt_ms(k1['device_ms'])} (queued {fmt_ms(k1['queued_ms'])}), "
                f"plain {fmt_ms(k1['plain_device_ms'])}")
    shapes = {"K1": field_shapes_check(dev, "K1")}
    phase("K1-shapes", f"raster field equal to its plain version in {shapes['K1']['cases']} "
                       "cases: " + ", ".join(f"{k} ({v} hits)"
                                            for k, v in shapes["K1"]["hits"].items()))
    k2 = {b: fused_check(dev, b) for b in ("matmul", "stencil")}
    for b, r in k2.items():
        timing = "" if "ms" not in r else (
            f"; per call kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; device time "
            f"kernel {fmt_ms(r['device_ms'])}, plain {fmt_ms(r['plain_device_ms'])}")
        phase("K2", f"{b}: costs within rtol {r['cost_max_rel']:.2e} (+{r['edge_flips']} "
                    f"edge flips), best sample agrees {r['argmax_agree']}/{r['particles']}, "
                    f"means max err {r['max_abs_err']:.2e}{timing}")
    k2_split = split_check(dev, "K2")
    phase("K2", split_line(k2["matmul"], k2_split, smi))
    mom = moments_check(dev)
    phase("K2-philox", f"variance ratio median {mom['var_ratio_median']:.4f}, "
                       f"max lane mean {mom['max_lane_mean']:.4f}")
    mp = main_path(dev)
    phase("main", f"{ITERS} iters: launches {mp['launches']}, goal err {mp['goal_err']:.3f}, "
                  f"start err {mp['start_err']:.2e}; optimize {mp['optimize_updates_per_s']:.0f} "
                  f"updates/s; fused loop kernel {mp['loop_updates_per_s_kernel']:.0f} vs plain "
                  f"{mp['loop_updates_per_s_plain']:.0f} updates/s; kernel loop "
                  f"{mp['loop_iter_wall_ms']:.4f} ms/iter, device time "
                  f"{fmt_ms(mp['loop_iter_device_ms'])}/iter in "
                  f"{mp['loop_device_ops_per_iter']:.2f} device operations, device busy "
                  f"{'not measured' if mp['loop_device_busy'] is None else format(mp['loop_device_busy'], '.1%')}"
                  f" on {smi}")
    k3 = dof_quad_check(dev)
    phase("K3", f"dof stencil energy on {k3['rows']} rows within {k3['max_rel']:.2e} relative "
                f"of the float64 oracle (rtol {K3_RTOL}); per call kernel {k3['ms']:.4f} ms, "
                f"plain {k3['plain_ms']:.4f} ms; device time kernel {fmt_ms(k3['device_ms'])}, "
                f"plain {fmt_ms(k3['plain_device_ms'])}; bound {k3['bound'][0]:.4f} ms")
    k4 = fk_fields_check(dev)
    phase("K4", f"FK + fields on {k4['points']} points within {k4['max_rel']:.2e} relative of "
                f"the float64 oracle (rtol {K4_RTOL}), flat entry {k4['flat_rel']:.1e} from "
                f"the plane entry; per call kernel {k4['ms']:.4f} ms, plain {k4['plain_ms']:.4f}"
                f" ms; device time kernel {fmt_ms(k4['device_ms'])}, plain "
                f"{fmt_ms(k4['plain_device_ms'])}; bound {k4['bound'][0]:.4f} ms "
                f"({k4['bound'][1]}); specialised FK walk on {smi}")
    fkg = fk_generic_check(dev)
    phase("K4-generic", f"generic FK walk on a chain with an x-axis and a prismatic joint: K4 "
                        f"on {fkg['trajectories']} trajectories within {fkg['k4_max_rel']:.2e}, "
                        f"K8 on {fkg['points']} configurations within {fkg['k8_max_rel']:.2e} "
                        f"relative of the float64 oracle (rtol {K4_RTOL})")
    fkg.update(fused_generic_walk_check(dev))
    phase("K4-generic", f"generic FK walk in the fused kernels on a tilted Panda, eps operand "
                        f"against the plain versions: K5 costs within "
                        f"{fkg['k5_cost_max_rel']:.2e}, means {fkg['k5_mean_max_err']:.2e}; K6 "
                        f"costs within {fkg['k6_cost_max_rel']:.2e}, means "
                        f"{fkg['k6_mean_max_err']:.2e} (rtol {K5_COST_RTOL}, atol "
                        f"{K5_MEAN_ATOL})")
    k5 = fused_dof_check(dev)
    ln = k5["launch"]
    phase("K5", f"eps operand: costs within {k5['cost_max_rel']:.2e} relative (rtol "
                f"{K5_COST_RTOL}), best sample agrees {k5['argmax_agree']}/{k5['particles']}, "
                f"means max err {k5['max_abs_err']:.2e}; per call kernel {k5['ms']:.4f} ms, "
                f"plain {k5['plain_ms']:.4f} ms; device time kernel {fmt_ms(k5['device_ms'])},"
                f" plain {fmt_ms(k5['plain_device_ms'])}; bound {k5['bound'][0]:.4f} ms "
                f"({k5['bound'][1]}), non-zero work {k5['nonzero_bound'][0]:.4f} ms; "
                f"{ln['ctas']} persistent CTAs of {ln['threads']} threads, {ln['smem_bytes']} B "
                f"of shared memory, {ln['ctas_per_sm']} per SM, W's zero half skipped: "
                f"{ln['triangular']}, FK variant {ln['variant']} on {smi}")
    k5_split = fused_dof_split_check(dev)
    phase("K5-split", f"seed mode at {k5_split['ctas']} persistent CTAs against "
                      f"{k5_split['particles']} (one particle each): costs equal, new means "
                      f"within {k5_split['mean_max_err']:.2e} (atol {SPLIT_MEAN_ATOL})")
    phase("K5-dense", f"dense instantiation: on the prior's W equal to the last bit to the one "
                      f"that skips its zeros; on a W without them costs within "
                      f"{k5_split['dense_cost_max_rel']:.2e} relative of the plain version, best "
                      f"sample agrees {k5_split['dense_argmax_agree']}/{k5_split['particles']}, "
                      f"means max err {k5_split['dense_mean_max_err']:.2e}")
    k5_shapes = fused_dof_shapes_check(dev)
    for k, r in k5_shapes.items():
        ln = r["launch"]
        phase("K5-shapes", f"{k}, eps operand: costs within {r['cost_max_rel']:.2e} relative, "
                           f"best sample agrees {r['argmax_agree']}/{r['particles']}, means max "
                           f"err {r['mean_max_err']:.2e}; {ln['threads']} threads, "
                           f"{ln['smem_bytes']} B of shared memory, W's zero half skipped: "
                           f"{ln['triangular']}, FK variant {ln['variant']}")
    k5_free = fused_dof_rng_free_check(dev)
    phase("K5-rng-free", " | ".join(
        f"{k}: costs within {v['max_rel']:.2e} relative, means moved {v['means_moved']:.1e}"
        for k, v in k5_free.items()))
    k5_mom = fused_dof_moments_check(dev)
    phase("K5-philox", f"variance ratio median {k5_mom['var_ratio_median']:.4f}, largest lane "
                       f"mean {k5_mom['max_lane_mean_z']:.2f} standard errors")
    pm = panda_main_path(dev)
    for k, r in pm.items():
        busy = "not measured" if r["device_busy"] is None else format(r["device_busy"], ".1%")
        phase("panda-main", f"{k}: {PANDA_ITERS} iters, launches {r['launches']}, generic FK "
                            f"walks {r['generic_launches']}, mean cost "
                            f"{r['cost0']:.6g} -> {r['cost']:.6g}, start err {r['start_err']:.2e};"
                            f" {r['updates_per_s']:.0f} updates/s over optimize(); 20-iteration"
                            f" window {r['iter_wall_ms']:.4f} ms/iter wall, device time "
                            f"{fmt_ms(r['iter_device_ms'])}/iter in "
                            f"{r['device_ops_per_iter']:.2f} device operations, device busy "
                            f"{busy} on {smi}")
        phase("panda-main", f"{k}: device ms per iteration by kernel: " + "; ".join(
            f"{n} {ms:.4f}" for n, ms in r["top_kernels_ms_per_iter"]))
    k6 = fused_flat_check(dev)
    phase("K6", f"eps operand: costs within {k6['cost_max_rel']:.2e} relative (rtol "
                f"{K5_COST_RTOL}), best sample agrees {k6['argmax_agree']}/{k6['particles']}, "
                f"means max err {k6['max_abs_err']:.2e}; per call kernel {k6['ms']:.4f} ms, "
                f"plain {k6['plain_ms']:.4f} ms; device time kernel {fmt_ms(k6['device_ms'])},"
                f" plain {fmt_ms(k6['plain_device_ms'])}; bound {k6['bound'][0]:.4f} ms "
                f"({k6['bound'][1]}), {k6['bound_on_sms_ms']:.4f} ms on the "
                f"{k6['ctas_launched']} SMs its CTAs occupy")
    k6_split = split_check(dev, "K6")
    phase("K6", split_line(k6, k6_split, smi))
    k6_free = fused_flat_rng_free_check(dev)
    phase("K6-rng-free", " | ".join(
        f"{k}: costs within {v['max_rel']:.2e} relative, means moved {v['means_moved']:.1e}"
        for k, v in k6_free.items()))
    k6_mom = fused_flat_moments_check(dev)
    phase("K6-philox", f"variance ratio median {k6_mom['var_ratio_median']:.4f}, largest lane "
                       f"mean {k6_mom['max_lane_mean_z']:.2f} standard errors")
    lf = link_fields_check(dev)
    k7, k8 = lf["K7"], lf["K8"]
    phase("K7", f"link fields on {k7['points']} points within {k7['max_rel']:.2e} relative of "
                f"the float64 oracle, on config 4's {k7['config4_points']} within "
                f"{k7['config4_max_rel']:.2e} (rtol {K4_RTOL}); config 4: per call kernel "
                f"{k7['ms']:.4f} ms, plain {k7['plain_ms']:.4f} ms; device time kernel "
                f"{fmt_ms(k7['device_ms'])}, plain {fmt_ms(k7['plain_device_ms'])}; bound "
                f"{k7['bound'][0]:.4f} ms ({k7['bound'][1]}); {k7['points']} points: per call "
                f"{k7['big_ms']:.4f} ms, device {fmt_ms(k7['big_device_ms'])}, bound "
                f"{k7['big_bound'][0]:.4f} ms ({k7['big_bound'][1]})")
    k7_layouts = link_fields_layouts_check(dev)
    for key, rel in k7_layouts["worst"].items():
        phase("K7-layouts", f"{key}: within {rel:.2e} relative of the float64 oracle "
                            f"(rtol {K4_RTOL})")
    phase("K7-layouts", f"{k7_layouts['cases']} launches on {k7_layouts['points']} points, "
                        f"{k7_layouts['generic_launches']} through the runtime link count "
                        f"(expected {k7_layouts['generic_cases']})")
    phase("K8", f"FK + fields on {k8['points']} configurations within {k8['max_rel']:.2e} "
                f"relative of the float64 oracle and {k8['k7_rel']:.2e} of K7 on fk_compact "
                f"positions (rtol {K4_RTOL}); per call kernel {k8['ms']:.4f} ms, plain "
                f"{k8['plain_ms']:.4f} ms; device time kernel {fmt_ms(k8['device_ms'])}, plain "
                f"{fmt_ms(k8['plain_device_ms'])}; bound {k8['bound'][0]:.4f} ms "
                f"({k8['bound'][1]})")
    p4 = panda4_main_path(dev)
    for k in ("a", "b", "c", "d"):
        r = p4[k]
        busy = "not measured" if r["device_busy"] is None else format(r["device_busy"], ".1%")
        phase("panda4-main", f"({k}): {PANDA4_ITERS} iters, launches {r['launches']}, generic "
                             f"FK walks {r['generic_launches']}, mean cost "
                             f"{r['cost0']:.6g} -> {r['cost']:.6g}, start err "
                             f"{r['start_err']:.2e}; {r['updates_per_s']:.0f} updates/s over "
                             f"{'the K6 loop' if k == 'a' else 'optimize()'}; 20-iteration "
                             f"window {r['iter_wall_ms']:.4f} ms/iter wall, device time "
                             f"{fmt_ms(r['iter_device_ms'])}/iter in "
                             f"{r['device_ops_per_iter']:.2f} device operations, device busy "
                             f"{busy} on {smi}")
        phase("panda4-main", f"({k}): device ms per iteration by kernel: " + "; ".join(
            f"{n} {ms:.4f}" for n, ms in r["top_kernels_ms_per_iter"]))
    phase("panda4-main", "stacks (c), (d) on route (b)'s means: " + ", ".join(
        f"({k}) within {v:.2e} relative of (b)" for k, v in p4["stack_rel"].items())
        + f" (rtol {STACK_RTOL})")
    k9 = {b: fused_check(dev, b, per_particle=True) for b in ("matmul", "stencil")}
    for b, r in k9.items():
        timing = "" if "ms" not in r else (
            f"; per call kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; device time "
            f"kernel {fmt_ms(r['device_ms'])}, plain {fmt_ms(r['plain_device_ms'])}")
        phase("K9", f"{b}: costs within rtol {r['cost_max_rel']:.2e} (+{r['edge_flips']} "
                    f"edge flips), best sample agrees {r['argmax_agree']}/{r['particles']}, "
                    f"means max err {r['max_abs_err']:.2e}{timing}")
    k9_split = split_check(dev, "K9")
    phase("K9", split_line(k9["matmul"], k9_split, smi))
    k9_mom = moments_check(dev, per_particle=True)
    phase("K9-philox", f"per-particle seeds: variance ratio median "
                       f"{k9_mom['var_ratio_median']:.4f}, max lane mean "
                       f"{k9_mom['max_lane_mean']:.4f}")
    k9_run = k9_loop(dev)
    busy = ("not measured" if k9_run["device_busy"] is None
            else format(k9_run["device_busy"], ".1%"))
    phase("K9-loop", f"fused_planar_optimize {ITERS} iters: launches {k9_run['launches']}, "
                     f"goal err {k9_run['goal_err']:.3f}, start err {k9_run['start_err']:.2e}; "
                     f"{k9_run['updates_per_s']:.0f} updates/s, {k9_run['iter_wall_ms']:.4f} "
                     f"ms/iter wall, device time {fmt_ms(k9_run['iter_device_ms'])}/iter in "
                     f"{k9_run['device_ops_per_iter']:.2f} device operations, device busy "
                     f"{busy} on {smi}")
    f2 = field2d_check(dev)
    for kname, what in (("K10", "grid lookup"), ("K11", "primitive field")):
        r = f2[kname]
        phase(kname, f"{what} exact on {r['points']} + {r['edge_points']} edge points "
                     f"({r['hits']} hits); per call kernel {r['ms']:.4f} ms, plain "
                     f"{r['plain_ms']:.4f} ms; device time kernel {fmt_ms(r['device_ms'])} "
                     f"(queued {fmt_ms(r['queued_ms'])}), plain {fmt_ms(r['plain_device_ms'])}; "
                     f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]}); {r['big_points']} "
                     f"points: per call {r['big_ms']:.4f} ms, device "
                     f"{fmt_ms(r['big_device_ms'])} (queued {fmt_ms(r['big_queued_ms'])}), "
                     f"bound {r['big_bound'][0]:.5f} ms ({r['big_bound'][1]})")
    for kname, what in (("K10", "grid lookup"), ("K11", "primitive field")):
        shapes[kname] = r = field_shapes_check(dev, kname)
        phase(f"{kname}-shapes", f"{what} equal to its plain version in {r['cases']} cases: "
                                 + ", ".join(f"{k} ({v} hits)" for k, v in r["hits"].items()))
    pr = planar_ref_main(dev)
    for k, r in pr.items():
        busy = "not measured" if r["device_busy"] is None else format(r["device_busy"], ".1%")
        phase("planar-ref-main", f"({k}): {ITERS} iters, launches {r['launches']}, goal err "
                                 f"{r['goal_err']:.3f}, start err {r['start_err']:.2e}; "
                                 f"{r['updates_per_s']:.0f} updates/s over optimize(); "
                                 f"20-iteration window {r['iter_wall_ms']:.4f} ms/iter wall, "
                                 f"device time {fmt_ms(r['iter_device_ms'])}/iter in "
                                 f"{r['device_ops_per_iter']:.0f} device operations, device "
                                 f"busy {busy} on {smi}")
        phase("planar-ref-main", f"({k}): device ms per iteration by kernel: " + "; ".join(
            f"{n} {ms:.4f}" for n, ms in r["top_kernels_ms_per_iter"]))
    gn = gn_main(dev)
    for k in ("cholesky", "woodbury"):
        r = gn[k]
        busy = "not measured" if r["device_busy"] is None else format(r["device_busy"], ".1%")
        phase("gn-main", f"{k}: {GN_ITERS} iters at P = {2 * GN_PPG}, launches "
                         f"{r['launches']}, goal err {r['goal_err']:.2e}, start err "
                         f"{r['start_err']:.2e}, mean cost {r['mean_cost']:.6g}; "
                         f"{r['updates_per_s']:.0f} particle-updates/s over optimize(); "
                         f"10-iteration window {r['iter_wall_ms']:.4f} ms/iter wall, device "
                         f"time {fmt_ms(r['iter_device_ms'])}/iter in "
                         f"{r['device_ops_per_iter']:.0f} device operations, device busy {busy} "
                         f"on {smi}")
        phase("gn-main", f"{k}: device ms per iteration by kernel: " + "; ".join(
            f"{n} {ms:.4f}" for n, ms in r["top_kernels_ms_per_iter"]))
    phase("gn-main", f"means: woodbury vs cholesky {gn['woodbury_vs_cholesky']:.2e} (atol "
                     f"{GN_METHOD_ATOL}), inverse vs cholesky after 3 iterations "
                     f"{gn['inverse_vs_cholesky_3']:.2e} (atol {GN_INVERSE3_ATOL})")
    sc = s1_check(dev)
    for c in sc["cases"]:
        phase("S1", f"{c['case']}: S1 {c['s1_rel']:.2e}, plain {c['plain_rel']:.2e} relative "
                    f"from the float64 serial oracle, S1 vs plain {c['s1_vs_plain_abs']:.2e} "
                    f"absolute ({c['s1_vs_plain_rel']:.2e} relative; rtol "
                    f"{S1_RTOL[getattr(torch, c['dtype'])]:g})")
    phase("S1", f"{list(S1_MAIN)} float32 backward: per call kernel {sc['ms']:.4f} ms, plain "
                f"{sc['plain_ms']:.4f} ms; device time kernel {fmt_ms(sc['device_ms'])} "
                f"(queued {fmt_ms(sc['queued_ms'])}), plain {fmt_ms(sc['plain_device_ms'])}; "
                f"bound {sc['bound'][0]:.4f} ms ({sc['bound'][1]}); solve_triangular against "
                f"the dense L^T {sc['library_ms']:.4f} ms ({sc['library_err']:.2e} from S1); "
                f"largest |phi| entry {sc['phi_max']} on {smi}")
    lh = {t: long_horizon_main(dev, t) for t in LH_HORIZONS}
    for t, r in lh.items():
        busy = "not measured" if r["device_busy"] is None else format(r["device_busy"], ".1%")
        phase("long-horizon-main", f"T = {t}: {LH_ITERS} iters, launches {r['launches']}, goal "
                                   f"err {r['goal_err']:.2e}, start err {r['start_err']:.2e}; "
                                   f"{r['updates_per_s']:.1f} updates/s over optimize(); "
                                   f"10-iteration window {r['iter_wall_ms']:.4f} ms/iter wall, "
                                   f"device time {fmt_ms(r['iter_device_ms'])}/iter in "
                                   f"{r['device_ops_per_iter']:.0f} device operations, device "
                                   f"busy {busy} on {smi}")
        phase("long-horizon-main", f"T = {t}: device ms per iteration by kernel: " + "; ".join(
            f"{n} {ms:.4f}" for n, ms in r["top_kernels_ms_per_iter"]))
        k1h = r["k1_held"][0]
        phase("long-horizon-main", f"T = {t}: {LH_CHECK_ITERS} iterations with the same draws, "
                                   f"kernels vs plain versions on the card: K1 equal to its plain "
                                   f"version on the path's {LH_CHECK_ITERS} point sets "
                                   f"{k1h['shape']} at strides {k1h['strides']} "
                                   f"({[k['hits'] for k in r['k1_held']]} points hit); costs "
                                   f"within {r['cost_rel_max_in_tol']:.2e} relative (rtol "
                                   f"{COST_RTOL}) but {r['cost_edge_flips']} cell-edge flips; "
                                   f"best sample agrees for {r['plain_agree']}/{r['particles']} "
                                   f"particles, means within {r['plain_mean_err']:.2e} (atol "
                                   f"{MEAN_ATOL})")
    api = long_horizon_api(dev)
    phase("long-horizon-api", f"T = {LH_API_T}: StochGPMP reset / optimize / optimize(collect_metrics)"
                              f" / sample_trajectories and GPMP.sample_trajectories: shapes "
                              f"{api['shapes']}, launches {api['api_launches']}, GPMP draws' "
                              f"start err {api['gn_start_err']:.2e}; the quadratic stack takes "
                              f"route {api['quad_route']}, launches {api['quad_launches']}")
    px = panda_example(dev)
    phase("panda-example", f"IK goal from 16 starts + q_init, 150 iterations: "
                           f"{px['ik_seconds']:.3f} s, SE(3) distance {px['ik_err']:.2e} (tol "
                           f"{IK_TOL}), near-best rule held in float64 ({px['near_best']} "
                           f"solutions within 0.05 of the best)")
    for k in ("a", "b"):
        r = px[k]
        busy = "not measured" if r["device_busy"] is None else format(r["device_busy"], ".1%")
        phase("panda-example", f"({k}): {PX_ITERS} iters in chunks of {PX_CHUNK}, launches "
                               f"{r['launches']}, mean cost {r['cost0']:.6g} -> {r['cost']:.6g}, "
                               f"start err {r['start_err']:.2e}, final EE to target "
                               f"{max(r['ee_dist']):.4f} (tol {PX_EE_TOL}); "
                               f"{r['updates_per_s']:.0f} updates/s over optimize(); "
                               f"10-iteration window {r['iter_wall_ms']:.4f} ms/iter wall, device "
                               f"time {fmt_ms(r['iter_device_ms'])}/iter in "
                               f"{r['device_ops_per_iter']:.0f} device operations, device busy "
                               f"{busy} on {smi}")
        phase("panda-example", f"({k}): device ms per iteration by kernel: " + "; ".join(
            f"{n} {ms:.4f}" for n, ms in r["top_kernels_ms_per_iter"]))
    phase("panda-example", f"stack (a) on (b)'s final means within {px['stack_rel']:.2e} "
                           f"relative of (b) (rtol {STACK_RTOL}); the two runs' final means "
                           f"{px['means_apart']:.3g} apart (a figure, not a gate)")
    pmesh = panda_mesh(dev)
    busy = ("not measured" if pmesh["device_busy"] is None
            else format(pmesh["device_busy"], ".1%"))
    phase("panda-mesh", f"{PM_ITERS} iters, mean cost {pmesh['cost0']:.6g} -> {pmesh['cost']:.6g}, "
                        f"start err {pmesh['start_err']:.2e}; mesh / floor fields on the path's "
                        f"link poses within {pmesh['field_rel']['mesh']:.2e} / "
                        f"{pmesh['field_rel']['floor']:.2e} relative of float64 (rtol {PM_RTOL}); "
                        f"clean particles {pmesh['clean_share']:.2f}; build with IK "
                        f"{pmesh['build_seconds']:.3f} s; {pmesh['updates_per_s']:.0f} updates/s "
                        f"over optimize(); 10-iteration window {pmesh['iter_wall_ms']:.4f} "
                        f"ms/iter wall, device time {fmt_ms(pmesh['iter_device_ms'])}/iter in "
                        f"{pmesh['device_ops_per_iter']:.0f} device operations, device busy "
                        f"{busy} on {smi}")
    phase("panda-mesh", "device ms per iteration by kernel: " + "; ".join(
        f"{n} {ms:.4f}" for n, ms in pmesh["top_kernels_ms_per_iter"]))
    pg = panda_gn(dev)
    gl = gn_long(dev)
    for path, res, iters in (("panda-gn", pg, PG_ITERS), ("gn-long", gl, GNL_ITERS)):
        for k in ("cholesky", "woodbury"):
            r = res[k]
            busy = "not measured" if r["device_busy"] is None else format(r["device_busy"], ".1%")
            if path == "panda-gn":
                extra = f"float64, EE distance {r['ee_dist0']:.4g} -> {r['ee_dist']:.4g}"
                rate = "over optimize()"
            else:
                h = r["s1_held"][0]
                extra = (f"launches {r['launches']} (staged S1 {r['staged']}), each held: S1 "
                         f"(the init draw, planes {h['shape']} at strides {h['strides']}) "
                         f"{h['s1_rel']:.2e} from the float64 recurrence (plain "
                         f"{h['plain_rel']:.2e}, rtol {S1_RTOL[torch.float32]}), "
                         f"{r['k1_held']} K1 launches equal to plain")
                rate = "over the un-held window"
            phase(path, f"{k}: {iters} iters, {extra}, start err {r['start_err']:.2e}, mean cost "
                        f"{r['mean_cost']:.6g}; {r['updates_per_s']:.1f} particle-updates/s {rate}; "
                        f"window {r['iter_wall_ms']:.3f} ms/iter wall, device time "
                        f"{fmt_ms(r['iter_device_ms'])}/iter in {r['device_ops_per_iter']:.0f} "
                        f"device operations, device busy {busy} on {smi}")
            phase(path, f"{k}: device ms per iteration by kernel: " + "; ".join(
                f"{n} {ms:.4f}" for n, ms in r["top_kernels_ms_per_iter"]))
        if path == "panda-gn":
            phase(path, "float32 probe, one iteration per call: " + "; ".join(
                f"{k} first non-finite means at iteration {res[k]['float32_first_nonfinite']}, "
                f"{res[k]['float32_updates_per_s']:.1f} particle-updates/s"
                for k in ("cholesky", "woodbury")))
            for where, w in res["float32_witness"].items():
                phase(path, f"float32 witness built on the {where} (seed 0): " + "; ".join(
                    f"{name}: smallest Schur eigenvalue {fmt_list(w[name]['margin'])} x eps "
                    f"||B_t|| at blocks {w[name]['block']}, float32 Schur error "
                    f"{fmt_list(w[name]['err'])} x eps ||B_t||, first float32 block not "
                    f"positive definite {w[name]['first_bad']}"
                    for name in ("gn", "init")) + f"; init factor finite "
                    f"{w['init_factor_finite']}, GPMP's own init draw finite "
                    f"{w['init_draw_finite']}")
        phase(path, f"float64 on the card, one step: woodbury within "
                    f"{res['woodbury_vs_cholesky_64']:.2e} of cholesky (rtol {GN64_RTOL}, atol "
                    f"{GN64_ATOL})")
    details.update(K1=k1, K2=k2, K2_split=k2_split, moments=mom, main=mp, K3=k3, K4=k4,
                   K4_generic=fkg, K5=k5, K5_split=k5_split, K5_shapes=k5_shapes,
                   K5_rng_free=k5_free, K5_moments=k5_mom, panda_main=pm, K6=k6,
                   K6_split=k6_split, K6_rng_free=k6_free, K6_moments=k6_mom, K7=k7,
                   K7_layouts=k7_layouts, K8=k8,
                   panda4_main=p4, K9=k9, K9_split=k9_split, K9_moments=k9_mom,
                   K9_loop=k9_run, K10=f2["K10"], K11=f2["K11"], shapes=shapes,
                   planar_ref_main=pr,
                   gn_main=gn, S1=sc, long_horizon_main=lh, long_horizon_api=api,
                   panda_example=px, panda_mesh=pmesh, panda_gn=pg, gn_long=gl)
    if args.log_dir:
        out = Path(args.log_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(details, indent=1, default=str))

    # bounds of K1 and K2 from this run's shapes: K1 reads 8 bytes and writes
    # 4 per point; K2 multiplies [S, M] by [M, M] twice per particle (matmul
    # branch) and moves means, lin_rows, W, A, the new means and the costs
    m2 = T * 4
    k1_bound = bound(12 * k1["points"], 0.0)
    k2_bound = bound(4 * (3 * 3 * PPG * m2 + 2 * m2 * m2 + 3 * PPG * S),
                     2 * 2 * 3 * PPG * S * m2 * m2)
    record = [
        # K1: the planar main path's launch, long-horizon-main's at T = 4096 and
        # gn-long's (cholesky)
        ("raster_field", "raster_field.cu", "stoch_gpmp_tpu/ops/pallas/fields.py:147",
         mp["launches"]["raster_field"] + lh[LH_HORIZONS[0]]["launches"]["raster_field"]
         + gl["cholesky"]["launches"]["raster_field"], k1, k1_bound),
        ("fused_planar_step", "fused_planar_step.cu",
         "stoch_gpmp_tpu/ops/pallas/fused_step.py:419", mp["launches"]["fused_planar_step"],
         dict(k2["matmul"], max_abs_err=max(r["max_abs_err"] for r in k2.values())), k2_bound),
        ("dof_quad_eval", "dof_quad_eval.cu", "stoch_gpmp_tpu/ops/pallas/stencil.py:242",
         pm["dof"]["launches"]["dof_quad_eval"], k3, k3["bound"]),
        # K4: config 5's dof path and panda-example (b)
        ("fk_fields", "fk_fields.cu", "stoch_gpmp_tpu/ops/pallas/panda_fields.py:325",
         pm["dof"]["launches"]["fk_fields"] + px["b"]["launches"]["fk_fields"], k4, k4["bound"]),
        ("fused_panda_dof_step", "fused_panda_dof_step.cu",
         "stoch_gpmp_tpu/ops/pallas/panda_step_dof.py:225",
         pm["fused"]["launches"]["fused_panda_dof_step"], k5, k5["bound"]),
        ("fused_panda_step", "fused_panda_step.cu", "stoch_gpmp_tpu/ops/pallas/panda_step.py:199",
         p4["a"]["launches"]["fused_panda_step"], k6, k6["bound"]),
        ("link_fields", "link_fields.cu", "stoch_gpmp_tpu/ops/pallas/panda_fields.py:73",
         p4["d"]["launches"]["link_fields"], k7, k7["bound"]),
        # K8 has no caller on any route (nor in the JAX package): 0 launches
        ("fk_fields_points", "fk_fields.cu", "stoch_gpmp_tpu/ops/pallas/panda_fields.py:175",
         sum(p4[r]["launches"]["fk_fields_points"] for r in "abcd"), k8, k8["bound"]),
        # K9 is K2 with one int32 seed pair per particle: K2's work and bytes
        # plus the seeds
        ("fused_planar_step_per_particle", "fused_planar_step.cu",
         "stoch_gpmp_tpu/ops/pallas/fused_step.py:159",
         k9_run["launches"]["fused_planar_step_per_particle"],
         dict(k9["matmul"], max_abs_err=max(r["max_abs_err"] for r in k9.values())),
         bound(4 * (3 * 3 * PPG * m2 + 2 * m2 * m2 + 3 * PPG * S + 2 * 3 * PPG),
               2 * 2 * 3 * PPG * S * m2 * m2)),
        ("grid_lookup", "grid_lookup.cu", "stoch_gpmp_tpu/ops/pallas/fields.py:69",
         pr["g"]["launches"]["grid_lookup"], f2["K10"], f2["K10"]["bound"]),
        ("primitive_field", "primitive_field.cu", "stoch_gpmp_tpu/ops/pallas/fields.py:214",
         pr["p"]["launches"]["primitive_field"], f2["K11"], f2["K11"]["bound"]),
    ]
    record.append(("bidiag_scan", "bidiag_scan.cu",
                   "stoch_gpmp_tpu/gp/tridiag.py:259 (XLA associative_scan)",
                   lh[LH_HORIZONS[0]]["launches"]["bidiag_scan"]
                   + gl["cholesky"]["launches"]["bidiag_scan"], sc, sc["bound"]))
    kernels = [
        {"name": n, "route": "cuda", "source": f"stoch_gpmp_tpu_torch/csrc/{src}",
         "replaces": rep, "launches": launches, "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bd[0], "bound_by": bd[1],
         "library_ms": r.get("library_ms")}
        for n, src, rep, launches, r, bd in record
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
