"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--log-dir DIR]

Phases, one line each; any failure exits non-zero before the result line:

1. the device: its name, ``nvidia-smi``'s name and power limit, and the
   float32 matmul settings (TF32 must be off);
2. build both CUDA kernels from ``stoch_gpmp_tpu_torch/csrc`` with nvcc;
3. K1, the raster collision field, against its plain PyTorch version at the
   planner's shape (a strided ``[1920, 63, 2]`` slice) plus cell-edge and
   off-map points: exact equality;
4. K2, the fused planar iteration, with an eps operand against its plain
   version at the parity shape, matmul branch (parity) and stencil branch
   (goal anchor sigma 1e-5);
5. K2 with in-kernel Philox draws: the update's moments with uniform weights;
6. the main path: ``StochGPMP(fused_kernel=True)`` on the parity problem for
   500 iterations, with launch counts, goal reaching and updates/s of the
   kernel loop beside the same loop with the plain K2 on the card, and the
   device's busy share over a window of the kernel loop.

Times: ``ms``/``plain_ms`` are per call over back-to-back calls through
the wrapper (CUDA events), which includes the host's launch cost where it
exceeds the device's; the device time per call comes from
``torch.profiler``. The line before the last is the kernels' JSON record;
the last line is ``{"ok": true, "device": {...}}``. ``--log-dir`` also
writes the nvcc log and the per-phase details there.
"""

from __future__ import annotations

import argparse
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


def fmt_ms(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


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
    k = torch.arange(-110, 111, device=dev, dtype=torch.float32) * 0.1
    edges = torch.stack(torch.meshgrid(k, k, indexing="ij"), -1).reshape(-1, 2)
    edges = torch.cat([edges, torch.nextafter(edges, torch.full_like(edges, 1e9)),
                       torch.nextafter(edges, torch.full_like(edges, -1e9)),
                       torch.tensor([[50.0, -50.0], [-1e6, 1e6]], device=dev)])
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
                device_ms=device_ms(kernel, 100), plain_device_ms=device_ms(plain, 20))


def make_step(dev, sigma_goal_prior=1e-3, zero_quad=False):
    """K2's step object for the parity problem (or the pure sampler of the
    moments check: quadratic, importance and obstacles removed)."""
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import make_fused_planar_step_batched
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
    step = make_fused_planar_step_batched(
        weight_t=sampler.weight_t, dof_prior=prior, dof_quad=dq,
        num_particles=state.particle_means.shape[0], rect_bounds=rects, circles=circles,
        cell_size=coll.field.cell_size, nx=coll.field.nx, ny=coll.field.ny,
        traj_len=T, state_dim=4, num_samples=S, k_coll=k_coll,
        temperature=tau, step_size=step_size,
    )
    return step, state


def fused_check(dev, branch: str) -> dict:
    """K2 (eps operand) vs its plain version on the card."""
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (
        fused_planar_step,
        fused_planar_step_plain,
    )

    step, state = make_step(dev, sigma_goal_prior=1e-5 if branch == "stencil" else 1e-3)
    if step.use_stencil != (branch == "stencil"):
        fail(f"K2 {branch}: the gate picked the other quadratic")
    p = state.particle_means.shape[0]
    means = state.particle_means.reshape(p, -1).contiguous()
    prec_u = step.dof_prior.matvec_flat(state.particle_means).reshape(p, -1)
    gen = torch.Generator(device=dev).manual_seed(1)
    eps = torch.randn((p, S, means.shape[1]), generator=gen, device=dev)
    new_k, cost_k = fused_planar_step(step, means, prec_u, eps=eps)
    new_p, cost_p = fused_planar_step_plain(step, means, prec_u, eps)
    torch.cuda.synchronize()
    if not (torch.isfinite(cost_k).all() and torch.isfinite(new_k).all()):
        fail(f"K2 {branch}: non-finite output")
    diff = (cost_k - cost_p).abs()
    tol = COST_RTOL * cost_p.abs()
    near = diff <= tol
    flips = torch.round(diff / step.k_coll) if step.k_coll else torch.zeros_like(diff)
    edge = (~near) & (flips >= 1) & ((diff - flips * step.k_coll).abs() <= tol)
    bad = ~(near | edge)
    edge_share = float(edge.float().mean())
    if bool(bad.any()):
        fail(f"K2 {branch}: {int(bad.sum())} costs off by more than rtol {COST_RTOL} "
             f"(max rel {float((diff / cost_p.abs()).max()):.3g})")
    if edge_share > EDGE_SHARE:
        fail(f"K2 {branch}: {edge_share:.3%} of the samples flipped a cell edge")
    agree = cost_k.argmin(1) == cost_p.argmin(1)
    if float(agree.float().mean()) < MIN_ARGMAX_AGREE:
        fail(f"K2 {branch}: best sample agrees for only {int(agree.sum())}/{p} particles")
    mean_err = float((new_k - new_p)[agree].abs().max())
    if mean_err > MEAN_ATOL:
        fail(f"K2 {branch}: new means differ by {mean_err:.3g} where the best sample agrees")
    out = dict(cost_max_rel=float((diff[near] / cost_p.abs()[near]).max()),
               edge_flips=int(edge.sum()), argmax_agree=int(agree.sum()), particles=p,
               max_abs_err=mean_err)
    if branch == "matmul":  # time the main path's branch: seed mode vs plain + its draw
        kernel = lambda: fused_planar_step(step, means, prec_u, seed=3)  # noqa: E731
        plain = lambda: fused_planar_step_plain(  # noqa: E731
            step, means, prec_u, torch.randn((p, S, means.shape[1]), generator=gen, device=dev))
        out.update(ms=cuda_ms(kernel, 200), plain_ms=cuda_ms(plain, 50),
                   device_ms=device_ms(kernel, 50), plain_device_ms=device_ms(plain, 20))
    return out


def moments_check(dev) -> dict:
    """K2 with Philox draws and uniform weights: the update is the sample
    mean of ``eps @ W``, so its per-lane variance is diag(W^T W) / S."""
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import fused_planar_step

    step, state = make_step(dev, zero_quad=True)
    p = state.particle_means.shape[0]
    means = state.particle_means.reshape(p, -1).contiguous()
    prec_u = torch.zeros_like(means)
    diffs = []
    for seed in range(100):
        new, _ = fused_planar_step(step, means, prec_u, seed=1000 + seed)
        diffs.append(new - means)
    d = torch.stack(diffs).double()  # [seeds, P, M]
    emp_var = d.var(dim=(0, 1))
    want_var = (step.weight_t.double() ** 2).sum(0) / S
    ratio = float((emp_var / want_var).median())
    max_mean = float(d.mean(dim=(0, 1)).abs().max())
    if not 0.85 < ratio < 1.15:
        fail(f"K2 Philox: median variance ratio {ratio:.4f} outside (0.85, 1.15)")
    if not max_mean < 0.02:
        fail(f"K2 Philox: largest per-lane mean {max_mean:.4f} >= 0.02")
    return dict(var_ratio_median=ratio, max_lane_mean=max_mean)


def main_path(dev) -> dict:
    """StochGPMP(fused_kernel=True) on the parity problem, built natively."""
    from stoch_gpmp_tpu_torch.ops.kernels.fields import raster_primitive_cost
    from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (
        fused_planar_optimize_batched,
        fused_planar_step,
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
    raster_primitive_cost.launches = 0
    fused_planar_step.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = planner.optimize()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"raster_field": raster_primitive_cost.launches,
                "fused_planar_step": fused_planar_step.launches}
    if min(launches.values()) < 1:
        fail(f"main path did not launch every kernel: {launches}")
    shapes = [tuple(o.shape) for o in out]
    if shapes != [(p, T, 2), (p, T, 2), (p, S, T, 2), (p, S, T, 2), (p, S), (p, T, 4)]:
        fail(f"main path: unexpected 6-tuple shapes {shapes}")
    means = planner.particle_means
    if not all(bool(torch.isfinite(o).all()) for o in out):
        fail("main path: non-finite output")
    ends = means.reshape(3, PPG, T, 4)[:, :, -1, :2].cpu()
    goal_err = float((ends - torch.tensor(GOALS)[:, None, :2]).norm(dim=-1).max())
    start_err = float((means[:, 0, :2].cpu() - torch.tensor(START[:2])).abs().max())
    if goal_err >= GOAL_TOL or start_err >= START_TOL:
        fail(f"main path: end points {goal_err:.3g} from the goals, start {start_err:.3g}")

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
            pu = step.dof_prior.matvec_flat(m.reshape(p, T, 4)).reshape(p, -1)
            eps = torch.randn((p, S, m.shape[1]), generator=gen, device=dev)
            m, _ = fused_planar_step_plain(step, m, pu, eps)
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
    busy = device_ms(lambda: fused_planar_optimize_batched(step, means0, gen, 50), 1)
    iter_ms = 1e3 * sum(times["kernel"]) / len(times["kernel"]) / (ITERS - 1)
    return dict(launches=launches, goal_err=goal_err, start_err=start_err,
                optimize_seconds=seconds, optimize_updates_per_s=p * ITERS / seconds,
                loop_updates_per_s_kernel=per_s["kernel"],
                loop_updates_per_s_plain=per_s["plain"],
                loop_iter_wall_ms=iter_ms,
                loop_iter_device_ms=None if busy is None else busy / 50,
                loop_device_busy=None if busy is None else busy / 50 / iter_ms)


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
    used = [ln.split(":", 1)[-1].strip() for ln in _build.build_info.get("log", "").splitlines()
            if "Used" in ln or "spill" in ln]
    phase("build", f"nvcc sm_90a in {time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(used)}")
    details = {"device": name, "nvidia_smi": smi, "build_log": _build.build_info.get("log", "")}

    k1 = raster_check(dev)
    phase("K1", f"raster field exact on {k1['points']} + {k1['edge_points']} edge points; "
                f"per call kernel {k1['ms']:.4f} ms, plain {k1['plain_ms']:.4f} ms; device "
                f"time kernel {fmt_ms(k1['device_ms'])}, plain {fmt_ms(k1['plain_device_ms'])}")
    k2 = {b: fused_check(dev, b) for b in ("matmul", "stencil")}
    for b, r in k2.items():
        timing = "" if "ms" not in r else (
            f"; per call kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; device time "
            f"kernel {fmt_ms(r['device_ms'])}, plain {fmt_ms(r['plain_device_ms'])}")
        phase("K2", f"{b}: costs within rtol {r['cost_max_rel']:.2e} (+{r['edge_flips']} "
                    f"edge flips), best sample agrees {r['argmax_agree']}/{r['particles']}, "
                    f"means max err {r['max_abs_err']:.2e}{timing}")
    mom = moments_check(dev)
    phase("K2-philox", f"variance ratio median {mom['var_ratio_median']:.4f}, "
                       f"max lane mean {mom['max_lane_mean']:.4f}")
    mp = main_path(dev)
    phase("main", f"{ITERS} iters: launches {mp['launches']}, goal err {mp['goal_err']:.3f}, "
                  f"start err {mp['start_err']:.2e}; optimize {mp['optimize_updates_per_s']:.0f} "
                  f"updates/s; fused loop kernel {mp['loop_updates_per_s_kernel']:.0f} vs plain "
                  f"{mp['loop_updates_per_s_plain']:.0f} updates/s; kernel loop "
                  f"{mp['loop_iter_wall_ms']:.4f} ms/iter, device time "
                  f"{fmt_ms(mp['loop_iter_device_ms'])}/iter, device busy "
                  f"{'not measured' if mp['loop_device_busy'] is None else format(mp['loop_device_busy'], '.1%')}"
                  f" on {smi}")
    details.update(K1=k1, K2=k2, moments=mom, main=mp)
    if args.log_dir:
        out = Path(args.log_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(details, indent=1))

    kernels = [
        {"name": "raster_field", "route": "cuda",
         "source": "stoch_gpmp_tpu_torch/csrc/raster_field.cu",
         "replaces": "stoch_gpmp_tpu/ops/pallas/fields.py:147",
         "launches": mp["launches"]["raster_field"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "fused_planar_step", "route": "cuda",
         "source": "stoch_gpmp_tpu_torch/csrc/fused_planar_step.cu",
         "replaces": "stoch_gpmp_tpu/ops/pallas/fused_step.py:419",
         "launches": mp["launches"]["fused_planar_step"],
         "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
         "ms": k2["matmul"]["ms"], "plain_ms": k2["matmul"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
