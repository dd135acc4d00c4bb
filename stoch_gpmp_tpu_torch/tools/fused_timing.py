"""Where the time of the port's kernels goes, on one NVIDIA GPU: the
phases of the fused kernels K2, K6 and K5 and of the FK + fields kernel K4,
and the kernels' device time per call across shapes.

    python3 -m stoch_gpmp_tpu_torch.tools.fused_timing phases [--out DIR] [--only K5,K4,S1]
    python3 -m stoch_gpmp_tpu_torch.tools.fused_timing shapes [--only K5,K4,K7,S1,S1-sweep,C1,floor]

``phases`` builds instrumented copies of ``csrc/fused_planar_step.cu`` (K2),
``csrc/fused_panda_step.cu`` (K6), ``csrc/fused_panda_dof_step.cu`` (K5),
``csrc/fk_fields.cu`` (K4, with its copy of ``csrc/fk_chain.cuh``) and
``csrc/bidiag_scan.cu`` (S1) into ``DIR`` (default ``build/phase_timing``):
one thread of every CTA stamps ``clock64()`` at the phase boundaries. The
stamps are placed at anchor lines of this checkout's sources, one anchor
set per kernel; an anchor that does not occur exactly once is an error. To
compare two commits, run each checkout's own copy of this module. It runs
K2 at the planar parity shape and K6 at Panda config 4 (seed mode, the
wrapper's split and 1 CTA per particle; with 1 a phase that loops over
tiles sums them and the stamps of the last tile count), K5 at Panda config
5 (seed mode and an eps operand) and K4 on config 5's dof planes, through
the port's wrappers with the instrumented launchers in place, and prints
per phase the median and the largest cycle count over the CTAs and the
largest total, then ptxas's report of the shipped kernels.

``shapes`` times K5 (seed mode, also at 1 and 2 CTAs per SM and at half
and all of the particles' CTAs), K4, K8 and K7 at config 5 (K7 on the FK
positions of K8's configurations) and K4 and K7 at config 4, and K2 in seed
mode at planar parity (P = 15, S = 128) and at the planar shapes of
``benchmarks/run.py`` ``planar-parity-64ppg`` (P = 192, S = 128) and
``planar-512ppg`` (P = 1536, S = 32), and K6 at config 4 (P = 5, S = 32)
and at P = 128: per shape the device time per call of the kernel alone and
of the whole step (``torch.profiler``), at the wrapper's split and at 1, 2,
4 and 8 CTAs per particle, with the launch's shared memory and resident
clusters. It also times the point kernels: K7 at config 4's ``[160, 63, 9,
3]`` view and at 1.30 M points, K1, K10 and K11 at the planner's ``[1920,
63, 2]`` view and at 1.31 M points, and the launch floor (a one-element
``fill_``), each by ``torch.profiler``, by CUDA events around calls queued
behind a sleeping kernel (so they run back to back on the device) and per
call through the wrapper, then ptxas's report of their sources (``floor``, ``host``: the
host's share of a wrapper call). ``S1`` times the long-horizon solve (the
backward plane solve of ``build_long_horizon_problem``'s sampler on ``[4,
480, T]`` planes, T = 4096 and 1024) through the wrapper, beside the
launcher's shape, and ptxas's report of its source; ``S1-sweep`` adds its
launch at a sweep of shapes (rows per CTA, chunks per segment, steps per
table stage, plane buffers, table stages; device ms by ``torch.profiler``);
``S1-host`` the host's time per call of its wrapper's pieces. ``C1`` times
the GP prior's block Cholesky (with ``L^{-1}`` at the planar, per-dof and
Panda priors' shapes; the factor alone for the long-horizon Gauss-Newton
batch and prior) beside the plain loops and the library's dense Cholesky,
and ``make_gp_prior`` through C1. ``phases --only S1`` stamps the
last time segment of each CTA of S1 (consumer thread 0): the wait for the
segment's planes (TMA, issued one or more segments earlier), phases 1, 2
and 3.

Both print the card's name, power limit and SM clock. Needs one NVIDIA GPU
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build, fused_step, panda_step, panda_step_dof
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import fk_link_fields_cost_rows

STAMPS = '''#include <cuda_runtime.h>
__device__ long long g_phase_clock[16384][8];
__device__ long long g_phase_acc[16384][4];
#define STAMP(k) if (threadIdx.x == STAMP_THREAD && blockIdx.x < 16384) { \\
  g_phase_clock[blockIdx.x][k] = clock64(); \\
  if (k == 0) for (int a = 0; a < 4; ++a) g_phase_acc[blockIdx.x][a] = 0; }
#define ACC_BEGIN(k) const long long stamp_acc_##k = clock64();
#define ACC_END(k) if (threadIdx.x == STAMP_THREAD && blockIdx.x < 16384) \\
  g_phase_acc[blockIdx.x][k] += clock64() - stamp_acc_##k;
extern "C" int phase_clock_read(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_phase_clock, (size_t)n * 8 * sizeof(long long));
}
extern "C" int phase_acc_read(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_phase_acc, (size_t)n * 4 * sizeof(long long));
}
'''
# Per kernel: its source, the phases, the stamping thread and the anchors:
# (file, anchor text, stamp index, stamp after the anchor or before it); the
# file is the kernel's source or a header it includes, whose instrumented
# copy sits beside the instrumented source. A stamp index may instead be the
# macro text to place: ACC_BEGIN(k) and ACC_END(k) sum the stamping thread's
# cycles between them into counter k (zeroed at STAMP(0)), for work that a
# loop interleaves; "accs" names the counters.
K2 = dict(src="fused_planar_step.cu", phases=[
    "prior pu", "draws", "x = mu + eps W", "x A", "per-row sums", "cluster combine"], thread=0,
    stamps=[
        (None, "  const int p = blockIdx.x / prm.ctas;", 0, True),
        (None, "  pu_sh[m] = prec_u_lane(mu_sh, m, M, nd, prm.prior);  // read after the next "
               "barrier", 1, True),
        (None, "    // --- 2. x = mu + eps @ W ------------------------------------------------",
         2, False),
        (None, "    // --- 3. x A into the tile buffer (matmul branch) -------------------------",
         3, False),
        (None, "    // --- 4. per-row sums, one warp per row: quad, linear, collision, importance",
         4, False),
        (None, "    __syncthreads();  // the tile buffer is free for the next tile", 5, True),
        (None, "                         new_means + (size_t)p * M);", 6, True)])
K6 = dict(src="fused_panda_step.cu", phases=[
    "prior pu", "draws", "x = mu + eps W", "stencil, FK, fields, goal", "cluster combine"],
    thread=0, stamps=[
        (None, "  const int p = blockIdx.x / ctas, tid = threadIdx.x, lane = tid & 31, warp = "
               "tid >> 5;", 0, True),
        (None, "  for (int m = tid; m < M; m += NT) pu_sh[m] = prec_u_lane(mu_sh, m, M, D, "
               "prm.prior);", 1, True),
        (None, "    tile_matmul_splitk<KT, KS, ST, ST>(tile_sh, M, ring, mu_sh,", 2, False),
        (None, "  // --- 3. stencil energy + anchors + importance, one warp per sample row ------"
               "----", 3, False),
        (None, "  // --- 5. per-sample cost ----------------------------------------------------"
               "--------", 4, False),
        (None, "                         prm.temperature, prm.step_size, new_means + (size_t)p "
               "* M);", 5, True)])
K5 = dict(src="fused_panda_dof_step.cu", phases=[
    "Sigma^-1 mu", "draws, substitution, row sums", "FK, fields, goal", "cost, softmax",
    "update"], accs=[
    "pass 1: draws + chunk recurrence (thread 0's warp)", "carries, pass 2, x rows (same)",
    "row sums: stencil, anchors, importance (same)"],
    thread=0, stamps=[  # the stamps of each CTA's last particle
        (None, "  for (int p = blockIdx.x; p < P; p += gridDim.x) {", 0, True),
        (None, "    __syncthreads();  // pu is complete; the previous particle's rows are "
               "consumed", 1, True),
        (None, "        // pass 1: the draws and the chunk's recurrence from a zero carry",
         "ACC_BEGIN(0)", False),
        (None, "        // the carries: y at step t0 is y0 + Phi_c y(t0 + CH); a suffix scan of "
               "the", "ACC_END(0) ACC_BEGIN(1)", False),
        (None, "        // the rows' quadratic terms: the chunk's stencil residuals, the anchors "
               "and", "ACC_END(1) ACC_BEGIN(2)", False),
        (None, "          if (two) rowq_sh[d * S + 2 * j + 1] = e1;\n        }",
         "ACC_END(2)", True),
        (None, "    // --- 3. FK + link fields per (sample, t); SE(3) goal at t = T-1 -----------"
               "--", 2, False),
        (None, "    // --- 4. per-sample cost, the softmax over the S samples -------------------"
               "-----", 3, False),
        (None, "    // --- 5. the mean update ---------------------------------------------------"
               "--------", 4, False),
        (None, "      new_means[idx] = mu + prm.step_size * grad;\n    }", 5, True)])
K4 = dict(src="fk_fields.cu", phases=["walk", "self field", "obstacle field", "reduction"],
          thread=1, stamps=[  # thread 0 holds t = 0, which is skipped
        (None, "  const long long b = (long long)blockIdx.x * (NT / lanes) + g;", 0, True),
        (None, "    fk_walk_spec<FkPanda>(chain, q, pos, ee_r);", 1, True),
        ("fk_chain.cuh", "  if (w_obst != 0.0f && n_obst > 0) {", 2, False),
        (None, "pos_sh + tid, sph, n_obst, inv_2m2, w_self, w_obst);\n    }\n  }", 3, True),
        (None, "    out[b] = s;\n  }", 4, True)])
S1 = dict(src="bidiag_scan.cu", phases=[  # consumer thread 0, each CTA's last time segment
    "wait for the planes", "phase 1: chunk recurrences", "phase 2: carries",
    "phase 3: y = local + phi c"], thread=0, stamps=[
        (None, "    F* buf = bufs + (a.tma ? (size_t)(q % NB) * buf_elems : 0);", 0, True),
        (None, "    // phase 1: the chunk's recurrence from a zero carry, local results in place",
         1, False),
        (None, "    // phase 2: the carries.", 2, False),
        (None, "    // phase 3: y_t = local_t + phi_t carry_in, in place", 3, False),
        (None, "    if (a.tma) {\n      fence_proxy_async();", 4, False)])
# the planar parity step's temperature and step size (chip_smoke.py), and
# config 4's (benchmarks/run.py)
PLANAR_TAU, PLANAR_STEP, PANDA_TAU, PANDA_STEP = 1.0, 0.5, 1.0, 0.1


def planar_step(dev, ppg: int, num_samples: int):
    """K2's step for 3 goals x ``ppg`` particles of the planar parity
    problem, as ``StochGPMP(fused_kernel=True)`` builds it, and the means
    ``[P, T, 4]``."""
    from stoch_gpmp_tpu_torch.planners.fused_exec import build_fused_executor
    from stoch_gpmp_tpu_torch.problems import build_planar_problem

    sampler, cost, state = build_planar_problem(ppg=ppg, dtype=torch.float32, device=dev)
    p = state.particle_means.shape[0]
    run, why = build_fused_executor(sampler, cost, {}, num_particles=p, num_samples=num_samples,
                                    temperature=PLANAR_TAU, step_size=PLANAR_STEP)
    if run is None:
        raise RuntimeError(why)
    return run.step, state.particle_means.contiguous()


def panda_flat_step(dev, ppg: int):
    """K6's step for 1 goal x ``ppg`` particles of the Panda config-4
    problem (S = 32, T = 64, the fast stack), and the means ``[P, T, 14]``."""
    from stoch_gpmp_tpu_torch.problems import build_panda_problem

    sampler, cost, state, obs, s = build_panda_problem(
        num_goals=1, ppg=ppg, traj_len=64, num_samples=32, dtype=torch.float32, device=dev)
    quad, fields = cost.costs
    step = panda_step.make_fused_panda_step(
        chain=fields.chain, weight_t=sampler.weight_t, dof_prior=sampler.dof,
        dof_quad=quad.dof_form, num_particles=state.particle_means.shape[0],
        spheres=obs["obstacle_spheres"], target_h=fields.target_h, n_dof=fields.n_dof,
        traj_len=fields.traj_len, num_samples=s, margin=fields.margin,
        w_self=1.0 / fields.sigma_self**2, w_obst=1.0 / fields.sigma_coll**2,
        w_goal=1.0 / fields.sigma_goal**2, temperature=PANDA_TAU, step_size=PANDA_STEP)
    return step, state.particle_means.contiguous()


def panda_dof_step(dev):
    """K5's step at Panda config 5 (10 goals x 128 particles, S = 8, T =
    128, the fast stack) as ``StochGPMP(fused_kernel=True)`` builds it, and
    the means as dof planes ``[7, P, 256]``."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import make_fused_panda_dof_step
    from stoch_gpmp_tpu_torch.problems import build_panda_problem

    sampler, cost, state, obs, s = build_panda_problem(
        num_goals=10, ppg=128, traj_len=128, num_samples=8, dtype=torch.float32, device=dev)
    quad, fields = cost.costs
    step = make_fused_panda_dof_step(
        chain=fields.chain, dof_prior=sampler.dof, dof_quad=quad.dof_form,
        num_particles=state.particle_means.shape[0], spheres=obs["obstacle_spheres"],
        target_h=fields.target_h, n_dof=fields.n_dof, traj_len=fields.traj_len, num_samples=s,
        margin=fields.margin, w_self=1.0 / fields.sigma_self**2,
        w_obst=1.0 / fields.sigma_coll**2, w_goal=1.0 / fields.sigma_goal**2,
        temperature=PANDA_TAU, step_size=PANDA_STEP)
    return step, to_dof_planes(state.particle_means).contiguous()


def fk_rows(dev, traj_len: int):
    """K4's input on a Panda main path: the joint planes ``[7, B, T]`` of
    the sample rows (each particle mean plus 0.05 normal noise), a view of
    the dof planes at config 5 (``traj_len`` 128, B = 10240) or of the flat
    ``[B, T, 14]`` batch at config 4 (64, B = 160); the spheres and the
    field weights."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.problems import build_panda_problem

    shape = (dict(num_goals=10, ppg=128, traj_len=128, num_samples=8) if traj_len == 128
             else dict(num_goals=1, ppg=5, traj_len=64, num_samples=32))
    _, cost, state, obs, s = build_panda_problem(**shape, dtype=torch.float32, device=dev)
    fields = cost.costs[1]
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = state.particle_means.repeat_interleave(s, dim=0)
    rows = rows + 0.05 * torch.randn(rows.shape, generator=gen, device=dev)
    if traj_len == 128:
        q = to_dof_planes(rows).contiguous()[:, :, :traj_len]
    else:
        q = rows[..., :7].permute(2, 0, 1)
    kw = dict(margin=fields.margin, w_self=1.0 / fields.sigma_self**2,
              w_obst=1.0 / fields.sigma_coll**2)
    return fields.chain, q, obs["obstacle_spheres"], kw


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader", "-i", "0"], capture_output=True,
                          text=True).stdout.strip()


# --- phases -------------------------------------------------------------------


def instrumented(spec: dict, out_dir: Path) -> ctypes.CDLL:
    """Build ``spec``'s source with clock64 stamps at its anchors; raises
    where an anchor does not occur exactly once."""
    name, stamps = spec["src"], spec["stamps"]
    files = {f: (_build.CSRC / (f or name)).read_text() for f, *_ in stamps}
    missed = [a for f, a, *_ in stamps if files[f].count(a) != 1]
    if missed:
        raise RuntimeError(f"{name}: anchors not found exactly once: {missed}")
    for f, anchor, k, after in stamps:
        mark = f"STAMP({k});" if isinstance(k, int) else k
        files[f] = files[f].replace(
            anchor, f"{anchor}\n  {mark}" if after else f"  {mark}\n{anchor}")
    kdir = out_dir / Path(name).stem
    kdir.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        if f is not None:
            (kdir / f).write_text(text)
    cu, so = kdir / name, kdir / name.replace(".cu", ".so")
    cu.write_text(f"#define STAMP_THREAD {spec['thread']}\n" + STAMPS + files[None])
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.phase_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.phase_acc_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def report(what: str, lib, n_ctas: int, phases, accs=()) -> None:
    clocks = np.zeros((n_ctas, 8), dtype=np.int64)
    if lib.phase_clock_read(clocks.ctypes.data, n_ctas) != 0:
        raise RuntimeError("reading the phase clocks failed")
    launched = (clocks[:, 0] != 0) & (clocks[:, len(phases)] != 0)  # the CTAs launched
    clocks = clocks[launched]
    n_ctas = clocks.shape[0]
    d = np.diff(clocks[:, : len(phases) + 1], axis=1)
    total = int((clocks[:, len(phases)] - clocks[:, 0]).max())
    print(f"{what}: cycles per phase, median / largest over {n_ctas} CTAs:")
    for name, med, top in zip(phases, np.median(d, axis=0), d.max(axis=0)):
        print(f"  {name:28s} {int(med):8d} / {int(top):8d}")
    print(f"  {'total, largest CTA':28s} {total:8d}")
    if accs:
        acc = np.zeros((launched.shape[0], 4), dtype=np.int64)
        if lib.phase_acc_read(acc.ctypes.data, launched.shape[0]) != 0:
            raise RuntimeError("reading the phase counters failed")
        acc = acc[launched]
        for k, name in enumerate(accs):
            print(f"  of which {name}: {int(np.median(acc[:, k]))} / {int(acc[:, k].max())}")


def use(lib, so) -> None:
    """Point the port's launchers at the instrumented library's."""
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(so, name):
            fn = getattr(so, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            setattr(lib, name, fn)


def phases(dev, out_dir: Path, only) -> None:
    lib = _build.load_library()
    if "K2" in only:
        k2 = instrumented(K2, out_dir)
        use(lib, k2)
        step, means = planar_step(dev, 5, 128)
        p = means.shape[0]
        means = means.reshape(p, -1)
        for c in (fused_step.launch_shape(step)["ctas"], 1):
            for _ in range(3):
                fused_step.fused_planar_step(step, means, seed=3, ctas=c)
            torch.cuda.synchronize()
            report(f"K2, planar parity, {c} CTAs per particle (matmul branch, seed mode)", k2,
                   p * c, K2["phases"])
    if "K6" in only:
        k6 = instrumented(K6, out_dir)
        use(lib, k6)
        step4, means4 = panda_flat_step(dev, 5)
        p4 = means4.shape[0]
        means4 = means4.reshape(p4, -1)
        for c in (panda_step.launch_shape(step4)["ctas"], 1):
            for _ in range(3):
                panda_step.fused_panda_step(step4, means4, seed=3, ctas=c)
            torch.cuda.synchronize()
            report(f"K6, Panda config 4, {c} CTAs per particle (seed mode)", k6, p4 * c,
                   K6["phases"])
    if "K5" in only:
        k5 = instrumented(K5, out_dir)
        use(lib, k5)
        step5, planes = panda_dof_step(dev)
        eps = torch.randn((step5.n_dof, step5.num_particles, step5.num_samples,
                           planes.shape[-1]), device=dev)
        for mode, kw in (("seed mode", dict(seed=3)), ("eps operand", dict(eps=eps))):
            for _ in range(3):
                step5(planes, **kw)
            torch.cuda.synchronize()
            report(f"K5, Panda config 5 ({mode})", k5, min(16384, step5.num_particles),
                   K5["phases"], K5["accs"])
    if "S1" in only:
        from stoch_gpmp_tpu_torch.problems import build_long_horizon_problem

        s1 = instrumented(S1, out_dir)
        use(lib, s1)
        for t in (4096, 1024):
            ps = build_long_horizon_problem(t, device=dev)[0].psolver
            x = torch.randn((4, 480, t), device=dev)
            for _ in range(3):
                ps.solve_LT_planes(tuple(x))
            torch.cuda.synchronize()
            shape = s1_shape(lib, 480, t)
            report(f"S1, backward [4, 480, {t}] float32, launch shape {shape}", s1,
                   -(-480 // shape[0]), S1["phases"])
    if "K4" in only:
        k4 = instrumented(K4, out_dir)
        use(lib, k4)
        chain, q, spheres, kw = fk_rows(dev, 128)
        for _ in range(3):
            fk_link_fields_cost_rows(chain, q, spheres, **kw)
        torch.cuda.synchronize()
        report(f"K4, Panda config 5 dof planes {tuple(q.shape)}, the first 16384 blocks", k4,
               16384, K4["phases"])
    for k, spec in (("K2", K2), ("K6", K6), ("K5", K5), ("K4", K4), ("S1", S1)):
        if k in only:
            print(f"ptxas {spec['src']}: {ptxas_report(spec['src'])}", flush=True)


# --- shapes -------------------------------------------------------------------


def device_events(fn, reps: int) -> list[tuple[str, float, float]]:
    """``fn()`` once, then ``reps`` calls under ``torch.profiler`` (device
    activity only, so no time is counted twice): per device operation that
    took time, its name, device ms per call and runs per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in prof.key_averages() if e.self_device_time_total > 0]


def device_per_call(fn, reps: int, kernel: str) -> tuple[float, float]:
    """Device ms per call of ``fn()`` (:func:`device_events`): the kernels
    whose name holds ``kernel``, and every device operation."""
    events = device_events(fn, reps)
    return sum(ms for k, ms, _ in events if kernel in k), sum(ms for _, ms, _ in events)


def device_breakdown(fn, reps: int, top: int = 8) -> tuple[float | None, list, float]:
    """Device time per call of ``fn()`` (:func:`device_events`), the ``top``
    device operations by time and the device operations (kernels and copies)
    per call: ``(total ms per call, or None where the profiler saw no device
    activity; [(name, ms per call), ...]; operations per call)``."""
    events = device_events(fn, reps)
    busy = sum(ms for _, ms, _ in events)
    rows = sorted(events, key=lambda e: -e[1])[:top]
    return ((busy if busy > 0 else None), [(name[:48], ms) for name, ms, _ in rows],
            sum(n for *_, n in events))


def time_step(what: str, step, means, kernel: str, wrapper, module, reps: int = 20) -> None:
    """One line per split: the kernel's and the whole step's device ms per
    call in seed mode (the step's own call at the default split; the
    wrapper with ``ctas=`` where it takes it)."""
    p = means.shape[0]
    flat = means.reshape(p, -1)
    for c in (None, 1, 2, 4, 8):
        if c is None:
            fn = lambda: step(means, seed=3)  # noqa: E731
        else:
            fn = lambda: wrapper(step, flat, seed=3, ctas=c)  # noqa: E731
        try:
            kern, every = device_per_call(fn, reps, kernel)
        except (RuntimeError, ValueError) as err:
            print(f"{what}, ctas={c}: not launched ({err})", flush=True)
            continue
        sh = module.launch_shape(step, c)
        shape = (f", {sh['ctas']} CTAs per particle, {sh['ctas_launched']} CTAs, "
                 f"{sh['smem_bytes']} B shared memory, {sh['stages']} K-tile buffers, "
                 f"{sh['max_active_clusters']} clusters resident, "
                 f"{-(-p // sh['max_active_clusters'])} wave(s)")
        label = "default split" if c is None else f"ctas={c}"
        print(f"{what}, {label}: kernel {kern:.4f} ms, step {every:.4f} ms device per call"
              f"{shape}", flush=True)


def events_per_call(fn, reps: int) -> float:
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


def queued_ms(fn, n: int = 200) -> tuple[float, bool]:
    """Device time per call of ``fn()``, CUDA events around ``n`` calls
    queued behind a sleeping kernel, so that they run back to back on the
    device whatever the host's launch cost (each call's device time plus the
    gap between two launches); and whether the sleep outlasted the queueing
    (else the figure is the host's)."""
    per_call = events_per_call(fn, 20)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e6 * per_call * n))  # ~2 GHz: twice the queueing time
    start.record()
    for _ in range(n):
        fn()
    end.record()
    held = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, held


def time_point(what: str, fn, kernel: str, reps: int = 100) -> None:
    """One line: ``fn``'s device ms per call by ``torch.profiler`` (the
    kernels whose name holds ``kernel``, and every device operation) and by
    CUDA events around queued launches, and its time per call through the
    wrapper (CUDA events, back to back; the median and the least of 7 runs
    of 200 calls, as the host's pace drifts)."""
    kern, every = device_per_call(fn, reps, kernel)
    queued, held = queued_ms(fn)
    runs = [events_per_call(fn, 200) for _ in range(7)]
    print(f"{what}: device {kern:.4f} ms kernel, {every:.4f} ms every operation "
          f"(torch.profiler, {reps} calls); queued {queued:.4f} ms per call (CUDA events, 200 "
          f"calls back to back on the device{'' if held else '; NOT held: the host'}); per "
          f"call {float(np.median(runs)):.4f} ms, least {min(runs):.4f} ms (CUDA events, back "
          "to back, 7 x 200)", flush=True)


def link_positions(dev, traj_len: int):
    """K7's input on a Panda main path: the link positions of ``fk_rows``'s
    sample rows through ``chain.fk_compact``, as ``[B, T, L, 3][:, 1:]``
    (what ``FusedLinkFieldsCost`` passes: a view), at config 4 (``traj_len``
    64: ``[160, 63, 9, 3]``) or config 5 (128: ``[10240, 127, 9, 3]``, 1.30
    M points); the chain, the spheres and the field weights."""
    chain, q, spheres, kw = fk_rows(dev, traj_len)
    b, t = q.shape[1], q.shape[2]
    pos = chain.fk_compact(q.permute(1, 2, 0).reshape(-1, q.shape[0])).positions
    return chain, pos.reshape(b, t, -1, 3)[:, 1:], spheres, kw


def planar_points(dev, field: str):
    """K1's (``field`` "raster"), K10's ("grid") or K11's ("primitive")
    field of the planar parity map and its points: the planner's strided ``[1920, 63, 2]`` slice
    of a ``[1920, 64, 4]`` batch and a ``[20480, 64, 2]`` slice of ``[20480,
    64, 4]`` (1.31 M points), uniform over the map."""
    from stoch_gpmp_tpu_torch.problems import build_planar_cost

    _, f = build_planar_cost(dtype=torch.float32, device=dev, fast=False, field=field)
    gen = torch.Generator(device=dev).manual_seed(0)
    view = (torch.rand((1920, 64, 4), generator=gen, device=dev) * 22 - 11)[:, 1:, :2]
    big = (torch.rand((20480, 64, 4), generator=gen, device=dev) * 22 - 11)[..., :2]
    return f, view, big


def point_kernels(dev, only) -> None:
    """The launch floor (a one-element ``fill_``), K7 at config 4 and at
    1.30 M points, K1, K10 and K11 at the planner's view and at 1.31 M
    points, the host's share of a wrapper call, and ptxas's report of the
    four sources."""
    from stoch_gpmp_tpu_torch.ops.kernels import fields, panda_fields

    _build.load_library()
    if "floor" in only:
        time_point("launch floor, torch.empty(1).fill_(0)",
                   lambda: torch.empty(1, device=dev).fill_(0), "")
    if "K7" in only:
        k7 = panda_fields.fused_link_fields_cost
        for what, t in (("config 4", 64), ("config 5, 1.30 M points", 128)):
            _, pos, spheres, kw = link_positions(dev, t)
            time_point(f"K7 {what} {tuple(pos.shape)}", lambda: k7(pos, spheres, **kw),
                       "link_fields")
    for kname, field, kernel in (("K1", "raster", "raster_field"), ("K10", "grid", "grid_lookup"),
                                 ("K11", "primitive", "primitive_field")):
        if kname in only:
            f, view, big = planar_points(dev, field)
            for pts in (view, big):
                time_point(f"{kname} {tuple(pts.shape)}", lambda: f.compute_cost(pts), kernel)
    if "host" in only:
        import time

        for what, fn in (("_build.stream_ptr", lambda: _build.stream_ptr(dev)),
                         ("torch.empty((160, 63))", lambda: torch.empty((160, 63), device=dev)),
                         ("_build.load_library", _build.load_library)):
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            print(f"host: {what} {(time.perf_counter() - t0) / 2 * 1e3:.2f} us per call",
                  flush=True)
    for src in ("link_fields.cu", "primitive_field.cu", "grid_lookup.cu", "raster_field.cu"):
        print(f"ptxas {src}: {ptxas_report(src)}", flush=True)


def s1_shape(lib, b: int, t: int, shape=(0, 0, 0, 0, 0)) -> tuple | None:
    """S1's launch shape on ``[4, b, t]`` float32 planes, as
    ``bidiag_scan_config`` reports it: ``(rows per CTA, chunks per segment,
    steps per table stage, plane buffers, table stages, shared memory bytes,
    threads)``; the launcher's choice for a zero shape, else the given one,
    None where the kernel does not take it."""
    out = (ctypes.c_int * 7)(*shape, *[0] * (7 - len(shape)))
    if lib.bidiag_scan_config(b, t, 4, 0, out) != 0:
        return None
    return tuple(out)


def s1_launches(dev, sweep: bool) -> None:
    """S1 at the long-horizon main path's shapes: the wrapper's call, then
    (``sweep``) a sweep of launch shapes, float32, backward."""
    from stoch_gpmp_tpu_torch.ops.kernels import bidiag_scan as s1
    from stoch_gpmp_tpu_torch.problems import LONG_HORIZON, build_long_horizon_problem

    lib = _build.load_library()
    b = LONG_HORIZON["particles"] * LONG_HORIZON["num_samples"]
    for t in (4096, 1024):
        ps = build_long_horizon_problem(t, device=dev)[0].psolver
        x = torch.randn((4, b, t), generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
        out = torch.empty_like(x)
        time_point(f"S1 backward [4, {b}, {t}] (launch shape {s1_shape(lib, b, t)})",
                   lambda: ps.solve_LT_planes(tuple(x), out=tuple(out)), "bidiag_scan")
        if not sweep:
            continue
        ptrs = [m.data_ptr() for m in s1.tables(ps, backward=True)]
        for shape in [(rows, 8 * 32 // rows, 4, 2, 2) for rows in (2, 8)] + [
                (4, chunks, steps, buffers, stages) for chunks in (32, 64)
                for steps in (4, 8) for buffers in (1, 2) for stages in (2, 3, 4)]:
            got = s1_shape(lib, b, t, shape)
            if got is None or shape[1] > -(-t // s1.CHUNK):
                continue
            arg = (ctypes.c_int * 5)(*shape)
            fn = lambda: _build.check(max(0, lib.bidiag_scan_launch_shaped(  # noqa: E731
                x.data_ptr(), b * t, t, 1, out.data_ptr(), b * t, t, 1, *ptrs, b, t, 4, 0, 1,
                s1.CHUNK, s1.SCAN_LEVELS, arg, _build.stream_ptr(dev))),
                "bidiag_scan_launch_shaped")
            kern, _ = device_per_call(fn, 20, "bidiag_scan")
            print(f"S1 [4, {b}, {t}] shape {got}: kernel {kern:.4f} ms device per call",
                  flush=True)


def s1_host(dev, reps: int = 3000) -> None:
    """The host's microseconds per S1 call at ``[4, 480, 1024]`` float32
    backward (``time.perf_counter`` over ``reps`` calls, not synchronised,
    the device keeping up): ``solve_LT_planes`` with and without ``out=``,
    the planes' layout check (``_layout``) and the launcher's ctypes call
    alone."""
    import time

    from stoch_gpmp_tpu_torch.ops.kernels import bidiag_scan as s1
    from stoch_gpmp_tpu_torch.problems import build_long_horizon_problem

    t, b = 1024, 480
    ps = build_long_horizon_problem(t, device=dev)[0].psolver
    x = torch.randn((4, b, t), device=dev)
    out = torch.empty_like(x)
    xp, op = tuple(x), tuple(out)
    lib = _build.load_library()
    args = (x.data_ptr(), b * t, t, 1, out.data_ptr(), b * t, t, 1,
            *(m.data_ptr() for m in s1.tables(ps, backward=True)), b, t, 4, 0, 1, s1.CHUNK,
            s1.SCAN_LEVELS, _build.stream_ptr(dev))
    for what, fn in (("solve_LT_planes(planes, out=)", lambda: ps.solve_LT_planes(xp, out=op)),
                     ("solve_LT_planes(planes)", lambda: ps.solve_LT_planes(xp)),
                     ("_layout(planes)", lambda: s1._layout(xp)),
                     ("bidiag_scan_launch (ctypes)", lambda: lib.bidiag_scan_launch(*args))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        print(f"S1 host: {what} {us:.2f} us per call", flush=True)


def c1_launches(dev) -> None:
    """C1 at the shapes the port factors (the demo's planar sampling prior
    and its per-dof factor, the Panda example's prior, each with ``L^{-1}``;
    the long-horizon Gauss-Newton batch and prior, the factor alone) beside
    its plain version, the loops, and beside the library's dense factor
    (``torch.linalg.cholesky_ex`` of the ``M x M`` precision, and
    ``solve_triangular`` against the identity for ``L^{-1}``) on the card;
    then ``make_gp_prior`` at the demo's shape, two C1 launches."""
    from stoch_gpmp_tpu_torch.gp.lift import q_inv_block, unary_weight
    from stoch_gpmp_tpu_torch.gp.prior import build_precision, make_gp_prior
    from stoch_gpmp_tpu_torch.ops.kernels.block_chol import block_chol_plain
    from stoch_gpmp_tpu_torch.problems import DT, GOALS, PANDA_DT, START

    def prec(dof, t, dt, s_start, s_gp, s_goal, lead=()):
        d = 2 * dof
        p = build_precision(dof, t, dt, unary_weight(d, s_start, device=dev),
                            q_inv_block(dof, dt, sigma=s_gp, device=dev),
                            k_g_inv=unary_weight(d, s_goal, device=dev), device=dev)
        return type(p)(p.diag.expand(lead + p.diag.shape).contiguous(),
                       p.lower.expand(lead + p.lower.shape).contiguous())

    for what, system, inverse, library in (
            ("planar prior (4, 64) with L^-1", prec(2, 64, DT, 1e-3, 3.0, 1e-3), True, True),
            ("per-dof factor (2, 64) with L^-1", prec(1, 64, DT, 1e-3, 3.0, 1e-3), True, True),
            ("Panda prior (14, 64) with L^-1", prec(7, 64, PANDA_DT, 1e-3, 0.1, 0.07), True,
             True),
            ("Gauss-Newton batch [15, 1024, 4, 4]", prec(2, 1024, DT, 1e-3, 3.0, 1e-3, (15,)),
             False, True),
            ("long-horizon prior (4, 4096)", prec(2, 4096, DT, 1e-3, 3.0, 1e-3), False, False)):
        kernel = system.cholesky_inverse if inverse else system.cholesky

        def plain(system=system, inverse=inverse):
            return block_chol_plain(system, inverse=inverse)

        time_point(f"C1 {what}", kernel, "block_chol_kernel", reps=20)
        _, every = device_per_call(plain, 2, "")
        print(f"C1 {what}, plain loops: device {every:.4f} ms every operation, per call "
              f"{events_per_call(plain, 2):.4f} ms (CUDA events)", flush=True)
        if library:
            dense = system.to_dense()
            eye = torch.eye(dense.shape[-1], dtype=dense.dtype, device=dev)

            def lib(dense=dense, eye=eye, inverse=inverse):
                chol = torch.linalg.cholesky_ex(dense)[0]  # no host check of info
                if inverse:
                    return torch.linalg.solve_triangular(chol, eye, upper=False)
                return chol

            _, every = device_per_call(lib, 5, "")
            print(f"C1 {what}, library (dense cholesky_ex{' + solve_triangular' * inverse} on "
                  f"{list(dense.shape)}): device {every:.4f} ms every operation, per call "
                  f"{events_per_call(lib, 5):.4f} ms (CUDA events)", flush=True)

    def prior():
        return make_gp_prior(2, 64, DT, START, 1e-3, 3.0, sigma_goal=1e-3, goal_states=GOALS,
                             device=dev)

    _, every = device_per_call(prior, 3, "")
    runs = [events_per_call(prior, 10) for _ in range(5)]
    print(f"make_gp_prior (2 dof, T = 64) through C1: device {every:.4f} ms every operation, "
          f"per call {float(np.median(runs)):.4f} ms median of 5 x 10 (CUDA events)",
          flush=True)


def ptxas_report(src: str) -> str:
    """ptxas's registers, spills and stack frames per kernel of ``csrc/src``,
    from a build of that source alone with the kernels' flags (the shared
    build may have been cached)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", f"{tmp}/k.so",
                               str(_build.CSRC / src)], capture_output=True, text=True)
    lines = [ln.split(":", 1)[-1].strip() for ln in proc.stderr.splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    return " | ".join(lines) or proc.stderr


def shapes(dev, only) -> None:
    if "C1" in only:
        c1_launches(dev)
        print(f"ptxas block_chol.cu: {ptxas_report('block_chol.cu')}", flush=True)
    if "S1" in only or "S1-sweep" in only:
        s1_launches(dev, "S1-sweep" in only)
        print(f"ptxas bidiag_scan.cu: {ptxas_report('bidiag_scan.cu')}", flush=True)
    if "S1-host" in only:
        s1_host(dev)
    if "K5" in only:
        step, planes = panda_dof_step(dev)
        kern, every = device_per_call(lambda: step(planes, seed=3), 20, "fused_panda_dof_step")
        print(f"K5 Panda config 5 P=1280 S=8 T=128: kernel {kern:.4f} ms, step {every:.4f} ms "
              "device per call", flush=True)
        wrapper = panda_step_dof.fused_panda_dof_step
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for c in (sms, 2 * sms, step.num_particles // 2, step.num_particles):  # CTAs, looping
            kern, _ = device_per_call(lambda: wrapper(step, planes, seed=3, ctas=c), 20,
                                      "fused_panda_dof_step")
            print(f"K5 Panda config 5, {c} CTAs: kernel {kern:.4f} ms device per call",
                  flush=True)
    if "K4" in only:
        for what, t in (("config 5 dof planes", 128), ("config 4 flat batch", 64)):
            chain, q, spheres, kw = fk_rows(dev, t)
            kern, _ = device_per_call(
                lambda: fk_link_fields_cost_rows(chain, q, spheres, **kw), 50, "fk_fields")
            print(f"K4 Panda {what} {tuple(q.shape)}: kernel {kern:.4f} ms device per call",
                  flush=True)
    if "K8" in only:
        from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import fk_link_fields_cost

        chain, q, spheres, kw = fk_rows(dev, 128)
        flat = q.permute(1, 2, 0).reshape(-1, q.shape[0])  # [B * T, 7], a strided view
        kern, _ = device_per_call(lambda: fk_link_fields_cost(chain, flat, spheres, **kw), 20,
                                  "fk_fields_points")
        print(f"K8 Panda config 5 points {tuple(flat.shape)}: kernel {kern:.4f} ms device per "
              "call", flush=True)
    point_kernels(dev, only)
    for what, ppg, s in (("K2 planar parity P=15 S=128", 5, 128),
                         ("K2 planar-parity-64ppg P=192 S=128", 64, 128),
                         ("K2 planar-512ppg P=1536 S=32", 512, 32))[:3 * ("K2" in only)]:
        step, means = planar_step(dev, ppg, s)
        time_step(what, step, means, "fused_planar_step_kernel", fused_step.fused_planar_step,
                  fused_step)
    for what, ppg in (("K6 Panda config 4 P=5 S=32", 5),
                      ("K6 Panda P=128 S=32", 128))[:2 * ("K6" in only)]:
        step, means = panda_flat_step(dev, ppg)
        time_step(what, step, means, "fused_panda_step_kernel", panda_step.fused_panda_step,
                  panda_step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("phases", "shapes"))
    ap.add_argument("--only", default="K2,K6,K5,K4,K7,K8,K1,K10,K11,S1,floor,host",
                    help="kernels (and floor, host), comma-separated")
    ap.add_argument("--out", type=Path, default=Path("build") / "phase_timing",
                    help="where phases builds the instrumented kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs one NVIDIA GPU")
    dev = torch.device("cuda", 0)
    if args.what == "phases":
        phases(dev, args.out, args.only.split(","))
    else:
        shapes(dev, args.only.split(","))
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
