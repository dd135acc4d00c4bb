"""Where the time of the cluster-split fused kernels K2 and K6 goes, on one
NVIDIA GPU.

    python3 -m stoch_gpmp_tpu_torch.tools.fused_timing phases [--out DIR]
    python3 -m stoch_gpmp_tpu_torch.tools.fused_timing shapes

``phases`` builds instrumented copies of ``csrc/fused_planar_step.cu`` (K2)
and ``csrc/fused_panda_step.cu`` (K6) into ``DIR`` (default
``build/phase_timing``): thread 0 of every CTA stamps ``clock64()`` at the
phase boundaries. It runs K2 at the planar parity shape and K6 at Panda
config 4 (seed mode, the wrapper's split and 1 CTA per particle; with 1 a
phase that loops over tiles sums them and the stamps of the last tile
count) through the port's wrappers with the instrumented launchers in
place, and prints per phase the median and the largest cycle count over the
CTAs and the largest total.

``shapes`` times K2 in seed mode at planar parity (P = 15, S = 128) and at
the planar shapes of ``benchmarks/run.py`` ``planar-parity-64ppg`` (P = 192,
S = 128) and ``planar-512ppg`` (P = 1536, S = 32), and K6 at config 4 (P =
5, S = 32) and at P = 128: per shape the device time per call of the kernel
alone and of the whole step (``torch.profiler``), at the wrapper's split
and, where the wrapper takes ``ctas=``, at 1, 2, 4 and 8 CTAs per particle,
with the launch's shared memory and resident clusters. It uses only the
steps' public calls, so the same module run from an older checkout of the
port times that checkout's kernels.

Both print the card's name, power limit and SM clock. Needs one NVIDIA GPU
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from stoch_gpmp_tpu_torch.ops.kernels import _build, fused_step, panda_step

STAMPS = '''
__device__ long long g_phase_clock[4096][8];
#define STAMP(k) if (threadIdx.x == 0) g_phase_clock[blockIdx.x][k] = clock64();
extern "C" int phase_clock_read(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_phase_clock, (size_t)n * 8 * sizeof(long long));
}
'''
# (anchor line in the source, stamp index, stamp after the line or before it)
K2_STAMPS = [
    ("  const int p = blockIdx.x / prm.ctas;", 0, True),
    ("  pu_sh[m] = prec_u_lane(mu_sh, m, M, nd, prm.prior);  // read after the next barrier",
     1, True),
    ("    // --- 2. x = mu + eps @ W ------------------------------------------------", 2, False),
    ("    // --- 3. x A into the tile buffer (matmul branch) -------------------------", 3, False),
    ("    // --- 4. per-row sums, one warp per row: quad, linear, collision, importance", 4, False),
    ("    __syncthreads();  // the tile buffer is free for the next tile", 5, True),
    ("                         new_means + (size_t)p * M);", 6, True),
]
K2_PHASES = ["prior pu", "draws", "x = mu + eps W", "x A", "per-row sums", "cluster combine"]
K6_STAMPS = [
    ("  const int p = blockIdx.x / ctas, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
     0, True),
    ("  for (int m = tid; m < M; m += NT) pu_sh[m] = prec_u_lane(mu_sh, m, M, D, prm.prior);",
     1, True),
    ("    tile_matmul_splitk<KT, KS, ST, ST>(tile_sh, M, ring, mu_sh,", 2, False),
    ("  // --- 3. stencil energy + anchors + importance, one warp per sample row ----------",
     3, False),
    ("  // --- 5. per-sample cost ------------------------------------------------------------",
     4, False),
    ("                         prm.temperature, prm.step_size, new_means + (size_t)p * M);",
     5, True),
]
K6_PHASES = ["prior pu", "draws", "x = mu + eps W", "stencil, FK, fields, goal", "cluster combine"]
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


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader", "-i", "0"], capture_output=True,
                          text=True).stdout.strip()


# --- phases -------------------------------------------------------------------


def instrumented(name: str, stamps, out_dir: Path) -> ctypes.CDLL:
    src = (_build.CSRC / name).read_text()
    src = src.replace('#include "kernel_common.cuh"', '#include "kernel_common.cuh"\n' + STAMPS)
    for anchor, k, after in stamps:
        if src.count(anchor) != 1:
            raise RuntimeError(f"{name}: the phase anchor {anchor.strip()!r} is not unique")
        src = src.replace(anchor, f"{anchor}\n  STAMP({k});" if after else f"  STAMP({k});\n{anchor}")
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / name, out_dir / name.replace(".cu", ".so")
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.phase_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def report(what: str, lib, n_ctas: int, phases) -> None:
    clocks = np.zeros((n_ctas, 8), dtype=np.int64)
    if lib.phase_clock_read(clocks.ctypes.data, n_ctas) != 0:
        raise RuntimeError("reading the phase clocks failed")
    d = np.diff(clocks[:, : len(phases) + 1], axis=1)
    total = int((clocks[:, len(phases)] - clocks[:, 0]).max())
    print(f"{what}: cycles per phase, median / largest over {n_ctas} CTAs:")
    for name, med, top in zip(phases, np.median(d, axis=0), d.max(axis=0)):
        print(f"  {name:28s} {int(med):8d} / {int(top):8d}")
    print(f"  {'total, largest CTA':28s} {total:8d}")


def phases(dev, out_dir: Path) -> None:
    lib = _build.load_library()
    k2 = instrumented("fused_planar_step.cu", K2_STAMPS, out_dir)
    k6 = instrumented("fused_panda_step.cu", K6_STAMPS, out_dir)
    for name, so in (("fused_planar_step_launch", k2), ("fused_panda_step_launch", k6)):
        fn = getattr(so, name)
        fn.argtypes, fn.restype = _build.SIGNATURES[name], ctypes.c_int
        setattr(lib, name, fn)
    step, means = planar_step(dev, 5, 128)
    p = means.shape[0]
    means = means.reshape(p, -1)
    for c in (fused_step.launch_shape(step)["ctas"], 1):
        for _ in range(3):
            fused_step.fused_planar_step(step, means, seed=3, ctas=c)
        torch.cuda.synchronize()
        report(f"K2, planar parity, {c} CTAs per particle (matmul branch, seed mode)", k2,
               p * c, K2_PHASES)
    step4, means4 = panda_flat_step(dev, 5)
    p4 = means4.shape[0]
    means4 = means4.reshape(p4, -1)
    for c in (panda_step.launch_shape(step4)["ctas"], 1):
        for _ in range(3):
            panda_step.fused_panda_step(step4, means4, seed=3, ctas=c)
        torch.cuda.synchronize()
        report(f"K6, Panda config 4, {c} CTAs per particle (seed mode)", k6, p4 * c, K6_PHASES)


# --- shapes -------------------------------------------------------------------


def device_per_call(fn, reps: int, kernel: str) -> tuple[float, float]:
    """Device ms per call of ``fn()`` under ``torch.profiler``: the kernels
    whose name holds ``kernel``, and every device operation."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    mine = sum(e.self_device_time_total for e in events if kernel in e.key)
    every = sum(e.self_device_time_total for e in events)
    return mine / 1e3 / reps, every / 1e3 / reps


def time_step(what: str, step, means, kernel: str, wrapper, module, reps: int = 20) -> None:
    """One line per split: the kernel's and the whole step's device ms per
    call in seed mode (the step's own call at the default split; the
    wrapper with ``ctas=`` where it takes it)."""
    p = means.shape[0]
    flat = means.reshape(p, -1)
    splits = [None]
    if "ctas" in inspect.signature(wrapper).parameters:
        splits += [1, 2, 4, 8]
    for c in splits:
        if c is None:
            fn = lambda: step(means, seed=3)  # noqa: E731
        else:
            fn = lambda: wrapper(step, flat, seed=3, ctas=c)  # noqa: E731
        try:
            kern, every = device_per_call(fn, reps, kernel)
        except (RuntimeError, ValueError) as err:
            print(f"{what}, ctas={c}: not launched ({err})", flush=True)
            continue
        shape = ""
        if hasattr(module, "launch_shape"):
            sh = (module.launch_shape(step, c) if c is not None else module.launch_shape(step))
            shape = (f", {sh['ctas']} CTAs per particle, {sh['ctas_launched']} CTAs, "
                     f"{sh['smem_bytes']} B shared memory, {sh['stages']} K-tile buffers, "
                     f"{sh['max_active_clusters']} clusters resident, "
                     f"{-(-p // sh['max_active_clusters'])} wave(s)")
        label = "default split" if c is None else f"ctas={c}"
        print(f"{what}, {label}: kernel {kern:.4f} ms, step {every:.4f} ms device per call"
              f"{shape}", flush=True)


def shapes(dev) -> None:
    for what, ppg, s in (("K2 planar parity P=15 S=128", 5, 128),
                         ("K2 planar-parity-64ppg P=192 S=128", 64, 128),
                         ("K2 planar-512ppg P=1536 S=32", 512, 32)):
        step, means = planar_step(dev, ppg, s)
        time_step(what, step, means, "fused_planar_step_kernel", fused_step.fused_planar_step,
                  fused_step)
    for what, ppg in (("K6 Panda config 4 P=5 S=32", 5), ("K6 Panda P=128 S=32", 128)):
        step, means = panda_flat_step(dev, ppg)
        time_step(what, step, means, "fused_panda_step_kernel", panda_step.fused_panda_step,
                  panda_step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("phases", "shapes"))
    ap.add_argument("--out", type=Path, default=Path("build") / "phase_timing",
                    help="where phases builds the instrumented kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs one NVIDIA GPU")
    dev = torch.device("cuda", 0)
    if args.what == "phases":
        phases(dev, args.out)
    else:
        shapes(dev)
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
