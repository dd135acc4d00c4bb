"""Runs one cell once: set-up, a closed-loop window, an optional traced
window, the check, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: ``configs/<config>.json`` names its ``problem``
(``problems/<problem>.py``), ``traffic/<mix>.json`` its ``loop``
(``loops/<loop>.py``), and each metric of ``BENCHMARK.json`` is read by
``metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from collections import defaultdict
from pathlib import Path

import numpy as np

from portbench import check

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stoch_gpmp_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_module(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py``."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


class NonFinite(RuntimeError):
    pass


class Session:
    """What a loop sees of the run: the configuration, the traffic, the
    problem, seeds drawn from ``--seed``, spans, and the calls kept for the
    check (a uniform sample of the window's calls, drawn from the seed)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.rng = np.random.default_rng(seed % 2**64)
        self.pick = random.Random(seed)
        self.problem = load_module("problems", cfg["problem"]).Problem(cfg, device)
        self.loop = load_module("loops", traffic["loop"]).Loop(self)
        self.capacity = traffic.get("check_calls", 6)
        self.kept: list = []
        self.offers = 0
        self.recording = False
        self.spans: dict = defaultdict(list)

    def draw_seed(self) -> int:
        return int(self.rng.integers(0, 2**62))

    @contextlib.contextmanager
    def span(self, name: str):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{name}"):
            yield
        if self.recording:
            self.spans[name].append(time.perf_counter() - t0)

    def offer(self, **call) -> None:
        """Reservoir sampling of the window's calls (the keywords of the
        ``check.Call``)."""
        if not self.recording:
            return
        call = check.Call(**call)
        self.offers += 1
        if len(self.kept) < self.capacity:
            self.kept.append(call)
        else:
            j = self.pick.randrange(self.offers)
            if j < self.capacity:
                self.kept[j] = call

    @staticmethod
    def check_finite(result) -> None:
        if not np.all(np.isfinite(result)):
            raise NonFinite("the result holds non-finite values")


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(session: Session, seconds: float) -> dict:
    """Closed loop for ``seconds``: requests one after another; each
    request's latency from issue to its result on the host."""
    lat, updates, failed = [], 0, 0
    session.recording = True
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        try:
            updates += session.loop.request()
        except Exception:  # a request that raises counts as failed
            if failed == 0:
                traceback.print_exc()
            failed += 1
        lat.append(time.perf_counter() - t0)
    end = time.perf_counter()
    session.recording = False
    return {"latencies": lat, "updates": updates, "failed": failed,
            "attempted": len(lat), "seconds": end - start, "start": start}


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of all ``values`` (linear between ranks)."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100, method="inclusive")[int(q) - 1])


def read_trace(path: str) -> dict:
    """Device operations and the benchmark's spans of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
        elif cat == "user_annotation" and e["name"].startswith("portbench."):
            spans.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
    return {"ops": ops, "spans": spans}


def union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def run_trace(session: Session, requests: int) -> dict | None:
    """Up to ``requests`` more requests under ``torch.profiler``, fewer where
    the traffic's ``trace_seconds`` pass first (at least one); the device's
    busy time over the traced window, its operations and the idle gaps by
    the benchmark span the host was in."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(session.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    iters = 0
    limit = session.traffic.get("trace_seconds", float("inf"))
    sync(session.device)
    with profile(activities=acts) as prof:
        with session.span("window"):
            start = time.perf_counter()
            for _ in range(requests):
                iters += session.loop.request(record=False)
                if time.perf_counter() - start >= limit:
                    break
            sync(session.device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = read_trace(path)
    finally:
        os.unlink(path)
    win = [s for s in tr["spans"] if s[0] == "portbench.window"]
    if not win:
        return None
    w0, w1 = win[0][1], win[0][1] + win[0][2]
    ops = [o for o in tr["ops"] if w0 <= o[1] <= w1]
    busy = union((o[1], o[1] + o[2]) for o in ops)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    inner = [s for s in tr["spans"] if s[0] != "portbench.window"]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = [s for s in inner if s[1] <= mid <= s[1] + s[2]]
        name = min(cover, key=lambda s: s[2])[0] if cover else "portbench.window"
        idle[name] += (b - a) * 1e-6
    by_name = defaultdict(float)
    for name, _, dur in ops:
        by_name[name[:96]] += dur * 1e-6
    return {
        "ops": ops, "spans": inner, "iters": iters // session.problem.num_particles,
        "window_s": (w1 - w0) * 1e-6, "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
    }


def power_limit_w():
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def kernel_build() -> dict:
    """Whether this process built the program's kernels (a first run in a
    checkout) and the seconds the build took: the program's build record,
    one entry per source, ``"(cached)"`` where it loaded a finished
    build."""
    mod = sys.modules.get("stoch_gpmp_tpu_torch.ops.kernels._build")
    info = getattr(mod, "build_info", {}) if mod is not None else {}
    built = [v["seconds"] for v in info.values() if v.get("log") != "(cached)"]
    return {"compiled": bool(built), "kernel_build_s": max(built, default=0.0)}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, t0: float,
             bench: dict | None = None) -> dict:
    """One run of ``cell``; returns the result object (without printing)."""
    import torch

    if bench is None:
        with open(ROOT / "BENCHMARK.json") as f:
            bench = json.load(f)
    spec = cell_spec(bench, cell)
    cfg = load_json("configs", spec["config"])
    traffic = load_json("traffic", spec["traffic"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    session = Session(cfg, traffic, seed, dev)
    session.loop.setup()
    sync(dev)
    window = run_window(session, seconds)
    setup_s = window["start"] - t0
    traced = run_trace(session, traffic["trace_requests"]) if trace else None
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    probe = [session.draw_seed() for _ in session.kept]
    limits = cfg["limits"]
    try:
        nums = session.problem.judge(session.kept, probe)
    except Exception:  # a comparison that cannot be made is no pass
        traceback.print_exc()
        nums = {k: float("nan") for k in limits}
    checks = {k: {"value": v if np.isfinite(v) else None, "limit": limits.get(k)}
              for k, v in nums.items()}
    correct = bool(session.kept) and window["failed"] == 0 and all(
        None not in (c["value"], c["limit"]) and c["value"] <= c["limit"]
        for c in checks.values())
    ctx = {"cfg": cfg, "traffic": traffic, "window": window, "trace": traced,
           "setup_s": setup_s, "spans": dict(session.spans), "problem": session.problem,
           "plan": getattr(session.loop, "plan", None)}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, cell, kind):
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": spec["chips"], "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit_w() if dev.type == "cuda" else None}
    out = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
           "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced["busy_s"]
        device_info["window_s"] = traced["window_s"]
        out["breakdown"] = {"device_ops": [list(kv) for kv in traced["device_ops"]],
                            "idle_gaps": [list(kv) for kv in traced["idle_gaps"]]}
    out["setup"] = kernel_build()
    out["checks"] = checks
    return out
