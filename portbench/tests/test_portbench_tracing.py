"""The metrics that read the program's spans: a short traced run of each
cell reports each of them in exactly the cells its entry lists, with a
positive value (the CPU has no device time, so ``fused_device_us`` reads
only on the card); each reads nothing from a program that keeps no spans."""

import json
import time

import pytest
import torch

from portbench import harness

SEED, SECONDS = 3_000_000_019, 1.0
QUICK = dict(warm_requests=1, trace_requests=1)
CELLS = {
    "planar-env.refine": dict(iters_per_request=10),
    "planar-env.demo": dict(iters_per_plan=10, iters_per_call=5),
}
NEW = ("program_build_ms", "prior_build_ms", "executor_build_ms", "fused_launch_us",
       "fused_device_us", "flat_iter_ms")


def bench() -> dict:
    with open(harness.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def traced_run(cell, device, monkeypatch):
    load = harness.load_json

    def patched(kind, name):
        data = load(kind, name)
        return {**data, **QUICK, **CELLS[cell]} if kind == "traffic" else data

    monkeypatch.setattr(harness, "load_json", patched)
    return harness.run_cell(cell, SEED, SECONDS, True, torch.device(device), time.perf_counter())


def listed(cell) -> set:
    return {m["name"] for m in bench()["per_layer"] if m["name"] in NEW and cell in m["workloads"]}


@pytest.mark.parametrize("cell", list(CELLS))
def test_span_metrics_read_in_their_cells(monkeypatch, cell):
    out = traced_run(cell, "cpu", monkeypatch)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items() if k in NEW}
    assert set(got) == listed(cell) - {"fused_device_us"}
    assert all(v > 0 for v in got.values()), got


def test_span_metrics_read_nothing_without_the_recorder(monkeypatch):
    """A program with no span ring (the parent of the change that added
    it) leaves every such metric out, without raising."""
    from stoch_gpmp_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    out = traced_run("planar-env.demo", "cpu", monkeypatch)
    assert not set(out["metrics"]) & set(NEW)
    assert "plan_build_ms" in out["metrics"]


@pytest.mark.cuda
def test_fused_device_time_reads_on_the_card(card, monkeypatch):
    out = traced_run("planar-env.refine", card, monkeypatch)
    assert out["correct"], out["checks"]
    device_us = out["metrics"]["fused_device_us"]["value"]
    launch_us = out["metrics"]["fused_launch_us"]["value"]
    print(f"fused_device_us {device_us!r} fused_launch_us {launch_us!r}", flush=True)
    assert 1.0 < device_us < 10 * launch_us
