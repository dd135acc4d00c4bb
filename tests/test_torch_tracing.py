"""The program's spans and counters (``utils/profiling.py``) on the CPU:
where the planner opens its spans and how they nest, the route counters,
the ring's wrap, the device-time pairs read without a synchronise, and
the spans in a ``trace()`` and outside one. One test, marked ``cuda``,
runs on the card: ``python -m pytest tests/test_torch_tracing.py -m cuda``."""

import json

import pytest
import torch

from stoch_gpmp_tpu_torch.planners import StochGPMP
from stoch_gpmp_tpu_torch.problems import DT, GOALS, START, build_planar_cost
from stoch_gpmp_tpu_torch.utils import profiling
from stoch_gpmp_tpu_torch.utils.profiling import annotate, counters, spans

P = profiling.PREFIX


@pytest.fixture(autouse=True)
def fresh_ring():
    profiling.reset()
    yield
    profiling.reset()


def planar_planner(device="cpu", **kw):
    """The planar problem of ``problems.py`` (the fast raster stack) at 3
    goals x 2 particles, 16 samples."""
    cost, _ = build_planar_cost(device=device)
    return StochGPMP(
        num_particles_per_goal=2, num_samples=16, traj_len=64, dt=DT, n_dof=2, opt_iters=1,
        start_state=START, multi_goal_states=GOALS, cost=cost, step_size=0.5,
        sigma_start_init=1e-3, sigma_goal_init=1e-3, sigma_gp_init=20.0,
        sigma_start_sample=1e-3, sigma_goal_sample=1e-3, sigma_gp_sample=3.0, seed=0,
        device=device, **kw)


def children(records, parent):
    return [(r.name[len(P):], r.n) for r in records if r.parent == parent.index]


def test_planner_build_nests_its_spans():
    planar_planner(fused_kernel=True)
    records = spans()
    names = [r.name[len(P):] for r in records if r.parent < 0]
    assert names == ["costs.quadratic", "envs.obstacle_map", "costs.raster_field",
                     "planner.init"]
    init = next(r for r in records if r.name == P + "planner.init")
    (reset_name, _), = children(records, init)
    assert reset_name == "planner.reset"
    reset = next(r for r in records if r.name == P + "planner.reset")
    assert children(records, reset) == [("gp.prior", None), ("gp.prior_sample", None),
                                        ("gp.prior", None)]
    assert all(r.root == init.index for r in records if r.index >= init.index)
    assert all(r.end_ns >= r.start_ns for r in records)


def test_fused_optimize_nests_its_spans():
    planner = planar_planner(fused_kernel=True)
    first = profiling.spans()[-1].index
    for call in range(2):
        planner.optimize(opt_iters=50)
        planner.get_traj()
        records = [r for r in spans() if r.index > first]
        first = records[-1].index
        roots = [r for r in records if r.parent < 0]
        assert [(r.name[len(P):], r.n) for r in roots] == [("planner.optimize", 50),
                                                           ("planner.get_traj", None)]
        opt = roots[0]
        want = [("planner.fused_loop", 49), ("planner.flat", 1)]
        assert children(records, opt) == ([("planner.fused_build", None)] if call == 0 else []) \
            + want
        flat = next(r for r in records if r.name == P + "planner.flat")
        assert children(records, flat) == [("step.draw", None), ("step.cost", None),
                                           ("step.prior_term", None), ("step.update", None)]
        assert all(r.root == opt.index for r in records if r.index < roots[1].index)
        loop = next(r for r in records if r.name == P + "planner.fused_loop")
        assert loop.device_ms is None  # a CPU path records no device pair
        assert opt.start_ns <= loop.start_ns <= loop.end_ns <= flat.start_ns <= opt.end_ns


def test_route_counters_count_each_route():
    fused = planar_planner(fused_kernel=True)
    flat = planar_planner(fused_kernel=False)
    dof = planar_planner(sample_method="dof")
    before = counters()
    fused.optimize(opt_iters=10)
    fused.optimize(opt_iters=10)
    flat.optimize(opt_iters=3)
    dof.optimize(opt_iters=2)
    after = counters()
    gained = {r: after["iterations"][r] - before["iterations"][r] for r in profiling.ROUTES}
    assert gained == {"fused": 18, "flat": 5, "dof": 2, "planes": 0}
    assert after["executor_builds"] - before["executor_builds"] == 1
    assert [r.name[len(P):] for r in spans() if r.name.endswith(".dof")] == ["planner.dof"]


def panda_planner(**kw):
    """The Panda on the fast stack (``QuadraticCost`` + ``PlaneFieldsCost``)
    at 1 goal x 2 particles, 4 samples, T = 128: the dof route, on the CPU."""
    from stoch_gpmp_tpu_torch.problems import PANDA_DT, _panda_setup, _panda_stack

    chain, target_h, _, start = _panda_setup(torch.float32, "cpu")
    goals = start[None].clone()
    cost = _panda_stack(chain, target_h, start, goals, 128, fast=True)
    return StochGPMP(
        num_particles_per_goal=2, num_samples=4, traj_len=128, dt=PANDA_DT, n_dof=7,
        opt_iters=1, start_state=start, multi_goal_states=goals, cost=cost, step_size=0.1,
        sigma_start_init=1e-4, sigma_goal_init=0.1, sigma_gp_init=0.8, sigma_start_sample=1e-3,
        sigma_goal_sample=0.07, sigma_gp_sample=0.1, seed=0, device="cpu", **kw)


DOF_STEP = [("dof.draw", None), ("dof.quad", None), ("dof.fields", None), ("dof.update", None)]


def test_dof_route_opens_its_step_spans():
    planner = panda_planner()
    roots = [r.name[len(P):] for r in spans() if r.parent < 0]
    assert roots[:2] == ["costs.quadratic", "costs.plane_fields"]
    first = spans()[-1].index
    observation = {"obstacle_spheres": torch.tensor([[[0.7, 0.1, 0.8, 0.15]]])}
    planner.optimize(opt_iters=3, observation=observation)
    records = [r for r in spans() if r.index > first]
    dof = next(r for r in records if r.name == P + "planner.dof")
    assert dof.n == 3 and children(records, dof) == DOF_STEP * 3
    fused = panda_planner(fused_kernel=True)
    first = spans()[-1].index
    fused.optimize(opt_iters=3, observation=observation)
    records = [r for r in spans() if r.index > first]
    opt = next(r for r in records if r.name == P + "planner.optimize")
    assert [n for n, _ in children(records, opt)] == ["planner.fused_build", "planner.fused_loop",
                                                       "planner.dof"]
    dof = next(r for r in records if r.name == P + "planner.dof")
    assert dof.n == 1 and children(records, dof) == DOF_STEP


@pytest.mark.parametrize("kw", [dict(fused_kernel=True), dict(fused_kernel=False)],
                         ids=["fused", "flat"])
def test_planar_routes_open_no_dof_spans(kw):
    planner = planar_planner(**kw)
    planner.optimize(opt_iters=3)
    names = {r.name[len(P):] for r in spans()}
    assert {"planner.optimize", "step.draw"} <= names
    assert not {n for n in names if n.startswith("dof.")} | {"costs.plane_fields"} & names


def test_counters_read_the_wrappers(monkeypatch):
    from stoch_gpmp_tpu_torch.ops.kernels import bidiag_scan, fused_step

    monkeypatch.setattr(fused_step.fused_planar_step, "launches", 499)
    monkeypatch.setattr(bidiag_scan.bidiag_scan, "staged_launches", 3)
    launches = counters()["launches"]
    assert launches["fused_planar_step"] == {"launches": 499}
    assert launches["bidiag_scan"]["staged_launches"] == 3
    assert set(launches["bidiag_scan"]) == {"launches", "generic_launches", "staged_launches"}


def test_ring_wraps_and_reports_a_lost_range(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 8)
    profiling.reset()
    for i in range(5):
        with annotate("outer", n=i):
            with annotate("inner"):
                pass
    ring = profiling._ring
    # records close inner first: 1, 0, 3, 2, ...; the last two written (9, 8)
    # took the slots of the first two (1, 0)
    starts = {r[0]: r[2] for r in ring.records}
    assert sorted(starts) == list(range(2, 10))
    assert 0 < ring.lost_ns < starts[2]
    later = spans(starts[2] * 1e-9)
    assert [r.index for r in later] == list(range(2, 10))
    assert spans() is None
    assert spans(ring.lost_ns * 1e-9) is None
    outer = [r for r in later if r.name == P + "outer"]
    assert [r.n for r in outer] == [1, 2, 3, 4]
    assert all(r.parent == r.index - 1 for r in later if r.name == P + "inner")


class FakeEvent:
    """A CUDA event that completes when its test says so and counts
    synchronises."""

    syncs = 0
    done = False

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = len(FakeEvent.log)
        FakeEvent.log.append(self)

    def synchronize(self):
        FakeEvent.syncs += 1
        FakeEvent.done = True

    def elapsed_time(self, end):
        if not FakeEvent.done:
            raise RuntimeError("Both events must be completed before calculating elapsed time.")
        return float(end.t - self.t)


def fake_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(profiling, "_current_stream", lambda: "stream")
    monkeypatch.setattr(FakeEvent, "log", [], raising=False)
    monkeypatch.setattr(FakeEvent, "syncs", 0)
    monkeypatch.setattr(FakeEvent, "done", False)


def test_device_pairs_resolve_without_a_synchronise(monkeypatch):
    fake_events(monkeypatch)
    for i in range(3):
        with annotate("loop", n=i, device=True):
            pass
    assert FakeEvent.syncs == 0 and profiling._ring.pairs == 3  # none had passed
    FakeEvent.done = True
    with annotate("loop", n=3, device=True):  # resolves the three, reuses a pair
        pass
    assert FakeEvent.syncs == 0 and profiling._ring.pairs == 3
    assert [r.device_ms for r in spans()] == [1.0, 1.0, 1.0, 1.0]
    assert FakeEvent.syncs == 1  # reading the ring waits for the last pair only


def test_device_pairs_are_bounded(monkeypatch):
    fake_events(monkeypatch)
    for _ in range(profiling.EVENT_PAIRS + 5):
        with annotate("loop", n=1, device=True):
            pass
    assert profiling._ring.pairs == profiling.EVENT_PAIRS
    timed = [r.device_ms is not None for r in spans()]
    assert timed == [True] * profiling.EVENT_PAIRS + [False] * 5


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    planner = planar_planner(fused_kernel=True)
    planner.optimize(opt_iters=3)
    assert any(r.name == P + "planner.fused_loop" for r in spans())


def test_trace_holds_the_program_spans_around_their_operations(tmp_path):
    planner = planar_planner(fused_kernel=True)
    with profiling.trace(str(tmp_path)):
        planner.optimize(opt_iters=5)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith(P)}
    assert {P + n for n in ("planner.optimize", "planner.fused_loop", "planner.flat",
                            "step.draw", "step.cost", "step.prior_term",
                            "step.update")} <= set(ranges)
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]

    def inside(span):
        a, b = span["ts"], span["ts"] + span["dur"]
        return [e["name"] for e in ops if a <= e["ts"] and e["ts"] + e["dur"] <= b]

    assert "aten::randn" in inside(ranges[P + "step.draw"])
    assert "aten::softmax" in inside(ranges[P + "step.update"])
    assert inside(ranges[P + "planner.fused_loop"])
    assert set(inside(ranges[P + "planner.flat"])) <= set(inside(ranges[P + "planner.optimize"]))


@pytest.mark.cuda
def test_trace_puts_each_kernel_under_its_span_on_the_card(tmp_path):
    """On the card, every K2 launch lies in ``planner.fused_loop``, the
    flat iteration's K1 in ``planner.flat`` > ``step.cost``, and the
    priors' kernels in ``gp.prior`` (by the launch each kernel correlates
    with); the fused loop's span carries its CUDA-event time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    planner = planar_planner("cuda", fused_kernel=True)
    planner.optimize(opt_iters=3)  # builds the kernels and the executor
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        planner.reset()
        planner.optimize(opt_iters=20)
        planner.get_traj()
        torch.cuda.synchronize()
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith(P)]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat", "").startswith("cuda_")  # the runtime's or the lower API's launch
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]

    def spans_of(kernel):
        launch = launches.get(kernel.get("args", {}).get("correlation"))
        if launch is None:
            return set()
        return {a["name"][len(P):] for a in ranges if a["ts"] <= launch["ts"]
                and launch["ts"] + launch["dur"] <= a["ts"] + a["dur"]}

    k2 = [k for k in kernels if "fused_planar_step_kernel" in k["name"]]
    assert len(k2) == 19 and all("planner.fused_loop" in spans_of(k) for k in k2)
    k1 = [k for k in kernels if "raster_field_kernel" in k["name"]]
    assert k1 and all({"planner.flat", "step.cost"} <= spans_of(k) for k in k1)
    assert sum("gp.prior" in spans_of(k) for k in kernels) > 100
    loop = [r for r in spans() if r.name == P + "planner.fused_loop"][-1]
    assert loop.n == 19 and loop.device_ms > 0
