"""On the card: the Philox draw of the fused kernel against the reference's
redraw, and the precision controls, each on three seeds at the cell's own
size, which must come out not correct. Run with ``python -m pytest
portbench/tests/test_portbench_cuda.py -m cuda -s`` (``-s`` prints the
readings)."""

import json

import pytest
import torch

from portbench.reference import philox
from portbench.tests.helpers import config, run

pytestmark = pytest.mark.cuda

SEEDS = (3_100_000_001, 3_100_000_002, 3_100_000_003)
CELLS = ("planar-env.refine", "planar-env.demo")
SECONDS = 4.0


def test_fused_kernel_draws_the_reference_philox(card):
    from portbench.harness import Session, load_json

    s = Session(load_json("configs", "planar-env"), load_json("traffic", "refine"), 5, card)
    plan = s.problem.plan(1, 2)
    plan.planner.optimize(opt_iters=2)
    step = plan.planner._fused[1].step
    mu = plan.planner.particle_means
    seed = (123 << 32) | 456
    eps = torch.as_tensor(philox.fused_normals(seed, 15, 128, 256), dtype=torch.float32,
                          device=card)
    a_mu, a_c = step(mu, seed=seed)
    b_mu, b_c = step(mu, eps=eps)
    assert torch.allclose(a_c, b_c, rtol=1e-5) and torch.allclose(a_mu, b_mu, atol=1e-5)


def _report(tag, cell, seed, out):
    print(f"{tag} {cell} {seed} " + json.dumps(out["checks"]), flush=True)


@pytest.mark.parametrize("cell", CELLS)
def test_control_the_program_in_tf32(card, cell, monkeypatch):
    """The program's own TF32 path (PyTorch's matmul flag) in place of its
    float32 products: the priors' factors, the draws and the costs."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for seed in SEEDS:
        out = run(cell, seed, SECONDS, card)
        _report("control-program-tf32", cell, seed, out)
        assert not out["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_the_reference_in_the_fused_place(card, cell, monkeypatch):
    """The reference, in float32 with TF32 products, in place of the fused
    kernel's launches that the check judges."""
    from portbench.problems import planar
    from portbench.reference.planar import FusedStepControl, PlanarProblem

    cfg = config()

    def control(call, mu, seed):
        return FusedStepControl(PlanarProblem(cfg, call.plan.obstacles),
                                cfg["num_samples"])(mu, seed=seed)

    monkeypatch.setattr(planar.Problem, "k2_launch", staticmethod(control))
    for seed in SEEDS:
        out = run(cell, seed, SECONDS, card)
        _report("control-reference-tf32", cell, seed, out)
        assert not out["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs(card, cell):
    for seed in SEEDS:
        out = run(cell, seed, SECONDS, card)
        _report("sound", cell, seed, out)
        assert out["correct"]


def test_fused_step_replays_bit_for_bit(card):
    """The check replays a call's fused loop launch by launch and holds the
    call's last samples against where the replay ends, so a launch has to
    give the same bits for the same means and seed."""
    from portbench.harness import Session, load_json

    s = Session(load_json("configs", "planar-env"), load_json("traffic", "refine"), 7, card)
    plan = s.problem.plan(3, 4)
    plan.planner.optimize(opt_iters=2)
    step = plan.planner._fused[1].step
    a = b = plan.planner.particle_means
    for seed in range(1, 50):
        a, b = step(a, seed=seed)[0], step(b, seed=seed)[0]
    assert torch.equal(a, b)
