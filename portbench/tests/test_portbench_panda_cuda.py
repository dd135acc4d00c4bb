"""On the card, at the Panda cell's own size: K5's in-kernel draw against
the reference's redraw (``reference/philox_dof.py``), K5's replay bit for
bit, one plan's launches by the program's counters, and the precision
controls, each on three seeds, which must come out not correct: the
program in TF32 (it fails), its draws in TF32, and the reference in
float32 with TF32 products in K5's place and in the dof route's costs.
Besides, the two scene faults of ``test_portbench_panda.py`` (the spheres
ignored, the previous plan's spheres) at the cell's size. Run with
``python -m pytest portbench/tests/test_portbench_panda_cuda.py -m cuda -s``
(``-s`` prints the readings)."""

import json

import pytest
import torch

from portbench.problems.panda import empty_scene
from portbench.reference.panda import PandaProblem
from portbench.reference.philox_dof import dof_normals
from portbench.tests.helpers import config, run
from portbench.tests.test_portbench_panda import fault_scene_ignored, fault_scene_stale

pytestmark = pytest.mark.cuda

SEEDS = (3_100_000_011, 3_100_000_012, 3_100_000_013)
CELL = "panda-multigoal.replan"
SECONDS = 4.0


def _session(card, seed):
    from portbench.harness import Session, load_json

    return Session(config("panda-multigoal"), load_json("traffic", "replan"), seed, card)


def _planned(card, seed):
    """A plan of the cell whose first call has built its K5 step."""
    plan = _session(card, seed).problem.plan(seed + 1, seed + 2)
    plan.planner.optimize(opt_iters=2, observation=plan.observation)
    return plan


def test_k5_draws_the_reference_philox(card):
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes

    plan = _planned(card, 5)
    step = plan.planner._fused[1].step
    mu = to_dof_planes(plan.planner.particle_means)
    n, p, m = mu.shape
    seed = (123 << 32) | 456
    eps = torch.as_tensor(dof_normals(seed, n, p, step.num_samples, m), dtype=torch.float32,
                          device=card)
    a_mu, a_c = step(mu, seed=seed)
    b_mu, b_c = step(mu, eps=eps)
    print(f"k5 philox: costs {float(((a_c - b_c).abs() / b_c.abs()).max())!r} "
          f"means {float((a_mu - b_mu).abs().max())!r}", flush=True)
    assert torch.allclose(a_c, b_c, rtol=1e-5) and torch.allclose(a_mu, b_mu, atol=1e-5)


def test_k5_replays_bit_for_bit(card):
    """The check replays a call's K5 loop launch by launch through the
    planner's step, so a launch has to give the same bits for the same
    means and seed as the loop gave."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import fused_panda_dof_optimize

    from portbench.check import SEED_HIGH

    plan = _planned(card, 7)
    step = plan.planner._fused[1].step
    mu = to_dof_planes(plan.planner.particle_means)
    gen = torch.Generator(device=card).manual_seed(11)
    state = gen.get_state()
    looped = fused_panda_dof_optimize(step, mu, gen, 49)
    gen.set_state(state)
    replayed = mu
    for seed in torch.randint(0, SEED_HIGH, (49,), generator=gen, device=card).tolist():
        replayed = step(replayed, seed=seed)[0]
    assert torch.equal(looped, replayed)


def test_one_plan_launches(card):
    """One request of the cell: K5 runs ``iters_per_call - 1`` launches a
    call, the dof route (K3, K4) one iteration a call, C1 two launches a
    prior, one executor build."""
    from stoch_gpmp_tpu_torch.utils.profiling import counters

    s = _session(card, 9)
    s.loop.request(record=False)  # builds every kernel
    torch.cuda.synchronize()
    before = counters()
    s.loop.request(record=False)
    torch.cuda.synchronize()
    after = counters()
    tr = s.traffic
    calls = tr["iters_per_plan"] // tr["iters_per_call"]
    gained = {k: after["launches"][k]["launches"] - before["launches"][k]["launches"]
              for k in ("fused_panda_dof_step", "dof_quad_eval", "fk_link_fields_cost_rows",
                        "block_chol")}
    print("one plan", gained, flush=True)
    assert gained == {"fused_panda_dof_step": calls * (tr["iters_per_call"] - 1),
                      "dof_quad_eval": calls, "fk_link_fields_cost_rows": calls,
                      "block_chol": 4}
    iters = {r: after["iterations"][r] - before["iterations"][r] for r in after["iterations"]}
    assert iters == {"fused": calls * (tr["iters_per_call"] - 1), "flat": 0, "dof": calls,
                     "planes": 0}
    assert after["executor_builds"] - before["executor_builds"] == 1


def _report(tag, seed, out):
    print(f"{tag} {CELL} {seed} " + json.dumps(out["checks"]), flush=True)


def test_control_the_program_in_tf32(card, monkeypatch):
    """The program's own TF32 path (PyTorch's matmul flag) in place of its
    float32 products. The priors' precision (weights up to 2e11 that
    cancel, ``gp/prior.py build_precision``) is then no longer positive
    definite: the plans' trajectories are NaN and the run fails in its
    set-up."""
    from portbench.harness import NonFinite

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for seed in SEEDS:
        with pytest.raises(NonFinite):
            run(CELL, seed, SECONDS, card)
        print(f"control-program-tf32 {CELL} {seed} the set-up's plan is NaN", flush=True)


def test_control_the_draws_in_tf32(card, monkeypatch):
    """The program's TF32 path everywhere but the priors' build (which it
    breaks, above): the init draw and the dof route's draws."""
    from stoch_gpmp_tpu_torch.planners import stoch_gpmp

    build = stoch_gpmp.make_gp_prior

    def float32_prior(*a, **kw):
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return build(*a, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = True

    monkeypatch.setattr(stoch_gpmp, "make_gp_prior", float32_prior)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for seed in SEEDS:
        out = run(CELL, seed, SECONDS, card)
        _report("control-draws-tf32", seed, out)
        assert not out["correct"]


def test_control_the_reference_in_the_dof_route(card, monkeypatch):
    """The reference's costs, in float32 with TF32 products, in place of the
    program's in the dof route's iteration (the program's draw, softmax
    and update)."""
    from dataclasses import replace

    from stoch_gpmp_tpu_torch.gp.dof_factored import from_dof_planes, to_dof_planes
    from stoch_gpmp_tpu_torch.planners import stoch_gpmp

    ref = PandaProblem(config("panda-multigoal"))

    def route(sampler, cost, state, observation, *, num_samples, temperature, step_size,
              **kw):
        mu = to_dof_planes(state.particle_means)
        x, corr = sampler.dof.sample_planes(state.generator, mu, num_samples)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        costs = ref.costs(x, mu, observation["obstacle_spheres"][0].cpu(), dtype=torch.float32)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
        w = torch.softmax(-costs / temperature, dim=1)
        grad = torch.einsum("ps,dpsk->dpk", w, corr)
        aux = stoch_gpmp.StochGPMPAux(samples=from_dof_planes(x), costs=costs, weights=w,
                                      grad=from_dof_planes(grad))
        return replace(state, particle_means=from_dof_planes(mu + step_size * grad)), aux

    monkeypatch.setattr(stoch_gpmp, "_stoch_gpmp_optimize_dof", route)
    for seed in SEEDS:
        out = run(CELL, seed, SECONDS, card)
        _report("control-reference-dof-route", seed, out)
        assert not out["correct"]


class FusedStepControl:
    """The reference in the fused kernel's place, as the precision control:
    one iteration from dof planes ``means [n, P, 2T]`` with the kernel's
    Philox draw for ``seed``, on the means' device in float32 with every
    product in TF32 (the precision below the configuration's float32).
    Returns ``(new_means, costs)`` as the kernel does."""

    def __init__(self, problem: PandaProblem, num_samples: int, spheres):
        self.pb, self.num_samples, self.spheres = problem, num_samples, spheres

    def __call__(self, means: torch.Tensor, *, seed: int):
        pb, f32 = self.pb, torch.float32
        n, p, m = means.shape
        eps = torch.as_tensor(dof_normals(seed, n, p, self.num_samples, m), dtype=f32,
                              device=means.device)
        keep = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            mu = means.to(f32)
            corr = (eps.reshape(-1, m) @ pb.w_plane.to(dtype=f32, device=means.device)
                    ).reshape(eps.shape)
            x = mu[:, :, None] + corr
            c = pb.costs(x, mu, self.spheres, dtype=f32)
            w = torch.softmax(-c / pb.temperature, dim=1)
            new = mu + pb.step_size * torch.einsum("ps,dpsk->dpk", w, corr)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = keep
        return new, c


def test_control_the_reference_in_the_k5_place(card, monkeypatch):
    """The reference, in float32 with TF32 products, in place of the K5
    launches that the check judges (and of their empty-scene twins)."""
    from portbench.problems import panda

    ref = PandaProblem(config("panda-multigoal"))

    def control(call, mu, seed, empty=False):
        spheres = empty_scene(call.plan.spheres) if empty else call.plan.spheres
        return FusedStepControl(ref, ref.cfg["num_samples"], spheres)(mu, seed=seed)

    monkeypatch.setattr(panda.Problem, "k5_launch", staticmethod(control))
    for seed in SEEDS:
        out = run(CELL, seed, SECONDS, card)
        _report("control-reference-tf32", seed, out)
        assert not out["correct"]


@pytest.mark.parametrize("fault", [fault_scene_ignored, fault_scene_stale],
                         ids=lambda f: f.__name__[6:])
def test_scene_fault_is_not_correct(card, monkeypatch, fault):
    fault(monkeypatch)
    for seed in SEEDS:
        out = run(CELL, seed, SECONDS, card)
        _report(fault.__name__, seed, out)
        assert not out["correct"]


def test_sound_runs(card):
    for seed in SEEDS:
        out = run(CELL, seed, SECONDS, card)
        _report("sound", seed, out)
        assert out["correct"]
