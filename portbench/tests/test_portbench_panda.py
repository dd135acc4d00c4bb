"""The Panda cell on the CPU at a small size (2 goals x 2 particles, S = 4,
T = 128, in float64 so that the program's plain versions agree with the
reference to rounding): the reference against the program (FK, the
priors, the costs against the plain K5, K3 and the dof route's fields),
the scene's spheres, K5's Philox layout, the counts, the span readers, and
the check: a sound run is correct and each fault planted under the timed
path is not. The card's draws, replay and controls are in
``test_portbench_panda_cuda.py``."""

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.counts import panda as counts
from portbench.counts import peaks
from portbench.problems.panda import Problem, empty_scene, make_spheres, philox_weighted_draw
from portbench.reference import philox, philox_dof
from portbench.reference.panda import PandaProblem, fk, planes, tmajor
from portbench.tests.helpers import config

F64 = torch.float64
CELL = "panda-multigoal.replan"
SEED, SECONDS = 3_000_000_023, 1.0
QUICK = dict(iters_per_plan=10, iters_per_call=5, warm_requests=1, trace_requests=1)


def small(cfg: dict) -> dict:
    return {**cfg, "goals": cfg["goals"][:2], "particles_per_goal": 2, "num_samples": 4,
            "dtype": "float64"}


def run_small(monkeypatch, trace=False):
    load = harness.load_json

    def patched(kind, name):
        data = load(kind, name)
        return {"configs": small, "traffic": lambda d: {**d, **QUICK}}.get(kind, dict)(data)

    monkeypatch.setattr(harness, "load_json", patched)
    return harness.run_cell(CELL, SEED, SECONDS, trace, torch.device("cpu"), time.perf_counter())


# --- the reference against the program ----------------------------------------


def test_fk_matches_program():
    from stoch_gpmp_tpu_torch.kinematics import franka_panda

    q = torch.rand(256, 7, dtype=F64, generator=torch.Generator().manual_seed(3)) * 6 - 3
    poses = franka_panda(F64).fk(q)
    pos, rot = fk(q)
    assert torch.allclose(pos, poses[..., :3, 3], rtol=0, atol=1e-14)
    assert torch.allclose(rot, poses[:, -1, :3, :3], rtol=0, atol=1e-14)


def test_plane_layouts_match_program():
    from stoch_gpmp_tpu_torch.gp.dof_factored import plane_perm, to_dof_planes

    x = torch.randn(3, 5, 16, 14, dtype=F64)
    assert torch.equal(planes(x), to_dof_planes(x))
    lanes = torch.arange(32)[None]
    assert torch.equal(tmajor(lanes)[0], torch.as_tensor(plane_perm(16)).argsort())


def test_priors_and_quadratic_match_program():
    from stoch_gpmp_tpu_torch.costs import CostGP, CostGoalPrior
    from stoch_gpmp_tpu_torch.gp.dof_factored import DofQuadraticCost
    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior

    cfg = small(config("panda-multigoal"))
    ref = PandaProblem(cfg)
    start, goals = torch.tensor(cfg["start"], dtype=F64), torch.tensor(cfg["goals"], dtype=F64)
    s, i, c = cfg["sample_sigmas"], cfg["init_sigmas"], cfg["cost"]
    kw = dict(goal_states=goals, dtype=F64, device="cpu")
    sample = make_gp_prior(7, 128, cfg["dt"], start, s["start"], s["gp"], sigma_goal=s["goal"],
                           **kw)
    w = sample.dof.w_dof
    assert torch.allclose(ref.w_plane, w, rtol=0, atol=1e-9 * float(w.abs().max()))
    init = make_gp_prior(7, 128, cfg["dt"], start, i["start"], i["gp"], sigma_goal=i["goal"],
                         **kw)
    lam = init.precision.to_dense()
    assert torch.allclose(ref.chol_init @ ref.chol_init.T, lam, rtol=1e-12,
                          atol=1e-12 * float(lam.abs().max()))
    assert torch.allclose(ref.init_means(), init.means, rtol=0, atol=1e-12)
    gp = CostGP.create(7, 128, start, cfg["dt"], {"sigma_start": c["sigma_start"],
                                                  "sigma_gp": c["sigma_gp"]}, dtype=F64)
    goal = CostGoalPrior.create(7, 128, goals, sigma_goal_prior=c["sigma_goal_prior"], dtype=F64)
    a_dof = DofQuadraticCost.from_gp_and_goal_prior(gp, goal, 128).a_dof
    perm = tmajor(torch.arange(256)[None])[0].argsort()
    dense = (ref.jac.T @ torch.block_diag(*ref.kw) @ ref.jac)[perm][:, perm]
    assert torch.allclose(dense, a_dof, rtol=1e-12, atol=1e-12 * float(a_dof.abs().max()))


@pytest.fixture(scope="module")
def built():
    """A small plan whose first call built its plain K5 step, its reference,
    and seeded means and draws around the plan's means."""
    cfg = small(config("panda-multigoal"))
    problem = Problem(cfg, "cpu")
    plan = problem.plan(11, 12)
    plan.planner.optimize(opt_iters=2, observation=plan.observation)
    step = plan.planner._fused[1].step
    gen = torch.Generator().manual_seed(5)
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes

    mu = to_dof_planes(plan.planner.particle_means)
    mu = mu + 0.05 * torch.randn(mu.shape, dtype=F64, generator=gen)
    eps = torch.randn((7, mu.shape[1], 4, 256), dtype=F64, generator=gen)
    return plan, step, PandaProblem(cfg), mu, eps


def test_costs_match_the_plain_versions(built):
    """Against the plain K5 (its SE(3) angle by the A&S polynomial, within 2e-8
    rad: ~4e-8 of a cost the goal term dominates, so rtol 1e-7), the plain
    K3 (the quadratic and the importance term in residual form, float64
    sums of positive terms: rtol 1e-10) and the dof route's fields (the
    plain K4 and the exact arccos: rtol 1e-10)."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import prec_u_planes
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import fused_panda_dof_step_plain
    from stoch_gpmp_tpu_torch.ops.kernels.stencil import dof_quad_eval_plain

    plan, step, ref, mu, eps = built
    _, k5 = fused_panda_dof_step_plain(step, mu, eps)
    corr = (eps.reshape(-1, 256) @ step.w_dof).reshape(eps.shape)
    x = mu[:, :, None] + corr
    c_ref = ref.costs(x, mu, plan.spheres)
    assert torch.allclose(k5, c_ref, rtol=1e-7, atol=0)
    p = step.dof_prior
    pu = prec_u_planes(mu, p.q_i2, p.k_s2, p.k_g2, p.dt)
    rows = x.reshape(7, -1, 256)
    k3 = dof_quad_eval_plain(step.dof_quad, rows, pu=pu, temperature=1.0, num_samples=4)
    quad = ref.quadratic(x) + ref.importance(x, mu)
    assert torch.allclose(k3.reshape(quad.shape), quad, rtol=1e-10, atol=0)
    fields = plan.planner.cost.costs[1].eval_dof_planes(rows, observation=plan.observation)
    assert torch.allclose(fields.reshape(quad.shape), c_ref - quad, rtol=1e-10, atol=0)


def test_scene_terms_match_the_plain_versions(built):
    """The obstacle term alone, as each plain version computes it (its costs
    less those with the spheres moved away, so the goal's A&S angle and the
    quadratic cancel), against the reference's: float64 sums of positive
    terms, rtol 1e-9 of a term that is ~1e-4 of the cost."""
    from dataclasses import replace

    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import fused_panda_dof_step_plain

    plan, step, ref, mu, eps = built
    x = mu[:, :, None] + (eps.reshape(-1, 256) @ step.w_dof).reshape(eps.shape)
    _, scene = ref.costs_and_scene(x, mu, plan.spheres)
    assert float(scene.min()) > 1e-3 * float(scene.max()) > 0
    bare = replace(step, spheres=empty_scene(step.spheres))
    k5 = (fused_panda_dof_step_plain(step, mu, eps)[1]
          - fused_panda_dof_step_plain(bare, mu, eps)[1])
    assert torch.allclose(k5, scene, rtol=1e-9, atol=0)
    fields = plan.planner.cost.costs[1].eval_dof_planes
    empty = {"obstacle_spheres": empty_scene(plan.observation["obstacle_spheres"])}
    rows = x.reshape(7, -1, 256)
    k4 = fields(rows, observation=plan.observation) - fields(rows, observation=empty)
    assert torch.allclose(k4.reshape(scene.shape), scene, rtol=1e-9, atol=0)


def test_k5_step_is_the_reference_iteration(built):
    """The plain K5's new means against the reference's iteration on the
    same draws (the weights of the reference's costs)."""
    from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import fused_panda_dof_step_plain

    plan, step, ref, mu, eps = built
    new, _ = fused_panda_dof_step_plain(step, mu, eps)
    x = mu[:, :, None] + (eps.reshape(-1, 256) @ ref.w_plane).reshape(eps.shape)
    w = ref.weights(ref.costs(x, mu, plan.spheres))
    want = mu + ref.step_size * torch.einsum("ps,dpsk->dpk", w, x - mu[:, :, None])
    assert torch.allclose(new, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", [0, 5, 2**40 + 3])
def test_spheres_are_the_upstream_rule(seed):
    from stoch_gpmp_tpu_torch.problems import panda_spheres

    want = panda_spheres(np.random.default_rng(seed), 5)[0]
    got = make_spheres(config("panda-multigoal"), seed)
    assert np.array_equal(got, want.astype(np.float32).astype(np.float64))
    assert 0.1 <= got[:, 3].min() and got[:, 3].max() <= 0.2


def test_dof_normals_layout():
    seed = (9 << 32) | 4242
    z = philox_dof.dof_normals(seed, 3, 5, 7, 64)
    assert z.shape == (3, 5, 7, 64)
    # dof 2, particle 4, pair 3 (samples 6 and 7; S = 7 keeps 6), lane 11
    bits = philox.philox4x32_10(np.uint32(11), np.uint32(3), np.uint32(4), np.uint32(2), 4242, 9)
    a, _ = philox.box_muller(bits[0], bits[1])
    assert z[2, 4, 6, 11] == a
    bits = philox.philox4x32_10(np.uint32(40), np.uint32(0), np.uint32(1), np.uint32(0), 4242, 9)
    assert tuple(z[0, 1, :2, 40]) == philox.box_muller(bits[0], bits[1])
    w = torch.softmax(torch.randn(5, 7, dtype=F64, generator=torch.Generator().manual_seed(1))
                      * 40, dim=1)
    want = torch.einsum("ps,dpsm->dpm", w, torch.as_tensor(z))
    assert torch.allclose(philox_weighted_draw(w, seed, 3, 64), want, rtol=0, atol=1e-10)


# --- the counts -------------------------------------------------------------------


def test_structural_zeros_as_the_reference_builds_them():
    cfg = config("panda-multigoal")
    ref = PandaProblem(cfg)
    assert int((ref.w_plane != 0).sum()) == counts.w_nnz(cfg) == 32896
    assert int((ref.lam1 != 0).sum()) == 4 * (3 * 128 - 2)


def test_iteration_counts_by_hand():
    cfg = config("panda-multigoal")
    work = counts.iteration(cfg, n_obst=5)
    rows = 7 * 1280 * 8
    sampling = rows * (2 * 32896 + 256)
    prior = 7 * 1280 * 2 * 4 * 382 + rows * 2 * 256
    quadratic = rows * (127 * 16 + 12)
    # FK: translations 8 non-zero components x 6, 7 revolute turns x 20, 2 fixed turns x 18
    assert counts.fk_flops() == 48 + 140 + 36
    point = 224 + 11 * (36 + 9 * 5) + 3
    fields = 1280 * 8 * (127 * point + 51)
    update = 1280 * 8 * 4 + 7 * 1280 * (3 * 8 * 256 + 2 * 256)
    assert work["flops"] == sampling + prior + quadratic + fields + update == 6_459_054_080
    assert work["bytes"] == 4 * (2 * 7 * 1280 * 256 + 32896 + 1280 * 8 + 10 * 7 * 2 + 20)
    assert peaks.least_seconds(work["flops"], work["bytes"]) == pytest.approx(9.64038e-5,
                                                                              rel=1e-5)


# --- the readers ------------------------------------------------------------------


def test_span_readers(monkeypatch):
    """A traced CPU run reads the dof route's spans (no K5 on the CPU, so no
    roofline); a program without the ``dof.fields`` span leaves that
    metric out and keeps the route's."""
    from portbench.metrics import dof_fields_ms, dof_iter_ms
    from stoch_gpmp_tpu_torch.utils.profiling import Span

    out = run_small(monkeypatch, trace=True)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == {"dof_iter_ms", "dof_fields_ms"} and all(v > 0 for v in got.values())
    older = [Span(1, "stoch_gpmp.planner.dof", 0, 4_000_000, -1, 1, 1, None)]
    monkeypatch.setattr(dof_fields_ms, "window_spans", lambda ctx: older)
    monkeypatch.setattr(dof_iter_ms, "window_spans", lambda ctx: older)
    assert dof_fields_ms.read({}) is None and dof_iter_ms.read({}) == 4.0


def test_no_k5_no_roofline():
    from portbench.harness import load_module

    ctx = {"trace": {"ops": [("fused_planar_step_kernel", 0.0, 3.0)], "iters": 1},
           "cfg": config("panda-multigoal"), "plan": object()}
    assert load_module("metrics", "k5_roofline").read(ctx) is None


# --- the check --------------------------------------------------------------------


def test_sound_run_is_correct(monkeypatch):
    from stoch_gpmp_tpu_torch.utils.profiling import counters

    before = counters()["iterations"]
    out = run_small(monkeypatch)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    gained = {r: counters()["iterations"][r] - before[r] for r in before}
    calls = gained["dof"]
    assert calls > 0 and gained["fused"] == 4 * calls and gained["flat"] == 0


def _half(costs, temperature):
    """The softmax over the first half of the samples only."""
    h = costs.shape[1] // 2
    w = torch.zeros_like(costs)
    w[:, :h] = torch.softmax(-costs[:, :h] / temperature, dim=1)
    return w


def fault_dof_unchanged(monkeypatch):
    from stoch_gpmp_tpu_torch.planners import stoch_gpmp as mod

    route = mod._stoch_gpmp_optimize_dof

    def unchanged(sampler, cost, state, *a, **kw):
        return state, route(sampler, cost, state, *a, **kw)[1]

    monkeypatch.setattr(mod, "_stoch_gpmp_optimize_dof", unchanged)


def fault_dof_half(monkeypatch):
    from dataclasses import replace

    from stoch_gpmp_tpu_torch.planners import stoch_gpmp as mod

    route = mod._stoch_gpmp_optimize_dof

    def half(sampler, cost, state, *a, **kw):
        new, aux = route(sampler, cost, state, *a, **kw)
        w = _half(aux.costs, kw["temperature"])
        grad = torch.einsum("ps,pstd->ptd", w, aux.samples - state.particle_means[:, None])
        means = state.particle_means + kw["step_size"] * grad
        return replace(new, particle_means=means), replace(aux, weights=w, grad=grad)

    monkeypatch.setattr(mod, "_stoch_gpmp_optimize_dof", half)


def fault_k5_unchanged(monkeypatch):
    from stoch_gpmp_tpu_torch.ops.kernels import panda_step_dof as mod

    plain = mod.fused_panda_dof_step_plain
    monkeypatch.setattr(mod, "fused_panda_dof_step_plain",
                        lambda step, means, eps: (means, plain(step, means, eps)[1]))


def fault_k5_half(monkeypatch):
    from stoch_gpmp_tpu_torch.ops.kernels import panda_step_dof as mod

    plain = mod.fused_panda_dof_step_plain

    def half(step, means, eps):
        _, costs = plain(step, means, eps)
        corr = (eps.reshape(-1, eps.shape[-1]) @ step.w_dof).reshape(eps.shape)
        w = _half(costs, step.temperature)
        return means + step.step_size * torch.einsum("ps,dpsk->dpk", w, corr), costs

    monkeypatch.setattr(mod, "fused_panda_dof_step_plain", half)


def fault_k5_loop_unchanged(monkeypatch):
    """The K5 loop runs its launches but keeps the means it was given."""
    from stoch_gpmp_tpu_torch.ops.kernels import panda_step_dof as mod

    loop = mod.fused_panda_dof_optimize
    monkeypatch.setattr(mod, "fused_panda_dof_optimize",
                        lambda step, means, generator, n: (loop(step, means, generator, n),
                                                           means)[1])


def fault_k5_loop_skips_a_launch(monkeypatch):
    """The K5 loop draws its seeds but leaves out its first launch."""
    from stoch_gpmp_tpu_torch.ops.kernels import panda_step_dof as mod

    from portbench.check import SEED_HIGH

    def skip(step, means, generator, n):
        seeds = torch.randint(0, SEED_HIGH, (n,), generator=generator,
                              device=generator.device).tolist()
        for seed in seeds[1:]:
            means, _ = step(means, seed=seed)
        return means

    monkeypatch.setattr(mod, "fused_panda_dof_optimize", skip)


def fault_trajectory(monkeypatch):
    from stoch_gpmp_tpu_torch.planners import StochGPMP

    get = StochGPMP.get_traj
    monkeypatch.setattr(StochGPMP, "get_traj", lambda self, mode="best": get(self, mode) + 1e-3)


def fault_trajectory_of_another_particle(monkeypatch):
    """``get_traj`` returns the heaviest sample of another particle than the
    one of the first largest weight: here one that ties it at weight 1."""
    from stoch_gpmp_tpu_torch.planners import StochGPMP

    def other(self, mode="best"):
        aux = self._recent_aux
        w = aux.weights.clone()
        w[int(torch.argmax(w.reshape(-1))) // self.num_samples] = -1.0
        p, s = divmod(int(torch.argmax(w.reshape(-1))), self.num_samples)
        return aux.samples[p, s]

    monkeypatch.setattr(StochGPMP, "get_traj", other)


def _observing(monkeypatch, spheres_of):
    """The planner plans with ``spheres_of(spheres)`` in place of the
    observation's spheres."""
    from stoch_gpmp_tpu_torch.planners import StochGPMP

    optimize = StochGPMP.optimize

    def planned(self, *a, observation, **kw):
        obs = {**observation, "obstacle_spheres": spheres_of(observation["obstacle_spheres"])}
        return optimize(self, *a, observation=obs, **kw)

    monkeypatch.setattr(StochGPMP, "optimize", planned)


def fault_scene_ignored(monkeypatch):
    """K5 and the dof route plan in an empty scene: the spheres moved away."""
    _observing(monkeypatch, empty_scene)


def fault_scene_stale(monkeypatch):
    """K5 and the dof route plan in the previous plan's scene."""
    scenes = []

    def previous(spheres):
        i = next((k for k, v in enumerate(scenes) if torch.equal(v, spheres)), None)
        if i is None:
            scenes.append(spheres)
            i = len(scenes) - 1
        return scenes[max(i - 1, 0)]

    _observing(monkeypatch, previous)


def fault_k5_ignores_scene(monkeypatch):
    """K5 is built with the spheres moved away; the dof route sees them."""
    from stoch_gpmp_tpu_torch.ops.kernels import panda_step_dof as mod

    make = mod.make_fused_panda_dof_step
    monkeypatch.setattr(mod, "make_fused_panda_dof_step",
                        lambda *, spheres, **kw: make(spheres=empty_scene(spheres), **kw))


def fault_dof_route_ignores_scene(monkeypatch):
    """The dof route's fields take no observation; K5 sees the spheres."""
    from stoch_gpmp_tpu_torch.costs import PlaneFieldsCost

    fields = PlaneFieldsCost.eval_dof_planes
    monkeypatch.setattr(PlaneFieldsCost, "eval_dof_planes",
                        lambda self, x, observation=None: fields(self, x, observation=None))


FAULTS = [fault_dof_unchanged, fault_dof_half, fault_k5_unchanged, fault_k5_half,
          fault_k5_loop_unchanged, fault_k5_loop_skips_a_launch, fault_trajectory,
          fault_trajectory_of_another_particle, fault_scene_ignored, fault_scene_stale,
          fault_k5_ignores_scene, fault_dof_route_ignores_scene]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[6:])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_small(monkeypatch)
    print(fault.__name__, {k: c["value"] for k, c in out["checks"].items()})
    assert not out["correct"], out["checks"]
