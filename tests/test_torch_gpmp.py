"""Gauss-Newton GPMP of the PyTorch port against the JAX package: the batched
structured factor and solve, each cost's ``gn_contrib``/``gn_rank1``, the GN
steps (structured Cholesky, dense, trust region, Woodbury), the loop, the
``GPMP`` class and the ``examples/planar_gpmp.py`` problem.

Everything runs in float64 on the CPU on inputs made with numpy from a seed,
at the configurations of ``tests/test_gpmp.py``. Tolerance: rtol 1e-9 (only
the summation order differs), relative to the largest entry.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stoch_gpmp_tpu_torch import convert  # noqa: E402
from stoch_gpmp_tpu_torch.gp.tridiag import BlockTridiag  # noqa: E402
from stoch_gpmp_tpu_torch.planners import (  # noqa: E402
    GPMP,
    build_woodbury,
    gpmp_optimize,
    gpmp_step,
    gpmp_step_woodbury,
)

RTOL = 1e-9


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _quad_problem(traj_len=12):
    """``tests/test_gpmp.py``'s quadratic stack: two goals, float64."""
    from stoch_gpmp_tpu.costs import CostComposite, CostGP, CostGoalPrior

    start = jnp.asarray([0.0, 0.0, 0.0, 0.0])
    goals = jnp.asarray([[2.0, 1.0, 0, 0], [-1.0, 2.0, 0, 0]])
    return CostComposite.create(2, traj_len, [
        CostGP.create(2, traj_len, start, 0.05, {"sigma_start": 0.01, "sigma_gp": 0.5},
                      dtype=jnp.float64),
        CostGoalPrior.create(2, traj_len, goals, sigma_goal_prior=0.02, dtype=jnp.float64),
    ])


def _field_problem():
    """``tests/test_gpmp.py``'s occupancy-grid stack (one goal, T = 24)."""
    from stoch_gpmp_tpu.costs import (
        CostCollision,
        CostComposite,
        CostGP,
        CostGoalPrior,
        OccupancyGridField,
    )

    start = jnp.asarray([-2.0, -2.0, 0.0, 0.0])
    goals = jnp.asarray([[2.0, 2.0, 0.0, 0.0]])
    xg, yg = jnp.meshgrid(jnp.arange(40.0), jnp.arange(40.0))
    grid = jnp.exp(-((xg - 20.0) ** 2 + (yg - 20.0) ** 2) / 50.0)
    return CostComposite.create(2, 24, [
        CostGP.create(2, 24, start, 0.05, {"sigma_start": 0.01, "sigma_gp": 0.5},
                      dtype=jnp.float64),
        CostGoalPrior.create(2, 24, goals, sigma_goal_prior=0.02, dtype=jnp.float64),
        CostCollision.create(2, 24, OccupancyGridField(grid=grid, cell_size=0.1),
                             sigma_coll=0.1),
    ])


def _states(means):
    from stoch_gpmp_tpu.planners.gpmp import GPMPState

    js = GPMPState(particle_means=jnp.asarray(means), key=jax.random.PRNGKey(0))
    return js, convert.gpmp_state_from_jax(js, device="cpu")


def test_batched_block_cholesky_and_solve_match_jax():
    """``BlockTridiag.cholesky`` and ``BlockBidiagChol.solve`` with a leading
    particle dimension against JAX's ``vmap`` of the unbatched ones, plus
    ``to_dense`` of both, ``add_block_diag`` and ``add_jitter``."""
    from stoch_gpmp_tpu.gp.tridiag import BlockTridiag as JBT

    rng = np.random.default_rng(0)
    p, t, d = 3, 12, 4
    a = rng.normal(size=(p, t * d, t * d))
    a = a @ np.swapaxes(a, -1, -2) + t * d * np.eye(t * d)
    diag = np.stack([a[:, i * d:(i + 1) * d, i * d:(i + 1) * d] for i in range(t)], 1)
    lower = np.stack([a[:, (i + 1) * d:(i + 2) * d, i * d:(i + 1) * d] for i in range(t - 1)], 1)
    extra = np.einsum("ptij,ptkj->ptik", *(2 * [rng.normal(size=(p, t, d, d))]))
    b = rng.normal(size=(p, t, d))

    def jax_one(dg, lo, ex, bb):
        bt = JBT(diag=dg, lower=lo).add_block_diag(ex).add_jitter(0.5)
        ch = bt.cholesky()
        return ch.diag, ch.lower, ch.solve(bb), bt.to_dense(), ch.to_dense()

    want = jax.jit(jax.vmap(jax_one))(*map(jnp.asarray, (diag, lower, extra, b)))
    bt = (BlockTridiag(torch.from_numpy(diag), torch.from_numpy(lower))
          .add_block_diag(torch.from_numpy(extra)).add_jitter(0.5))
    ch = bt.cholesky()
    for got, w in zip((ch.diag, ch.lower, ch.solve(torch.from_numpy(b)), bt.to_dense(),
                       ch.to_dense()), want):
        _close(got, w)


@pytest.mark.parametrize("which", ["gp", "goal_prior", "quadratic", "composite"])
def test_quadratic_gn_contrib_matches_jax(which):
    from stoch_gpmp_tpu.costs.quadratic import QuadraticCost

    jc = _quad_problem()
    gp, goal = jc.costs
    jcost = {"gp": gp, "goal_prior": goal, "composite": jc,
             "quadratic": QuadraticCost.from_gp_and_goal_prior(gp, goal, 12)}[which]
    tcost = convert.cost_from_jax(jcost, device="cpu")
    trajs = np.random.default_rng(1).normal(size=(4, 12, 4))
    got = tcost.gn_contrib(torch.from_numpy(trajs))
    want = jax.jit(lambda c, x: c.gn_contrib(x))(jcost, jnp.asarray(trajs))
    for name in ("diag", "lower", "g"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            _close(g, w)


def test_field_gn_through_fk_matches_jax():
    """``CostGoal(EESE3DistanceField)`` and ``CostCollision(LinkDistanceField)``
    through ``fk=chain.fk`` on the Panda chain: the composite's
    ``gn_contrib`` and each ``gn_rank1`` against JAX (``jax.grad`` through
    FK there, ``torch.autograd.grad`` here)."""
    from stoch_gpmp_tpu.costs import (
        CostCollision,
        CostComposite,
        CostGoal,
        CostGP,
        EESE3DistanceField,
        LinkDistanceField,
    )
    from stoch_gpmp_tpu.kinematics import homogeneous, z_rot
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda

    chain = franka_panda(dtype=jnp.float64)
    n, t = 7, 8
    start_q = jnp.asarray([0.0, -0.5, 0.0, -2.0, 0.0, 2.0, 0.0])
    start = jnp.concatenate([start_q, jnp.zeros_like(start_q)])
    target = homogeneous(z_rot(jnp.asarray(0.3)), jnp.asarray([0.4, 0.2, 0.5]))
    jc = CostComposite.create(n, t, [
        CostGP.create(n, t, start, 0.05, {"sigma_start": 0.001, "sigma_gp": 0.1},
                      dtype=jnp.float64),
        CostCollision.create(n, t, LinkDistanceField(), sigma_coll=0.1),
        CostGoal.create(n, t, EESE3DistanceField(target_h=target), sigma_goal=0.05),
    ], fk=chain.fk)
    means = np.asarray(start)[None, None] + 0.1 * np.random.default_rng(5).normal(size=(2, t, 14))
    obs = {"obstacle_spheres": jnp.asarray([[[0.5, 0.0, 0.5, 0.1]]])}
    tc = convert.cost_from_jax(jc, device="cpu")
    tobs = convert.observation_from_jax(obs, device="cpu")
    tm = torch.from_numpy(means)
    jm = jnp.asarray(means)

    def jax_rank1(m, o):  # as the composite calls them: the link poses and fk
        return [jc.costs[i].gn_rank1(m, x_trajs=jc._fk_trajs(m), observation=o,
                                     fk_trajs=jc._fk_trajs) for i in (1, 2)]

    rank1 = jax.jit(jax_rank1)(jm, obs)
    # JAX's composite contribution is CostGP's plus k h h^T and k h e of each
    # field (tests/test_gpmp.py test_gn_rank1_consistent_with_gn_contrib)
    want = jc.costs[0].gn_contrib(jm)
    diag, g = np.asarray(want.diag), np.asarray(want.g)
    for jh, je, jk in rank1:
        hf = np.zeros((2, t, 14))
        hf[..., :n] = np.asarray(jh)
        diag = diag + jk * np.einsum("pti,ptj->ptij", hf, hf)
        g = g + jk * hf * np.asarray(je)[..., None]
    got = tc.gn_contrib(tm, observation=tobs)
    for name, w in (("diag", diag), ("lower", want.lower), ("g", g)):
        _close(getattr(got, name), w)
    for i, (jh, je, jk) in zip((1, 2), rank1):
        h, e, k = tc.costs[i].gn_rank1(tm, x_trajs=tc._fk_trajs(tm), observation=tobs,
                                       fk_trajs=tc._fk_trajs)
        assert k == jk and bool(h.abs().max() > 0)
        _close(h, jh)
        _close(e, je)


def test_cost_gp_trajectory_matches_jax():
    from stoch_gpmp_tpu.costs.costs import CostGPTrajectory as J

    jc = J.create(2, 12, None, 0.05, {"sigma_gp": 0.5}, dtype=jnp.float64)
    tc = convert.cost_from_jax(jc, device="cpu")
    x = np.random.default_rng(2).normal(size=(5, 12, 4))
    _close(tc.eval(torch.from_numpy(x)), jc.eval(jnp.asarray(x)))
    with pytest.raises(NotImplementedError, match="no linear system"):
        tc.gn_contrib(torch.from_numpy(x))


@pytest.mark.parametrize("stack", ["quadratic", "fields"])
@pytest.mark.parametrize("method,trust_region", [
    ("cholesky", False), ("inverse", False), ("cholesky", True), ("inverse", True)])
def test_gpmp_step_matches_jax(stack, method, trust_region):
    from stoch_gpmp_tpu.planners.gpmp import gpmp_step as jstep

    jc = _quad_problem() if stack == "quadratic" else _field_problem()
    t = jc.traj_len
    js, ts = _states(0.5 * np.random.default_rng(3).normal(size=(4, t, 4)))
    kw = dict(delta=0.1 if trust_region else 1e-3, trust_region=trust_region, method=method,
              step_size=0.5)
    want = jax.jit(lambda c, st: jstep(c, st, {}, **kw))(jc, js).particle_means
    _close(gpmp_step(convert.cost_from_jax(jc, device="cpu"), ts, {}, **kw).particle_means,
           want)


@pytest.mark.parametrize("stack", ["quadratic", "fields"])
def test_woodbury_matches_jax(stack):
    """``build_woodbury`` + ``gpmp_step_woodbury`` against JAX's, and equal
    to the structured step."""
    from stoch_gpmp_tpu.planners.gpmp import build_woodbury as jbuild
    from stoch_gpmp_tpu.planners.gpmp import gpmp_step_woodbury as jwb

    jc = _quad_problem() if stack == "quadratic" else _field_problem()
    tc = convert.cost_from_jax(jc, device="cpu")
    js, ts = _states(0.5 * np.random.default_rng(4).normal(size=(4, jc.traj_len, 4)))
    jmodel, tmodel = jbuild(jc, 1e-2), build_woodbury(tc, 1e-2)
    assert tmodel.n_fields == jmodel.n_fields == (stack == "fields")
    for name in ("h0i", "wpp_tiled", "cdiag"):
        _close(getattr(tmodel, name), getattr(jmodel, name))
    got = gpmp_step_woodbury(tmodel, tc, ts, {}, step_size=0.5).particle_means
    _close(got, jax.jit(lambda st: jwb(jmodel, jc, st, {}, step_size=0.5))(js).particle_means)
    ref = gpmp_step(tc, ts, {}, delta=1e-2, trust_region=False, step_size=0.5).particle_means
    _close(got, ref, rtol=1e-7)


@pytest.mark.parametrize("method", ["cholesky", "woodbury"])
def test_gpmp_optimize_five_iterations_matches_jax(method):
    from stoch_gpmp_tpu.planners.gpmp import build_woodbury as jbuild
    from stoch_gpmp_tpu.planners.gpmp import gpmp_optimize as jopt

    jc = _field_problem()
    tc = convert.cost_from_jax(jc, device="cpu")
    js, ts = _states(0.5 * np.random.default_rng(6).normal(size=(3, 24, 4)))
    kw = dict(opt_iters=5, delta=1e-2, trust_region=False, method=method, step_size=0.5)
    jmodel = jbuild(jc, 1e-2) if method == "woodbury" else None
    want = jax.jit(lambda st: jopt(jc, st, {}, woodbury=jmodel, **kw))(js).particle_means
    got = gpmp_optimize(tc, ts, {}, woodbury=build_woodbury(tc, 1e-2)
                        if method == "woodbury" else None, **kw).particle_means
    _close(got, want)
    with pytest.raises(ValueError, match="needs woodbury"):
        gpmp_optimize(tc, ts, {}, **dict(kw, method="woodbury"))
    with pytest.raises(ValueError, match="unknown solve method"):
        gpmp_optimize(tc, ts, {}, **dict(kw, method="qr"))


def _planner_kwargs(goals, start):
    return dict(num_particles_per_goal=3, traj_len=24, opt_iters=5, dt=0.05, n_dof=2,
                step_size=0.5, start_state=start, multi_goal_states=goals,
                sigma_start_init=0.01, sigma_goal_init=0.01, sigma_gp_init=2.0,
                sigma_start_sample=0.01, sigma_goal_sample=0.01, sigma_gp_sample=0.5,
                solver_params={"delta": 1e-2, "trust_region": False, "method": "cholesky"},
                seed=0)


def test_gpmp_class_matches_jax():
    """``GPMP.optimize``'s ``(vel, pos, costs)`` from numpy-made initial
    means against JAX ``gpmp_optimize`` and ``cost.eval``;
    ``get_recent_samples`` and ``sample_trajectories`` shapes; ``mesh=``
    (a mesh of this one process) gives the same results bit for bit (the
    4-rank mesh runs in ``tests/test_torch_parallel.py``);
    ``method='woodbury'`` gives the same means; without initial
    means the init prior's draw starts at the start state."""
    from stoch_gpmp_tpu.planners.gpmp import gpmp_optimize as jopt

    jc = _field_problem()
    tc = convert.cost_from_jax(jc, device="cpu")
    start = np.array([-2.0, -2.0, 0.0, 0.0])
    goals = np.array([[2.0, 2.0, 0.0, 0.0]])
    init = start + np.random.default_rng(7).normal(scale=0.3, size=(3, 24, 4))
    js, _ = _states(init)
    jm = jax.jit(lambda st: jopt(jc, st, {}, opt_iters=5, delta=1e-2, trust_region=False,
                                 step_size=0.5))(js).particle_means
    kw = _planner_kwargs(goals, start)
    tp = GPMP(cost=tc, initial_particle_means=init, dtype=torch.float64, device="cpu", **kw)
    vel, pos, costs = tp.optimize()
    _close(vel, jm[..., 2:])
    _close(pos, jm[..., :2])
    _close(costs, jc.eval(jm.reshape(3, -1)))
    pos, vel = tp.get_recent_samples()
    assert pos.shape == vel.shape == (3, 24, 2)
    pos, vel = tp.sample_trajectories(5)
    assert pos.shape == vel.shape == (3, 5, 24, 2) and bool(torch.isfinite(pos).all())
    wb = GPMP(cost=tc, initial_particle_means=init, dtype=torch.float64, device="cpu",
              **dict(kw, solver_params={"delta": 1e-2, "method": "woodbury"}))
    _close(wb.optimize()[1], jm[..., :2], rtol=1e-7)
    from stoch_gpmp_tpu_torch.parallel.sharding import Mesh

    one = Mesh(devices=np.zeros((1, 1), dtype=int), axis_names=("p", "s"), rank=0,
               coords=(0, 0), device=torch.device("cpu"), backend="gloo")
    plain = GPMP(cost=tc, initial_particle_means=init, dtype=torch.float64, device="cpu", **kw)
    meshed = GPMP(cost=tc, initial_particle_means=init, dtype=torch.float64, mesh=one, **kw)
    for got, want in zip(meshed.optimize(), plain.optimize()):
        assert torch.equal(got, want)
    sampled = GPMP(cost=tc, device="cpu", dtype=torch.float64, **kw)  # init prior draw
    assert sampled.particle_means.shape == (3, 24, 4)
    np.testing.assert_allclose(sampled.particle_means[:, 0, :2].numpy(),
                               np.broadcast_to(start[:2], (3, 2)), atol=0.1)


def test_build_woodbury_rejects_unsupported_stacks():
    class Weird:
        pass

    tc = convert.cost_from_jax(_quad_problem(), device="cpu")
    from dataclasses import replace

    assert build_woodbury(replace(tc, costs=tc.costs + (Weird(),)), 1e-2) is None
    with pytest.raises(ValueError, match="does not decompose"):
        GPMP(cost=replace(tc, costs=tc.costs + (Weird(),)), device="cpu",
             initial_particle_means=np.zeros((6, 12, 4)),
             **dict(_planner_kwargs(np.zeros((2, 4)), np.zeros(4)), traj_len=12,
                    solver_params={"method": "woodbury"}))


def test_planar_gpmp_problem_matches_example():
    """``build_planar_gpmp_problem`` is ``examples/planar_gpmp.py``: three GN
    iterations in float64 from the same numpy-made initial means equal JAX
    ``gpmp_optimize`` on the stack built as the example builds it, with the
    example's step and damping; ``cost.eval`` at the end as ``optimize``
    returns it."""
    from stoch_gpmp_tpu.costs import CostCollision, CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.envs import generate_obstacle_map
    from stoch_gpmp_tpu.planners.gpmp import gpmp_optimize as jopt
    from stoch_gpmp_tpu_torch.problems import GPMP_GOALS, START, build_planar_gpmp_problem

    obst_map, _ = generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=10,
        rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2], rng=0,
        dtype=jnp.float64)
    start, goals = jnp.asarray(START), jnp.asarray(GPMP_GOALS)
    jc = CostComposite.create(2, 64, [
        CostGP.create(2, 64, start, 0.05, {"sigma_start": 0.01, "sigma_gp": 0.5},
                      dtype=jnp.float64),
        CostGoalPrior.create(2, 64, goals, sigma_goal_prior=0.01, dtype=jnp.float64),
        CostCollision.create(2, 64, obst_map.as_field(), sigma_coll=0.05),
    ])
    init = np.asarray(START) + np.random.default_rng(8).normal(scale=3.0, size=(6, 64, 4))
    js, _ = _states(init)
    jm = jax.jit(lambda st: jopt(jc, st, {}, opt_iters=3, delta=1e-2, trust_region=False,
                                 step_size=0.3))(js).particle_means
    want_cost = jc.eval(jm.reshape(6, -1))
    for method in ("cholesky", "woodbury"):
        tp = build_planar_gpmp_problem(3, method=method, dtype=torch.float64, device="cpu",
                                       initial_particle_means=init)
        assert type(tp.cost.costs[2].field).__name__ == "OccupancyGridField"
        vel, pos, costs = tp.optimize(opt_iters=3)
        rtol = RTOL if method == "cholesky" else 1e-7
        _close(pos, jm[..., :2], rtol)
        _close(vel, jm[..., 2:], rtol)
        _close(costs, want_cost, rtol)


def test_entry_points_default_to_the_card():
    """``GPMP``, ``build_planar_gpmp_problem`` and the reference-shaped
    planar problem run on the CUDA card unless given ``device='cpu'``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from stoch_gpmp_tpu_torch.problems import build_planar_gpmp_problem, build_planar_problem

    for fn in (lambda: build_planar_gpmp_problem(),
               lambda: build_planar_problem(fast=False, field="primitive"),
               lambda: GPMP(num_particles_per_goal=1, traj_len=8, opt_iters=1, n_dof=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


def method_agreement_f32(ppg=96, iters=(3, 100)):
    """``examples/planar_gpmp.py`` at ``ppg`` particles per goal in float32
    on the CPU, JAX package and port, from the same initial means (the
    port's init-prior draw at seed 0): the largest difference of the means
    between the solve methods, and between the packages, after each
    iteration count. ``chip_smoke.py``'s gn-main tolerances come from it."""
    from stoch_gpmp_tpu.costs import CostCollision, CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.envs import generate_obstacle_map
    from stoch_gpmp_tpu.planners import GPMP as JGPMP
    from stoch_gpmp_tpu_torch.problems import GPMP_GOALS, START, build_planar_gpmp_problem

    f32 = jnp.float32
    start, goals = jnp.asarray(START, f32), jnp.asarray(GPMP_GOALS, f32)
    obst_map, _ = generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=10,
        rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2], rng=0, dtype=f32)
    jc = CostComposite.create(2, 64, [
        CostGP.create(2, 64, start, 0.05, {"sigma_start": 0.01, "sigma_gp": 0.5}, dtype=f32),
        CostGoalPrior.create(2, 64, goals, sigma_goal_prior=0.01, dtype=f32),
        CostCollision.create(2, 64, obst_map.as_field(), sigma_coll=0.05),
    ])
    init = build_planar_gpmp_problem(ppg, device="cpu").particle_means.numpy()
    out = {}
    for n in iters:
        means = {}
        for method in ("cholesky", "inverse", "woodbury"):
            jp = JGPMP(num_particles_per_goal=ppg, traj_len=64, opt_iters=1, dt=0.05, n_dof=2,
                       step_size=0.3, start_state=start, multi_goal_states=goals, cost=jc,
                       initial_particle_means=jnp.asarray(init), sigma_start_init=0.01,
                       sigma_goal_init=0.01, sigma_gp_init=5.0, sigma_start_sample=0.01,
                       sigma_goal_sample=0.01, sigma_gp_sample=0.5,
                       solver_params={"delta": 1e-2, "trust_region": False, "method": method},
                       seed=0, dtype=f32)
            jp.optimize(opt_iters=n)
            tp = build_planar_gpmp_problem(ppg, method=method, device="cpu",
                                           initial_particle_means=init)
            tp.optimize(opt_iters=n)
            means["jax", method] = np.asarray(jp.particle_means)
            means["port", method] = tp.particle_means.numpy()
        for pkg in ("jax", "port"):
            chol = means[pkg, "cholesky"]
            for other in ("inverse", "woodbury"):
                out[f"{pkg} {other} vs cholesky, {n} iterations"] = float(
                    np.abs(means[pkg, other] - chol).max())
        for method in ("cholesky", "inverse", "woodbury"):
            out[f"port vs jax {method}, {n} iterations"] = float(
                np.abs(means["port", method] - means["jax", method]).max())
    return out


if __name__ == "__main__":  # python tests/test_torch_gpmp.py
    jax.config.update("jax_platforms", "cpu")
    for name, value in method_agreement_f32().items():
        print(f"{name}: {value:.3g}")
