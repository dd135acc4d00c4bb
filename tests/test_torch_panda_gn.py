"""Gauss-Newton on the Panda through FK and past M = 2048, the planner API
gaps and the Panda planning problems of the PyTorch port, against the JAX
package.

- ``StochGPMP.optimize``'s signature and a positional call (fault F1);
- ``gn_contrib`` of ``Cost`` and the fused costs raising JAX's
  ``NotImplementedError`` (fault F2);
- 3 ``gpmp_optimize`` iterations with ``cholesky`` and ``woodbury`` on the
  stack of ``tests/test_gpmp.py test_gpmp_panda_with_fk_fields`` at T = 8;
- 2 iterations of each at T = 520 (M = 2080), P = 2, delta 10, on
  ``benchmarks/long_horizon.py``'s stack;
- ``StochGPMP.Sigma_inv``, ``DofQuadraticCost.eval`` /
  ``eval_dof_planes_dense``, ``PlaneFieldsCost.supports_planes`` /
  ``eval_planes``;
- ``sample_dtype=torch.bfloat16`` under the JAX test's own bound
  (``tests/test_planner_planar.py test_sample_dtype_bf16_stays_close``);
- ``gp.prior.sample_correction``, the one sampler choice of
  ``GPPrior.sample`` and ``sample_around``, bit for bit;
- the Panda builders of ``problems.py`` against the same stacks built by the
  JAX package.

Float64 on the CPU, inputs made with numpy from a seed; tolerance rtol 1e-9
relative to the largest entry unless a test says otherwise. The JAX side is
jitted; each JAX problem is built once per module.
"""

import inspect
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
from stoch_gpmp_tpu_torch.planners import (  # noqa: E402
    GPMPState,
    StochGPMP,
    build_woodbury,
    gpmp_optimize,
)

RTOL = 1e-9
START_Q = [0.012, -0.57, 0.0, -2.81, 0.0, 3.037, 0.741]


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


# --- F1: StochGPMP.optimize ---------------------------------------------------
class _SeenObservation:
    """A cost wrapper that records the observation keys it is given."""

    def __init__(self, cost):
        self.cost, self.seen = cost, []

    def eval(self, trajs, x_trajs=None, observation=None):
        self.seen.append(sorted(observation or {}))
        return self.cost.eval(trajs, x_trajs=x_trajs, observation=observation)

    def supports_dof_planes(self):
        return False


def _small_panda_planner(cost):
    start = START_Q + [0.0] * 7
    return StochGPMP(num_particles_per_goal=2, num_samples=4, traj_len=8, opt_iters=2,
                     dt=0.05, n_dof=7, start_state=start, multi_goal_states=[start], cost=cost,
                     step_size=0.1, sigma_start_init=1e-4, sigma_goal_init=0.1,
                     sigma_gp_init=0.8, sigma_start_sample=1e-3, sigma_goal_sample=0.07,
                     sigma_gp_sample=0.1, seed=3, dtype=torch.float64, device="cpu")


def test_optimize_signature_matches_jax():
    from stoch_gpmp_tpu.planners import StochGPMP as JStochGPMP

    want = list(inspect.signature(JStochGPMP.optimize).parameters)
    assert list(inspect.signature(StochGPMP.optimize).parameters) == want


def test_optimize_positional_call_is_the_keyword_call():
    """``optimize(n, False, obs)`` binds ``obs`` to ``observation``, as in
    JAX: the same result as the keyword call, the obstacles seen by the
    cost, and ``debug`` never reaches the observation."""
    from stoch_gpmp_tpu_torch.costs import CostCollision, CostComposite, LinkDistanceField
    from stoch_gpmp_tpu_torch.kinematics import franka_panda

    chain = franka_panda(torch.float64)
    obs = {"obstacle_spheres": _t([[[0.5, 0.0, 0.5, 0.3]]])}
    outs, seen = [], []
    for call in (lambda p: p.optimize(2, False, obs),
                 lambda p: p.optimize(opt_iters=2, observation=obs),
                 lambda p: p.optimize(2, True, obs)):
        cost = _SeenObservation(CostComposite.create(7, 8, [
            CostCollision.create(7, 8, LinkDistanceField(), sigma_coll=0.1)], fk=chain.fk))
        planner = _small_panda_planner(cost)
        outs.append(call(planner))
        seen.append(cost.seen)
        assert planner.last_metrics is None
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(outs[2], outs[1]):
        assert torch.equal(a, b)
    assert seen[0] == seen[1] == seen[2] == [["obstacle_spheres"]] * 2


# --- F2: gn_contrib of the fused costs -----------------------------------------
@pytest.fixture(scope="module")
def fused_costs():
    """JAX's ``FusedLinkFieldsCost`` and ``PlaneFieldsCost`` (T = 8) and the
    port's conversions, alone and each in a composite."""
    from stoch_gpmp_tpu.costs import CostComposite, CostGP
    from stoch_gpmp_tpu.costs.fused_fields import FusedLinkFieldsCost, PlaneFieldsCost
    from stoch_gpmp_tpu.kinematics import homogeneous, z_rot
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda

    chain = franka_panda(dtype=jnp.float64)
    start = jnp.asarray(START_Q + [0.0] * 7)
    gp = CostGP.create(7, 8, start, 0.05, {"sigma_start": 1e-3, "sigma_gp": 0.1},
                       dtype=jnp.float64)
    target = homogeneous(z_rot(jnp.asarray(0.3)), jnp.asarray([0.4, 0.2, 0.5]))
    fused = FusedLinkFieldsCost.create(7, 8)
    plane = PlaneFieldsCost.create(7, 8, chain, target, use_pallas=False)
    jcosts = {"fused": fused, "plane": plane,
              "fused_composite": CostComposite.create(7, 8, [gp, fused], fk=chain.fk_compact),
              "plane_composite": CostComposite.create(7, 8, [gp, plane])}
    return {k: (c, convert.cost_from_jax(c, device="cpu")) for k, c in jcosts.items()}


@pytest.mark.parametrize("which", ["fused", "plane", "fused_composite", "plane_composite"])
def test_fused_costs_refuse_gauss_newton_as_jax_does(fused_costs, which):
    """``NotImplementedError`` with JAX's message, pointing to the separate
    fields; ``build_woodbury`` gives None for the stacks in both packages."""
    from stoch_gpmp_tpu.planners.gpmp import build_woodbury as jbuild

    jc, tc = fused_costs[which]
    x = np.random.default_rng(0).normal(size=(2, 8, 14))
    with pytest.raises(NotImplementedError) as jerr:
        jc.gn_contrib(jnp.asarray(x))
    match = "use the separate CostCollision/CostGoal fields" if "plane" in which else \
        "use the separate CostCollision fields for the Gauss-Newton path"
    assert str(jerr.value).startswith(match)
    with pytest.raises(NotImplementedError, match=match):
        tc.gn_contrib(_t(x))
    if "composite" in which:
        assert jbuild(jc, 1e-2) is None and build_woodbury(tc, 1e-2) is None


def test_base_cost_gn_contrib_raises():
    from stoch_gpmp_tpu_torch.costs import Cost

    with pytest.raises(NotImplementedError):
        Cost().gn_contrib(torch.zeros(1, 8, 4))


# --- GN through FK --------------------------------------------------------------
@pytest.fixture(scope="module")
def panda_gn():
    """``tests/test_gpmp.py``'s Panda GN stack at T = 8 (two particles from
    the woodbury test's draw), its observation and the port's conversion."""
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
    means = np.asarray(start)[None, None] + 0.1 * np.random.default_rng(5).standard_normal(
        (2, t, 2 * n))
    obs = {"obstacle_spheres": jnp.asarray([[[0.5, 0.0, 0.5, 0.1]]])}
    return jc, means, obs, convert.cost_from_jax(jc, device="cpu"), \
        convert.observation_from_jax(obs, device="cpu")


def _jax_gpmp(jc, means, obs, method, iters, delta, step):
    from stoch_gpmp_tpu.planners.gpmp import GPMPState as JState
    from stoch_gpmp_tpu.planners.gpmp import build_woodbury as jbuild
    from stoch_gpmp_tpu.planners.gpmp import gpmp_optimize as jopt

    wb = jbuild(jc, delta) if method == "woodbury" else None
    run = jax.jit(lambda st, o: jopt(jc, st, o, opt_iters=iters, delta=delta,
                                     trust_region=False, method=method, step_size=step,
                                     woodbury=wb))
    return run(JState(particle_means=jnp.asarray(means), key=jax.random.PRNGKey(0)), obs)


@pytest.mark.parametrize("method", ["cholesky", "woodbury"])
def test_panda_gn_through_fk_matches_jax(panda_gn, method):
    """3 iterations of ``gpmp_optimize`` (delta 1e-2, step 0.2): the field
    Jacobians by ``torch.autograd`` through FK against ``jax.grad``, the
    structured solve or the Woodbury split with two rank-1 fields."""
    jc, means, obs, tc, tobs = panda_gn
    want = _jax_gpmp(jc, means, obs, method, 3, 1e-2, 0.2).particle_means
    wb = build_woodbury(tc, 1e-2) if method == "woodbury" else None
    assert wb is None or wb.n_fields == 2
    state = GPMPState(particle_means=_t(means), generator=torch.Generator())
    got = gpmp_optimize(tc, state, tobs, opt_iters=3, delta=1e-2, trust_region=False,
                        method=method, step_size=0.2, woodbury=wb).particle_means
    _close(got, want)


def float32_gn_systems():
    """``problems.build_panda_gpmp``'s float32 problem (seed 0) in both
    packages: its first Gauss-Newton system ``(diag + delta I, lower)`` at
    the initial means (JAX's from the same stack on the same means and
    spheres, jitted), and the precision blocks of the planner's own init
    prior (no goal), as float32 torch tensors by name."""
    from stoch_gpmp_tpu.costs import (
        CostCollision,
        CostComposite,
        CostGoal,
        CostGP,
        EESE3DistanceField,
        LinkDistanceField,
    )
    from stoch_gpmp_tpu.gp.prior import make_gp_prior as jmake
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda

    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior
    from stoch_gpmp_tpu_torch.problems import build_panda_gpmp

    f32 = jnp.float32
    pb = build_panda_gpmp(0, device="cpu")
    pl = pb.planner
    delta = float(pl.solver_params["delta"])
    c = pl.cost.gn_contrib(pl.particle_means, observation=pb.observation)
    eye = torch.eye(14)
    start = jnp.asarray(pl.start_state.numpy())
    n, t = pl.n_dof, pl.traj_len
    jc = CostComposite.create(n, t, [
        CostGP.create(n, t, start, pl.dt, {"sigma_start": 0.001, "sigma_gp": 0.1}, dtype=f32),
        CostCollision.create(n, t, LinkDistanceField(), sigma_coll=0.1),
        CostGoal.create(n, t, EESE3DistanceField(target_h=jnp.asarray(pb.target_h.numpy())),
                        sigma_goal=0.05),
    ], fk=franka_panda(dtype=f32).fk)
    obs = {"obstacle_spheres": jnp.asarray(pb.observation["obstacle_spheres"].numpy())}
    jcon = jax.jit(lambda cc, x, o: cc.gn_contrib(x, observation=o))(
        jc, jnp.asarray(pl.particle_means.numpy()), obs)
    prior = make_gp_prior(n, t, pl.dt, pl.start_state, pl.sigma_start_init, pl.sigma_gp_init,
                          device="cpu")
    jprior = jmake(n, t, pl.dt, start, pl.sigma_start_init, pl.sigma_gp_init, dtype=f32)
    as_t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {
        "port": (c.diag + delta * eye, c.lower),
        "jax": (as_t(jcon.diag) + delta * eye, as_t(jcon.lower)),
        "port_init": (prior.precision.diag, prior.precision.lower),
        "jax_init": (as_t(jprior.precision.diag), as_t(jprior.precision.lower)),
    }


def test_float32_panda_gn_system_is_within_rounding_of_indefinite():
    """Why ``chip_smoke.py``'s panda-gn runs in float64: on
    ``build_panda_gpmp``'s float32 problem, both packages build the same
    first Gauss-Newton system (blocks within 1e-6 of the largest) and the
    same goal-free init prior, and in each the last block's Schur
    complement has its smallest eigenvalue (float64, on the float32 blocks)
    only 1-30 float32 units of its block's norm above zero
    (``chip_smoke.schur_margins``). On the GN system the float32 recurrence
    (``BlockTridiag.cholesky``'s steps, on this CPU) moves that Schur
    complement by more than the margin for some particle, so rounding
    alone can make a float32 factor fail there. The two packages' margins
    agree within 1%."""
    import chip_smoke

    systems = float32_gn_systems()
    for part in (0, 1):
        for a, b in (("port", "jax"), ("port_init", "jax_init")):
            got, want = systems[a][part], systems[b][part]
            assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    w = {k: chip_smoke.schur_margins(*v) for k, v in systems.items()}
    for k, r in w.items():
        assert set(r["block"]) == {63}, (k, r)
        assert all(1.0 < m < 30.0 for m in r["margin"]), (k, r)
    for k in ("port", "jax"):
        assert max(e / m for e, m in zip(w[k]["err"], w[k]["margin"])) > 1.0, w[k]
    np.testing.assert_allclose(w["port"]["margin"], w["jax"]["margin"], rtol=1e-2)
    np.testing.assert_allclose(w["port_init"]["margin"], w["jax_init"]["margin"], rtol=1e-2)


@pytest.fixture(scope="module")
def long_gn():
    """``benchmarks/long_horizon.py``'s stack at T = 520 (M = 2080), float64,
    two particles: the straight line plus a smooth perturbation."""
    from stoch_gpmp_tpu.costs import CostCollision, CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.costs.fields import RasterPrimitive2DField
    from stoch_gpmp_tpu.envs import generate_obstacle_map
    from stoch_gpmp_tpu.gp.prior import const_vel_means

    from stoch_gpmp_tpu_torch.problems import LONG_HORIZON_GOALS, START

    t, f64 = 520, jnp.float64
    start, goals = jnp.asarray(START, f64), jnp.asarray(LONG_HORIZON_GOALS, f64)
    obst_map, obst_list = generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
        rand_limits=[[-7.5, 7.5]] * 2, rand_rect_shape=[2, 2], rng=0, dtype=f64)
    jc = CostComposite.create(2, t, [
        CostGP.create(2, t, start, 0.02, {"sigma_start": 1e-3, "sigma_gp": 0.1}, dtype=f64),
        CostGoalPrior.create(2, t, goals, sigma_goal_prior=1e-3, dtype=f64),
        CostCollision.create(2, t, RasterPrimitive2DField.from_map(
            obst_map, obst_list, use_pallas=False), sigma_coll=1e-5),
    ])
    line = np.asarray(const_vel_means(start, goals, t - 1, 0.02, 2))
    bump = np.sin(np.linspace(0.0, np.pi, t))[:, None] * np.array([1.5, -1.0, 0.0, 0.0])
    means = np.concatenate([line, line + bump])
    return jc, means, convert.cost_from_jax(jc, device="cpu")


@pytest.mark.parametrize("method", ["cholesky", "woodbury"])
def test_long_horizon_gn_matches_jax(long_gn, method):
    """2 iterations at T = 520, delta 10 (``gn_bench``'s default at T >=
    512), step 0.5: the batched block Cholesky's Python loop over 520 blocks
    against JAX's ``lax.scan``, and the Woodbury split with its ``[2T, 2T]``
    per-dof inverse."""
    jc, means, tc = long_gn
    want = _jax_gpmp(jc, means, {}, method, 2, 10.0, 0.5).particle_means
    wb = build_woodbury(tc, 10.0) if method == "woodbury" else None
    state = GPMPState(particle_means=_t(means), generator=torch.Generator())
    got = gpmp_optimize(tc, state, {}, opt_iters=2, delta=10.0, trust_region=False,
                        method=method, step_size=0.5, woodbury=wb).particle_means
    _close(got, want)


def test_long_horizon_gpmp_builder():
    """``problems.build_long_horizon_gpmp``: the init means come from the
    solver sampler past M = 2048, the step is finite and keeps the start."""
    from stoch_gpmp_tpu_torch.problems import START, build_long_horizon_gpmp

    planner = build_long_horizon_gpmp(520, method="woodbury", particles=2,
                                      dtype=torch.float64, device="cpu")
    assert planner._sample_prior.psolver is not None
    assert planner.solver_params["delta"] == 10.0 and planner._wb.n_fields == 1
    vel, pos, costs = planner.optimize(opt_iters=1)
    assert bool(torch.isfinite(costs).all()) and pos.shape == (2, 520, 2)
    assert float((pos[:, 0] - torch.tensor(START[:2], dtype=torch.float64)).abs().max()) < 0.05


# --- the planner's API gaps -----------------------------------------------------
@pytest.fixture(scope="module")
def planar64():
    """A JAX ``StochGPMP`` on the planar quadratic stack (float64, T = 16)
    and the same planner in the port."""
    from stoch_gpmp_tpu.costs import CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.planners import StochGPMP as JStochGPMP

    from stoch_gpmp_tpu_torch.problems import GOALS, START

    t = 16
    jc = CostComposite.create(2, t, [
        CostGP.create(2, t, jnp.asarray(START), 0.02, {"sigma_start": 1e-3, "sigma_gp": 0.1},
                      dtype=jnp.float64),
        CostGoalPrior.create(2, t, jnp.asarray(GOALS), sigma_goal_prior=1e-3,
                             dtype=jnp.float64)])
    kw = dict(num_particles_per_goal=2, num_samples=8, traj_len=t, opt_iters=2, dt=0.02,
              n_dof=2, start_state=START, multi_goal_states=GOALS, sigma_start_init=1e-3,
              sigma_goal_init=1e-3, sigma_gp_init=3.0, sigma_start_sample=1e-3,
              sigma_goal_sample=1e-3, sigma_gp_sample=3.0, step_size=0.5)
    jp = JStochGPMP(cost=jc, dtype=jnp.float64, **{k: (jnp.asarray(v) if isinstance(v, list)
                                                       else v) for k, v in kw.items()})
    tp = StochGPMP(cost=convert.cost_from_jax(jc, device="cpu"), dtype=torch.float64,
                   device="cpu", **kw)
    return jp, tp


def test_sigma_inv_matches_jax(planar64):
    jp, tp = planar64
    _close(tp.Sigma_inv.diag, jp.Sigma_inv.diag, 1e-12)
    _close(tp.Sigma_inv.lower, jp.Sigma_inv.lower, 1e-12)
    _close(tp.Sigma_inv.to_dense(), jp.Sigma_inv.to_dense(), 1e-12)


def test_dof_quadratic_eval_matches_jax():
    """``DofQuadraticCost.eval`` (a flat batch through the plane layout),
    ``eval_dof_planes_dense`` and, for a cost without the stencil constants,
    ``eval_dof_planes`` falling back to the dense form."""
    from dataclasses import replace

    from stoch_gpmp_tpu.costs import CostGP, CostGoalPrior
    from stoch_gpmp_tpu.gp.dof_factored import DofQuadraticCost as JDQ
    from stoch_gpmp_tpu.gp.dof_factored import to_dof_planes as jto

    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes
    from stoch_gpmp_tpu_torch.problems import GOALS, START

    t = 12
    gp = CostGP.create(2, t, jnp.asarray(START), 0.02, {"sigma_start": 1e-2, "sigma_gp": 0.5},
                       dtype=jnp.float64)
    goal = CostGoalPrior.create(2, t, jnp.asarray(GOALS), sigma_goal_prior=1e-2,
                                dtype=jnp.float64)
    jdq = JDQ.from_gp_and_goal_prior(gp, goal, t)
    tdq = convert._dof_quad_from_jax(jdq, torch.float64, "cpu")
    x = np.random.default_rng(2).normal(size=(6, t, 4)) * 3.0
    want = jax.jit(lambda c, v: c.eval(v))(jdq, jnp.asarray(x))
    _close(tdq.eval(_t(x)), want)
    _close(tdq.eval(_t(x).reshape(6, -1)), want)
    planes = to_dof_planes(_t(x))
    dense = jax.jit(lambda c, v: c.eval_dof_planes_dense(v))(jdq, jto(jnp.asarray(x)))
    _close(tdq.eval_dof_planes_dense(planes), dense, 1e-7)  # the matmul form cancels
    _close(replace(tdq, q_i2=None).eval_dof_planes(planes), dense, 1e-7)


def test_plane_fields_cost_planes_match_jax(fused_costs):
    """``PlaneFieldsCost.supports_planes`` and ``eval_planes`` (the plain
    K4 version on the CPU) against JAX's plane entry; the composite's
    ``supports_planes`` in both packages."""
    jplane, tplane = fused_costs["plane"]
    assert tplane.supports_planes() and jplane.supports_planes()
    jcomp, tcomp = fused_costs["plane_composite"]
    assert tcomp.supports_planes() == jcomp.supports_planes()
    x = np.asarray(START_Q)[:, None, None] + 0.3 * np.random.default_rng(4).normal(size=(7, 3, 8))
    spheres = np.zeros((1, 5, 4))  # as many as num_obstacles, which JAX's flat XLA path reads
    rng = np.random.default_rng(0)
    spheres[0, :, :3] = rng.uniform([0.2, -0.2, 0.3], [0.6, 0.2, 0.7], (5, 3))
    spheres[0, :, 3] = rng.uniform(0.1, 0.2, 5)
    obs = {"obstacle_spheres": jnp.asarray(spheres)}
    jplanes = tuple(jnp.asarray(x[i]) for i in range(7))
    want = jax.jit(lambda c, p, o: c.eval_planes(p, observation=o))(jplane, jplanes, obs)
    got = tplane.eval_planes(tuple(_t(x[i]) for i in range(7)),
                             observation=convert.observation_from_jax(obs, device="cpu"))
    _close(got, want)


@pytest.mark.parametrize("num_spheres", [3, 7])
def test_plane_fields_cost_takes_every_sphere_as_jax_kernels_do(num_spheres):
    """With fewer or more spheres than JAX's ``num_obstacles`` (5), the
    port's ``PlaneFieldsCost`` (the plain K4 version on the CPU) equals
    JAX's default ``use_pallas=True`` cost through both its kernel paths,
    the flat ``eval`` and ``eval_planes`` (Pallas in interpret mode), which
    take every sphere given; ``num_obstacles`` is read only by JAX's
    ``use_pallas=False`` path, which the port does not have."""
    from stoch_gpmp_tpu.costs.fused_fields import PlaneFieldsCost
    from stoch_gpmp_tpu.kinematics import homogeneous, z_rot
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda

    target = homogeneous(z_rot(jnp.asarray(0.3)), jnp.asarray([0.4, 0.2, 0.5]))
    jplane = PlaneFieldsCost.create(7, 8, franka_panda(dtype=jnp.float64), target)
    assert jplane.num_obstacles == 5 and jplane.use_pallas
    tplane = convert.cost_from_jax(jplane, device="cpu")
    rng = np.random.default_rng(num_spheres)
    x = np.asarray(START_Q + [0.0] * 7) + 0.3 * rng.normal(size=(3, 8, 14))
    spheres = np.zeros((1, num_spheres, 4))
    spheres[0, :, :3] = rng.uniform([0.2, -0.2, 0.3], [0.6, 0.2, 0.7], (num_spheres, 3))
    spheres[0, :, 3] = rng.uniform(0.1, 0.2, num_spheres)
    obs = {"obstacle_spheres": jnp.asarray(spheres)}
    tobs = convert.observation_from_jax(obs, device="cpu")
    want = jax.jit(lambda c, v, o: c.eval(v, observation=o))(jplane, jnp.asarray(x), obs)
    _close(tplane.eval(_t(x), observation=tobs), want)
    jplanes = tuple(jnp.asarray(x[..., i]) for i in range(7))
    want_planes = jax.jit(lambda c, p, o: c.eval_planes(p, observation=o))(jplane, jplanes, obs)
    _close(tplane.eval_planes(tuple(_t(x[..., i]) for i in range(7)), observation=tobs),
           want_planes)
    # the spheres past the fifth count: dropping them changes the cost
    fewer = {"obstacle_spheres": tobs["obstacle_spheres"][:, :min(num_spheres, 5) - 1]}
    assert not torch.allclose(tplane.eval(_t(x), observation=fewer), _t(np.asarray(want)))


def test_sample_dtype_bf16_stays_close():
    """``sample_dtype=torch.bfloat16`` (the JAX test's bound): 20 iterations
    on the flat path stay finite with float32 means; the dof and plane
    routes are refused, as in JAX. One step with JAX's bfloat16 draw
    injected equals JAX's ``stoch_gpmp_step(sample_dtype=jnp.bfloat16)``
    (both round the sampling product to bfloat16, so within 2 bfloat16
    units of the largest correction), and its correction differs from the
    float32 product's on the same draw by bfloat16 rounding: more than 1e-4
    and less than 1e-2 of the largest correction."""
    from stoch_gpmp_tpu.costs import CostComposite, CostGoalPrior, CostGP
    from stoch_gpmp_tpu.gp.prior import make_gp_prior as jmake
    from stoch_gpmp_tpu.planners.stoch_gpmp import SamplerModel as JSampler
    from stoch_gpmp_tpu.planners.stoch_gpmp import StochGPMPState as JState
    from stoch_gpmp_tpu.planners.stoch_gpmp import stoch_gpmp_step as jstep

    from stoch_gpmp_tpu_torch.planners import (
        StochGPMPState,
        stoch_gpmp_optimize,
        stoch_gpmp_step,
    )
    from stoch_gpmp_tpu_torch.planners.stoch_gpmp import _route
    from stoch_gpmp_tpu_torch.problems import GOALS, START, build_planar_problem

    sampler, cost, state = build_planar_problem(traj_len=32, ppg=4, device="cpu", seed=11,
                                                fast=False)
    st, aux = stoch_gpmp_optimize(sampler, cost, state, {}, opt_iters=20, num_samples=32,
                                  temperature=1.0, step_size=0.5, sample_dtype=torch.bfloat16)
    assert bool(torch.isfinite(st.particle_means).all())
    assert st.particle_means.dtype == torch.float32 and aux.samples.dtype == torch.float32
    s128, c128, _ = build_planar_problem(traj_len=128, ppg=1, device="cpu")
    assert _route(s128, c128, 128) == "dof"
    assert _route(s128, c128, 128, sample_dtype=torch.bfloat16) == "flat"

    t, p, s = 32, 3, 16
    f32 = jnp.float32
    jprior = jmake(2, t, 0.02, jnp.asarray(START, f32), 1e-3, 3.0, sigma_goal=1e-3,
                   goal_states=jnp.asarray(GOALS, f32), dtype=f32)
    jcost = CostComposite.create(2, t, [
        CostGP.create(2, t, jnp.asarray(START, f32), 0.02, {"sigma_start": 1e-3,
                                                            "sigma_gp": 0.1}, dtype=f32),
        CostGoalPrior.create(2, t, jnp.asarray(GOALS, f32), sigma_goal_prior=1e-3, dtype=f32)])
    jsampler = JSampler.from_prior(jprior)
    key = jax.random.PRNGKey(2)
    jst = JState(particle_means=jprior.means, key=key)
    kw = dict(num_samples=s, temperature=1.0, step_size=0.5)
    _, jaux = jax.jit(lambda sa, c, st: jstep(sa, c, st, {}, sample_dtype=jnp.bfloat16, **kw))(
        jsampler, jcost, jst)
    eps = torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(key)[1], (p, s, 4 * t), dtype=jnp.bfloat16).astype(f32)))
    tsampler = convert.sampler_from_jax(jsampler, device="cpu", dtype=torch.float32)
    tcost = convert.cost_from_jax(jcost, device="cpu", dtype=torch.float32)
    means = torch.from_numpy(np.array(jprior.means))
    tst = StochGPMPState(particle_means=means, generator=torch.Generator())
    corr = {}
    for dtype in (torch.bfloat16, None):
        _, a = stoch_gpmp_step(tsampler, tcost, tst, {}, sample_dtype=dtype,
                               eps=eps.to(dtype or torch.float32), **kw)
        corr[dtype] = a.samples - means[:, None]
    jcorr = torch.from_numpy(np.array(jaux.samples)) - means[:, None]
    big = float(jcorr.abs().max())
    assert float((corr[torch.bfloat16] - jcorr).abs().max()) <= 2 * 2.0**-8 * big
    rel = float((corr[torch.bfloat16] - corr[None]).abs().max()) / big
    assert 1e-4 < rel < 1e-2, rel


def test_sample_correction_is_bit_identical():
    """The merged sampler choice gives the draws the three separate forms
    gave, bit for bit: the dense ``eps @ L^{-1}``, the parallel-in-time
    solver and (a model with neither) the Cholesky substitution; the JAX
    package's ``"auto"`` rule picks the same one (checked against
    ``GPPrior.sample`` with JAX's draw injected)."""
    from dataclasses import replace

    from stoch_gpmp_tpu.gp.prior import make_gp_prior as jmake

    from stoch_gpmp_tpu_torch.gp.prior import make_gp_prior, sample_correction
    from stoch_gpmp_tpu_torch.planners.stoch_gpmp import sample_around
    from stoch_gpmp_tpu_torch.problems import GOALS, START

    kw = dict(sigma_goal=1e-3, goal_states=GOALS, dtype=torch.float64, device="cpu")
    dense = make_gp_prior(2, 24, 0.02, START, 1e-3, 3.0, **kw)
    solver = make_gp_prior(2, 24, 0.02, START, 1e-3, 3.0, materialize_dense=False, **kw)
    chol = replace(solver, psolver=None)
    eps = torch.from_numpy(np.random.default_rng(8).normal(size=(3, 5, 24, 4)))
    forms = {
        "dense": (dense, (eps.reshape(3, 5, -1) @ dense.weight_t).reshape(eps.shape)),
        "solver": (solver, solver.psolver.solve_LT(eps)),
        "chol": (chol, chol.chol.solve_LT(eps)),
    }
    for name, (prior, want) in forms.items():
        assert torch.equal(sample_correction(prior, eps), want), name
        assert torch.equal(prior.sample(None, 5, eps=eps), prior.means[:, None] + want), name
        gen = torch.Generator().manual_seed(4)
        e = torch.randn((3, 5, 24, 4), generator=torch.Generator().manual_seed(4),
                        dtype=torch.float64)
        assert torch.equal(sample_around(prior, prior.means, 5, gen),
                           prior.means[:, None] + sample_correction(prior, e)), name
    jprior = jmake(2, 24, 0.02, jnp.asarray(START), 1e-3, 3.0, sigma_goal=1e-3,
                   goal_states=jnp.asarray(GOALS), dtype=jnp.float64, materialize_dense=False)
    jchol = jprior.replace(psolver=None)
    key = jax.random.PRNGKey(6)
    jeps = torch.from_numpy(np.array(jax.random.normal(key, (3, 5, 24, 4), dtype=jnp.float64)))
    _close(chol.sample(None, 5, eps=jeps), jchol.sample(key, 5), 1e-12)


# --- the Panda problems of problems.py ------------------------------------------
def test_panda_builders_match_jax_stacks():
    """``build_panda_example`` (both stacks) and ``build_panda_mesh`` against
    the stacks the JAX example and ``benchmarks/success_rate_panda.py``
    build from the same goal, target and numpy draws: the spheres exactly,
    the costs on the same trajectories within rtol 1e-9 (float64)."""
    from stoch_gpmp_tpu.costs import (
        CostCollision,
        CostComposite,
        CostGP,
        CostGoal,
        CostGoalPrior,
        EESE3DistanceField,
        LinkDistanceField,
        LinkSelfDistanceField,
        MeshSphereDistanceField,
        MeshSphereFloorField,
    )
    from stoch_gpmp_tpu.envs.panda_env import random_init_static_sphere
    from stoch_gpmp_tpu.kinematics import homogeneous, y_rot, z_rot
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda as jfp

    from stoch_gpmp_tpu_torch.problems import build_panda_example, build_panda_mesh

    f64, n = jnp.float64, 7
    chain = jfp(dtype=f64)
    q_goal = np.asarray(START_Q) + 0.2
    start = jnp.asarray(START_Q + [0.0] * 7)
    goals = jnp.concatenate([jnp.asarray(q_goal), jnp.zeros(7)])[None]
    x = np.asarray(start)[None, None] + 0.1 * np.random.default_rng(9).normal(size=(3, 64, 14))
    for mesh in (False, True):
        t = 32 if mesh else 64
        rng = np.random.default_rng(0)
        pos = np.array([0.3, 0.3, 0.3]) + (rng.uniform(-0.05, 0.05, 3) if mesh else 0.0)
        target = homogeneous(z_rot(jnp.asarray(-np.pi)) @ y_rot(jnp.asarray(-np.pi)),
                             jnp.asarray(pos))
        costs = [
            CostGP.create(n, t, start, 0.05, {"sigma_start": 0.0001, "sigma_gp": 0.0007},
                          dtype=f64),
            CostGoalPrior.create(n, t, goals, sigma_goal_prior=20.0, dtype=f64),
            CostCollision.create(n, t, LinkSelfDistanceField(margin=0.03), sigma_coll=0.01)]
        if mesh:
            field = MeshSphereDistanceField.for_panda(chain, dtype=f64)
            costs += [CostCollision.create(n, t, field, sigma_coll=0.01),
                      CostCollision.create(n, t, MeshSphereFloorField(mesh=field),
                                           sigma_coll=0.01)]
        else:
            costs.append(CostCollision.create(n, t, LinkDistanceField(), sigma_coll=0.01))
        costs.append(CostGoal.create(n, t, EESE3DistanceField(target_h=target),
                                     sigma_goal=0.00007))
        jc = CostComposite.create(n, t, costs, fk=chain.fk)
        built = [build_panda_mesh(0, q_goal=_t(q_goal), dtype=torch.float64, device="cpu")] \
            if mesh else [build_panda_example(0, fast=fast, q_goal=_t(q_goal),
                                              dtype=torch.float64, device="cpu")
                          for fast in (False, True)]
        if not mesh:
            spheres = np.zeros((1, 5, 4))
            for i in range(5):
                r, p = random_init_static_sphere(0.1, 0.2, np.array([0.6, -0.2, 0.6]),
                                                 np.array([1.0, 0.2, 1.0]), 0.01, rng=rng)
                spheres[0, i] = [*p, r]
            assert np.array_equal(built[0].spheres, spheres)
        obs = {"obstacle_spheres": jnp.asarray(built[0].observation["obstacle_spheres"].numpy())}
        want = jax.jit(lambda c, v, o: c.eval(v, observation=o))(jc, jnp.asarray(x[:, :t]), obs)
        for b in built:
            _close(b.target_h, target, 1e-12)
            _close(b.planner.cost.eval(_t(x[:, :t]), observation=b.observation), want)


def test_panda_planning_modules_never_import_jax():
    """The Panda planning modules, a CPU build of each Panda problem (IK
    included) and a step of each, and the simulator (dynamics, bodies,
    environment, the example twins) with an environment step through the
    dynamics and a torque step of the 9-DOF arm load no JAX and nothing of
    the JAX package."""
    import subprocess

    code = (
        "import sys, torch\n"
        "import stoch_gpmp_tpu_torch.kinematics.ik, stoch_gpmp_tpu_torch.envs.panda_env\n"
        "import stoch_gpmp_tpu_torch.kinematics.panda_collision\n"
        "from stoch_gpmp_tpu_torch import problems as pr\n"
        "from stoch_gpmp_tpu_torch.kinematics import franka_panda\n"
        "c = franka_panda(torch.float64)\n"
        "q = pr.panda_ik_goal(c, pr.panda_target(dtype=torch.float64),"
        " torch.tensor(pr.PANDA_START_Q, dtype=torch.float64), num_starts=2, num_iters=2)\n"
        "for b in (pr.build_panda_example(q_goal=q, device='cpu'),"
        " pr.build_panda_mesh(q_goal=q, device='cpu')):\n"
        "    b.planner.optimize(opt_iters=1, observation=b.observation)\n"
        "g = pr.build_panda_gpmp(method='woodbury', device='cpu')\n"
        "g.planner.optimize(opt_iters=1, observation=g.observation)\n"
        "import stoch_gpmp_tpu_torch.kinematics.dynamics, stoch_gpmp_tpu_torch.envs.objects\n"
        "import stoch_gpmp_tpu_torch.examples.panda_environment\n"
        "import stoch_gpmp_tpu_torch.examples.planar_sharded\n"
        "from stoch_gpmp_tpu_torch.envs import Panda, PandaEnv\n"
        "env = PandaEnv(num_obst=2, seed=0, physics='dynamics', device='cpu')\n"
        "env.reset(); env.step(env.panda.q + 0.05)\n"
        "p = Panda(gripper=True, device='cpu')\n"
        "p.setTargetTorques(p.solveInverseDynamics(p.q, p.dq, p.dq)); p.step(1 / 240)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'stoch_gpmp_tpu.', 'benchmarks')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=300)


if __name__ == "__main__":  # python tests/test_torch_panda_gn.py
    import chip_smoke

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)  # as tests/conftest.py sets it
    for name, system in float32_gn_systems().items():
        print(name, chip_smoke.schur_margins(*system))
