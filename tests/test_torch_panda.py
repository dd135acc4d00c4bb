"""The Panda 7-DOF dof-factored slice of the PyTorch port against the JAX
package: config 5's layout (T = 128, 8 samples, 7 DOF, 5 spheres) at a small
width, 2 goals x 4 particles, float64 wherever the JAX function takes it.

The JAX problem mirrors ``benchmarks/run.py _panda_problem(fast=True)`` with
a dtype argument and is carried over by ``convert``; the eps draws are
rebuilt from the JAX state key exactly as ``_stoch_gpmp_optimize_dof`` draws
them and injected into the port. Each test states its tolerance.
"""

import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stoch_gpmp_tpu_torch import convert  # noqa: E402
from stoch_gpmp_tpu_torch.gp.dof_factored import from_dof_planes, to_dof_planes  # noqa: E402
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (  # noqa: E402
    fk_link_fields_cost_rows,
    fk_link_fields_cost_rows_plain,
)
from stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof import (  # noqa: E402
    fused_panda_dof_step,
    fused_panda_dof_step_plain,
    make_fused_panda_dof_step,
)
from stoch_gpmp_tpu_torch.ops.kernels.stencil import (  # noqa: E402
    dof_quad_eval,
    dof_quad_eval_plain,
)
from stoch_gpmp_tpu_torch.planners import StochGPMP, stoch_gpmp_optimize  # noqa: E402
from stoch_gpmp_tpu_torch.problems import PANDA_START_Q, build_panda_problem  # noqa: E402

G, PPG, S, T, D = 2, 4, 8, 128, 7
P = G * PPG
TAU, STEP = 1.0, 0.1
RTOL = 1e-9


def _jax_panda(dtype):
    """``benchmarks/run.py _panda_problem(fast=True)`` with a dtype."""
    from stoch_gpmp_tpu.costs import CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.costs.fused_fields import PlaneFieldsCost
    from stoch_gpmp_tpu.costs.quadratic import QuadraticCost
    from stoch_gpmp_tpu.gp.prior import make_gp_prior
    from stoch_gpmp_tpu.kinematics import homogeneous, y_rot, z_rot
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda
    from stoch_gpmp_tpu.planners import SamplerModel, StochGPMPState

    dt = 0.05
    chain = franka_panda(dtype=dtype)
    target_h = homogeneous(z_rot(jnp.asarray(-np.pi, dtype)) @ y_rot(jnp.asarray(-np.pi, dtype)),
                           jnp.asarray([0.3, 0.3, 0.3], dtype))
    start_q = jnp.asarray(PANDA_START_Q, dtype)
    start = jnp.concatenate([start_q, jnp.zeros_like(start_q)])
    rng = np.random.default_rng(0)
    goals_q = start_q[None] + jnp.asarray(rng.uniform(-0.3, 0.3, (G, D)), dtype)
    goals = jnp.concatenate([goals_q, jnp.zeros_like(goals_q)], axis=-1)
    gp = CostGP.create(D, T, start, dt, {"sigma_start": 0.0001, "sigma_gp": 0.0007}, dtype=dtype)
    goal = CostGoalPrior.create(D, T, goals, sigma_goal_prior=20.0, dtype=dtype)
    cost = CostComposite.create(D, T, [
        QuadraticCost.from_gp_and_goal_prior(gp, goal, T),
        PlaneFieldsCost.create(D, T, chain, target_h, margin=0.03, sigma_self=0.01,
                               sigma_coll=0.01, sigma_goal=0.00007)])
    prior = make_gp_prior(D, T, dt, start, 0.001, 0.1, sigma_goal=0.07, goal_states=goals,
                          dtype=dtype)
    state = StochGPMPState(particle_means=jnp.repeat(prior.means, PPG, axis=0),
                           key=jax.random.PRNGKey(0))
    spheres = np.zeros((1, 5, 4))
    spheres[0, :, :3] = rng.uniform([0.6, -0.2, 0.6], [1.0, 0.2, 1.0], (5, 3))
    spheres[0, :, 3] = rng.uniform(0.1, 0.2, 5)
    return SamplerModel.from_prior(prior), cost, state, {"obstacle_spheres": jnp.asarray(spheres, dtype)}


@pytest.fixture(scope="module")
def problem():
    """The JAX problem (float64) and its conversion to the port on the CPU."""
    js, jc, jst, jobs = _jax_panda(jnp.float64)
    kw = dict(device="cpu")
    return {
        "jax": (js, jc, jst, jobs),
        "torch": (convert.sampler_from_jax(js, **kw), convert.cost_from_jax(jc, **kw),
                  convert.state_from_jax(jst, **kw), convert.observation_from_jax(jobs, **kw)),
    }


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(t, j, rtol=RTOL):
    """Relative to the largest magnitude of the reference."""
    j = np.asarray(j)
    np.testing.assert_allclose(_np(t), j, rtol=rtol, atol=rtol * np.abs(j).max())


def _jax_eps_chain(key, n):
    """The eps of ``n`` successive dof-path iterations from ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (D, P, S, 2 * T), dtype=jnp.float64))))
    return out


def _samples(means, scale, seed):
    """``[P * S, T, 2d]`` rows: each particle mean plus normal noise."""
    x = np.repeat(np.asarray(means), S, axis=0)
    return x + scale * np.random.default_rng(seed).normal(size=x.shape)


def test_native_build_equals_converted(problem):
    """``build_panda_problem`` equals the carried-over JAX problem: goals,
    spheres and the SE(3) target exactly (the same numpy draws), the
    factors and means to float64 roundoff (rtol 1e-12)."""
    ts, tc, tst, tobs = problem["torch"]
    ns, nc, nst, nobs, s = build_panda_problem(G, PPG, T, S, dtype=torch.float64, device="cpu")
    assert s == S
    np.testing.assert_array_equal(nobs["obstacle_spheres"].numpy(), tobs["obstacle_spheres"].numpy())
    nq, tq = nc.costs[0].dof_form, tc.costs[0].dof_form
    np.testing.assert_array_equal(nq.g_pd.numpy(), tq.g_pd.numpy())
    np.testing.assert_allclose(nc.costs[1].target_h.numpy(), tc.costs[1].target_h.numpy(),
                               rtol=0, atol=1e-15)
    for name in ("q_i2", "k_s2", "k_g2", "s_pd"):
        _close(getattr(nq, name), getattr(tq, name), rtol=1e-12)
    _close(ns.dof.w_dof, ts.dof.w_dof, rtol=1e-12)
    _close(nst.particle_means, tst.particle_means, rtol=1e-12)


def test_dof_planes_layout_and_stencils(problem):
    """``to_dof_planes``/``from_dof_planes`` exactly; ``matvec_planes``,
    ``sample_planes`` (injected eps) and ``grad_dof_planes`` within rtol
    1e-10 of the largest entry (float64, the stencil's ~2e11 weights)."""
    js, jc, jst, _ = problem["jax"]
    ts, tc, tst, _ = problem["torch"]
    from stoch_gpmp_tpu.gp.dof_factored import to_dof_planes as jto

    x = _samples(jst.particle_means, 1e-3, 1)
    xp = to_dof_planes(torch.from_numpy(x))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jto(jnp.asarray(x))))
    np.testing.assert_array_equal(from_dof_planes(xp).numpy(), x)
    mu = to_dof_planes(tst.particle_means)
    _close(ts.dof.matvec_planes(mu), js.dof.matvec_planes(jto(jst.particle_means)), rtol=1e-10)
    (eps,) = _jax_eps_chain(jst.key, 1)
    tx, tcorr = ts.dof.sample_planes(None, mu, S, eps=eps)
    jcorr = (jnp.asarray(eps.numpy()).reshape(-1, 2 * T) @ js.dof.w_dof).reshape(eps.shape)
    _close(tcorr, jcorr, rtol=1e-12)
    _close(tx, np.asarray(mu)[:, :, None] + np.asarray(jcorr), rtol=1e-12)
    dq, jdq = tc.costs[0].dof_form, jc.costs[0].dof_form
    _close(dq.grad_dof_planes(xp), jdq.grad_dof_planes(jnp.asarray(xp.numpy())), rtol=1e-10)


def test_dof_quad_plain_matches_jax(problem):
    """K3's plain version: float64 against ``DofQuadraticCost
    .eval_dof_planes`` plus the importance term ``tau * x . pu``, rtol 1e-12
    (the same residual form, summed in another order); float32 against
    ``dof_quad_eval_pallas(interpret=True)``, rtol 1e-5 (float32 sums in
    another order)."""
    js, jc, jst, _ = problem["jax"]
    ts, tc, tst, _ = problem["torch"]
    from stoch_gpmp_tpu.gp.dof_factored import to_dof_planes as jto
    from stoch_gpmp_tpu.ops.pallas.stencil import dof_quad_eval_pallas

    dq, jdq = tc.costs[0].dof_form, jc.costs[0].dof_form
    xp = to_dof_planes(torch.from_numpy(_samples(jst.particle_means, 1e-3, 2)))
    jx = jnp.asarray(xp.numpy())
    pu = ts.dof.matvec_planes(to_dof_planes(tst.particle_means))
    jpu = jnp.asarray(pu.numpy())
    tau = 0.25
    want = np.asarray(jdq.eval_dof_planes(jx))
    imp = np.einsum("dpsk,dpk->ps", xp.numpy().reshape(D, P, S, -1), pu.numpy()).reshape(-1)
    _close(dof_quad_eval_plain(dq, xp), want, rtol=1e-12)
    _close(dof_quad_eval_plain(dq, xp, pu=pu, temperature=tau, num_samples=S), want + tau * imp,
           rtol=1e-12)
    assert torch.equal(dof_quad_eval(dq, xp), dof_quad_eval_plain(dq, xp))  # CPU: plain
    dq32 = replace(dq, **{k: getattr(dq, k).float() for k in ("q_i2", "k_s2", "k_g2", "s_pd", "g_pd")})
    for kw, jkw in (({}, {}), (dict(pu=pu.float(), temperature=tau, num_samples=S),
                              dict(pu=jpu.astype(jnp.float32), temperature=tau, num_samples=S))):
        pal = dof_quad_eval_pallas(jdq, jx.astype(jnp.float32), interpret=True, **jkw)
        _close(dof_quad_eval_plain(dq32, xp.float(), **kw), pal, rtol=1e-5)


def test_fk_fields_plain_matches_jax(problem):
    """K4's plain version against ``fk_link_fields_cost_rows`` (interpret
    mode) on the dof planes' position view, float64, rtol 1e-12: rows in the
    planner regime and rows drawn across the joint range, with and without
    spheres."""
    from stoch_gpmp_tpu.ops.pallas.panda_fields import fk_link_fields_cost_rows as jrows

    js, jc, jst, jobs = problem["jax"]
    _, tc, _, tobs = problem["torch"]
    fields, jfields = tc.costs[1], jc.costs[1]
    x = _samples(jst.particle_means, 0.05, 3)
    x[P * S // 2:, :, :D] = np.random.default_rng(4).uniform(-2.8, 2.8, x[P * S // 2:, :, :D].shape)
    xp = to_dof_planes(torch.from_numpy(x))
    q = xp[:, :, :T]
    qrows = jnp.asarray(q.permute(1, 0, 2).reshape(P * S, D * T).numpy())
    for spheres, jsph in ((tobs["obstacle_spheres"], jobs["obstacle_spheres"]), (None, None)):
        kw = dict(margin=0.03, w_self=1e4, w_obst=1e4 if spheres is not None else 0.0)
        got = fk_link_fields_cost_rows_plain(fields.chain, q, None if spheres is None
                                             else spheres.reshape(-1, 4), **kw)
        want = jrows(jfields.chain, qrows, jfields.tmask, jsph, n_dof=D, tpad=T, **kw)
        _close(got, want, rtol=1e-12)
        assert torch.equal(fk_link_fields_cost_rows(fields.chain, q, spheres, **kw), got)


def test_plane_fields_cost_matches_jax(problem):
    """``PlaneFieldsCost.eval`` (flat ``[B, T, 2d]``), ``eval_dof_planes`` and
    ``eval_planes`` against JAX's ``eval``/``eval_dof_planes``, float64, rtol
    1e-12; and the whole composite's ``eval_dof_planes``."""
    js, jc, jst, jobs = problem["jax"]
    _, tc, _, tobs = problem["torch"]
    from stoch_gpmp_tpu.gp.dof_factored import to_dof_planes as jto

    x = _samples(jst.particle_means, 0.05, 5)
    jx = jnp.asarray(x)
    fields, jfields = tc.costs[1], jc.costs[1]
    want = np.asarray(jfields.eval(jx, observation=jobs))
    xt = torch.from_numpy(x)
    _close(fields.eval(xt, observation=tobs), want, rtol=1e-12)
    xp = to_dof_planes(xt)
    _close(fields.eval_dof_planes(xp, observation=tobs), want, rtol=1e-12)
    planes = tuple(xp[i, :, :T] for i in range(D))
    _close(fields.eval_planes(planes, observation=tobs), want, rtol=1e-12)
    _close(tc.eval_dof_planes(xp, observation=tobs),
           jc.eval_dof_planes(jto(jx), observation=jobs), rtol=1e-12)


@pytest.mark.parametrize("iters", [1, 3])
def test_dof_path_matches_jax(problem, iters):
    """``stoch_gpmp_optimize`` takes the dof path (T % 128 == 0) in both
    packages; with the JAX draws injected, new means, costs, weights and the
    last samples agree to rtol 1e-9 (float64; K3's plain version in the port
    against the composite's XLA stencil plus the importance sum in JAX)."""
    from stoch_gpmp_tpu.planners import stoch_gpmp_optimize as jopt

    js, jc, jst, jobs = problem["jax"]
    ts, tc, tst, tobs = problem["torch"]
    eps = _jax_eps_chain(jst.key, iters)
    jn, ja = jax.jit(lambda s, c, st, o: jopt(
        s, c, st, o, opt_iters=iters, num_samples=S, temperature=TAU, step_size=STEP))(
        js, jc, jst, jobs)
    tn, ta = stoch_gpmp_optimize(ts, tc, tst, tobs, opt_iters=iters, num_samples=S,
                                 temperature=TAU, step_size=STEP, eps=eps)
    _close(tn.particle_means, jn.particle_means)
    _close(ta.costs, ja.costs)
    _close(ta.weights, ja.weights)
    _close(ta.samples, ja.samples)
    _close(ta.grad, ja.grad)


def test_fused_dof_step_plain_matches_composed_jax_iteration(problem):
    """K5's plain version with injected eps against the same iteration
    composed from the JAX package's XLA pieces (its fused kernel seeds the
    TPU's hardware PRNG and cannot run off the TPU): ``x = mu + eps @
    w_dof``, ``cost.eval_dof_planes(x) + tau * x . Sigma^{-1} mu``, softmax,
    mean update. The kernel's SE(3) angle is the A&S polynomial (|err| <=
    2e-8 rad) where JAX uses ``arccos``; through ``w_goal = 2e8`` that moves
    a cost by at most ~1e-7 relative: costs rtol 1e-6, weights atol 1e-9,
    new means rtol 1e-9."""
    from stoch_gpmp_tpu.gp.dof_factored import to_dof_planes as jto

    js, jc, jst, jobs = problem["jax"]
    ts, tc, tst, tobs = problem["torch"]
    quad, fields = tc.costs
    (eps,) = _jax_eps_chain(jst.key, 1)
    step = make_fused_panda_dof_step(
        chain=fields.chain, dof_prior=ts.dof, dof_quad=quad.dof_form, num_particles=P,
        spheres=tobs["obstacle_spheres"], target_h=fields.target_h, n_dof=D, traj_len=T,
        num_samples=S, margin=fields.margin, w_self=1.0 / fields.sigma_self**2,
        w_obst=1.0 / fields.sigma_coll**2, w_goal=1.0 / fields.sigma_goal**2,
        temperature=TAU, step_size=STEP)
    mu = to_dof_planes(tst.particle_means)
    new, costs = step(mu, eps=eps)
    jmu = jto(jst.particle_means)
    jcorr = (jnp.asarray(eps.numpy()).reshape(-1, 2 * T) @ js.dof.w_dof).reshape(eps.shape)
    jx = jmu[:, :, None] + jcorr
    jcost = jc.eval_dof_planes(jx.reshape(D, P * S, 2 * T), observation=jobs).reshape(P, S)
    jcost = jcost + TAU * jnp.sum(jx * js.dof.matvec_planes(jmu)[:, :, None], axis=(0, -1))
    jw = jax.nn.softmax(-jcost / TAU, axis=1)
    jnew = jmu + STEP * jnp.einsum("ps,dpsk->dpk", jw, jcorr)
    _close(costs, jcost, rtol=1e-6)
    np.testing.assert_allclose(torch.softmax(-costs / TAU, 1).numpy(), np.asarray(jw), atol=1e-9)
    _close(new, jnew)
    # the wrapper on CPU tensors is the plain version, eps or seed
    assert torch.equal(fused_panda_dof_step(step, mu, eps=eps)[1],
                       fused_panda_dof_step_plain(step, mu, eps)[1])


def _panda_planner(fused, cost, goals, **kw):
    start_q = torch.tensor(PANDA_START_Q, dtype=torch.float64)
    args = dict(
        num_particles_per_goal=PPG, num_samples=S, traj_len=T, dt=0.05, n_dof=D, opt_iters=4,
        temperature=TAU, start_state=torch.cat([start_q, torch.zeros_like(start_q)]),
        multi_goal_states=goals, cost=cost, step_size=STEP, sigma_start_init=1e-3,
        sigma_goal_init=0.07, sigma_gp_init=0.1, sigma_start_sample=1e-3,
        sigma_goal_sample=0.07, sigma_gp_sample=0.1, seed=0, dtype=torch.float64,
        device="cpu", fused_kernel=fused)
    args.update(kw)
    return StochGPMP(**args), start_q


@pytest.mark.parametrize("fused", [False, True])
def test_panda_class_api(problem, fused):
    """``StochGPMP`` on the Panda stack, with and without ``fused_kernel``
    (its first iterations in K5's plain version on the CPU): the
    reference-shaped 6-tuple, finite, the mean cost falling, the start held
    within 2e-2 (the JAX package's TPU-test gate)."""
    _, tc, _, tobs = problem["torch"]
    dq = tc.costs[0].dof_form
    goals = torch.cat([dq.g_pd[..., 0], dq.g_pd[..., 1]], dim=-1)
    planner, start_q = _panda_planner(fused, tc, goals)

    def cost_of(means):
        return float(tc.eval_dof_planes(to_dof_planes(means), observation=tobs).mean())

    c0 = cost_of(planner.particle_means)
    out = planner.optimize(observation=tobs)
    shapes = [(P, T, D), (P, T, D), (P, S, T, D), (P, S, T, D), (P, S), (P, T, 2 * D)]
    assert [tuple(o.shape) for o in out] == shapes
    assert all(torch.isfinite(o).all() for o in out)
    assert cost_of(planner.particle_means) < c0
    np.testing.assert_allclose(planner.particle_means[:, 0, :D].numpy(),
                               np.broadcast_to(start_q.numpy(), (P, D)), atol=2e-2)
    assert planner.get_traj("best").shape == (T, 2 * D)
    assert planner.get_recent_samples()[0].shape == (P, S, T, D)
    if fused:
        assert planner._fused_runner(tobs).step.num_particles == P


def test_panda_wrappers_contract(problem):
    """K3/K4/K5 wrappers: CPU tensors take the plain versions and count no
    launch; another device raises; K5 takes exactly one of eps and seed, and
    a seed gives the same draw twice."""
    ts, tc, tst, tobs = problem["torch"]
    quad, fields = tc.costs
    mu = to_dof_planes(tst.particle_means)
    step = make_fused_panda_dof_step(
        chain=fields.chain, dof_prior=ts.dof, dof_quad=quad.dof_form, num_particles=P,
        spheres=tobs["obstacle_spheres"], target_h=fields.target_h, n_dof=D, traj_len=T,
        num_samples=S, margin=0.03, w_self=1e4, w_obst=1e4, w_goal=2e8)
    with pytest.raises(ValueError, match="exactly one"):
        fused_panda_dof_step(step, mu)
    a, b = step(mu, seed=5), step(mu, seed=5)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], step(mu, seed=6)[0])
    launches = (dof_quad_eval.launches, fk_link_fields_cost_rows.launches,
                fused_panda_dof_step.launches)
    assert launches == (0, 0, 0)
    meta = mu.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dof_quad_eval(quad.dof_form, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fk_link_fields_cost_rows(fields.chain, meta[:, :, :T], None, margin=0.03, w_self=1.0,
                                 w_obst=0.0)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_panda_dof_step(step, meta, seed=1)


def test_convert_round_trips(problem):
    """The sampler's dof factor, the Panda stack and the observation carry
    over exactly (float64 both sides)."""
    js, jc, jst, jobs = problem["jax"]
    ts, tc, tst, tobs = problem["torch"]
    for name in ("w_dof", "prec_dof", "q_i2", "k_s2", "k_g2"):
        np.testing.assert_array_equal(getattr(ts.dof, name).numpy(), np.asarray(getattr(js.dof, name)))
    fields, jfields = tc.costs[1], jc.costs[1]
    assert fields.chain.link_names == list(jfields.chain.link_names)
    np.testing.assert_array_equal(fields.target_h.numpy(), np.asarray(jfields.target_h))
    for name in ("margin", "sigma_self", "sigma_coll", "sigma_goal", "w_pos", "w_rot"):
        assert getattr(fields, name) == getattr(jfields, name)
    np.testing.assert_array_equal(tobs["obstacle_spheres"].numpy(), np.asarray(jobs["obstacle_spheres"]))
    assert tc.supports_dof_planes()
    assert tc.costs[0].dof_form.stencil_weights[0] == float(jc.costs[0].dof_form.q_i2[0, 0])


def test_entry_points_default_to_cuda():
    """``device=None`` means the CUDA card: without one every entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from stoch_gpmp_tpu_torch.problems import build_planar_cost, build_planar_problem

    for fn in (build_planar_problem, build_planar_cost, lambda: build_panda_problem(1, 2),
               lambda: convert.state_from_jax(None), lambda: convert.cost_from_jax(None),
               lambda: convert.observation_from_jax({})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StochGPMP(num_particles_per_goal=1, num_samples=2, traj_len=8, opt_iters=1, dt=0.1,
                  n_dof=2, start_state=[0.0] * 4, cost=None, sigma_start_init=1.0,
                  sigma_gp_init=1.0, sigma_start_sample=1.0, sigma_gp_sample=1.0)


def test_panda_slice_never_imports_jax():
    """The Panda slices' modules (the dof path's and the flat path's, K3-K8),
    a CPU build of both stacks and an evaluation of each load no JAX and
    nothing of the JAX package."""
    code = (
        "import sys, torch\n"
        "import stoch_gpmp_tpu_torch.kinematics, stoch_gpmp_tpu_torch.costs.fused_fields\n"
        "import stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof, stoch_gpmp_tpu_torch.ops.kernels.panda_step\n"
        "import stoch_gpmp_tpu_torch.costs.fields, stoch_gpmp_tpu_torch.convert\n"
        "from stoch_gpmp_tpu_torch.problems import build_panda_problem\n"
        "from stoch_gpmp_tpu_torch.planners import stoch_gpmp_optimize\n"
        "sa, c, st, o, s = build_panda_problem(1, 2, 128, 2, device='cpu')\n"
        "stoch_gpmp_optimize(sa, c, st, o, opt_iters=1, num_samples=s, temperature=1.0, step_size=0.1)\n"
        "sa, c, st, o, s = build_panda_problem(device='cpu', fast=False)\n"
        "c.eval(st.particle_means, observation=o)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'stoch_gpmp_tpu.', 'benchmarks')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
