"""The flat-layout Panda slice of the PyTorch port against the JAX package:
``benchmarks/run.py`` config 4 at its full width (1 goal x 5 particles, 32
samples, T = 64, 7 DOF, 5 spheres).

- K6's plain version (the whole flat Panda iteration) with the JAX draw
  injected, against the JAX ``stoch_gpmp_step`` on the fast stack (the JAX
  fused kernel seeds the TPU's hardware PRNG and cannot run off the TPU),
  and the RNG-free tiers of the JAX package's TPU test;
- the flat path on the reference-shaped stack against JAX;
- config 4 through all four routes on the CPU, and the contracts.

The JAX problem mirrors ``benchmarks/run.py _panda_problem`` with a dtype
argument and is carried over by ``convert``; the eps draws are rebuilt from
the JAX state key exactly as ``stoch_gpmp_step`` draws them. Each test
states its tolerance.
"""

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
from stoch_gpmp_tpu_torch.costs import CostComposite, FusedLinkFieldsCost  # noqa: E402
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (  # noqa: E402
    fk_link_fields_cost,
    fk_link_fields_cost_rows,
    fused_link_fields_cost,
)
from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (  # noqa: E402
    ctas_per_particle,
    prec_u_lanes,
)
from stoch_gpmp_tpu_torch.ops.kernels.panda_step import (  # noqa: E402
    fused_panda_optimize,
    fused_panda_step,
    fused_panda_step_plain,
    make_fused_panda_step,
)
from stoch_gpmp_tpu_torch.planners import StochGPMP, stoch_gpmp_optimize  # noqa: E402
from stoch_gpmp_tpu_torch.problems import (  # noqa: E402
    PANDA_DT,
    PANDA_START_Q,
    build_panda_problem,
)

G, PPG, S, T, D = 1, 5, 32, 64, 7
P, M = G * PPG, T * 2 * D
TAU, STEP = 1.0, 0.1


def _jax_config4(dtype, fast):
    """``benchmarks/run.py _panda_problem(fast=fast)`` at config 4 with a
    dtype and a ``PRNGKey(0)`` state key."""
    from stoch_gpmp_tpu.costs import (
        CostCollision, CostComposite, CostGP, CostGoal, CostGoalPrior,
        EESE3DistanceField, LinkDistanceField, LinkSelfDistanceField,
    )
    from stoch_gpmp_tpu.costs.fused_fields import PlaneFieldsCost
    from stoch_gpmp_tpu.costs.quadratic import QuadraticCost
    from stoch_gpmp_tpu.gp.prior import make_gp_prior
    from stoch_gpmp_tpu.kinematics import homogeneous, y_rot, z_rot
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda
    from stoch_gpmp_tpu.planners import SamplerModel, StochGPMPState

    chain = franka_panda(dtype=dtype)
    target_h = homogeneous(z_rot(jnp.asarray(-np.pi, dtype)) @ y_rot(jnp.asarray(-np.pi, dtype)),
                           jnp.asarray([0.3, 0.3, 0.3], dtype))
    start_q = jnp.asarray(PANDA_START_Q, dtype)
    start = jnp.concatenate([start_q, jnp.zeros_like(start_q)])
    rng = np.random.default_rng(0)
    goals_q = start_q[None] + jnp.asarray(rng.uniform(-0.3, 0.3, (G, D)), dtype)
    goals = jnp.concatenate([goals_q, jnp.zeros_like(goals_q)], axis=-1)
    gp = CostGP.create(D, T, start, PANDA_DT, {"sigma_start": 0.0001, "sigma_gp": 0.0007},
                       dtype=dtype)
    goal = CostGoalPrior.create(D, T, goals, sigma_goal_prior=20.0, dtype=dtype)
    if fast:
        cost = CostComposite.create(D, T, [
            QuadraticCost.from_gp_and_goal_prior(gp, goal, T),
            PlaneFieldsCost.create(D, T, chain, target_h, margin=0.03, sigma_self=0.01,
                                   sigma_coll=0.01, sigma_goal=0.00007)])
    else:
        cost = CostComposite.create(D, T, [
            gp, goal,
            CostCollision.create(D, T, LinkSelfDistanceField(margin=0.03), sigma_coll=0.01),
            CostCollision.create(D, T, LinkDistanceField(), sigma_coll=0.01),
            CostGoal.create(D, T, EESE3DistanceField(target_h=target_h), sigma_goal=0.00007),
        ], fk=chain.fk_compact)
    prior = make_gp_prior(D, T, PANDA_DT, start, 0.001, 0.1, sigma_goal=0.07, goal_states=goals,
                          dtype=dtype)
    state = StochGPMPState(particle_means=jnp.repeat(prior.means, PPG, axis=0),
                           key=jax.random.PRNGKey(0))
    spheres = np.zeros((1, 5, 4))
    spheres[0, :, :3] = rng.uniform([0.6, -0.2, 0.6], [1.0, 0.2, 1.0], (5, 3))
    spheres[0, :, 3] = rng.uniform(0.1, 0.2, 5)
    return SamplerModel.from_prior(prior), cost, state, {"obstacle_spheres": jnp.asarray(spheres, dtype)}


@pytest.fixture(scope="module")
def problems():
    """The JAX config-4 problems and their conversions to the port on the
    CPU, by ``(dtype name, stack)``."""
    out = {}
    for name, jdt, tdt in (("float64", jnp.float64, torch.float64),
                           ("float32", jnp.float32, torch.float32)):
        for stack in ("fast", "ref"):
            if name == "float32" and stack == "ref":
                continue
            js, jc, jst, jobs = _jax_config4(jdt, stack == "fast")
            kw = dict(device="cpu", dtype=tdt)
            out[name, stack] = {
                "jax": (js, jc, jst, jobs),
                "torch": (convert.sampler_from_jax(js, **kw), convert.cost_from_jax(jc, **kw),
                          convert.state_from_jax(jst, **kw),
                          convert.observation_from_jax(jobs, **kw)),
            }
    return out


def _eps_chain(key, n, dtype):
    """The eps of ``n`` successive ``stoch_gpmp_step`` calls from ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, (P, S, M), dtype=dtype))))
    return out


def _close(t, j, rtol=None, atol=None):
    """``rtol`` relative to the largest magnitude of the reference, or an
    absolute ``atol``."""
    j = np.asarray(j, dtype=np.float64)
    t = (t.numpy() if torch.is_tensor(t) else np.asarray(t)).astype(np.float64)
    tol = atol if atol is not None else rtol * np.abs(j).max()
    np.testing.assert_allclose(t, j, rtol=0, atol=tol)


def _step(sampler, cost, obs, **over):
    """K6's step object for the converted fast stack."""
    quad, fields = cost.costs
    kw = dict(
        chain=fields.chain, weight_t=sampler.weight_t, dof_prior=sampler.dof,
        dof_quad=quad.dof_form, num_particles=P, spheres=obs["obstacle_spheres"],
        target_h=fields.target_h, n_dof=D, traj_len=T, num_samples=S, margin=fields.margin,
        w_self=1.0 / fields.sigma_self**2, w_obst=1.0 / fields.sigma_coll**2,
        w_goal=1.0 / fields.sigma_goal**2, temperature=TAU, step_size=STEP)
    kw.update(over)
    return make_fused_panda_step(**kw)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_panda_step_plain_matches_jax_step(problems, dtype):
    """K6's plain version at config 4 with the JAX draw injected against the
    JAX ``stoch_gpmp_step`` on the fast stack (the same iteration, composed
    of XLA pieces and the Pallas field kernel in interpret mode). The
    kernel's SE(3) angle is the A&S polynomial (|err| <= 2e-8 rad) where JAX
    uses ``arccos``; through ``w_goal = 2e8`` that moves a cost by ~1e-8
    relative. float64: costs rtol 1e-6, new means rtol 1e-9; float32: costs
    rtol 2e-4, new means atol 1e-5."""
    from stoch_gpmp_tpu.planners import stoch_gpmp_step as jstep

    js, jc, jst, jobs = problems[dtype, "fast"]["jax"]
    ts, tc, tst, tobs = problems[dtype, "fast"]["torch"]
    (eps,) = _eps_chain(jst.key, 1, jnp.float64 if dtype == "float64" else jnp.float32)
    jn, ja = jax.jit(lambda s, c, st, o: jstep(
        s, c, st, o, num_samples=S, temperature=TAU, step_size=STEP))(js, jc, jst, jobs)
    step = _step(ts, tc, tobs)
    new, costs = step(tst.particle_means, eps=eps)
    if dtype == "float64":
        _close(costs, ja.costs, rtol=1e-6)
        _close(new, jn.particle_means, rtol=1e-9)
    else:
        _close(costs, ja.costs, rtol=2e-4)
        _close(new, jn.particle_means, atol=1e-5)
    assert new.dtype == tst.particle_means.dtype and costs.shape == (P, S)


def _host_f64_quad_flat(dq, means):
    """Float64 numpy oracle of the stencil quadratic on flat ``[P, T, 2d]``
    (``tests/test_fused_panda_tpu.py``)."""
    x = np.asarray(means, dtype=np.float64)
    d = x.shape[-1] // 2
    q, ks, kg = (np.asarray(getattr(dq, k), np.float64) for k in ("q_i2", "k_s2", "k_g2"))
    s_pd, g_pd = np.asarray(dq.s_pd, np.float64), np.asarray(dq.g_pd, np.float64)
    pos, vel = x[..., :d], x[..., d:]
    rp = pos[:, :-1] + float(dq.dt) * vel[:, :-1] - pos[:, 1:]
    rv = vel[:, :-1] - vel[:, 1:]
    e = (q[0, 0] * rp**2 + 2 * q[0, 1] * rp * rv + q[1, 1] * rv**2).sum((1, 2))
    r0p, r0v = pos[:, 0] - s_pd[None, :, 0], vel[:, 0] - s_pd[None, :, 1]
    e += (ks[0, 0] * r0p**2 + 2 * ks[0, 1] * r0p * r0v + ks[1, 1] * r0v**2).sum(1)
    gp = np.repeat(g_pd, x.shape[0] // dq.num_goals, axis=0)
    rgp, rgv = pos[:, -1] - gp[..., 0], vel[:, -1] - gp[..., 1]
    e += (kg[0, 0] * rgp**2 + 2 * kg[0, 1] * rgp * rgv + kg[1, 1] * rgv**2).sum(1)
    return e


@pytest.mark.parametrize("tier", ["fields", "full"])
def test_fused_panda_step_rng_free_tiers(problems, tier):
    """The JAX package's RNG-free TPU gates (``tests/test_fused_panda_tpu.py
    :97-120``) on K6's plain version in float32, ``W = 0`` so every sample is
    its particle's mean: fields + goal + importance (quadratic zeroed) within
    3e-4 of the JAX fast stack's fields on the means plus the importance
    term; the full stack within 1e-3 of a float64 stencil oracle; the means
    unmoved within 1e-5."""
    js, jc, jst, jobs = problems["float32", "fast"]["jax"]
    ts, tc, tst, tobs = problems["float32", "fast"]["torch"]
    means = tst.particle_means
    pu = ts.dof.matvec_flat(means).reshape(P, -1)
    imp = torch.sum(means.reshape(P, -1).double() * pu.double(), dim=-1).numpy()
    ref_f = np.asarray(jc.costs[1].eval(jst.particle_means, observation=jobs), np.float64) + imp
    dq = tc.costs[0].dof_form
    if tier == "fields":
        z = torch.zeros((2, 2))
        dq, want, rtol = replace(dq, q_i2=z, k_s2=z, k_g2=z), ref_f, 3e-4
    else:
        want, rtol = _host_f64_quad_flat(jc.costs[0].dof_form, jst.particle_means) + ref_f, 1e-3
    step = _step(ts, tc, tobs, weight_t=torch.zeros((M, M)), dof_quad=dq)
    new, costs = step(means, seed=0)
    np.testing.assert_allclose(costs.double().numpy(), np.broadcast_to(want[:, None], (P, S)),
                               rtol=rtol)
    np.testing.assert_allclose(new.numpy(), means.numpy(), rtol=0, atol=1e-5)


def test_flat_path_reference_stack_matches_jax(problems):
    """``stoch_gpmp_optimize`` on the reference-shaped stack
    (``CostComposite(fk=chain.fk_compact)``, T = 64: the flat path in both
    packages), 3 iterations with the JAX draws injected, float64: new means,
    costs, weights and the last samples within rtol 1e-9."""
    from stoch_gpmp_tpu.planners import stoch_gpmp_optimize as jopt

    js, jc, jst, jobs = problems["float64", "ref"]["jax"]
    ts, tc, tst, tobs = problems["float64", "ref"]["torch"]
    eps = _eps_chain(jst.key, 3, jnp.float64)
    jn, ja = jax.jit(lambda s, c, st, o: jopt(
        s, c, st, o, opt_iters=3, num_samples=S, temperature=TAU, step_size=STEP))(
        js, jc, jst, jobs)
    tn, ta = stoch_gpmp_optimize(ts, tc, tst, tobs, opt_iters=3, num_samples=S,
                                 temperature=TAU, step_size=STEP, eps=eps)
    _close(tn.particle_means, jn.particle_means, rtol=1e-9)
    _close(ta.costs, ja.costs, rtol=1e-9)
    _close(ta.weights, ja.weights, rtol=1e-9)
    _close(ta.samples, ja.samples, rtol=1e-9)


def _routes_problem():
    """Config 4 in float32 on the CPU: the fast and reference-shaped stacks,
    the FusedLinkFieldsCost stack, and the shared sampler, means and
    observation."""
    sampler, fast, state, obs, s = build_panda_problem(device="cpu")
    _, ref, _, _, _ = build_panda_problem(device="cpu", fast=False)
    fused = CostComposite.create(D, T, [ref.costs[0], ref.costs[1], FusedLinkFieldsCost.create(D, T),
                                        ref.costs[4]], fk=ref.fk)
    return sampler, {"b": fast, "c": ref, "d": fused}, state, obs, s


@pytest.mark.parametrize("route", ["a", "b", "c", "d"])
def test_config4_routes_on_cpu(route):
    """Config 4 on CPU tensors through each route, 4 iterations from the
    straight-line means: (a) the fused K6 loop (its plain version), (b) the
    fast stack, (c) the reference-shaped stack and (d) the same with
    ``FusedLinkFieldsCost``, each through ``StochGPMP``, which returns the
    reference's 6-tuple. The fast stack's mean cost on the means falls and
    every particle's t = 0 stays within 2e-2 of the start (the JAX
    package's TPU-test gates)."""
    sampler, stacks, state, obs, s = _routes_problem()
    fast = stacks["b"]
    c0 = float(fast.eval(state.particle_means, observation=obs).mean())
    if route == "a":
        step = _step(sampler, fast, obs)
        gen = torch.Generator().manual_seed(0)
        means = fused_panda_optimize(step, state.particle_means, gen, 4)
    else:
        planner = StochGPMP(
            num_particles_per_goal=PPG, num_samples=s, traj_len=T, dt=PANDA_DT, n_dof=D,
            opt_iters=4, temperature=TAU, step_size=STEP,
            start_state=torch.cat([torch.tensor(PANDA_START_Q), torch.zeros(D)]),
            multi_goal_states=fast.costs[0].dof_form.g_pd.permute(0, 2, 1).reshape(G, -1),
            initial_particle_means=state.particle_means, cost=stacks[route],
            sigma_start_sample=0.001, sigma_gp_sample=0.1, sigma_goal_sample=0.07, seed=0,
            device="cpu")
        out = planner.optimize(observation=obs)
        shapes = [(P, T, D), (P, T, D), (P, S, T, D), (P, S, T, D), (P, S), (P, T, 2 * D)]
        assert [tuple(o.shape) for o in out] == shapes
        assert all(torch.isfinite(o).all() for o in out)
        means = planner.particle_means
    assert torch.isfinite(means).all() and means.shape == (P, T, 2 * D)
    assert float(fast.eval(means, observation=obs).mean()) < c0
    np.testing.assert_allclose(means[:, 0, :D].numpy(),
                               np.broadcast_to(np.float32(PANDA_START_Q), (P, D)), atol=2e-2)


def test_stacks_agree_on_planner_means():
    """After 2 fast-stack iterations on the CPU, stacks (c) and (d) equal
    stack (b) on the means within rtol 1e-4 (float32; the card's gate)."""
    sampler, stacks, state, obs, s = _routes_problem()
    out, _ = stoch_gpmp_optimize(sampler, stacks["b"], state, obs, opt_iters=2, num_samples=s,
                                 temperature=TAU, step_size=STEP)
    means = out.particle_means
    want = stacks["b"].eval(means, observation=obs).double().numpy()
    for r in ("c", "d"):
        np.testing.assert_allclose(stacks[r].eval(means, observation=obs).double().numpy(), want,
                                   rtol=1e-4)


def test_fused_kernel_rejects_t64_panda_stack():
    """``StochGPMP(fused_kernel=True)`` on config 4's fast stack raises with
    the JAX executor's reason (``fused_exec.py:72-74``): K6 is reached
    through ``make_fused_panda_step`` only, as in the JAX package."""
    sampler, stacks, state, obs, s = _routes_problem()
    planner = StochGPMP(
        num_particles_per_goal=PPG, num_samples=s, traj_len=T, dt=PANDA_DT, n_dof=D,
        opt_iters=3, start_state=torch.cat([torch.tensor(PANDA_START_Q), torch.zeros(D)]),
        multi_goal_states=stacks["b"].costs[0].dof_form.g_pd.permute(0, 2, 1).reshape(G, -1),
        initial_particle_means=state.particle_means, cost=stacks["b"],
        sigma_start_sample=0.001, sigma_gp_sample=0.1, sigma_goal_sample=0.07, device="cpu",
        fused_kernel=True)
    with pytest.raises(ValueError, match=r"traj_len=64 not a multiple of 128 \(plane lanes\)"):
        planner.optimize(observation=obs)


def test_fused_panda_step_wrapper_contract():
    """K6's wrapper: exactly one of eps and seed; a seed gives the same draw
    twice and another seed another; CPU tensors take the plain version and
    count no launch; another device raises."""
    sampler, stacks, state, obs, s = _routes_problem()
    step = _step(sampler, stacks["b"], obs)
    means = state.particle_means.reshape(P, -1)
    with pytest.raises(ValueError, match="exactly one"):
        fused_panda_step(step, means)
    with pytest.raises(ValueError, match="exactly one"):
        fused_panda_step(step, means, seed=1, eps=torch.zeros((P, S, M)))
    a, b = fused_panda_step(step, means, seed=5), fused_panda_step(step, means, seed=5)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], fused_panda_step(step, means, seed=6)[0])
    eps = torch.randn((P, S, M), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a[1], fused_panda_step_plain(step, means, eps)[1])
    assert (fused_panda_step.launches, fused_link_fields_cost.launches,
            fk_link_fields_cost.launches, fk_link_fields_cost_rows.launches) == (0, 0, 0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_panda_step(step, means.to("meta"), seed=1)


@pytest.mark.parametrize("which", ["means", "samples"])
def test_prec_u_lanes_matches_jax_matvec_flat(problems, which):
    """K6's per-lane ``Sigma^{-1} mu`` (``prec_u_lanes``) against the JAX
    package's ``DofFactoredPrior.matvec_flat`` at the Panda shape (d = 7,
    T = 64), float64, on config 4's means and on noisy samples around
    them: rtol 1e-12 of the largest entry."""
    js, _, jst, _ = problems["float64", "fast"]["jax"]
    ts = problems["float64", "fast"]["torch"][0]
    x = np.array(jst.particle_means)
    if which == "samples":
        x = x + np.random.default_rng(5).normal(scale=0.05, size=x.shape)
    want = np.asarray(js.dof.matvec_flat(jnp.asarray(x)))
    got = prec_u_lanes(torch.from_numpy(x), ts.dof.q_i2, ts.dof.k_s2, ts.dof.k_g2, ts.dof.dt)
    assert got.shape == x.shape == (P, T, 2 * D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_k6_cluster_split_at_config4():
    """K6's split at config 4 on the H100 SXM's 132 SMs: 8 CTAs per particle
    of one 4-row tile (40 CTAs); 1 where the particles alone fill the card
    (P = 100: 2 x 100 > 132), doubled where a CTA of that split does not
    fit (``fits`` standing for the kernel's answer); and a sample count
    whose CTA rows fit at no split is refused."""
    _, _, _, _, s = _routes_problem()
    anything = lambda c: True  # noqa: E731
    assert ctas_per_particle(P, s, 4, 132, anything) == 8
    assert ctas_per_particle(100, s, 4, 132, anything) == 1
    assert ctas_per_particle(100, s, 4, 132, lambda c: c >= 2) == 2
    with pytest.raises(ValueError, match="fits a CTA's shared memory"):
        ctas_per_particle(P, 8 * 64 + 4, 4, 132, lambda c: False)
