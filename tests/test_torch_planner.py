"""The problem, the cost stack and the planner of the PyTorch port against
the JAX package, at the full planar parity width (3 goals x 5 particles,
128 samples, T = 64), float64.

The JAX problem is ``__graft_entry__._build_problem(fast=True)`` carried over
by ``convert``; the eps draws are rebuilt from the JAX state key exactly as
``stoch_gpmp_step`` draws them and injected into the port. Tolerance: rtol
1e-9 on new means, costs and weights (float64 in both; only the summation
order differs).
"""

import subprocess
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
from stoch_gpmp_tpu_torch.ops.kernels.fused_step import (  # noqa: E402
    ctas_per_particle,
    fused_planar_optimize,
    fused_planar_step,
    fused_planar_step_per_particle,
    make_fused_planar_step,
    make_fused_planar_step_batched,
    prec_u_lanes,
)
from stoch_gpmp_tpu_torch.planners import (  # noqa: E402
    StochGPMP,
    stoch_gpmp_optimize,
    stoch_gpmp_step,
)
from stoch_gpmp_tpu_torch.problems import (  # noqa: E402
    GOALS,
    START,
    build_planar_cost,
    build_planar_problem,
)

S, TAU, STEP = 128, 1.0, 0.5
RTOL = 1e-9


@pytest.fixture(scope="module")
def problem():
    """The JAX parity problem, its stencil-branch twin (goal anchor
    sigma 1e-5, weight 1e10) and both carried over to the port."""
    from __graft_entry__ import _build_problem
    from stoch_gpmp_tpu.costs import CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.costs.quadratic import QuadraticCost

    js, jc, jst = _build_problem(fast=True, dtype=jnp.float64)
    gp = CostGP.create(2, 64, jnp.asarray(START), 0.02,
                       {"sigma_start": 0.001, "sigma_gp": 0.1}, dtype=jnp.float64)
    goal = CostGoalPrior.create(2, 64, jnp.asarray(GOALS), sigma_goal_prior=1e-5,
                                dtype=jnp.float64)
    jc_st = CostComposite.create(
        2, 64, [QuadraticCost.from_gp_and_goal_prior(gp, goal, 64), jc.costs[1]])
    return {
        "jax": (js, {"matmul": jc, "stencil": jc_st}, jst),
        "torch": (convert.sampler_from_jax(js, device="cpu"),
                  {"matmul": convert.cost_from_jax(jc, device="cpu"),
                   "stencil": convert.cost_from_jax(jc_st, device="cpu")},
                  convert.state_from_jax(jst, device="cpu")),
    }


def _jax_eps_chain(key, shape, n):
    """The eps of ``n`` successive ``stoch_gpmp_step`` calls from ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, dtype=jnp.float64))))
    return out


def _jax_step(js, jc, jst):
    from stoch_gpmp_tpu.planners import stoch_gpmp_step as jstep

    return jax.jit(lambda s, c, st: jstep(
        s, c, st, {}, num_samples=S, temperature=TAU, step_size=STEP))(js, jc, jst)


def _close(t, j, rtol=RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * np.abs(j).max())


@pytest.mark.parametrize("branch", ["matmul", "stencil"])
def test_step_matches_jax(problem, branch):
    js, jcs, jst = problem["jax"]
    ts, tcs, tst = problem["torch"]
    p, t, d = jst.particle_means.shape
    (eps,) = _jax_eps_chain(jst.key, (p, S, t * d), 1)
    jn, ja = _jax_step(js, jcs[branch], jst)
    tn, ta = stoch_gpmp_step(ts, tcs[branch], tst, {}, num_samples=S,
                             temperature=TAU, step_size=STEP, eps=eps)
    _close(tn.particle_means, jn.particle_means)
    _close(ta.costs, ja.costs)
    _close(ta.weights, ja.weights)
    _close(ta.samples, ja.samples)


def test_optimize_three_iterations_matches_jax(problem):
    from stoch_gpmp_tpu.planners import stoch_gpmp_optimize as jopt

    js, jcs, jst = problem["jax"]
    ts, tcs, tst = problem["torch"]
    p, t, d = jst.particle_means.shape
    eps = _jax_eps_chain(jst.key, (p, S, t * d), 3)
    jn, ja = jax.jit(lambda s, c, st: jopt(
        s, c, st, {}, opt_iters=3, num_samples=S, temperature=TAU,
        step_size=STEP))(js, jcs["matmul"], jst)
    tn, ta = stoch_gpmp_optimize(ts, tcs["matmul"], tst, {}, opt_iters=3, num_samples=S,
                                 temperature=TAU, step_size=STEP, eps=eps)
    _close(tn.particle_means, jn.particle_means)
    _close(ta.costs, ja.costs)
    _close(ta.weights, ja.weights)


@pytest.mark.parametrize("branch", ["matmul", "stencil"])
def test_fused_step_plain_matches_jax_step(problem, branch):
    """The fused step's plain version (K2) against JAX's flat
    ``stoch_gpmp_step`` with the same eps. The JAX fused kernel itself
    cannot run off the TPU (it seeds the TPU hardware PRNG), and the flat
    step computes the same update. In the matmul branch K2's costs are the
    step's costs minus the per-goal constant c (it cancels in the softmax),
    so new means and weights are equal; in the stencil branch the costs are
    equal outright."""
    js, jcs, jst = problem["jax"]
    ts, tcs, tst = problem["torch"]
    quad, coll = tcs[branch].costs
    p, t, d = jst.particle_means.shape
    (eps,) = _jax_eps_chain(jst.key, (p, S, t * d), 1)
    jn, ja = _jax_step(js, jcs[branch], jst)
    field = coll.field
    step = make_fused_planar_step_batched(
        weight_t=ts.weight_t, dof_prior=ts.dof, dof_quad=quad.dof_form,
        num_particles=p, rect_bounds=field.rect_bounds, circles=field.circles,
        cell_size=field.cell_size, nx=field.nx, ny=field.ny, traj_len=t,
        state_dim=d, num_samples=S, k_coll=1.0 / coll.sigma_coll**2,
        temperature=TAU, step_size=STEP,
    )
    assert step.use_stencil == (branch == "stencil")
    new_means, costs = step(tst.particle_means, eps=eps)
    want = np.asarray(ja.costs)
    if branch == "matmul":
        want = want - np.repeat(quad.c.numpy(), p // 3)[:, None]
    np.testing.assert_allclose(costs.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    _close(torch.softmax(-costs / TAU, dim=1), ja.weights)
    _close(new_means, jn.particle_means)


def _k9_step(ts, quad, coll, p, num_samples=S):
    field = coll.field
    return make_fused_planar_step(
        weight_t=ts.weight_t, dof_prior=ts.dof, dof_quad=quad.dof_form,
        num_particles=p, rect_bounds=field.rect_bounds, circles=field.circles,
        cell_size=field.cell_size, nx=field.nx, ny=field.ny, traj_len=64,
        state_dim=4, num_samples=num_samples, k_coll=1.0 / coll.sigma_coll**2,
        temperature=TAU, step_size=STEP,
    )


@pytest.mark.parametrize("branch", ["matmul", "stencil"])
def test_fused_step_per_particle_plain_matches_jax_step(problem, branch):
    """K9's plain version with an eps operand against JAX's flat
    ``stoch_gpmp_step`` with the same eps, under K2's tolerances (the JAX
    K9 seeds the TPU hardware PRNG and cannot run off the TPU): in the
    matmul branch the costs omit the per-goal constant c."""
    js, jcs, jst = problem["jax"]
    ts, tcs, tst = problem["torch"]
    quad, coll = tcs[branch].costs
    p, t, d = jst.particle_means.shape
    (eps,) = _jax_eps_chain(jst.key, (p, S, t * d), 1)
    jn, ja = _jax_step(js, jcs[branch], jst)
    step = _k9_step(ts, quad, coll, p)
    assert step.use_stencil == (branch == "stencil")
    new_means, costs = step(tst.particle_means, eps=eps)
    want = np.asarray(ja.costs)
    if branch == "matmul":
        want = want - np.repeat(quad.c.numpy(), p // 3)[:, None]
    np.testing.assert_allclose(costs.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    _close(torch.softmax(-costs / TAU, dim=1), ja.weights)
    _close(new_means, jn.particle_means)


def test_fused_step_per_particle_wrapper_contract(problem):
    """K9 with seeds: a particle's draw depends on its own seed pair alone;
    the same seeds repeat; exactly one of eps and seeds; CPU tensors take
    the plain version and count no launch; ``fused_planar_optimize`` draws
    all its seeds up front."""
    ts, tcs, tst = problem["torch"]
    quad, coll = tcs["matmul"].costs
    step = _k9_step(ts, quad, coll, 15, num_samples=16)
    means = tst.particle_means
    seeds = torch.arange(30, dtype=torch.int32).reshape(15, 2) - 7
    a, ca = step(means, seeds)
    b, _ = step(means, seeds.clone())
    other = seeds.clone()
    other[1] = torch.tensor([2**31 - 1, -(2**31)], dtype=torch.int32)
    c, cc = step(means, other)
    assert torch.equal(a, b)
    assert torch.equal(a[0], c[0]) and torch.equal(ca[2:], cc[2:]) and not torch.equal(a[1], c[1])
    with pytest.raises(ValueError, match="exactly one"):
        fused_planar_step_per_particle(step, means.reshape(15, 256))
    with pytest.raises(ValueError, match="int32"):
        step(means, seeds.long())
    out = fused_planar_optimize(step, means, torch.Generator().manual_seed(0), 2)
    assert out.shape == means.shape and bool(torch.isfinite(out).all())
    assert fused_planar_step_per_particle.launches == 0


def test_fused_step_wrapper_contract(problem):
    ts, tcs, tst = problem["torch"]
    quad, coll = tcs["matmul"].costs
    step = make_fused_planar_step_batched(
        weight_t=ts.weight_t, dof_prior=ts.dof, dof_quad=quad.dof_form,
        num_particles=15, rect_bounds=coll.field.rect_bounds, circles=coll.field.circles,
        cell_size=0.1, nx=200, ny=200, traj_len=64, state_dim=4, num_samples=16,
        k_coll=1e10, temperature=TAU, step_size=STEP,
    )
    means = tst.particle_means.reshape(15, 256)
    with pytest.raises(ValueError, match="exactly one"):
        fused_planar_step(step, means)
    a = fused_planar_step(step, means, seed=7)
    b = fused_planar_step(step, means, seed=7)
    c = fused_planar_step(step, means, seed=8)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert fused_planar_step.launches == 0  # CPU tensors take the plain version
    with pytest.raises(ValueError, match="unsupported device"):
        fused_planar_step(step, means.to("meta"), seed=1)


@pytest.mark.parametrize("which", ["means", "samples"])
def test_prec_u_lanes_matches_jax_matvec_flat(problem, which):
    """The fused kernels' per-lane ``Sigma^{-1} mu`` (``prec_u_lanes``, the
    plain form of ``csrc/kernel_common.cuh prec_u_lane``) against the JAX
    package's ``DofFactoredPrior.matvec_flat`` at the planar shape (d = 2,
    T = 64), float64, on the parity means and on noisy samples around
    them: rtol 1e-12 of the largest entry (the prior's weights reach 1.5e6
    and the residuals cancel)."""
    js, _, jst = problem["jax"]
    ts = problem["torch"][0]
    x = np.array(jst.particle_means)
    if which == "samples":
        x = x + np.random.default_rng(4).normal(scale=0.3, size=x.shape)
    want = np.asarray(js.dof.matvec_flat(jnp.asarray(x)))
    got = prec_u_lanes(torch.from_numpy(x), ts.dof.q_i2, ts.dof.k_s2, ts.dof.k_g2, ts.dof.dt)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("case", ["parity", "P192", "ragged", "config4", "refused", "doubled",
                                  "pcie"])
def test_ctas_per_particle(case):
    """The cluster size of the split fused kernels on the H100 SXM's 132
    SMs: 8 CTAs of one 16-row tile at planar parity (120 CTAs); 1 at
    ``benchmarks/run.py`` configs 1-3's P = 192 (the particles alone fill
    the card); S = 40 (3 tiles, not a multiple of 16 c) takes 2; config 4's
    4-row tiles take 8 (40 CTAs). ``fits`` stands for the kernel's answer
    whether a CTA's rows fit its shared memory, here at most 128 rows as
    the parity kernel's 227 KB hold at M = 256: S = 1024 at P = 192 doubles
    to 8 CTAs of 128 rows, and S = 2048 at parity, 256 rows per CTA even at
    8 CTAs, is refused. On a 114-SM card parity takes 4 (15 x 8 > 114)."""
    def holds_128(rows_per_tile, s):
        tiles = -(-s // rows_per_tile)
        return lambda c: -(-tiles // c) * rows_per_tile <= 128

    if case == "refused":
        with pytest.raises(ValueError, match="fits a CTA's shared memory"):
            ctas_per_particle(15, 2048, 16, 132, holds_128(16, 2048))
        return
    p, s, tile, sms, want = {"parity": (15, 128, 16, 132, 8), "P192": (192, 128, 16, 132, 1),
                             "ragged": (15, 40, 16, 132, 2), "config4": (5, 32, 4, 132, 8),
                             "doubled": (192, 1024, 16, 132, 8),
                             "pcie": (15, 128, 16, 114, 4)}[case]
    anything = lambda c: True  # noqa: E731
    assert ctas_per_particle(p, s, tile, sms, anything) == (1 if case == "doubled" else want)
    assert ctas_per_particle(p, s, tile, sms, holds_128(tile, s)) == want


def test_native_build_equals_converted(problem):
    js, jcs, jst = problem["jax"]
    jc = jcs["matmul"]
    ns, nc, nst = build_planar_problem(dtype=torch.float64, device="cpu")
    cs, cc = convert.sampler_from_jax(js, device="cpu"), convert.cost_from_jax(jc, device="cpu")
    np.testing.assert_allclose(ns.weight_t.numpy(), cs.weight_t.numpy(), rtol=0, atol=1e-12)
    for name in ("a_dense", "b", "c"):
        np.testing.assert_array_equal(getattr(nc.costs[0], name).numpy(),
                                      getattr(cc.costs[0], name).numpy())
    assert nc.costs[0].stencil_required == cc.costs[0].stencil_required is False
    for name in ("rect_bounds", "circles"):
        np.testing.assert_array_equal(getattr(nc.costs[1].field, name).numpy(),
                                      getattr(cc.costs[1].field, name).numpy())
    # straight start-to-goal lines: linspace rounds differently in the last bit
    np.testing.assert_allclose(nst.particle_means.numpy(),
                               convert.state_from_jax(jst, device="cpu").particle_means.numpy(),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("branch", ["matmul", "stencil"])
def test_cost_stack_eval(problem, branch):
    """Composite eval (quadratic + raster collision) of the converted and
    the natively built stacks against JAX, rtol 1e-12 of the largest cost
    (the quadratic's terms reach ~1e11 and cancel; the packages sum them in
    a different order). The stencil twin's 1e10 goal weight puts the
    quadratic in its stencil form in both packages."""
    _, jcs, jst = problem["jax"]
    jcost = jcs[branch]
    tcost = problem["torch"][1][branch]
    native, _ = build_planar_cost(dtype=torch.float64, device="cpu",
                                  sigma_goal_prior=1e-5 if branch == "stencil" else 1e-3)
    assert tcost.costs[0].stencil_required == native.costs[0].stencil_required == (
        branch == "stencil")
    x = (np.asarray(jst.particle_means)[:, None]
         + np.random.default_rng(2).normal(scale=0.5, size=(15, 32, 64, 4))).reshape(-1, 64, 4)
    want = np.asarray(jcost.eval(jnp.asarray(x)))
    for cost in (tcost, native):
        got = cost.eval(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def _planner(fused, **kw):
    cost, _ = build_planar_cost(dtype=torch.float32, device="cpu")
    args = dict(device="cpu",
        num_particles_per_goal=5, num_samples=S, traj_len=64, dt=0.02, n_dof=2,
        opt_iters=20, temperature=TAU, start_state=START, multi_goal_states=GOALS,
        cost=cost, step_size=STEP, sigma_start_init=1e-3, sigma_goal_init=1e-3,
        sigma_gp_init=20.0, sigma_start_sample=1e-3, sigma_goal_sample=1e-3,
        sigma_gp_sample=3.0, seed=0, fused_kernel=fused,
    )
    args.update(kw)
    return StochGPMP(**args), cost


@pytest.mark.parametrize("fused", [False, True])
def test_class_api(fused):
    """The reference-shaped 6-tuple, finite, start anchored, mean cost
    falling over 20 iterations; with ``fused_kernel`` the first 19 run in
    the fused step's plain version (CPU tensors)."""
    planner, cost = _planner(fused)
    c0 = float(cost.eval(planner.particle_means).mean())
    out = planner.optimize()
    assert len(out) == 6
    p = planner.num_particles
    shapes = [(p, 64, 2), (p, 64, 2), (p, S, 64, 2), (p, S, 64, 2), (p, S), (p, 64, 4)]
    assert [tuple(o.shape) for o in out] == shapes
    assert all(torch.isfinite(o).all() for o in out)
    assert float(cost.eval(planner.particle_means).mean()) < c0
    np.testing.assert_allclose(planner.particle_means[:, 0, :2].numpy(),
                               np.broadcast_to(START[:2], (p, 2)), atol=5e-2)
    assert planner.get_traj("best").shape == (64, 4)
    pos, vel = planner.sample_trajectories(3)
    assert pos.shape == (p, 3, 64, 2) and vel.shape == (p, 3, 64, 2)
    assert planner.get_recent_samples()[0].shape == (p, S, 64, 2)


def test_collect_metrics_and_routing():
    """Metrics over the flat path; ``mesh=`` with ``fused_kernel=True``
    raises JAX's ``ValueError`` (the mesh itself runs in
    ``tests/test_torch_parallel.py``); the planar stack at
    T = 128 takes the dof-factored path, as in the JAX package, and with the
    JAX draws injected its two iterations (metrics included) match JAX's dof
    path to rtol 1e-9 (float64)."""
    from stoch_gpmp_tpu.planners import stoch_gpmp_optimize as jopt
    from stoch_gpmp_tpu_torch.planners.stoch_gpmp import _route

    planner, _ = _planner(False, opt_iters=3)
    planner.optimize(collect_metrics=True)
    assert planner.last_metrics.cost_mean.shape == (3,)
    with pytest.raises(ValueError, match="single-chip only"):
        _planner(True, mesh=object())
    from __graft_entry__ import _build_problem

    js, jc, jst = _build_problem(traj_len=128, fast=True, dtype=jnp.float64)
    ts, tc = convert.sampler_from_jax(js, device="cpu"), convert.cost_from_jax(jc, device="cpu")
    tst = convert.state_from_jax(jst, device="cpu")
    cost128, _ = build_planar_cost(traj_len=128, dtype=torch.float32, device="cpu")
    planner128, _ = _planner(False, traj_len=128, cost=cost128, opt_iters=2)
    assert _route(planner128.sampler, cost128, 128) == _route(ts, tc, 128) == "dof"
    p, t, d = jst.particle_means.shape
    eps = []
    key = jst.key
    for _ in range(2):
        key, sub = jax.random.split(key)
        eps.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (d // 2, p, S, 2 * t), dtype=jnp.float64))))
    jn, ja, jm = jax.jit(lambda s, c, st: jopt(
        s, c, st, {}, opt_iters=2, num_samples=S, temperature=TAU, step_size=STEP,
        collect_metrics=True))(js, jc, jst)
    tn, ta, tm = stoch_gpmp_optimize(ts, tc, tst, {}, opt_iters=2, num_samples=S,
                                     temperature=TAU, step_size=STEP, collect_metrics=True,
                                     eps=eps)
    _close(tn.particle_means, jn.particle_means)
    _close(ta.costs, ja.costs)
    _close(ta.weights, ja.weights)
    for name in ("cost_mean", "cost_min", "weight_entropy", "update_norm"):
        _close(getattr(tm, name), getattr(jm, name))
    out = planner128.optimize()
    assert out[2].shape == (15, S, 128, 2) and bool(torch.isfinite(out[4]).all())


def test_fused_kernel_ineligible_stack_raises():
    from stoch_gpmp_tpu_torch.costs import (
        CostCollision,
        CostComposite,
        CostGP,
        CostGoalPrior,
    )
    from stoch_gpmp_tpu_torch.envs import generate_obstacle_map

    obst_map, _ = generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
        rand_limits=[[-7.5, 7.5], [-7.5, 7.5]], rand_rect_shape=[2, 2], rng=0, device="cpu")
    cost = CostComposite.create(2, 64, [
        CostGP.create(2, 64, START, 0.02, {"sigma_start": 1e-3, "sigma_gp": 0.1}),
        CostGoalPrior.create(2, 64, GOALS, sigma_goal_prior=1e-3),
        CostCollision.create(2, 64, obst_map.as_field(), sigma_coll=1e-5),
    ])
    planner, _ = _planner(True, cost=cost, opt_iters=3)
    with pytest.raises(ValueError, match=r"panda kernel: cost must be CostComposite\(\["
                                         r"QuadraticCost, PlaneFieldsCost\]\); planar kernel: "
                                         "cost must be CostComposite"):
        planner.optimize()


def test_print_info_and_timer_match_jax(capsys):
    from stoch_gpmp_tpu.utils import print_info as jinfo
    from stoch_gpmp_tpu_torch.utils import Timer, print_info as tinfo

    import time

    costs = np.random.default_rng(3).normal(size=(15, 128))
    now = time.time()  # the elapsed times differ between the calls; the cost does not
    jinfo(7, 500, now, now, jnp.asarray(costs))
    tinfo(7, 500, now, now, torch.from_numpy(costs))
    jline, tline = capsys.readouterr().out.splitlines()
    assert tline.split("| Cost:")[1] == jline.split("| Cost:")[1]
    assert tline.startswith("Iteration:     7/  500 ")
    timer = Timer()
    for _ in range(2):
        with timer.lap("step"):
            pass
    assert list(timer.laps) == ["step"] and 0 <= timer.laps["step"] <= timer.total()


def test_package_never_imports_jax():
    modules = [
        "stoch_gpmp_tpu_torch", "stoch_gpmp_tpu_torch.convert", "stoch_gpmp_tpu_torch.problems",
        "stoch_gpmp_tpu_torch.gp", "stoch_gpmp_tpu_torch.costs", "stoch_gpmp_tpu_torch.envs",
        "stoch_gpmp_tpu_torch.planners", "stoch_gpmp_tpu_torch.planners.fused_exec",
        "stoch_gpmp_tpu_torch.utils", "stoch_gpmp_tpu_torch.ops.kernels.fields",
        "stoch_gpmp_tpu_torch.ops.kernels.stencil", "stoch_gpmp_tpu_torch.ops.kernels.fused_step",
        "stoch_gpmp_tpu_torch.kinematics", "stoch_gpmp_tpu_torch.costs.fused_fields",
        "stoch_gpmp_tpu_torch.ops.kernels.panda_fields",
        "stoch_gpmp_tpu_torch.ops.kernels.panda_step_dof",
        "stoch_gpmp_tpu_torch.planners.gpmp", "stoch_gpmp_tpu_torch.tools.fused_timing",
        "stoch_gpmp_tpu_torch.parallel", "stoch_gpmp_tpu_torch.parallel.launch",
        "stoch_gpmp_tpu_torch.parallel.drive", "stoch_gpmp_tpu_torch.utils.checkpoint",
        "stoch_gpmp_tpu_torch.utils.profiling", "stoch_gpmp_tpu_torch.utils.paths",
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "from stoch_gpmp_tpu_torch.problems import build_planar_gpmp_problem, build_planar_problem\n"
        "build_planar_problem(device='cpu')\n"
        "for f in ('grid', 'primitive'):\n"
        "    build_planar_problem(device='cpu', fast=False, field=f)\n"
        "build_planar_gpmp_problem(device='cpu', traj_len=8).optimize(opt_iters=1)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'stoch_gpmp_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
