"""Multi-device planning of the PyTorch port (``parallel/``) against the JAX
package's ``stoch_gpmp_tpu.parallel`` on the 8 virtual CPU devices of
``tests/conftest.py``.

The port runs one process per rank: one module-scoped ``parallel.launch``
of 4 gloo ranks on the CPU runs every sharded case (``parallel.drive
run_cases``) and returns numpy arrays; the JAX package runs the same cases
on the same numpy inputs with its own draws, which are rebuilt from its keys
and injected into the port as the global draw. Every problem puts a block of
particles that starts inside a goal on some rank (3 goals over 2 or 4 ranks
of the ``p`` axis). Everything runs in float64; the tolerances are
``tests/test_sharding.py``'s, each written at its assertion.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stoch_gpmp_tpu_torch import convert  # noqa: E402
from stoch_gpmp_tpu_torch.parallel.sharding import Mesh, mesh_layout, shard_rows  # noqa: E402

# each spawning call's own limit (the launcher kills its ranks and raises)
LAUNCH_TIMEOUT = 120.0
GOALS = np.array([[1.0, 1, 0, 0], [1, -1, 0, 0], [-1, 1, 0, 0]])
START = np.zeros(4)


def _eps_chain(key, shape, n):
    """The eps of ``n`` successive JAX draws from ``key`` (split, draw)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, dtype=jnp.float64))))
    return out


def _planar(traj_len, materialize_dense=True, ppg=6):
    """3 goals x ``ppg`` particles, ``CostGP + CostGoalPrior`` (float64):
    the JAX sampler, cost and state."""
    from stoch_gpmp_tpu.costs import CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.gp.prior import make_gp_prior
    from stoch_gpmp_tpu.planners import SamplerModel, StochGPMPState

    goals, start = jnp.asarray(GOALS), jnp.asarray(START)
    prior = make_gp_prior(2, traj_len, 0.05, start, 1e-2, 1.0, sigma_goal=1e-2,
                          goal_states=goals, dtype=jnp.float64,
                          materialize_dense=materialize_dense)
    cost = CostComposite.create(2, traj_len, [
        CostGP.create(2, traj_len, start, 0.05, {"sigma_start": 1e-2, "sigma_gp": 1.0},
                      dtype=jnp.float64),
        CostGoalPrior.create(2, traj_len, goals, sigma_goal_prior=1e-2, dtype=jnp.float64),
    ])
    state = StochGPMPState(particle_means=jnp.repeat(prior.means, ppg, axis=0),
                           key=jax.random.PRNGKey(1))
    return SamplerModel.from_prior(prior), cost, state


def _dof_quad(n_dof, t, dtype):
    """``tests/test_sharding.py``'s dof-layout quadratic (``CostGP +
    CostGoalPrior`` as a ``DofQuadraticCost``) at 3 goals."""
    from stoch_gpmp_tpu.costs import CostGP, CostGoalPrior
    from stoch_gpmp_tpu.gp.dof_factored import DofQuadraticCost

    rng = np.random.default_rng(2)
    start = jnp.asarray(np.concatenate([rng.normal(size=n_dof), np.zeros(n_dof)]), dtype)
    goals = jnp.asarray(np.concatenate([rng.normal(size=(3, n_dof)), np.zeros((3, n_dof))], 1),
                        dtype)
    gp = CostGP.create(n_dof, t, start, 0.05, {"sigma_start": 1e-3, "sigma_gp": 0.1}, dtype=dtype)
    goal_prior = CostGoalPrior.create(n_dof, t, goals, sigma_goal_prior=1.0, dtype=dtype)
    return DofQuadraticCost.from_gp_and_goal_prior(gp, goal_prior, t)


def _dof_problem(ppg=4):
    """The dof layout's problem: ``_planar(8)``'s sampler (its per-dof
    factor) with its ``CostGP + CostGoalPrior`` fused into one
    ``QuadraticCost`` (whose dof form K3 evaluates), 3 goals x ``ppg``."""
    from stoch_gpmp_tpu.costs import CostComposite
    from stoch_gpmp_tpu.costs.quadratic import QuadraticCost

    js, jc, jst = _planar(8, ppg=ppg)
    quad = QuadraticCost.from_gp_and_goal_prior(jc.costs[0], jc.costs[1], 8)
    return js, CostComposite.create(2, 8, [quad]), jst


def _gn_cost(with_field):
    """3 goals, T = 8 (``tests/test_sharding.py``'s GN stack), with the
    occupancy grid of its Woodbury problem when ``with_field``."""
    from stoch_gpmp_tpu.costs import (
        CostCollision,
        CostComposite,
        CostGP,
        CostGoalPrior,
        OccupancyGridField,
    )

    goals, start = jnp.asarray(GOALS), jnp.asarray(START)
    costs = [
        CostGP.create(2, 8, start, 0.05, {"sigma_start": 1e-2, "sigma_gp": 1.0},
                      dtype=jnp.float64),
        CostGoalPrior.create(2, 8, goals, sigma_goal_prior=1e-2, dtype=jnp.float64),
    ]
    if with_field:
        xg, yg = jnp.meshgrid(jnp.arange(40.0), jnp.arange(40.0))
        grid = jnp.exp(-((xg - 20.0) ** 2 + (yg - 20.0) ** 2) / 50.0)
        costs.append(CostCollision.create(2, 8, OccupancyGridField(grid=grid, cell_size=0.1),
                                          sigma_coll=0.1))
    return CostComposite.create(2, 8, costs)


def _class_kwargs(dtype):
    return dict(num_particles_per_goal=4, traj_len=8, opt_iters=4, dt=0.05, n_dof=2,
                step_size=0.5, start_state=START, multi_goal_states=GOALS,
                sigma_start_init=1e-2, sigma_goal_init=1e-2, sigma_gp_init=1.0,
                sigma_start_sample=1e-2, sigma_goal_sample=1e-2, sigma_gp_sample=1.0,
                seed=7, dtype=dtype)


@pytest.fixture(scope="module")
def runs():
    """The JAX package's sharded results and the port's, from one launch of
    4 gloo ranks that runs while JAX computes: ``{name: (jax outputs, [rank
    outputs])}``."""
    import threading

    from stoch_gpmp_tpu.parallel import (
        make_mesh,
        make_sharded_gpmp_optimize,
        make_sharded_optimize,
        shard_gpmp_state,
        shard_planner_state,
    )
    from stoch_gpmp_tpu.planners import StochGPMP as JStochGPMP
    from stoch_gpmp_tpu.planners.gpmp import GPMP as JGPMP, GPMPState, build_woodbury
    from stoch_gpmp_tpu_torch.parallel.drive import run_cases
    from stoch_gpmp_tpu_torch.parallel.launch import launch

    cases, jax_runs = [], {}

    def add(name, case, jax_run=None):
        cases.append(dict(case, name=name))
        jax_runs[name] = jax_run

    cpu = dict(device="cpu")

    def sharded(js, jc, jst, shape, kw, layout="flat"):
        def go():
            mesh = make_mesh(4, axis_shape=shape)
            res = make_sharded_optimize(mesh, layout=layout, **kw)(
                js, jc, shard_planner_state(mesh, jst), {})
            out = dict(means=res[0].particle_means, costs=res[1].costs, weights=res[1].weights)
            if len(res) == 3:
                out.update({f"metric_{k}": getattr(res[2], k) for k in
                            ("cost_mean", "cost_min", "weight_entropy", "update_norm")})
            return out
        return go

    def optimize_case(js, jc, jst, shape, kw, eps_shape, layout="flat"):
        return dict(kind="optimize", mesh=shape, layout=layout, kwargs=kw,
                    sampler=convert.sampler_from_jax(js, **cpu),
                    cost=convert.cost_from_jax(jc, **cpu),
                    means=torch.from_numpy(np.array(jst.particle_means)),
                    eps=_eps_chain(jst.key, eps_shape, kw["opt_iters"]))

    # flat planar on (2, 2): P = 18 over 2 ranks of p (goals 0 and 1 in the
    # first block), S = 4 over 2 of s
    js, jc, jst = _planar(8)
    kw = dict(opt_iters=3, num_samples=4, temperature=1.0, step_size=0.5, collect_metrics=True)
    add("flat", optimize_case(js, jc, jst, (2, 2), kw, (18, 4, 32)),
        sharded(js, jc, jst, (2, 2), kw))
    # the dof layout: (4, 1) (blocks of 3 in 3 goals of 4) and (2, 2)
    js, jc, jst = _dof_problem()
    kw = dict(opt_iters=3, num_samples=4, temperature=1.0, step_size=0.3)
    for shape in ((4, 1), (2, 2)):
        add(f"dof{shape}", optimize_case(js, jc, jst, shape, kw, (2, 12, 4, 16), "dof"),
            sharded(js, jc, jst, shape, kw, "dof"))
    # long horizon (no dense factor): the flat step draws plane-major
    # (plane_stream), as the unsharded plane path does
    js, jc, jst = _planar(8, materialize_dense=False)
    assert js.weight_t is None and js.psolver is not None
    kw = dict(opt_iters=3, num_samples=4, temperature=1.0, step_size=0.5)
    add("long", optimize_case(js, jc, jst, (2, 2), kw, (4, 18, 4, 8)),
        sharded(js, jc, jst, (2, 2), kw))
    # Gauss-Newton on (4, 1): cholesky with the trust region (damping all-
    # reduced over p), woodbury on the occupancy-grid stack
    means = np.random.default_rng(0).standard_normal((12, 8, 4))
    for method, trust, field in (("cholesky", True, False), ("woodbury", False, True)):
        jc = _gn_cost(field)
        kw = dict(opt_iters=4, delta=1e-2, trust_region=trust, method=method, step_size=0.5)

        def gn(jc=jc, kw=kw):
            mesh = make_mesh(4, axis_shape=(4, 1))
            extra = dict(woodbury=build_woodbury(jc, 1e-2)) if kw["method"] == "woodbury" else {}
            jst = GPMPState(particle_means=jnp.asarray(means), key=jax.random.PRNGKey(0))
            return dict(means=make_sharded_gpmp_optimize(mesh, **kw, **extra)(
                jc, shard_gpmp_state(mesh, jst), {}).particle_means)
        add(f"gn-{method}", dict(kind="gpmp", mesh=(4, 1), cost=convert.cost_from_jax(jc, **cpu),
                                 kwargs=kw, means=torch.from_numpy(means)), gn)
    # the classes: StochGPMP(mesh=) on (2, 2) against the port without a
    # mesh (same generator seed; checked in the test), GPMP(mesh=) on (4, 1)
    # against JAX's GPMP(mesh=) from the same initial means
    sk = dict(_class_kwargs(torch.float64), num_particles_per_goal=6, num_samples=4,
              traj_len=8, opt_iters=3, device="cpu")
    add("stochgpmp", dict(kind="stochgpmp", mesh=(2, 2), collect_metrics=True, kwargs=sk,
                          cost=convert.cost_from_jax(_planar(8)[1], **cpu)))
    # StochGPMP(mesh=) on (2, 2) against JAX's StochGPMP(mesh=): the same
    # const_vel initial means (no init draw, so JAX's key is the seed's) and
    # JAX's draws injected into the port's sharded optimize
    jc = _planar(8)[1]
    ck = dict(_class_kwargs(jnp.float64), num_particles_per_goal=6, num_samples=4,
              opt_iters=3, initial_particle_means="const_vel",
              start_state=jnp.asarray(START), multi_goal_states=jnp.asarray(GOALS))

    def stoch_class(jc=jc):
        jp = JStochGPMP(cost=jc, mesh=make_mesh(4, axis_shape=(2, 2)), **ck)
        np.testing.assert_array_equal(np.array(jp.state.key), np.array(jax.random.PRNGKey(7)))
        res = jp.optimize(collect_metrics=True)
        out = {f"out{i}": r for i, r in enumerate(res)}
        out.update(means=jp.particle_means, best=jp.get_traj("best"),
                   recent=jp.get_recent_samples()[0])
        out.update({f"metric_{k}": getattr(jp.last_metrics, k) for k in
                    ("cost_mean", "cost_min", "weight_entropy", "update_norm")})
        return out
    add("stochgpmp-jax", dict(kind="stochgpmp", mesh=(2, 2), collect_metrics=True,
                              kwargs=dict(ck, dtype=torch.float64, device="cpu", start_state=START,
                                          multi_goal_states=GOALS),
                              cost=convert.cost_from_jax(jc, **cpu),
                              eps=_eps_chain(jax.random.PRNGKey(7), (18, 4, 32), 3)), stoch_class)
    jc = _gn_cost(False)
    gk = dict(_class_kwargs(jnp.float64), solver_params={"delta": 1e-2, "trust_region": True},
              initial_particle_means=np.random.default_rng(3).standard_normal((12, 8, 4)))

    def gn_class():
        jp = JGPMP(cost=jc, mesh=make_mesh(4, axis_shape=(4, 1)),
                   **dict(gk, start_state=jnp.asarray(START), multi_goal_states=jnp.asarray(GOALS)))
        return dict(zip(("vel", "pos", "costs"), jp.optimize()))
    add("gpmp-class", dict(kind="gpmp_class", mesh=(4, 1), cost=convert.cost_from_jax(jc, **cpu),
                           kwargs=dict(gk, dtype=torch.float64, device="cpu")), gn_class)
    # the mesh layouts of 1, 2 and 4 ranks (the sub-meshes leave ranks out)
    for shape in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (1, 4)):
        add(f"mesh{shape}", dict(kind="mesh", mesh=shape))

    ranks = {}

    def port():
        try:
            ranks["out"] = launch(run_cases, 4, (cases, "cpu"), device="cpu",
                                  timeout=LAUNCH_TIMEOUT)
        except Exception as e:  # noqa: BLE001 - raised in the test thread below
            ranks["error"] = e

    thread = threading.Thread(target=port)
    thread.start()
    with ThreadPoolExecutor(3) as pool:  # JAX's compiles overlap; its results do not depend on it
        futures = {name: pool.submit(run) for name, run in jax_runs.items() if run is not None}
        want = {name: futures[name].result() if name in futures else None for name in jax_runs}
    thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return {c["name"]: (want[c["name"]], [r[i] for r in ranks["out"]])
            for i, c in enumerate(cases)}


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _members(outs):
    got = [o for o in outs if o is not None]
    assert got and not any(o["jax_loaded"] for o in got)  # no rank imports JAX
    return got


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_layout_matches_jax(n):
    from stoch_gpmp_tpu.parallel import make_mesh

    ids = np.vectorize(lambda dv: dv.id)(make_mesh(n).devices)
    np.testing.assert_array_equal(mesh_layout(n), ids - ids.min())
    ids = np.vectorize(lambda dv: dv.id)(make_mesh(n, axis_shape=(1, n)).devices)
    np.testing.assert_array_equal(mesh_layout(n, (1, n)), ids - ids.min())


def test_rank_meshes_match_jax_positions(runs):
    """``make_mesh`` in the ranks: each member's coordinates are its
    device's position in JAX's mesh of the same shape; ranks beyond the
    mesh are left out."""
    from stoch_gpmp_tpu.parallel import make_mesh

    for shape in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (1, 4)):
        _, outs = runs[f"mesh{shape}"]
        ids = np.vectorize(lambda dv: dv.id)(make_mesh(shape[0] * shape[1],
                                                       axis_shape=shape).devices)
        assert [o is not None for o in outs] == [r < ids.size for r in range(4)]
        for r, o in enumerate(outs[:ids.size]):
            assert tuple(o["coords"]) == tuple(np.argwhere(ids - ids.min() == r)[0])
            assert tuple(o["shape"]) == shape


def test_sharded_flat_matches_jax(runs):
    """Flat planar on (2, 2) against JAX's sharded run: means rtol 1e-5 /
    atol 1e-6, costs rtol 1e-4 / atol 1e-5 (``tests/test_sharding.py:67-73``),
    the weights and the metrics as the costs; every rank returns the same
    global results."""
    want, outs = runs["flat"]
    for o in _members(outs):
        _close(o["means"], want["means"], 1e-5, 1e-6)
        _close(o["costs"], want["costs"], 1e-4, 1e-5)
        _close(o["weights"], want["weights"], 1e-4, 1e-5)
        for k in ("cost_mean", "cost_min", "weight_entropy", "update_norm"):
            _close(o[f"metric_{k}"], want[f"metric_{k}"], 1e-4, 1e-5)
    # each rank's own block: rank (i, j) holds particles 9 i .. 9 i + 8
    for r, o in enumerate(outs):
        _close(o["block"], np.asarray(want["means"])[9 * (r // 2):9 * (r // 2) + 9], 1e-5, 1e-6)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_dof_matches_jax(runs, shape):
    """The dof layout against JAX's: means rtol 1e-5 / atol 1e-5, costs
    rtol 1e-4 / atol 1e-4 (``tests/test_sharding.py:207-216``); K3's plain
    version runs on each rank's rows."""
    want, outs = runs[f"dof{shape}"]
    for o in _members(outs):
        _close(o["means"], want["means"], 1e-5, 1e-5)
        _close(o["costs"], want["costs"], 1e-4, 1e-4)


def test_sharded_long_horizon_plane_stream_matches_jax(runs):
    """The long-horizon sampler under the sharded flat step (plane-major
    draws): means rtol 1e-5 / atol 1e-6 (``tests/test_sharding.py:155-160``)."""
    want, outs = runs["long"]
    for o in _members(outs):
        _close(o["means"], want["means"], 1e-5, 1e-6)
        _close(o["costs"], want["costs"], 1e-4, 1e-5)


@pytest.mark.parametrize("method", ["cholesky", "woodbury"])
def test_sharded_gpmp_matches_jax(runs, method):
    """GN on (4, 1) against JAX's sharded GN: rtol 1e-9 / atol 1e-10
    (``tests/test_sharding.py:117-120, 413-416``)."""
    want, outs = runs[f"gn-{method}"]
    for o in _members(outs):
        _close(o["means"], want["means"], 1e-9, 1e-10)


def test_stochgpmp_class_mesh(runs):
    """``StochGPMP(mesh=)`` on (2, 2) returns on every rank what the class
    without a mesh returns from the same seed: the 6-tuple, the means, the
    metrics, ``get_traj``, ``get_recent_samples`` and
    ``sample_trajectories`` (rtol 1e-5 / atol 1e-6, as
    ``tests/test_sharding.py:364-367``)."""
    from stoch_gpmp_tpu_torch.planners import StochGPMP

    _, outs = runs["stochgpmp"]
    jc = _planar(8)[1]
    kw = dict(_class_kwargs(torch.float64), num_particles_per_goal=6, num_samples=4,
              traj_len=8, opt_iters=3, device="cpu")
    ref = StochGPMP(cost=convert.cost_from_jax(jc, device="cpu"), **kw)
    res = ref.optimize(collect_metrics=True)
    pos = ref.sample_trajectories(2)[0]
    for o in _members(outs):
        for i, r in enumerate(res):
            _close(o[f"out{i}"], r.numpy(), 1e-5, 1e-6)
        _close(o["means"], ref.particle_means.numpy(), 1e-5, 1e-6)
        _close(o["best"], ref.get_traj("best").numpy(), 1e-5, 1e-6)
        _close(o["recent"], ref.get_recent_samples()[0].numpy(), 1e-5, 1e-6)
        _close(o["drawn"], pos.numpy(), 1e-5, 1e-6)
        _close(o["metric_cost_mean"], ref.last_metrics.cost_mean.numpy(), 1e-5, 1e-6)


def test_stochgpmp_class_mesh_matches_jax(runs):
    """``StochGPMP(mesh=)`` on (2, 2) against JAX's ``StochGPMP(mesh=)`` from
    the same const_vel means with JAX's draws injected: the 6-tuple (the
    costs rtol 1e-4 / atol 1e-5, the rest rtol 1e-5 / atol 1e-6, as
    ``tests/test_sharding.py:67-73``), the means, ``get_traj("best")``,
    ``get_recent_samples`` and the metrics, on every rank."""
    want, outs = runs["stochgpmp-jax"]
    for o in _members(outs):
        for i in range(6):
            _close(o[f"out{i}"], want[f"out{i}"], *((1e-4, 1e-5) if i == 4 else (1e-5, 1e-6)))
        for k in ("means", "best", "recent"):
            _close(o[k], want[k], 1e-5, 1e-6)
        for k in ("cost_mean", "cost_min", "weight_entropy", "update_norm"):
            _close(o[f"metric_{k}"], want[f"metric_{k}"], 1e-4, 1e-5)


def test_gpmp_class_mesh_matches_jax(runs):
    """``GPMP(mesh=)`` on (4, 1) against JAX's ``GPMP(mesh=)`` from the same
    initial means: ``(vel, pos, costs)`` rtol 1e-9 / atol 1e-10."""
    want, outs = runs["gpmp-class"]
    for o in _members(outs):
        for k in ("vel", "pos", "costs"):
            _close(o[k], want[k], 1e-9, 1e-10)


def _single_mesh():
    """A mesh of this one process (no process group: with one rank on each
    axis and gloo, every collective is the identity and is skipped)."""
    return Mesh(devices=np.zeros((1, 1), dtype=int), axis_names=("p", "s"), rank=0,
                coords=(0, 0), device=torch.device("cpu"), backend="gloo")


def test_refusals_match_jax():
    """``fused_kernel=True`` with ``mesh=`` raises JAX's ``ValueError``; the
    dof layout on a problem the dof path cannot take raises JAX's
    ``shard_dof`` error (``tests/test_sharding.py:219-223``)."""
    from stoch_gpmp_tpu_torch.parallel import make_sharded_optimize
    from stoch_gpmp_tpu_torch.planners import StochGPMP

    with pytest.raises(ValueError, match="single-chip"):
        StochGPMP(fused_kernel=True, mesh=_single_mesh(), device="cpu",
                  **dict(_class_kwargs(torch.float64), num_samples=4))
    js, jc, jst = _dof_problem(ppg=1)
    ts = convert.sampler_from_jax(js, device="cpu")
    ts.dof = None
    run = make_sharded_optimize(_single_mesh(), layout="dof", opt_iters=1, num_samples=2,
                                temperature=1.0, step_size=0.3)
    with pytest.raises(ValueError, match="shard_dof"):
        run(ts, convert.cost_from_jax(jc, device="cpu"), convert.state_from_jax(jst, device="cpu"),
            {})


def _view_cases():
    """``(name, JAX cost)`` of every goal-dependent cost and a composite."""
    from stoch_gpmp_tpu.costs import CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.costs.quadratic import QuadraticCost

    t, goals, start = 8, jnp.asarray(GOALS), jnp.asarray(START)
    gp = CostGP.create(2, t, start, 0.05, {"sigma_start": 1e-2, "sigma_gp": 1.0},
                       dtype=jnp.float64)
    goal = CostGoalPrior.create(2, t, goals, sigma_goal_prior=1e-2, dtype=jnp.float64)
    stencil = CostGoalPrior.create(2, t, goals, sigma_goal_prior=1e-6, dtype=jnp.float64)
    quad = QuadraticCost.from_gp_and_goal_prior(gp, goal, t)
    return {
        "goal_prior": goal,
        "quadratic": quad,
        "quadratic_stencil": QuadraticCost.from_gp_and_goal_prior(gp, stencil, t),
        "composite": CostComposite.create(2, t, [gp, goal]),
        "dof_quadratic": quad,  # its dof form
    }


@pytest.mark.parametrize("name", ["goal_prior", "quadratic", "quadratic_stencil", "composite",
                                  "dof_quadratic"])
@pytest.mark.parametrize("start,count", [(3, 9), (9, 9), (5, 4)])
def test_particle_block_view_equals_global_rows(name, start, count):
    """A cost viewed on particles ``start .. start + count`` of 18 (3 goals
    of 6; each block starts inside a goal) gives, on those particles'
    samples, exactly the global cost's rows: ``eval`` (2 samples per
    particle), ``gn_contrib``, and for the dof form ``eval_dof_planes`` (K3's
    plain version), its dense form and ``grad_dof_planes`` (rtol 1e-12)."""
    from stoch_gpmp_tpu_torch.gp.dof_factored import to_dof_planes

    cost = convert.cost_from_jax(_view_cases()[name], device="cpu")
    if name == "dof_quadratic":
        cost = cost.dof_form
    view = shard_rows(cost, start, count, 18)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((18, 2, 8, 4)))
    rows = slice(2 * start, 2 * (start + count))
    flat, mine = x.reshape(36, 8, 4), x[start:start + count].reshape(2 * count, 8, 4)

    def same(a, b):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(a.abs().max()))

    same(cost.eval(flat)[rows], view.eval(mine))
    if name != "dof_quadratic":
        g_all = cost.gn_contrib(x[:, 0])
        g_mine = view.gn_contrib(x[start:start + count, 0])
        same(g_all.g[start:start + count], g_mine.g)
        same(g_all.diag[start:start + count], g_mine.diag)
        return
    xp, xm = to_dof_planes(flat), to_dof_planes(mine)
    same(cost.eval_dof_planes(xp)[rows], view.eval_dof_planes(xm))
    same(cost.eval_dof_planes_dense(xp)[rows], view.eval_dof_planes_dense(xm))
    one = to_dof_planes(x[:, 0])
    same(cost.grad_dof_planes(one)[:, start:start + count],
         view.grad_dof_planes(to_dof_planes(x[start:start + count, 0])))


def test_k3_on_shard_rows_matches_jax_anchors():
    """K3's plain version on a rank's rows through the particle-block view
    against JAX's ``dof_quad_eval_pallas(..., anchors=, interpret=True)`` on
    the same rows and against the global call (float32 inputs, the
    importance term fused; rtol 2e-5, the bound of JAX's own check,
    ``tests/test_sharding.py:226-272``)."""
    from stoch_gpmp_tpu.ops.pallas.stencil import dof_anchor_rows, dof_quad_eval_pallas
    from stoch_gpmp_tpu_torch.ops.kernels.stencil import dof_quad_eval

    jdq = _dof_quad(2, 128, jnp.float32)  # JAX's kernel takes T % 128 == 0
    tdq = convert._dof_quad_from_jax(jdq, torch.float32, "cpu")
    rng = np.random.default_rng(7)
    p, s, start, count = 12, 4, 3, 3  # a block of 3 starting inside goal 0
    x = rng.normal(size=(2, p, s, 256)).astype(np.float32)
    pu = rng.normal(size=(2, p, 256)).astype(np.float32)
    xs, pus = x[:, start:start + count], pu[:, start:start + count]
    anch = jnp.repeat(dof_anchor_rows(jdq, p)[:, start:start + count], s, axis=1)
    want = np.asarray(dof_quad_eval_pallas(
        jdq, jnp.asarray(xs.reshape(2, count * s, 256)), pu=jnp.asarray(pus), temperature=0.7,
        num_samples=s, anchors=anch, interpret=True))
    got = dof_quad_eval(tdq.particle_block(start, count, p),
                        torch.from_numpy(xs.reshape(2, count * s, 256)),
                        pu=torch.from_numpy(pus), temperature=0.7, num_samples=s).numpy()
    whole = dof_quad_eval(tdq, torch.from_numpy(x.reshape(2, p * s, 256)),
                          pu=torch.from_numpy(pu), temperature=0.7, num_samples=s).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(got, whole.reshape(p, s)[start:start + count].reshape(-1),
                               rtol=2e-5, atol=1e-3)


def test_shard_dof_quad_takes_only_a_viewed_quadratic():
    """The sharded dof path's K3 call (``_make_shard_dof_quad``) checks that
    the quadratic was viewed on the rank's particles: the global quadratic
    (3 goals) on a block of 6 particles of 12 raises; its view gives the
    global call's rows (the plain version, on the CPU)."""
    from stoch_gpmp_tpu_torch.ops.kernels.stencil import dof_quad_eval
    from stoch_gpmp_tpu_torch.parallel.sharding import _make_shard_dof_quad

    tdq = convert._dof_quad_from_jax(_dof_quad(2, 8, jnp.float64), torch.float64, "cpu")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 12, 4, 16)))
    pu = torch.from_numpy(rng.normal(size=(2, 12, 16)))
    quad = _make_shard_dof_quad(_single_mesh())
    kw = dict(temperature=0.7, num_samples=4)
    mine, pmine = x[:, 3:9].reshape(2, 24, 16), pu[:, 3:9]
    with pytest.raises(AssertionError, match="not viewed"):
        quad(tdq, mine, pu=pmine, **kw)
    got = quad(tdq.particle_block(3, 6, 12), mine, pu=pmine, **kw)
    whole = dof_quad_eval(tdq, x.reshape(2, 48, 16), pu=pu, **kw)
    np.testing.assert_allclose(got.numpy(), whole.numpy()[12:36], rtol=1e-12)


def test_run_cases_defaults_to_the_card():
    """``run_cases``'s device defaults to None, the card: on a host without
    one it raises ``resolve_device``'s error before any collective (no
    process group exists here), as every entry point of the port does."""
    import inspect

    from stoch_gpmp_tpu_torch.parallel.drive import run_cases

    assert inspect.signature(run_cases).parameters["device"].default is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cases([dict(kind="mesh", mesh=(1, 1))])


def test_single_rank_mesh_is_the_unsharded_path():
    """On a mesh of one rank the sharded classes give the unsharded results
    bit for bit (every collective is the identity)."""
    from stoch_gpmp_tpu_torch.planners import GPMP, StochGPMP

    tc = convert.cost_from_jax(_planar(8)[1], device="cpu")
    kw = dict(_class_kwargs(torch.float64), num_particles_per_goal=6, num_samples=4,
              traj_len=8, opt_iters=3, device="cpu")
    a, b = StochGPMP(cost=tc, **kw), StochGPMP(cost=tc, mesh=_single_mesh(), **kw)
    for x, y in zip(a.optimize(), b.optimize()):
        assert torch.equal(x, y)
    tc = convert.cost_from_jax(_gn_cost(True), device="cpu")
    kw = dict(_class_kwargs(torch.float64), device="cpu",
              solver_params={"delta": 1e-2, "trust_region": True})
    a, b = GPMP(cost=tc, **kw), GPMP(cost=tc, mesh=_single_mesh(), **kw)
    for x, y in zip(a.optimize(), b.optimize()):
        assert torch.equal(x, y)
