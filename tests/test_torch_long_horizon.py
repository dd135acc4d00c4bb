"""The long-horizon path of the PyTorch port against the JAX package, float64
on the CPU: the parallel-in-time solver (``ParallelBidiagSolver``, whose
solves are kernel S1 on the card and the log-step scan here),
``matvec_planes``, ``make_gp_prior``'s modes, the four ``eval_planes``, the
structured ``stoch_gpmp_step`` and the ``"planes"`` route of
``stoch_gpmp_optimize``, with the JAX draws injected.

The problems are ``benchmarks/long_horizon.py _problem`` at small horizons
(T = 96, 128) and 3 particles x 8 samples, where ``materialize_dense=False``
forces the solver. Tolerances (float64 in both packages; only the
summation order differs, and the JAX package's ``associative_scan`` is
another tree than the port's): solves and tables rtol 1e-10 of the largest
entry; costs, weights and means rtol 1e-9; the field counts exact.
"""

import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stoch_gpmp_tpu_torch import convert  # noqa: E402
from stoch_gpmp_tpu_torch.gp.prior import build_precision, make_gp_prior  # noqa: E402
from stoch_gpmp_tpu_torch.gp.tridiag import ParallelBidiagSolver  # noqa: E402
from stoch_gpmp_tpu_torch.ops.kernels import bidiag_scan as s1  # noqa: E402
from stoch_gpmp_tpu_torch.planners import (  # noqa: E402
    GPMP,
    SamplerModel,
    StochGPMP,
    stoch_gpmp_optimize,
    stoch_gpmp_step,
)
from stoch_gpmp_tpu_torch.planners.stoch_gpmp import _route  # noqa: E402
from stoch_gpmp_tpu_torch.problems import (  # noqa: E402
    LONG_HORIZON_GOALS,
    START,
    build_long_horizon_problem,
)

P, S, TAU, STEP = 3, 8, 1.0, 0.5
SOLVE_RTOL, RTOL = 1e-10, 1e-9


def _close(t, j, rtol=RTOL):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, rtol=rtol, atol=rtol * np.abs(j).max())


def _chols(dof, t):
    """The JAX and port block Cholesky of the long-horizon sampling
    precision (sigma_start 1e-3, sigma_gp 3.0, goal 1e-3), float64."""
    from stoch_gpmp_tpu.gp.lift import q_inv_block as jq, unary_weight as ju
    from stoch_gpmp_tpu.gp.prior import build_precision as jbuild
    from stoch_gpmp_tpu_torch.gp.lift import q_inv_block, unary_weight

    d = 2 * dof
    jp = jbuild(dof, t, 0.02, ju(d, 1e-3, dtype=jnp.float64),
                jq(dof, 0.02, sigma=3.0, dtype=jnp.float64),
                k_g_inv=ju(d, 1e-3, dtype=jnp.float64), dtype=jnp.float64)
    tp = build_precision(dof, t, 0.02, unary_weight(d, 1e-3, dtype=torch.float64),
                         q_inv_block(dof, 0.02, sigma=3.0, dtype=torch.float64),
                         k_g_inv=unary_weight(d, 1e-3, dtype=torch.float64),
                         dtype=torch.float64, device="cpu")
    return jp, tp, jp.cholesky(), tp.cholesky()


def _jax_problem(t, *, quad=False, materialize_dense=False, particles=P):
    """``benchmarks/long_horizon.py _problem(t, with_obstacles=True)`` in
    float64 with ``particles`` particles (``quad``: the stack's CostGP and
    goal prior fused into one ``QuadraticCost``)."""
    from stoch_gpmp_tpu.costs import CostCollision, CostComposite, CostGP, CostGoalPrior
    from stoch_gpmp_tpu.costs.fields import RasterPrimitive2DField
    from stoch_gpmp_tpu.costs.quadratic import QuadraticCost
    from stoch_gpmp_tpu.envs import generate_obstacle_map
    from stoch_gpmp_tpu.gp.prior import make_gp_prior as jmake
    from stoch_gpmp_tpu.planners import SamplerModel as JSampler, StochGPMPState as JState

    dt = jnp.float64
    start, goals = jnp.asarray(START, dt), jnp.asarray(LONG_HORIZON_GOALS, dt)
    gp = CostGP.create(2, t, start, 0.02, {"sigma_start": 1e-3, "sigma_gp": 0.1}, dtype=dt)
    goal = CostGoalPrior.create(2, t, goals, sigma_goal_prior=1e-3, dtype=dt)
    obst_map, obst_list = generate_obstacle_map(
        map_dim=(20, 20), cell_size=0.1, random_gen=True, num_obst=15,
        rand_limits=[[-7.5, 7.5]] * 2, rand_rect_shape=[2, 2], rng=0, dtype=dt)
    field = RasterPrimitive2DField.from_map(obst_map, obst_list, use_pallas=False)
    coll = CostCollision.create(2, t, field, sigma_coll=1e-5)
    costs = [QuadraticCost.from_gp_and_goal_prior(gp, goal, t)] if quad else [gp, goal]
    cost = CostComposite.create(2, t, costs + [coll])
    prior = jmake(2, t, 0.02, start, 1e-3, 3.0, sigma_goal=1e-3, goal_states=goals,
                  dtype=dt, materialize_dense=materialize_dense)
    state = JState(particle_means=jnp.repeat(prior.means, particles, axis=0),
                   key=jax.random.PRNGKey(0))
    return JSampler.from_prior(prior), cost, state


def _convert(js, jc, jst):
    return (convert.sampler_from_jax(js, device="cpu"), convert.cost_from_jax(jc, device="cpu"),
            convert.state_from_jax(jst, device="cpu"))


@pytest.fixture(scope="module")
def problem96():
    js, jc, jst = _jax_problem(96)
    return (js, jc, jst), _convert(js, jc, jst)


@pytest.mark.parametrize("t", [1, 77])
def test_matvec_planes_matches_jax(t):
    jp, tp, _, _ = _chols(2, t)
    x = np.random.default_rng(t).normal(size=(3, 5, t, 4))
    jout = jp.matvec_planes(tuple(jnp.asarray(x[..., i]) for i in range(4)))
    tout = tp.matvec_planes(tuple(torch.from_numpy(x[..., i]) for i in range(4)))
    flat = tp.matvec(torch.from_numpy(x))
    for i in range(4):
        _close(tout[i], jout[i], rtol=SOLVE_RTOL)
        _close(tout[i], flat[..., i], rtol=SOLVE_RTOL)


@pytest.mark.parametrize("t", [1, 2, 77])
def test_from_chol_tables_match_jax(t):
    """``dinv``, ``a_fwd`` and ``a_bwd`` against the JAX solver's; the
    kernel's chunk tables built from the JAX tables (``from_tables``, the
    conversion's way) equal those built from the port's factor."""
    from stoch_gpmp_tpu.gp.tridiag import ParallelBidiagSolver as JSolver

    _, _, jch, tch = _chols(2, t)
    js, ts = JSolver.from_chol(jch), ParallelBidiagSolver.from_chol(tch)
    for name in ("dinv", "a_fwd", "a_bwd"):
        _close(getattr(ts, name), getattr(js, name), rtol=SOLVE_RTOL)
    conv = ParallelBidiagSolver.from_tables(
        *(torch.from_numpy(np.array(getattr(js, n))) for n in ("dinv", "a_fwd", "a_bwd")))
    for name in ("phi_fwd", "phi_bwd", "rec_fwd", "rec_bwd", "phr_fwd", "phr_bwd", "psi_fwd",
                 "psi_bwd"):
        _close(getattr(conv, name), getattr(ts, name), rtol=SOLVE_RTOL)


@pytest.mark.parametrize("dof", [1, 2])
@pytest.mark.parametrize("t", [1, 2, 77, 128])
def test_solves_match_jax_and_serial(t, dof):
    """The five solves (planes and ``[..., T, d]``) against the JAX
    package's parallel solver and the port's serial ``BlockBidiagChol``."""
    from stoch_gpmp_tpu.gp.tridiag import ParallelBidiagSolver as JSolver

    _, _, jch, tch = _chols(dof, t)
    js, ts = JSolver.from_chol(jch), ParallelBidiagSolver.from_chol(tch)
    d = 2 * dof
    b = np.random.default_rng(7 * t + dof).normal(size=(3, 5, t, d))
    tb = torch.from_numpy(b)
    for name in ("solve_L", "solve_LT", "solve"):
        want = np.asarray(getattr(js, name)(jnp.asarray(b)))
        got = getattr(ts, name)(tb)
        _close(got, want, rtol=SOLVE_RTOL)
        _close(got, getattr(tch, name)(tb), rtol=SOLVE_RTOL)
    for name, serial in (("solve_L_planes", tch.solve_L), ("solve_LT_planes", tch.solve_LT)):
        want = getattr(js, name)(tuple(jnp.asarray(b[..., i]) for i in range(d)))
        got = getattr(ts, name)(tuple(tb[..., i] for i in range(d)))
        ref = serial(tb)
        for i in range(d):
            assert got[i].shape == (3, 5, t)
            _close(got[i], want[i], rtol=SOLVE_RTOL)
            _close(got[i], ref[..., i], rtol=SOLVE_RTOL)


def _psi(solver, backward, lv, k):
    """The ``[d, d]`` product of ``scan_products`` at level ``lv``, chunk
    ``k``."""
    psi = solver.psi_bwd if backward else solver.psi_fwd
    d = solver.block_dim
    return psi[lv, :, k].reshape(d, d)


def _emulate_s1(solver, x, *, backward, chunks, rows=4):
    """Kernel S1's order of work on ``x [B, T, d]``: segments of ``chunks``
    chunks of ``CHUNK`` steps (backward: last segment first), the chunks
    dealt to warps of ``KW = min(32 // rows, chunks)``; per chunk the
    recurrence from a zero carry (``rec``: the packed triangle and ``A_t``);
    per warp the log-step scan of the chunk maps (``psi`` level l, partner
    2^l chunks away) from a zero carry; the warps' aggregates composed in
    order with the segment's carry (``psi`` at level log2 KW); a second scan
    spreads each warp's carry over its chunks; ``y = local + phi
    carry_in``."""
    b, t, d = x.shape
    rec = solver.rec_bwd if backward else solver.rec_fwd
    phi = solver.phi_bwd if backward else solver.phi_fwd
    tri = torch.zeros((t, d, d), dtype=x.dtype)
    o = 0
    for i in range(d):  # unpack rec's triangle as the kernel reads it
        js = range(i, d) if backward else range(i + 1)
        for j in js:
            tri[:, i, j] = rec[:t, o]
            o += 1
    a = rec[:t, o:o + d * d].reshape(t, d, d)
    c = torch.einsum("tij,btj->bti", tri, x)
    nch, seg_len = -(-t // s1.CHUNK), chunks * s1.CHUNK
    kw = min(32 // rows, chunks)
    nw, levels = chunks // kw, kw.bit_length() - 1
    y = torch.empty_like(x)
    cseg = x.new_zeros((b, d))
    segs = range(-(-t // seg_len))

    def scan(v, seg):  # per warp, in place: v[k] += Psi-span(k) v[partner]
        step, lv = 1, 0
        while step < kw:
            new = v.clone()
            for k in range(chunks):
                kg, kl = seg * chunks + k, k % kw
                ok = kl + step < kw and kg + step < nch if backward else kl >= step
                if kg < nch and ok:
                    new[k] = v[k] + v[k + step if backward else k - step] @ _psi(
                        solver, backward, lv, kg).T
            v, step, lv = new, step * 2, lv + 1
        return v

    for seg in (reversed(segs) if backward else segs):
        local, e = {}, x.new_zeros((chunks, b, d))
        for k in range(chunks):
            k0 = (seg * chunks + k) * s1.CHUNK
            if k0 >= t:
                continue
            k1 = min(t, k0 + s1.CHUNK)
            loc = x.new_zeros((b, d))
            for s in (range(k1 - 1, k0 - 1, -1) if backward else range(k0, k1)):
                loc = loc @ a[s].T + c[:, s]
                local[s] = loc
            e[k] = loc
        e = scan(e, seg)
        cin_w, cv = {}, cseg
        for ww in (reversed(range(nw)) if backward else range(nw)):
            cin_w[ww] = cv
            kf = seg * chunks + ww * kw
            kx = kf if backward else kf + kw - 1
            if kf >= nch:
                continue
            agg = e[ww * kw if backward else ww * kw + kw - 1]
            cv = agg + cv @ _psi(solver, backward, levels, kx).T if kx < nch else agg
        cseg = cv
        f = x.new_zeros((chunks, b, d))
        for ww in range(nw):
            k = ww * kw + (kw - 1 if backward else 0)
            if seg * chunks + k < nch:
                f[k] = cin_w[ww] @ _psi(solver, backward, 0, seg * chunks + k).T
        y_end = e + scan(f, seg)
        for k in range(chunks):
            k0 = (seg * chunks + k) * s1.CHUNK
            if k0 >= t:
                continue
            edge = k % kw == (kw - 1 if backward else 0)
            cin = cin_w[k // kw] if edge else y_end[k + 1 if backward else k - 1]
            for s in range(k0, min(t, k0 + s1.CHUNK)):
                y[:, s] = local[s] + cin @ phi[s].T
    return y


@pytest.mark.parametrize("chunks", [1, 2, 8])
@pytest.mark.parametrize("t", [1, 2, 77, 128])
def test_chunk_tables_compose_to_serial_solve(t, chunks):
    """The tables S1 reads (``rec``, ``phi``, ``psi``), composed as S1
    composes them (chunks, the scans over chunks, time segments of 1, 2 or
    8 chunks), reproduce the serial solves."""
    _, _, _, tch = _chols(2, t)
    ts = ParallelBidiagSolver.from_chol(tch)
    x = torch.from_numpy(np.random.default_rng(t).normal(size=(6, t, 4)))
    _close(_emulate_s1(ts, x, backward=False, chunks=chunks), tch.solve_L(x), rtol=SOLVE_RTOL)
    _close(_emulate_s1(ts, x, backward=True, chunks=chunks), tch.solve_LT(x), rtol=SOLVE_RTOL)


@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("t", [1024, 1100, 2600])
def test_chunk_tables_compose_at_kernel_segments(t, rows):
    """The same at the launcher's segments of eight warps' chunks (64 chunks,
    1,024 steps, at 4 rows per CTA; 256 at 1 row, 32 at 8): one whole
    segment, and horizons that end part-way through a segment, a warp and
    a chunk (T = 1100, 2600)."""
    _, _, _, tch = _chols(2, t)
    ts = ParallelBidiagSolver.from_chol(tch)
    x = torch.from_numpy(np.random.default_rng(t + rows).normal(size=(3, t, 4)))
    chunks = 8 * (32 // rows)
    for backward, serial in ((False, tch.solve_L), (True, tch.solve_LT)):
        _close(_emulate_s1(ts, x, backward=backward, chunks=chunks, rows=rows), serial(x),
               rtol=SOLVE_RTOL)


@pytest.mark.parametrize("backward", [False, True])
def test_scan_tables_match_serial_products(backward):
    """``rec`` holds the triangle of ``D_t^{-1}`` (``D_t^{-T}`` backward) and
    ``A_t`` (zero-padded to an odd number of 16-byte units), ``phr`` the
    chunk prefixes ``phi_t``, both zero-padded to whole chunks; ``psi`` level l at chunk k
    is the product of the ``A_t`` over the 2^l chunks ending (backward:
    starting) at k, cut at the horizon's ends, against the serial product
    in float64."""
    t, d = 200, 4
    _, _, _, tch = _chols(2, t)
    ts = ParallelBidiagSolver.from_chol(tch)
    a = ts.a_bwd if backward else ts.a_fwd
    rec = ts.rec_bwd if backward else ts.rec_fwd
    phr = ts.phr_bwd if backward else ts.phr_fwd
    phi = ts.phi_bwd if backward else ts.phi_fwd
    nch, n_tri = -(-t // s1.CHUNK), d * (d + 1) // 2
    assert rec.shape == (nch * s1.CHUNK, s1.rec_width(d, 8)) and rec.is_contiguous()
    assert phr.shape == (nch * s1.CHUNK, s1.phi_width(d, 8)) and phr.is_contiguous()
    tri = torch.cat([ts.dinv[:, i:, i] if backward else ts.dinv[:, i, :i + 1]
                     for i in range(d)], dim=1)
    assert torch.equal(rec[:t, :n_tri], tri)
    assert torch.equal(rec[:t, n_tri:n_tri + d * d], a.reshape(t, d * d))
    assert not rec[:t, n_tri + d * d:].any() and not rec[t:].any()
    assert torch.equal(phr[:t, :d * d], phi.reshape(t, d * d))
    assert not phr[:t, d * d:].any() and not phr[t:].any()
    psi = ts.psi_bwd if backward else ts.psi_fwd
    assert psi.shape == (s1.SCAN_LEVELS, d * d, nch) and psi.is_contiguous()
    for lv in range(s1.SCAN_LEVELS):
        for k in range(nch):
            lo, hi = (k, min(nch - 1, k + 2**lv - 1)) if backward else (max(0, k + 1 - 2**lv), k)
            want = torch.eye(d, dtype=torch.float64)
            for s in range(lo * s1.CHUNK, min(t, (hi + 1) * s1.CHUNK)):
                want = want @ a[s] if backward else a[s] @ want
            _close(_psi(ts, backward, lv, k), want, rtol=SOLVE_RTOL)


def test_make_gp_prior_auto_mode():
    """Dense exactly when M = 4T <= 2048, else the parallel solver; the dof
    factor only while 2T <= 2048; the sampler of a solver prior keeps no
    dense precision."""
    kw = dict(sigma_goal=1e-3, goal_states=LONG_HORIZON_GOALS, dtype=torch.float64,
              device="cpu")
    dense = make_gp_prior(2, 512, 0.02, START, 1e-3, 3.0, **kw)
    long = make_gp_prior(2, 513, 0.02, START, 1e-3, 3.0, **kw)
    assert dense.weight_t is not None and dense.psolver is None
    assert long.weight_t is None and long.psolver is not None and long.dof is not None
    assert SamplerModel.from_prior(long).precision_dense is None
    assert SamplerModel.from_prior(dense).precision_dense is not None
    assert make_gp_prior(2, 1024, 0.02, START, 1e-3, 3.0, **kw).dof is not None
    assert make_gp_prior(2, 1025, 0.02, START, 1e-3, 3.0, **kw).dof is None
    forced = make_gp_prior(2, 40, 0.02, START, 1e-3, 3.0, materialize_dense=False, **kw)
    assert forced.weight_t is None and forced.psolver is not None


@pytest.mark.parametrize("method", ["dense", "scan", "pscan", "auto"])
def test_prior_sample_matches_jax(method):
    """``GPPrior.sample`` with the JAX draw injected, against JAX's sample
    from the same key (T = 40: ``dense`` on a dense prior, the others on a
    solver prior)."""
    from stoch_gpmp_tpu.gp.prior import make_gp_prior as jmake

    t, dense = 40, method == "dense"
    jp = jmake(2, t, 0.02, jnp.asarray(START), 1e-3, 3.0, sigma_goal=1e-3,
               goal_states=jnp.asarray(LONG_HORIZON_GOALS), dtype=jnp.float64,
               materialize_dense=dense)
    tp = make_gp_prior(2, t, 0.02, START, 1e-3, 3.0, sigma_goal=1e-3,
                       goal_states=LONG_HORIZON_GOALS, dtype=torch.float64, device="cpu",
                       materialize_dense=dense)
    key = jax.random.PRNGKey(3)
    eps = torch.from_numpy(np.array(jax.random.normal(key, (1, 6, t, 4), dtype=jnp.float64)))
    _close(tp.sample(None, 6, method=method, eps=eps), jp.sample(key, 6, method=method),
           rtol=SOLVE_RTOL)
    moved = tp.set_means(tp.means + 1.0)
    _close(moved.sample(None, 6, method=method, eps=eps) - 1.0,
           jp.sample(key, 6, method=method), rtol=SOLVE_RTOL)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, t, 4)))
    _close(tp.precision_matvec(x), jp.precision_matvec(jnp.asarray(x.numpy())),
           rtol=SOLVE_RTOL)


def test_set_sigma_inv_keeps_the_solver_form():
    prior = make_gp_prior(2, 600, 0.02, START, 1e-3, 3.0, sigma_goal=1e-3,
                          goal_states=LONG_HORIZON_GOALS, dtype=torch.float64, device="cpu")
    swapped = prior.set_sigma_inv(prior.precision.add_jitter(1.0))
    assert swapped.weight_t is None and swapped.psolver is not None and swapped.dof is None
    b = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 600, 4)))
    _close(swapped.psolver.solve(b), swapped.chol.solve(b), rtol=SOLVE_RTOL)


@pytest.mark.parametrize("which", ["gp", "goal", "collision", "composite"])
def test_eval_planes_match_jax_and_eval(problem96, which):
    """The four ``eval_planes`` on the long-horizon stack against the JAX
    package's and the port's own ``eval`` on the same ``[P, S, T, d]``
    batch; the raster field reads the planes of one tensor in place."""
    (_, jc, _), (_, tc, _) = problem96
    idx = {"gp": 0, "goal": 1, "collision": 2}
    jcost = jc if which == "composite" else jc.costs[idx[which]]
    tcost = tc if which == "composite" else tc.costs[idx[which]]
    assert tcost.supports_planes() and jcost.supports_planes()
    x = np.random.default_rng(5).normal(size=(P, 4, 96, 4)) * 6.0
    xt = torch.from_numpy(x).permute(3, 0, 1, 2).contiguous()  # [d, P, S, T]
    got = tcost.eval_planes(tuple(xt))
    want = jcost.eval_planes(tuple(jnp.asarray(x[..., i]) for i in range(4)))
    flat = tcost.eval(torch.from_numpy(x).reshape(P * 4, 96, 4)).reshape(P, 4)
    assert got.shape == (P, 4)
    _close(got, want)
    _close(got, flat)
    if which == "collision":
        assert float(want.min()) > 0  # the samples hit obstacles


def _jax_plane_eps(key, shape, n):
    """The eps of ``n`` plane-path iterations from ``key`` (split, then
    draw ``[d, P, S, T]``, as the JAX plane path draws)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, shape, dtype=jnp.float64)))
    return torch.from_numpy(np.stack(out))


@pytest.mark.parametrize("plane_stream", [False, True])
def test_structured_step_matches_jax(problem96, plane_stream):
    """``stoch_gpmp_step`` on a solver sampler: the structured solve on
    ``[P, S, T, d]`` and, with ``plane_stream``, the plane-ordered draw and
    solve, against the JAX step with the same flag and key."""
    from stoch_gpmp_tpu.planners import stoch_gpmp_step as jstep

    (js, jc, jst), (ts, tc, tst) = problem96
    p, t, d = jst.particle_means.shape
    shape = (d, p, S, t) if plane_stream else (p, S, t * d)
    eps = _jax_plane_eps(jst.key, shape, 1)[0]
    jn, ja = jax.jit(lambda s, c, st: jstep(
        s, c, st, {}, num_samples=S, temperature=TAU, step_size=STEP,
        plane_stream=plane_stream))(js, jc, jst)
    tn, ta = stoch_gpmp_step(ts, tc, tst, {}, num_samples=S, temperature=TAU,
                             step_size=STEP, plane_stream=plane_stream, eps=eps)
    _close(tn.particle_means, jn.particle_means)
    _close(ta.samples, ja.samples)
    _close(ta.costs, ja.costs)
    _close(ta.weights, ja.weights)


@pytest.mark.parametrize("collect_metrics", [False, True])
def test_planes_route_three_iterations_match_jax(problem96, collect_metrics):
    """``stoch_gpmp_optimize`` on the ``"planes"`` route over 3 iterations
    with the JAX draws injected (a stacked tensor, or a callable with the
    metrics), against the JAX plane path."""
    from stoch_gpmp_tpu.planners import stoch_gpmp_optimize as jopt

    (js, jc, jst), (ts, tc, tst) = problem96
    assert _route(ts, tc, 96) == "planes"
    p, t, d = jst.particle_means.shape
    eps = _jax_plane_eps(jst.key, (d, p, S, t), 3)
    jout = jax.jit(lambda s, c, st: jopt(
        s, c, st, {}, opt_iters=3, num_samples=S, temperature=TAU, step_size=STEP,
        collect_metrics=collect_metrics))(js, jc, jst)
    tout = stoch_gpmp_optimize(
        ts, tc, tst, {}, opt_iters=3, num_samples=S, temperature=TAU, step_size=STEP,
        collect_metrics=collect_metrics, eps=(lambda i: eps[i]) if collect_metrics else eps)
    (jn, ja), (tn, ta) = jout[:2], tout[:2]
    _close(tn.particle_means, jn.particle_means)
    _close(ta.samples, ja.samples)
    _close(ta.costs, ja.costs)
    _close(ta.weights, ja.weights)
    _close(ta.grad, ja.grad)
    if collect_metrics:
        for name in ("cost_mean", "cost_min", "weight_entropy", "update_norm"):
            _close(getattr(tout[2], name), getattr(jout[2], name))


class _Routed(Exception):
    pass


@pytest.mark.parametrize("case", ["dense64", "psolver96", "psolver128", "quad128"])
def test_route_matches_jax_gates(case, monkeypatch):
    """``_route`` against the JAX package's own choice, read by replacing
    its dof and plane paths with probes: a dense T = 64 problem (flat),
    solver problems at T = 96 and 128 on the CostGP stack (planes), and the
    quadratic stack at T = 128 (dof)."""
    import stoch_gpmp_tpu.planners.stoch_gpmp as jmod

    t = {"dense64": 64, "psolver96": 96, "psolver128": 128, "quad128": 128}[case]
    js, jc, jst = _jax_problem(t, quad=case.startswith("quad"),
                               materialize_dense=case == "dense64", particles=1)
    ts, tc, tst = _convert(js, jc, jst)
    for name, route in (("_stoch_gpmp_optimize_dof", "dof"),
                        ("_stoch_gpmp_optimize_planes", "planes")):
        monkeypatch.setattr(jmod, name, lambda *a, route=route, **k: (_ for _ in ()).throw(
            _Routed(route)))
    try:
        jmod.stoch_gpmp_optimize(js, jc, jst, {}, opt_iters=1, num_samples=2,
                                 temperature=TAU, step_size=STEP)
        want = "flat"
    except _Routed as routed:
        want = str(routed)
    assert want == {"dense64": "flat", "psolver96": "planes", "psolver128": "planes",
                    "quad128": "dof"}[case]
    assert _route(ts, tc, t) == want


def test_sampler_from_jax_psolver(problem96):
    """The converted solver sampler: no dense factor or precision, the JAX
    solver's tables, S1's tables (chunk prefixes, step records, scan
    products) equal to the native build's, and the native problem equal to
    the converted one."""
    (js, jc, _), (ts, tc, tst) = problem96
    assert ts.weight_t is None and ts.precision_dense is None and ts.psolver is not None
    for name in ("dinv", "a_fwd", "a_bwd"):
        _close(getattr(ts.psolver, name), getattr(js.psolver, name), rtol=SOLVE_RTOL)
    ns, nc, nst = build_long_horizon_problem(96, dtype=torch.float64, device="cpu")
    for f in fields(ParallelBidiagSolver):
        _close(getattr(ns.psolver, f.name), getattr(ts.psolver, f.name), rtol=SOLVE_RTOL)
    np.testing.assert_allclose(nst.particle_means.numpy()[:P], tst.particle_means.numpy(),
                               rtol=1e-12)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(6, 96, 4)) * 6.0)
    _close(nc.eval(x), tc.eval(x))


def test_kernel_wrapper_contract():
    """S1's wrapper: the plain version for a CPU tensor, counted nowhere; a
    tensor on another device raises, and so do tables of another shape
    (``rec`` rows of ``rec_width``, ``psi`` of ``SCAN_LEVELS`` levels over
    the chunks), checked before the device; the planes' layout (one tensor
    at a plane stride, or the stride-d planes of ``[..., T, d]``) is read
    in place."""
    from dataclasses import replace

    _, _, _, tch = _chols(2, 40)
    ts = ParallelBidiagSolver.from_chol(tch)
    for f in fields(ParallelBidiagSolver):  # as the kernel reads them
        assert getattr(ts, f.name).is_contiguous()
    assert [s1.rec_width(d, size) for d, size in ((4, 4), (4, 8), (14, 4), (2, 8))] == [
        28, 26, 308, 10]
    assert [s1.phi_width(d, size) for d, size in ((4, 4), (4, 8), (14, 4), (2, 8))] == [
        16, 16, 196, 4]
    before = (s1.bidiag_scan.launches, s1.bidiag_scan.staged_launches)
    x = torch.zeros((4, 3, 5, 40), dtype=torch.float64)
    ts.solve_LT_planes(tuple(x))
    assert (s1.bidiag_scan.launches, s1.bidiag_scan.staged_launches) == before
    meta = replace(ts, **{f.name: getattr(ts, f.name).to("meta")
                          for f in fields(ParallelBidiagSolver)})
    with pytest.raises(ValueError, match="S1 takes float32 or float64 CUDA planes"):
        s1.bidiag_scan(meta, tuple(x.to("meta")), backward=True)
    for bad in (dict(psi_bwd=meta.psi_bwd[:-1]), dict(rec_bwd=meta.rec_bwd[:, :-2]),
                dict(psi_fwd=meta.psi_fwd[..., :1]), dict(phr_bwd=meta.phr_bwd[:40]),
                dict(phr_fwd=meta.phr_fwd[:, :12])):
        with pytest.raises(ValueError, match="contiguous tables"):
            s1.bidiag_scan(replace(meta, **bad), tuple(x.to("meta")),
                           backward=not any(k.endswith("_fwd") for k in bad))
    with pytest.raises(ValueError, match="S1 takes"):
        s1.bidiag_scan(ts, tuple(x.to("meta")), backward=True)
    assert s1._layout(tuple(x))[1:] == (600, 40, 1, 15, 40)
    y = torch.zeros((3, 5, 40, 4))
    assert s1._layout(tuple(y.unbind(-1)))[1:] == (1, 160, 4, 15, 40)
    assert s1._layout((x[0], x[1].clone(), x[2], x[3])) is None


def test_long_horizon_class_api():
    """``StochGPMP`` and ``GPMP`` at d = 4, T = 520 (M = 2080) on the CPU:
    the solver sampler, ``reset``, ``optimize`` with and without metrics,
    ``sample_trajectories``; finite values, shapes and the start anchor;
    ``fused_kernel=True`` refuses the stack with its reason."""
    from stoch_gpmp_tpu_torch.costs import CostComposite, CostGP, CostGoalPrior

    t = 520
    cost = CostComposite.create(2, t, [
        CostGP.create(2, t, START, 0.02, {"sigma_start": 1e-3, "sigma_gp": 0.1}),
        CostGoalPrior.create(2, t, LONG_HORIZON_GOALS, sigma_goal_prior=1e-3),
    ])
    kw = dict(num_particles_per_goal=2, num_samples=4, traj_len=t, opt_iters=3, dt=0.02,
              n_dof=2, step_size=STEP, temperature=TAU, start_state=START,
              multi_goal_states=LONG_HORIZON_GOALS, cost=cost, sigma_start_init=1e-3,
              sigma_gp_init=3.0, sigma_goal_init=1e-3, sigma_start_sample=1e-3,
              sigma_gp_sample=3.0, sigma_goal_sample=1e-3, device="cpu")
    planner = StochGPMP(**kw)
    assert planner.sampler.weight_t is None and planner.sampler.psolver is not None
    assert _route(planner.sampler, cost, t) == "planes"
    out = planner.optimize()
    assert [tuple(o.shape) for o in out] == [(2, t, 2), (2, t, 2), (2, 4, t, 2), (2, 4, t, 2),
                                             (2, 4), (2, t, 4)]
    assert all(bool(torch.isfinite(o).all()) for o in out)
    planner.optimize(collect_metrics=True)
    assert planner.last_metrics.cost_mean.shape == (3,)
    means = planner.particle_means
    assert float((means[:, 0, :2] - torch.tensor(START[:2])).abs().max()) < 0.05
    pos, vel = planner.sample_trajectories(3)
    assert pos.shape == (2, 3, t, 2) and bool(torch.isfinite(vel).all())
    planner.reset(start_state=START)
    assert planner.particle_means.shape == (2, t, 4)
    with pytest.raises(ValueError, match="fused_kernel=True but the stack is ineligible"):
        StochGPMP(fused_kernel=True, **kw).optimize()
    gn = GPMP(num_particles_per_goal=2, traj_len=t, opt_iters=1, dt=0.02, n_dof=2,
              start_state=START, multi_goal_states=LONG_HORIZON_GOALS, cost=cost,
              sigma_start_init=1e-3, sigma_goal_init=1e-3, sigma_gp_init=3.0,
              sigma_start_sample=1e-3, sigma_goal_sample=1e-3, sigma_gp_sample=3.0,
              solver_params={"delta": 1e-2, "trust_region": False, "method": "cholesky"},
              device="cpu")
    pos, vel = gn.sample_trajectories(3)
    assert pos.shape == (2, 3, t, 2) and bool(torch.isfinite(pos).all())
    assert float((pos[:, :, 0] - torch.tensor(START[:2])).abs().max()) < 0.05


def test_long_horizon_modules_never_import_jax():
    code = (
        "import sys\n"
        "from stoch_gpmp_tpu_torch.ops.kernels import bidiag_scan\n"
        "from stoch_gpmp_tpu_torch.problems import build_long_horizon_problem\n"
        "from stoch_gpmp_tpu_torch.planners import stoch_gpmp_optimize\n"
        "sa, c, st = build_long_horizon_problem(600, device='cpu')\n"
        "stoch_gpmp_optimize(sa, c, st, {}, opt_iters=1, num_samples=2, temperature=1.0,"
        " step_size=0.5)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'stoch_gpmp_tpu.'))"
        " or m == 'stoch_gpmp_tpu']\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
