"""GP core of the PyTorch port against the JAX package, in float64.

Same numpy inputs through both packages; every comparison is rtol 1e-10
(float64 arithmetic in both, in a different order at most).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stoch_gpmp_tpu.gp import dof_factored as jdf
from stoch_gpmp_tpu.gp import lift as jlift
from stoch_gpmp_tpu.gp import prior as jprior
from stoch_gpmp_tpu_torch.gp import dof_factored as tdf
from stoch_gpmp_tpu_torch.gp import lift as tlift
from stoch_gpmp_tpu_torch.gp import prior as tprior

F64 = torch.float64
RTOL = 1e-10
START = [-9.0, -9.0, 0.0, 0.0]
GOALS = [[9.0, 6.0, 0.0, 0.0], [9.0, -3.0, 0.0, 0.0], [-3.0, 9.0, 0.0, 0.0]]


def _close(t, j, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dof,dt,sigma", [(1, 0.02, 3.0), (2, 0.02, 0.1), (7, 0.05, 1e-3)])
def test_lift_matrices(dof, dt, sigma):
    _close(tlift.phi_matrix(dof, dt, dtype=F64), jlift.phi_matrix(dof, dt, dtype=jnp.float64))
    _close(tlift.q_inv_block(dof, dt, sigma=sigma, dtype=F64),
           jlift.q_inv_block(dof, dt, sigma=sigma, dtype=jnp.float64))
    _close(tlift.unary_weight(2 * dof, sigma, dtype=F64),
           jlift.unary_weight(2 * dof, sigma, dtype=jnp.float64))


@pytest.fixture(scope="module")
def priors():
    """The parity sampling prior (T=64, 2 DOF, three goals) in both packages."""
    kw = dict(sigma_goal=1e-3, goal_states=GOALS)
    j = jprior.make_gp_prior(2, 64, 0.02, jnp.asarray(START), 1e-3, 3.0,
                             dtype=jnp.float64, **kw)
    t = tprior.make_gp_prior(2, 64, 0.02, START, 1e-3, 3.0, dtype=F64, **kw)
    return j, t


@pytest.mark.parametrize("field", [
    "precision.diag", "precision.lower", "chol.diag", "chol.lower", "weight_t",
    "means", "dof.w_dof", "dof.prec_dof",
])
def test_prior_fields(priors, field):
    j, t = priors
    for name in field.split("."):
        j, t = getattr(j, name), getattr(t, name)
    # entries of the factor span ~1e-3..1e5: compare against the largest
    scale = float(np.abs(np.asarray(j)).max())
    _close(t, j, atol=RTOL * scale)


def test_dense_precision_and_matvec(priors):
    j, t = priors
    _close(t.precision.to_dense(), j.precision.to_dense())
    x = np.random.default_rng(0).normal(size=(5, 64, 4))
    _close(t.precision.matvec(torch.from_numpy(x)), j.precision.matvec(jnp.asarray(x)))
    _close(t.dof.matvec_flat(torch.from_numpy(x)), j.dof.matvec_flat(jnp.asarray(x)))
    _close(t.log_prob(torch.from_numpy(x[:3])), j.log_prob(jnp.asarray(x[:3])))


def test_cholesky_solves(priors):
    j, t = priors
    b = np.random.default_rng(1).normal(size=(3, 64, 4))
    for name in ("solve_L", "solve_LT"):
        _close(getattr(t.chol, name)(torch.from_numpy(b)),
               getattr(j.chol, name)(jnp.asarray(b)))
    _close(t.chol.dense_inv_transpose(), j.chol.dense_inv_transpose(), atol=1e-10)


def test_set_sigma_inv_rebuilds_factor(priors):
    j, t = priors
    scale = 2.0
    jp = j.set_sigma_inv(j.precision.replace(diag=j.precision.diag * scale,
                                             lower=j.precision.lower * scale))
    tp = t.set_sigma_inv(type(t.precision)(t.precision.diag * scale, t.precision.lower * scale))
    _close(tp.weight_t, jp.weight_t, atol=1e-12)
    assert tp.dof is None and jp.dof is None


def test_dof_quadratic_cost_fields():
    from stoch_gpmp_tpu.costs import CostGP as JGP, CostGoalPrior as JGoal
    from stoch_gpmp_tpu_torch.costs import CostGP as TGP, CostGoalPrior as TGoal

    sig = {"sigma_start": 1e-3, "sigma_gp": 0.1}
    jq = jdf.DofQuadraticCost.from_gp_and_goal_prior(
        JGP.create(2, 64, jnp.asarray(START), 0.02, sig, dtype=jnp.float64),
        JGoal.create(2, 64, jnp.asarray(GOALS), 1e-3, dtype=jnp.float64), 64)
    tq = tdf.DofQuadraticCost.from_gp_and_goal_prior(
        TGP.create(2, 64, START, 0.02, sig, dtype=F64),
        TGoal.create(2, 64, GOALS, 1e-3, dtype=F64), 64)
    for name in ("a_dof", "b_planes", "c", "q_i2", "k_s2", "k_g2", "s_pd", "g_pd"):
        _close(getattr(tq, name), getattr(jq, name))
    assert tq.dt == pytest.approx(jq.dt, rel=RTOL)


@pytest.mark.parametrize("sigma_goal", [None, 1e-3])
def test_dof_factored_prior(sigma_goal):
    """The per-dof factor at a shorter horizon, with and without a goal
    anchor (zero goal weights without one)."""
    j = jdf.make_dof_factored_prior(16, 0.05, 1e-2, 0.5, sigma_goal=sigma_goal,
                                    dtype=jnp.float64)
    t = tdf.make_dof_factored_prior(16, 0.05, 1e-2, 0.5, sigma_goal=sigma_goal, dtype=F64)
    for name in ("w_dof", "prec_dof", "q_i2", "k_s2", "k_g2"):
        jv = getattr(j, name)
        _close(getattr(t, name), jv, atol=RTOL * float(np.abs(np.asarray(jv)).max()))


# --- kernel C1's routing: a CPU system takes the loops, its plain version ---


def _c1_counts():
    from stoch_gpmp_tpu_torch.ops.kernels.block_chol import block_chol

    return block_chol.launches, block_chol.generic_launches


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_cpu_build_takes_the_loop(dtype):
    """``make_gp_prior`` on the CPU: the factor, ``L^{-1}`` and the per-dof
    factor are the loops' to the last bit, and C1's counters do not move."""
    before = _c1_counts()
    t = tprior.make_gp_prior(2, 64, 0.02, START, 1e-3, 3.0, sigma_goal=1e-3,
                             goal_states=GOALS, dtype=dtype)
    assert _c1_counts() == before
    chol = t.precision.cholesky_loop()
    assert torch.equal(t.chol.diag, chol.diag) and torch.equal(t.chol.lower, chol.lower)
    assert torch.equal(t.weight_t, chol.dense_inv_transpose().T)
    assert torch.equal(t.chol.dense_inv_transpose(), chol.dense_inv_transpose())
    assert t.weight_t.dtype == dtype and t.weight_t.is_contiguous()


@pytest.mark.parametrize("dof,traj_len,dt,sigmas", [
    (7, 16, 0.05, (1e-4, 0.8, 0.1)),  # the Panda example's init prior, d = 14
    (1, 64, 0.02, (1e-3, 3.0, 1e-3)),  # the planar per-dof shape, d = 2
])
def test_prior_build_matches_jax(dof, traj_len, dt, sigmas):
    """``make_gp_prior`` on the CPU against the JAX package at the other
    block sizes C1 compiles in: the factor and ``L^{-1}`` (the dense
    sampler), relative to their largest entries."""
    s_start, s_gp, s_goal = sigmas
    start = np.linspace(-1.0, 1.0, 2 * dof)
    goals = np.linspace(1.0, -0.5, 2 * dof)[None]
    j = jprior.make_gp_prior(dof, traj_len, dt, jnp.asarray(start), s_start, s_gp,
                             sigma_goal=s_goal, goal_states=jnp.asarray(goals),
                             dtype=jnp.float64)
    t = tprior.make_gp_prior(dof, traj_len, dt, start, s_start, s_gp, sigma_goal=s_goal,
                             goal_states=goals, dtype=F64)
    for name in ("diag", "lower"):
        jv = getattr(j.chol, name)
        _close(getattr(t.chol, name), jv, atol=RTOL * float(np.abs(np.asarray(jv)).max()))
    _close(t.weight_t, j.weight_t, atol=RTOL * float(np.abs(np.asarray(j.weight_t)).max()))


@pytest.mark.parametrize("device,dtype,d,taken", [
    ("cuda", torch.float32, 4, True),
    ("cuda", F64, 14, True),
    ("cuda", torch.float32, 16, True),
    ("cuda", torch.float32, 18, False),
    ("cuda", torch.float16, 4, False),
    ("meta", torch.float32, 4, False),
])
def test_c1_takes_by_what_the_blocks_show(device, dtype, d, taken):
    """C1 takes CUDA float32 or float64 blocks up to d = 16 and refuses
    every other system off the CPU: no second path on the card. Nothing is
    counted either way."""
    from types import SimpleNamespace

    from stoch_gpmp_tpu_torch.ops.kernels import block_chol as c1

    blocks = SimpleNamespace(device=torch.device(device), dtype=dtype)
    before = _c1_counts()
    if taken:
        c1.check_blocks(blocks, d)
    else:
        with pytest.raises(ValueError, match="C1 takes float32 or float64 CUDA blocks"):
            c1.check_blocks(blocks, d)
    assert _c1_counts() == before


def test_loop_nan_carries_forward():
    """The plain version's contract, which C1 keeps: a block that is not
    positive definite makes its ``D_t`` all NaN and every later one too,
    and leaves the earlier blocks as they were."""
    prec = tprior.build_precision(2, 16, 0.02, tlift.unary_weight(4, 1e-3),
                                  tlift.q_inv_block(2, 0.02, sigma=3.0))
    diag = prec.diag.clone()
    diag[5] = -diag[5]
    bad = type(prec)(diag, prec.lower).cholesky()
    good = prec.cholesky()
    assert torch.equal(bad.diag[:5], good.diag[:5]) and torch.equal(bad.lower[:4], good.lower[:4])
    assert bool(bad.diag[5:].isnan().all()) and bool(bad.lower[5:].isnan().all())
    assert bool(torch.isfinite(bad.lower[4]).all())


@pytest.mark.parametrize("diag_shape,lower_shape,lead", [
    ((64, 4, 4), (63, 4, 4), ()),
    ((15, 64, 4, 4), (63, 4, 4), (15,)),
    ((1, 8, 2, 2), (3, 7, 2, 2), (3,)),
    ((5, 1, 4, 4), (5, 0, 4, 4), (5,)),
])
def test_c1_blocks_broadcast_and_check(diag_shape, lower_shape, lead):
    """C1's operands: ``diag`` and ``lower`` broadcast to one leading
    shape, contiguous; blocks of another shape or dtype are refused."""
    from stoch_gpmp_tpu_torch.ops.kernels.block_chol import _blocks

    diag, lower = _blocks(torch.ones(diag_shape), torch.ones(lower_shape))
    assert diag.shape[:-3] == lower.shape[:-3] == lead
    assert diag.is_contiguous() and lower.is_contiguous()
    with pytest.raises(ValueError, match="T-1"):
        _blocks(torch.ones(diag_shape), torch.ones(diag_shape))
    with pytest.raises(ValueError, match="one dtype"):
        _blocks(torch.ones(diag_shape), torch.ones(lower_shape, dtype=F64))
