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
