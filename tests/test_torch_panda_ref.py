"""The reference-shaped Panda stack of the PyTorch port against the JAX
package: the link geometry (``LinkState``, ``se3_distance``), the link fields,
``CostComposite(fk=...)`` with ``CostCollision``/``CostGoal`` on link poses,
and the plain versions of kernels K7 (fields at link positions) and K8
(FK + fields per configuration), at ``benchmarks/run.py`` config 4's layout
(1 goal, T = 64, 7 DOF, 5 spheres) and small batches.

Inputs are made with numpy from a seed; the JAX problem mirrors
``benchmarks/run.py _panda_problem(fast=False)`` with a dtype argument and
is carried over by ``convert``. Each test states its tolerance.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stoch_gpmp_tpu_torch import convert  # noqa: E402
from stoch_gpmp_tpu_torch.costs import (  # noqa: E402
    CostCollision,
    CostComposite,
    EESE3DistanceField,
    FusedLinkFieldsCost,
    LinkDistanceField,
    LinkSelfDistanceField,
)
from stoch_gpmp_tpu_torch.kinematics import se3_distance  # noqa: E402
from stoch_gpmp_tpu_torch.ops.kernels.panda_fields import (  # noqa: E402
    fk_link_fields_cost,
    fk_link_fields_cost_plain,
    fused_link_fields_cost,
    fused_link_fields_cost_plain,
)
from stoch_gpmp_tpu_torch.problems import PANDA_START_Q, build_panda_problem  # noqa: E402

T, D, S = 64, 7, 4
KW = dict(margin=0.03, w_self=1e4, w_obst=1e4)


def _jax_reference_stack(dtype, fk_name):
    """``benchmarks/run.py _panda_problem(fast=False)``'s cost stack and
    observation with a dtype and the chain's ``fk_name`` method as ``fk``."""
    from stoch_gpmp_tpu.costs import (
        CostCollision, CostComposite, CostGP, CostGoal, CostGoalPrior,
        EESE3DistanceField, LinkDistanceField, LinkSelfDistanceField,
    )
    from stoch_gpmp_tpu.kinematics import homogeneous, y_rot, z_rot
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda

    chain = franka_panda(dtype=dtype)
    target_h = homogeneous(z_rot(jnp.asarray(-np.pi, dtype)) @ y_rot(jnp.asarray(-np.pi, dtype)),
                           jnp.asarray([0.3, 0.3, 0.3], dtype))
    start_q = jnp.asarray(PANDA_START_Q, dtype)
    start = jnp.concatenate([start_q, jnp.zeros_like(start_q)])
    rng = np.random.default_rng(0)
    goals_q = start_q[None] + jnp.asarray(rng.uniform(-0.3, 0.3, (1, D)), dtype)
    goals = jnp.concatenate([goals_q, jnp.zeros_like(goals_q)], axis=-1)
    cost = CostComposite.create(D, T, [
        CostGP.create(D, T, start, 0.05, {"sigma_start": 0.0001, "sigma_gp": 0.0007}, dtype=dtype),
        CostGoalPrior.create(D, T, goals, sigma_goal_prior=20.0, dtype=dtype),
        CostCollision.create(D, T, LinkSelfDistanceField(margin=0.03), sigma_coll=0.01),
        CostCollision.create(D, T, LinkDistanceField(), sigma_coll=0.01),
        CostGoal.create(D, T, EESE3DistanceField(target_h=target_h), sigma_goal=0.00007),
    ], fk=getattr(chain, fk_name))
    spheres = np.zeros((1, 5, 4))
    spheres[0, :, :3] = rng.uniform([0.6, -0.2, 0.6], [1.0, 0.2, 1.0], (5, 3))
    spheres[0, :, 3] = rng.uniform(0.1, 0.2, 5)
    return cost, {"obstacle_spheres": jnp.asarray(spheres, dtype)}


def _trajs(n, scale, seed):
    """``[n, T, 2d]`` trajectories: config 4's straight start-to-goal means
    plus normal noise of ``scale``."""
    _, _, st, _, _ = build_panda_problem(dtype=torch.float64, device="cpu")
    x = np.repeat(st.particle_means.numpy()[:1], n, axis=0)
    return x + scale * np.random.default_rng(seed).normal(size=x.shape)


def _q(n, seed):
    """``[n, d]`` joint angles: half near the start, half across the joint
    range (links within the 3 cm margin of each other)."""
    rng = np.random.default_rng(seed)
    q = np.asarray(PANDA_START_Q) + 0.1 * rng.normal(size=(n, D))
    q[n // 2:] = rng.uniform(-2.8, 2.8, (n - n // 2, D))
    return q


def _close(t, j, rtol):
    """Relative to the largest magnitude of the reference."""
    j = np.asarray(j, dtype=np.float64)
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * max(np.abs(j).max(), 1e-300))


@pytest.fixture(scope="module")
def links():
    """The same float64 joint angles through the JAX chain's ``fk`` and
    ``fk_compact``, and the port's chain, the link tensors carried over."""
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda

    from stoch_gpmp_tpu_torch.kinematics import franka_panda as tfranka

    q = _q(40, 1).reshape(8, 5, D)
    jchain = franka_panda(dtype=jnp.float64)
    jfull = jchain.fk(jnp.asarray(q))
    jcompact = jchain.fk_compact(jnp.asarray(q))
    rng = np.random.default_rng(2)
    spheres = np.concatenate([rng.uniform(0.0, 0.6, (1, 5, 3)), rng.uniform(0.1, 0.3, (1, 5, 1))],
                             axis=-1)
    # two spheres centred on links: those points sit inside a sphere
    spheres[0, 3, :3] = np.asarray(jcompact.positions)[0, 0, 4]
    spheres[0, 4, :3] = np.asarray(jcompact.positions)[3, 2, 8]
    return {
        "q": q, "chain": tfranka(),
        "jax": {"full": jfull, "compact": jcompact},
        "torch": {"full": torch.from_numpy(np.array(jfull)),
                  "compact": convert.link_state_from_jax(jcompact, device="cpu")},
        "spheres": spheres,
    }


def test_link_state_matches_jax(links):
    """``fk``/``fk_compact`` and ``LinkState``'s ``shape``, ``__getitem__``,
    ``reshape`` and ``ee_pose`` against JAX, float64, rtol 1e-12."""
    chain, q = links["chain"], torch.from_numpy(links["q"])
    jfull, jcompact = links["jax"]["full"], links["jax"]["compact"]
    _close(chain.fk(q), jfull, 1e-12)
    ls = chain.fk_compact(q)
    assert ls.shape == tuple(jcompact.shape) == (8, 5, 9, 3)
    _close(ls.positions, jcompact.positions, 1e-12)
    _close(ls.ee_rot, jcompact.ee_rot, 1e-12)
    for idx in ((slice(None), slice(1, None)), (slice(None), -1), 3):
        got, want = ls[idx], jcompact[idx]
        assert got.shape == tuple(want.shape)
        _close(got.positions, want.positions, 1e-12)
        _close(got.ee_rot, want.ee_rot, 1e-12)
    flat, jflat = ls.reshape(40), jcompact.reshape(40)
    assert flat.shape == tuple(jflat.shape) == (40, 9, 3)
    _close(flat.ee_pose(), jflat.ee_pose(), 1e-12)
    _close(ls.ee_pose(), jfull[..., -1, :, :], 1e-12)


def test_se3_distance_matches_jax(links):
    """``se3_distance`` between end-effector poses and a target, and between
    pairs of poses, float64, rtol 1e-12."""
    from stoch_gpmp_tpu.kinematics.se3 import se3_distance as jse3

    jfull, full = links["jax"]["full"], links["torch"]["full"]
    target = full[0, 0, -1]
    for w_pos, w_rot in ((1.0, 1.0), (2.0, 0.5)):
        _close(se3_distance(full[..., -1, :, :], target, w_pos=w_pos, w_rot=w_rot),
               jse3(jfull[..., -1, :, :], jfull[0, 0, -1], w_pos=w_pos, w_rot=w_rot), 1e-12)
        _close(se3_distance(full[..., 2, :, :], full[..., 6, :, :], w_pos=w_pos, w_rot=w_rot),
               jse3(jfull[..., 2, :, :], jfull[..., 6, :, :], w_pos=w_pos, w_rot=w_rot), 1e-12)


def _field_pairs():
    """``(name, port field, JAX field, takes spheres)`` for every link field
    and option."""
    from stoch_gpmp_tpu.costs import fields as jf

    out = []
    for ftype, clamp in (("rbf", False), ("sdf", False), ("sdf", True), ("occupancy", False)):
        out.append((f"link-{ftype}{'-clamp' if clamp else ''}",
                    LinkDistanceField(field_type=ftype, clamp_sdf=clamp),
                    jf.LinkDistanceField(field_type=ftype, clamp_sdf=clamp), True))
    out.append(("link-rbf-interp", LinkDistanceField(num_interpolate=3),
                jf.LinkDistanceField(num_interpolate=3), True))
    out.append(("self", LinkSelfDistanceField(margin=0.05),
                jf.LinkSelfDistanceField(margin=0.05), False))
    out.append(("self-interp", LinkSelfDistanceField(margin=0.05, num_interpolate=2),
                jf.LinkSelfDistanceField(margin=0.05, num_interpolate=2), False))
    return out


@pytest.mark.parametrize("rep", ["full", "compact"])
def test_link_fields_match_jax(links, rep):
    """Every link field of ``costs/fields.py`` (``compute_cost`` of each type
    and option, ``distances``, ``compute_collision``, ``compute_distance``)
    and ``EESE3DistanceField`` on the same link tensors as JAX, full poses
    and ``fk_compact``, float64, rtol 1e-12 (collision flags exactly)."""
    tl, jl = links["torch"][rep], links["jax"][rep]
    sph = links["spheres"]
    tsph, jsph = torch.from_numpy(sph), jnp.asarray(sph)
    for name, tf, jf, with_spheres in _field_pairs():
        if with_spheres:
            _close(tf.compute_cost(tl, obstacle_spheres=tsph),
                   jf.compute_cost(jl, obstacle_spheres=jsph), 1e-12)
            _close(tf.distances(tl, tsph), jf.distances(jl, jsph), 1e-12)
            _close(tf.compute_distance(tl, tsph), jf.compute_distance(jl, jsph), 1e-12)
            got, want = tf.compute_collision(tl, tsph), np.asarray(jf.compute_collision(jl, jsph))
            assert want.any() and np.array_equal(got.numpy(), want), name
            assert not tf.compute_collision(tl).any()
            assert float(tf.compute_distance(tl)) == 1e10
            _close(tf.compute_cost(tl), jf.compute_cost(jl), 1e-12)
        else:
            _close(tf.compute_cost(tl), jf.compute_cost(jl), 1e-12)
            _close(tf.distances(tl), jf.distances(jl), 1e-12)
            _close(tf.compute_distance(tl), jf.compute_distance(jl), 1e-12)
            for buffer in (0.05, 0.3):
                got = tf.compute_collision(tl, buffer=buffer)
                assert np.array_equal(got.numpy(), np.asarray(jf.compute_collision(jl, buffer=buffer)))
    from stoch_gpmp_tpu.costs.fields import EESE3DistanceField as JEE

    target = links["torch"]["full"][1, 1, -1]
    for square in (True, False):
        tf = EESE3DistanceField(target_h=target, w_pos=1.5, w_rot=0.7, square=square)
        jf = JEE(target_h=jnp.asarray(target.numpy()), w_pos=1.5, w_rot=0.7, square=square)
        _close(tf.compute_cost(tl), jf.compute_cost(jl), 1e-12)
        _close(tf.update_target(target * 1.0).compute_distance(tl), jf.compute_distance(jl), 1e-12)


@pytest.mark.parametrize("fk_name", ["fk", "fk_compact"])
def test_reference_stack_eval_matches_jax(fk_name):
    """``CostComposite(fk=chain.fk)`` and ``(fk=chain.fk_compact)``, carried
    over by ``convert``, against JAX ``eval`` on the same trajectories,
    float64, rtol 1e-10 (weights up to ~2e11 on the GP residuals)."""
    jc, jobs = _jax_reference_stack(jnp.float64, fk_name)
    tc = convert.cost_from_jax(jc, device="cpu")
    tobs = convert.observation_from_jax(jobs, device="cpu")
    assert tc.fk.__name__ == fk_name and not tc.supports_dof_planes()
    x = _trajs(12, 0.05, 3)
    _close(tc.eval(torch.from_numpy(x), observation=tobs),
           jc.eval(jnp.asarray(x), observation=jobs), 1e-10)
    # the children on the composite's link poses, one by one
    xt = torch.from_numpy(x)
    links = tc._fk_trajs(xt)
    jlinks = jc._fk_trajs(jnp.asarray(x))
    for c, j in zip(tc.costs, jc.costs):
        _close(c.eval(xt, x_trajs=links, observation=tobs),
               j.eval(jnp.asarray(x), x_trajs=jlinks, observation=jobs), 1e-10)


def test_reference_stack_equals_fast_stack_float32():
    """In float32 on the same trajectories, the reference-shaped stack
    (``fast=False``, ``fk=chain.fk_compact``), the same stack with
    ``FusedLinkFieldsCost`` in place of the two collisions, and the fast
    stack ``QuadraticCost + PlaneFieldsCost`` agree within rtol 2e-5 (the
    JAX package's own gate for the same identity,
    ``tests/test_fused_fields.py``)."""
    _, fast, st, obs, _ = build_panda_problem(device="cpu")
    _, ref, _, _, _ = build_panda_problem(device="cpu", fast=False)
    fused = CostComposite.create(D, T, [ref.costs[0], ref.costs[1],
                                        FusedLinkFieldsCost.create(D, T),
                                        ref.costs[4]], fk=ref.fk)
    x = torch.from_numpy(_trajs(16, 0.05, 4)).float()
    want = fast.eval(x, observation=obs).double()
    for cost in (ref, fused):
        _close(cost.eval(x, observation=obs).double(), want.numpy(), 2e-5)


@pytest.mark.parametrize("with_spheres", [True, False])
def test_fused_link_fields_plain_matches_jax(links, with_spheres):
    """K7's plain version against the JAX ``fused_link_fields_cost``
    (interpret mode) on ``fk_compact`` positions, including the strided
    ``[:, 1:]`` view, float32, rtol 2e-5 (float32 sums in another order)."""
    from stoch_gpmp_tpu.ops.pallas.panda_fields import fused_link_fields_cost as jk7

    pos = links["torch"]["compact"].positions.float()
    sph = torch.from_numpy(links["spheres"]).float() if with_spheres else None
    jsph = None if sph is None else jnp.asarray(sph.numpy())
    kw = dict(KW, w_obst=KW["w_obst"] if with_spheres else 0.0)
    for view in (pos, pos[:, 1:]):
        got = fused_link_fields_cost_plain(view, None if sph is None else sph.reshape(-1, 4), **kw)
        want = jk7(jnp.asarray(view.numpy()), jsph, **kw)
        assert got.shape == tuple(want.shape)
        _close(got, want, 2e-5)
        assert torch.equal(fused_link_fields_cost(view, sph, **kw), got)  # CPU: plain


def test_fused_link_fields_cost_matches_separate_collisions(links):
    """``FusedLinkFieldsCost`` equals ``CostCollision(LinkSelfDistanceField)
    + CostCollision(LinkDistanceField)`` on full poses and on ``fk_compact``,
    with and without spheres (float64, rtol 1e-12: the same terms); it
    raises without link poses."""
    x = torch.zeros((8, 5, 2 * D), dtype=torch.float64)
    obs = {"obstacle_spheres": torch.from_numpy(links["spheres"])}
    c_self = CostCollision.create(D, 5, LinkSelfDistanceField(margin=0.03), sigma_coll=0.01)
    c_coll = CostCollision.create(D, 5, LinkDistanceField(), sigma_coll=0.02)
    fused = FusedLinkFieldsCost.create(D, 5, margin=0.03, sigma_self=0.01, sigma_coll=0.02)
    for rep in ("full", "compact"):
        xl = links["torch"][rep]
        want = (c_self.eval(x, x_trajs=xl, observation=obs)
                + c_coll.eval(x, x_trajs=xl, observation=obs))
        _close(fused.eval(x, x_trajs=xl, observation=obs), want.numpy(), 1e-12)
        _close(fused.eval(x, x_trajs=xl), c_self.eval(x, x_trajs=xl).numpy(), 1e-12)
    with pytest.raises(ValueError, match="requires FK link poses"):
        fused.eval(x)


def test_fk_link_fields_plain_matches_jax(links):
    """K8's plain version against the JAX ``fk_link_fields_cost`` (interpret
    mode, N = 1000: not a multiple of its 8192-point block), float32, rtol
    2e-5, with and without spheres; and equal to K7's plain version on
    ``chain.fk_compact`` positions of the same ``q`` (float64, rtol 1e-12)."""
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda
    from stoch_gpmp_tpu.ops.pallas.panda_fields import fk_link_fields_cost as jk8

    chain = links["chain"]
    q = _q(1000, 5)
    sph = torch.from_numpy(links["spheres"])
    jchain = franka_panda(dtype=jnp.float32)
    for spheres in (sph, None):
        kw = dict(KW, w_obst=KW["w_obst"] if spheres is not None else 0.0)
        sp32 = None if spheres is None else spheres.float().reshape(-1, 4)
        got = fk_link_fields_cost_plain(chain, torch.from_numpy(q).float(), sp32, **kw)
        want = jk8(jchain, jnp.asarray(q, jnp.float32),
                   None if spheres is None else jnp.asarray(sp32.numpy()), **kw)
        assert got.shape == (1000,)
        _close(got, want, 2e-5)
        q64 = torch.from_numpy(q)
        sp64 = None if spheres is None else spheres.reshape(-1, 4)
        k8 = fk_link_fields_cost(chain, q64, spheres, **kw)  # CPU: plain
        assert torch.equal(k8, fk_link_fields_cost_plain(chain, q64, sp64, **kw))
        _close(k8, fused_link_fields_cost_plain(chain.fk_compact(q64).positions, sp64, **kw).numpy(),
               1e-12)
    # a strided view of q reads the same
    qw = torch.from_numpy(np.repeat(q[:50], 2, axis=1))[:, ::2]
    _close(fk_link_fields_cost_plain(chain, qw, sph.reshape(-1, 4), **KW),
           fk_link_fields_cost_plain(chain, qw.contiguous(), sph.reshape(-1, 4), **KW).numpy(), 0)


def test_convert_round_trips_reference_stack():
    """The reference stack carries over with its ``fk`` mapped to the same
    method of the converted chain, its fields and weights exactly; a
    ``FusedLinkFieldsCost`` and a ``LinkState`` too."""
    from stoch_gpmp_tpu.costs.fused_fields import FusedLinkFieldsCost as JFused
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda

    jc, _ = _jax_reference_stack(jnp.float64, "fk_compact")
    tc = convert.cost_from_jax(jc, device="cpu")
    assert [type(c).__name__ for c in tc.costs] == [type(c).__name__ for c in jc.costs]
    assert tc.fk.__self__.link_names == list(jc.fk.__self__.link_names)
    self_c, coll_c, goal_c = tc.costs[2:]
    assert self_c.field.margin == 0.03 and self_c.traj_range == (1, T)
    assert coll_c.field.field_type == "rbf" and coll_c.sigma_coll == 0.01
    assert goal_c.sigma_goal == 0.00007
    np.testing.assert_array_equal(goal_c.field.target_h.numpy(), np.asarray(jc.costs[4].field.target_h))
    f = convert.cost_from_jax(JFused(margin=0.04, sigma_self=0.02, sigma_coll=0.03), device="cpu")
    assert (f.margin, f.sigma_self, f.sigma_coll) == (0.04, 0.02, 0.03)
    ls = franka_panda(dtype=jnp.float64).fk_compact(jnp.asarray(_q(6, 7)))
    tls = convert.link_state_from_jax(ls, device="cpu")
    np.testing.assert_array_equal(tls.positions.numpy(), np.asarray(ls.positions))
    np.testing.assert_array_equal(tls.ee_rot.numpy(), np.asarray(ls.ee_rot))
    with pytest.raises(NotImplementedError, match="fk_compact"):
        convert._fk_from_jax(lambda q: q)


def test_link_kernel_wrappers_contract(links):
    """K7/K8 wrappers: CPU tensors take the plain versions and count no
    launch; another device raises."""
    chain = links["chain"]
    pos = links["torch"]["compact"].positions
    q = torch.from_numpy(links["q"]).reshape(-1, D)
    fused_link_fields_cost(pos, None, **KW)
    fk_link_fields_cost(chain, q, None, **KW)
    assert (fused_link_fields_cost.launches, fk_link_fields_cost.launches) == (0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_link_fields_cost(pos.to("meta"), None, **KW)
    with pytest.raises(ValueError, match="unsupported device"):
        fk_link_fields_cost(chain, q.to("meta"), None, **KW)

