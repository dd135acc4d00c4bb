"""The Panda planning pieces of the PyTorch port against the JAX package: the
SE(3) helpers and ``Frame``, the chain's joint limits, the gripper model,
IK (``pose_error``, ``solve_ik``, ``solve_ik_multistart`` with JAX's starts
injected), the obstacle spawn helper, and the mesh-sphere fields with their
Gauss-Newton terms through FK.

Everything runs in float64 on the CPU on inputs made with numpy from a seed.
Tolerance: rtol 1e-9 relative to the largest entry (only the summation
order differs), 1e-12 where no iteration compounds the rounding. The JAX
functions are jitted and each JAX problem is built once per module.
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
from stoch_gpmp_tpu_torch.kinematics import ik as tik  # noqa: E402
from stoch_gpmp_tpu_torch.kinematics import se3 as tse3  # noqa: E402

RTOL = 1e-9
EXACT = 1e-12
START_Q = np.array([0.012, -0.57, 0.0, -2.81, 0.0, 3.037, 0.741])


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _rotations(n, seed):
    from scipy.spatial.transform import Rotation

    return Rotation.random(n, random_state=np.random.default_rng(seed)).as_matrix()


# the 180-degree branch cases of tests/test_kinematics.py
def _flips():
    from scipy.spatial.transform import Rotation

    return np.stack([
        np.eye(3),
        Rotation.from_euler("x", np.pi).as_matrix(),
        Rotation.from_euler("y", np.pi).as_matrix(),
        Rotation.from_euler("z", np.pi).as_matrix(),
        Rotation.from_rotvec(np.pi * np.array([1, 1, 0]) / np.sqrt(2)).as_matrix(),
    ])


@pytest.fixture(scope="module")
def jchain():
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda

    return franka_panda(dtype=jnp.float64)


@pytest.fixture(scope="module")
def target():
    from stoch_gpmp_tpu.kinematics import Frame, y_rot, z_rot

    rot = z_rot(jnp.asarray(-np.pi)) @ y_rot(jnp.asarray(-np.pi))
    return np.asarray(Frame(rot=rot, trans=jnp.asarray([0.3, 0.3, 0.3])).get_transform_matrix())


def test_axis_angle_to_matrix_matches_jax():
    from stoch_gpmp_tpu.kinematics.se3 import axis_angle_to_matrix

    rng = np.random.default_rng(1)
    axes = rng.standard_normal((6, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = rng.uniform(-np.pi, np.pi, 6)
    want = jax.jit(axis_angle_to_matrix)(jnp.asarray(axes), jnp.asarray(angles))
    _close(tse3.axis_angle_to_matrix(_t(axes), _t(angles)), want, EXACT)
    _close(tse3.axis_angle_to_matrix(_t(axes[0]), 1.3),
           axis_angle_to_matrix(jnp.asarray(axes[0]), jnp.asarray(1.3)), EXACT)


@pytest.mark.parametrize("case", ["random", "flips"])
def test_quaternions_match_jax(case):
    """``matrix_to_quaternion`` (all four branches: the 180-degree flips take
    the diagonal-led ones) and ``quaternion_to_matrix``, batched."""
    from stoch_gpmp_tpu.kinematics.se3 import matrix_to_quaternion, quaternion_to_matrix

    mats = _rotations(16, 9) if case == "random" else _flips()
    jq = jax.jit(matrix_to_quaternion)(jnp.asarray(mats))
    tq = tse3.matrix_to_quaternion(_t(mats))
    _close(tq, jq, EXACT)
    _close(tse3.quaternion_to_matrix(tq), jax.jit(quaternion_to_matrix)(jq), EXACT)
    _close(tse3.quaternion_to_matrix(tq), mats, 1e-9)  # the round trip
    _close(tse3.matrix_to_quaternion(_t(mats[1])), matrix_to_quaternion(jnp.asarray(mats[1])),
           EXACT)


def test_frame_matches_jax():
    from stoch_gpmp_tpu.kinematics.se3 import Frame

    rots = _rotations(3, 4)
    trans = np.random.default_rng(4).normal(size=(3, 3))
    jf = Frame(rot=jnp.asarray(rots), trans=jnp.asarray(trans))
    tf = tse3.Frame(rot=_t(rots), trans=_t(trans))
    _close(tf.get_transform_matrix(), jf.get_transform_matrix(), EXACT)
    _close(tf.get_quaternion(), jf.get_quaternion(), EXACT)


@pytest.mark.parametrize("gripper", [False, True])
def test_panda_chain_matches_jax(gripper):
    """``franka_panda(dtype, gripper=)``: the 7-DOF arm and the 9-DOF
    gripper (two prismatic fingers), FK of every link and the joint limits
    against JAX's in float64, the port's own model and the converted one;
    ``DifferentiableFrankaPanda`` likewise."""
    from stoch_gpmp_tpu.kinematics.panda_model import DifferentiableFrankaPanda as JD
    from stoch_gpmp_tpu.kinematics.panda_model import franka_panda as jfp

    from stoch_gpmp_tpu_torch.kinematics import DifferentiableFrankaPanda, franka_panda

    jc = jfp(jnp.float64, gripper=gripper)
    tc = franka_panda(torch.float64, gripper=gripper)
    assert tc.n_dofs == jc.n_dofs == (9 if gripper else 7)
    assert tc.link_names == jc.link_names and tc.limits_lower.dtype == torch.float64
    q = np.random.default_rng(7).uniform(-1.5, 1.5, (4, 3, jc.n_dofs))
    if gripper:
        q[..., 7:] = np.random.default_rng(8).uniform(0.0, 0.04, (4, 3, 2))
    want = jax.jit(jc.fk)(jnp.asarray(q))
    for chain in (tc, convert.chain_from_jax(jc)):
        _close(chain.fk(_t(q)), want, EXACT)
        for name in ("limits_lower", "limits_upper", "limits_velocity"):
            _close(getattr(chain, name), getattr(jc, name), 0.0)
    jd, td = JD(gripper=gripper, dtype=jnp.float64), DifferentiableFrankaPanda(
        gripper=gripper, dtype=torch.float64)
    assert td.get_link_names() == jd.get_link_names()
    _close(td.compute_forward_kinematics_all_links(_t(q[0])),
           jd.compute_forward_kinematics_all_links(jnp.asarray(q[0])), EXACT)


def test_pose_error_matches_jax(jchain, target):
    """The 6D error (translation and SO(3) log map), near and at a
    180-degree flip too (the clamps)."""
    from stoch_gpmp_tpu.kinematics.ik import pose_error

    q = np.random.default_rng(3).uniform(-1.5, 1.5, (5, 7))
    h = np.asarray(jchain.ee_pose(jnp.asarray(q)))
    flip = h[0].copy()
    flip[:3, :3] = h[0, :3, :3] @ _flips()[3]  # theta = pi about z
    near = h[0].copy()
    near[:3, :3] = h[0, :3, :3] @ tse3.z_rot(torch.tensor(np.pi - 1e-4)).numpy()
    hs = np.concatenate([h, flip[None], near[None]])
    want = jax.jit(pose_error)(jnp.asarray(hs), jnp.asarray(target))
    _close(tik.pose_error(_t(hs), _t(target)), want, EXACT)


def test_solve_ik_from_fixed_starts_matches_jax(jchain, target):
    """``solve_ik`` from three fixed starts, 20 iterations: the port's batch
    against JAX's ``vmap``, and one start alone."""
    from stoch_gpmp_tpu.kinematics.ik import solve_ik

    starts = START_Q + np.random.default_rng(5).uniform(-0.5, 0.5, (3, 7))
    want = jax.jit(jax.vmap(lambda q: solve_ik(jchain, jnp.asarray(target), q,
                                               num_iters=20)))(jnp.asarray(starts))
    tc = convert.chain_from_jax(jchain)
    _close(tik.solve_ik(tc, _t(target), _t(starts), num_iters=20), want)
    _close(tik.solve_ik(tc, _t(target), _t(starts[1]), num_iters=20), want[1])


@pytest.mark.parametrize("with_q_init", [True, False])
def test_solve_ik_multistart_with_jax_starts(jchain, target, with_q_init):
    """``solve_ik_multistart`` with JAX's uniform draw injected returns JAX's
    configuration: the argmin, or with ``q_init`` the near-best rule (the
    solution within 0.05 of the best that is closest to ``q_init``)."""
    from stoch_gpmp_tpu.kinematics.ik import solve_ik_multistart

    key = jax.random.PRNGKey(3)
    kw = dict(num_starts=8, num_iters=40)
    q_init = jnp.asarray(START_Q) if with_q_init else None
    want = jax.jit(lambda k: solve_ik_multistart(jchain, jnp.asarray(target), k, q_init=q_init,
                                                 **kw))(key)
    uniform = np.asarray(jax.random.uniform(key, (8, 7), dtype=jnp.float64))
    got = tik.solve_ik_multistart(
        convert.chain_from_jax(jchain), _t(target), None,
        q_init=_t(START_Q) if with_q_init else None, starts=_t(uniform), **kw)
    _close(got, want)


def test_solve_ik_multistart_draws_from_the_generator(target):
    """Without ``starts`` the draw comes from the generator: the same seed
    gives the same configuration, in the chain's dtype."""
    from stoch_gpmp_tpu_torch.kinematics import franka_panda

    chain = franka_panda(torch.float64)
    solve = lambda: tik.solve_ik_multistart(  # noqa: E731
        chain, _t(target), torch.Generator().manual_seed(2), num_starts=4, num_iters=20)
    a, b = solve(), solve()
    assert a.dtype == torch.float64 and torch.equal(a, b)


def test_solve_ik_multistart_draws_on_the_target_device(monkeypatch):
    """Without ``q_init``, ``starts`` and a generator, the uniform draw is
    made on ``target_h``'s device in its dtype (a target on the card keeps
    the solve there): a target on ``"meta"``, ``torch.rand`` spied."""
    from stoch_gpmp_tpu_torch.kinematics import franka_panda

    class Drawn(Exception):
        pass

    seen = []

    def spy(*args, **kw):
        seen.append((kw.get("device"), kw.get("dtype"), kw.get("generator")))
        raise Drawn

    monkeypatch.setattr(torch, "rand", spy)
    target = torch.eye(4, dtype=torch.float64, device="meta")
    with pytest.raises(Drawn):
        tik.solve_ik_multistart(franka_panda(torch.float32), target, num_starts=4)
    assert seen == [(torch.device("meta"), torch.float64, None)]


def test_solve_ik_multistart_follows_the_target_and_refuses_a_foreign_generator(target):
    """On the CPU the solution takes the target's dtype, not the chain's; a
    generator on another device than the target's raises."""
    from stoch_gpmp_tpu_torch.kinematics import franka_panda

    chain = franka_panda(torch.float64)
    got = tik.solve_ik_multistart(chain, _t(target).float(), num_starts=2, num_iters=3)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    with pytest.raises(ValueError, match="generator"):
        tik.solve_ik_multistart(chain, _t(target).to("meta"), torch.Generator(), num_starts=2)


def test_random_init_static_sphere_matches_jax():
    """The same ``default_rng`` seed gives JAX's radii and positions; the
    port refuses a missing generator."""
    from stoch_gpmp_tpu.envs.panda_env import random_init_static_sphere as jspawn

    from stoch_gpmp_tpu_torch.envs import random_init_static_sphere

    lo, hi = np.array([0.6, -0.2, 0.6]), np.array([1.0, 0.2, 1.0])
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(12):
        (js, jp), (ts, tp) = jspawn(0.1, 0.2, lo, hi, 0.01, rng=jr), \
            random_init_static_sphere(0.1, 0.2, lo, hi, 0.01, rng=tr)
        assert js == ts and np.array_equal(jp, tp)
    with pytest.raises(TypeError, match="explicit"):
        random_init_static_sphere(0.1, 0.2, lo, hi, 0.01)


@pytest.fixture(scope="module")
def mesh_case(jchain):
    from stoch_gpmp_tpu.costs import MeshSphereDistanceField, MeshSphereFloorField

    jm = MeshSphereDistanceField.for_panda(jchain, dtype=jnp.float64)
    q = np.random.default_rng(0).uniform(-1.5, 1.5, (4, 3, 7))
    spheres = np.array([[[0.5, 0.0, 0.5, 0.15], [0.2, 0.3, 0.8, 0.1]]])
    return jm, MeshSphereFloorField(mesh=jm), q, spheres


def test_mesh_fields_match_jax(jchain, mesh_case):
    """``MeshSphereDistanceField`` (``for_panda``, ``world_spheres``,
    ``compute_cost``, ``compute_collision`` at two buffers, the obstacle-free
    branch) and ``MeshSphereFloorField``, built natively and converted."""
    from stoch_gpmp_tpu_torch.costs import MeshSphereDistanceField, MeshSphereFloorField
    from stoch_gpmp_tpu_torch.kinematics.panda_collision import PANDA_COLLISION_SPHERES

    jm, jf, q, spheres = mesh_case
    tc = convert.chain_from_jax(jchain)
    native = MeshSphereDistanceField.for_panda(tc, dtype=torch.float64)
    assert native.link_indices == jm.link_indices
    assert sum(len(r) for r in native.radii) == 82 and len(PANDA_COLLISION_SPHERES) == 9
    jl, tl = jchain.fk(jnp.asarray(q)), tc.fk(_t(q))
    sp = jnp.asarray(spheres)
    want = jax.jit(lambda lt, s: (jm.world_spheres(lt), jm.compute_cost(lt, s), jf.compute_cost(lt),
                                  jm.compute_collision(lt, s), jm.compute_collision(lt, s, 0.1),
                                  jm.compute_cost(lt)))(jl, sp)
    (wc, wr), cost, floor, hit0, hit1, free = want
    assert 0 < int(np.asarray(hit0).sum()) < int(np.asarray(hit1).sum()) < hit1.size
    for field in (native, convert._field_from_jax(jm, torch.float64, "cpu")):
        cw, rw = field.world_spheres(tl)
        _close(cw, wc, EXACT)
        _close(rw, wr, 0.0)
        _close(field.compute_cost(tl, _t(spheres)), cost, EXACT)
        _close(MeshSphereFloorField(mesh=field).compute_cost(tl), floor, EXACT)
        assert np.array_equal(field.compute_collision(tl, _t(spheres)).numpy(), np.asarray(hit0))
        assert np.array_equal(field.compute_collision(tl, _t(spheres), 0.1).numpy(),
                              np.asarray(hit1))
        _close(field.compute_cost(tl), free, 0.0)
    converted = convert._field_from_jax(jf, torch.float64, "cpu")
    _close(converted.compute_cost(tl), floor, EXACT)
    assert not field.compute_collision(tl).any()


def test_mesh_field_refuses_a_link_state(mesh_case):
    """The mesh spheres need every link's rotation: a ``LinkState`` is
    refused, except by the obstacle-free branch."""
    from stoch_gpmp_tpu_torch.costs import MeshSphereDistanceField
    from stoch_gpmp_tpu_torch.kinematics import franka_panda

    chain = franka_panda(torch.float64)
    field = MeshSphereDistanceField.for_panda(chain, dtype=torch.float64)
    links = chain.fk_compact(_t(mesh_case[2]))
    assert torch.equal(field.compute_cost(links), torch.zeros(4, 3, dtype=torch.float64))
    with pytest.raises(TypeError, match="LinkState"):
        field.compute_cost(links, _t(mesh_case[3]))


@pytest.mark.parametrize("which", ["mesh", "floor"])
def test_mesh_field_gn_terms_through_fk_match_jax(jchain, mesh_case, which):
    """``CostCollision`` of each mesh field in a composite with
    ``fk=chain.fk``: ``gn_rank1`` (``torch.autograd`` through FK against
    ``jax.grad``) and the composite's ``gn_contrib``, at poses where no mesh
    sphere touches an obstacle (the ``max(d - r, 0)`` hinge is smooth
    there)."""
    from stoch_gpmp_tpu.costs import CostCollision, CostComposite, CostGP

    jm, jf, _, spheres = mesh_case
    n, t = 7, 6
    start = jnp.concatenate([jnp.asarray(START_Q), jnp.zeros(7)])
    field = jm if which == "mesh" else jf
    jc = CostComposite.create(n, t, [
        CostGP.create(n, t, start, 0.05, {"sigma_start": 0.001, "sigma_gp": 0.1},
                      dtype=jnp.float64),
        CostCollision.create(n, t, field, sigma_coll=0.1),
    ], fk=jchain.fk)
    means = np.asarray(start)[None, None] + 0.05 * np.random.default_rng(6).normal(size=(2, t, 14))
    obs = {"obstacle_spheres": jnp.asarray(spheres)}
    cw, rw = jm.world_spheres(jchain.fk(jnp.asarray(means[..., :n])))
    gap = (np.linalg.norm(np.asarray(cw)[..., :, None, :] - spheres[0, :, :3], axis=-1)
           - np.asarray(rw)[:, None])
    assert gap.min() > 0.0  # no sphere centre inside an obstacle's hinge
    jm_ = jnp.asarray(means)
    jh, je, jk = jax.jit(lambda m, o: jc.costs[1].gn_rank1(
        m, x_trajs=jc._fk_trajs(m), observation=o, fk_trajs=jc._fk_trajs))(jm_, obs)
    tc = convert.cost_from_jax(jc, device="cpu")
    tobs = convert.observation_from_jax(obs, device="cpu")
    tm = _t(means)
    h, e, k = tc.costs[1].gn_rank1(tm, x_trajs=tc._fk_trajs(tm), observation=tobs,
                                   fk_trajs=tc._fk_trajs)
    assert k == jk and bool(h.abs().max() > 0)
    _close(h, jh)
    _close(e, je)
    want = jax.jit(lambda m, o: jc.gn_contrib(m, observation=o))(jm_, obs)
    got = tc.gn_contrib(tm, observation=tobs)
    for name in ("diag", "lower", "g"):
        _close(getattr(got, name), getattr(want, name))
