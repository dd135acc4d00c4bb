"""The port's simulator (``envs/objects.py``, ``envs/panda_env.py``)
against the JAX package's, on the CPU.

Both packages draw their spheres from ``np.random.default_rng`` and keep
their bookkeeping in numpy, so seeded resets are equal and the bounce
helpers equal to the last bit; FK, the contact fields, the deflection
Jacobian and the dynamics run in float64 in both (JAX with the x64 of
``tests/conftest.py``). Episodes drive an arm into an obstacle sphere
placed under its hand (deflected on a run of steps) and out, and their joint states,
costs, flags, contact verdicts and ring buffers agree within 1e-12 in
kinematic mode and 1e-9 through the dynamics (RNEA, Cholesky against
JAX's LU, over hundreds of substeps). Each JAX episode runs once per
module.
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

from stoch_gpmp_tpu.envs import objects as jobj  # noqa: E402
from stoch_gpmp_tpu.envs import panda_env as jenv  # noqa: E402
from stoch_gpmp_tpu_torch.envs import objects as tobj  # noqa: E402
from stoch_gpmp_tpu_torch.envs import panda_env as tenv  # noqa: E402

KIN_TOL, DYN_TOL = 1e-12, 1e-9


def _jax_env(**kw):
    return jenv.PandaEnv(**kw)


def _port_env(**kw):
    return tenv.PandaEnv(device="cpu", **kw)


def _drive(make, physics="kinematic", motion=0, steps=60):
    """A seeded episode: 3 spheres, sphere 0 moved under the hand, two goals
    (the first reached at once), targets drifting the arm down into the
    sphere for 20 steps and back out. Returns the per-step records and the
    environment."""
    env = make(num_obst=3, seed=2, physics=physics, motion_obstacles=motion)
    env.reset()
    ee, _ = env.panda.getEEPositionAndOrientation()
    sphere = env.spheres[0]
    sphere.base_position, sphere.scale = ee + np.array([0.05, 0.0, -0.12]), 0.06
    env.set_goals([ee + np.array([0.0, 0.0, -0.05]), ee + np.array([0.3, 0.0, 0.0])])
    rng = np.random.default_rng(5)
    drift = np.array([0.0, 0.02, 0.0, -0.03, 0.0, 0.02, 0.0])
    rows = []
    for t in range(steps):
        a_t = env.panda.q + (drift if t < 20 else -drift) + rng.uniform(-0.05, 0.05, 7)
        s_t, cost, done, info = env.step(a_t)
        rows.append(dict(s_robot=s_t[0].copy(), s_obs=s_t[1].copy(), cost=float(cost),
                         done=bool(done), goal=None if info[0] is None else info[0].copy(),
                         reached=list(info[1]), contact=bool(info[2]),
                         verdicts=dict(env.contact_verdicts), dq=env.panda.dq.copy()))
    return rows, env


def _compare_rows(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("done", "reached", "contact", "verdicts"):
            assert g[k] == w[k], k
        for k in ("s_robot", "s_obs", "goal", "dq"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol, err_msg=k)
        np.testing.assert_allclose(g["cost"], w["cost"], rtol=tol, err_msg="cost")


def _compare_buffers(genv, wenv, tol):
    assert genv._buffer_idx == wenv._buffer_idx and len(genv.buffer) == len(wenv.buffer)
    for g, w in zip(genv.buffer, wenv.buffer):
        assert g.keys() == w.keys()
        for k in ("is_contact", "goal_reached", "time_horizon", "time"):
            assert g[k] == w[k], k
        for k in ("s_robot", "a_robot", "s_obs", "s_goal"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol, err_msg=k)


@pytest.fixture(scope="module", params=[("kinematic", 0), ("dynamics", 0), ("kinematic", 2)],
                ids=["kinematic", "dynamics", "motion2"])
def episodes(request):
    physics, motion = request.param
    return physics, _drive(_jax_env, physics, motion), _drive(_port_env, physics, motion)


def test_episode_matches_jax(episodes):
    """60 steps: joint states, sphere states, costs, done, info, contact
    verdicts and velocities after every step."""
    physics, (want, _), (got, _) = episodes
    _compare_rows(got, want, KIN_TOL if physics == "kinematic" else DYN_TOL)


def test_episode_ring_buffer_matches_jax(episodes):
    physics, (_, wenv), (_, genv) = episodes
    _compare_buffers(genv, wenv, KIN_TOL if physics == "kinematic" else DYN_TOL)


def test_episode_exercises_contact_and_motion(episodes):
    """The scenario is not vacuous: the first goal is reached, static-sphere
    episodes are in contact (deflected) on a run of steps and leave it, and
    motion_obstacles=2 moves a sphere."""
    physics, _, (got, genv) = episodes
    assert got[0]["reached"][0]
    if genv.motion_obstacles:
        assert any(not np.array_equal(r["s_obs"], got[0]["s_obs"]) for r in got)
    else:
        assert 8 <= sum(r["contact"] for r in got) and not got[-1]["contact"]


@pytest.mark.parametrize("location", [0, 1, 2, 3])
@pytest.mark.parametrize("order", [0, 1])
def test_bounce_helpers_bit_for_bit(location, order):
    rng = np.random.default_rng(10 * location + order)
    for _ in range(200):
        pos = rng.uniform(-1.0, 1.0, 3) * np.array([0.8, 0.5, 0.6])
        vel = rng.uniform(-0.1, 0.1, 3)
        scale = rng.uniform(0.08, 0.1)
        args = (scale, pos, vel, jenv._SPHERE_MIN, jenv._SPHERE_MAX, [location, order])
        for w, g in zip(jenv.update_linear_velocity_sphere_simple(*args),
                        tenv.update_linear_velocity_sphere_simple(*args)):
            assert np.array_equal(w, g)
        args = (pos, vel, jenv._SPHERE_MIN, jenv._SPHERE_MAX, 0.05)
        for w, g in zip(jenv.update_linear_velocity_sphere(*args),
                        tenv.update_linear_velocity_sphere(*args)):
            assert np.array_equal(w, g)


@pytest.mark.parametrize("motion", [0, 1, 2])
def test_reset_states_equal_jax(motion):
    for seed in (0, 3, 11):
        want = _jax_env(num_obst=4, seed=seed, motion_obstacles=motion).reset()
        got = _port_env(num_obst=4, seed=seed, motion_obstacles=motion).reset()
        for w, g in zip(want, got):
            assert np.array_equal(w, g)


def _deflection_case(make, deflect):
    """``tests/test_panda_env.py``'s terminal deflection: a sphere under
    the hand, the arm commanded into it for one step."""
    env = make(num_obst=1, seed=0, contact_deflection=deflect)
    env.reset()
    ee, _ = env.panda.getEEPositionAndOrientation()
    env.spheres[0].base_position = ee + np.array([0.0, 0.0, -0.06])
    env.spheres[0].scale = 0.08
    env.set_goals([ee + np.array([1.0, 0, 0]), None])
    q_cmd = env.panda.q.copy()
    q_cmd[3] -= 0.3
    _, cost, done, _ = env.step(q_cmd)
    return env, float(cost), bool(done)


def _floor_case(make):
    env = make(num_obst=0, seed=0)
    env.reset()
    env.set_goals([np.array([1.0, 0, 0]), None])
    q_cmd = env.panda.q.copy()
    q_cmd[1], q_cmd[3] = 1.6, -2.2  # lean the whole arm down through the floor
    qs = []
    for _ in range(120):
        _, _, done, _ = env.step(q_cmd)
        qs.append(env.panda.q.copy())
        if done:
            break
    return env, np.stack(qs)


def _no_contact_case(make, deflect):
    env = make(num_obst=0, seed=3, contact_deflection=deflect)
    env.reset()
    env.set_goals([np.array([0.4, 0.1, 0.5]), None])
    for _ in range(5):
        env.step(env.panda.q + 0.01)
    return env


def test_deflection_on_a_sphere_matches_jax():
    for deflect in (False, True):
        (wenv, wcost, wdone), (genv, gcost, gdone) = (_deflection_case(m, deflect)
                                                      for m in (_jax_env, _port_env))
        np.testing.assert_allclose(genv.panda.q, wenv.panda.q, rtol=0, atol=DYN_TOL)
        np.testing.assert_allclose(genv.panda.dq, wenv.panda.dq, rtol=0, atol=DYN_TOL)
        assert (gcost, gdone, genv.is_contact) == (wcost, wdone, wenv.is_contact) == (1e2, True,
                                                                                      True)
        assert genv.contact_verdicts == wenv.contact_verdicts
        if deflect:
            q_on = genv.panda.q
        else:
            q_off = genv.panda.q
    assert not np.allclose(q_on, q_off, atol=1e-6)  # the deflection moved the record


def test_deflection_on_the_floor_matches_jax():
    (wenv, wq), (genv, gq) = _floor_case(_jax_env), _floor_case(_port_env)
    assert gq.shape == wq.shape and genv.is_contact and wenv.is_contact
    np.testing.assert_allclose(gq, wq, rtol=0, atol=DYN_TOL)
    np.testing.assert_allclose(genv.panda.dq, wenv.panda.dq, rtol=0, atol=DYN_TOL)


def test_deflection_without_contact_is_a_no_op():
    on, off = _no_contact_case(_port_env, True), _no_contact_case(_port_env, False)
    np.testing.assert_array_equal(on.panda.q, off.panda.q)
    np.testing.assert_array_equal(on.panda.dq, off.panda.dq)
    want = _no_contact_case(_jax_env, True)
    np.testing.assert_allclose(on.panda.q, want.panda.q, rtol=0, atol=DYN_TOL)
    assert not on.is_contact and not want.is_contact


def test_dynamic_sphere_push_out_matches_jax():
    """A dynamic sphere inside the arm's volume is pushed out along the
    contact normal with its approach velocity removed, as in JAX; a static
    one is left alone."""
    out = []
    for make in (_jax_env, _port_env):
        env = make(num_obst=1, seed=0)
        cw, _, _ = env._world_collision_spheres(env.panda.link_poses())
        s = env.spheres[0]
        s.scale = 0.05
        inside = cw[len(cw) // 2] + np.array([0.0, 0.0, 1e-3])
        s.base_position, s.base_linear_velocity = inside.copy(), np.array([0.0, 0.0, -0.5])
        s.role = 0
        env._resolve_obstacle_contacts()
        assert np.array_equal(s.base_position, inside)
        s.role = 1
        env._resolve_obstacle_contacts()
        out.append((s.base_position.copy(), s.base_linear_velocity.copy()))
    (wp, wv), (gp, gv) = out
    assert not np.allclose(gp, inside)
    np.testing.assert_allclose(gp, wp, rtol=0, atol=KIN_TOL)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=KIN_TOL)


def _torque_and_gear(mod, **kw):
    """Torque mode on the 7-DOF arm (gravity compensation holds it, zero
    torque lets it fall) and the 9-DOF finger gear (one finger pushed,
    both move; kinematic tracking keeps them symmetric)."""
    out = []
    panda = mod.Panda(**kw)
    tau = panda.solveInverseDynamics(panda.q, np.zeros(7), np.zeros(7))
    out.append(np.asarray(tau))
    panda.setTargetTorques(np.asarray(tau))
    for _ in range(10):
        panda.step(1.0 / 240.0)
    out += [panda.q.copy(), panda.dq.copy()]
    panda.reset()
    panda.setTargetTorques(np.zeros(7))
    for _ in range(20):
        panda.step(1.0 / 240.0)
    out += [panda.q.copy(), panda.dq.copy()]

    grip = mod.Panda(gripper=True, use_dynamics=True, **kw)
    tau = np.zeros(9)
    tau[:7] = np.asarray(grip.solveInverseDynamics(grip.q, grip.dq, np.zeros(9)))[:7]
    tau[7] = -3.0
    grip.setTargetTorques(tau)
    for _ in range(120):
        grip.step(1.0 / 240.0)
    out += [grip.q.copy(), grip.dq.copy()]

    kin = mod.Panda(gripper=True, **kw)
    target = kin.q.copy()
    target[7], target[8] = 0.0, 0.04
    kin.setTargetPositions(target)
    for _ in range(240):
        kin.step(1.0 / 240.0)
    out.append(kin.q.copy())
    return out


def test_torque_mode_and_finger_gear_match_jax():
    want, got = _torque_and_gear(jobj), _torque_and_gear(tobj, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=DYN_TOL)
    held, fallen, fingers, kin = got[1], got[3], got[5], got[-1]
    assert np.abs(held - tobj.Panda.HOME).max() < 1e-4 < np.abs(fallen - tobj.Panda.HOME).max()
    assert fingers[7] < 0.035 and abs(fingers[7] - fingers[8]) < 5e-3
    assert abs(kin[7] - kin[8]) < 1e-9


def test_inverse_dynamics_and_kinematics_match_jax():
    """``solveInverseDynamics`` on a batch, ``solveInverseKinematics`` with
    JAX's uniform draw injected as the starts, and the end-effector pose."""
    jp, tp = jobj.Panda(), tobj.Panda(device="cpu")
    rng = np.random.default_rng(4)
    pos, vel, acc = (rng.uniform(-1.0, 1.0, (3, 7)) for _ in range(3))
    np.testing.assert_allclose(np.stack(tp.solveInverseDynamics(pos, vel, acc)),
                               np.stack(jp.solveInverseDynamics(pos, vel, acc)),
                               rtol=1e-10, atol=1e-12)
    starts = np.array(jax.random.uniform(jax.random.PRNGKey(5), (16, 7), dtype=jnp.float64))
    ori = np.array([1.0, 0.0, 0.0, 0.0])
    want = jp.solveInverseKinematics([0.4, 0.2, 0.4], ori, seed=5)
    got = tp.solveInverseKinematics([0.4, 0.2, 0.4], ori, seed=5, starts=starts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    pos, quat = tp.getEEPositionAndOrientation()
    wpos, wquat = jp.getEEPositionAndOrientation()
    np.testing.assert_allclose(pos, wpos, rtol=0, atol=KIN_TOL)
    np.testing.assert_allclose(quat, wquat, rtol=0, atol=KIN_TOL)


def test_render_frames_match_jax(tmp_path):
    """``render=True`` frames (skeleton, spheres, goal, flags) equal JAX's;
    the port writes the episode GIF and refuses to draw without frames."""
    import matplotlib

    matplotlib.use("Agg")
    envs = []
    for make in (_jax_env, _port_env):
        env = make(num_obst=2, seed=4, render=True)
        env.reset()
        env.set_goals([np.array([0.4, 0.2, 0.5]), None])
        for _ in range(3):
            env.step(env.panda.q + 0.02)
        envs.append(env)
    wenv, genv = envs
    assert len(genv.frames) == len(wenv.frames) == 4
    for g, w in zip(genv.frames, wenv.frames):
        np.testing.assert_allclose(g["skeleton"], w["skeleton"], rtol=0, atol=KIN_TOL)
        np.testing.assert_array_equal(g["goal"], w["goal"])
        assert [(p.tolist(), r, o) for p, r, o in g["spheres"]] == \
            [(p.tolist(), r, o) for p, r, o in w["spheres"]]
        assert (g["t"], g["contact"], g["reached"]) == (w["t"], w["contact"], w["reached"])
    out = genv.save_animation(tmp_path / "ep.gif", fps=5)
    assert out.exists() and out.stat().st_size > 0
    bare = _port_env(num_obst=1, seed=4)
    bare.reset()
    bare.step()
    assert bare.frames == []
    with pytest.raises(ValueError, match="render=True"):
        bare.render_frame()


def test_live_render_headless():
    import matplotlib

    matplotlib.use("Agg")
    env = _port_env(num_obst=1, seed=0, render="live", live_render_every=2)
    env.reset()
    env.set_goals([np.array([0.4, 0.1, 0.5]), None])
    for _ in range(4):
        env.step(env.panda.q + 0.01)
    assert len(env.frames) == 5 and env._live_ax is not None


def test_default_device_is_the_card():
    """``Panda`` and ``PandaEnv`` resolve ``device=None`` to the card: on a
    host without one they raise instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tobj.Panda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenv.PandaEnv()
