"""The port's rigid-body dynamics (``kinematics/dynamics.py``, the Panda's
inertials, the URDF ``<inertial>`` parser) against the JAX package's, and
against an independent float64 oracle.

The oracle is the Euler-Lagrange equation evaluated by FK and autodiff
alone (``torch.func``): kinetic energy from COM velocities (``jvp`` of the
COM positions) and body angular velocities (``jvp`` of the world
rotations), potential energy from COM heights; no Newton-Euler recursion
is shared with the code under test beyond the per-joint frames. Inputs are
seeded numpy draws; the JAX side runs with x64 (``tests/conftest.py``).
Tolerances: rtol 1e-10 against JAX in float64 (atol 1e-12 for entries
that are zero up to roundoff), rtol 1e-4 in float32 (atol 1e-4 times the
largest entry); the oracle's rtol 1e-9 / atol 1e-10 are the JAX package's
own (``tests/test_dynamics.py``).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jvp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stoch_gpmp_tpu.kinematics import panda_model as jpm  # noqa: E402
from stoch_gpmp_tpu.kinematics import urdf as jurdf  # noqa: E402
from stoch_gpmp_tpu.kinematics.dynamics import ChainDynamics as JDyn  # noqa: E402
from stoch_gpmp_tpu_torch.kinematics import panda_model as tpm  # noqa: E402
from stoch_gpmp_tpu_torch.kinematics import urdf as turdf  # noqa: E402
from stoch_gpmp_tpu_torch.kinematics.dynamics import ChainDynamics  # noqa: E402

GRAVITY = (0.0, 0.0, -9.81)
TOL = {"float64": (1e-10, 1e-12), "float32": (1e-4, 1e-4)}
METHODS = ("rnea", "mass_matrix", "bias_forces", "gravity_torques", "forward_dynamics",
           "com_positions", "link_world_rotations", "kinetic_energy", "potential_energy")


def _pair(gripper: bool, dtype: str):
    """The JAX and the port's Panda dynamics in ``dtype``."""
    return (jpm.panda_dynamics(gripper=gripper, dtype=getattr(jnp, dtype)),
            tpm.panda_dynamics(gripper=gripper, dtype=getattr(torch, dtype), device="cpu"))


def _args(method: str, q, qd, qdd):
    return {"rnea": (q, qd, qdd), "bias_forces": (q, qd), "forward_dynamics": (q, qd, qdd),
            "kinetic_energy": (q, qd)}.get(method, (q,))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("gripper", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_dynamics_match_jax(method, gripper, dtype):
    """Every public method on a ``[4, 3, n]`` batch: the port's one-pass
    mass matrix against JAX's ``n`` passes, and the rest, equal within the
    dtype's tolerance."""
    jd, td = _pair(gripper, dtype)
    n = jd.n_dofs
    rng = np.random.default_rng(11 + n)
    q, qd, qdd = (rng.uniform(-1.5, 1.5, (4, 3, n)).astype(dtype) for _ in range(3))
    want = np.asarray(getattr(jd, method)(*_args(method, *(jnp.asarray(x) for x in (q, qd, qdd)))))
    got = getattr(td, method)(*_args(method, *(torch.from_numpy(x) for x in (q, qd, qdd))))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    rtol, atol = TOL[dtype]
    if dtype == "float32":
        atol *= np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("gripper", [False, True])
def test_mass_and_bias_is_mass_matrix_and_bias_forces(gripper):
    """The one pass that feeds the steppers equals ``mass_matrix`` and
    ``bias_forces`` (the same arithmetic on other rows: to the last bit)."""
    td = tpm.panda_dynamics(gripper=gripper, device="cpu")
    rng = np.random.default_rng(3)
    q, qd = (torch.from_numpy(rng.uniform(-1.5, 1.5, (5, td.n_dofs))) for _ in range(2))
    m, h = td.mass_and_bias(q, qd)
    assert torch.equal(m, td.mass_matrix(q))
    np.testing.assert_allclose(h.numpy(), td.bias_forces(q, qd).numpy(), rtol=0, atol=1e-13)


def _lagrangian_tau(dyn: ChainDynamics, q, qd, qdd):
    """tau = d/dt(dL/dqd) - dL/dq by autodiff on FK quantities only."""
    masses = torch.from_numpy(dyn._mass)
    inertias = torch.from_numpy(dyn._inertia)

    def kinetic(q, qd):
        v = jvp(dyn.com_positions, (q,), (qd,))[1]
        t_lin = 0.5 * torch.einsum("l,lc,lc->", masses, v, v)
        r = dyn.link_world_rotations(q)
        dr = jvp(dyn.link_world_rotations, (q,), (qd,))[1]
        w_hat = torch.einsum("lij,lkj->lik", dr, r)  # omega_hat in the world frame
        w_world = torch.stack([w_hat[:, 2, 1], w_hat[:, 0, 2], w_hat[:, 1, 0]], -1)
        w_link = torch.einsum("lji,lj->li", r, w_world)
        return t_lin + 0.5 * torch.einsum("li,lij,lj->", w_link, inertias, w_link)

    def lagrangian(q, qd):
        return kinetic(q, qd) - dyn.potential_energy(q, gravity=GRAVITY)

    dp = jvp(grad(lagrangian, argnums=1), (q, qd), (qd, qdd))[1]
    return dp - grad(lagrangian, argnums=0)(q, qd)


@pytest.mark.parametrize("gripper", [False, True])
def test_rnea_matches_lagrangian_oracle(gripper):
    dyn = tpm.panda_dynamics(gripper=gripper, device="cpu")
    n = dyn.n_dofs
    assert n == (9 if gripper else 7)
    rng = np.random.default_rng(1)
    for _ in range(5):
        q, qd, qdd = (torch.from_numpy(rng.uniform(lo, hi, n))
                      for lo, hi in ((-1.5, 1.5), (-1.0, 1.0), (-2.0, 2.0)))
        np.testing.assert_allclose(dyn.rnea(q, qd, qdd, gravity=GRAVITY).numpy(),
                                   _lagrangian_tau(dyn, q, qd, qdd).numpy(),
                                   rtol=1e-9, atol=1e-10)


def test_power_balance():
    """tau . qd == d/dt (T + V) along any (q, qd, qdd)."""
    dyn = tpm.panda_dynamics(device="cpu")
    rng = np.random.default_rng(2)
    q, qd, qdd = (torch.from_numpy(rng.uniform(lo, hi, 7))
                  for lo, hi in ((-1.5, 1.5), (-1.0, 1.0), (-2.0, 2.0)))

    def energy(q, qd):
        return dyn.kinetic_energy(q, qd) + dyn.potential_energy(q, gravity=GRAVITY)

    de = jvp(energy, (q, qd), (qd, qdd))[1]
    power = torch.sum(dyn.rnea(q, qd, qdd, gravity=GRAVITY) * qd)
    np.testing.assert_allclose(float(power), float(de), rtol=1e-9)


@pytest.mark.parametrize("gripper", [False, True])
def test_mass_matrix_symmetric_positive_definite(gripper):
    dyn = tpm.panda_dynamics(gripper=gripper, device="cpu")
    rng = np.random.default_rng(3)
    m = dyn.mass_matrix(rng.uniform(-1.5, 1.5, (4, 3, dyn.n_dofs)))
    assert tuple(m.shape) == (4, 3, dyn.n_dofs, dyn.n_dofs)
    np.testing.assert_allclose(m.numpy(), m.mT.numpy(), rtol=0, atol=1e-12)
    assert bool((torch.linalg.eigvalsh(m) > 0).all())


def test_zero_gravity_and_inverse_forward_roundtrip():
    """No gravity and no motion: no torque; forward dynamics (Cholesky)
    inverts RNEA."""
    dyn = tpm.panda_dynamics(device="cpu")
    rng = np.random.default_rng(5)
    q, qd, qdd = (torch.from_numpy(rng.uniform(lo, hi, 7))
                  for lo, hi in ((-1.5, 1.5), (-1.0, 1.0), (-2.0, 2.0)))
    z = torch.zeros(7, dtype=torch.float64)
    assert float(dyn.rnea(q, z, z, gravity=(0, 0, 0)).abs().max()) <= 1e-12
    tau = dyn.rnea(q, qd, qdd, gravity=GRAVITY)
    np.testing.assert_allclose(dyn.forward_dynamics(q, qd, tau, gravity=GRAVITY).numpy(),
                               qdd.numpy(), rtol=1e-8)


# a two-link arm with every joint kind and every <inertial> entry: a tilted
# inertia frame, off-diagonal moments, a link without <inertial>, one with
# an empty one
URDF = """<robot name="toy">
  <link name="base"/>
  <link name="upper">
    <inertial><origin xyz="0.1 0.02 -0.05" rpy="0.3 -0.2 0.7"/><mass value="1.7"/>
      <inertia ixx="0.21" ixy="0.013" ixz="-0.02" iyy="0.15" iyz="0.004" izz="0.09"/>
    </inertial>
  </link>
  <link name="slider">
    <inertial><mass value="0.4"/><inertia ixx="0.01" iyy="0.02" izz="0.03"/></inertial>
  </link>
  <link name="tip"><inertial/></link>
  <link name="marker"/>
  <joint name="j1" type="revolute"><parent link="base"/><child link="upper"/>
    <origin xyz="0 0 0.3" rpy="0 0.4 0"/><axis xyz="0.6 0 0.8"/>
    <limit lower="-2" upper="2" velocity="1.5" effort="30"/></joint>
  <joint name="j2" type="prismatic"><parent link="upper"/><child link="slider"/>
    <origin xyz="0.25 0 0" rpy="-1.2 0 0.1"/><axis xyz="0 1 0"/>
    <limit lower="0" upper="0.2" velocity="0.3"/></joint>
  <joint name="j3" type="continuous"><parent link="slider"/><child link="tip"/>
    <origin xyz="0 0.1 0.05"/><axis xyz="1 0 0"/></joint>
  <joint name="j4" type="fixed"><parent link="tip"/><child link="marker"/>
    <origin xyz="0.05 0 0"/></joint>
</robot>"""


def test_inline_urdf_inertials_parse_equal_and_drive_equal_dynamics():
    """Both packages parse the same ``InertialSpec``s (and joints) from the
    inline URDF; ``ChainDynamics`` on the parsed models agree on every
    joint kind."""
    jm, tm = jurdf.parse_urdf(URDF), turdf.parse_urdf(URDF)
    assert [vars(i) for i in tm.inertials] == [vars(i) for i in jm.inertials]
    assert [vars(j) for j in tm.joints] == [vars(j) for j in jm.joints]
    assert tm.inertial_for("upper").mass == 1.7 and tm.inertial_for("marker") is None
    assert tm.inertial_for("tip").mass == 0.0
    jd, td = JDyn(jm), ChainDynamics(tm, device="cpu")
    assert td.total_mass == jd.total_mass
    rng = np.random.default_rng(8)
    q, qd, qdd = (rng.uniform(-1.0, 1.0, (6, 3)) for _ in range(3))
    for method in METHODS:
        args = _args(method, q, qd, qdd)
        want = np.asarray(getattr(jd, method)(*(jnp.asarray(a) for a in args)))
        got = getattr(td, method)(*args).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12, err_msg=method)


def test_panda_inertials_equal_jax():
    assert [vars(i) for i in tpm.PANDA_INERTIALS] == [vars(i) for i in jpm.PANDA_INERTIALS]
    for t, j in ((tpm.PANDA_NO_GRIPPER, jpm.PANDA_NO_GRIPPER),
                 (tpm.PANDA_WITH_GRIPPER, jpm.PANDA_WITH_GRIPPER)):
        assert t.inertials == tpm.PANDA_INERTIALS and len(j.inertials) == len(t.inertials)
