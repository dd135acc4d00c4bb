"""Kinematics of the PyTorch port against the JAX package, in float64.

Same numpy inputs (joint angles from ``default_rng``) through both
packages. Tolerance: 1e-12 absolute on poses and rotations (metres and
unit-scale entries; float64 in both, the same folded algebra, summed in the
same order up to the backends' fusion).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from stoch_gpmp_tpu.kinematics import se3 as jse3  # noqa: E402
from stoch_gpmp_tpu.kinematics.panda_model import franka_panda as jpanda  # noqa: E402
from stoch_gpmp_tpu.kinematics.urdf import parse_urdf as jparse  # noqa: E402
from stoch_gpmp_tpu_torch import convert  # noqa: E402
from stoch_gpmp_tpu_torch.kinematics import (  # noqa: E402
    KinematicChain,
    franka_panda,
    parse_urdf,
)
from stoch_gpmp_tpu_torch.kinematics import se3 as tse3  # noqa: E402

ATOL = 1e-12

URDF = """<robot name="arm">
  <link name="base"/><link name="a"/><link name="b"/><link name="c"/>
  <joint name="j1" type="revolute"><parent link="base"/><child link="a"/>
    <origin xyz="0 0 0.3" rpy="0.1 -0.2 0.3"/><axis xyz="0 1 0"/>
    <limit lower="-1" upper="1" velocity="2" effort="5"/></joint>
  <joint name="j2" type="prismatic"><parent link="a"/><child link="b"/>
    <origin xyz="0.2 0 0" rpy="1.5707963267948966 0 0"/><axis xyz="1 0 0"/></joint>
  <joint name="j3" type="continuous"><parent link="b"/><child link="c"/>
    <origin xyz="0 0.1 0.05"/><axis xyz="0.6 0 0.8"/></joint>
</robot>"""


def _q(n, shape=(5, 3), seed=0):
    return np.random.default_rng(seed).uniform(-2.5, 2.5, shape + (n,))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def chains():
    """The Panda chain natively and carried over from JAX, and the JAX one."""
    return franka_panda(), convert.chain_from_jax(jpanda(dtype=jnp.float64)), \
        jpanda(dtype=jnp.float64)


@pytest.mark.parametrize("which", [0, 1], ids=["native", "converted"])
def test_panda_fk_matches_jax(chains, which):
    chain, jchain = chains[which], chains[2]
    q = _q(7)
    _close(chain.fk(torch.from_numpy(q)), jchain.fk(jnp.asarray(q)))
    ls, jls = chain.fk_compact(torch.from_numpy(q)), jchain.fk_compact(jnp.asarray(q))
    _close(ls.positions, jls.positions)
    _close(ls.ee_rot, jls.ee_rot)
    _close(ls.ee_pose(), jls.ee_pose())
    _close(chain.ee_pose(torch.from_numpy(q)), jchain.ee_pose(jnp.asarray(q)))


def test_fk_planes_from_scalars_matches_jax(chains):
    """The folded structure of arrays: the same entries are Python-float
    constants in both packages, and the rest agree."""
    chain, _, jchain = chains
    q = _q(7, (11,), seed=1)
    tp = chain.fk_planes_from_scalars([torch.from_numpy(q[:, i]) for i in range(7)])
    jp = jchain.fk_planes_from_scalars([jnp.asarray(q[:, i]) for i in range(7)])
    assert len(tp) == len(jp) == 9
    for (tr, tpos), (jr, jpos) in zip(tp, jp):
        for t, j in zip([*sum(tr, []), *tpos], [*sum(jr, []), *jpos]):
            assert isinstance(t, float) == isinstance(j, float)
            if isinstance(t, float):
                assert t == j
            else:
                _close(t, j)


def test_urdf_chain_with_prismatic_joint_matches_jax():
    model, jmodel = parse_urdf(URDF), jparse(URDF)
    assert [j.name for j in model.joints] == [j.name for j in jmodel.joints]
    assert model.joints[0].limit_effort == 5.0 and model.n_dofs == jmodel.n_dofs == 3
    q = _q(3, (4,), seed=2)
    from stoch_gpmp_tpu.kinematics.chain import KinematicChain as JChain

    _close(KinematicChain(model).fk(torch.from_numpy(q)),
           JChain(jmodel, dtype=jnp.float64).fk(jnp.asarray(q)))


def test_joint_table_and_serial_check(chains):
    """The kernels' joint table reproduces the chain's FK when walked in
    float64 numpy the way ``csrc/fk_chain.cuh`` walks it; a branching tree
    is refused."""
    chain = chains[0]
    tab = chain.joint_table()
    q = _q(7, (1,), seed=3)[0]
    r, p, pos = np.eye(3), np.zeros(3), {}
    for j in range(len(tab["type"])):
        p = p + r @ tab["trans"][j]
        r = r @ tab["rot"][j]
        if tab["type"][j] == 1:
            k = tab["axis"][j]
            km = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
            qj = q[tab["dof"][j]]
            r = r @ (np.eye(3) + np.sin(qj) * km + (1 - np.cos(qj)) * km @ km)
        if tab["slot"][j] >= 0:
            pos[tab["slot"][j]] = p
    want = chain.fk_compact(torch.from_numpy(q)).positions.numpy()
    np.testing.assert_allclose(np.stack([pos[i] for i in range(9)]), want, atol=1e-12)
    tree = URDF.replace('<parent link="b"/><child link="c"/>', '<parent link="a"/><child link="c"/>')
    with pytest.raises(ValueError, match="serial chain"):
        KinematicChain(parse_urdf(tree)).joint_table()


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(4)
    th = rng.uniform(-3, 3, (6,))
    for name in ("x_rot", "y_rot", "z_rot"):
        _close(getattr(tse3, name)(torch.from_numpy(th)), getattr(jse3, name)(jnp.asarray(th)))
    rpy = rng.uniform(-3, 3, (6, 3))
    r1 = tse3.rpy_to_matrix(torch.from_numpy(rpy))
    _close(r1, jse3.rpy_to_matrix(jnp.asarray(rpy)))
    trans = rng.normal(size=(6, 3))
    _close(tse3.homogeneous(r1, torch.from_numpy(trans)),
           jse3.homogeneous(jnp.asarray(r1.numpy()), jnp.asarray(trans)))
    r2 = tse3.rpy_to_matrix(torch.from_numpy(rpy[::-1].copy()))
    _close(tse3.rotation_angle(r1, r2),
           jse3.rotation_angle(jnp.asarray(r1.numpy()), jnp.asarray(r2.numpy())), atol=1e-10)
