"""Built-in Franka Panda kinematic model (no-gripper arm).

PyTorch counterpart of ``stoch_gpmp_tpu/kinematics/panda_model.py``, with
its own copy of the joint table: the public Franka Emika Panda
specification (``franka_description``, no-gripper variant), 7 revolute
joints plus the fixed base, hand and end-effector frames. The gripper
variant and the inertial parameters (inverse dynamics) are not ported yet.
"""

from __future__ import annotations

import math

from stoch_gpmp_tpu_torch.kinematics.chain import KinematicChain
from stoch_gpmp_tpu_torch.kinematics.urdf import JointSpec, RobotModel

_HALF_PI = math.pi / 2.0

PANDA_NO_GRIPPER = RobotModel(
    name="panda_no_gripper",
    joints=(
        JointSpec("panda_fixed", "fixed", "base_link", "panda_link0"),
        JointSpec(
            "panda_joint1", "revolute", "panda_link0", "panda_link1",
            origin_xyz=(0.0, 0.0, 0.333), axis=(0.0, 0.0, 1.0),
            limit_lower=-2.8973, limit_upper=2.8973, limit_velocity=2.1750,
        ),
        JointSpec(
            "panda_joint2", "revolute", "panda_link1", "panda_link2",
            origin_rpy=(-_HALF_PI, 0.0, 0.0), axis=(0.0, 0.0, 1.0),
            limit_lower=-1.7628, limit_upper=1.7628, limit_velocity=2.1750,
        ),
        JointSpec(
            "panda_joint3", "revolute", "panda_link2", "panda_link3",
            origin_xyz=(0.0, -0.316, 0.0), origin_rpy=(_HALF_PI, 0.0, 0.0),
            axis=(0.0, 0.0, 1.0),
            limit_lower=-2.8973, limit_upper=2.8973, limit_velocity=2.1750,
        ),
        JointSpec(
            "panda_joint4", "revolute", "panda_link3", "panda_link4",
            origin_xyz=(0.0825, 0.0, 0.0), origin_rpy=(_HALF_PI, 0.0, 0.0),
            axis=(0.0, 0.0, 1.0),
            limit_lower=-3.0718, limit_upper=-0.0698, limit_velocity=2.1750,
        ),
        JointSpec(
            "panda_joint5", "revolute", "panda_link4", "panda_link5",
            origin_xyz=(-0.0825, 0.384, 0.0), origin_rpy=(-_HALF_PI, 0.0, 0.0),
            axis=(0.0, 0.0, 1.0),
            limit_lower=-2.8973, limit_upper=2.8973, limit_velocity=2.6100,
        ),
        JointSpec(
            "panda_joint6", "revolute", "panda_link5", "panda_link6",
            origin_rpy=(_HALF_PI, 0.0, 0.0), axis=(0.0, 0.0, 1.0),
            limit_lower=-0.0175, limit_upper=3.7525, limit_velocity=2.6100,
        ),
        JointSpec(
            "panda_joint7", "revolute", "panda_link6", "panda_link7",
            origin_xyz=(0.088, 0.0, 0.0), origin_rpy=(_HALF_PI, 0.0, 0.0),
            axis=(0.0, 0.0, 1.0),
            limit_lower=-2.8973, limit_upper=2.8973, limit_velocity=2.6100,
        ),
        JointSpec(
            "panda_hand_joint", "fixed", "panda_link7", "panda_hand",
            origin_xyz=(0.0, 0.0, 0.107), origin_rpy=(0.0, 0.0, -math.pi / 4),
        ),
        JointSpec(
            "ee_fixed_joint", "fixed", "panda_hand", "ee_link",
            origin_xyz=(0.0, 0.0, 0.1), origin_rpy=(0.0, 0.0, -1.57),
        ),
    ),
)

# The movable-link frames the FK exposes by default, end-effector last.
PANDA_FK_LINKS = [
    "panda_link1",
    "panda_link2",
    "panda_link3",
    "panda_link4",
    "panda_link5",
    "panda_link6",
    "panda_link7",
    "panda_hand",
    "ee_link",
]


def franka_panda(link_names=None) -> KinematicChain:
    """Batched FK chain for the 7-DOF Panda arm (no gripper)."""
    return KinematicChain(
        PANDA_NO_GRIPPER, link_names=link_names if link_names is not None else PANDA_FK_LINKS
    )
