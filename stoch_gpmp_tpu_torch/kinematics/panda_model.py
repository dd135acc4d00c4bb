"""Built-in Franka Panda kinematic model.

PyTorch counterpart of ``stoch_gpmp_tpu/kinematics/panda_model.py``, with
its own copy of the joint tables: the public Franka Emika Panda
specification (``franka_description``), the no-gripper arm (7 revolute
joints plus the fixed base, hand and end-effector frames) and the gripper
variant (the same 7 joints with slightly wider limits, link 8, the hand,
two prismatic finger joints and the grasp-target frame: 9 DOF), and the
per-link inertials both models carry for the rigid-body dynamics
(:func:`panda_dynamics`).
"""

from __future__ import annotations

import math

import torch

from stoch_gpmp_tpu_torch.kinematics.chain import KinematicChain
from stoch_gpmp_tpu_torch.kinematics.urdf import InertialSpec, JointSpec, RobotModel
from stoch_gpmp_tpu_torch.utils.device import resolve_device

_HALF_PI = math.pi / 2.0

# Inertial parameters of the franka_description asset's <inertial> blocks:
# masses and COM offsets per link, diag(0.1) rotational inertia.
_D = dict(ixx=0.1, iyy=0.1, izz=0.1)
PANDA_INERTIALS = (
    InertialSpec("panda_link0", 2.9, (0.0, 0.0, 0.05), **_D),
    InertialSpec("panda_link1", 2.7, (0.0, -0.04, -0.05), **_D),
    InertialSpec("panda_link2", 2.73, (0.0, -0.04, 0.06), **_D),
    InertialSpec("panda_link3", 2.04, (0.01, 0.01, -0.05), **_D),
    InertialSpec("panda_link4", 2.08, (-0.03, 0.03, 0.02), **_D),
    InertialSpec("panda_link5", 3.0, (0.0, 0.04, -0.12), **_D),
    InertialSpec("panda_link6", 1.3, (0.04, 0.0, 0.0), **_D),
    InertialSpec("panda_link7", 0.2, (0.0, 0.0, 0.08), **_D),
    InertialSpec("panda_link8", 0.0, (0.0, 0.0, 0.0), **_D),
    InertialSpec("panda_hand", 0.81, (0.0, 0.0, 0.04), **_D),
    InertialSpec("panda_leftfinger", 0.1, (0.0, 0.01, 0.02), **_D),
    InertialSpec("panda_rightfinger", 0.1, (0.0, -0.01, 0.02), **_D),
    InertialSpec("panda_grasptarget", 0.0, (0.0, 0.0, 0.0), **_D),
)

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
    inertials=PANDA_INERTIALS,
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


# Gripper variant: joints 1-7 with slightly wider limits, fixed link8 +
# hand, two prismatic finger joints, and the grasp-target frame as the EE.
PANDA_WITH_GRIPPER = RobotModel(
    name="panda",
    joints=(
        JointSpec("panda_fixed", "fixed", "base_link", "panda_link0"),
        JointSpec(
            "panda_joint1", "revolute", "panda_link0", "panda_link1",
            origin_xyz=(0.0, 0.0, 0.333), axis=(0.0, 0.0, 1.0),
            limit_lower=-2.9671, limit_upper=2.9671, limit_velocity=2.1750,
            limit_effort=87.0,
        ),
        JointSpec(
            "panda_joint2", "revolute", "panda_link1", "panda_link2",
            origin_rpy=(-_HALF_PI, 0.0, 0.0), axis=(0.0, 0.0, 1.0),
            limit_lower=-1.8326, limit_upper=1.8326, limit_velocity=2.1750,
            limit_effort=87.0,
        ),
        JointSpec(
            "panda_joint3", "revolute", "panda_link2", "panda_link3",
            origin_xyz=(0.0, -0.316, 0.0), origin_rpy=(_HALF_PI, 0.0, 0.0),
            axis=(0.0, 0.0, 1.0),
            limit_lower=-2.9671, limit_upper=2.9671, limit_velocity=2.1750,
            limit_effort=87.0,
        ),
        JointSpec(
            "panda_joint4", "revolute", "panda_link3", "panda_link4",
            origin_xyz=(0.0825, 0.0, 0.0), origin_rpy=(_HALF_PI, 0.0, 0.0),
            axis=(0.0, 0.0, 1.0),
            limit_lower=-3.1416, limit_upper=0.0, limit_velocity=2.1750,
            limit_effort=87.0,
        ),
        JointSpec(
            "panda_joint5", "revolute", "panda_link4", "panda_link5",
            origin_xyz=(-0.0825, 0.384, 0.0), origin_rpy=(-_HALF_PI, 0.0, 0.0),
            axis=(0.0, 0.0, 1.0),
            limit_lower=-2.9671, limit_upper=2.9671, limit_velocity=2.6100,
            limit_effort=12.0,
        ),
        JointSpec(
            "panda_joint6", "revolute", "panda_link5", "panda_link6",
            origin_rpy=(_HALF_PI, 0.0, 0.0), axis=(0.0, 0.0, 1.0),
            limit_lower=-0.0873, limit_upper=3.8223, limit_velocity=2.6100,
            limit_effort=12.0,
        ),
        JointSpec(
            "panda_joint7", "revolute", "panda_link6", "panda_link7",
            origin_xyz=(0.088, 0.0, 0.0), origin_rpy=(_HALF_PI, 0.0, 0.0),
            axis=(0.0, 0.0, 1.0),
            limit_lower=-2.9671, limit_upper=2.9671, limit_velocity=2.6100,
            limit_effort=12.0,
        ),
        JointSpec(
            "panda_joint8", "fixed", "panda_link7", "panda_link8",
            origin_xyz=(0.0, 0.0, 0.107),
        ),
        JointSpec(
            "panda_hand_joint", "fixed", "panda_link8", "panda_hand",
            origin_rpy=(0.0, 0.0, -math.pi / 4),
        ),
        JointSpec(
            "panda_finger_joint1", "prismatic", "panda_hand", "panda_leftfinger",
            origin_xyz=(0.0, 0.0, 0.0584), axis=(0.0, 1.0, 0.0),
            limit_lower=0.0, limit_upper=0.04, limit_velocity=0.2,
            limit_effort=20.0,
        ),
        JointSpec(
            "panda_finger_joint2", "prismatic", "panda_hand", "panda_rightfinger",
            origin_xyz=(0.0, 0.0, 0.0584), axis=(0.0, -1.0, 0.0),
            limit_lower=0.0, limit_upper=0.04, limit_velocity=0.2,
            limit_effort=20.0,
        ),
        JointSpec(
            "panda_grasptarget_hand", "fixed", "panda_hand", "panda_grasptarget",
            origin_xyz=(0.0, 0.0, 0.105),
        ),
    ),
    inertials=PANDA_INERTIALS,
)

PANDA_GRIPPER_FK_LINKS = [
    "panda_link1",
    "panda_link2",
    "panda_link3",
    "panda_link4",
    "panda_link5",
    "panda_link6",
    "panda_link7",
    "panda_hand",
    "panda_leftfinger",
    "panda_rightfinger",
    "panda_grasptarget",
]


def franka_panda(dtype=torch.float32, link_names=None, gripper: bool = False) -> KinematicChain:
    """Batched FK chain for the Panda arm: 7 DOF, or 9 with the two
    prismatic finger joints when ``gripper=True``. ``dtype`` is the dtype of
    the chain's joint-limit tensors; FK runs in ``q``'s dtype."""
    model = PANDA_WITH_GRIPPER if gripper else PANDA_NO_GRIPPER
    default_links = PANDA_GRIPPER_FK_LINKS if gripper else PANDA_FK_LINKS
    return KinematicChain(model, link_names=link_names if link_names is not None
                          else default_links, dtype=dtype)


def panda_dynamics(gripper: bool = False, dtype=torch.float64, device=None):
    """Batched RNEA dynamics for the Panda (inertials ``PANDA_INERTIALS``).
    Float64 by default, as the JAX package computes it under x64; the
    device is the CUDA card unless ``device`` says otherwise."""
    from stoch_gpmp_tpu_torch.kinematics.dynamics import ChainDynamics

    return ChainDynamics(PANDA_WITH_GRIPPER if gripper else PANDA_NO_GRIPPER, dtype=dtype,
                         device=resolve_device(device))


class DifferentiableFrankaPanda:
    """The reference's FK wrapper class over :func:`franka_panda`."""

    def __init__(self, gripper: bool = False, dtype=torch.float32):
        self.chain = franka_panda(dtype=dtype, gripper=gripper)
        self._n_dofs = self.chain.n_dofs

    def compute_forward_kinematics_all_links(self, q: torch.Tensor) -> torch.Tensor:
        return self.chain.fk(q)

    def get_link_names(self):
        return list(self.chain.link_names)

    def print_link_names(self):
        print(self.get_link_names())
