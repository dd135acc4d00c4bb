from stoch_gpmp_tpu_torch.kinematics.chain import KinematicChain, LinkState
from stoch_gpmp_tpu_torch.kinematics.panda_model import (
    PANDA_FK_LINKS,
    PANDA_NO_GRIPPER,
    franka_panda,
)
from stoch_gpmp_tpu_torch.kinematics.se3 import (
    homogeneous,
    rotation_angle,
    rpy_to_matrix,
    se3_distance,
    x_rot,
    y_rot,
    z_rot,
)
from stoch_gpmp_tpu_torch.kinematics.urdf import JointSpec, RobotModel, parse_urdf

__all__ = [
    "KinematicChain",
    "LinkState",
    "PANDA_FK_LINKS",
    "PANDA_NO_GRIPPER",
    "franka_panda",
    "homogeneous",
    "rotation_angle",
    "rpy_to_matrix",
    "se3_distance",
    "x_rot",
    "y_rot",
    "z_rot",
    "JointSpec",
    "RobotModel",
    "parse_urdf",
]
