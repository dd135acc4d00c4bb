from stoch_gpmp_tpu_torch.kinematics.chain import KinematicChain, LinkState
from stoch_gpmp_tpu_torch.kinematics.panda_model import (
    PANDA_FK_LINKS,
    PANDA_GRIPPER_FK_LINKS,
    PANDA_NO_GRIPPER,
    PANDA_WITH_GRIPPER,
    DifferentiableFrankaPanda,
    franka_panda,
)
from stoch_gpmp_tpu_torch.kinematics.se3 import (
    Frame,
    axis_angle_to_matrix,
    homogeneous,
    matrix_to_quaternion,
    quaternion_to_matrix,
    rotation_angle,
    rpy_to_matrix,
    se3_distance,
    x_rot,
    y_rot,
    z_rot,
)
from stoch_gpmp_tpu_torch.kinematics.urdf import JointSpec, RobotModel, parse_urdf

__all__ = [
    "DifferentiableFrankaPanda",
    "Frame",
    "KinematicChain",
    "LinkState",
    "PANDA_FK_LINKS",
    "PANDA_GRIPPER_FK_LINKS",
    "PANDA_NO_GRIPPER",
    "PANDA_WITH_GRIPPER",
    "axis_angle_to_matrix",
    "franka_panda",
    "homogeneous",
    "matrix_to_quaternion",
    "quaternion_to_matrix",
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
