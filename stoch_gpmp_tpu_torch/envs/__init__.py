from stoch_gpmp_tpu_torch.envs.map_generator import generate_obstacle_map
from stoch_gpmp_tpu_torch.envs.obst_map import (
    Obstacle,
    ObstacleCircle,
    ObstacleMap,
    ObstacleRectangle,
)
from stoch_gpmp_tpu_torch.envs.panda_env import random_init_static_sphere

__all__ = [
    "generate_obstacle_map",
    "Obstacle",
    "ObstacleCircle",
    "ObstacleMap",
    "ObstacleRectangle",
    "random_init_static_sphere",
]
