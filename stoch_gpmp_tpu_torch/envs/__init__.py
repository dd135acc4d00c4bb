from stoch_gpmp_tpu_torch.envs.map_generator import generate_obstacle_map
from stoch_gpmp_tpu_torch.envs.obst_map import (
    Obstacle,
    ObstacleCircle,
    ObstacleMap,
    ObstacleRectangle,
)


def __getattr__(name):
    # lazy: panda_env pulls in the kinematics stack
    if name in ("PandaEnv", "random_init_static_sphere", "update_linear_velocity_sphere"):
        from stoch_gpmp_tpu_torch.envs import panda_env

        return getattr(panda_env, name)
    if name in ("Panda", "Sphere", "BodyCore", "DynamicBodyCore"):
        from stoch_gpmp_tpu_torch.envs import objects

        return getattr(objects, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "generate_obstacle_map",
    "Obstacle",
    "ObstacleCircle",
    "ObstacleMap",
    "ObstacleRectangle",
    "PandaEnv",
    "Panda",
    "Sphere",
]
