"""stoch_gpmp_tpu_torch — the PyTorch + CUDA port of ``stoch_gpmp_tpu``.

Same layout and names as the JAX package, so each module's counterpart sits
at the same relative path. Plain tensor code is PyTorch; the TPU kernels of
``stoch_gpmp_tpu/ops/pallas/`` become CUDA kernels written for Hopper in
``csrc/``, wrapped in ``ops/kernels/``, each beside a plain PyTorch
version that the CPU tests use. This package never imports JAX.

Ported: the planar StochGPMP main path (GP prior, planar cost stack, flat
planner path, the fused planar iterations), the reference-shaped planar
stacks on the occupancy grid and the analytic primitives, Gauss-Newton
``GPMP`` (structured Cholesky, dense and Woodbury solves), the Panda 7-DOF
dof-factored path (kinematics, ``PlaneFieldsCost``, the dof planner path,
the fused dof iteration), the Panda parity workload (the
reference-shaped link-field stack, the fused flat iteration), Panda
planning (IK goals, the mesh spheres, GN through FK), long horizons, and
multi-device planning on ``torch.distributed`` (``parallel/``). Entry points run on the CUDA card unless given
``device="cpu"``. Importing the package is light; submodules load on first
use.
"""

__version__ = "0.1.0"


def __getattr__(name):
    from importlib import import_module

    _exports = {
        "StochGPMP": "stoch_gpmp_tpu_torch.planners",
        "GPMP": "stoch_gpmp_tpu_torch.planners",
        "GPPrior": "stoch_gpmp_tpu_torch.gp",
        "make_gp_prior": "stoch_gpmp_tpu_torch.gp",
        "CostComposite": "stoch_gpmp_tpu_torch.costs",
        "CostGP": "stoch_gpmp_tpu_torch.costs",
        "CostGoalPrior": "stoch_gpmp_tpu_torch.costs",
        "CostCollision": "stoch_gpmp_tpu_torch.costs",
        "PlaneFieldsCost": "stoch_gpmp_tpu_torch.costs",
        "franka_panda": "stoch_gpmp_tpu_torch.kinematics",
        "generate_obstacle_map": "stoch_gpmp_tpu_torch.envs",
    }
    if name in _exports:
        return getattr(import_module(_exports[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
