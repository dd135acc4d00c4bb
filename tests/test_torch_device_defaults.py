"""Every entry point of the port runs on the CUDA card unless the caller
asks for the CPU: its ``device`` default is None (resolved to the card by
``utils.device.resolve_device``) or the card itself, and on a host without
CUDA the default raises resolve_device's "no CUDA device" error instead of
moving to the CPU. The host is made CUDA-less by patching
``torch.cuda.is_available``, so the sweep runs the same on any host.

The entry points: the ``problems.build_*`` builders, ``StochGPMP``,
``GPMP``, ``Panda``, ``PandaEnv``, ``parallel.make_mesh``,
``parallel.drive.run_cases``, ``parallel.launch`` and the ``--device``
flag of the four example twins."""

import inspect
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stoch_gpmp_tpu_torch import problems  # noqa: E402

NO_CUDA = "no CUDA device"
BUILDERS = sorted(n for n in dir(problems) if n.startswith("build_"))
# builders' required positional arguments
BUILDER_ARGS = {"build_long_horizon_problem": (64,), "build_sharded_planar_problem": (2,)}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _device_default(fn):
    """The default of ``fn``'s ``device`` parameter; ``inspect._empty`` when
    it takes the device through ``**kw`` only."""
    param = inspect.signature(fn).parameters.get("device")
    return inspect.Parameter.empty if param is None else param.default


@pytest.mark.parametrize("name", BUILDERS)
def test_builders_default_to_the_card(name, no_cuda):
    fn = getattr(problems, name)
    assert _device_default(fn) in (None, inspect.Parameter.empty)
    with pytest.raises(RuntimeError, match=NO_CUDA):
        fn(*BUILDER_ARGS.get(name, ()))


def _planner(cls):
    return lambda **kw: cls(num_particles_per_goal=1, num_samples=2, traj_len=8,
                            opt_iters=1, dt=0.02, n_dof=2, **kw)


def _entry(name):
    """``(the callable whose signature carries the default, a call that
    takes every default)``."""
    if name == "StochGPMP":
        from stoch_gpmp_tpu_torch.planners import StochGPMP

        return StochGPMP, _planner(StochGPMP)
    if name == "GPMP":
        from stoch_gpmp_tpu_torch.planners import GPMP

        return GPMP, lambda: GPMP(num_particles_per_goal=1, traj_len=8, opt_iters=1, dt=0.02,
                                  n_dof=2)
    if name == "Panda":
        from stoch_gpmp_tpu_torch.envs.objects import Panda

        return Panda, Panda
    if name == "PandaEnv":
        from stoch_gpmp_tpu_torch.envs import PandaEnv

        return PandaEnv, PandaEnv
    if name == "run_cases":
        from stoch_gpmp_tpu_torch.parallel.drive import run_cases

        return run_cases, lambda: run_cases([])
    if name == "launch":
        from stoch_gpmp_tpu_torch.parallel.launch import launch

        return launch, lambda: launch(print, 1)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["StochGPMP", "GPMP", "Panda", "PandaEnv", "run_cases",
                                  "launch"])
def test_entry_points_default_to_the_card(name, no_cuda):
    fn, call = _entry(name)
    assert _device_default(fn) in (None, "cuda")
    with pytest.raises(RuntimeError, match=NO_CUDA):
        call()


def test_make_mesh_defaults_to_the_card(no_cuda, tmp_path):
    """In a process group of one gloo rank, ``make_mesh()`` takes the
    rank's card and raises without one."""
    import torch.distributed as dist

    from stoch_gpmp_tpu_torch.parallel import make_mesh

    assert _device_default(make_mesh) is None
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match=NO_CUDA):
            make_mesh()
        assert make_mesh(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("twin", ["panda_environment", "planar_environment", "planar_gpmp",
                                  "planar_sharded"])
def test_example_twins_default_to_the_card(twin, no_cuda):
    """Each twin run with no flag takes the card (and raises without one);
    ``--device`` is how a caller picks the CPU."""
    import importlib

    module = importlib.import_module(f"stoch_gpmp_tpu_torch.examples.{twin}")
    with pytest.raises(RuntimeError, match=NO_CUDA):
        module.main([])
