"""The port's public API against the JAX package's.

For every public callable of the modules both packages have under
``costs``, ``gp``, ``kinematics`` and ``planners`` (functions, classes, and
the classes' public methods and constructors), every positional parameter of
the JAX signature appears in the port's at the same position; the port may
add keyword parameters after them (``device=``, ``eps=``, ``generator=``,
``starts=``). What differs on purpose is listed below with the reason.
"""

import importlib
import inspect
import pkgutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PACKAGES = ("costs", "gp", "kinematics", "planners")
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)

# JAX-only positional parameters, left out of the comparison, by qualified
# name: each is an execution or layout choice of a TPU kernel, or belongs to
# a module not ported yet.
OMITTED = {
    # the Pallas or gather/one-hot choice of a TPU kernel: the port has one
    # CUDA kernel per field
    "RasterPrimitive2DField": ("use_pallas",),
    "RasterPrimitive2DField.__init__": ("use_pallas",),
    "RasterPrimitive2DField.from_map": ("use_pallas",),
    "OccupancyGridField": ("lookup",),
    "OccupancyGridField.__init__": ("lookup",),
    # the TPU kernel's selection matrix, time mask and 128-lane padding: the
    # port's K4 reads the position planes through their strides; and
    # num_obstacles, which only JAX's use_pallas=False path reads (its first
    # num_obstacles spheres): K4, as JAX's Pallas paths, takes every sphere
    # given
    "PlaneFieldsCost": ("num_obstacles", "use_pallas", "sel", "tmask", "tpad"),
    "PlaneFieldsCost.__init__": ("num_obstacles", "use_pallas", "sel", "tmask", "tpad"),
    # inertial parameters: inverse dynamics is not ported yet
    "RobotModel": ("inertials",),
    "RobotModel.__init__": ("inertials",),
}
# the same position under another name: a JAX PRNG key is a torch.Generator
RENAMED = {"key": "generator"}
# public names of the JAX modules the port does not have yet (inverse
# dynamics; queue 1 of ROADMAP.md), by qualified name
NOT_PORTED = {"ChainDynamics", "InertialSpec", "panda_dynamics", "RobotModel.inertial_for"}


def _modules():
    """``(name, JAX module, port module)`` for ``PACKAGES`` and their
    submodules present in both packages."""
    out = []
    for pkg in PACKAGES:
        jpkg = importlib.import_module(f"stoch_gpmp_tpu.{pkg}")
        names = [pkg] + [f"{pkg}.{m.name}" for m in pkgutil.iter_modules(jpkg.__path__)]
        for name in names:
            try:
                tmod = importlib.import_module(f"stoch_gpmp_tpu_torch.{name}")
            except ModuleNotFoundError:
                continue
            out.append((name, importlib.import_module(f"stoch_gpmp_tpu.{name}"), tmod))
    return out


def _qualified(label: str) -> str:
    """``"module:Name.method"`` -> ``"Name.method"``."""
    return label.split(":", 1)[1]


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items() if not n.startswith("_")
                 and getattr(v, "__module__", None) == mod.__name__]
    return names


def _positional(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values() if p.kind in POSITIONAL]


def _pairs():
    """``(label, JAX callable, port callable)`` for every public callable
    and method both packages have, plus the labels of missing ones."""
    pairs, missing = [], []
    for name, jmod, tmod in _modules():
        for attr in _public(jmod):
            label = f"{name}:{attr}"
            jobj = getattr(jmod, attr)
            if not hasattr(tmod, attr):
                missing.append(label)
                continue
            tobj = getattr(tmod, attr)
            if not callable(jobj):
                continue
            pairs.append((label, jobj, tobj))
            if not inspect.isclass(jobj):
                continue
            for meth, raw in vars(jobj).items():
                if (meth.startswith("_") and meth != "__init__") or meth == "replace":
                    continue
                if isinstance(raw, property):
                    if not hasattr(tobj, meth):
                        missing.append(f"{label}.{meth}")
                    continue
                if not (callable(raw) or isinstance(raw, (classmethod, staticmethod))):
                    continue
                if hasattr(tobj, meth):
                    pairs.append((f"{label}.{meth}", getattr(jobj, meth), getattr(tobj, meth)))
                else:
                    missing.append(f"{label}.{meth}")
    return pairs, missing


PAIRS, MISSING = _pairs()


def test_every_public_name_is_ported_or_listed():
    assert sorted({m for m in MISSING if _qualified(m) not in NOT_PORTED}) == []


MODULES = sorted({label.split(":")[0] for label, _, _ in PAIRS})


@pytest.mark.parametrize("module", MODULES)
def test_positional_parameters_match(module):
    """Per module: every callable's JAX positional parameters lead the
    port's, in order."""
    bad = []
    for label, jfn, tfn in PAIRS:
        if label.split(":")[0] != module:
            continue
        want, got = _positional(jfn), _positional(tfn)
        if want is None or got is None:  # a builtin without a signature
            continue
        want = [RENAMED.get(n, n) for n in want if n not in OMITTED.get(_qualified(label), ())]
        if got[:len(want)] != want:
            bad.append(f"{label}: JAX {want}, port {got}")
    assert bad == []


def test_the_listed_differences_are_still_differences():
    """Each listed omission still exists in JAX and is still absent from
    the port, so the lists cannot outlive what they excuse."""
    by_name = {_qualified(label): (jfn, tfn) for label, jfn, tfn in PAIRS}
    for name, params in OMITTED.items():
        jfn, tfn = by_name[name]
        for n in params:
            assert n in _positional(jfn) and n not in _positional(tfn), (name, n)
    assert NOT_PORTED <= {_qualified(m) for m in MISSING}
