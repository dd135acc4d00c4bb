"""Minimal URDF parser producing a kinematic-chain specification.

PyTorch counterpart of ``stoch_gpmp_tpu/kinematics/urdf.py``: joints
(type, origin, axis, limits incl. effort), the link graph and the per-link
``<inertial>`` blocks (mass, COM origin, inertia tensor), the inputs of
the rigid-body dynamics (``kinematics/dynamics.py``). Visual and collision
geometry are ignored.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field


@dataclass(frozen=True)
class JointSpec:
    name: str
    joint_type: str  # 'revolute' | 'continuous' | 'prismatic' | 'fixed'
    parent_link: str
    child_link: str
    origin_xyz: tuple[float, float, float] = (0.0, 0.0, 0.0)
    origin_rpy: tuple[float, float, float] = (0.0, 0.0, 0.0)
    axis: tuple[float, float, float] = (0.0, 0.0, 1.0)
    limit_lower: float | None = None
    limit_upper: float | None = None
    limit_velocity: float | None = None
    limit_effort: float | None = None

    @property
    def actuated(self) -> bool:
        return self.joint_type in ("revolute", "continuous", "prismatic")


@dataclass(frozen=True)
class InertialSpec:
    """Per-link ``<inertial>``: mass, COM pose in the link frame, and the
    symmetric inertia tensor about the COM expressed in the inertial frame."""

    link: str
    mass: float
    com_xyz: tuple[float, float, float] = (0.0, 0.0, 0.0)
    com_rpy: tuple[float, float, float] = (0.0, 0.0, 0.0)
    ixx: float = 0.0
    ixy: float = 0.0
    ixz: float = 0.0
    iyy: float = 0.0
    iyz: float = 0.0
    izz: float = 0.0


@dataclass(frozen=True)
class RobotModel:
    name: str
    joints: tuple[JointSpec, ...]
    links: tuple[str, ...] = field(default_factory=tuple)
    inertials: tuple[InertialSpec, ...] = field(default_factory=tuple)

    def inertial_for(self, link: str) -> InertialSpec | None:
        for it in self.inertials:
            if it.link == link:
                return it
        return None

    @property
    def root_link(self) -> str:
        if not self.joints:
            if not self.links:
                raise ValueError("URDF has no joints and no links")
            return self.links[0]
        children = {j.child_link for j in self.joints}
        roots = [j.parent_link for j in self.joints if j.parent_link not in children]
        if not roots:
            raise ValueError("no root link found (cycle in joint graph?)")
        return roots[0]

    @property
    def n_dofs(self) -> int:
        return sum(1 for j in self.joints if j.actuated)


def _floats(s: str | None, default):
    if s is None:
        return default
    return tuple(float(x) for x in s.split())


def _limit(limit, attr):
    return float(limit.get(attr)) if limit is not None and limit.get(attr) else None


def parse_urdf(source: str) -> RobotModel:
    """Parse a URDF file path or XML string into a RobotModel."""
    if source.lstrip().startswith("<"):
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()
    if root.tag != "robot":
        raise ValueError(f"not a URDF document (root tag {root.tag!r})")

    joints = []
    for j in root.findall("joint"):
        origin = j.find("origin")
        axis = j.find("axis")
        limit = j.find("limit")
        joints.append(JointSpec(
            name=j.get("name"),
            joint_type=j.get("type"),
            parent_link=j.find("parent").get("link"),
            child_link=j.find("child").get("link"),
            origin_xyz=_floats(origin.get("xyz") if origin is not None else None,
                               (0.0, 0.0, 0.0)),
            origin_rpy=_floats(origin.get("rpy") if origin is not None else None,
                               (0.0, 0.0, 0.0)),
            axis=_floats(axis.get("xyz") if axis is not None else None, (0.0, 0.0, 1.0)),
            limit_lower=_limit(limit, "lower"),
            limit_upper=_limit(limit, "upper"),
            limit_velocity=_limit(limit, "velocity"),
            limit_effort=_limit(limit, "effort"),
        ))
    links = tuple(link.get("name") for link in root.findall("link"))
    return RobotModel(name=root.get("name", "robot"), joints=tuple(joints), links=links,
                      inertials=tuple(_inertial(link) for link in root.findall("link")
                                      if link.find("inertial") is not None))


def _inertial(link) -> InertialSpec:
    """The ``<inertial>`` block of a ``<link>`` element: absent entries are
    0 (mass, inertia) or the identity pose."""
    node = link.find("inertial")
    origin, mass, inertia = node.find("origin"), node.find("mass"), node.find("inertia")

    def moment(attr):
        return 0.0 if inertia is None or inertia.get(attr) is None else float(inertia.get(attr))

    return InertialSpec(
        link=link.get("name"),
        mass=float(mass.get("value")) if mass is not None else 0.0,
        com_xyz=_floats(origin.get("xyz") if origin is not None else None, (0.0, 0.0, 0.0)),
        com_rpy=_floats(origin.get("rpy") if origin is not None else None, (0.0, 0.0, 0.0)),
        **{a: moment(a) for a in ("ixx", "ixy", "ixz", "iyy", "iyz", "izz")},
    )
