"""URDF kinematic-chain loading (port of
``habitat_tpu/articulated_agents/urdf.py``; numpy and XML, the same code).

The reference loads the robot description into Bullet
(articulated_agents/manipulator.py:79-120). Here the URDF XML is parsed
directly (stdlib ElementTree, no physics engine), the link/joint tree is
walked from a base link to an end-effector link, fixed joints are folded
into their successors' origins, and the result is a dense
``ArticulatedChain`` of per-joint static transforms and axes that
``kinematics.fk_chain`` runs as batched tensor math (Rodrigues rotation
about arbitrary unit axes, prismatic slides, rpy fixed rotations).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np


def _rpy_matrix(r: float, p: float, y: float) -> np.ndarray:
    """URDF rpy = extrinsic XYZ = Rz(y) @ Ry(p) @ Rx(r)."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _floats(s: Optional[str], n: int, default: float = 0.0) -> np.ndarray:
    if not s:
        return np.full((n,), default)
    return np.asarray([float(v) for v in s.split()], np.float64)


@dataclasses.dataclass
class UrdfJoint:
    name: str
    joint_type: str  # revolute | continuous | prismatic | fixed
    parent: str
    child: str
    origin_xyz: np.ndarray  # (3,)
    origin_rot: np.ndarray  # (3,3) from rpy
    axis: np.ndarray  # (3,) unit
    lower: float
    upper: float
    velocity: float
    effort: float


@dataclasses.dataclass
class ArticulatedChain:
    """Dense serial chain for fk_chain: for joint j the frame update is
    T_j = Translate(origin[j]) @ R_fixed[j] @ Motion_j(q_j) where Motion is a
    Rodrigues rotation about axis[j] (revolute) or a slide along it
    (prismatic, is_prismatic[j])."""

    name: str
    joint_names: List[str]
    origin_xyz: np.ndarray  # (J, 3)
    origin_rot: np.ndarray  # (J, 3, 3)
    axis: np.ndarray  # (J, 3)
    is_prismatic: np.ndarray  # (J,) bool
    lower: np.ndarray  # (J,)
    upper: np.ndarray  # (J,)
    ee_offset: np.ndarray  # (3,) fixed tail translation after the last joint
    ee_rot: np.ndarray  # (3,3) fixed tail rotation

    @property
    def num_joints(self) -> int:
        return len(self.joint_names)


class UrdfModel:
    """Parsed URDF: links, joints, tree topology (reference loads this into
    Bullet; here it's plain data)."""

    def __init__(self, name: str, links: List[str], joints: List[UrdfJoint]):
        self.name = name
        self.links = links
        self.joints = joints
        self.child_to_joint: Dict[str, UrdfJoint] = {j.child: j for j in joints}
        self.parent_to_joints: Dict[str, List[UrdfJoint]] = {}
        for j in joints:
            self.parent_to_joints.setdefault(j.parent, []).append(j)

    @property
    def root_link(self) -> str:
        children = set(self.child_to_joint)
        roots = [l for l in self.links if l not in children]
        if not roots:
            raise ValueError("URDF has no root link (cycle?)")
        return roots[0]

    def movable_joint_names(self) -> List[str]:
        return [j.name for j in self.joints if j.joint_type != "fixed"]

    def find_path(self, base: str, tip: str) -> List[UrdfJoint]:
        """Joint sequence from base link down to tip link."""
        path: List[UrdfJoint] = []
        link = tip
        while link != base:
            j = self.child_to_joint.get(link)
            if j is None:
                raise ValueError(f"link {tip!r} is not below {base!r}")
            path.append(j)
            link = j.parent
        return path[::-1]

    def extract_chain(
        self, base_link: Optional[str] = None, ee_link: Optional[str] = None
    ) -> ArticulatedChain:
        """Serial chain base->ee with fixed joints folded into neighbors.

        Defaults: base = root link, ee = deepest link reachable through the
        longest run of movable joints (matches how the reference picks the
        gripper/EE link by config, ee_links in robot params)."""
        base = base_link or self.root_link
        if ee_link is None:
            ee_link = self._deepest_link(base)
        path = self.find_path(base, ee_link)

        names: List[str] = []
        xyz: List[np.ndarray] = []
        rot: List[np.ndarray] = []
        axis: List[np.ndarray] = []
        prism: List[bool] = []
        lo: List[float] = []
        hi: List[float] = []
        # accumulate fixed transforms into the next movable joint's origin
        acc_R = np.eye(3)
        acc_t = np.zeros(3)
        for j in path:
            o_t = acc_t + acc_R @ j.origin_xyz
            o_R = acc_R @ j.origin_rot
            if j.joint_type == "fixed":
                acc_t, acc_R = o_t, o_R
                continue
            names.append(j.name)
            xyz.append(o_t)
            rot.append(o_R)
            axis.append(j.axis)
            prism.append(j.joint_type == "prismatic")
            unlimited = j.joint_type == "continuous"
            lo.append(-np.pi if unlimited else j.lower)
            hi.append(np.pi if unlimited else j.upper)
            acc_t, acc_R = np.zeros(3), np.eye(3)
        if not names:
            raise ValueError(f"no movable joints between {base!r} and {ee_link!r}")
        return ArticulatedChain(
            name=self.name,
            joint_names=names,
            origin_xyz=np.asarray(xyz, np.float32),
            origin_rot=np.asarray(rot, np.float32),
            axis=np.asarray(axis, np.float32),
            is_prismatic=np.asarray(prism, bool),
            lower=np.asarray(lo, np.float32),
            upper=np.asarray(hi, np.float32),
            ee_offset=acc_t.astype(np.float32),
            ee_rot=acc_R.astype(np.float32),
        )

    def _deepest_link(self, base: str) -> str:
        best, best_score = base, (-1, -1)

        def walk(link: str, movable: int, depth: int) -> None:
            nonlocal best, best_score
            if (movable, depth) > best_score:
                best, best_score = link, (movable, depth)
            for j in self.parent_to_joints.get(link, []):
                walk(j.child, movable + (j.joint_type != "fixed"), depth + 1)

        walk(base, 0, 0)
        return best


def parse_urdf(source: str) -> UrdfModel:
    """Parse URDF XML from a file path or an XML string."""
    if source.lstrip().startswith("<"):
        root = ET.fromstring(source)
    else:
        root = ET.parse(source).getroot()
    if root.tag != "robot":
        raise ValueError(f"not a URDF (<robot> expected, got <{root.tag}>)")
    links = [l.get("name", "") for l in root.findall("link")]
    joints: List[UrdfJoint] = []
    for el in root.findall("joint"):
        origin = el.find("origin")
        xyz = _floats(origin.get("xyz") if origin is not None else None, 3)
        rpy = _floats(origin.get("rpy") if origin is not None else None, 3)
        axis_el = el.find("axis")
        ax = (
            _floats(axis_el.get("xyz"), 3)
            if axis_el is not None
            else np.array([1.0, 0.0, 0.0])
        )
        n = np.linalg.norm(ax)
        ax = ax / n if n > 0 else np.array([1.0, 0.0, 0.0])
        limit = el.find("limit")
        parent = el.find("parent")
        child = el.find("child")
        if parent is None or child is None:
            raise ValueError(f"joint {el.get('name')!r} missing parent/child")
        joints.append(
            UrdfJoint(
                name=el.get("name", ""),
                joint_type=el.get("type", "fixed"),
                parent=parent.get("link", ""),
                child=child.get("link", ""),
                origin_xyz=xyz,
                origin_rot=_rpy_matrix(*rpy),
                axis=ax,
                lower=float(limit.get("lower", 0.0)) if limit is not None else 0.0,
                upper=float(limit.get("upper", 0.0)) if limit is not None else 0.0,
                velocity=float(limit.get("velocity", 0.0)) if limit is not None else 0.0,
                effort=float(limit.get("effort", 0.0)) if limit is not None else 0.0,
            )
        )
    return UrdfModel(root.get("name", "robot"), links, joints)


def load_chain(
    urdf_path: str,
    base_link: Optional[str] = None,
    ee_link: Optional[str] = None,
) -> ArticulatedChain:
    """File -> ArticulatedChain (the fk_chain-ready product)."""
    return parse_urdf(urdf_path).extract_chain(base_link, ee_link)
