"""Joint tables of the four robots: Panda, Fetch, FetchArm, Rizon4.

Own copy of the kinematic data in ``ikflow_tpu/robots/library.py`` (a test
pins the two equal). Panda reproduces the golden zero-configuration pose
``[0.088, 0, 0.926, 0, 0.92387953, 0.38268343, 0]``; Fetch's torso lift is
prismatic; FetchArm is Fetch with the torso fixed; Rizon4 is authored from
the public datasheet. Collision capsules are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from ikflow_tpu_torch.robots.chain import FIXED, PRISMATIC, REVOLUTE, Joint, KinematicChain

_PI = math.pi
_HALF_PI = math.pi / 2.0

_PANDA_JOINT_LIMITS = [
    (-2.8973, 2.8973),
    (-1.7628, 1.7628),
    (-2.8973, 2.8973),
    (-3.0718, -0.0698),
    (-2.8973, 2.8973),
    (-0.0175, 3.7525),
    (-2.8973, 2.8973),
]


def _panda_joints() -> List[Joint]:
    lims = _PANDA_JOINT_LIMITS
    return [
        Joint("panda_joint1", (0, 0, 0.333), (0, 0, 0), (0, 0, 1), REVOLUTE, lims[0]),
        Joint("panda_joint2", (0, 0, 0), (-_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[1]),
        Joint("panda_joint3", (0, -0.316, 0), (_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[2]),
        Joint("panda_joint4", (0.0825, 0, 0), (_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[3]),
        Joint("panda_joint5", (-0.0825, 0.384, 0), (-_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[4]),
        Joint("panda_joint6", (0, 0, 0), (_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[5]),
        Joint("panda_joint7", (0.088, 0, 0), (_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[6]),
        Joint("panda_joint8", (0, 0, 0.107), (0, 0, 0), (0, 0, 1), FIXED),
        Joint("panda_hand_joint", (0, 0, 0), (0, 0, -_PI / 4), (0, 0, 1), FIXED),
    ]


def _fetch_joints(torso_actuated: bool) -> List[Joint]:
    torso_type = PRISMATIC if torso_actuated else FIXED
    torso_limits = (0.0, 0.38615) if torso_actuated else None
    return [
        Joint("torso_lift_joint", (-0.086875, 0, 0.37743), (0, 0, 0), (0, 0, 1), torso_type, torso_limits),
        Joint("shoulder_pan_joint", (0.119525, 0, 0.34858), (0, 0, 0), (0, 0, 1), REVOLUTE, (-1.6056, 1.6056)),
        Joint("shoulder_lift_joint", (0.117, 0, 0.06), (0, 0, 0), (0, 1, 0), REVOLUTE, (-1.221, 1.518)),
        Joint("upperarm_roll_joint", (0.219, 0, 0), (0, 0, 0), (1, 0, 0), REVOLUTE, (-_PI, _PI)),
        Joint("elbow_flex_joint", (0.133, 0, 0), (0, 0, 0), (0, 1, 0), REVOLUTE, (-2.251, 2.251)),
        Joint("forearm_roll_joint", (0.197, 0, 0), (0, 0, 0), (1, 0, 0), REVOLUTE, (-_PI, _PI)),
        Joint("wrist_flex_joint", (0.1245, 0, 0), (0, 0, 0), (0, 1, 0), REVOLUTE, (-2.16, 2.16)),
        Joint("wrist_roll_joint", (0.1385, 0, 0), (0, 0, 0), (1, 0, 0), REVOLUTE, (-_PI, _PI)),
        Joint("gripper_axis", (0.16645, 0, 0), (0, 0, 0), (0, 0, 1), FIXED),
    ]


_RIZON4_JOINT_LIMITS = [
    (-2.7925, 2.7925),
    (-2.2689, 2.2689),
    (-2.7925, 2.7925),
    (-2.2689, 2.2689),
    (-2.7925, 2.7925),
    (-2.2689, 2.2689),
    (-2.7925, 2.7925),
]


def _rizon4_joints() -> List[Joint]:
    lims = _RIZON4_JOINT_LIMITS
    return [
        Joint("rizon_joint1", (0, 0, 0.155), (0, 0, 0), (0, 0, 1), REVOLUTE, lims[0]),
        Joint("rizon_joint2", (0, 0.03, 0.21), (_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[1]),
        Joint("rizon_joint3", (0, 0.035, 0.205), (-_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[2]),
        Joint("rizon_joint4", (0, -0.03, 0.19), (_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[3]),
        Joint("rizon_joint5", (0, 0.025, 0.195), (-_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[4]),
        Joint("rizon_joint6", (0, 0.03, 0.19), (_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[5]),
        Joint("rizon_joint7", (0, -0.055, 0.07), (-_HALF_PI, 0, 0), (0, 0, 1), REVOLUTE, lims[6]),
        Joint("rizon_flange", (0, 0, 0.081), (0, 0, 0), (0, 0, 1), FIXED),
    ]


def make_panda() -> KinematicChain:
    return KinematicChain("panda", _panda_joints())


def make_fetch() -> KinematicChain:
    return KinematicChain("fetch", _fetch_joints(torso_actuated=True))


def make_fetch_arm() -> KinematicChain:
    return KinematicChain("fetch_arm", _fetch_joints(torso_actuated=False))


def make_rizon4() -> KinematicChain:
    return KinematicChain("rizon4", _rizon4_joints())


_ROBOT_FACTORIES = {
    "panda": make_panda,
    "fetch": make_fetch,
    "fetch_arm": make_fetch_arm,
    "rizon4": make_rizon4,
}

_ROBOT_CACHE: Dict[str, KinematicChain] = {}


def robot_names() -> Tuple[str, ...]:
    return tuple(_ROBOT_FACTORIES)


def get_robot(name: str) -> KinematicChain:
    """Robot by name, built once (chains are immutable)."""
    if name not in _ROBOT_FACTORIES:
        raise ValueError(f"unknown robot {name!r}; available: {sorted(_ROBOT_FACTORIES)}")
    if name not in _ROBOT_CACHE:
        _ROBOT_CACHE[name] = _ROBOT_FACTORIES[name]()
    return _ROBOT_CACHE[name]
