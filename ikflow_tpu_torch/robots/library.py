"""Joint and collision-capsule tables of the four robots: Panda, Fetch,
FetchArm, Rizon4.

Own copy of the kinematic and collision data in
``ikflow_tpu/robots/library.py`` (tests pin the two equal). Panda reproduces
the golden zero-configuration pose ``[0.088, 0, 0.926, 0, 0.92387953,
0.38268343, 0]``; Fetch's torso lift is prismatic; FetchArm is Fetch with the
torso fixed; Rizon4 is authored from the public datasheet.

Capsules: Panda's and Fetch's are fitted to the collision meshes of the
public MuJoCo models (kitchen_franka Franka, openai Fetch); Rizon4 has
skeleton capsules between consecutive joint origins. Panda's clamped-zero
configuration is a real self-collision (the hand folds onto the forearm at
q6 = 0), so Panda calibrates its pair list on the mid-limits centre and the
Franka "ready" pose instead.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ikflow_tpu_torch.robots.chain import FIXED, PRISMATIC, REVOLUTE, Capsule, Joint, KinematicChain

_PI = math.pi
_HALF_PI = math.pi / 2.0


def _skeleton_capsules(joints: Sequence[Joint], radius: float, min_len: float = 0.04) -> List[Capsule]:
    """Capsules spanning consecutive joint origins: joint i's origin offset,
    in frame i (0 = base), for every offset of at least ``min_len``."""
    caps = []
    for i, joint in enumerate(joints):
        p1 = np.asarray(joint.xyz, dtype=np.float64)
        if np.linalg.norm(p1) >= min_len:
            caps.append(Capsule(frame_index=i, p0=(0.0, 0.0, 0.0), p1=tuple(p1), radius=radius))
    return caps

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


# Capsules fitted to the kitchen_franka collision meshes (provenance and
# validation numbers: the JAX package's ``robots/library.py``). frame_index N
# is the frame after joint N (link N); the closed fingers are folded into
# link 7's frame.
_PANDA_CAPSULES = [
    Capsule(0, (-0.0390, -0.0012, 0.0616), (-0.0496, -0.0012, 0.0565), 0.1067),
    Capsule(1, (0.0218, -0.0883, 0.0418), (0.0241, -0.1149, 0.0187), 0.0245),
    Capsule(1, (-0.0189, -0.1171, 0.0173), (-0.0250, -0.0905, 0.0392), 0.0240),
    Capsule(1, (-0.0003, -0.0747, 0.0062), (0.0022, -0.0470, 0.0171), 0.0517),
    Capsule(1, (0.0018, 0.0109, -0.1738), (0.0009, 0.0133, -0.1718), 0.0555),
    Capsule(2, (-0.0035, -0.1589, -0.0188), (-0.0259, -0.0900, -0.0536), 0.0606),
    Capsule(2, (0.0032, 0.0193, 0.0485), (0.0023, 0.0079, 0.0746), 0.0524),
    Capsule(2, (-0.0223, 0.0174, 0.1171), (-0.0258, 0.0397, 0.0902), 0.0245),
    Capsule(2, (0.0218, 0.0212, 0.1138), (0.0227, 0.0395, 0.0907), 0.0266),
    Capsule(3, (0.0602, 0.0477, -0.0122), (0.0026, 0.0028, -0.0559), 0.0755),
    Capsule(4, (-0.0222, 0.0135, 0.0488), (-0.0808, 0.0588, 0.0041), 0.0759),
    Capsule(5, (-0.0188, 0.0944, 0.0300), (-0.0024, 0.0513, 0.0452), 0.0361),
    Capsule(5, (0.0236, 0.1171, 0.0142), (0.0098, 0.1242, 0.0102), 0.0258),
    Capsule(5, (0.0001, 0.0488, -0.0686), (-0.0016, 0.0026, -0.1956), 0.0713),
    Capsule(6, (-0.0323, -0.0112, 0.0216), (-0.0352, 0.0010, 0.0201), 0.0355),
    Capsule(6, (0.0460, -0.0027, 0.0209), (0.0445, 0.0017, 0.0214), 0.0619),
    Capsule(6, (0.1101, 0.0401, -0.0046), (0.1207, -0.0064, -0.0056), 0.0415),
    Capsule(7, (-0.0005, -0.0007, 0.0820), (0.0248, 0.0251, 0.0833), 0.0476),
    Capsule(7, (0.0636, 0.0630, 0.1243), (0.0658, 0.0660, 0.1454), 0.0243),
    Capsule(7, (0.0316, 0.0231, 0.1037), (-0.0468, -0.0465, 0.0952), 0.0327),
    Capsule(7, (-0.0685, -0.0686, 0.1557), (-0.0739, -0.0708, 0.1162), 0.0165),
    Capsule(7, (0.0000, -0.0000, 0.2314), (0.0000, -0.0000, 0.1909), 0.0255),
]

# Collision-free calibration poses for the pair list. The default pair
# (centre, clamped zero) would whitelist the hand-forearm collision that the
# clamped-zero pose really has.
_PANDA_READY = [0.0, -0.785, 0.0, -2.356, 0.0, 1.571, 0.785]
_PANDA_CENTER = [0.5 * (lo + hi) for lo, hi in _PANDA_JOINT_LIMITS]


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


# Capsules fitted to the openai-fetch collision meshes. frame_index 0 is
# base_link (with the fixed torso, e-stop and laser), 1 the torso lift (with
# the head at pan/tilt zero), 2..8 the arm links, 9 the gripper with its
# fingers. Fetch and FetchArm share them: their joint lists are the same, the
# torso joint only fixed in FetchArm.
_FETCH_CAPSULES = [
    Capsule(0, (0.2236, -0.1376, 0.2352), (0.2377, -0.1164, 0.1801), 0.1624),
    Capsule(0, (0.2200, 0.1446, 0.2432), (0.2391, 0.1187, 0.1927), 0.1662),
    Capsule(0, (-0.1773, 0.1587, 0.2105), (-0.1028, 0.2029, 0.2345), 0.1899),
    Capsule(0, (-0.1618, -0.1729, 0.2189), (-0.0930, -0.2082, 0.2332), 0.1845),
    Capsule(1, (-0.0342, -0.0025, 0.4061), (-0.0315, -0.0048, 0.2237), 0.1779),
    Capsule(2, (0.0190, -0.0139, 0.0407), (0.0860, -0.0382, 0.0577), 0.0837),
    Capsule(3, (0.1107, 0.0104, 0.0000), (0.0186, 0.0455, 0.0000), 0.0701),
    Capsule(4, (0.0099, 0.0079, 0.0000), (0.1148, -0.0407, -0.0000), 0.0640),
    Capsule(5, (0.0201, 0.0448, 0.0000), (0.1114, 0.0062, -0.0000), 0.0644),
    Capsule(6, (0.0109, 0.0033, -0.0000), (0.1116, -0.0627, -0.0003), 0.0563),
    Capsule(7, (-0.0445, 0.0634, -0.0177), (-0.0072, 0.0645, -0.0466), 0.0124),
    Capsule(7, (-0.0445, 0.0635, 0.0168), (-0.0091, 0.0643, 0.0461), 0.0121),
    Capsule(7, (-0.0007, -0.0037, 0.0008), (0.0047, 0.0103, 0.0011), 0.0581),
    Capsule(7, (0.0846, 0.0358, 0.0005), (0.1049, 0.0046, 0.0010), 0.0471),
    Capsule(8, (0.0046, -0.0346, -0.0279), (0.0048, -0.0415, -0.0160), 0.0257),
    Capsule(8, (0.0039, 0.0293, -0.0342), (0.0040, 0.0164, -0.0417), 0.0251),
    Capsule(8, (0.0038, -0.0293, 0.0341), (0.0042, -0.0144, 0.0426), 0.0252),
    Capsule(8, (0.0045, 0.0348, 0.0280), (0.0048, 0.0416, 0.0159), 0.0256),
    Capsule(9, (-0.0931, -0.0008, 0.0030), (-0.0931, -0.0008, 0.0030), 0.0646),
    Capsule(1, (0.1985, -0.0218, 0.6625), (0.1936, 0.0302, 0.6638), 0.1118),
    Capsule(1, (-0.0341, -0.0686, 0.6375), (0.0346, -0.1228, 0.6630), 0.0538),
    Capsule(1, (0.0169, 0.1116, 0.6531), (-0.0493, 0.0432, 0.6382), 0.0507),
    Capsule(0, (-0.1530, 0.1480, 0.7419), (-0.1236, 0.1532, 0.4505), 0.0798),
    Capsule(0, (-0.1868, -0.1306, 0.8202), (-0.2628, 0.0330, 0.8208), 0.0459),
    Capsule(0, (-0.2765, -0.0284, 0.3585), (-0.1899, -0.1319, 0.3593), 0.0572),
    Capsule(0, (-0.2382, 0.1131, 0.3588), (-0.1497, 0.1500, 0.3593), 0.0271),
    Capsule(0, (-0.1223, 0.2337, 0.3086), (-0.1178, 0.2237, 0.3033), 0.0144),
    Capsule(0, (0.2527, -0.0068, 0.2361), (0.1993, 0.0097, 0.2339), 0.0109),
    Capsule(0, (0.2093, -0.0126, 0.2327), (0.1963, -0.0109, 0.2338), 0.0082),
    Capsule(9, (-0.0385, 0.0000, 0.0000), (-0.0385, 0.0000, 0.0000), 0.0134),
    Capsule(9, (0.0385, 0.0000, 0.0000), (0.0385, 0.0000, 0.0000), 0.0134),
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
    return KinematicChain("panda", _panda_joints(), capsules=_PANDA_CAPSULES,
                          calibration_configs=[_PANDA_CENTER, _PANDA_READY])


def make_fetch() -> KinematicChain:
    return KinematicChain("fetch", _fetch_joints(torso_actuated=True), capsules=_FETCH_CAPSULES)


def make_fetch_arm() -> KinematicChain:
    return KinematicChain("fetch_arm", _fetch_joints(torso_actuated=False), capsules=_FETCH_CAPSULES)


def make_rizon4() -> KinematicChain:
    joints = _rizon4_joints()
    return KinematicChain("rizon4", joints, capsules=_skeleton_capsules(joints, radius=0.055))


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
