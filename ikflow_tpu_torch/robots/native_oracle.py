"""ctypes bindings of the float64 C++ kinematics oracle. Port of
``ikflow_tpu/robots/native_oracle.py``.

The oracle is the repo's ``native/fk_oracle.cpp``: float64 FK, the geometric
Jacobian, and a classical damped-LM IK on the host, the independent
reference that both packages are held to. The port compiles that one source
with ``g++`` into ``build/libfk_oracle.so`` at the checkout root (never into
``native/``), on first use or when the source is newer; the library is
written under a temporary name and renamed, so concurrent builds never
load half a file. Where there is no compiler or no source,
``native_available()`` is False and the constructor raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from ikflow_tpu_torch.cuda_build import BUILD_DIR
from ikflow_tpu_torch.robots.chain import FIXED, PRISMATIC, REVOLUTE, KinematicChain

SOURCE = os.path.join(os.path.dirname(BUILD_DIR), "native", "fk_oracle.cpp")
LIB_PATH = os.path.join(BUILD_DIR, "libfk_oracle.so")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
OPENMP_FLAG = "-fopenmp"  # the batch loops' pragmas; a compiler without OpenMP builds them serial
BUILD_TIMEOUT_S = 120

# The C ABI's joint type codes (fk_oracle.cpp).
_TYPE_CODE = {REVOLUTE: 0, PRISMATIC: 1, FIXED: 2}

_LIB: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile ``native/fk_oracle.cpp`` into ``build/libfk_oracle.so``, with
    OpenMP where the compiler has it, else serial."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    errors = []
    for flags in ((*CXX_FLAGS, OPENMP_FLAG), CXX_FLAGS):
        try:
            subprocess.run([os.environ.get("CXX", "g++"), *flags, "-o", tmp, SOURCE], check=True,
                           capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
            break
        except subprocess.CalledProcessError as e:
            errors.append(f"{' '.join(flags)}:\n{e.stdout}\n{e.stderr}")
    else:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n" + "\n".join(errors))
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(SOURCE):
        raise FileNotFoundError(f"the oracle's source {SOURCE} is not in this checkout")
    if not os.path.exists(LIB_PATH) or os.path.getmtime(LIB_PATH) < os.path.getmtime(SOURCE):
        build()
    lib = ctypes.CDLL(LIB_PATH)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    ub = ctypes.POINTER(ctypes.c_ubyte)
    lib.fk_model_create.restype = ctypes.c_void_p
    lib.fk_model_create.argtypes = [ctypes.c_int, dp, dp, dp, ip]
    lib.fk_model_destroy.restype = None
    lib.fk_model_destroy.argtypes = [ctypes.c_void_p]
    lib.fk_model_ndof.restype = ctypes.c_int
    lib.fk_model_ndof.argtypes = [ctypes.c_void_p]
    lib.fk_forward.restype = None
    lib.fk_forward.argtypes = [ctypes.c_void_p, dp, ctypes.c_int, dp]
    lib.fk_jacobian.restype = None
    lib.fk_jacobian.argtypes = [ctypes.c_void_p, dp, ctypes.c_int, dp, dp]
    lib.ik_lm_solve.restype = None
    lib.ik_lm_solve.argtypes = [ctypes.c_void_p, dp, dp, ctypes.c_int, ctypes.c_int,
                                ctypes.c_double, ctypes.c_double, ctypes.c_double, dp, dp, ub]
    _LIB = lib
    return lib


def native_available() -> bool:
    """True where the oracle builds (or is built) and loads."""
    try:
        _load_library()
        return True
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _doubles(a, shape_tail, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.float64)
    if a.ndim != 1 + len(shape_tail) or a.shape[1:] != shape_tail:
        raise ValueError(f"{what} must be (n, {', '.join(map(str, shape_tail))}), got {a.shape}")
    return a


class NativeFkOracle:
    """Float64 host oracle of a ``KinematicChain``: the chain's joint
    constants are marshalled from Python, so the chain stays the one source
    of truth."""

    def __init__(self, chain: KinematicChain):
        lib = _load_library()
        self._lib = lib
        self.chain = chain
        n = len(chain.joints)
        R = np.ascontiguousarray(np.stack(chain._origins_R).reshape(n, 9), dtype=np.float64)
        t = np.ascontiguousarray(np.stack(chain._origins_t), dtype=np.float64)
        axes = np.ascontiguousarray(np.stack(chain._axes), dtype=np.float64)
        types = np.array([_TYPE_CODE[j.joint_type] for j in chain.joints], dtype=np.int32)
        self._keepalive = (R, t, axes, types)
        self._model = lib.fk_model_create(n, _as_c(R), _as_c(t), _as_c(axes),
                                          types.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if not self._model:
            raise ValueError(f"the oracle rejected the chain of {chain.name} (more joints than it takes?)")
        if lib.fk_model_ndof(self._model) != chain.ndof:
            raise ValueError(f"the oracle counts {lib.fk_model_ndof(self._model)} dof for {chain.name}, "
                             f"the chain {chain.ndof}")

    def __del__(self):
        model = getattr(self, "_model", None)
        if model:
            self._lib.fk_model_destroy(model)

    def forward_kinematics(self, q) -> np.ndarray:
        """(n, ndof) -> (n, 7) poses [x, y, z, qw, qx, qy, qz], float64."""
        q = _doubles(q, (self.chain.ndof,), "q")
        out = np.empty((q.shape[0], 7), dtype=np.float64)
        self._lib.fk_forward(self._model, _as_c(q), q.shape[0], _as_c(out))
        return out

    def fk_pose_and_jacobian(self, q) -> Tuple[np.ndarray, np.ndarray]:
        """(n, ndof) -> poses (n, 7) and geometric Jacobians (n, 6, ndof)."""
        q = _doubles(q, (self.chain.ndof,), "q")
        n, nd = q.shape
        pose = np.empty((n, 7), dtype=np.float64)
        jac = np.empty((n, 6, nd), dtype=np.float64)
        self._lib.fk_jacobian(self._model, _as_c(q), n, _as_c(pose), _as_c(jac))
        return pose, jac

    def ik_lm(self, target_poses, q0, max_iters: int = 50, lambd: float = 1e-4, pos_tol: float = 1e-3,
              rot_tol: float = 0.01, clamp_to_limits: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Classical damped-LM IK from seeds ``q0`` on the host. -> (q, valid)."""
        q = _doubles(q0, (self.chain.ndof,), "q0").copy()
        n = q.shape[0]
        targets = _doubles(target_poses, (7,), "target_poses")
        if targets.shape[0] != n:
            raise ValueError(f"{targets.shape[0]} targets for {n} seeds")
        valid = np.zeros(n, dtype=np.uint8)
        low = np.ascontiguousarray(self.chain._limits_low, dtype=np.float64)
        high = np.ascontiguousarray(self.chain._limits_high, dtype=np.float64)
        self._lib.ik_lm_solve(
            self._model, _as_c(targets), _as_c(q), n, max_iters, lambd, pos_tol, rot_tol,
            _as_c(low) if clamp_to_limits else None, _as_c(high) if clamp_to_limits else None,
            valid.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        )
        return q, valid.astype(bool)
