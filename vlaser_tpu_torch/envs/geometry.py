"""Rotation conversions (sxyz euler convention, quaternions w-x-y-z),
host-side numpy: the functions of vlaser_tpu/envs/geometry.py that
`envs.adapters` and `eval.variant_configs` reach, copied unchanged.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_EPS = np.finfo(np.float64).eps * 4.0


def euler2mat(ai: float, aj: float, ak: float) -> np.ndarray:
    """sxyz euler -> 3x3 rotation matrix (R = Rz(ak) @ Ry(aj) @ Rx(ai))."""
    si, sj, sk = math.sin(ai), math.sin(aj), math.sin(ak)
    ci, cj, ck = math.cos(ai), math.cos(aj), math.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    M = np.empty((3, 3))
    M[0, 0] = cj * ck
    M[0, 1] = sj * sc - cs
    M[0, 2] = sj * cc + ss
    M[1, 0] = cj * sk
    M[1, 1] = sj * ss + cc
    M[1, 2] = sj * cs - sc
    M[2, 0] = -sj
    M[2, 1] = cj * si
    M[2, 2] = cj * ci
    return M


def mat2euler(M: np.ndarray) -> Tuple[float, float, float]:
    """3x3 rotation matrix -> sxyz euler (inverse of euler2mat)."""
    M = np.asarray(M, dtype=np.float64)
    cy = math.sqrt(M[0, 0] * M[0, 0] + M[1, 0] * M[1, 0])
    if cy > _EPS:
        ax = math.atan2(M[2, 1], M[2, 2])
        ay = math.atan2(-M[2, 0], cy)
        az = math.atan2(M[1, 0], M[0, 0])
    else:
        ax = math.atan2(-M[1, 2], M[1, 1])
        ay = math.atan2(-M[2, 0], cy)
        az = 0.0
    return ax, ay, az


def quat2mat(q: np.ndarray) -> np.ndarray:
    """w-x-y-z quaternion -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    if n < _EPS:
        return np.eye(3)
    s = 2.0 / n
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z
    return np.array(
        [
            [1.0 - (yY + zZ), xY - wZ, xZ + wY],
            [xY + wZ, 1.0 - (xX + zZ), yZ - wX],
            [xZ - wY, yZ + wX, 1.0 - (xX + yY)],
        ]
    )


def mat2quat(M: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> w-x-y-z quaternion (Shepperd's method)."""
    M = np.asarray(M, dtype=np.float64)
    K = (
        np.array(
            [
                [M[0, 0] - M[1, 1] - M[2, 2], 0, 0, 0],
                [M[0, 1] + M[1, 0], M[1, 1] - M[0, 0] - M[2, 2], 0, 0],
                [M[0, 2] + M[2, 0], M[1, 2] + M[2, 1], M[2, 2] - M[0, 0] - M[1, 1], 0],
                [M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1],
                 M[0, 0] + M[1, 1] + M[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


def euler2quat(ai: float, aj: float, ak: float) -> np.ndarray:
    return mat2quat(euler2mat(ai, aj, ak))


def quat2euler(q: np.ndarray) -> Tuple[float, float, float]:
    return mat2euler(quat2mat(q))


def euler2axangle(ai: float, aj: float, ak: float) -> Tuple[np.ndarray, float]:
    """sxyz euler -> (unit axis, angle); used for env delta-rotation actions
    (env_adapter/simpler.py:167)."""
    return quat2axangle(euler2quat(ai, aj, ak))


def quat2axangle(q: np.ndarray) -> Tuple[np.ndarray, float]:
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = math.sqrt(x * x + y * y + z * z)
    if n < _EPS:
        return np.array([1.0, 0.0, 0.0]), 0.0
    axis = np.array([x, y, z]) / n
    angle = 2.0 * math.atan2(n, w)
    if angle > math.pi:
        angle -= 2.0 * math.pi
    return axis, angle
