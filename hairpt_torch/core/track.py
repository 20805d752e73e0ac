"""Keyframed rigid-transform animation (port of hairpt/core/track.py;
reference: include/mitsuba/core/track.h AnimatedTransform and
src/libcore/track.cpp).

A transform is decomposed into (translation, rotation quaternion, scale)
per keyframe and interpolated between keyframes: lerp for translation and
scale, slerp for rotation, the reference's model. numpy on the host in
float64. Used for the camera under an open shutter and for animated
shapes and instances, posed at each shutter time.
"""
from __future__ import annotations

import numpy as np


def mat_to_quat(m):
    """Rotation matrix [3, 3] -> quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s])
    i = np.argmax(np.diag(m))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def quat_to_mat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def decompose(m4):
    """(translation [3], rotation quaternion [4], scale [3]) of a 4 x 4
    transform; a mirrored rotation moves its sign into the x scale."""
    t = m4[:3, 3].copy()
    a = m4[:3, :3]
    s = np.linalg.norm(a, axis=0)
    r = a / np.maximum(s, 1e-12)
    if np.linalg.det(r) < 0:
        r[:, 0] *= -1
        s[0] *= -1
    return t, mat_to_quat(r), s


class AnimatedTransform:
    """Sorted keyframes of 4 x 4 transforms; eval(time) interpolates and
    clamps to the first and last keyframe outside them."""

    def __init__(self, keyframes):
        """keyframes: list of (time, 4 x 4 matrix)."""
        kf = sorted(keyframes, key=lambda x: x[0])
        self.times = np.array([k[0] for k in kf], np.float64)
        self.tr = [decompose(np.asarray(k[1], np.float64)) for k in kf]

    @classmethod
    def from_tracks(cls, times, tr) -> "AnimatedTransform":
        """The same animation from its decomposed keyframes (times and
        (translation, quaternion, scale) per keyframe, as another
        AnimatedTransform stores them), without decomposing again."""
        a = cls.__new__(cls)
        a.times = np.array(times, np.float64)
        a.tr = [tuple(np.array(x, np.float64) for x in k) for k in tr]
        return a

    def eval(self, time: float) -> np.ndarray:
        ts = self.times
        if time <= ts[0] or len(ts) == 1:
            i0 = i1 = 0
            f = 0.0
        elif time >= ts[-1]:
            i0 = i1 = len(ts) - 1
            f = 0.0
        else:
            i1 = int(np.searchsorted(ts, time))
            i0 = i1 - 1
            f = float((time - ts[i0]) / (ts[i1] - ts[i0]))
        t0, q0, s0 = self.tr[i0]
        t1, q1, s1 = self.tr[i1]
        t = t0 * (1 - f) + t1 * f
        s = s0 * (1 - f) + s1 * f
        r = quat_to_mat(slerp(q0, q1, f))
        m = np.eye(4)
        m[:3, :3] = r * s[None, :]
        m[:3, 3] = t
        return m
