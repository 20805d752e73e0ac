"""Colorimetry the sun bake and the scene loader's spectra need (numpy
copy of the matching part of hairpt/core/spectral.py)."""
from __future__ import annotations

import numpy as np

LAM_MIN = 380.0
LAM_MAX = 720.0

# linear sRGB <-> XYZ (D65 white), IEC 61966-2-1
XYZ_TO_RGB = np.array([
    [3.2404542, -1.5371385, -0.4985314],
    [-0.9692660, 1.8760108, 0.0415560],
    [0.0556434, -0.2040259, 1.0572252]])


def _g(x, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return np.exp(-0.5 * ((x - mu) / s) ** 2)


def cmf_xyz(lam):
    """CIE 1931 2-degree colour matching functions at wavelengths lam [nm]
    (Wyman, Sloan & Shirley 2013 multi-lobe Gaussian fit). [..., 3]."""
    lam = np.asarray(lam, np.float64)
    x = (1.056 * _g(lam, 599.8, 37.9, 31.0)
         + 0.362 * _g(lam, 442.0, 16.0, 26.7)
         - 0.065 * _g(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _g(lam, 568.8, 46.9, 40.5)
         + 0.286 * _g(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _g(lam, 437.0, 11.8, 36.0)
         + 0.681 * _g(lam, 459.0, 26.0, 13.8))
    return np.stack([x, y, z], axis=-1)
