"""Colorimetry (numpy copy of hairpt/core/spectral.py): the CIE matching
functions the sun bake and the scene loader's spectra need, and the
spectral render's bins, its RGB integration weights, its corrected
RGB -> SPD upsampling basis and Cauchy dispersion
(integrators/spectral.py)."""
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


def bin_centers(n_bins: int):
    """n_bins uniform bin centres over [LAM_MIN, LAM_MAX] and the bin
    width."""
    edges = np.linspace(LAM_MIN, LAM_MAX, n_bins + 1)
    return 0.5 * (edges[:-1] + edges[1:]), edges[1] - edges[0]


def _raw_bases(lam):
    """Smooth non-negative primaries (roughly sRGB-hued Gaussians), the
    upsampling basis before its correction. [..., 3]."""
    lam = np.asarray(lam, np.float64)
    r = _g(lam, 615.0, 45.0, 55.0) + 0.12 * _g(lam, 430.0, 25.0, 25.0)
    g = _g(lam, 545.0, 40.0, 45.0)
    b = _g(lam, 462.0, 28.0, 38.0)
    return np.stack([r, g, b], axis=-1)


def rgb_weights(n_bins: int):
    """(W [n_bins, 3], lam, dl): per-bin radiance S [..., n_bins]
    integrates to linear sRGB as S @ W. The CIE functions through
    XYZ -> sRGB, each column normalised so a flat spectrum gives exactly
    (1, 1, 1)."""
    lam, dl = bin_centers(n_bins)
    cm = cmf_xyz(lam)
    W = (cm * dl) @ XYZ_TO_RGB.T
    W = W / np.sum(W, axis=0, keepdims=True)
    return W, lam, dl


def upsample_basis(n_bins: int):
    """(A [n_bins, 3], lam, dl): spd = clip(A @ rgb, 0), corrected so
    that W.T @ A = I (M = W.T @ B, A = B @ inv(M)): integrating an
    upsampled colour with rgb_weights gives the colour back."""
    lam, dl = bin_centers(n_bins)
    B = _raw_bases(lam)
    W, _, _ = rgb_weights(n_bins)
    M = W.T @ B
    A = B @ np.linalg.inv(M)
    return A, lam, dl


def cauchy_eta(eta_d, b_um2, lam_nm):
    """Cauchy dispersion eta(lam) = eta_d + B (1 / lam^2 - 1 / lam_d^2),
    lam in um, lam_d = 589.3 nm (the sodium D line); b_um2 the Cauchy B
    coefficient in um^2 (about 0.0042 for BK7)."""
    lam_um = np.asarray(lam_nm, np.float64) / 1000.0
    return eta_d + b_um2 * (1.0 / lam_um ** 2 - 1.0 / 0.5893 ** 2)
