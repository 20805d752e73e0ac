"""RGB spectrum helpers and the spectra of the scene XML (port of
hairpt/core/spectrum.py). The traced helpers (luminance, the sRGB and
power-law gamma curves, the Planckian-locus blackbody_rgb) work on
tensors; the `<spectrum>` tag's 'lambda:value' form (an
InterpolatedSpectrum integrated to linear sRGB) and the `<blackbody>`
tag's exact Planck spectrum are numpy on the host, once per scene load."""
from __future__ import annotations

import numpy as np
import torch

from . import spectral


def luminance(rgb):
    """ITU-R BT.709 luminance of [..., 3] (Spectrum::getLuminance)."""
    w = torch.tensor([0.212671, 0.715160, 0.072169], dtype=rgb.dtype,
                     device=rgb.device)
    return (rgb * w).sum(-1)


def srgb_gamma(x):
    """Linear -> sRGB transfer curve (src/libcore/bitmap.cpp)."""
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=1e-8),
                                         1.0 / 2.4) - 0.055)


def inv_srgb_gamma(y):
    y = torch.clamp(y, 0.0, 1.0)
    return torch.where(y <= 0.04045, y / 12.92,
                       torch.pow((y + 0.055) / 1.055, 2.4))


def gamma_encode(x, gamma: float):
    """The power-law gamma of ldrfilm (2.2 in every reference scene)."""
    return torch.pow(torch.clamp(x, 0.0, 1.0), 1.0 / gamma)


def blackbody_rgb(temperature_k):
    """The Planckian-locus fit (Tanner Helland's) of a blackbody's colour:
    linear RGB [..., 3] of unit luminance. The exact spectrum is
    blackbody_rgb_exact."""
    t = torch.clamp(temperature_k, 1000.0, 40000.0) / 100.0
    r = torch.where(t <= 66.0, 255.0, 329.698727446 * torch.pow(
        torch.clamp(t - 60.0, min=1e-3), -0.1332047592))
    g = torch.where(
        t <= 66.0,
        99.4708025861 * torch.log(torch.clamp(t, min=1e-3)) - 161.1195681661,
        288.1221695283 * torch.pow(torch.clamp(t - 60.0, min=1e-3),
                                   -0.0755148492))
    b = torch.where(t >= 66.0, 255.0, torch.where(
        t <= 19.0, 0.0,
        138.5177312231 * torch.log(torch.clamp(t - 10.0, min=1e-3))
        - 305.0447927307))
    rgb = torch.clamp(torch.stack([r, g, b], -1) / 255.0, 0.0, 1.0) ** 2.2
    return rgb / torch.clamp(luminance(rgb), min=1e-6)[..., None]


def planck_radiance(lam_nm, temperature_k):
    """Planck's law: spectral radiance of a blackbody in W / (m^2 sr nm)
    (reference spectrum.cpp:1528 BlackBodySpectrum::eval), float64."""
    h = 6.62607015e-34          # Planck constant [J s] (SI 2019 exact)
    c = 299792458.0             # speed of light [m/s]
    kb = 1.380649e-23           # Boltzmann constant [J/K]
    lam = np.asarray(lam_nm, np.float64) * 1e-9
    t = np.asarray(temperature_k, np.float64)
    x = h * c / (lam * kb * np.maximum(t, 1e-6))
    # expm1 keeps the long-wavelength (x -> 0) limit exact
    return (2.0 * h * c * c) / (lam ** 5 * np.expm1(x)) * 1e-9


def blackbody_rgb_exact(temperature_k, scale: float = 1.0):
    """Planck's law integrated against the CIE colour matching functions
    over [380, 720] nm -> linear sRGB, in absolute radiometric scale times
    `scale`."""
    lam = np.linspace(spectral.LAM_MIN, spectral.LAM_MAX, 512)
    spd = planck_radiance(lam, temperature_k)
    cm = spectral.cmf_xyz(lam)
    dl = lam[1] - lam[0]
    xyz = np.sum(spd[..., None] * cm, axis=-2) * dl
    rgb = xyz @ spectral.XYZ_TO_RGB.T
    return np.maximum(rgb, 0.0) * scale


class InterpolatedSpectrum:
    """Piecewise-linear spectrum over irregular wavelength samples, zero
    outside the sampled range (reference spectrum.cpp
    InterpolatedSpectrum)."""

    def __init__(self, wavelengths, values):
        w = np.asarray(wavelengths, np.float64)
        v = np.asarray(values, np.float64)
        order = np.argsort(w)
        self.w = w[order]
        self.v = v[order]
        if len(self.w) < 2:
            raise ValueError("InterpolatedSpectrum needs >= 2 samples")

    @classmethod
    def from_string(cls, s: str):
        """Parse the scene XML's 'l1:v1, l2:v2, ...' form."""
        pairs = [p for p in s.replace(",", " ").split() if p]
        w, v = [], []
        for p in pairs:
            a, b = p.split(":")
            w.append(float(a))
            v.append(float(b))
        return cls(w, v)

    def eval(self, lam):
        lam = np.asarray(lam, np.float64)
        out = np.interp(lam, self.w, self.v)
        return np.where((lam < self.w[0]) | (lam > self.w[-1]), 0.0, out)

    def to_rgb(self):
        """Integrate against the CIE CMFs -> linear sRGB, normalised by the
        CIE-Y integral so a flat unit spectrum maps to luminance 1."""
        lam = np.linspace(max(spectral.LAM_MIN, self.w[0]),
                          min(spectral.LAM_MAX, self.w[-1]), 512)
        spd = self.eval(lam)
        cm = spectral.cmf_xyz(lam)
        dl = lam[1] - lam[0]
        xyz = np.sum(spd[:, None] * cm, axis=0) * dl
        lam_full = np.linspace(spectral.LAM_MIN, spectral.LAM_MAX, 512)
        y_norm = np.sum(spectral.cmf_xyz(lam_full)[:, 1]) \
            * (lam_full[1] - lam_full[0])
        return np.maximum(xyz / y_norm @ spectral.XYZ_TO_RGB.T, 0.0)
