"""Bitmap resampling with the reconstruction-filter library (port of
hairpt/utils/resample.py).

Counterpart of the reference's Bitmap::resample / Resampler<Scalar>
(include/mitsuba/core/bitmap.h:1040-1090, src/libcore/bitmap.cpp:
2230-2300, core/rfilter.h): separable filtered resampling as two dense
products, out = W_y img W_x^T, on the image's device. The boundary
conditions (clamp, wrap, mirror, zero) fold into the weight matrices,
which are built on the host; an optional range clamp suppresses the
ringing of negative-lobe filters as the reference's min/max clamp does.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..film.rfilter import FILTERS, filter_eval

BOUNDARIES = ("clamp", "wrap", "mirror", "zero")


def _filter_1d(kind: int, x: np.ndarray, radius: float) -> np.ndarray:
    """1-D filter profile through the separable 2-D eval at dy = 0 (the
    f(0) factor cancels in the row normalization), in float32 as the JAX
    package evaluates it."""
    xt = torch.as_tensor(np.asarray(x, np.float32))
    w = filter_eval(kind, radius, xt, torch.zeros_like(xt))
    return w.numpy().astype(np.float64)


def resample_matrix(filter_name: str, src_n: int, dst_n: int,
                    boundary: str = "clamp") -> np.ndarray:
    """[dst_n, src_n] row-normalized resampling weights for one axis.

    Downsampling widens the kernel by the scale factor (a low-pass), as
    the reference Resampler's `filterRadius * scale` path does."""
    if boundary not in BOUNDARIES:
        raise ValueError(f"boundary must be one of {BOUNDARIES}")
    kind, radius = FILTERS[filter_name]
    scale = src_n / dst_n
    kscale = max(1.0, scale)          # kernel dilation when minifying
    r = radius * kscale
    W = np.zeros((dst_n, src_n), np.float64)
    j = np.arange(dst_n)
    centers = (j + 0.5) * scale       # target centres in source coordinates
    lo = np.floor(centers - r + 0.5).astype(np.int64)
    hi = np.ceil(centers + r - 0.5).astype(np.int64)
    n_tap = int((hi - lo).max()) + 1
    taps = lo[:, None] + np.arange(n_tap)[None, :]          # [dst, taps]
    off = (taps + 0.5 - centers[:, None]) / kscale
    w = _filter_1d(kind, off.astype(np.float32), radius)
    if boundary == "clamp":
        idx = np.clip(taps, 0, src_n - 1)
    elif boundary == "wrap":
        idx = np.mod(taps, src_n)
    elif boundary == "mirror":
        period = 2 * src_n
        m = np.mod(taps, period)
        idx = np.where(m < src_n, m, period - 1 - m)
    else:                              # zero: drop the out-of-range taps
        inside = (taps >= 0) & (taps < src_n)
        w = np.where(inside, w, 0.0)
        idx = np.clip(taps, 0, src_n - 1)
    np.add.at(W, (np.repeat(j, n_tap), idx.reshape(-1)), w.reshape(-1))
    s = W.sum(axis=1, keepdims=True)
    # zero-boundary rows fully outside keep their (partial) mass; the
    # others normalize to preserve constants (bitmap.cpp normalizes each
    # row in Resampler's constructor)
    W = np.where(s > 1e-9, W / np.maximum(s, 1e-9), W)
    return W.astype(np.float32)


def resample(img, width: int, height: int, filter_name: str = "lanczos",
             boundary: str = "clamp", clamp=None, device=None):
    """Resample an [H, W] or [H, W, C] image (a tensor, on its device, or
    an array, on `device`: the card unless "cpu") to (height, width).

    clamp=(lo, hi) bounds the output (ringing suppression for
    negative-lobe filters, bitmap.h:1066 minValue / maxValue); clamp="auto"
    clamps each channel to the source's range."""
    if not torch.is_tensor(img):
        img = torch.as_tensor(np.asarray(img, np.float32),
                              device=resolve_device(device))
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    H, W0, C = img.shape
    dev = img.device
    Wy = torch.as_tensor(resample_matrix(filter_name, H, height, boundary),
                         device=dev)
    Wx = torch.as_tensor(resample_matrix(filter_name, W0, width, boundary),
                         device=dev)
    mid = (Wy @ img.reshape(H, W0 * C)).reshape(height, W0, C)    # rows
    mid = mid.transpose(0, 1).reshape(W0, height * C)
    out = (Wx @ mid).reshape(width, height, C).transpose(0, 1)    # cols
    if clamp == "auto":
        lo = img.amin(dim=(0, 1))
        hi = img.amax(dim=(0, 1))
        out = torch.minimum(torch.maximum(out, lo), hi)
    elif clamp is not None:
        out = torch.clamp(out, clamp[0], clamp[1])
    return out[..., 0] if squeeze else out
