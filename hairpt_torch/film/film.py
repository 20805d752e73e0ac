"""Film: filter-weighted sample splatting and develop (port of
hairpt/film/film.py). One scatter-add per filter tap and wave into an RGB
accumulator plus a weight channel; develop divides like HDRFilm."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .rfilter import FILTERS, filter_eval


class Film(NamedTuple):
    width: int
    height: int
    filter_kind: int
    filter_radius: float
    gamma: float = 2.2

    @staticmethod
    def make(width: int, height: int, rfilter: str = "tent",
             gamma: float = 2.2) -> "Film":
        kind, radius = FILTERS[rfilter]
        return Film(width, height, kind, radius, gamma)


def splat_samples(film: Film, pos, value, image, weight):
    """Scatter-add filtered samples. pos [N, 2] (pixel centres at i+0.5),
    value [N, 3]; returns the new image [H, W, 3] and weight [H, W]. The
    adds are out of place, so `value` may carry a gradient to the film."""
    radius = film.filter_radius
    n_taps = int(math.ceil(2.0 * radius)) + 1
    x = pos[..., 0]
    y = pos[..., 1]
    x0 = torch.ceil(x - radius - 0.5).to(torch.int64)
    y0 = torch.ceil(y - radius - 0.5).to(torch.int64)
    H, W = film.height, film.width
    img = image.reshape(-1, 3)
    wt = weight.reshape(-1)
    for ty in range(n_taps):
        iy = y0 + ty
        cy = iy.to(torch.float32) + 0.5
        for tx in range(n_taps):
            ix = x0 + tx
            cx = ix.to(torch.float32) + 0.5
            w = filter_eval(film.filter_kind, radius, cx - x, cy - y)
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            w = torch.where(valid, w, 0.0)
            flat = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
            img = img.index_add(0, flat, w[..., None] * value)
            wt = wt.index_add(0, flat, w)
    return img.view(H, W, 3), wt.view(H, W)


def develop(image, weight):
    """Weighted-average normalize (HDRFilm::develop semantics)."""
    return image / torch.clamp(weight, min=1e-8)[..., None]


def zeros(film: Film, device):
    return (torch.zeros((film.height, film.width, 3), device=device),
            torch.zeros((film.height, film.width), device=device))
