"""Film: filter-weighted sample splatting and develop (port of
hairpt/film/film.py). One scatter-add per filter tap and wave into an RGB
accumulator plus a weight channel; develop divides like HDRFilm.
splat_add_only is the light tracers' nearest-pixel splat. On the card a
scatter-add sums in the order its atomics land, so two runs differ in
the last bits of a pixel that takes several adds."""
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
    annotations: tuple = ()     # ((x, y, text), ...) label[] overlays
    #                             (src/films/annotations.h)
    banner: bool = False        # hdrfilm / ldrfilm banner overlay

    @staticmethod
    def make(width: int, height: int, rfilter: str = "tent",
             gamma: float = 2.2, annotations=(), banner=False) -> "Film":
        kind, radius = FILTERS[rfilter]
        return Film(width, height, kind, radius, gamma, tuple(annotations),
                    bool(banner))


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


def splat_add_only(film: Film, pos, value, image):
    """Nearest-pixel scatter-add with no weight bookkeeping, for the
    measurement-estimate splats (bdpt's t = 1 and light tracing), which
    are already normalized by the sample count (reference: hdrfilm's
    separate splat buffer with splatScale). A position off the film adds
    nothing. Returns the new image [H, W, 3]; `image` is updated in place
    and returned."""
    H, W = film.height, film.width
    ix = torch.clamp(torch.floor(pos[..., 0]).to(torch.int64), 0, W - 1)
    iy = torch.clamp(torch.floor(pos[..., 1]).to(torch.int64), 0, H - 1)
    inb = (pos[..., 0] >= 0) & (pos[..., 0] < W) \
        & (pos[..., 1] >= 0) & (pos[..., 1] < H)
    return image.index_put_((iy, ix), torch.where(inb[..., None], value,
                                                  0.0), accumulate=True)
