"""Out-of-core banded rendering into a streamed scanline EXR (port of
hairpt/film/tiled.py).

Counterpart of the reference's tiledhdrfilm (src/films/tiledhdrfilm.cpp),
which merges image blocks into an out-of-core EXR so that a huge film is
never resident. Here the image is rendered in horizontal bands of rows:
one path-tracing wave per (band, sample) over that band's pixels, each
finished band developed and appended to the EXR through
utils/exr.ExrScanlineWriter. Peak film memory is one band plus a
filter-radius apron, whatever the output's size.

The seams: samples within apron = ceil(filter radius) rows of a band's
edge also reach the neighbouring band, so each band renders rows
[y0 - apron, y1 + apron) (the sampler is stateless, so an overlapping
row gives the same samples in both bands) and writes rows [y0, y1).
Every written pixel receives the same filtered contributions as in a
monolithic render; rows clamped into the image are pushed off the band
film and add nothing.
"""
from __future__ import annotations

import math

import torch

from ..utils import stats
from ..utils.exr import ExrScanlineWriter
from . import film as film_mod


def render_tiled_exr(scene, path: str, band_rows: int = 64, seed: int = 0,
                     spp: int | None = None, compression: str = "zip",
                     half: bool = True):
    """Render `scene` with the path integrator band by band, streaming the
    scanlines to the EXR at `path`; the image goes straight to disk.
    band_rows is rounded down to a multiple of the writer's lines per
    block (16 under zip compression, at least one block). The band
    waves' rays (the aprons' included), lanes and waves, and the render
    time and rate are recorded in utils/stats under "Path tracer", as
    path.render records a monolithic render's."""
    from ..integrators.path import make_li_fn

    cfg = scene.config
    fl = scene.film
    W, H = cfg.width, cfg.height
    spp = spp if spp is not None else cfg.spp
    dev = scene.arrays.device
    apron = int(math.ceil(fl.filter_radius))
    writer = ExrScanlineWriter(path, H, W, 3, half=half,
                               compression=compression)
    # the writer's blocks span lpb rows: align the bands to them
    band_rows = max(writer.lpb, (band_rows // writer.lpb) * writer.lpb)
    li_fn = make_li_fn(scene)
    n_band = band_rows + 2 * apron
    band_film = fl._replace(height=n_band)
    cols = torch.arange(W, device=dev)
    total_rays = 0.0
    n_waves = 0
    stats.start_timer("render")
    for y0 in range(0, H, band_rows):
        y1 = min(y0 + band_rows, H)
        ya = y0 - apron
        rows = ya + torch.arange(n_band, device=dev)
        dead = ((rows < 0) | (rows >= H))[:, None].expand(n_band, W) \
            .reshape(-1)
        pix = (torch.clamp(rows, 0, H - 1)[:, None] * W
               + cols[None, :]).reshape(-1)
        image = torch.zeros((n_band, W, 3), device=dev)
        weight = torch.zeros((n_band, W), device=dev)
        for s in range(spp):
            sample_idx = torch.full(pix.shape, s + seed * 65536,
                                    dtype=torch.int64, device=dev)
            radiance, pos, n_rays = li_fn(scene.arrays, pix, sample_idx)
            radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0,
                                        neginf=0.0)
            # band-local y; the clamped duplicate rows go far off the film
            local = torch.stack([pos[:, 0], pos[:, 1] - float(ya)], -1)
            local = torch.where(dead[:, None], -1e6, local)
            image, weight = film_mod.splat_samples(band_film, local,
                                                   radiance, image, weight)
            total_rays += float(n_rays)
            n_waves += 1
        band = film_mod.develop(image, weight).cpu().numpy()
        writer.write_band(y0, band[apron:apron + (y1 - y0)])
    writer.close()
    lanes = float(n_band * W) * n_waves
    stats.stop_timer("Path tracer", "render", total_rays, "rays")
    stats.record("Path tracer", "Rays traced", total_rays)
    stats.record("Path tracer", "Camera samples", lanes)
    stats.record("Path tracer", "Rays per camera sample", total_rays, lanes,
                 kind="average")
    stats.record("Path tracer", "Sample waves", n_waves)
