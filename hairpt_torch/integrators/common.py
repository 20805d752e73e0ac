"""Scene intersection and shading records (port of the hair branch of
hairpt/integrators/common.py)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math import Ray, Frame, normalize
from ..ops import intersect_swept as iswept
from ..ops import intersect_tiled as itiled


def block_swizzle(width: int, height: int, bw: int = 8, bh: int = 8):
    """Lane -> pixel permutation in which each run of bw*bh lanes is a
    bw x bh screen block, so a 64-ray tile of the intersector stays
    spatially tight. int64 numpy [width*height], or None when the
    resolution does not tile evenly."""
    if width % bw or height % bh:
        return None
    i = np.arange(width * height, dtype=np.int64)
    per = bw * bh
    blk = i // per
    j = i % per
    bx = blk % (width // bw)
    by = blk // (width // bw)
    px = bx * bw + j % bw
    py = by * bh + j // bw
    return py * width + px


class Hit(NamedTuple):
    valid: torch.Tensor    # [N] bool
    t: torch.Tensor        # [N]
    p: torch.Tensor        # [N, 3]
    geo_n: torch.Tensor    # [N, 3]
    sh_s: torch.Tensor     # [N, 3] shading tangent (hair: fiber axis)
    sh_t: torch.Tensor     # [N, 3]
    sh_n: torch.Tensor     # [N, 3]
    mat_id: torch.Tensor   # [N] int32
    prim: torch.Tensor     # [N] sorted hair segment id, -1 = miss


def frame(hit: Hit) -> Frame:
    return Frame(s=hit.sh_s, t=hit.sh_t, n=hit.sh_n)


def _check_traversal(traversal: str):
    if traversal not in ("tiled", "swept"):
        raise NotImplementedError(f"traversal {traversal!r} is not ported "
                                  f"(only 'tiled' and 'swept')")


def scene_intersect(arr, ray: Ray, q_max: int, sort_rays: bool = False,
                    compact: bool = True, traversal: str = "tiled",
                    p_max: int = 24, chunk: int = 64) -> Hit:
    """Closest hair hit and its shading record (hit point snapped back onto
    the cylinder, as the reference's fillIntersectionRecord does).
    traversal 'tiled' queries the tiled intersector (q_max slots per
    tile, sort_rays and compact as there); 'swept' the swept traversal
    (p_max candidates per ray, chunks of `chunk` pairs), which ignores
    sort_rays and compact as the JAX package's does."""
    _check_traversal(traversal)
    n = ray.o.shape[0]
    dev = ray.o.device
    if traversal == "swept":
        t_hair, prim_hair = iswept.swept_closest_hit(
            arr.hair_swept, ray, p_max=p_max, chunk=chunk)
    else:
        t_hair, prim_hair = itiled.tiled_closest_hit(
            arr.hair_swept, ray, q_max=q_max, sort_rays=sort_rays,
            compact=compact)
    use_hair = t_hair < float("inf")
    t = torch.where(use_hair, t_hair, float("inf"))
    valid = torch.isfinite(t) & (t < ray.maxt) & (prim_hair >= 0)
    p = ray.o + ray.d * t[..., None]

    i = torch.clamp(prim_hair, min=0).long()
    p0 = arr.hair.p0[i]
    p1 = arr.hair.p1[i]
    radius = arr.hair.radius[i]
    axis = normalize(p1 - p0)
    rel = p - p0
    nrad = normalize(rel - torch.sum(axis * rel, -1, keepdim=True) * axis)
    tt = torch.linalg.cross(nrad, axis)
    local_y = torch.sum(tt * rel, dim=-1)
    local_z = torch.sum(nrad * rel, dim=-1)
    shift = radius - torch.sqrt(torch.clamp(local_y ** 2 + local_z ** 2,
                                            min=0.0))
    p_snap = p + nrad * shift[..., None]
    hair_sel = use_hair & (prim_hair >= 0)
    m = hair_sel[..., None]

    e = torch.eye(3, device=dev)
    geo_n = torch.where(m, nrad, e[2].expand(n, 3))
    return Hit(valid=valid, t=t, p=torch.where(m, p_snap, p), geo_n=geo_n,
               sh_s=torch.where(m, axis, e[0].expand(n, 3)),
               sh_t=torch.where(m, tt, e[1].expand(n, 3)),
               sh_n=geo_n,
               mat_id=torch.where(hair_sel, arr.hair_mat_id[i],
                                  torch.zeros_like(arr.hair_mat_id[i])),
               prim=torch.where(use_hair, prim_hair, -1))


def scene_occluded(arr, ray: Ray, q_max: int, sort_rays: bool = False,
                   compact: bool = True, traversal: str = "tiled",
                   p_max: int = 24, chunk: int = 64):
    """[N] bool: does the ray hit any hair segment in [mint, maxt]. The
    traversal and its parameters as in scene_intersect."""
    _check_traversal(traversal)
    if traversal == "swept":
        return iswept.swept_any_hit(arr.hair_swept, ray, p_max=p_max,
                                    chunk=chunk)
    return itiled.tiled_any_hit(arr.hair_swept, ray, q_max=q_max,
                                sort_rays=sort_rays, compact=compact)
