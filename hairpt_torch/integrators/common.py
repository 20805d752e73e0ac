"""Scene intersection and shading records (port of
hairpt/integrators/common.py): the triangles through the packed BVH walk,
the hair through the tiled (under 'tiled_sub' with kernel A culling the
sub-cluster boxes), swept or packed traversal, both through the per-ray
or the blocked walk under traversal 'perray' or 'blocked', the instanced
meshes through the two-level walk, and the shading record of the nearest
hit (a triangle's area-light index included)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math import Ray, Frame, dot, frame_from_normal, normalize
from ..ops import instancing as inst_mod
from ..ops import intersect as isec
from ..ops import intersect_blocked as iblk
from ..ops import intersect_packed as ipk
from ..ops import intersect_swept as iswept
from ..ops import intersect_tiled as itiled
from ..scene.scene import TRAVERSALS


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
    valid: torch.Tensor       # [N] bool
    t: torch.Tensor           # [N]
    p: torch.Tensor           # [N, 3]
    geo_n: torch.Tensor       # [N, 3]
    sh_s: torch.Tensor        # [N, 3] shading tangent (hair: fiber axis)
    sh_t: torch.Tensor        # [N, 3]
    sh_n: torch.Tensor        # [N, 3]
    uv: torch.Tensor          # [N, 2]
    mat_id: torch.Tensor      # [N] int32
    emitter_id: torch.Tensor  # [N] int32 area-light index, -1 = none
    is_hair: torch.Tensor     # [N] bool
    uv_density: torch.Tensor  # [N] the triangle's uv density (0 off it)
    bary: torch.Tensor        # [N, 2] triangle barycentrics (b1, b2)
    vcolor: torch.Tensor      # [N, 3] interpolated vertex colours (1 off)
    prim: torch.Tensor        # [N] sorted prim id (the hair table's where
    #                           is_hair, the prototype-local id on an
    #                           instance, else the triangles'), -1 = miss


def frame(hit: Hit) -> Frame:
    return Frame(s=hit.sh_s, t=hit.sh_t, n=hit.sh_n)


def _check_traversal(traversal: str):
    if traversal not in TRAVERSALS:
        raise ValueError(f"traversal {traversal!r} is not one of "
                         f"{TRAVERSALS}")


def _pad_ray(ray: Ray, block: int):
    """(ray padded to a multiple of block, its length before): the padding
    rays start at 0 along +z with mint = maxt = 0 (the JAX package's
    _pad_ray)."""
    n = ray.o.shape[0]
    pad = (-n) % block
    if pad == 0:
        return ray, n
    z3 = torch.zeros((pad, 3), dtype=ray.o.dtype, device=ray.o.device)
    zd = z3.clone()
    zd[:, 2] = 1.0
    z = torch.zeros((pad,), dtype=ray.mint.dtype, device=ray.o.device)
    return Ray(o=torch.cat([ray.o, z3]), d=torch.cat([ray.d, zd]),
               mint=torch.cat([ray.mint, z]),
               maxt=torch.cat([ray.maxt, z])), n


def _walk(arr, leaf: str, ray: Ray, traversal: str, block: int,
          any_hit: bool):
    """One kind's closest hit (t, sorted prim) or any hit over its tree:
    the per-ray walk (kernel H) under 'perray', the blocked walk (kernel
    I; rays padded to a multiple of block) under 'blocked', else the
    packed walk (kernel F)."""
    geom = arr.tri if leaf == "tri" else arr.hair
    if traversal == "perray":
        bvh = arr.tri_bvh if leaf == "tri" else arr.hair_bvh
        return (isec.any_hit if any_hit else isec.closest_hit)(
            bvh, geom, leaf, ray)
    if traversal == "blocked":
        bvh = arr.tri_bvh if leaf == "tri" else arr.hair_bvh
        pray, n = _pad_ray(ray, block)
        if any_hit:
            return iblk.any_hit_blocked(bvh, geom, leaf, pray, block)[:n]
        t, prim = iblk.closest_hit_blocked(bvh, geom, leaf, pray, block)
        return t[:n], prim[:n]
    packed = arr.tri_packed if leaf == "tri" else arr.hair_packed
    return (ipk.any_hit_packed if any_hit else ipk.closest_hit_packed)(
        packed, leaf, ray)


def scene_intersect(arr, ray: Ray, q_max: int, sort_rays: bool = False,
                    compact: bool = True, traversal: str = "tiled",
                    p_max: int = 24, chunk: int = 64,
                    block: int = 256, short_t: float = 0.0) -> Hit:
    """Closest hit against the triangles and the hair, and its shading
    record. The triangles are walked first (the packed walk; the per-ray
    or the blocked walk under 'perray' or 'blocked'); the hair
    ray's maxt is clipped to the triangle hit. traversal 'tiled' queries
    the hair through the tiled intersector (q_max slots per tile,
    sort_rays, compact and short_t as there), 'tiled_sub' likewise with
    subcull, 'swept' through the swept traversal
    (p_max candidates per ray, chunks of `chunk` pairs), which ignores
    sort_rays and compact as the JAX package's does, 'packed' through the
    packed walk, 'perray' and 'blocked' (blocks of `block` rays) through
    those walks. The instances are walked last (the two-level walk), up
    to the nearer of the triangle and hair hits. A triangle hit's
    barycentrics, interpolated normal, uv and vertex colours are
    recomputed for the chosen triangle and its geometric normal turned
    into the shading normal's hemisphere, an instanced hit's likewise in
    its prototype's object space (its uv_density stays 0, its vertex
    colour 1); a hair hit's point is snapped back onto the cylinder, as
    the reference's fillIntersectionRecord does."""
    _check_traversal(traversal)
    n = ray.o.shape[0]
    dev = ray.o.device
    inf = torch.full((n,), float("inf"), device=dev)
    none = torch.full((n,), -1, dtype=torch.int32, device=dev)
    t_tri, prim_tri = inf, none
    if arr.tri is not None:
        t_tri, prim_tri = _walk(arr, "tri", ray, traversal, block, False)
    t_hair, prim_hair = inf, none
    if arr.hair is not None:
        hair_ray = ray if arr.tri is None \
            else ray._replace(maxt=torch.minimum(ray.maxt, t_tri))
        if traversal == "swept":
            t_hair, prim_hair = iswept.swept_closest_hit(
                arr.hair_swept, hair_ray, p_max=p_max, chunk=chunk)
        elif traversal in ("packed", "perray", "blocked"):
            t_hair, prim_hair = _walk(arr, "hair", hair_ray, traversal,
                                      block, False)
        else:
            t_hair, prim_hair = itiled.tiled_closest_hit(
                arr.hair_swept, hair_ray, q_max=q_max, sort_rays=sort_rays,
                compact=compact, subcull=traversal == "tiled_sub",
                short_t=short_t)
    t_inst, prim_inst, which_inst = inf, none, none
    if arr.inst is not None:
        iray = ray._replace(maxt=torch.minimum(
            ray.maxt, torch.minimum(t_tri, t_hair)))
        t_inst, prim_inst, which_inst = inst_mod.inst_closest_hit(arr.inst,
                                                                  iray)
    use_hair = t_hair < t_tri
    use_inst = (t_inst < t_hair) & (t_inst < t_tri)
    t = torch.where(use_inst, t_inst, torch.where(use_hair, t_hair, t_tri))
    valid = torch.isfinite(t) & (t < ray.maxt) \
        & ((prim_tri >= 0) | (prim_hair >= 0) | (prim_inst >= 0))
    use_hair = use_hair & ~use_inst
    p = ray.o + ray.d * t[..., None]

    e = torch.eye(3, device=dev)
    geo_n = e[2].expand(n, 3)
    sh_n = geo_n
    sh_s = e[0].expand(n, 3)
    sh_t = e[1].expand(n, 3)
    uv = torch.zeros((n, 2), device=dev)
    mat_id = torch.zeros((n,), dtype=torch.int32, device=dev)
    emitter_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    uv_density = torch.zeros((n,), device=dev)
    bary = torch.zeros((n, 2), device=dev)
    vcolor = torch.ones((n, 3), device=dev)

    if arr.tri is not None:
        i = torch.clamp(prim_tri, min=0).long()
        p0 = arr.tri.p0[i]
        e1 = arr.tri.e1[i]
        e2 = arr.tri.e2[i]
        gn = normalize(torch.linalg.cross(e1, e2))
        # the chosen triangle's barycentrics, recomputed
        pv = torch.linalg.cross(ray.d, e2)
        det = dot(e1, pv)
        inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
        tv = ray.o - p0
        b1 = dot(tv, pv) * inv
        qv = torch.linalg.cross(tv, e1)
        b2 = dot(ray.d, qv) * inv
        b0 = 1.0 - b1 - b2
        sh = arr.tri_shading
        ns = normalize(sh.n0[i] * b0[..., None] + sh.n1[i] * b1[..., None]
                       + sh.n2[i] * b2[..., None])
        uvi = sh.uv0[i] * b0[..., None] + sh.uv1[i] * b1[..., None] \
            + sh.uv2[i] * b2[..., None]
        # the geometric normal into the shading normal's hemisphere
        # (winding-robust: procedural stand-ins may wind either way)
        gn = torch.where((dot(gn, ns) < 0)[..., None], -gn, gn)
        f = frame_from_normal(ns)
        tri_sel = ~use_hair & ~use_inst & (prim_tri >= 0)
        m = tri_sel[..., None]
        geo_n = torch.where(m, gn, geo_n)
        sh_n = torch.where(m, ns, sh_n)
        sh_s = torch.where(m, f.s, sh_s)
        sh_t = torch.where(m, f.t, sh_t)
        uv = torch.where(m, uvi, uv)
        mat_id = torch.where(tri_sel, sh.mat_id[i], mat_id)
        emitter_id = torch.where(tri_sel, sh.emitter_id[i], emitter_id)
        uv_density = torch.where(tri_sel, sh.uv_density[i], uv_density)
        bary = torch.where(m, torch.stack([b1, b2], -1), bary)
        vcolor = torch.where(m, sh.vc0[i] * b0[..., None]
                             + sh.vc1[i] * b1[..., None]
                             + sh.vc2[i] * b2[..., None], vcolor)

    if arr.hair is not None:
        i = torch.clamp(prim_hair, min=0).long()
        p0 = arr.hair.p0[i]
        p1 = arr.hair.p1[i]
        radius = arr.hair.radius[i]
        axis = normalize(p1 - p0)
        rel = p - p0
        nrad = normalize(rel - torch.sum(axis * rel, -1, keepdim=True)
                         * axis)
        tt = torch.linalg.cross(nrad, axis)
        local_y = torch.sum(tt * rel, dim=-1)
        local_z = torch.sum(nrad * rel, dim=-1)
        shift = radius - torch.sqrt(torch.clamp(local_y ** 2 + local_z ** 2,
                                                min=0.0))
        p_snap = p + nrad * shift[..., None]
        hair_sel = use_hair & (prim_hair >= 0)
        m = hair_sel[..., None]
        p = torch.where(m, p_snap, p)
        geo_n = torch.where(m, nrad, geo_n)
        sh_n = torch.where(m, nrad, sh_n)
        sh_s = torch.where(m, axis, sh_s)
        sh_t = torch.where(m, tt, sh_t)
        mat_id = torch.where(hair_sel, arr.hair_mat_id[i], mat_id)

    if arr.inst is not None:
        gn_i, ns_i, uv_i, mat_i, bary_i = inst_mod.inst_shading(
            arr.inst, ray, t, prim_inst, which_inst)
        f_i = frame_from_normal(ns_i)
        sel = use_inst & (prim_inst >= 0)
        m = sel[..., None]
        geo_n = torch.where(m, torch.where((dot(gn_i, ns_i) < 0)[..., None],
                                           -gn_i, gn_i), geo_n)
        sh_n = torch.where(m, ns_i, sh_n)
        sh_s = torch.where(m, f_i.s, sh_s)
        sh_t = torch.where(m, f_i.t, sh_t)
        uv = torch.where(m, uv_i, uv)
        mat_id = torch.where(sel, mat_i, mat_id)
        bary = torch.where(m, bary_i, bary)

    return Hit(valid=valid, t=t, p=p, geo_n=geo_n, sh_s=sh_s, sh_t=sh_t,
               sh_n=sh_n, uv=uv, mat_id=mat_id, emitter_id=emitter_id,
               is_hair=use_hair & valid, uv_density=uv_density, bary=bary,
               vcolor=vcolor,
               prim=torch.where(use_inst, prim_inst,
                                torch.where(use_hair, prim_hair, prim_tri)))


def scene_occluded(arr, ray: Ray, q_max: int, sort_rays: bool = False,
                   compact: bool = True, traversal: str = "tiled",
                   p_max: int = 24, chunk: int = 64, block: int = 256,
                   short_t: float = 0.0):
    """[N] bool: does the ray hit a triangle, a hair segment or an
    instance in [mint, maxt]. The triangles are walked first, then the
    hair, then the instances; a later shadow ray starts with maxt = 0
    where an earlier one already occludes. The traversal and its
    parameters as in scene_intersect."""
    _check_traversal(traversal)
    occ = torch.zeros(ray.o.shape[:1], dtype=torch.bool, device=ray.o.device)
    if arr.tri is not None:
        occ = occ | _walk(arr, "tri", ray, traversal, block, True)
    if arr.hair is not None:
        ray2 = ray if arr.tri is None \
            else ray._replace(maxt=torch.where(occ, 0.0, ray.maxt))
        if traversal == "swept":
            occ = occ | iswept.swept_any_hit(arr.hair_swept, ray2,
                                             p_max=p_max, chunk=chunk)
        elif traversal in ("packed", "perray", "blocked"):
            occ = occ | _walk(arr, "hair", ray2, traversal, block, True)
        else:
            occ = occ | itiled.tiled_any_hit(
                arr.hair_swept, ray2, q_max=q_max, sort_rays=sort_rays,
                compact=compact, subcull=traversal == "tiled_sub",
                short_t=short_t)
    if arr.inst is not None:
        ray3 = ray._replace(maxt=torch.where(occ, 0.0, ray.maxt))
        occ = occ | inst_mod.inst_any_hit(arr.inst, ray3)
    return occ
