"""Cluster layout of the hair segments and the swept traversal (port of
hairpt/ops/intersect_swept.py).

The build is numpy on the host with torch holders. The intersectors read
four tables from it: the cluster AABBs cl_lo/cl_hi [C, 3] (phase A), the
transposed segment blocks seg_rows_t [C, 16, K] (phase B) and the
32-segment sub-cluster AABBs sub_lo/sub_hi. Rows of seg_rows_t, as in the
JAX package: 0:3 p0 | 3:6 unit axis | 6:9 n0 | 9:12 n1 | 12 r | 13 sn1 =
(p1-p0).n1 | 14 r^2 | 15 id (int32 bits; -1 marks a padding segment).

The swept traversal (swept_closest_hit) is the JAX package's two-phase
cluster sweep: phase A (_phase_a_dense, plain torch) records up to p_max
candidate clusters per ray; the (ray, cluster) pairs are sorted by
cluster and padded into chunks of `chunk` pairs of one cluster; phase B
is kernel E (phaseb_kernels.phase_b_chunks); the results are routed back
and reduced per ray. Left out: `_phase_a`, the cluster-BVH walk, which no
path of the JAX package calls (its `nodes` table is not built here).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core.math import Ray
from . import bvh as bvh_mod
from . import phaseb_kernels as pk

PRIM_F = 16  # floats per packed primitive
MAX_LEAF_CLUSTERS = 4  # SAH builder cap for leaf_size=1


class SweptHair(NamedTuple):
    cl_lo: torch.Tensor       # [C, 3] cluster bounds (phase-A cull)
    cl_hi: torch.Tensor       # [C, 3]
    seg_rows_t: torch.Tensor  # [C, PRIM_F, K] phase-B segment blocks
    sub_lo: torch.Tensor      # [C*K/32, 3] 32-segment sub-cluster bounds
    sub_hi: torch.Tensor


def _bitcast_i2f(x):
    return np.asarray(x, np.int32).view(np.float32)


def hair_pack_rows(p0, p1, n0, n1, radius, ids):
    """Hair segment packed row: p0, p1, n0, n1, r, pad, pad, id."""
    n = len(p0)
    rows = np.zeros((n, PRIM_F), np.float32)
    rows[:, 0:3] = p0
    rows[:, 3:6] = p1
    rows[:, 6:9] = n0
    rows[:, 9:12] = n1
    rows[:, 12] = radius
    rows[:, PRIM_F - 1] = _bitcast_i2f(np.asarray(ids, np.int32))
    return rows


def _miter_seg_bounds(p0, p1, n0, n1, radius):
    """Exact per-segment AABBs of the miter-clipped cylinders.

    The accepted-hit region of the intersection kernel
    (tiled_kernels.cyl_test) is the infinite cylinder of radius r about
    the axis a=(p1-p0)/|..| clipped by the miter planes (p0,n0) and
    (p1,n1) — a convex body whose extreme point along any direction lies
    on one of the two cap ellipses.  The per-axis half-extent of the cap
    ellipse {v : v.n=0, |v-(v.a)a| <= r} is

        E_i = r/|n.a| * sqrt((1-b^2) g1^2 + 2 a b g1 g2 + (1-a^2) g2^2)

    with (u1,u2) an orthonormal basis of the plane, a=u1.a, b=u2.a and
    g=(u1_i, u2_i).  Result is clamped against the legacy conservative
    box (min(p0,p1) - 2r, max + 2r) so near-degenerate miters (n almost
    perpendicular to the axis) stay finite and never looser than before.

    Analog of the reference's cylinder-plane "fancy" AABB
    clipping (src/shapes/hair.cpp:239-444): closed-form cap-ellipse
    extents at cluster-build time instead of kd-split-plane clipping.
    Host-side numpy; runs once per scene build.
    """
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    r = np.asarray(radius, np.float64)[:, None]
    ax = p1 - p0
    ax_len = np.sqrt(np.maximum((ax * ax).sum(-1, keepdims=True), 1e-30))
    ax = ax / ax_len

    def cap_extents(nrm):
        nrm = np.asarray(nrm, np.float64)
        nn = np.sqrt(np.maximum((nrm * nrm).sum(-1, keepdims=True), 1e-30))
        nrm = nrm / nn
        # u1 = normalize(n x e_k), e_k the axis least aligned with n
        k = np.argmin(np.abs(nrm), axis=-1)
        e = np.zeros_like(nrm)
        e[np.arange(len(k)), k] = 1.0
        u1 = np.cross(nrm, e)
        u1 /= np.sqrt(np.maximum((u1 * u1).sum(-1, keepdims=True), 1e-30))
        u2 = np.cross(nrm, u1)
        al = (u1 * ax).sum(-1, keepdims=True)       # u1.a
        be = (u2 * ax).sum(-1, keepdims=True)       # u2.a
        na = np.abs((nrm * ax).sum(-1, keepdims=True))
        quad = ((1.0 - be * be) * u1 * u1
                + 2.0 * al * be * u1 * u2
                + (1.0 - al * al) * u2 * u2)
        return (r / np.maximum(na, 1e-6)) * np.sqrt(np.maximum(quad, 0.0))

    e0 = cap_extents(n0)
    e1 = cap_extents(n1)
    lo = np.minimum(p0 - e0, p1 - e1)
    hi = np.maximum(p0 + e0, p1 + e1)
    # never looser than the legacy conservative box
    lo = np.maximum(lo, np.minimum(p0, p1) - 2.0 * r)
    hi = np.minimum(hi, np.maximum(p0, p1) + 2.0 * r)
    return lo.astype(np.float32), hi.astype(np.float32)


def _cluster_setup(p0, p1, n0, n1, radius, K):
    """Morton order of the segments, padded to whole clusters, and the
    per-cluster bounds in that order (before the cluster-tree reorder)."""
    assert K % 32 == 0, "cluster size must hold whole 32-seg sub-clusters"
    n = len(p0)
    lo, hi = _miter_seg_bounds(p0, p1, n0, n1, radius)
    centroid = 0.5 * (lo + hi)
    ext = np.maximum(centroid.max(0) - centroid.min(0), 1e-12)
    q = np.clip((centroid - centroid.min(0)) / ext * 1023.0, 0,
                1023).astype(np.uint32)
    order = np.argsort(bvh_mod.morton3(q), kind="stable")
    pad = (-n) % K
    if pad:
        order = np.concatenate([order, np.full(pad, -1)])
    C = len(order) // K

    def take(a, fill=0.0):
        out = np.full((len(order),) + a.shape[1:], fill, a.dtype)
        valid = order >= 0
        out[valid] = a[order[valid]]
        return out

    slo = np.where((order >= 0)[:, None], take(lo, 3e37), 3e37)
    shi = np.where((order >= 0)[:, None], take(hi, -3e37), -3e37)
    cl_lo = slo.reshape(C, K, 3).min(1)
    cl_hi = shi.reshape(C, K, 3).max(1)
    return order, take, cl_lo, cl_hi


def cluster_bounds(p0, p1, n0, n1, radius, K: int = 64):
    """(cl_lo, cl_hi) [C, 3] before the cluster-tree reorder — the input
    of the cluster BVH build whose prim order build_swept_hair applies."""
    _, _, cl_lo, cl_hi = _cluster_setup(p0, p1, n0, n1, radius, K)
    return cl_lo, cl_hi


def build_swept_hair(p0, p1, n0, n1, radius, K: int = 64, device=None,
                     cluster_order=None) -> SweptHair:
    """Host-side build. Inputs are the segment arrays in the order their
    ids should refer to. cluster_order overrides the cluster BVH's prim
    order (tests pass the JAX build's, to compare like with like). The
    tables go on `device` (the card unless "cpu")."""
    device = resolve_device(device)
    order, take, cl_lo, cl_hi = _cluster_setup(p0, p1, n0, n1, radius, K)
    C = cl_lo.shape[0]
    sp0, sp1 = take(p0), take(p1)
    sn0, sn1 = take(n0), take(n1)
    srad = take(radius)
    sid = np.where(order >= 0, order, -1).astype(np.int32)

    if cluster_order is None:
        fb = bvh_mod.build(cl_lo, cl_hi, leaf_size=1)
        assert fb.node_count.max() <= MAX_LEAF_CLUSTERS, fb.node_count.max()
        cluster_order = fb.prim_order
    corder = np.asarray(cluster_order)

    rows = hair_pack_rows(sp0, sp1, sn0, sn1, srad, sid)
    rows = rows.reshape(C, K * PRIM_F)[corder].reshape(C * K, PRIM_F)
    rows_k = rows.copy()
    seg_v = rows[:, 3:6].astype(np.float64) - rows[:, 0:3]
    seg_len = np.sqrt(np.maximum((seg_v * seg_v).sum(-1, keepdims=True),
                                 1e-30))
    rows_k[:, 3:6] = (seg_v / seg_len).astype(np.float32)
    rows_k[:, 13] = (seg_v * rows[:, 9:12].astype(np.float64))\
        .sum(-1).astype(np.float32)
    rows_k[:, 14] = rows[:, 12] * rows[:, 12]
    rows_t = rows_k.reshape(C, K, PRIM_F).transpose(0, 2, 1).copy()

    SUBK = 32
    validf = rows[:, PRIM_F - 1].view(np.int32) >= 0
    elof, ehif = _miter_seg_bounds(rows[:, 0:3], rows[:, 3:6],
                                   rows[:, 6:9], rows[:, 9:12],
                                   rows[:, 12])
    slof = np.where(validf[:, None], elof, 3e37)
    shif = np.where(validf[:, None], ehif, -3e37)
    C32 = rows.shape[0] // SUBK
    sub_lo = slof.reshape(C32, SUBK, 3).min(1)
    sub_hi = shif.reshape(C32, SUBK, 3).max(1)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)
    return SweptHair(cl_lo=dev(cl_lo[corder]), cl_hi=dev(cl_hi[corder]),
                     seg_rows_t=dev(rows_t), sub_lo=dev(sub_lo),
                     sub_hi=dev(sub_hi))


# ---------------------------------------------------------------------------
# the swept traversal
# ---------------------------------------------------------------------------

# largest [rays, clusters] f32 temporary of the dense phase A (bytes)
PHASE_A_BYTES = 128 << 20

# per-process counters read by chip_smoke.py: queries, live rays queried,
# live rays whose phase-A candidates overflowed p_max
STATS = {"queries": 0, "rays": 0, "overflow_rays": 0}


def _phase_a_dense(sw: SweptHair, ray: Ray, p_max: int, c_chunk: int = 1024,
                   return_n_hit: bool = False):
    """Candidate clusters of each ray: slab tests against every cluster
    AABB. Returns (slots [N, p_max] i32 cluster ids, -1 past the
    candidates; cnt [N] i32), and with return_n_hit the number of boxes
    each ray enters ([N] int64).

    The JAX package has two branches that keep different candidates when
    a ray enters more than p_max boxes, and both are kept:
      * C <= c_chunk (masked minima): the p_max LOWEST cluster ids, in id
        order;
      * C > c_chunk (top_k merges over cluster chunks): the p_max NEAREST
        entries, by entry t and, on equal t, lower id first. jax.lax.top_k
        puts the lower index first on ties, and ties are common (a ray
        starting inside several boxes enters each at t = 0); torch.topk
        promises no tie order, so the selection runs on a unique integer
        key (entry-t bits << id bits | id), whose order is exactly that.
    Rays are processed in chunks so no [rays, C] f32 temporary passes
    PHASE_A_BYTES."""
    N = ray.o.shape[0]
    C = sw.cl_lo.shape[0]
    dev = ray.o.device
    d = ray.d
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-12,
                              torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype),
                              d)
    lowest_ids = C <= c_chunk
    cbits = max(1, (C - 1).bit_length())
    cid = torch.arange(C, device=dev)
    k = min(p_max, C)
    slots = torch.full((N, p_max), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((N,), dtype=torch.int32, device=dev)
    n_hit = torch.zeros((N,), dtype=torch.int64, device=dev)
    r_chunk = max(1, PHASE_A_BYTES // (4 * C))
    for r0 in range(0, N, r_chunk):
        r1 = min(N, r0 + r_chunk)
        o = ray.o[r0:r1]
        inv = inv_d[r0:r1]
        tn = tf = None
        for ax in range(3):
            a0 = (sw.cl_lo[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
            a1 = (sw.cl_hi[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
            lo_ax = torch.minimum(a0, a1)
            hi_ax = torch.maximum(a0, a1)
            tn = lo_ax if tn is None else torch.maximum(tn, lo_ax)
            tf = hi_ax if tf is None else torch.minimum(tf, hi_ax)
            del a0, a1, lo_ax, hi_ax
        tf = tf * 1.00000024 + 1e-7
        hit = (tn <= tf) & (tf >= ray.mint[r0:r1, None]) \
            & (tn <= ray.maxt[r0:r1, None])
        del tf
        nh = hit.sum(dim=1)
        n_hit[r0:r1] = nh
        if lowest_ids:
            key = torch.where(hit, cid, C)
            sel = torch.topk(key, k, dim=1, largest=False,
                             sorted=True).values
            found = sel < C
            cnt[r0:r1] = torch.clamp(nh, max=p_max).to(torch.int32)
        else:
            # entry t >= 0: its f32 bits order like its values (-0.0 is
            # folded into +0.0); ids fill the low bits
            bits = torch.clamp(tn, min=0.0).view(torch.int32).long() \
                & 0x7FFFFFFF
            key = torch.where(hit, (bits << cbits) | cid,
                              torch.iinfo(torch.int64).max)
            sel = torch.topk(key, k, dim=1, largest=False,
                             sorted=True).values
            found = sel < (0x7F800000 << cbits)     # a finite entry t
            sel = sel & ((1 << cbits) - 1)
            cnt[r0:r1] = found.sum(dim=1).to(torch.int32)
        del tn, hit, key
        slots[r0:r1, :k] = torch.where(found, sel, -1).to(torch.int32)
    if return_n_hit:
        return slots, cnt, n_hit
    return slots, cnt


def _route_pairs(slots, C: int, chunk: int):
    """The (ray, cluster) pairs of the candidate slots [N, P], sorted by
    cluster with a stable sort (pairs of one cluster keep ray order) and
    padded so that every chunk of `chunk` pairs holds one cluster. Sizes
    are the JAX package's: n_padded = ceil(N*P/chunk)*chunk + C*chunk
    pair slots. Returns (chunk_cl [n_chunks] i32, chunk_ray [n_chunks,
    chunk] i32 with -1 in dead lanes, and for the route back, over the M
    valid pairs: pos [M] int64, the pair's index ray * P + slot, and dest
    [M] int64, its padded position)."""
    N, P = slots.shape
    dev = slots.device
    keys = slots.reshape(-1).long()
    keys = torch.where(keys < 0, C, keys)             # invalid sorts last
    sc, order = torch.sort(keys, stable=True)
    counts = torch.bincount(sc, minlength=C + 1)[:C]
    padded = (counts + chunk - 1) // chunk * chunk
    pad_off = torch.cumsum(padded, 0) - padded
    start = torch.cumsum(counts, 0) - counts
    n_valid = int(counts.sum())
    sc = sc[:n_valid]
    pos = order[:n_valid]
    dest = pad_off[sc] + torch.arange(n_valid, device=dev) - start[sc]
    n_padded = -(-(N * P) // chunk) * chunk + C * chunk
    chunk_ray = torch.full((n_padded,), -1, dtype=torch.int32, device=dev)
    chunk_ray[dest] = (pos // P).to(torch.int32)
    chunk_cl = torch.full((n_padded,), -1, dtype=torch.int32, device=dev)
    chunk_cl[dest] = sc.to(torch.int32)
    return (chunk_cl.view(-1, chunk).amax(dim=1).contiguous(),
            chunk_ray.view(-1, chunk), pos, dest)


def _chunk_rays(ray: Ray, chunk_ray):
    """[n_chunks, 8, CH] f32 rows o.xyz, d.xyz, mint, maxt of the chunks'
    rays; dead lanes take ray 0's rows with maxt = -1 (nothing hits)."""
    n, ch = chunk_ray.shape
    ridx = chunk_ray.clamp(min=0).long()
    out = torch.empty((n, 8, ch), dtype=torch.float32,
                      device=chunk_ray.device)
    for j, comp in enumerate((ray.o[:, 0], ray.o[:, 1], ray.o[:, 2],
                              ray.d[:, 0], ray.d[:, 1], ray.d[:, 2],
                              ray.mint)):
        out[:, j, :] = comp[ridx]
    out[:, 7, :] = torch.where(chunk_ray >= 0, ray.maxt[ridx], -1.0)
    return out


def swept_closest_hit(sw: SweptHair, ray: Ray, p_max: int = 24,
                      chunk: int = 16):
    """Closest hit of the swept traversal: (t [N], prim_id [N]), inf / -1
    = miss. A ray is tested against its p_max phase-A candidates only
    (overflow drops candidates, as in the JAX package); among its pairs
    the first minimum wins."""
    N = ray.o.shape[0]
    C = sw.cl_lo.shape[0]
    slots, _, n_hit = _phase_a_dense(sw, ray, p_max, return_n_hit=True)
    live = ray.maxt > ray.mint
    STATS["queries"] += 1
    STATS["rays"] += int(live.sum())
    STATS["overflow_rays"] += int((live & (n_hit > p_max)).sum())
    chunk_cl, chunk_ray, pos, dest = _route_pairs(slots, C, chunk)
    t_c, p_c = pk.phase_b_chunks(chunk_cl, _chunk_rays(ray, chunk_ray),
                                 sw.seg_rows_t)
    dev = ray.o.device
    t_pairs = torch.full((N * p_max,), float("inf"), device=dev)
    p_pairs = torch.full((N * p_max,), -1, dtype=torch.int32, device=dev)
    t_pairs[pos] = t_c.reshape(-1)[dest]
    p_pairs[pos] = p_c.reshape(-1)[dest]
    t_pairs = t_pairs.view(N, p_max)
    k = torch.argmin(t_pairs, dim=1, keepdim=True)
    best_t = t_pairs.gather(1, k)[:, 0]
    best_p = p_pairs.view(N, p_max).gather(1, k)[:, 0]
    return best_t, torch.where(torch.isfinite(best_t), best_p, -1)


def swept_any_hit(sw: SweptHair, ray: Ray, p_max: int = 24,
                  chunk: int = 16):
    """Occlusion through the swept traversal: its closest hit, then
    (p >= 0) & ~degenerate."""
    degenerate = ray.maxt <= ray.mint
    _, p = swept_closest_hit(sw, ray, p_max, chunk)
    return (p >= 0) & ~degenerate
