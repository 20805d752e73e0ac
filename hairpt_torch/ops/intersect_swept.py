"""Cluster layout of the hair segments (port of the build half of
hairpt/ops/intersect_swept.py; numpy on the host, torch holders).

The tiled intersector reads four tables from it: the cluster AABBs
cl_lo/cl_hi [C, 3] (phase A), the transposed segment blocks seg_rows_t
[C, 16, K] (phase B) and the 32-segment sub-cluster AABBs sub_lo/sub_hi.
Rows of seg_rows_t, as in the JAX package: 0:3 p0 | 3:6 unit axis |
6:9 n0 | 9:12 n1 | 12 r | 13 sn1 = (p1-p0).n1 | 14 r^2 | 15 id (int32
bits; -1 marks a padding segment).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import bvh as bvh_mod

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


def build_swept_hair(p0, p1, n0, n1, radius, K: int = 64, device="cpu",
                     cluster_order=None) -> SweptHair:
    """Host-side build. Inputs are the segment arrays in the order their
    ids should refer to. cluster_order overrides the cluster BVH's prim
    order (tests pass the JAX build's, to compare like with like)."""
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
