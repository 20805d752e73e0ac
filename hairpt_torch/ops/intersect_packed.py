"""The packed-layout BVH walk (port of hairpt/ops/intersect_packed.py):
the triangles' closest and any hit, and the hair's where the traversal is
'packed'.

Layout (the JAX package's):
  nodes     [M, 8] f32   bbox min xyz, bbox max xyz, bitcast meta,
                         bitcast skip
  leaf_rows [L, LEAF * 16] f32  a leaf's primitives packed into one row,
                         16 floats each, the last one the bitcast prim id
                         (-1 pads a leaf)
  meta (int32): leaf  -> (leaf_row << 5) | count   (count <= LEAF)
                inner -> (left_child << 5) | 0x1F
The walk is the stackless skip-pointer order of the SAH builder
(ops/bvh.py): a ray at node k descends to its left child where it
enters k's box and k is inner, and else jumps to skip[k]; the sentinel is
M. In the JAX package the walk is a per-ray jax.lax.while_loop under
vmap (XLA array code, no Pallas kernel); here it is kernel F
(csrc/packed.cu), one thread per ray, templated on the leaf (triangle or
hair) and the mode (closest or any hit).

closest_hit_packed and any_hit_packed launch kernel F on CUDA tensors and
run the plain walk (closest_hit_packed_plain, any_hit_packed_plain) on
CPU tensors; there is no other branch. The plain walk is vectorised: every
live ray steps its own node per iteration, and the loop ends when every
ray has reached the sentinel (walk_plain, which ops/intersect.py runs
over the BVHArrays too). Both cap a ray's walk at 2 M steps (a
stackless walk visits a node at most once) and raise where a ray reaches
the cap. Kernel F and the plain walk do the same float32 operations in
the same order (the kernel is built with --fmad=false; the hair leaf
takes its inverse length as 1 / sqrt, the plain side's root from
tiled_kernels.sqrt_rn), so they agree bit for bit on the card.

LAUNCHES counts kernel F's launches per instance, PLAIN_ON_CUDA the
plain walks on CUDA tensors (the main path makes none; chip_smoke.py
calls the plain walk on the card only to compare), STATS["walks"] every
call of the public wrappers on any device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .tiled_kernels import (_check, _inv_dir, _raise_rc, _slab, _stream,
                            nvcc_cmd, sqrt_rn)

PRIM_F = 16      # floats per packed primitive
INNER = 0x1F
LEAF_KINDS = ("tri", "hair")

LAUNCHES = {f"packed_{leaf}_{mode}": 0 for leaf in LEAF_KINDS
            for mode in ("closest", "any")}
PLAIN_ON_CUDA = dict.fromkeys(LAUNCHES, 0)
STATS = {"walks": 0}


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0
    STATS["walks"] = 0


class PackedBVH(NamedTuple):
    nodes: torch.Tensor      # [M, 8] float32
    leaf_rows: torch.Tensor  # [L, leaf_size * PRIM_F] float32


def _bitcast_i2f(x):
    return np.asarray(x, np.int32).view(np.float32)


def pack_bvh(fb, prim_rows: np.ndarray, leaf_size: int = 4,
             device="cpu") -> PackedBVH:
    """The packed layout of a FlatBVH and the [N, 16] rows of its
    BVH-sorted primitives (slot 15 the bitcast original prim id), on
    `device`; the JAX package's pack_bvh."""
    m = fb.node_left.shape[0]
    is_leaf = fb.node_count >= 0
    leaf_ids = np.cumsum(is_leaf) - 1
    n_leaves = int(is_leaf.sum())
    rows = np.zeros((max(n_leaves, 1), leaf_size * PRIM_F), np.float32)
    rows[:, PRIM_F - 1::PRIM_F] = _bitcast_i2f(
        np.full((1,), -1, np.int32))[0]
    starts = fb.node_left[is_leaf]
    counts = fb.node_count[is_leaf]
    for k in range(leaf_size):
        take = counts > k
        rows[np.nonzero(take)[0], k * PRIM_F:(k + 1) * PRIM_F] = \
            prim_rows[starts[take] + k]
    meta = np.where(is_leaf,
                    (leaf_ids.astype(np.int64) << 5)
                    | np.minimum(fb.node_count, leaf_size),
                    (fb.node_left.astype(np.int64) << 5) | INNER)
    nodes = np.zeros((m, 8), np.float32)
    nodes[:, 0:3] = fb.node_min
    nodes[:, 3:6] = fb.node_max
    nodes[:, 6] = _bitcast_i2f(meta.astype(np.int32))
    nodes[:, 7] = _bitcast_i2f(fb.node_skip)
    return PackedBVH(torch.as_tensor(nodes, device=device),
                     torch.as_tensor(rows, device=device))


def tri_pack_rows(p0, v1, v2, ids):
    """Triangle packed row: p0, e1, e2, pad..., bitcast id."""
    n = len(p0)
    rows = np.zeros((n, PRIM_F), np.float32)
    rows[:, 0:3] = p0
    rows[:, 3:6] = v1 - p0
    rows[:, 6:9] = v2 - p0
    rows[:, PRIM_F - 1] = _bitcast_i2f(np.asarray(ids, np.int32))
    return rows


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


# ---------------------------------------------------------------------------
# leaf tests, plain: rows [R, K, 16] against one ray per row, the ray's
# components [R, 1]; returns (t [R, K], pid [R, K], hit [R, K]). Sums of
# three products go x, y, z from the left, as in csrc/packed.cu.
# ---------------------------------------------------------------------------

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def tri_leaf_eval(rows, o, d, mint, maxt):
    """Moller-Trumbore over a leaf's triangles (the JAX package's
    tri_leaf_eval). o, d: 3-tuples of [R, 1]; mint, maxt [R, 1]."""
    p0x, p0y, p0z = rows[..., 0], rows[..., 1], rows[..., 2]
    e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
    e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
    pid = rows[..., PRIM_F - 1].contiguous().view(torch.int32)
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = _dot3(e1x, e1y, e1z, px, py, pz)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    tx, ty, tz = ox - p0x, oy - p0y, oz - p0z
    u = _dot3(tx, ty, tz, px, py, pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = _dot3(dx, dy, dz, qx, qy, qz) * inv_det
    t = _dot3(e2x, e2y, e2z, qx, qy, qz) * inv_det
    hit = (pid >= 0) & (torch.abs(det) >= 1e-12) & (u >= 0) & (v >= 0) \
        & (u + v <= 1) & (t >= mint) & (t <= maxt)
    return t, pid, hit


def hair_leaf_eval(rows, o, d, mint, maxt):
    """The miter-cylinder test on packed hair rows (the JAX package's
    hair_leaf_eval, math: the reference's src/shapes/hair.cpp:485), with
    the inverse length as 1 / sqrt (JAX: rsqrt)."""
    p0x, p0y, p0z = rows[..., 0], rows[..., 1], rows[..., 2]
    p1x, p1y, p1z = rows[..., 3], rows[..., 4], rows[..., 5]
    n0x, n0y, n0z = rows[..., 6], rows[..., 7], rows[..., 8]
    n1x, n1y, n1z = rows[..., 9], rows[..., 10], rows[..., 11]
    r = rows[..., 12]
    pid = rows[..., PRIM_F - 1].contiguous().view(torch.int32)
    ox, oy, oz = o
    dx, dy, dz = d
    sx, sy, sz = p1x - p0x, p1y - p0y, p1z - p0z
    l2 = torch.clamp(_dot3(sx, sy, sz, sx, sy, sz), min=1e-30)
    inv_len = 1.0 / sqrt_rn(l2)
    ax, ay, az = sx * inv_len, sy * inv_len, sz * inv_len
    rx, ry, rz = ox - p0x, oy - p0y, oz - p0z
    ar = _dot3(ax, ay, az, rx, ry, rz)
    pox, poy, poz = rx - ar * ax, ry - ar * ay, rz - ar * az
    ad = _dot3(ax, ay, az, dx, dy, dz)
    pdx, pdy, pdz = dx - ad * ax, dy - ad * ay, dz - ad * az
    a = _dot3(pdx, pdy, pdz, pdx, pdy, pdz)
    b = _dot3(pox, poy, poz, pdx, pdy, pdz)
    ok = a > 1e-18
    a_safe = torch.where(ok, a, 1.0)
    t_mid = -b / a_safe
    qx, qy, qz = pox + pdx * t_mid, poy + pdy * t_mid, poz + pdz * t_mid
    c_mid = _dot3(qx, qy, qz, qx, qy, qz) - r * r
    disc = -c_mid / a_safe
    ok = ok & (disc >= 0.0)
    dt = sqrt_rn(torch.clamp(disc, min=0.0))
    t_near = t_mid - dt
    t_far = t_mid + dt

    def miter_ok(t):
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        return (_dot3(px - p0x, py - p0y, pz - p0z, n0x, n0y, n0z) >= 0.0) \
            & (_dot3(px - p1x, py - p1y, pz - p1z, n1x, n1y, n1z) <= 0.0)

    near_ok = ok & (t_near >= mint) & (t_near <= maxt) & miter_ok(t_near)
    far_ok = ok & (t_far >= mint) & (t_far <= maxt) & miter_ok(t_far)
    t = torch.where(near_ok, t_near, t_far)
    hit = (pid >= 0) & (near_ok | far_ok)
    return t, pid, hit


LEAF_EVAL = {"tri": tri_leaf_eval, "hair": hair_leaf_eval}


# ---------------------------------------------------------------------------
# the plain walk
# ---------------------------------------------------------------------------

class _PackedLayout:
    """The node and leaf rows of a PackedBVH, as walk_plain reads them."""
    degenerate_rule = True    # any hit: maxt <= mint is no hit, no walk

    def __init__(self, bvh: PackedBVH):
        self.nodes = bvh.nodes
        self.M = bvh.nodes.shape[0]
        self.K = bvh.leaf_rows.shape[1] // PRIM_F
        self.leaf_rows = bvh.leaf_rows.view(-1, self.K, PRIM_F)
        self.meta = bvh.nodes[:, 6].contiguous().view(torch.int32)
        self.skip = bvh.nodes[:, 7].contiguous().view(torch.int32).long()

    def node(self, nd):
        """(lo, hi: per-axis lists, child, count, is_leaf, skip) of nodes
        nd."""
        row = self.nodes[nd]
        meta = self.meta[nd]
        count = meta & 0x1F
        return ([row[:, a] for a in range(3)],
                [row[:, 3 + a] for a in range(3)], (meta >> 5).long(),
                count, count != INNER, self.skip[nd])

    def rows(self, child):
        """[s, K, 16] primitive rows of leaves `child`."""
        return self.leaf_rows[child]


def walk_plain(layout, leaf: str, ray, any_hit: bool, name: str,
               counts: dict | None = None):
    """The vectorised skip-pointer walk over a layout (_PackedLayout
    here, intersect._ArraysLayout for the BVHArrays): every live ray
    steps its own node per iteration until it reaches the sentinel M.
    counts, if given, receives the work the kernels do on these rays:
    node rows read ("nodes"), leaf rows read ("leaves") and primitive
    tests in their order ("prims": an any-hit leaf stops at its first
    hit)."""
    if leaf not in LEAF_EVAL:
        raise ValueError(f"leaf must be one of {LEAF_KINDS}, got {leaf!r}")
    leaf_eval = LEAF_EVAL[leaf]
    M, K = layout.M, layout.K
    dev = ray.o.device
    N = ray.o.shape[0]
    o = ray.o.float()
    d = ray.d.float()
    inv_d = _inv_dir(d)
    mint = ray.mint.float()
    maxt = ray.maxt.float().clone()          # closest hit: shrinks
    best_t = torch.full((N,), float("inf"), device=dev)
    best_p = torch.full((N,), -1, dtype=torch.int32, device=dev)
    degenerate = (maxt <= mint) if layout.degenerate_rule \
        else torch.zeros((N,), dtype=torch.bool, device=dev)
    occ = degenerate.clone()
    node = torch.zeros((N,), dtype=torch.int64, device=dev)
    lanes = torch.arange(K, device=dev)
    idx = torch.nonzero(~occ if any_hit else torch.ones_like(occ))[:, 0]
    steps = 0
    n_nodes = n_leaves = n_prims = 0
    while idx.numel() > 0:
        if steps == 2 * M:
            raise RuntimeError(f"{name}: {idx.numel()} rays walked 2 M = "
                               f"{2 * M} steps without reaching the "
                               f"sentinel (a corrupt BVH)")
        nd = node[idx]
        lo, hi, child, count, is_leaf, skip = layout.node(nd)
        oi, ii = o[idx], inv_d[idx]
        mt = maxt[idx]
        tn, tf = _slab([oi[:, a] for a in range(3)],
                       [ii[:, a] for a in range(3)], lo, hi)
        hit_box = (tn <= tf) & (tf >= mint[idx]) & (tn <= mt)
        sel = torch.nonzero(hit_box & is_leaf)[:, 0]
        if sel.numel() > 0:
            ri = idx[sel]
            rows = layout.rows(child[sel])                 # [s, K, 16]
            oc = tuple(o[ri, a, None] for a in range(3))
            dc = tuple(d[ri, a, None] for a in range(3))
            mts = maxt[ri]
            t, pid, hit = leaf_eval(rows, oc, dc, mint[ri, None],
                                    mts[:, None])
            lane_ok = hit & (lanes[None, :] < count[sel, None])
            if counts is not None:
                n_leaves += sel.numel()
                first = torch.where(lane_ok.any(dim=1),
                                    lane_ok.int().argmax(dim=1) + 1,
                                    count[sel])
                n_prims += int((first if any_hit else count[sel]).sum())
            if any_hit:
                occ[ri] = occ[ri] | lane_ok.any(dim=1)
            else:
                # the first lane at the least t, then strictly below the
                # shrinking maxt
                tb = torch.full_like(mts, float("inf"))
                pb = torch.full_like(best_p[ri], -1)
                for k in range(K):
                    tk = torch.where(lane_ok[:, k], t[:, k], float("inf"))
                    better = tk < tb
                    tb = torch.where(better, tk, tb)
                    pb = torch.where(better, pid[:, k], pb)
                got = tb < mts
                maxt[ri] = torch.where(got, tb, mts)
                best_t[ri] = torch.where(got, tb, best_t[ri])
                best_p[ri] = torch.where(got, pb, best_p[ri])
        node[idx] = torch.where(hit_box & ~is_leaf, child, skip)
        steps += 1
        n_nodes += idx.numel()
        done = node[idx] == M
        if any_hit:
            done = done | occ[idx]
        idx = idx[~done]
    if counts is not None:
        counts.update(nodes=n_nodes, leaves=n_leaves, prims=n_prims,
                      steps=steps)
    if any_hit:
        return occ & ~degenerate
    return best_t, best_p


def _walk_plain(bvh: PackedBVH, leaf: str, ray, any_hit: bool,
                counts: dict | None = None):
    name = f"packed_{leaf}_{'any' if any_hit else 'closest'}"
    if ray.o.is_cuda and leaf in LEAF_EVAL:
        PLAIN_ON_CUDA[name] += 1
    return walk_plain(_PackedLayout(bvh), leaf, ray, any_hit, name, counts)


def closest_hit_packed_plain(bvh: PackedBVH, leaf: str, ray, counts=None):
    """(t [N] f32, prim id [N] i32; inf / -1 = miss)."""
    return _walk_plain(bvh, leaf, ray, any_hit=False, counts=counts)


def any_hit_packed_plain(bvh: PackedBVH, leaf: str, ray, counts=None):
    """[N] bool: a hit in [mint, maxt]; False where maxt <= mint."""
    return _walk_plain(bvh, leaf, ray, any_hit=True, counts=counts)


# ---------------------------------------------------------------------------
# kernel F
# ---------------------------------------------------------------------------

_LIB = None
# the walk shared by kernels F and G
WALK_HEADERS = ["packed_walk.cuh"]
# the codes the kernels set in their error flag
WALK_ERRORS = {1: "a ray walked 2 M steps without reaching the sentinel",
               2: "a node, a leaf row or a leaf's count lay outside the "
                  "tree"}


def raise_walk_error(code: int, name: str):
    """Raise for a kernel's error flag (0: no error)."""
    if code != 0:
        raise RuntimeError(f"{name}: {WALK_ERRORS.get(code, code)} (a "
                           f"corrupt BVH)")


def lib():
    """Build (first use) and load libhairpt_packed.so (kernel F)."""
    global _LIB
    if _LIB is None:
        from ._native import load_library
        L = load_library("hairpt_packed", ["packed.cu"], nvcc_cmd(),
                         headers=WALK_HEADERS)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.hairpt_packed_walk.argtypes = [vp, vp, ci, ci, ci, ci, ci, vp, vp,
                                         vp, vp, ci, vp, vp, vp, vp, vp]
        L.hairpt_packed_walk.restype = ci
        _LIB = L
    return _LIB


def _walk(bvh: PackedBVH, leaf: str, ray, any_hit: bool):
    STATS["walks"] += 1
    if not ray.o.is_cuda:
        return _walk_plain(bvh, leaf, ray, any_hit)
    if leaf not in LEAF_KINDS:
        raise ValueError(f"leaf must be one of {LEAF_KINDS}, got {leaf!r}")
    dev = ray.o.device
    N = ray.o.shape[0]
    M = bvh.nodes.shape[0]
    L, W = bvh.leaf_rows.shape
    K = W // PRIM_F
    _check(bvh.nodes, "nodes", torch.float32, (M, 8), dev)
    _check(bvh.leaf_rows, "leaf_rows", torch.float32, (L, K * PRIM_F), dev)
    o = ray.o.float().contiguous()
    d = ray.d.float().contiguous()
    mint = ray.mint.float().contiguous()
    maxt = ray.maxt.float().contiguous()
    _check(o, "o", torch.float32, (N, 3), dev)
    _check(d, "d", torch.float32, (N, 3), dev)
    _check(mint, "mint", torch.float32, (N,), dev)
    _check(maxt, "maxt", torch.float32, (N,), dev)
    err = torch.zeros((1,), dtype=torch.int32, device=dev)
    if any_hit:
        occ = torch.empty((N,), dtype=torch.int32, device=dev)
        t = pid = None
    else:
        occ = None
        t = torch.empty((N,), dtype=torch.float32, device=dev)
        pid = torch.empty((N,), dtype=torch.int32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()
    name = f"packed_{leaf}_{'any' if any_hit else 'closest'}"
    if N > 0:
        rc = lib().hairpt_packed_walk(
            bvh.nodes.data_ptr(), bvh.leaf_rows.data_ptr(), M, L, K,
            LEAF_KINDS.index(leaf), int(any_hit), o.data_ptr(),
            d.data_ptr(), mint.data_ptr(), maxt.data_ptr(), N, ptr(t),
            ptr(pid), ptr(occ), err.data_ptr(), _stream(dev))
        _raise_rc(rc, name)
        LAUNCHES[name] += 1
        raise_walk_error(int(err.item()), name)
    if any_hit:
        return occ != 0
    return t, pid


def closest_hit_packed(bvh: PackedBVH, leaf: str, ray):
    """(t [N] f32, the BVH-sorted prim id [N] i32; inf / -1 = miss): the
    closest hit of each ray over the packed BVH's leaves of kind `leaf`
    ('tri' or 'hair'), in [mint, maxt]. Kernel F on CUDA tensors, the
    plain walk on CPU tensors."""
    return _walk(bvh, leaf, ray, any_hit=False)


def any_hit_packed(bvh: PackedBVH, leaf: str, ray):
    """[N] bool: does the ray hit a primitive in [mint, maxt] (False where
    maxt <= mint). Kernel F on CUDA tensors, the plain walk on CPU."""
    return _walk(bvh, leaf, ray, any_hit=True)
