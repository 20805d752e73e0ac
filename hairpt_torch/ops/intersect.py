"""The per-ray BVH walk over the SoA tree (port of hairpt/ops/intersect.py):
traversal='perray', for the triangles and the hair.

The tree is the SAH builder's FlatBVH as BVHArrays: node_min / node_max
[M, 3] f32, node_left [M] i32 (the left child, or a leaf's first
primitive), node_count [M] i32 (-1 inner, else the leaf's primitive
count; LEAF = 4 at most are tested) and node_skip [M] i32 (the next node
in preorder past the subtree; the sentinel is M). A leaf's primitives
are a contiguous run of the BVH-sorted geometry: TriGeom (p0, e1, e2)
or HairGeom (p0, p1, n0, n1, radius) of scene/scene.py. A ray at node k
descends to node_left[k] where it enters k's box and k is inner, and
else jumps to node_skip[k]. The closest hit keeps the first lane at the
least t of a leaf and takes it where t < maxt strictly, maxt shrinking
to it; the result is (t, the sorted prim index). The any hit stops at
the first hit; unlike the packed walk it has no rule for maxt <= mint,
as in the JAX package.

In the JAX package the walk is a per-ray jax.lax.while_loop under vmap
(XLA array code, no Pallas kernel); here it is kernel H
(csrc/perray.cu: one thread per ray, the walk of csrc/packed_walk.cuh
over this layout). closest_hit / any_hit launch kernel H on CUDA
tensors and run the plain walk (closest_hit_plain / any_hit_plain: the
packed walk's vectorised loop, intersect_packed.walk_plain, over this
layout, with the same leaf arithmetic) on CPU tensors; there is no other
branch. Both cap a walk at 2 M steps and raise there. They do the same
float32 operations in the same order (the kernel is built with
--fmad=false), so they agree bit for bit on the card.

LAUNCHES counts kernel H's launches per instance, PLAIN_ON_CUDA the
plain walks on CUDA tensors (the main path makes none).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import intersect_packed as ipk
from .tiled_kernels import _check, _raise_rc, _stream, nvcc_cmd

LEAF = 4          # primitives tested per leaf (the JAX package's leaf_size)
LEAF_KINDS = ipk.LEAF_KINDS
GEOM_FIELDS = {"tri": ("p0", "e1", "e2"),
               "hair": ("p0", "p1", "n0", "n1", "radius")}

LAUNCHES = {f"perray_{leaf}_{mode}": 0 for leaf in LEAF_KINDS
            for mode in ("closest", "any")}
PLAIN_ON_CUDA = dict.fromkeys(LAUNCHES, 0)


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


class BVHArrays(NamedTuple):
    node_min: torch.Tensor    # [M, 3] float32
    node_max: torch.Tensor    # [M, 3] float32
    node_left: torch.Tensor   # [M] int32
    node_count: torch.Tensor  # [M] int32, -1 inner
    node_skip: torch.Tensor   # [M] int32


def bvh_to_device(fb, device="cpu") -> BVHArrays:
    """BVHArrays of a FlatBVH on `device`."""
    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return BVHArrays(t(fb.node_min, torch.float32),
                     t(fb.node_max, torch.float32),
                     t(fb.node_left, torch.int32),
                     t(fb.node_count, torch.int32),
                     t(fb.node_skip, torch.int32))


def prim_rows(geom, leaf: str) -> torch.Tensor:
    """[N, 16] f32 rows of the sorted geometry in the packed layout
    (intersect_packed.tri_pack_rows / hair_pack_rows), each row's id its
    sorted index: the plain walks test them with the packed walk's leaf
    arithmetic, on the same float32 values as the kernels read."""
    g = [getattr(geom, f) for f in GEOM_FIELDS[leaf]]
    n = g[0].shape[0]
    rows = torch.zeros((n, ipk.PRIM_F), dtype=torch.float32,
                       device=g[0].device)
    if leaf == "tri":
        rows[:, 0:3], rows[:, 3:6], rows[:, 6:9] = g
    else:
        rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12] = g[:4]
        rows[:, 12] = g[4]
    rows[:, ipk.PRIM_F - 1] = torch.arange(
        n, dtype=torch.int32, device=rows.device).view(torch.float32)
    return rows


class _ArraysLayout:
    """BVHArrays and their sorted geometry, as walk_plain reads them."""
    degenerate_rule = False   # the JAX package's any hit has none

    def __init__(self, bvh: BVHArrays, geom, leaf: str):
        self.bvh = bvh
        self.M = bvh.node_left.shape[0]
        self.K = LEAF
        self.prims = prim_rows(geom, leaf)
        self.lanes = torch.arange(LEAF, device=bvh.node_left.device)

    def node(self, nd):
        b = self.bvh
        count = b.node_count[nd]
        return ([b.node_min[nd, a] for a in range(3)],
                [b.node_max[nd, a] for a in range(3)],
                b.node_left[nd].long(), torch.clamp(count, max=LEAF),
                count >= 0, b.node_skip[nd].long())

    def rows(self, child):
        """[s, LEAF, 16]: the leaves' runs (lanes past a leaf's count
        read a clamped row and are masked)."""
        i = torch.clamp(child[:, None] + self.lanes[None, :], 0,
                        max(self.prims.shape[0] - 1, 0))
        return self.prims[i]


def _plain(bvh: BVHArrays, geom, leaf: str, ray, any_hit: bool,
           counts=None):
    name = f"perray_{leaf}_{'any' if any_hit else 'closest'}"
    if leaf not in LEAF_KINDS:
        raise ValueError(f"leaf must be one of {LEAF_KINDS}, got {leaf!r}")
    if ray.o.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    return ipk.walk_plain(_ArraysLayout(bvh, geom, leaf), leaf, ray,
                          any_hit, name, counts)


def closest_hit_plain(bvh: BVHArrays, geom, leaf: str, ray, counts=None):
    """(t [N] f32, sorted prim index [N] i32; inf / -1 = miss)."""
    return _plain(bvh, geom, leaf, ray, False, counts)


def any_hit_plain(bvh: BVHArrays, geom, leaf: str, ray, counts=None):
    """[N] bool: a hit in [mint, maxt]."""
    return _plain(bvh, geom, leaf, ray, True, counts)


def brute_force_closest(geom, leaf: str, ray):
    """(t, sorted prim index) of each ray against every primitive, with
    the walk's leaf arithmetic (a test oracle; tiny scenes only)."""
    rows = prim_rows(geom, leaf)
    n = rows.shape[0]
    o = tuple(ray.o[:, a, None].float() for a in range(3))
    d = tuple(ray.d[:, a, None].float() for a in range(3))
    t, pid, hit = ipk.LEAF_EVAL[leaf](rows[None], o, d,
                                      ray.mint[:, None].float(),
                                      ray.maxt[:, None].float())
    t = torch.where(hit, t, float("inf"))
    k = torch.argmin(t, dim=1) if n else torch.zeros_like(ray.mint).long()
    tb = t.gather(1, k[:, None])[:, 0] if n \
        else torch.full_like(ray.mint, float("inf"))
    return tb, torch.where(torch.isfinite(tb), k.int(), -1)


# ---------------------------------------------------------------------------
# kernel H
# ---------------------------------------------------------------------------

_LIB = None


def lib():
    """Build (first use) and load libhairpt_perray.so (kernel H)."""
    global _LIB
    if _LIB is None:
        from ._native import load_library
        L = load_library("hairpt_perray", ["perray.cu"], nvcc_cmd(),
                         headers=ipk.WALK_HEADERS)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.hairpt_perray_walk.argtypes = [vp, vp, vp, vp, vp, ci, vp, ci, ci,
                                         ci, vp, vp, vp, vp, ci, vp, vp, vp,
                                         vp, vp]
        L.hairpt_perray_walk.restype = ci
        _LIB = L
    return _LIB


def check_tree(bvh: BVHArrays, geom, leaf: str, dev):
    """Check the tree's and the geometry's dtypes, shapes and device;
    returns (M, the geometry's pointer array, prim count)."""
    if leaf not in LEAF_KINDS:
        raise ValueError(f"leaf must be one of {LEAF_KINDS}, got {leaf!r}")
    M = bvh.node_left.shape[0]
    for f, shape, dtype in (("node_min", (M, 3), torch.float32),
                            ("node_max", (M, 3), torch.float32),
                            ("node_left", (M,), torch.int32),
                            ("node_count", (M,), torch.int32),
                            ("node_skip", (M,), torch.int32)):
        _check(getattr(bvh, f), f, dtype, shape, dev)
    g = [getattr(geom, f) for f in GEOM_FIELDS[leaf]]
    P = g[0].shape[0]
    for f, x in zip(GEOM_FIELDS[leaf], g):
        _check(x, f, torch.float32, (P,) if f == "radius" else (P, 3), dev)
    ptrs = (ctypes.c_void_p * 5)(*([x.data_ptr() for x in g]
                                   + [None] * (5 - len(g))))
    return M, ptrs, P


def ray_inputs(ray, dev):
    N = ray.o.shape[0]
    out = (ray.o.float().contiguous(), ray.d.float().contiguous(),
           ray.mint.float().contiguous(), ray.maxt.float().contiguous())
    for name, x, shape in zip(("o", "d", "mint", "maxt"), out,
                              ((N, 3), (N, 3), (N,), (N,))):
        _check(x, name, torch.float32, shape, dev)
    return out


def _walk(bvh: BVHArrays, geom, leaf: str, ray, any_hit: bool):
    if not ray.o.is_cuda:
        return _plain(bvh, geom, leaf, ray, any_hit)
    dev = ray.o.device
    M, ptrs, P = check_tree(bvh, geom, leaf, dev)
    o, d, mint, maxt = ray_inputs(ray, dev)
    N = o.shape[0]
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
    name = f"perray_{leaf}_{'any' if any_hit else 'closest'}"
    if N > 0:
        rc = lib().hairpt_perray_walk(
            bvh.node_min.data_ptr(), bvh.node_max.data_ptr(),
            bvh.node_left.data_ptr(), bvh.node_count.data_ptr(),
            bvh.node_skip.data_ptr(), M, ptrs, P, LEAF_KINDS.index(leaf),
            int(any_hit), o.data_ptr(), d.data_ptr(), mint.data_ptr(),
            maxt.data_ptr(), N, ptr(t), ptr(pid), ptr(occ), err.data_ptr(),
            _stream(dev))
        _raise_rc(rc, name)
        LAUNCHES[name] += 1
        ipk.raise_walk_error(int(err.item()), name)
    if any_hit:
        return occ != 0
    return t, pid


def closest_hit(bvh: BVHArrays, geom, leaf: str, ray):
    """(t [N] f32, the BVH-sorted prim index [N] i32; inf / -1 = miss):
    each ray's closest hit in [mint, maxt] over the tree's leaves of kind
    `leaf` ('tri': TriGeom, 'hair': HairGeom). Kernel H on CUDA tensors,
    the plain walk on CPU tensors."""
    return _walk(bvh, geom, leaf, ray, any_hit=False)


def any_hit(bvh: BVHArrays, geom, leaf: str, ray):
    """[N] bool: does the ray hit a primitive in [mint, maxt]. Kernel H on
    CUDA tensors, the plain walk on CPU tensors."""
    return _walk(bvh, geom, leaf, ray, any_hit=True)
