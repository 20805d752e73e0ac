"""Flattened BVH construction (port of hairpt/ops/bvh.py; host-side numpy
and a native SAH builder, run once per scene build).

The forward render uses the builder twice: for the hair segments' prim
order (the order arr.hair is stored in) and for the cluster order of the
swept layout. Flattened format as in the JAX package: node_min/max [M, 3],
node_left [M], node_count [M] (-1 internal), node_skip [M], prim_order
[N] (new position -> original prim index).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FlatBVH(NamedTuple):
    node_min: np.ndarray    # [M, 3] float32
    node_max: np.ndarray    # [M, 3] float32
    node_left: np.ndarray   # [M] int32
    node_count: np.ndarray  # [M] int32
    node_skip: np.ndarray   # [M] int32
    prim_order: np.ndarray  # [N] int32: new position -> original prim index
    depth: int              # tree depth (root = 0)


def morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10 bits per axis of quantized centroids [N, 3] -> uint32."""
    def expand(v):
        v = v.astype(np.uint32) & 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v
    return (expand(x[:, 0]) << 2) | (expand(x[:, 1]) << 1) | expand(x[:, 2])


def _heap_skip_pointers(num_nodes: int) -> np.ndarray:
    """skip[h] = heap index of the next subtree in DFS preorder, or num_nodes.

    In heap layout (children of h are 2h+1, 2h+2), the preorder successor
    after finishing subtree h is the right sibling of the deepest ancestor
    (including h) that is a left child. Vectorized walk over tree depth.
    """
    h = np.arange(num_nodes, dtype=np.int64)
    cur = h.copy()
    skip = np.full(num_nodes, num_nodes, dtype=np.int64)
    done = np.zeros(num_nodes, dtype=bool)
    depth = int(np.ceil(np.log2(num_nodes + 1))) + 1
    for _ in range(depth + 1):
        is_left = (cur % 2 == 1)
        newly = is_left & ~done
        skip[newly] = cur[newly] + 1
        done |= newly
        at_root = cur == 0
        done |= at_root
        parent = np.maximum((cur - 1) // 2, 0)
        cur = np.where(done, cur, parent)
    return skip.astype(np.int32)


# ---------------------------------------------------------------------------
# native binned-SAH builder (the port's copy of csrc/bvh_builder.cpp,
# compiled into hairpt_torch/_build/ and loaded through ctypes)
# ---------------------------------------------------------------------------

# portable code generation (no host-tuned -march: the library must run on any
# x86-64 host) and no floating-point contraction, so the tree does not
# depend on which FMA units the build host has
BVH_CMD = ["g++", "-O3", "-fPIC", "-std=c++17", "-pthread", "-shared",
           "-ffp-contract=off"]

_NATIVE = None
_NATIVE_TRIED = False


def _load_native():
    """Compile (once) and load the SAH builder; None if g++ is missing."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes
    from ._native import load_library
    try:
        lib = load_library("hairpt_bvh", ["bvh_builder.cpp"], BVH_CMD)
    except (OSError, RuntimeError, FileNotFoundError):
        return None
    lib.hairpt_build_bvh.restype = ctypes.c_int32
    _NATIVE = lib
    return _NATIVE


def build_sah(aabb_min: np.ndarray, aabb_max: np.ndarray,
              leaf_size: int = 4, n_threads: int = 0) -> FlatBVH | None:
    """Binned-SAH build via the native library (preorder skip layout).
    Returns None if the native builder is unavailable."""
    lib = _load_native()
    if lib is None:
        return None
    import ctypes
    import os
    n = int(aabb_min.shape[0])
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    lo = np.ascontiguousarray(aabb_min, np.float32)
    hi = np.ascontiguousarray(aabb_max, np.float32)
    cap = 2 * n + 16
    node_lo = np.empty((cap, 3), np.float32)
    node_hi = np.empty((cap, 3), np.float32)
    node_left = np.empty(cap, np.int32)
    node_count = np.empty(cap, np.int32)
    node_skip = np.empty(cap, np.int32)
    prim_order = np.empty(n, np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    m = lib.hairpt_build_bvh(
        ptr(lo, ctypes.c_float), ptr(hi, ctypes.c_float),
        ctypes.c_int32(n), ctypes.c_int32(leaf_size),
        ctypes.c_int32(n_threads),
        ptr(node_lo, ctypes.c_float), ptr(node_hi, ctypes.c_float),
        ptr(node_left, ctypes.c_int32), ptr(node_count, ctypes.c_int32),
        ptr(node_skip, ctypes.c_int32), ptr(prim_order, ctypes.c_int32))
    if m <= 0:
        return None
    return FlatBVH(node_min=node_lo[:m].copy(), node_max=node_hi[:m].copy(),
                   node_left=node_left[:m].copy(),
                   node_count=node_count[:m].copy(),
                   node_skip=node_skip[:m].copy(),
                   prim_order=prim_order,
                   depth=0)


def build(aabb_min: np.ndarray, aabb_max: np.ndarray,
          leaf_size: int = 4, prefer_sah: bool = True) -> FlatBVH:
    """Build the flattened BVH from primitive AABBs [N, 3] (float arrays).

    Uses the native binned-SAH builder when available (better tree quality
    → fewer traversal steps); falls back to the pure-numpy complete-binary
    Morton LBVH below."""
    if prefer_sah:
        fb = build_sah(aabb_min, aabb_max, leaf_size)
        if fb is not None:
            return fb
    n = aabb_min.shape[0]
    assert n > 0
    aabb_min = np.asarray(aabb_min, np.float64)
    aabb_max = np.asarray(aabb_max, np.float64)
    centroid = 0.5 * (aabb_min + aabb_max)

    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroid - lo) / extent) * 1023.0, 0, 1023).astype(np.uint32)
    codes = morton3(q)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    s_min = aabb_min[order]
    s_max = aabb_max[order]

    # chunk into leaves of `leaf_size` prims, pad leaf count to a power of two
    n_chunks = (n + leaf_size - 1) // leaf_size
    n_leaves = 1 << int(np.ceil(np.log2(max(n_chunks, 1))))
    pad_prims = n_leaves * leaf_size - n

    big = np.float32(3.0e37)
    s_min = np.concatenate([s_min, np.full((pad_prims, 3), big)])
    s_max = np.concatenate([s_max, np.full((pad_prims, 3), -big)])

    # leaf AABBs
    leaf_min = s_min.reshape(n_leaves, leaf_size, 3).min(axis=1)
    leaf_max = s_max.reshape(n_leaves, leaf_size, 3).max(axis=1)

    num_nodes = 2 * n_leaves - 1
    node_min = np.empty((num_nodes, 3), np.float64)
    node_max = np.empty((num_nodes, 3), np.float64)
    node_min[n_leaves - 1:] = leaf_min
    node_max[n_leaves - 1:] = leaf_max

    # bottom-up union, level by level (vectorized)
    lvl_start = n_leaves - 1
    width = n_leaves
    while width > 1:
        child_min = node_min[lvl_start:lvl_start + width].reshape(-1, 2, 3)
        child_max = node_max[lvl_start:lvl_start + width].reshape(-1, 2, 3)
        pstart = lvl_start // 2
        node_min[pstart:lvl_start] = child_min.min(axis=1)
        node_max[pstart:lvl_start] = child_max.max(axis=1)
        lvl_start = pstart
        width //= 2

    h = np.arange(num_nodes, dtype=np.int64)
    is_leaf = h >= n_leaves - 1
    node_left = np.where(is_leaf, (h - (n_leaves - 1)) * leaf_size,
                         2 * h + 1).astype(np.int32)
    # clamp leaf counts at the tail (padded prims are never real)
    starts = (h[is_leaf] - (n_leaves - 1)) * leaf_size
    counts = np.clip(n - starts, 0, leaf_size)
    # internal nodes are tagged -1; a leaf may legitimately have count 0
    # (fully padded tail) and must still be treated as a leaf by traversal
    node_count = np.full(num_nodes, -1, np.int32)
    node_count[is_leaf] = counts

    node_skip = _heap_skip_pointers(num_nodes)

    # empty leaves (fully padded): make the box never hit
    return FlatBVH(
        node_min=node_min.astype(np.float32),
        node_max=node_max.astype(np.float32),
        node_left=node_left,
        node_count=node_count,
        node_skip=node_skip,
        prim_order=order,
        depth=int(np.log2(n_leaves)) + 1,
    )
