"""The block-shared BVH walk (port of hairpt/ops/intersect_blocked.py):
traversal='blocked', for the triangles and the hair.

A block of `block` consecutive rays walks the BVHArrays tree of
ops/intersect.py together (the reference's 4-wide SSE ray packets,
include/mitsuba/render/triaccel.h:37, as the JAX package models them):
one node index per block; each lane slab-tests its own ray against the
node's box; the block descends to the left child where any lane enters
an inner node's box, and else takes the skip pointer. At a leaf the
lanes that enter its box test its primitives (at most LEAF, the same
leaf arithmetic and tie rule as the per-ray walk), each against its own
shrinking maxt. The any hit leaves occluded lanes out of the box test,
starts with the lanes whose maxt <= mint counted as occluded, ends a
block once every lane is occluded or has maxt <= mint, and returns
occ & !(maxt <= mint) (the JAX package's :190, :231). The number of
rays must be a multiple of `block`; common._pad_ray pads a query with
rays of zero origin, direction +z and maxt 0, which stay in the loop.

In the JAX package the walk is one jax.lax.while_loop over every block
(XLA array code, no Pallas kernel); here it is kernel I (csrc/blocked.cu:
one CTA per block, a thread per lane, the node index uniform,
__syncthreads_or for the descent, a leaf's primitives staged in shared
memory). closest_hit_blocked / any_hit_blocked launch kernel I on CUDA
tensors and run the plain version (a vectorised loop over the blocks
with the same float32 operations in the same order) on CPU tensors;
there is no other branch. Both cap a block's walk at 2 M steps.

LAUNCHES counts kernel I's launches per instance, PLAIN_ON_CUDA the
plain versions on CUDA tensors (the main path makes none).
"""
from __future__ import annotations

import ctypes

import torch

from . import intersect as isec
from . import intersect_packed as ipk
from .tiled_kernels import _inv_dir, _raise_rc, _slab, _stream, nvcc_cmd

MAX_BLOCK = 1024

LAUNCHES = {f"blocked_{leaf}_{mode}": 0 for leaf in isec.LEAF_KINDS
            for mode in ("closest", "any")}
PLAIN_ON_CUDA = dict.fromkeys(LAUNCHES, 0)


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def _check_block(n: int, block: int):
    if block % 32 or not 0 < block <= MAX_BLOCK:
        raise ValueError(f"block must be a multiple of 32 in [32, "
                         f"{MAX_BLOCK}], got {block}")
    if n % block:
        raise ValueError(f"the number of rays ({n}) must be a multiple of "
                         f"block ({block}); pad them (common._pad_ray)")


def _plain(bvh, geom, leaf: str, ray, any_hit: bool, block: int,
           counts=None):
    """The vectorised block walk; counts, if given, receives the block
    steps ("steps"), node rows read by a block ("nodes"), leaves staged
    ("leaves") and the (lane, primitive) tests of the lanes that enter a
    staged leaf's box ("prims")."""
    name = f"blocked_{leaf}_{'any' if any_hit else 'closest'}"
    if leaf not in isec.LEAF_KINDS:
        raise ValueError(f"leaf must be one of {isec.LEAF_KINDS}, got "
                         f"{leaf!r}")
    N = ray.o.shape[0]
    _check_block(N, block)
    if ray.o.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    leaf_eval = ipk.LEAF_EVAL[leaf]
    lay = isec._ArraysLayout(bvh, geom, leaf)
    M, K = lay.M, isec.LEAF
    dev = ray.o.device
    nb = N // block
    o = ray.o.float().reshape(nb, block, 3)
    d = ray.d.float().reshape(nb, block, 3)
    inv_d = _inv_dir(d)
    mint = ray.mint.float().reshape(nb, block)
    maxt = ray.maxt.float().reshape(nb, block).clone()
    best_t = torch.full((nb, block), float("inf"), device=dev)
    best_p = torch.full((nb, block), -1, dtype=torch.int32, device=dev)
    degenerate = maxt <= mint
    occ = degenerate.clone()
    node = torch.zeros((nb,), dtype=torch.int64, device=dev)
    lanes = torch.arange(K, device=dev)
    idx = torch.arange(nb, device=dev)
    steps = n_nodes = n_leaves = n_prims = 0
    while idx.numel() > 0:
        if steps == 2 * M:
            raise RuntimeError(f"{name}: {idx.numel()} blocks walked 2 M = "
                               f"{2 * M} steps without reaching the "
                               f"sentinel (a corrupt BVH)")
        nd = node[idx]
        lo, hi, child, count, is_leaf, skip = lay.node(nd)
        tn, tf = _slab([o[idx, :, a] for a in range(3)],
                       [inv_d[idx, :, a] for a in range(3)],
                       [x[:, None] for x in lo], [x[:, None] for x in hi])
        hit_box = (tn <= tf) & (tf >= mint[idx]) & (tn <= maxt[idx])
        if any_hit:
            hit_box = hit_box & ~occ[idx]
        entered = hit_box.any(dim=1)
        sel = torch.nonzero(entered & is_leaf)[:, 0]
        if sel.numel() > 0:
            bi = idx[sel]
            rows = lay.rows(child[sel])[:, None]          # [s, 1, K, 16]
            oc = tuple(o[bi, :, a, None] for a in range(3))
            dc = tuple(d[bi, :, a, None] for a in range(3))
            mts = maxt[bi]
            t, pid, hit = leaf_eval(rows, oc, dc, mint[bi, :, None],
                                    mts[:, :, None])
            lane_ok = hit & hit_box[sel, :, None] \
                & (lanes[None, None, :] < count[sel, None, None])
            if counts is not None:
                n_leaves += sel.numel()
                n_prims += int((hit_box[sel].sum(1) * count[sel]).sum())
            if any_hit:
                occ[bi] = occ[bi] | lane_ok.any(dim=2)
            else:
                tb = torch.full_like(mts, float("inf"))
                pb = torch.full_like(best_p[bi], -1)
                for k in range(K):
                    tk = torch.where(lane_ok[:, :, k], t[:, :, k],
                                     float("inf"))
                    better = tk < tb
                    tb = torch.where(better, tk, tb)
                    pb = torch.where(better, pid[:, :, k], pb)
                got = tb < mts
                maxt[bi] = torch.where(got, tb, mts)
                best_t[bi] = torch.where(got, tb, best_t[bi])
                best_p[bi] = torch.where(got, pb, best_p[bi])
        if any_hit:
            done = (occ[idx] | (maxt[idx] <= mint[idx])).all(dim=1)
            nxt = torch.where(entered & ~is_leaf & ~done, child,
                              torch.where(done, M, skip))
        else:
            nxt = torch.where(entered & ~is_leaf, child, skip)
        node[idx] = nxt
        steps += 1
        n_nodes += idx.numel()
        idx = idx[nxt != M]
    if counts is not None:
        counts.update(nodes=n_nodes, leaves=n_leaves, prims=n_prims,
                      steps=steps)
    if any_hit:
        return (occ & ~degenerate).reshape(N)
    return best_t.reshape(N), best_p.reshape(N)


def closest_hit_blocked_plain(bvh, geom, leaf: str, ray, block: int = 256,
                              counts=None):
    """(t [N] f32, sorted prim index [N] i32; inf / -1 = miss)."""
    return _plain(bvh, geom, leaf, ray, False, block, counts)


def any_hit_blocked_plain(bvh, geom, leaf: str, ray, block: int = 256,
                          counts=None):
    """[N] bool: a hit in [mint, maxt]; False where maxt <= mint."""
    return _plain(bvh, geom, leaf, ray, True, block, counts)


# ---------------------------------------------------------------------------
# kernel I
# ---------------------------------------------------------------------------

_LIB = None


def lib():
    """Build (first use) and load libhairpt_blocked.so (kernel I)."""
    global _LIB
    if _LIB is None:
        from ._native import load_library
        L = load_library("hairpt_blocked", ["blocked.cu"], nvcc_cmd(),
                         headers=ipk.WALK_HEADERS)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.hairpt_blocked_walk.argtypes = [vp, vp, vp, vp, vp, ci, vp, ci, ci,
                                          ci, vp, vp, vp, vp, ci, ci, vp, vp,
                                          vp, vp, vp]
        L.hairpt_blocked_walk.restype = ci
        _LIB = L
    return _LIB


def _walk(bvh, geom, leaf: str, ray, any_hit: bool, block: int):
    if not ray.o.is_cuda:
        return _plain(bvh, geom, leaf, ray, any_hit, block)
    dev = ray.o.device
    M, ptrs, P = isec.check_tree(bvh, geom, leaf, dev)
    o, d, mint, maxt = isec.ray_inputs(ray, dev)
    N = o.shape[0]
    _check_block(N, block)
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
    name = f"blocked_{leaf}_{'any' if any_hit else 'closest'}"
    if N > 0:
        rc = lib().hairpt_blocked_walk(
            bvh.node_min.data_ptr(), bvh.node_max.data_ptr(),
            bvh.node_left.data_ptr(), bvh.node_count.data_ptr(),
            bvh.node_skip.data_ptr(), M, ptrs, P,
            isec.LEAF_KINDS.index(leaf), int(any_hit), o.data_ptr(),
            d.data_ptr(), mint.data_ptr(), maxt.data_ptr(), N, block, ptr(t),
            ptr(pid), ptr(occ), err.data_ptr(), _stream(dev))
        _raise_rc(rc, name)
        LAUNCHES[name] += 1
        ipk.raise_walk_error(int(err.item()), name)
    if any_hit:
        return occ != 0
    return t, pid


def closest_hit_blocked(bvh, geom, leaf: str, ray, block: int = 256):
    """(t [N] f32, the BVH-sorted prim index [N] i32; inf / -1 = miss),
    the rays walked in blocks of `block` (N a multiple of it). Kernel I
    on CUDA tensors, the plain version on CPU tensors."""
    return _walk(bvh, geom, leaf, ray, False, block)


def any_hit_blocked(bvh, geom, leaf: str, ray, block: int = 256):
    """[N] bool: a hit in [mint, maxt], False where maxt <= mint. Kernel I
    on CUDA tensors, the plain version on CPU tensors."""
    return _walk(bvh, geom, leaf, ray, True, block)
