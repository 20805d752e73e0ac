"""Two-level BVH instancing (port of hairpt/ops/instancing.py; reference:
src/shapes/{shapegroup,instance}.cpp).

Each prototype keeps ONE object-space packed BVH (the triangles' packed
layout of ops/intersect_packed.py); an instance is a (prototype, world to
object transform) pair. A query transforms each ray per instance and
walks the prototype's tree, so geometry memory is O(prototypes), not
O(instances); t stays the world t (the object-space direction is not
normalised), so the closest hit compares instances directly.

InstancedGeo lays every prototype out for one launch: their node rows
and leaf rows concatenated (the ids inside a prototype's tree stay local,
its rows found through its node and leaf bases), their shading arrays
concatenated in the prototype's own triangle order (a hit's prim id is
local to its prototype; the shading gathers add the prototype's base),
and per instance the prototype id, the world to object transform
w2o [I, 3, 4], the normal matrix nrm_m [I, 3, 3] and the world box
aabb_lo / aabb_hi [I, 3], with `table` [I, INST_F] the row kernel G reads
per instance (box, w2o, the prototype's bases and counts bitcast).

inst_closest_hit and inst_any_hit launch kernel G (csrc/instanced.cu) on
CUDA tensors and run the plain versions (inst_closest_hit_plain,
inst_any_hit_plain) on CPU tensors; there is no other branch. The plain
versions follow the JAX package's loop over the instances in order: the
world box test (_aabb_cull), the object ray, the prototype's packed walk
(intersect_packed's plain walk) up to min(maxt, best t) for the closest
hit, a strict t < best t (the first instance in order wins a tie), any
hit OR-ed over the instances. The JAX package walks a culled instance
with maxt = 0, which finds a hit only where mint < 0; the plain versions
and the kernel walk a culled instance only there, which gives the same
results. The object ray is written as explicit sums in a fixed order,
((m0 o.x + m1 o.y) + m2 o.z) + m3, in the kernel too, so the two agree
bit for bit on the card.

LAUNCHES counts kernel G's launches per mode, PLAIN_ON_CUDA the plain
versions' calls on CUDA tensors (the main path makes none), STATS["walks"]
every call of the public wrappers on any device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.math import normalize
from . import bvh as bvh_mod
from . import intersect_packed as ipk
from .tiled_kernels import _check, _inv_dir, _raise_rc, _stream, nvcc_cmd

LEAF = 4          # triangles per leaf row (the JAX package's build_proto)
INST_F = 24       # floats per row of the kernel's instance table
MODES = ("closest", "any")

LAUNCHES = {f"inst_{m}": 0 for m in MODES}
PLAIN_ON_CUDA = dict.fromkeys(LAUNCHES, 0)
STATS = {"walks": 0}


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0
    STATS["walks"] = 0


class ProtoGeo(NamedTuple):
    """One prototype's object-space triangles, in the mesh's own order
    (the ids its packed BVH returns)."""
    bvh: ipk.PackedBVH
    p0: torch.Tensor      # [T, 3]
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor      # [T, 3] vertex shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor     # [T, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor  # [T] int32
    obj_lo: np.ndarray    # [3] object-space box, host side
    obj_hi: np.ndarray


_SHADING = ("p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
            "mat_id")


class InstancedGeo(NamedTuple):
    nodes: torch.Tensor       # [sum M, 8] every prototype's node rows
    leaf_rows: torch.Tensor   # [sum L, LEAF * 16]
    p0: torch.Tensor          # [sum T, 3] shading arrays, prototype order
    e1: torch.Tensor
    e2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor         # [sum T, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor      # [sum T] int32
    proto_prim_base: torch.Tensor   # [P] int64
    proto_prim_count: torch.Tensor  # [P] int64
    proto_id: torch.Tensor    # [I] int32
    w2o: torch.Tensor         # [I, 3, 4] float32
    nrm_m: torch.Tensor       # [I, 3, 3] float32 = (w2o linear)^T
    aabb_lo: torch.Tensor     # [I, 3] world boxes
    aabb_hi: torch.Tensor
    table: torch.Tensor       # [I, INST_F] kernel G's instance rows
    protos: tuple             # host: per prototype (node base, M, leaf
    #                           base, L, prim base, T, obj_lo, obj_hi)
    proto_ids: tuple          # host: proto_id as ints

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def proto_bvh(self, p: int) -> ipk.PackedBVH:
        """Prototype p's packed BVH (views into the concatenated rows)."""
        nb, m, lb, nl = self.protos[p][:4]
        return ipk.PackedBVH(self.nodes[nb:nb + m],
                             self.leaf_rows[lb:lb + nl])


def build_proto(mesh, mat_id: int, device="cpu") -> ProtoGeo:
    """A prototype's packed BVH from a shapes.Mesh in object space (the
    JAX package's build_proto)."""
    pos = np.asarray(mesh.positions, np.float32)
    idx = np.asarray(mesh.faces, np.int32)
    p0 = pos[idx[:, 0]]
    p1 = pos[idx[:, 1]]
    p2 = pos[idx[:, 2]]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    fb = bvh_mod.build(lo, hi, leaf_size=LEAF)
    order = np.asarray(fb.prim_order)
    rows = ipk.tri_pack_rows(p0[order], p1[order], p2[order], order)
    bvh = ipk.pack_bvh(fb, rows, leaf_size=LEAF, device=device)
    if mesh.normals is not None:
        nrm = np.asarray(mesh.normals, np.float32)
        n0, n1, n2 = nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]]
    else:
        gn = np.cross(p1 - p0, p2 - p0)
        gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-12)
        n0 = n1 = n2 = gn
    if mesh.uvs is not None:
        uv = np.asarray(mesh.uvs, np.float32)
        uv0, uv1, uv2 = uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]
    else:
        uv0 = uv1 = uv2 = np.zeros((len(idx), 2), np.float32)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return ProtoGeo(bvh=bvh, p0=t(p0), e1=t(p1 - p0), e2=t(p2 - p0),
                    n0=t(n0), n1=t(n1), n2=t(n2), uv0=t(uv0), uv1=t(uv1),
                    uv2=t(uv2),
                    mat_id=t(np.full(len(idx), mat_id, np.int32),
                             torch.int32),
                    obj_lo=lo.min(0).astype(np.float32),
                    obj_hi=hi.max(0).astype(np.float32))


def instance_transforms(protos, instances):
    """Per-instance traversal arrays from (prototype index, to_world 4 x
    4) pairs: (w2o [I, 4, 4], nrm_m [I, 3, 3], aabb_lo [I, 3], aabb_hi
    [I, 3]), float32 numpy; `protos` need only obj_lo and obj_hi. The
    JAX package's instance_transforms, operation for operation."""
    w2o, nrm, lo_l, hi_l = [], [], [], []
    for pid, o2w in instances:
        o2w = np.asarray(o2w, np.float64)
        m = np.linalg.inv(o2w)
        w2o.append(m.astype(np.float32))
        nrm.append(m[:3, :3].T.astype(np.float32))
        lo_o = np.asarray(protos[pid].obj_lo)
        hi_o = np.asarray(protos[pid].obj_hi)
        cs = np.array([[x, y, z] for x in (lo_o[0], hi_o[0])
                       for y in (lo_o[1], hi_o[1])
                       for z in (lo_o[2], hi_o[2])])
        cw = cs @ o2w[:3, :3].T + o2w[:3, 3]
        lo_l.append(cw.min(0).astype(np.float32))
        hi_l.append(cw.max(0).astype(np.float32))
    return np.stack(w2o), np.stack(nrm), np.stack(lo_l), np.stack(hi_l)


def assemble(protos, proto_id, w2o, nrm_m, aabb_lo, aabb_hi,
             device="cpu") -> InstancedGeo:
    """The one-launch layout of prototypes (ProtoGeo) and per-instance
    float32 arrays (w2o [I, 4, 4] or [I, 3, 4])."""
    dev = torch.device(device)
    host, nb, lb, pb = [], 0, 0, 0
    for pr in protos:
        m, nl, nt = (pr.bvh.nodes.shape[0], pr.bvh.leaf_rows.shape[0],
                     pr.p0.shape[0])
        host.append((nb, m, lb, nl, pb, nt,
                     np.asarray(pr.obj_lo, np.float32),
                     np.asarray(pr.obj_hi, np.float32)))
        nb, lb, pb = nb + m, lb + nl, pb + nt
    ids = tuple(int(i) for i in proto_id)
    w2o = np.ascontiguousarray(np.asarray(w2o, np.float32)[:, :3, :])
    lo = np.asarray(aabb_lo, np.float32)
    hi = np.asarray(aabb_hi, np.float32)
    tab = np.zeros((len(ids), INST_F), np.float32)
    tab[:, 0:3] = lo
    tab[:, 3:6] = hi
    tab[:, 6:18] = w2o.reshape(-1, 12)
    ints = np.array([host[i][:4] + (host[i][5],) for i in ids],
                    np.int32).reshape(-1, 5)
    tab[:, 18:23] = ints.view(np.float32)

    def cat(f):
        return torch.cat([getattr(pr, f).to(dev) for pr in protos])

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    return InstancedGeo(
        nodes=torch.cat([pr.bvh.nodes.to(dev) for pr in protos]),
        leaf_rows=torch.cat([pr.bvh.leaf_rows.to(dev) for pr in protos]),
        **{f: cat(f) for f in _SHADING},
        proto_prim_base=t([h[4] for h in host], torch.int64),
        proto_prim_count=t([h[5] for h in host], torch.int64),
        proto_id=t(ids, torch.int32), w2o=t(w2o), nrm_m=t(nrm_m),
        aabb_lo=t(lo), aabb_hi=t(hi), table=t(tab), protos=tuple(host),
        proto_ids=ids)


def build_instanced(protos, instances, device="cpu") -> InstancedGeo:
    """instances: list of (prototype index, to_world 4 x 4 numpy)."""
    w2o, nrm, lo, hi = instance_transforms(protos, instances)
    return assemble(protos, [i for i, _ in instances], w2o, nrm, lo, hi,
                    device)


class _Bounds(NamedTuple):
    obj_lo: np.ndarray
    obj_hi: np.ndarray


def repose_instanced(inst: InstancedGeo, instances) -> InstancedGeo:
    """The instance table with new to_world transforms (the same
    prototypes and instance order); the geometry is untouched."""
    bounds = [_Bounds(h[6], h[7]) for h in inst.protos]
    w2o, nrm, lo, hi = instance_transforms(bounds, instances)
    dev = inst.device
    tab = inst.table.cpu().numpy().copy()
    tab[:, 0:3] = lo
    tab[:, 3:6] = hi
    tab[:, 6:18] = w2o[:, :3, :].reshape(-1, 12)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return inst._replace(w2o=t(w2o[:, :3, :]), nrm_m=t(nrm), aabb_lo=t(lo),
                         aabb_hi=t(hi), table=t(tab))


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _aabb_cull(o, inv_d, mint, maxt, lo, hi):
    """The world box test (the JAX package's _aabb_cull): lo, hi [3]."""
    t0 = (lo[None] - o) * inv_d
    t1 = (hi[None] - o) * inv_d
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1) * 1.00000024 + 1e-7
    return (tn <= tf) & (tf >= mint) & (tn <= maxt)


def obj_ray_arrays(o, d, m):
    """(o', d') of world rays [N, 3] under w2o rows m [3, 4] or [N, 3, 4],
    as explicit sums in kernel G's order."""
    if m.dim() == 2:
        m = m[None]
    o2 = torch.stack([((m[:, r, 0] * o[:, 0] + m[:, r, 1] * o[:, 1])
                       + m[:, r, 2] * o[:, 2]) + m[:, r, 3]
                      for r in range(3)], -1)
    d2 = torch.stack([(m[:, r, 0] * d[:, 0] + m[:, r, 1] * d[:, 1])
                      + m[:, r, 2] * d[:, 2] for r in range(3)], -1)
    return o2, d2


def _walk_instances(inst: InstancedGeo, ray, any_hit: bool, counts=None):
    name = f"inst_{'any' if any_hit else 'closest'}"
    if ray.o.is_cuda:
        PLAIN_ON_CUDA[name] += 1
    dev = ray.o.device
    n = ray.o.shape[0]
    o = ray.o.float()
    d = ray.d.float()
    mint = ray.mint.float()
    maxt = ray.maxt.float()
    inv_d = _inv_dir(d)
    neg_mint = mint < 0
    best_t = torch.full((n,), float("inf"), device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    tot = dict(nodes=0, leaves=0, prims=0, steps=0, walked=0)
    for i, p in enumerate(inst.proto_ids):
        mt = maxt if any_hit else torch.minimum(maxt, best_t)
        hit_box = _aabb_cull(o, inv_d, mint, mt, inst.aabb_lo[i],
                             inst.aabb_hi[i])
        walk = hit_box | neg_mint
        if any_hit:
            walk = walk & ~occ
        idx = torch.nonzero(walk)[:, 0]
        if idx.numel() == 0:
            continue
        o2, d2 = obj_ray_arrays(o[idx], d[idx], inst.w2o[i])
        sub = type(ray)(o=o2, d=d2, mint=mint[idx],
                        maxt=torch.where(hit_box[idx], mt[idx], 0.0))
        c = {} if counts is not None else None
        if any_hit:
            occ[idx] = occ[idx] | ipk.any_hit_packed_plain(
                inst.proto_bvh(p), "tri", sub, counts=c)
        else:
            t, prim = ipk.closest_hit_packed_plain(inst.proto_bvh(p), "tri",
                                                   sub, counts=c)
            better = t < best_t[idx]
            best_t[idx] = torch.where(better, t, best_t[idx])
            best_p[idx] = torch.where(better, prim, best_p[idx])
            best_i[idx] = torch.where(better, i, best_i[idx])
        if c is not None:
            for k in ("nodes", "leaves", "prims", "steps"):
                tot[k] += c[k]
            tot["walked"] += idx.numel()
    if counts is not None:
        counts.update(tot, boxes=n * len(inst.proto_ids))
    if any_hit:
        return occ
    return best_t, best_p, best_i


def inst_closest_hit_plain(inst: InstancedGeo, ray, counts=None):
    """(t [N] f32, prototype-local prim id [N] i32, instance [N] i32;
    inf / -1 / -1 = miss). counts, if given, receives the work kernel G
    does: box tests ("boxes"), rays walked ("walked") and the walks' node
    rows, leaf rows and triangle tests."""
    return _walk_instances(inst, ray, any_hit=False, counts=counts)


def inst_any_hit_plain(inst: InstancedGeo, ray, counts=None):
    """[N] bool: a hit of any instance in [mint, maxt]."""
    return _walk_instances(inst, ray, any_hit=True, counts=counts)


# ---------------------------------------------------------------------------
# kernel G
# ---------------------------------------------------------------------------

_LIB = None


def lib():
    """Build (first use) and load libhairpt_instanced.so (kernel G)."""
    global _LIB
    if _LIB is None:
        from ._native import load_library
        L = load_library("hairpt_instanced", ["instanced.cu"], nvcc_cmd(),
                         headers=ipk.WALK_HEADERS)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.hairpt_inst_walk.argtypes = [vp, ci, vp, vp, ci, ci, vp, vp, vp,
                                       vp, ci, vp, vp, vp, vp, vp, vp]
        L.hairpt_inst_walk.restype = ci
        _LIB = L
    return _LIB


def _launch(inst: InstancedGeo, ray, any_hit: bool):
    dev = ray.o.device
    n = ray.o.shape[0]
    n_inst = len(inst.proto_ids)
    m = inst.nodes.shape[0]
    nl, w = inst.leaf_rows.shape
    k = w // ipk.PRIM_F
    _check(inst.table, "table", torch.float32, (n_inst, INST_F), dev)
    _check(inst.nodes, "nodes", torch.float32, (m, 8), dev)
    _check(inst.leaf_rows, "leaf_rows", torch.float32, (nl, k * ipk.PRIM_F),
           dev)
    o = ray.o.float().contiguous()
    d = ray.d.float().contiguous()
    mint = ray.mint.float().contiguous()
    maxt = ray.maxt.float().contiguous()
    _check(o, "o", torch.float32, (n, 3), dev)
    _check(d, "d", torch.float32, (n, 3), dev)
    _check(mint, "mint", torch.float32, (n,), dev)
    _check(maxt, "maxt", torch.float32, (n,), dev)
    err = torch.zeros((1,), dtype=torch.int32, device=dev)
    i32 = torch.int32
    if any_hit:
        occ = torch.empty((n,), dtype=i32, device=dev)
        t = pid = which = None
    else:
        occ = None
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        pid = torch.empty((n,), dtype=i32, device=dev)
        which = torch.empty((n,), dtype=i32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()
    name = f"inst_{'any' if any_hit else 'closest'}"
    if n > 0:
        rc = lib().hairpt_inst_walk(
            inst.table.data_ptr(), n_inst, inst.nodes.data_ptr(),
            inst.leaf_rows.data_ptr(), k, int(any_hit), o.data_ptr(),
            d.data_ptr(), mint.data_ptr(), maxt.data_ptr(), n, ptr(t),
            ptr(pid), ptr(which), ptr(occ), err.data_ptr(), _stream(dev))
        _raise_rc(rc, name)
        LAUNCHES[name] += 1
        ipk.raise_walk_error(int(err.item()), name)
    if any_hit:
        return occ != 0
    return t, pid, which


def inst_closest_hit(inst: InstancedGeo, ray):
    """(t [N], prototype-local prim [N], instance [N]; inf / -1 / -1 =
    miss): the closest hit over the instances in [mint, maxt]. Kernel G
    on CUDA tensors, the plain version on CPU tensors."""
    STATS["walks"] += 1
    if not ray.o.is_cuda:
        return inst_closest_hit_plain(inst, ray)
    return _launch(inst, ray, any_hit=False)


def inst_any_hit(inst: InstancedGeo, ray):
    """[N] bool: does the ray hit an instance in [mint, maxt]. Kernel G on
    CUDA tensors, the plain version on CPU tensors."""
    STATS["walks"] += 1
    if not ray.o.is_cuda:
        return inst_any_hit_plain(inst, ray)
    return _launch(inst, ray, any_hit=True)


# ---------------------------------------------------------------------------
# the shading record
# ---------------------------------------------------------------------------

def inst_shading(inst: InstancedGeo, ray, t, prim, which):
    """The object-space barycentric shading record, its normals taken to
    world through nrm_m: (geo_n, sh_n, uv, mat_id, bary [N, 2]) for lanes
    with which >= 0 (the JAX package's inst_shading; other lanes read
    instance 0)."""
    iw = torch.clamp(which, min=0).long()
    o2, d2 = obj_ray_arrays(ray.o, ray.d, inst.w2o[iw])
    proto = inst.proto_id[iw].long()
    pc = torch.minimum(torch.clamp(prim, min=0).long(),
                       inst.proto_prim_count[proto] - 1) \
        + inst.proto_prim_base[proto]
    p0, e1, e2 = inst.p0[pc], inst.e1[pc], inst.e2[pc]
    pv = torch.linalg.cross(d2, e2)
    det = torch.sum(e1 * pv, -1)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, 1.0, det)
    tv = o2 - p0
    b1 = torch.sum(tv * pv, -1) * inv
    qv = torch.linalg.cross(tv, e1)
    b2 = torch.sum(d2 * qv, -1) * inv
    b0 = 1.0 - b1 - b2
    ns_o = normalize(inst.n0[pc] * b0[..., None] + inst.n1[pc] * b1[..., None]
                      + inst.n2[pc] * b2[..., None])
    gn_o = normalize(torch.linalg.cross(e1, e2))
    nm = inst.nrm_m[iw]
    ns = normalize(torch.einsum("nij,nj->ni", nm, ns_o))
    gn = normalize(torch.einsum("nij,nj->ni", nm, gn_o))
    uv = inst.uv0[pc] * b0[..., None] + inst.uv1[pc] * b1[..., None] \
        + inst.uv2[pc] * b2[..., None]
    return gn, ns, uv, inst.mat_id[pc], torch.stack([b1, b2], -1)
