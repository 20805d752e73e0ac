"""The hand-written CUDA kernels of the swept traversal, their wrappers
and their plain PyTorch versions (port of hairpt/ops/pallas_phaseb.py and
of the XLA phase A of hairpt/ops/intersect_swept.py).

  swept_phase_a   the swept phase A: each ray's candidate clusters, slab
                  tests against the cluster boxes with a tile test in
                  front, in the 64-ray tiles of tile_order (csrc/
                  swept_cull.cu; plain version
                  intersect_swept._phase_a_dense, the port of the JAX
                  package's XLA array code intersect_swept.py:220, which
                  has no Pallas kernel; swept_phase_a_model transcribes
                  the kernel's algorithm for the CPU tests)
  phase_b_chunks  kernel E: each chunk of CH rays, all routed to one
                  cluster, against that cluster's K segments (replaces
                  pallas_phaseb._phaseb_kernel / _phaseb_one;
                  csrc/phaseb.cu); the kernel tests a ray only against the
                  32-segment sub-clusters whose widened box it enters
                  (sub_cull_plain)

Layout contract (from intersect_swept.swept_closest_hit):
  cl_lo, cl_hi [C, 3] f32           cluster boxes
  slots      [N, p_max] i32         candidate cluster ids, -1 past cnt
  cnt [N] i32, n_hit [N] i64        candidates kept, boxes entered
  chunk_cl   [n_chunks] i32         cluster per chunk (-1 = dead chunk)
  chunk_rays [n_chunks, 8, CH] f32  rows o.xyz, d.xyz, mint, maxt (dead
                                    lanes maxt = -1)
  seg_rows   [C, 16, K] f32         (K in KERNEL_K for the kernel)
  sub_lo, sub_hi [C * K / 32, 3]    sub-cluster boxes, aligned with
                                    seg_rows (the kernel's cull)
  t, pid     [n_chunks, CH] f32 / i32 (inf / -1 = miss)

A wrapper runs the plain version for CPU tensors and launches the kernel
or raises for CUDA tensors. LAUNCHES counts kernel launches, PLAIN_ON_CUDA
plain-version calls on CUDA tensors (the main path makes none).
"""
from __future__ import annotations

import ctypes

import torch

from . import tiled_kernels as tk
from .tiled_kernels import HEADERS, KERNEL_K, _check, _raise_rc, _stream, \
    nvcc_cmd

MAX_CH = 256          # rays per chunk the kernel's launch accepts
# candidates per ray whose sorted list the phase-A kernel keeps in shared
# memory (csrc/swept_cull.cu SMEM_K); above it, in a scratch tensor
SMEM_K = 64
SUBK = 32             # segments per sub-cluster
# kernel E's sub-box cull margin (csrc/phaseb.cu SUB_PAD, kernel B's
# BOX_PAD): each sub-cluster box is widened by SUB_PAD times the larger of
# the ray origin's and the box's largest |coordinate|
SUB_PAD = 2.0 ** -16

LAUNCHES = {"swept_phase_a": 0, "phase_b_chunks": 0}
PLAIN_ON_CUDA = {"swept_phase_a": 0, "phase_b_chunks": 0}


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


_LIB = None
_CULL_LIB = None


def lib():
    """Build (first use) and load libhairpt_phaseb.so (kernel E)."""
    global _LIB
    if _LIB is None:
        from ._native import load_library
        L = load_library("hairpt_phaseb", ["phaseb.cu"], nvcc_cmd(), HEADERS)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.hairpt_phase_b_chunks.argtypes = [vp] * 5 + [ci] * 3 + [vp] * 3
        L.hairpt_phase_b_chunks.restype = ci
        _LIB = L
    return _LIB


def cull_lib():
    """Build (first use) and load libhairpt_swept_cull.so (the swept
    phase A)."""
    global _CULL_LIB
    if _CULL_LIB is None:
        from ._native import load_library
        L = load_library("hairpt_swept_cull", ["swept_cull.cu"], nvcc_cmd(),
                         HEADERS)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.hairpt_swept_cull.argtypes = [vp] * 5 + [ci] + [vp] * 2 \
            + [ci] * 5 + [vp] * 5
        L.hairpt_swept_cull.restype = ci
        _CULL_LIB = L
    return _CULL_LIB


# ---------------------------------------------------------------------------
# the swept phase A
# ---------------------------------------------------------------------------

def tile_order(sw, ray):
    """A permutation of the rays ([N] i32) that makes the swept phase-A
    kernel's 64-ray tiles coherent: by direction octant, then by the
    Morton code of the origin (8 bits per axis) in the clusters' bounds.
    Unlike intersect_tiled._morton_sort_rays it orders dead rays like
    live ones: they are tested too, and a tile of dead rays with mixed
    directions passes every box."""
    lo = sw.cl_lo.amin(dim=0)
    hi = sw.cl_hi.amax(dim=0)
    q = ((ray.o - lo) * (255.0 / torch.clamp(hi - lo, min=1e-9)))
    q = torch.nan_to_num(q.clamp(0.0, 255.0), nan=0.0).to(torch.int32)
    q = (q | (q << 8)) & 0x0300F00F         # bit i of each axis -> 3i
    q = (q | (q << 4)) & 0x030C30C3
    q = (q | (q << 2)) & 0x09249249
    d = ray.d
    key = (q[:, 0] | (q[:, 1] << 1) | (q[:, 2] << 2)
           | ((d[:, 0] > 0).int() << 24) | ((d[:, 1] > 0).int() << 25)
           | ((d[:, 2] > 0).int() << 26))
    return torch.argsort(key).to(torch.int32)


def swept_phase_a(sw, ray, p_max: int, c_chunk: int = 1024):
    """(slots [N, p_max] i32, cnt [N] i32, n_hit [N] i64): each ray's
    candidate clusters against the boxes sw.cl_lo, sw.cl_hi, equal to
    intersect_swept._phase_a_dense(sw, ray, p_max, c_chunk,
    return_n_hit=True) in both of its branches (C <= c_chunk: the p_max
    lowest ids; otherwise the p_max nearest), for any p_max >= 1. The
    kernel groups the rays into 64-ray tiles in tile_order's order; the
    outputs stay in the caller's order."""
    if not ray.o.is_cuda:
        from .intersect_swept import _phase_a_dense
        return _phase_a_dense(sw, ray, p_max, c_chunk, return_n_hit=True)
    N = ray.o.shape[0]
    C = sw.cl_lo.shape[0]
    dev = ray.o.device
    k = min(p_max, C)
    if k < 1:
        raise ValueError(f"swept_phase_a takes p_max >= 1 and C >= 1, got "
                         f"p_max = {p_max}, C = {C}")
    o, d = ray.o.contiguous(), ray.d.contiguous()
    mint, maxt = ray.mint.contiguous(), ray.maxt.contiguous()
    for t, name, shape in ((o, "o", (N, 3)), (d, "d", (N, 3)),
                           (mint, "mint", (N,)), (maxt, "maxt", (N,)),
                           (sw.cl_lo, "cl_lo", (C, 3)),
                           (sw.cl_hi, "cl_hi", (C, 3))):
        _check(t, name, torch.float32, shape, dev)
    slots = torch.empty((N, p_max), dtype=torch.int32, device=dev)
    cnt = torch.empty((N,), dtype=torch.int32, device=dev)
    n_hit = torch.empty((N,), dtype=torch.int64, device=dev)
    if N == 0:
        return slots, cnt, n_hit
    perm = tile_order(sw, ray)
    spill = None
    if k > SMEM_K:   # each 64-ray tile's k sorted keys per ray
        spill = torch.empty((-(-N // 64) * k * 64,), dtype=torch.int64,
                            device=dev)
    rc = cull_lib().hairpt_swept_cull(
        o.data_ptr(), d.data_ptr(), mint.data_ptr(), maxt.data_ptr(),
        perm.data_ptr(), N, sw.cl_lo.data_ptr(), sw.cl_hi.data_ptr(), C, k,
        p_max, max(1, (C - 1).bit_length()), int(C <= c_chunk),
        slots.data_ptr(), cnt.data_ptr(), n_hit.data_ptr(),
        None if spill is None else spill.data_ptr(), _stream(dev))
    _raise_rc(rc, "swept_phase_a")
    LAUNCHES["swept_phase_a"] += 1
    return slots, cnt, n_hit


def never_hits_plain(o, inv, mint, maxt):
    """[N] bool: the rays the swept phase-A kernel skips, which
    _phase_a_dense's test sends past every box whatever its (finite)
    faces: on an axis where o or 1/d is not finite, both faces of every
    box give the slab value v = (0 - o) * inv, and the ray misses if v is
    NaN, +inf with maxt < +inf, or -inf with mint > -inf."""
    inf = float("inf")
    fin = torch.isfinite(o) & torch.isfinite(inv)              # [N, 3]
    v = (0.0 - o) * inv
    miss = torch.isnan(v) | ((v == inf) & ~(maxt[:, None] == inf)) \
        | ((v == -inf) & ~(mint[:, None] == -inf))
    return (~fin & miss).any(dim=1)


def swept_phase_a_model(sw, ray, p_max: int, c_chunk: int = 1024,
                        ranged=None):
    """csrc/swept_cull.cu transcribed, for the CPU tests: the rays in
    tile_order's 64-ray tiles; the tile test (tiled_kernels.
    group_cull_plain over each tile's rays but padding and those
    never_hits_plain skips, or over `ranged` [T, 64], in tile order, if
    given), the per-ray slab test of the rays it ranges on the clusters
    their tile passes (fminf/fmaxf with the kernel's NaN check), and the
    selection: hits counted, then the k = min(p_max, C) smallest keys in
    key order (key = id in the lowest-ids branch; else entry-t bits <<
    cbits | id, an entry at t = +inf not kept). Returns (slots, cnt,
    n_hit, in the caller's order, and the clusters passing the tile test
    [T])."""
    N = ray.o.shape[0]
    C = sw.cl_lo.shape[0]
    T = -(-N // 64)
    pad = T * 64 - N
    perm = tile_order(sw, ray).long()
    o = torch.cat([ray.o[perm], torch.zeros((pad, 3))])
    d = torch.cat([ray.d[perm], torch.ones((pad, 3))])
    mint = torch.cat([ray.mint[perm], torch.zeros(pad)])
    maxt = torch.cat([ray.maxt[perm], torch.zeros(pad)])
    r8 = torch.cat([o.T, d.T, mint[None], maxt[None]]).view(8, T, 64) \
        .transpose(0, 1)
    inv = tk._inv_dir(d)
    if ranged is None:
        ranged = ((torch.arange(T * 64) < N)
                  & ~never_hits_plain(o, inv, mint, maxt)).view(T, 64)
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T])
    p1 = tk.group_cull_plain(r8, bounds, ranged)               # [T, C]
    tn = tf = None
    nan = torch.zeros((T * 64, C), dtype=torch.bool)
    for ax in range(3):
        a0 = (sw.cl_lo[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        a1 = (sw.cl_hi[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        nan = nan | torch.isnan(a0) | torch.isnan(a1)
        lo_ax, hi_ax = torch.fmin(a0, a1), torch.fmax(a0, a1)
        tn = lo_ax if tn is None else torch.fmax(tn, lo_ax)
        tf = hi_ax if tf is None else torch.fmin(tf, hi_ax)
    tf = tf * 1.00000024 + 1e-7
    hit = ~nan & (tn <= tf) & (tf >= mint[:, None]) & (tn <= maxt[:, None])
    hit = (hit & p1.repeat_interleave(64, dim=0)
           & ranged.reshape(-1, 1))[:N]
    cid = torch.arange(C)
    k = min(p_max, C)
    if C <= c_chunk:
        kept, key = hit, cid.expand(N, C)
    else:
        cbits = max(1, (C - 1).bit_length())
        tb = torch.clamp(tn[:N], min=0.0).view(torch.int32).long() \
            & 0x7FFFFFFF
        kept, key = hit & (tb < 0x7F800000), (tb << cbits) | cid
    key = torch.where(kept, key, torch.iinfo(torch.int64).max)
    sel = torch.sort(key, dim=1).values[:, :k]
    n_kept = torch.clamp(kept.sum(1), max=k)
    cmask = (1 << max(1, (C - 1).bit_length())) - 1
    slots = torch.full((N, p_max), -1, dtype=torch.int32)
    slots[perm, :k] = torch.where(torch.arange(k)[None] < n_kept[:, None],
                                  sel & cmask, -1).to(torch.int32)
    back = torch.empty_like(perm)
    back[perm] = torch.arange(N)
    return (slots, n_kept.to(torch.int32)[back], hit.sum(1)[back],
            p1.sum(1))


# ---------------------------------------------------------------------------
# kernel E
# ---------------------------------------------------------------------------


def phase_b_chunks(chunk_cl, chunk_rays, seg_rows, sub_lo=None,
                   sub_hi=None):
    """(t [n_chunks, CH] f32, pid [n_chunks, CH] i32): each ray's closest
    hit over its chunk's cluster; among the lanes at the minimum t the
    largest pid wins (the JAX kernel's rule). The kernel skips the
    32-segment sub-clusters whose box (sub_lo, sub_hi, widened by SUB_PAD)
    a ray does not enter; the result does not depend on them, and the
    plain version does not read them."""
    if not chunk_rays.is_cuda:
        return phase_b_chunks_plain(chunk_cl, chunk_rays, seg_rows)
    n, _, ch = chunk_rays.shape
    C, _, K = seg_rows.shape
    dev = chunk_rays.device
    if K not in KERNEL_K:
        raise ValueError(f"phase_b_chunks kernel takes K in {KERNEL_K}, "
                         f"got {K}")
    if not 0 < ch <= MAX_CH:
        raise ValueError(f"phase_b_chunks kernel takes CH <= {MAX_CH}, "
                         f"got {ch}")
    if sub_lo is None or sub_hi is None:
        raise ValueError("phase_b_chunks kernel culls with the sub-cluster "
                         "boxes: pass sub_lo and sub_hi")
    _check(chunk_cl, "chunk_cl", torch.int32, (n,), dev)
    _check(chunk_rays, "chunk_rays", torch.float32, (n, 8, ch), dev)
    _check(seg_rows, "seg_rows", torch.float32, (C, 16, K), dev)
    _check(sub_lo, "sub_lo", torch.float32, (C * K // SUBK, 3), dev)
    _check(sub_hi, "sub_hi", torch.float32, (C * K // SUBK, 3), dev)
    t = torch.empty((n, ch), dtype=torch.float32, device=dev)
    pid = torch.empty((n, ch), dtype=torch.int32, device=dev)
    rc = lib().hairpt_phase_b_chunks(chunk_cl.data_ptr(),
                                     chunk_rays.data_ptr(),
                                     seg_rows.data_ptr(), sub_lo.data_ptr(),
                                     sub_hi.data_ptr(), n, ch, K,
                                     t.data_ptr(), pid.data_ptr(),
                                     _stream(dev))
    _raise_rc(rc, "phase_b_chunks")
    LAUNCHES["phase_b_chunks"] += 1
    return t, pid


def sub_cull_plain(chunk_rays, lo, hi, pad=None):
    """Plain version of kernel E's sub-box cull: chunk_rays [n, 8, CH],
    the boxes of each chunk's sub-clusters lo, hi [n, S, 3] -> [n, S, CH]
    bool, False only where the ray cannot hit a segment of the
    sub-cluster. Kernel A's slab arithmetic on the box widened by `pad`
    (default SUB_PAD) times the larger of the ray origin's and the box's
    largest |coordinate|; a lane with maxt < mint fails, a ray with a
    non-finite o, d or 1/d component passes."""
    pad = SUB_PAD if pad is None else pad
    o = chunk_rays[:, None, 0:3]                        # [n, 1, 3, CH]
    d = chunk_rays[:, None, 3:6]
    inv_d = tk._inv_dir(d)
    mint, maxt = chunk_rays[:, None, 6], chunk_rays[:, None, 7]
    mag = torch.abs(o).amax(dim=2)                      # [n, 1, CH]
    bmag = torch.maximum(torch.abs(lo), torch.abs(hi)).amax(dim=2)
    p = pad * (mag + bmag[..., None])                   # [n, S, CH]
    tn, tf = tk._slab([o[:, :, ax] for ax in range(3)],
                      [inv_d[:, :, ax] for ax in range(3)],
                      [lo[..., ax, None] - p for ax in range(3)],
                      [hi[..., ax, None] + p for ax in range(3)])
    fin = (torch.isfinite(o) & torch.isfinite(d)
           & torch.isfinite(inv_d)).all(dim=2)
    return (maxt >= mint) & (~fin | ((tn <= tf) & (tf >= mint)
                                     & (tn <= maxt)))


def _cyl_terms(rows, rays):
    """The terms of _phaseb_one's cylinder test that cyl_test_chunk and
    cyl_pretest_plain share: rows [n, 16, K], rays [n, 8, CH] -> the
    segment rows [n, 1, K] and ray rows [n, CH, 1] as getters, the
    components of o - p0 and d perpendicular to the axis, a = |pd|^2 and
    b = po . pd, in the kernel's order of operations."""
    def seg(j):
        return rows[:, j, None, :]                 # [n, 1, K]

    def rayc(j):
        return rays[:, j, :, None]                 # [n, CH, 1]

    ax_, ay_, az_ = seg(3), seg(4), seg(5)
    rx, ry, rz = rayc(0) - seg(0), rayc(1) - seg(1), rayc(2) - seg(2)
    ar = ax_ * rx + ay_ * ry + az_ * rz
    po = (rx - ar * ax_, ry - ar * ay_, rz - ar * az_)
    dx, dy, dz = rayc(3), rayc(4), rayc(5)
    ad = ax_ * dx + ay_ * dy + az_ * dz
    pd = (dx - ad * ax_, dy - ad * ay_, dz - ad * az_)
    a = pd[0] * pd[0] + pd[1] * pd[1] + pd[2] * pd[2]
    b = po[0] * pd[0] + po[1] * pd[1] + po[2] * pd[2]
    return seg, rayc, po, pd, a, b


def cyl_test_chunk(rows, rays):
    """Miter-cylinder test of pallas_phaseb._phaseb_one: rows [n, 16, K]
    (one cluster per chunk), rays [n, 8, CH] -> (t [n, CH, K] with inf =
    miss, pid_row [n, 1, K]). Two divisions by a and the miter planes
    through the hit point, in the kernel's order of operations."""
    seg, rayc, (pox, poy, poz), (pdx, pdy, pdz), a, b = _cyl_terms(rows,
                                                                   rays)
    p0x, p0y, p0z = seg(0), seg(1), seg(2)
    n0x, n0y, n0z = seg(6), seg(7), seg(8)
    n1x, n1y, n1z = seg(9), seg(10), seg(11)
    sn1 = seg(13)
    rr2 = seg(14)
    pid_row = rows[:, 15, None, :].contiguous().view(torch.int32)
    ox, oy, oz = rayc(0), rayc(1), rayc(2)
    dx, dy, dz = rayc(3), rayc(4), rayc(5)
    mint2 = rayc(6)
    maxt2 = rayc(7)

    ok = a > 1e-18
    a_safe = torch.where(ok, a, 1.0)
    t_mid = -b / a_safe
    qx, qy, qz = pox + pdx * t_mid, poy + pdy * t_mid, poz + pdz * t_mid
    c_mid = qx * qx + qy * qy + qz * qz - rr2
    disc = -c_mid / a_safe
    ok = ok & (disc >= 0.0)
    dt = tk.sqrt_rn(torch.clamp(disc, min=0.0))
    t_near = t_mid - dt
    t_far = t_mid + dt

    def miter_ok(t):
        ex = ox + dx * t - p0x
        ey = oy + dy * t - p0y
        ez = oz + dz * t - p0z
        h0 = ex * n0x + ey * n0y + ez * n0z
        h1 = ex * n1x + ey * n1y + ez * n1z - sn1
        return (h0 >= 0.0) & (h1 <= 0.0)

    near_ok = ok & (t_near >= mint2) & (t_near <= maxt2) & miter_ok(t_near)
    far_ok = ok & (t_far >= mint2) & (t_far <= maxt2) & miter_ok(t_far)
    t = torch.where(near_ok, t_near, t_far)
    hit = (pid_row >= 0) & (near_ok | far_ok)
    return torch.where(hit, t, float("inf")), pid_row


def cyl_pretest_plain(rows, rays, t_rel: float = 0.0):
    """Plain version of kernel E's pretest (csrc/cyl_test.cuh
    cyl_may_hit_chunk): rows [n, 16, K], rays [n, 8, CH] -> [n, CH, K]
    bool, False only where cyl_test_chunk misses. It computes c = |q|^2 -
    r^2 at q = po + pd t_mid as cyl_test_chunk does, with t_mid from an
    approximate division, and rejects a c above its error bound
    2^-17 Lq W + 2^-36 W^2 + 2^-19 (|q|^2 + r^2) + 1e-30 (Lp, Lq the L1
    norms of po and q, W = Lp + 2 Lq; finite c and bound only). The
    kernel's __fdividef is within 2 ulp of -b / a; here t_mid = (-b / a)
    (1 + t_rel), so a test can move it by more than that."""
    seg, _, (pox, poy, poz), (pdx, pdy, pdz), a, b = _cyl_terms(rows, rays)
    rr2 = seg(14)
    ok = a > 1e-18
    tm = -b / torch.where(ok, a, 1.0) * (1.0 + t_rel)
    qx, qy, qz = pox + pdx * tm, poy + pdy * tm, poz + pdz * tm
    sq = qx * qx + qy * qy + qz * qz
    c = sq - rr2
    lq = torch.abs(qx) + torch.abs(qy) + torch.abs(qz)
    w = torch.abs(pox) + torch.abs(poy) + torch.abs(poz) + 2.0 * lq
    tol = PRETEST_Q * lq * w + PRETEST_W * w * w \
        + PRETEST_S * (sq + rr2) + 1e-30
    rej = torch.isfinite(c) & torch.isfinite(tol) & (c > tol)
    pid_row = rows[:, 15, None, :].contiguous().view(torch.int32)
    return (pid_row >= 0) & ok & ~rej


# kernel E's pretest bound (csrc/cyl_test.cuh cyl_may_hit_chunk)
PRETEST_Q = 2.0 ** -17
PRETEST_W = 2.0 ** -36
PRETEST_S = 2.0 ** -19


# chunks per piece of the plain version: bounds its [n, CH, K] temporaries
PLAIN_CHUNKS = 1024


def phase_b_chunks_plain(chunk_cl, chunk_rays, seg_rows):
    """Plain version of kernel E, in pieces of PLAIN_CHUNKS chunks."""
    if chunk_rays.is_cuda:
        PLAIN_ON_CUDA["phase_b_chunks"] += 1
    ts, ps = [], []
    for c in range(0, max(chunk_cl.shape[0], 1), PLAIN_CHUNKS):
        cl = chunk_cl[c:c + PLAIN_CHUNKS]
        live = (cl >= 0)[:, None, None]
        t_m, pid_row = cyl_test_chunk(seg_rows[cl.clamp(min=0).long()],
                                      chunk_rays[c:c + PLAIN_CHUNKS])
        t_m = torch.where(live, t_m, float("inf"))
        best = t_m.amin(dim=2)
        is_best = (t_m <= best[..., None]) & torch.isfinite(t_m)
        ts.append(best)
        ps.append(torch.where(is_best, pid_row, -1).amax(dim=2))
    return torch.cat(ts), torch.cat(ps)
