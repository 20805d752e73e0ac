"""The hand-written CUDA kernel of the swept traversal's phase B, its
wrapper and its plain PyTorch version (port of hairpt/ops/pallas_phaseb.py).

  phase_b_chunks  kernel E: each chunk of CH rays, all routed to one
                  cluster, against that cluster's K segments (replaces
                  pallas_phaseb._phaseb_kernel / _phaseb_one;
                  csrc/phaseb.cu)

Layout contract (from intersect_swept.swept_closest_hit):
  chunk_cl   [n_chunks] i32         cluster per chunk (-1 = dead chunk)
  chunk_rays [n_chunks, 8, CH] f32  rows o.xyz, d.xyz, mint, maxt (dead
                                    lanes maxt = -1)
  seg_rows   [C, 16, K] f32         (K in KERNEL_K for the kernel)
  t, pid     [n_chunks, CH] f32 / i32 (inf / -1 = miss)

The wrapper runs the plain version for CPU tensors and launches the kernel
or raises for CUDA tensors. LAUNCHES counts kernel launches, PLAIN_ON_CUDA
plain-version calls on CUDA tensors (the main path makes none).
"""
from __future__ import annotations

import ctypes

import torch

from .tiled_kernels import HEADERS, KERNEL_K, _check, _raise_rc, _stream, \
    nvcc_cmd

MAX_CH = 256          # rays per chunk the kernel's launch accepts

LAUNCHES = {"phase_b_chunks": 0}
PLAIN_ON_CUDA = {"phase_b_chunks": 0}


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


_LIB = None


def lib():
    """Build (first use) and load libhairpt_phaseb.so."""
    global _LIB
    if _LIB is None:
        from ._native import load_library
        L = load_library("hairpt_phaseb", ["phaseb.cu"], nvcc_cmd(), HEADERS)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.hairpt_phase_b_chunks.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp,
                                            vp]
        L.hairpt_phase_b_chunks.restype = ci
        _LIB = L
    return _LIB


def phase_b_chunks(chunk_cl, chunk_rays, seg_rows):
    """(t [n_chunks, CH] f32, pid [n_chunks, CH] i32): each ray's closest
    hit over its chunk's cluster; among the lanes at the minimum t the
    largest pid wins (the JAX kernel's rule)."""
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
    _check(chunk_cl, "chunk_cl", torch.int32, (n,), dev)
    _check(chunk_rays, "chunk_rays", torch.float32, (n, 8, ch), dev)
    _check(seg_rows, "seg_rows", torch.float32, (C, 16, K), dev)
    t = torch.empty((n, ch), dtype=torch.float32, device=dev)
    pid = torch.empty((n, ch), dtype=torch.int32, device=dev)
    rc = lib().hairpt_phase_b_chunks(chunk_cl.data_ptr(),
                                     chunk_rays.data_ptr(),
                                     seg_rows.data_ptr(), n, ch, K,
                                     t.data_ptr(), pid.data_ptr(),
                                     _stream(dev))
    _raise_rc(rc, "phase_b_chunks")
    LAUNCHES["phase_b_chunks"] += 1
    return t, pid


def cyl_test_chunk(rows, rays):
    """Miter-cylinder test of pallas_phaseb._phaseb_one: rows [n, 16, K]
    (one cluster per chunk), rays [n, 8, CH] -> (t [n, CH, K] with inf =
    miss, pid_row [n, 1, K]). Two divisions by a and the miter planes
    through the hit point, in the kernel's order of operations."""
    def seg(j):
        return rows[:, j, None, :]                 # [n, 1, K]

    def rayc(j):
        return rays[:, j, :, None]                 # [n, CH, 1]

    p0x, p0y, p0z = seg(0), seg(1), seg(2)
    ax_, ay_, az_ = seg(3), seg(4), seg(5)
    n0x, n0y, n0z = seg(6), seg(7), seg(8)
    n1x, n1y, n1z = seg(9), seg(10), seg(11)
    sn1 = seg(13)
    rr2 = seg(14)
    pid_row = rows[:, 15, None, :].contiguous().view(torch.int32)
    ox, oy, oz = rayc(0), rayc(1), rayc(2)
    dx, dy, dz = rayc(3), rayc(4), rayc(5)
    mint2 = rayc(6)
    maxt2 = rayc(7)

    rx, ry, rz = ox - p0x, oy - p0y, oz - p0z
    ar = ax_ * rx + ay_ * ry + az_ * rz
    pox, poy, poz = rx - ar * ax_, ry - ar * ay_, rz - ar * az_
    ad = ax_ * dx + ay_ * dy + az_ * dz
    pdx, pdy, pdz = dx - ad * ax_, dy - ad * ay_, dz - ad * az_
    a = pdx * pdx + pdy * pdy + pdz * pdz
    b = pox * pdx + poy * pdy + poz * pdz
    ok = a > 1e-18
    a_safe = torch.where(ok, a, 1.0)
    t_mid = -b / a_safe
    qx, qy, qz = pox + pdx * t_mid, poy + pdy * t_mid, poz + pdz * t_mid
    c_mid = qx * qx + qy * qy + qz * qz - rr2
    disc = -c_mid / a_safe
    ok = ok & (disc >= 0.0)
    dt = torch.sqrt(torch.clamp(disc, min=0.0))
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
