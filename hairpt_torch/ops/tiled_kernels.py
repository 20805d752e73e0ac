"""The two hand-written CUDA kernels of the tiled intersector, their
wrappers and their plain PyTorch versions (port of hairpt/ops/pallas_tiled.py).

  cull_phase_a  phase A: slab test of each 64-ray tile against every
                cluster AABB (replaces pallas_tiled._cull_kernel)
  phase_b       phase B: miter-cylinder test over each tile's packed slot
                list (replaces pallas_tiled._tiled_kernel, deferred
                HAIRPT_UNROLL=8 semantics)

Layout contract:
  rays8    [T, 8, 64] f32  rows o.xyz, d.xyz, mint, maxt (dead: maxt<=mint)
  bounds   [6, C] f32      cluster lo.xyz, hi.xyz rows
  te       [T, C] bf16     min entry t per (tile, cluster), +inf = miss
  t_pmax   [T, 64] f32     per-ray largest entry t (-1 = no candidate)
  slots    [T, q] i32      cid | bq << 20 (bq: 12-bit suffix bound)
  cnt      [T] i32, tmin/tscale [T] f32
  seg_rows [C, 16, K] f32  (K in KERNEL_K for the kernel)
  t, pid   [T, 64] f32 / i32 (inf / -1 = miss)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. LAUNCHES counts kernel launches and
PLAIN_ON_CUDA counts plain-version calls on CUDA tensors (the main path
makes none; chip_smoke.py calls the plain versions on the card only to
compare).
"""
from __future__ import annotations

import ctypes
import os
import shutil

import torch

TILE = 64
UNROLL = 8            # slots between phase-B early-exit checks
TE_INF = 4095         # 12-bit "+inf" bound
CID_MASK = (1 << 20) - 1
KERNEL_K = (32, 64, 128)   # instantiated in tiled.cu

LAUNCHES = {"cull_phase_a": 0, "phase_b": 0}
PLAIN_ON_CUDA = {"cull_phase_a": 0, "phase_b": 0}


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


def nvcc_path() -> str:
    p = shutil.which("nvcc")
    if p is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        p = "/usr/local/cuda/bin/nvcc"
    if p is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return p


def nvcc_cmd():
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
            "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
            "-Xptxas=-v"]


_LIB = None


def lib():
    """Build (first use) and load libhairpt_tiled.so."""
    global _LIB
    if _LIB is None:
        from ._native import load_library
        L = load_library("hairpt_tiled", ["tiled.cu"], nvcc_cmd())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.hairpt_cull.argtypes = [vp, vp, ci, ci, vp, vp, vp]
        L.hairpt_cull.restype = ci
        L.hairpt_phase_b.argtypes = [vp] * 7 + [ci, ci, ci, ci, vp, vp, vp, vp]
        L.hairpt_phase_b.restype = ci
        _LIB = L
    return _LIB


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


# ---------------------------------------------------------------------------
# phase A
# ---------------------------------------------------------------------------

def cull_phase_a(rays8, bounds):
    """(te [T, C] bf16, t_pmax [T, 64] f32) for rays8 [T, 8, 64] and
    bounds [6, C]."""
    if not rays8.is_cuda:
        return cull_phase_a_plain(rays8, bounds)
    T, C = rays8.shape[0], bounds.shape[1]
    dev = rays8.device
    _check(rays8, "rays8", torch.float32, (T, 8, TILE), dev)
    _check(bounds, "bounds", torch.float32, (6, C), dev)
    te = torch.empty((T, C), dtype=torch.bfloat16, device=dev)
    t_pmax = torch.full((T, TILE), -1.0, dtype=torch.float32, device=dev)
    rc = lib().hairpt_cull(rays8.data_ptr(), bounds.data_ptr(), T, C,
                           te.data_ptr(), t_pmax.data_ptr(), _stream(dev))
    _raise_rc(rc, "cull_phase_a")
    LAUNCHES["cull_phase_a"] += 1
    return te, t_pmax


def cull_phase_a_plain(rays8, bounds, tile_chunk: int = 64):
    """Plain version of kernel A (the JAX package's _tile_cluster_mask
    with cull_phase_a's bf16 truncation), chunked over tiles so the
    [tiles, 64, C] temporaries stay small."""
    if rays8.is_cuda:
        PLAIN_ON_CUDA["cull_phase_a"] += 1
    T = rays8.shape[0]
    C = bounds.shape[1]
    inf = float("inf")
    tes, tpms = [], []
    for t0 in range(0, T, tile_chunk):
        r = rays8[t0:t0 + tile_chunk]
        o = r[:, 0:3]                                   # [Tc, 3, 64]
        d = r[:, 3:6]
        d = torch.where(torch.abs(d) < 1e-12,
                        torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype), d)
        inv_d = 1.0 / d
        mint = r[:, 6, :, None]
        maxt = r[:, 7, :, None]
        tn = tf = None
        for ax in range(3):
            a0 = (bounds[ax][None, None, :] - o[:, ax, :, None]) \
                * inv_d[:, ax, :, None]
            a1 = (bounds[3 + ax][None, None, :] - o[:, ax, :, None]) \
                * inv_d[:, ax, :, None]
            lo_ax = torch.minimum(a0, a1)
            hi_ax = torch.maximum(a0, a1)
            tn = lo_ax if tn is None else torch.maximum(tn, lo_ax)
            tf = hi_ax if tf is None else torch.minimum(tf, hi_ax)
        tf = tf * 1.00000024 + 1e-7
        hit = (tn <= tf) & (tf >= mint) & (tn <= maxt) & (maxt > mint)
        tn0 = torch.clamp(tn, min=0.0)
        te_c = torch.where(hit, tn0, inf).amin(dim=1)          # [Tc, C]
        te_c = (te_c.view(torch.int32) & -65536).view(torch.float32)
        tes.append(te_c.to(torch.bfloat16))
        tpms.append(torch.where(hit, tn0, -1.0).amax(dim=2))   # [Tc, 64]
    return torch.cat(tes), torch.cat(tpms)


# ---------------------------------------------------------------------------
# phase B
# ---------------------------------------------------------------------------

def phase_b(slots, cnt, tmin, tscale, rays8, t_pmax, seg_rows,
            any_hit: bool = False, return_slots_run: bool = False):
    """(t [T, 64] f32, pid [T, 64] i32): closest (or any) hit of each ray
    over its tile's cnt[t] packed slots. return_slots_run adds the number
    of slots each tile tested before its early exit ([T] i32)."""
    if not rays8.is_cuda:
        return phase_b_plain(slots, cnt, tmin, tscale, rays8, t_pmax,
                             seg_rows, any_hit, return_slots_run)
    T, q = slots.shape
    C, _, K = seg_rows.shape
    dev = rays8.device
    if K not in KERNEL_K:
        raise ValueError(f"phase_b kernel takes K in {KERNEL_K}, got {K}")
    _check(slots, "slots", torch.int32, (T, q), dev)
    _check(cnt, "cnt", torch.int32, (T,), dev)
    _check(tmin, "tmin", torch.float32, (T,), dev)
    _check(tscale, "tscale", torch.float32, (T,), dev)
    _check(rays8, "rays8", torch.float32, (T, 8, TILE), dev)
    _check(t_pmax, "t_pmax", torch.float32, (T, TILE), dev)
    _check(seg_rows, "seg_rows", torch.float32, (C, 16, K), dev)
    t = torch.empty((T, TILE), dtype=torch.float32, device=dev)
    pid = torch.empty((T, TILE), dtype=torch.int32, device=dev)
    run = torch.empty((T,), dtype=torch.int32, device=dev) \
        if return_slots_run else None
    rc = lib().hairpt_phase_b(
        slots.data_ptr(), cnt.data_ptr(), tmin.data_ptr(),
        tscale.data_ptr(), rays8.data_ptr(), t_pmax.data_ptr(),
        seg_rows.data_ptr(), T, q, K, int(bool(any_hit)), t.data_ptr(),
        pid.data_ptr(), None if run is None else run.data_ptr(),
        _stream(dev))
    _raise_rc(rc, "phase_b")
    LAUNCHES["phase_b"] += 1
    return (t, pid, run) if return_slots_run else (t, pid)


def cyl_test(rows, rays):
    """Miter-cylinder test, the JAX package's _cyl_test_tm: rows
    [n, 16, K] (one cluster per tile), rays [n, 8, 64] ->
    (t [n, 64, K] with inf = miss, pid_row [n, 1, K]). Same operations in
    the same order as the kernel."""
    def seg(j):
        return rows[:, j, None, :]                 # [n, 1, K]

    def rayc(j):
        return rays[:, j, :, None]                 # [n, 64, 1]

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
    inv_a = 1.0 / a_safe
    t_mid = -b * inv_a
    qx, qy, qz = pox + pdx * t_mid, poy + pdy * t_mid, poz + pdz * t_mid
    c_mid = qx * qx + qy * qy + qz * qz - rr2
    disc = -c_mid * inv_a
    ok = ok & (disc >= 0.0)
    dt = torch.sqrt(torch.clamp(disc, min=0.0))
    t_near = t_mid - dt
    t_far = t_mid + dt
    on0 = rx * n0x + ry * n0y + rz * n0z
    dn0 = dx * n0x + dy * n0y + dz * n0z
    on1 = rx * n1x + ry * n1y + rz * n1z - sn1
    dn1 = dx * n1x + dy * n1y + dz * n1z

    def miter_ok(t):
        return (on0 + t * dn0 >= 0.0) & (on1 + t * dn1 <= 0.0)

    near_ok = ok & (t_near >= mint2) & (t_near <= maxt2) & miter_ok(t_near)
    far_ok = ok & (t_far >= mint2) & (t_far <= maxt2) & miter_ok(t_far)
    t = torch.where(near_ok, t_near, t_far)
    hit = (pid_row >= 0) & (near_ok | far_ok)
    return torch.where(hit, t, float("inf")), pid_row


# tiles per chunk of the plain phase B: bounds its [tiles, 64, K]
# running matrices and temporaries at any wave size
PLAIN_B_TILES = 1024


def phase_b_plain(slots, cnt, tmin, tscale, rays8, t_pmax, seg_rows,
                  any_hit: bool = False, return_slots_run: bool = False):
    """Plain version of kernel B with the JAX kernel's deferred semantics:
    a running (t, pid) per (ray, lane) updated on strict <, an early-exit
    check after every group of UNROLL slots, and the final reduction
    "min t, then the largest pid among the lanes at that t". any_hit: a
    ray holding a finite hit skips the remaining slots (as the kernel).
    Tiles are independent, so they run in chunks of PLAIN_B_TILES."""
    if rays8.is_cuda:
        PLAIN_ON_CUDA["phase_b"] += 1
    outs = [_phase_b_plain_chunk(slots[c:c + PLAIN_B_TILES],
                                 cnt[c:c + PLAIN_B_TILES],
                                 tmin[c:c + PLAIN_B_TILES],
                                 tscale[c:c + PLAIN_B_TILES],
                                 rays8[c:c + PLAIN_B_TILES],
                                 t_pmax[c:c + PLAIN_B_TILES], seg_rows,
                                 any_hit)
            for c in range(0, max(slots.shape[0], 1), PLAIN_B_TILES)]
    best, pid, run = (torch.cat(x) for x in zip(*outs))
    return (best, pid, run) if return_slots_run else (best, pid)


def _phase_b_plain_chunk(slots, cnt, tmin, tscale, rays8, t_pmax, seg_rows,
                         any_hit):
    T = slots.shape[0]
    K = seg_rows.shape[2]
    dev = rays8.device
    inf = float("inf")
    run_t = torch.full((T, TILE, K), inf, device=dev)
    run_pid = torch.full((T, TILE, K), -1, dtype=torch.int32, device=dev)
    cnt_l = cnt.long()
    active = cnt_l > 0
    run = torch.zeros((T,), dtype=torch.int32, device=dev)
    n_max = int(cnt_l.max()) if T > 0 else 0
    for q0 in range(0, n_max, UNROLL):
        if not bool(active.any()):
            break
        for s in range(q0, min(q0 + UNROLL, n_max)):
            idx = torch.nonzero(active & (s < cnt_l)).squeeze(1)
            if idx.numel() == 0:
                continue
            cid = (slots[idx, s] & CID_MASK).long()
            t_m, pid_row = cyl_test(seg_rows[cid], rays8[idx])
            prev = run_t[idx]
            if any_hit:
                held = torch.isfinite(prev.amin(dim=2, keepdim=True))
                t_m = torch.where(held, inf, t_m)
            better = t_m < prev
            run_t[idx] = torch.where(better, t_m, prev)
            run_pid[idx] = torch.where(better, pid_row, run_pid[idx])
        chk = active & (q0 < cnt_l)
        q_end = torch.clamp(cnt_l, max=q0 + UNROLL)
        run = torch.where(chk, q_end.to(torch.int32), run)
        q_last = (q_end - 1).clamp(min=0)
        packed = slots.gather(1, q_last[:, None])[:, 0]
        bq = (packed >> 20) & TE_INF
        te_next = torch.where(bq == TE_INF, inf,
                              tmin + bq.to(torch.float32) * tscale)
        best = run_t.amin(dim=2)
        if any_hit:
            done_ray = torch.isfinite(best) | (te_next[:, None] > t_pmax)
        else:
            done_ray = (best <= te_next[:, None]) \
                | (te_next[:, None] > t_pmax)
        done = done_ray.all(dim=1)
        active = active & ~(chk & done) & (q0 + UNROLL < cnt_l)
    best = run_t.amin(dim=2)
    if any_hit:
        pid = torch.where(torch.isfinite(best), 0, -1).to(torch.int32)
    else:
        is_best = (run_t <= best[..., None]) & torch.isfinite(run_t)
        pid = torch.where(is_best, run_pid, -1).amax(dim=2)
    return best, pid, run
