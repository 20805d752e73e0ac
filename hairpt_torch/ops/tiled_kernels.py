"""The hand-written CUDA kernels of the tiled intersector, their wrappers
and their plain PyTorch versions (port of hairpt/ops/pallas_tiled.py).

  cull_phase_a    kernel A, phase A: slab test of each 64-ray tile against
                  every cluster AABB (replaces pallas_tiled._cull_kernel);
                  emit_oct=True adds the octet bits (csrc/tiled.cu); the
                  kernel slab-tests a ray only against the clusters that
                  pass its tile test (group_cull_plain)
  phase_b         kernel B, phase B: miter-cylinder test over each tile's
                  packed slot list (replaces pallas_tiled._tiled_kernel,
                  deferred HAIRPT_UNROLL=8 semantics; csrc/tiled.cu);
                  the kernel tests a slot only for the rays that enter
                  its widened cluster box (slot_cull_plain)
  phase_b_oct     kernel C, phase B that tests a slot only for the 8-ray
                  octets whose bit is set (replaces
                  pallas_tiled._tiled_kernel_oct; csrc/octets.cu); the
                  kernel tests a slot only for the rays of those octets
                  that enter its widened cluster box (slot_cull_plain)
  stream_phase_b  kernel D, phase B over eight per-octet compacted slot
                  streams (replaces pallas_tiled._stream_kernel;
                  csrc/octets.cu); the kernel tests an entry only for the
                  octet's rays that enter its widened cluster box

Layout contract:
  rays8    [T, 8, 64] f32  rows o.xyz, d.xyz, mint, maxt (dead: maxt<=mint)
  bounds   [6, C] f32      cluster lo.xyz, hi.xyz rows
  te       [T, C] bf16     min entry t per (tile, cluster), +inf = miss
  t_pmax   [T, 64] f32     per-ray largest entry t (-1 = no candidate)
  slots    [T, q] i32      cid | bq << 20 (bq: 12-bit suffix bound)
  cnt      [T] i32, tmin/tscale [T] f32
  seg_rows [C, 16, K] f32  (K in KERNEL_K for the kernel)
  t, pid   [T, 64] f32 / i32 (inf / -1 = miss)
  oct      [T, C] i32       bit o: a ray of octet o (rays 8o..8o+7) enters
  oct_slot [T, q] i32       the slot's octet word (0 for an empty slot)
  cids     [T, q] i32       slot cluster ids (stream mode)
  streams  [T, 8, qo] i32   slot index | bq << 12 per octet stream
  off      [T, n_win+1, 8]  per-window stream offsets (last column: lengths)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. LAUNCHES counts the launches of the dense
path's kernels (A, B) and OCT_LAUNCHES those of the octet and stream
modes (A's octet variant, C, D), which the default path never runs;
PLAIN_ON_CUDA and OCT_PLAIN_ON_CUDA count plain-version calls on CUDA
tensors (the main path makes none; chip_smoke.py calls the plain versions
on the card only to compare).
"""
from __future__ import annotations

import ctypes
import os
import shutil

import numpy as np
import torch

TILE = 64
UNROLL = 8            # slots between phase-B early-exit checks
TE_INF = 4095         # 12-bit "+inf" bound
CID_MASK = (1 << 20) - 1
QBITS = 12            # stream entry: slot index in the low 12 bits
KERNEL_K = (32, 64, 128)   # instantiated in every kernel source

LAUNCHES = {"cull_phase_a": 0, "phase_b": 0}
PLAIN_ON_CUDA = {"cull_phase_a": 0, "phase_b": 0}
OCT_LAUNCHES = {"cull_phase_a_oct": 0, "phase_b_oct": 0,
                "stream_phase_b": 0}
OCT_PLAIN_ON_CUDA = {"cull_phase_a_oct": 0, "phase_b_oct": 0,
                     "stream_phase_b": 0}


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA, OCT_LAUNCHES, OCT_PLAIN_ON_CUDA):
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
_OCT_LIB = None
HEADERS = ["cyl_test.cuh", "slab.cuh"]


def lib():
    """Build (first use) and load libhairpt_tiled.so (kernels A and B)."""
    global _LIB
    if _LIB is None:
        from ._native import load_library
        L = load_library("hairpt_tiled", ["tiled.cu"], nvcc_cmd(), HEADERS)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.hairpt_cull.argtypes = [vp, vp, ci, ci, vp, vp, vp, vp]
        L.hairpt_cull.restype = ci
        L.hairpt_phase_b.argtypes = [vp] * 8 + [ci] * 4 + [vp] * 5
        L.hairpt_phase_b.restype = ci
        _LIB = L
    return _LIB


def oct_lib():
    """Build (first use) and load libhairpt_octets.so (kernels C and D)."""
    global _OCT_LIB
    if _OCT_LIB is None:
        from ._native import load_library
        L = load_library("hairpt_octets", ["octets.cu"], nvcc_cmd(), HEADERS)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        L.hairpt_phase_b_oct.argtypes = [vp] * 9 + [ci] * 5 + [vp] * 4
        L.hairpt_phase_b_oct.restype = ci
        L.hairpt_stream.argtypes = [vp] * 9 + [ci] * 7 + [vp] * 4
        L.hairpt_stream.restype = ci
        _OCT_LIB = L
    return _OCT_LIB


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

def cull_phase_a(rays8, bounds, emit_oct: bool = False):
    """(te [T, C] bf16, t_pmax [T, 64] f32) for rays8 [T, 8, 64] and
    bounds [6, C]; emit_oct adds oct [T, C] i32 (the kernel's octet
    instance, which only the octet and stream modes launch)."""
    if not rays8.is_cuda:
        return cull_phase_a_plain(rays8, bounds, emit_oct=emit_oct)
    T, C = rays8.shape[0], bounds.shape[1]
    dev = rays8.device
    _check(rays8, "rays8", torch.float32, (T, 8, TILE), dev)
    _check(bounds, "bounds", torch.float32, (6, C), dev)
    te = torch.empty((T, C), dtype=torch.bfloat16, device=dev)
    t_pmax = torch.full((T, TILE), -1.0, dtype=torch.float32, device=dev)
    oct = torch.empty((T, C), dtype=torch.int32, device=dev) \
        if emit_oct else None
    rc = lib().hairpt_cull(rays8.data_ptr(), bounds.data_ptr(), T, C,
                           te.data_ptr(), t_pmax.data_ptr(),
                           None if oct is None else oct.data_ptr(),
                           _stream(dev))
    _raise_rc(rc, "cull_phase_a")
    if emit_oct:
        OCT_LAUNCHES["cull_phase_a_oct"] += 1
        return te, t_pmax, oct
    LAUNCHES["cull_phase_a"] += 1
    return te, t_pmax


def _inv_dir(d):
    """1 / d with components below 1e-12 in magnitude set to +-1e-12, as
    the slab tests of kernels A and B take it."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12,
                             torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype),
                             d)


def _slab(o, inv_d, lo, hi):
    """The slab test's interval (entry tn, exit tf widened by 1.00000024
    and 1e-7) from per-axis lists of broadcastable tensors, in the
    kernels' order of operations."""
    tn = tf = None
    for ax in range(3):
        a0 = (lo[ax] - o[ax]) * inv_d[ax]
        a1 = (hi[ax] - o[ax]) * inv_d[ax]
        lo_ax = torch.minimum(a0, a1)
        hi_ax = torch.maximum(a0, a1)
        tn = lo_ax if tn is None else torch.maximum(tn, lo_ax)
        tf = hi_ax if tf is None else torch.minimum(tf, hi_ax)
    return tn, tf * 1.00000024 + 1e-7


def cull_phase_a_plain(rays8, bounds, tile_chunk: int = 64,
                       emit_oct: bool = False):
    """Plain version of kernel A (the JAX package's _tile_cluster_mask
    with cull_phase_a's bf16 truncation), chunked over tiles so the
    [tiles, 64, C] temporaries stay small."""
    if rays8.is_cuda and emit_oct:
        OCT_PLAIN_ON_CUDA["cull_phase_a_oct"] += 1
    elif rays8.is_cuda:
        PLAIN_ON_CUDA["cull_phase_a"] += 1
    T = rays8.shape[0]
    C = bounds.shape[1]
    inf = float("inf")
    octw = (1 << torch.arange(8, dtype=torch.int32, device=rays8.device)) \
        .view(1, 8, 1)
    tes, tpms, octs = [], [], []
    for t0 in range(0, T, tile_chunk):
        r = rays8[t0:t0 + tile_chunk]
        inv_d = _inv_dir(r[:, 3:6])                     # [Tc, 3, 64]
        mint = r[:, 6, :, None]
        maxt = r[:, 7, :, None]
        tn, tf = _slab([r[:, ax, :, None] for ax in range(3)],
                       [inv_d[:, ax, :, None] for ax in range(3)],
                       [bounds[ax][None, None, :] for ax in range(3)],
                       [bounds[3 + ax][None, None, :] for ax in range(3)])
        hit = (tn <= tf) & (tf >= mint) & (tn <= maxt) & (maxt > mint)
        tn0 = torch.clamp(tn, min=0.0)
        te_c = torch.where(hit, tn0, inf).amin(dim=1)          # [Tc, C]
        te_c = (te_c.view(torch.int32) & -65536).view(torch.float32)
        tes.append(te_c.to(torch.bfloat16))
        tpms.append(torch.where(hit, tn0, -1.0).amax(dim=2))   # [Tc, 64]
        if emit_oct:
            h8 = hit.view(hit.shape[0], 8, 8, C).any(dim=2)     # [Tc, 8, C]
            octs.append((h8.to(torch.int32) * octw).sum(1, dtype=torch.int32))
    if emit_oct:
        return torch.cat(tes), torch.cat(tpms), torch.cat(octs)
    return torch.cat(tes), torch.cat(tpms)


def group_cull_plain(rays8, bounds, ranged=None):
    """Plain version of kernel A's tile test (csrc/slab.cuh tile_pass):
    [T, C] bool, False only where no ray of the tile can pass its slab
    test against the cluster's box. Over the tile's ranged rays (ranged
    [T, 64] bool; by default its live rays, as kernel A takes them; the
    swept phase A takes every ray but padding) it takes the ranges of the
    origin and of 1/d per axis, the least mint and the largest maxt, and
    applies each rounded operation of the slab test to the range ends (a
    product at the four corners of its range), in the kernel's order, with
    fmin/fmax for the kernel's fminf/fmaxf; rounding to nearest is
    monotone, so the result brackets every ray's value. A tile with no
    ranged ray passes nothing; one with a ranged ray whose o or 1/d has a
    non-finite component passes everything (fminf/fmaxf drop a NaN, so
    that ray may hit through its other axes)."""
    inf = float("inf")
    o, inv = rays8[:, 0:3], _inv_dir(rays8[:, 3:6])     # [T, 3, 64]
    mint, maxt = rays8[:, 6], rays8[:, 7]
    if ranged is None:
        ranged = maxt > mint
    fin = torch.isfinite(o).all(dim=1) & torch.isfinite(inv).all(dim=1)
    use = ranged & fin

    def lo_hi(x):                                       # over the tile
        u = use.view(x.shape[0], *[1] * (x.dim() - 2), -1)
        return (torch.where(u, x, inf).amin(dim=-1)[..., None],
                torch.where(u, x, -inf).amax(dim=-1)[..., None])

    omin, omax = lo_hi(o)                               # [T, 3, 1]
    imin, imax = lo_hi(inv)
    t_mint = lo_hi(mint)[0]                             # [T, 1]
    t_maxt = lo_hi(maxt)[1]

    def face(f, ax):
        xl, xh = f - omax[:, ax], f - omin[:, ax]
        p0, p1 = xl * imin[:, ax], xl * imax[:, ax]
        p2, p3 = xh * imin[:, ax], xh * imax[:, ax]
        return (torch.fmin(torch.fmin(p0, p1), torch.fmin(p2, p3)),
                torch.fmax(torch.fmax(p0, p1), torch.fmax(p2, p3)))

    tn = tf = None
    for ax in range(3):
        l0, h0 = face(bounds[ax][None, :], ax)
        l1, h1 = face(bounds[3 + ax][None, :], ax)
        lo_ax, hi_ax = torch.fmin(l0, l1), torch.fmax(h0, h1)
        tn = lo_ax if tn is None else torch.fmax(tn, lo_ax)
        tf = hi_ax if tf is None else torch.fmin(tf, hi_ax)
    tf = tf * 1.00000024 + 1e-7
    reject = (tn > tf) | (tf < t_mint) | (tn > t_maxt)
    bad = (ranged & ~fin).any(dim=-1, keepdim=True)
    return bad | (ranged.any(dim=-1, keepdim=True) & ~reject)


# ---------------------------------------------------------------------------
# phase B
# ---------------------------------------------------------------------------

def phase_b(slots, cnt, tmin, tscale, rays8, t_pmax, seg_rows, bounds,
            any_hit: bool = False, return_slots_run: bool = False,
            pairs_out=None):
    """(t [T, 64] f32, pid [T, 64] i32): closest (or any) hit of each ray
    over its tile's cnt[t] packed slots. bounds [6, C] are the cluster
    boxes of kernel A, which the kernel uses to skip (ray, slot) pairs
    that cannot hit; the result does not depend on them. return_slots_run
    adds the number of slots each tile tested before its early exit ([T]
    i32). pairs_out ([T] i32, CUDA only) receives each tile's count of
    (ray, slot) pairs that passed the kernel's slot cull."""
    if not rays8.is_cuda:
        if pairs_out is not None:
            raise ValueError("pairs_out counts the kernel's slot cull; the "
                             "plain version tests every pair")
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
    _check(bounds, "bounds", torch.float32, (6, C), dev)
    if pairs_out is not None:
        _check(pairs_out, "pairs_out", torch.int32, (T,), dev)
    t = torch.empty((T, TILE), dtype=torch.float32, device=dev)
    pid = torch.empty((T, TILE), dtype=torch.int32, device=dev)
    run = torch.empty((T,), dtype=torch.int32, device=dev) \
        if return_slots_run else None
    rc = lib().hairpt_phase_b(
        slots.data_ptr(), cnt.data_ptr(), tmin.data_ptr(),
        tscale.data_ptr(), rays8.data_ptr(), t_pmax.data_ptr(),
        seg_rows.data_ptr(), bounds.data_ptr(), T, q, K, C,
        int(bool(any_hit)), t.data_ptr(), pid.data_ptr(),
        None if run is None else run.data_ptr(),
        None if pairs_out is None else pairs_out.data_ptr(), _stream(dev))
    _raise_rc(rc, "phase_b")
    LAUNCHES["phase_b"] += 1
    return (t, pid, run) if return_slots_run else (t, pid)


# the phase-B kernels' box-cull margin (csrc/slab.cuh BOX_PAD): each
# cluster box is widened by BOX_PAD times the larger of the ray origin's
# and the box's largest |coordinate|
BOX_PAD = 2.0 ** -16


def slot_cull_plain(rays8, lo, hi, maxt_eff):
    """Plain version of the box test of kernels B, C and D (csrc/slab.cuh
    box_cull) per (ray, slot): rays8 [n, 8, 64], one cluster box lo, hi
    [n, 3] per row, maxt_eff [n, 64] (the ray's maxt, or min(maxt, best))
    -> [n, 64] bool. Kernel A's slab arithmetic on the box widened by
    BOX_PAD."""
    o = rays8[:, 0:3]                                   # [n, 3, 64]
    inv_d = _inv_dir(rays8[:, 3:6])
    mag = torch.abs(o).amax(dim=1)                      # [n, 64]
    bmag = torch.maximum(torch.abs(lo), torch.abs(hi)).amax(dim=1)
    pad = BOX_PAD * (mag + bmag[:, None])
    tn, tf = _slab([o[:, ax] for ax in range(3)],
                   [inv_d[:, ax] for ax in range(3)],
                   [lo[:, ax, None] - pad for ax in range(3)],
                   [hi[:, ax, None] + pad for ax in range(3)])
    return (tn <= tf) & (tf >= rays8[:, 6]) & (tn <= maxt_eff)


def sqrt_rn(x):
    """float32 square root rounded to nearest, as the kernels' sqrtf,
    on every host. torch's CPU sqrt goes through MKL's vector math,
    which is not correctly rounded and rounds differently under each
    instruction set MKL dispatches to; numpy's float32 sqrt is the IEEE
    instruction. On the card torch's sqrt is IEEE."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.detach().contiguous().numpy()))


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
    dt = sqrt_rn(torch.clamp(disc, min=0.0))
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


# ---------------------------------------------------------------------------
# octet and stream phase B (kernels C and D)
# ---------------------------------------------------------------------------

def _slot_reduce(t_m, pid_row):
    """The octet kernels' per-slot reduction of cyl_test's [n, L, K]
    result: (minimum t [n, L], the largest pid among the lanes at it)."""
    st = t_m.amin(dim=2)
    is_best = (t_m <= st[..., None]) & torch.isfinite(t_m)
    return st, torch.where(is_best, pid_row, -1).amax(dim=2)


def _dequant(bq, tmin, tscale):
    """Entry-t bound of 12-bit codes bq (4095 = +inf) as the kernels
    compute it: tmin + bq * tscale, two roundings."""
    return torch.where(bq == TE_INF, float("inf"),
                       tmin + bq.to(torch.float32) * tscale)


def _done(best, te_next, t_pmax, any_hit):
    if any_hit:
        return torch.isfinite(best) | (te_next > t_pmax)
    return (best <= te_next) | (te_next > t_pmax)


def phase_b_oct(slots, cnt, tmin, tscale, oct_slot, rays8, t_pmax, seg_rows,
                bounds, any_hit: bool = False, pairs_out=None):
    """(t [T, 64] f32, pid [T, 64] i32): phase B over each tile's cnt[t]
    packed slots, a ray testing a slot only where its octet's bit is set
    in oct_slot. pid is the hit's id in both modes. bounds [6, C] are the
    cluster boxes, which the kernel uses to skip (ray, slot) pairs that
    cannot hit; the result does not depend on them. pairs_out ([T] i32,
    CUDA only) receives each tile's count of (ray, slot) pairs that
    passed the kernel's slot cull."""
    if not rays8.is_cuda:
        if pairs_out is not None:
            raise ValueError("pairs_out counts the kernel's slot cull; the "
                             "plain version tests every set octet")
        return phase_b_oct_plain(slots, cnt, tmin, tscale, oct_slot, rays8,
                                 t_pmax, seg_rows, any_hit)
    T, q = slots.shape
    C, _, K = seg_rows.shape
    dev = rays8.device
    if K not in KERNEL_K:
        raise ValueError(f"phase_b_oct kernel takes K in {KERNEL_K}, got {K}")
    _check(slots, "slots", torch.int32, (T, q), dev)
    _check(cnt, "cnt", torch.int32, (T,), dev)
    _check(tmin, "tmin", torch.float32, (T,), dev)
    _check(tscale, "tscale", torch.float32, (T,), dev)
    _check(oct_slot, "oct_slot", torch.int32, (T, q), dev)
    _check(rays8, "rays8", torch.float32, (T, 8, TILE), dev)
    _check(t_pmax, "t_pmax", torch.float32, (T, TILE), dev)
    _check(seg_rows, "seg_rows", torch.float32, (C, 16, K), dev)
    _check(bounds, "bounds", torch.float32, (6, C), dev)
    if pairs_out is not None:
        _check(pairs_out, "pairs_out", torch.int32, (T,), dev)
    t = torch.empty((T, TILE), dtype=torch.float32, device=dev)
    pid = torch.empty((T, TILE), dtype=torch.int32, device=dev)
    rc = oct_lib().hairpt_phase_b_oct(
        slots.data_ptr(), cnt.data_ptr(), tmin.data_ptr(), tscale.data_ptr(),
        oct_slot.data_ptr(), rays8.data_ptr(), t_pmax.data_ptr(),
        seg_rows.data_ptr(), bounds.data_ptr(), T, q, K, C,
        int(bool(any_hit)), t.data_ptr(), pid.data_ptr(),
        None if pairs_out is None else pairs_out.data_ptr(), _stream(dev))
    _raise_rc(rc, "phase_b_oct")
    OCT_LAUNCHES["phase_b_oct"] += 1
    return t, pid


def phase_b_oct_plain(slots, cnt, tmin, tscale, oct_slot, rays8, t_pmax,
                      seg_rows, any_hit: bool = False,
                      return_work: bool = False):
    """Plain version of kernel C with _tiled_kernel_oct's rules: per slot,
    each octet whose bit is set takes the slot's reduced (t, pid) on a
    strictly smaller t; after every slot the tile stops once every ray is
    resolved against that slot's bound. Chunks of PLAIN_B_TILES tiles.
    return_work adds, per tile, the segment blocks the kernel reads and
    the (ray, cluster) tests it runs ([T] int64 each)."""
    if rays8.is_cuda:
        OCT_PLAIN_ON_CUDA["phase_b_oct"] += 1
    outs = [_phase_b_oct_plain_chunk(*(a[c:c + PLAIN_B_TILES] for a in (
        slots, cnt, tmin, tscale, oct_slot, rays8, t_pmax)), seg_rows,
        any_hit) for c in range(0, max(slots.shape[0], 1), PLAIN_B_TILES)]
    out = tuple(torch.cat(x) for x in zip(*outs))
    return out if return_work else out[:2]


def _phase_b_oct_plain_chunk(slots, cnt, tmin, tscale, oct_slot, rays8,
                             t_pmax, seg_rows, any_hit):
    T = slots.shape[0]
    dev = rays8.device
    best = torch.full((T, TILE), float("inf"), device=dev)
    pid = torch.full((T, TILE), -1, dtype=torch.int32, device=dev)
    octet = torch.arange(TILE, device=dev) // 8
    cnt_l = cnt.long()
    active = cnt_l > 0
    blocks = torch.zeros((T,), dtype=torch.int64, device=dev)
    tests = torch.zeros((T,), dtype=torch.int64, device=dev)
    for s in range(int(cnt_l.max()) if T > 0 else 0):
        idx = torch.nonzero(active & (s < cnt_l)).squeeze(1)
        if idx.numel() == 0:
            break
        m8 = oct_slot[idx, s]
        sub = idx[m8 != 0]
        blocks[sub] += 1
        tests[idx] += 8 * _popcount8(m8)
        if sub.numel():
            cid = (slots[sub, s] & CID_MASK).long()
            st, sp = _slot_reduce(*cyl_test(seg_rows[cid], rays8[sub]))
            bit = ((oct_slot[sub, s][:, None] >> octet[None]) & 1).bool()
            st = torch.where(bit, st, float("inf"))
            prev = best[sub]
            better = st < prev
            best[sub] = torch.where(better, st, prev)
            pid[sub] = torch.where(better, sp, pid[sub])
        te_next = _dequant((slots[idx, s] >> 20) & TE_INF, tmin[idx],
                           tscale[idx])
        done = _done(best[idx], te_next[:, None], t_pmax[idx],
                     any_hit).all(dim=1)
        active[idx[done]] = False
    return best, pid, blocks, tests


def _popcount8(m):
    return sum(((m >> b) & 1).long() for b in range(8))


def stream_phase_b(cids, streams, off, cnt, tmin, tscale, rays8, t_pmax,
                   seg_rows, bounds, any_hit: bool = False, pairs_out=None):
    """(t [T, 64] f32, pid [T, 64] i32): each octet walks its own stream
    streams[t, o, 0:off[t, -1, o]] of slot indices into cids and stops on
    its own bound. cnt is taken as the JAX call takes it (the kernel needs
    only the streams' lengths); pid is the hit's id in both modes. bounds
    [6, C] are the cluster boxes, which the kernel uses to skip (ray,
    entry) pairs that cannot hit; the result does not depend on them.
    pairs_out ([T] i32, CUDA only) receives each tile's count of (ray,
    entry) pairs that passed the kernel's entry cull."""
    if not rays8.is_cuda:
        if pairs_out is not None:
            raise ValueError("pairs_out counts the kernel's entry cull; the "
                             "plain version tests every entry")
        return stream_phase_b_plain(cids, streams, off, cnt, tmin, tscale,
                                    rays8, t_pmax, seg_rows, any_hit)
    T, q = cids.shape
    qo = streams.shape[2]
    n_win = off.shape[1] - 1
    C, _, K = seg_rows.shape
    dev = rays8.device
    if K not in KERNEL_K:
        raise ValueError(f"stream kernel takes K in {KERNEL_K}, got {K}")
    _check(cids, "cids", torch.int32, (T, q), dev)
    _check(streams, "streams", torch.int32, (T, 8, qo), dev)
    _check(off, "off", torch.int32, (T, n_win + 1, 8), dev)
    _check(cnt, "cnt", torch.int32, (T,), dev)
    _check(tmin, "tmin", torch.float32, (T,), dev)
    _check(tscale, "tscale", torch.float32, (T,), dev)
    _check(rays8, "rays8", torch.float32, (T, 8, TILE), dev)
    _check(t_pmax, "t_pmax", torch.float32, (T, TILE), dev)
    _check(seg_rows, "seg_rows", torch.float32, (C, 16, K), dev)
    _check(bounds, "bounds", torch.float32, (6, C), dev)
    if pairs_out is not None:
        _check(pairs_out, "pairs_out", torch.int32, (T,), dev)
    t = torch.empty((T, TILE), dtype=torch.float32, device=dev)
    pid = torch.empty((T, TILE), dtype=torch.int32, device=dev)
    rc = oct_lib().hairpt_stream(
        cids.data_ptr(), streams.data_ptr(), off.data_ptr(),
        tmin.data_ptr(), tscale.data_ptr(), rays8.data_ptr(),
        t_pmax.data_ptr(), seg_rows.data_ptr(), bounds.data_ptr(), T, q, qo,
        n_win, K, C, int(bool(any_hit)), t.data_ptr(), pid.data_ptr(),
        None if pairs_out is None else pairs_out.data_ptr(), _stream(dev))
    _raise_rc(rc, "stream_phase_b")
    OCT_LAUNCHES["stream_phase_b"] += 1
    return t, pid


def stream_phase_b_plain(cids, streams, off, cnt, tmin, tscale, rays8,
                         t_pmax, seg_rows, any_hit: bool = False,
                         return_work: bool = False):
    """Plain version of kernel D: per (tile, octet), entries in stream
    order, each replacing the octet's rays' results on a strictly smaller
    t, a stop check after every entry. Chunks of PLAIN_B_TILES tiles.
    return_work adds, per tile, the distinct segment blocks the octets'
    walks touch (a cluster walked by several octets counts once) and the
    (ray, cluster) tests they run ([T] int64 each)."""
    if rays8.is_cuda:
        OCT_PLAIN_ON_CUDA["stream_phase_b"] += 1
    outs = [_stream_plain_chunk(*(a[c:c + PLAIN_B_TILES] for a in (
        cids, streams, off, tmin, tscale, rays8, t_pmax)), seg_rows, any_hit)
        for c in range(0, max(cids.shape[0], 1), PLAIN_B_TILES)]
    out = tuple(torch.cat(x) for x in zip(*outs))
    return out if return_work else out[:2]


def _stream_plain_chunk(cids, streams, off, tmin, tscale, rays8, t_pmax,
                        seg_rows, any_hit):
    T = cids.shape[0]
    dev = rays8.device
    length = off[:, -1, :].long()                      # [T, 8]
    best = torch.full((T, 8, 8), float("inf"), device=dev)
    pid = torch.full((T, 8, 8), -1, dtype=torch.int32, device=dev)
    r8o = rays8.view(T, 8, 8, 8)                       # [T, comp, oct, lane]
    tpm = t_pmax.view(T, 8, 8)
    done = torch.zeros((T, 8), dtype=torch.bool, device=dev)
    entries = torch.zeros((T,), dtype=torch.int64, device=dev)
    touched = torch.zeros(cids.shape, dtype=torch.bool, device=dev)
    for j in range(int(length.max()) if T > 0 else 0):
        it, io = torch.nonzero(~done & (j < length), as_tuple=True)
        if it.numel() == 0:
            break
        entries.index_add_(0, it, torch.ones_like(it))
        e = streams[it, io, j]
        qi = (e & ((1 << QBITS) - 1)).long()
        touched[it, qi] = True
        cid = (cids[it, qi] & CID_MASK).long()
        st, sp = _slot_reduce(*cyl_test(seg_rows[cid], r8o[it, :, io, :]))
        prev = best[it, io]
        better = st < prev
        best[it, io] = torch.where(better, st, prev)
        pid[it, io] = torch.where(better, sp, pid[it, io])
        te_next = _dequant((e >> QBITS) & TE_INF, tmin[it], tscale[it])
        done[it, io] = _done(best[it, io], te_next[:, None], tpm[it, io],
                             any_hit).all(dim=1)
    return (best.view(T, TILE), pid.view(T, TILE), touched.sum(dim=1),
            8 * entries)
