"""Kernel K, the hash-grid photon query (csrc/photons.cu), its wrappers
and its plain PyTorch versions.

The photon maps (integrators/photonmap.py) keep their photons sorted by
an int32 cell key of a uniform grid (grid_res cells per axis, cell size
1 / inv_cell, origin grid_min; invalid photons carry the key grid_res^3).
A lane's query reads the 27 cells around it in the JAX package's loop
order (dx, then dy, then dz, each -1, 0, 1): per cell the slots
min(start + j, M - 1) for j < max_per_cell, start = lower_bound(cell,
key). The JAX package evaluates its BSDF or phase function on every slot
and masks; here the query returns the (lane, photon) pairs that pass the
mask, lane by lane in the loop order, and the caller evaluates only
those.

  surface_pairs  the surface gather's pairs (hairpt/integrators/
                 photonmap.py:214-233): slot photon valid, in the lane's
                 cell, d2 = |pos - p|^2 < r2 (a clamped slot at M - 1 that
                 matches is a pair again for every such slot, as the dense
                 loop counts it)
  beam_pairs     the beam radiance estimate's pairs (:441-468): per march
                 step j < n_steps (t_mid = (j + 1/2) h, h = 1 / inv_cell in
                 f32) the 27 cells around o + d t_mid; a pair is a valid
                 photon in the cell whose foot = (pos - o) . d lies in
                 [j h, j h + h), with b2 = |pos - o|^2 - foot^2 < radius^2,
                 0 < foot < t_end; with the step and cell number (step * 27
                 + cell) of each pair

A wrapper given CUDA tensors runs kernel K (two launches per chunk of
lanes: count, then write at the exclusive cumsum of the counts) or
raises; given CPU tensors it runs the plain version. The iter_* forms
yield the pairs in chunks of whole lanes, each holding at most
`pair_cap` pairs (a lane with more is a chunk of its own), so a caller
bounds the memory of what it evaluates on them. LAUNCHES counts K's
launches (both passes), PLAIN_ON_CUDA the plain versions' calls on CUDA
tensors (chip_smoke.py makes those only to compare).

Layout: pos [M, 3] f32, cell [M] int32 sorted, valid [M] bool, radius
[M] f32 (beam); surface lanes p [N, 3], r2 [N]; beam lanes o, d [N, 3],
t_end [N]; pairs lane, idx [P] int64 (and sc [P] int64 in beam mode).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

LAUNCHES = {"photon_surface": 0, "photon_beam": 0}
PLAIN_ON_CUDA = {"photon_surface": 0, "photon_beam": 0}
# the pairs one chunk of lanes may hold (the photon maps evaluate a BSDF
# or a phase function on each: about 1 KiB of temporaries per pair)
PAIR_CAP = 1 << 22
# lanes per plain-version chunk ([lanes, max_per_cell] temporaries)
PLAIN_LANES = 1 << 18
CELL_CLAMP = 1e9
OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


class Grid:
    """The photon map's arrays as the query reads them: pos, cell, valid
    (and radius for the beam), on one device, with grid_min and inv_cell
    as host floats (their f32 values), h = f32(1 / inv_cell) and
    grid_res."""

    def __init__(self, pos, cell, valid, grid_min, inv_cell: float,
                 grid_res: int, radius=None):
        self.pos = pos.float().contiguous()
        self.cell = cell.to(torch.int32).contiguous()
        self.valid = valid.bool().contiguous()
        self.radius = None if radius is None else radius.float().contiguous()
        self.gmin_host = [float(x) for x in grid_min.detach().cpu()]
        self.inv = float(np.float32(inv_cell))
        self.h = float(np.float32(1.0) / np.float32(inv_cell))
        self.gr = int(grid_res)
        self.M = int(cell.shape[0])


def _cell_of(x, g, inv: float):
    """((x - g) * inv) truncated toward zero to int64, the float clamped
    to +-CELL_CLAMP first (NaN to -CELL_CLAMP)."""
    f = (x - g) * torch.tensor(inv, dtype=torch.float32, device=x.device)
    f = torch.where(torch.isnan(f), -CELL_CLAMP,
                    torch.clamp(f, -CELL_CLAMP, CELL_CLAMP))
    return f.to(torch.int32).to(torch.int64)


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


# ---------------------------------------------------------------------------
# plain versions: the JAX package's dense loops, returning the pair list
# ---------------------------------------------------------------------------

def _slots(g: Grid, key, okc, mpc: int):
    """(idx [n, mpc], in_cell & okc & valid [n, mpc]) of the dense loop."""
    start = torch.searchsorted(g.cell, key.to(torch.int32).contiguous())
    offs = torch.arange(mpc, device=key.device)
    idx = torch.clamp(start[:, None] + offs[None, :], max=g.M - 1)
    ok = (g.cell[idx] == key.to(torch.int32)[:, None]) & okc[:, None] \
        & g.valid[idx]
    return idx, ok


def surface_pairs_plain(g: Grid, p, r2, max_per_cell: int = 32,
                        counts=None):
    """(lane, idx) of the surface gather's pairs, from the dense loop.
    counts (a dict) gets 'cells' (in-grid cells searched) and 'slots'
    (slots up to the first that leaves the cell) added."""
    n = p.shape[0]
    dev = p.device
    if p.is_cuda:
        PLAIN_ON_CUDA["photon_surface"] += 1
    lanes, idxs = [], []
    for l0 in range(0, n, PLAIN_LANES):
        pc = p[l0:l0 + PLAIN_LANES]
        rc = r2[l0:l0 + PLAIN_LANES]
        m = pc.shape[0]
        finite = torch.isfinite(pc).all(-1)
        q = [_cell_of(pc[:, k], g.gmin_host[k], g.inv) for k in range(3)]
        near_all, idx_all = [], []
        for dx, dy, dz in OFFSETS:
            c = [q[0] + dx, q[1] + dy, q[2] + dz]
            okc = finite
            for ck in c:
                okc = okc & (ck >= 0) & (ck < g.gr)
            key = torch.where(okc, (c[0] * g.gr + c[1]) * g.gr + c[2], 0)
            idx, ok = _slots(g, key, okc, max_per_cell)
            e = g.pos[idx] - pc[:, None]
            d2 = e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] \
                + e[..., 2] * e[..., 2]
            near_all.append(ok & (d2 < rc[:, None]))
            idx_all.append(idx)
            if counts is not None:
                in_c = (g.cell[idx] == key.to(torch.int32)[:, None]) \
                    & okc[:, None]
                counts["cells"] = counts.get("cells", 0) + int(okc.sum())
                # the kernel reads each in-cell slot and the first that
                # is not
                counts["slots"] = counts.get("slots", 0) + int(
                    torch.clamp(in_c.sum(1) + 1, max=max_per_cell)[okc]
                    .sum())
        near = torch.stack(near_all, 1).reshape(m, -1)   # lane, cell, slot
        idx = torch.stack(idx_all, 1).reshape(m, -1)
        li, si = torch.nonzero(near, as_tuple=True)
        lanes.append(li + l0)
        idxs.append(idx[li, si])
    if not lanes:
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        return z, z.clone()
    return torch.cat(lanes), torch.cat(idxs)


def beam_pairs_plain(g: Grid, o, d, t_end, n_steps: int,
                     max_per_cell: int = 16, counts=None):
    """(lane, idx, sc = step * 27 + cell) of the beam estimate's pairs,
    from the dense loop (per step, then sorted by lane, stably). counts
    gets 'cells', 'slots' and 'steps' (steps below t_end) added."""
    n = o.shape[0]
    dev = o.device
    if o.is_cuda:
        PLAIN_ON_CUDA["photon_beam"] += 1
    h = torch.tensor(g.h, dtype=torch.float32, device=dev)
    lanes, idxs, scs = [], [], []
    for j in range(n_steps):
        jf = torch.tensor(float(j), dtype=torch.float32, device=dev)
        lo_t = jf * h
        hi_t = lo_t + h
        t_mid = (jf + 0.5) * h
        live = lo_t < t_end
        if counts is not None:
            counts["steps"] = counts.get("steps", 0) + int(live.sum())
        if not bool(live.any()):
            break
        p = o + d * t_mid
        q = [_cell_of(p[:, k], g.gmin_host[k], g.inv) for k in range(3)]
        for ci, (dx, dy, dz) in enumerate(OFFSETS):
            c = [q[0] + dx, q[1] + dy, q[2] + dz]
            okc = live
            for ck in c:
                okc = okc & (ck >= 0) & (ck < g.gr)
            key = torch.where(okc, (c[0] * g.gr + c[1]) * g.gr + c[2], 0)
            idx, ok = _slots(g, key, okc, max_per_cell)
            rel = g.pos[idx] - o[:, None]
            foot = _dot3(rel, d[:, None])
            b2 = _dot3(rel, rel) - foot * foot
            r = g.radius[idx]
            near = ok & (foot >= lo_t) & (foot < hi_t) & (b2 < r * r) \
                & (foot > 0) & (foot < t_end[:, None])
            if counts is not None:
                in_c = (g.cell[idx] == key.to(torch.int32)[:, None]) \
                    & okc[:, None]
                counts["cells"] = counts.get("cells", 0) + int(okc.sum())
                counts["slots"] = counts.get("slots", 0) + int(
                    torch.clamp(in_c.sum(1) + 1, max=max_per_cell)[okc]
                    .sum())
            li, si = torch.nonzero(near, as_tuple=True)
            lanes.append(li)
            idxs.append(idx[li, si])
            scs.append(torch.full_like(li, j * 27 + ci))
    if not lanes:
        z = torch.zeros((0,), dtype=torch.int64, device=dev)
        return z, z.clone(), z.clone()
    lane = torch.cat(lanes)
    # the per-step lists in (step, cell, slot) order; a stable sort by
    # lane keeps that order within each lane
    order = torch.sort(lane, stable=True).indices
    return lane[order], torch.cat(idxs)[order], torch.cat(scs)[order]


# ---------------------------------------------------------------------------
# kernel K
# ---------------------------------------------------------------------------

_LIB = None


def lib():
    """Build (first use) and load libhairpt_photons.so (kernel K)."""
    global _LIB
    if _LIB is None:
        from ._native import load_library
        from .tiled_kernels import nvcc_cmd
        L = load_library("hairpt_photons", ["photons.cu"], nvcc_cmd())
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.hairpt_photons.argtypes = [ci, ci, vp, vp, vp, vp, ci, ci, cf, cf,
                                     cf, cf, cf, ci, ci, vp, vp, vp, ci, ci,
                                     vp, ctypes.c_longlong, vp, vp, vp, vp,
                                     vp]
        L.hairpt_photons.restype = ci
        _LIB = L
    return _LIB


def _launch(g: Grid, beam: bool, write: bool, mpc: int, n_steps: int, a, d,
            s, lane0: int, offs=None, base: int = 0, count=None, lane=None,
            idx=None, sc=None):
    from .tiled_kernels import _raise_rc, _stream
    name = "photon_beam" if beam else "photon_surface"
    n = a.shape[0]
    if n == 0:
        return
    rc = lib().hairpt_photons(
        int(beam), int(write), g.pos.data_ptr(), g.cell.data_ptr(),
        g.valid.data_ptr(),
        None if g.radius is None else g.radius.data_ptr(), g.M, g.gr,
        g.gmin_host[0], g.gmin_host[1], g.gmin_host[2], g.inv, g.h, mpc,
        n_steps, a.data_ptr(), None if d is None else d.data_ptr(),
        s.data_ptr(), n, lane0, None if offs is None else offs.data_ptr(),
        base, None if count is None else count.data_ptr(),
        None if lane is None else lane.data_ptr(),
        None if idx is None else idx.data_ptr(),
        None if sc is None else sc.data_ptr(), _stream(a.device))
    _raise_rc(rc, name)
    LAUNCHES[name] += 1


def _check_grid(g: Grid, dev, beam: bool):
    from .tiled_kernels import _check
    _check(g.pos, "pos", torch.float32, (g.M, 3), dev)
    _check(g.cell, "cell", torch.int32, (g.M,), dev)
    _check(g.valid, "valid", torch.bool, (g.M,), dev)
    if beam:
        if g.radius is None:
            raise ValueError("the beam query needs the photons' radius")
        _check(g.radius, "radius", torch.float32, (g.M,), dev)


def _chunks(counts, pair_cap: int):
    """(offs [N] int64 exclusive starts, [(l0, l1, p0, p1)]): whole-lane
    chunks of at most pair_cap pairs (a lane with more is a chunk of its
    own). One host read of the cumsum."""
    ends = torch.cumsum(counts.to(torch.int64), 0)
    offs = ends - counts.to(torch.int64)
    ends_h = ends.cpu().numpy()
    n = ends_h.shape[0]
    out = []
    l0, p0 = 0, 0
    while l0 < n:
        l1 = int(np.searchsorted(ends_h, p0 + pair_cap, side="right"))
        l1 = max(l1, l0 + 1)
        p1 = int(ends_h[l1 - 1])
        out.append((l0, l1, p0, p1))
        l0, p0 = l1, p1
    return offs, out


def _iter_kernel(g: Grid, beam: bool, mpc: int, n_steps: int, a, d, s,
                 pair_cap: int):
    dev = a.device
    n = a.shape[0]
    count = torch.empty((n,), dtype=torch.int32, device=dev)
    _launch(g, beam, False, mpc, n_steps, a, d, s, 0, count=count)
    offs, chunks = _chunks(count, pair_cap)
    for l0, l1, p0, p1 in chunks:
        P = p1 - p0
        lane = torch.empty((P,), dtype=torch.int32, device=dev)
        idx = torch.empty((P,), dtype=torch.int32, device=dev)
        sc = torch.empty((P,), dtype=torch.int32, device=dev) \
            if beam else None
        if P > 0:
            _launch(g, beam, True, mpc, n_steps, a[l0:l1],
                    None if d is None else d[l0:l1], s[l0:l1], l0,
                    offs=offs[l0:l1], base=p0, lane=lane, idx=idx, sc=sc)
        out = (lane.long(), idx.long())
        yield out + ((sc.long(),) if beam else ())


def _lanes(x, n, dev, name, width):
    from .tiled_kernels import _check
    x = x.float().contiguous()
    _check(x, name, torch.float32, (n, width) if width else (n,), dev)
    return x


def iter_surface_pairs(g: Grid, p, r2, max_per_cell: int = 32,
                       pair_cap: int = PAIR_CAP):
    """Chunks (lane, idx) of the surface pairs, lane order: kernel K on
    CUDA tensors, surface_pairs_plain (one chunk per PLAIN_LANES lanes)
    on CPU tensors. r2 may be a float."""
    n = p.shape[0]
    dev = p.device
    r2 = torch.broadcast_to(torch.as_tensor(r2, dtype=torch.float32,
                                            device=dev), (n,))
    if not p.is_cuda:
        for l0 in range(0, n, PLAIN_LANES):
            lane, idx = surface_pairs_plain(g, p[l0:l0 + PLAIN_LANES],
                                            r2[l0:l0 + PLAIN_LANES],
                                            max_per_cell)
            yield lane + l0, idx
        return
    _check_grid(g, dev, False)
    p = _lanes(p, n, dev, "p", 3)
    r2 = _lanes(r2, n, dev, "r2", 0)
    yield from _iter_kernel(g, False, max_per_cell, 0, p, None, r2,
                            pair_cap)


def iter_beam_pairs(g: Grid, o, d, t_end, n_steps: int,
                    max_per_cell: int = 16, pair_cap: int = PAIR_CAP):
    """Chunks (lane, idx, sc) of the beam pairs, lane order: kernel K on
    CUDA tensors, beam_pairs_plain on CPU tensors."""
    n = o.shape[0]
    dev = o.device
    if not o.is_cuda:
        for l0 in range(0, n, PLAIN_LANES):
            sl = slice(l0, l0 + PLAIN_LANES)
            lane, idx, sc = beam_pairs_plain(g, o[sl], d[sl], t_end[sl],
                                             n_steps, max_per_cell)
            yield lane + l0, idx, sc
        return
    _check_grid(g, dev, True)
    o = _lanes(o, n, dev, "o", 3)
    d = _lanes(d, n, dev, "d", 3)
    t_end = _lanes(t_end, n, dev, "t_end", 0)
    yield from _iter_kernel(g, True, max_per_cell, n_steps, o, d, t_end,
                            pair_cap)


def _cat(chunks, k):
    return [torch.cat([c[i] for c in chunks]) for i in range(k)]


def surface_pairs(g: Grid, p, r2, max_per_cell: int = 32):
    """All surface pairs (lane, idx) in one list."""
    ch = list(iter_surface_pairs(g, p, r2, max_per_cell, pair_cap=1 << 62))
    return tuple(_cat(ch, 2))


def beam_pairs(g: Grid, o, d, t_end, n_steps: int, max_per_cell: int = 16):
    """All beam pairs (lane, idx, sc) in one list."""
    ch = list(iter_beam_pairs(g, o, d, t_end, n_steps, max_per_cell,
                              pair_cap=1 << 62))
    return tuple(_cat(ch, 3))


# ---------------------------------------------------------------------------
# kernel K's per-thread loop, transcribed (the CPU tests hold it to the
# plain versions; scalar Python over float32 numpy values)
# ---------------------------------------------------------------------------

def _f32(x):
    return np.float32(x)


def _cell_of_scalar(x, g, inv):
    f = _f32(_f32(_f32(x) - _f32(g)) * _f32(inv))
    if np.isnan(f):
        f = _f32(-CELL_CLAMP)
    f = min(max(f, _f32(-CELL_CLAMP)), _f32(CELL_CLAMP))
    return int(np.trunc(f))


def _lower_bound(cell, key):
    lo, hi = 0, cell.shape[0]
    while lo < hi:
        mid = (lo + hi) >> 1
        if cell[mid] < key:
            lo = mid + 1
        else:
            hi = mid
    return lo


def surface_thread(g: Grid, p, r2, mpc: int):
    """One lane of surface_kernel: its [(idx)] in emission order."""
    pos = g.pos.cpu().numpy()
    cell = g.cell.cpu().numpy()
    valid = g.valid.cpu().numpy()
    p = [_f32(x) for x in p]
    r2 = _f32(r2)
    out = []
    if not all(np.isfinite(x) for x in p):
        return out
    q = [_cell_of_scalar(p[k], g.gmin_host[k], g.inv) for k in range(3)]
    for dx, dy, dz in OFFSETS:
        c = (q[0] + dx, q[1] + dy, q[2] + dz)
        if any(ck < 0 or ck >= g.gr for ck in c):
            continue
        key = (c[0] * g.gr + c[1]) * g.gr + c[2]
        start = _lower_bound(cell, key)
        for j in range(mpc):
            idx = min(start + j, g.M - 1)
            if cell[idx] != key:
                break
            if not valid[idx]:
                continue
            e = [_f32(pos[idx, k] - p[k]) for k in range(3)]
            d2 = _f32(_f32(_f32(e[0] * e[0]) + _f32(e[1] * e[1]))
                      + _f32(e[2] * e[2]))
            if d2 < r2:
                out.append(idx)
    return out


def beam_thread(g: Grid, o, d, t_end, n_steps: int, mpc: int):
    """One lane of beam_kernel: its [(idx, sc)] in emission order."""
    pos = g.pos.cpu().numpy()
    cell = g.cell.cpu().numpy()
    valid = g.valid.cpu().numpy()
    rad = g.radius.cpu().numpy()
    o = [_f32(x) for x in o]
    d = [_f32(x) for x in d]
    t_end = _f32(t_end)
    h = _f32(g.h)
    out = []
    for j in range(n_steps):
        jf = _f32(j)
        lo_t = _f32(jf * h)
        if lo_t >= t_end:
            break
        hi_t = _f32(lo_t + h)
        t_mid = _f32(_f32(jf + _f32(0.5)) * h)
        q = [_cell_of_scalar(_f32(o[k] + _f32(d[k] * t_mid)),
                             g.gmin_host[k], g.inv) for k in range(3)]
        for ci, (dx, dy, dz) in enumerate(OFFSETS):
            c = (q[0] + dx, q[1] + dy, q[2] + dz)
            if any(ck < 0 or ck >= g.gr for ck in c):
                continue
            key = (c[0] * g.gr + c[1]) * g.gr + c[2]
            start = _lower_bound(cell, key)
            for s in range(mpc):
                idx = min(start + s, g.M - 1)
                if cell[idx] != key:
                    break
                if not valid[idx]:
                    continue
                r = [_f32(pos[idx, k] - o[k]) for k in range(3)]
                foot = _f32(_f32(_f32(r[0] * d[0]) + _f32(r[1] * d[1]))
                            + _f32(r[2] * d[2]))
                rr = _f32(_f32(_f32(r[0] * r[0]) + _f32(r[1] * r[1]))
                          + _f32(r[2] * r[2]))
                b2 = _f32(rr - _f32(foot * foot))
                r2 = _f32(rad[idx] * rad[idx])
                if lo_t <= foot < hi_t and b2 < r2 and foot > 0 \
                        and foot < t_end:
                    out.append((idx, j * 27 + ci))
    return out
