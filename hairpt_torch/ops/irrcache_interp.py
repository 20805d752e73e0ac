"""Kernel L, the Ward-weighted irradiance-cache interpolation
(csrc/irrcache.cu), its wrapper, its plain PyTorch version and a
transcription of its per-thread loop.

The irradiance cache's render pass (integrators/irrcache.py) weights
every cache record for every lane (hairpt/integrators/irrcache.py:
273-308):

    diff = p - cpos, d2 = |diff|^2, ndot = clip(n . cnrm, -1, 1)
    arg = sqrt(d2) / k + sqrt(max(1 - ndot, 0)) + 1e-4
    w = 1 / arg where ndot > 0.2, else 0
    w_cut = w where arg < kappa, else 0
    has_cut = sum(w_cut) > 0; w = w_cut where has_cut
    e_rec = max(e_ind + cross(cnrm, n) . r_grad + diff . t_grad, 0)
            (with the records' gradients, [world axis, colour]), else e_ind
    e = sum(w e_rec) / max(sum(w), 1e-9)

interp returns (e [N, 3], has_cut [N] bool); a lane that is not valid
gets e = 0 and has_cut False. Given CUDA tensors it runs kernel L or
raises; given CPU tensors it runs interp_plain. LAUNCHES counts L's
launches per instance ('irrcache_interp' without gradients,
'irrcache_interp_grad' with them), PLAIN_ON_CUDA the plain version's
calls on CUDA tensors (chip_smoke.py makes those only to compare).

The plain version is the dense formula over lane chunks whose
[chunk, M] temporaries stay under PLAIN_BYTES, with L's order of
additions: each sum first over a tile of TILE records in record order,
then over the tiles in order. Each pair's terms are the same float
operations in the same order as L's, so the two agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

LAUNCHES = {"irrcache_interp": 0, "irrcache_interp_grad": 0}
PLAIN_ON_CUDA = {"irrcache_interp": 0, "irrcache_interp_grad": 0}
# the plain version's temporaries per lane chunk (about 32 [chunk, M]
# float tensors live at once with the gradients)
PLAIN_BYTES = 2 << 30
PLAIN_TEMPS = 32
# records per shared-memory tile of kernel L (THREADS in irrcache.cu)
TILE = 128


def reset_counts():
    for d in (LAUNCHES, PLAIN_ON_CUDA):
        for k in d:
            d[k] = 0


class Records(NamedTuple):
    """The cache: cpos, cnrm, e_ind [M, 3] and, with gradients, r_grad
    and t_grad [M, 3 (world axis), 3 (colour)]."""
    cpos: torch.Tensor
    cnrm: torch.Tensor
    e_ind: torch.Tensor
    r_grad: Optional[torch.Tensor] = None
    t_grad: Optional[torch.Tensor] = None

    @property
    def grad(self) -> bool:
        return self.r_grad is not None

    def packed(self):
        """[M, 27] (or [M, 9] without gradients) f32 rows: cpos, cnrm,
        e_ind, r_grad row-major, t_grad row-major."""
        m = self.cpos.shape[0]
        parts = [self.cpos, self.cnrm, self.e_ind]
        if self.grad:
            parts += [self.r_grad.reshape(m, 9), self.t_grad.reshape(m, 9)]
        return torch.cat([x.float() for x in parts], 1).contiguous()


def _name(grad: bool) -> str:
    return "irrcache_interp_grad" if grad else "irrcache_interp"


def pair_terms(p, n, rec: Records, k: float, kappa: float):
    """(w, w_cut, e_rec) of lanes p, n [L, 3] against every record:
    [L, M], [L, M], [L, M, 3], each float operation in kernel L's
    order."""
    c = rec.cpos[None]
    q = rec.cnrm[None]
    dx = p[:, None, 0] - c[..., 0]
    dy = p[:, None, 1] - c[..., 1]
    dz = p[:, None, 2] - c[..., 2]
    d2 = (dx * dx + dy * dy) + dz * dz
    nx, ny, nz = n[:, None, 0], n[:, None, 1], n[:, None, 2]
    ndot = torch.clamp((nx * q[..., 0] + ny * q[..., 1]) + nz * q[..., 2],
                       -1.0, 1.0)
    # a tensor divisor: torch divides by a host scalar as a product with
    # its reciprocal, L divides
    kt = torch.full((), k, dtype=torch.float32, device=p.device)
    arg = (torch.sqrt(d2) / kt
           + torch.sqrt(torch.clamp(1.0 - ndot, min=0.0))) + 1e-4
    w = torch.where(ndot > 0.2, 1.0 / arg, 0.0)
    wc = torch.where(arg < kappa, w, 0.0)
    if not rec.grad:
        return w, wc, rec.e_ind[None].expand(p.shape[0], -1, -1)
    c0 = q[..., 1] * nz - q[..., 2] * ny
    c1 = q[..., 2] * nx - q[..., 0] * nz
    c2 = q[..., 0] * ny - q[..., 1] * nx
    R = rec.r_grad[None]
    T = rec.t_grad[None]
    e = []
    for ci in range(3):
        rg = (c0 * R[..., 0, ci] + c1 * R[..., 1, ci]) + c2 * R[..., 2, ci]
        tg = (dx * T[..., 0, ci] + dy * T[..., 1, ci]) + dz * T[..., 2, ci]
        e.append(torch.clamp((rec.e_ind[None, :, ci] + rg) + tg, min=0.0))
    return w, wc, torch.stack(e, -1)


def interp_plain(p, n, valid, rec: Records, k_norm_radius: float = 0.25,
                 kappa: float = 2.0, chunk: Optional[int] = None):
    """(e [N, 3], has_cut [N]) by the dense formula, in chunks of `chunk`
    lanes (by default as many as PLAIN_BYTES of temporaries hold)."""
    N = p.shape[0]
    M = rec.cpos.shape[0]
    dev = p.device
    if p.is_cuda:
        PLAIN_ON_CUDA[_name(rec.grad)] += 1
    if chunk is None:
        chunk = max(1, PLAIN_BYTES // (4 * PLAIN_TEMPS * max(M, 1)))
    e_out = torch.zeros((N, 3), device=dev)
    cut_out = torch.zeros((N,), dtype=torch.bool, device=dev)
    live = torch.nonzero(valid).flatten()
    for l0 in range(0, live.shape[0], chunk):
        sel = live[l0:l0 + chunk]
        w, wc, e_rec = pair_terms(p[sel], n[sel], rec, k_norm_radius, kappa)
        # sw, swc, sum w e, sum w_cut e
        sums = tiled_sums(torch.stack(
            [w, wc] + [w * e_rec[..., c] for c in range(3)]
            + [wc * e_rec[..., c] for c in range(3)]))
        cut = sums[1] > 0
        den = torch.clamp(torch.where(cut, sums[1], sums[0]), min=1e-9)
        num = torch.where(cut[:, None], sums[5:8].T, sums[2:5].T)
        e_out[sel] = num / den[:, None]
        cut_out[sel] = cut
    return e_out, cut_out


def tiled_sums(x):
    """x [..., M] summed over its last axis in kernel L's order: within
    each tile of TILE in order, then the tile sums in order."""
    M = x.shape[-1]
    T = -(-M // TILE)
    if M == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    x = torch.nn.functional.pad(x, (0, T * TILE - M))
    x = x.reshape(x.shape[:-1] + (T, TILE))
    acc = x[..., 0]
    for j in range(1, TILE):
        acc = acc + x[..., j]
    tot = acc[..., 0]
    for t in range(1, T):
        tot = tot + acc[..., t]
    return tot


# ---------------------------------------------------------------------------
# kernel L
# ---------------------------------------------------------------------------

_LIB = None


def lib():
    """Build (first use) and load libhairpt_irrcache.so (kernel L)."""
    global _LIB
    if _LIB is None:
        from ._native import load_library
        from .tiled_kernels import nvcc_cmd
        L = load_library("hairpt_irrcache", ["irrcache.cu"], nvcc_cmd())
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L.hairpt_irrcache.argtypes = [ci, vp, vp, vp, ci, vp, ci, cf, cf,
                                      vp, vp, vp]
        L.hairpt_irrcache.restype = ci
        _LIB = L
    return _LIB


def interp(p, n, valid, rec: Records, k_norm_radius: float = 0.25,
           kappa: float = 2.0):
    """(e [N, 3], has_cut [N] bool): kernel L on CUDA tensors,
    interp_plain on CPU tensors."""
    if not p.is_cuda:
        return interp_plain(p, n, valid, rec, k_norm_radius, kappa)
    from .tiled_kernels import _check, _raise_rc, _stream
    N = p.shape[0]
    dev = p.device
    p = p.float().contiguous()
    n = n.float().contiguous()
    v = valid.to(torch.uint8).contiguous()
    _check(p, "p", torch.float32, (N, 3), dev)
    _check(n, "n", torch.float32, (N, 3), dev)
    _check(v, "valid", torch.uint8, (N,), dev)
    packed = rec.packed()
    M = packed.shape[0]
    _check(packed, "records", torch.float32, (M, 27 if rec.grad else 9),
           dev)
    e = torch.empty((N, 3), device=dev)
    cut = torch.empty((N,), dtype=torch.uint8, device=dev)
    if N == 0:
        return e, cut.bool()
    rc = lib().hairpt_irrcache(
        int(rec.grad), p.data_ptr(), n.data_ptr(), v.data_ptr(), N,
        packed.data_ptr() if M else None, M,
        float(np.float32(k_norm_radius)), float(np.float32(kappa)),
        e.data_ptr(), cut.data_ptr(), _stream(dev))
    name = _name(rec.grad)
    _raise_rc(rc, name)
    LAUNCHES[name] += 1
    return e, cut.bool()


# ---------------------------------------------------------------------------
# kernel L's per-thread loop, transcribed (the CPU tests hold it to the
# plain version; scalar Python over float32 numpy values)
# ---------------------------------------------------------------------------

def interp_thread(p, n, valid: bool, rec: Records, k: float, kappa: float):
    """One lane of interp_kernel: (e [3] float32, has_cut)."""
    f = np.float32
    if not valid:
        return np.zeros(3, np.float32), False
    rows = rec.packed().cpu().numpy()
    px, py, pz = (f(x) for x in p)
    nx, ny, nz = (f(x) for x in n)
    k, kappa = f(k), f(kappa)
    sw = swc = f(0)
    se = [f(0)] * 3
    sec = [f(0)] * 3
    for t0 in range(0, rows.shape[0], TILE):
        tw = twc = f(0)
        te = [f(0)] * 3
        tec = [f(0)] * 3
        for R in rows[t0:t0 + TILE]:
            dx, dy, dz = f(px - R[0]), f(py - R[1]), f(pz - R[2])
            d2 = f(f(f(dx * dx) + f(dy * dy)) + f(dz * dz))
            ndot = f(f(f(nx * R[3]) + f(ny * R[4])) + f(nz * R[5]))
            ndot = min(max(ndot, f(-1)), f(1))
            arg = f(f(f(np.sqrt(d2) / k)
                      + np.sqrt(max(f(f(1) - ndot), f(0)))) + f(1e-4))
            w = f(f(1) / arg) if ndot > f(0.2) else f(0)
            wc = w if arg < kappa else f(0)
            if rec.grad:
                c0 = f(f(R[4] * nz) - f(R[5] * ny))
                c1 = f(f(R[5] * nx) - f(R[3] * nz))
                c2 = f(f(R[3] * ny) - f(R[4] * nx))
                e = []
                for c in range(3):
                    rg = f(f(f(c0 * R[9 + c]) + f(c1 * R[12 + c]))
                           + f(c2 * R[15 + c]))
                    tg = f(f(f(dx * R[18 + c]) + f(dy * R[21 + c]))
                           + f(dz * R[24 + c]))
                    e.append(max(f(f(R[6 + c] + rg) + tg), f(0)))
            else:
                e = [R[6], R[7], R[8]]
            tw, twc = f(tw + w), f(twc + wc)
            te = [f(te[c] + f(w * e[c])) for c in range(3)]
            tec = [f(tec[c] + f(wc * e[c])) for c in range(3)]
        sw, swc = f(sw + tw), f(swc + twc)
        se = [f(se[c] + te[c]) for c in range(3)]
        sec = [f(sec[c] + tec[c]) for c in range(3)]
    cut = bool(swc > 0)
    den = max(swc if cut else sw, f(1e-9))
    return np.array([f((sec[c] if cut else se[c]) / den)
                     for c in range(3)], np.float32), cut
