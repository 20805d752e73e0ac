"""Tile-routed cluster intersection (port of hairpt/ops/intersect_tiled.py).

A query groups rays into tiles of 64 consecutive rays and runs
  1. phase A (kernel A, tiled_kernels.cull_phase_a): every tile's entry t
     into every cluster AABB, as bf16 te [T, C], and each ray's t_pmax;
  2. routing (_tile_slots): per tile, the q nearest clusters in exact
     (entry t, cluster id) order, packed with a 12-bit suffix bound;
  3. phase B (kernel B, tiled_kernels.phase_b) over those slots;
  4. the exact-overflow completion loop: tiles with more than q candidate
     clusters route the clusters after the last retained one in further
     passes until every ray is provably resolved (no dropped hits).

Routing order. The JAX package sorts te with a stable sort, so clusters
with equal (bf16-truncated, often tied) entry t stay in ascending id
order, and the completion mask is "(te > te_l) | (te == te_l & cid >
cid_l)". The port packs both into one integer key, key = te_bits << b |
cid (te >= 0, so its bf16 bits order like its values): keys are unique,
their ascending order IS the stable order, the q smallest come from one
torch.topk, and the completion mask is simply key > key_last. This keeps
the routing bit-identical to the JAX package without the [T, C] int64
index tensor a sort would return.

The completion loop is capped at ceil(C/q) + 1 passes (each pass retires
q clusters of every overflowing tile, so ceil(C/q) always suffice); past
the cap it raises with the count of unresolved rays.
"""
from __future__ import annotations

import math

import torch

from ..core.math import Ray
from . import tiled_kernels as tk
from .intersect_swept import SweptHair

TILE = tk.TILE
TE_INF = tk.TE_INF
TE_BF16_INF = 0x7F80

# largest [tiles, C] temporary a chunk may hold (bytes)
CHUNK_BYTES = 2 << 30

# per-process counters read by chip_smoke.py: queries, completion passes
STATS = {"queries": 0, "max_passes": 0, "overflow_tiles": 0}


def _pad_rays(ray: Ray, tile: int):
    N = ray.o.shape[0]
    pad = (-N) % tile
    if pad == 0:
        return ray, N
    dev = ray.o.device
    z3 = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
    dpad = z3.clone()
    dpad[:, 2] = 1.0
    return Ray(o=torch.cat([ray.o, z3]), d=torch.cat([ray.d, dpad]),
               mint=torch.cat([ray.mint, torch.zeros(pad, device=dev)]),
               maxt=torch.cat([ray.maxt, torch.full((pad,), -1.0,
                                                    device=dev)])), N


def rays8_of(ray: Ray, tile: int = TILE):
    """[N, ...] rays (N a multiple of tile) -> [T, 8, tile] rows o.xyz,
    d.xyz, mint, maxt."""
    T = ray.o.shape[0] // tile
    return torch.stack([ray.o[:, 0], ray.o[:, 1], ray.o[:, 2],
                        ray.d[:, 0], ray.d[:, 1], ray.d[:, 2],
                        ray.mint, ray.maxt], dim=0) \
        .reshape(8, T, tile).transpose(0, 1).contiguous()


def _morton_sort_rays(sw: SweptHair, ray: Ray):
    """Sort rays by (direction octant, origin Morton code); dead rays
    (maxt <= mint) last. Returns (sorted ray, order)."""
    lo = sw.cl_lo.amin(dim=0)
    hi = sw.cl_hi.amax(dim=0)
    inv = 1.0 / torch.clamp(hi - lo, min=1e-9)
    qf = torch.clamp(((ray.o - lo) * inv) * 255.0, 0.0, 255.0)
    qf = torch.nan_to_num(qf, nan=0.0)
    qi = qf.to(torch.int64)
    m = torch.zeros(ray.o.shape[:-1], dtype=torch.int64, device=ray.o.device)
    for b in range(8):
        for ax in range(3):
            m = m | (((qi[..., ax] >> b) & 1) << (3 * b + ax))
    octant = ((ray.d[..., 0] > 0).long() | ((ray.d[..., 1] > 0).long() << 1)
              | ((ray.d[..., 2] > 0).long() << 2))
    key = m | (octant << 24)
    key = torch.where(ray.maxt > ray.mint, key, 0xFFFFFFFF)
    order = torch.argsort(key, stable=True)
    return Ray(o=ray.o[order], d=ray.d[order], mint=ray.mint[order],
               maxt=ray.maxt[order]), order


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

class KeySpace:
    """Integer keys te_bits << cbits | cid for C clusters."""

    def __init__(self, C: int):
        self.C = C
        self.cbits = max(1, (C - 1).bit_length())
        self.dtype = torch.int32 if 15 + self.cbits <= 31 else torch.int64
        self.inf_base = TE_BF16_INF << self.cbits     # keys >= it: miss
        self.max_key = self.inf_base | ((1 << self.cbits) - 1)

    def keys(self, te):
        """[T, C] bf16 te -> [T, C] keys. The sign bit is cleared: te is
        >= 0, and a -0.0 sorts as 0.0 exactly as the JAX sort has it."""
        bits = te.view(torch.int16).to(self.dtype) & 0x7FFF
        cid = torch.arange(self.C, dtype=self.dtype, device=te.device)
        return (bits << self.cbits) | cid

    def te_of(self, key):
        """f32 entry t (the bf16 value, exactly) of keys."""
        bits = (key >> self.cbits).to(torch.int32) << 16
        return bits.view(torch.float32)

    def cid_of(self, key):
        return (key & ((1 << self.cbits) - 1)).to(torch.int64)


def _tile_slots(key, ks: KeySpace, q_max: int):
    """Each tile's q_max smallest keys, packed. Returns (packed [T, q_max]
    i32 = cid | bq << 20, cnt [T] i32, tmin [T], tscale [T], overflow
    count, (key_last [T], more [T])): key_last is the last retained key
    where the tile has more candidates (more), else max_key."""
    T, C = key.shape
    dev = key.device
    valid = key < ks.inf_base
    n_hit = valid.sum(dim=1)
    cnt = torch.clamp(n_hit, max=q_max).to(torch.int32)
    more = n_hit > q_max
    k = min(q_max, C)
    srt = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    if k < q_max:
        srt = torch.cat([srt, torch.full((T, q_max - k), ks.max_key,
                                         dtype=key.dtype, device=dev)], 1)
    te_slot = ks.te_of(srt)                                   # [T, q] f32
    tmin = te_slot[:, 0]
    tmin = torch.where(torch.isfinite(tmin), tmin, 0.0)
    kmax = torch.where(valid, key, -1).amax(dim=1)
    tmax = ks.te_of(torch.clamp(kmax, min=0))
    tmax = torch.where(kmax >= 0, tmax, 1.0)
    span = torch.clamp(tmax - tmin, min=1e-6)
    inf = torch.full((T, 1), float("inf"), device=dev)
    te_next = torch.cat([te_slot[:, 1:], inf], dim=1)
    scale = span / (TE_INF - 1)
    bq = torch.floor((te_next - tmin[:, None]) / span[:, None]
                     * (TE_INF - 1))
    bq = torch.clamp(bq, 0, TE_INF - 1).to(torch.int64)
    bq = torch.where(torch.isfinite(te_next), bq, TE_INF)
    cid = torch.where(torch.isfinite(te_slot), ks.cid_of(srt), 0)
    packed = cid | (bq << 20)
    packed = torch.where(packed >= (1 << 31), packed - (1 << 32), packed)
    key_last = torch.where(more, srt[:, q_max - 1],
                           torch.full_like(srt[:, 0], ks.max_key))
    return (packed.to(torch.int32), cnt, tmin.contiguous(),
            scale.contiguous(), int(more.sum()), (key_last, more))


def pass_cap(C: int, q_max: int) -> int:
    """Most completion passes a query may take: ceil(C/q) suffice."""
    return math.ceil(C / q_max) + 1


def _query_chunk(sw: SweptHair, rays8, bounds, ks: KeySpace, q_max: int,
                 any_mode: bool):
    """Phase A, routing, phase B and the completion loop for one chunk of
    tiles. Returns (t [T, 64], pid [T, 64], overflow, passes).

    A completion pass re-routes only the tiles that still have clusters
    left (`more`): every other tile would get an empty slot list, so
    leaving it out changes no result."""
    te, t_pmax = tk.cull_phase_a(rays8, bounds)
    key = ks.keys(te)
    del te
    T = rays8.shape[0]
    dev = rays8.device
    t_k = torch.full((T, TILE), float("inf"), device=dev)
    p_k = torch.full((T, TILE), -1, dtype=torch.int32, device=dev)
    cap = pass_cap(ks.C, q_max)
    overflow = 0
    sel = None          # tiles of this pass (None: all)
    key_last = None
    for k_pass in range(cap):
        if sel is None:
            key_k, rays8_k, tpm_k = key, rays8, t_pmax
            t_s, p_s = t_k, p_k
        else:
            key_s = key[sel]
            key_k = torch.where(key_s > key_last[:, None], key_s, ks.max_key)
            t_s, p_s = t_k[sel], p_k[sel]
            rays8_k = rays8[sel]
            rays8_k[:, 7, :] = torch.minimum(rays8_k[:, 7, :], t_s)
            tpm_k = t_pmax[sel]
        slots, cnt, tmin, tscale, ov, (key_last, more) = _tile_slots(
            key_k, ks, q_max)
        if k_pass == 0:
            overflow = ov
        t2, p2 = tk.phase_b(slots, cnt, tmin, tscale, rays8_k, tpm_k,
                            sw.seg_rows_t, any_hit=any_mode)
        better = t2 < t_s
        t_s = torch.where(better, t2, t_s)
        p_s = torch.where(better, p2, p_s)
        if sel is None:
            t_k, p_k = t_s, p_s
        else:
            t_k[sel] = t_s
            p_k[sel] = p_s
        if ov == 0:
            return t_k, p_k, overflow, k_pass + 1
        te_l = torch.where(more, ks.te_of(key_last), float("inf"))
        u = (p_s < 0) if any_mode else (t_s > te_l[:, None])
        u = u & more[:, None] & (te_l[:, None] <= tpm_k)
        n_u = int(u.sum())
        if n_u == 0:
            return t_k, p_k, overflow, k_pass + 1
        keep = torch.nonzero(more).squeeze(1)
        sel = keep if sel is None else sel[keep]
        key_last = key_last[keep]
    raise RuntimeError(f"tiled intersection: {n_u} rays still unresolved "
                       f"after the cap of {cap} completion passes "
                       f"(C={ks.C}, q={q_max})")


def _run(sw: SweptHair, ray: Ray, q_max: int, any_mode: bool):
    """Pad, lay out as rays8, query chunk by chunk. Returns (t [N], p [N])."""
    ray_p, n_in = _pad_rays(ray, TILE)
    rays8 = rays8_of(ray_p)
    T = rays8.shape[0]
    C = sw.cl_lo.shape[0]
    ks = KeySpace(C)
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()   # [6, C]
    t_chunk = max(1, CHUNK_BYTES // (8 * C))   # 8 bytes: the widest key
    ts, ps = [], []
    for t0 in range(0, T, t_chunk):
        t_c, p_c, ov, passes = _query_chunk(sw, rays8[t0:t0 + t_chunk],
                                            bounds, ks, q_max, any_mode)
        ts.append(t_c)
        ps.append(p_c)
        STATS["overflow_tiles"] += ov
        STATS["max_passes"] = max(STATS["max_passes"], passes)
    STATS["queries"] += 1
    t = torch.cat(ts).reshape(-1)[:n_in]
    p = torch.cat(ps).reshape(-1)[:n_in]
    return t, p


def tiled_closest_hit(sw: SweptHair, ray: Ray, q_max: int = 128,
                      mode: str = "closest", sort_rays: bool = False,
                      compact: bool = True):
    """Closest hit over the cluster layout: (t [N], prim_id [N]),
    inf / -1 = miss. mode='any' lets a tile stop once every ray holds
    some hit. sort_rays Morton-sorts the rays first (bounce waves) and
    unsorts the results. compact runs mostly-dead sorted waves on a
    prefix of N/4 or N/16 rays picked by the live count."""
    any_mode = mode == "any"
    order = None
    if sort_rays:
        ray, order = _morton_sort_rays(sw, ray)
    N = ray.o.shape[0]
    caps = []
    if order is not None and N >= 4 * TILE and compact:
        for f in (4, 16):
            M = max(TILE, (-(-N // f) // TILE) * TILE)
            if M < N and M not in caps:
                caps.append(M)
    M_run = N
    if caps:
        live = int((ray.maxt > ray.mint).sum())
        for M in caps:
            if live <= M:
                M_run = M
    if M_run < N:
        sub = Ray(o=ray.o[:M_run], d=ray.d[:M_run], mint=ray.mint[:M_run],
                  maxt=ray.maxt[:M_run])
        t_m, p_m = _run(sw, sub, q_max, any_mode)
        t = torch.full((N,), float("inf"), device=ray.o.device)
        p = torch.full((N,), -1, dtype=torch.int32, device=ray.o.device)
        t[:M_run] = t_m
        p[:M_run] = p_m
    else:
        t, p = _run(sw, ray, q_max, any_mode)
    if order is not None:
        t_u = torch.empty_like(t)
        p_u = torch.empty_like(p)
        t_u[order] = t
        p_u[order] = p
        t, p = t_u, p_u
    return t, p


def tiled_any_hit(sw: SweptHair, ray: Ray, q_max: int = 128,
                  sort_rays: bool = False, compact: bool = True):
    """Occlusion: True where the ray hits any segment in [mint, maxt]."""
    degenerate = ray.maxt <= ray.mint
    _, p = tiled_closest_hit(sw, ray, q_max, mode="any",
                             sort_rays=sort_rays, compact=compact)
    return (p >= 0) & ~degenerate
