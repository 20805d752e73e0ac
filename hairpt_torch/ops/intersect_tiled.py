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

Two further modes replace steps 2-3 (off by default, as in the JAX
package): octets=True routes each slot with its octet word (kernel A's
octet output) and runs kernel C (tiled_kernels.phase_b_oct), which tests
a slot only for the 8-ray octets that enter it; streams=True compacts the
slots into eight per-octet streams (_octet_streams) and runs kernel D
(tiled_kernels.stream_phase_b), where each octet walks its own stream and
stops on its own bound. Both keep the completion loop; in stream mode its
bound also covers streams truncated at stream_qo entries.

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
q clusters of every overflowing tile, so ceil(C/q) always suffice; in
stream mode q is min(q, stream_qo)); past the cap it raises with the
count of unresolved rays.
"""
from __future__ import annotations

import math
from typing import NamedTuple

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

# largest [tiles, 8, q] temporary of the stream routing (bytes)
STREAM_CHUNK_BYTES = 512 << 20


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


class _Slots(NamedTuple):
    """Each tile's q_max smallest keys and the quantities derived from
    them, shared by the slot and the stream routing."""
    srt: torch.Tensor      # [T, q] sorted keys (max_key past the hits)
    te_slot: torch.Tensor  # [T, q] f32 entry t (inf past the hits)
    cid: torch.Tensor      # [T, q] int64 cluster id (0 past the hits)
    cnt: torch.Tensor      # [T] i32 slots in use
    more: torch.Tensor     # [T] bool: more than q candidates
    tmin: torch.Tensor     # [T] f32
    span: torch.Tensor     # [T] f32
    scale: torch.Tensor    # [T] f32 = span / 4094


def _sorted_slots(key, ks: KeySpace, q_max: int) -> _Slots:
    T, C = key.shape
    dev = key.device
    valid = key < ks.inf_base
    n_hit = valid.sum(dim=1)
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
    cid = torch.where(torch.isfinite(te_slot), ks.cid_of(srt), 0)
    return _Slots(srt=srt, te_slot=te_slot, cid=cid,
                  cnt=torch.clamp(n_hit, max=q_max).to(torch.int32),
                  more=n_hit > q_max, tmin=tmin.contiguous(), span=span,
                  scale=(span / (TE_INF - 1)).contiguous())


def _quantize(te_next, tmin, span):
    """12-bit floor-quantized bounds (int64) of f32 entry times; +inf ->
    TE_INF. tmin and span broadcast against te_next."""
    bq = torch.floor((te_next - tmin) / span * (TE_INF - 1))
    bq = torch.clamp(bq, 0, TE_INF - 1).to(torch.int64)
    return torch.where(torch.isfinite(te_next), bq, TE_INF)


def _tile_slots(key, ks: KeySpace, q_max: int, oct=None):
    """Each tile's q_max smallest keys, packed. Returns (packed [T, q_max]
    i32 = cid | bq << 20, cnt [T] i32, tmin [T], tscale [T], overflow
    count, (key_last [T], more [T])): key_last is the last retained key
    where the tile has more candidates (more), else max_key. With oct
    ([T, C] octet bits) a last element oct_slot [T, q_max] i32 gives each
    slot's octet word (0 for an empty slot)."""
    T = key.shape[0]
    sl = _sorted_slots(key, ks, q_max)
    inf = torch.full((T, 1), float("inf"), device=key.device)
    te_next = torch.cat([sl.te_slot[:, 1:], inf], dim=1)
    bq = _quantize(te_next, sl.tmin[:, None], sl.span[:, None])
    packed = sl.cid | (bq << 20)
    packed = torch.where(packed >= (1 << 31), packed - (1 << 32), packed)
    key_last = torch.where(sl.more, sl.srt[:, q_max - 1],
                           torch.full_like(sl.srt[:, 0], ks.max_key))
    out = (packed.to(torch.int32), sl.cnt, sl.tmin, sl.scale,
           int(sl.more.sum()), (key_last, sl.more))
    if oct is None:
        return out
    oct_slot = torch.where(torch.isfinite(sl.te_slot),
                           oct.gather(1, sl.cid), 0)
    return out + (oct_slot.contiguous(),)


def _octet_streams(key, ks: KeySpace, oct, q_max: int, qo: int,
                   W: int | None = None):
    """Routing of the stream mode (the JAX package's _octet_streams): the
    tile's slots in exact key order, and per octet o the stable
    compaction of the slots whose octet bit o is set into a stream of at
    most qo entries, each packing its slot index with the floor-quantized
    entry bound of the stream's next entry (<< 12; TE_INF on the last).

    Returns (cids [T, q_max] i32, streams [T, 8, qo] i32, off
    [T, n_win+1, 8] i32 = per octet the entries with slot index < w*W,
    cnt [T] i32, tmin [T], tscale [T], overflow, (key_last [T], more
    [T])). W=None, the query's form, gives one window: off [T, 2, 8]
    holds 0 and each stream's length, the only column kernel D reads
    (the JAX windows feed the TPU kernel's DMA ring). The bound covers slot overflow (more than q_max candidates)
    and the truncation of any stream past qo entries: key_last is the
    smallest of the last retained slot's key and each truncated stream's
    last entry's key, so every dropped (slot, octet) incidence has a
    larger key. The slot index has 12 bits: q_max <= 4096. Built in
    chunks of tiles so the [tiles, 8, q] temporaries stay below
    STREAM_CHUNK_BYTES."""
    if q_max > 1 << tk.QBITS:
        raise ValueError(f"stream mode takes q_max <= {1 << tk.QBITS} (a "
                         f"12-bit slot index), got {q_max}")
    if not 0 < qo <= q_max:
        raise ValueError(f"stream_qo must lie in [1, q_max], got {qo}")
    T = key.shape[0]
    dev = key.device
    sl = _sorted_slots(key, ks, q_max)
    oct_slot = torch.where(torch.isfinite(sl.te_slot),
                           oct.gather(1, sl.cid), 0)
    if W is not None:
        n_win = -(-q_max // W)
        thr = torch.arange(n_win + 1, device=dev) * W
    obit = torch.arange(8, device=dev)[None, :, None]
    qidx = torch.arange(q_max, device=dev)
    big = 1 << 13                     # past every slot index and threshold
    streams, offs, key_oct = [], [], []
    tc = max(1, STREAM_CHUNK_BYTES // (8 * q_max * 8))
    for c in range(0, T, tc):
        n = min(tc, T - c)
        bits = ((oct_slot[c:c + n, None, :] >> obit) & 1).bool()  # [n,8,q]
        pos = torch.cumsum(bits, dim=2) - 1
        keep = bits & (pos < qo)
        cnt8 = bits.sum(dim=2)                                    # [n, 8]
        row = torch.arange(n * 8, device=dev).view(n, 8, 1) * qo
        sq = torch.full((n * 8 * qo,), big, dtype=torch.int64, device=dev)
        sq[(row + pos)[keep]] = qidx.expand(n, 8, q_max)[keep]
        sq = sq.view(n, 8, qo)
        valid_s = sq < big
        sq0 = torch.where(valid_s, sq, 0)
        te_ent = sl.te_slot[c:c + n].gather(1, sq0.view(n, 8 * qo)) \
            .view(n, 8, qo)
        te_ent = torch.where(valid_s, te_ent, float("inf"))
        te_next = torch.cat([te_ent[:, :, 1:],
                             torch.full((n, 8, 1), float("inf"),
                                        device=dev)], dim=2)
        bq = _quantize(te_next, sl.tmin[c:c + n, None, None],
                       sl.span[c:c + n, None, None])
        streams.append(torch.where(valid_s, sq0 | (bq << tk.QBITS),
                                   TE_INF << tk.QBITS).to(torch.int32))
        trunc = cnt8 > qo
        if W is None:
            offs.append(torch.stack([torch.zeros_like(cnt8),
                                     torch.clamp(cnt8, max=qo)], 1)
                        .to(torch.int32))
        else:
            offs.append(torch.searchsorted(
                sq.view(n * 8, qo), thr.expand(n * 8, n_win + 1)
                .contiguous()).view(n, 8, n_win + 1).transpose(1, 2)
                .to(torch.int32))
        k_last = sl.srt[c:c + n].gather(1, sq0[:, :, qo - 1])      # [n, 8]
        key_oct.append(torch.where(trunc, k_last, ks.max_key).amin(dim=1))
    key_oct = torch.cat(key_oct)
    key_slot = torch.where(sl.more, sl.srt[:, q_max - 1], ks.max_key)
    key_last = torch.minimum(key_slot, key_oct)
    more = key_last < ks.max_key
    return (sl.cid.to(torch.int32), torch.cat(streams).contiguous(),
            torch.cat(offs).contiguous(), sl.cnt, sl.tmin, sl.scale,
            int(more.sum()), (key_last, more))


def pass_cap(C: int, q_max: int) -> int:
    """Most completion passes a query may take: ceil(C/q) suffice when a
    pass retires at least q clusters of every overflowing tile (q_max
    slots; in stream mode min(q_max, stream_qo), since a truncated stream
    holds qo distinct slots at or before the bound)."""
    return math.ceil(C / q_max) + 1


class PhaseB(NamedTuple):
    """Which phase B a query runs: the dense kernel B (default), kernel C
    (octets) or kernel D (streams, qo entries per octet stream)."""
    octets: bool = False
    streams: bool = False
    qo: int = 0


def _route_and_test(sw, bounds, key_k, oct_k, rays8_k, tpm_k, ks, q_max,
                    any_mode, pb: PhaseB):
    """One pass of routing and phase B over a set of tiles. Returns
    (t, pid, overflow, (key_last, more))."""
    if pb.streams:
        cids, strm, off, cnt, tmin, tscale, ov, bound = _octet_streams(
            key_k, ks, oct_k, q_max, pb.qo)
        t, p = tk.stream_phase_b(cids, strm, off, cnt, tmin, tscale, rays8_k,
                                 tpm_k, sw.seg_rows_t, bounds,
                                 any_hit=any_mode)
    elif pb.octets:
        slots, cnt, tmin, tscale, ov, bound, oct_sl = _tile_slots(
            key_k, ks, q_max, oct=oct_k)
        t, p = tk.phase_b_oct(slots, cnt, tmin, tscale, oct_sl, rays8_k,
                              tpm_k, sw.seg_rows_t, bounds, any_hit=any_mode)
    else:
        slots, cnt, tmin, tscale, ov, bound = _tile_slots(key_k, ks, q_max)
        t, p = tk.phase_b(slots, cnt, tmin, tscale, rays8_k, tpm_k,
                          sw.seg_rows_t, bounds, any_hit=any_mode)
    return t, p, ov, bound


def _query_chunk(sw: SweptHair, rays8, bounds, ks: KeySpace, q_max: int,
                 any_mode: bool, pb: PhaseB = PhaseB()):
    """Phase A, routing, phase B and the completion loop for one chunk of
    tiles. Returns (t [T, 64], pid [T, 64], overflow, passes).

    A completion pass re-routes only the tiles that still have clusters
    left (`more`): every other tile would get an empty slot list, so
    leaving it out changes no result. The octet words of the octet and
    stream modes come from the first cull and are re-used by every pass,
    as in the JAX package."""
    oct = None
    if pb.octets or pb.streams:
        te, t_pmax, oct = tk.cull_phase_a(rays8, bounds, emit_oct=True)
    else:
        te, t_pmax = tk.cull_phase_a(rays8, bounds)
    key = ks.keys(te)
    del te
    T = rays8.shape[0]
    dev = rays8.device
    t_k = torch.full((T, TILE), float("inf"), device=dev)
    p_k = torch.full((T, TILE), -1, dtype=torch.int32, device=dev)
    cap = pass_cap(ks.C, min(q_max, pb.qo) if pb.streams else q_max)
    overflow = 0
    sel = None          # tiles of this pass (None: all)
    key_last = None
    for k_pass in range(cap):
        if sel is None:
            key_k, oct_k, rays8_k, tpm_k = key, oct, rays8, t_pmax
            t_s, p_s = t_k, p_k
        else:
            key_s = key[sel]
            key_k = torch.where(key_s > key_last[:, None], key_s, ks.max_key)
            oct_k = None if oct is None else oct[sel]
            t_s, p_s = t_k[sel], p_k[sel]
            rays8_k = rays8[sel]
            rays8_k[:, 7, :] = torch.minimum(rays8_k[:, 7, :], t_s)
            tpm_k = t_pmax[sel]
        t2, p2, ov, (key_last, more) = _route_and_test(
            sw, bounds, key_k, oct_k, rays8_k, tpm_k, ks, q_max, any_mode,
            pb)
        if k_pass == 0:
            overflow = ov
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


def _run(sw: SweptHair, ray: Ray, q_max: int, any_mode: bool,
         pb: PhaseB = PhaseB()):
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
                                            bounds, ks, q_max, any_mode, pb)
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
                      compact: bool = True, octets: bool = False,
                      streams: bool = False, stream_qo: int | None = None):
    """Closest hit over the cluster layout: (t [N], prim_id [N]),
    inf / -1 = miss. mode='any' lets a tile stop once every ray holds
    some hit. sort_rays Morton-sorts the rays first (bounce waves) and
    unsorts the results. compact runs mostly-dead sorted waves on a
    prefix of N/4 or N/16 rays picked by the live count.

    octets runs phase B as kernel C, streams as kernel D (streams wins
    when both are set, as in the JAX package). stream_qo, the entries per
    octet stream, defaults to max(256, q_max // 4) and is clamped to
    q_max. The JAX package turns streams off for K < 128 because Mosaic
    cannot DMA narrower slices; the CUDA kernel has no such limit and runs
    for every K (the results are the same either way). The JAX options
    stream_w (the windows of the TPU kernel's DMA ring) and stream_unroll
    (its scheduling) change no result and have no counterpart here."""
    any_mode = mode == "any"
    if streams:
        if stream_qo is None:
            stream_qo = max(256, q_max // 4)
        pb = PhaseB(streams=True, qo=min(stream_qo, q_max))
    else:
        pb = PhaseB(octets=octets)
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
        t_m, p_m = _run(sw, sub, q_max, any_mode, pb)
        t = torch.full((N,), float("inf"), device=ray.o.device)
        p = torch.full((N,), -1, dtype=torch.int32, device=ray.o.device)
        t[:M_run] = t_m
        p[:M_run] = p_m
    else:
        t, p = _run(sw, ray, q_max, any_mode, pb)
    if order is not None:
        t_u = torch.empty_like(t)
        p_u = torch.empty_like(p)
        t_u[order] = t
        p_u[order] = p
        t, p = t_u, p_u
    return t, p


def tiled_any_hit(sw: SweptHair, ray: Ray, q_max: int = 128,
                  sort_rays: bool = False, compact: bool = True,
                  octets: bool = False, streams: bool = False,
                  stream_qo: int | None = None):
    """Occlusion: True where the ray hits any segment in [mint, maxt]."""
    degenerate = ray.maxt <= ray.mint
    _, p = tiled_closest_hit(sw, ray, q_max, mode="any",
                             sort_rays=sort_rays, compact=compact,
                             octets=octets, streams=streams,
                             stream_qo=stream_qo)
    return (p >= 0) & ~degenerate
