"""Hair fiber geometry (numpy copy of the parts of hairpt/scene/hairgen.py
the hair scenes need: FiberSet, the .mitshair loader and writer, the
preprocessing, segments and the procedural furball, straight, curly and
hair-curl generators). Host-side, runs once per scene build; the fibers
equal the JAX package's exactly.

File formats follow the reference's src/shapes/hair.cpp:641-716: a binary
file starts with the magic "BINARY_HAIR" and a uint32 vertex count, then
float32 xyz triples where a non-finite x separates fibers; an ASCII file
has one "x y z" per line, and a line with fewer than three fields starts
a new fiber. The JAX package scans the binary separators with a Python
loop over every vertex; the port's scan is vectorised (the reference's
real assets hold millions of vertices) and gives the same flags."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FiberSet(NamedTuple):
    vertices: np.ndarray            # [V, 3] float
    vertex_starts_fiber: np.ndarray  # [V] bool
    radius: float


BINARY_MAGIC = b"BINARY_HAIR"


def _binary_fibers(data: np.ndarray):
    """Vertices and fiber-start flags of a binary file's [N, 3] records.
    A kept vertex starts a fiber when it is the first record or follows
    a separator: a run of separators, or a leading one, starts one fiber
    at the next kept vertex."""
    sep = ~np.isfinite(data[:, 0])
    after = np.ones(len(data), bool)
    after[1:] = sep[:-1]
    return data[~sep], after[~sep]


def load_hair_file(path: str, radius: float,
                   angle_threshold_deg: float = 1.0,
                   reduction: float = 0.0,
                   seed: int = 0) -> FiberSet:
    with open(path, "rb") as f:
        head = f.read(len(BINARY_MAGIC))
        if head == BINARY_MAGIC:
            n = np.frombuffer(f.read(4), "<u4")[0]
            data = np.frombuffer(f.read(12 * int(n)), "<f4").reshape(-1, 3)
            verts, starts = _binary_fibers(data)
        else:
            text = head + f.read()
            verts_l, starts_l = [], []
            new = True
            for line in text.decode("latin1").splitlines():
                t = line.split()
                if len(t) < 3:
                    new = True
                    continue
                verts_l.append([float(t[0]), float(t[1]), float(t[2])])
                starts_l.append(new)
                new = False
            verts = np.asarray(verts_l, np.float64)
            starts = np.asarray(starts_l, bool)
    fs = FiberSet(np.asarray(verts, np.float64), starts, radius)
    return preprocess(fs, angle_threshold_deg, reduction, seed)


def save_hair_binary(path: str, fs: FiberSet):
    """The binary format, a +inf separator before every fiber but the
    first."""
    verts = np.asarray(fs.vertices, np.float32)
    cut = np.nonzero(np.asarray(fs.vertex_starts_fiber, bool))[0]
    allv = np.insert(verts, cut[cut > 0], np.inf, axis=0)
    with open(path, "wb") as f:
        f.write(BINARY_MAGIC)
        f.write(np.uint32(len(allv)).tobytes())
        f.write(allv.astype("<f4").tobytes())


def preprocess(fs: FiberSet, angle_threshold_deg: float = 1.0,
               reduction: float = 0.0, seed: int = 0) -> FiberSet:
    """Optionally cull fibers (with Cook-style radius enlargement) and
    merge near-collinear consecutive segments (reference hair.cpp:598-716;
    the JAX package's single vectorised pass)."""
    verts, starts, radius = fs.vertices, fs.vertex_starts_fiber, fs.radius
    if reduction > 0:
        rng = np.random.default_rng(seed)
        fiber_id = np.cumsum(starts) - 1
        n_fibers = fiber_id[-1] + 1
        keep_fiber = rng.random(n_fibers) >= reduction
        keep = keep_fiber[fiber_id]
        verts = verts[keep]
        starts = starts[keep]
        radius = radius / (1.0 - reduction) ** 0.5  # keep projected coverage

    if angle_threshold_deg > 0 and len(verts) > 2:
        # drop interior vertices whose adjacent segment directions are
        # within the angle threshold, never two adjacent ones in a pass
        cos_thr = np.cos(np.radians(angle_threshold_deg))
        d = verts[1:] - verts[:-1]
        dn = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)
        cosang = np.sum(dn[:-1] * dn[1:], axis=-1)      # at vertex i in 1..n-2
        interior = ~starts[1:-1] & ~starts[2:]
        drop = np.zeros(len(verts), bool)
        drop[1:-1] = interior & (cosang > cos_thr)
        drop[1:] &= ~drop[:-1]
        verts = verts[~drop]
        starts = starts[~drop]
    return FiberSet(verts, starts, radius)


def segments(fs: FiberSet):
    """Flatten fibers into per-segment arrays with miter end planes
    (reference geometry model: hair.cpp:70-74, 570-596).
    Returns dict of float32 arrays p0,p1,n0,n1 and int fiber ids."""
    v = np.asarray(fs.vertices, np.float64)
    s = np.asarray(fs.vertex_starts_fiber, bool)
    n = len(v)
    iv = np.arange(n - 1)
    seg_mask = ~s[1:]                       # segment (i, i+1) exists
    iv = iv[seg_mask]
    d = v[1:] - v[:-1]
    dn = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-20)

    tang = dn[iv]
    has_prev = np.zeros(len(iv), bool)
    has_next = np.zeros(len(iv), bool)
    prev_t = np.zeros_like(tang)
    next_t = np.zeros_like(tang)
    has_prev = (iv - 1 >= 0) & ~s[iv]
    valid_prev = np.clip(iv - 1, 0, n - 2)
    prev_t = dn[valid_prev]
    has_next = (iv + 1 <= n - 2) & ~s[np.clip(iv + 2, 0, n - 1)]
    valid_next = np.clip(iv + 1, 0, n - 2)
    next_t = dn[valid_next]

    def miter(tt, other, has):
        m = tt + other
        ln = np.linalg.norm(m, axis=-1, keepdims=True)
        m = np.where(ln > 1e-12, m / np.maximum(ln, 1e-12), tt)
        return np.where(has[:, None], m, tt)

    n0 = miter(tang, prev_t, has_prev)
    n1 = miter(tang, next_t, has_next)
    return dict(p0=v[iv].astype(np.float32), p1=v[iv + 1].astype(np.float32),
                n0=n0.astype(np.float32), n1=n1.astype(np.float32),
                radius=np.full(len(iv), fs.radius, np.float32))


def _smooth_noise(rng, n, octaves=3, scale=1.0):
    x = np.zeros(n)
    for o in range(octaves):
        k = 2 ** o
        phase = rng.uniform(0, 2 * np.pi)
        freq = rng.uniform(0.5, 1.5) * k
        x += np.sin(np.linspace(0, freq * np.pi, n) + phase) / k
    return x * scale


def gen_straight_hair(n_fibers: int = 800, n_segs: int = 24,
                      radius: float = 0.00566563, seed: int = 0) -> FiberSet:
    """A hanging curtain of gently bending strands, framed for
    models/straight-hair/scene*.xml (camera ~(0,16.5,-25) looking +z/down)."""
    rng = np.random.default_rng(seed)
    verts, starts = [], []
    for _ in range(n_fibers):
        x0 = rng.uniform(-4.0, 4.0)
        z0 = rng.uniform(-1.2, 1.2)
        y_top = rng.uniform(12.5, 13.5)
        length = rng.uniform(8.0, 10.0)
        t = np.linspace(0, 1, n_segs + 1)
        bend_x = _smooth_noise(rng, n_segs + 1, 3, 0.25) * t
        bend_z = _smooth_noise(rng, n_segs + 1, 3, 0.25) * t
        pts = np.stack([x0 + bend_x, y_top - length * t, z0 + bend_z], -1)
        verts.append(pts)
        st = np.zeros(n_segs + 1, bool)
        st[0] = True
        starts.append(st)
    return FiberSet(np.concatenate(verts), np.concatenate(starts), radius)


def gen_curly_hair(n_fibers: int = 500, n_segs: int = 60,
                   radius: float = 0.00559955, seed: int = 1) -> FiberSet:
    """Helical ringlets, framed like models/curly-hair/scene.xml."""
    rng = np.random.default_rng(seed)
    verts, starts = [], []
    for _ in range(n_fibers):
        x0 = rng.uniform(-4.0, 4.0)
        z0 = rng.uniform(-1.5, 1.5)
        y_top = rng.uniform(12.0, 13.5)
        length = rng.uniform(7.0, 10.0)
        curl_r = rng.uniform(0.25, 0.6)
        turns = rng.uniform(4.0, 9.0)
        phase = rng.uniform(0, 2 * np.pi)
        t = np.linspace(0, 1, n_segs + 1)
        ang = phase + turns * 2 * np.pi * t
        pts = np.stack([x0 + curl_r * np.cos(ang) * (0.3 + 0.7 * t),
                        y_top - length * t,
                        z0 + curl_r * np.sin(ang) * (0.3 + 0.7 * t)], -1)
        verts.append(pts)
        st = np.zeros(n_segs + 1, bool)
        st[0] = True
        starts.append(st)
    return FiberSet(np.concatenate(verts), np.concatenate(starts), radius)


def gen_hair_curl(n_fibers_per_clump: int = 220, n_segs: int = 48,
                  radius: float = 0.000444, seed: int = 2):
    """Four separate hanging curl clumps (black/red/brown/blonde),
    framed like models/hair-curl/scene.xml (camera at y~5.9, z~17).
    Returns a list of four FiberSets."""
    rng = np.random.default_rng(seed)
    out = []
    for cx in (-3.0, -1.0, 1.0, 3.0):
        verts, starts = [], []
        for _ in range(n_fibers_per_clump):
            dx, dz = rng.normal(0, 0.22, 2)
            y_top = rng.uniform(8.2, 8.8)
            length = rng.uniform(4.5, 5.8)
            curl_r = rng.uniform(0.15, 0.4)
            turns = rng.uniform(3, 7)
            phase = rng.uniform(0, 2 * np.pi)
            t = np.linspace(0, 1, n_segs + 1)
            ang = phase + turns * 2 * np.pi * t
            pts = np.stack([cx + dx + curl_r * np.cos(ang) * t,
                            y_top - length * t,
                            dz + curl_r * np.sin(ang) * t], -1)
            verts.append(pts)
            st = np.zeros(n_segs + 1, bool)
            st[0] = True
            starts.append(st)
        out.append(FiberSet(np.concatenate(verts), np.concatenate(starts),
                            radius))
    return out


def gen_furball(n_fibers: int = 6000, n_segs: int = 12,
                radius: float = 0.00216667, seed: int = 3,
                center=(0.0, 11.0, 0.0), core_r: float = 1.6,
                fiber_len: float = 1.8) -> FiberSet:
    """Radial fur on a sphere with gravity droop, framed like
    models/furball/scene.xml (camera at (-10.7, 14.3, 10.3) aimed at
    roughly (0, 11, 0))."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center)
    # even-ish directions over the sphere
    u = rng.random((n_fibers, 2))
    z = 1 - 2 * u[:, 0]
    r = np.sqrt(np.maximum(1 - z * z, 0))
    phi = 2 * np.pi * u[:, 1]
    dirs = np.stack([r * np.cos(phi), z, r * np.sin(phi)], -1)
    t = np.linspace(0, 1, n_segs + 1)
    lengths = fiber_len * rng.uniform(0.75, 1.25, n_fibers)
    # droop: blend direction toward -y along the fiber
    droop = 0.55 * t ** 2
    pts = center + dirs[:, None, :] * (core_r + lengths[:, None]
                                       * t[None, :])[:, :, None]
    pts[..., 1] -= droop[None, :] * lengths[:, None]
    # slight per-fiber waviness
    wob = rng.normal(0, 0.03, (n_fibers, 1, 3)) * np.sin(
        np.pi * 3 * t)[None, :, None]
    pts = pts + wob * lengths[:, None, None]
    verts = pts.reshape(-1, 3)
    starts = np.zeros(len(verts), bool)
    starts[::n_segs + 1] = True
    return FiberSet(verts, starts, radius)
