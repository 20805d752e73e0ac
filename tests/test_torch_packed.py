"""The packed BVH walk (hairpt_torch/ops/intersect_packed.py) on the CPU:
its plain walk against hairpt's closest_hit_packed / any_hit_packed on
triangles and on hair, and a torch transcription of kernel F's per-ray
loop (csrc/packed_walk.cuh, one ray at a time, in Python) against the
vectorised plain walk, bit for bit, on grazing and edge rays.

Both packages pack the same FlatBVH (the port's SAH build) with the same
rows. The JAX walk runs under XLA:CPU, which contracts a * b + c into
fused multiply-adds, so its t and the port's may differ in the last
bits: pid and the hit flags are held exactly, each side's t within
T_ULP ulp of a float64 evaluation of the same test on the same
primitive."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core.math import Ray as JRay
from hairpt.ops import intersect_packed as jpk
from hairpt_torch.core.math import Ray
from hairpt_torch.models import shapes as shp
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.ops import intersect_packed as tpk
from hairpt_torch.ops.tiled_kernels import sqrt_rn
from hairpt_torch.scene import hairgen as th
from torch_threads import one_thread  # noqa: F401

# t against the float64 evaluation, in ulp of t: 4 for the triangles (as
# tests/test_torch_tiled.py holds the tiled cylinder test); 8 for the
# hair leaf, whose projections lose more to rounding without fused
# multiply-adds and with the axis taken as s * (1 / sqrt(s.s)): measured
# on this module's furball rays, the port 6.25 ulp at most, the JAX walk
# (XLA:CPU contracts, rsqrt) 2.40
T_ULP = {"tri": 4, "hair": 8}
F32 = torch.float32


def _tri_bvh(mesh):
    p, f = mesh.positions, mesh.faces
    v0, v1, v2 = p[f[:, 0]], p[f[:, 1]], p[f[:, 2]]
    fb = tbvh.build(np.minimum(np.minimum(v0, v1), v2),
                    np.maximum(np.maximum(v0, v1), v2))
    o = fb.prim_order
    rows = tpk.tri_pack_rows(v0[o].astype(np.float32),
                             v1[o].astype(np.float32),
                             v2[o].astype(np.float32),
                             np.arange(len(o), dtype=np.int32))
    b = tpk.pack_bvh(fb, rows)
    return b.nodes.numpy(), b.leaf_rows.numpy()


def _hair_bvh(fs):
    s = th.segments(fs)
    p0, p1, n0, n1, rad = (s[k] for k in ("p0", "p1", "n0", "n1", "radius"))
    tang = p1 - p0
    tang = tang / np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True),
                             1e-20)
    expand = rad / np.maximum(np.minimum(np.abs(np.sum(n0 * tang, -1)),
                                         np.abs(np.sum(n1 * tang, -1))), 0.3)
    fb = tbvh.build(np.minimum(p0, p1) - expand[:, None],
                    np.maximum(p0, p1) + expand[:, None])
    o = fb.prim_order
    rows = tpk.hair_pack_rows(p0[o], p1[o], n0[o], n1[o], rad[o],
                              np.arange(len(o), dtype=np.int32))
    b = tpk.pack_bvh(fb, rows)
    return b.nodes.numpy(), b.leaf_rows.numpy()


def _ripples(g=33):
    """The JAX loader's procedural heightfield, at g x g."""
    yy, xx = np.meshgrid(np.linspace(0, 4 * np.pi, g),
                         np.linspace(0, 4 * np.pi, g))
    return shp.heightfield(0.1 * np.sin(xx) * np.cos(yy))


def _spread(rows, k):
    """The first primitive of k leaves spread over the leaf rows."""
    first = rows.reshape(-1, 4, 16)[:, 0]
    return first[::max(1, len(first) // k)][:k]


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _tri_rays(rows, n, seed):
    """(rays, n_exact, n_cond): n camera-like rays from above onto the
    ripples and the teapot stand-in beside them, half with a finite maxt
    (n_cond: the well-conditioned ones); rays grazing the surface (an
    ill-conditioned t) and dead lanes parked at o + d * inf; then, from
    n_exact, the edge rays, whose hit (which of two triangles, or none)
    turns on the last bits: aimed at triangle vertices and edge midpoints
    (shared by neighbours), also straight down (two direction components
    exactly 0), and rays that start on the surface."""
    rs = np.random.default_rng(seed)
    org = np.stack([rs.uniform(-1.5, 6.0, n), rs.uniform(-1.5, 1.5, n),
                    rs.uniform(0.3, 3.0, n)], -1)
    tgt = np.stack([rs.uniform(-1, 5.5, n), rs.uniform(-1, 1, n),
                    rs.uniform(-0.2, 0.5, n)], -1)
    d = _unit(tgt - org)
    maxt = np.where(rs.random(n) < 0.5, np.inf, rs.uniform(0.5, 3.0, n))
    first = _spread(rows, n // 8)          # a leaf's first triangle
    p0, e1 = first[:, 0:3], first[:, 3:6]
    k = len(p0)
    gz = np.stack([rs.uniform(-1, 1, k), rs.uniform(-1, 1, k),
                   np.full(k, 0.05)], -1)
    gd = _unit(np.stack([rs.normal(size=k), rs.normal(size=k),
                         rs.uniform(-1e-3, 1e-3, k)], -1))
    dead_d = _unit(rs.normal(size=(8, 3)))
    with np.errstate(invalid="ignore"):
        dead_o = np.zeros((8, 3)) + dead_d * np.inf
    dead_o[0, 0] = np.nan
    org = np.concatenate([org, gz, dead_o])
    d = np.concatenate([d, gd, dead_d])
    maxt = np.concatenate([maxt, np.full(k, np.inf), np.zeros(8)])
    n_exact = len(org)
    for h in (p0, p0 + 0.5 * e1):                 # a vertex, an edge
        away = h + rs.normal(0, 0.8, (k, 3))
        org = np.concatenate([org, h + np.array([0.0, 0.0, 1.5]), away])
        d = np.concatenate([d, np.tile([[0.0, 0.0, -1.0]], (k, 1)),
                            _unit(h - away)])
    org = np.concatenate([org, p0 + 0.25 * e1])
    d = np.concatenate([d, _unit(rs.normal(size=(k, 3)))])
    maxt = np.concatenate([maxt, np.full(len(org) - len(maxt), np.inf)])
    return (org.astype(np.float32), d.astype(np.float32),
            np.zeros(len(org), np.float32), maxt.astype(np.float32)), \
        n_exact, n


def _hair_rays(rows, n, seed):
    """(rays, n_exact, n_cond): rays into the furball, and, past
    n_exact = n_cond, edge
    rays, whose hit turns on the last bits: tangent to a segment's
    cylinder (aimed at its axis point offset by exactly the radius),
    along a segment's axis, and through a miter plane's centre."""
    rs = np.random.default_rng(seed)
    org = _unit(rs.normal(size=(n, 3))) * 3.0
    d = _unit(rs.uniform(-0.7, 0.7, (n, 3)) - org)
    seg = _spread(rows, n // 8)
    p0, p1, r = seg[:, 0:3], seg[:, 3:6], seg[:, 12:13]
    k = len(seg)
    axis = _unit(p1 - p0)
    side = _unit(np.cross(axis, rs.normal(size=(k, 3))))
    perp = _unit(np.cross(axis, side))
    mid = 0.5 * (p0 + p1)
    o_t = mid + side * r - perp * 2.0
    org = np.concatenate([org, o_t, p0 - axis * 0.5, p0 - perp * 1.0])
    d = np.concatenate([d, perp, axis, perp])
    m = len(org)
    return (org.astype(np.float32), d.astype(np.float32),
            np.zeros(m, np.float32), np.full(m, np.inf, np.float32)), n, n


@pytest.fixture(scope="module")
def geoms():
    """(nodes, rows, rays) for triangles (the ripples beside the teapot
    stand-in, shifted to x = 4) and for the hair of a small furball."""
    tea = shp.transform_mesh(shp.compute_smooth_normals(
        shp.teapot_standin(0.3)), np.array([[1, 0, 0, 4.0], [0, 1, 0, 0],
                                            [0, 0, 1, 0.0], [0, 0, 0, 1]]))
    tris = shp.merge([_ripples(), tea])
    tn, tr = _tri_bvh(tris)
    fs = th.gen_furball(n_fibers=60, n_segs=8, radius=0.02, seed=3,
                        center=(0, 0, 0), core_r=0.6, fiber_len=0.8)
    hn, hr = _hair_bvh(fs)
    return {"tri": (tn, tr, _tri_rays(tr, 600, 0)),
            "hair": (hn, hr, _hair_rays(hr, 600, 1))}


def _torch_ray(r):
    return Ray(*[torch.as_tensor(x) for x in r])


def _t64(leaf, row, o, d):
    """float64 evaluation of the leaf test of one ray against the packed
    row [16] (on the root the float32 test reports): t."""
    g = row.astype(np.float64)
    o, d = o.astype(np.float64), d.astype(np.float64)
    if leaf == "tri":
        e1, e2 = g[3:6], g[6:9]
        pv = np.cross(d, e2)
        det = e1 @ pv
        return (e2 @ np.cross(o - g[0:3], e1)) / det
    p0, p1 = g[0:3], g[3:6]
    ax = (p1 - p0) / np.sqrt((p1 - p0) @ (p1 - p0))
    rel = o - p0
    po = rel - (ax @ rel) * ax
    pd = d - (ax @ d) * ax
    a, b = pd @ pd, po @ pd
    t_mid = -b / a
    q = po + pd * t_mid
    dt = np.sqrt(max(-(q @ q - g[12] * g[12]) / a, 0.0))
    return t_mid - dt, t_mid + dt


@pytest.mark.parametrize("leaf", ["tri", "hair"])
@pytest.mark.parametrize("mode", ["closest", "any"])
def test_plain_walk_matches_jax(geoms, leaf, mode):
    """The plain walk against hairpt's vmapped while_loop on the rays
    whose hit does not turn on the last bits (n_exact): hit flags and pid
    exactly; each side's t within T_ULP[leaf] ulp of the float64 t where the
    test is well conditioned (n_cond: not the grazing rays, whose
    Moller-Trumbore determinant nearly vanishes)."""
    nodes, rows, (ray, n_exact, n_cond) = geoms[leaf]
    ray = tuple(x[:n_exact] for x in ray)
    jb = jpk.PackedBVH(jnp.asarray(nodes), jnp.asarray(rows))
    jl = {"tri": jpk.tri_leaf_eval, "hair": jpk.hair_leaf_eval}[leaf]
    tb = tpk.PackedBVH(torch.as_tensor(nodes), torch.as_tensor(rows))
    jr = JRay(*[jnp.asarray(x) for x in ray])
    if mode == "any":
        # shadow rays: a finite maxt, some of them degenerate
        maxt = np.where(np.arange(len(ray[3])) % 7 == 0, 0.0,
                        np.minimum(ray[3], 2.0)).astype(np.float32)
        ray = ray[:3] + (maxt,)
        jr = jr._replace(maxt=jnp.asarray(maxt))
        occ_j = np.asarray(jax.jit(
            lambda r: jpk.any_hit_packed(jb, jl, r))(jr))
        occ_t = tpk.any_hit_packed(tb, leaf, _torch_ray(ray)).numpy()
        np.testing.assert_array_equal(occ_t, occ_j)
        assert 10 < occ_j.sum() < len(occ_j) - 10
        return
    t_j, p_j = jax.jit(lambda r: jpk.closest_hit_packed(jb, jl, r))(jr)
    t_j, p_j = np.asarray(t_j), np.asarray(p_j)
    t_t, p_t = tpk.closest_hit_packed(tb, leaf, _torch_ray(ray))
    t_t, p_t = t_t.numpy(), p_t.numpy()
    np.testing.assert_array_equal(p_t, p_j)
    hit = np.nonzero(p_j >= 0)[0]
    assert 50 < len(hit) < len(p_j) - 10
    assert np.isinf(t_t[p_t < 0]).all() and np.isinf(t_j[p_j < 0]).all()
    by_id = {}
    prim = rows.reshape(-1, 16)
    ids = prim[:, 15].view(np.int32)
    for r, i in zip(prim, ids):
        by_id[int(i)] = r
    for i in hit[hit < n_cond]:
        t64 = _t64(leaf, by_id[int(p_j[i])], ray[0][i], ray[1][i])
        if leaf == "hair":                  # the root the port reports
            t64 = min(t64, key=lambda x: abs(x - float(t_t[i])))
        ulp = float(np.spacing(np.float32(t64)))
        for name, t in (("port", t_t[i]), ("jax", t_j[i])):
            assert abs(float(t) - t64) <= T_ULP[leaf] * ulp, (
                name, i, float(t), t64, abs(float(t) - t64) / ulp)


# ---------------------------------------------------------------------------
# kernel F, transcribed
# ---------------------------------------------------------------------------

def _f(x):
    return torch.tensor(x, dtype=F32)


NAN = _f(float("nan"))
INF = _f(float("inf"))


def _nmin(a, b):
    return NAN if (torch.isnan(a) or torch.isnan(b)) else torch.fmin(a, b)


def _nmax(a, b):
    return NAN if (torch.isnan(a) or torch.isnan(b)) else torch.fmax(a, b)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _tri_test(p, o, d, mint, maxt):
    """TriLeaf::test, csrc/packed_walk.cuh."""
    pid = int(p[15:16].view(torch.int32))
    p0, e1, e2 = p[0:3], p[3:6], p[6:9]
    pv = (d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
          d[0] * e2[1] - d[1] * e2[0])
    det = _dot3(e1, pv)
    inv_det = _f(1.0) / (_f(1.0) if abs(det) < 1e-12 else det)
    tv = (o[0] - p0[0], o[1] - p0[1], o[2] - p0[2])
    u = _dot3(tv, pv) * inv_det
    q = (tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
         tv[0] * e1[1] - tv[1] * e1[0])
    v = _dot3(d, q) * inv_det
    t = _dot3(e2, q) * inv_det
    ok = (pid >= 0 and bool(abs(det) >= 1e-12) and bool(u >= 0)
          and bool(v >= 0) and bool(u + v <= 1) and bool(t >= mint)
          and bool(t <= maxt))
    return ok, t, pid


def _hair_test(p, o, d, mint, maxt):
    """HairLeaf::test, csrc/packed_walk.cuh."""
    pid = int(p[15:16].view(torch.int32))
    p0, p1, n0, n1, rad = p[0:3], p[3:6], p[6:9], p[9:12], p[12]
    s = (p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2])
    l2 = _nmax(_dot3(s, s), _f(1e-30))
    inv_len = _f(1.0) / sqrt_rn(l2.reshape(1))[0]
    ax = (s[0] * inv_len, s[1] * inv_len, s[2] * inv_len)
    r = (o[0] - p0[0], o[1] - p0[1], o[2] - p0[2])
    ar = _dot3(ax, r)
    po = (r[0] - ar * ax[0], r[1] - ar * ax[1], r[2] - ar * ax[2])
    ad = _dot3(ax, d)
    pd = (d[0] - ad * ax[0], d[1] - ad * ax[1], d[2] - ad * ax[2])
    qa = _dot3(pd, pd)
    qb = _dot3(po, pd)
    ok = bool(qa > 1e-18)
    a_safe = qa if ok else _f(1.0)
    t_mid = -qb / a_safe
    q = (po[0] + pd[0] * t_mid, po[1] + pd[1] * t_mid,
         po[2] + pd[2] * t_mid)
    c_mid = _dot3(q, q) - rad * rad
    disc = -c_mid / a_safe
    ok = ok and bool(disc >= 0)
    dt = sqrt_rn(_nmax(disc, _f(0.0)).reshape(1))[0]
    t_near, t_far = t_mid - dt, t_mid + dt

    def miter_ok(tt):
        h = (o[0] + d[0] * tt, o[1] + d[1] * tt, o[2] + d[2] * tt)
        return bool(_dot3((h[0] - p0[0], h[1] - p0[1], h[2] - p0[2]),
                          n0) >= 0) and \
            bool(_dot3((h[0] - p1[0], h[1] - p1[1], h[2] - p1[2]), n1) <= 0)

    near_ok = ok and bool(t_near >= mint) and bool(t_near <= maxt) \
        and miter_ok(t_near)
    far_ok = ok and bool(t_far >= mint) and bool(t_far <= maxt) \
        and miter_ok(t_far)
    return (pid >= 0 and (near_ok or far_ok)), \
        (t_near if near_ok else t_far), pid


def _kernel_f(nodes, rows, K, leaf, any_hit, o, d, mint, maxt):
    """walk_kernel<Leaf, ANY> for one ray, line by line."""
    test = {"tri": _tri_test, "hair": _hair_test}[leaf]
    M = nodes.shape[0]

    def inv(x):
        return _f(1.0) / ((_f(1e-12) if x >= 0 else _f(-1e-12))
                          if abs(x) < 1e-12 else x)
    iv = [inv(d[a]) for a in range(3)]
    degenerate = bool(maxt <= mint)
    occ = degenerate
    best_t, best_p = INF, -1
    node, steps = 0, 0
    while node != M and not (any_hit and occ):
        assert steps < 2 * M
        steps += 1
        row = nodes[node]
        meta = int(row[6:7].view(torch.int32))
        skip = int(row[7:8].view(torch.int32))
        count, child = meta & 0x1F, meta >> 5
        is_leaf = count != 0x1F
        tn = tf = None
        for a in range(3):
            a0 = (row[a] - o[a]) * iv[a]
            a1 = (row[3 + a] - o[a]) * iv[a]
            lo, hi = _nmin(a0, a1), _nmax(a0, a1)
            tn = lo if tn is None else _nmax(tn, lo)
            tf = hi if tf is None else _nmin(tf, hi)
        tf = tf * _f(1.00000024) + _f(1e-7)
        hit_box = bool(tn <= tf) and bool(tf >= mint) and bool(tn <= maxt)
        if hit_box and is_leaf:
            tb, pb = INF, -1
            for j in range(count):
                ok, t, pid = test(rows[child, j * 16:(j + 1) * 16], o, d,
                                  mint, maxt)
                if ok:
                    if any_hit:
                        occ = True
                        break
                    if t < tb:
                        tb, pb = t, pid
            if not any_hit and tb < maxt:
                maxt = best_t = tb
                best_p = pb
        node = child if (hit_box and not is_leaf) else skip
    if any_hit:
        return occ and not degenerate
    return best_t, best_p


@pytest.mark.parametrize("leaf", ["tri", "hair"])
@pytest.mark.parametrize("mode", ["closest", "any"])
def test_kernel_f_transcription_equals_plain_walk(geoms, leaf, mode):
    """Kernel F's loop, one ray at a time (lane order within a leaf, the
    any-hit break, the strict t < maxt across leaves, NaN-passing min
    and max), against the vectorised plain walk bit for bit: t and pid
    (closest) or the flag (any). Every edge ray of the wave and a sample
    of the others."""
    nodes, rows, (ray, _, _) = geoms[leaf]
    n_all = len(ray[0])
    pick = np.concatenate([np.arange(0, 600, 10), np.arange(600, n_all)])
    o, d, mint, maxt = (torch.as_tensor(x[pick]) for x in ray)
    if mode == "any":
        maxt = torch.where(torch.arange(len(pick)) % 7 == 0, 0.0,
                           torch.clamp(maxt, max=2.0))
    tb = tpk.PackedBVH(torch.as_tensor(nodes), torch.as_tensor(rows))
    rw = torch.as_tensor(rows)
    nd = torch.as_tensor(nodes)
    ray_t = Ray(o, d, mint, maxt)
    if mode == "any":
        plain = tpk.any_hit_packed(tb, leaf, ray_t)
        assert 5 < int(plain.sum()) < len(pick) - 5
    else:
        t_p, p_p = tpk.closest_hit_packed(tb, leaf, ray_t)
        assert 20 < int((p_p >= 0).sum()) < len(pick) - 5
    for i in range(len(pick)):
        got = _kernel_f(nd, rw, 4, leaf, mode == "any", o[i], d[i],
                        mint[i], maxt[i])
        if mode == "any":
            assert got == bool(plain[i]), i
        else:
            t_k, p_k = got
            assert p_k == int(p_p[i]), i
            assert t_k.view(torch.int32) == t_p[i].view(torch.int32), i


def test_walk_cap_raises():
    """A skip pointer that loops (a corrupt tree) stops the plain walk
    at 2 M steps with an error, as kernel F's cap does."""
    nodes, rows = _tri_bvh(shp.rectangle())
    nodes = nodes.copy()
    nodes[:, 7] = np.zeros(len(nodes), np.int32).view(np.float32)
    nodes[:, 0:3], nodes[:, 3:6] = 1.0, -1.0          # enters no box
    tb = tpk.PackedBVH(torch.as_tensor(nodes), torch.as_tensor(rows))
    ray = Ray(torch.zeros(1, 3), torch.tensor([[0.0, 0.0, 1.0]]),
              torch.zeros(1), torch.full((1,), float("inf")))
    with pytest.raises(RuntimeError, match="2 M"):
        tpk.closest_hit_packed(tb, "tri", ray)


def test_pack_bvh_matches_jax():
    """pack_bvh's nodes and leaf rows against hairpt's, bit for bit, for
    a triangle and a hair tree."""
    mesh = _ripples(9)
    nodes, rows = _tri_bvh(mesh)
    p, f = mesh.positions, mesh.faces
    v0, v1, v2 = p[f[:, 0]], p[f[:, 1]], p[f[:, 2]]
    fb = tbvh.build(np.minimum(np.minimum(v0, v1), v2),
                    np.maximum(np.maximum(v0, v1), v2))
    o = fb.prim_order
    jrows = jpk.tri_pack_rows(v0[o].astype(np.float32),
                              v1[o].astype(np.float32),
                              v2[o].astype(np.float32),
                              np.arange(len(o), dtype=np.int32))
    jb = jpk.pack_bvh(fb, jrows)
    np.testing.assert_array_equal(np.asarray(jb.nodes).view(np.int32),
                                  nodes.view(np.int32))
    np.testing.assert_array_equal(np.asarray(jb.leaf_rows).view(np.int32),
                                  rows.view(np.int32))
    s = th.segments(th.gen_furball(n_fibers=10, n_segs=4, seed=1))
    args = [s[k] for k in ("p0", "p1", "n0", "n1", "radius")]
    ids = np.arange(len(args[0]), dtype=np.int32)
    np.testing.assert_array_equal(
        tpk.hair_pack_rows(*args, ids).view(np.int32),
        jpk.hair_pack_rows(*args, ids).view(np.int32))
