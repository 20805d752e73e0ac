"""Instanced meshes in the port against hairpt, on the CPU: the
prototypes and instance transforms (exact), the two-level walk's closest
and any hit (kernel G's plain versions) against hairpt's loop over the
instances, against the port's own packed walk of the instances
flattened into one mesh, the instanced shading record and
scene_intersect / scene_occluded, hairpt_torch.convert's instance table,
the loader's instanced stand-in against the same scene built by hand,
and the differentiable mode on it.

Both packages' builds take the SAH builder of csrc/bvh_builder.cpp; the
tests load the port's build of it into hairpt (`same_bvh`, as
tests/test_torch_xml.py does), so the trees are the same. XLA:CPU
contracts the object ray's multiply-adds, so a ray that passes within
float32 rounding of a triangle's edge may hit the neighbour in one
package and not the other: such rays are allowed where they lie within
EDGE of an edge (barycentric, in float64)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core.math import Ray as JRay
from hairpt.integrators import common as jcommon
from hairpt.models import shapes as jshp
from hairpt.ops import bvh as jbvh
from hairpt.ops import instancing as jinst
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import convert
from hairpt_torch.core.math import Ray
from hairpt_torch.integrators import common as tcommon
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models import shapes as tshp
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.ops import instancing as tinst
from hairpt_torch.ops import intersect_packed as tipk
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.scene.scene import SceneBuilder as TSceneBuilder
from torch_instanced import _chain, _move, _rot, _scale, hand_build
from torch_threads import one_thread  # noqa: F401

N = 8192
AGREE = 0.999     # share of rays whose hit (instance, prim) must agree
EDGE = 1e-4       # barycentric distance to an edge of a disagreeing ray
T_RTOL = 1e-5
ATOL = 1e-5
# the shading record's barycentrics come from sums that cancel (the ray's
# origin is far from the triangle beside its size), so float32 rounding
# of the object ray moves them by up to about EPS * kappa, kappa the
# solve's conditioning (|tv| |pv| + |d| |qv|) / |det| in float64 (kappa
# 20-60 here; measured: |db| <= 0.95 EPS kappa between the packages); an
# interpolated attribute moves by that times its spread over the
# triangle's vertices. The record is held to ATOL plus COND times that.
EPS = 2.0 ** -23
COND = 4.0


@pytest.fixture
def same_bvh(monkeypatch):
    lib = tbvh._load_native()
    assert lib is not None
    monkeypatch.setattr(jbvh, "_NATIVE", lib)
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)


def _same_bits(a, b):
    """Equal bits (the packed rows' -1 ids are NaN patterns)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _mesh(m):
    return m.compute_smooth_normals(m.sphere(0.8, 10, 16))


# four instances: rotated, non-uniformly scaled, mirrored, rotated and
# scaled
TO_WORLD = [
    _chain(_rot((0, 1, 0), 30.0), _move(-1.6, 0.0, 0.0)),
    _chain(_scale(1.4, 0.7, 1.0), _rot((1, 1, 0), 45.0), _move(1.6, 0, 0)),
    _chain(_scale(-1.0, 1.0, 1.0), _move(0.0, 1.6, 0.2)),
    _chain(_scale(0.8), _rot((0, 0, 1), 60.0), _move(0.0, -1.6, 0.5)),
]


def _rays(seed=0, n=N):
    """Rays from a sphere of radius 6 at points near the instances'
    centres; a tenth with a finite maxt, a twentieth with mint < 0."""
    rs = np.random.default_rng(seed)
    o = rs.normal(size=(n, 3))
    o = 6.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    c = np.array([t[:3, 3] for t in TO_WORLD])[rs.integers(0, 4, n)]
    d = c + rs.normal(scale=0.6, size=(n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(rs.random(n) < 0.1, rs.uniform(3.0, 8.0, n), np.inf)
    mint = np.where(rs.random(n) < 0.05, -1.0, 0.0)
    f = np.float32
    return o.astype(f), d.astype(f), mint.astype(f), maxt.astype(f)


def _both(seed=0):
    jp = jinst.build_proto(_mesh(jshp), 0)
    tp = tinst.build_proto(_mesh(tshp), 0)
    inst = [(0, t) for t in TO_WORLD]
    j = jinst.build_instanced([jp], inst)
    t = tinst.build_instanced([tp], inst)
    o, d, mint, maxt = _rays(seed)
    jray = JRay(*(jnp.asarray(x) for x in (o, d, mint, maxt)))
    tray = Ray(*(torch.as_tensor(x) for x in (o, d, mint, maxt)))
    return jp, tp, j, t, jray, tray


def _bary64(mesh, o2w, o, d, prim):
    """float64 barycentrics (b0, b1, b2) of the world ray (o, d) against
    triangle `prim` of `mesh` under o2w, and the hit's t."""
    m = np.linalg.inv(o2w)
    oo = m[:3, :3] @ o + m[:3, 3]
    dd = m[:3, :3] @ d
    p = np.asarray(mesh.positions, np.float64)[np.asarray(mesh.faces)[prim]]
    e1, e2 = p[1] - p[0], p[2] - p[0]
    pv = np.cross(dd, e2)
    det = e1 @ pv
    tv = oo - p[0]
    u = (tv @ pv) / det
    qv = np.cross(tv, e1)
    v = (dd @ qv) / det
    return np.array([1 - u - v, u, v]), (e2 @ qv) / det


def _near_edge(mesh, o, d, hits):
    """Does one of the hits (instance, prim) of the ray lie within EDGE
    of an edge of its triangle?"""
    for which, prim in hits:
        if which >= 0:
            b, _ = _bary64(mesh, TO_WORLD[which], o.astype(np.float64),
                           d.astype(np.float64), prim)
            if np.min(np.abs(b)) < EDGE:
                return True
    return False


def _bounds(mesh, which, prim, o, d):
    """Per lane, float64: (the barycentrics' rounding bound, the
    interpolated normal's, the uv's) of hits (which, prim) of rays (o,
    d); ATOL on lanes without a hit."""
    n = len(which)
    out = np.full((3, n), ATOL)
    pos = np.asarray(mesh.positions, np.float64)
    f = np.asarray(mesh.faces)
    nrm = np.asarray(mesh.normals, np.float64)
    uvs = np.asarray(mesh.uvs, np.float64)
    for r in np.nonzero(which >= 0)[0]:
        m = np.linalg.inv(TO_WORLD[which[r]])
        oo = m[:3, :3] @ o[r] + m[:3, 3]
        dd = m[:3, :3] @ d[r]
        p = pos[f[prim[r]]]
        e1, e2 = p[1] - p[0], p[2] - p[0]
        pv = np.cross(dd, e2)
        tv = oo - p[0]
        qv = np.cross(tv, e1)
        kappa = (np.linalg.norm(tv) * np.linalg.norm(pv)
                 + np.linalg.norm(dd) * np.linalg.norm(qv)) / abs(e1 @ pv)
        db = COND * EPS * kappa
        vn, vt = nrm[f[prim[r]]], uvs[f[prim[r]]]
        spread_n = max(np.linalg.norm(vn[i] - vn[j]) for i in range(3)
                       for j in range(3))
        spread_t = max(np.abs(vt[i] - vt[j]).max() for i in range(3)
                       for j in range(3))
        out[:, r] += (db, 2.0 * db * spread_n, db * spread_t)
    return out


def _agree(mesh, jhit, thit, o, d, maxt):
    """The closest-hit rule: (instance, prim) equal on >= AGREE of the
    rays, each other ray within EDGE of an edge (or at its maxt), t
    within T_RTOL where both hit the same triangle."""
    (jt, jp, ji), (tt, tp, ti) = jhit, thit
    same = (jp == tp) & (ji == ti)
    assert same.mean() >= AGREE, same.mean()
    for r in np.nonzero(~same)[0]:
        at_maxt = any(abs(t_ - maxt[r]) <= T_RTOL * abs(maxt[r])
                      for t_ in (jt[r], tt[r]) if np.isfinite(t_))
        assert at_maxt or _near_edge(mesh, o[r], d[r],
                                     [(ji[r], jp[r]), (ti[r], tp[r])]), r
    hit = same & (jp >= 0)
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=T_RTOL)
    assert hit.sum() > N // 4


def test_build_proto_and_transforms_match_jax(same_bvh):
    """build_proto (packed BVH, shading arrays, object box) and
    instance_transforms (w2o, normal matrix, world boxes) bit for bit,
    and hairpt_torch.convert's instance table equal to the port's own."""
    jp, tp, j, t, _, _ = _both()
    np.testing.assert_array_equal(tp.bvh.nodes.numpy().view(np.int32),
                                  np.asarray(jp.bvh.nodes).view(np.int32))
    np.testing.assert_array_equal(
        tp.bvh.leaf_rows.numpy().view(np.int32),
        np.asarray(jp.bvh.leaf_rows).view(np.int32))
    for f in tinst._SHADING:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    np.testing.assert_array_equal(tp.obj_lo, jp.obj_lo)
    np.testing.assert_array_equal(tp.obj_hi, jp.obj_hi)
    jw, jn, jlo, jhi = jinst.instance_transforms([jp], [(0, m)
                                                        for m in TO_WORLD])
    tw, tn, tlo, thi = tinst.instance_transforms([tp], [(0, m)
                                                        for m in TO_WORLD])
    for a, b in ((tw, jw), (tn, jn), (tlo, jlo), (thi, jhi)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.w2o.numpy(), np.asarray(j.w2o)[:, :3])
    c = convert._instances(jax.tree_util.tree_map(np.asarray, j), "cpu")
    for f in tinst.InstancedGeo._fields:
        a, b = getattr(t, f), getattr(c, f)
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and _same_bits(a, b), f
    assert c.proto_ids == t.proto_ids and len(c.protos) == 1
    # re-posing writes the same table as building with the new poses
    moved = [(0, m @ _move(0.0, 0.25, 0.0)) for m in TO_WORLD]
    r = tinst.repose_instanced(t, moved)
    b = tinst.build_instanced([tp], moved)
    for f in ("w2o", "nrm_m", "aabb_lo", "aabb_hi", "table"):
        assert torch.equal(getattr(r, f), getattr(b, f)), f


def test_instanced_hits_match_jax(same_bvh):
    """inst_closest_hit / inst_any_hit (kernel G's plain versions) on 4
    instances (rotated, non-uniformly scaled, mirrored) against hairpt's
    on the same rays: (instance, prim) and the occlusion flags equal on
    >= 99.9% of the rays, every other ray within 1e-4 (barycentric) of an
    edge; t within 1e-5 relative on the rest."""
    _, _, j, t, jray, tray = _both()

    def jf(geo, ray):
        return jinst.inst_closest_hit(geo, ray), jinst.inst_any_hit(geo, ray)
    (jt, jp, ji), jocc = jax.jit(jf)(j, jray)
    jhit = tuple(np.asarray(x) for x in (jt, jp, ji))
    tt, tp, ti = tinst.inst_closest_hit(t, tray)
    tocc = tinst.inst_any_hit(t, tray)
    o, d, _, maxt = (np.asarray(x) for x in tray)
    mesh = _mesh(tshp)
    _agree(mesh, jhit, (tt.numpy(), tp.numpy(), ti.numpy()), o, d, maxt)
    jocc, tocc = np.asarray(jocc), tocc.numpy()
    assert (jocc == tocc).mean() >= AGREE
    for r in np.nonzero(jocc != tocc)[0]:
        assert _near_edge(mesh, o[r], d[r], [(jhit[2][r], jhit[1][r]),
                                             (int(ti[r]), int(tp[r]))]), r
    # an occluded ray is one with a closest hit
    assert np.array_equal(tocc, tp.numpy() >= 0)


def test_instanced_walk_matches_flattened():
    """The port's instanced walk against its own packed walk of the four
    instances flattened into one world-space mesh, with the same rules:
    the flattened prim id (instance * T + prim) equal on >= 99.9% of the
    rays, the rest at an edge, t within 1e-5."""
    mesh = _mesh(tshp)
    t = tinst.build_instanced([tinst.build_proto(mesh, 0)],
                              [(0, m) for m in TO_WORLD])
    o, d, mint, maxt = _rays(seed=1)
    ray = Ray(*(torch.as_tensor(x) for x in (o, d, mint, maxt)))
    ti_t, ti_p, ti_i = (x.numpy() for x in tinst.inst_closest_hit(t, ray))
    n_tri = len(mesh.faces)
    flat = tshp.merge([tshp.transform_mesh(mesh, m) for m in TO_WORLD])
    pos = np.asarray(flat.positions, np.float32)
    f = np.asarray(flat.faces)
    p0, p1, p2 = pos[f[:, 0]], pos[f[:, 1]], pos[f[:, 2]]
    fb = tbvh.build(np.minimum(np.minimum(p0, p1), p2),
                    np.maximum(np.maximum(p0, p1), p2), leaf_size=4)
    o_ = fb.prim_order
    bvh = tipk.pack_bvh(fb, tipk.tri_pack_rows(p0[o_], p1[o_], p2[o_], o_))
    ft, fp = (x.numpy() for x in tipk.closest_hit_packed_plain(bvh, "tri",
                                                               ray))
    fi = np.where(fp >= 0, fp // n_tri, -1)
    _agree(mesh, (ft, np.where(fp >= 0, fp % n_tri, -1), fi),
           (ti_t, ti_p, ti_i), o, d, maxt)
    focc = tipk.any_hit_packed_plain(bvh, "tri", ray).numpy()
    tocc = tinst.inst_any_hit(t, ray).numpy()
    assert (focc == tocc).mean() >= AGREE


def _within(name, got, ref, bound, lanes):
    with np.errstate(invalid="ignore"):    # inf - inf on missed lanes
        err = np.abs(np.asarray(got, np.float64)
                     - np.asarray(ref, np.float64))
    err = err.reshape(len(err), -1).max(-1)
    bad = np.nonzero(lanes & (err > bound))[0]
    assert bad.size == 0, (name, bad[:8], err[bad[:8]], bound[bad[:8]])


def test_inst_shading_matches_jax(same_bvh):
    """inst_shading on hairpt's hits (the same t, prim and instance in
    both): the geometric normal within 1e-5, the material ids equal, the
    barycentrics, shading normal and uv within 1e-5 plus the float32
    conditioning of the barycentric solve (COND)."""
    _, _, j, t, jray, tray = _both(seed=2)
    jt, jp, ji = jax.jit(jinst.inst_closest_hit)(j, jray)
    ref = jax.jit(jinst.inst_shading)(j, jray, jt, jp, ji)
    got = tinst.inst_shading(t, tray, *(torch.as_tensor(np.array(x))
                                        for x in (jt, jp, ji)))
    hit = np.asarray(ji) >= 0
    assert hit.sum() > N // 4
    b_bary, b_n, b_uv = _bounds(_mesh(tshp), np.asarray(ji), np.asarray(jp),
                                *(x.numpy().astype(np.float64)
                                  for x in tray[:2]))
    for name, a, b, bound in zip(
            ("geo_n", "sh_n", "uv", "mat_id", "bary"), got, ref,
            (np.full(N, ATOL), b_n, b_uv, np.zeros(N), b_bary)):
        _within(name, a.numpy(), np.asarray(b), bound, hit)


def _scene(b, m, device=None):
    """A prototype in four instances over a rectangle, in either package."""
    from hairpt_torch.film.film import Film as TFilm
    from hairpt_torch.models.sensors import Camera as TCamera
    from hairpt.film.film import Film as JFilm
    from hairpt.models.sensors import Camera as JCamera
    mid = b.add_material(diffuse=(0.6, 0.5, 0.4))
    floor = b.add_material(diffuse=(0.3, 0.3, 0.3))
    p = b.add_prototype(_mesh(m), mid)
    for tw in TO_WORLD:
        b.add_instance(p, tw)
    b.add_mesh(m.rectangle(), floor,
               to_world=_chain(_scale(6.0), _move(0.0, 0.0, -1.5)))
    cam = np.eye(4)
    cam[:3, 3] = (0.0, 0.0, -6.0)
    film, camera = (TFilm, TCamera) if device else (JFilm, JCamera)
    return b.build(camera.perspective(cam, 40.0, 16, 16),
                   film.make(16, 16, "tent"), spp=1, traversal="packed")


def test_instanced_scene_intersect_matches_jax(same_bvh):
    """scene_intersect with instances and a rectangle, the nearer of the
    triangle and instance hits: the hit record (t, point, normals, frame,
    uv, barycentrics, material, prim, uv_density 0 and vertex colour 1 on
    instances) within 1e-5 where both hit the same primitive, and
    scene_occluded's flags; the instance tables of the two builds (through
    hairpt_torch.convert) bit for bit."""
    js = _scene(JSceneBuilder(), jshp)
    ts = _scene(TSceneBuilder(device="cpu"), tshp, device="cpu")
    cs = convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    for f in ("table", "nodes", "leaf_rows", "p0", "n0", "uv0", "mat_id"):
        assert _same_bits(getattr(ts.arrays.inst, f),
                          getattr(cs.arrays.inst, f)), f
    o, d, mint, maxt = _rays(seed=3)
    jray = JRay(*(jnp.asarray(x) for x in (o, d, mint, maxt)))
    tray = Ray(*(torch.as_tensor(x) for x in (o, d, mint, maxt)))

    def jf(arr, ray):
        return (jcommon.scene_intersect(arr, ray, "packed"),
                jcommon.scene_occluded(arr, ray, "packed"))
    jh, jocc = jax.jit(jf)(js.arrays, jray)
    th = tcommon.scene_intersect(ts.arrays, tray, 128, traversal="packed")
    tocc = tcommon.scene_occluded(ts.arrays, tray, 128, traversal="packed")
    same = (np.asarray(jh.prim) == th.prim.numpy()) \
        & (np.asarray(jh.valid) == th.valid.numpy())
    assert same.mean() >= AGREE
    inst = same & th.valid.numpy() & (th.uv_density.numpy() == 0)
    assert inst.sum() > N // 8
    # the instances' lanes as test_inst_shading_matches_jax bounds them
    # (a frame's tangents with the normal's bound), the rest within 1e-5
    ti = tinst.inst_closest_hit(ts.arrays.inst, tray)[2].numpy()
    b_bary, b_n, b_uv = _bounds(_mesh(tshp), np.where(inst, ti, -1),
                                th.prim.numpy(), o.astype(np.float64),
                                d.astype(np.float64))
    # the point o + d t moves with t: by up to T_RTOL |t|
    _within("p", th.p.numpy(), np.asarray(jh.p),
            ATOL + T_RTOL * np.abs(np.nan_to_num(np.asarray(jh.t))), same)
    for f in ("t", "geo_n", "vcolor", "uv_density"):
        np.testing.assert_allclose(getattr(th, f).numpy()[same],
                                   np.asarray(getattr(jh, f))[same],
                                   rtol=T_RTOL, atol=ATOL, err_msg=f)
    for f, bound in (("sh_n", b_n), ("sh_s", b_n), ("sh_t", b_n),
                     ("uv", b_uv), ("bary", b_bary)):
        _within(f, getattr(th, f).numpy(), np.asarray(getattr(jh, f)),
                bound, same)
    for f in ("mat_id", "emitter_id", "is_hair"):
        np.testing.assert_array_equal(getattr(th, f).numpy()[same],
                                      np.asarray(getattr(jh, f))[same])
    assert (th.mat_id.numpy()[inst] == 0).all()
    assert (th.vcolor.numpy()[inst] == 1).all()
    assert (np.asarray(jocc) == tocc.numpy()).mean() >= AGREE


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("inst"))
    return scene_xmls.write_scene(root, "instanced")


def test_instanced_loader_equals_builder(standin):
    """The loader's scene for the instanced stand-in (64 instances of the
    teapot's shapegroup, the bitmap floor in a normal map, the bump-mapped
    heightfield, the deformable pair under the curvature texture) equals
    the scene built by hand through SceneBuilder, tensor for tensor, with
    the same config, camera and static flags."""
    ls = txl.load_scene(standin, res_scale=0.05, spp_override=1,
                        max_depth_override=3, device="cpu")
    hs = hand_build("hairpt_torch", os.path.dirname(standin), device="cpu")
    assert ls.config == hs.config and ls.active_kinds == hs.active_kinds
    assert ls.has_normal_maps and hs.has_normal_maps
    for a, b in zip(ls.camera, hs.camera):
        assert np.array_equal(np.asarray(a), np.asarray(b))

    def tensors(a, path):
        if torch.is_tensor(a):
            yield path, a
        elif hasattr(a, "_fields"):
            for f in a._fields:
                yield from tensors(getattr(a, f), f"{path}.{f}")
    lt = dict(tensors(ls.arrays, "arrays"))
    ht = dict(tensors(hs.arrays, "arrays"))
    assert lt.keys() == ht.keys()
    for k, v in lt.items():
        assert v.dtype == ht[k].dtype and v.shape == ht[k].shape, k
        assert _same_bits(v, ht[k]), k
    assert ls.arrays.inst.protos[0][:6] == hs.arrays.inst.protos[0][:6]
    assert len(ls.arrays.inst.proto_ids) == 64
    assert ls.arrays.inst.p0.shape[0] == 2808


@pytest.fixture(scope="module")
def small(standin):
    """The stand-in with 4 instances at 32 x 18, depth 3, no Russian
    roulette, and its lanes."""
    import dataclasses
    xml = scene_xmls.write_scene(os.path.dirname(os.path.dirname(standin)),
                                 "instanced", grid=2)
    s = txl.load_scene(xml, res_scale=0.025, spp_override=1,
                       max_depth_override=3, device="cpu")
    s = s._replace(config=dataclasses.replace(s.config, rr_depth=999))
    n = s.config.width * s.config.height
    return s, torch.arange(n), torch.zeros(n, dtype=torch.int64)


def _diff_mode(s, pix, smp):
    mt = s.arrays.materials
    diffuse = mt.diffuse.clone().requires_grad_()
    arr = s.arrays._replace(materials=mt._replace(diffuse=diffuse))
    rad, _, rays = tpath.make_li_fn(s, differentiable=True)(arr, pix, smp)
    return rad, rays, diffuse


def test_instanced_differentiable_mode(small):
    """The differentiable mode on the stand-in (4 instances, 32 x 18,
    depth 3, no Russian roulette) gives the forward mode's image and ray
    count (to float32 rounding: a diffuse lobe's weight is re-evaluated as
    f(wo) / pdf(wo), which rounds apart from the sampled weight, the
    albedo, by an ulp), and its backward pass runs no query (the
    instanced walk's results are stashed with the packed walk's); the
    teapots' diffuse takes a gradient."""
    s, pix, smp = small
    with torch.no_grad():
        l0, _, r0 = tpath.make_li_fn(s)(s.arrays, pix, smp)
    l1, r1, diffuse = _diff_mode(s, pix, smp)
    torch.testing.assert_close(l1.detach(), l0, rtol=1e-5, atol=1e-7)
    assert float(r0) == float(r1)
    walks = (tinst.STATS["walks"], tipk.STATS["walks"])
    assert walks[0] > 0
    l1.mean().backward()
    assert (tinst.STATS["walks"], tipk.STATS["walks"]) == walks
    g = diffuse.grad
    assert torch.isfinite(g).all() and g[0].abs().sum() > 0


def test_instanced_prb_matches_differentiable_mode(small):
    """Path-replay backprop on the stand-in replays its shading (the
    bitmap's level of detail and the camera hit's EWA, the normal and
    bump maps): its loss and diffuse gradient equal the differentiable
    mode's with tests/test_torch_prb.py's bounds (1e-4 relative; 5e-3 of
    the largest |g|)."""
    from hairpt_torch.integrators import prb
    s, pix, smp = small
    rad, _, diffuse = _diff_mode(s, pix, smp)
    loss = rad.mean()
    loss.backward()
    mt = s.arrays.materials
    arr = s.arrays._replace(materials=mt._replace(
        diffuse=mt.diffuse.clone().requires_grad_()))
    (l_prb, _), g = prb.make_prb_grad_fn(s)(arr, pix, smp)
    assert float(l_prb) == pytest.approx(float(loss.detach()), rel=1e-4)
    a, b = diffuse.grad.numpy(), g[("materials", "diffuse")].numpy()
    scale = np.abs(a).max()
    assert scale > 0
    np.testing.assert_allclose(b / scale, a / scale, atol=5e-3)
