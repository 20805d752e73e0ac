"""Triangle meshes in the port against hairpt, on the CPU: the shapes
module (every builder and reader, bit for bit), the mesh scene build
(triangles, their shading records, the packed BVHs and the texture
table, bit for bit, both packages on the port's SAH build), smooth
plastic's eval, pdf and sample, the procedural textures, and a small
furball over a checkerboard rectangle rendered by the port (tiled and
packed) against hairpt's packed render; and the differentiable mode's
gradient on a textured mesh scene."""
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core import rng as jrng
from hairpt.film.film import Film as JFilm
from hairpt.integrators import path as jpath
from hairpt.models import emitters as jem
from hairpt.models import shapes as jshp
from hairpt.models.bsdf import plastic as jplastic  # noqa: F401 (registers)
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.ops import bvh as jbvh
from hairpt.scene import hairgen as jh
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import convert
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models import shapes as tshp
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import furball as tfur
from hairpt_torch.scene.scene import SceneBuilder as TSceneBuilder
from torch_threads import one_thread  # noqa: F401

N = 4096


@pytest.fixture
def same_bvh(monkeypatch):
    """hairpt's scene build on the port's SAH library (its own is built
    with -march=native; see tests/test_torch_xml.py)."""
    lib = tbvh._load_native()
    assert lib is not None
    monkeypatch.setattr(jbvh, "_NATIVE", lib)
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)


# --- shapes ----------------------------------------------------------------

OBJ = """# a quad, a triangle with negative indices, uvs and normals
v 0 0 0
v 1 0 0
v 1 1 0.25
v 0 1 0
v 0.5 0.5 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0 0.6 0.8
f 1/1/1 2/2/1 3/3/2 4/4/1
f -1/-4/-2 -4/-3/-1 -3/-2/-1
"""
OBJ_PLAIN = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 1\nf 1 2 3\nf 2 4 3\n"
PLY_HEADER = ("ply\nformat {fmt} 1.0\nelement vertex 5\nproperty float x\n"
              "property float y\nproperty float z\nelement face 2\n"
              "property list uchar int vertex_indices\nend_header\n")
PLY_V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0.5],
                  [0.5, 0.5, 1]], np.float32)
PLY_F = [[0, 1, 2, 3], [1, 4, 2]]


def _write_files(d):
    (d / "m.obj").write_text(OBJ)
    (d / "p.obj").write_text(OBJ_PLAIN)
    body = "".join(" ".join(repr(float(x)) for x in v) + "\n" for v in PLY_V)
    body += "".join(f"{len(f)} " + " ".join(map(str, f)) + "\n"
                    for f in PLY_F)
    (d / "a.ply").write_text(PLY_HEADER.format(fmt="ascii") + body)
    data = PLY_HEADER.format(fmt="binary_little_endian").encode()
    data += PLY_V.astype("<f4").tobytes()
    for f in PLY_F:
        data += bytes([len(f)]) + np.asarray(f, "<i4").tobytes()
    (d / "b.ply").write_bytes(data)
    # .serialized (version 4): flags (normals, uvs), a name, counts, the
    # attribute blocks in float32, then the faces
    rs = np.random.default_rng(5)
    pos = rs.random((6, 3)).astype("<f4")
    nrm = rs.random((6, 3)).astype("<f4")
    uv = rs.random((6, 2)).astype("<f4")
    faces = np.array([[0, 1, 2], [2, 3, 4], [4, 5, 0]], "<u4")
    raw = struct.pack("<I", 0x0001 | 0x0002) + b"mesh\0" \
        + struct.pack("<QQ", 6, 3) + pos.tobytes() + nrm.tobytes() \
        + uv.tobytes() + faces.tobytes()
    (d / "m.serialized").write_bytes(struct.pack("<HH", 0x041C, 4)
                                     + zlib.compress(raw))


M4 = np.array([[0.5, -0.8, 0.1, 1.0], [0.7, 0.4, -0.3, -2.0],
               [0.2, 0.1, 1.5, 0.5], [0, 0, 0, 1.0]])
HEIGHTS = np.random.default_rng(2).normal(0, 0.1, (7, 9))

SHAPES = {
    "rectangle": lambda m, d: m.rectangle(),
    "sphere": lambda m, d: m.sphere(0.7, 8, 12),
    "disk": lambda m, d: m.disk(16),
    "cube": lambda m, d: m.cube(),
    "cylinder": lambda m, d: m.cylinder(0.5, 12),
    "merge": lambda m, d: m.merge([m.disk(8), m.sphere(1.0, 4, 6),
                                   m.cylinder(0.3, 5)]),
    "teapot_standin": lambda m, d: m.teapot_standin(),
    "smooth_normals": lambda m, d: m.compute_smooth_normals(
        m.teapot_standin(0.5)),
    "transform": lambda m, d: m.transform_mesh(m.sphere(1.0, 6, 8), M4),
    "heightfield": lambda m, d: m.heightfield(HEIGHTS, 2.0, 0.5, flip=True),
    "lerp": lambda m, d: m.lerp_mesh(m.sphere(1.0, 6, 8),
                                     m.transform_mesh(m.sphere(1.0, 6, 8),
                                                      M4), 0.3),
    "curvature": lambda m, d: m.vertex_gaussian_curvature(
        m.teapot_standin()),
    "obj": lambda m, d: m.load_obj(str(d / "m.obj")),
    "obj_positions_only": lambda m, d: m.load_obj(str(d / "p.obj")),
    "ply_ascii": lambda m, d: m.load_ply_ascii(str(d / "a.ply")),
    "ply_binary": lambda m, d: m.load_ply_ascii(str(d / "b.ply")),
    "serialized": lambda m, d: m.load_serialized(str(d / "m.serialized")),
}


def _same(a, b, what):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(
            np.ascontiguousarray(a).view(np.uint8),
            np.ascontiguousarray(b).view(np.uint8), err_msg=what)
        return
    assert type(a).__name__ == type(b).__name__ == "Mesh", what
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, (what, f)
        else:
            _same(np.asarray(x), np.asarray(y), f"{what}.{f}")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shapes_match_jax(tmp_path, name):
    """Every builder and reader of hairpt_torch.models.shapes against
    hairpt's: the same arrays (dtype, shape, bits)."""
    _write_files(tmp_path)
    _same(SHAPES[name](tshp, tmp_path), SHAPES[name](jshp, tmp_path), name)


# --- the mesh scene build --------------------------------------------------

def _mixed(b, m, textures: bool = True, fibers: bool = True):
    """The same scene through either package's SceneBuilder: the teapot
    stand-in under plastic, a sphere and a transformed cube under
    diffuse, a checkerboard, grid, wireframe and vertex-colour texture
    (the sphere's mesh carries colours) and, optionally, furball fibers."""
    t = [b.add_checkerboard((0.7, 0.6, 0.5), (0.1, 0.2, 0.3), 4.0, 2.0,
                            0.25, -0.5),
         b.add_gridtexture((0.2,) * 3, (0.9,) * 3, 0.05, 3.0, 3.0),
         b.add_wireframe_texture(line_width=0.1),
         b.add_vertexcolor_texture()] if textures else [-1] * 4
    pl = b.add_material(kind=jmat.PLASTIC, eta=1.5, diffuse=(0.6, 0.1, 0.1),
                        nonlinear=True, tex_id=t[0])
    df = b.add_material(kind=jmat.DIFFUSE, twosided=True, tex_id=t[1])
    wf = b.add_material(kind=jmat.DIFFUSE, tex_id=t[2])
    vc = b.add_material(kind=jmat.DIFFUSE, tex_id=t[3])
    b.add_mesh(m.compute_smooth_normals(m.teapot_standin()), pl,
               to_world=np.diag([0.5, 0.5, 0.5, 1.0]))
    b.add_mesh(m.rectangle(), df, to_world=tfur.FLOOR_TO_WORLD)
    b.add_mesh(m.cube(), wf, to_world=M4)
    sph = m.sphere(0.8, 6, 10)
    cols = np.random.default_rng(1).random(sph.positions.shape)
    b.add_mesh(sph._replace(colors=cols.astype(np.float32)), vc)
    if fibers:
        rp = b.add_material(kind=jmat.ROUGHPLASTIC, alpha=0.2, eta=1.55)
        b.add_fibers(jh.gen_furball(n_fibers=40, n_segs=6, radius=0.01,
                                    center=(0, 3, 0), core_r=0.5,
                                    fiber_len=0.5), rp)


def _build_both(fibers=True, textures=True):
    cam = np.eye(4)
    cam[:3, 3] = (0.0, 2.0, -12.0)
    bj = JSceneBuilder()
    bt = TSceneBuilder(device="cpu")
    _mixed(bj, jshp, textures, fibers)
    _mixed(bt, tshp, textures, fibers)
    js = bj.build(JCamera.perspective(cam, 40.0, 16, 16),
                  JFilm.make(16, 16, "tent"), spp=1, traversal="packed")
    from hairpt_torch.film.film import Film
    from hairpt_torch.models.sensors import Camera
    ts = bt.build(Camera.perspective(cam, 40.0, 16, 16),
                  Film.make(16, 16, "tent"), spp=1, traversal="packed")
    return js, ts


def _bits(a, b, path):
    if hasattr(a, "_fields"):
        for f in a._fields:
            _bits(getattr(a, f), getattr(b, f), f"{path}.{f}")
        return
    if a is None or b is None:
        assert a is None and b is None, path
        return
    x, y = a.numpy(), b.numpy()
    assert x.dtype == y.dtype and x.shape == y.shape, path
    np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                  err_msg=path)


@pytest.mark.parametrize("fibers", [True, False], ids=["mixed", "meshes"])
def test_mesh_scene_build_matches_jax(same_bvh, fibers):
    """A scene of meshes (and fibers) through both SceneBuilders: tri,
    tri_shading, the triangles' and the hair's packed BVHs, the hair's
    miter normals, the texture table and the material table bit for
    bit."""
    js, ts = _build_both(fibers=fibers)
    cs = convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    for f in ("tri", "tri_shading", "tri_packed", "hair", "hair_mat_id",
              "hair_packed", "checkers", "materials"):
        _bits(getattr(ts.arrays, f), getattr(cs.arrays, f), f)
    assert ts.active_kinds == cs.active_kinds
    assert (ts.arrays.hair is None) == (not fibers)
    assert ts.config.traversal == "packed"


def test_mesh_builder_refusals():
    """The motion integrator's mesh motion tables (item 13's, refused by
    an earlier slice) are taken: the mesh's relative motion is kept for
    the build; so is an area light (item 13's): the mesh gets an emitter
    id; and an animated instance (item 11c): its animation drives
    repose_inst."""
    from hairpt_torch.core.track import AnimatedTransform
    b = TSceneBuilder(device="cpu")
    b.add_mesh(tshp.rectangle(), 0, radiance=(1.0, 1.0, 1.0))
    assert b.tri_meshes[0][2] == 0 and len(b.area_lights) == 1
    m = np.eye(4)
    m[:3, 3] = (1.0, 2.0, 3.0)
    b.add_mesh(tshp.rectangle(), 0, motion=m)
    np.testing.assert_array_equal(b.mesh_motion[1], m.astype(np.float32))
    anim = AnimatedTransform([(0.0, np.eye(4)), (1.0, np.diag([2.0] * 3
                                                               + [1.0]))])
    b.add_instance(b.add_prototype(tshp.rectangle(), b.add_material()),
                   np.eye(4), anim=anim)
    assert b.instance_anims == {0: anim}


# --- smooth plastic and the textures ---------------------------------------

def _dirs(seed, upper_frac=0.9):
    rs = np.random.default_rng(seed)
    w = rs.normal(size=(N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    flip = rs.random(N) < upper_frac
    w[:, 2] = np.where(flip, np.abs(w[:, 2]), -np.abs(w[:, 2]))
    return w


@pytest.fixture(scope="module")
def plastic_tables():
    """Two smooth-plastic rows (eta 1.5, linear; eta 1.33, nonlinear,
    with a specular tint), lanes spread over both."""
    rows = [dict(kind=jmat.PLASTIC, eta=1.5, diffuse=(0.6, 0.12, 0.08)),
            dict(kind=jmat.PLASTIC, eta=1.33, nonlinear=True,
                 diffuse=(0.2, 0.5, 0.7), specular=(0.9, 0.8, 0.7))]
    bj, bt = JSceneBuilder(), TSceneBuilder(device="cpu")
    for r in rows:
        bj.add_material(**dict(r))
        bt.add_material(**dict(r))
    tj = jmat.pack_materials(bj.materials)
    tt = tmat.pack_materials(bt.materials, device="cpu")
    for f in tmat.MaterialTable._fields:
        if f == "cloth":  # no irawan row: no weave table
            assert getattr(tt, f) is None and getattr(tj, f) is None
            continue
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)), err_msg=f)
    mid = np.random.default_rng(0).integers(0, 2, N).astype(np.int32)
    gj = jmat.gather(tj, None, jnp.asarray(mid), jnp.zeros((N, 2)))
    gt = tmat.gather(tt, None, torch.as_tensor(mid))
    return gj, gt


def test_plastic_eval_pdf_matches_jax(plastic_tables):
    gj, gt = plastic_tables
    wi, wo = _dirs(1), _dirs(2)
    fj, pj = jmat.eval_pdf((jmat.PLASTIC,), gj, jnp.asarray(wi),
                           jnp.asarray(wo))
    ft, pt = tmat.eval_pdf((tmat.PLASTIC,), gt, torch.as_tensor(wi),
                           torch.as_tensor(wo))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4,
                               atol=1e-6)
    assert (pt.numpy() > 0).mean() > 0.5


def test_plastic_sample_matches_jax(plastic_tables):
    """Both lobes: the delta reflection (is_delta, weight F / p_spec
    times the specular tint) and the compensated diffuse."""
    gj, gt = plastic_tables
    wi = _dirs(3)
    rs = np.random.default_rng(4)
    u_lobe = rs.random(N).astype(np.float32)
    u2 = rs.random((N, 2)).astype(np.float32)
    u2b = rs.random((N, 2)).astype(np.float32)
    ref = jmat.sample((jmat.PLASTIC,), gj, jnp.asarray(wi),
                      jnp.asarray(u_lobe), jnp.asarray(u2), jnp.asarray(u2b))
    got = tmat.sample((tmat.PLASTIC,), gt, torch.as_tensor(wi),
                      torch.as_tensor(u_lobe), torch.as_tensor(u2),
                      torch.as_tensor(u2b))
    wo_j, w_j, p_j, d_j, e_j = (np.asarray(x) for x in ref)
    wo_t, w_t, p_t, d_t, e_t = (x.numpy() for x in got)
    np.testing.assert_array_equal(d_t, d_j)
    assert 0.02 < d_j.mean() < 0.5
    np.testing.assert_allclose(wo_t, wo_j, atol=2e-5)
    ok = p_j > 0
    np.testing.assert_array_equal(p_t > 0, ok)
    np.testing.assert_allclose(p_t[ok], p_j[ok], rtol=5e-4)
    np.testing.assert_allclose(w_t[ok], w_j[ok], rtol=5e-4, atol=1e-6)
    np.testing.assert_array_equal(e_t, e_j)


def test_fresnel_diffuse_reflectance_matches_jax():
    from hairpt.models.bsdf.fresnel import fresnel_diffuse_reflectance as fj
    from hairpt_torch.models.bsdf.fresnel import \
        fresnel_diffuse_reflectance as ft
    for eta in (1.5, 1 / 1.5, 1.33, 1.0):
        assert ft(eta) == fj(eta)


@pytest.mark.parametrize("kind", ["checkerboard", "gridtexture",
                                  "wireframe", "vertexcolors"])
def test_texture_kinds_match_jax(kind):
    """eval_checkerboard's procedural kinds on random uv (negative ones
    too), barycentrics and vertex colours, with untextured lanes
    (tex_id -1) keeping their base colour: equal to hairpt's."""
    rs = np.random.default_rng(["checkerboard", "gridtexture", "wireframe",
                                "vertexcolors"].index(kind))
    bj, bt = JSceneBuilder(), TSceneBuilder(device="cpu")
    for b in (bj, bt):
        if kind == "checkerboard":
            b.add_checkerboard((0.7, 0.6, 0.5), (0.1, 0.2, 0.3), 3.0, 5.0,
                               0.3, -0.2)
        elif kind == "gridtexture":
            b.add_gridtexture((0.2, 0.3, 0.4), (0.9, 0.8, 0.7), 0.08, 2.5,
                              1.5, 0.1, 0.7)
        elif kind == "wireframe":
            b.add_wireframe_texture((0.5, 0.5, 0.4), (0.1, 0.1, 0.2), 0.07)
        else:
            b.add_vertexcolor_texture()
    tex_t = tmat.pack_checkers(bt.checkers, device="cpu")
    mj = _jax_checkers(bj)
    uv = rs.uniform(-3, 3, (N, 2)).astype(np.float32)
    bary = rs.dirichlet((1, 1, 1), N)[:, 1:].astype(np.float32)
    vcol = rs.random((N, 3)).astype(np.float32)
    base = rs.random((N, 3)).astype(np.float32)
    tid = np.where(rs.random(N) < 0.2, -1, 0).astype(np.int32)
    ref = np.asarray(jmat.eval_checkerboard(
        mj, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(base),
        bary=jnp.asarray(bary), vcolor=jnp.asarray(vcol)))
    got = tmat.eval_checkerboard(
        tex_t, torch.as_tensor(tid), torch.as_tensor(uv),
        torch.as_tensor(base), torch.as_tensor(bary),
        torch.as_tensor(vcol)).numpy()
    np.testing.assert_array_equal(got, ref)
    # both colours (or the vertex colours) show up on textured lanes
    on = tid >= 0
    assert len(np.unique(got[on], axis=0)) >= 2


def _jax_checkers(bj):
    """hairpt's texture table as its SceneBuilder.build makes it."""
    c = bj.checkers
    z = np.zeros((len(c), 4, 4, 3), np.float32)
    return jmat.CheckerboardTable(
        kind=jnp.asarray([x[0] for x in c], jnp.int32),
        color0=jnp.asarray([x[1] for x in c], jnp.float32),
        color1=jnp.asarray([x[2] for x in c], jnp.float32),
        uv_scale=jnp.asarray([x[3] for x in c], jnp.float32),
        uv_offset=jnp.asarray([x[4] for x in c], jnp.float32),
        bitmaps=jnp.asarray(z),
        aux=jnp.asarray([(x[6] if len(x) > 6 else 0.01) for x in c],
                        jnp.float32),
        mips=jnp.zeros((len(c), 4, 4, 4, 3), jnp.float32))


# --- a hair scene with a mesh in it ----------------------------------------

RES = 32
# depth 2: the camera hit, its shadow ray and its bounce ray, all through
# both walks (hair and triangles). Deeper paths bounce off the fibers,
# whose normals the two packages' float32 roundings of the hit point move
# by up to 0.5% (radius 0.0069), and then diverge: measured at depth 3,
# 1.7-1.9% of pixel values differ past 1e-3 + 1e-4, the image means
# within 1.6e-5
FLOOR_DEPTH = 2


def _jax_furball_floor(res):
    """tfur.furball_floor_scene through hairpt's SceneBuilder (its CPU
    default traversal, the packed walk for hair and triangles)."""
    b = JSceneBuilder()
    m = b.add_material(**tfur.MATERIALS["roughplastic"])
    tex = b.add_checkerboard(**tfur.FLOOR_CHECKER)
    floor = b.add_material(kind=jmat.DIFFUSE, twosided=True, tex_id=tex)
    b.add_mesh(jshp.rectangle(), floor, to_world=tfur.FLOOR_TO_WORLD)
    b.add_fibers(jh.gen_furball(n_fibers=600,
                                radius=0.00216667 / np.sqrt(0.1)), m)
    b.env = jem.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                            sky_scale=5.0, sun_scale=19.0912,
                            sun_radius_scale=37.9165, res=256)
    cam = JCamera.perspective(tfur.CAM_TO_WORLD, 35.0, res, res)
    m_res = max(1, int(np.ceil(np.log2(res))))
    return b.build(cam, JFilm.make(res, res, "tent"), spp=1,
                   max_depth=FLOOR_DEPTH,
                   sampler=(jrng.SOBOL_QMC, m_res, res), swept_k=128)


@pytest.fixture(scope="module")
def floor_renders():
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", tbvh._load_native())
    mp.setattr(jbvh, "_NATIVE_TRIED", True)
    js = _jax_furball_floor(RES)
    assert js.config.traversal == "packed"
    img_j = np.asarray(jpath.render(js, spp=2))
    imgs = {trav: tpath.render(tfur.furball_floor_scene(
        quality=0.1, res=RES, depth=FLOOR_DEPTH, device="cpu",
        traversal=trav), spp=2).numpy() for trav in ("tiled", "packed")}
    mp.undo()
    return img_j, imgs


@pytest.mark.parametrize("trav", ["tiled", "packed"])
def test_furball_floor_render_matches_jax(floor_renders, trav):
    """The port's render (hair through the tiled traversal or the packed
    walk, the rectangle through the packed walk) against hairpt's packed
    render: the image mean within 1e-3 relative and >= 99% of pixel
    values within 1e-3 relative + 1e-4 (tests/test_torch_cli.py's
    bounds)."""
    img_j, imgs = floor_renders
    img_t = imgs[trav]
    assert img_t.shape == img_j.shape and img_j.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 1e-3
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()


def test_textured_rows_take_no_diffuse_gradient():
    """The differentiable mode on the furball over the checkerboard: the
    fur's diffuse reflectance gets a gradient, the floor's none (its
    checkerboard replaces the table's diffuse on every floor lane)."""
    s = tfur.furball_floor_scene(quality=0.1, res=16, depth=3, device="cpu")
    mt = s.arrays.materials
    diffuse = mt.diffuse.clone().requires_grad_()
    arr = s.arrays._replace(materials=mt._replace(diffuse=diffuse))
    n = 16 * 16
    rad, _, _ = tpath.make_li_fn(s, differentiable=True)(
        arr, torch.arange(n), torch.zeros(n, dtype=torch.int64))
    rad.mean().backward()
    g = diffuse.grad
    assert torch.isfinite(g).all() and g[0].abs().sum() > 0
    assert g[1].abs().sum() == 0
