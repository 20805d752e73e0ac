"""The motion-vector integrator of hairpt_torch (integrators/motion.py,
the motion tables of scene.py, the loader's and convert's share of them,
the CLI's --integrator motion) against hairpt's on the CPU: the scenes
of tests/test_motion.py at W = 32 (object and camera translation with
'd', the mirror with 'rd', the thin glass with 'ttd'), built by hairpt's
SceneBuilder and carried across with convert, and the XML motion
stand-in (no hair, 2 x 2 animated instances) through both loaders.

Bounds: the +inf (untrackable) pixels equal, the finite pixels within
1e-3 px (and 1e-3 in the distance channel). The chain configs' Newton
iterations run on float32 image positions, whose last bits differ
between XLA's and torch's arithmetic; 1e-3 px is three orders below the
tests' own motion."""
import jax
import numpy as np
import pytest
import torch

from hairpt.film.film import Film as JFilm
from hairpt.integrators import motion as jmotion
from hairpt.models import shapes as jshp
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.ops import bvh as jbvh
from hairpt.scene import xml_loader as jxl
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import cli, convert
from hairpt_torch.integrators import motion as tmotion
from hairpt_torch.models import shapes as tshp
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.scene.scene import SceneBuilder
from torch_threads import one_thread  # noqa: F401

W = 32
PX_TOL = 1e-3


def _translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def _scaled(z, s):
    m = _translate([0, 0, z])
    m[0, 0] = m[1, 1] = s
    return m


def _build(b, depth):
    cam = JCamera.perspective(np.eye(4), 90.0, W, W)
    js = b.build(cam, JFilm.make(W, W, "box"), spp=1, max_depth=depth,
                 traversal="packed")
    return js, convert.convert_scene(
        js, jax.tree_util.tree_map(np.asarray, js.arrays), device="cpu")


def quad(motion=None, camera1=None):
    b = JSceneBuilder()
    mid = b.add_material(kind=jmat.DIFFUSE, diffuse=(0.5, 0.5, 0.5))
    b.add_mesh(jshp.rectangle(), mid, to_world=_translate([0, 0, 3.0]),
               motion=motion)
    if camera1 is not None:
        b.camera1 = JCamera.perspective(camera1, 90.0, W, W)
    return _build(b, 2)


def mirror():
    b = JSceneBuilder()
    m = b.add_material(kind=jmat.CONDUCTOR, diffuse=(1.0, 1.0, 1.0))
    d = b.add_material(kind=jmat.DIFFUSE, diffuse=(0.5, 0.5, 0.5))
    b.add_mesh(jshp.rectangle(), m, to_world=_scaled(3.0, 3.0))
    b.add_mesh(jshp.rectangle(), d, to_world=_translate([0, 0, -2.0]),
               motion=_translate([0.4, 0, 0]))
    return _build(b, 3)


def glass(ior=1.5):
    b = JSceneBuilder()
    d = b.add_material(kind=jmat.DIFFUSE, diffuse=(0.5, 0.5, 0.5))
    g = b.add_material(kind=jmat.DIELECTRIC, eta=ior)
    for z in (1.4, 1.6):
        b.add_mesh(jshp.rectangle(), g, to_world=_scaled(z, 3.0))
    b.add_mesh(jshp.rectangle(), d, to_world=_scaled(3.0, 2.0),
               motion=_translate([0.3, 0, 0]))
    return _build(b, 4)


CASES = {
    "object_d": (lambda: quad(motion=_translate([0.3, 0, 0])), "d"),
    "camera_d": (lambda: quad(camera1=_translate([0.4, 0, 0])), "d"),
    "mirror_rd": (mirror, "rd"),
    "glass_ttd": (glass, "ttd"),
}


def _agree(img_t, img_j, min_finite=0.05, edge=None):
    """+inf pixels equal, finite ones within PX_TOL. edge [H, W] bool:
    pixels whose rays meet a quad's shared triangle edge, where hairpt's
    triangle test may let the ray slip between the two triangles and
    the port's hits (hairpt's pixel +inf, the port's finite)."""
    img_t = img_t.numpy() if torch.is_tensor(img_t) else np.asarray(img_t)
    img_j = np.asarray(img_j)
    assert img_t.shape == img_j.shape
    fin_t, fin_j = np.isfinite(img_t), np.isfinite(img_j)
    assert (img_j[~fin_j] == np.inf).all() and (img_t[~fin_t] == np.inf).all()
    if edge is not None:
        slip = edge[..., None] & fin_t & ~fin_j
        assert slip.all(-1).sum() <= edge.sum()
        fin_j = fin_j | slip
        img_j = np.where(slip, img_t, img_j)
    np.testing.assert_array_equal(fin_t, fin_j)
    assert fin_j.all(-1).mean() >= min_finite, fin_j.mean()
    np.testing.assert_allclose(img_t[fin_t], img_j[fin_j], rtol=0,
                               atol=PX_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_motion_matches_jax(case):
    make, config = CASES[case]
    js, cs = make()
    img_j = jmotion.render_motion(js, config=config)
    img_t = tmotion.render_motion(cs, config=config)
    # the chain configs' rays on the image diagonal meet the centred
    # quads' diagonals (tests/test_motion.py: "the exact centre ray grazes
    # the quad triangles' shared diagonal and can slip between them")
    _agree(img_t, img_j, min_finite=0.01 if config == "rd" else 0.05,
           edge=np.eye(W, dtype=bool) if config != "d" else None)
    if case == "object_d":
        v = img_t[W // 2, W // 2].numpy()
        assert abs(v[0] - (-0.5 * W * 0.3 / 3.0)) < 1e-2


def test_motion_config_from_the_scene():
    """render_motion's config defaults to RenderConfig.motion_config."""
    import dataclasses
    _, cs = mirror()
    cs_rd = cs._replace(config=dataclasses.replace(cs.config,
                                                   motion_config="rd"))
    np.testing.assert_array_equal(tmotion.render_motion(cs_rd).numpy(),
                                  tmotion.render_motion(cs, config="rd")
                                  .numpy())


def test_advance_clamps_prims_as_jax():
    """_advance on hair, triangle and out-of-table (instance) prims:
    hairpt's gather clamps the index into tri_obj, the port's too."""
    from types import SimpleNamespace
    import jax.numpy as jnp
    js, cs = quad(motion=_translate([0.3, 0, 0]))
    n_tri = int(cs.motion.tri_obj.shape[0])
    prim = np.array([-1, 0, n_tri - 1, n_tri, n_tri + 40], np.int32)
    hair = np.array([False, False, False, False, True])
    p = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    hj = SimpleNamespace(prim=jnp.asarray(prim), is_hair=jnp.asarray(hair),
                         p=jnp.asarray(p))
    ht = SimpleNamespace(prim=torch.as_tensor(prim),
                         is_hair=torch.as_tensor(hair), p=torch.as_tensor(p))
    want = np.asarray(jmotion._advance(js.motion, hj))
    got = tmotion._advance(cs.motion, ht).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_convert_carries_the_motion_tables():
    """convert_scene carries tri_obj, obj_m and the camera at the target
    time across."""
    js, cs = quad(motion=_translate([0.3, 0, 0]),
                  camera1=_translate([0.1, 0.2, 0]))
    np.testing.assert_array_equal(cs.motion.tri_obj.numpy(),
                                  np.asarray(js.motion.tri_obj))
    np.testing.assert_array_equal(cs.motion.obj_m.numpy(),
                                  np.asarray(js.motion.obj_m))
    np.testing.assert_array_equal(cs.motion.cam1.to_world,
                                  np.asarray(js.motion.cam1.to_world))
    assert cs.motion.cam1.tan_half_fov == cs.camera.tan_half_fov


def test_builder_motion_tables_match_jax():
    """add_mesh(motion=) and camera1 build the same tables on both
    sides (the triangles' object ids in BVH order)."""
    tb = SceneBuilder(device="cpu")
    jb = JSceneBuilder()
    for b, shp in ((tb, tshp), (jb, jshp)):
        m = b.add_material()
        b.add_mesh(shp.rectangle(), m, to_world=_translate([0, 0, 3.0]))
        b.add_mesh(shp.sphere(0.5, 8, 12), m, motion=_translate([1, 2, 3]))
    from hairpt_torch.film.film import Film
    from hairpt_torch.models.sensors import Camera
    ts = tb.build(Camera.perspective(np.eye(4), 90.0, 8, 8),
                  Film.make(8, 8, "box"), spp=1)
    jsc = jb.build(JCamera.perspective(np.eye(4), 90.0, 8, 8),
                   JFilm.make(8, 8, "box"), spp=1)
    assert jsc.motion is not None and ts.motion is not None
    np.testing.assert_array_equal(ts.motion.obj_m.numpy(),
                                  np.asarray(jsc.motion.obj_m))
    # object ids by triangle: compared through each triangle's first
    # vertex (the two BVH builds may order the triangles differently)
    def by_tri(obj, p0):
        rows = np.concatenate([np.asarray(p0, np.float64),
                               np.asarray(obj, np.float64)[:, None]], 1)
        return rows[np.lexsort(rows.T[::-1])]
    np.testing.assert_allclose(
        by_tri(ts.motion.tri_obj.numpy(), ts.arrays.tri.p0.numpy()),
        by_tri(np.asarray(jsc.motion.tri_obj), jsc.arrays.tri.p0),
        atol=1e-6)
    assert np.array_equal(ts.motion.cam1.to_world, ts.camera.to_world)


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The motion stand-in (no hair, 2 x 2 animated instances, 24^2)
    through both loaders, the hair-free BVHs built by one library."""
    d = str(tmp_path_factory.mktemp("mv"))
    xml = scene_xmls.write_scene(d, "motion", hair=False, res=24, depth=3,
                                 grid=2)
    old = jbvh._NATIVE, jbvh._NATIVE_TRIED
    jbvh._NATIVE, jbvh._NATIVE_TRIED = tbvh._load_native(), True
    try:
        js = jxl.load_scene(xml)
    finally:
        jbvh._NATIVE, jbvh._NATIVE_TRIED = old
    return xml, txl.load_scene(xml, device="cpu"), js


def test_loaders_build_the_same_motion_tables(standin):
    _, ts, js = standin
    assert ts.motion is not None and js.motion is not None
    np.testing.assert_allclose(ts.motion.obj_m.numpy(),
                               np.asarray(js.motion.obj_m), atol=1e-6)
    np.testing.assert_array_equal(ts.motion.tri_obj.numpy(),
                                  np.asarray(js.motion.tri_obj))
    np.testing.assert_allclose(ts.motion.cam1.to_world,
                               np.asarray(js.motion.cam1.to_world),
                               atol=1e-6)
    assert ts.config.motion_config == js.config.motion_config == "d"


def test_standin_motion_matches_jax(standin):
    """The stand-in's motion vectors ('d': the animated camera, the
    moving teapot, the deformable pair and the instances, whose hits
    take the table's clamped row in both packages) through each
    package's loader."""
    _, ts, js = standin
    img_j = jmotion.render_motion(js)
    img_t = tmotion.render_motion(ts)
    _agree(img_t, img_j)


@pytest.mark.parametrize("how", ["flag", "xml"])
def test_cli_renders_motion(standin, tmp_path, how):
    """--integrator motion, or an XML whose integrator is motion with a
    `time` of 0.5: the image the CLI writes is render_motion's of the
    loaded scene, +inf pixels included."""
    xml, ts, _ = standin
    if how == "xml":
        src = open(xml).read()
        i0 = src.index("<integrator")
        i1 = src.index("</integrator>") + len("</integrator>")
        src = src[:i0] + ("<integrator type=\"motion\"><float name=\"time\" "
                          "value=\"0.5\"/></integrator>") + src[i1:]
        xml = str(tmp_path / "m.xml")
        import os
        import shutil
        for f in ("teapot.obj", "sphere0.obj", "sphere1.obj"):
            shutil.copy(os.path.join(os.path.dirname(standin[0]), f),
                        tmp_path / f)
        with open(xml, "w") as fh:
            fh.write(src)
        ts = txl.load_scene(xml, device="cpu")
        assert ts.config.integrator == "motion"
    out = tmp_path / "o.exr"
    args = ["render", xml, "-o", str(out), "--cpu"]
    if how == "flag":
        args += ["--integrator", "motion"]
    assert cli.main(args) == 0
    img = np.load(tmp_path / "o.npy")
    ref = tmotion.render_motion(ts).numpy()
    np.testing.assert_array_equal(img, ref)
    assert np.isinf(img).any() and np.isfinite(img).any()
