"""Motion blur in the port against hairpt on the CPU: the keyframe
interpolation (core/track.py), both loaders on the motion stand-in
(hairpt_torch.scene.scene_xmls.motion: an animated camera, a moving
mesh, a deformable pair and animated instances under the shutter
[0, 1]), the triangles rebuilt per shutter time against a fresh build,
open-shutter renders against hairpt's, a closed shutter against the
static scene, a resumed render, and convert's handling of the shutter.

hairpt rebuilds its whole scene at each shutter time, and its wave
recompiles where the rebuilt triangle tree changes size. The render
comparison therefore uses the stand-in's `swing` variant at spp 2: its
triangles are the same at times 1/4 and 3/4 (one compile), while the
camera and the instances move."""
import os

import jax
import numpy as np
import pytest
import torch

from hairpt.core import track as jtrack
from hairpt.integrators import path as jpath
from hairpt.models.sensors import Camera as JCamera
from hairpt.film.film import Film as JFilm
from hairpt.ops import bvh as jbvh
from hairpt.scene import xml_loader as jxl
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt.models import shapes as jshp
from hairpt_torch import convert
from hairpt_torch.core import track as ttrack
from hairpt_torch.film.film import Film
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models import emitters as tem
from hairpt_torch.models import shapes as tshp
from hairpt_torch.models.sensors import Camera
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import hairgen as th
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.scene.scene import SceneBuilder
from torch_threads import one_thread  # noqa: F401

# loader and rebuild comparisons: 1e-6 (float32 rounding of float64
# poses); the keyframe interpolation in float64: 1e-12
POSE_TOL = 1e-6
TRACK_TOL = 1e-12
SMALL = dict(res=24, depth=3, grid=2)


def _m4(scale=(1.0, 1.0, 1.0), axis=(0.0, 1.0, 0.0), angle=0.0,
        t=(0.0, 0.0, 0.0)):
    """A 4 x 4 transform: scale, then a rotation, then a translation."""
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = np.cos(np.radians(angle)), np.sin(np.radians(angle))
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    r = np.eye(3) * c + s * k + (1 - c) * np.outer(a, a)
    m = np.eye(4)
    m[:3, :3] = r @ np.diag(scale)
    m[:3, 3] = t
    return m


TRACKS = {
    "two": [(0.0, _m4((1, 2, 1), (0, 1, 0), 10, (1, 2, 3))),
            (1.0, _m4((2, 1, 1), (1, 1, 0), 80, (-1, 0, 5)))],
    "three": [(0.5, _m4(angle=170, t=(0, 1, 0))),
              (-1.0, _m4((1, 1, -1), (0, 0, 1), 45)),
              (2.0, _m4((0.5, 0.5, 0.5), (1, 0, 1), -120, (3, 3, 3)))],
    "near": [(0.0, _m4(angle=5.0)), (1.0, _m4(angle=5.01))],
    "one": [(0.25, _m4((3, 3, 3), (1, 2, 3), 33, (1, 1, 1)))],
}
TIMES = (-3.0, -1.0, -0.4, 0.0, 0.1, 0.25, 0.5, 0.77, 1.0, 1.9, 2.0, 7.0)


@pytest.mark.parametrize("case", sorted(TRACKS))
def test_animated_transform_matches_jax(case):
    """AnimatedTransform.eval against hairpt's at the keyframes, between
    them and outside them (clamped), float64 within TRACK_TOL; and
    from_tracks (a copy of the decomposed keyframes) evaluates the
    same."""
    j = jtrack.AnimatedTransform(TRACKS[case])
    t = ttrack.AnimatedTransform(TRACKS[case])
    c = ttrack.AnimatedTransform.from_tracks(j.times, j.tr)
    for time in TIMES + tuple(k for k, _ in TRACKS[case]):
        ref = j.eval(time)
        np.testing.assert_allclose(t.eval(time), ref, rtol=0,
                                   atol=TRACK_TOL, err_msg=str(time))
        np.testing.assert_array_equal(c.eval(time), t.eval(time))


def test_quaternion_helpers_match_jax():
    """mat_to_quat (both branches of the trace), quat_to_mat, slerp and
    decompose (a mirrored rotation) against hairpt's."""
    rs = np.random.default_rng(4)
    for k in range(40):
        m = _m4(rs.uniform(0.5, 2, 3), rs.normal(size=3),
                rs.uniform(-180, 180), rs.normal(size=3))
        if k % 5 == 0:
            m[:3, 0] *= -1
        for a, b in zip(ttrack.decompose(m), jtrack.decompose(m)):
            np.testing.assert_allclose(a, b, rtol=0, atol=TRACK_TOL)
        q = ttrack.mat_to_quat(m[:3, :3] / np.linalg.norm(m[:3, :3], axis=0))
        np.testing.assert_allclose(
            q, jtrack.mat_to_quat(m[:3, :3] / np.linalg.norm(m[:3, :3],
                                                             axis=0)),
            atol=TRACK_TOL)
        np.testing.assert_allclose(ttrack.quat_to_mat(q),
                                   jtrack.quat_to_mat(q), atol=TRACK_TOL)
        q2 = ttrack.mat_to_quat(_m4(axis=rs.normal(size=3),
                                    angle=rs.uniform(-179, 179))[:3, :3])
        for f in (0.0, 0.3, 1.0):
            np.testing.assert_allclose(ttrack.slerp(q, q2, f),
                                       jtrack.slerp(q, q2, f),
                                       atol=TRACK_TOL)


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The motion stand-in without its hair (24^2, depth 3, 2 x 2
    instances) through both loaders."""
    d = str(tmp_path_factory.mktemp("motion"))
    xml = scene_xmls.write_scene(d, "motion", hair=False, **SMALL)
    return txl.load_scene(xml, device="cpu"), jxl.load_scene(xml)


def _tris(tri, mat_id):
    """The triangles as rows (v0, v1, v2, material) sorted
    lexicographically: comparable whatever the BVH's prim order."""
    p0 = np.asarray(tri.p0, np.float64)
    rows = np.concatenate([p0, p0 + np.asarray(tri.e1, np.float64),
                           p0 + np.asarray(tri.e2, np.float64),
                           np.asarray(mat_id, np.float64)[:, None]], 1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("t_s", [0.125, 0.375, 0.625, 0.875])
def test_loaders_agree_on_the_motion_standin(standin, t_s):
    """At each of the four shutter times of spp 4: the shutter, the
    camera's pose, the instance table after repose_inst and the
    triangles after rebuild_geo (compared as sorted rows, so the BVH's
    prim order does not matter) within POSE_TOL; every other array of
    the rebuild is the build's own object."""
    ts, js = standin
    assert ts.shutter == tuple(js.shutter) == (0.0, 1.0)
    np.testing.assert_allclose(ts.camera.to_world,
                               np.asarray(js.camera.to_world), atol=POSE_TOL)
    np.testing.assert_allclose(ts.camera_anim.eval(t_s),
                               js.camera_anim.eval(t_s), atol=POSE_TOL)
    ti = ts.repose_inst(ts.arrays, t_s).inst
    ji = js.repose_inst(js.arrays, t_s).inst
    assert len(ti.proto_ids) == len(ji.w2o) == 4
    for f in ("w2o", "aabb_lo", "aabb_hi"):
        a = getattr(ti, f).numpy()
        b = np.asarray(getattr(ji, f), np.float32)[:, :a.shape[1]]
        np.testing.assert_allclose(a, b, atol=POSE_TOL, err_msg=f)
    assert not np.allclose(ti.w2o.numpy(), ts.arrays.inst.w2o.numpy())
    ta, ja = ts.rebuild_geo(t_s), js.rebuild_geo(t_s)
    got = _tris(ta.tri, ta.tri_shading.mat_id)
    ref = _tris(ja.tri, np.asarray(ja.tri_shading.mat_id))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=POSE_TOL)
    assert not np.allclose(got, _tris(ts.arrays.tri,
                                      ts.arrays.tri_shading.mat_id))
    for f in ("hair", "hair_packed", "hair_swept", "hair_bvh", "materials",
              "checkers", "env", "inst"):
        assert getattr(ta, f) is getattr(ts.arrays, f), f


def _builder(meshes_at=None):
    """A scene of a deformable pair, an animated teapot, a static floor
    and a few fibers; meshes_at=(t, build) gives instead the static
    scene whose meshes are those of `build`'s rebuild rules at time t,
    each added as a plain world-space mesh."""
    b = SceneBuilder(device="cpu")
    m = b.add_material()
    sph = tshp.sphere(1.0, 8, 16)
    sph1 = sph._replace(positions=sph.positions * np.array([1.3, 0.7, 1.3]))
    move = _m4(t=(0.0, 0.0, 3.0))
    anim = ttrack.AnimatedTransform([(0.0, _m4(t=(-2, 0, 0))),
                                     (1.0, _m4((1, 1, 1), (0, 1, 0), 30,
                                               (-1, 0.5, 0)))])
    tea = tshp.compute_smooth_normals(tshp.teapot_standin(0.5))
    if meshes_at is None:
        b.add_morph_mesh(sph, sph1, m, to_world=move, time=0.0)
        b.add_mesh(tea, m, to_world=anim.eval(0.0))
        b.animated_meshes[1] = anim
        b.shutter = (0.0, 1.0)
    else:
        t, ref = meshes_at
        w0, w1 = ref.morph_meshes[0]
        b.add_mesh(tshp.lerp_mesh(w0, w1, float(np.clip(t, 0, 1))), m)
        rel = anim.eval(t) @ np.linalg.inv(anim.eval(0.0))
        b.add_mesh(tshp.transform_mesh(ref.tri_meshes[1][0], rel), m)
    b.add_mesh(tshp.rectangle(), m, to_world=_m4((5, 5, 5), (1, 0, 0), -90))
    b.add_fibers(th.gen_furball(n_fibers=20, n_segs=4, radius=0.02,
                                center=(0, 1, 0), core_r=0.3,
                                fiber_len=0.4), m)
    b.env = tem.make_constant((0.8, 0.8, 0.8), device="cpu")
    return b


def _build(b):
    cam = Camera.perspective(_m4(t=(0.0, 1.0, -8.0)), 40.0, 16, 16)
    return b.build(cam, Film.make(16, 16, "tent"), spp=2, max_depth=3,
                   traversal="packed")


def _bits(a, b, path):
    if hasattr(a, "_fields"):
        for f in a._fields:
            _bits(getattr(a, f), getattr(b, f), f"{path}.{f}")
        return
    assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                       b.view(torch.int32) if b.is_floating_point() else b),\
        path


@pytest.mark.parametrize("t", [-0.5, 0.3, 1.0, 1.7])
def test_rebuild_equals_a_fresh_build(t):
    """rebuild_geo(t) against a fresh build of the meshes posed at t (the
    morph re-lerped at clip(t, 0, 1), the animated mesh moved by
    anim(t) inv(anim(open)), the track clamped outside its keyframes):
    the triangle block bit for bit; every other array is the build's
    own object."""
    b = _builder()
    s = _build(b)
    got = s.rebuild_geo(t)
    ref = _build(_builder((t, b))).arrays
    for f in ("tri", "tri_shading", "tri_packed", "tri_bvh"):
        _bits(getattr(got, f), getattr(ref, f), f)
    for f in ("hair", "hair_mat_id", "hair_packed", "hair_swept", "hair_bvh",
              "materials", "env"):
        assert getattr(got, f) is getattr(s.arrays, f), f
    assert s.repose_inst is None and s.camera_anim is None


def test_closed_shutter_renders_like_the_static_scene():
    """With close == open the animation is never evaluated: the render
    equals, bit for bit, that of the same scene with no animation, at
    every sample; with the shutter open it does not."""
    b = _builder()
    s = _build(b)
    static = s._replace(rebuild_geo=None, shutter=(0.0, 0.0))
    ref = tpath.render(static, spp=2)
    closed = tpath.render(s._replace(shutter=(0.5, 0.5)), spp=2)
    assert float(ref.mean()) > 0 and torch.equal(closed, ref)
    assert not torch.equal(tpath.render(s, spp=2), ref)


def test_resumed_render_keeps_its_shutter_times(tmp_path):
    """A render stopped after its first wave and resumed from its
    checkpoint equals the uninterrupted render bit for bit: sample s
    keeps t_s."""
    s = _build(_builder())
    ref = tpath.render(s, spp=2)
    ck = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def stop(done, *a):
        raise Stop()
    with pytest.raises(Stop):
        tpath.render(s, spp=2, checkpoint=ck, progress=stop)
    assert int(np.load(ck)["next_sample"]) == 1
    assert torch.equal(tpath.render(s, spp=2, checkpoint=ck), ref)


def test_open_shutter_render_matches_jax(monkeypatch, tmp_path):
    """The stand-in's swing variant (no hair, 2 x 2 instances, 24^2,
    depth 3, Sobol', spp 2: two shutter times, the camera, the teapot's
    swing and the instances moving) through the port's loader and render
    against hairpt's, with the mesh tests' bounds: the image mean within
    1e-3 relative and >= 99% of pixel values within 1e-3 relative +
    1e-4; and the port's image differs from its closed-shutter render."""
    monkeypatch.setattr(jbvh, "_NATIVE", tbvh._load_native())
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)
    xml = scene_xmls.write_scene(str(tmp_path), "motion", hair=False,
                                 swing=True, spp=2, **SMALL)
    js = jxl.load_scene(xml)
    ts = txl.load_scene(xml, device="cpu")
    assert js.rebuild_geo(0.25).tri.p0.shape == js.rebuild_geo(0.75) \
        .tri.p0.shape
    img_j = np.asarray(jpath.render(js, spp=2))
    img_t = tpath.render(ts, spp=2).numpy()
    assert img_t.shape == img_j.shape == (24, 24, 3) and img_j.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 1e-3
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()
    still = tpath.render(ts._replace(shutter=(0.0, 0.0)), spp=2).numpy()
    assert np.abs(still - img_t).max() > 1e-2


def test_convert_carries_the_shutter_and_animations(standin):
    """convert_scene carries an animated camera and animated instances
    across (their poses equal hairpt's at a shutter time), and raises on
    hairpt's rebuild_geo under an open shutter: it is a closure over
    hairpt's SceneBuilder."""
    _, js = standin
    with pytest.raises(NotImplementedError, match="rebuild_geo"):
        convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                         js.arrays),
                              device="cpu")
    b = JSceneBuilder()
    m = b.add_material()
    p = b.add_prototype(jshp.cube(), m)
    anim = jtrack.AnimatedTransform(TRACKS["two"])
    b.add_instance(p, anim.eval(0.0), anim=anim)
    b.add_instance(p, np.eye(4))
    b.shutter = (0.0, 1.0)
    b.camera_anim = jtrack.AnimatedTransform(TRACKS["three"])
    jsc = b.build(JCamera.perspective(np.eye(4), 40.0, 8, 8),
                  JFilm.make(8, 8, "tent"), spp=1)
    cs = convert.convert_scene(jsc, jax.tree_util.tree_map(np.asarray,
                                                           jsc.arrays),
                               device="cpu")
    assert cs.shutter == (0.0, 1.0) and cs.rebuild_geo is None
    for t in (0.2, 0.9):
        np.testing.assert_array_equal(cs.camera_anim.eval(t),
                                      jsc.camera_anim.eval(t))
        got = cs.repose_inst(cs.arrays, t).inst
        ref = jsc.repose_inst(jsc.arrays, t).inst
        np.testing.assert_allclose(got.w2o.numpy(),
                                   np.asarray(ref.w2o)[:, :3],
                                   atol=POSE_TOL)
        np.testing.assert_allclose(got.aabb_lo.numpy(),
                                   np.asarray(ref.aabb_lo), atol=POSE_TOL)


def test_standin_files(tmp_path):
    """write_scene writes the stand-in's meshes beside its XML, and the
    XML is the reference syntax hairpt's validator takes."""
    from hairpt_torch.scene import xml_validate as txv
    import xml.etree.ElementTree as ET
    xml = scene_xmls.write_scene(str(tmp_path), "motion")
    d = os.path.dirname(xml)
    for f in ("teapot.obj", "sphere0.obj", "sphere1.obj"):
        assert os.path.getsize(os.path.join(d, f)) > 0
    root = ET.parse(xml).getroot()
    txv.validate(root, xml)
    assert len(root.findall("shape[@type='instance']")) == 16
    assert len(root.find("sensor").find("animation")) == 2
