"""Area and delta lights in the port against hairpt, on the CPU: the
delta-light table and its sampler for each kind, the area-light table of
a scene build (and carried across by convert_scene), NEE's emitter
sampling and the BSDF-hit pdf with every source kind present, a small
render lit by all three kinds, a point light's analytic floor, PRB
against the differentiable mode with an area light, the two loaders on
one XML with every emitter, and an emissive mesh under an open shutter
whose area table follows rebuild_geo.

Each JAX function is traced at most once: the render is hairpt's packed
traversal (no Pallas kernel), the rest runs eagerly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core import rng as jrng
from hairpt.core.math import matrix_lookat as jlookat
from hairpt.film.film import Film as JFilm
from hairpt.integrators import common as jcommon
from hairpt.integrators import path as jpath
from hairpt.models import emitters as jem
from hairpt.models import shapes as jshp
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.ops import bvh as jbvh
from hairpt.scene import xml_loader as jxl
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import convert
from hairpt_torch.core import rng as trng
from hairpt_torch.core.math import matrix_lookat as tlookat
from hairpt_torch.core.track import AnimatedTransform
from hairpt_torch.film.film import Film as TFilm
from hairpt_torch.integrators import common as tcommon
from hairpt_torch.integrators import inverse as tinv
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models import emitters as tem
from hairpt_torch.models import shapes as tshp
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.models.sensors import Camera as TCamera
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.scene.scene import SceneBuilder as TSceneBuilder
from torch_threads import one_thread  # noqa: F401

RES = 32
DEPTH = 4
SPP = 4
# the delta lights of the lit mesh scene, one of each kind
DELTA = [
    dict(kind=jem.POINT, position=(-2.0, 2.5, 1.0), intensity=(8, 7, 6)),
    dict(kind=jem.SPOT, position=(1.5, 4.0, -2.0),
         direction=(-0.3, -1.0, 0.5), intensity=(30, 30, 36),
         cutoff_deg=30.0, beam_deg=20.0),
    dict(kind=jem.DIRECTIONAL, direction=(0.3, -1.0, 0.2),
         intensity=(0.4, 0.35, 0.3)),
    dict(kind=jem.COLLIMATED, position=(0.0, 3.0, 0.0),
         direction=(0.0, -1.0, 0.0), intensity=(50, 50, 50)),
]
LIGHT_RTOL = 1e-6      # the delta-light sampler (the same f32 arithmetic)
NEE_RTOL = 1e-5        # NEE's sampler and pdf (square roots, searchsorted)
# a first call's bound, of each output's largest value: 2x the largest
# first-call error of torch's CPU sin seen (1.4e-4, ROADMAP Queue C)
FIRST_CALL_ATOL = 3e-4


@pytest.fixture
def same_bvh(monkeypatch):
    """hairpt's scene build on the port's SAH library (tests/
    test_torch_xml.py)."""
    lib = tbvh._load_native()
    assert lib is not None
    monkeypatch.setattr(jbvh, "_NATIVE", lib)
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)


def _lit_meshes(b, shp, mat, env, cam_cls, lookat, film_cls, sampler,
                res=RES, depth=DEPTH):
    """The lit mesh scene through either package's builder: a diffuse
    floor, a plastic cube, an emissive rectangle above (facing down) and
    an emissive sphere beside it, the four delta lights and a dim
    constant environment."""
    floor = b.add_material(kind=mat.DIFFUSE, diffuse=(0.6, 0.55, 0.5),
                           twosided=True)
    box = b.add_material(kind=mat.PLASTIC, diffuse=(0.2, 0.4, 0.7))
    dark = b.add_material(kind=mat.DIFFUSE, diffuse=(0.05, 0.05, 0.05))
    rot = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], float)
    m = np.eye(4)
    m[:3, :3] = rot @ np.diag([6.0, 6.0, 1.0])
    b.add_mesh(shp.rectangle(), floor, to_world=m)
    m = np.eye(4)
    m[:3, :3] *= 0.6
    m[:3, 3] = (0.0, 0.6, 0.0)
    b.add_mesh(shp.cube(), box, to_world=m)
    m = np.eye(4)
    m[:3, :3] = np.diag([1.2, 1.2, 1.0]) @ np.array(
        [[1, 0, 0], [0, 0, 1], [0, -1, 0]], float).T
    m[:3, 3] = (0.0, 3.0, 0.5)
    b.add_mesh(shp.rectangle(), dark, to_world=m, radiance=(5.0, 4.5, 4.0))
    m = np.eye(4)
    m[:3, 3] = (2.0, 1.0, 1.0)
    b.add_mesh(shp.sphere(0.4), dark, to_world=m, radiance=(2.0, 3.0, 4.0))
    for e in DELTA:
        b.delta_lights.append(dict(e))
    b.env = env
    cam = cam_cls.perspective(lookat((0.0, 3.0, -7.0), (0.0, 0.7, 0.0),
                                     (0.0, 1.0, 0.0)), 45.0, res, res)
    m_res = max(1, int(np.ceil(np.log2(res))))
    return b.build(cam, film_cls.make(res, res, "tent"), spp=1,
                   max_depth=depth, sampler=(sampler, m_res, res))


def _jax_lit(**kw):
    return _lit_meshes(JSceneBuilder(), jshp, jmat, jem.make_constant(
        (0.1, 0.1, 0.12)), JCamera, jlookat, JFilm, jrng.SOBOL_QMC, **kw)


def _torch_lit(**kw):
    return _lit_meshes(TSceneBuilder(device="cpu"), tshp, tmat,
                       tem.make_constant((0.1, 0.1, 0.12), device="cpu"),
                       TCamera, tlookat, TFilm, trng.SOBOL_QMC, **kw)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tables_equal(a, b, name):
    """Two NamedTuples of arrays, field for field, bit for bit."""
    assert (a is None) == (b is None), name
    if a is None:
        return
    assert type(a)._fields == type(b)._fields, name
    for f in type(a)._fields:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (name, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f}")


@pytest.fixture(scope="module")
def lit_pair():
    """hairpt's lit mesh scene (its CPU default: the packed walk) and the
    port's copy of it (convert_scene)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", tbvh._load_native())
    mp.setattr(jbvh, "_NATIVE_TRIED", True)
    js = _jax_lit()
    ts = _torch_lit()
    mp.undo()
    cs = convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    return js, ts, cs


# --- the delta lights ------------------------------------------------------

@pytest.mark.parametrize("kind", ["point", "spot", "directional",
                                  "collimated"])
def test_delta_lights_match_jax(kind):
    """make_delta_lights (two lights of the kind, its defaults filled in
    on the second) and delta_light_sample at random shading points:
    within LIGHT_RTOL of hairpt's."""
    k = {"point": jem.POINT, "spot": jem.SPOT,
         "directional": jem.DIRECTIONAL, "collimated": jem.COLLIMATED}[kind]
    assert (tem.POINT, tem.SPOT, tem.DIRECTIONAL, tem.COLLIMATED) == (
        jem.POINT, jem.SPOT, jem.DIRECTIONAL, jem.COLLIMATED)
    entries = [dict(kind=k, position=(0.5, 3.0, -1.0),
                    direction=(0.2, -1.0, 0.1), intensity=(5.0, 4.0, 3.0),
                    cutoff_deg=35.0, beam_deg=25.0), dict(kind=k)]
    jd = jem.make_delta_lights(entries)
    td = tem.make_delta_lights(entries, device="cpu")
    assert tem.DeltaLights._fields == jem.DeltaLights._fields
    _tables_equal(jd, td, "delta")
    rs = np.random.default_rng(3)
    p = rs.uniform(-2.0, 2.0, (4096, 3)).astype(np.float32)
    p[:, 1] = rs.uniform(-1.0, 1.0, 4096)
    u = rs.random(4096).astype(np.float32)
    out_j = jem.delta_light_sample(jd, jnp.asarray(p), jnp.asarray(u))
    out_t = tem.delta_light_sample(td, torch.as_tensor(p),
                                   torch.as_tensor(u))
    for name, a, b in zip(("d", "dist", "contrib", "prob"), out_j, out_t):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_allclose(b, a, rtol=LIGHT_RTOL, atol=0,
                                   err_msg=name)
    contrib = out_t[2].numpy()
    if kind == "collimated":
        assert not contrib.any()
    else:
        assert (contrib > 0).mean() > 0.3
    if kind == "spot":
        assert (contrib.max(-1) == 0).mean() > 0.1    # outside the cone


# --- the scene build -------------------------------------------------------

def test_area_and_delta_tables_match_jax(lit_pair, same_bvh):
    """The port's build of the lit mesh scene against hairpt's, and
    hairpt's carried across by convert_scene: the AreaLights (emissive
    triangles in BVH order, their tri_index, the power CDF) and
    DeltaLights tables bit for bit, each triangle's emitter_id, and the
    NEE probabilities equal among the three kinds present."""
    js, ts, cs = lit_pair
    assert tem.AreaLights._fields == jem.AreaLights._fields
    for s in (ts, cs):
        _tables_equal(js.arrays.area, s.arrays.area, "area")
        _tables_equal(js.arrays.delta, s.arrays.delta, "delta")
        np.testing.assert_array_equal(
            s.arrays.tri_shading.emitter_id.numpy(),
            np.asarray(js.arrays.tri_shading.emitter_id))
        assert s.config.nee_probs == js.config.nee_probs == (1 / 3,) * 3
    area = ts.arrays.area
    eid = ts.arrays.tri_shading.emitter_id
    np.testing.assert_array_equal(
        torch.nonzero(eid >= 0).squeeze(1).int().numpy(),
        area.tri_index.numpy())
    np.testing.assert_array_equal(area.p0.numpy(),
                                  ts.arrays.tri.p0[area.tri_index.long()]
                                  .numpy())
    assert set(eid.tolist()) == {-1, 0, 1}


def _jax_hit(valid, t, emitter_id):
    n = valid.shape[0]
    z3 = jnp.zeros((n, 3), jnp.float32)
    return jcommon.Hit(valid=jnp.asarray(valid), t=jnp.asarray(t),
                       p=z3, geo_n=z3, sh_s=z3, sh_t=z3, sh_n=z3,
                       uv=jnp.zeros((n, 2)), mat_id=jnp.zeros(n, jnp.int32),
                       emitter_id=jnp.asarray(emitter_id), is_hair=None,
                       uv_density=None, bary=None, vcolor=None, prim=None)


def test_nee_sampling_and_hit_pdf_match_jax(lit_pair):
    """_sample_emitter_direct and _pdf_emitter_hit with the environment,
    the area lights and the delta lights all present, on hairpt's tables
    and their copy: within NEE_RTOL. The BSDF-hit pdf takes hits on the
    emitters (from the sampled directions), on other triangles and
    misses."""
    js, _, cs = lit_pair
    rs = np.random.default_rng(5)
    n = 8192
    p = np.stack([rs.uniform(-3, 3, n), rs.uniform(0, 1.5, n),
                  rs.uniform(-3, 3, n)], -1).astype(np.float32)
    u_sel = rs.random(n).astype(np.float32)
    u2 = rs.random((n, 2)).astype(np.float32)
    cfg_j = js.config
    out_j = jpath._sample_emitter_direct(js.arrays, cfg_j, jnp.asarray(p),
                                         jnp.asarray(u_sel), jnp.asarray(u2))
    # torch's CPU sin can be off by ~1e-4 on its first call in a process
    # (ROADMAP Queue C; the environment's sampler calls it): the first
    # call is held to FIRST_CALL_ATOL, the second to NEE_RTOL
    for first in (True, False):
        out_t = tpath._sample_emitter_direct(cs.arrays, cs.config,
                                             torch.as_tensor(p),
                                             torch.as_tensor(u_sel),
                                             torch.as_tensor(u2))
        for name, a, b in zip(("d", "dist", "le", "pdf", "is_dl"), out_j,
                              out_t):
            a, b = np.asarray(a), b.numpy()
            if a.dtype == bool:
                np.testing.assert_array_equal(b, a, err_msg=name)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=0.0 if first else NEE_RTOL,
                    atol=FIRST_CALL_ATOL * np.abs(a).max() if first
                    else 1e-7, err_msg=name)
    pdf = out_t[3].numpy()
    sel = np.digitize(u_sel, np.cumsum(cs.config.nee_probs)[:-1])
    for k in range(3):     # each kind was picked, with a positive pdf
        assert (pdf[sel == k] > 0).any(), k
    eid = rs.integers(-1, 2, n).astype(np.int32)
    valid = rs.random(n) < 0.8
    t = rs.uniform(0.5, 6.0, n).astype(np.float32)
    d = np.array(out_j[0])
    pdf_j = jpath._pdf_emitter_hit(js.arrays, cfg_j,
                                   _jax_hit(valid, t, eid), jnp.asarray(d))
    hit_t = tcommon.Hit(*[None] * len(tcommon.Hit._fields))._replace(
        valid=torch.as_tensor(valid), t=torch.as_tensor(t),
        emitter_id=torch.as_tensor(eid))
    pdf_t = tpath._pdf_emitter_hit(cs.arrays, cs.config, hit_t,
                                   torch.as_tensor(d))
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j),
                               rtol=NEE_RTOL, atol=0)
    assert (pdf_t.numpy()[valid & (eid >= 0)] > 0).any()


# --- renders ---------------------------------------------------------------

def test_lit_render_matches_jax(lit_pair):
    """hairpt's render of the lit mesh scene (32 x 32, spp 4, depth 4,
    packed walk) against the port's of its copy: the mean within 1e-3
    relative, >= 99% of pixel values within 1e-3 relative + 1e-4
    (tests/test_torch_mesh.py's bounds)."""
    js, _, cs = lit_pair
    assert js.config.traversal == cs.config.traversal == "packed"
    img_j = np.asarray(jpath.render(js, spp=SPP))
    img_t = tpath.render(cs, spp=SPP).numpy()
    assert img_t.shape == img_j.shape and img_j.mean() > 0
    assert np.isfinite(img_t).all()
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 1e-3
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()


def test_point_light_floor_is_analytic():
    """The port alone: a diffuse floor (albedo 0.8) 3 below a point light
    of intensity 10 peaks at a / pi * I / d^2 (tests/test_emitters.py's
    scene and bound)."""
    b = TSceneBuilder(device="cpu")
    m = b.add_material(kind=tmat.DIFFUSE, diffuse=(0.8,) * 3, twosided=True)
    rot = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], float)
    floor = np.eye(4)
    floor[:3, :3] = rot @ np.diag([20.0, 20.0, 1.0])
    b.add_mesh(tshp.rectangle(), m, to_world=floor)
    b.delta_lights.append(dict(kind=tem.POINT, position=(0, 3, 0),
                               intensity=(10, 10, 10)))
    cam = TCamera.perspective(tlookat((0, 2, -6), (0, 0, 0), (0, 1, 0)),
                              45.0, 24, 24)
    s = b.build(cam, TFilm.make(24, 24, "box"), spp=1, max_depth=2,
                sampler=trng.SOBOL)
    assert s.config.nee_probs == (0.0, 0.0, 1.0)
    img = tpath.render(s, spp=16).numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.max(), 0.8 / np.pi * 10.0 / 9.0,
                               rtol=0.08)


def test_prb_matches_the_differentiable_mode_with_an_area_light(lit_pair):
    """PRB's gradient of the mean radiance with respect to the diffuse
    table against the differentiable mode's (depth 3, no RR), with the
    area lights' loop-top emission in the replay: the loss within 1e-4,
    the gradient within 5e-3 of its largest |g| (tests/test_torch_prb.py's
    bounds)."""
    _, ts, _ = lit_pair
    ts = ts._replace(config=dataclasses.replace(ts.config, max_depth=3,
                                                rr_depth=999))
    n = RES * RES
    lanes = (torch.arange(n), torch.zeros(n, dtype=torch.int64))
    diffuse = ts.arrays.materials.diffuse
    leaf = diffuse.clone().requires_grad_()
    li = tpath.make_li_fn(ts, differentiable=True)
    rad, _, _ = li(tinv.apply_params_arrays(ts.arrays, {"diffuse": leaf},
                                            ()), *lanes)
    loss = rad.mean()
    loss.backward()
    loss = loss.detach()
    l_prb, g_prb = tinv.make_prb_loss_grad(ts)(ts.arrays,
                                               {"diffuse": diffuse}, *lanes)
    assert float(l_prb) == pytest.approx(float(loss), rel=1e-4)
    a, b = leaf.grad.numpy(), g_prb["diffuse"].numpy()
    scale = np.abs(a).max()
    assert scale > 0
    np.testing.assert_allclose(b / scale, a / scale, atol=5e-3)
    # the emitter hits matter: without the area lights the loss drops
    dark = ts._replace(arrays=ts.arrays._replace(area=None))
    l_dark, _ = tinv.make_prb_loss_grad(dark)(dark.arrays,
                                              {"diffuse": diffuse}, *lanes)
    assert float(l_dark) < 0.9 * float(l_prb)


# --- the loaders and motion blur ----------------------------------------

LIT_XML = """<scene version="0.5.0">
  <integrator type="path"><integer name="maxDepth" value="4"/></integrator>
  <sensor type="perspective"><float name="fov" value="45"/>
    <transform name="toWorld"><lookat origin="0, 3, -7" target="0, 0.7, 0"
      up="0, 1, 0"/></transform>
    <sampler type="independent"><integer name="sampleCount" value="2"/>
    </sampler>
    <film type="hdrfilm"><integer name="width" value="24"/>
      <integer name="height" value="24"/></film></sensor>
  <bsdf type="diffuse" id="floor"/>
  <shape type="rectangle"><transform name="toWorld"><scale value="6"/>
    <rotate x="1" angle="-90"/></transform><ref id="floor"/></shape>
  <shape type="rectangle"><transform name="toWorld"><scale value="1.2"/>
    <rotate x="1" angle="90"/><translate y="3"/></transform>
    <emitter type="area"><rgb name="radiance" value="5, 4.5, 4"/>
    </emitter></shape>
  <shape type="sphere"><point name="center" x="2" y="1" z="1"/>
    <float name="radius" value="0.4"/>
    <emitter type="area"><spectrum name="radiance" value="3"/></emitter>
  </shape>
  <shape type="cube"><transform name="toWorld"><scale value="0.5"/>
    <translate y="0.5"/></transform>
    <emitter type="area"><blackbody name="radiance" temperature="4000"
      scale="1e-7"/></emitter></shape>
  <shape type="hair"><string name="filename" value="furball.mitshair"/>
    <emitter type="area"/></shape>
  <emitter type="point"><point name="position" x="-2" y="2.5" z="1"/>
    <rgb name="intensity" value="8, 7, 6"/></emitter>
  <emitter type="spot"><transform name="toWorld"><lookat origin="1.5, 4, -2"
    target="0, 0, 0" up="0, 1, 0"/></transform>
    <spectrum name="intensity" value="30"/>
    <float name="cutoffAngle" value="30"/></emitter>
  <emitter type="spot"><point name="position" x="0" y="4" z="0"/>
    <vector name="direction" x="0" y="-1" z="0"/>
    <float name="cutoffAngle" value="25"/><float name="beamWidth"
    value="10"/><spectrum name="power" value="40"/></emitter>
  <emitter type="directional"><vector name="direction" x="0.3" y="-1"
    z="0.2"/><spectrum name="irradiance" value="0.4"/></emitter>
  <emitter type="collimated"><transform name="toWorld"><translate y="3"/>
    </transform></emitter>
  <emitter type="constant"><rgb name="radiance" value="0.1"/></emitter>
</scene>
"""


def test_loaders_agree_on_every_emitter(tmp_path, same_bvh):
    """One XML with area lights on a rectangle, a sphere and a cube (rgb,
    spectrum and blackbody radiance), an emitter inside a hair shape
    (dropped by both), a point, two spots (toWorld; position and
    direction, beamWidth, power), a directional and a collimated light:
    hairpt's loader and the port's give the same config and area, delta
    and triangle tables, and the port renders it."""
    d = tmp_path / "lit"
    d.mkdir()
    path = str(d / "scene.xml")
    with open(path, "w") as f:
        f.write(LIT_XML)
    load = dict(hair_quality=0.01)
    js = jxl.load_scene(path, **load)
    ts = txl.load_scene(path, **load, device="cpu")
    cs = convert.convert_scene(js._replace(config=dataclasses.replace(
        js.config, traversal="tiled", tiled_q=2048)),
        jax.tree_util.tree_map(np.asarray, js.arrays), device="cpu")
    assert ts.config == cs.config
    for f in ("area", "delta", "tri", "tri_shading", "hair"):
        _tables_equal(getattr(cs.arrays, f), getattr(ts.arrays, f), f)
    assert ts.arrays.delta.kind.tolist() == [tem.POINT, tem.SPOT, tem.SPOT,
                                             tem.DIRECTIONAL, tem.COLLIMATED]
    eid = ts.arrays.tri_shading.emitter_id
    assert set(eid.tolist()) == {-1, 0, 1, 2}
    assert ts.arrays.area.cdf.shape[0] == int((eid >= 0).sum())
    assert ts.config.nee_probs == (1 / 3,) * 3
    img = tpath.render(ts, spp=1)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0


def test_area_table_follows_the_shutter(tmp_path):
    """An emissive rectangle moved between two keyframes under an open
    shutter: rebuild_geo's area table sits on the moved triangles at every
    shutter time (it equals a still build of the mesh posed there), so
    NEE samples the light where BSDF rays hit it; the render differs from
    one that kept the build-time table."""
    anim = AnimatedTransform([(0.0, np.eye(4)),
                              (1.0, np.array([[1.0, 0, 0, 1.5],
                                              [0, 1, 0, 0.0],
                                              [0, 0, 1, 0.5],
                                              [0, 0, 0, 1]]))])
    rot = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], float)
    light = np.eye(4)
    light[:3, :3] = rot * 0.8
    light[:3, 3] = (0.0, 2.0, 0.0)

    def build(t=None):
        b = TSceneBuilder(device="cpu")
        m = b.add_material(kind=tmat.DIFFUSE, diffuse=(0.7,) * 3,
                           twosided=True)
        fl = np.eye(4)
        fl[:3, :3] = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]]) * 5.0
        b.add_mesh(tshp.rectangle(), m, to_world=fl)
        pose = light if t is None else anim.eval(t) @ light
        b.add_mesh(tshp.rectangle(), m, to_world=pose, radiance=(4, 4, 4))
        if t is None:
            b.animated_meshes[1] = anim
            b.shutter = (0.0, 1.0)
        cam = TCamera.perspective(tlookat((0, 4, -6), (0, 0, 0), (0, 1, 0)),
                                  45.0, 24, 24)
        return b.build(cam, TFilm.make(24, 24, "box"), spp=2, max_depth=3,
                       sampler=trng.SOBOL)

    s = build()
    assert s.rebuild_geo is not None
    for t in (0.25, 0.75):
        moved = s.rebuild_geo(t)
        still = build(t)
        _tables_equal(moved.area, still.arrays.area, f"area at {t}")
        assert not torch.equal(moved.area.p0, s.arrays.area.p0)
        np.testing.assert_array_equal(
            moved.area.p0.numpy(),
            moved.tri.p0[moved.area.tri_index.long()].numpy())
    img = tpath.render(s, spp=2).numpy()
    kept = s._replace(rebuild_geo=lambda t: s.rebuild_geo(t)._replace(
        area=s.arrays.area))
    img_kept = tpath.render(kept, spp=2).numpy()
    assert np.isfinite(img).all() and img.mean() > 0
    assert np.abs(img - img_kept).max() > 1e-3
