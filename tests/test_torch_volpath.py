"""The volumetric path tracer of hairpt_torch against hairpt's, on the CPU:
small renders (24 x 24, depth 5, 2 spp) of one triangle scene (hairpt's
packed walk, no Pallas kernel; carried across by convert_scene) in a
global HG fog, in a kkay fiber-phase fog, in a small grid medium
(Woodcock tracking) and with its shape-bounded media (a null-bounded
sphere and a dielectric sphere with interior media); the scene's hk
sphere is in every render. The hk BSDF per lane, and the two loaders on
the bounded-media XML.

Each JAX render function is compiled once. Bounds: the image mean within
2e-3 relative and >= 97% of the pixel values within 1e-3 relative +
1e-4. The two packages' log, exp, sin, cos and pow round the last bit
differently; a path in a medium samples a distance and a phase direction
at every event, and a last-bit change can move a lane's medium event
across a surface or a Woodcock density test across its threshold, after
which that lane's path differs (on the order of one pixel value in a
hundred at these sizes)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core.math import matrix_lookat as jlookat
from hairpt.film.film import Film as JFilm
from hairpt.integrators import volpath as jvp
from hairpt.models import emitters as jem
from hairpt.models import media as jmed
from hairpt.models import shapes as jshp
from hairpt.models.bsdf import hk as jhk
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.ops import bvh as jbvh
from hairpt.scene import xml_loader as jxl
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import convert
from hairpt_torch.integrators import path as tpath
from hairpt_torch.integrators import volpath as tvp
from hairpt_torch.models import media as tmed
from hairpt_torch.models.bsdf import hk as thk  # noqa: F401
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene.xml_loader import load_scene as tload
from torch_threads import one_thread  # noqa: F401

RES, DEPTH, SPP = 24, 5, 2
MEAN_RTOL = 2e-3
PIX_SHARE = 0.97
HK_ROW = dict(kind=jmat.HK, transmit=(2.0, 1.5, 1.0),
              sigma_a=(0.05, 0.1, 0.2), alpha=0.5, beta_r=0.4)



def _jax_scene():
    """A diffuse floor, a null-bounded sphere of fog (medium 1), a
    dielectric sphere filled with a denser medium (medium 2), an hk
    sphere and a constant environment."""
    b = JSceneBuilder()
    floor = b.add_material(kind=jmat.DIFFUSE, diffuse=(0.6, 0.55, 0.5),
                           twosided=True)
    null = b.add_material(kind=jmat.NULL)
    glass = b.add_material(kind=jmat.DIELECTRIC, eta=1.33)
    hk = b.add_material(**HK_ROW)
    fog = b.add_medium((0.6, 0.7, 0.8), (0.05, 0.05, 0.05), g=0.3)
    dense = b.add_medium((2.0, 1.2, 0.6), (0.1, 0.2, 0.4), g=-0.2)
    m = np.eye(4)
    m[:3, :3] = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], float) * 6.0
    b.add_mesh(jshp.rectangle(), floor, to_world=m)
    for k, (mid, c, r, med) in enumerate((
            (null, (0.0, 1.2, 0.0), 1.2, fog),
            (glass, (1.6, 0.6, -1.2), 0.6, dense),
            (hk, (-1.6, 0.6, -1.0), 0.6, 0))):
        m = np.eye(4)
        m[:3, 3] = c
        b.add_mesh(jshp.sphere(r), mid, to_world=m)
        if med:
            b.mesh_media[len(b.tri_meshes) - 1] = (med, 0)
    b.env = jem.make_constant((0.9, 0.85, 0.8))
    cam = JCamera.perspective(jlookat((0.0, 2.5, -6.5), (0.0, 0.8, 0.0),
                                      (0.0, 1.0, 0.0)), 45.0, RES, RES)
    return b.build(cam, JFilm.make(RES, RES, "tent"), spp=SPP,
                   max_depth=DEPTH, traversal="packed")


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", tbvh._load_native())
    mp.setattr(jbvh, "_NATIVE_TRIED", True)
    js = _jax_scene()
    mp.undo()
    cs = convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    return js, cs


def _grid(device=None):
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, 12)] * 3, indexing="ij")
    data = (np.clip(1.2 - np.sqrt(x * x + y * y + z * z), 0, 1)
            * (0.7 + 0.3 * np.sin(5 * x) * np.cos(4 * z))).astype(np.float32)
    box = ((-2.0, 0.0, -2.0), (2.0, 2.5, 2.0))
    if device is None:
        return jmed.make_grid_volume(data, *box)
    return tmed.make_grid_volume(data, *box, device=device)


MEDIA = {
    "hg_fog": lambda m, dev: m.make_medium(
        (0.15, 0.12, 0.1), (0.01, 0.02, 0.03), g=0.5, phase_kind=m.HG,
        fog_depth=20.0, **dev),
    "kkay_fog": lambda m, dev: m.make_medium(
        (0.2, 0.2, 0.2), (0.02, 0.02, 0.02), phase_kind=m.KKAY,
        orientation=(0.3, 0.9, 0.2), exponent=12.0, fog_depth=20.0, **dev),
    "grid": lambda m, dev: m.make_hetero_medium(
        _grid(dev.get("device")), (1.5, 1.8, 2.1), (0.1, 0.1, 0.1), g=0.2),
}


def _compare(img_t, img_j):
    img_j = np.asarray(img_j)
    img_t = img_t.numpy()
    assert img_t.shape == img_j.shape and img_j.mean() > 0
    assert np.isfinite(img_t).all()
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < MEAN_RTOL, \
        (img_t.mean(), img_j.mean())
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= PIX_SHARE, close.mean()


@pytest.mark.parametrize("name", list(MEDIA))
def test_global_medium_render_matches_jax(pair, name):
    js, cs = pair
    jm = MEDIA[name](jmed, {})
    tm = MEDIA[name](tmed, {"device": "cpu"})
    img_j = jvp.render_volpath(js, medium=jm, spp=SPP)
    img_t = tvp.render_volpath(cs, medium=tm, spp=SPP)
    _compare(img_t, img_j)


def test_bounded_media_render_matches_jax(pair):
    """The shape-bounded tracer (no scene medium): the fog sphere's null
    boundary, the glass sphere's interior medium, the hk sphere."""
    js, cs = pair
    assert js.medium is None and cs.medium is None
    assert cs.arrays.media is not None
    np.testing.assert_array_equal(cs.arrays.tri_med.numpy(),
                                  np.asarray(js.arrays.tri_med))
    assert set(np.unique(cs.arrays.tri_med.numpy()[:, 0])) == {0, 1, 2}
    _compare(tvp.render_volpath(cs, spp=SPP),
             jvp.render_volpath(js, spp=SPP))


def test_hk_bsdf_matches_jax():
    """hk's eval_pdf and sample per lane (both hemispheres, grazing
    lanes): 1e-5 relative + 1e-6 on 99.5% of the values, 1e-2 on all
    (the HG lobe at a sampled direction amplifies last-bit differences,
    tests/test_torch_bsdf_families.py's reasoning)."""
    rs = np.random.RandomState(4)
    n = 4096

    def dirs():
        w = rs.normal(size=(n, 3)).astype(np.float32)
        return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(
            np.float32)
    wi, wo = dirs(), dirs()
    u_lobe = rs.random(n).astype(np.float32)
    u2 = rs.random((n, 2)).astype(np.float32)
    jt = jmat.pack_materials([jmat.default_material_row(**HK_ROW)])
    tt = tmat.pack_materials([tmat.default_material_row(**HK_ROW)],
                             device="cpu")
    mid = np.zeros(n, np.int32)
    uv = np.zeros((n, 2), np.float32)
    jg = jmat.gather(jt, None, jnp.asarray(mid), jnp.asarray(uv))
    tg = tmat.gather(tt, None, torch.as_tensor(mid), torch.as_tensor(uv))
    jout = jhk.HK.eval_pdf(jg, jnp.asarray(wi), jnp.asarray(wo), None)
    tout = thk.HK.eval_pdf(tg, torch.as_tensor(wi), torch.as_tensor(wo))
    jout += jhk.HK.sample(jg, jnp.asarray(wi), jnp.asarray(u_lobe),
                          jnp.asarray(u2), jnp.asarray(u2), None)[:4]
    tout += thk.HK.sample(tg, torch.as_tensor(wi), torch.as_tensor(u_lobe),
                          torch.as_tensor(u2), torch.as_tensor(u2))[:4]
    for a, b in zip(tout, jout):
        a = a.numpy().astype(np.float64)
        b = np.asarray(b).astype(np.float64)
        if a.dtype == bool or b.dtype == bool:
            assert (a == b).mean() >= 0.999
            continue
        ok = np.abs(a - b) <= 1e-6 + 1e-5 * np.abs(b)
        assert ok.mean() >= 0.995, ok.mean()
        assert np.allclose(a, b, rtol=1e-2, atol=1e-4)


def test_loaders_agree_on_the_bounded_xml(tmp_path, monkeypatch):
    """The bounded-media stand-in (scene_xmls.bounded: a null-bounded fog
    sphere, a dielectric sphere with an interior medium, an hk sphere) and
    the media stand-in's scene medium through both loaders: the material
    table, tri_med, the media table and the scene medium equal."""
    monkeypatch.setattr(jbvh, "_NATIVE", tbvh._load_native())
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)
    kw = dict(res_scale=0.03125, hair_quality=0.005, spp_override=1,
              max_depth_override=3)
    x = scene_xmls.write_scene(str(tmp_path), "bounded")
    js = jxl.load_scene(x, **kw)
    ts = tload(x, device="cpu", **kw)
    assert ts.config.integrator == js.config.integrator == "volpath"
    assert jmat.HK in js.active_kinds and tmat.HK in ts.active_kinds
    for f in jmat.MaterialTable._fields:
        if getattr(js.arrays.materials, f, None) is None:
            continue
        np.testing.assert_allclose(
            getattr(ts.arrays.materials, f).numpy(),
            np.asarray(getattr(js.arrays.materials, f)), err_msg=f)
    np.testing.assert_array_equal(ts.arrays.tri_med.numpy(),
                                  np.asarray(js.arrays.tri_med))
    for f in jmed.MediumTable._fields:
        np.testing.assert_array_equal(getattr(ts.arrays.media, f).numpy(),
                                      np.asarray(getattr(js.arrays.media, f)))
    x = scene_xmls.write_scene(str(tmp_path), "media", vol_res=16)
    jm = jxl.load_scene(x, **kw).medium
    tm = tload(x, device="cpu", **kw).medium
    assert isinstance(tm, tmed.HeteroMedium) and tm.phase_kind == jm.phase_kind
    for f in ("sigma_t", "albedo", "g", "majorant"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    for f in ("data", "world_min", "inv_extent"):
        np.testing.assert_array_equal(getattr(tm.vol, f).numpy(),
                                      np.asarray(getattr(jm.vol, f)))
    # kernel J's host scalars are the plain loops' float32 values, from
    # the builder and from convert_medium alike
    cm = convert.convert_medium(jm, "cpu")
    for m in (tm, cm):
        assert m.inv_majorant == float(1.0 / m.majorant)
        assert m.sigma_t_max == float(torch.amax(m.sigma_t))


def test_compaction_changes_no_lane(pair, monkeypatch):
    """The wave narrowed to path.render's staged widths (live lanes
    first, here from 1 lane up) renders the same image, bit for bit, as
    the wave at full width (in the HG fog at depth 12, so that lanes
    die): each lane's numbers are its own."""
    _, cs = pair
    cs = cs._replace(config=dataclasses.replace(cs.config, max_depth=12))
    widths = []
    narrow = tvp._Wave.narrow

    def recorded(self, width):
        narrow(self, width)
        widths.append(self.lane.shape[0])
    monkeypatch.setattr(tvp._Wave, "narrow", recorded)
    medium = MEDIA["hg_fog"](tmed, {"device": "cpu"})
    monkeypatch.setattr(tpath, "STAGE_MIN", 10 ** 9)
    full = tvp.render_volpath(cs, medium=medium, spp=1)
    assert widths == []
    monkeypatch.setattr(tpath, "STAGE_MIN", 1)
    assert torch.equal(tvp.render_volpath(cs, medium=medium, spp=1), full)
    assert widths == tpath.stage_caps(RES * RES)[1:] and widths[0] < RES * RES
