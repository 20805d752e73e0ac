"""The materials stand-in (hairpt_torch.scene.scene_xmls.materials: one
sphere per surface BSDF family and wrapper material the port added, under
a thin-lens camera, without its hair) through both packages' loaders:
the tables through convert_scene, and a small render against hairpt's
(triangles only: hairpt's packed traversal, no Pallas call).
tests/test_torch_bsdf_families.py holds path-replay backprop to the
differentiable mode on it."""
import jax
import numpy as np
import pytest

from hairpt.integrators import path as jpath
from hairpt.ops import bvh as jbvh
from hairpt.scene.xml_loader import load_scene as jload
from hairpt_torch import convert
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene.xml_loader import load_scene as tload
from torch_threads import one_thread  # noqa: F401

RES, SPP, DEPTH = 32, 4, 6


@pytest.fixture(scope="module")
def stand_in(tmp_path_factory):
    """The materials stand-in without its hair (one sphere per new family
    under the thin lens, the checkerboard floor, the sunsky), 32^2, 4
    spp, depth 6, through hairpt's loader (its packed traversal: no
    Pallas call) and the port's, both with the port's BVH builder."""
    d = str(tmp_path_factory.mktemp("materials"))
    xml = scene_xmls.write_scene(d, "materials", res=RES, spp=SPP,
                                 depth=DEPTH, hair=False)
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", tbvh._load_native())
    mp.setattr(jbvh, "_NATIVE_TRIED", True)
    try:
        js = jload(xml)
        img_j = np.asarray(jpath.render(js, spp=SPP))
    finally:
        mp.undo()
    ts = tload(xml, device="cpu")
    return js, ts, img_j


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


def test_loaders_give_equal_tables(stand_in):
    """Both loaders on the XML with every new BSDF and the thin lens: the
    port's tables equal hairpt's carried across by convert_scene, bit for
    bit, and so do the camera and the active kinds."""
    js, ts, _ = stand_in
    assert js.config.traversal == "packed"
    cs = convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    for f in ("tri", "tri_shading", "tri_packed", "materials", "checkers"):
        _bits(getattr(ts.arrays, f), getattr(cs.arrays, f), f)
    assert ts.active_kinds == cs.active_kinds
    assert set(ts.active_kinds) >= {
        tmat.ROUGHDIFFUSE, tmat.CONDUCTOR, tmat.ROUGHCONDUCTOR,
        tmat.DIELECTRIC, tmat.THINDIELECTRIC, tmat.ROUGHDIELECTRIC,
        tmat.DIFFTRANS, tmat.PHONG, tmat.WARD, tmat.NULL, tmat.MIXTURE,
        tmat.MASK, tmat.COATING, tmat.ROUGHCOATING}
    for a, b in zip(ts.camera, cs.camera):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert ts.camera.kind == 1 and ts.camera.aperture_radius == 0.02


def test_render_matches_jax(stand_in):
    """The port's render against hairpt's: the image mean within 1e-3
    relative and >= 99% of pixel values within 1e-3 relative + 1e-4
    (tests/test_torch_mesh.py's bounds)."""
    _, ts, img_j = stand_in
    img_t = tpath.render(ts, spp=SPP).numpy()
    assert img_t.shape == img_j.shape and img_j.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 1e-3
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()
