"""The nine sensor kinds of hairpt_torch.models.sensors against
hairpt.models.sensors: sample_ray on seeded film positions and aperture
samples (1e-6 relative, 1e-6 absolute where a component crosses zero),
and both loaders on each sensor XML: the cameras equal, convert_scene's
camera equal to the port loader's, and the port's small render of each
kind finite and non-black. (The render through hairpt's camera equals
the port's because the rays are sample_ray's, held above.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core.math import matrix_lookat
from hairpt.models import sensors as jsens
from hairpt.scene.xml_loader import load_scene as jload
from hairpt_torch import convert
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models import sensors as tsens
from hairpt_torch.scene.xml_loader import load_scene as tload
from torch_threads import one_thread  # noqa: F401

N = 4096
W, H = 48, 32
RTOL = 1e-6
ATOL = 1e-6   # absolute, for components that cross zero

KINDS = {
    "perspective": (jsens.PERSPECTIVE, {}),
    "thinlens": (jsens.THINLENS, dict(aperture_radius=0.05,
                                      focus_distance=3.0)),
    "orthographic": (jsens.ORTHOGRAPHIC, {}),
    "spherical": (jsens.SPHERICAL, {}),
    "telecentric": (jsens.TELECENTRIC, dict(aperture_radius=0.1,
                                            focus_distance=2.5)),
    "radiancemeter": (jsens.RADIANCEMETER, {}),
    "fluencemeter": (jsens.FLUENCEMETER, {}),
    "irradiancemeter": (jsens.IRRADIANCEMETER, {}),
    "perspective_rdist": (jsens.PERSPECTIVE_RDIST, dict(kc=(0.12, -0.03))),
}
TO_WORLD = matrix_lookat((0.3, 1.0, -4.0), (0.0, 0.2, 0.0), (0.0, 1.0, 0.0))


def _cameras(name):
    kind, kw = KINDS[name]
    kw = dict(kw)
    kc = kw.pop("kc", (0.0, 0.0))
    jc = jsens.Camera.perspective(TO_WORLD, 40.0, W, H, kind=kind, **kw)
    jc = jc._replace(kc0=kc[0], kc1=kc[1])
    tc = tsens.Camera.perspective(TO_WORLD, 40.0, W, H, kind=kind, **kw)
    return jc, tc._replace(kc0=kc[0], kc1=kc[1])


@pytest.mark.parametrize("name", sorted(KINDS))
def test_sample_ray_matches_jax(name):
    jc, tc = _cameras(name)
    assert tc.tan_half_fov == float(jc.tan_half_fov)
    rs = np.random.default_rng(7)
    pos = (rs.random((N, 2)) * [W, H]).astype(np.float32)
    ap = rs.random((N, 2)).astype(np.float32)
    jr = jsens.sample_ray(jc, jnp.asarray(pos), jnp.asarray(ap))
    tr = tsens.sample_ray(tc, torch.as_tensor(pos), torch.as_tensor(ap))
    for f in ("o", "d", "mint", "maxt"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    # the lens kinds move the origin over the aperture
    spread = float(tr.o.std(0).max())
    assert (spread > 0) == (name in ("thinlens", "telecentric",
                                     "orthographic"))


def _sensor_xml(name):
    extra = {"thinlens": "<float name=\"apertureRadius\" value=\"0.05\"/>"
                         "<float name=\"focusDistance\" value=\"4\"/>",
             "telecentric": "<float name=\"apertureRadius\" value=\"0.1\"/>"
                            "<float name=\"focusDistance\" value=\"4\"/>",
             "perspective_rdist": "<string name=\"kc\" "
                                  "value=\"0.12, -0.03\"/>"}.get(name, "")
    return ("<scene version=\"0.5.0\"><integrator type=\"path\"><integer "
            "name=\"maxDepth\" value=\"3\"/></integrator>"
            f"<sensor type=\"{name}\"><float name=\"fov\" value=\"40\"/>"
            f"{extra}<transform name=\"toWorld\"><lookat origin=\"0.3, 1, -4\" "
            "target=\"0, 0.2, 0\" up=\"0, 1, 0\"/></transform>"
            "<sampler type=\"independent\"><integer name=\"sampleCount\" "
            "value=\"2\"/></sampler><film type=\"hdrfilm\"><integer "
            f"name=\"width\" value=\"{W}\"/><integer name=\"height\" "
            f"value=\"{H}\"/><rfilter type=\"box\"/></film></sensor>"
            "<shape type=\"sphere\"><float name=\"radius\" value=\"1\"/>"
            "<bsdf type=\"diffuse\"/></shape>"
            "<shape type=\"rectangle\"><transform name=\"toWorld\"><scale "
            "value=\"5\"/><rotate x=\"1\" angle=\"-90\"/><translate "
            "y=\"-1\"/></transform></shape>"
            "<emitter type=\"constant\"><rgb name=\"radiance\" "
            "value=\"1, 0.9, 0.8\"/></emitter></scene>")


@pytest.mark.parametrize("name", sorted(set(KINDS) - {"perspective"}))
def test_loaders_and_render_of_each_sensor(tmp_path, name):
    """Each other sensor XML through both loaders: the cameras equal
    field for field, convert_scene's too; the port's loaded scene renders
    (finite, non-black), and the same render through convert_scene's
    camera and config is equal."""
    path = tmp_path / "scene.xml"
    path.write_text(_sensor_xml(name))
    js = jload(str(path))
    ts = tload(str(path), device="cpu")
    assert ts.camera.kind == int(js.camera.kind) == KINDS[name][0]
    for f in tsens.Camera._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ts.camera, f)),
                                      np.asarray(getattr(js.camera, f)),
                                      err_msg=f)
    img = tpath.render(ts, spp=1)
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0
    cs = convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    assert cs.camera == ts.camera._replace(
        to_world=cs.camera.to_world) and np.array_equal(
            cs.camera.to_world, ts.camera.to_world)
    ts_img = tpath.render(cs._replace(arrays=ts.arrays), spp=1)
    assert torch.equal(img, ts_img)
