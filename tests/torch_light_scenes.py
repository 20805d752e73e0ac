"""Small scenes for the light-tracer tests (test_torch_light_emit.py,
test_torch_ptracer.py, test_torch_bdpt.py, test_torch_vpl.py,
test_torch_photonmap.py): built by hairpt's SceneBuilder with its CPU
default, the packed BVH walk (no Pallas kernel), and carried across to
the port with hairpt_torch.convert; the hair stand-in's port side takes
the tiled traversal's plain versions (q = 8, so the completion loop
runs), as the card's main path takes kernels A and B.

  box        the area-lit box of tests/test_bdpt.py (one area light)
  sphere     the sphere on a floor under a constant environment of
             tests/test_photonmap.py and tests/test_vpl.py
  mixed      the sphere and floor under the environment, an area light
             above, a point and a spot light (every emitter group)
  fog        the point light above a sphere of tests/test_photonmap.py's
             beam radiance test, in its isotropic fog (a scene medium)
  hair       120 furball fibers under rough plastic, an area light, a
             point light and the sunsky: the slice as a whole

Both scene builds order the hair with the port's build of
csrc/bvh_builder.cpp (see tests/test_torch_xml.py).
"""
import dataclasses

import jax
import numpy as np

from hairpt.core.math import matrix_lookat
from hairpt.film.film import Film
from hairpt.models import emitters as em
from hairpt.models import media as med
from hairpt.models import shapes as shp
from hairpt.models.bsdf import registry as mat
from hairpt.models.sensors import Camera
from hairpt.ops import bvh as jbvh
from hairpt.scene import hairgen
from hairpt.scene.scene import SceneBuilder
from hairpt_torch import convert
from hairpt_torch.ops import bvh as tbvh
from torch_furball import CAM, DIFFUSE

FOG = dict(sigma_s=(0.3,) * 3, sigma_a=(0.05,) * 3, g=0.0,
           phase_kind=med.ISOTROPIC, fog_depth=6.0)


def _floor(b, m, y=-1.0, size=8.0):
    rot = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], float)
    t = np.eye(4)
    t[:3, :3] = rot @ np.diag([size, size, 1.0])
    t[:3, 3] = [0, y, 0]
    b.add_mesh(shp.rectangle(), m, to_world=t)


def box(res=16, spp=1, depth=5):
    b = SceneBuilder()
    white = b.add_material(kind=mat.DIFFUSE, diffuse=(0.7, 0.7, 0.7))
    red = b.add_material(kind=mat.DIFFUSE, diffuse=(0.7, 0.15, 0.1))
    floor = shp.rectangle()
    rot_floor = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0],
                          [0, 0, 0, 1]], np.float64)
    sc = np.diag([2.0, 2.0, 1.0, 1.0])
    tr = np.eye(4)
    tr[:3, 3] = [0, 0, 1.0]
    b.add_mesh(floor, white, to_world=tr @ rot_floor @ sc)
    back = np.eye(4)
    back[:3, 3] = [0, 1.0, 3.0]
    b.add_mesh(floor, white, to_world=back @ np.diag([1.0, 1.0, -1.0, 1.0])
               @ sc)
    left = np.array([[0, 0, 1, -1.8], [0, 1, 0, 1.0], [-1, 0, 0, 1.0],
                     [0, 0, 0, 1]], np.float64)
    b.add_mesh(floor, red, to_world=left @ sc)
    lamp = np.array([[0.4, 0, 0, 0], [0, 0, -0.4, 2.2], [0, 0.4, 0, 1.0],
                     [0, 0, 0, 1]], np.float64)
    b.add_mesh(floor, white, to_world=lamp, radiance=(12.0, 11.0, 9.0))
    cam = Camera.perspective(matrix_lookat((0.3, 1.2, -2.6), (0, 0.8, 1.0),
                                           (0, 1, 0)), 55.0, res, res)
    return b.build(cam, Film.make(res, res, "box"), spp=spp,
                   max_depth=depth, sampler=0, rr_depth=99,
                   traversal="packed")


def _sphere_floor(b):
    m = b.add_material(kind=mat.DIFFUSE, diffuse=(0.6, 0.6, 0.6),
                       twosided=True)
    b.add_mesh(shp.sphere(1.0, 16, 32), m)
    _floor(b, m)
    return m


def _cam(res):
    return Camera.perspective(matrix_lookat((0, 1.5, -5), (0, 0, 0),
                                            (0, 1, 0)), 45.0, res, res)


def sphere(res=16, spp=1, depth=6):
    b = SceneBuilder()
    _sphere_floor(b)
    b.env = em.make_constant((1.0, 1.0, 1.0))
    return b.build(_cam(res), Film.make(res, res, "box"), spp=spp,
                   max_depth=depth, sampler=1, strict_normals=False,
                   traversal="packed")


def _lights(b, m):
    lamp = np.array([[0.5, 0, 0, 0], [0, 0, -0.5, 2.2], [0, 0.5, 0, 0.0],
                     [0, 0, 0, 1]], float)
    b.add_mesh(shp.rectangle(), m, to_world=lamp, radiance=(5.0, 4.0, 3.0))
    b.delta_lights.append(dict(kind=em.POINT, position=(-1.5, 2.0, -1.0),
                               intensity=(3.0, 3.0, 3.0)))
    b.delta_lights.append(dict(kind=em.SPOT, position=(1.5, 3.0, -1.0),
                               direction=(-0.3, -1.0, 0.2),
                               intensity=(10.0, 10.0, 10.0),
                               cutoff_deg=30.0, beam_deg=20.0))


def mixed(res=16, spp=1, depth=6):
    b = SceneBuilder()
    m = _sphere_floor(b)
    b.env = em.make_constant((0.6, 0.7, 0.8))
    _lights(b, m)
    return b.build(_cam(res), Film.make(res, res, "box"), spp=spp,
                   max_depth=depth, sampler=1, strict_normals=False,
                   traversal="packed")


def fog(res=16, spp=1, depth=8):
    b = SceneBuilder()
    m = b.add_material(kind=mat.DIFFUSE, diffuse=(0.3,) * 3)
    tw = np.eye(4)
    tw[:3, 3] = (0.0, -3.0, 0.0)
    b.add_mesh(shp.sphere(0.5, 12, 24), m, to_world=tw)
    b.delta_lights.append(dict(kind=em.POINT, position=(0.0, 0.0, 0.0),
                               intensity=(4.0, 4.0, 4.0)))
    cam = Camera.perspective(matrix_lookat((0, 0, -4), (0, 0, 0),
                                           (0, 1, 0)), 45.0, res, res)
    s = b.build(cam, Film.make(res, res, "box"), spp=spp, max_depth=depth,
                sampler=1, traversal="packed")
    return s._replace(medium=med.make_medium(**FOG))


def hair(res=16, spp=1, depth=4):
    b = SceneBuilder()
    m = b.add_material(kind=mat.ROUGHPLASTIC, diffuse=DIFFUSE, alpha=0.2,
                       eta=1.55, dist=0)
    b.add_fibers(hairgen.gen_furball(n_fibers=120,
                                     radius=0.00216667 * 20), m)
    lamp = np.eye(4)
    lamp[:3, :3] = np.array([[2.5, 0, 0], [0, 0, -2.5], [0, 2.5, 0]])
    lamp[:3, 3] = (0.0, 17.0, 0.0)
    b.add_mesh(shp.rectangle(), b.add_material(kind=mat.DIFFUSE),
               to_world=lamp, radiance=(6.0, 5.6, 5.0))
    b.delta_lights.append(dict(kind=em.POINT, position=(-6.0, 16.0, 6.0),
                               intensity=(60.0, 50.0, 40.0)))
    b.env = em.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                           sky_scale=5.0, sun_scale=19.0912,
                           sun_radius_scale=37.9165, res=32)
    cam = Camera.perspective(CAM, 12.0, res, res)
    return b.build(cam, Film.make(res, res, "tent"), spp=spp,
                   max_depth=depth, sampler=1, traversal="packed")


def build(make, **kw):
    """(hairpt's scene, the port's converted scene on the CPU), the hair
    ordered by the port's BVH library; a scene with hair converts to the
    tiled traversal (q = 8)."""
    old = jbvh._NATIVE, jbvh._NATIVE_TRIED
    jbvh._NATIVE, jbvh._NATIVE_TRIED = tbvh._load_native(), True
    try:
        js = make(**kw)
    finally:
        jbvh._NATIVE, jbvh._NATIVE_TRIED = old
    src = js
    if js.arrays.hair is not None:
        src = js._replace(config=dataclasses.replace(
            js.config, traversal="tiled", tiled_q=8))
    cs = convert.convert_scene(src, jax.tree_util.tree_map(np.asarray,
                                                           js.arrays),
                               device="cpu")
    return js, cs


def compare(img_t, img_j, mean_rtol=2e-3, share=0.97):
    """The image mean within mean_rtol relative and >= share of the
    pixel values within 1e-3 relative + 1e-4."""
    img_j = np.asarray(img_j)
    img_t = img_t.numpy() if hasattr(img_t, "numpy") else np.asarray(img_t)
    assert img_t.shape == img_j.shape and img_j.mean() > 0
    assert np.isfinite(img_t).all()
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < mean_rtol, \
        (img_t.mean(), img_j.mean())
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= share, close.mean()
