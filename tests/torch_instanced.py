"""The instanced stand-in (hairpt_torch.scene.scene_xmls.instanced) built
by hand through either package's SceneBuilder, as its XML loads: the
tests hold the port's loader to it tensor for tensor, and render it
through hairpt (whose loader raises on any bitmap texture, ROADMAP
Queue C) against the port's loader."""
import importlib
import math
import os

import numpy as np

from hairpt_torch.scene import scene_xmls
from hairpt_torch.utils import io

RES = (1280, 720)
EYE = ((0, 24, 52), (0, 0, 8), (0, 1, 0))


def _rot(axis, deg):
    """The loader's <rotate> matrix (Rodrigues, float64)."""
    ax = np.asarray(axis, np.float64)
    ax = ax / np.linalg.norm(ax)
    ang = np.radians(deg)
    k = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    t = np.eye(4)
    t[:3, :3] = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k
    return t


def _scale(x, y=None, z=None):
    return np.diag([x, x if y is None else y, x if z is None else z, 1.0])


def _move(x=0.0, y=0.0, z=0.0):
    t = np.eye(4)
    t[:3, 3] = (x, y, z)
    return t


def _chain(*ms):
    """The loader's composition in document order (m = t @ m)."""
    m = np.eye(4)
    for t in ms:
        m = t @ m
    return m


def hand_build(pkg: str, d: str, res_scale=0.05, depth=3, grid=8, spp=1,
               device=None):
    """The stand-in whose files write_scene(..., grid=grid) put in `d`,
    through pkg's ("hairpt" or "hairpt_torch") SceneBuilder, in the
    loader's order: the four top-level materials and their textures,
    the shapegroup's default material and its prototype, a default
    material and the instance per instance, the floor, the heightfield,
    the deformable pair, the envmap of the missing EXR."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    shp = mod("models.shapes")
    mat = mod("models.bsdf.registry")
    em = mod("models.emitters")
    rng = mod("core.rng")
    b = mod("scene.scene").SceneBuilder(
        **({} if device is None else dict(device=device)))
    dev = {} if device is None else dict(device=b.device)

    def png(f, gamma):
        a = io.png_rgb(io.read_png(os.path.join(d, f))).astype(np.float32) \
            / 255.0
        return a ** gamma if gamma != 1.0 else a
    teapot = b.add_material(kind=mat.ROUGHPLASTIC, twosided=True,
                            eta=1.5 / 1.000277, diffuse=(0.2, 0.35, 0.6),
                            alpha=0.15, dist=0)
    t_floor = b.add_bitmap_texture(png("floor.png", 2.2) * 1.0, uscale=6.0,
                                   vscale=6.0)
    t_nrm = b.add_bitmap_texture(io.read_pfm(os.path.join(
        d, "floor_normal.pfm")))
    floor = b.add_material(kind=mat.DIFFUSE, twosided=True, eta=1.5046,
                           dist=0, tex_id=t_floor, nrm_tex_id=t_nrm,
                           nrm_kind=0, nrm_scale=1.0)
    t_bump = b.add_bitmap_texture(png("bump.png", 1.0))
    ripples = b.add_material(kind=mat.DIFFUSE, twosided=False, eta=1.5046,
                             dist=0, diffuse=(0.55, 0.5, 0.45),
                             nrm_tex_id=t_bump, nrm_kind=1, nrm_scale=0.01)
    t_curv = b.add_vertexcolor_texture()
    b.curvature_scale = 0.5
    blob = b.add_material(kind=mat.DIFFUSE, twosided=False, eta=1.5046,
                          dist=0, tex_id=t_curv, __curvature__=True)
    b.add_material(kind=mat.DIFFUSE)
    proto = b.add_prototype(shp.compute_smooth_normals(shp.load_obj(
        os.path.join(d, "teapot.obj"))), teapot)
    for s, a, x, z in scene_xmls.instance_poses(grid):
        b.add_material(kind=mat.DIFFUSE)
        b.add_instance(proto, _chain(_scale(s), _rot((0, 1, 0), a),
                                     _move(x=x, z=z)))
    b.add_mesh(shp.rectangle(), floor,
               to_world=_chain(_scale(30.0), _rot((1, 0, 0), -90.0)))
    yy, xx = np.meshgrid(np.linspace(0, 4 * np.pi, 65),
                         np.linspace(0, 4 * np.pi, 65))
    b.add_mesh(shp.heightfield(0.1 * np.sin(xx) * np.cos(yy), scale_z=4.0),
               ripples, to_world=_chain(_scale(4.0, 4.0, 1.0),
                                        _rot((1, 0, 0), -90.0),
                                        _move(-8.0, 0.5, 22.0)))
    b.add_morph_mesh(shp.load_obj(os.path.join(d, "sphere0.obj")),
                     shp.load_obj(os.path.join(d, "sphere1.obj")), blob,
                     to_world=_chain(_scale(2.5), _move(8.0, 2.5, 22.0)),
                     time=0.5)
    b.env = em.make_envmap(np.full((64, 128, 3), 0.8, np.float32),
                           np.eye(3), scale=1.0, **dev)
    w, h = (max(8, int(round(x * res_scale))) for x in RES)
    cam = mod("models.sensors").Camera.perspective(
        mod("core.math").matrix_lookat(*EYE), 45.0, w, h, fov_axis="x")
    film = mod("film.film").Film.make(w, h, "tent", 2.2)
    m_res = max(1, math.ceil(math.log2(max(w, h))))
    return b.build(cam, film, spp=spp, max_depth=depth,
                   sampler=(rng.SOBOL_QMC, m_res, w))
