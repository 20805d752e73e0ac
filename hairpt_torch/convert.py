"""Carry a scene built by the JAX package across to the port.

The input is the JAX scene's arrays with every leaf turned into numpy
(for example `jax.tree_util.tree_map(np.asarray, scene.arrays)`); this
module only reads attributes, so it needs no JAX. The result renders the
identical scene (same prim order, cluster layout, materials, hair tables
and baked environment) through hairpt_torch. params_to_torch and
grads_to_numpy carry a parameter dict of the JAX package's inverse
rendering across and its gradients back, so both packages can be
differentiated on one dict.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .film.film import Film
from .models import emitters as em
from .models.bsdf import registry as mat
from .models.sensors import Camera
from .ops.intersect_swept import SweptHair
from .scene.scene import HairGeom, RenderConfig, Scene, SceneArrays


def _t(a, device, dtype=None):
    a = np.array(a, copy=True, order="C")
    return torch.as_tensor(a, device=device, dtype=dtype)


def convert_arrays(arrays, device=None) -> SceneArrays:
    """JAX SceneArrays (numpy leaves; hair scene, tiled or swept
    traversal) -> hairpt_torch SceneArrays on `device`."""
    dev = resolve_device(device)
    h = arrays.hair
    sw = arrays.hair_swept
    m = arrays.materials
    hair = HairGeom(p0=_t(h.p0, dev, torch.float32),
                    p1=_t(h.p1, dev, torch.float32),
                    radius=_t(h.radius, dev, torch.float32))
    swept = SweptHair(*[_t(getattr(sw, f), dev, torch.float32)
                        for f in SweptHair._fields])
    materials = mat.MaterialTable(**{
        f: _t(getattr(m, f), dev) for f in mat.MaterialTable._fields})
    ht = arrays.hair_tables
    if ht is not None:
        ht = mat.HairTables(*[None if getattr(ht, f) is None else
                              _t(getattr(ht, f), dev, torch.float32)
                              for f in mat.HairTables._fields])
    env = None
    if arrays.env is not None:
        e = arrays.env
        env = em.EnvMap(image=_t(e.image, dev, torch.float32),
                        to_world=_t(e.to_world, dev, torch.float32),
                        to_local=_t(e.to_local, dev, torch.float32),
                        alias_idx=_t(e.alias_idx, dev, torch.int64),
                        alias_prob=_t(e.alias_prob, dev, torch.float32),
                        texel_pdf=_t(e.texel_pdf, dev, torch.float32))
    return SceneArrays(hair=hair,
                       hair_mat_id=_t(arrays.hair_mat_id, dev, torch.int32),
                       hair_swept=swept, materials=materials,
                       hair_tables=ht, env=env)


def convert_scene(scene, arrays, device=None) -> Scene:
    """A JAX Scene (read for its camera, film, config and active kinds)
    plus its numpy arrays -> a hairpt_torch Scene. Its materials may be
    any ported family (DIFFUSE, ROUGHPLASTIC and the hair kinds), its
    environment a baked sunsky, an envmap or a constant one, its sampler
    any of the five modes and its film any of the six filters; a thin
    lens, radial distortion, another camera kind or film annotations
    raise."""
    cam = scene.camera
    if int(cam.kind) != 0 or cam.aperture_radius or cam.kc0 or cam.kc1:
        raise NotImplementedError("only the pinhole perspective camera is "
                                  "ported (ROADMAP item 13)")
    if scene.film.annotations or scene.film.banner:
        raise NotImplementedError("film annotations and the banner are not "
                                  "ported yet (ROADMAP item 13)")
    camera = Camera(kind=int(cam.kind),
                    to_world=np.asarray(cam.to_world, np.float32),
                    tan_half_fov=float(np.float32(cam.tan_half_fov)),
                    aspect=cam.aspect, width=cam.width, height=cam.height,
                    near=cam.near, far=cam.far)
    fl = scene.film
    film = Film(fl.width, fl.height, fl.filter_kind, fl.filter_radius,
                fl.gamma)
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    cfg = RenderConfig(**{k: v for k, v in
                          dataclasses.asdict(scene.config).items()
                          if k in fields})
    if cfg.traversal not in ("tiled", "swept"):
        raise NotImplementedError("only traversal='tiled' and 'swept' are "
                                  "ported")
    active = tuple(int(k) for k in scene.active_kinds)
    mat.check_kinds(active)
    return Scene(arrays=convert_arrays(arrays, device), camera=camera,
                 film=film, config=cfg, active_kinds=active,
                 marschner_rows=tuple(int(r) for r in scene.marschner_rows))


def params_to_torch(params: dict, device=None) -> dict:
    """A params dict with numpy leaves (for example the JAX package's,
    through np.asarray) -> leaf tensors on `device` that require grad."""
    dev = resolve_device(device)
    return {k: _t(v, dev, torch.float32).requires_grad_()
            for k, v in params.items()}


def grads_to_numpy(grads: dict) -> dict:
    """Gradients (tensors, or None where none flowed) -> numpy arrays."""
    return {k: None if g is None else g.detach().cpu().numpy()
            for k, g in grads.items()}
