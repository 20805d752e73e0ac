"""Carry a scene built by the JAX package across to the port.

The input is the JAX scene's arrays with every leaf turned into numpy
(for example `jax.tree_util.tree_map(np.asarray, scene.arrays)`); this
module only reads attributes, so it needs no JAX. The result renders the
identical scene (same prim order, cluster layout, instance tables,
materials (and the cloth BSDF's weave tables), textures, hair tables,
baked environment, area and delta lights, shape-bounded media, the
dipole's samples and the scene medium) through hairpt_torch, with its
shutter, its camera's animation, its animated instances and its motion
tables. params_to_torch and grads_to_numpy carry a parameter dict of the
JAX package's inverse rendering across and its gradients back, so both
packages can be differentiated on one dict.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch

from . import resolve_device
from .core.track import AnimatedTransform
from .film.film import Film
from .models import emitters as em
from .models import media as med_mod
from .models import subsurface as sss_mod
from .models.bsdf import cloth as cloth_mod
from .models.bsdf import registry as mat
from .models.sensors import Camera
from .ops import instancing as inst_mod
from .ops.intersect import BVHArrays
from .ops.intersect_packed import PackedBVH
from .ops.intersect_swept import SweptHair
from .scene.scene import (TRAVERSALS, HairGeom, MotionTables, RenderConfig,
                          Scene, SceneArrays, TriGeom, TriShading, repose_fn)


def _t(a, device, dtype=None):
    a = np.array(a, copy=True, order="C")
    return torch.as_tensor(a, device=device, dtype=dtype)


def _tuple(cls, src, dev, dtypes=None):
    """cls (a NamedTuple of tensors) from src's attributes, or None."""
    if src is None:
        return None
    dtypes = dtypes or {}
    return cls(**{f: _t(getattr(src, f), dev, dtypes.get(f, torch.float32))
                  for f in cls._fields})


def _instances(inst, dev):
    """The JAX package's InstancedGeo (numpy leaves) in the port's
    one-launch layout."""
    protos = [inst_mod.ProtoGeo(
        bvh=_tuple(PackedBVH, pr.bvh, dev),
        **{f: _t(getattr(pr, f), dev, torch.int32 if f == "mat_id"
                 else torch.float32) for f in inst_mod._SHADING},
        obj_lo=np.asarray(pr.obj_lo, np.float32),
        obj_hi=np.asarray(pr.obj_hi, np.float32)) for pr in inst.protos]
    return inst_mod.assemble(protos, inst.proto_id, np.asarray(inst.w2o),
                             np.asarray(inst.nrm_m), np.asarray(inst.aabb_lo),
                             np.asarray(inst.aabb_hi), dev)


def convert_arrays(arrays, device=None) -> SceneArrays:
    """JAX SceneArrays (numpy leaves) -> hairpt_torch SceneArrays on
    `device`: triangles (their shading, packed BVH and BVHArrays),
    instances, hair (its packed BVH, BVHArrays and swept layout),
    materials, textures (bitmaps and mips included), hair tables, the
    environment, the area and delta lights, the shape-bounded media
    (tri_med, media) and the dipole's samples (sss)."""
    dev = resolve_device(device)
    i32 = torch.int32
    m = arrays.materials
    cloth = _tuple(cloth_mod.ClothTable, getattr(m, "cloth", None), dev,
                   {"pattern": i32})
    materials = mat.MaterialTable(cloth=cloth, **{
        f: _t(getattr(m, f), dev) for f in mat.MaterialTable._fields
        if f != "cloth"})
    ck = arrays.checkers
    checkers = None
    if ck is not None:
        checkers = _tuple(mat.CheckerboardTable, ck, dev, {"kind": i32})
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
    bvh_types = {"node_left": i32, "node_count": i32, "node_skip": i32}
    return SceneArrays(
        tri=_tuple(TriGeom, arrays.tri, dev),
        tri_shading=_tuple(TriShading, arrays.tri_shading, dev,
                           {"mat_id": i32, "emitter_id": i32}),
        tri_packed=_tuple(PackedBVH, arrays.tri_packed, dev),
        hair=_tuple(HairGeom, arrays.hair, dev),
        hair_mat_id=None if arrays.hair_mat_id is None
        else _t(arrays.hair_mat_id, dev, i32),
        hair_packed=_tuple(PackedBVH, arrays.hair_packed, dev),
        hair_swept=_tuple(SweptHair, arrays.hair_swept, dev),
        materials=materials, checkers=checkers, hair_tables=ht, env=env,
        inst=None if getattr(arrays, "inst", None) is None
        else _instances(arrays.inst, dev),
        tri_bvh=_tuple(BVHArrays, getattr(arrays, "tri_bvh", None), dev,
                       bvh_types),
        hair_bvh=_tuple(BVHArrays, getattr(arrays, "hair_bvh", None), dev,
                        bvh_types),
        area=_tuple(em.AreaLights, getattr(arrays, "area", None), dev,
                    {"tri_index": i32}),
        delta=_tuple(em.DeltaLights, getattr(arrays, "delta", None), dev,
                     {"kind": i32}),
        sss=_sss(getattr(arrays, "sss", None), dev),
        tri_med=None if getattr(arrays, "tri_med", None) is None
        else _t(arrays.tri_med, dev, i32),
        media=_tuple(med_mod.MediumTable, getattr(arrays, "media", None),
                     dev))


def _sss(s, dev):
    """The JAX package's SSSSamples (numpy leaves), or None."""
    if s is None:
        return None
    p = s.params
    params = sss_mod.SSSParams(
        sigma_s=_t(p.sigma_s, dev, torch.float32),
        sigma_a=_t(p.sigma_a, dev, torch.float32),
        eta=_t(p.eta, dev, torch.float32),
        scale=_t(p.scale, dev, torch.float32), g=float(p.g))
    return sss_mod.SSSSamples(
        pos=_t(s.pos, dev, torch.float32), irr=_t(s.irr, dev, torch.float32),
        area=_t(s.area, dev, torch.float32),
        cell=_t(s.cell, dev, torch.int64),
        grid_min=_t(s.grid_min, dev, torch.float32),
        inv_cell=_t(s.inv_cell, dev, torch.float32),
        grid_res=int(s.grid_res), params=params)


def convert_medium(medium, device=None):
    """The JAX package's Medium or HeteroMedium (its grid volume dense or
    block-sparse) on `device`, or None."""
    if medium is None:
        return None
    dev = resolve_device(device)

    def f(x):
        return None if x is None else _t(x, dev, torch.float32)
    if hasattr(medium, "vol"):
        v = medium.vol
        if hasattr(v, "block_idx"):
            vol = med_mod.HGridVolume(
                block_idx=_t(v.block_idx, dev, torch.int32),
                blocks=f(v.blocks), world_min=f(v.world_min),
                inv_extent=f(v.inv_extent))
        else:
            vol = med_mod.GridVolume(data=f(v.data), world_min=f(v.world_min),
                                     inv_extent=f(v.inv_extent))
        return med_mod.HeteroMedium(
            vol=vol, sigma_t=f(medium.sigma_t), albedo=f(medium.albedo),
            g=f(medium.g), majorant=f(medium.majorant),
            phase_kind=int(medium.phase_kind),
            max_steps=int(medium.max_steps),
            **med_mod.host_scalars(np.asarray(medium.majorant),
                                   np.asarray(medium.sigma_t)))
    return med_mod.Medium(
        sigma_t=f(medium.sigma_t), albedo=f(medium.albedo), g=f(medium.g),
        fog_depth=f(medium.fog_depth), phase_kind=int(medium.phase_kind),
        phase_p=f(medium.phase_p), orientation=f(medium.orientation),
        mix=tuple((int(k), float(w), float(g)) for k, w, g in medium.mix))


def _animation(anim):
    """The JAX package's AnimatedTransform as the port's (its decomposed
    keyframes taken over as they are), or None."""
    if anim is None:
        return None
    return AnimatedTransform.from_tracks(anim.times, anim.tr)


def _repose_inst(repose):
    """The port's repose_inst for the JAX package's: its base instance
    list and animations are the closure's default arguments (_base,
    _anims)."""
    if repose is None:
        return None
    params = inspect.signature(repose).parameters
    return repose_fn([(int(i), np.asarray(m, np.float64))
                      for i, m in params["_base"].default],
                     {int(k): _animation(a)
                      for k, a in params["_anims"].default.items()})


def convert_scene(scene, arrays, device=None) -> Scene:
    """A JAX Scene (read for its camera, film, config and active kinds)
    plus its numpy arrays -> a hairpt_torch Scene. Its materials may be
    any family (CLOTH with its weave tables, the wrappers and DIPOLE
    included), its camera any of the nine sensor kinds (a thin lens's
    aperture and focus and the radial distortion come across), its
    environment a baked sunsky, an envmap or a constant one, with
    area and delta lights beside it or in its place, its
    sampler any of the five modes, its film any of the six filters and
    its traversal any of scene.TRAVERSALS. Its shutter, the camera's
    animation and the animated instances come across. A JAX rebuild_geo
    (animated or deformable meshes under an open shutter) is a closure
    over a JAX builder, so it raises: build such a scene on both sides
    from one XML or one builder script. The film's annotations and
    banner come across; the integrator type (any string, as the loaders
    take it), the scene medium, the delta lights and the motion
    integrator's tables (tri_obj, obj_m and the camera at the target
    time) come across."""
    shutter = tuple(float(x) for x in getattr(scene, "shutter", (0.0, 0.0)))
    if shutter[1] > shutter[0] \
            and getattr(scene, "rebuild_geo", None) is not None:
        raise NotImplementedError(
            "the scene's rebuild_geo is a closure over a JAX SceneBuilder "
            "and cannot be carried across; build the animated meshes on "
            "both sides from one XML (xml_loader.load_scene) or one "
            "builder script")
    camera = convert_camera(scene.camera)
    fl = scene.film
    film = Film(fl.width, fl.height, fl.filter_kind, fl.filter_radius,
                fl.gamma, tuple((int(x), int(y), str(t))
                                for x, y, t in fl.annotations),
                bool(fl.banner))
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    cfg = RenderConfig(**{k: v for k, v in
                          dataclasses.asdict(scene.config).items()
                          if k in fields})
    if cfg.traversal not in TRAVERSALS:
        raise ValueError(f"traversal {cfg.traversal!r} is not one of "
                         f"{TRAVERSALS}")
    active = tuple(int(k) for k in scene.active_kinds)
    mat.check_kinds(active)
    return Scene(arrays=convert_arrays(arrays, device), camera=camera,
                 film=film, config=cfg, active_kinds=active,
                 marschner_rows=tuple(int(r) for r in scene.marschner_rows),
                 has_normal_maps=bool(getattr(scene, "has_normal_maps",
                                              False)),
                 shutter=shutter,
                 camera_anim=_animation(getattr(scene, "camera_anim", None)),
                 repose_inst=_repose_inst(getattr(scene, "repose_inst",
                                                  None)),
                 medium=convert_medium(getattr(scene, "medium", None),
                                       device),
                 motion=convert_motion(getattr(scene, "motion", None),
                                       device))


def convert_camera(cam) -> Camera:
    """The JAX package's Camera (any leaf type) -> the port's."""
    return Camera(kind=int(cam.kind),
                  to_world=np.asarray(cam.to_world, np.float32),
                  tan_half_fov=float(np.float32(cam.tan_half_fov)),
                  aspect=cam.aspect, width=cam.width, height=cam.height,
                  near=cam.near, far=cam.far,
                  aperture_radius=float(cam.aperture_radius),
                  focus_distance=float(cam.focus_distance),
                  kc0=float(cam.kc0), kc1=float(cam.kc1))


def convert_motion(motion, device=None):
    """The JAX package's MotionTables (any leaf type) -> the port's, or
    None."""
    if motion is None:
        return None
    dev = resolve_device(device)
    return MotionTables(
        tri_obj=None if motion.tri_obj is None
        else _t(motion.tri_obj, dev, torch.int32),
        obj_m=_t(motion.obj_m, dev, torch.float32),
        cam1=convert_camera(motion.cam1))


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
