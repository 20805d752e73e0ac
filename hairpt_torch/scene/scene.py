"""Scene assembly (port of hairpt/scene/scene.py): host-side build ->
torch arrays on the device + static config.

Triangle meshes are flattened into one triangle pool and hair fibers into
one segment pool, each under its own SAH BVH; instanced meshes keep one
object-space tree per prototype (ops/instancing.py); materials, textures
(procedural and bitmap, the bitmaps with their mip pyramid) and the
environment become tables. The triangles are walked by the packed BVH
walk (ops/intersect_packed.py, kernel F on the card), the instances by
the two-level walk (kernel G); the hair by the tiled or the swept
traversal, or by the packed walk under traversal='packed'. Under
traversal='perray' or 'blocked' the triangles and the hair are walked
over their BVHArrays instead (ops/intersect.py, kernel H;
ops/intersect_blocked.py, kernel I). 'tiled_sub' is the tiled traversal
with kernel A culling the 32-segment sub-cluster boxes.

Lights: the environment, area lights (meshes added with a radiance:
their triangles, in BVH order, become the AreaLights table) and delta
lights (delta_lights: point, spot, directional, collimated); NEE picks
among the kinds present with equal probability (RenderConfig.nee_probs).

Media and subsurface: SceneBuilder.medium (a media.Medium or
HeteroMedium, the scene-level medium of integrators/volpath.py),
add_medium and mesh_media (shape-bounded media: the per-triangle
tri_med ids, in BVH order, and the MediumTable), and the DIPOLE rows
whose samples integrators/sss.attach_dipole puts in SceneArrays.sss;
RenderConfig.integrator, sss_single and sss_g as the loader reads them.

Motion blur: a sensor's shutter (open, close) with close > open makes
render() give sample index s the time t_s = open + (s + 1/2) / spp *
(close - open), at which it poses the animated camera (camera_anim),
rebuilds the triangles (rebuild_geo: deformable pairs re-lerped,
animated meshes moved, the area-light table built from the moved
triangles) and re-poses the animated instances
(repose_inst). The hair never moves, so a rebuild keeps its arrays.

Motion vectors: add_mesh(motion=M) and SceneBuilder.camera1 give the
scene its MotionTables (the motion integrator's): each triangle's object
id in BVH order, each object's relative motion T(t1) T(t0)^-1 and the
camera at the target time.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import rng
from ..film.film import Film
from ..models import emitters as em
from ..models import shapes as shp
from ..models.bsdf import registry as mat
from ..models.bsdf import hair as hair_bsdf  # registers the hair kinds
from ..models.bsdf import plastic  # noqa: F401  (registers the plastics)
from ..models.bsdf import simple  # noqa: F401  (registers the simple kinds)
from ..models.bsdf import dielectric_rough  # noqa: F401  (registers them)
from ..models.bsdf import hk  # noqa: F401  (registers HK)
from ..models.bsdf import cloth as cloth_bsdf  # registers CLOTH
from ..models import media as med_mod
from ..models.bsdf import tables as rt_tables
from ..models.bsdf.fresnel import fresnel_diffuse_reflectance
from ..models.sensors import Camera
from ..ops import bvh as bvh_mod
from ..ops import instancing as inst_mod
from ..ops import intersect as isec
from ..ops import intersect_packed as ipk
from ..ops import intersect_swept as iswept
from . import hairgen

TRAVERSALS = ("tiled", "tiled_sub", "swept", "packed", "perray",
              "blocked")


class TriGeom(NamedTuple):
    """Triangles in BVH prim order (the ids the walk returns)."""
    p0: torch.Tensor   # [N, 3]
    e1: torch.Tensor   # [N, 3] v1 - v0
    e2: torch.Tensor   # [N, 3] v2 - v0


class TriShading(NamedTuple):
    """Per-triangle shading attributes, in BVH prim order."""
    n0: torch.Tensor          # [N, 3] vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor         # [N, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor      # [N] int32
    emitter_id: torch.Tensor  # [N] int32 area-light index, -1 = none
    uv_density: torch.Tensor  # [N] sqrt(uv area / world area)
    vc0: torch.Tensor         # [N, 3] vertex colours (default 1)
    vc1: torch.Tensor
    vc2: torch.Tensor


class HairGeom(NamedTuple):
    """Hair segments in BVH prim order (the ids the intersector returns)."""
    p0: torch.Tensor      # [S, 3]
    p1: torch.Tensor      # [S, 3]
    n0: torch.Tensor      # [S, 3] first miter plane normal
    n1: torch.Tensor      # [S, 3] second miter plane normal
    radius: torch.Tensor  # [S]


class SceneArrays(NamedTuple):
    tri: Optional[TriGeom]
    tri_shading: Optional[TriShading]
    tri_packed: Optional[ipk.PackedBVH]
    hair: Optional[HairGeom]
    hair_mat_id: Optional[torch.Tensor]     # [S] int32
    hair_packed: Optional[ipk.PackedBVH]
    hair_swept: Optional[iswept.SweptHair]
    materials: mat.MaterialTable
    checkers: Optional[mat.CheckerboardTable]
    hair_tables: Optional[mat.HairTables]
    env: Optional[em.EnvMap]
    inst: Optional[inst_mod.InstancedGeo] = None  # shapegroup / instance
    tri_bvh: Optional[isec.BVHArrays] = None   # the trees of tri_packed
    hair_bvh: Optional[isec.BVHArrays] = None  # and hair_packed, as SoA
    area: Optional[em.AreaLights] = None       # emissive triangles
    delta: Optional[em.DeltaLights] = None     # point, spot, ... lights
    sss: object = None       # subsurface.SSSSamples (dipole), attached by
    #                          integrators/sss.attach_dipole
    tri_med: Optional[torch.Tensor] = None     # [Ntri, 2] int32 (interior,
    #                          exterior) medium ids, 0 = vacuum
    media: Optional[med_mod.MediumTable] = None  # shape-bounded media

    @property
    def device(self) -> torch.device:
        return self.materials.kind.device


class MotionTables(NamedTuple):
    """Per-object rigid motion for the motion integrator (reference:
    src/integrators/misc/motion.cpp): obj_m[k] maps a world-space point
    on object k at the frame time to the target time (T(t1) T(t0)^-1);
    cam1 is the sensor at the target time."""
    tri_obj: Optional[torch.Tensor]  # [Ntri] int32 object id, BVH order
    obj_m: torch.Tensor              # [O, 4, 4] relative motion
    cam1: Camera                     # the camera at the target time


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (the JAX package's names and defaults;
    the sampler default is the ported INDEPENDENT mode)."""
    width: int
    height: int
    spp: int
    max_depth: int = 65
    rr_depth: int = 5
    strict_normals: bool = True
    sampler: object = rng.INDEPENDENT   # or (rng.SOBOL_QMC, m, width)
    ray_eps: float = 1e-3
    traversal: str = "tiled"    # the hair's: 'tiled' | 'tiled_sub' |
    #                             'swept' | 'packed'; 'perray' | 'blocked'
    #                             for both triangles and hair
    block: int = 256            # rays per block ('blocked')
    swept_k: int = 128          # segments per cluster
    swept_c: int = 0            # cluster count (filled at build)
    swept_pmax: int = 24        # phase-A candidate clusters per ray ('swept')
    swept_chunk: int = 64       # pairs per phase-B chunk ('swept')
    tiled_q: int = 128          # candidate clusters per 64-ray tile
    tiled_short: float = 0.0    # short-ray-first clamp of the sorted
    #                             (bounce and shadow) tiled queries; a
    #                             hair scene's build turns 0 into -1, off
    nee_probs: tuple = (1.0, 0.0, 0.0)   # (env, area, delta)
    nee_rr: float = 0.0         # shadow-ray Russian roulette threshold
    integrator: str = "path"    # the scene XML's integrator type
    sss_single: bool = False    # subsurface: single scattering (vs dipole)
    sss_g: float = 0.0          # HG anisotropy of single scattering
    motion_config: str = "d"    # the motion integrator's path config
    tiled_film: bool = False    # a tiledhdrfilm: the CLI streams bands


class Scene(NamedTuple):
    arrays: SceneArrays
    camera: Camera
    film: Film
    config: RenderConfig
    active_kinds: tuple
    marschner_rows: tuple = ()  # material-row index per hair-table aux_id
    has_normal_maps: bool = False  # any normal- or bump-mapped material
    shutter: tuple = (0.0, 0.0)    # (open, close); close > open: blur
    camera_anim: object = None     # AnimatedTransform of the sensor
    rebuild_geo: object = None     # t -> SceneArrays with the triangles
    #                                (and the area lights on them) posed
    #                                at time t (animated meshes,
    #                                deformable pairs)
    repose_inst: object = None     # (arrays, t) -> arrays with the
    #                                animated instances posed at t
    medium: object = None          # media.Medium or HeteroMedium: the
    #                                scene-level medium of volpath
    motion: object = None          # MotionTables (the motion integrator)


# the bitmaps' pre-blurred pyramid (the JAX package's _build_mips)
_build_mips = mat.build_mips


def _uv_density(uv0, uv1, uv2, e1, e2):
    """sqrt(uv area / world area) per triangle: a world-space footprint
    in uv units (the JAX package's mip LOD factor)."""
    a = uv1 - uv0
    b = uv2 - uv0
    uv_area = 0.5 * np.abs(a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
    w_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    return np.sqrt(uv_area / np.maximum(w_area, 1e-20))


class SceneBuilder:
    """Imperative host-side builder: materials, textures, meshes, fibers
    and an environment, then build() puts the arrays on `device` (the card
    unless "cpu")."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.tri_meshes = []       # (Mesh in world space, mat_id,
        #                            emitter id or -1)
        self.area_lights = []      # radiance [3] f32 per emissive mesh
        self.delta_lights = []     # make_delta_lights entries
        self.fibers = []
        self.materials = []
        self.checkers = []         # procedural texture rows
        self.hair_aux = []         # (sigma_a, beta_r, eta) per hair table
        self.cloth = []            # (WeavePattern, repeatU, repeatV) per
        #                            CLOTH row's aux_id
        self.env: Optional[em.EnvMap] = None
        self.curvature_mats = set()  # material ids whose texture is
        self.curvature_scale = 1.0   # the curvature texture
        self.protos = []           # (Mesh in object space, mat_id)
        self.instances = []        # (prototype index, to_world 4 x 4)
        self.shutter = (0.0, 0.0)  # (open, close); close > open: blur
        self.camera_anim = None    # the sensor's AnimatedTransform
        self.animated_meshes = {}  # mesh index -> AnimatedTransform (the
        #                            mesh stored at shutter open)
        self.morph_meshes = {}     # mesh index -> (mesh at 0, mesh at 1)
        #                            in world space (deformable pairs)
        self.instance_anims = {}   # instance index -> AnimatedTransform
        self.medium = None         # Medium or HeteroMedium (volpath)
        self.media_rows = []       # shape-bounded media (ids 1-based)
        self.mesh_media = {}       # mesh index -> (interior, exterior) id
        self.mesh_motion = {}      # mesh index -> 4 x 4 relative motion
        self.camera1 = None        # the camera at the motion target time

    # -- materials and textures --------------------------------------------

    def add_material(self, **row) -> int:
        is_curv = row.pop("__curvature__", False)
        kind = row.get("kind", mat.DIFFUSE)
        mat.check_kinds([kind])
        # per-material precomputed transmittance slices
        if kind in (mat.ROUGHPLASTIC, mat.MARSCHNER, mat.MARSCHNER_PURE,
                    mat.ROUGHCOATING):
            dist = row.get("dist", 0)
            eta = row.get("eta", 1.5)
            alpha = row.get("alpha", 0.1)
            rt = rt_tables.get(dist, eta)
            cosg = (np.arange(mat.N_COS) + 0.5) / mat.N_COS
            row["ext_trans"] = rt.eval_np(cosg, np.full(mat.N_COS, alpha))
            row["int_fdr"] = 1.0 - rt_tables.get(dist, 1.0 / eta) \
                .eval_diffuse_np(alpha)
        if kind in (mat.COATING, mat.ROUGHCOATING):
            # the specular sampling weight from the layer's average
            # absorption (coating.cpp configure(): 1 / (avgAbsorption + 1))
            sa = np.asarray(row.get("sigma_a", (0.0,) * 3), np.float64)
            avg_absorb = float(np.mean(np.exp(-2.0 * sa)))
            row.setdefault("spec_weight", 1.0 / (avg_absorb + 1.0))
        if kind == mat.PLASTIC:
            row["int_fdr"] = fresnel_diffuse_reflectance(
                1.0 / row.get("eta", 1.5))
        if kind in (mat.MARSCHNER, mat.MARSCHNER_PURE):
            row["aux_id"] = len(self.hair_aux)
            self.hair_aux.append((row.get("sigma_a", (0.5, 0.5, 0.5)),
                                  row.get("beta_r", 0.1),
                                  row.get("eta", 1.55)))
        if kind == mat.CLOTH:
            # irawan woven cloth: the weave pattern rides a side table
            # (ClothTable), the pattern's scalars ride the row (see
            # models/bsdf/cloth.py)
            wp = row.pop("weave")
            ru = row.pop("repeat_u", 1.0)
            rv = row.pop("repeat_v", 1.0)
            row["aux_id"] = len(self.cloth)
            self.cloth.append((wp, ru, rv))
            row["transmit"] = (wp.alpha, wp.beta, wp.ss)
            row["k"] = (wp.h_width, 0.0, 0.0)
            row.setdefault("diffuse", tuple(np.mean(
                [y["kd"] for y in wp.yarns], axis=0)))
            row.setdefault("specular", tuple(np.mean(
                [y["ks"] for y in wp.yarns], axis=0)))
        # luminance-based lobe weights (reference: configure() of each BSDF)
        lum = np.array([0.212671, 0.715160, 0.072169])
        d = float(np.dot(np.asarray(row.get("diffuse", (0.5,) * 3)), lum))
        s = float(np.dot(np.asarray(row.get("specular", (1.0,) * 3)), lum))
        t = float(np.dot(np.asarray(row.get("transmit", (1.0,) * 3)), lum))
        if "spec_weight" not in row:
            if kind == mat.MARSCHNERDIELECTRIC:
                row["spec_weight"] = (s + t) / max(d + s + t, 1e-9)
            else:
                row["spec_weight"] = s / max(d + s, 1e-9)
        self.materials.append(mat.default_material_row(**row))
        if is_curv:
            self.curvature_mats.add(len(self.materials) - 1)
        return len(self.materials) - 1

    def add_checkerboard(self, color0, color1, uscale=1.0, vscale=1.0,
                         uoffset=0.0, voffset=0.0) -> int:
        """reference: src/textures/checkerboard.cpp"""
        self.checkers.append((mat.TEX_CHECKER, color0, color1,
                              (uscale, vscale), (uoffset, voffset), 0.01))
        return len(self.checkers) - 1

    def add_gridtexture(self, color0, color1, line_width=0.01, uscale=1.0,
                        vscale=1.0, uoffset=0.0, voffset=0.0) -> int:
        """reference: src/textures/gridtexture.cpp"""
        self.checkers.append((mat.TEX_GRID, color0, color1,
                              (uscale, vscale), (uoffset, voffset),
                              line_width))
        return len(self.checkers) - 1

    def add_wireframe_texture(self, color0=(0.1,) * 3, color1=(0.6,) * 3,
                              line_width=0.05) -> int:
        """reference: src/textures/wireframe.cpp (edge distance in
        barycentric units)"""
        self.checkers.append((mat.TEX_WIREFRAME, color0, color1, (1.0, 1.0),
                              (0.0, 0.0), line_width))
        return len(self.checkers) - 1

    def add_vertexcolor_texture(self) -> int:
        """reference: src/textures/vertexcolors.cpp"""
        self.checkers.append((mat.TEX_VERTEXCOLORS, (1, 1, 1), (1, 1, 1),
                              (1.0, 1.0), (0.0, 0.0), 0.01))
        return len(self.checkers) - 1

    def add_bitmap_texture(self, image, uscale=1.0, vscale=1.0,
                           uoffset=0.0, voffset=0.0, res=256) -> int:
        """image: [H, W, 3] linear float, resampled (nearest) to res x
        res; reference: src/textures/bitmap.cpp."""
        img = np.asarray(image, np.float32)
        ys = (np.arange(res) + 0.5) / res * img.shape[0]
        xs = (np.arange(res) + 0.5) / res * img.shape[1]
        img_r = img[np.clip(ys.astype(int), 0, img.shape[0] - 1)][
            :, np.clip(xs.astype(int), 0, img.shape[1] - 1)]
        self.checkers.append((mat.TEX_BITMAP, (0, 0, 0), (0, 0, 0),
                              (uscale, vscale), (uoffset, voffset), 0.01,
                              img_r))
        return len(self.checkers) - 1

    # -- geometry ----------------------------------------------------------

    def add_mesh(self, mesh: shp.Mesh, mat_id: int, to_world=None,
                 radiance=None, motion=None):
        """radiance: the mesh is an area light of that radiance (reference:
        src/emitters/area.cpp), each of its triangles an entry of the
        AreaLights table. motion: the world-space relative motion
        T(t1) T(t0)^-1 of the mesh, for the motion integrator."""
        if motion is not None:
            self.mesh_motion[len(self.tri_meshes)] = np.asarray(motion,
                                                                np.float32)
        if to_world is not None:
            mesh = shp.transform_mesh(mesh, to_world)
        emitter_id = -1
        if radiance is not None:
            emitter_id = len(self.area_lights)
            self.area_lights.append(np.asarray(radiance, np.float32))
        self.tri_meshes.append((self._curvature_fixup(mesh, mat_id),
                                mat_id, emitter_id))

    def _curvature_fixup(self, mesh: shp.Mesh, mat_id: int) -> shp.Mesh:
        """Bake the curvature texture's vertex colours (|K| tanh
        compressed; negative K red, positive green)."""
        if mat_id in self.curvature_mats and mesh.colors is None:
            k = shp.vertex_gaussian_curvature(mesh)
            v = np.tanh(np.abs(k) * self.curvature_scale)
            cols = np.zeros((len(k), 3), np.float32)
            cols[:, 0] = np.where(k < 0, v, 0.0)
            cols[:, 1] = np.where(k >= 0, v, 0.0)
            mesh = mesh._replace(colors=cols)
        return mesh

    def add_morph_mesh(self, m0: shp.Mesh, m1: shp.Mesh, mat_id: int,
                       to_world=None, radiance=None, time: float = 0.0):
        """A keyframe morph (reference: src/shapes/deformable.cpp) built at
        scene time `time`; its world-space pair is kept, and under an open
        shutter rebuild_geo re-lerps it at each shutter time (clipped to
        [0, 1]). radiance as in add_mesh."""
        k = len(self.tri_meshes)
        self.add_mesh(shp.lerp_mesh(m0, m1, float(np.clip(time, 0, 1))),
                      mat_id, to_world=to_world, radiance=radiance)
        if to_world is not None:
            m0 = shp.transform_mesh(m0, to_world)
            m1 = shp.transform_mesh(m1, to_world)
        self.morph_meshes[k] = (m0, m1)

    def add_prototype(self, mesh: shp.Mesh, mat_id: int) -> int:
        """Register a shared object-space prototype (a shapegroup child,
        reference: src/shapes/shapegroup.cpp). Returns its index."""
        self.protos.append((mesh, mat_id))
        return len(self.protos) - 1

    def add_instance(self, proto_idx: int, to_world, anim=None):
        """Instance a prototype (reference: src/shapes/instance.cpp): the
        geometry is shared through the two-level walk, not flattened.
        anim: an AnimatedTransform of to_world; under an open shutter
        repose_inst re-poses the instance table at each shutter time."""
        self.instances.append((proto_idx, np.asarray(to_world, np.float64)))
        if anim is not None:
            self.instance_anims[len(self.instances) - 1] = anim

    def add_medium(self, sigma_s, sigma_a, g=0.0) -> int:
        """A shape-boundable homogeneous medium; returns its 1-based id
        (0 = vacuum) for mesh_media entries."""
        self.media_rows.append(dict(sigma_s=sigma_s, sigma_a=sigma_a, g=g))
        return len(self.media_rows)

    def add_fibers(self, fs: hairgen.FiberSet, mat_id: int):
        """One FiberSet (gen_hair_curl's clumps are added one by one, as
        in the JAX package)."""
        self.fibers.append((fs, mat_id))

    # -- build -------------------------------------------------------------

    def _meshes_at(self, t: float):
        """The meshes at shutter time t: each deformable pair re-lerped at
        clip(t, 0, 1) (its curvature colours baked again), then each
        animated mesh moved by anim(t) inv(anim(open)) (the JAX package's
        rebuild rules)."""
        meshes = list(self.tri_meshes)
        for k, (w0, w1) in self.morph_meshes.items():
            _, mid, eid = meshes[k]
            meshes[k] = (self._curvature_fixup(shp.lerp_mesh(
                w0, w1, float(np.clip(t, 0.0, 1.0))), mid), mid, eid)
        t_open = float(self.shutter[0])
        for k, anim in self.animated_meshes.items():
            rel = anim.eval(float(t)) @ np.linalg.inv(anim.eval(t_open))
            mesh, mid, eid = meshes[k]
            meshes[k] = (shp.transform_mesh(mesh, rel), mid, eid)
        return meshes

    def _build_triangles(self, t, meshes):
        """(TriGeom, TriShading, PackedBVH, BVHArrays, AreaLights or None,
        tri_med or None, the BVH's triangle order) of the meshes: the JAX package's triangle block,
        area-light table and per-triangle medium ids (mesh_media, in BVH
        order), dtype for dtype."""
        v0l, v1l, v2l, n0l, n1l, n2l = [], [], [], [], [], []
        uv0l, uv1l, uv2l, midl, vc0l, vc1l, vc2l = [], [], [], [], [], [], []
        eidl = []
        for mesh, mid, eid in meshes:
            f = mesh.faces
            p = mesh.positions
            v0, v1, v2 = p[f[:, 0]], p[f[:, 1]], p[f[:, 2]]
            v0l.append(v0)
            v1l.append(v1)
            v2l.append(v2)
            if mesh.normals is not None:
                nn = mesh.normals
                n0l.append(nn[f[:, 0]])
                n1l.append(nn[f[:, 1]])
                n2l.append(nn[f[:, 2]])
            else:
                gn = np.cross(v1 - v0, v2 - v0)
                gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                                 1e-20)
                n0l.append(gn)
                n1l.append(gn)
                n2l.append(gn)
            if mesh.uvs is not None:
                uv = mesh.uvs
                uv0l.append(uv[f[:, 0]])
                uv1l.append(uv[f[:, 1]])
                uv2l.append(uv[f[:, 2]])
            else:
                z = np.zeros((len(f), 2))
                uv0l.append(z)
                uv1l.append(z)
                uv2l.append(z)
            midl.append(np.full(len(f), mid, np.int32))
            eidl.append(np.full(len(f), eid, np.int32))
            if mesh.colors is not None:
                cc = mesh.colors
                vc0l.append(cc[f[:, 0]])
                vc1l.append(cc[f[:, 1]])
                vc2l.append(cc[f[:, 2]])
            else:
                one = np.ones((len(f), 3), np.float32)
                vc0l.append(one)
                vc1l.append(one)
                vc2l.append(one)
        cat = np.concatenate
        v0, v1, v2 = cat(v0l), cat(v1l), cat(v2l)
        fb = bvh_mod.build(np.minimum(np.minimum(v0, v1), v2),
                           np.maximum(np.maximum(v0, v1), v2))
        o = fb.prim_order
        f32 = torch.float32
        p0_s = v0[o].astype(np.float32)
        e1_s = (v1 - v0)[o].astype(np.float32)
        e2_s = (v2 - v0)[o].astype(np.float32)
        tri = TriGeom(p0=t(p0_s, f32), e1=t(e1_s, f32), e2=t(e2_s, f32))
        eid = cat(eidl)[o]
        rows = ipk.tri_pack_rows(v0[o].astype(np.float32),
                                 v1[o].astype(np.float32),
                                 v2[o].astype(np.float32),
                                 np.arange(len(o), dtype=np.int32))
        packed = ipk.pack_bvh(fb, rows, device=self.device)
        shading = TriShading(
            n0=t(cat(n0l)[o], f32), n1=t(cat(n1l)[o], f32),
            n2=t(cat(n2l)[o], f32), uv0=t(cat(uv0l)[o], f32),
            uv1=t(cat(uv1l)[o], f32), uv2=t(cat(uv2l)[o], f32),
            mat_id=t(cat(midl)[o], torch.int32),
            emitter_id=t(eid, torch.int32),
            uv_density=t(_uv_density(cat(uv0l)[o], cat(uv1l)[o],
                                     cat(uv2l)[o], (v1 - v0)[o],
                                     (v2 - v0)[o]), f32),
            vc0=t(cat(vc0l)[o], f32), vc1=t(cat(vc1l)[o], f32),
            vc2=t(cat(vc2l)[o], f32))
        tri_med = None
        if self.mesh_media:
            tm = np.concatenate(
                [np.tile(np.asarray(self.mesh_media.get(k, (0, 0)),
                                    np.int32), (len(mesh.faces), 1))
                 for k, (mesh, _, _) in enumerate(meshes)])
            tri_med = t(tm[o], torch.int32)
        return (tri, shading, packed, isec.bvh_to_device(fb, self.device),
                self._area_table(t, p0_s, e1_s, e2_s, eid), tri_med, o)

    def _area_table(self, t, p0, e1, e2, eid):
        """AreaLights over the emissive triangles in BVH order (the JAX
        package's build: normals and areas from the f32 edges, the CDF by
        power luminance with 1e-12 per entry), or None."""
        sel = np.nonzero(eid >= 0)[0]
        if not self.area_lights or len(sel) == 0:
            return None
        p0, e1, e2 = p0[sel], e1[sel], e2[sel]
        nrm = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(nrm, axis=-1)
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                               1e-20)
        rad = np.stack([self.area_lights[e] for e in eid[sel]])
        power = area * (rad @ np.array([0.212671, 0.715160, 0.072169]))
        cdf = np.cumsum(power + 1e-12)
        cdf /= cdf[-1]
        f32 = torch.float32
        return em.AreaLights(p0=t(p0, f32), e1=t(e1, f32), e2=t(e2, f32),
                             n=t(nrm, f32), radiance=t(rad, f32),
                             area=t(area, f32), cdf=t(cdf, f32),
                             tri_index=t(sel.astype(np.int32), torch.int32))

    def _build_hair(self, t, cfg):
        segs = [hairgen.segments(fs) for fs, _ in self.fibers]
        p0 = np.concatenate([s["p0"] for s in segs])
        p1 = np.concatenate([s["p1"] for s in segs])
        n0 = np.concatenate([s["n0"] for s in segs])
        n1 = np.concatenate([s["n1"] for s in segs])
        rad = np.concatenate([s["radius"] for s in segs])
        mid = np.concatenate([np.full(len(s["p0"]), m, np.int32)
                              for s, (_, m) in zip(segs, self.fibers)])
        # conservative AABBs: expand by radius / steepest miter angle
        # (reference: HairKDTree::getAABB, hair.cpp:445-464)
        tang = p1 - p0
        tang = tang / np.maximum(np.linalg.norm(tang, axis=-1,
                                                keepdims=True), 1e-20)
        c0 = np.abs(np.sum(n0 * tang, -1))
        c1 = np.abs(np.sum(n1 * tang, -1))
        expand = rad / np.maximum(np.minimum(c0, c1), 0.3)
        lo = np.minimum(p0, p1) - expand[:, None]
        hi = np.maximum(p0, p1) + expand[:, None]
        fb = bvh_mod.build(lo, hi)
        o = fb.prim_order
        f32 = torch.float32
        hair = HairGeom(p0=t(p0[o], f32), p1=t(p1[o], f32),
                        n0=t(n0[o], f32), n1=t(n1[o], f32),
                        radius=t(rad[o], f32))
        rows = ipk.hair_pack_rows(p0[o], p1[o], n0[o], n1[o], rad[o],
                                  np.arange(len(o), dtype=np.int32))
        packed = ipk.pack_bvh(fb, rows, device=self.device)
        swept = iswept.build_swept_hair(p0[o], p1[o], n0[o], n1[o], rad[o],
                                        K=cfg.swept_k, device=self.device)
        return (hair, t(mid[o], torch.int32), packed, swept,
                isec.bvh_to_device(fb, self.device))

    def build(self, camera: Camera, film: Film, **config_kwargs) -> Scene:
        if "traversal" not in config_kwargs:
            config_kwargs["traversal"] = "tiled"
            config_kwargs.setdefault("tiled_q", 2048)
        if config_kwargs["traversal"] not in TRAVERSALS:
            raise ValueError(f"traversal {config_kwargs['traversal']!r} is "
                             f"not one of {TRAVERSALS}")
        if not self.fibers and not self.tri_meshes and not self.instances:
            raise ValueError("the scene has no geometry")
        cfg = RenderConfig(width=film.width, height=film.height,
                           **config_kwargs)
        dev = self.device

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        tri = tri_shading = tri_packed = tri_bvh = area = tri_med = None
        order = None
        if self.tri_meshes:
            tri, tri_shading, tri_packed, tri_bvh, area, tri_med, order = \
                self._build_triangles(t, self.tri_meshes)
        hair = hair_mat_id = hair_packed = swept = hair_bvh = None
        if self.fibers:
            hair, hair_mat_id, hair_packed, swept, hair_bvh = \
                self._build_hair(t, cfg)
            # short-ray-first stays opt-in, as in the JAX package: 0 means
            # off (-1), a positive value turns it on
            cfg = dataclasses.replace(
                cfg, swept_c=int(swept.seg_rows_t.shape[0]),
                tiled_short=-1.0 if cfg.tiled_short == 0.0
                else cfg.tiled_short)

        rows = self.materials or [mat.default_material_row(
            kind=mat.ROUGHPLASTIC)]
        cloth = cloth_bsdf.pack_cloth(
            [c[0] for c in self.cloth], [(c[1], c[2]) for c in self.cloth],
            device=dev) if self.cloth else None
        materials = mat.pack_materials(rows, device=dev, cloth=cloth)
        checkers = mat.pack_checkers(self.checkers, device=dev) \
            if self.checkers else None
        inst = None
        if self.instances:
            inst = inst_mod.build_instanced(
                [inst_mod.build_proto(m_, mid_, device=dev)
                 for m_, mid_ in self.protos], self.instances, device=dev)
        env = self.env.to(dev) if self.env is not None else None
        delta = em.make_delta_lights(self.delta_lights, device=dev) \
            if self.delta_lights else None
        # NEE picks among the kinds of source present with equal
        # probability
        present = [env is not None, area is not None, delta is not None]
        n_src = max(sum(present), 1)
        cfg = dataclasses.replace(cfg, nee_probs=tuple(
            (1.0 / n_src) if p else 0.0 for p in present))
        active = tuple(sorted({int(r["kind"]) for r in rows}))
        mat.check_kinds(active)
        ht = None
        if self.hair_aux:
            ht = hair_bsdf.hair_tables(torch.stack([
                hair_bsdf.precompute_azimuthal(sa, br, eta, device=dev)
                for sa, br, eta in self.hair_aux]))
        marschner_rows = tuple(
            i for i, r in enumerate(rows)
            if r["kind"] in (mat.MARSCHNER, mat.MARSCHNER_PURE))
        arrays = SceneArrays(tri=tri, tri_shading=tri_shading,
                             tri_packed=tri_packed, hair=hair,
                             hair_mat_id=hair_mat_id,
                             hair_packed=hair_packed, hair_swept=swept,
                             materials=materials, checkers=checkers,
                             hair_tables=ht, env=env, inst=inst,
                             tri_bvh=tri_bvh, hair_bvh=hair_bvh, area=area,
                             delta=delta, tri_med=tri_med,
                             media=med_mod.make_medium_table(
                                 self.media_rows, device=dev)
                             if self.media_rows and tri_med is not None
                             else None)
        return Scene(arrays=arrays, camera=camera, film=film, config=cfg,
                     motion=self._motion_tables(t, camera, order),
                     active_kinds=active, marschner_rows=marschner_rows,
                     has_normal_maps=any(int(r.get("nrm_tex_id", -1)) >= 0
                                         for r in rows),
                     shutter=tuple(float(x) for x in self.shutter),
                     camera_anim=self.camera_anim,
                     rebuild_geo=self._rebuild_fn(t, arrays),
                     repose_inst=self._repose_fn(), medium=self.medium)

    def _motion_tables(self, t, camera: Camera, order):
        """MotionTables when a mesh has a motion or camera1 is set (the
        JAX package's rule), else None. order: the triangles' BVH order
        (None without triangles)."""
        if not (self.mesh_motion or self.camera1 is not None):
            return None
        tri_obj = None
        if order is not None:
            obj = np.concatenate([np.full(len(mesh.faces), k, np.int32)
                                  for k, (mesh, _, _) in
                                  enumerate(self.tri_meshes)])
            tri_obj = t(obj[order], torch.int32)
        obj_m = np.tile(np.eye(4, dtype=np.float32),
                        (max(len(self.tri_meshes), 1), 1, 1))
        for k, m4 in self.mesh_motion.items():
            obj_m[k] = m4
        return MotionTables(tri_obj=tri_obj, obj_m=t(obj_m, torch.float32),
                            cam1=self.camera1 if self.camera1 is not None
                            else camera)

    def _rebuild_fn(self, t, arrays: SceneArrays):
        """rebuild_geo: t_s -> `arrays` with the triangle block (tri,
        tri_shading, tri_packed, tri_bvh) and the area lights on it built
        anew from the meshes at t_s, so NEE samples an emissive mesh where
        its hits are; the hair, instances, materials, textures, delta
        lights and environment stay the build's own objects (the JAX
        package rebuilds the whole scene, hair included, which never
        moves). None without animated or deformable meshes."""
        if not (self.animated_meshes or self.morph_meshes):
            return None

        def rebuild_geo(t_s: float) -> SceneArrays:
            tri, shading, packed, bvh, area, tri_med, _ = \
                self._build_triangles(t, self._meshes_at(t_s))
            return arrays._replace(tri=tri, tri_shading=shading,
                                   tri_packed=packed, tri_bvh=bvh,
                                   area=area, tri_med=tri_med)
        return rebuild_geo

    def _repose_fn(self):
        return repose_fn(self.instances, self.instance_anims) \
            if self.instance_anims else None


def repose_fn(instances, anims):
    """repose_inst: (arrays, t_s) -> arrays with the instance table re-posed
    at t_s (ops/instancing.repose_instanced: no geometry rebuilt).
    instances: (prototype index, to_world) in order; anims: instance
    index -> AnimatedTransform of its to_world."""
    base = list(instances)
    anims = dict(anims)

    def repose_inst(arrays, t_s: float):
        insts = list(base)
        for k, anim in anims.items():
            insts[k] = (insts[k][0], anim.eval(float(t_s)))
        return arrays._replace(
            inst=inst_mod.repose_instanced(arrays.inst, insts))
    return repose_inst
