"""Scene assembly for the hair scenes (port of the hair branch of
hairpt/scene/scene.py): host-side build -> torch arrays on the device +
static config."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import rng
from ..film.film import Film
from ..models import emitters as em
from ..models.bsdf import registry as mat
from ..models.bsdf import hair as hair_bsdf  # registers the hair kinds
from ..models.bsdf import plastic  # noqa: F401  (registers ROUGHPLASTIC)
from ..models.bsdf import simple  # noqa: F401  (registers DIFFUSE)
from ..models.bsdf import tables as rt_tables
from ..models.sensors import Camera
from ..ops import bvh as bvh_mod
from ..ops import intersect_swept as iswept
from . import hairgen


class HairGeom(NamedTuple):
    """Hair segments in BVH prim order (the ids the intersector returns)."""
    p0: torch.Tensor      # [S, 3]
    p1: torch.Tensor      # [S, 3]
    radius: torch.Tensor  # [S]


class SceneArrays(NamedTuple):
    hair: HairGeom
    hair_mat_id: torch.Tensor       # [S] int32
    hair_swept: iswept.SweptHair
    materials: mat.MaterialTable
    hair_tables: Optional[mat.HairTables]
    env: Optional[em.EnvMap]


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
    traversal: str = "tiled"    # 'tiled' | 'swept'
    swept_k: int = 128          # segments per cluster
    swept_c: int = 0            # cluster count (filled at build)
    swept_pmax: int = 24        # phase-A candidate clusters per ray ('swept')
    swept_chunk: int = 64       # pairs per phase-B chunk ('swept')
    tiled_q: int = 128          # candidate clusters per 64-ray tile
    nee_probs: tuple = (1.0, 0.0, 0.0)   # (env, area, delta)
    nee_rr: float = 0.0         # shadow-ray Russian roulette threshold


class Scene(NamedTuple):
    arrays: SceneArrays
    camera: Camera
    film: Film
    config: RenderConfig
    active_kinds: tuple
    marschner_rows: tuple = ()  # material-row index per hair-table aux_id


class SceneBuilder:
    """Imperative host-side builder: materials, fibers and an environment,
    then build() puts the arrays on `device` (the card unless "cpu")."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.fibers = []
        self.materials = []
        self.hair_aux = []         # (sigma_a, beta_r, eta) per hair table
        self.env: Optional[em.EnvMap] = None

    def add_material(self, **row) -> int:
        kind = row.get("kind", mat.DIFFUSE)
        mat.check_kinds([kind])
        # per-material precomputed transmittance slices
        if kind in (mat.ROUGHPLASTIC, mat.MARSCHNER, mat.MARSCHNER_PURE):
            dist = row.get("dist", 0)
            eta = row.get("eta", 1.5)
            alpha = row.get("alpha", 0.1)
            rt = rt_tables.get(dist, eta)
            cosg = (np.arange(mat.N_COS) + 0.5) / mat.N_COS
            row["ext_trans"] = rt.eval_np(cosg, np.full(mat.N_COS, alpha))
            row["int_fdr"] = 1.0 - rt_tables.get(dist, 1.0 / eta) \
                .eval_diffuse_np(alpha)
        if kind in (mat.MARSCHNER, mat.MARSCHNER_PURE):
            row["aux_id"] = len(self.hair_aux)
            self.hair_aux.append((row.get("sigma_a", (0.5, 0.5, 0.5)),
                                  row.get("beta_r", 0.1),
                                  row.get("eta", 1.55)))
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
        return len(self.materials) - 1

    def add_fibers(self, fs: hairgen.FiberSet, mat_id: int):
        """One FiberSet (gen_hair_curl's clumps are added one by one, as
        in the JAX package)."""
        self.fibers.append((fs, mat_id))

    def build(self, camera: Camera, film: Film, **config_kwargs) -> Scene:
        if "traversal" not in config_kwargs:
            config_kwargs["traversal"] = "tiled"
            config_kwargs.setdefault("tiled_q", 2048)
        if config_kwargs["traversal"] not in ("tiled", "swept"):
            raise NotImplementedError("only traversal='tiled' and 'swept' "
                                      "are ported")
        if not self.fibers:
            raise NotImplementedError("the port renders hair scenes only")
        cfg = RenderConfig(width=film.width, height=film.height,
                           **config_kwargs)
        dev = self.device

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
        o = bvh_mod.build(lo, hi).prim_order

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)
        hair = HairGeom(p0=t(p0[o]), p1=t(p1[o]), radius=t(rad[o]))
        swept = iswept.build_swept_hair(p0[o], p1[o], n0[o], n1[o], rad[o],
                                        K=cfg.swept_k, device=dev)
        cfg = dataclasses.replace(
            cfg, swept_c=int(swept.seg_rows_t.shape[0]))

        rows = self.materials or [mat.default_material_row(
            kind=mat.ROUGHPLASTIC)]
        materials = mat.pack_materials(rows, device=dev)
        env = self.env.to(dev) if self.env is not None else None
        cfg = dataclasses.replace(
            cfg, nee_probs=(1.0, 0.0, 0.0) if env is not None
            else (0.0, 0.0, 0.0))
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
        arrays = SceneArrays(hair=hair, hair_mat_id=t(mid[o], torch.int32),
                             hair_swept=swept, materials=materials,
                             hair_tables=ht, env=env)
        return Scene(arrays=arrays, camera=camera, film=film, config=cfg,
                     active_kinds=active, marschner_rows=marschner_rows)
