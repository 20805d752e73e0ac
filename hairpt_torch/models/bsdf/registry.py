"""Switch-free BSDF dispatch over material tables (port of the parts of
hairpt/models/bsdf/registry.py the hair and mesh scenes use).

Materials live in an SoA table; a shading wave gathers its per-lane
parameters and every family present in the scene is evaluated and
lane-selected by kind. Ported families: DIFFUSE (simple.py), PLASTIC
and ROUGHPLASTIC (plastic.py) and the hair BSDFs KAJIYAKAY, MARSCHNER,
MARSCHNER_PURE and MARSCHNERDIELECTRIC (hair.py), whose Marschner kinds
read the stacked azimuthal tables (HairTables) through the
`hair_tables` argument. gather resolves a material's diffuse
reflectance through its procedural texture (CheckerboardTable: the
checkerboard, gridtexture, wireframe and vertexcolors kinds; bitmaps,
mips and normal or bump maps are ROADMAP item 11c). The scenes have no
wrapper materials, so eval_pdf_mix / sample_mix equal eval_pdf / sample
and perturb_shading_frame is the identity.

Conventions (as in the reference's bsdf.h): wi, wo in the local shading
frame, +z the shading normal; eval returns f(wi, wo) |cos theta_o|;
sample returns (wo, weight = f cos / pdf, pdf, is_delta, eta_scale).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ... import resolve_device

# family ids (the JAX package's values, baked into material tables; only
# the kinds with a family in FAMILIES render, the others name what the
# scene loader refuses)
DIFFUSE = 0
ROUGHDIFFUSE = 1
CONDUCTOR = 2
ROUGHCONDUCTOR = 3
DIELECTRIC = 4
THINDIELECTRIC = 5
ROUGHDIELECTRIC = 6
PLASTIC = 7
ROUGHPLASTIC = 8
PHONG = 9
WARD = 10
NULL = 11
KAJIYAKAY = 12
MARSCHNER = 13          # = the fork's MarschnerDiffuse, faithful quirks
MARSCHNERDIELECTRIC = 14
MASK = 15
DIFFTRANS = 16
MIXTURE = 17
COATING = 18
ROUGHCOATING = 19
HK = 21
CLOTH = 22
MARSCHNER_PURE = 23     # corrected-mode Marschner (true 3-lobe mixture
#                         pdf, fresh per-decision samples, MIS-compatible)

N_COS = 64  # resolution of the per-material external-transmittance slice

# texture kinds of the JAX package's CheckerboardTable (1, the bitmap, is
# ROADMAP item 11c)
TEX_CHECKER = 0
TEX_GRID = 2
TEX_WIREFRAME = 3
TEX_VERTEXCOLORS = 4


class MaterialTable(NamedTuple):
    """SoA material parameters, [M] leading axis."""
    kind: torch.Tensor         # [M] int32 family id
    twosided: torch.Tensor     # [M] bool
    diffuse: torch.Tensor      # [M, 3]
    specular: torch.Tensor     # [M, 3]
    transmit: torch.Tensor     # [M, 3]
    exponent: torch.Tensor     # [M] Kajiya-Kay Phong exponent
    alpha: torch.Tensor        # [M] microfacet roughness
    dist: torch.Tensor         # [M] 0 = ggx, 1 = beckmann
    eta: torch.Tensor          # [M] int_ior / ext_ior
    nonlinear: torch.Tensor    # [M] bool
    spec_weight: torch.Tensor  # [M] specularSamplingWeight
    ext_trans: torch.Tensor    # [M, N_COS] T12(cos theta) slice
    int_fdr: torch.Tensor      # [M] internal diffuse Fresnel reflectance
    sigma_a: torch.Tensor      # [M, 3] hair absorption
    beta_r: torch.Tensor       # [M] hair longitudinal roughness
    scale_tilt: torch.Tensor   # [M] hair scale tilt (radians)
    aux_id: torch.Tensor       # [M] int32 row of the hair tables (-1 none)
    tex_id: torch.Tensor       # [M] int32 row of the texture table (-1 none)


class CheckerboardTable(NamedTuple):
    """Procedural textures, [T] leading axis (reference:
    src/textures/{checkerboard,gridtexture,wireframe,vertexcolors}.cpp)."""
    kind: torch.Tensor       # [T] int32: TEX_CHECKER, TEX_GRID,
    #                          TEX_WIREFRAME or TEX_VERTEXCOLORS
    color0: torch.Tensor     # [T, 3]
    color1: torch.Tensor     # [T, 3]
    uv_scale: torch.Tensor   # [T, 2]
    uv_offset: torch.Tensor  # [T, 2]
    aux: torch.Tensor        # [T] the grid's or wireframe's line width


class HairTables(NamedTuple):
    """Stacked Marschner azimuthal tables, [K] hair materials
    (reference: marschner_diffuse.cpp precomputeAzimuthalDistributions)."""
    values: torch.Tensor       # [K, 3 (R/TT/TRT), 64 (cos theta_d),
    #                            64 (phi), 3 (rgb)]
    weights: torch.Tensor      # [K, 3, 64, 64] dilated max-weights
    lobe_weight: torch.Tensor  # [K, 3, 64] integral of N dphi per row
    values_quad: torch.Tensor = None  # [K, 63, 63, 3, 4, 3] 2x2 bilinear
    #                            quads (hair.quad_pack): one block per lane


class GatheredMat(NamedTuple):
    """Per-lane material parameters."""
    kind: torch.Tensor
    diffuse: torch.Tensor
    specular: torch.Tensor
    transmit: torch.Tensor
    exponent: torch.Tensor
    alpha: torch.Tensor
    dist: torch.Tensor
    eta: torch.Tensor
    nonlinear: torch.Tensor
    spec_weight: torch.Tensor
    ext_trans: torch.Tensor
    int_fdr: torch.Tensor
    sigma_a: torch.Tensor
    beta_r: torch.Tensor
    scale_tilt: torch.Tensor
    aux_id: torch.Tensor


def default_material_row(**over):
    row = dict(kind=DIFFUSE, twosided=False, diffuse=(0.5, 0.5, 0.5),
               specular=(1.0, 1.0, 1.0), transmit=(1.0, 1.0, 1.0),
               exponent=30.0, alpha=0.1, dist=0, eta=1.5, nonlinear=False,
               spec_weight=0.5, ext_trans=np.ones(N_COS), int_fdr=0.0,
               sigma_a=(0.5, 0.5, 0.5), beta_r=0.1, scale_tilt=-0.1,
               aux_id=-1, tex_id=-1)
    row.update(over)
    return row


def pack_materials(rows, device=None) -> MaterialTable:
    """The material rows as an SoA table on `device` (the card unless
    "cpu")."""
    device = resolve_device(device)

    def arr(key, dtype=np.float32):
        return torch.as_tensor(np.array([r[key] for r in rows], dtype=dtype),
                               device=device)
    return MaterialTable(
        kind=arr("kind", np.int32), twosided=arr("twosided", bool),
        diffuse=arr("diffuse"), specular=arr("specular"),
        transmit=arr("transmit"), exponent=arr("exponent"),
        alpha=arr("alpha"), dist=arr("dist", np.int32), eta=arr("eta"),
        nonlinear=arr("nonlinear", bool), spec_weight=arr("spec_weight"),
        ext_trans=arr("ext_trans"), int_fdr=arr("int_fdr"),
        sigma_a=arr("sigma_a"), beta_r=arr("beta_r"),
        scale_tilt=arr("scale_tilt"), aux_id=arr("aux_id", np.int32),
        tex_id=arr("tex_id", np.int32))


def pack_checkers(rows, device=None) -> CheckerboardTable:
    """Texture rows (kind, color0, color1, uv_scale, uv_offset, aux) as a
    table on `device`."""
    device = resolve_device(device)

    def arr(i, dtype=np.float32):
        return torch.as_tensor(np.array([r[i] for r in rows], dtype=dtype),
                               device=device)
    return CheckerboardTable(kind=arr(0, np.int32), color0=arr(1),
                             color1=arr(2), uv_scale=arr(3),
                             uv_offset=arr(4), aux=arr(5))


def _fmod1(x):
    """x mod 1 with the sign of the divisor (jnp.mod's rule)."""
    r = torch.fmod(x, 1.0)
    return torch.where((r != 0) & (r < 0), r + 1.0, r)


def eval_checkerboard(tex, tex_id, uv, base, bary=None, vcolor=None):
    """The textured reflectance; lanes with tex_id < 0 keep `base` (the
    JAX package's eval_checkerboard for its procedural kinds)."""
    if tex is None:
        return base
    tid = torch.clamp(tex_id, min=0).long()
    scale = tex.uv_scale[tid]
    off = tex.uv_offset[tid]
    kind = tex.kind[tid]
    c0 = tex.color0[tid]
    c1 = tex.color1[tid]
    su = uv[..., 0] * scale[..., 0] + off[..., 0]
    sv = uv[..., 1] * scale[..., 1] + off[..., 1]
    # checkerboard (reference checkerboard.cpp:66-74): 2 x 2 tiles per
    # scaled-uv unit, truncating int conversion, same parity -> color0
    x = torch.remainder(torch.trunc(su * 2.0).to(torch.int32), 2)
    y = torch.remainder(torch.trunc(sv * 2.0).to(torch.int32), 2)
    val = torch.where((x == y)[..., None], c0, c1)
    # gridtexture: color1 lines of width lineWidth along the cell borders
    lw = tex.aux[tid] * 0.5
    fu = _fmod1(su)
    fv = _fmod1(sv)
    on_line = (torch.minimum(fu, 1.0 - fu) < lw) \
        | (torch.minimum(fv, 1.0 - fv) < lw)
    val_gr = torch.where(on_line[..., None], c1, c0)
    val = torch.where((kind == TEX_GRID)[..., None], val_gr, val)
    # wireframe: color1 near the triangle's edges (barycentric distance)
    if bary is not None:
        b1 = bary[..., 0]
        b2 = bary[..., 1]
        b0 = 1.0 - b1 - b2
        edge = torch.minimum(torch.minimum(b0, b1), b2) < tex.aux[tid]
        val_wf = torch.where(edge[..., None], c1, c0)
        val = torch.where((kind == TEX_WIREFRAME)[..., None], val_wf, val)
    # vertexcolors: the interpolated vertex colours
    if vcolor is not None:
        val = torch.where((kind == TEX_VERTEXCOLORS)[..., None], vcolor, val)
    return torch.where((tex_id >= 0)[..., None], val, base)


class _Rows(torch.autograd.Function):
    """field[m] for a field of a material table. A table has a few rows
    and a wave up to a million lanes on one of them; the backward of
    plain indexing (index_put's sorted accumulate) sums a row's lanes on
    one thread, about 0.2 s per field and wave on an H100, so this
    backward sums each row's lanes with one masked reduction, in a fixed
    order."""

    @staticmethod
    def forward(ctx, field, m):
        ctx.save_for_backward(m)
        ctx.rows = field.shape[0]
        return field[m]

    @staticmethod
    def backward(ctx, g):
        (m,) = ctx.saved_tensors
        sel = m.view((-1,) + (1,) * (g.dim() - 1))
        return torch.stack([torch.where(sel == j, g, 0.0).sum(0)
                            for j in range(ctx.rows)]), None


def gather(table: MaterialTable, tex, mat_id, uv=None, bary=None,
           vcolor=None) -> GatheredMat:
    """Each lane's material row, its diffuse reflectance resolved through
    its texture (tex: a CheckerboardTable or None; uv, bary and vcolor
    the hit's)."""
    m = torch.clamp(mat_id, min=0).long()
    fields = [getattr(table, f) for f in GatheredMat._fields]
    gm = GatheredMat(*[_Rows.apply(v, m) if v.requires_grad else v[m]
                       for v in fields])
    if tex is None:
        return gm
    return gm._replace(diffuse=eval_checkerboard(
        tex, table.tex_id[m], uv, gm.diffuse, bary, vcolor))


def ext_trans_lookup(gm: GatheredMat, cos_theta):
    """Per-lane T12(cos theta) from the material's precomputed slice."""
    x = torch.clamp(cos_theta, 0.0, 1.0) * N_COS - 0.5
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, N_COS - 2)
    fx = torch.clamp(x - x0.to(x.dtype), 0.0, 1.0)
    t0 = torch.gather(gm.ext_trans, -1, x0[..., None])[..., 0]
    t1 = torch.gather(gm.ext_trans, -1, (x0 + 1)[..., None])[..., 0]
    return t0 * (1.0 - fx) + t1 * fx


# kind -> family class with eval_pdf(gm, wi, wo, aux) and
# sample(gm, wi, u_lobe, u2, u2b, aux), aux the scene's HairTables (or
# None); filled by the family modules
FAMILIES: dict = {}


def register(kind: int, family):
    FAMILIES[kind] = family


def check_kinds(active_kinds):
    missing = [k for k in active_kinds if k not in FAMILIES]
    if missing:
        raise NotImplementedError(f"BSDF kinds {missing} are not ported "
                                  f"(ported: {sorted(FAMILIES)})")


def eval_pdf(active_kinds, gm: GatheredMat, wi, wo, hair_tables=None):
    n = wi.shape[:-1]
    f = torch.zeros(n + (3,), device=wi.device)
    pdf = torch.zeros(n, device=wi.device)
    for kind in sorted(set(int(k) for k in active_kinds)):
        fk, pk = FAMILIES[kind].eval_pdf(gm, wi, wo, hair_tables)
        sel = gm.kind == kind
        f = torch.where(sel[..., None], fk, f)
        pdf = torch.where(sel, pk, pdf)
    return f, pdf


def sample(active_kinds, gm: GatheredMat, wi, u_lobe, u2, u2b,
           hair_tables=None):
    n = wi.shape[:-1]
    dev = wi.device
    wo = torch.zeros(n + (3,), device=dev)
    weight = torch.zeros(n + (3,), device=dev)
    pdf = torch.zeros(n, device=dev)
    is_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    eta_s = torch.ones(n, device=dev)
    for kind in sorted(set(int(k) for k in active_kinds)):
        wk, wtk, pk, dk, ek = FAMILIES[kind].sample(gm, wi, u_lobe, u2, u2b,
                                                    hair_tables)
        sel = gm.kind == kind
        wo = torch.where(sel[..., None], wk, wo)
        weight = torch.where(sel[..., None], wtk, weight)
        pdf = torch.where(sel, pk, pdf)
        is_delta = torch.where(sel, dk, is_delta)
        eta_s = torch.where(sel, ek, eta_s)
    return wo, weight, pdf, is_delta, eta_s


def eval_pdf_mix(active_kinds, table, mat_id, gm, wi, wo, hair_tables=None):
    """eval_pdf behind the wrapper-material indirection (none in the
    ported scenes)."""
    return eval_pdf(active_kinds, gm, wi, wo, hair_tables)


def sample_mix(active_kinds, table, mat_id, gm, wi, u_lobe, u2, u2b,
               hair_tables=None):
    return sample(active_kinds, gm, wi, u_lobe, u2, u2b, hair_tables)


def perturb_shading_frame(table, mat_id, sh_n, sh_s, sh_t):
    """Normal and bump maps need textures, which the port has none of."""
    return sh_n, sh_s, sh_t
