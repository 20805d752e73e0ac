"""Switch-free BSDF dispatch over material tables (port of the parts of
hairpt/models/bsdf/registry.py the hair and mesh scenes use).

Materials live in an SoA table; a shading wave gathers its per-lane
parameters and every family present in the scene is evaluated and
lane-selected by kind. Ported families: DIFFUSE, ROUGHDIFFUSE,
CONDUCTOR, DIELECTRIC, THINDIELECTRIC, NULL, PHONG and WARD
(simple.py), PLASTIC, ROUGHPLASTIC and ROUGHCONDUCTOR (plastic.py),
ROUGHDIELECTRIC and DIFFTRANS (dielectric_rough.py) and the hair BSDFs
KAJIYAKAY, MARSCHNER, MARSCHNER_PURE and MARSCHNERDIELECTRIC (hair.py),
whose Marschner kinds read the stacked azimuthal tables (HairTables)
through the `hair_tables` argument; the wrapper materials MIXTURE, MASK,
COATING and ROUGHCOATING (one level of nesting, as in the JAX package)
go through eval_pdf_mix / sample_mix. gather resolves a material's
diffuse reflectance through its texture (CheckerboardTable: the
checkerboard, gridtexture, wireframe and vertexcolors kinds, and
bitmaps: bilinear, or trilinear in their mip pyramid at a footprint's
level of detail, or the elliptical (EWA) filter where the camera hit
gives a uv Jacobian); perturb_shading_frame applies a material's normal
or bump map. HK (hk.py, the Hanrahan-Krueger slab) registers itself;
DIPOLE rows are resolved by the integrator (the subsurface branch of
integrators/path.py), so eval_pdf and sample leave them out. CLOTH (the
irawan woven cloth, cloth.py) reads its weave patterns from
MaterialTable.cloth: gather resolves the yarn at each cloth lane's uv.

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
DIPOLE = 20             # subsurface dipole: params transmit = sigma_s',
#                         sigma_a, eta, mix_w = density scale
HK = 21
CLOTH = 22
MARSCHNER_PURE = 23     # corrected-mode Marschner (true 3-lobe mixture
#                         pdf, fresh per-decision samples, MIS-compatible)

WRAPPER_KINDS = (MIXTURE, MASK, COATING, ROUGHCOATING)

N_COS = 64  # resolution of the per-material external-transmittance slice

# texture kinds of the JAX package's CheckerboardTable
TEX_CHECKER = 0
TEX_BITMAP = 1
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
    k: torch.Tensor            # [M, 3] conductor absorption
    nonlinear: torch.Tensor    # [M] bool
    spec_weight: torch.Tensor  # [M] specularSamplingWeight
    ext_trans: torch.Tensor    # [M, N_COS] T12(cos theta) slice
    int_fdr: torch.Tensor      # [M] internal diffuse Fresnel reflectance
    sigma_a: torch.Tensor      # [M, 3] hair absorption
    beta_r: torch.Tensor       # [M] hair longitudinal roughness
    scale_tilt: torch.Tensor   # [M] hair scale tilt (radians)
    aux_id: torch.Tensor       # [M] int32 row of the hair tables (-1 none)
    tex_id: torch.Tensor       # [M] int32 row of the texture table (-1 none)
    mix_a: torch.Tensor        # [M] int32 first sub-material row (wrappers)
    mix_b: torch.Tensor        # [M] int32 second sub-material row (MIXTURE)
    mix_w: torch.Tensor        # [M] weight of mix_a (MIXTURE)
    nrm_tex_id: torch.Tensor   # [M] int32 normal or bump texture (-1 none)
    nrm_kind: torch.Tensor     # [M] int32 0 = normal map, 1 = bump map
    nrm_scale: torch.Tensor    # [M] bump height scale
    cloth: object = None       # cloth.ClothTable of the CLOTH rows' aux_id
    #                            (None without cloth)


class CheckerboardTable(NamedTuple):
    """Textures, [T] leading axis (reference: src/textures/{checkerboard,
    bitmap,gridtexture,wireframe,vertexcolors}.cpp): the procedural kinds
    and bitmaps resampled to one resolution R."""
    kind: torch.Tensor       # [T] int32: TEX_CHECKER, TEX_BITMAP,
    #                          TEX_GRID, TEX_WIREFRAME or TEX_VERTEXCOLORS
    color0: torch.Tensor     # [T, 3]
    color1: torch.Tensor     # [T, 3]
    uv_scale: torch.Tensor   # [T, 2]
    uv_offset: torch.Tensor  # [T, 2]
    aux: torch.Tensor        # [T] the grid's or wireframe's line width
    bitmaps: torch.Tensor    # [T, R, R, 3] (zeros for the procedural kinds)
    mips: torch.Tensor       # [T, 4, R, R, 3] pre-blurred pyramid (level k
    #                          the 2^k box average, stored at full R)


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
    k: torch.Tensor
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
               exponent=30.0, alpha=0.1, dist=0, eta=1.5,
               k=(1.0, 1.0, 1.0), nonlinear=False, spec_weight=0.5,
               ext_trans=np.ones(N_COS), int_fdr=0.0,
               sigma_a=(0.5, 0.5, 0.5), beta_r=0.1, scale_tilt=-0.1,
               aux_id=-1, tex_id=-1, mix_a=0, mix_b=0, mix_w=0.5,
               nrm_tex_id=-1, nrm_kind=0, nrm_scale=1.0)
    row.update(over)
    return row


def pack_materials(rows, device=None, cloth=None) -> MaterialTable:
    """The material rows as an SoA table on `device` (the card unless
    "cpu"); cloth: the ClothTable of the CLOTH rows (cloth.pack_cloth),
    or None."""
    device = resolve_device(device)

    def arr(key, dtype=np.float32):
        return torch.as_tensor(np.array([r[key] for r in rows], dtype=dtype),
                               device=device)
    return MaterialTable(
        kind=arr("kind", np.int32), twosided=arr("twosided", bool),
        diffuse=arr("diffuse"), specular=arr("specular"),
        transmit=arr("transmit"), exponent=arr("exponent"),
        alpha=arr("alpha"), dist=arr("dist", np.int32), eta=arr("eta"),
        k=arr("k"), nonlinear=arr("nonlinear", bool),
        spec_weight=arr("spec_weight"),
        ext_trans=arr("ext_trans"), int_fdr=arr("int_fdr"),
        sigma_a=arr("sigma_a"), beta_r=arr("beta_r"),
        scale_tilt=arr("scale_tilt"), aux_id=arr("aux_id", np.int32),
        tex_id=arr("tex_id", np.int32), mix_a=arr("mix_a", np.int32),
        mix_b=arr("mix_b", np.int32), mix_w=arr("mix_w"),
        nrm_tex_id=arr("nrm_tex_id", np.int32),
        nrm_kind=arr("nrm_kind", np.int32), nrm_scale=arr("nrm_scale"),
        cloth=cloth)


def build_mips(bitmaps: np.ndarray, levels: int = 4) -> np.ndarray:
    """Pre-blurred pyramid for trilinear filtering: level k = 2^k box
    average, stored at full resolution (the JAX package's _build_mips,
    numpy, the same code)."""
    t, r, _, _ = bitmaps.shape
    out = np.zeros((t, levels, r, r, 3), np.float32)
    out[:, 0] = bitmaps
    cur = bitmaps
    for k in range(1, levels):
        rr = max(r >> k, 1)
        small = cur.reshape(t, rr, cur.shape[1] // rr,
                            rr, cur.shape[2] // rr, 3).mean((2, 4))
        out[:, k] = np.repeat(np.repeat(small, r // rr, axis=1),
                              r // rr, axis=2)
        cur = out[:, k]
    return out


def pack_checkers(rows, device=None) -> CheckerboardTable:
    """Texture rows (kind, color0, color1, uv_scale, uv_offset, aux[,
    image]) as a table on `device`: the bitmaps (the rows' images, all of
    one resolution R; 4 x 4 zeros when no row has one) and their mips,
    as the JAX package's SceneBuilder.build lays them out."""
    device = resolve_device(device)

    def arr(i, dtype=np.float32):
        return torch.as_tensor(np.array([r[i] for r in rows], dtype=dtype),
                               device=device)
    images = [r[6] if len(r) > 6 else None for r in rows]
    res = max([im.shape[0] for im in images if im is not None], default=4)
    bitmaps = np.zeros((len(rows), res, res, 3), np.float32)
    for i, im in enumerate(images):
        if im is not None:
            bitmaps[i] = im
    return CheckerboardTable(
        kind=arr(0, np.int32), color0=arr(1), color1=arr(2),
        uv_scale=arr(3), uv_offset=arr(4), aux=arr(5),
        bitmaps=torch.as_tensor(bitmaps, device=device),
        mips=torch.as_tensor(build_mips(bitmaps), device=device))


def _fmod1(x):
    """x mod 1 with the sign of the divisor (jnp.mod's rule)."""
    r = torch.fmod(x, 1.0)
    return torch.where((r != 0) & (r < 0), r + 1.0, r)


def _wrap_index(x, r):
    return torch.remainder(x, r).long()


def _bilinear(img, tid, level, fu, fv):
    """Bilinear lookup at texel coordinates (fu, fv) [N] (texel centres
    at +0.5, repeat wrap) in level `level` ([N] or None: the base
    bitmaps) of texture `tid` [N], in the JAX package's order of
    operations."""
    r = img.shape[-2]
    x0 = torch.floor(fu).to(torch.int32)
    y0 = torch.floor(fv).to(torch.int32)
    wx = (fu - x0)[..., None]
    wy = (fv - y0)[..., None]
    x0m, x1m = _wrap_index(x0, r), _wrap_index(x0 + 1, r)
    y0m, y1m = _wrap_index(y0, r), _wrap_index(y0 + 1, r)
    if level is None:
        def at(y, x):
            return img[tid, y, x]
    else:
        def at(y, x):
            return img[tid, level, y, x]
    return ((at(y0m, x0m) * (1 - wx) + at(y0m, x1m) * wx) * (1 - wy)
            + (at(y1m, x0m) * (1 - wx) + at(y1m, x1m) * wx) * wy)


def _texel_coords(r, su, sv):
    """Scaled uv -> texel coordinates (repeat wrap, v flipped)."""
    fu = _fmod1(su) * r - 0.5
    fv = _fmod1(1.0 - _fmod1(sv)) * r - 0.5
    return fu, fv


def _mip_levels(lvl, n_levels):
    """(l0, l1, fl) of a level of detail: a NaN level (a lane whose
    footprint is undefined, as a miss's) reads level 0 and gives NaN, as
    XLA's conversion of NaN to an index does."""
    l0 = torch.nan_to_num(torch.floor(lvl), nan=0.0).to(torch.int32)
    fl = (lvl - l0)[..., None]
    return l0.long(), torch.clamp(l0 + 1, max=n_levels - 1).long(), fl


def _bilinear_mip(tex, tid, su, sv, level_idx):
    """Bilinear lookup in mip level `level_idx` [N] of texture `tid` [N]
    at scaled uv (su, sv) [N] (repeat wrap, v flipped)."""
    fu, fv = _texel_coords(tex.bitmaps.shape[1], su, sv)
    return _bilinear(tex.mips, tid, level_idx, fu, fv)


def ewa_eval_bitmap(tex, tid, su, sv, duv_dx, duv_dy, n_probes: int = 7,
                    max_aniso: float | None = None):
    """Anisotropic filtering of the bitmap pyramid (the JAX package's
    ewa_eval_bitmap; reference: include/mitsuba/render/mipmap.h evalEWA):
    the footprint ellipse (the image of the pixel under the uv Jacobian
    [duv_dx | duv_dy], in scaled-uv units) integrated by n_probes
    Gaussian-weighted trilinear probes along its major axis at the level
    of its minor axis (Feline). max_aniso defaults to (n_probes + 1) / 2,
    the largest ratio the probes cover without gaps."""
    if max_aniso is None:
        max_aniso = (n_probes + 1) / 2.0
    r = tex.bitmaps.shape[1]
    n_levels = tex.mips.shape[1]
    a = duv_dx[..., 0] * r
    c = duv_dx[..., 1] * r
    b = duv_dy[..., 0] * r
    d = duv_dy[..., 1] * r
    m00 = a * a + b * b
    m11 = c * c + d * d
    m01 = a * c + b * d
    tr = m00 + m11
    diff = torch.sqrt(torch.clamp((m00 - m11) ** 2 + 4 * m01 * m01,
                                  min=0.0))
    s_major = torch.sqrt(torch.clamp(0.5 * (tr + diff), min=1e-12))
    s_minor = torch.sqrt(torch.clamp(0.5 * (tr - diff), min=0.0))
    s_minor = torch.clamp(torch.maximum(s_minor, s_major / max_aniso),
                          min=1.0)
    s_major = torch.maximum(s_major, s_minor)
    theta = 0.5 * torch.atan2(2 * m01, m00 - m11)
    maj_u = torch.cos(theta) / r
    maj_v = torch.sin(theta) / r
    lvl = torch.clamp(torch.log2(s_minor), 0.0, n_levels - 1.001)
    l0, l1, fl = _mip_levels(lvl, n_levels)
    half = torch.clamp(s_major - s_minor, min=0.0)
    acc = torch.zeros(su.shape + (3,), device=su.device)
    wsum = torch.zeros(su.shape + (1,), device=su.device)
    for i in range(n_probes):
        u_i = (2.0 * i / max(n_probes - 1, 1) - 1.0) if n_probes > 1 \
            else 0.0
        w = torch.exp(torch.tensor(-2.0 * u_i * u_i, dtype=torch.float32,
                                   device=su.device))
        off = half * u_i
        pu = su + maj_u * off
        pv = sv + maj_v * off
        v0 = _bilinear_mip(tex, tid, pu, pv, l0)
        v1 = _bilinear_mip(tex, tid, pu, pv, l1)
        acc = acc + w * (v0 * (1 - fl) + v1 * fl)
        wsum = wsum + w
    return acc / wsum


def eval_checkerboard(tex, tex_id, uv, base, bary=None, vcolor=None,
                      lod=None, duv=None):
    """The textured reflectance; lanes with tex_id < 0 keep `base` (the
    JAX package's eval_checkerboard). lod [N]: the level of detail of a
    footprint, which makes bitmap lanes trilinear in the mips; duv:
    (duv_dx, duv_dy) [N, 2], the pixel footprint's uv Jacobian (unscaled
    uv), which makes bitmap lanes with a nonzero one EWA-filtered."""
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
    # bitmap: bilinear, repeat wrap, v flipped as in the reference
    is_bm = (kind == TEX_BITMAP)[..., None]
    fu, fv = _texel_coords(tex.bitmaps.shape[1], su, sv)
    val = torch.where(is_bm, _bilinear(tex.bitmaps, tid, None, fu, fv), val)
    # trilinear in the mips at the footprint's level (reference:
    # src/textures/bitmap.cpp through mipmap.h)
    if lod is not None and tex.mips.shape[1] > 0:
        n_levels = tex.mips.shape[1]
        l0, l1, fl = _mip_levels(torch.clamp(lod, 0.0, n_levels - 1.001),
                                 n_levels)
        val_bm = _bilinear(tex.mips, tid, l0, fu, fv) * (1 - fl) \
            + _bilinear(tex.mips, tid, l1, fu, fv) * fl
        if duv is not None:
            # EWA where the lane has a footprint Jacobian; the caller
            # passes duv only where some lane may have one
            sc_dx = duv[0] * scale
            sc_dy = duv[1] * scale
            has_j = (torch.sum(torch.abs(sc_dx), -1)
                     + torch.sum(torch.abs(sc_dy), -1)) > 0
            val_bm = torch.where(has_j[..., None], ewa_eval_bitmap(
                tex, tid, su, sv, sc_dx, sc_dy), val_bm)
        val = torch.where(is_bm, val_bm, val)
    # gridtexture: color1 lines of width lineWidth along the cell borders
    lw = tex.aux[tid] * 0.5
    gu = _fmod1(su)
    gv = _fmod1(sv)
    on_line = (torch.minimum(gu, 1.0 - gu) < lw) \
        | (torch.minimum(gv, 1.0 - gv) < lw)
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


def gather(table: MaterialTable, tex, mat_id, uv=None, lod=None, bary=None,
           vcolor=None, duv=None) -> GatheredMat:
    """Each lane's material row, its diffuse reflectance resolved through
    its texture (tex: a CheckerboardTable or None; uv, bary and vcolor
    the hit's; lod and duv the footprint's, as eval_checkerboard takes
    them), and each cloth lane's yarn resolved at its uv (_cloth_stage;
    a cloth lane without a uv raises)."""
    m = torch.clamp(mat_id, min=0).long()
    fields = [getattr(table, f) for f in GatheredMat._fields]
    gm = GatheredMat(*[_field(v, m) for v in fields])
    if tex is not None:
        gm = gm._replace(diffuse=eval_checkerboard(
            tex, table.tex_id[m], uv, gm.diffuse, bary, vcolor, lod=lod,
            duv=duv))
    if table.cloth is not None:
        gm = _cloth_stage(table.cloth, gm, uv)
    return gm


def _cloth_stage(ct, gm: GatheredMat, uv) -> GatheredMat:
    """The irawan lanes' yarn resolved at their uv (the JAX package's
    gather, registry.py:384-401, which resolves every lane and selects
    the cloth ones): cloth.cloth_resolve on the cloth lanes only, its
    results written into the GatheredMat fields cloth.py's docstring
    maps (kd, ks, u, v, umax, psi, kappa and (w, l, is_weft))."""
    from . import cloth as cloth_mod
    idx = torch.nonzero(gm.kind == CLOTH).view(-1)
    if idx.numel() == 0:
        return gm
    if uv is None:
        raise ValueError("gather: cloth lanes need the hit's uv")
    res = cloth_mod.cloth_resolve(ct, torch.clamp(gm.aux_id[idx], min=0),
                                  uv[idx])

    def put(field, value):
        return field.index_put((idx,), value.to(field.dtype))
    return gm._replace(
        diffuse=put(gm.diffuse, res["kd"]),
        specular=put(gm.specular, res["ks"]),
        exponent=put(gm.exponent, res["u"]),
        alpha=put(gm.alpha, res["v"]),
        beta_r=put(gm.beta_r, res["umax"]),
        scale_tilt=put(gm.scale_tilt, res["psi"]),
        eta=put(gm.eta, res["kappa"]),
        sigma_a=put(gm.sigma_a, torch.stack(
            [res["w"], res["l"], res["is_weft"].to(res["w"].dtype)], -1)))


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
    missing = [k for k in active_kinds
               if k not in FAMILIES and k not in WRAPPER_KINDS
               and k != DIPOLE]
    if missing:
        raise NotImplementedError(f"BSDF kinds {missing} are not ported "
                                  f"yet (ROADMAP item 13; ported: "
                                  f"{sorted(set(FAMILIES) | set(WRAPPER_KINDS))})")


def eval_pdf(active_kinds, gm: GatheredMat, wi, wo, hair_tables=None):
    """f cos and the sampling pdf of every lane (the wrappers' lanes are
    eval_pdf_mix's)."""
    n = wi.shape[:-1]
    f = torch.zeros(n + (3,), device=wi.device)
    pdf = torch.zeros(n, device=wi.device)
    for kind in sorted(set(int(k) for k in active_kinds)):
        if kind in WRAPPER_KINDS or kind == DIPOLE:
            continue
        fk, pk = FAMILIES[kind].eval_pdf(gm, wi, wo, hair_tables)
        sel = gm.kind == kind
        f = torch.where(sel[..., None], fk, f)
        pdf = torch.where(sel, pk, pdf)
    return f, pdf


def sample(active_kinds, gm: GatheredMat, wi, u_lobe, u2, u2b,
           hair_tables=None):
    """(wo, weight, pdf, is_delta, eta_scale) of every lane (the
    wrappers' lanes are sample_mix's)."""
    n = wi.shape[:-1]
    dev = wi.device
    wo = torch.zeros(n + (3,), device=dev)
    weight = torch.zeros(n + (3,), device=dev)
    pdf = torch.zeros(n, device=dev)
    is_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    eta_s = torch.ones(n, device=dev)
    for kind in sorted(set(int(k) for k in active_kinds)):
        if kind in WRAPPER_KINDS or kind == DIPOLE:
            continue
        wk, wtk, pk, dk, ek = FAMILIES[kind].sample(gm, wi, u_lobe, u2, u2b,
                                                    hair_tables)
        sel = gm.kind == kind
        wo = torch.where(sel[..., None], wk, wo)
        weight = torch.where(sel[..., None], wtk, weight)
        pdf = torch.where(sel, pk, pdf)
        is_delta = torch.where(sel, dk, is_delta)
        eta_s = torch.where(sel, ek, eta_s)
    return wo, weight, pdf, is_delta, eta_s


# ---------------------------------------------------------------------------
# Wrapper materials: one level of nested-material indirection (the JAX
# package's registry.py, reference src/bsdfs/{mixturebsdf,blendbsdf,mask,
# coating,roughcoating}.cpp).
#   MIXTURE      rows mix_a and mix_b blended with weight mix_w;
#   MASK         opacity (in `diffuse`, possibly textured) times row mix_a
#                plus (1 - opacity) delta pass-through;
#   COATING      a smooth dielectric layer (ior `eta`, absorption times
#                thickness in `sigma_a`) over row mix_a, whose directions
#                are refraction-unfolded;
#   ROUGHCOATING a microfacet layer: the specular lobe D G F / (4 cos),
#                the nested transmittance from the row's ext_trans slice.
# A nested row is a plain family. Its row is fetched with gather (uv only,
# as in the JAX package), so a gradient to its fields goes through _Rows.
# ---------------------------------------------------------------------------

def _sub_kinds(active_kinds):
    return tuple(k for k in active_kinds if k not in WRAPPER_KINDS)


def _refract_in(w, eta):
    """Refraction-unfolded entry into the coating layer: the transmitted
    direction in the SAME hemisphere as w (reference: coating.cpp
    refractIn). Returns (w', R12, tir)."""
    from .fresnel import fresnel_dielectric
    cos_i = w[..., 2]
    R, _ = fresnel_dielectric(torch.abs(cos_i), eta)
    inv_eta = 1.0 / eta
    sin2_t = (1.0 - cos_i * cos_i) * inv_eta * inv_eta
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wp = torch.stack([w[..., 0] * inv_eta, w[..., 1] * inv_eta,
                      torch.sign(cos_i) * cos_t], dim=-1)
    return wp, torch.where(tir, 1.0, R), tir


def _refract_out(wp, eta):
    """Exit from the layer (reference: coating.cpp refractOut). Returns
    (w, R21, tir)."""
    from .fresnel import fresnel_dielectric
    cos_i = wp[..., 2]
    R, _ = fresnel_dielectric(torch.abs(cos_i), 1.0 / eta)
    sin2_t = (1.0 - cos_i * cos_i) * eta * eta
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    w = torch.stack([wp[..., 0] * eta, wp[..., 1] * eta,
                     torch.sign(cos_i) * cos_t], dim=-1)
    return w, torch.where(tir, 1.0, R), tir


def _coat_absorb(gm, wi_p, wo_p):
    """exp(-sigma_a d (1 / |cos theta_i'| + 1 / |cos theta_o'|)); sigma_a
    holds the absorption times the thickness."""
    path = 1.0 / torch.clamp(torch.abs(wi_p[..., 2]), min=1e-6) \
        + 1.0 / torch.clamp(torch.abs(wo_p[..., 2]), min=1e-6)
    return torch.exp(-gm.sigma_a * path[..., None])


def _coat_prob_spec(gm, wi, rough: bool):
    from .fresnel import fresnel_dielectric
    if rough:
        r = 1.0 - ext_trans_lookup(gm, torch.abs(wi[..., 2]))
    else:
        r, _ = fresnel_dielectric(torch.abs(wi[..., 2]), gm.eta)
    sw = gm.spec_weight
    return (r * sw) / torch.clamp(r * sw + (1 - r) * (1 - sw), min=1e-7)


def _coat_eval_pdf(sub, gm, gm_n, wi, wo, hair_tables, rough: bool):
    """(f, pdf) of a coated lane, both lobes, solid-angle measure."""
    wi_p, R12, tir_i = _refract_in(wi, gm.eta)
    wo_p, R21, tir_o = _refract_in(wo, gm.eta)
    f_n, p_n = eval_pdf(sub, gm_n, wi_p, wo_p, hair_tables)
    inv_eta2 = 1.0 / (gm.eta * gm.eta)
    jac = inv_eta2 * wo[..., 2] / torch.where(
        torch.abs(wo_p[..., 2]) < 1e-7, 1e-7, wo_p[..., 2])
    if rough:
        T_i = ext_trans_lookup(gm, torch.abs(wi[..., 2]))
        T_o = ext_trans_lookup(gm, torch.abs(wo[..., 2]))
        through = (T_i * T_o)[..., None]
    else:
        through = ((1.0 - R12) * (1.0 - R21))[..., None]
    f = f_n * through * _coat_absorb(gm, wi_p, wo_p) * jac[..., None]
    dead = tir_i | tir_o
    f = torch.where(dead[..., None], 0.0, f)
    p_spec = _coat_prob_spec(gm, wi, rough)
    pdf = torch.where(dead, 0.0, p_n * jac * (1.0 - p_spec))
    if rough:
        # the glossy reflection lobe (reference: roughcoating.cpp:273-291)
        from . import microfacet as mf
        from .fresnel import fresnel_dielectric
        from .plastic import _dyn_g, _dyn_ndf, _dyn_pdf_m, _half
        both_up = wi[..., 2] * wo[..., 2] > 0
        h = _half(wi, wo) * torch.sign(wo[..., 2])[..., None]
        D = _dyn_ndf(gm.dist, gm.alpha, h)
        G = _dyn_g(gm.dist, gm.alpha, wi, wo, h)
        F, _ = fresnel_dielectric(torch.abs(torch.sum(wi * h, -1)), gm.eta)
        spec = gm.specular * (F * D * G / torch.clamp(
            4.0 * torch.abs(wi[..., 2]), min=1e-7))[..., None]
        pdf_m = _dyn_pdf_m(gm.dist, gm.alpha, wi, h)
        pdf_spec = mf.half_vector_to_wo_pdf(pdf_m, wo, h)
        f = f + torch.where(both_up[..., None], spec, 0.0)
        pdf = pdf + torch.where(both_up, pdf_spec * p_spec, 0.0)
    return f, pdf


def eval_pdf_mix(active_kinds, table, tex, mat_id, uv, gm, wi, wo,
                 hair_tables=None):
    """eval_pdf with one level of wrapper-material indirection."""
    akt = set(int(k) for k in active_kinds)
    f, pdf = eval_pdf(active_kinds, gm, wi, wo, hair_tables)
    if not (akt & set(WRAPPER_KINDS)):
        return f, pdf
    m = torch.clamp(mat_id, min=0).long()
    kind_m = table.kind[m]
    sub = _sub_kinds(active_kinds)
    gm_a = gather(table, tex, table.mix_a[m], uv)
    if MIXTURE in akt or MASK in akt:
        f_a, p_a = eval_pdf(sub, gm_a, wi, wo, hair_tables)
    if MIXTURE in akt:
        is_mix = kind_m == MIXTURE
        w = _field(table.mix_w, m)
        gm_b = gather(table, tex, table.mix_b[m], uv)
        f_b, p_b = eval_pdf(sub, gm_b, wi, wo, hair_tables)
        f = torch.where(is_mix[..., None],
                        w[..., None] * f_a + (1 - w)[..., None] * f_b, f)
        pdf = torch.where(is_mix, w * p_a + (1 - w) * p_b, pdf)
    if MASK in akt:
        is_mask = kind_m == MASK
        op = gm.diffuse  # the opacity, texture-resolved
        f = torch.where(is_mask[..., None], f_a * op, f)
        pdf = torch.where(is_mask, p_a * _luminance(op), pdf)
    for rough, kind in ((False, COATING), (True, ROUGHCOATING)):
        if kind in akt:
            is_c = kind_m == kind
            f_c, p_c = _coat_eval_pdf(sub, gm, gm_a, wi, wo, hair_tables,
                                      rough)
            f = torch.where(is_c[..., None], f_c, f)
            pdf = torch.where(is_c, p_c, pdf)
    return f, pdf


def sample_mix(active_kinds, table, tex, mat_id, uv, gm, wi, u_lobe, u2,
               u2b, hair_tables=None):
    """sample with one level of wrapper-material indirection."""
    akt = set(int(k) for k in active_kinds)
    if not (akt & set(WRAPPER_KINDS)):
        return sample(active_kinds, gm, wi, u_lobe, u2, u2b, hair_tables)
    m = torch.clamp(mat_id, min=0).long()
    kind_m = table.kind[m]
    sub = _sub_kinds(active_kinds)
    n = wi.shape[:-1]
    dev = wi.device

    # ---- route each lane to an effective sub-material, rescaled sample --
    id_eff = m
    u_eff = u_lobe
    if MIXTURE in akt:
        is_mix = kind_m == MIXTURE
        w = _field(table.mix_w, m)
        pick_a = u_lobe < w
        u_resc = torch.where(pick_a, u_lobe / torch.clamp(w, min=1e-7),
                             (u_lobe - w) / torch.clamp(1 - w, min=1e-7))
        id_eff = torch.where(is_mix, torch.where(
            pick_a, table.mix_a[m], table.mix_b[m]).long(), id_eff)
        u_eff = torch.where(is_mix, u_resc, u_eff)
    if MASK in akt:
        is_mask = kind_m == MASK
        op_lum = _luminance(gm.diffuse)
        mask_nested = u_lobe < op_lum
        id_eff = torch.where(is_mask & mask_nested, table.mix_a[m].long(),
                             id_eff)
        u_eff = torch.where(is_mask, u_lobe / torch.clamp(op_lum, min=1e-7),
                            u_eff)
    is_coat = torch.zeros(n, dtype=torch.bool, device=dev)
    coat_rough = torch.zeros(n, dtype=torch.bool, device=dev)
    if COATING in akt:
        is_coat = is_coat | (kind_m == COATING)
    if ROUGHCOATING in akt:
        sel = kind_m == ROUGHCOATING
        is_coat = is_coat | sel
        coat_rough = coat_rough | sel
    if COATING in akt or ROUGHCOATING in akt:
        if (COATING in akt) != (ROUGHCOATING in akt):
            p_spec = _coat_prob_spec(gm, wi, ROUGHCOATING in akt)
        else:
            p_spec = torch.where(coat_rough, _coat_prob_spec(gm, wi, True),
                                 _coat_prob_spec(gm, wi, False))
        coat_nested = u_lobe >= p_spec
        id_eff = torch.where(is_coat & coat_nested, table.mix_a[m].long(),
                             id_eff)
        u_eff = torch.where(is_coat & coat_nested,
                            (u_lobe - p_spec)
                            / torch.clamp(1 - p_spec, min=1e-7), u_eff)

    # coated lanes sample the nested BSDF with the refracted wi
    wi_p, R12, tir_i = _refract_in(wi, gm.eta)
    wi_eff = torch.where(is_coat[..., None], wi_p, wi)
    gm_eff = gather(table, tex, id_eff, uv)
    wo, wt, pdf, is_delta, eta_s = sample(sub, gm_eff, wi_eff, u_eff, u2,
                                          u2b, hair_tables)

    # ---- MIXTURE: a smooth lane takes the full blended f / pdf ----
    if MIXTURE in akt:
        f_mix, p_mix = eval_pdf_mix(active_kinds, table, tex, mat_id, uv,
                                    gm, wi, wo, hair_tables)
        smooth_mix = is_mix & ~is_delta
        wt = torch.where(smooth_mix[..., None],
                         f_mix / torch.clamp(p_mix, min=1e-9)[..., None], wt)
        pdf = torch.where(smooth_mix, p_mix, pdf)
        delta_mix = is_mix & is_delta
        pdf = torch.where(delta_mix, pdf * torch.where(pick_a, w, 1 - w),
                          pdf)

    # ---- MASK ----
    if MASK in akt:
        # nested branch: weight x opacity / op_lum, pdf x op_lum
        sel_n = is_mask & mask_nested
        wt = torch.where(sel_n[..., None], wt * gm.diffuse
                         / torch.clamp(op_lum, min=1e-7)[..., None], wt)
        pdf = torch.where(sel_n, pdf * op_lum, pdf)
        # pass-through branch: delta transmission straight through
        sel_t = is_mask & ~mask_nested
        wo = torch.where(sel_t[..., None], -wi, wo)
        wt = torch.where(sel_t[..., None], (1.0 - gm.diffuse)
                         / torch.clamp(1.0 - op_lum, min=1e-7)[..., None],
                         wt)
        pdf = torch.where(sel_t, 1.0 - op_lum, pdf)
        is_delta = torch.where(sel_t, True, is_delta)
        eta_s = torch.where(sel_t, 1.0, eta_s)

    # ---- COATING / ROUGHCOATING ----
    if COATING in akt or ROUGHCOATING in akt:
        from ...core.math import reflect_z
        # nested branch: refract the sampled wo out of the layer
        wo_out, R21, tir_o = _refract_out(wo, gm.eta)
        sel_n = is_coat & coat_nested
        sel_s = is_coat & ~coat_nested
        # the specular branch's direction: a mirror for the smooth coat, a
        # microfacet-sampled glossy reflection for the rough one
        # (roughcoating.cpp:293-316)
        wo_s = reflect_z(wi)
        if ROUGHCOATING in akt:
            from .plastic import _dyn_sample_m
            m_h, _ = _dyn_sample_m(gm.dist, gm.alpha, wi, u2)
            wo_g = 2.0 * torch.sum(wi * m_h, -1, keepdim=True) * m_h - wi
            wo_s = torch.where(coat_rough[..., None], wo_g, wo_s)
        # the full coated f / pdf at the outgoing direction (as eval does:
        # MIS-consistent pdfs for smooth nested lobes)
        gm_a = gather(table, tex, table.mix_a[m], uv)
        wo_eval = torch.where(sel_n[..., None], wo_out,
                              torch.where(sel_s[..., None], wo_s, wo))
        if COATING in akt:
            f_c0, p_c0 = _coat_eval_pdf(sub, gm, gm_a, wi, wo_eval,
                                        hair_tables, False)
        if ROUGHCOATING in akt:
            f_c1, p_c1 = _coat_eval_pdf(sub, gm, gm_a, wi, wo_eval,
                                        hair_tables, True)
        if COATING in akt and ROUGHCOATING in akt:
            f_c = torch.where(coat_rough[..., None], f_c1, f_c0)
            p_c = torch.where(coat_rough, p_c1, p_c0)
        elif COATING in akt:
            f_c, p_c = f_c0, p_c0
        else:
            f_c, p_c = f_c1, p_c1
        tir = tir_i | tir_o
        smooth_n = sel_n & ~is_delta & ~tir
        wo = torch.where(sel_n[..., None], wo_out, wo)
        wt = torch.where(smooth_n[..., None],
                         f_c / torch.clamp(p_c, min=1e-9)[..., None], wt)
        wt = torch.where((sel_n & (is_delta | tir))[..., None], torch.where(
            (sel_n & is_delta & ~tir)[..., None],
            wt * ((1.0 - R12) * (1.0 - R21)
                  / torch.clamp(1 - p_spec, min=1e-7))[..., None]
            * _coat_absorb(gm, wi_p, wo), 0.0), wt)
        pdf = torch.where(smooth_n, p_c, pdf)
        pdf = torch.where(sel_n & is_delta, pdf * (1 - p_spec), pdf)
        pdf = torch.where(sel_n & tir, 0.0, pdf)
        # the specular branch
        wo = torch.where(sel_s[..., None], wo_s, wo)
        # smooth coating: a delta mirror of weight specular R12 / p_spec
        sel_s_delta = sel_s & ~coat_rough
        wt = torch.where(sel_s_delta[..., None], gm.specular
                         * (R12 / torch.clamp(p_spec, min=1e-7))[..., None],
                         wt)
        pdf = torch.where(sel_s_delta, p_spec, pdf)
        is_delta = torch.where(sel_s_delta, True, is_delta)
        # rough coating: a smooth glossy lobe, weight f / pdf with the full
        # mixture pdf; below-horizon samples are rejected
        sel_s_rough = sel_s & coat_rough
        ok_g = sel_s_rough & (wo[..., 2] * wi[..., 2] > 0) & (p_c > 1e-9)
        wt = torch.where(ok_g[..., None],
                         f_c / torch.clamp(p_c, min=1e-9)[..., None],
                         torch.where(sel_s_rough[..., None], 0.0, wt))
        pdf = torch.where(sel_s_rough, torch.where(ok_g, p_c, 0.0), pdf)
        is_delta = torch.where(sel_s_rough, False, is_delta)
        eta_s = torch.where(is_coat, 1.0, eta_s)
    return wo, wt, pdf, is_delta, eta_s


def _field(v, m):
    """v[m] of a material-table field, through _Rows where v requires
    grad."""
    return _Rows.apply(v, m) if v.requires_grad else v[m]


def _luminance(c):
    return c[..., 0] * _LUM[0] + c[..., 1] * _LUM[1] + c[..., 2] * _LUM[2]


_LUM = tuple(float(x) for x in np.array([0.212671, 0.715160, 0.072169],
                                        np.float32))


def perturb_shading_frame(table: MaterialTable, tex, mat_id, uv, sh_n, sh_s,
                          sh_t):
    """(sh_n, sh_s, sh_t) with the normal or bump map of each lane's
    material applied (the JAX package's perturb_shading_frame; reference:
    src/bsdfs/{normalmap,bumpmap}.cpp): a normal map reads a tangent-space
    normal as rgb * 2 - 1, a bump map takes differences of its height
    texture's luminance at 1 / R in u and v; the normal goes to world
    through the frame, which is then re-orthogonalised."""
    if tex is None:
        return sh_n, sh_s, sh_t
    m = torch.clamp(mat_id, min=0).long()
    tid = table.nrm_tex_id[m]
    kind = table.nrm_kind[m]
    scale = table.nrm_scale[m]
    base = torch.zeros(uv.shape[:-1] + (3,), device=uv.device)
    rgb = eval_checkerboard(tex, tid, uv, base)
    n_ts = rgb * 2.0 - 1.0
    d = 1.0 / tex.bitmaps.shape[1]
    h0 = _luminance(rgb)
    du = torch.tensor([d, 0.0], dtype=uv.dtype, device=uv.device)
    dv = torch.tensor([0.0, d], dtype=uv.dtype, device=uv.device)
    hu = _luminance(eval_checkerboard(tex, tid, uv + du, base))
    hv = _luminance(eval_checkerboard(tex, tid, uv + dv, base))
    dhdu = (hu - h0) / d * scale
    dhdv = (hv - h0) / d * scale
    n_bump = torch.stack([-dhdu, -dhdv, torch.ones_like(dhdu)], -1)
    n_local = torch.where((kind == 0)[..., None], n_ts, n_bump)
    n_local = n_local / torch.sqrt(torch.clamp(
        torch.sum(n_local * n_local, -1, keepdim=True), min=1e-12))
    n_w = sh_s * n_local[..., 0:1] + sh_t * n_local[..., 1:2] \
        + sh_n * n_local[..., 2:3]
    s_w = sh_s - n_w * torch.sum(n_w * sh_s, -1, keepdim=True)
    s_w = s_w / torch.sqrt(torch.clamp(torch.sum(s_w * s_w, -1,
                                                 keepdim=True), min=1e-12))
    t_w = torch.linalg.cross(n_w, s_w)
    a = (tid >= 0)[..., None]
    return (torch.where(a, n_w, sh_n), torch.where(a, s_w, sh_s),
            torch.where(a, t_w, sh_t))
