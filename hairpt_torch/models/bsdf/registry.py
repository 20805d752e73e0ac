"""Switch-free BSDF dispatch over material tables (port of the parts of
hairpt/models/bsdf/registry.py the forward render uses).

Materials live in an SoA table; a shading wave gathers its per-lane
parameters and every family present in the scene is evaluated and
lane-selected by kind. Ported family: ROUGHPLASTIC. The scene has no
textures and no wrapper materials in this slice, so gather is a plain
table lookup, eval_pdf_mix / sample_mix equal eval_pdf / sample and
perturb_shading_frame is the identity.

Conventions (as in the reference's bsdf.h): wi, wo in the local shading
frame, +z the shading normal; eval returns f(wi, wo) |cos theta_o|;
sample returns (wo, weight = f cos / pdf, pdf, is_delta, eta_scale).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ... import resolve_device

# family ids (the JAX package's values, baked into material tables)
DIFFUSE = 0
ROUGHPLASTIC = 8

N_COS = 64  # resolution of the per-material external-transmittance slice


class MaterialTable(NamedTuple):
    """SoA material parameters, [M] leading axis."""
    kind: torch.Tensor         # [M] int32 family id
    twosided: torch.Tensor     # [M] bool
    diffuse: torch.Tensor      # [M, 3]
    specular: torch.Tensor     # [M, 3]
    alpha: torch.Tensor        # [M] microfacet roughness
    dist: torch.Tensor         # [M] 0 = ggx, 1 = beckmann
    eta: torch.Tensor          # [M] int_ior / ext_ior
    nonlinear: torch.Tensor    # [M] bool
    spec_weight: torch.Tensor  # [M] specularSamplingWeight
    ext_trans: torch.Tensor    # [M, N_COS] T12(cos theta) slice
    int_fdr: torch.Tensor      # [M] internal diffuse Fresnel reflectance


class GatheredMat(NamedTuple):
    """Per-lane material parameters."""
    kind: torch.Tensor
    diffuse: torch.Tensor
    specular: torch.Tensor
    alpha: torch.Tensor
    dist: torch.Tensor
    eta: torch.Tensor
    nonlinear: torch.Tensor
    spec_weight: torch.Tensor
    ext_trans: torch.Tensor
    int_fdr: torch.Tensor


def default_material_row(**over):
    row = dict(kind=DIFFUSE, twosided=False, diffuse=(0.5, 0.5, 0.5),
               specular=(1.0, 1.0, 1.0), alpha=0.1, dist=0, eta=1.5,
               nonlinear=False, spec_weight=0.5, ext_trans=np.ones(N_COS),
               int_fdr=0.0)
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
        alpha=arr("alpha"), dist=arr("dist", np.int32), eta=arr("eta"),
        nonlinear=arr("nonlinear", bool), spec_weight=arr("spec_weight"),
        ext_trans=arr("ext_trans"), int_fdr=arr("int_fdr"))


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


def gather(table: MaterialTable, mat_id) -> GatheredMat:
    m = torch.clamp(mat_id, min=0).long()
    fields = [getattr(table, f) for f in GatheredMat._fields]
    return GatheredMat(*[_Rows.apply(v, m) if v.requires_grad else v[m]
                         for v in fields])


def ext_trans_lookup(gm: GatheredMat, cos_theta):
    """Per-lane T12(cos theta) from the material's precomputed slice."""
    x = torch.clamp(cos_theta, 0.0, 1.0) * N_COS - 0.5
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, N_COS - 2)
    fx = torch.clamp(x - x0.to(x.dtype), 0.0, 1.0)
    t0 = torch.gather(gm.ext_trans, -1, x0[..., None])[..., 0]
    t1 = torch.gather(gm.ext_trans, -1, (x0 + 1)[..., None])[..., 0]
    return t0 * (1.0 - fx) + t1 * fx


# kind -> family class with eval_pdf(gm, wi, wo) and
# sample(gm, wi, u_lobe, u2, u2b); filled by the family modules
FAMILIES: dict = {}


def register(kind: int, family):
    FAMILIES[kind] = family


def check_kinds(active_kinds):
    missing = [k for k in active_kinds if k not in FAMILIES]
    if missing:
        raise NotImplementedError(f"BSDF kinds {missing} are not ported "
                                  f"(ported: {sorted(FAMILIES)})")


def eval_pdf(active_kinds, gm: GatheredMat, wi, wo):
    n = wi.shape[:-1]
    f = torch.zeros(n + (3,), device=wi.device)
    pdf = torch.zeros(n, device=wi.device)
    for kind in sorted(set(int(k) for k in active_kinds)):
        fk, pk = FAMILIES[kind].eval_pdf(gm, wi, wo)
        sel = gm.kind == kind
        f = torch.where(sel[..., None], fk, f)
        pdf = torch.where(sel, pk, pdf)
    return f, pdf


def sample(active_kinds, gm: GatheredMat, wi, u_lobe, u2, u2b):
    n = wi.shape[:-1]
    dev = wi.device
    wo = torch.zeros(n + (3,), device=dev)
    weight = torch.zeros(n + (3,), device=dev)
    pdf = torch.zeros(n, device=dev)
    is_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    eta_s = torch.ones(n, device=dev)
    for kind in sorted(set(int(k) for k in active_kinds)):
        wk, wtk, pk, dk, ek = FAMILIES[kind].sample(gm, wi, u_lobe, u2, u2b)
        sel = gm.kind == kind
        wo = torch.where(sel[..., None], wk, wo)
        weight = torch.where(sel[..., None], wtk, weight)
        pdf = torch.where(sel, pk, pdf)
        is_delta = torch.where(sel, dk, is_delta)
        eta_s = torch.where(sel, ek, eta_s)
    return wo, weight, pdf, is_delta, eta_s


def eval_pdf_mix(active_kinds, table, mat_id, gm, wi, wo):
    """eval_pdf behind the wrapper-material indirection (none in this
    slice's scenes)."""
    return eval_pdf(active_kinds, gm, wi, wo)


def sample_mix(active_kinds, table, mat_id, gm, wi, u_lobe, u2, u2b):
    return sample(active_kinds, gm, wi, u_lobe, u2, u2b)


def perturb_shading_frame(table, mat_id, sh_n, sh_s, sh_t):
    """Normal and bump maps need textures, which this slice has none of."""
    return sh_n, sh_s, sh_t
