"""The surface BSDF families and the wrapper materials of hairpt_torch
against hairpt: fresnel_conductor, eval_pdf and sample of each family per
lane, and eval_pdf_mix / sample_mix on a table holding all four
wrappers (tests/test_torch_materials.py renders them), and path-replay
backprop against the differentiable mode on the materials stand-in. Lanes cover both
hemispheres, grazing angles, total internal reflection and eta < 1. Bound: 1e-4 relative or
1e-6 absolute (tests/test_torch_bsdf.py's bound for rough plastic's eval)
on at least 99% of the values, and 1e-2 relative or 1e-4 absolute on
all. The two packages' sin, cos, exp, log and rsqrt round the last bit
differently, and the lobes amplify that: a Beckmann lobe of alpha 0.1
takes exp(-tan^2 / alpha^2) of 1 - cos^2 of a sampled or half vector
(half of its sampled pdfs differ by more than 1e-5 relative), a Phong
lobe cos^40, a microfacet sample refracted out of a coating near the
critical angle a square root of a difference."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.models.bsdf import dielectric_rough as jdr  # noqa: F401
from hairpt.models.bsdf import plastic as jplastic  # noqa: F401
from hairpt.models.bsdf import registry as jmat
from hairpt.models.bsdf import simple as jsimple  # noqa: F401
from hairpt.models.bsdf.fresnel import fresnel_conductor as jfc
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch.integrators import inverse as tinv
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.models.bsdf.fresnel import fresnel_conductor as tfc
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene.scene import SceneBuilder as TSceneBuilder
from hairpt_torch.scene.xml_loader import load_scene as tload
from torch_threads import one_thread  # noqa: F401

N = 4096
RTOL, ATOL = 1e-4, 1e-6
TIGHT_SHARE = 0.99
LOOSE_RTOL, LOOSE_ATOL = 1e-2, 1e-4
CU = dict(eta=0.95, k=(3.9, 2.45, 2.14))
AU = dict(eta=0.40, k=(2.82, 2.35, 1.77))

# each family's rows: GGX and Beckmann, eta > 1 and eta < 1
FAMILY_ROWS = {
    "roughdiffuse": [dict(kind=jmat.ROUGHDIFFUSE, alpha=0.3,
                          diffuse=(0.6, 0.5, 0.4)),
                     dict(kind=jmat.ROUGHDIFFUSE, alpha=0.9)],
    "conductor": [dict(kind=jmat.CONDUCTOR, specular=(0.9, 0.8, 0.7), **AU),
                  dict(kind=jmat.CONDUCTOR, eta=1e4, k=(0.0, 0.0, 0.0))],
    "roughconductor": [dict(kind=jmat.ROUGHCONDUCTOR, alpha=0.2, dist=0,
                            **CU),
                       dict(kind=jmat.ROUGHCONDUCTOR, alpha=0.35, dist=1,
                            **AU)],
    "dielectric": [dict(kind=jmat.DIELECTRIC, eta=1.5046,
                        transmit=(0.9, 0.8, 1.0)),
                   dict(kind=jmat.DIELECTRIC, eta=0.7)],
    "thindielectric": [dict(kind=jmat.THINDIELECTRIC, eta=1.5046),
                       dict(kind=jmat.THINDIELECTRIC, eta=0.75,
                            specular=(0.5, 0.6, 0.7))],
    "roughdielectric": [dict(kind=jmat.ROUGHDIELECTRIC, eta=1.5046,
                             alpha=0.2, dist=0),
                        dict(kind=jmat.ROUGHDIELECTRIC, eta=0.75, alpha=0.1,
                             dist=1)],
    "difftrans": [dict(kind=jmat.DIFFTRANS, transmit=(0.5, 0.6, 0.7))],
    "null": [dict(kind=jmat.NULL, transmit=(0.9, 0.9, 0.8))],
    "phong": [dict(kind=jmat.PHONG, exponent=40.0, diffuse=(0.3, 0.1, 0.1),
                   specular=(0.4, 0.4, 0.4)),
              dict(kind=jmat.PHONG, exponent=5.0)],
    "ward": [dict(kind=jmat.WARD, alpha=0.15, diffuse=(0.1, 0.2, 0.3),
                  specular=(0.3, 0.3, 0.3)),
             dict(kind=jmat.WARD, alpha=0.4)],
}


def _dirs(rs, n=N, upper=0.7):
    """Unit directions, `upper` of them in the upper hemisphere, an
    eighth grazing (|z| <= 1e-3)."""
    w = rs.normal(size=(n, 3)).astype(np.float32)
    graze = rs.random(n) < 0.125
    w[graze, 2] = rs.uniform(-1e-3, 1e-3, graze.sum())
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    up = rs.random(n) < upper
    w[:, 2] = np.where(up, np.abs(w[:, 2]), -np.abs(w[:, 2]))
    return w


def _tables(rows, seed):
    bj, bt = JSceneBuilder(), TSceneBuilder(device="cpu")
    for r in rows:
        bj.add_material(**dict(r))
        bt.add_material(**dict(r))
    tj = jmat.pack_materials(bj.materials)
    tt = tmat.pack_materials(bt.materials, device="cpu")
    mid = np.random.default_rng(seed).integers(0, len(rows), N).astype(
        np.int32)
    return tj, tt, mid


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == bool:
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        tight = np.isclose(a, b, rtol=RTOL, atol=ATOL).mean()
        assert tight >= TIGHT_SHARE, (what, tight)
        np.testing.assert_allclose(a, b, rtol=LOOSE_RTOL, atol=LOOSE_ATOL,
                                   err_msg=what)


def test_fresnel_conductor_matches_jax():
    rs = np.random.default_rng(1)
    c = np.concatenate([np.linspace(0, 1, 1001),
                        rs.uniform(0, 1e-3, 64)]).astype(np.float32)
    for eta, k in ((0.4, (2.82, 2.35, 1.77)), (0.95, (3.9, 2.45, 2.14)),
                   (1e4, (0.0, 0.0, 0.0)), (1.35, (7.47, 6.4, 5.3))):
        e3 = np.full((c.shape[0], 3), eta, np.float32)
        k3 = np.broadcast_to(np.asarray(k, np.float32), e3.shape).copy()
        _close(tfc(torch.as_tensor(c), torch.as_tensor(e3),
                   torch.as_tensor(k3)).numpy(),
               jfc(jnp.asarray(c), jnp.asarray(e3), jnp.asarray(k3)),
               f"eta {eta}")


@pytest.mark.parametrize("family", sorted(FAMILY_ROWS))
def test_family_matches_jax(family):
    """eval_pdf at seeded (wi, wo) and sample at seeded (wi, u) through
    the registry's dispatch, the same rows built by both SceneBuilders."""
    rows = FAMILY_ROWS[family]
    tj, tt, mid = _tables(rows, 2)
    for f in tmat.MaterialTable._fields:
        if f == "cloth":  # no irawan row: no weave table
            assert getattr(tt, f) is None and getattr(tj, f) is None
            continue
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)), err_msg=f)
    rs = np.random.default_rng(3)
    wi, wo = _dirs(rs), _dirs(rs, upper=0.5)
    u_lobe = rs.random(N).astype(np.float32)
    u2, u2b = (rs.random((N, 2)).astype(np.float32) for _ in range(2))
    kinds = tuple(sorted({r["kind"] for r in rows}))
    gj = jmat.gather(tj, None, jnp.asarray(mid), jnp.zeros((N, 2)))
    gt = tmat.gather(tt, None, torch.as_tensor(mid))
    fj, pj = jmat.eval_pdf(kinds, gj, jnp.asarray(wi), jnp.asarray(wo))
    ft, pt = tmat.eval_pdf(kinds, gt, torch.as_tensor(wi),
                           torch.as_tensor(wo))
    _close(ft.numpy(), fj, "f")
    _close(pt.numpy(), pj, "pdf")
    sj = jmat.sample(kinds, gj, jnp.asarray(wi), jnp.asarray(u_lobe),
                     jnp.asarray(u2), jnp.asarray(u2b))
    st = tmat.sample(kinds, gt, torch.as_tensor(wi), torch.as_tensor(u_lobe),
                     torch.as_tensor(u2), torch.as_tensor(u2b))
    names = ("wo", "weight", "pdf", "is_delta", "eta_s")
    sj = dict(zip(names, sj))
    if family == "phong":
        # the sampled lobe's pdf and weight are cos^40 of the sampled
        # direction: its last-bit differences (the two packages' sin, cos
        # and rsqrt) move them 40 ulps, so they are held to hairpt's eval
        # at the port's own direction
        fj2, pj2 = jmat.eval_pdf(kinds, gj, jnp.asarray(wi),
                                 jnp.asarray(st[0].numpy()))
        sj["pdf"] = pj2
        sj["weight"] = jnp.where(pj2[..., None] > 0, fj2 / jnp.maximum(
            pj2, 1e-12)[..., None], 0.0)
    for name, a in zip(names, st):
        _close(a.numpy(), sj[name], name)
    assert float(np.asarray(sj["pdf"]).max()) > 0


WRAPPER_ROWS = [
    dict(kind=jmat.DIFFUSE, diffuse=(0.5, 0.3, 0.2)),                  # 0
    dict(kind=jmat.ROUGHCONDUCTOR, alpha=0.2, dist=0, **CU),           # 1
    dict(kind=jmat.DIELECTRIC, eta=1.5046),                            # 2
    dict(kind=jmat.MIXTURE, mix_a=0, mix_b=1, mix_w=0.3),              # 3
    dict(kind=jmat.MASK, mix_a=0, diffuse=(0.5, 0.4, 0.6)),            # 4
    dict(kind=jmat.COATING, mix_a=1, eta=1.5046,
         sigma_a=(0.1, 0.2, 0.3)),                                     # 5
    dict(kind=jmat.ROUGHCOATING, mix_a=0, eta=1.5046, alpha=0.1,
         dist=0),                                                      # 6
    dict(kind=jmat.MIXTURE, mix_a=0, mix_b=2, mix_w=0.6),              # 7
    dict(kind=jmat.CONDUCTOR, **AU),                                   # 8
    dict(kind=jmat.COATING, mix_a=8, eta=1.33),                        # 9
    dict(kind=jmat.ROUGHCOATING, mix_a=1, eta=1.5, alpha=0.3, dist=1),  # 10
]


def test_wrappers_match_jax():
    """eval_pdf_mix and sample_mix over a table with MIXTURE (smooth and
    delta sub-materials), MASK, COATING (over a rough and over a smooth
    conductor) and ROUGHCOATING, lanes on every row."""
    tj, tt, mid = _tables(WRAPPER_ROWS, 4)
    for f in tmat.MaterialTable._fields:
        if f == "cloth":  # no irawan row: no weave table
            assert getattr(tt, f) is None and getattr(tj, f) is None
            continue
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)), err_msg=f)
    rs = np.random.default_rng(5)
    wi, wo = _dirs(rs, upper=0.85), _dirs(rs, upper=0.85)
    u_lobe = rs.random(N).astype(np.float32)
    u2, u2b = (rs.random((N, 2)).astype(np.float32) for _ in range(2))
    kinds = tuple(sorted({r["kind"] for r in WRAPPER_ROWS}))
    uv = np.zeros((N, 2), np.float32)
    mj, mt = jnp.asarray(mid), torch.as_tensor(mid)
    gj = jmat.gather(tj, None, mj, jnp.asarray(uv))
    gt = tmat.gather(tt, None, mt, torch.as_tensor(uv))
    fj, pj = jmat.eval_pdf_mix(kinds, tj, None, mj, jnp.asarray(uv), gj,
                               jnp.asarray(wi), jnp.asarray(wo))
    ft, pt = tmat.eval_pdf_mix(kinds, tt, None, mt, torch.as_tensor(uv), gt,
                               torch.as_tensor(wi), torch.as_tensor(wo))
    _close(ft.numpy(), fj, "f")
    _close(pt.numpy(), pj, "pdf")
    sj = jmat.sample_mix(kinds, tj, None, mj, jnp.asarray(uv), gj,
                         jnp.asarray(wi), jnp.asarray(u_lobe),
                         jnp.asarray(u2), jnp.asarray(u2b))
    st = tmat.sample_mix(kinds, tt, None, mt, torch.as_tensor(uv), gt,
                         torch.as_tensor(wi), torch.as_tensor(u_lobe),
                         torch.as_tensor(u2), torch.as_tensor(u2b))
    for name, a, b in zip(("wo", "weight", "pdf", "is_delta", "eta_s"),
                          st, sj):
        _close(a.numpy(), b, name)
    # every wrapper row has lanes that sampled a direction
    pdf = np.asarray(sj[2])
    for row in range(3, 8):
        assert (pdf[mid == row] > 0).any(), row


RES = 32


def test_prb_matches_the_differentiable_mode_with_wrappers(tmp_path):
    """Path-replay backprop against the differentiable mode at depth 3
    (RR off, no shadow-ray RR) on the materials stand-in without its hair
    (32^2), whose spheres include a
    mixture and a dielectric: the loss within 1e-4 relative, the diffuse
    gradient (which reaches the mixture's diffuse sub-row through
    gather) within 5e-3 of its largest |g| (tests/test_torch_prb.py's
    bounds)."""
    xml = scene_xmls.write_scene(str(tmp_path), "materials", res=RES,
                                 hair=False)
    ts = tload(xml, device="cpu")
    ts = ts._replace(config=dataclasses.replace(
        ts.config, max_depth=3, rr_depth=999, nee_rr=0.0))
    n = RES * RES
    pix, smp = torch.arange(n), torch.zeros(n, dtype=torch.int64)
    params = {"diffuse": ts.arrays.materials.diffuse.clone()}
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    li = tpath.make_li_fn(ts, differentiable=True)
    rad, _, _ = li(tinv.apply_params_arrays(ts.arrays, leaves, ()), pix, smp)
    loss = rad.mean()
    loss.backward()
    g_scan = leaves["diffuse"].grad.numpy()
    l_prb, g_prb = tinv.make_prb_loss_grad(ts)(ts.arrays, params, pix, smp)
    assert float(l_prb) == pytest.approx(loss.item(), rel=1e-4)
    g_prb = g_prb["diffuse"].numpy()
    scale = np.abs(g_scan).max()
    assert scale > 0
    mix_rows = [i for i, k in enumerate(ts.arrays.materials.kind.tolist())
                if k == tmat.MIXTURE]
    sub = [int(ts.arrays.materials.mix_b[r]) for r in mix_rows]
    assert np.abs(g_scan[sub]).max() > 0
    np.testing.assert_allclose(g_prb / scale, g_scan / scale, atol=5e-3)
