"""The irawan woven-cloth BSDF and its noise (hairpt_torch/core/noise.py,
hairpt_torch/models/bsdf/cloth.py, the cloth stage of registry.gather)
against hairpt on the CPU, on inputs drawn from numpy seeds: Perlin noise
and fbm within 1e-6, the TEA hash bit for bit, the weave parser's
WeavePattern and pack_cloth's ClothTable field for field (spec_norm
within 1e-5), cloth_resolve at uvs in [-2, 3]^2, the integrand, eval_pdf
and sample on both branches (filament and staple), and gather over mixed
cloth, diffuse and hair lanes with and without a texture table; a
float64 gradcheck of the port's eval_pdf (no JAX). hairpt's functions run
eagerly (no Pallas kernel is involved)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hairpt.core import noise as jnoise
from hairpt.models.bsdf import cloth as jcloth
from hairpt.models.bsdf import registry as jmat
from hairpt.scene.scene import SceneBuilder as JBuilder
from hairpt_torch.core import noise as tnoise
from hairpt_torch.models.bsdf import cloth as tcloth
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene.scene import SceneBuilder as TBuilder
from torch_threads import one_thread  # noqa: F401

PROPS = scene_xmls.TWILL_PROPS
# the built-ins (plain: staple yarns; twill: filaments) and the cloth
# stand-in's noisy twill (its $vars from PROPS)
WEAVES = {"plain": (jcloth.BUILTIN_WEAVES["plain"], {}),
          "twill": (jcloth.BUILTIN_WEAVES["twill"], {}),
          "file": (scene_xmls.TWILL_WV, PROPS)}
REPEATS = [(3.0, 2.0), (1.0, 1.0), (5.0, 7.0)]


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _close(a, b, rtol, share, worst=1e-3):
    """|a - b| within rtol of |b| (plus 1e-6 of the largest |b|) on >=
    share of the values, and within `worst` relative everywhere."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    tol = 1e-6 * max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b)
    assert (err <= rtol * np.abs(b) + tol).mean() >= share, err.max()
    assert (err <= worst * np.abs(b) + tol).all(), err.max()


@pytest.fixture(scope="module")
def patterns():
    pj = [jcloth.parse_weave(t, p) for t, p in WEAVES.values()]
    pt = [tcloth.parse_weave(t, p) for t, p in WEAVES.values()]
    return pj, pt


@pytest.fixture(scope="module")
def tables(patterns):
    pj, pt = patterns
    return (jcloth.pack_cloth(pj, REPEATS),
            tcloth.pack_cloth(pt, REPEATS, device="cpu"))


def test_perlin_and_fbm_match():
    p = np.random.RandomState(0).uniform(-40, 40, (4096, 3)) \
        .astype(np.float32)
    for fn in ("perlin", "fbm"):
        a = np.asarray(getattr(jnoise, fn)(jnp.asarray(p)))
        b = getattr(tnoise, fn)(_t(p)).numpy()
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rounds", [4, 8])
def test_sample_tea_bit_for_bit(rounds):
    """2^16 u32 pairs, a quarter of them within 2^12 of 2^32, so the sums
    and shifts wrap."""
    rs = np.random.RandomState(rounds)
    v = rs.randint(0, 2 ** 32, (2, 1 << 16), dtype=np.uint64)
    v[:, ::4] = 2 ** 32 - 1 - rs.randint(0, 4096, (2, 1 << 14))
    v0, v1 = v.astype(np.uint32)
    a0, a1 = jnoise.sample_tea(v0, v1, rounds)
    b0, b1 = tnoise.sample_tea(_t(v0.astype(np.int64)),
                               _t(v1.astype(np.int64)), rounds)
    np.testing.assert_array_equal(b0.numpy(), np.asarray(a0, np.int64))
    np.testing.assert_array_equal(b1.numpy(), np.asarray(a1, np.int64))
    fa = np.asarray(jnoise.sample_tea_float(v0, v1, rounds))
    fb = tnoise.sample_tea_float(_t(v0.astype(np.int64)),
                                 _t(v1.astype(np.int64)), rounds).numpy()
    assert fb.dtype == np.float32
    np.testing.assert_array_equal(fb.view(np.int32), fa.view(np.int32))


def test_float_to_u32_follows_xla():
    """The cast of cloth_resolve's noise positions: XLA saturates
    (negative and NaN to 0, past 2^32 - 1 to 2^32 - 1)."""
    x = np.array([-5e9, -3.5, -1.0, -0.3, -0.0, 0.0, 0.7, 3.7, 2 ** 31,
                  4294967040.0, 5e9, np.inf, -np.inf, np.nan], np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.uint32), np.int64)
    np.testing.assert_array_equal(tnoise.float_to_u32(_t(x)).numpy(), want)


@pytest.mark.parametrize("name", sorted(WEAVES))
def test_parse_weave_fields(name):
    text, props = WEAVES[name]
    a = jcloth.parse_weave(text, props)
    b = tcloth.parse_weave(text, props)
    assert vars(a) == vars(b)
    if name == "file":
        assert b.fineness > 0 and b.period > 0 and b.yarns[0]["kd"] == \
            PROPS["warp_kd"]
        assert all(getattr(b, f"d_{a_}_umax_over_d_{c}") != 0
                   for a_ in ("warp", "weft") for c in ("warp", "weft"))


def test_pack_cloth_fields(tables):
    ct_j, ct_t = tables
    for f in tcloth.ClothTable._fields:
        a = np.asarray(getattr(ct_j, f))
        b = getattr(ct_t, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f == "spec_norm":
            np.testing.assert_allclose(b, a, rtol=1e-5)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


def test_cloth_resolve_matches(tables):
    """2^16 lanes over the three patterns at uvs in [-2, 3]^2 (negative
    cell positions, so the saturating u32 cast runs): the yarn's ids and
    flags equal, the floats within 1e-5 relative."""
    ct_j, ct_t = tables
    ct_t = ct_t._replace(spec_norm=_t(np.asarray(ct_j.spec_norm)))
    rs = np.random.RandomState(3)
    n = 1 << 16
    uv = rs.uniform(-2, 3, (n, 2)).astype(np.float32)
    pid = rs.randint(0, len(REPEATS), n).astype(np.int32)
    for init in (False, True):
        rj = jcloth.cloth_resolve(ct_j, jnp.asarray(pid), jnp.asarray(uv),
                                  init=init)
        rt = tcloth.cloth_resolve(ct_t, _t(pid), _t(uv), init=init)
        assert sorted(rj) == sorted(rt)
        for k in rj:
            a = np.asarray(rj[k])
            b = rt[k].numpy()
            assert a.shape == b.shape, k
            if a.dtype == bool:
                np.testing.assert_array_equal(b, a, err_msg=k)
            else:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-30,
                                           err_msg=k)


def _rows(builder_cls, patterns, **kw):
    """Material rows through the builder: the three weaves (the plain one
    twosided), a diffuse, a textured diffuse and a Kajiya-Kay hair row."""
    b = builder_cls(**kw)
    for wp, (ru, rv) in zip(patterns, REPEATS):
        b.add_material(kind=tmat.CLOTH, weave=wp, repeat_u=ru, repeat_v=rv,
                       twosided=wp.name == "plain weave")
    b.add_material(kind=tmat.DIFFUSE, diffuse=(0.3, 0.5, 0.7))
    b.add_material(kind=tmat.DIFFUSE, diffuse=(0.2, 0.2, 0.2), tex_id=0)
    b.add_material(kind=tmat.KAJIYAKAY, diffuse=(0.4, 0.3, 0.2),
                   exponent=12.0)
    return b.materials, b.cloth


@pytest.fixture(scope="module")
def mats(patterns):
    """hairpt's and the port's material tables of _rows, and a
    checkerboard texture table built from the same arrays."""
    pj, pt = patterns
    rows_j, cl_j = _rows(JBuilder, pj)
    rows_t, cl_t = _rows(TBuilder, pt, device="cpu")
    ct_j = jcloth.pack_cloth([c[0] for c in cl_j],
                             [(c[1], c[2]) for c in cl_j])
    ct_t = tcloth.pack_cloth([c[0] for c in cl_t],
                             [(c[1], c[2]) for c in cl_t], device="cpu")
    tex_t = tmat.pack_checkers([(tmat.TEX_CHECKER, (0.9, 0.1, 0.1),
                                 (0.1, 0.9, 0.1), (4.0, 4.0), (0.0, 0.0),
                                 0.01)], device="cpu")
    tex_j = jmat.CheckerboardTable(**{
        f: jnp.asarray(getattr(tex_t, f).numpy())
        for f in jmat.CheckerboardTable._fields})
    return (jmat.pack_materials(rows_j, cloth=ct_j),
            tmat.pack_materials(rows_t, device="cpu", cloth=ct_t),
            tex_j, tex_t)


@pytest.mark.parametrize("textured", [False, True])
def test_gather_mixed_lanes(mats, textured):
    """Cloth, diffuse, textured diffuse and hair lanes in one wave: every
    GatheredMat field of every lane as hairpt's gather gives it (the
    cloth lanes' yarn resolved, the others untouched)."""
    tab_j, tab_t, tex_j, tex_t = mats
    if not textured:
        tex_j = tex_t = None
    rs = np.random.RandomState(5)
    n = 8192
    mid = rs.randint(0, 6, n).astype(np.int32)
    uv = rs.uniform(-2, 3, (n, 2)).astype(np.float32)
    gj = jmat.gather(tab_j, tex_j, jnp.asarray(mid), jnp.asarray(uv))
    gt = tmat.gather(tab_t, tex_t, _t(mid), _t(uv))
    for f in tmat.GatheredMat._fields:
        a = np.asarray(getattr(gj, f))
        b = getattr(gt, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-30,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    cl = mid < 3
    assert (gt.kind.numpy()[cl] == tmat.CLOTH).all()
    if not textured:
        with pytest.raises(ValueError, match="uv"):
            tmat.gather(tab_t, None, _t(mid), None)


def _dirs(rs, n):
    d = rs.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2]) * np.where(rs.rand(n) < 0.1, -1, 1)
    return d.astype(np.float32)


@pytest.mark.parametrize("branch", ["staple", "filament"])
def test_integrand_eval_and_sample(mats, branch):
    """4,096 lanes of the plain weave (staple yarns) or of the noisy twill
    (filaments): the integrand, eval_pdf's f and pdf and sample's outputs
    within 1e-5 relative on 99% of the values, all within 1e-3; the pdf
    within 1e-6."""
    tab_j, tab_t, _, _ = mats
    rs = np.random.RandomState(7 if branch == "staple" else 8)
    n = 4096
    mid = np.full(n, 0 if branch == "staple" else 2, np.int32)
    uv = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    wi, wo = _dirs(rs, n), _dirs(rs, n)
    u2 = rs.rand(n, 2).astype(np.float32)
    gj = jmat.gather(tab_j, None, jnp.asarray(mid), jnp.asarray(uv))
    gt = tmat.gather(tab_t, None, _t(mid), _t(uv))
    res_j = jcloth._cloth_res_from_gm(gj)
    res_t = tcloth._cloth_res_from_gm(gt)
    args_j = [gj.transmit[..., 0], gj.transmit[..., 1], gj.transmit[..., 2],
              gj.k[..., 0]]
    args_t = [gt.transmit[..., 0], gt.transmit[..., 1], gt.transmit[..., 2],
              gt.k[..., 0]]
    sj = np.asarray(jcloth._integrand(res_j, jnp.asarray(wi),
                                      jnp.asarray(wo), *args_j))
    st = tcloth._integrand(res_t, _t(wi), _t(wo), *args_t).numpy()
    assert (sj > 0).mean() > 0.02
    assert (np.abs(gt.scale_tilt.numpy()) > 1e-9).all() == (branch ==
                                                           "staple")
    _close(st, sj, 1e-5, 0.99)
    fj, pj = jcloth.Cloth.eval_pdf(gj, jnp.asarray(wi), jnp.asarray(wo),
                                   None)
    ft, pt = tcloth.Cloth.eval_pdf(gt, _t(wi), _t(wo), None)
    _close(ft.numpy(), fj, 1e-5, 0.99)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=1e-6)
    out_j = jcloth.Cloth.sample(gj, jnp.asarray(wi), None, jnp.asarray(u2),
                                None, None)
    out_t = tcloth.Cloth.sample(gt, _t(wi), None, _t(u2), None, None)
    _close(out_t[0].numpy(), out_j[0], 1e-5, 0.99)
    _close(out_t[1].numpy(), out_j[1], 1e-5, 0.99)
    np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    # through the registry's dispatch, as an integrator calls it
    f2, p2 = tmat.eval_pdf((tmat.CLOTH,), gt, _t(wi), _t(wo))
    np.testing.assert_array_equal(f2.numpy(), ft.numpy())
    np.testing.assert_array_equal(p2.numpy(), pt.numpy())


def test_eval_pdf_gradcheck(mats):
    """float64 gradients of the port's eval_pdf with respect to kd, ks and
    wi on lanes of both branches whose integrand is positive (away from
    the selection edges: the finite differences step 1e-6)."""
    _, tab_t, _, _ = mats
    rs = np.random.RandomState(11)
    n = 4096
    mid = np.where(rs.rand(n) < 0.5, 0, 2).astype(np.int32)
    uv = rs.uniform(0, 1, (n, 2)).astype(np.float32)
    wi, wo = _dirs(rs, n), _dirs(rs, n)
    gt = tmat.gather(tab_t, None, _t(mid), _t(uv))
    spec = tcloth._integrand(tcloth._cloth_res_from_gm(gt), _t(wi), _t(wo),
                             gt.transmit[..., 0], gt.transmit[..., 1],
                             gt.transmit[..., 2], gt.k[..., 0]).numpy()
    pick = np.concatenate([np.nonzero((spec > 0) & (mid == m))[0][:6]
                           for m in (0, 2)])
    assert len(pick) == 12
    gm = tmat.GatheredMat(*[
        v[_t(pick)].to(torch.float64) if v.is_floating_point()
        else v[_t(pick)] for v in gt])
    wo64 = _t(wo[pick], torch.float64)

    def f(kd, ks, wi_):
        g = gm._replace(diffuse=kd, specular=ks)
        fv, pdf = tcloth.Cloth.eval_pdf(g, wi_, wo64, None)
        return fv, pdf
    kd = gm.diffuse.clone().requires_grad_(True)
    ks = gm.specular.clone().requires_grad_(True)
    wi64 = _t(wi[pick], torch.float64).requires_grad_(True)
    assert torch.autograd.gradcheck(f, (kd, ks, wi64), eps=1e-6, atol=1e-5,
                                    rtol=1e-3)
