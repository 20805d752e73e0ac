"""hairpt_torch's hair BSDFs (models/bsdf/hair.py) against hairpt's on
seeded numpy inputs: the azimuthal precompute, its sampling tables and
quad packing, their gradients, and eval / pdf / sample of Kajiya-Kay,
Marschner (faithful and corrected) and MarschnerDielectric; the port's
own checks of lobe linearity, sample / pdf consistency and the table
lookup's backward; the procedural hair generators bit for bit.

The JAX side runs eagerly (no Pallas kernel is involved), so this file
compiles nothing."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hairpt.core import rng as jrng
from hairpt.models.bsdf import hair as jhair
from hairpt.models.bsdf import registry as jmat
from hairpt.scene import hairgen as jgen
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch.core import rng as trng
from hairpt_torch.models.bsdf import hair as thair
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.scene import hairgen as tgen
from hairpt_torch.scene.scene import SceneBuilder as TSceneBuilder
from torch_threads import one_thread  # noqa: F401

N = 4096
KINDS = {"kajiyakay": jmat.KAJIYAKAY, "marschner": jmat.MARSCHNER,
         "marschner_pure": jmat.MARSCHNER_PURE,
         "marschnerdielectric": jmat.MARSCHNERDIELECTRIC}
# two parameter sets: the furball's hair and a lighter, rougher one
PARAMS = [((0.5, 0.5, 0.5), 0.1, 1.55), ((0.9, 0.45, 0.25), 0.3, 1.3)]
# a CDF edge: a lane whose uniform sample lies this close to a lobe,
# bin or branch boundary may choose differently in the two packages
EDGE = 1e-6
# an azimuth bin narrower than this share of its row's CDF: the sampled
# position inside it is (u - lo) / (hi - lo), which an ulp of the CDF
# near 1 (6e-8) moves by over 1e-3
SLIVER = 6e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# the azimuthal tables
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=PARAMS, ids=["furball", "light"])
def tables(request):
    sa, br, eta = request.param
    vj = np.asarray(jhair.precompute_azimuthal(jnp.asarray(sa, jnp.float32),
                                               br, eta))
    vt = thair.precompute_azimuthal(sa, br, eta)
    return request.param, vj, vt


def test_precompute_azimuthal_matches_jax(tables):
    """Within 2e-6 of the table's largest value: a Gauss-Legendre sum of
    140 terms per texel, summed by einsum in another order than XLA's
    (measured: 7.7e-7)."""
    _, vj, vt = tables
    assert vt.shape == vj.shape == (3, thair.AZ_RES, thair.AZ_RES, 3)
    assert vt.dtype == torch.float32
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0,
                               atol=2e-6 * np.abs(vj).max())


def test_sampling_tables_and_quad_pack_match_jax(tables):
    """On the same values: the dilated weights and the quads exactly
    (max, roll and slicing), the lobe weights within 1e-6 relative (a sum
    of 64)."""
    _, vj, _ = tables
    wj, lwj = jhair.azimuthal_sampling_tables(jnp.asarray(vj))
    wt, lwt = thair.azimuthal_sampling_tables(_t(vj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_allclose(lwt.numpy(), np.asarray(lwj), rtol=1e-6)
    stacked = np.stack([vj, 0.5 * vj])
    np.testing.assert_array_equal(
        thair.quad_pack(_t(stacked)).numpy(),
        np.asarray(jhair.quad_pack(jnp.asarray(stacked))))


def test_precompute_gradient_matches_jax(tables):
    """d/d(sigma_a, beta_r, eta) of a seeded weighted sum of the tables
    against jax.grad, each within 1e-4 of its size (measured: 2.1e-5, on
    beta_r through the detector table's interpolation)."""
    (sa, br, eta), vj, _ = tables
    w = np.random.default_rng(0).standard_normal(vj.shape) \
        .astype(np.float32)

    def fj(s, b, e):
        return jnp.sum(jhair.precompute_azimuthal(s, b, e) * w)
    gj = jax.grad(fj, argnums=(0, 1, 2))(jnp.asarray(sa, jnp.float32),
                                         jnp.float32(br), jnp.float32(eta))
    leaves = [torch.tensor(x, dtype=torch.float32, requires_grad=True)
              for x in (sa, br, eta)]
    (thair.precompute_azimuthal(*leaves) * _t(w)).sum().backward()
    for a, b in zip(gj, leaves):
        a = np.asarray(a)
        np.testing.assert_allclose(b.grad.numpy(), a, rtol=0,
                                   atol=1e-4 * np.abs(a).max())


def _quad_grad(lookup, quad, blk, g):
    q = quad.clone().requires_grad_()
    out = lookup(q, blk)
    (out * g).sum().backward()
    return out, q.grad


def test_table_lookup_backward_equals_plain_indexing():
    """take_rows (index_select, whose backward is an index_add_ over the
    rows) gives plain indexing's values and gradient bit for bit: 3,969
    blocks of 36 floats, 20,000 lanes crowded onto a few of them, small
    integer cotangents (every order of summation is exact)."""
    rs = np.random.default_rng(1)
    quad = torch.as_tensor(rs.random((1, 63, 63, 3, 4, 3)),
                           dtype=torch.float32)
    flat = quad.reshape(-1, 3, 4, 3)
    blk = torch.as_tensor(np.concatenate([
        rs.integers(0, flat.shape[0], 12000), rs.integers(3900, 3969, 8000)]))
    g = torch.as_tensor(rs.integers(-8, 9, (blk.shape[0], 3, 4, 3)),
                        dtype=torch.float32)
    a, ga = _quad_grad(lambda q, i: thair.take_rows(q.reshape(-1, 3, 4, 3),
                                                    i), quad, blk, g)
    b, gb = _quad_grad(lambda q, i: q.reshape(-1, 3, 4, 3)[i], quad, blk, g)
    assert torch.equal(a, b)
    assert torch.equal(ga, gb)


# ---------------------------------------------------------------------------
# the BSDFs on fixed inputs
# ---------------------------------------------------------------------------

def _dirs(seed, upper_frac=0.9):
    rs = np.random.default_rng(seed)
    w = rs.normal(size=(N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    flip = rs.random(N) < upper_frac
    w[:, 2] = np.where(flip, np.abs(w[:, 2]), -np.abs(w[:, 2]))
    return w


def _setup(kind):
    """Two material rows of one kind (the furball's hair with bench.py's
    diffuse, and a pure-hair row without diffuse), built by both
    packages' SceneBuilder; lanes spread over both rows; the hair tables
    of each (values from hairpt, so only the BSDF differs), with and
    without quads."""
    rows = [dict(kind=kind, sigma_a=(0.5, 0.5, 0.5), beta_r=0.1, eta=1.55,
                 alpha=0.2, exponent=12.0,
                 diffuse=(0.143016, 0.0156076, 1.80928e-05)),
            dict(kind=kind, sigma_a=(0.9, 0.45, 0.25), beta_r=0.3, eta=1.3,
                 alpha=0.3, exponent=40.0, diffuse=(0.0, 0.0, 0.0),
                 transmit=(0.6, 0.7, 0.8))]
    bj, bt = JSceneBuilder(), TSceneBuilder(device="cpu")
    for r in rows:
        bj.add_material(**dict(r))
        bt.add_material(**dict(r))
    tj = jmat.pack_materials(bj.materials)
    tt = tmat.pack_materials(bt.materials, device="cpu")
    for f in tmat.MaterialTable._fields:
        if f == "cloth":  # no irawan row: no weave table
            assert getattr(tt, f) is None and getattr(tj, f) is None
            continue
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)),
                                      err_msg=f)
    mid = np.random.default_rng(0).integers(0, 2, N).astype(np.int32)
    gj = jmat.gather(tj, None, jnp.asarray(mid), jnp.zeros((N, 2)))
    gt = tmat.gather(tt, None, torch.as_tensor(mid))
    auxes = []
    if bj.hair_aux:
        vals = np.stack([np.asarray(jhair.precompute_azimuthal(
            jnp.asarray(s, jnp.float32), b, e)) for s, b, e in bj.hair_aux])
        ws, lws = zip(*[jhair.azimuthal_sampling_tables(jnp.asarray(v))
                        for v in vals])
        aj = jmat.HairTables(values=jnp.asarray(vals), weights=jnp.stack(ws),
                             lobe_weight=jnp.stack(lws))
        at = tmat.HairTables(values=_t(vals),
                             weights=_t(np.asarray(jnp.stack(ws))),
                             lobe_weight=_t(np.asarray(jnp.stack(lws))))
        auxes = [(aj, at), (aj._replace(values_quad=jhair.quad_pack(
            aj.values)), at._replace(values_quad=thair.quad_pack(at.values)))]
    else:
        auxes = [(None, None)]
    return gj, gt, auxes


def _edge_lanes(kind, gt, wi, u_lobe, u2, u2b, aux):
    """Lanes whose lobe, azimuth bin or branch choice sits within EDGE of
    a CDF edge, or whose azimuth bin is a SLIVER, from the port's own
    sampling quantities."""
    wi, u_lobe, u2, u2b = (_t(x) for x in (wi, u_lobe, u2, u2b))
    if kind == jmat.KAJIYAKAY:
        return (u_lobe - gt.spec_weight).abs() < EDGE
    if kind == jmat.MARSCHNERDIELECTRIC:
        from hairpt_torch.models.bsdf.fresnel import fresnel_dielectric
        F, _ = fresnel_dielectric(wi[..., 2], gt.eta)
        T = 1.0 - F
        Rp = torch.where(F < 1.0, F + T * T * F / (1.0 - F * F + 1e-12), F)
        x = u_lobe / gt.spec_weight.clamp(min=1e-7)
        return ((u_lobe - gt.spec_weight).abs() < EDGE) \
            | ((x - Rp).abs() < EDGE)
    k = thair._aux_row(gt)
    if kind == jmat.MARSCHNER:
        lobe_u, phi_u = u2[..., 0], u2[..., 1]
        branch = (u2[..., 1] - thair.RoughPlastic._prob_spec(gt, wi)).abs() \
            < EDGE
    else:
        lobe_u, phi_u = u2b[..., 0], u2b[..., 1]
        branch = (u_lobe - thair._marschner_p_spec(gt, wi)).abs() < EDGE
    sin_ti = wi[..., 1]
    cos_ti = torch.clamp(torch.sqrt((1.0 - sin_ti * sin_ti).clamp(min=0)),
                         max=1.0)
    theta_i = torch.asin(sin_ti.clamp(-1, 1))
    lw = thair._lobe_weight_lanes(aux.lobe_weight, k, 63 * cos_ti)
    c = torch.cumsum(lw, -1) / lw.sum(-1, keepdim=True)
    lobe_edge = (c[..., :2] - lobe_u[..., None]).abs().amin(-1) < EDGE
    lobe = thair._select_lobe(lobe_u * lw.sum(-1), lw)
    th, v3 = thair._lobe_thetas(gt, theta_i)
    th_sel = thair._pick(th, lobe)
    sin_to = thair.sample_longitudinal(
        thair._pick(v3, lobe), torch.sin(th_sel), torch.cos(th_sel),
        u2[..., 0], u2[..., 1]).clamp(-1, 1)
    cos_td = torch.cos((torch.asin(sin_to) - theta_i) * 0.5)
    w = thair._lerped_row(aux.weights, k, lobe, 63 * cos_td)
    cdf = torch.cumsum(w, -1) / w.sum(-1, keepdim=True).clamp(min=1e-20)
    bin_edge = (cdf - phi_u[..., None]).abs().amin(-1) < EDGE
    # a sliver bin: the position inside it, (u - lo) / (hi - lo), moves by
    # more than 1e-3 per float32 ulp of the CDF near 1
    x = (cdf < phi_u[..., None]).sum(-1).clamp(max=63)
    width = torch.gather(cdf, -1, x[..., None])[..., 0] - torch.where(
        x > 0, torch.gather(cdf, -1, (x - 1).clamp(min=0)[..., None])[..., 0],
        0.0)
    sliver = width < SLIVER
    return branch | lobe_edge | bin_edge | sliver


@pytest.mark.parametrize("kind", list(KINDS.values()), ids=list(KINDS))
def test_eval_pdf_matches_jax(kind):
    """f within 1e-4 relative (+1e-6 absolute) and pdf within 1e-4
    relative, every lane, texel and quad lookups: the longitudinal term's
    I0 is torch.special.i0 against jnp.i0 (two float32 series) and its
    exp amplifies their ulps by the lobe's 1 / v (measured: 2e-5)."""
    gj, gt, auxes = _setup(kind)
    wi, wo = _dirs(1), _dirs(2)
    for aj, at in auxes:
        fj, pj = jmat.eval_pdf((kind,), gj, jnp.asarray(wi), jnp.asarray(wo),
                               aj)
        ft, pt = tmat.eval_pdf((kind,), gt, _t(wi), _t(wo), at)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4,
                                   atol=1e-6)
        if kind != jmat.MARSCHNERDIELECTRIC:
            assert (np.abs(ft.numpy()).max(-1) > 0).mean() > 0.3


@pytest.mark.parametrize("kind", list(KINDS.values()), ids=list(KINDS))
def test_sample_matches_jax(kind):
    """wo within 2e-5, weight and pdf within 5e-4 relative, the delta
    flags exactly, on every lane but those whose lobe, bin or branch
    choice sits within 1e-6 of a CDF edge or whose azimuth bin is a
    sliver (counted: at most 0.5% of the lanes)."""
    gj, gt, auxes = _setup(kind)
    wi = _dirs(3)
    rs = np.random.default_rng(4)
    u_lobe = rs.random(N).astype(np.float32)
    u2 = rs.random((N, 2)).astype(np.float32)
    u2b = rs.random((N, 2)).astype(np.float32)
    for aj, at in auxes:
        ref = jmat.sample((kind,), gj, jnp.asarray(wi), jnp.asarray(u_lobe),
                          jnp.asarray(u2), jnp.asarray(u2b), aj)
        got = tmat.sample((kind,), gt, _t(wi), _t(u_lobe), _t(u2), _t(u2b),
                          at)
        wo_j, w_j, p_j, d_j, _ = (np.asarray(x) for x in ref)
        wo_t, w_t, p_t, d_t, _ = (x.numpy() for x in got)
        edge = _edge_lanes(kind, gt, wi, u_lobe, u2, u2b, at).numpy()
        keep = ~edge
        assert edge.sum() <= 0.005 * N, edge.sum()
        np.testing.assert_array_equal(d_t[keep], d_j[keep])
        np.testing.assert_allclose(wo_t[keep], wo_j[keep], atol=2e-5)
        np.testing.assert_allclose(p_t[keep], p_j[keep], rtol=5e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(w_t[keep], w_j[keep], rtol=5e-4,
                                   atol=1e-6)
        assert (p_t > 0).mean() > 0.3


def test_sampled_pole_keeps_a_finite_gradient():
    """A lane whose longitudinal sample u is 0 (a Sobol' point at the
    origin) samples the pole: exp(-2 / v) underflows for the R lobe,
    cos_t = -inf and sin(theta_o) clamps to +-1. Both packages sample the
    same direction and weight there. hairpt's beta_r gradient of the
    sampled weights is NaN (0 * inf in the vMF inversion, the asin and the
    atan2 of the pole direction); the port's is finite: hairpt's over the
    other lanes plus, on the pole lanes, the gradient of eval at the
    sampled direction held fixed. Faithful Marschner, whose sampled
    weight carries the gradient through the direction; 1e-3 relative."""
    kind = jmat.MARSCHNER
    gj, gt, auxes = _setup(kind)
    aj, at = auxes[1]
    n, n_pole = 512, 8
    wi = _dirs(5)[:n]
    rs = np.random.default_rng(6)
    u_lobe = rs.random(n).astype(np.float32)
    u2 = rs.random((n, 2)).astype(np.float32)
    u2[:n_pole] = 0.0
    u2b = rs.random((n, 2)).astype(np.float32)
    gj = jax.tree_util.tree_map(lambda x: x[:n], gj)
    gt = tmat.GatheredMat(*[x[:n] for x in gt])

    def fj(b, lanes):
        m = len(lanes)
        g = jax.tree_util.tree_map(lambda x: x[lanes], gj)
        w = jmat.sample((kind,), g._replace(beta_r=b * jnp.ones(m)),
                        jnp.asarray(wi[lanes]), jnp.asarray(u_lobe[lanes]),
                        jnp.asarray(u2[lanes]), jnp.asarray(u2b[lanes]), aj)
        return jnp.sum(w[1]), w
    (_, ref), g_all = jax.jit(jax.value_and_grad(
        lambda b: fj(b, np.arange(n)), has_aux=True))(jnp.float32(0.1))
    g_rest = jax.jit(jax.grad(lambda b: fj(b, np.arange(n_pole, n))[0]))(
        jnp.float32(0.1))
    b = torch.tensor(0.1, requires_grad=True)
    wo_t, w_t, _, d_t, _ = tmat.sample(
        (kind,), gt._replace(beta_r=b.expand(n)), _t(wi), _t(u_lobe),
        _t(u2), _t(u2b), at)
    np.testing.assert_allclose(wo_t.detach().numpy()[:n_pole],
                               np.asarray(ref[0])[:n_pole], atol=2e-5)
    np.testing.assert_allclose(w_t.detach().numpy()[:n_pole],
                               np.asarray(ref[1])[:n_pole], rtol=5e-4,
                               atol=1e-6)
    assert bool(d_t[:n_pole].all())
    assert np.isnan(float(g_all))
    w_t.sum().backward()
    bp = torch.tensor(0.1, requires_grad=True)
    gp = tmat.GatheredMat(*[x[:n_pole] for x in gt])
    f_pole, _ = tmat.eval_pdf((kind,), gp._replace(beta_r=bp.expand(n_pole)),
                              _t(wi[:n_pole]), wo_t[:n_pole].detach(), at)
    f_pole.sum().backward()
    assert torch.isfinite(b.grad)
    assert float(b.grad) == pytest.approx(float(g_rest) + float(bp.grad),
                                          rel=1e-3)


def _mask_tables(at, lobe):
    """The port's tables with every lobe but `lobe` zeroed, the sampling
    tables rebuilt (tools/render_ablations.py::mask_tables)."""
    if lobe is None:
        return at
    mask = torch.zeros((1, 3, 1, 1, 1))
    mask[0, lobe] = 1.0
    return thair.hair_tables(at.values * mask)


@pytest.mark.parametrize("kind", [jmat.MARSCHNER, jmat.MARSCHNER_PURE],
                         ids=["marschner", "marschner_pure"])
def test_lobe_masking_linearity(kind):
    """The Marschner eval is linear in the azimuthal tables: the R-only,
    TT-only and TRT-only evals sum to the full one (no diffuse term), so
    table masking is per-lobe ablation (tests/test_ablation.py's check,
    on the port alone; 1e-4 relative, 1e-6 absolute)."""
    n = 512
    at = thair.hair_tables(thair.precompute_azimuthal((0.5, 0.5, 0.5), 0.1,
                                                      1.55)[None])
    table = tmat.pack_materials([tmat.default_material_row(
        kind=kind, sigma_a=(0.5, 0.5, 0.5), beta_r=0.1, eta=1.55, aux_id=0,
        diffuse=(0.0, 0.0, 0.0))], device="cpu")
    gt = tmat.gather(table, None, torch.zeros(n, dtype=torch.int32))
    wi = torch.as_tensor(np.broadcast_to(np.array(
        [np.sin(np.radians(40.0)) * np.cos(np.radians(30.0)),
         np.sin(np.radians(40.0)) * np.sin(np.radians(30.0)),
         np.cos(np.radians(40.0))], np.float32), (n, 3)).copy())
    d = np.random.RandomState(3).randn(n, 3)
    wo = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                         dtype=torch.float32)
    f_full, _ = tmat.eval_pdf([kind], gt, wi, wo, _mask_tables(at, None))
    parts = sum(tmat.eval_pdf([kind], gt, wi, wo, _mask_tables(at, lb))[0]
                for lb in (0, 1, 2))
    assert float(f_full.abs().max()) > 0
    np.testing.assert_allclose(parts.numpy(), f_full.numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("kind,over", [
    (jmat.MARSCHNER_PURE, dict(aux_id=0, sigma_a=(0.5, 0.5, 0.5),
                               beta_r=0.1, eta=1.55)),
    (jmat.KAJIYAKAY, dict())], ids=["marschner_pure", "kajiyakay"])
def test_sample_pdf_consistency(kind, over):
    """sample()'s pdf equals pdf() of the sampled direction (1e-3
    relative, 1e-5 absolute) and weight * pdf equals eval (1e-3), on the
    port alone (tests/test_bsdf.py::sample_pdf_consistency), 2^15 lanes
    at wi 40 degrees from the normal."""
    n = 1 << 15
    aux = thair.hair_tables(thair.precompute_azimuthal(
        (0.5, 0.5, 0.5), 0.1, 1.55)[None])
    table = tmat.pack_materials([tmat.default_material_row(kind=kind,
                                                           **over)],
                                device="cpu")
    gm = tmat.gather(table, None, torch.zeros(n, dtype=torch.int32))
    t, p = np.radians(40.0), np.radians(30.0)
    wi = torch.as_tensor(np.array([np.sin(t) * np.cos(p),
                                   np.sin(t) * np.sin(p), np.cos(t)],
                                  np.float32)).expand(n, 3)
    pix = torch.arange(n)
    ul = trng.uniform_1d(pix, 0, 1)
    u2 = trng.uniform_2d(pix, 0, 2)
    u2b = trng.uniform_2d(pix, 0, 4)
    wo, w, pdf, is_delta, _ = tmat.sample([kind], gm, wi, ul, u2, u2b, aux)
    f, pdf2 = tmat.eval_pdf([kind], gm, wi, wo, aux)
    ok = ((pdf > 1e-6) & ~is_delta).numpy()
    assert ok.mean() > 0.5
    np.testing.assert_allclose(pdf.numpy()[ok], pdf2.numpy()[ok], rtol=1e-3,
                               atol=1e-5)
    err = np.abs(w.numpy()[ok] * pdf.numpy()[ok, None] - f.numpy()[ok])
    assert err.max() < 1e-3, err.max()
    # the same uniforms as the JAX package's consistency check
    np.testing.assert_array_equal(
        u2.numpy(), np.asarray(jrng.uniform_2d(jnp.arange(n,
                                                          dtype=jnp.uint32),
                                               0, 2)))


# ---------------------------------------------------------------------------
# the procedural hair scenes' fibers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("gen_straight_hair", dict(n_fibers=300)),
    ("gen_curly_hair", dict(n_fibers=200)),
    ("gen_hair_curl", dict(n_fibers_per_clump=60))],
    ids=["straight", "curly", "curl"])
def test_hair_generators_equal_jax(name, kw):
    """The fibers (vertices, fiber starts, radius) equal hairpt's bit for
    bit, and so do their miter segments."""
    a, b = getattr(jgen, name)(**kw), getattr(tgen, name)(**kw)
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    assert len(a) == len(b) == (4 if name == "gen_hair_curl" else 1)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fb.vertices, fa.vertices)
        np.testing.assert_array_equal(fb.vertex_starts_fiber,
                                      fa.vertex_starts_fiber)
        assert fb.radius == fa.radius
        sa, sb = jgen.segments(fa), tgen.segments(fb)
        for k in ("p0", "p1", "n0", "n1", "radius"):
            np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
