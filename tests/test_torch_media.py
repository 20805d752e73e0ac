"""The media model of hairpt_torch against hairpt: each of the seven phase
kinds' eval, pdf and sample, the homogeneous transmittance and distance
samplers, the medium table, the dense and block-sparse grid lookups,
the .vol reader, and the Woodcock plain loops (delta and ratio
tracking) on the same pixel, sample and dimension.

Bounds, with their reasons:
- phase values, pdfs and directions: 2e-5 relative or 1e-6 absolute on
  every value (the pdf at a sampled direction of an HG lobe of g up to
  0.9 on 99%, and 1e-2 relative on 99.9%) where the arithmetic is
  rational, square roots and one transcendental; the two packages'
  sin, cos, log, pow, arcsin and erfinv round the last bit differently,
  so the fiber phases (a cosine to the 4th or 20th power, a latitude CDF
  whose bin a rounding can flip, a rejection test per candidate) are
  held to that bound on 99% of the values and to 1e-2 relative on
  99.9%;
- grid lookups: 1e-6 relative (float32 trilinear blends of the same
  operations in the same order; exact on the CPU in practice);
- Woodcock: the medium-event flags equal on >= 99.9% of the lanes and
  t within 1e-4 relative where both flag an event (a step is -log(1 - u)
  / majorant, and the two logs round differently, which can move a
  density test across its threshold); the ratio-tracking transmittance
  within 1e-4 absolute on 99.9% of the lanes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hairpt.models import media as jmed
from hairpt_torch.models import media as tmed
from torch_threads import one_thread  # noqa: F401

N = 2048
RTOL, ATOL = 2e-5, 1e-6



def _dirs(rs, n=N):
    w = rs.normal(size=(n, 3)).astype(np.float32)
    return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(a, b, share=1.0, rtol=RTOL, atol=ATOL, loose_share=None):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    ok = np.abs(a - b) <= atol + rtol * np.abs(b)
    assert ok.mean() >= share, (ok.mean(), np.abs(a - b)[~ok][:5])
    if loose_share is not None:
        ok2 = np.abs(a - b) <= 1e-4 + 1e-2 * np.abs(b)
        assert ok2.mean() >= loose_share, ok2.mean()


ORI = (0.3, -0.2, 0.9)
KINDS = {
    "isotropic": dict(phase_kind=jmed.ISOTROPIC),
    "hg": dict(phase_kind=jmed.HG, g=0.6),
    "rayleigh": dict(phase_kind=jmed.RAYLEIGH),
    "kkay": dict(phase_kind=jmed.KKAY, orientation=ORI, exponent=20.0),
    "microflake": dict(phase_kind=jmed.MICROFLAKE, orientation=ORI,
                       stddev=0.3),
    "mixture": dict(phase_kind=jmed.MIXTURE_PHASE,
                    mix=((jmed.HG, 0.5, 0.7), (jmed.ISOTROPIC, 0.3, 0.0),
                         (jmed.RAYLEIGH, 0.1, 0.0))),
    "kkay_is": dict(phase_kind=jmed.KKAY_IS, orientation=ORI,
                    exponent=8.0),
}
FIBER = ("kkay", "microflake", "kkay_is")


def _media(kw):
    jm = jmed.make_medium((0.3, 0.4, 0.5), (0.05, 0.02, 0.01), **kw)
    tm = tmed.make_medium((0.3, 0.4, 0.5), (0.05, 0.02, 0.01),
                          device="cpu", **kw)
    return jm, tm


@pytest.mark.parametrize("name", list(KINDS))
def test_phase_functions_match_jax(name):
    """eval, pdf and sample of each phase kind on seeded directions (the
    kkay kinds with an orientation, a fiber phase's lanes covering the
    specular cone)."""
    jm, tm = _media(KINDS[name])
    rs = np.random.RandomState(7)
    wi = _dirs(rs)
    wo = _dirs(rs)
    u2 = rs.random((N, 2)).astype(np.float32)
    pk = jm.phase_kind
    jargs = (jm.phase_p, jm.orientation, jm.mix)
    targs = (tm.phase_p, tm.orientation, tm.mix)
    share, loose = (0.99, 0.999) if name in FIBER else (1.0, None)
    _close(tmed.phase_eval(pk, tm.g, _t(wi), _t(wo), *targs),
           jmed.phase_eval(pk, jm.g, jnp.asarray(wi), jnp.asarray(wo),
                           *jargs), share, loose_share=loose)
    _close(tmed.phase_pdf(pk, tm.g, _t(wi), _t(wo), *targs),
           jmed.phase_pdf(pk, jm.g, jnp.asarray(wi), jnp.asarray(wo),
                          *jargs), share, loose_share=loose)
    two, tpdf = tmed.phase_sample(pk, tm.g, _t(wi), _t(u2), *targs)
    jwo, jpdf = jmed.phase_sample(pk, jm.g, jnp.asarray(wi),
                                  jnp.asarray(u2), *jargs)
    rtol = 1e-4 if name == "rayleigh" else RTOL   # cbrt against pow
    _close(two, jwo, share, rtol=rtol, atol=1e-5, loose_share=loose)
    _close(tpdf, jpdf, share, rtol=rtol, loose_share=loose)
    assert bool(torch.isfinite(two).all()) and bool(torch.isfinite(tpdf).all())


def test_hg_with_per_lane_g_matches_jax():
    """The bounded tracer's per-lane g (HG eval and sample)."""
    rs = np.random.RandomState(3)
    wi, wo = _dirs(rs), _dirs(rs)
    g = rs.uniform(-0.9, 0.9, N).astype(np.float32)
    g[:64] = 0.0
    u2 = rs.random((N, 2)).astype(np.float32)
    _close(tmed.phase_eval(tmed.HG, _t(g), _t(wi), _t(wo)),
           jmed.phase_eval(jmed.HG, jnp.asarray(g), jnp.asarray(wi),
                           jnp.asarray(wo)))
    two, tpdf = tmed.phase_sample(tmed.HG, _t(g), _t(wi), _t(u2))
    jwo, jpdf = jmed.phase_sample(jmed.HG, jnp.asarray(g), jnp.asarray(wi),
                                  jnp.asarray(u2))
    _close(two, jwo, atol=1e-5)
    # the pdf at the sampled direction of a lobe up to g = 0.9 amplifies
    # the direction's last-bit differences
    _close(tpdf, jpdf, 0.99, loose_share=0.999)


def test_homogeneous_samplers_and_table_match_jax():
    rs = np.random.RandomState(5)
    jm, tm = _media(dict(phase_kind=jmed.HG, g=0.2))
    u_c = rs.random(N).astype(np.float32)
    u_d = rs.random(N).astype(np.float32)
    t_max = rs.uniform(0.0, 30.0, N).astype(np.float32)
    t_max[:32] = 1e30
    dist = np.concatenate([t_max[:-8], [np.inf] * 8]).astype(np.float32)
    _close(tmed.transmittance(tm, _t(dist)), jmed.transmittance(
        jm, jnp.asarray(dist)))
    jd, jis, jw = jmed.sample_distance(jm, jnp.asarray(u_c),
                                       jnp.asarray(u_d), jnp.asarray(t_max))
    td, tis, tw = tmed.sample_distance(tm, _t(u_c), _t(u_d), _t(t_max))
    assert np.array_equal(tis.numpy(), np.asarray(jis))
    _close(td, jd)
    _close(tw, jw)
    entries = [dict(sigma_s=(0.5, 0.6, 0.7), sigma_a=(0.1, 0.0, 0.2),
                    g=0.4), dict(sigma_s=(2.0,) * 3, sigma_a=(0.0,) * 3)]
    jt = jmed.make_medium_table(entries)
    tt = tmed.make_medium_table(entries, device="cpu")
    for f in jmed.MediumTable._fields:
        assert np.array_equal(getattr(tt, f).numpy(), getattr(jt, f)), f
    mid = rs.randint(0, 3, N)
    sig = np.asarray(jt.sigma_t)[mid]
    alb = np.asarray(jt.albedo)[mid]
    jd, jis, jw = jmed.sample_distance_lane(
        jnp.asarray(sig), jnp.asarray(alb), jnp.asarray(u_c),
        jnp.asarray(u_d), jnp.asarray(t_max))
    td, tis, tw = tmed.sample_distance_lane(_t(sig), _t(alb), _t(u_c),
                                            _t(u_d), _t(t_max))
    assert np.array_equal(tis.numpy(), np.asarray(jis))
    _close(td, jd)
    _close(tw, jw)


def _density(res=20, seed=0):
    rs = np.random.RandomState(seed)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, res)] * 3, indexing="ij")
    blob = np.exp(-3.0 * (x * x + y * y + z * z)) \
        * (0.6 + 0.4 * rs.random((res, res, res)))
    blob[:, :, : res // 3] = 0.0       # empty blocks for the sparse grid
    return blob.astype(np.float32)


WMIN, WMAX = (-1.0, -0.5, -2.0), (1.5, 1.0, 0.5)


def _volumes():
    data = _density()
    return {"dense": (jmed.make_grid_volume(data, WMIN, WMAX),
                      tmed.make_grid_volume(data, WMIN, WMAX, device="cpu")),
            "sparse": (jmed.make_hgrid_from_dense(data, WMIN, WMAX, block=8),
                       tmed.make_hgrid_from_dense(data, WMIN, WMAX, block=8,
                                                  device="cpu"))}


def test_grid_lookups_match_jax():
    """grid_density and hgrid_density at seeded points in and around the
    box (the sparse grid's empty blocks and padding included)."""
    rs = np.random.RandomState(11)
    p = rs.uniform(np.asarray(WMIN) - 0.3, np.asarray(WMAX) + 0.3,
                   (N, 3)).astype(np.float32)
    for name, (jv, tv) in _volumes().items():
        jd = np.asarray(jmed.volume_density(jv, jnp.asarray(p)))
        td = tmed.volume_density(tv, _t(p)).numpy()
        _close(td, jd, rtol=1e-6, atol=0.0)
        assert (jd > 0).mean() > 0.2 and (jd == 0).mean() > 0.1, name


def test_load_vol_reads_a_written_file(tmp_path):
    data = _density(res=12, seed=2)[:, :10, :7].copy()
    f = str(tmp_path / "smoke.vol")
    tmed.write_vol(f, data, WMIN, WMAX)
    jv = jmed.load_vol(f)
    tv = tmed.load_vol(f, device="cpu")
    for fld in ("data", "world_min", "inv_extent"):
        assert np.array_equal(getattr(tv, fld).numpy(),
                              np.asarray(getattr(jv, fld))), fld
    assert tv.data.shape == (12, 10, 7)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_woodcock_plain_loops_match_jax(kind):
    """Delta and ratio tracking through the grid on seeded rays (some
    missing the box, some starting inside it) with the same pixel,
    sample and dimension on both sides."""
    jv, tv = _volumes()[kind]
    jm = jmed.make_hetero_medium(jv, (4.0, 5.0, 6.0), (0.5, 0.5, 0.5),
                                 g=0.3)
    tm = tmed.make_hetero_medium(tv, (4.0, 5.0, 6.0), (0.5, 0.5, 0.5),
                                 g=0.3)
    rs = np.random.RandomState(17)
    o = rs.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    o[: N // 4] = rs.uniform(-0.5, 0.3, (N // 4, 3))
    d = _dirs(rs)
    t_max = rs.uniform(0.5, 8.0, N).astype(np.float32)
    t_max[:64] = 1e30
    pix = np.arange(N, dtype=np.uint32) * 7 + 3
    smp = np.full(N, 5 + 65536, np.uint32)
    jt, jis = jmed.woodcock_sample(jm, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(t_max), jnp.asarray(pix),
                                   jnp.asarray(smp), 29)
    tt, tis = tmed.woodcock_sample(tm, _t(o), _t(d), _t(t_max),
                                   _t(pix.astype(np.int64)),
                                   _t(smp.astype(np.int64)), 29)
    jis = np.asarray(jis)
    agree = tis.numpy() == jis
    assert agree.mean() >= 0.999, agree.mean()
    assert 0.1 < jis.mean() < 0.9
    both = agree & jis
    _close(tt.numpy()[both], np.asarray(jt)[both], rtol=1e-4, atol=1e-6)
    jtr = jmed.woodcock_transmittance(jm, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(t_max), jnp.asarray(pix),
                                      jnp.asarray(smp), 31)
    ttr = tmed.woodcock_transmittance(tm, _t(o), _t(d), _t(t_max),
                                      _t(pix.astype(np.int64)),
                                      _t(smp.astype(np.int64)), 31)
    _close(ttr, jtr, share=0.999, rtol=0.0, atol=1e-4)
    assert 0.05 < float((ttr[:, 0] < 1).float().mean()) < 0.95
