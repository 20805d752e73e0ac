"""The port's leftovers of hairpt/core against hairpt on seeded inputs, on
the CPU: core/distribution (build_cdf, sample_discrete,
sample_continuous, pdf_continuous, InterpolatedCdf1D), core/numerics
(brent_solve, the Catmull-Rom spline's eval, integral and sampling, the
associated Legendre recursion and the real SH basis, projection and
evaluation) and spectrum's luminance, sRGB and power-law gamma and
Planckian-locus blackbody_rgb.

Tolerances: indices exact except where a u lies within 1 ulp of a CDF
step (the two packages' float32 cumulative sums may round a step either
way); floats within 1e-6 absolute, or 1e-5 relative for the SH and
cubic-spline integrals (sums of many terms). The SH basis and expansion
are held within 1e-5 of their largest magnitude: a value near zero
carries the error of its neighbours (cos(m phi) and the recursion's
products of the two libraries' cos and sin)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core import distribution as jdist
from hairpt.core import numerics as jnum
from hairpt.core import spectrum as jspec
from hairpt_torch.core import distribution as tdist
from hairpt_torch.core import numerics as tnum
from hairpt_torch.core import spectrum as tspec
from torch_threads import one_thread  # noqa: F401

RNG = np.random.default_rng(23)
WEIGHTS = RNG.random((6, 17)).astype(np.float32) ** 3
WEIGHTS[2] = 0.0            # a row of zeros: the uniform cdf
WEIGHTS[4, 3:9] = 0.0       # empty bins inside a row
U = RNG.random((6, 500)).astype(np.float32)
ATOL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return np.asarray(x)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _close_sh(got, want):
    want = _np(want)
    _close(got, want, atol=1e-5 * np.abs(want).max())


def _near_step(cdf, u):
    """Lanes whose u lies within 1 ulp of one of its row's CDF entries."""
    cdf = np.asarray(cdf, np.float32)
    ulp = np.spacing(np.abs(u).astype(np.float32))[..., None]
    return (np.abs(cdf[:, None, :] - u[..., None]) <= ulp).any(-1)


def test_build_cdf():
    c_t, tot_t = tdist.build_cdf(_t(WEIGHTS))
    c_j, tot_j = jdist.build_cdf(jnp.asarray(WEIGHTS))
    _close(c_t, c_j)
    _close(tot_t, tot_j)
    assert np.allclose(_np(c_t)[:, -1], 1.0)


def test_sample_discrete_and_continuous():
    cdf = _np(jdist.build_cdf(jnp.asarray(WEIGHTS))[0])
    for fn in ("sample_discrete", "sample_continuous"):
        got = getattr(tdist, fn)(_t(cdf)[:, None, :].expand(6, 500, 17),
                                 _t(U))
        want = getattr(jdist, fn)(jnp.asarray(cdf)[:, None, :]
                                  .repeat(500, 1), jnp.asarray(U))
        if fn == "sample_discrete":
            idx_t, idx_j = _np(got[0]), _np(want[0])
            ok = (idx_t == idx_j) | _near_step(cdf, U)
            assert ok.all()
            same = idx_t == idx_j
            for g, w in zip(got[1:], want[1:]):
                _close(_np(g)[same], _np(w)[same])
        else:
            for g, w in zip(got, want):
                _close(g, w)


def test_pdf_continuous():
    cdf = _np(jdist.build_cdf(jnp.asarray(WEIGHTS))[0])
    x = RNG.random((6, 300)).astype(np.float32)
    got = tdist.pdf_continuous(_t(cdf)[:, None, :].expand(6, 300, 17),
                               _t(x))
    want = jdist.pdf_continuous(jnp.asarray(cdf)[:, None, :].repeat(300, 1),
                                jnp.asarray(x))
    _close(got, want)


def test_interpolated_cdf_1d():
    w = RNG.random((9, 13)).astype(np.float32)
    v = (RNG.random(400) * 8.5 - 0.2).astype(np.float32)
    u = RNG.random(400).astype(np.float32)
    d_t = tdist.InterpolatedCdf1D(w, device="cpu")
    d_j = jdist.InterpolatedCdf1D(w)
    _close(d_t.sum(_t(v)), d_j.sum(jnp.asarray(v)), rtol=1e-6)
    idx_t, ur_t, p_t = d_t.sample(_t(v), _t(u))
    idx_j, ur_j, p_j = d_j.sample(jnp.asarray(v), jnp.asarray(u))
    same = _np(idx_t) == _np(idx_j)
    assert same.mean() > 0.99
    _close(_np(ur_t)[same], _np(ur_j)[same], atol=1e-5)
    _close(_np(p_t)[same], _np(p_j)[same])
    _close(d_t.pdf_bin(_t(v), idx_t), d_j.pdf_bin(jnp.asarray(v),
                                                  jnp.asarray(_np(idx_t))))


def test_brent_solve():
    c = (RNG.random(256) * 7 + 0.1).astype(np.float32)
    got = tnum.brent_solve(lambda x: x ** 3 - _t(c), 0.0, 2.5)
    want = jnum.brent_solve(lambda x: x ** 3 - jnp.asarray(c), 0.0, 2.5)
    _close(got, want)
    _close(got, np.cbrt(c), atol=1e-5)


VALUES = (np.sin(np.linspace(0, 5, 23)) + 1.3).astype(np.float32)


def test_cubic_eval_and_integral():
    x = (RNG.random(600) * 2.6 - 0.3).astype(np.float32)
    _close(tnum.eval_cubic_1d(_t(x), VALUES, 0.0, 2.0),
           jnum.eval_cubic_1d(jnp.asarray(x), VALUES, 0.0, 2.0))
    np.testing.assert_allclose(tnum.integrate_cubic_1d(VALUES, 0.0, 2.0),
                               jnum.integrate_cubic_1d(VALUES, 0.0, 2.0),
                               rtol=1e-5)


def test_cubic_sample():
    u = RNG.random(600).astype(np.float32)
    x_t, pdf_t = tnum.sample_cubic_1d(_t(u), VALUES, 0.0, 2.0)
    x_j, pdf_j = jnum.sample_cubic_1d(jnp.asarray(u), VALUES, 0.0, 2.0)
    _close(x_t, x_j)
    _close(pdf_t, pdf_j, atol=0.0, rtol=1e-5)


@pytest.mark.parametrize("l_max", [0, 1, 4, 7])
def test_sh_basis_and_legendre(l_max):
    """The recursion on the same x over all of [-1, 1]; the basis away
    from the poles, where sqrt(1 - cos^2 theta) turns the two libraries'
    1-ulp differences in cos into 1e-4."""
    x = np.concatenate([[-1.0, 1.0, 0.0], RNG.random(300) * 2 - 1]) \
        .astype(np.float32)
    P_t = tnum.assoc_legendre(l_max, _t(x))
    P_j = jnum._assoc_legendre(l_max, jnp.asarray(x))
    assert P_t.keys() == P_j.keys()
    for k in P_t:
        _close(P_t[k], P_j[k], atol=1e-6, rtol=1e-5)
    th = (RNG.random(300) * (np.pi - 0.1) + 0.05).astype(np.float32)
    ph = (RNG.random(300) * 2 * np.pi).astype(np.float32)
    _close_sh(tnum.sh_eval_basis(l_max, _t(th), _t(ph)),
              jnum.sh_eval_basis(l_max, jnp.asarray(th), jnp.asarray(ph)))


def test_sh_project_and_eval():
    def f_t(t, p):
        return torch.cos(t) ** 2 + 0.3 * torch.sin(t) * torch.cos(p) + 0.1

    def f_j(t, p):
        return jnp.cos(t) ** 2 + 0.3 * jnp.sin(t) * jnp.cos(p) + 0.1
    c_t = tnum.sh_project(f_t, 4, device="cpu")
    c_j = jnum.sh_project(f_j, 4)
    _close_sh(c_t, c_j)
    th = (RNG.random(200) * np.pi).astype(np.float32)
    ph = (RNG.random(200) * 2 * np.pi).astype(np.float32)
    _close_sh(tnum.sh_eval(c_t, 4, _t(th), _t(ph)),
              jnum.sh_eval(c_j, 4, jnp.asarray(th), jnp.asarray(ph)))


def test_spectrum_helpers():
    x = (RNG.random((400, 3)) * 1.4 - 0.2).astype(np.float32)
    _close(tspec.luminance(_t(x)), jspec.luminance(jnp.asarray(x)))
    for fn in ("srgb_gamma", "inv_srgb_gamma"):
        _close(getattr(tspec, fn)(_t(x)), getattr(jspec, fn)(jnp.asarray(x)))
    _close(tspec.gamma_encode(_t(x), 2.2),
           jspec.gamma_encode(jnp.asarray(x), 2.2))
    temps = np.concatenate([[500.0, 1000.0, 1900.0, 6500.0, 6600.0, 40000.0,
                             60000.0], RNG.random(200) * 20000 + 800]) \
        .astype(np.float32)
    _close(tspec.blackbody_rgb(_t(temps)),
           jspec.blackbody_rgb(jnp.asarray(temps)), atol=1e-6, rtol=1e-6)
