"""The specular manifold walk of hairpt_torch (integrators/manifold.py)
against hairpt's on the CPU, on tests/test_manifold.py's mirror sphere
(reflection) and refraction plane, both built by hairpt's SceneBuilder
with the packed walk and carried across (torch_mlt_scenes).

Bounds: _constraint within 1e-6 (XLA's rsqrt and fused multiply-adds
against torch's); walk's x and n within 1e-4 of the chord |a - x| and
ok equal on >= 99% of the lanes; generalized_g within 1e-3 relative on
the lanes both walks call ok, both from hairpt's x and n (G's forward
differences at 1e-4 of the chord amplify a last-bit difference of x
about 1e3-fold: from each package's own x the two agree within
1.1e-3). The port alone keeps test_manifold.py's oracles: the reflection
law, the Fermat point of the analytic sphere within 0.03, Snell's law on
the plane."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core.math import Ray as JRay
from hairpt.integrators import manifold as jmf
from hairpt.integrators.aux_integrators import _swept_params as j_params
from hairpt.integrators.common import scene_intersect as j_isect
from hairpt_torch.core.math import Ray
from hairpt_torch.integrators import manifold as tmf
from hairpt_torch.integrators.common import scene_intersect
from hairpt_torch.integrators.path import _swept_params
import torch_light_scenes as tls
import torch_mlt_scenes as tms
from test_manifold import _sphere_reflection_oracle
from torch_threads import one_thread  # noqa: F401

N = 256


@pytest.fixture(scope="module")
def sphere():
    return tls.build(tms.sphere_mesh)


@pytest.fixture(scope="module")
def plane():
    return tls.build(tms.plane_mesh)


def _hits(js, cs, a, d):
    n = a.shape[0]
    hj = j_isect(js.arrays, JRay(o=jnp.asarray(a), d=jnp.asarray(d),
                                 mint=jnp.zeros(n),
                                 maxt=jnp.full(n, np.inf)),
                 js.config.traversal, js.config.block,
                 j_params(js.config))
    ht = scene_intersect(cs.arrays, Ray(o=torch.as_tensor(a),
                                        d=torch.as_tensor(d),
                                        mint=torch.zeros(n),
                                        maxt=torch.full((n,), np.inf)),
                         **_swept_params(cs.config))
    return hj, ht


def _setup(kind):
    rs = np.random.RandomState(0 if kind == "sphere" else 1)
    if kind == "sphere":
        a = np.array([0.0, 0.0, -3.0], np.float32)
        b = np.array([2.0, 1.0, -2.5], np.float32)
        tgt = np.array([0.15, 0.1, 1.0]) + rs.randn(N, 3) * 0.05
        eta = np.ones(N, np.float32)
    else:
        a = np.array([0.0, 0.0, 1.0], np.float32)
        b = np.array([0.8, 0.0, -1.0], np.float32)
        tgt = np.array([0.3, 0.0, -1.0]) + rs.randn(N, 3) * 0.1
        eta = np.full(N, 1.5, np.float32)
    d0 = (tgt / np.linalg.norm(tgt, axis=-1, keepdims=True)).astype(
        np.float32)
    return np.tile(a, (N, 1)), np.tile(b, (N, 1)), d0, eta


def test_constraint_matches_jax():
    rs = np.random.RandomState(0)
    a, b, x = (rs.randn(512, 3).astype(np.float32) for _ in range(3))
    n = rs.randn(512, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    eta = np.where(rs.rand(512) < 0.5, 1.0, 1.5).astype(np.float32)
    cj, (sj, tj) = jmf._constraint(*map(jnp.asarray, (a, b, x, n, eta)))
    ct, (st, tt) = tmf._constraint(*map(torch.as_tensor, (a, b, x, n, eta)))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["sphere", "plane"])
def test_walk_and_g_match_jax(sphere, plane, kind):
    js, cs = {"sphere": sphere, "plane": plane}[kind]
    a, b, d0, eta = _setup(kind)
    hj, ht = _hits(js, cs, a, d0)
    assert np.asarray(hj.valid).mean() > 0.9
    np.testing.assert_array_equal(ht.valid.numpy(), np.asarray(hj.valid))
    xj, nj, okj = jmf.walk(js.arrays, js.config, jnp.asarray(a),
                           jnp.asarray(b), hj, eta=jnp.asarray(eta))
    xt, nt, okt = tmf.walk(cs.arrays, cs.config, torch.as_tensor(a),
                           torch.as_tensor(b), ht, eta=torch.as_tensor(eta))
    okj, okt = np.asarray(okj), okt.numpy()
    assert (okj == okt).mean() >= 0.99 and okj.mean() > 0.5
    chord = np.linalg.norm(a - np.asarray(xj), axis=-1)
    both = okj & okt
    for got, want in ((xt, xj), (nt, nj)):
        err = np.linalg.norm(got.numpy() - np.asarray(want), axis=-1)
        assert (err[both] <= 1e-4 * chord[both]).all(), err[both].max()
    gj = np.asarray(jmf.generalized_g(jnp.asarray(a), jnp.asarray(b), xj, nj,
                                      jnp.asarray(eta)))
    gt = tmf.generalized_g(torch.as_tensor(a), torch.as_tensor(b),
                           torch.as_tensor(np.array(xj)),
                           torch.as_tensor(np.array(nj)),
                           torch.as_tensor(eta)).numpy()
    rel = np.abs(gt - gj) / np.abs(gj)
    assert np.isfinite(gt[both]).all() and (gt[both] > 0).all()
    assert (rel[both] < 1e-3).all(), np.sort(rel[both])[-5:]


def test_walk_keeps_the_oracles(sphere, plane):
    """The port alone: the reflection law at the solved sphere points and
    the analytic Fermat point (test_manifold.py's oracle); Snell's law on
    the plane."""
    _, cs = sphere
    a, b, d0, _ = _setup("sphere")
    _, ht = _hits(sphere[0], cs, a[:8], d0[:8])
    x, n, ok = tmf.walk(cs.arrays, cs.config, torch.as_tensor(a[:8]),
                        torch.as_tensor(b[:8]), ht)
    ok = ok.numpy()
    assert ok.any()
    x_np, n_w = x.numpy()[ok], n.numpy()[ok]
    wa = a[0] - x_np
    wa /= np.linalg.norm(wa, axis=-1, keepdims=True)
    wb = b[0] - x_np
    wb /= np.linalg.norm(wb, axis=-1, keepdims=True)
    r = 2 * np.sum(wa * n_w, -1, keepdims=True) * n_w - wa
    assert (np.sum(r * wb, -1) > 0.9999).all()
    oracle = _sphere_reflection_oracle(a[0], b[0])
    assert (np.linalg.norm(x_np - oracle, axis=-1) < 0.03).all()

    _, cp = plane
    a, b, d0, eta = _setup("plane")
    _, ht = _hits(plane[0], cp, a[:4], d0[:4])
    x, _, ok = tmf.walk(cp.arrays, cp.config, torch.as_tensor(a[:4]),
                        torch.as_tensor(b[:4]), ht,
                        eta=torch.as_tensor(eta[:4]))
    x_np = x.numpy()[ok.numpy()]
    assert len(x_np)
    ts = np.linspace(0.0, 0.8, 20001)

    def resid(t):
        x_ = np.array([t, 0.0, 0.0])
        wa_ = (a[0] - x_) / np.linalg.norm(a[0] - x_)
        wb_ = (b[0] - x_) / np.linalg.norm(b[0] - x_)
        return (wa_ + 1.5 * wb_)[0]
    rr = np.array([resid(t) for t in ts])
    t_star = ts[np.where(np.diff(np.sign(rr)) != 0)[0][0]]
    assert (np.abs(x_np[:, 0] - t_star) < 2e-3).all()
    assert (np.abs(x_np[:, 2]) < 1e-4).all()
