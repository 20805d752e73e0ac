"""hairpt_torch rough plastic (the furball's material) against hairpt:
eval, pdf and sampling per lane, with the GGX and Beckmann distributions
and the material table built the same way."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hairpt.models.bsdf import registry as jmat
from hairpt.models.bsdf import plastic as jplastic  # noqa: F401 (registers)
from hairpt.models.bsdf.fresnel import fresnel_dielectric as jfresnel
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.models.bsdf.fresnel import fresnel_dielectric as tfresnel
from hairpt_torch.scene.scene import SceneBuilder as TSceneBuilder
from torch_threads import one_thread  # noqa: F401

N = 4096


def _dirs(seed, upper_frac=0.9):
    rs = np.random.default_rng(seed)
    w = rs.normal(size=(N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    flip = rs.random(N) < upper_frac
    w[:, 2] = np.where(flip, np.abs(w[:, 2]), -np.abs(w[:, 2]))
    return w


@pytest.fixture(scope="module")
def tables():
    """Two rough-plastic rows (GGX alpha 0.2 eta 1.55 as the furball;
    Beckmann alpha 0.4 eta 1.3), one table per package, lanes spread over
    both rows."""
    rows = [dict(kind=jmat.ROUGHPLASTIC, alpha=0.2, eta=1.55, dist=0,
                 diffuse=(0.143016, 0.0156076, 1.80928e-05)),
            dict(kind=jmat.ROUGHPLASTIC, alpha=0.4, eta=1.3, dist=1,
                 diffuse=(0.5, 0.4, 0.3))]
    bj, bt = JSceneBuilder(), TSceneBuilder(device="cpu")
    for r in rows:
        bj.add_material(**dict(r))
        bt.add_material(**dict(r))
    tj = jmat.pack_materials(bj.materials)
    tt = tmat.pack_materials(bt.materials, device="cpu")
    mid = np.random.default_rng(0).integers(0, 2, N).astype(np.int32)
    gj = jmat.gather(tj, None, jnp.asarray(mid), jnp.zeros((N, 2)))
    gt = tmat.gather(tt, None, torch.as_tensor(mid))
    return tj, tt, gj, gt, mid


def test_material_tables_equal(tables):
    tj, tt, _, _, _ = tables
    for f in tmat.MaterialTable._fields:
        if f == "cloth":  # no irawan row: no weave table
            assert getattr(tt, f) is None and getattr(tj, f) is None
            continue
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)),
                                      err_msg=f)


def test_fresnel_matches_jax():
    c = np.linspace(-1, 1, 1001).astype(np.float32)
    for eta in (1.55, 1.0 / 1.55):
        for a, b in zip(tfresnel(torch.as_tensor(c), torch.tensor(eta)),
                        jfresnel(jnp.asarray(c), eta)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_eval_pdf_matches_jax(tables):
    _, _, gj, gt, _ = tables
    wi, wo = _dirs(1), _dirs(2)
    fj, pj = jmat.eval_pdf((jmat.ROUGHPLASTIC,), gj, jnp.asarray(wi),
                           jnp.asarray(wo))
    ft, pt = tmat.eval_pdf((tmat.ROUGHPLASTIC,), gt, torch.as_tensor(wi),
                           torch.as_tensor(wo))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4,
                               atol=1e-6)
    assert (pt.numpy() > 0).mean() > 0.5


def test_sample_matches_jax(tables):
    _, _, gj, gt, _ = tables
    wi = _dirs(3)
    rs = np.random.default_rng(4)
    u_lobe = rs.random(N).astype(np.float32)
    u2 = rs.random((N, 2)).astype(np.float32)
    u2b = rs.random((N, 2)).astype(np.float32)
    ref = jmat.sample((jmat.ROUGHPLASTIC,), gj, jnp.asarray(wi),
                      jnp.asarray(u_lobe), jnp.asarray(u2), jnp.asarray(u2b))
    got = tmat.sample((tmat.ROUGHPLASTIC,), gt, torch.as_tensor(wi),
                      torch.as_tensor(u_lobe), torch.as_tensor(u2),
                      torch.as_tensor(u2b))
    wo_j, w_j, p_j, d_j, e_j = (np.asarray(x) for x in ref)
    wo_t, w_t, p_t, d_t, e_t = (x.numpy() for x in got)
    np.testing.assert_allclose(wo_t, wo_j, atol=2e-5)
    ok = p_j > 0
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(p_t > 0, ok)
    np.testing.assert_allclose(p_t[ok], p_j[ok], rtol=5e-4)
    np.testing.assert_allclose(w_t[ok], w_j[ok], rtol=5e-4, atol=1e-6)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(e_t, e_j)
