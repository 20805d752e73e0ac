"""Subsurface scattering in hairpt_torch against hairpt, on the CPU: the
dipole's coefficients, its diffusion kernel, the hash-grid build and the
gathered radiance on seeded inputs; the irradiance prepass
(attach_dipole) on one triangle scene; and small path renders (24 x 24,
depth 4, 2 spp; hairpt's packed walk, no Pallas kernel) of that scene
with the dipole and with single scattering, the port's scene carried
across by convert_scene. Each JAX render function is compiled once.

Bounds: coefficients and kernel values 1e-5 relative (float32 square
roots, exponentials and divisions; the two packages' exp round the last
bit differently); the gathered radiance 1e-4 relative (a sum over up to
27 x 64 samples, in the same order); the irradiance 1e-4 relative on
99% of the samples and 1e-2 on all (the NEE's direction and its shadow
ray: a last-bit change can flip a grazing shadow test); the renders'
mean within 2e-3 relative and >= 97% of the pixel values within 1e-3
relative + 1e-4 (tests/test_torch_volpath.py's bounds: the single
scattering samples a distance and a light per lane)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core.math import matrix_lookat as jlookat
from hairpt.film.film import Film as JFilm
from hairpt.integrators import path as jpath
from hairpt.integrators import sss as jsss
from hairpt.models import emitters as jem
from hairpt.models import shapes as jshp
from hairpt.models import subsurface as jsub
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.ops import bvh as jbvh
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import convert
from hairpt_torch.integrators import path as tpath
from hairpt_torch.integrators import sss as tsss
from hairpt_torch.models import subsurface as tsub
from hairpt_torch.ops import bvh as tbvh
from torch_threads import one_thread  # noqa: F401

RES, DEPTH, SPP = 24, 4, 2
N_SAMPLES, K_LIGHT = 512, 2
SIG_S, SIG_A, ETA, SCALE = (2.6, 3.2, 3.9), (0.0021, 0.0041, 0.0071), 1.3, 8.0



def _params(m, dev=None):
    if m is jsub:
        return jsub.SSSParams(jnp.asarray(SIG_S, jnp.float32),
                              jnp.asarray(SIG_A, jnp.float32),
                              jnp.float32(ETA), jnp.float32(SCALE), 0.3)
    return tsub.SSSParams(torch.tensor(SIG_S), torch.tensor(SIG_A),
                          torch.tensor(ETA), torch.tensor(SCALE), 0.3)


def _close(a, b, rtol, share=1.0):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ok = np.abs(a - b) <= 1e-7 + rtol * np.abs(b)
    assert ok.mean() >= share, (ok.mean(), np.abs(a - b).max())


def test_dipole_kernel_and_gather_match_jax():
    jp, tp = _params(jsub), _params(tsub)
    for a, b in zip(tsub.dipole_coeffs(tp), jsub.dipole_coeffs(jp)):
        _close(a.numpy(), b, 1e-5)
    rs = np.random.RandomState(2)
    r2 = (rs.random(4096) ** 3 * 4.0).astype(np.float32)
    _close(tsub.rd_kernel(tp, torch.as_tensor(r2)).numpy(),
           jsub.rd_kernel(jp, jnp.asarray(r2)), 1e-5)
    # a pool on a unit sphere, its irradiance and area
    m = 3000
    pos = rs.normal(size=(m, 3)).astype(np.float32)
    pos /= np.linalg.norm(pos, axis=1, keepdims=True)
    irr = rs.random((m, 3)).astype(np.float32)
    area = np.full(m, 4 * np.pi / m, np.float32)
    js = jsub.build_sss(jnp.asarray(pos), jnp.asarray(irr),
                        jnp.asarray(area), jp)
    ts = tsub.build_sss(torch.as_tensor(pos), torch.as_tensor(irr),
                        torch.as_tensor(area), tp)
    np.testing.assert_array_equal(ts.cell.numpy(), np.asarray(js.cell))
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ts.grid_min.numpy(),
                                  np.asarray(js.grid_min))
    q = rs.normal(size=(1024, 3)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cos = rs.uniform(-1, 1, 1024).astype(np.float32)
    lo_t = tsub.sss_radiance(ts, torch.as_tensor(q), torch.as_tensor(cos))
    lo_j = jax.jit(jsub.sss_radiance)(js, jnp.asarray(q), jnp.asarray(cos))
    assert float(lo_t.mean()) > 0
    _close(lo_t.numpy(), lo_j, 1e-4)
    # the chunked gather sums each lane in the same order
    old = tsub.CHUNK
    tsub.CHUNK = 100
    try:
        assert torch.equal(tsub.sss_radiance(ts, torch.as_tensor(q),
                                             torch.as_tensor(cos)), lo_t)
    finally:
        tsub.CHUNK = old


def _jax_scene(single: bool):
    """A dipole sphere (radius 1; its faces wound outward, so the
    prepass's sample normals face out) on a diffuse floor under a
    constant environment."""
    b = JSceneBuilder()
    floor = b.add_material(kind=jmat.DIFFUSE, diffuse=(0.5, 0.5, 0.5),
                           twosided=True)
    skin = b.add_material(kind=jmat.DIPOLE, transmit=SIG_S, sigma_a=SIG_A,
                          eta=ETA, mix_w=SCALE)
    m = np.eye(4)
    m[:3, :3] = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], float) * 5.0
    b.add_mesh(jshp.rectangle(), floor, to_world=m)
    m = np.eye(4)
    m[:3, 3] = (0.0, 1.0, 0.0)
    ball = jshp.sphere(1.0)
    b.add_mesh(ball._replace(faces=np.ascontiguousarray(
        ball.faces[:, ::-1])), skin, to_world=m)
    b.env = jem.make_constant((1.0, 0.95, 0.9))
    cam = JCamera.perspective(jlookat((0.0, 2.0, -4.5), (0.0, 0.9, 0.0),
                                      (0.0, 1.0, 0.0)), 40.0, RES, RES)
    return b.build(cam, JFilm.make(RES, RES, "tent"), spp=SPP,
                   max_depth=DEPTH, traversal="packed", sss_single=single,
                   sss_g=0.3)


@pytest.fixture(scope="module")
def scenes():
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", tbvh._load_native())
    mp.setattr(jbvh, "_NATIVE_TRIED", True)
    out = {}
    for single in (False, True):
        js = jsss.attach_dipole(_jax_scene(single), n_samples=N_SAMPLES,
                                k_light_samples=K_LIGHT)
        cs = convert.convert_scene(js, jax.tree_util.tree_map(
            np.asarray, js.arrays), device="cpu")
        out[single] = (js, cs)
    mp.undo()
    return out


def test_irradiance_prepass_matches_jax(scenes):
    """The port's attach_dipole on the carried-across scene (its sss
    dropped) against hairpt's: the same area-weighted points (numpy's
    default_rng), the irradiance by NEE."""
    js, cs = scenes[False]
    ts = tsss.attach_dipole(cs._replace(arrays=cs.arrays._replace(sss=None)),
                            n_samples=N_SAMPLES, k_light_samples=K_LIGHT)
    a, b = ts.arrays.sss, js.arrays.sss
    np.testing.assert_array_equal(a.cell.numpy(), np.asarray(b.cell))
    np.testing.assert_allclose(a.pos.numpy(), np.asarray(b.pos), rtol=1e-6,
                               atol=1e-6)
    assert float(a.irr.mean()) > 0
    _close(a.irr.numpy(), b.irr, 1e-4, share=0.99)
    _close(a.irr.numpy(), b.irr, 1e-2)


@pytest.mark.parametrize("single", [False, True],
                         ids=["dipole", "singlescatter"])
def test_subsurface_render_matches_jax(scenes, single):
    js, cs = scenes[single]
    assert cs.config.sss_single == single
    img_j = np.asarray(jpath.render(js, spp=SPP))
    img_t = tpath.render(cs, spp=SPP).numpy()
    assert img_t.shape == img_j.shape and img_j.mean() > 0
    assert np.isfinite(img_t).all()
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 2e-3, \
        (img_t.mean(), img_j.mean())
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.97, close.mean()
