"""Spectral rendering of hairpt_torch against hairpt's, on the CPU: the
colorimetry (upsample_basis, rgb_weights, cauchy_eta), the band arrays of
respectralize_arrays field by field, and render_spectral at 3 and 6 bins
with and without Cauchy dispersion, on a small scene with every RGB
quantity the bands touch: 60 Marschner fibers (their azimuthal tables
recomputed per band), a dielectric sphere (its eta dispersed), a
diffuse floor, an area light, a point light and the sunsky (built by
hairpt's SceneBuilder on its packed walk; the port on the tiled
traversal's plain versions).

Bounds: the colorimetry exactly (the same float64 numpy); the band
arrays' upsampled fields within 1e-6 relative + 1e-7 (a [3] x [3, 3]
product in float32), eta exactly, the Marschner tables within 2e-6 of
their largest value (tests/test_torch_hair.py's bound for the
precompute); the images by torch_light_scenes.compare. Each JAX render
is compiled once."""
import dataclasses

import jax
import numpy as np
import pytest

from hairpt.core import spectral as jsp
from hairpt.film.film import Film
from hairpt.integrators import spectral as jspec
from hairpt.models import emitters as em
from hairpt.models import shapes as shp
from hairpt.models.bsdf import registry as mat
from hairpt.models.sensors import Camera
from hairpt.ops import bvh as jbvh
from hairpt.scene import hairgen
from hairpt.scene.scene import SceneBuilder
from hairpt_torch import convert
from hairpt_torch.core import spectral as tsp
from hairpt_torch.integrators import spectral as tspec
from hairpt_torch.ops import bvh as tbvh
import torch_light_scenes as scenes
from torch_furball import CAM
from torch_threads import one_thread  # noqa: F401

RES = 12


def _prism_scene():
    b = SceneBuilder()
    hair = b.add_material(kind=mat.MARSCHNER, sigma_a=(0.8, 0.5, 0.3),
                          beta_r=0.15, eta=1.55)
    b.add_fibers(hairgen.gen_furball(n_fibers=60,
                                     radius=0.00216667 * 20), hair)
    glass = b.add_material(kind=mat.DIELECTRIC, eta=1.5)
    tw = np.eye(4)
    tw[:3, 3] = (1.5, 11.0, -2.0)
    b.add_mesh(shp.sphere(1.2, 12, 24), glass, to_world=tw)
    floor = b.add_material(kind=mat.DIFFUSE, diffuse=(0.6, 0.5, 0.3),
                           twosided=True)
    ft = np.eye(4)
    ft[:3, :3] = np.array([[8.0, 0, 0], [0, 0, 8.0], [0, -8.0, 0]])
    ft[:3, 3] = (0.0, 8.0, 0.0)
    b.add_mesh(shp.rectangle(), floor, to_world=ft)
    lamp = np.eye(4)
    lamp[:3, :3] = np.array([[2.5, 0, 0], [0, 0, -2.5], [0, 2.5, 0]])
    lamp[:3, 3] = (0.0, 17.0, 0.0)
    b.add_mesh(shp.rectangle(), b.add_material(kind=mat.DIFFUSE),
               to_world=lamp, radiance=(6.0, 5.6, 5.0))
    b.delta_lights.append(dict(kind=em.POINT, position=(-6.0, 16.0, 6.0),
                               intensity=(60.0, 50.0, 40.0)))
    b.env = em.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                           sky_scale=5.0, sun_scale=19.0912,
                           sun_radius_scale=37.9165, res=32)
    cam = Camera.perspective(CAM, 12.0, RES, RES)
    return b.build(cam, Film.make(RES, RES, "tent"), spp=1, max_depth=4,
                   sampler=1, traversal="packed")


@pytest.fixture(scope="module")
def prism():
    old = jbvh._NATIVE, jbvh._NATIVE_TRIED
    jbvh._NATIVE, jbvh._NATIVE_TRIED = tbvh._load_native(), True
    try:
        js = _prism_scene()
    finally:
        jbvh._NATIVE, jbvh._NATIVE_TRIED = old
    src = js._replace(config=dataclasses.replace(js.config,
                                                 traversal="tiled",
                                                 tiled_q=8))
    cs = convert.convert_scene(src, jax.tree_util.tree_map(np.asarray,
                                                           js.arrays),
                               device="cpu")
    assert cs.marschner_rows == js.marschner_rows == (0,)
    return js, cs


@pytest.mark.parametrize("n_bins", [3, 6, 12, 30])
def test_colorimetry_equals_jax(n_bins):
    for f in ("bin_centers", "upsample_basis", "rgb_weights"):
        got, want = getattr(tsp, f)(n_bins), getattr(jsp, f)(n_bins)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    lam = tsp.bin_centers(n_bins)[0]
    np.testing.assert_array_equal(tsp.cauchy_eta(1.5, 0.0042, lam),
                                  jsp.cauchy_eta(1.5, 0.0042, lam))
    W, _, _ = tsp.rgb_weights(n_bins)
    A, _, _ = tsp.upsample_basis(n_bins)
    np.testing.assert_allclose(W.T @ A, np.eye(3), atol=1e-12)


@pytest.mark.parametrize("cauchy_b", [0.0, 0.0042])
def test_respectralize_arrays_field_by_field(prism, cauchy_b):
    js, cs = prism
    A, lam, _ = tsp.upsample_basis(6)
    for g in range(2):
        sl = slice(3 * g, 3 * g + 3)
        at = tspec.respectralize_arrays(cs, A[sl], lam[sl], cauchy_b)
        aj = jspec.respectralize_arrays(js, A[sl], lam[sl], cauchy_b)
        up = [("materials", f) for f in ("diffuse", "specular", "transmit",
                                         "sigma_a")]
        up += [("area", "radiance"), ("delta", "intensity"),
               ("env", "image")]
        for grp, f in up:
            a = getattr(getattr(at, grp), f).numpy()
            b = np.asarray(getattr(getattr(aj, grp), f))
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{grp}.{f}")
        np.testing.assert_array_equal(at.materials.eta.numpy(),
                                      np.asarray(aj.materials.eta))
        if cauchy_b > 0:
            assert float(at.materials.eta[1]) != 1.5
        # untouched: the env's sampling tables, the other material fields
        np.testing.assert_array_equal(at.env.alias_prob.numpy(),
                                      cs.arrays.env.alias_prob.numpy())
        assert at.materials.k is cs.arrays.materials.k
        for f in ("values", "weights", "lobe_weight", "values_quad"):
            a = getattr(at.hair_tables, f).numpy()
            b = np.asarray(getattr(aj.hair_tables, f))
            assert a.shape == b.shape, f
            assert np.abs(a - b).max() <= 2e-6 * np.abs(b).max(), f


@pytest.mark.parametrize("n_bins,cauchy_b", [(3, 0.0), (6, 0.0),
                                             (6, 0.0042)])
def test_render_spectral_matches_jax(prism, n_bins, cauchy_b):
    js, cs = prism
    a, bins_t = tspec.render_spectral(cs, n_bins=n_bins, spp=1, seed=1,
                                      cauchy_b=cauchy_b, return_bins=True)
    b, bins_j = jspec.render_spectral(js, n_bins=n_bins, spp=1, seed=1,
                                      cauchy_b=cauchy_b, return_bins=True)
    assert bins_t.shape == (RES, RES, n_bins)
    scenes.compare(a, b)
    scenes.compare(bins_t, bins_j)


def test_render_spectral_refuses_a_bin_count():
    with pytest.raises(ValueError, match="multiple of 3"):
        tspec.render_spectral(None, n_bins=4)
