"""The auxiliary integrators of hairpt_torch (direct, ao, field, adaptive,
multichannel) against hairpt's, on the CPU: the area-lit box of
tests/test_bdpt.py and the 120-fiber hair stand-in of
tests/torch_light_scenes.py (hairpt on its packed walk, the port on the
tiled traversal's plain versions).

Bounds: every FIELDS entry within 1e-5 of its largest value (at least
1) on the box, and on >= 99% of the hair's values within 1e-4 (the
tiled query's cylinder arithmetic against the packed walk's); ao,
direct, adaptive and multichannel images by torch_light_scenes.compare
(the mean within 2e-3, >= 97% of the values within 1e-3 relative +
1e-4); the adaptive hot set exactly, and
hot_pixels against jax.lax.top_k exactly on tied errors. Each JAX render
is compiled once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.integrators import aux_integrators as jaux
from hairpt_torch.integrators import aux_integrators as taux
import torch_light_scenes as scenes
from torch_threads import one_thread  # noqa: F401

RES = 12


@pytest.fixture(scope="module")
def box():
    return scenes.build(scenes.box, res=RES)


@pytest.fixture(scope="module")
def hair():
    return scenes.build(scenes.hair, res=RES)


def _field_close(a, b, rel, share):
    a = a.numpy()
    b = np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    near = np.abs(a - b) <= rel * max(np.abs(b).max(), 1.0)
    assert near.mean() >= share, np.abs(a - b).max()


@pytest.mark.parametrize("field", jaux.FIELDS)
def test_render_field_matches_jax(box, hair, field):
    assert taux.FIELDS == jaux.FIELDS
    for (js, cs), rel, share in ((box, 1e-5, 1.0), (hair, 1e-4, 0.99)):
        _field_close(taux.render_field(cs, field),
                     jaux.render_field(js, field), rel, share)


def test_render_field_refuses_an_unknown_field(box):
    with pytest.raises(ValueError, match="not one of"):
        taux.render_field(box[1], "normal")


@pytest.mark.parametrize("ray_length", [-1.0, 0.5])
def test_render_ao_matches_jax(box, hair, ray_length):
    for js, cs in (box, hair):
        scenes.compare(taux.render_ao(cs, spp=3, ray_length=ray_length,
                                      seed=2),
                       jaux.render_ao(js, spp=3, ray_length=ray_length,
                                      seed=2))


def test_render_direct_matches_jax(box, hair):
    for js, cs in (box, hair):
        scenes.compare(taux.render_direct(cs, seed=1, spp=2),
                       jaux.render_direct(js, seed=1, spp=2))


def test_hot_pixels_break_ties_like_top_k():
    """Equal errors straddling the k boundary (the background's zeros):
    the lower index first, as jax.lax.top_k orders them."""
    rng = np.random.default_rng(3)
    err = rng.integers(0, 4, 400).astype(np.float32) * 0.25
    err[rng.random(400) < 0.5] = 0.0
    for k in (1, 37, 150, 399):
        _, want = jax.lax.top_k(jnp.asarray(err), k)
        got = taux.hot_pixels(torch.as_tensor(err), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_render_adaptive_matches_jax(box, monkeypatch):
    """The hot set exactly (each package's read from its call that picks
    it) and the image, on the box with fraction 0.3."""
    js, cs = box
    seen = {}
    top_k = jax.lax.top_k

    def spy(x, k):
        out = top_k(x, k)
        seen["hot"] = np.asarray(out[1])
        return out
    monkeypatch.setattr(jax.lax, "top_k", spy)
    b = jaux.render_adaptive(js, base_spp=2, extra_spp=2, fraction=0.3,
                             seed=1)
    hot_pixels = taux.hot_pixels

    def spy_t(err, k):
        seen["hot_t"] = hot_pixels(err, k)
        return seen["hot_t"]
    monkeypatch.setattr(taux, "hot_pixels", spy_t)
    a = taux.render_adaptive(cs, base_spp=2, extra_spp=2, fraction=0.3,
                             seed=1)
    np.testing.assert_array_equal(seen["hot_t"].numpy(), seen["hot"])
    assert seen["hot"].shape[0] == int(RES * RES * 0.3)
    scenes.compare(a, b)


def test_render_multichannel_matches_jax(hair):
    js, cs = hair
    chans = ("radiance", "ao", "shNormal", "albedo")
    a = taux.render_multichannel(cs, channels=chans, spp=2, seed=1)
    b = jaux.render_multichannel(js, channels=chans, spp=2, seed=1)
    assert set(a) == set(b) == set(chans)
    for ch in ("radiance", "ao"):
        scenes.compare(a[ch], b[ch])
    for ch in ("shNormal", "albedo"):
        _field_close(a[ch], b[ch], 1e-4, 0.99)
