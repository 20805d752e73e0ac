"""The slice end to end: a small furball scene built by hairpt, carried
across with hairpt_torch.convert, rendered one wave through both
packages (hairpt's tiled traversal with its Pallas kernel in interpret
mode, hairpt_torch's plain versions on the CPU)."""
import numpy as np
import jax
import pytest
import torch

from hairpt.core import rng as jrng
from hairpt.film.film import Film as JFilm
from hairpt.integrators import path as jpath
from hairpt.models import emitters as jem
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.scene import hairgen as jh
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import convert
from hairpt_torch.integrators import common as tcommon
from hairpt_torch.integrators import path as tpath
from hairpt_torch.ops import intersect_tiled as ttl
from torch_threads import one_thread  # noqa: F401

RES = 32
CAM = np.array([[-0.704024, 0.0939171, 0.703939, -10.6677],
                [1.05829e-08, 0.991217, -0.132245, 14.3141],
                [-0.710177, -0.0931033, -0.69784, 10.2879],
                [0, 0, 0, 1]])


@pytest.fixture(scope="module")
def scenes():
    """bench.py's furball at quality 0.02 (120 fibers, 1,440 segments,
    C = 12 clusters of 128), fibers 20x thicker and a 12-degree view so
    hair covers a good share of a 32^2 film; depth 3, true Sobol',
    q = 8 < C (the completion loop runs), shadow-ray RR 0.01. One JAX
    render per module (its compile dominates the file's time)."""
    b = JSceneBuilder()
    m = b.add_material(kind=jmat.ROUGHPLASTIC, alpha=0.2, eta=1.55, dist=0,
                       diffuse=(0.143016, 0.0156076, 1.80928e-05))
    b.add_fibers(jh.gen_furball(n_fibers=120, radius=0.00216667 * 20), m)
    b.env = jem.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                            sky_scale=5.0, sun_scale=19.0912,
                            sun_radius_scale=37.9165, res=32)
    cam = JCamera.perspective(CAM, 12.0, RES, RES)
    scene = b.build(cam, JFilm.make(RES, RES, "tent"), spp=1, max_depth=3,
                    sampler=(jrng.SOBOL_QMC, 5, RES), traversal="tiled",
                    swept_k=128, tiled_q=8, nee_rr=0.01)
    img_j = np.asarray(jpath.render(scene, spp=1))
    arrays = jax.tree_util.tree_map(np.asarray, scene.arrays)
    ts = convert.convert_scene(scene, arrays, device="cpu")
    ttl.STATS["max_passes"] = 0
    img_t = tpath.render(ts, spp=1).numpy()
    return scene, ts, img_j, img_t


def test_converted_scene_is_the_jax_scene(scenes):
    scene, ts, _, _ = scenes
    assert ts.config.swept_c == scene.config.swept_c == 12
    assert ts.config.tiled_q == 8
    np.testing.assert_array_equal(ts.arrays.hair_swept.seg_rows_t.numpy()
                                  .view(np.int32),
                                  np.asarray(scene.arrays.hair_swept
                                             .seg_rows_t).view(np.int32))
    np.testing.assert_array_equal(ts.arrays.env.image.numpy(),
                                  np.asarray(scene.arrays.env.image))


def test_render_image_mean_matches_jax(scenes):
    """Image mean within 1e-3 relative: the two packages trace the same
    paths; a few diverge where float32 rounding (an ulp in a hit t or a
    sin/cos) flips a sampling decision."""
    _, _, img_j, img_t = scenes
    assert img_t.shape == img_j.shape == (RES, RES, 3)
    assert np.all(np.isfinite(img_t))
    assert img_j.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 1e-3


def test_render_per_pixel_matches_jax(scenes):
    """>= 99% of pixel values within 1e-3 relative (+1e-4 absolute), and
    the completion loop ran (more than one pass)."""
    _, ts, img_j, img_t = scenes
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()
    assert ttl.STATS["max_passes"] > 1


def test_camera_hits_cover_the_film(scenes):
    """The test scene is not mostly background: a quarter or more of the
    camera rays hit hair."""
    _, ts, _, _ = scenes
    cfg = ts.config
    li = tpath.make_li_fn(ts)
    pix = torch.arange(RES * RES)
    smp = torch.zeros_like(pix)
    from hairpt_torch.core import rng
    from hairpt_torch.models import sensors
    s = rng.Sampler(cfg.sampler, pix, smp)
    j = s.next_2d(0)
    pos = torch.stack([(pix % RES).float() + j[:, 0],
                       (pix // RES).float() + j[:, 1]], -1)
    hit = tcommon.scene_intersect(ts.arrays, sensors.sample_ray(ts.camera,
                                                                pos),
                                  cfg.tiled_q)
    assert float(hit.valid.float().mean()) >= 0.25
    rad, pos2, n_rays = li(ts.arrays, pix, smp)
    assert rad.shape == (RES * RES, 3) and float(n_rays) > RES * RES
