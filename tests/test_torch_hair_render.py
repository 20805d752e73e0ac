"""The hair BSDFs end to end: the small furball of tests/torch_furball.py
with its 120 fibers split over four materials, one per hair kind
(Kajiya-Kay, Marschner faithful and corrected, MarschnerDielectric),
built by hairpt, carried across with hairpt_torch.convert and rendered,
and differentiated with respect to sigma_a and beta_r through the
azimuthal tables, by both packages on the CPU; path-replay backprop
against the port's differentiable mode; the port's SceneBuilder against
the converted scene; the inverse-rendering twin at a tiny size.

The scene uses the padded Sobol' sampler of the inverse-rendering
example. (With the true Sobol' sampler a lane's longitudinal sample can
be exactly 0, where hairpt's beta_r gradient is NaN and the port's is
not: tests/test_torch_hair.py::test_sampled_pole_keeps_a_finite_gradient
holds that difference.) hairpt renders with its CPU default, the packed
BVH traversal, which has no Pallas kernel and compiles in seconds; the
port runs the tiled traversal's plain versions on the same geometry
(closest hits are exact in both). Each JAX function is compiled once per
module."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hairpt.film.film import Film as JFilm
from hairpt.integrators import inverse as jinv
from hairpt.integrators import path as jpath
from hairpt.models import emitters as jem
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.scene import hairgen as jgen
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import convert
from hairpt_torch.core import rng as trng
from hairpt_torch.film.film import Film as TFilm
from hairpt_torch.integrators import inverse as tinv
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models import emitters as tem
from hairpt_torch.models.sensors import Camera as TCamera
from hairpt_torch.scene import hairgen as tgen
from hairpt_torch.scene.scene import SceneBuilder as TSceneBuilder
from torch_furball import CAM, DIFFUSE
from torch_threads import one_thread  # noqa: F401

RES = 32
N = RES * RES
KINDS = (jmat.KAJIYAKAY, jmat.MARSCHNER, jmat.MARSCHNER_PURE,
         jmat.MARSCHNERDIELECTRIC)
HAIR_PARAMS = ("sigma_a", "beta_r")
# as tests/test_torch_grad.py: the loss within 1e-3 relative (a few paths
# diverge where float32 rounding flips a sampling decision), each
# gradient component within 1e-2 of the largest |g| of hairpt's
LOSS_RTOL = 1e-3
GRAD_REL = 1e-2
# as tests/test_torch_prb.py: PRB against the differentiable mode
PRB_LOSS_RTOL = 1e-4
PRB_ATOL = 5e-3        # of each parameter's largest |g|


def _rows():
    return [dict(kind=k, sigma_a=(0.5, 0.5, 0.5), beta_r=0.1, eta=1.55,
                 alpha=0.2, exponent=30.0, diffuse=DIFFUSE) for k in KINDS]


def _fiber_sets(gen):
    """The small furball's 120 fibers as four FiberSets of 30."""
    fs = gen.gen_furball(n_fibers=120, radius=0.00216667 * 20)
    nv = 13                                 # 12 segments per fiber
    return [gen.FiberSet(fs.vertices[i * 30 * nv:(i + 1) * 30 * nv],
                         fs.vertex_starts_fiber[i * 30 * nv:
                                                (i + 1) * 30 * nv],
                         fs.radius) for i in range(4)]


def _build(b, em, cam_cls, film_cls, gen, env_kw=(), **cfg):
    """The four-kind furball through either package's SceneBuilder."""
    for r, fs in zip(_rows(), _fiber_sets(gen)):
        b.add_fibers(fs, b.add_material(**r))
    b.env = em.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                           sky_scale=5.0, sun_scale=19.0912,
                           sun_radius_scale=37.9165, res=32, **dict(env_kw))
    cam = cam_cls.perspective(CAM, 12.0, RES, RES)
    return b.build(cam, film_cls.make(RES, RES, "tent"), spp=1,
                   max_depth=3, sampler=1, nee_rr=0.0, **cfg)


@pytest.fixture(scope="module")
def hair():
    """hairpt's render and its loss, lanes and gradients (one compile
    each), the converted scene (tiled, q = 8 < C so the completion loop
    runs) and the port's render, lanes and gradients on it."""
    scene = _build(JSceneBuilder(), jem, JCamera, JFilm, jgen)
    img_j = np.asarray(jpath.render(scene, spp=1))
    li_j = jpath.make_li_fn(scene, differentiable=True)
    pix_j = jnp.arange(N, dtype=jnp.uint32)
    smp_j = jnp.zeros((N,), jnp.uint32)

    def loss_j(p):
        arrs = jinv.apply_params_arrays(scene.arrays, p, scene.marschner_rows)
        rad = li_j(arrs, pix_j, smp_j)[0]
        return jnp.mean(rad), rad
    mt = scene.arrays.materials
    params = {k: np.array(getattr(mt, k)) for k in HAIR_PARAMS}
    (l_j, rad_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()})

    tiled = scene._replace(config=dataclasses.replace(
        scene.config, traversal="tiled", tiled_q=8))
    ts = convert.convert_scene(
        tiled, jax.tree_util.tree_map(np.asarray, scene.arrays),
        device="cpu")
    img_t = tpath.render(ts, spp=1).numpy()
    pt = convert.params_to_torch(params, device="cpu")
    rad_t, _, _ = tpath.make_li_fn(ts, differentiable=True)(
        tinv.apply_params_arrays(ts.arrays, pt, ts.marschner_rows),
        torch.arange(N), torch.zeros(N, dtype=torch.int64))
    loss_t = rad_t.mean()
    loss_t.backward()
    return dict(scene=scene, ts=ts, params=params, img_j=img_j, img_t=img_t,
                l_j=float(l_j), rad_j=np.asarray(rad_j),
                g_j={k: np.asarray(v) for k, v in g_j.items()},
                l_t=float(loss_t.detach()), rad_t=rad_t.detach().numpy(),
                g_t=convert.grads_to_numpy({k: v.grad
                                            for k, v in pt.items()}))


def test_converted_scene_has_the_hair_tables(hair):
    """convert.py carries the four kinds, the Marschner rows and all four
    table arrays across unchanged; the port's SceneBuilder, given the
    same materials and fibers, builds the same material table bit for bit
    and hair tables within 2e-6 of their largest value (the precompute's
    summation order, tests/test_torch_hair.py)."""
    scene, ts = hair["scene"], hair["ts"]
    assert ts.active_kinds == tuple(sorted(KINDS))
    assert ts.marschner_rows == scene.marschner_rows == (1, 2)
    ht_j = scene.arrays.hair_tables
    for f in ("values", "weights", "lobe_weight", "values_quad"):
        np.testing.assert_array_equal(getattr(ts.arrays.hair_tables,
                                              f).numpy(),
                                      np.asarray(getattr(ht_j, f)),
                                      err_msg=f)
    built = _build(TSceneBuilder(device="cpu"), tem, TCamera, TFilm, tgen,
                   env_kw={"device": "cpu"}, traversal="tiled", tiled_q=8)
    assert built.marschner_rows == (1, 2)
    assert built.config.sampler == trng.SOBOL
    for f in built.arrays.materials._fields:
        if f == "cloth":  # no irawan row: no weave table
            assert built.arrays.materials.cloth is None \
                and ts.arrays.materials.cloth is None
            continue
        np.testing.assert_array_equal(
            getattr(built.arrays.materials, f).numpy(),
            getattr(ts.arrays.materials, f).numpy(), err_msg=f)
    for f in ("values", "values_quad", "weights"):
        a = np.asarray(getattr(ht_j, f))
        np.testing.assert_allclose(getattr(built.arrays.hair_tables,
                                           f).numpy(), a, rtol=0,
                                   atol=2e-6 * np.abs(a).max(), err_msg=f)


def test_hair_render_matches_jax(hair):
    """The forward render: the image mean within 1e-3 relative and >= 99%
    of pixel values within 1e-3 relative (+1e-4 absolute), as the rough
    plastic render (tests/test_torch_path.py)."""
    img_j, img_t = hair["img_j"], hair["img_t"]
    assert img_t.shape == img_j.shape == (RES, RES, 3)
    assert np.all(np.isfinite(img_t)) and img_j.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 1e-3
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()


def test_hair_differentiable_lanes_match_jax(hair):
    """The differentiable mode's per-lane radiance (>= 99% within 1e-3
    relative + 1e-4) and its mean, the loss, within LOSS_RTOL."""
    assert hair["l_j"] > 0
    assert abs(hair["l_t"] - hair["l_j"]) / hair["l_j"] < LOSS_RTOL
    close = np.isclose(hair["rad_t"], hair["rad_j"], rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.parametrize("name", HAIR_PARAMS)
def test_hair_gradient_matches_jax(hair, name):
    """d loss / d sigma_a [4, 3] and d beta_r [4] through the tables'
    precompute: finite, zero on the Kajiya-Kay and dielectric rows (rows
    0 and 3, which read no table and no beta_r), each component within
    GRAD_REL of the largest |g| of hairpt's."""
    g_j, g_t = hair["g_j"], hair["g_t"]
    scale = max(np.abs(v).max() for v in g_j.values())
    assert scale > 0
    assert np.isfinite(g_t[name]).all() and np.isfinite(g_j[name]).all()
    assert g_t[name].shape == g_j[name].shape
    assert not g_t[name][[0, 3]].any()
    np.testing.assert_allclose(g_t[name], g_j[name], rtol=0,
                               atol=GRAD_REL * scale, err_msg=name)


@pytest.mark.parametrize("depth", [3, 5])
def test_hair_prb_matches_differentiable_mode(hair, depth):
    """PRB's sigma_a and beta_r gradients (through the tables, carried
    back by make_prb_loss_grad) against the port's differentiable mode,
    RR off: the loss within 1e-4 and each gradient within 5e-3 of its
    largest |g| (tests/test_torch_prb.py's bounds)."""
    ts = hair["ts"]
    ts = ts._replace(config=dataclasses.replace(ts.config, max_depth=depth,
                                                rr_depth=999))
    params = {k: torch.as_tensor(v) for k, v in hair["params"].items()}
    pix, smp = torch.arange(N), torch.zeros(N, dtype=torch.int64)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    rad, _, _ = tpath.make_li_fn(ts, differentiable=True)(
        tinv.apply_params_arrays(ts.arrays, leaves, ts.marschner_rows),
        pix, smp)
    l_scan = rad.mean()
    l_scan.backward()
    l_prb, g_prb = tinv.make_prb_loss_grad(ts)(ts.arrays, params, pix, smp)
    assert float(l_prb) == pytest.approx(float(l_scan.detach()),
                                         rel=PRB_LOSS_RTOL)
    for k in HAIR_PARAMS:
        a, b = leaves[k].grad.numpy(), g_prb[k].numpy()
        scale = np.abs(a).max()
        assert scale > 0 and np.isfinite(b).all()
        np.testing.assert_allclose(b / scale, a / scale, atol=PRB_ATOL,
                                   err_msg=k)


def test_inverse_twin_runs_on_the_cpu(tmp_path):
    """hairpt_torch.tools.inverse_furball with --device cpu at a tiny
    size (res 24, 400 fibers, 6 steps): the example's scene (faithful
    Marschner, padded Sobol') and log format, finite losses, the
    parameters inside fit's clamps, and sigma_a's red channel moved from
    0.5 toward the truth 0.9 (the largest of the gradient's pulls). At
    this size the two-sample cross loss is dominated by its noise, in
    hairpt's example as in the twin, so whether it falls is checked at
    the example's size on the card (chip_smoke phase 10)."""
    from hairpt_torch.tools import inverse_furball as twin
    log = tmp_path / "twin.txt"
    assert twin.main(["--device", "cpu", "--res", "24", "--fibers", "400",
                      "--steps", "6", "--spp", "2", "--log",
                      str(log)]) == 0
    text = log.read_text().splitlines()
    assert text[0] == "# furball inverse rendering (BASELINE.json config 5)"
    assert text[1].endswith("backend=cpu res=24 fibers=400 spp=2 depth=3 "
                            "steps=6")
    losses = [float(line.split()[-1]) for line in text
              if line.startswith("step")]
    assert len(losses) == 6 and np.all(np.isfinite(losses))
    sa = [line for line in text if line.startswith("sigma_a")][0].split()
    br = [line for line in text if line.startswith("beta_r")][0].split()
    assert sa[-3:] == ["0.9000", "0.4500", "0.2500"] and br[-1] == "0.1600"
    rec = np.array([float(x) for x in sa[2:5]])
    assert np.all((rec >= 0.0) & (rec <= 10.0))
    assert 0.02 <= float(br[2]) <= 1.0
    assert rec[0] > 0.55, rec
