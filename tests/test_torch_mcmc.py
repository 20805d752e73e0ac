"""The primary-sample-space integrators of hairpt_torch (the path
estimator's uniforms hook, pssmlt, erpt) against hairpt's, on the CPU:
the area-lit box of tests/test_bdpt.py (which hairpt's own pssmlt and
erpt tests render) and the 120-fiber hair stand-in of
tests/torch_light_scenes.py.

Bounds: the chain's building blocks (the fresh uniforms, the wrap to
[0, 1), the pool pick) exactly; the Gaussian steps within 1e-6 (libm's
log and cos against XLA's); eval_u's positions exactly and its radiance
within 1e-4 relative + 1e-5 on >= 99% of the lanes (a path diverges
where float32 rounding flips a sampling decision), on seeded uniforms
with the pixel dims at 0 and 1 - 2^-24 and a dim past n_uniform_dims
that wraps; the chain images by torch_light_scenes.compare (the mean
within 2e-3, >= 97% of the values within 1e-3 relative + 1e-4). A chain
amplifies a last-bit difference where a pool pick or an accept test
falls within rounding of its threshold: on the hair stand-in, where 2-3%
of eval_u's lanes differ by 1e-4 to 1e-2 relative (the hair shading's
float32 rounding), 95% of the lanes must agree and the chain images'
means agree within 2e-3. The chains themselves are held chain by chain
against hairpt's, read out step by step by _jax_chains: at most
CHAINS_DIFFER of them may start from another pool lane or differ in an
accept flag, and the image of the others is held by
torch_light_scenes.compare. Each JAX function is compiled once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core import rng as jrng
from hairpt.film import film as jfilm
from hairpt.integrators import erpt as jerpt
from hairpt.integrators import path as jpath
from hairpt.integrators import pssmlt as jpss
from hairpt_torch.film import film as tfilm
from hairpt_torch.integrators import erpt as terpt
from hairpt_torch.integrators import path as tpath
from hairpt_torch.integrators import pssmlt as tpss
import torch_light_scenes as scenes
from torch_threads import one_thread  # noqa: F401

RES = 12
LANES = 512


@pytest.fixture(scope="module")
def box():
    return scenes.build(scenes.box, res=RES, depth=5)


@pytest.fixture(scope="module")
def hair():
    return scenes.build(scenes.hair, res=RES, depth=4)


SCENES = ("box", "hair")
# the share of eval_u's lanes within 1e-4 relative: on the hair stand-in
# 2-3% of the lanes differ by 1e-4 to 1e-2 relative (the shading's float32
# rounding on XLA's CPU against torch's, whichever hair traversal)
LANE_SHARE = {"box": 0.99, "hair": 0.95}
# the share of the chains that may start from another pool lane or differ
# in an accept flag (0-1.6% on the hair at seeds 1-22, none on the box)
CHAINS_DIFFER = {"box": 0.01, "hair": 0.03}


def _uniforms(n_dims, seed=0):
    u = np.random.default_rng(seed).random((LANES, n_dims)).astype(
        np.float32)
    u[:8, 0] = 0.0
    u[8:16, 0] = np.float32(1.0 - 2.0 ** -24)
    u[16:24, 1] = np.float32(1.0 - 2.0 ** -24)
    u[24:32, 2:] = 0.0
    return u


def _lanes_agree(rgb_t, rgb_j, share=0.99):
    rgb_j = np.asarray(rgb_j)
    ok = np.isclose(rgb_t.numpy(), rgb_j, rtol=1e-4, atol=1e-5).all(-1)
    assert ok.mean() >= share, ok.mean()
    assert rgb_j.mean() > 0


def _chain_images(a, b, make):
    """On the hair stand-in only the mean (2e-3): a chain whose pool pick
    or accept test lands within such a lane's difference of its threshold
    follows its own Markov chain from then on (3-13% of the pixels differ
    by more than 1e-2 at seeds 1-3)."""
    if make != "hair":
        scenes.compare(a, b)
        return
    b = np.asarray(b)
    assert np.isfinite(a.numpy()).all() and b.mean() > 0
    assert abs(float(a.mean()) - b.mean()) / b.mean() < 2e-3


_JAX_EVAL_U = {}


def _jax_chains(make, js, kind, n, n_mut, seed, sigma=0.014, p_large=0.3):
    """hairpt's chains step by step: the lax.scan bodies of
    hairpt/integrators/pssmlt.py and erpt.py, transcribed over hairpt's
    own eval_u, uniforms and film, keeping what the scan drops. Returns
    (b, pick, [(((pos, dep), (pos_p, dep_p)), acc) per step]), as the
    port's pssmlt_chains and erpt_chains do."""
    if make not in _JAX_EVAL_U:
        ev, n_dims = jpss.make_eval_u(js)
        _JAX_EVAL_U[make] = jax.jit(ev), n_dims
    ev, n_dims = _JAX_EVAL_U[make]
    cfg, arr = js.config, js.arrays
    idx = jnp.arange(n, dtype=jnp.uint32)

    def fresh(it, key):
        return jnp.stack([jrng.uniform_1d(idx, jnp.uint32(key),
                                          it * n_dims + d)
                          for d in range(n_dims)], axis=1)

    def gauss(key, d1, d2):
        pix = idx[:, None] * 131 \
            + jnp.arange(n_dims)[None, :].astype(jnp.uint32)
        g1 = jrng.uniform_1d(pix, jnp.uint32(key), d1)
        g2 = jrng.uniform_1d(pix, jnp.uint32(key), d2)
        return jnp.sqrt(-2.0 * jnp.log(jnp.maximum(g1, 1e-12))) \
            * jnp.cos(2 * jnp.pi * g2)

    if kind == "pssmlt":
        u0 = fresh(jnp.uint32(0), seed * 7919 + 1)
        pos0, rgb0, l0 = ev(arr, u0)
        u_pick = jrng.uniform_1d(idx, jnp.uint32(seed + 9), 0)
    else:
        u0 = fresh(jnp.uint32(0), seed * 131 + 1)
        pix = idx % (cfg.width * cfg.height)
        ux = ((pix % cfg.width).astype(jnp.float32) + u0[:, 0]) / cfg.width
        uy = ((pix // cfg.width).astype(jnp.float32) + u0[:, 1]) \
            / cfg.height
        u0 = u0.at[:, 0].set(ux).at[:, 1].set(uy)
        pos0, rgb0, l0 = ev(arr, u0)
        u_r = jrng.uniform_1d(idx, jnp.uint32(seed * 131 + 3), 0)
        u_pick = (idx.astype(jnp.float32) + u_r) / n
    b = jnp.mean(l0)
    cdf = jnp.cumsum(l0) / jnp.maximum(jnp.sum(l0), 1e-20)
    pick = jnp.clip(jnp.searchsorted(cdf, u_pick), 0, n - 1)
    u, pos, rgb, l = u0[pick], pos0[pick], rgb0[pick], l0[pick]
    steps = []
    for it in map(jnp.uint32, range(n_mut)):
        if kind == "pssmlt":
            u_large = fresh(it + 1, seed * 7919 + 2)
            u_small = jnp.mod(u + sigma * gauss(seed, it * 3 + 1,
                                                it * 3 + 2), 1.0)
            is_large = jrng.uniform_1d(idx, jnp.uint32(seed + 3),
                                       it) < p_large
            u_prop = jnp.where(is_large[:, None], u_large, u_small)
        else:
            u_prop = jnp.mod(u + sigma * gauss(seed + 5, it * 2 + 1,
                                               it * 2 + 2), 1.0)
        pos_p, rgb_p, l_p = ev(arr, u_prop)
        a = jnp.clip(l_p / jnp.maximum(l, 1e-12), 0.0, 1.0)
        if kind == "pssmlt":
            a = jnp.where(l <= 0, 1.0, a)
            w_cur = (1.0 - a) / jnp.maximum(l, 1e-12)
            w_prop = a / jnp.maximum(l_p, 1e-12)
            deps = ((pos, rgb * jnp.where(l > 0, w_cur, 0.0)[:, None]),
                    (pos_p, rgb_p * jnp.where(l_p > 0, w_prop,
                                              0.0)[:, None]))
            acc = jrng.uniform_1d(idx, jnp.uint32(seed + 4), it) < a
        else:
            share = b / n_mut
            deps = ((pos, jnp.where(
                (l > 1e-12)[:, None], rgb / jnp.maximum(l, 1e-12)[:, None]
                * ((1.0 - a) * share)[:, None], 0.0)),
                (pos_p, jnp.where(
                    (l_p > 1e-12)[:, None],
                    rgb_p / jnp.maximum(l_p, 1e-12)[:, None]
                    * (a * share)[:, None], 0.0)))
            acc = jrng.uniform_1d(idx, jnp.uint32(seed + 6), it) < a
        steps.append((deps, acc))
        u = jnp.where(acc[:, None], u_prop, u)
        pos = jnp.where(acc[:, None], pos_p, pos)
        rgb = jnp.where(acc[:, None], rgb_p, rgb)
        l = jnp.where(acc, l_p, l)
    return b, pick, steps


def _chains_agree(make, js, cs, kind, chains, ref, n_mut, seed):
    """The port's chains against hairpt's (_jax_chains): the transcription
    first against hairpt's own render `ref` (the same scaled sum of
    deposits, by torch_light_scenes.compare; within 1e-5 on the box), then
    chain by chain: the pool pick and every accept flag equal on all but
    CHAINS_DIFFER of the chains, and the image of the chains that agree,
    splatted by the port's film from each package's deposits, by
    torch_light_scenes.compare."""
    cfg = js.config
    b_j, pick_j, steps_j = _jax_chains(make, js, kind, LANES, n_mut, seed)
    scale = (cfg.width * cfg.height) / LANES
    scale_j = b_j * scale / n_mut if kind == "pssmlt" else scale
    img = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    for deps, _ in steps_j:
        for p, w in deps:
            img = jfilm.splat_add_only(js.film, p, w, img)
    img, ref = np.asarray(img * scale_j), np.asarray(ref)
    scenes.compare(img, ref)
    if make == "box":
        np.testing.assert_allclose(img, ref, rtol=1e-5,
                                   atol=1e-5 * ref.max())
    steps_t = list(chains.steps)
    assert len(steps_t) == n_mut
    acc_t = np.stack([a.numpy() for _, a in steps_t])
    acc_j = np.stack([np.asarray(a) for _, a in steps_j])
    agree = (chains.pick.numpy() == np.asarray(pick_j)) \
        & (acc_t == acc_j).all(0)
    assert 1.0 - agree.mean() <= CHAINS_DIFFER[make], agree.mean()
    assert 0.05 < acc_t.mean() < 0.95
    keep = torch.as_tensor(agree)[:, None]
    img_t = torch.zeros(cfg.height, cfg.width, 3)
    img_j = torch.zeros(cfg.height, cfg.width, 3)
    for (dt, _), (dj, _) in zip(steps_t, steps_j):
        for (p, w), (pj, wj) in zip(dt, dj):
            img_t = tfilm.splat_add_only(cs.film, p, w * keep, img_t)
            img_j = tfilm.splat_add_only(
                cs.film, torch.as_tensor(np.array(pj)),
                torch.as_tensor(np.array(wj)) * keep, img_j)
    scale_t = float(chains.b) * scale / n_mut if kind == "pssmlt" \
        else scale
    scenes.compare(img_t * scale_t, img_j.numpy() * float(scale_j))


def test_n_pss_dims(box):
    js, cs = box
    assert tpss.n_pss_dims(cs.config) == jpss.n_pss_dims(js.config) == 70


@pytest.mark.parametrize("make", SCENES)
def test_eval_u_matches_jax_lane_by_lane(box, hair, make):
    js, cs = {"box": box, "hair": hair}[make]
    ev_j, n_dims = jpss.make_eval_u(js)
    ev_t, n_t = tpss.make_eval_u(cs)
    assert n_t == n_dims
    u = _uniforms(n_dims)
    pos_j, rgb_j, l_j = ev_j(js.arrays, jnp.asarray(u))
    pos_t, rgb_t, l_t = ev_t(cs.arrays, torch.as_tensor(u))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    _lanes_agree(rgb_t, rgb_j, LANE_SHARE[make])
    ok = np.isclose(l_t.numpy(), np.asarray(l_j), rtol=1e-4, atol=1e-5)
    assert ok.mean() >= LANE_SHARE[make]


def test_uniforms_wrap_past_n_uniform_dims(box):
    """n_uniform_dims 10 at depth 5: the bounces read dims up to 65, which
    wrap to column dim mod 10 in both packages; the staged widths are
    off."""
    js, cs = box
    n = LANES
    u = _uniforms(10, seed=1)
    pix = np.arange(n) % (RES * RES)
    li_j = jpath.make_li_fn(js, n_uniform_dims=10)
    rgb_j, pos_j, _ = li_j(js.arrays, jnp.asarray(pix, jnp.uint32),
                           jnp.zeros(n, jnp.uint32), jnp.asarray(u))
    li_t = tpath.make_li_fn(cs, n_uniform_dims=10)
    rgb_t, pos_t, _ = li_t(cs.arrays, torch.as_tensor(pix),
                           torch.zeros(n, dtype=torch.int64),
                           uniforms=torch.as_tensor(u))
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    _lanes_agree(rgb_t, rgb_j)
    with pytest.raises(ValueError, match="uniforms"):
        li_t(cs.arrays, torch.as_tensor(pix),
             torch.zeros(n, dtype=torch.int64))


def test_uniform_sampler_takes_rows():
    u = torch.rand(6, 5)
    smp = tpath.UniformSampler(u)
    assert torch.equal(smp.next_1d(7), u[:, 2])
    assert torch.equal(smp.next_2d(4), torch.stack([u[:, 4], u[:, 0]], -1))
    order = torch.tensor([3, 1])
    assert torch.equal(smp.take(order).next_1d(1), u[order, 1])


def test_fresh_uniforms_equal_jax_per_dim():
    idx = np.arange(300)
    n_dims, key, it = 23, (5 * 7919 + 2) & 0xFFFFFFFF, 7
    got = tpss.fresh_uniforms(torch.as_tensor(idx), key, it, n_dims)
    want = jnp.stack([jrng.uniform_1d(jnp.asarray(idx, jnp.uint32),
                                      jnp.uint32(key),
                                      jnp.uint32(it) * n_dims + d)
                      for d in range(n_dims)], axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gauss_step_matches_jax():
    idx = np.arange(200)
    n_dims, seed, it = 19, 3, 5
    got = tpss.gauss_step(torch.as_tensor(idx), seed, n_dims, it * 3 + 1,
                          it * 3 + 2)
    pix = jnp.asarray(idx, jnp.uint32)[:, None] * 131 \
        + jnp.arange(n_dims)[None, :].astype(jnp.uint32)
    g1 = jrng.uniform_1d(pix, jnp.uint32(seed), jnp.uint32(it) * 3 + 1)
    g2 = jrng.uniform_1d(pix, jnp.uint32(seed), jnp.uint32(it) * 3 + 2)
    want = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(g1, 1e-12))) \
        * jnp.cos(2 * jnp.pi * g2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_wrap01_equals_jnp_mod():
    x = np.array([-1e-10, -0.0, 0.0, -0.25, 0.999999, 1.0, 1.0 + 2e-7,
                  1.5, -1.25, 2.0 ** -30, -(2.0 ** -30), 0.5],
                 np.float32)
    got = tpss.wrap01(torch.as_tensor(x)).numpy()
    want = np.asarray(jnp.mod(jnp.asarray(x), 1.0))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0] == 1.0


def test_pool_pick_matches_jax():
    """Integer luminances (exact cumulative sums), zeros among them, and
    picks on and between the steps."""
    l = np.array([0, 3, 0, 0, 1, 4, 0, 2], np.float32)
    u = np.array([0.0, 0.3, 0.3 + 1e-7, 0.4, 0.99, 1.0, 0.05, 0.7],
                 np.float32)
    got = tpss.pick_from_pool(torch.as_tensor(l), torch.as_tensor(u))
    cdf = jnp.cumsum(jnp.asarray(l)) / jnp.maximum(jnp.sum(jnp.asarray(l)),
                                                   1e-20)
    want = jnp.clip(jnp.searchsorted(cdf, jnp.asarray(u)), 0, len(l) - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("make", SCENES)
def test_render_pssmlt_matches_jax(box, hair, make):
    js, cs = {"box": box, "hair": hair}[make]
    a = tpss.render_pssmlt(cs, n_chains=LANES, n_mutations=6, seed=1)
    b = jpss.render_pssmlt(js, n_chains=LANES, n_mutations=6, seed=1)
    _chain_images(a, b, make)
    _chains_agree(make, js, cs, "pssmlt", tpss.pssmlt_chains(
        cs, n_chains=LANES, n_mutations=6, seed=1), b, 6, 1)


@pytest.mark.parametrize("make", SCENES)
def test_render_erpt_matches_jax(box, hair, make):
    js, cs = {"box": box, "hair": hair}[make]
    a = terpt.render_erpt(cs, n_seeds=LANES, n_mutations=4, seed=2)
    b = jerpt.render_erpt(js, n_seeds=LANES, n_mutations=4, seed=2)
    _chain_images(a, b, make)
    _chains_agree(make, js, cs, "erpt", terpt.erpt_chains(
        cs, n_seeds=LANES, n_mutations=4, seed=2), b, 4, 2)
