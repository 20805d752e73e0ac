"""Path-space MLT of hairpt_torch (integrators/mlt.py) against hairpt's on
the CPU, piece by piece, on the mirror box of tests/test_mlt_mutators.py
(torch_mlt_scenes.mirror_box, both sides with the packed walk).

Bounds: the lane gather and select, the bucket scaling and the uint32
salts' uniforms exactly; _perturb_dir, _delta_bounce, _eval_bsdf and
traj_w within 1e-6 (libm's and XLA's transcendental functions and fused
multiply-adds); _record_path lane by lane: the integer and boolean fields
equal on every lane, the float fields within 1e-4 relative + 1e-5. Each
mutation step from one recorded state (the lanes of its pattern): ok
(a > 0) equal on >= 99% of the lanes, a within 1e-3 relative + 1e-5 on
>= 97% of the lanes both call ok (the bidirectional steps: their few
lanes that survive); the manifold step's a within 5e-2 relative on those
lanes: its walked vertex agrees within 4e-6 in both packages, but the
generalized geometric term's forward differences at 1e-4 of the chord
amplify that, and float32 rounding, about 1e3-fold (a differs by up to
3.3% between the packages, 1.7% at the 97th percentile; hairpt's own
float32 G agrees with its float64 G within 1e-3 on under half of random
lanes). The port alone keeps
test_mlt_mutators.py's self-acceptance bounds under vanishing
perturbations. Each JAX function is compiled once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core import rng as jrng
from hairpt.integrators import mlt as jm
from hairpt_torch.core import rng as trng
from hairpt_torch.integrators import mlt as tm
import torch_light_scenes as tls
import torch_mlt_scenes as tms
from torch_threads import one_thread  # noqa: F401

RES = 24
N_POOL = 1 << 14
N = 1 << 10
SEED = 3
PHASES = ("lens", "caustic", "manifold", "mchain", "bidir", "bidir2")
# the relative tolerance of a where it is not 1e-3
A_RTOL = {"manifold": 5e-2}
# the least share of lanes both packages accept something on
BOTH_OK = {"bidir": 0.01, "bidir2": 0.0}
_JIT = {}


@pytest.fixture(scope="module")
def box():
    return tls.build(tms.mirror_box, res=RES)


def _t(x):
    return torch.as_tensor(np.array(x))


def _pix(n, salt):
    u = jrng.uniform_2d(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(salt), 0)
    return jnp.stack([u[:, 0] * RES, u[:, 1] * RES], -1)


@pytest.fixture(scope="module")
def pools(box):
    js, cs = box
    pix = _pix(N_POOL, 77)
    pj = jax.jit(lambda p: jm._record_path(js, js.arrays, p,
                                           jnp.uint32(5)))(pix)
    pt = tm._record_path(cs, cs.arrays, _t(pix), 5)
    return pj, pt


def _fields(rec):
    out = {f: getattr(rec, f) for f in rec._fields if f != "v"}
    out.update({"v." + f: getattr(rec.v, f) for f in rec.v._fields})
    return out


def test_record_path_matches_jax_lane_by_lane(pools):
    pj, pt = pools
    fj, ft = _fields(pj), _fields(pt)
    for k, want in fj.items():
        want, got = np.asarray(want), ft[k].numpy()
        assert got.shape == want.shape, k
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert (np.asarray(jm._lum(jm.traj_w(pj))) > 0).mean() > 0.01


def test_lane_gather_select_and_buckets(pools):
    pj, pt = pools
    rows = np.random.default_rng(1).integers(0, N_POOL, N)
    gj = jm._lane_gather(pj, jnp.asarray(rows))
    gt = tm._lane_gather(pt, torch.as_tensor(rows))
    src = _fields(pt)
    for k, v in _fields(gt).items():
        want = src[k].numpy()
        want = want[rows] if k in ("pix", "w_rest") else want[:, rows]
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    mask = np.random.default_rng(2).random(N) < 0.5
    rows2 = np.roll(rows, 7)
    sj = jm._lane_select(jnp.asarray(mask), gj,
                         jm._lane_gather(pj, jnp.asarray(rows2)))
    st = tm._lane_select(torch.as_tensor(mask), gt,
                         tm._lane_gather(pt, torch.as_tensor(rows2)))
    for k, v in _fields(st).items():
        np.testing.assert_allclose(v.numpy(), np.asarray(_fields(sj)[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tm.traj_w(gt).numpy(),
                               np.asarray(jm.traj_w(gj)), rtol=1e-6,
                               atol=1e-6)
    ratio = np.random.default_rng(3).random((N, 3)).astype(np.float32)
    dj = jm._deep_scale(gj, 2, jnp.asarray(ratio))
    dt = tm._deep_scale(gt, 2, torch.as_tensor(ratio))
    for k in ("w_em", "w_env", "w_rest"):
        np.testing.assert_allclose(getattr(dt, k).numpy(),
                                   np.asarray(getattr(dj, k)), rtol=1e-6,
                                   atol=0)
    np.testing.assert_array_equal(dt.w_em[:2].numpy(), gt.w_em[:2].numpy())


def test_perturb_dir_and_salts():
    rs = np.random.default_rng(0)
    d = rs.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u2 = rs.random((512, 2)).astype(np.float32)
    for th1, th2 in ((1e-4, 0.1), (1e-7, 2e-7), (2e-6, 1e-4)):
        np.testing.assert_allclose(
            tm._perturb_dir(torch.as_tensor(d), torch.as_tensor(u2), th1,
                            th2).numpy(),
            np.asarray(jm._perturb_dir(jnp.asarray(d), jnp.asarray(u2), th1,
                                       th2)), rtol=0, atol=1e-6)
    idx = np.arange(300)
    ji = jnp.asarray(idx, jnp.uint32)
    ti = torch.as_tensor(idx)
    for seed in (0, 5, 40000):
        for it in (0, 3, 61, 2 ** 20 + 7):
            itu = jnp.uint32(it)
            pairs = [
                (jrng.uniform_2d(ji, itu * jnp.uint32(2654435761)
                                 + jnp.uint32(17), 0),
                 trng.uniform_2d(ti, (it * 2654435761 + 17) & tm.M32, 0)),
                (jrng.uniform_1d(ji, jnp.uint32(seed * 131) + itu * 977 + 3,
                                 8),
                 trng.uniform_1d(ti, ((seed * 131) & tm.M32) + it * 977 + 3
                                 & tm.M32, 8)),
                (jrng.uniform_2d(ji, jnp.uint32(seed * 7919 + 5), 0),
                 trng.uniform_2d(ti, (seed * 7919 + 5) & tm.M32, 0)),
                (jrng.uniform_1d(ji, jnp.uint32(seed + 4 + 13 * 4), itu),
                 trng.uniform_1d(ti, (seed + 4 + 13 * 4) & tm.M32, it)),
                (jrng.uniform_1d(ji, jnp.uint32(seed + 41), itu * 4),
                 trng.uniform_1d(ti, (seed + 41) & tm.M32, (it * 4)
                                 & tm.M32))]
            for j, t in pairs:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    g_t = tm._gauss2(ti, 7, 5, 6, 11)
    g = jrng.uniform_2d(ji, jnp.uint32(12), jnp.uint32(22))
    g2 = jrng.uniform_2d(ji, jnp.uint32(13), jnp.uint32(22))
    g_j = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(g[:, :1], 1e-12))) \
        * jnp.concatenate([jnp.cos(2 * jnp.pi * g2[:, :1]),
                           jnp.sin(2 * jnp.pi * g2[:, :1])], 1)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6,
                               atol=1e-6)


def test_bsdf_eval_and_delta_bounce(box, pools):
    """_eval_bsdf and _delta_bounce at the recorded vertices 0..2, toward
    the recorded directions, both branches."""
    js, cs = box
    pj, pt = pools
    for k in range(3):
        vj, vt = jm._vtx(pj, k), tm._vtx(pt, k)
        wi = -np.asarray(pj.wo[k - 1]) if k else np.tile(
            np.asarray([0.0, 0.0, -1.0], np.float32), (N_POOL, 1))
        fj, pdj = jm._eval_bsdf(js.arrays, js.active_kinds, vj,
                                jnp.asarray(wi), pj.wo[k])
        ft, pdt = tm._eval_bsdf(cs.arrays, cs.active_kinds, vt,
                                torch.as_tensor(wi), pt.wo[k])
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(pdt.numpy(), np.asarray(pdj), rtol=1e-4,
                                   atol=1e-6)
        for c in (0, 1):
            ch = np.full(N_POOL, c, np.int32)
            oj = jm._delta_bounce(js.arrays, js.active_kinds, vj,
                                  jnp.asarray(wi), jnp.asarray(ch))
            ot = tm._delta_bounce(cs.arrays, cs.active_kinds, vt,
                                  torch.as_tensor(wi), torch.as_tensor(ch))
            for a, b in zip(ot, oj):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-4, atol=1e-6)


def _ctx(box, n=N, seed=SEED, lens_sigma=0.03):
    js, cs = box
    cj = jm._Ctx(scene=js, arr=js.arrays, kinds=js.active_kinds, n=n,
                 idx=jnp.arange(n, dtype=jnp.uint32),
                 cam_o=js.camera.to_world[:3, 3], seed=seed,
                 lens_sigma=lens_sigma)
    return cj, tm.make_ctx(cs, n, seed, lens_sigma)


def _jax_step(ctx, phase):
    """hairpt's step of `phase`, jitted once per (phase, ctx)."""
    key = (phase, ctx.seed, ctx.lens_sigma)
    if key not in _JIT:
        fn = {"lens": lambda s, it: jm._step_lens(ctx, s, it, 0.3),
              "caustic": lambda s, it: jm._step_caustic(ctx, s, it),
              "manifold": lambda s, it: jm._step_manifold(ctx, s, it),
              "mchain": lambda s, it: jm._step_mchain(ctx, s, it),
              "bidir": lambda s, it: jm._step_bidir(ctx, s, it),
              "bidir2": lambda s, it: jm._step_bidir2(ctx, s, it)}[phase]
        _JIT[key] = jax.jit(fn)
    return _JIT[key]


def _struct(phase, pj, arr):
    if phase == "caustic":
        return jm._struct_caustic(pj, arr)
    if phase == "manifold":
        return jm._struct_manifold(pj, arr)
    if phase == "mchain":
        return jm._struct_mchain(pj, arr)
    return jm._lum(jm.traj_w(pj)) > 0


@pytest.mark.parametrize("phase", PHASES)
def test_step_matches_jax(box, pools, phase):
    """Each step from the same state (the pool lanes of its pattern,
    repeated to N lanes), at step 7 (bidir2: the odd-round class)."""
    js, cs = box
    pj, pt = pools
    rows = np.nonzero(np.asarray(_struct(phase, pj, js.arrays)))[0]
    assert rows.size >= 3, rows.size
    rows = np.resize(rows, N)
    sj = jm._lane_gather(pj, jnp.asarray(rows))
    st = tm._lane_gather(pt, torch.as_tensor(rows))
    cj, ct = _ctx(box)
    prop_j, aj = _jax_step(cj, phase)(sj, jnp.uint32(7))
    if phase == "bidir2":
        prop_t, at = tm._step_bidir2(ct, st, 7)
    else:
        prop_t, at = tm.step(ct, phase, st, 7, 0, 0.3)
    aj, at = np.asarray(aj), at.numpy()
    okj, okt = aj > 0, at > 0
    assert (okj == okt).mean() >= 0.99, (okj == okt).mean()
    both = okj & okt
    assert both.mean() >= BOTH_OK.get(phase, 0.05), both.mean()
    close = np.isclose(at, aj, rtol=A_RTOL.get(phase, 1e-3), atol=1e-5)
    assert close[both].mean() >= 0.97 if both.any() else True, \
        close[both].mean()
    # the proposals' contributions on the lanes both accept with equal a
    keep = both & close
    np.testing.assert_allclose(
        tm.traj_w(prop_t).numpy()[keep], np.asarray(jm.traj_w(prop_j))[keep],
        rtol=A_RTOL.get(phase, 1e-3), atol=1e-5)
    np.testing.assert_array_equal(prop_t.v.valid.numpy()[:, keep],
                                  np.asarray(prop_j.v.valid)[:, keep])


def test_self_acceptance_under_vanishing_perturbations(box):
    """test_mlt_mutators.py's bounds, the port alone: the caustic,
    manifold and multi-chain moves accept a vanishing perturbation with
    a median a above 0.9, 0.85 and 0.85 on the lanes that survive."""
    _, cs = box
    pix = _pix(1 << 15, 77)
    pool = tm._record_path(cs, cs.arrays, _t(pix), 5)
    ctx = tm.make_ctx(cs, N, 0, 0.03)
    arr = cs.arrays

    def take(mask, want):
        rows = np.nonzero(mask.numpy())[0]
        assert rows.size >= want, rows.size
        return tm._lane_gather(pool, torch.as_tensor(np.resize(rows, N)))

    cases = (
        (take(tm._struct_caustic(pool, arr), 16),
         lambda s: tm._step_caustic(ctx, s, 1, sigma_scale=1e-3), 0.3, 0.9),
        (take(tm._struct_manifold(pool, arr), 6),
         lambda s: tm._step_manifold(ctx, s, 1, sigma=1e-4), 0.2, 0.85),
        (take(tm._struct_mchain(pool, arr), 4),
         lambda s: tm._step_mchain(ctx._replace(lens_sigma=1e-6), s, 1),
         0.2, 0.85))
    for st, fn, share, med in cases:
        a = fn(st)[1].numpy()
        elig = a > 0
        assert elig.mean() > share, elig.mean()
        assert np.median(a[elig]) > med, np.median(a[elig])


def test_render_mlt_matches_pt(box):
    """test_mlt_mutators.py's consistency bounds, the port alone: the
    mean within 15% of the path tracer's, the 4 x 4 block means within
    30% at the 85th percentile (16^2, its 8,192 chains and 64 steps)."""
    from hairpt_torch.integrators import path as tpath

    cs = tls.build(tms.mirror_box, res=16)[1]
    img_pt = tpath.render(cs, spp=128).numpy()
    img_ml = tm.render_mlt(cs, n_chains=1 << 13, n_mutations=64,
                           seed=2).numpy()
    assert np.isfinite(img_ml).all() and (img_ml >= 0).all()
    m_pt, m_ml = img_pt.mean(), img_ml.mean()
    assert abs(m_ml - m_pt) / m_pt < 0.15, (m_pt, m_ml)
    a = img_pt.reshape(4, 4, 4, 4, 3).mean((1, 3, 4))
    c = img_ml.reshape(4, 4, 4, 4, 3).mean((1, 3, 4))
    rel = np.abs(a - c) / np.maximum(a, 8e-2)
    assert np.percentile(rel, 85) < 0.3, rel
