"""The tiled query's options subcull, short_t (short-ray-first) and
two_round in the port, on the CPU: subcull's phase A (kernel A's plain
version over the 32-segment sub-cluster boxes, reduced to cluster rows)
against hairpt's _tile_cluster_mask reduced as hairpt reduces it (XLA
code, no Pallas); each option against the port's default query on the
small furball's camera, first-bounce and inner waves (32^2), closest
and any hit;
renders with traversal 'tiled_sub' and with tiled_short against the
'tiled' render; and convert_scene carrying both settings. No Pallas
kernel compiles here (a call of hairpt's query in interpret mode costs
about a minute of compile on a CPU): the options are held to the port's
default query, which tests/test_torch_tiled.py holds to hairpt's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core.math import Ray as JRay
from hairpt.film.film import Film as JFilm
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.ops import bvh as jbvh
from hairpt.ops import intersect_swept as jsw
from hairpt.ops import intersect_tiled as jtl
from hairpt.scene import hairgen
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import convert
from hairpt_torch.core import rng as trng
from hairpt_torch.core import warps as twarps
from hairpt_torch.core.math import Ray
from hairpt_torch.film.film import Film as TFilm
from hairpt_torch.integrators import common as tcommon
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.models import sensors as tsensors
from hairpt_torch.models.sensors import Camera as TCamera
from hairpt_torch.ops import intersect_swept as tsw
from hairpt_torch.ops import intersect_tiled as ttl
from hairpt_torch.ops import tiled_kernels as tk
from hairpt_torch.scene import hairgen as thairgen
from hairpt_torch.scene.furball import CAM_TO_WORLD, furball_scene
from hairpt_torch.scene.scene import SceneBuilder as TSceneBuilder
from torch_threads import one_thread  # noqa: F401

K = 128          # four sub-cluster boxes per cluster
N_RAYS = 256
Q = 64           # below the small furball's C = 57 ... 4 * C sub-boxes
TWO_ROUND = 8
# the least share of rays whose hit flag and pid an option must keep
PID_MIN_AGREE = 0.9999



@pytest.fixture(scope="module")
def layout():
    """120 fibers x 8 segments in C = 8 clusters of 128 (the last half
    padding, so two of its sub-boxes hold no segment), both packages'
    layouts with the same cluster order, and 256 rays (4 tiles): every
    7th with a finite maxt, every 11th dead."""
    fs = hairgen.gen_furball(n_fibers=120, n_segs=8, radius=0.01, seed=0,
                             center=(0, 0, 0), core_r=0.8, fiber_len=1.0)
    s = hairgen.segments(fs)
    a = [s[k] for k in ("p0", "p1", "n0", "n1", "radius")]
    sw_j = jsw.build_swept_hair(*a, K=K)
    lo, hi = tsw.cluster_bounds(*a, K=K)
    corder = jbvh.build(lo, hi, leaf_size=1).prim_order
    sw_t = tsw.build_swept_hair(*a, K=K, cluster_order=corder,
                                device="cpu")
    rs = np.random.default_rng(1)
    o = rs.uniform(-1, 1, (N_RAYS, 3)) * 0.5 + np.array([0, 0.2, -4.0])
    d = rs.uniform(-1.2, 1.2, (N_RAYS, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    maxt = np.full(N_RAYS, np.inf, np.float32)
    maxt[::7] = 4.0
    maxt[::11] = -1.0
    mint = np.zeros(N_RAYS, np.float32)
    jr = JRay(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint),
              jnp.asarray(maxt))
    tr = Ray(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(mint),
             torch.as_tensor(maxt))
    C = int(sw_j.seg_rows.shape[0]) // K
    assert C == 8 and sw_t.sub_lo.shape[0] == 4 * C
    return sw_j, sw_t, jr, tr, C


def test_subcull_phase_a_matches_jax(layout):
    """cull_reduce(subcull=True): te (min), the octet words (OR) and
    t_pmax over the sub-boxes equal hairpt's _tile_cluster_mask over
    (sub_lo, sub_hi) reduced as hairpt's query reduces it
    (intersect_tiled.py:521-532); the boxes themselves are equal too.
    The all-padding sub-boxes (inverted bounds) enter as hairpt's do."""
    sw_j, sw_t, jr, tr, C = layout
    np.testing.assert_array_equal(sw_t.sub_lo.numpy(),
                                  np.asarray(sw_j.sub_lo))
    np.testing.assert_array_equal(sw_t.sub_hi.numpy(),
                                  np.asarray(sw_j.sub_hi))
    mask_s, te_s, tpm_j, oct_s = jtl._tile_cluster_mask(
        sw_j, jr, 64, bounds=(sw_j.sub_lo, sw_j.sub_hi))
    n_sub = K // 32
    mask_j = np.asarray(mask_s).reshape(-1, C, n_sub).any(-1)
    te_j = np.asarray(te_s.astype(jnp.float32)).reshape(-1, C, n_sub).min(-1)
    oc3 = np.asarray(oct_s).reshape(-1, C, n_sub)
    oct_j = oc3[:, :, 0] | oc3[:, :, 1] | oc3[:, :, 2] | oc3[:, :, 3]
    te_t, tpm_t, oct_t = ttl.cull_reduce(ttl.rays8_of(tr), ttl.sub_bounds(
        sw_t), C, emit_oct=True, subcull=True)
    np.testing.assert_array_equal(te_t.float().numpy(), te_j)
    np.testing.assert_array_equal(torch.isfinite(te_t.float()).numpy(),
                                  mask_j)
    np.testing.assert_array_equal(oct_t.numpy(), oct_j)
    np.testing.assert_array_equal(tpm_t.numpy(),
                                  np.asarray(tpm_j).reshape(-1, 64))
    # an inverted (all-padding) sub-box is a huge box to the slab test,
    # in both packages: its cluster is every live tile's candidate at 0
    empty = (sw_t.sub_lo > sw_t.sub_hi).any(1).view(C, n_sub).any(1)
    assert int(empty.sum()) == 1
    live = (tr.maxt > tr.mint).view(-1, 64).any(1)
    assert bool((te_t.float()[live][:, empty] == 0).all())
    # elsewhere the sub-boxes' entries are no earlier than the clusters'
    te_c, _ = tk.cull_phase_a(ttl.rays8_of(tr), torch.cat(
        [sw_t.cl_lo.T, sw_t.cl_hi.T]).contiguous())
    fin = torch.isfinite(te_c.float()) & ~empty
    assert bool((te_t.float()[fin] >= te_c.float()[fin]).all())
    assert bool((te_t.float()[fin] > te_c.float()[fin]).any())


@pytest.fixture(scope="module")
def furball():
    """The small furball (quality 0.1: C = 57 clusters of 128) at 32^2:
    its camera wave, a first-bounce wave (uniformly random directions at
    the camera hits, Morton-sorted, as tests/test_torch_tiled.py builds
    it at 64^2) and a wave from inside its fur (2048 rays from points
    between the core and the fiber tips, uniformly random directions,
    Morton-sorted), where most rays that hit start; the default query's
    results, computed on first use."""
    scene = furball_scene(quality=0.1, res=32, depth=4, device="cpu", q=Q)
    cfg, arr = scene.config, scene.arrays
    sw = arr.hair_swept
    pixel = torch.as_tensor(tcommon.block_swizzle(cfg.width, cfg.height))
    smp = trng.Sampler(cfg.sampler, pixel, torch.zeros_like(pixel))
    jit = smp.next_2d(0)
    pos = torch.stack([(smp.pixel % cfg.width).float() + jit[:, 0],
                       (smp.pixel // cfg.width).float() + jit[:, 1]], -1)
    cam = tsensors.sample_ray(scene.camera, pos)
    hit = tcommon.scene_intersect(arr, cam, cfg.tiled_q)
    n = pixel.shape[0]
    rs = np.random.default_rng(11)
    d = twarps.square_to_uniform_sphere(torch.as_tensor(
        rs.random((n, 2)), dtype=torch.float32))
    d = torch.where((torch.sum(d * hit.geo_n, -1) < 0)[:, None], -d, d)
    o = torch.where(hit.valid[:, None], hit.p + hit.geo_n * cfg.ray_eps,
                    cam.o)
    bounce = Ray(o=o, d=d, mint=torch.zeros(n),
                 maxt=torch.where(hit.valid, float("inf"), 0.0))
    u = rs.normal(size=(2048, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = np.array([0.0, 11.0, 0.0]) + u * rs.uniform(1.7, 2.6, (2048, 1))
    d = rs.normal(size=(2048, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inner = Ray(torch.as_tensor(o, dtype=torch.float32),
                torch.as_tensor(d, dtype=torch.float32), torch.zeros(2048),
                torch.full((2048,), float("inf")))
    wv = {"camera": cam,
          "bounce": ttl._morton_sort_rays(sw, bounce)[0],
          "inner": ttl._morton_sort_rays(sw, inner)[0]}
    diag = float(torch.linalg.norm(sw.cl_hi - sw.cl_lo, dim=1).median())
    ref = {}

    def default(wave, mode):
        if (wave, mode) not in ref:
            ref[wave, mode] = ttl.tiled_closest_hit(sw, wv[wave], Q,
                                                    mode=mode)
        return ref[wave, mode]
    return sw, wv, diag, default


# a short_t of half the median cluster-box diagonal leaves work for both
# of short-ray-first's queries on the small furball (whose 57 clusters
# are far larger than the full furball's)
OPTIONS = {"subcull": lambda diag: dict(subcull=True),
           "short_t": lambda diag: dict(short_t=0.5 * diag, sort_rays=True),
           "two_round": lambda diag: dict(two_round=TWO_ROUND),
           "subcull_short_t": lambda diag: dict(subcull=True,
                                                short_t=0.5 * diag,
                                                sort_rays=True)}


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("mode", ["closest", "any"])
@pytest.mark.parametrize("wave", ["camera", "bounce", "inner"])
def test_option_equals_the_default_query(furball, wave, mode, option):
    """Each option against the default query (q = 64 < C: completion
    passes run) on the small furball's waves: hit flags and pids equal
    on >= PID_MIN_AGREE of the rays, t bit for bit where a closest-hit
    pid is equal, and every differing ray's lost hit (the default's
    closest hit) outside its segment's sub-cluster box
    (ttl.outside_sub_box)."""
    sw, wv, diag, default = furball
    ray = wv[wave]
    t_r, p_r = default(wave, mode)
    t_o, p_o = ttl.tiled_closest_hit(sw, ray, Q, mode=mode,
                                     **OPTIONS[option](diag))
    differ = (p_o != p_r) | ((p_o >= 0) != (p_r >= 0))
    assert float((~differ).float().mean()) >= PID_MIN_AGREE
    if mode == "closest":
        same = ~differ & (p_r >= 0)
        assert torch.equal(t_o[same], t_r[same])
    if bool(differ.any()):
        t_c, p_c = default(wave, "closest")
        lost = differ & (p_c >= 0)
        pt = ray.o[lost] + ray.d[lost] * t_c[lost, None]
        assert bool((ttl.outside_sub_box(sw, p_c[lost], pt) > 0).all())
    assert int((p_r >= 0).sum()) > {"camera": 20, "bounce": 0,
                                    "inner": 50}[wave]
    if "short_t" in option and mode == "closest" and wave == "inner":
        # both of short-ray-first's queries find hits (the camera rays
        # start far from the fur: their first query finds none)
        st = 0.5 * diag
        assert bool((t_o[p_o >= 0] <= st).any())
        assert bool((t_o[p_o >= 0] > st).any())


def test_outside_sub_box_is_zero_inside():
    """A segment's own end points lie in its sub-box; a point a radius
    past the box's face lies outside by one radius."""
    fs = thairgen.gen_furball(n_fibers=40, n_segs=8, radius=0.01, seed=2,
                              center=(0, 0, 0), core_r=0.8, fiber_len=1.0)
    s = thairgen.segments(fs)
    sw = tsw.build_swept_hair(*[s[k] for k in ("p0", "p1", "n0", "n1",
                                               "radius")], K=K,
                              device="cpu")
    pid = torch.arange(len(s["p0"]))
    p0 = torch.as_tensor(s["p0"], dtype=torch.float32)
    assert float(ttl.outside_sub_box(sw, pid, p0).max()) == 0.0
    ids = sw.seg_rows_t[:, 15, :].contiguous().view(torch.int32)
    row = int(torch.nonzero(ids.reshape(-1) == 5)[0])
    far = sw.sub_hi[row // ttl.SUBK].clone()
    far[0] += 0.01
    np.testing.assert_allclose(float(ttl.outside_sub_box(
        sw, torch.tensor([5]), far[None])), 1.0, rtol=1e-5)


def test_tiled_sub_and_short_renders_equal_tiled():
    """The small furball rendered with traversal 'tiled_sub' and with
    tiled_short > 0 (the sorted bounce and shadow queries short-ray-
    first) equals its 'tiled' render, and the sub-box instance of kernel
    A's wrapper is the one that ran (its plain version, on the CPU)."""
    base = furball_scene(quality=0.1, res=32, depth=4, device="cpu", q=Q)
    assert base.config.tiled_short == -1.0
    # torch's CPU sin can be off by ~1e-4 on its first call in a process
    # (ROADMAP Queue C): the first 'tiled' render is held to that, the
    # options to the second
    first = tpath.render(base, spp=1).numpy()
    img = tpath.render(base, spp=1).numpy()
    np.testing.assert_allclose(first, img, rtol=0,
                               atol=3e-4 * np.abs(img).max())
    sub = furball_scene(quality=0.1, res=32, depth=4, device="cpu", q=Q,
                        traversal="tiled_sub")
    short = base._replace(config=dataclasses.replace(base.config,
                                                     tiled_short=1.8))
    for s in (sub, short):
        tk.reset_counts()
        other = tpath.render(s, spp=1).numpy()
        np.testing.assert_allclose(other, img, rtol=1e-6, atol=1e-7)
        assert tk.LAUNCHES == {"cull_phase_a": 0, "phase_b": 0}
        assert tk.SUB_PLAIN_ON_CUDA == {"cull_phase_a_sub": 0}
    assert img.mean() > 0


def _builders(n_fibers=30):
    fs = (hairgen.gen_furball(n_fibers=n_fibers, radius=0.02),
          thairgen.gen_furball(n_fibers=n_fibers, radius=0.02))
    jb, tb = JSceneBuilder(), TSceneBuilder(device="cpu")
    jb.add_fibers(fs[0], jb.add_material(kind=jmat.ROUGHPLASTIC))
    tb.add_fibers(fs[1], tb.add_material(kind=tmat.ROUGHPLASTIC))
    return jb, tb


@pytest.mark.parametrize("short", [0.0, 0.7])
def test_convert_and_builder_carry_tiled_sub_and_short(short):
    """A hairpt scene built with traversal 'tiled_sub' and a tiled_short
    (0 -> -1, off; a positive value kept) comes across with both; the
    port's builder applies the same rule."""
    jb, tb = _builders()
    kw = dict(spp=1, traversal="tiled_sub", tiled_q=2048, tiled_short=short)
    js = jb.build(JCamera.perspective(CAM_TO_WORLD, 35.0, 8, 8),
                  JFilm.make(8, 8, "tent"), **kw)
    ts = tb.build(TCamera.perspective(CAM_TO_WORLD, 35.0, 8, 8),
                  TFilm.make(8, 8, "tent"), **kw)
    import jax
    cs = convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    want = -1.0 if short == 0.0 else short
    for s in (ts, cs):
        assert s.config.traversal == "tiled_sub"
        assert s.config.tiled_short == js.config.tiled_short == want
        assert s.config.tiled_q == 2048
