"""hairpt_torch tiled intersector against hairpt run as its own CPU tests
run it (Pallas in interpret mode): the plain phase A and phase B, the
slot routing with tied bf16 entry times, and whole queries with q smaller
than the cluster count, so the exact-overflow completion loop runs. Then
kernel B's own rules against the port's plain phase B: its slot cull
keeps every hit, and its slot-level merge equals the per-lane rule; and
kernel A's: its tile test keeps every hit, and its two-level cull
equals the plain phase A."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hairpt.core.math import Ray as JRay
from hairpt.ops import bvh as jbvh
from hairpt.ops import intersect_swept as jsw
from hairpt.ops import intersect_tiled as jtl
from hairpt.ops import pallas_tiled as jpt
from hairpt.scene import hairgen
from hairpt_torch.core import rng as trng
from hairpt_torch.core import warps as twarps
from hairpt_torch.core.math import Ray
from hairpt_torch.integrators import common as tcommon
from hairpt_torch.models import sensors as tsensors
from hairpt_torch.scene import hairgen as thairgen
from hairpt_torch.scene.furball import furball_scene
from hairpt_torch.ops import intersect_swept as tsw
from hairpt_torch.ops import intersect_tiled as ttl
from hairpt_torch.ops import tiled_kernels as tk
from torch_threads import one_thread  # noqa: F401

K = 32
N_RAYS = 256
TILE = tk.TILE


@pytest.fixture(scope="module")
def geom():
    """60 fibers x 8 segments in C = 15 clusters of 32, both packages'
    layouts with the same cluster order, and 256 rays (4 tiles): camera-
    like rays, every 7th with a finite maxt, every 11th dead."""
    fs = hairgen.gen_furball(n_fibers=60, n_segs=8, radius=0.01, seed=0,
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
    assert C == 15
    return sw_j, sw_t, jr, tr, C


def _bounds(sw_t):
    return torch.cat([sw_t.cl_lo.T, sw_t.cl_hi.T]).contiguous()


def test_plain_phase_a_matches_jax(geom):
    sw_j, sw_t, jr, tr, C = geom
    mask, te_j, tpm_j, _ = jtl._tile_cluster_mask(sw_j, jr, 64)
    te_t, tpm_t = tk.cull_phase_a(ttl.rays8_of(tr), _bounds(sw_t))
    np.testing.assert_array_equal(te_t.float().numpy(),
                                  np.asarray(te_j.astype(jnp.float32)))
    np.testing.assert_array_equal(tpm_t.numpy(),
                                  np.asarray(tpm_j).reshape(-1, 64))
    assert bool(np.asarray(mask).any())


@pytest.mark.parametrize("q", [4, 6, 16])
def test_tile_slots_match_jax_with_tied_entry_times(q):
    """Entry times on a coarse grid, so many clusters of a tile share one
    bf16 te: the packed slots, counts, bounds and the last retained
    (te, cid) must equal the JAX stable-sort routing."""
    rs = np.random.default_rng(q)
    T, C = 40, 37
    te = (rs.integers(0, 6, (T, C)) * 0.375 + 1.0).astype(np.float32)
    te[rs.random((T, C)) < 0.3] = np.inf
    te[3] = np.inf                      # a tile with no candidate
    te_bf = jnp.asarray(te).astype(jnp.bfloat16)
    mask = jnp.isfinite(te_bf)
    ref = jtl._tile_slots(mask, te_bf, q, return_bound=True)
    ks = ttl.KeySpace(C)
    key = ks.keys(torch.as_tensor(te).to(torch.bfloat16))
    packed, cnt, tmin, tscale, ov, (key_last, more) = ttl._tile_slots(
        key, ks, q)
    assert int(np.asarray(jnp.sum(mask, 1) > 1).sum()) > 0
    # ties exist: some tile holds the same te in two clusters
    assert any(len(set(r[np.isfinite(r)])) < np.isfinite(r).sum()
               for r in te)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(ref[3]))
    assert ov == int(ref[4])
    te_l, cid_l, more_j = ref[5]
    np.testing.assert_array_equal(more.numpy(), np.asarray(more_j))
    m = more.numpy()
    np.testing.assert_array_equal(
        ks.te_of(key_last).numpy()[m],
        np.asarray(te_l.astype(jnp.float32))[m])
    np.testing.assert_array_equal(ks.cid_of(key_last).numpy()[m],
                                  np.asarray(cid_l)[m])


# t against a float64 evaluation: XLA:CPU contracts the JAX kernel's
# multiply-adds into FMAs (its object code for a * b + c is one vfmadd)
# while the port rounds every operation, so the two round differently.
# Each side is held to a float64 evaluation of the same cylinder test on
# the hit segment (pid, compared exactly, names it) within T_ULP ulp: no
# pattern of contracted multiply-adds moves a geom hit by more than 3 ulp
# (test_contracted_multiply_adds_move_t_by_at_most_3_ulp). The float64
# evaluation takes the root that the port's float32 test takes, so a hit
# next to a miter plane or mint cannot read as a rounding difference
T_ULP = 4


def _near_ok32(g, ray):
    """Whether cyl_test takes the near root of the ray [8] on the segment
    g [16], both float32: its float32 arithmetic (no fused multiply-add),
    in its order of operations."""
    f32 = np.float32
    near, _ = _t32_contracted(g, ray, np.zeros(19, bool))
    ox, oy, oz, dx, dy, dz, mint, maxt = ray
    rx, ry, rz = f32(ox - g[0]), f32(oy - g[1]), f32(oz - g[2])

    def dot(x, y, z, n):
        return f32(f32(f32(x * n[0]) + f32(y * n[1])) + f32(z * n[2]))

    on0, dn0 = dot(rx, ry, rz, g[6:9]), dot(dx, dy, dz, g[6:9])
    on1 = f32(dot(rx, ry, rz, g[9:12]) - g[13])
    dn1 = dot(dx, dy, dz, g[9:12])
    return bool(mint <= near <= maxt and f32(on0 + f32(near * dn0)) >= 0
                and f32(on1 + f32(near * dn1)) <= 0)


def _cyl_t64(seg_rows, rays8, pid):
    """float64 evaluation of the tiled cylinder test (cyl_test's
    operations) of each ray of rays8 [T, 8, 64] against the segment whose
    id is pid [T * 64] (>= 0), on the root the float32 test takes
    (_near_ok32): t [T * 64] float64, nan where pid < 0."""
    rows32 = seg_rows.numpy()
    rows = seg_rows.double().numpy()                        # [C, 16, K]
    ids = seg_rows[:, 15].contiguous().view(torch.int32).numpy()
    where = {int(ids[c, l]): (c, l) for c, l in zip(*np.nonzero(ids >= 0))}
    ray32 = rays8.numpy().transpose(0, 2, 1).reshape(-1, 8)
    ray = ray32.astype(np.float64)
    pid = np.asarray(pid).reshape(-1)
    t64 = np.full(pid.shape, np.nan)
    for i in np.nonzero(pid >= 0)[0]:
        c, lane = where[int(pid[i])]
        g = rows[c, :, lane]
        rx, ry, rz = ray[i, 0] - g[0], ray[i, 1] - g[1], ray[i, 2] - g[2]
        dx, dy, dz = ray[i, 3:6]
        ar = g[3] * rx + g[4] * ry + g[5] * rz
        po = np.array([rx - ar * g[3], ry - ar * g[4], rz - ar * g[5]])
        ad = g[3] * dx + g[4] * dy + g[5] * dz
        pd = np.array([dx - ad * g[3], dy - ad * g[4], dz - ad * g[5]])
        a, b = pd @ pd, po @ pd
        t_mid = -b / a
        q = po + pd * t_mid
        dt = np.sqrt(max(-(q @ q - g[14]) / a, 0.0))
        near = _near_ok32(rows32[c, :, lane], ray32[i])
        t64[i] = t_mid - dt if near else t_mid + dt
    return t64


def assert_t_near_f64(seg_rows, rays8, pid, **sides):
    """Each side's t [T, 64] (keyword: its name) within T_ULP ulp of the
    float64 evaluation on the rays that hit (pid [T, 64], the same on
    every side)."""
    t64 = _cyl_t64(seg_rows, rays8, pid)
    hit = ~np.isnan(t64)
    ulp = np.spacing(t64[hit].astype(np.float32)).astype(np.float64)
    for name, t in sides.items():
        err = np.abs(np.asarray(t).reshape(-1)[hit] - t64[hit]) / ulp
        assert err.max() <= T_ULP, (
            f"{name}: t {err.max():.2f} ulp from the float64 evaluation")


def _t32_contracted(g, ray, fuse):
    """cyl_test's two roots (near, far) in float32 for the segment g [16]
    and the ray [8], each of its 19 multiply-add sites either rounded
    twice or, where fuse (19 bools, in the order below) says so, fused
    into one rounding as an FMA does."""
    f32 = np.float32
    sites = iter(fuse)

    def ma(a, b, c):
        if next(sites):
            return f32(np.float64(a) * np.float64(b) + np.float64(c))
        return f32(f32(a * b) + c)

    ox, oy, oz, dx, dy, dz = ray[:6]
    rx, ry, rz = f32(ox - g[0]), f32(oy - g[1]), f32(oz - g[2])
    ar = ma(g[5], rz, ma(g[4], ry, f32(g[3] * rx)))
    px, py, pz = ma(-ar, g[3], rx), ma(-ar, g[4], ry), ma(-ar, g[5], rz)
    ad = ma(g[5], dz, ma(g[4], dy, f32(g[3] * dx)))
    qx, qy, qz = ma(-ad, g[3], dx), ma(-ad, g[4], dy), ma(-ad, g[5], dz)
    a = ma(qz, qz, ma(qy, qy, f32(qx * qx)))
    b = ma(pz, qz, ma(py, qy, f32(px * qx)))
    inv_a = f32(f32(1.0) / a)
    t_mid = f32(-b * inv_a)
    mx, my, mz = ma(qx, t_mid, px), ma(qy, t_mid, py), ma(qz, t_mid, pz)
    c_mid = f32(ma(mz, mz, ma(my, my, f32(mx * mx))) - g[14])
    dt = f32(np.sqrt(max(f32(-c_mid * inv_a), f32(0.0))))
    return f32(t_mid - dt), f32(t_mid + dt)


def test_contracted_multiply_adds_move_t_by_at_most_3_ulp(geom):
    """Why T_ULP is 4: on the hits of the geom rays (the port's plain
    phase B, q = 6, as test_plain_phase_b_matches_jax_kernel routes
    them), no pattern of fused multiply-adds (none, all, and 200 random
    ones per hit) moves t more than 3 ulp from the float64 evaluation,
    so evaluations that differ only in contraction, such as the JAX
    kernel under XLA:CPU and the port, lie within T_ULP of it. The
    pattern with no fused site is the port's arithmetic, bit for bit."""
    sw_j, sw_t, jr, tr, C = geom
    r8 = ttl.rays8_of(tr)
    te, tpm = tk.cull_phase_a(r8, _bounds(sw_t))
    ks = ttl.KeySpace(C)
    slots, cnt, tmin, tscale, _, _ = ttl._tile_slots(ks.keys(te), ks, 6)
    t, pid = tk.phase_b(slots, cnt, tmin, tscale, r8, tpm, sw_t.seg_rows_t,
                        _bounds(sw_t))
    pid = pid.numpy().reshape(-1)
    t64 = _cyl_t64(sw_t.seg_rows_t, r8, pid)
    rows = sw_t.seg_rows_t.numpy()
    ids = rows[:, 15].view(np.int32)
    where = {int(ids[c, l]): (c, l) for c, l in zip(*np.nonzero(ids >= 0))}
    rays = r8.numpy().transpose(0, 2, 1).reshape(-1, 8)
    rs = np.random.default_rng(0)
    hits = np.nonzero(pid >= 0)[0]
    assert len(hits) > 10
    worst = 0.0
    for i in hits:
        g = rows[where[int(pid[i])][0], :, where[int(pid[i])][1]]
        ulp = float(np.spacing(np.float32(t64[i])))
        patterns = [np.zeros(19, bool), np.ones(19, bool)] \
            + list(rs.random((200, 19)) < 0.5)
        for fuse in patterns:
            near, far = _t32_contracted(g, rays[i], fuse)
            err = min(abs(float(near) - t64[i]), abs(float(far) - t64[i]))
            worst = max(worst, err / ulp)
        assert float(t.numpy().reshape(-1)[i]) in [
            float(x) for x in _t32_contracted(g, rays[i], patterns[0])]
    assert worst <= T_ULP - 1


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_phase_b_matches_jax_kernel(geom, any_hit):
    """The plain phase B against the JAX Pallas kernel (interpret mode,
    deferred unroll-8 path) on the same routed slots; q = 6 < C. Closest
    hit: pid exactly, and each side's t within T_ULP of a float64
    evaluation of the same test."""
    sw_j, sw_t, jr, tr, C = geom
    q = 6
    r8 = ttl.rays8_of(tr)
    te_t, tpm_t = tk.cull_phase_a(r8, _bounds(sw_t))
    ks = ttl.KeySpace(C)
    slots, cnt, tmin, tscale, ov, _ = ttl._tile_slots(ks.keys(te_t), ks, q)
    assert ov > 0
    t_j, p_j = jpt.tiled_phase_b(
        jnp.asarray(slots.numpy()), jnp.asarray(cnt.numpy()),
        jnp.asarray(tmin.numpy()), jnp.asarray(tscale.numpy()),
        jnp.asarray(r8.numpy()), jnp.asarray(tpm_t.numpy()),
        jnp.asarray(sw_t.seg_rows_t.numpy()), K, q, any_hit=any_hit,
        interpret=True, unroll=8)
    t_t, p_t = tk.phase_b(slots, cnt, tmin, tscale, r8, tpm_t,
                          sw_t.seg_rows_t, _bounds(sw_t), any_hit=any_hit)
    p_j, t_j = np.asarray(p_j), np.asarray(t_j)
    if any_hit:
        np.testing.assert_array_equal(p_t.numpy() >= 0, p_j >= 0)
    else:
        np.testing.assert_array_equal(p_t.numpy(), p_j)
        assert (p_j >= 0).sum() > 10
        assert_t_near_f64(sw_t.seg_rows_t, r8, p_j, port=t_t.numpy(),
                          jax=t_j)


@pytest.mark.parametrize("mode", ["closest", "any"])
def test_tiled_query_with_completion_loop_matches_jax(geom, mode):
    """q = 4 < C = 15: several completion passes; the result equals the
    JAX query (impl='interpret')."""
    sw_j, sw_t, jr, tr, C = geom
    ttl.STATS["max_passes"] = 0
    if mode == "closest":
        t_j, p_j, ov = jtl.tiled_closest_hit(sw_j, jr, C, K, q_max=4,
                                             impl="interpret",
                                             return_overflow=True)
        t_t, p_t = ttl.tiled_closest_hit(sw_t, tr, q_max=4)
        assert int(ov) > 0
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
        hit = np.asarray(p_j) >= 0
        assert hit.sum() > 10
        np.testing.assert_allclose(t_t.numpy()[hit], np.asarray(t_j)[hit],
                                   rtol=1e-6)
    else:
        o_j = jtl.tiled_any_hit(sw_j, jr, C, K, q_max=4, impl="interpret")
        o_t = ttl.tiled_any_hit(sw_t, tr, q_max=4)
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    assert ttl.STATS["max_passes"] > 1


def test_morton_sort_matches_jax_and_sorted_query_is_unsorted_back(geom):
    sw_j, sw_t, jr, tr, C = geom
    _, order_j = jtl._morton_sort_rays(sw_j, jr)
    _, order_t = ttl._morton_sort_rays(sw_t, tr)
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    t0, p0 = ttl.tiled_closest_hit(sw_t, tr, q_max=4)
    t1, p1 = ttl.tiled_closest_hit(sw_t, tr, q_max=4, sort_rays=True)
    np.testing.assert_array_equal(p1.numpy(), p0.numpy())
    np.testing.assert_array_equal(t1.numpy(), t0.numpy())


def test_liveness_compaction_matches_full_width(geom):
    """A mostly-dead sorted wave runs on a prefix of N/4 or N/16 rays;
    the results equal the full-width run."""
    sw_j, sw_t, jr, tr, C = geom
    maxt = tr.maxt.clone()
    maxt[torch.arange(N_RAYS) % 9 != 0] = 0.0
    r = tr._replace(maxt=maxt)
    t_c, p_c = ttl.tiled_closest_hit(sw_t, r, q_max=4, sort_rays=True,
                                     compact=True)
    t_f, p_f = ttl.tiled_closest_hit(sw_t, r, q_max=4, sort_rays=True,
                                     compact=False)
    np.testing.assert_array_equal(p_c.numpy(), p_f.numpy())
    np.testing.assert_array_equal(t_c.numpy(), t_f.numpy())
    assert (p_f.numpy() >= 0).sum() > 0


def test_completion_loop_raises_past_its_cap(geom, monkeypatch):
    """The loop never spins: with the cap forced to one pass, a query
    that needs more passes raises with the unresolved count."""
    sw_j, sw_t, jr, tr, C = geom
    monkeypatch.setattr(ttl, "pass_cap", lambda C, q: 1)
    with pytest.raises(RuntimeError, match="unresolved"):
        ttl.tiled_closest_hit(sw_t, tr, q_max=2)


def test_wrappers_run_plain_versions_on_cpu(geom):
    sw_j, sw_t, jr, tr, C = geom
    tk.reset_counts()
    ttl.tiled_closest_hit(sw_t, tr, q_max=4)
    assert tk.LAUNCHES == {"cull_phase_a": 0, "phase_b": 0}
    assert tk.PLAIN_ON_CUDA == {"cull_phase_a": 0, "phase_b": 0}


# ---------------------------------------------------------------------------
# kernel B's slot cull and its slot-level merge (csrc/tiled.cu), on the CPU
# ---------------------------------------------------------------------------

def _furball_waves():
    """The small furball (quality 0.1: 600 fibers x 12 segments, C = 57
    clusters of 128) at 64^2: its camera wave and a first-bounce wave
    (uniformly random directions at the camera hits, Morton-sorted), as
    chip_smoke.py builds them at full width."""
    scene = furball_scene(quality=0.1, res=64, depth=4, device="cpu", q=64)
    cfg, arr = scene.config, scene.arrays
    pixel = torch.as_tensor(tcommon.block_swizzle(cfg.width, cfg.height))
    smp = trng.Sampler(cfg.sampler, pixel, torch.zeros_like(pixel))
    jit = smp.next_2d(0)
    pos = torch.stack([(smp.pixel % cfg.width).float() + jit[:, 0],
                       (smp.pixel // cfg.width).float() + jit[:, 1]], -1)
    cam = tsensors.sample_ray(scene.camera, pos)
    hit = tcommon.scene_intersect(arr, cam, cfg.tiled_q)
    n = pixel.shape[0]
    u = torch.as_tensor(np.random.default_rng(7).random((n, 2)),
                        dtype=torch.float32)
    d = twarps.square_to_uniform_sphere(u)
    d = torch.where((torch.sum(d * hit.geo_n, -1) < 0)[:, None], -d, d)
    o = torch.where(hit.valid[:, None], hit.p + hit.geo_n * cfg.ray_eps,
                    cam.o)
    bounce = Ray(o=o, d=d, mint=torch.zeros(n),
                 maxt=torch.where(hit.valid, float("inf"), 0.0))
    bounce, _ = ttl._morton_sort_rays(arr.hair_swept, bounce)
    assert int(hit.valid.sum()) > 100
    return arr.hair_swept, {"camera": cam, "bounce": bounce}


def _random_geometry():
    """The geometry of tests/test_torch_octets.py::
    test_streams_on_random_geometry_match_large_q (300 fibers, 1024 rays
    from a patch towards random points), in the port's own layout."""
    fs = thairgen.gen_furball(n_fibers=300, n_segs=8, radius=0.01, seed=0,
                              center=(0, 0, 0), core_r=0.8, fiber_len=1.0)
    segs = thairgen.segments(fs)
    sw = tsw.build_swept_hair(*[segs[k] for k in ("p0", "p1", "n0", "n1",
                                                  "radius")],
                              K=K, device="cpu")
    rs = np.random.default_rng(1)
    o = rs.uniform(-1, 1, (1024, 3)) * 0.5 + np.array([0, 0.2, -4.0])
    d = rs.uniform(-1.5, 1.5, (1024, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = Ray(torch.as_tensor(o, dtype=torch.float32),
              torch.as_tensor(d, dtype=torch.float32), torch.zeros(1024),
              torch.full((1024,), float("inf")))
    return sw, {"random": ray}


def _grazing_pencil(n_seg=64):
    """Rays that touch a fiber's cylinder exactly on a face of the
    fiber's own box. Each segment's axis lies in the yz plane (a_x = 0),
    so its box reaches c.x +- r along the whole segment; a ray in the yz
    plane perpendicular to the axis, with its x ON the box face (or 1 to
    3 ulp inside), grazes the cylinder there. Returns the (tile, box)
    pairs as _pairs_of does: one tile of 64 such rays per segment, its
    cluster block, the segment's own box (tighter than its cluster's) and
    the segment's lane."""
    rs = np.random.default_rng(5)
    c = rs.uniform(-4, 4, (n_seg, 3)) + np.array([1.0, 6.0, -2.0])
    th = rs.uniform(0, 2 * np.pi, n_seg)
    ax = np.stack([np.zeros(n_seg), np.cos(th), np.sin(th)], -1)
    L, r = 0.08, 0.00216667
    p0 = (c - ax * L / 2).astype(np.float32)
    p1 = (c + ax * L / 2).astype(np.float32)
    axf = ax.astype(np.float32)
    rad = np.full(n_seg, r, np.float32)
    lo, hi = tsw._miter_seg_bounds(p0, p1, axf, axf, rad)
    sw = tsw.build_swept_hair(p0, p1, axf, axf, rad, K=K, device="cpu")
    ids = sw.seg_rows_t[:, 15].contiguous().view(torch.int32)  # [C, K]
    where = {int(ids[cc, ll]): (cc, ll) for cc, ll in
             zip(*np.nonzero(ids.numpy() >= 0))}
    r8 = np.zeros((n_seg, 8, TILE), np.float32)
    for i in range(n_seg):
        j = np.arange(TILE)
        side = np.where(j % 2 == 0, 1.0, -1.0)             # hi / lo face
        k = (j // 2) % 4                                   # ulp inside
        s_ax = ((j // 8) / 7.0 - 0.5) * 0.6 * L            # along the axis
        face = np.where(side > 0, hi[i, 0], lo[i, 0]).astype(np.float32)
        ox = face - (side * k * np.spacing(np.abs(face))).astype(np.float32)
        d = np.array([0.0, axf[i, 2], -axf[i, 1]], np.float32)
        d = np.where((j // 32)[:, None] == 0, d, -d)
        e = c[i] + ax[i] * s_ax[:, None]
        o = (e - d * 1.0).astype(np.float32)
        o[:, 0] = ox
        r8[i, 0:3] = o.T
        r8[i, 3:6] = d.T
        r8[i, 7] = np.inf
    cl, ln = zip(*(where[i] for i in range(n_seg)))
    return (sw.seg_rows_t[list(cl)], torch.as_tensor(r8),
            torch.as_tensor(lo), torch.as_tensor(hi),
            torch.as_tensor(ln, dtype=torch.int64))


def _pairs_of(sw, ray):
    """Every (tile, cluster) pair of a wave: the cluster blocks [n, 16, K],
    the tiles' rays8 [n, 8, 64], the cluster boxes lo, hi [n, 3] and no
    lane (a pair hits where any lane hits)."""
    r8 = ttl.rays8_of(ttl._pad_rays(ray, TILE)[0])
    T, C = r8.shape[0], sw.cl_lo.shape[0]
    tiles = torch.arange(T).repeat_interleave(C)
    cl = torch.arange(C).repeat(T)
    return sw.seg_rows_t[cl], r8[tiles], sw.cl_lo[cl], sw.cl_hi[cl], None


def _cull_violations(rows, r8, lo, hi, lane, any_hit, chunk=256):
    """(pairs hit, hits the box test rejects, hits outside the exact box,
    the largest distance of a hit point outside its exact box relative to
    the margin's scale). Closest hit lowers maxt to the pair's own nearest
    hit, the tightest the kernel ever uses; any hit keeps the ray's
    maxt."""
    n_hit = n_viol = n_out = 0
    worst = 0.0
    for a in range(0, rows.shape[0], chunk):
        r8c = r8[a:a + chunk]
        t_m, _ = tk.cyl_test(rows[a:a + chunk], r8c)          # [m, 64, K]
        if lane is None:
            t_hit = t_m.amin(dim=2)
        else:
            t_hit = t_m.gather(2, lane[a:a + chunk, None, None].expand(
                -1, TILE, 1))[..., 0]
        hit = torch.isfinite(t_hit)
        maxt_eff = r8c[:, 7] if any_hit else \
            torch.where(hit, t_hit, r8c[:, 7])
        lo_c, hi_c = lo[a:a + chunk], hi[a:a + chunk]
        ok = tk.slot_cull_plain(r8c, lo_c, hi_c, maxt_eff)
        n_hit += int(hit.sum())
        n_viol += int((hit & ~ok).sum())
        if bool(hit.any()):
            p = r8c[:, 0:3].double() \
                + r8c[:, 3:6].double() * t_hit.double()[:, None]
            out = torch.maximum(lo_c.double()[..., None] - p,
                                p - hi_c.double()[..., None]).amax(dim=1)
            scale = r8c[:, 0:3].abs().amax(dim=1).double() \
                + torch.maximum(lo_c.abs(), hi_c.abs()).amax(dim=1)[:, None]
            n_out += int(((out > 0) & hit).sum())
            worst = max(worst, float((out.clamp(min=0) / scale)[hit].max()))
    return n_hit, n_viol, n_out, worst


@pytest.fixture(scope="module")
def furball_waves():
    return _furball_waves()


@pytest.fixture(scope="module")
def cull_cases(furball_waves):
    sw_f, wv_f = furball_waves
    sw_r, wv_r = _random_geometry()
    waves = [_pairs_of(sw, ray) for sw, wv in ((sw_f, wv_f), (sw_r, wv_r))
             for ray in wv.values()]
    return waves, _grazing_pencil()


@pytest.mark.parametrize("any_hit", [False, True])
def test_slot_cull_keeps_every_hit(cull_cases, any_hit, monkeypatch):
    """Kernel B's box test (slot_cull_plain, with its margin BOX_PAD)
    never rejects a (ray, cluster) pair whose lane test hits: every ray
    against every cluster on the small furball's camera and first-bounce
    waves and on the random geometry, and a pencil of rays grazing
    fibers exactly on their boxes' faces. Without the margin the pencil
    loses hits; with it, no hit point lies outside its exact box by more
    than 1/16 of the margin."""
    waves, pencil = cull_cases
    n_hit = n_viol = 0
    worst = 0.0
    for case in waves:
        h, v, _, wst = _cull_violations(*case, any_hit)
        n_hit, n_viol, worst = n_hit + h, n_viol + v, max(worst, wst)
    assert n_hit > 500
    h, v, out, wst = _cull_violations(*pencil, any_hit)
    assert h > 500
    assert n_viol == 0 and v == 0
    assert max(worst, wst) < tk.BOX_PAD / 16
    monkeypatch.setattr(tk, "BOX_PAD", 0.0)
    assert _cull_violations(*pencil, any_hit)[1] > 0


def _slotwise_model(slots, cnt, tmin, tscale, rays8, t_pmax, seg_rows,
                    bounds, any_hit):
    """csrc/tiled.cu phase_b_kernel transcribed slot by slot: the box
    cull, each (ray, warp of 32 lanes)'s record (its minimum t, the lanes
    at it, the largest pid among them and among those not holding the
    ray's best), and the merge of a slot's records into the ray's (best,
    pid, holds-best bits). Returns (t, pid, slots run, tie counts)."""
    T, K_ = slots.shape[0], seg_rows.shape[2]
    NW = K_ // 32
    inf = float("inf")
    best = torch.full((T, TILE), inf)
    bpid = torch.full((T, TILE), -1, dtype=torch.int32)
    eq = torch.zeros((T, TILE, K_), dtype=torch.bool)
    cnt_l = cnt.long()
    active = cnt_l > 0
    run = torch.zeros((T,), dtype=torch.int32)
    ties = {"lanes": 0, "slots": 0}
    n_max = int(cnt_l.max())
    for q0 in range(0, n_max, tk.UNROLL):
        if not bool(active.any()):
            break
        for s in range(q0, min(q0 + tk.UNROLL, n_max)):
            idx = torch.nonzero(active & (s < cnt_l)).squeeze(1)
            if idx.numel() == 0:
                continue
            n = idx.numel()
            cid = (slots[idx, s] & tk.CID_MASK).long()
            r8, b, e0 = rays8[idx], best[idx], eq[idx]
            maxt_eff = r8[:, 7] if any_hit else torch.minimum(r8[:, 7], b)
            act = tk.slot_cull_plain(r8, bounds[:3, cid].T, bounds[3:, cid].T,
                                     maxt_eff)
            if any_hit:
                act = act & ~torch.isfinite(b)
            t_m, pid_row = tk.cyl_test(seg_rows[cid], r8)
            tw = torch.where(act[..., None], t_m, inf).view(n, TILE, NW, 32)
            wmin = tw.amin(dim=3)                               # [n, 64, NW]
            at = torch.isfinite(tw) & (tw == wmin[..., None])
            pw = pid_row.view(n, 1, NW, 32)
            held = e0.view(n, TILE, NW, 32)
            pa = torch.where(at, pw, -1).amax(dim=3)
            pn = torch.where(at & ~held, pw, -1).amax(dim=3)
            st = wmin.amin(dim=2)                               # [n, 64]
            atw = torch.isfinite(wmin) & (wmin == st[..., None])
            lt = st < b
            tie = (st == b) & torch.isfinite(st)
            lanes = (at & atw[..., None]).view(n, TILE, K_)
            ties["lanes"] += int(((lanes.sum(dim=2) > 1) & (lt | tie)).sum())
            ties["slots"] += int((tie & lanes.any(dim=2)).sum())
            eq[idx] = torch.where(lt[..., None], lanes,
                                  torch.where(tie[..., None], e0 | lanes, e0))
            bpid[idx] = torch.where(
                lt, torch.where(atw, pa, -1).amax(dim=2).to(torch.int32),
                torch.where(tie, torch.maximum(
                    bpid[idx], torch.where(atw, pn, -1).amax(dim=2)
                    .to(torch.int32)), bpid[idx]))
            best[idx] = torch.where(lt, st, b)
        chk = active & (q0 < cnt_l)
        q_end = torch.clamp(cnt_l, max=q0 + tk.UNROLL)
        run = torch.where(chk, q_end.to(torch.int32), run)
        packed = slots.gather(1, (q_end - 1).clamp(min=0)[:, None])[:, 0]
        te_next = tk._dequant((packed >> 20) & tk.TE_INF, tmin, tscale)
        done = tk._done(best, te_next[:, None], t_pmax, any_hit).all(dim=1)
        active = active & ~(chk & done) & (q0 + tk.UNROLL < cnt_l)
    pid = torch.where(torch.isfinite(best), 0, -1).to(torch.int32) \
        if any_hit else bpid
    return best, pid, run, ties


def _tied_inputs(sw_t, seed=0, C2=10, T=4, q=24):
    """Slots over clusters built to tie: each new cluster is a lane
    permutation of a geom cluster with some lanes copied onto others (the
    same t at several lanes) and new random ids; clusters are drawn with
    repeats into each tile's slot list (the same t in several slots, at
    the same and at other lanes). Each ray aims at a point just inside a
    random live segment of a random new cluster, from 4 units away."""
    rs = np.random.default_rng(seed)
    base = sw_t.seg_rows_t.numpy()
    C, _, K_ = base.shape
    rows = np.empty((C2, 16, K_), np.float32)
    lo = np.empty((C2, 3), np.float32)
    hi = np.empty((C2, 3), np.float32)
    src = rs.integers(0, C, C2)
    src[1] = src[0]                          # one source used twice
    for j, c in enumerate(src):
        blk = base[c][:, rs.permutation(K_)].copy()
        for _ in range(K_ // 4):
            a, b = rs.integers(0, K_, 2)
            blk[:, b] = blk[:, a]
        ids = blk[15].view(np.int32)
        ids[ids >= 0] = rs.integers(0, 50, int((ids >= 0).sum()))
        rows[j] = blk
        lo[j], hi[j] = sw_t.cl_lo[c].numpy(), sw_t.cl_hi[c].numpy()
    n = T * TILE
    cl = rs.integers(0, C2, n)
    ln = np.array([rs.choice(np.nonzero(rows[c, 15].view(np.int32) >= 0)[0])
                   for c in cl])
    tgt = rows[cl, 0:3, ln] + 0.01 * rows[cl, 3:6, ln]
    u = rs.normal(size=(n, 3))
    o = tgt + 4.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.full(n, np.inf)
    maxt[::7] = 3.99                         # some rays stop short
    r8 = ttl.rays8_of(Ray(torch.as_tensor(o, dtype=torch.float32),
                          torch.as_tensor(d, dtype=torch.float32),
                          torch.zeros(n),
                          torch.as_tensor(maxt, dtype=torch.float32)))
    bounds = torch.as_tensor(np.concatenate([lo.T, hi.T]))
    _, t_pmax = tk.cull_phase_a_plain(r8, bounds)
    cid = rs.integers(0, C2, (T, q))
    cnt = rs.integers(q // 2, q + 1, T)
    cnt[0] = q
    bq = np.sort(rs.integers(0, 2048, (T, q)), axis=1)
    bq[:, -1] = tk.TE_INF
    slots = torch.as_tensor((cid | (bq << 20)).astype(np.int64)
                            .astype(np.uint32).view(np.int32))
    tmin = torch.as_tensor(rs.uniform(3.0, 3.5, T).astype(np.float32))
    tscale = torch.as_tensor(rs.uniform(1e-3, 3e-3, T).astype(np.float32))
    return (slots, torch.as_tensor(cnt.astype(np.int32)), tmin, tscale, r8,
            t_pmax, torch.as_tensor(rows), bounds)


@pytest.mark.parametrize("any_hit", [False, True])
def test_slot_merge_equals_per_lane_rule_on_forced_ties(geom, any_hit):
    """The kernel's slot-level rule (cull, reduce each slot per warp, then
    merge against the holds-best bits) gives exactly phase_b_plain's
    per-lane result (t, pid and slots run) on slots built to tie exactly
    across lanes and across slots."""
    args = _tied_inputs(geom[1])
    t_p, p_p, run_p = tk.phase_b_plain(*args[:7], any_hit, True)
    t_m, p_m, run_m, ties = _slotwise_model(*args, any_hit)
    np.testing.assert_array_equal(t_m.numpy(), t_p.numpy())
    np.testing.assert_array_equal(p_m.numpy(), p_p.numpy())
    np.testing.assert_array_equal(run_m.numpy(), run_p.numpy())
    assert int((p_p >= 0).sum()) > 200
    assert bool((run_p < args[1]).any())         # an early exit ran
    assert ties["lanes"] > 20
    if not any_hit:
        assert ties["slots"] > 100


def test_phase_b_wrapper_refuses_pair_counts_on_cpu(geom):
    args = _tied_inputs(geom[1])
    with pytest.raises(ValueError, match="cull"):
        tk.phase_b(*args, pairs_out=torch.zeros(args[0].shape[0],
                                                dtype=torch.int32))


# ---------------------------------------------------------------------------
# kernel A's group test and its two-level cull (csrc/tiled.cu), on the CPU
# ---------------------------------------------------------------------------

def _kernel_slab(rays8, bounds):
    """Kernel A's per-ray test of every ray against every box, with
    torch.fmin/fmax for the kernel's fminf/fmaxf (they drop a NaN
    operand, where cull_phase_a_plain's torch.minimum propagates it):
    (hit [T, 64, C], entry t [T, 64, C]). A dead ray never hits."""
    o = [rays8[:, ax, :, None] for ax in range(3)]
    inv = tk._inv_dir(rays8[:, 3:6])
    tn = tf = None
    for ax in range(3):
        a0 = (bounds[ax][None, None, :] - o[ax]) * inv[:, ax, :, None]
        a1 = (bounds[3 + ax][None, None, :] - o[ax]) * inv[:, ax, :, None]
        lo_ax, hi_ax = torch.fmin(a0, a1), torch.fmax(a0, a1)
        tn = lo_ax if tn is None else torch.fmax(tn, lo_ax)
        tf = hi_ax if tf is None else torch.fmin(tf, hi_ax)
    tf = tf * 1.00000024 + 1e-7
    mint, maxt = rays8[:, 6, :, None], rays8[:, 7, :, None]
    hit = (maxt > mint) & (tn <= tf) & (tf >= mint) & (tn <= maxt)
    return hit, tn


def _tile_cull_model(rays8, bounds):
    """csrc/tiled.cu cull_kernel transcribed: the tile test, the per-ray
    test on the tile's surviving clusters, and the shared atomics' integer
    min, max and or on the bits of max(entry t, 0) with the sign cleared.
    Returns (te, t_pmax, oct, clusters passing the tile test [T])."""
    T, C = rays8.shape[0], bounds.shape[1]
    p1 = tk.group_cull_plain(rays8, bounds)                       # [T, C]
    hit, tn = _kernel_slab(rays8, bounds)
    hit = hit & p1[:, None]
    v = torch.clamp(tn, min=0.0).view(torch.int32) & 0x7FFFFFFF
    te = torch.where(hit, v, 0x7F800000).amin(dim=1)
    te = ((te >> 16) << 16).view(torch.float32).to(torch.bfloat16)
    neg1 = int(torch.tensor(-1.0).view(torch.int32))
    tpm = torch.where(hit, v, neg1).amax(dim=2).view(torch.float32)
    h8 = hit.view(T, 8, 8, C).any(dim=2)
    octw = (1 << torch.arange(8, dtype=torch.int32)).view(1, 8, 1)
    oct = (h8.to(torch.int32) * octw).sum(1, dtype=torch.int32)
    return te, tpm, oct, p1.sum(1)


def _a_case(ray, bounds):
    return ttl.rays8_of(ttl._pad_rays(ray, TILE)[0]), bounds


def _adversarial_tiles():
    """Two tiles against 64 boxes near 1e4, some of zero width on one or
    all axes: rays aimed at random boxes, with direction components set
    to 0, -0, +-1e-13 (below the 1e-12 clamp), +-1e-12 and straddling 0
    within each octet; dead rays (maxt <= mint), mint > 0, finite maxt
    just past or short of the aim point, and 28 padding rays."""
    rs = np.random.default_rng(11)
    n_box, n = 64, 100
    c = 1e4 + rs.uniform(-3, 3, (n_box, 3))
    h = rs.uniform(0, 0.5, (n_box, 3))
    h[rs.random((n_box, 3)) < 0.2] = 0.0
    h[::9] = 0.0                                   # points
    lo, hi = (c - h).astype(np.float32), (c + h).astype(np.float32)
    o = (1e4 + rs.uniform(-4, 4, (n, 3))).astype(np.float32)
    tgt = c[rs.integers(0, n_box, n)] + rs.uniform(-0.3, 0.3, (n, 3))
    d = tgt - o
    dist = np.linalg.norm(d, axis=1)
    d = d / dist[:, None]
    specials = np.array([0.0, -0.0, 1e-13, -1e-13, 1e-12, -1e-12])
    pick = rs.random((n, 3)) < 0.25
    d[pick] = rs.choice(specials, int(pick.sum()))
    mint = np.where(rs.random(n) < 0.3, rs.uniform(0, 2, n), 0.0)
    maxt = np.where(rs.random(n) < 0.4, dist * rs.uniform(0.8, 1.2, n),
                    np.inf)
    dead = rs.random(n) < 0.15
    maxt[dead] = mint[dead] - rs.choice([0.0, 1.0], int(dead.sum()))
    ray = Ray(torch.as_tensor(o), torch.as_tensor(d, dtype=torch.float32),
              torch.as_tensor(mint, dtype=torch.float32),
              torch.as_tensor(maxt, dtype=torch.float32))
    return _a_case(ray, torch.as_tensor(np.concatenate([lo.T, hi.T])))


def _edge_tiles(n_tiles=8):
    """Tiles of 64 copies of one ray grazing an edge (x = 1, y = 0) of the
    unit box that hits it only because the slab test widens the exit t
    (tn > tf, tn <= tf * 1.00000024 + 1e-7): the group's ranges are then
    points, so the group test's own widening is what keeps the hit."""
    rs = np.random.default_rng(2)
    n = 4096
    o = rs.uniform(-3, -1, (n, 3)).astype(np.float32)
    e = np.stack([np.ones(n), np.zeros(n), rs.uniform(0.2, 0.8, n)], 1)
    d = e - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    bounds = torch.tensor([[0.0], [0.0], [0.0], [1.0], [1.0], [1.0]])
    o_t, d_t = torch.as_tensor(o), torch.as_tensor(d)
    inv = tk._inv_dir(d_t)
    tn = tf = None
    for ax in range(3):
        a0 = (bounds[ax] - o_t[:, ax]) * inv[:, ax]
        a1 = (bounds[3 + ax] - o_t[:, ax]) * inv[:, ax]
        lo_ax, hi_ax = torch.minimum(a0, a1), torch.maximum(a0, a1)
        tn = lo_ax if tn is None else torch.maximum(tn, lo_ax)
        tf = hi_ax if tf is None else torch.minimum(tf, hi_ax)
    only = (tn > tf) & (tn <= tf * 1.00000024 + 1e-7)
    sel = torch.nonzero(only)[:n_tiles, 0]
    assert sel.numel() == n_tiles
    r8 = torch.zeros((n_tiles, 8, TILE))
    r8[:, 0:3] = o_t[sel, :, None]
    r8[:, 3:6] = d_t[sel, :, None]
    r8[:, 7] = float("inf")
    return r8, bounds


def _nan_tile(component):
    """One tile aimed along +z (d.x > 0 for every ray, so the x slab
    bounds the group) at a box near the origin, and a far box at x = 50
    that ray 13 alone reaches, through a NaN in its x origin
    (component 'o') or x direction ('d'): fminf/fmaxf drop that axis, so
    its y and z slabs decide. Box 0 is near, box 1 is far."""
    rs = np.random.default_rng(3)
    o = np.stack([rs.uniform(-0.2, 0.2, TILE), rs.uniform(-0.2, 0.2, TILE),
                  np.full(TILE, -5.0)], 1)
    d = np.stack([rs.uniform(0.005, 0.01, TILE),
                  rs.uniform(-0.01, 0.01, TILE), np.ones(TILE)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if component == "o":
        o[13, 0] = np.nan
    else:
        d[13, 0] = np.nan
    lo = np.array([[-1.0, -1.0, -1.0], [50.0, -1.0, -1.0]], np.float32)
    hi = np.array([[1.0, 1.0, 1.0], [51.0, 1.0, 1.0]], np.float32)
    r8 = ttl.rays8_of(Ray(torch.as_tensor(o, dtype=torch.float32),
                          torch.as_tensor(d, dtype=torch.float32),
                          torch.zeros(TILE), torch.full((TILE,), np.inf)))
    return r8, torch.as_tensor(np.concatenate([lo.T, hi.T]))


@pytest.fixture(scope="module")
def a_cases(furball_waves):
    sw_f, wv_f = furball_waves
    sw_r, wv_r = _random_geometry()
    _, r8_p, lo_p, hi_p, _ = _grazing_pencil()
    cases = {name: _a_case(ray, _bounds(sw_f)) for name, ray in wv_f.items()}
    cases["random"] = _a_case(wv_r["random"], _bounds(sw_r))
    # every pencil tile against every fiber's own box (the rays lie on
    # the faces of their own fiber's box)
    cases["pencil"] = (r8_p, torch.cat([lo_p.T, hi_p.T]).contiguous())
    cases["adversarial"] = _adversarial_tiles()
    cases["edge"] = _edge_tiles()
    return cases


# the share of live (tile, cluster) pairs the tile test must reject on
# the small furball's camera wave (measured: 0.760; its first bounce wave
# has 3 live tiles, whose rays enter 94% of the clusters)
REJECT_AT_LEAST = {"camera": 0.7}


@pytest.mark.parametrize("case", ["camera", "bounce", "random", "pencil",
                                  "adversarial", "edge", "nan_o", "nan_d"])
def test_group_cull_keeps_every_hit(a_cases, case):
    """Kernel A's tile test (group_cull_plain) passes every (tile,
    cluster) pair in which a ray hits: by cull_phase_a_plain's predicate
    on the small furball's camera and first-bounce waves, the random
    geometry, the grazing pencil, the adversarial tiles and the edge
    tiles; and by the kernel's own fminf/fmaxf predicate on a tile where
    one live ray has a NaN origin ('nan_o') or direction ('nan_d')
    component, which reaches a box the tile's other rays do not and which
    the tile test, without its NaN rule, would reject. On the furball's
    camera wave the test rejects most pairs."""
    if case.startswith("nan_"):
        r8, bounds = _nan_tile(case[-1])
        hit, _ = _kernel_slab(r8, bounds)
        assert bool(hit[0, 13, 1]) and int(hit[0, :, 1].sum()) == 1
        assert not bool(torch.isfinite(
            tk.cull_phase_a_plain(r8, bounds)[0][0, 1].float()))
        ok = tk.group_cull_plain(r8, bounds)
        assert not bool((hit.any(1) & ~ok).any()) and bool(ok[0, 1])
        # without the NaN ray, the tile rejects the far box
        r8_dead = r8.clone()
        r8_dead[0, 7, 13] = -1.0
        assert not bool(tk.group_cull_plain(r8_dead, bounds)[0, 1])
        return
    r8, bounds = a_cases[case]
    hit = torch.isfinite(tk.cull_phase_a_plain(r8, bounds)[0].float())
    ok = tk.group_cull_plain(r8, bounds)
    assert ok.shape == hit.shape
    assert not bool((hit & ~ok).any())
    assert int(hit.sum()) > (10 if case == "adversarial" else 0)
    if case == "edge":
        assert bool(hit.all())
    if case in REJECT_AT_LEAST:
        live = (r8[:, 7] > r8[:, 6]).any(1)
        rejected = 1.0 - float(ok[live].float().mean())
        assert rejected >= REJECT_AT_LEAST[case], rejected


@pytest.mark.parametrize("case", ["camera", "bounce", "random", "pencil",
                                  "adversarial", "edge"])
def test_tile_cull_transcription_equals_plain_phase_a(a_cases, case):
    """Kernel A's two levels transcribed (_tile_cull_model: the tile test,
    the per-ray test on its surviving clusters, integer atomics on the
    sign-cleared entry t) give exactly cull_phase_a_plain's te, t_pmax
    and octet words, and the tile test passes no fewer clusters than are
    hit."""
    r8, bounds = a_cases[case]
    te_p, tpm_p, oct_p = tk.cull_phase_a_plain(r8, bounds, emit_oct=True)
    te_m, tpm_m, oct_m, n1 = _tile_cull_model(r8, bounds)
    np.testing.assert_array_equal(te_m.float().numpy(), te_p.float().numpy())
    np.testing.assert_array_equal(tpm_m.numpy(), tpm_p.numpy())
    np.testing.assert_array_equal(oct_m.numpy(), oct_p.numpy())
    n_hit = torch.isfinite(te_p.float()).sum(1)
    assert int(n_hit.sum()) > 0
    assert bool((n_hit <= n1).all()) and bool((n1 <= bounds.shape[1]).all())


def test_sqrt_rn_is_correctly_rounded():
    """The plain cylinder tests' root is the kernels' sqrtf, rounded to
    nearest, on every host (torch's CPU sqrt goes through MKL's vector
    math, whose rounding depends on the instruction set it dispatches
    to): equal to the float64 root rounded to float32 (double rounding
    is exact for a square root of a float32) on random, wide-range,
    denormal and boundary inputs."""
    rs = np.random.default_rng(3)
    x = np.concatenate([
        rs.random(1 << 16).astype(np.float32) * 1e-3,
        np.exp(rs.uniform(-87.0, 88.0, 1 << 16)).astype(np.float32),
        rs.integers(0, 0x7F800000, 1 << 16, dtype=np.uint32)
        .view(np.float32),
        np.array([0.0, -0.0, np.inf, 1.0, 4.0, 2.0 ** -149], np.float32)])
    ref = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = tk.sqrt_rn(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
