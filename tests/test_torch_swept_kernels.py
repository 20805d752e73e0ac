"""The swept traversal's two kernels (csrc/swept_cull.cu, csrc/phaseb.cu)
transcribed in torch and held, exactly, to the plain versions that
tests/test_torch_swept.py holds to the JAX package: the phase-A kernel's
tile test, per-ray test and selection against _phase_a_dense in both of
its branches, and kernel E's sub-box cull with its per-warp records and
their merge against phase_b_chunks_plain. The cases are the small
furball's waves, random geometry, dead rays at hit points, rays starting
inside several boxes, non-finite rays, p_max > C, key lists longer than
the kernel keeps in shared memory, a pencil grazing segments on their
sub-box faces, and forced equal-t ties. The pair routing between them
is held to its first, histogram-based form."""
import numpy as np
import pytest
import torch

from hairpt_torch.core import rng as trng
from hairpt_torch.core import warps as twarps
from hairpt_torch.core.math import Ray
from hairpt_torch.integrators import common as tcommon
from hairpt_torch.models import sensors as tsensors
from hairpt_torch.ops import intersect_swept as tsw
from hairpt_torch.ops import phaseb_kernels as pk
from hairpt_torch.scene import hairgen as thairgen
from hairpt_torch.scene.furball import furball_scene
from torch_threads import one_thread  # noqa: F401

P_MAX = 24
CHUNK = 64


def _ray(o, d, mint, maxt):
    f = torch.float32
    return Ray(torch.as_tensor(np.asarray(o), dtype=f),
               torch.as_tensor(np.asarray(d), dtype=f),
               torch.as_tensor(np.asarray(mint), dtype=f),
               torch.as_tensor(np.asarray(maxt), dtype=f))


def _fibers(n_fibers, K, seed=0):
    fs = thairgen.gen_furball(n_fibers=n_fibers, n_segs=8, radius=0.01,
                              seed=seed, center=(0, 0, 0), core_r=0.8,
                              fiber_len=1.0)
    s = thairgen.segments(fs)
    return tsw.build_swept_hair(*[s[k] for k in ("p0", "p1", "n0", "n1",
                                                 "radius")],
                                K=K, device="cpu")


@pytest.fixture(scope="module")
def furball():
    """The small furball (quality 0.1: 600 fibers x 12 segments, C = 57
    clusters of 128) at 64^2, as the swept render queries it, in lane
    order: its camera wave; a first-bounce wave (uniformly random
    directions at the camera hits, the missed lanes dead at the camera);
    and the dead lanes of a later bounce, which the integrator parks at
    their last hit point with mint = maxt = 0."""
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
    v = hit.valid
    dead = Ray(o=hit.p[v], d=d[v], mint=torch.zeros(int(v.sum())),
               maxt=torch.zeros(int(v.sum())))
    assert int(v.sum()) > 100
    return arr.hair_swept, {"camera": cam, "bounce": bounce, "dead": dead}


def _random_case(K=32):
    """300 fibers in clusters of K (C = 75 for K = 32); 1024 rays from a
    patch towards random points, every 5th with a finite maxt, every 9th
    dead."""
    sw = _fibers(300, K)
    rs = np.random.default_rng(1)
    o = rs.uniform(-1, 1, (1024, 3)) * 0.5 + np.array([0, 0.2, -4.0])
    d = rs.uniform(-1.5, 1.5, (1024, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.full(1024, np.inf)
    maxt[::5] = 4.0
    maxt[::9] = 0.0
    return sw, _ray(o, d, np.zeros(1024), maxt)


def _inside_case():
    """60 fibers in C = 15 clusters of 32; 500 rays starting at points
    inside the fur in random directions, most inside two or more boxes
    (they enter each at t = 0: ties broken by id), some dead."""
    sw = _fibers(60, 32)
    rs = np.random.default_rng(5)
    o = rs.uniform(-1.0, 1.0, (500, 3))
    d = rs.normal(size=(500, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.full(500, np.inf)
    maxt[::7] = 0.5
    maxt[::11] = 0.0
    return sw, _ray(o, d, np.zeros(500), maxt)


def _nonfinite_case():
    """The inside case's rays with non-finite components. Rays 3 and 17
    have a NaN origin or direction component (by _phase_a_dense's
    torch.minimum/maximum a NaN slab value makes a ray enter no box);
    rays 64..95 are escaped lanes as the integrator parks them, origin
    o + d * inf (+-inf components, NaN where d is 0), random directions,
    mint = maxt = 0; ray 96 has an infinite direction component (1/d =
    -0, finite); ray 100 starts at (+inf, +inf, +inf) heading into -x, -y,
    -z with maxt = +inf, so it enters every box at t = +inf and makes its
    tile pass every box."""
    sw, r = _inside_case()
    inf = float("inf")
    o, d = r.o.clone(), r.d.clone()
    mint, maxt = r.mint.clone(), r.maxt.clone()
    o[3, 0] = float("nan")
    d[17, 1] = float("nan")
    o[64:96] = r.o[64:96] + r.d[64:96] * inf
    o[64, 1] = float("nan")
    maxt[64:96] = 0.0
    d[96, 0] = -inf
    o[100] = inf
    d[100] = torch.tensor([-1.0, -1.0, -1.0]) / 3 ** 0.5
    maxt[100] = inf
    return sw, Ray(o, d, mint, maxt)


def _long_list_case():
    """Key lists longer than pk.SMEM_K (the kernel keeps them in a global
    scratch buffer): 200 boxes around the origin, nested and overlapping
    (phase A reads only cl_lo, cl_hi), 256 rays from a sphere of radius 3
    through the middle, most entering over 100 boxes; p_max = SMEM_K +
    16."""
    rs = np.random.default_rng(11)
    c = rs.uniform(-0.2, 0.2, (200, 3))
    h = rs.uniform(0.05, 1.0, (200, 3))
    f = torch.float32
    sw = tsw.SweptHair(torch.as_tensor(c - h, dtype=f),
                       torch.as_tensor(c + h, dtype=f), None, None, None)
    o = rs.normal(size=(256, 3))
    o *= 3.0 / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rs.uniform(-0.3, 0.3, (256, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.full(256, np.inf)
    maxt[::6] = 3.0
    return sw, _ray(o, d, np.zeros(256), maxt), pk.SMEM_K + 16


@pytest.fixture(scope="module")
def a_cases(furball):
    sw_f, wv = furball
    cases = {name: (sw_f, ray, 4) for name, ray in wv.items()}
    cases["random"] = _random_case() + (4,)
    cases["inside"] = _inside_case() + (5,)
    cases["nonfinite"] = _nonfinite_case() + (5,)
    sw_i, r_i = _inside_case()
    cases["p_max_over_c"] = (sw_i, r_i, sw_i.cl_lo.shape[0] + 5)
    cases["long_lists"] = _long_list_case()
    return cases


@pytest.mark.parametrize("c_chunk", [4, 1024])
@pytest.mark.parametrize("case", ["camera", "bounce", "dead", "random",
                                  "inside", "nonfinite", "p_max_over_c",
                                  "long_lists"])
def test_swept_phase_a_transcription_equals_plain(a_cases, case, c_chunk):
    """The phase-A kernel's algorithm (pk.swept_phase_a_model: the tile
    test over each tile's rays but padding, the per-ray test on the
    clusters it passes, the selection by key) gives _phase_a_dense's
    slots, cnt and n_hit exactly, in the nearest branch (c_chunk 4 < C)
    and the lowest-ids branch (c_chunk 1024 >= C)."""
    sw, ray, p_max = a_cases[case]
    C = sw.cl_lo.shape[0]
    s_p, c_p, n_p = tsw._phase_a_dense(sw, ray, p_max, c_chunk=c_chunk,
                                       return_n_hit=True)
    s_m, c_m, n_m, passes = pk.swept_phase_a_model(sw, ray, p_max,
                                                   c_chunk=c_chunk)
    np.testing.assert_array_equal(s_m.numpy(), s_p.numpy())
    np.testing.assert_array_equal(c_m.numpy(), c_p.numpy())
    np.testing.assert_array_equal(n_m.numpy(), n_p.numpy())
    assert int(n_p.sum()) > 100
    if case == "p_max_over_c":
        assert bool((s_p[:, C:] == -1).all()) and p_max > C
    else:
        assert int((n_p > p_max).sum()) > 0      # rays overflow p_max
    if case == "long_lists":                      # past the shared list
        assert p_max > pk.SMEM_K and int((c_p > pk.SMEM_K).sum()) > 100
    if case == "camera":                          # the tile test culls
        assert float(passes.sum()) < 0.5 * passes.numel() * C
    if case == "inside":                          # ties at t = 0
        o = ray.o[:, None, :]
        inside = ((o >= sw.cl_lo[None]) & (o <= sw.cl_hi[None])).all(-1)
        assert int((inside.sum(1) >= 2).sum()) > 50
    if case == "nonfinite":
        skip = pk.never_hits_plain(ray.o, pk.tk._inv_dir(ray.d), ray.mint,
                                   ray.maxt)
        assert bool(skip[[3, 17]].all()) and bool(skip[64:96].all())
        assert int(skip.sum()) == 34 and int(n_p[skip].sum()) == 0
        tile = int(torch.nonzero(pk.tile_order(sw, ray) == 100)) // 64
        assert int(n_p[100]) == C and int(passes[tile]) == C


def test_swept_tile_test_ranges_dead_rays(a_cases):
    """The tile test takes its ranges over every ray but padding: the
    dead lanes (mint = maxt = 0 at a hit point) enter the boxes around
    that point, and a tile test over live rays only, as kernel A's is,
    loses those candidates (and on a wave of dead lanes only, all)."""
    sw, ray, p_max = a_cases["dead"]
    _, c_p, n_p = tsw._phase_a_dense(sw, ray, p_max, return_n_hit=True)
    assert int((n_p > 0).sum()) > 0.9 * n_p.numel()
    T = -(-ray.o.shape[0] // 64)
    n = ray.o.shape[0]
    perm = pk.tile_order(sw, ray).long()       # the kernel's tiles
    maxt = torch.cat([ray.maxt[perm], torch.zeros(T * 64 - n)])
    mint = torch.cat([ray.mint[perm], torch.zeros(T * 64 - n)])
    live = (maxt > mint).view(T, 64)
    _, c_l, n_l, passes = pk.swept_phase_a_model(sw, ray, p_max,
                                                 ranged=live)
    assert int(passes.sum()) == 0 and int(n_l.sum()) == 0
    assert int(c_p.sum()) > 0


def test_swept_phase_a_wrapper_runs_the_plain_version_on_cpu(a_cases):
    sw, ray, p_max = a_cases["random"]
    pk.reset_counts()
    out = pk.swept_phase_a(sw, ray, p_max)
    ref = tsw._phase_a_dense(sw, ray, p_max, return_n_hit=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert pk.LAUNCHES == {"swept_phase_a": 0, "phase_b_chunks": 0}
    assert pk.PLAIN_ON_CUDA == {"swept_phase_a": 0, "phase_b_chunks": 0}
    order = pk.tile_order(sw, ray)
    assert torch.equal(torch.sort(order).values,
                       torch.arange(ray.o.shape[0], dtype=torch.int32))


def _route_pairs_histogram(slots, C, chunk):
    """_route_pairs as first written: the runs' lengths from a
    torch.bincount of the sorted keys, their starts from its cumsum."""
    N, P = slots.shape
    keys = slots.reshape(-1).long()
    keys = torch.where(keys < 0, C, keys)
    sc, order = torch.sort(keys, stable=True)
    counts = torch.bincount(sc, minlength=C + 1)[:C]
    padded = (counts + chunk - 1) // chunk * chunk
    pad_off = torch.cumsum(padded, 0) - padded
    start = torch.cumsum(counts, 0) - counts
    n_valid = int(counts.sum())
    sc = sc[:n_valid]
    pos = order[:n_valid]
    dest = pad_off[sc] + torch.arange(n_valid) - start[sc]
    n_padded = -(-(N * P) // chunk) * chunk + C * chunk
    chunk_ray = torch.full((n_padded,), -1, dtype=torch.int32)
    chunk_ray[dest] = (pos // P).to(torch.int32)
    chunk_cl = torch.full((n_padded,), -1, dtype=torch.int32)
    chunk_cl[dest] = sc.to(torch.int32)
    return (chunk_cl.view(-1, chunk).amax(dim=1), chunk_ray.view(-1, chunk),
            pos, dest)


@pytest.mark.parametrize("case", ["empty_clusters", "all_minus_one_rows",
                                  "no_pairs", "furball_camera"])
def test_route_pairs_equals_histogram_form(case, a_cases):
    """_route_pairs finds each cluster's run in the sorted keys by a
    search; its chunk_cl, chunk_ray, pos and dest equal the bincount form
    where clusters have no pairs (empty runs, first and last clusters
    included), where whole rows are -1, where no slot is valid, and on
    the small furball's camera wave."""
    C, chunk = 40, 8
    rs = np.random.default_rng(3)
    if case == "furball_camera":
        sw, ray, _ = a_cases["camera"]
        C = sw.cl_lo.shape[0]
        slots, _ = tsw._phase_a_dense(sw, ray, P_MAX, c_chunk=4)
    else:
        used = np.array([3, 4, 9, 17, 18, 30, 38])     # 0 and 39 empty
        slots = np.where(rs.random((300, 6)) < 0.6,
                         rs.choice(used, (300, 6)), -1)
        if case == "all_minus_one_rows":
            slots[::3] = -1
        if case == "no_pairs":
            slots[:] = -1
        slots = torch.as_tensor(slots, dtype=torch.int32)
    got = tsw._route_pairs(slots, C, chunk)
    want = _route_pairs_histogram(slots, C, chunk)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    n_valid = int((slots >= 0).sum())
    assert got[2].numel() == n_valid
    if case == "no_pairs":
        assert bool((got[0] == -1).all()) and n_valid == 0
    else:
        assert n_valid > 0 and int((got[0] >= 0).sum()) > 0


# ---------------------------------------------------------------------------
# kernel E: the sub-box cull, the per-warp records and their merge
# ---------------------------------------------------------------------------

def _chunk_model(chunk_cl, chunk_rays, seg_rows, sub_lo, sub_hi):
    """csrc/phaseb.cu chunk_kernel transcribed: the sub-box cull
    (pk.sub_cull_plain), each (ray, warp of 32 segments)'s record (the
    minimum t of its hits, the largest pid among its lanes at that t with
    t finite), and the merge of a ray's records (their minimum, the
    largest pid among the records at it). Returns (t, pid, pairs passing
    the cull, (ray, lane) ties across warps)."""
    n, _, CH = chunk_rays.shape
    C, _, K = seg_rows.shape
    NS = K // pk.SUBK
    live = chunk_cl >= 0
    cl = chunk_cl.clamp(min=0).long()
    act = pk.sub_cull_plain(chunk_rays, sub_lo.view(C, NS, 3)[cl],
                            sub_hi.view(C, NS, 3)[cl])     # [n, NS, CH]
    act = act & live[:, None, None]
    t_m, pid_row = pk.cyl_test_chunk(seg_rows[cl], chunk_rays)
    tw = torch.where(act.transpose(1, 2)[..., None],
                     t_m.view(n, CH, NS, 32), float("inf"))
    wm = tw.amin(dim=3)                                     # [n, CH, NS]
    at = (tw == wm[..., None]) & torch.isfinite(tw)
    pa = torch.where(at, pid_row.view(n, 1, NS, 32), -1).amax(dim=3)
    best = wm.amin(dim=2)
    on = wm == best[..., None]
    pid = torch.where(on, pa, -1).amax(dim=2)
    ties = int(((on & torch.isfinite(wm)).sum(2) > 1).sum())
    return best, pid, int(act.sum()), ties


def _routed(sw, ray):
    slots, _ = tsw._phase_a_dense(sw, ray, P_MAX)
    chunk_cl, chunk_ray, _, _ = tsw._route_pairs(slots, sw.cl_lo.shape[0],
                                                 CHUNK)
    return (chunk_cl, tsw._chunk_rays(ray, chunk_ray), sw.seg_rows_t,
            sw.sub_lo, sw.sub_hi)


def _grazing_chunks(n_seg=48):
    """One chunk per segment, against a cluster block that holds only
    that segment (its other 31 lanes padding), so its sub-box is the
    segment's own exact box. Each segment's axis lies in the yz plane, so
    the box reaches c.x +- r along the whole segment; the chunk's 64 rays
    lie in the yz plane perpendicular to the axis with x ON the box face
    (or 1 to 3 ulp inside) and graze the cylinder there."""
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
    K = 32
    sw = tsw.build_swept_hair(p0, p1, axf, axf, rad, K=K, device="cpu")
    rows_all = sw.seg_rows_t.numpy()
    ids = rows_all[:, 15].view(np.int32)
    where = {int(ids[cc, ll]): (cc, ll) for cc, ll in
             zip(*np.nonzero(ids >= 0))}
    blocks = np.zeros((n_seg, 16, K), np.float32)
    blocks[:, 15] = np.array(-1, np.int32).view(np.float32)
    r8 = np.zeros((n_seg, 8, CHUNK), np.float32)
    for i in range(n_seg):
        cc, ll = where[i]
        blocks[i, :, 0] = rows_all[cc, :, ll]
        j = np.arange(CHUNK)
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
    return (torch.arange(n_seg, dtype=torch.int32), torch.as_tensor(r8),
            torch.as_tensor(blocks), torch.as_tensor(lo),
            torch.as_tensor(hi))


def _tied_chunks(sw, seed=0, n_new=12, n_chunks=24):
    """Clusters built to tie: each is a lane permutation of a furball
    cluster with a quarter of its lanes copied onto others (the same t at
    lanes of one warp and of different warps) and new ids drawn from 0..49
    (equal pids at equal t too); every sub-box is the source cluster's
    box. Each chunk's 64 rays aim at a point just inside a random live
    segment of its cluster from 4 units away; every 7th stops short, every
    9th lane is padding (maxt = -1)."""
    rs = np.random.default_rng(seed)
    base = sw.seg_rows_t.numpy()
    C, _, K = base.shape
    NS = K // pk.SUBK
    rows = np.empty((n_new, 16, K), np.float32)
    lo = np.empty((n_new * NS, 3), np.float32)
    hi = np.empty((n_new * NS, 3), np.float32)
    for j, c in enumerate(rs.integers(0, C, n_new)):
        blk = base[c][:, rs.permutation(K)].copy()
        for _ in range(K // 4):
            a, b = rs.integers(0, K, 2)
            blk[:, b] = blk[:, a]
        ids = blk[15].view(np.int32)
        ids[ids >= 0] = rs.integers(0, 50, int((ids >= 0).sum()))
        rows[j] = blk
        lo[j * NS:(j + 1) * NS] = sw.cl_lo[c].numpy()
        hi[j * NS:(j + 1) * NS] = sw.cl_hi[c].numpy()
    cl = rs.integers(0, n_new, n_chunks)
    r8 = np.zeros((n_chunks, 8, CHUNK), np.float32)
    for i, c in enumerate(cl):
        live = np.nonzero(rows[c, 15].view(np.int32) >= 0)[0]
        ln = rs.choice(live, CHUNK)
        tgt = rows[c, 0:3, ln] + 0.01 * rows[c, 3:6, ln]
        u = rs.normal(size=(CHUNK, 3))
        o = tgt + 4.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
        d = tgt - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        maxt = np.full(CHUNK, np.inf)
        maxt[::7] = 3.99
        maxt[::9] = -1.0
        r8[i, 0:3], r8[i, 3:6], r8[i, 7] = o.T, d.T, maxt
    cl = np.concatenate([cl, [-1, -1]])                    # dead chunks
    r8 = np.concatenate([r8, r8[:2]])
    return (torch.as_tensor(cl.astype(np.int32)), torch.as_tensor(r8),
            torch.as_tensor(rows), torch.as_tensor(lo), torch.as_tensor(hi))


def _tangent_chunks(n_rot=4):
    """Rays that pass a segment's axis at distance r (1 - j 2^-22), j =
    0..63 (64 rays per chunk), perpendicular to it, from 1, 3, 10 and 30
    units away, all under a random rotation (so no value is exact): c =
    |q|^2 - r^2 lies a few 1e-12 below 0, where an error of the pretest's
    approximate t_mid decides. One chunk per (rotation, distance), its
    cluster block holding the segment in lane 0 (31 lanes padding)."""
    rs = np.random.default_rng(9)
    r, K = 0.00216667, 32
    j = np.arange(CHUNK)
    blocks, r8 = [], []
    for _ in range(n_rot):
        rot, _ = np.linalg.qr(rs.normal(size=(3, 3)))
        c = rs.uniform(-2, 2, 3)
        ax = rot @ np.array([0.0, 0.0, 1.0])
        p0 = (c - 0.04 * ax).astype(np.float32)
        p1 = (c + 0.04 * ax).astype(np.float32)
        sw = tsw.build_swept_hair(p0[None], p1[None],
                                  ax[None].astype(np.float32),
                                  ax[None].astype(np.float32),
                                  np.array([r], np.float32), K=K,
                                  device="cpu")
        ids = sw.seg_rows_t[0, 15].contiguous().view(torch.int32)
        lane = int(torch.nonzero(ids >= 0)[0, 0])
        blk = np.zeros((16, K), np.float32)
        blk[15] = np.array(-1, np.int32).view(np.float32)
        blk[:, 0] = sw.seg_rows_t[0, :, lane].numpy()
        for dist in (1.0, 3.0, 10.0, 30.0):
            x = r * (1.0 - j * 2.0 ** -22)
            z = ((j % 8) / 7.0 - 0.5) * 0.04
            o = np.stack([x, np.full(CHUNK, -dist), z], 1) @ rot.T + c
            d = np.tile(rot @ np.array([0.0, 1.0, 0.0]), (CHUNK, 1))
            rr = np.zeros((8, CHUNK), np.float32)
            rr[0:3], rr[3:6], rr[7] = o.T, d.T, np.inf
            blocks.append(blk)
            r8.append(rr)
    n = len(r8)
    lo = torch.full((n, 3), -1e30)
    return (torch.arange(n, dtype=torch.int32), torch.as_tensor(np.stack(r8)),
            torch.as_tensor(np.stack(blocks)), lo, -lo)


@pytest.fixture(scope="module")
def e_cases(furball):
    sw, wv = furball
    return {"camera": _routed(sw, wv["camera"]),
            "bounce": _routed(sw, wv["bounce"]),
            "random": _routed(*_random_case(K=128)),
            "pencil": _grazing_chunks(),
            "ties": _tied_chunks(sw),
            "tangent": _tangent_chunks()}


# hits each case must hold (the small furball's first bounce wave is
# mostly rays that leave the sparse fur: 6 hits)
MIN_HITS = {"camera": 100, "bounce": 5, "random": 100, "pencil": 100,
            "ties": 100, "tangent": 100}


@pytest.mark.parametrize("case", ["camera", "bounce", "random", "pencil",
                                  "ties", "tangent"])
def test_chunk_cull_and_merge_equal_plain_kernel_e(e_cases, case):
    """Kernel E's sub-box cull with its per-warp records and their merge
    (_chunk_model) gives phase_b_chunks_plain's t and pid exactly: on the
    routed chunks (p_max 24, chunks of 64) of the small furball's camera
    and first-bounce waves and of random rays through 300 fibers in
    clusters of 128, on a pencil of rays grazing segments on their
    sub-box faces, on chunks built to tie at equal t across lanes and
    warps, and on rays passing segments' axes at just under r. On the
    routed chunks the cull skips pairs."""
    args = e_cases[case]
    t_p, p_p = pk.phase_b_chunks_plain(*args[:3])
    t_m, p_m, n_act, ties = _chunk_model(*args)
    np.testing.assert_array_equal(t_m.numpy().view(np.int32),
                                  t_p.numpy().view(np.int32))
    np.testing.assert_array_equal(p_m.numpy(), p_p.numpy())
    assert int((p_p >= 0).sum()) > MIN_HITS[case]
    n, _, ch = args[1].shape
    NS = args[2].shape[2] // pk.SUBK
    if case in ("camera", "bounce", "random"):
        assert n_act < 0.8 * int((args[0] >= 0).sum()) * NS * ch
    if case == "ties":
        assert ties > 20


def test_sub_cull_margin_keeps_grazing_hits(e_cases, monkeypatch):
    """Without its margin (SUB_PAD = 0) the sub-box cull rejects grazing
    hits of the pencil, and the transcription loses them."""
    args = e_cases["pencil"]
    t_p, p_p = pk.phase_b_chunks_plain(*args[:3])
    monkeypatch.setattr(pk, "SUB_PAD", 0.0)
    _, p_m, _, _ = _chunk_model(*args)
    assert int(((p_p >= 0) & (p_m < 0)).sum()) > 0


def test_sub_cull_fails_padding_and_passes_nonfinite_rays(e_cases):
    """A lane with maxt < mint (padding) fails every sub-box; a ray with
    a NaN or infinite origin or direction component passes every one."""
    cl, r8, rows, lo, hi = e_cases["ties"]
    C, _, K = rows.shape
    NS = K // pk.SUBK
    r8 = r8[:4].clone()
    r8[:, 0, 1] = float("nan")
    r8[:, 4, 2] = float("inf")
    r8[:, 7, 3] = -1.0
    c = cl[:4].long()
    act = pk.sub_cull_plain(r8, lo.view(C, NS, 3)[c], hi.view(C, NS, 3)[c])
    assert bool(act[:, :, 1].all()) and bool(act[:, :, 2].all())
    assert not bool(act[:, :, 3].any())
    assert not bool(act[:, :, 9].any())          # padding lane of the case


def test_phase_b_chunks_wrapper_takes_no_boxes_on_cpu(e_cases):
    cl, r8, rows, lo, hi = e_cases["ties"]
    pk.reset_counts()
    t_a, p_a = pk.phase_b_chunks(cl, r8, rows)
    t_b, p_b = pk.phase_b_chunks(cl, r8, rows, lo, hi)
    assert torch.equal(p_a, p_b) and torch.equal(t_a, t_b)
    assert pk.LAUNCHES == {"swept_phase_a": 0, "phase_b_chunks": 0}


# the largest relative error of the kernel's __fdividef t_mid (2 ulp of
# -b / a, plus the plain quotient's own rounding), with room
T_MID_REL = 2.0 ** -21.5


@pytest.mark.parametrize("case", ["camera", "bounce", "random", "pencil",
                                  "ties", "tangent"])
def test_cyl_pretest_keeps_every_hit(e_cases, case):
    """Kernel E's pretest (pk.cyl_pretest_plain, its t_mid moved by
    +-T_MID_REL) rejects no (ray, segment) pair that cyl_test_chunk hits;
    on the routed furball and random chunks it leaves at most a quarter
    of the (ray, warp) pairs that pass the sub-box cull to the full
    test."""
    cl, r8, rows, lo, hi = e_cases[case]
    live = cl >= 0
    c = cl.clamp(min=0).long()
    t, _ = pk.cyl_test_chunk(rows[c], r8)
    hit = torch.isfinite(t) & live[:, None, None]
    assert int(hit.sum()) > MIN_HITS.get(case, 100)
    for rel in (T_MID_REL, -T_MID_REL):
        maybe = pk.cyl_pretest_plain(rows[c], r8, rel)
        assert not bool((hit & ~maybe).any())
    if case in ("camera", "random"):
        C, _, K = rows.shape
        NS = K // pk.SUBK
        act = pk.sub_cull_plain(r8, lo.view(C, NS, 3)[c],
                                hi.view(C, NS, 3)[c]) & live[:, None, None]
        warp = maybe.view(*maybe.shape[:2], NS, 32).any(-1).transpose(1, 2)
        assert int((warp & act).sum()) < 0.4 * int(act.sum())


def test_cyl_pretest_bound_keeps_tangent_hits(e_cases, monkeypatch):
    """Without its error bound the pretest rejects hits of rays that pass
    a segment's axis at just under r once t_mid moves by T_MID_REL."""
    cl, r8, rows, _, _ = e_cases["tangent"]
    t, _ = pk.cyl_test_chunk(rows[cl.long()], r8)
    hit = torch.isfinite(t)
    for name in ("PRETEST_Q", "PRETEST_W", "PRETEST_S"):
        monkeypatch.setattr(pk, name, 0.0)
    lost = sum(int((hit & ~pk.cyl_pretest_plain(rows[cl.long()], r8, rel))
                   .sum()) for rel in (T_MID_REL, -T_MID_REL))
    assert lost > 0
