"""The octet and stream modes of hairpt_torch's tiled intersector against
hairpt run as its own CPU tests run it (Pallas in interpret mode): kernel
A's octet output, the slot routing with octet words, kernel C's plain
version, the per-octet stream routing, kernel D's plain version, and
whole queries with octets=True and streams=True, including the stream
truncation case of tests/test_tiled.py (whose geometry helpers are copied
here: that module is in the slow tier)."""
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
from hairpt_torch.core.math import Ray
from hairpt_torch.ops import intersect_swept as tsw
from hairpt_torch.ops import intersect_tiled as ttl
from hairpt_torch.ops import tiled_kernels as tk
from test_torch_tiled import _grazing_pencil, _tied_inputs, assert_t_near_f64
from torch_threads import one_thread  # noqa: F401

K = 32

# t of the same cylinder test: XLA may contract the JAX kernel's
# multiply-adds into FMAs, the port rounds every operation, so t agrees
# to a few ulps; prim ids and hit flags are compared exactly. The kernel
# tests hold each side's t to a float64 evaluation instead
# (tests/test_torch_tiled.py assert_t_near_f64)
T_RTOL = 1e-6


def _layouts(a):
    """Both packages' cluster layouts of segment arrays a, with the JAX
    build's cluster order."""
    sw_j = jsw.build_swept_hair(*a, K=K)
    lo, hi = tsw.cluster_bounds(*a, K=K)
    corder = jbvh.build(lo, hi, leaf_size=1).prim_order
    sw_t = tsw.build_swept_hair(*a, K=K, cluster_order=corder, device="cpu")
    return sw_j, sw_t, int(sw_j.seg_rows.shape[0]) // K


def _rays(o, d, mint, maxt):
    o, d = np.asarray(o, np.float32), np.asarray(d, np.float32)
    mint, maxt = np.asarray(mint, np.float32), np.asarray(maxt, np.float32)
    return (JRay(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint),
                 jnp.asarray(maxt)),
            Ray(torch.as_tensor(o), torch.as_tensor(d),
                torch.as_tensor(mint), torch.as_tensor(maxt)))


def _geom_and_rays(n_fibers=400, n_rays=2048, seed=0):
    """tests/test_swept.py::_geom_and_rays: a furball and rays from a
    small patch towards random points around it (incoherent tiles)."""
    fs = hairgen.gen_furball(n_fibers=n_fibers, n_segs=8, radius=0.01,
                             seed=seed, center=(0, 0, 0), core_r=0.8,
                             fiber_len=1.0)
    segs = hairgen.segments(fs)
    a = [segs[k] for k in ("p0", "p1", "n0", "n1", "radius")]
    rng = np.random.default_rng(seed + 1)
    o = rng.uniform(-1, 1, (n_rays, 3)) * 0.5 + np.array([0, 0.2, -4.0])
    tgt = rng.uniform(-1.5, 1.5, (n_rays, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return a, _rays(o, d, np.zeros(n_rays), np.full(n_rays, np.inf))


def _adversarial_pencil(n_decoy=2000):
    """tests/test_tiled.py::_adversarial_pencil: one 64-ray tile of
    identical grazing rays down +x through 2000 decoy fibers whose boxes
    the rays enter but whose cylinders they miss; the only hit is a fiber
    at the far end. Returns (segment arrays, rays, x of the hit, its
    segment id)."""
    r = 0.01
    xs = 0.1 + 0.05 * np.arange(n_decoy)
    p0 = np.stack([xs, np.full_like(xs, -0.5),
                   np.full_like(xs, -1.5 * r)], -1)
    p1 = np.stack([xs, np.full_like(xs, 0.5),
                   np.full_like(xs, 5.0 * r)], -1)
    x_hit = 0.1 + 0.05 * n_decoy + 1.0
    p0 = np.concatenate([p0, [[x_hit, -0.5, 0.0]]]).astype(np.float32)
    p1 = np.concatenate([p1, [[x_hit, 0.5, 0.0]]]).astype(np.float32)
    axis = p1 - p0
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    n0 = n1 = axis.astype(np.float32)
    rad = np.full(len(p0), r, np.float32)
    n_rays = 64
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n_rays, 1))
    return ([p0, p1, n0, n1, rad],
            _rays(np.zeros((n_rays, 3)), d, np.zeros(n_rays),
                  np.full(n_rays, np.inf)), x_hit, len(p0) - 1)


@pytest.fixture(scope="module")
def geom():
    """60 fibers x 8 segments in C = 15 clusters of 32, and 512 rays in 8
    tiles from random origins to random targets (octets of one tile
    enter different clusters); every 5th ray has a finite maxt."""
    fs = hairgen.gen_furball(n_fibers=60, n_segs=8, radius=0.01, seed=0,
                             center=(0, 0, 0), core_r=0.8, fiber_len=1.0)
    s = hairgen.segments(fs)
    sw_j, sw_t, C = _layouts([s[k] for k in ("p0", "p1", "n0", "n1",
                                             "radius")])
    assert C == 15
    rs = np.random.default_rng(3)
    n = 512
    o = rs.uniform(-1, 1, (n, 3)) * 0.5 + np.array([0, 0.2, -4.0])
    d = rs.uniform(-1.2, 1.2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.full(n, np.inf)
    maxt[::5] = 4.0
    jr, tr = _rays(o, d, np.zeros(n), maxt)
    return sw_j, sw_t, jr, tr, C


def _bounds(sw_t):
    return torch.cat([sw_t.cl_lo.T, sw_t.cl_hi.T]).contiguous()


def _routed(sw_t, tr, C, q):
    """The port's plain phase A with octets, and the slot routing."""
    r8 = ttl.rays8_of(tr)
    te, tpm, oct = tk.cull_phase_a(r8, _bounds(sw_t), emit_oct=True)
    ks = ttl.KeySpace(C)
    return r8, te, tpm, oct, ks, ks.keys(te)


def _j(x):
    return jnp.asarray(x.numpy())


def test_plain_cull_octet_output_matches_jax(geom):
    """oct [T, C] of the plain cull equals both JAX forms exactly: the jnp
    _tile_cluster_mask and the Pallas cull_phase_a(emit_oct=True) in
    interpret mode (bounds padded to its 512-lane blocks)."""
    sw_j, sw_t, jr, tr, C = geom
    r8, te, tpm, oct, _, _ = _routed(sw_t, tr, C, 8)
    _, te_j, _, oct_j = jtl._tile_cluster_mask(sw_j, jr, 64)
    np.testing.assert_array_equal(oct.numpy(), np.asarray(oct_j))
    c_pad = jpt.CULL_CH
    b = np.full((8, c_pad), 3e37, np.float32)
    b[3:6] = -3e37
    b[0:3, :C] = sw_t.cl_lo.numpy().T
    b[3:6, :C] = sw_t.cl_hi.numpy().T
    te_p, tpm_p, oct_p = jpt.cull_phase_a(_j(r8), jnp.asarray(b),
                                          interpret=True, emit_oct=True)
    np.testing.assert_array_equal(oct.numpy(), np.asarray(oct_p)[:, :C])
    np.testing.assert_array_equal(te.float().numpy(),
                                  np.asarray(te_p.astype(jnp.float32))[:, :C])
    np.testing.assert_array_equal(tpm.numpy(), np.asarray(tpm_p))
    # octets of a tile differ: the skip bits carry information
    o = oct.numpy()
    assert ((o != 0) & (o != 255)).sum() > 10


def _tied_te(seed, T=40, C=37):
    """bf16 entry times on a coarse grid (many ties within a tile), a
    tile without candidates, and octet words with bits set only where
    the tile has a candidate."""
    rs = np.random.default_rng(seed)
    te = (rs.integers(0, 6, (T, C)) * 0.375 + 1.0).astype(np.float32)
    te[rs.random((T, C)) < 0.3] = np.inf
    te[3] = np.inf
    oct = rs.integers(1, 256, (T, C)).astype(np.int32)
    oct[~np.isfinite(te)] = 0
    oct[rs.random((T, C)) < 0.3] &= 0x0F
    return te, oct


def test_tile_slots_with_octet_words_match_jax():
    """_tile_slots(oct=...) against the JAX stable-sort routing with q = 6
    slots for up to 37 candidates: packed slots, counts, bounds, the
    per-slot octet words (0 for an empty slot) and the completion bound
    (te_last, cid_last, more), exactly."""
    q = 6
    te, oct = _tied_te(q)
    C = te.shape[1]
    te_bf = jnp.asarray(te).astype(jnp.bfloat16)
    mask = jnp.isfinite(te_bf)
    ref = jtl._tile_slots(mask, te_bf, q, return_bound=True,
                          oct=jnp.asarray(oct))
    ks = ttl.KeySpace(C)
    got = ttl._tile_slots(ks.keys(torch.as_tensor(te).to(torch.bfloat16)),
                          ks, q, oct=torch.as_tensor(oct))
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
    assert got[4] == int(ref[4]) > 0
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(ref[6]))
    key_last, more = got[5]
    te_l, cid_l, more_j = ref[5]
    m = more.numpy()
    np.testing.assert_array_equal(m, np.asarray(more_j))
    np.testing.assert_array_equal(ks.te_of(key_last).numpy()[m],
                                  np.asarray(te_l.astype(jnp.float32))[m])
    np.testing.assert_array_equal(ks.cid_of(key_last).numpy()[m],
                                  np.asarray(cid_l)[m])


@pytest.mark.parametrize("q,qo,w", [(16, 4, 4), (8, 8, 3), (16, 4, None)])
def test_octet_streams_match_jax(q, qo, w):
    """Every output of _octet_streams equals the JAX routing exactly:
    cluster ids, the eight streams (slot index | next bound << 12), the
    window offsets, counts, tmin, tscale, the overflow count and the
    completion bound triple. (16, 4, 4) truncates streams past qo and
    overflows slots; (8, 8, 3) only overflows slots, with windows that do
    not divide q; (16, 4, None) is the query's one-window form, equal to
    the JAX table with a window of q slots."""
    te, oct = _tied_te(100 + q + qo)
    C = te.shape[1]
    te_bf = jnp.asarray(te).astype(jnp.bfloat16)
    ref = jtl._octet_streams(jnp.isfinite(te_bf), te_bf, jnp.asarray(oct),
                             q, qo, q if w is None else w)
    ks = ttl.KeySpace(C)
    got = ttl._octet_streams(ks.keys(torch.as_tensor(te).to(torch.bfloat16)),
                             ks, torch.as_tensor(oct), q, qo, w)
    for i, name in enumerate(("cids", "streams", "off", "cnt", "tmin",
                              "tscale")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]),
                                      err_msg=name)
    assert got[6] == int(ref[6])
    key_last, more = got[7]
    te_l, cid_l, more_j = ref[7]
    m = more.numpy()
    np.testing.assert_array_equal(m, np.asarray(more_j))
    assert m.sum() > 0
    np.testing.assert_array_equal(ks.te_of(key_last).numpy()[m],
                                  np.asarray(te_l.astype(jnp.float32))[m])
    np.testing.assert_array_equal(ks.cid_of(key_last).numpy()[m],
                                  np.asarray(cid_l)[m])


def test_octet_streams_refuse_a_slot_index_past_12_bits():
    ks = ttl.KeySpace(8)
    key = torch.zeros((1, 8), dtype=ks.dtype)
    with pytest.raises(ValueError, match="12-bit"):
        ttl._octet_streams(key, ks, torch.zeros((1, 8), dtype=torch.int32),
                           4097, 256, 64)


def test_plain_phase_b_oct_matches_jax_kernel(geom):
    """Kernel C's plain version against _tiled_kernel_oct (interpret mode)
    on the same routed slots and octet words, q = 6 < C, in any-hit mode:
    the stop rule of that mode leaves real pids and the minimum t over
    the slots tested, both compared. (Closest-hit mode is compared
    through the whole octet query below; each JAX kernel compile in
    interpret mode costs about half a minute here.)"""
    sw_j, sw_t, jr, tr, C = geom
    q = 6
    r8, te, tpm, oct, ks, key = _routed(sw_t, tr, C, q)
    slots, cnt, tmin, tscale, ov, _, oct_sl = ttl._tile_slots(key, ks, q,
                                                              oct=oct)
    assert ov > 0
    t_j, p_j = jpt.tiled_phase_b(
        _j(slots), _j(cnt), _j(tmin), _j(tscale), _j(r8), _j(tpm),
        _j(sw_t.seg_rows_t), K, q, any_hit=True, interpret=True,
        oct=_j(oct_sl))
    t_t, p_t = tk.phase_b_oct(slots, cnt, tmin, tscale, oct_sl, r8, tpm,
                              sw_t.seg_rows_t, _bounds(sw_t), any_hit=True)
    p_j, t_j = np.asarray(p_j), np.asarray(t_j)
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    assert (p_j >= 0).sum() > 10
    assert_t_near_f64(sw_t.seg_rows_t, r8, p_j, port=t_t.numpy(), jax=t_j)


def test_plain_stream_phase_b_matches_jax_kernel(geom):
    """Kernel D's plain version against _stream_kernel (interpret mode,
    unroll 1) on the same streams, truncated at qo = 4 with windows of 4,
    in any-hit mode (real pids and the minimum t over the entries tested,
    both compared). The plain version checks its stop rule after every
    entry, as the JAX kernel does at unroll 1; the JAX kernel's default
    unroll 4 gives the same closest-hit result (the note in
    csrc/octets.cu says why; comparing at unroll 4 here would add about
    two minutes of XLA compile), and the closest-hit mode is compared
    through the whole stream query of the truncation test below."""
    sw_j, sw_t, jr, tr, C = geom
    q, qo, w = 12, 4, 4
    r8, te, tpm, oct, ks, key = _routed(sw_t, tr, C, q)
    cids, strm, off, cnt, tmin, tscale, ov, _ = ttl._octet_streams(
        key, ks, oct, q, qo, w)
    assert ov > 0
    t_t, p_t = tk.stream_phase_b(cids, strm, off, cnt, tmin, tscale, r8,
                                 tpm, sw_t.seg_rows_t, _bounds(sw_t),
                                 any_hit=True)
    t_j, p_j = jpt.stream_phase_b(
        _j(cids), _j(strm), _j(off), _j(cnt), _j(tmin), _j(tscale),
        _j(r8), _j(tpm), _j(sw_t.seg_rows_t), K, q, qo, w, any_hit=True,
        interpret=True, unroll=1)
    p_j, t_j = np.asarray(p_j), np.asarray(t_j)
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    assert (p_j >= 0).sum() > 10
    assert_t_near_f64(sw_t.seg_rows_t, r8, p_j, port=t_t.numpy(), jax=t_j)


def test_octet_query_matches_jax(geom):
    """A whole closest-hit query with octets=True and q = 6 < C = 15 (the
    completion loop runs) equals the JAX query (impl='interpret'); the
    octet closest and any-hit queries equal the port's dense ones, which
    tests/test_torch_tiled.py holds to the JAX package."""
    sw_j, sw_t, jr, tr, C = geom
    ttl.STATS["max_passes"] = 0
    t_j, p_j, ov = jtl.tiled_closest_hit(sw_j, jr, C, K, q_max=6,
                                         impl="interpret",
                                         return_overflow=True, octets=True)
    t_t, p_t = ttl.tiled_closest_hit(sw_t, tr, q_max=6, octets=True)
    assert int(ov) > 0
    assert ttl.STATS["max_passes"] > 1
    p_j = np.asarray(p_j)
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    hit = p_j >= 0
    assert hit.sum() > 20
    np.testing.assert_allclose(t_t.numpy()[hit], np.asarray(t_j)[hit],
                               rtol=T_RTOL)
    t_d, p_d = ttl.tiled_closest_hit(sw_t, tr, q_max=6)
    np.testing.assert_array_equal(p_t.numpy(), p_d.numpy())
    np.testing.assert_array_equal(t_t.numpy(), t_d.numpy())
    np.testing.assert_array_equal(
        ttl.tiled_any_hit(sw_t, tr, q_max=6, octets=True).numpy(),
        ttl.tiled_any_hit(sw_t, tr, q_max=6).numpy())


@pytest.mark.parametrize("qo", [4, 8, None])
def test_stream_queries_match_the_dense_query(geom, qo):
    """Stream queries with q = 6 < C (slot overflow; qo 4 also truncates
    streams) give the port's dense closest and any-hit answers exactly;
    streams run at K = 32, which the JAX package sends to the dense
    kernel on a TPU only (a Mosaic DMA limit)."""
    sw_j, sw_t, jr, tr, C = geom
    kw = dict(streams=True, stream_qo=qo)
    t_s, p_s = ttl.tiled_closest_hit(sw_t, tr, q_max=6, **kw)
    t_d, p_d = ttl.tiled_closest_hit(sw_t, tr, q_max=6)
    np.testing.assert_array_equal(p_s.numpy(), p_d.numpy())
    np.testing.assert_array_equal(t_s.numpy(), t_d.numpy())
    assert (p_d.numpy() >= 0).sum() > 20
    np.testing.assert_array_equal(
        ttl.tiled_any_hit(sw_t, tr, q_max=6, **kw).numpy(),
        ttl.tiled_any_hit(sw_t, tr, q_max=6).numpy())


def test_streams_truncation_exact_completion():
    """tests/test_tiled.py::test_streams_truncation_exact_completion on the
    port: the adversarial pencil with q_max 8, stream_qo 4 (slot overflow
    and stream truncation, 16 completion passes) finds the one far hit in
    closest and any-hit mode, and the closest hit equals the JAX query's
    (impl='interpret', stream_w 4 as in that test, stream_unroll 1 to keep
    its compile short; the port has neither TPU option)."""
    a, (jr, tr), x_hit, hit_seg = _adversarial_pencil()
    sw_j, sw_t, C = _layouts(a)
    assert C > 8
    kw = dict(q_max=8, streams=True, stream_qo=4)
    ttl.STATS.update(max_passes=0, overflow_tiles=0)
    t_t, p_t = ttl.tiled_closest_hit(sw_t, tr, **kw)
    assert ttl.STATS["overflow_tiles"] > 0
    assert ttl.STATS["max_passes"] > C // 8
    np.testing.assert_allclose(t_t.numpy(), x_hit - 0.01, atol=1e-3)
    assert np.all(p_t.numpy() == hit_seg)
    assert bool(ttl.tiled_any_hit(sw_t, tr, **kw).all())
    t_j, p_j = jtl.tiled_closest_hit(sw_j, jr, C, K, impl="interpret",
                                     stream_w=4, stream_unroll=1, **kw)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=T_RTOL)


def test_streams_on_random_geometry_match_large_q():
    """The second half of test_streams_truncation_exact_completion: on
    random geometry (300 fibers, 1024 rays) a sorted and compacted stream
    query with tiny caps (q 16, qo 8) gives the hit flags
    and t of the dense query at q = 192 exactly (the same segments are
    tested with the same arithmetic; only the order differs)."""
    a, (jr, tr) = _geom_and_rays(n_fibers=300, n_rays=1024)
    sw_j, sw_t, C = _layouts(a)
    t_b, p_b = ttl.tiled_closest_hit(sw_t, tr, q_max=192)
    ttl.STATS["overflow_tiles"] = 0
    t_s, p_s = ttl.tiled_closest_hit(sw_t, tr, q_max=16, streams=True,
                                     stream_qo=8, sort_rays=True)
    assert ttl.STATS["overflow_tiles"] > 0
    np.testing.assert_array_equal(p_s.numpy() >= 0, p_b.numpy() >= 0)
    np.testing.assert_array_equal(t_s.numpy(), t_b.numpy())
    assert (p_s.numpy() == p_b.numpy()).mean() > 0.999
    assert (p_b.numpy() >= 0).sum() > 100


def test_octet_wrappers_run_plain_versions_on_cpu(geom):
    sw_j, sw_t, jr, tr, C = geom
    tk.reset_counts()
    ttl.tiled_closest_hit(sw_t, tr, q_max=6, octets=True)
    ttl.tiled_closest_hit(sw_t, tr, q_max=6, streams=True)
    assert set(tk.OCT_LAUNCHES.values()) == {0}
    assert set(tk.OCT_PLAIN_ON_CUDA.values()) == {0}


def test_plain_stream_work_counts_each_block_once_per_tile(geom):
    """The work kernel D's plain version reports: per tile, the distinct
    slots the octets walk (a cluster walked by several octets counts
    once), so at most the entries walked and at least one where the tile
    has a stream, and 8 (ray, cluster) tests per entry."""
    sw_j, sw_t, jr, tr, C = geom
    q, qo = 12, 4
    r8, te, tpm, oct, ks, key = _routed(sw_t, tr, C, q)
    sargs = ttl._octet_streams(key, ks, oct, q, qo)[:6]
    _, _, blocks, tests = tk.stream_phase_b_plain(
        *sargs, r8, tpm, sw_t.seg_rows_t, return_work=True)
    entries = tests // 8
    assert torch.all(tests % 8 == 0)
    assert torch.all(blocks <= entries)
    assert torch.all(blocks <= q)
    has_stream = sargs[2][:, -1, :].amax(dim=1) > 0
    assert torch.all((blocks > 0) == has_stream)
    assert int((blocks < entries).sum()) > 0


# ---------------------------------------------------------------------------
# kernels C and D as the card runs them (csrc/octets.cu), on the CPU: the
# per-(ray, slot) or per-(ray, entry) box cull, the per-warp records and
# their merge, transcribed in torch and held to the plain versions
# ---------------------------------------------------------------------------

TILE = tk.TILE


def _merge_records(t_m, pid_row, act, groups):
    """The kernels' reduction of one slot for each ray: the lanes (last
    dim of t_m [n, L, K]) of the active rays are split into `groups` (each
    a record: a warp of kernel C, a lane's segment lanes in kernel D),
    each record keeps its minimum t and the largest pid at it, and the
    records merge the same way. Returns (st [n, L], sp [n, L])."""
    inf = float("inf")
    n, L, K_ = t_m.shape
    tg = torch.where(act[..., None], t_m, inf).view(n, L, *groups)
    pg = pid_row.view(n, 1, *groups).expand(n, L, *groups)
    rmin = tg.amin(dim=-1)
    rpid = torch.where(torch.isfinite(tg) & (tg == rmin[..., None]), pg,
                       -1).amax(dim=-1)
    st = rmin.amin(dim=-1)
    sp = torch.where(torch.isfinite(rmin) & (rmin == st[..., None]), rpid,
                     -1).amax(dim=-1)
    return st, sp


def _kernel_c_model(slots, cnt, tmin, tscale, oct_slot, rays8, t_pmax,
                    seg_rows, bounds, any_hit, skip_held=False):
    """csrc/octets.cu phase_b_oct_kernel transcribed slot by slot: a ray
    is active where its octet's bit is set and it passes the box cull
    (slot_cull_plain up to min(maxt, best), both modes); each warp of 32
    segment lanes writes (its minimum t, the largest pid at it) for each
    active ray; the records merge by minimum t, then largest pid, and
    replace the ray's result on a strictly smaller t; the tile stops
    after every slot. skip_held adds kernel B's any-hit rule (a ray
    holding a hit is not tested), which kernel C must not take. Returns
    (t, pid, (ray, slot) pairs passing the cull per tile)."""
    T, K_ = slots.shape[0], seg_rows.shape[2]
    best = torch.full((T, TILE), float("inf"))
    pid = torch.full((T, TILE), -1, dtype=torch.int32)
    octet = torch.arange(TILE) // 8
    cnt_l = cnt.long()
    active = cnt_l > 0
    pairs = torch.zeros(T, dtype=torch.int64)
    for s in range(int(cnt_l.max())):
        idx = torch.nonzero(active & (s < cnt_l)).squeeze(1)
        if idx.numel() == 0:
            break
        cid = (slots[idx, s] & tk.CID_MASK).long()
        r8, b = rays8[idx], best[idx]
        bit = ((oct_slot[idx, s][:, None] >> octet) & 1).bool()
        act = bit & tk.slot_cull_plain(r8, bounds[:3, cid].T,
                                       bounds[3:, cid].T,
                                       torch.minimum(r8[:, 7], b))
        if skip_held and any_hit:
            act = act & ~torch.isfinite(b)
        pairs[idx] += act.sum(dim=1)
        st, sp = _merge_records(*tk.cyl_test(seg_rows[cid], r8), act,
                                (K_ // 32, 32))
        better = st < b
        best[idx] = torch.where(better, st, b)
        pid[idx] = torch.where(better, sp, pid[idx])
        te_next = tk._dequant((slots[idx, s] >> 20) & tk.TE_INF, tmin[idx],
                              tscale[idx])
        done = tk._done(best[idx], te_next[:, None], t_pmax[idx],
                        any_hit).all(dim=1)
        active[idx[done]] = False
    return best, pid, pairs


def _kernel_d_model(cids, streams, off, cnt, tmin, tscale, rays8, t_pmax,
                    seg_rows, bounds, any_hit):
    """csrc/octets.cu stream_kernel transcribed entry by entry: per (tile,
    octet), rays 0..7 of the octet pass the entry's box cull
    (slot_cull_plain up to min(maxt, best)); lane l of the octet's warp
    tests segment lanes l, l + 32, .. against each active ray and keeps
    (its minimum t, the largest pid at it); the warp reduces the 32 lanes
    the same way and replaces the ray's result on a strictly smaller t;
    the octet stops after every entry. Returns (t, pid, (ray, entry)
    pairs passing the cull per tile)."""
    T, K_ = cids.shape[0], seg_rows.shape[2]
    length = off[:, -1, :].long()
    best = torch.full((T, 8, 8), float("inf"))
    pid = torch.full((T, 8, 8), -1, dtype=torch.int32)
    r8o = rays8.view(T, 8, 8, 8)                       # [T, comp, oct, lane]
    tpm = t_pmax.view(T, 8, 8)
    done = torch.zeros((T, 8), dtype=torch.bool)
    pairs = torch.zeros(T, dtype=torch.int64)
    for j in range(int(length.max())):
        it, io = torch.nonzero(~done & (j < length), as_tuple=True)
        if it.numel() == 0:
            break
        e = streams[it, io, j]
        cid = (cids[it, (e & ((1 << tk.QBITS) - 1)).long()]
               & tk.CID_MASK).long()
        r8, b = r8o[it, :, io, :], best[it, io]
        act = tk.slot_cull_plain(r8, bounds[:3, cid].T, bounds[3:, cid].T,
                                 torch.minimum(r8[:, 7], b))
        pairs.index_add_(0, it, act.sum(dim=1))
        t_m, pid_row = tk.cyl_test(seg_rows[cid], r8)
        # [n, 8, K] -> per lane l: segment lanes u * 32 + l
        st, sp = _merge_records(
            t_m.view(-1, 8, K_ // 32, 32).transpose(2, 3).reshape(t_m.shape),
            pid_row.view(-1, 1, K_ // 32, 32).transpose(2, 3)
            .reshape(pid_row.shape), act, (32, K_ // 32))
        better = st < b
        best[it, io] = torch.where(better, st, b)
        pid[it, io] = torch.where(better, sp, pid[it, io])
        te_next = tk._dequant((e >> tk.QBITS) & tk.TE_INF, tmin[it],
                              tscale[it])
        done[it, io] = tk._done(best[it, io], te_next[:, None], tpm[it, io],
                                any_hit).all(dim=1)
    return best.view(T, TILE), pid.view(T, TILE), pairs


def _streams_of(slots, cnt, oct_slot, qo, seed):
    """Kernel D's inputs over a slot list: octet o's stream holds, in slot
    order, the slots whose octet word has bit o (at most qo), each with a
    random increasing 12-bit bound (4095 on the last)."""
    rs = np.random.default_rng(seed)
    T, q = slots.shape
    streams = np.full((T, 8, qo), tk.TE_INF << tk.QBITS, np.int64)
    off = np.zeros((T, 2, 8), np.int32)
    words = oct_slot.numpy()
    for t in range(T):
        for o in range(8):
            ent = [s for s in range(int(cnt[t])) if (words[t, s] >> o) & 1]
            ent = ent[:qo]
            bq = np.sort(rs.integers(0, 4095, len(ent)))
            if ent:
                bq[-1] = tk.TE_INF
            streams[t, o, :len(ent)] = np.array(ent, np.int64) \
                | (bq.astype(np.int64) << tk.QBITS)
            off[t, 1, o] = len(ent)
    return ((slots & tk.CID_MASK).contiguous(),
            torch.as_tensor(streams.astype(np.int32)), torch.as_tensor(off))


@pytest.fixture(scope="module")
def cd_cases(geom):
    """Kernel C's and D's inputs, (C args, D args): 'geom' (the routed
    geom rays, q = 6 < C, streams truncated at qo = 4), 'random' (300
    fibers, 1024 incoherent rays, q = 16, qo = 8), 'tied' (tests/
    test_torch_tiled.py's _tied_inputs: lanes and slots at equal t, with
    random octet words; 'tied_k128' the same over K = 128 lanes, four
    records per ray in kernel C and four segment lanes per lane in D) and
    'pencil' (rays grazing a fiber exactly on a
    face of its box, each tile's one cluster holding only that fiber,
    so the cluster box is the fiber's exact box)."""
    cases = {}
    sw_j, sw_t, jr, tr, C = geom
    a, (_, tr_r) = _geom_and_rays(n_fibers=300, n_rays=1024)
    sw_r = tsw.build_swept_hair(*a, K=K, device="cpu")
    for name, sw, ray, q, qo in (("geom", sw_t, tr, 6, 4),
                                 ("random", sw_r, tr_r, 16, 8)):
        Cn = sw.cl_lo.shape[0]
        r8, te, tpm, oct, ks, key = _routed(sw, ray, Cn, q)
        slots, cnt, tmin, tscale, _, _, oct_sl = ttl._tile_slots(
            key, ks, q, oct=oct)
        sargs = ttl._octet_streams(key, ks, oct, q, qo)[:6]
        b = _bounds(sw)
        cases[name] = ((slots, cnt, tmin, tscale, oct_sl, r8, tpm,
                        sw.seg_rows_t, b),
                       sargs + (r8, tpm, sw.seg_rows_t, b))
    fs = hairgen.gen_furball(n_fibers=60, n_segs=8, radius=0.01, seed=0,
                             center=(0, 0, 0), core_r=0.8, fiber_len=1.0)
    sg = hairgen.segments(fs)
    sw_128 = tsw.build_swept_hair(*[sg[k] for k in ("p0", "p1", "n0", "n1",
                                                    "radius")],
                                  K=128, device="cpu")
    for name, sw, seed in (("tied", sw_t, 11), ("tied_k128", sw_128, 21)):
        slots, cnt, tmin, tscale, r8, tpm, rows, b = _tied_inputs(sw)
        rs = np.random.default_rng(seed)
        if name == "tied_k128":
            # lanes l and l + 32 of one kernel-D lane tie too
            rn = rows.numpy().copy()
            for j in range(rn.shape[0]):
                for l in rs.choice(32, 12, replace=False):
                    rn[j, :, l + 32] = rn[j, :, l]
                    if rn[j, 15, l].view(np.int32) >= 0:
                        rn[j, 15, l + 32] = np.int32(rs.integers(50, 99)) \
                            .view(np.float32)
            rows = torch.as_tensor(rn)
        words = rs.integers(0, 256, slots.shape)
        words[rs.random(slots.shape) < 0.2] = 0
        words[rs.random(slots.shape) < 0.2] = 255
        oct_sl = torch.as_tensor(words.astype(np.int32))
        cases[name] = ((slots, cnt, tmin, tscale, oct_sl, r8, tpm, rows, b),
                       _streams_of(slots, cnt, oct_sl, 16, seed + 1)
                       + (cnt, tmin, tscale, r8, tpm, rows, b))
    rows, r8, lo, hi, ln = _grazing_pencil()
    n = rows.shape[0]
    rows = rows.clone()
    ids = rows[:, 15].contiguous().view(torch.int32)
    keep = torch.arange(K)[None, :] == ln[:, None]
    rows[:, 15] = torch.where(keep, ids, -1).view(torch.float32)
    b = torch.cat([lo.T, hi.T]).contiguous()
    slots = torch.arange(n, dtype=torch.int32)[:, None] \
        | torch.tensor(tk.TE_INF << 20, dtype=torch.int64).to(torch.int32)
    cnt = torch.ones(n, dtype=torch.int32)
    tmin, tscale = torch.ones(n), torch.full((n,), 1e-3)
    tpm = tk.cull_phase_a_plain(r8, b)[1]
    oct_sl = torch.full((n, 1), 255, dtype=torch.int32)
    cases["pencil"] = ((slots, cnt, tmin, tscale, oct_sl, r8, tpm, rows, b),
                       _streams_of(slots, cnt, oct_sl, 1, 13)
                       + (cnt, tmin, tscale, r8, tpm, rows, b))
    return cases


CD_CASES = ["geom", "random", "tied", "tied_k128", "pencil"]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", CD_CASES)
def test_kernel_c_transcription_equals_plain(cd_cases, case, any_hit):
    """Kernel C as the card runs it (box cull ANDed with the octet bit,
    per-warp records, their merge, a stop check after every slot) gives
    phase_b_oct_plain's t and pid exactly, in both modes; its cull skips
    pairs the octet bits leave."""
    args = cd_cases[case][0]
    t_p, p_p, _, tests = tk.phase_b_oct_plain(*args[:8], any_hit,
                                              return_work=True)
    t_m, p_m, pairs = _kernel_c_model(*args, any_hit)
    np.testing.assert_array_equal(t_m.numpy(), t_p.numpy())
    np.testing.assert_array_equal(p_m.numpy(), p_p.numpy())
    assert int((p_p >= 0).sum()) > (60 if case == "pencil" else 20)
    assert 0 < int(pairs.sum()) <= int(tests.sum())
    if case != "pencil":
        assert int(pairs.sum()) < int(tests.sum())


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", CD_CASES)
def test_kernel_d_transcription_equals_plain(cd_cases, case, any_hit):
    """Kernel D as the card runs it (per-entry box cull of the octet's
    rays, per-lane then per-warp (minimum t, largest pid) reduction, a
    stop check after every entry) gives stream_phase_b_plain's t and pid
    exactly, in both modes."""
    args = cd_cases[case][1]
    t_p, p_p, _, tests = tk.stream_phase_b_plain(*args[:9], any_hit,
                                                 return_work=True)
    t_m, p_m, pairs = _kernel_d_model(*args, any_hit)
    np.testing.assert_array_equal(t_m.numpy(), t_p.numpy())
    np.testing.assert_array_equal(p_m.numpy(), p_p.numpy())
    assert int((p_p >= 0).sum()) > (60 if case == "pencil" else 20)
    assert 0 < int(pairs.sum()) <= int(tests.sum())


def test_kernel_c_cull_needs_its_margin_on_the_pencil(cd_cases, monkeypatch):
    """Without BOX_PAD the box cull drops grazing hits of the pencil: the
    transcriptions of C and D then lose hits the plain versions find."""
    c_args, d_args = cd_cases["pencil"]
    n_c = int((tk.phase_b_oct_plain(*c_args[:8])[1] >= 0).sum())
    n_d = int((tk.stream_phase_b_plain(*d_args[:9])[1] >= 0).sum())
    monkeypatch.setattr(tk, "BOX_PAD", 0.0)
    assert int((_kernel_c_model(*c_args, False)[1] >= 0).sum()) < n_c
    assert int((_kernel_d_model(*d_args, False)[1] >= 0).sum()) < n_d


def test_kernel_b_any_hit_rule_would_change_kernel_c(cd_cases):
    """Kernel B drops a ray from its cull once it holds a hit (any-hit
    mode). Kernel C must not: its rays go on testing, a later slot's
    smaller t replaces the hit, and the pid is that hit's. With B's rule
    the transcription's any-hit t or pid differs from phase_b_oct_plain;
    the hit flags stay the same."""
    args = cd_cases["tied"][0]
    t_p, p_p = tk.phase_b_oct_plain(*args[:8], True)
    t_m, p_m, _ = _kernel_c_model(*args, True, skip_held=True)
    np.testing.assert_array_equal(p_m.numpy() >= 0, p_p.numpy() >= 0)
    n_diff = int(((t_m != t_p) | (p_m != p_p)).sum())
    assert n_diff > 0
    t_k, p_k, _ = _kernel_c_model(*args, True)
    np.testing.assert_array_equal(t_k.numpy(), t_p.numpy())
    np.testing.assert_array_equal(p_k.numpy(), p_p.numpy())


def test_octet_wrappers_refuse_pair_counts_on_cpu(cd_cases):
    c_args, d_args = cd_cases["tied"]
    pairs = torch.zeros(c_args[0].shape[0], dtype=torch.int32)
    with pytest.raises(ValueError, match="cull"):
        tk.phase_b_oct(*c_args, pairs_out=pairs)
    with pytest.raises(ValueError, match="cull"):
        tk.stream_phase_b(*d_args, pairs_out=pairs)
