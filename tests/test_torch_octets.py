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

K = 32

# t of the same cylinder test: XLA may contract the JAX kernel's
# multiply-adds into FMAs, the port rounds every operation, so t agrees
# to a few ulps; prim ids and hit flags are compared exactly
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
                              sw_t.seg_rows_t, any_hit=True)
    p_j, t_j = np.asarray(p_j), np.asarray(t_j)
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    hit = p_j >= 0
    assert hit.sum() > 10
    np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], rtol=T_RTOL)


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
                                 tpm, sw_t.seg_rows_t, any_hit=True)
    t_j, p_j = jpt.stream_phase_b(
        _j(cids), _j(strm), _j(off), _j(cnt), _j(tmin), _j(tscale),
        _j(r8), _j(tpm), _j(sw_t.seg_rows_t), K, q, qo, w, any_hit=True,
        interpret=True, unroll=1)
    p_j, t_j = np.asarray(p_j), np.asarray(t_j)
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    hit = p_j >= 0
    assert hit.sum() > 10
    np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], rtol=T_RTOL)


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
