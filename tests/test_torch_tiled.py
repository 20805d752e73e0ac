"""hairpt_torch tiled intersector against hairpt run as its own CPU tests
run it (Pallas in interpret mode): the plain phase A and phase B, the
slot routing with tied bf16 entry times, and whole queries with q smaller
than the cluster count, so the exact-overflow completion loop runs."""
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
N_RAYS = 256


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


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_phase_b_matches_jax_kernel(geom, any_hit):
    """The plain phase B against the JAX Pallas kernel (interpret mode,
    deferred unroll-8 path) on the same routed slots; q = 6 < C."""
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
                          sw_t.seg_rows_t, any_hit=any_hit)
    p_j, t_j = np.asarray(p_j), np.asarray(t_j)
    if any_hit:
        np.testing.assert_array_equal(p_t.numpy() >= 0, p_j >= 0)
    else:
        np.testing.assert_array_equal(p_t.numpy(), p_j)
        hit = p_j >= 0
        assert hit.sum() > 10
        # XLA may contract multiply-adds of the cylinder test into FMAs;
        # the port rounds every operation: t agrees to a few ulps
        np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], rtol=1e-6)


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
