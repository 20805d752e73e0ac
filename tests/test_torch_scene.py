"""hairpt_torch host-side scene build against hairpt: fiber generation,
the cluster layout, the BVH prim order, the baked sunsky and its alias
table, the environment queries, the camera and the film."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hairpt.film import film as jfilm
from hairpt.integrators import common as jcommon
from hairpt.models import emitters as jem
from hairpt.models import sensors as jsens
from hairpt.ops import bvh as jbvh
from hairpt.ops import intersect_swept as jsw
from hairpt.scene import hairgen as jh
from hairpt_torch.film import film as tfilm
from hairpt_torch.integrators import common as tcommon
from hairpt_torch.models import emitters as tem
from hairpt_torch.models import sensors as tsens
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.ops import intersect_swept as tsw
from hairpt_torch.scene import hairgen as th
from torch_threads import one_thread  # noqa: F401

SUN = dict(sun_dir=(-0.376047, 0.758426, 0.532333), turbidity=3.0,
           sky_scale=5.0, sun_scale=19.0912, sun_radius_scale=37.9165,
           res=32)


def _segs(n_fibers=300):
    s = jh.segments(jh.gen_furball(n_fibers=n_fibers))
    return [s[k] for k in ("p0", "p1", "n0", "n1", "radius")]


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def test_gen_furball_and_segments_equal():
    fj = jh.gen_furball(n_fibers=250, seed=4)
    ft = th.gen_furball(n_fibers=250, seed=4)
    np.testing.assert_array_equal(ft.vertices, fj.vertices)
    np.testing.assert_array_equal(ft.vertex_starts_fiber,
                                  fj.vertex_starts_fiber)
    sj, st = jh.segments(fj), th.segments(ft)
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k])


@pytest.mark.parametrize("K", [32, 128])
def test_build_swept_hair_equal_given_cluster_order(K):
    """Same segment order and the JAX build's cluster order -> seg_rows_t,
    cl_lo/hi and sub_lo/hi bit for bit (row 15 holds int ids whose -1
    padding is a NaN pattern, so the comparison is on the bits)."""
    a = _segs()
    ref = jsw.build_swept_hair(*a, K=K)
    lo, hi = tsw.cluster_bounds(*a, K=K)
    corder = jbvh.build(lo, hi, leaf_size=1).prim_order
    got = tsw.build_swept_hair(*a, K=K, cluster_order=corder,
                              device="cpu")
    for f in ("cl_lo", "cl_hi", "seg_rows_t", "sub_lo", "sub_hi"):
        np.testing.assert_array_equal(_bits(getattr(got, f).numpy()),
                                      _bits(getattr(ref, f)), err_msg=f)


@pytest.mark.parametrize("prefer_sah", [True, False])
def test_bvh_prim_order_is_a_permutation(prefer_sah):
    """The port's own builds (its g++ SAH library and the numpy LBVH):
    valid permutations with every prim inside its leaf's box."""
    a = _segs(200)
    lo = np.minimum(a[0], a[1]) - 0.01
    hi = np.maximum(a[0], a[1]) + 0.01
    fb = tbvh.build(lo, hi, prefer_sah=prefer_sah)
    n = len(lo)
    np.testing.assert_array_equal(np.sort(fb.prim_order), np.arange(n))
    leaf = np.nonzero(fb.node_count >= 0)[0]
    for i in leaf:
        s, c = fb.node_left[i], fb.node_count[i]
        prims = fb.prim_order[s:s + c]
        assert np.all(lo[prims] >= fb.node_min[i] - 1e-6)
        assert np.all(hi[prims] <= fb.node_max[i] + 1e-6)
    sw_own = tsw.build_swept_hair(*a, K=32, device="cpu")
    C = sw_own.seg_rows_t.shape[0]
    ids = sw_own.seg_rows_t[:, 15].contiguous().view(torch.int32).reshape(-1)
    ids = ids[ids >= 0].numpy()
    np.testing.assert_array_equal(np.sort(ids), np.arange(len(a[0])))
    assert C * 32 >= len(a[0])


def test_bake_sunsky_and_alias_table_equal():
    ej = jem.bake_sunsky(**SUN)
    et = tem.bake_sunsky(**SUN, device="cpu")
    for f in ("image", "to_world", "to_local", "alias_prob", "texel_pdf"):
        np.testing.assert_array_equal(getattr(et, f).numpy(),
                                      np.asarray(getattr(ej, f)), err_msg=f)
    np.testing.assert_array_equal(et.alias_idx.numpy(),
                                  np.asarray(ej.alias_idx))
    w = np.random.default_rng(0).random(999) ** 3
    for x, y in zip(tem._build_alias_table(w), jem._build_alias_table(w)):
        np.testing.assert_array_equal(x, y)


def test_env_queries_match_jax():
    ej = jem.bake_sunsky(**SUN)
    et = tem.bake_sunsky(**SUN, device="cpu")
    rs = np.random.default_rng(1)
    d = rs.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u2 = rs.random((4096, 2)).astype(np.float32)
    np.testing.assert_allclose(tem.env_eval(et, torch.as_tensor(d)).numpy(),
                               np.asarray(jem.env_eval(ej, jnp.asarray(d))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tem.env_pdf(et, torch.as_tensor(d)).numpy(),
                               np.asarray(jem.env_pdf(ej, jnp.asarray(d))),
                               rtol=1e-5)
    for x, y in zip(tem.env_sample(et, torch.as_tensor(u2)),
                    jem.env_sample(ej, jnp.asarray(u2))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-6)


def test_camera_rays_and_film_match_jax():
    ctw = np.array([[-0.704024, 0.0939171, 0.703939, -10.6677],
                    [1.05829e-08, 0.991217, -0.132245, 14.3141],
                    [-0.710177, -0.0931033, -0.69784, 10.2879],
                    [0, 0, 0, 1]])
    cj = jsens.Camera.perspective(ctw, 35.0, 48, 32)
    ct = tsens.Camera.perspective(ctw, 35.0, 48, 32)
    pos = np.random.default_rng(2).random((2000, 2)).astype(np.float32) \
        * np.array([48, 32], np.float32)
    rj = jsens.sample_ray(cj, jnp.asarray(pos))
    rt = tsens.sample_ray(ct, torch.as_tensor(pos))
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6,
                                   atol=2e-6)
    val = np.random.default_rng(3).random((2000, 3)).astype(np.float32)
    fj = jfilm.Film.make(48, 32, "tent")
    ft = tfilm.Film.make(48, 32, "tent")
    img_j, w_j = jfilm.splat_samples(fj, jnp.asarray(pos), jnp.asarray(val),
                                     *jfilm.zeros(fj))
    img_t, w_t = tfilm.splat_samples(ft, torch.as_tensor(pos),
                                     torch.as_tensor(val),
                                     *tfilm.zeros(ft, "cpu"))
    np.testing.assert_allclose(tfilm.develop(img_t, w_t).numpy(),
                               np.asarray(jfilm.develop(img_j, w_j)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tcommon.block_swizzle(48, 32),
                                  jcommon.block_swizzle(48, 32))
