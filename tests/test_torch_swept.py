"""The swept traversal of hairpt_torch against hairpt run as its own CPU
tests run it: the dense phase A in both of its branches, kernel E's plain
version against phase_b_pallas in interpret mode, the pair routing and
whole swept queries against swept_closest_hit(impl='pallas'), and a small
furball rendered with traversal='swept' through both packages."""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hairpt.core import rng as jrng
from hairpt.core.math import Ray as JRay
from hairpt.film.film import Film as JFilm
from hairpt.integrators import path as jpath
from hairpt.models import emitters as jem
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.ops import bvh as jbvh
from hairpt.ops import intersect_swept as jsw
from hairpt.ops import pallas_phaseb as jpp
from hairpt.scene import hairgen
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import convert
from hairpt_torch.core.math import Ray
from hairpt_torch.film.film import Film
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models.sensors import Camera
from hairpt_torch.ops import intersect_swept as tsw
from hairpt_torch.ops import phaseb_kernels as pk
from hairpt_torch.scene.scene import SceneBuilder
from torch_threads import one_thread  # noqa: F401

K = 32

# t of the same cylinder test: XLA may contract the JAX kernel's
# multiply-adds into FMAs, the port rounds every operation, so t agrees
# to a few ulps; prim ids and hit flags are compared exactly
T_RTOL = 1e-6


@pytest.fixture(scope="module")
def geom():
    """60 fibers x 8 segments in C = 15 clusters of 32, both packages'
    layouts with the same cluster order, and 512 rays: half from outside
    the fur towards it, half from points inside it in random directions
    (they start inside several boxes, whose entry t is then 0); every 5th
    ray has a finite maxt and every 9th is dead (maxt <= mint)."""
    fs = hairgen.gen_furball(n_fibers=60, n_segs=8, radius=0.01, seed=0,
                             center=(0, 0, 0), core_r=0.8, fiber_len=1.0)
    s = hairgen.segments(fs)
    a = [s[k] for k in ("p0", "p1", "n0", "n1", "radius")]
    sw_j = jsw.build_swept_hair(*a, K=K)
    lo, hi = tsw.cluster_bounds(*a, K=K)
    corder = jbvh.build(lo, hi, leaf_size=1).prim_order
    sw_t = tsw.build_swept_hair(*a, K=K, cluster_order=corder, device="cpu")
    C = int(sw_j.seg_rows.shape[0]) // K
    assert C == 15
    rs = np.random.default_rng(5)
    n = 512
    o = rs.uniform(-1, 1, (n, 3)) * 0.5 + np.array([0, 0.2, -4.0])
    d = rs.uniform(-1.2, 1.2, (n, 3)) - o
    o[n // 2:] = rs.uniform(-1.0, 1.0, (n // 2, 3))
    d[n // 2:] = rs.normal(size=(n // 2, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.full(n, np.inf)
    maxt[::5] = 1.5
    maxt[::9] = 0.0
    o, d = o.astype(np.float32), d.astype(np.float32)
    mint = np.zeros(n, np.float32)
    maxt = maxt.astype(np.float32)
    jr = JRay(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint),
              jnp.asarray(maxt))
    tr = Ray(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(mint),
             torch.as_tensor(maxt))
    return sw_j, sw_t, jr, tr, C


@pytest.mark.parametrize("p_max,c_chunk", [(3, 1024), (24, 1024), (3, 4),
                                           (8, 4), (24, 4)])
def test_phase_a_dense_matches_jax_in_both_branches(geom, p_max, c_chunk):
    """C = 15 <= c_chunk takes the masked-minimum branch (the p_max lowest
    cluster ids); c_chunk = 4 < C takes the top_k branch (the p_max
    nearest, lower id first on equal entry t). Slots and counts equal
    the JAX function exactly, with rays that enter more than p_max boxes
    (p_max 3 and 8) or fewer slots than p_max exist (p_max 24 > C), and
    rays that enter several boxes at t = 0."""
    sw_j, sw_t, jr, tr, C = geom
    s_j, c_j = jsw._phase_a_dense(sw_j, jr, p_max, c_chunk=c_chunk)
    s_t, c_t, n_hit = tsw._phase_a_dense(sw_t, tr, p_max, c_chunk=c_chunk,
                                         return_n_hit=True)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    if p_max < C:
        assert int((n_hit > p_max).sum()) > 10
    else:
        assert bool((s_t[:, C:] == -1).all())
    # rays starting inside two or more boxes (ties at t = 0)
    o = tr.o[:, None, :]
    inside = ((o >= sw_t.cl_lo[None]) & (o <= sw_t.cl_hi[None])).all(-1)
    assert int((inside.sum(1) >= 2).sum()) > 10


def _routed_chunks(sw_t, tr, C, p_max=4, chunk=16):
    slots, _ = tsw._phase_a_dense(sw_t, tr, p_max)
    chunk_cl, chunk_ray, _, _ = tsw._route_pairs(slots, C, chunk)
    return chunk_cl, tsw._chunk_rays(tr, chunk_ray)


def test_plain_kernel_e_matches_phase_b_pallas(geom):
    """Kernel E's plain version against phase_b_pallas in interpret mode on
    the routed chunks of the query (dead chunks included): pid exactly,
    t to T_RTOL."""
    sw_j, sw_t, jr, tr, C = geom
    chunk_cl, chunk_rays = _routed_chunks(sw_t, tr, C)
    assert int((chunk_cl < 0).sum()) > 0
    t_j, p_j = jpp.phase_b_pallas(jnp.asarray(chunk_cl.numpy()),
                                  jnp.asarray(chunk_rays.numpy()),
                                  jnp.asarray(sw_t.seg_rows_t.numpy()), K,
                                  interpret=True)
    t_t, p_t = pk.phase_b_chunks(chunk_cl, chunk_rays, sw_t.seg_rows_t)
    p_j, t_j = np.asarray(p_j), np.asarray(t_j)
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    hit = p_j >= 0
    assert hit.sum() > 20
    np.testing.assert_allclose(t_t.numpy()[hit], t_j[hit], rtol=T_RTOL)


def test_swept_query_and_its_routing_match_jax(geom, monkeypatch):
    """The chunks the two packages hand to their phase-B kernel are equal
    (cluster per chunk and every ray row: the stable sort by cluster, the
    chunk-padded destinations), and swept_closest_hit equals the JAX
    query with impl='pallas' (interpret mode off the TPU); p_max 4, so
    rays overflow it, and chunks of 16."""
    sw_j, sw_t, jr, tr, C = geom
    seen = {}
    real_j, real_t = jpp.phase_b_pallas, pk.phase_b_chunks

    def spy_j(cc, rays, seg, K_, interpret=False):
        seen["j"] = (np.asarray(cc), np.asarray(rays))
        return real_j(cc, rays, seg, K_, interpret=interpret)

    def spy_t(cc, rays, seg, *boxes):
        seen["t"] = (cc.numpy(), rays.numpy())
        return real_t(cc, rays, seg, *boxes)

    monkeypatch.setattr(jpp, "phase_b_pallas", spy_j)
    monkeypatch.setattr(pk, "phase_b_chunks", spy_t)
    t_j, p_j = jsw.swept_closest_hit(sw_j, jr, C, K, p_max=4, chunk=16,
                                     impl="pallas")
    t_t, p_t = tsw.swept_closest_hit(sw_t, tr, p_max=4, chunk=16)
    np.testing.assert_array_equal(seen["t"][0], seen["j"][0])
    np.testing.assert_array_equal(seen["t"][1].view(np.int32),
                                  seen["j"][1].view(np.int32))
    p_j = np.asarray(p_j)
    np.testing.assert_array_equal(p_t.numpy(), p_j)
    hit = p_j >= 0
    assert hit.sum() > 20
    np.testing.assert_allclose(t_t.numpy()[hit], np.asarray(t_j)[hit],
                               rtol=T_RTOL)


def test_swept_any_hit_matches_jax(geom, monkeypatch):
    """swept_any_hit equals the JAX function: its closest hit, then
    (p >= 0) & ~degenerate. Its closest hit is pointed at impl='pallas'
    (interpret mode), so the kernel compiled for the query test above is
    re-used instead of compiling the XLA phase B."""
    sw_j, sw_t, jr, tr, C = geom
    monkeypatch.setattr(jsw, "swept_closest_hit", functools.partial(
        jsw.swept_closest_hit, impl="pallas"))
    o_j = jsw.swept_any_hit(sw_j, jr, C, K, p_max=4, chunk=16)
    o_t = tsw.swept_any_hit(sw_t, tr, p_max=4, chunk=16)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    assert int(o_t.sum()) > 20
    assert not bool(o_t[tr.maxt <= tr.mint].any())


RES = 32
CAM = np.array([[-0.704024, 0.0939171, 0.703939, -10.6677],
                [1.05829e-08, 0.991217, -0.132245, 14.3141],
                [-0.710177, -0.0931033, -0.69784, 10.2879],
                [0, 0, 0, 1]])


@pytest.fixture(scope="module")
def renders():
    """tests/test_torch_path.py's furball (120 fibers 20x thicker, C = 12
    clusters of 128, 32^2, depth 3, true Sobol', shadow-ray RR 0.01)
    built by hairpt with traversal='swept', p_max 4 (rays overflow it),
    chunks of 16; one wave through each package."""
    b = JSceneBuilder()
    m = b.add_material(kind=jmat.ROUGHPLASTIC, alpha=0.2, eta=1.55, dist=0,
                       diffuse=(0.143016, 0.0156076, 1.80928e-05))
    b.add_fibers(hairgen.gen_furball(n_fibers=120, radius=0.00216667 * 20),
                 m)
    b.env = jem.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                            sky_scale=5.0, sun_scale=19.0912,
                            sun_radius_scale=37.9165, res=32)
    cam = JCamera.perspective(CAM, 12.0, RES, RES)
    scene = b.build(cam, JFilm.make(RES, RES, "tent"), spp=1, max_depth=3,
                    sampler=(jrng.SOBOL_QMC, 5, RES), traversal="swept",
                    swept_k=128, swept_pmax=4, swept_chunk=16, nee_rr=0.01)
    img_j = np.asarray(jpath.render(scene, spp=1))
    arrays = jax.tree_util.tree_map(np.asarray, scene.arrays)
    ts = convert.convert_scene(scene, arrays, device="cpu")
    tsw.STATS.update(queries=0, rays=0, overflow_rays=0)
    pk.reset_counts()
    img_t = tpath.render(ts, spp=1).numpy()
    return scene, ts, img_j, img_t


def test_swept_render_matches_jax(renders):
    """Image mean within 1e-3 relative and >= 98% of pixel values within
    1e-3 relative (+1e-4 absolute). Not exact: on the CPU the JAX package
    takes its XLA phase B (intersect_swept._hair_test_chunk: axis from
    rsqrt of p1 - p0, second miter plane through p1, first lane on equal
    t), while the port runs kernel E's arithmetic (the precomputed unit
    axis and sn1, the largest pid on equal t), so hit t differ by ulps
    and a few grazing hits and sampling decisions flip."""
    scene, ts, img_j, img_t = renders
    assert ts.config.traversal == "swept"
    assert (ts.config.swept_pmax, ts.config.swept_chunk) == (4, 16)
    assert img_t.shape == img_j.shape == (RES, RES, 3)
    assert np.all(np.isfinite(img_t))
    assert img_j.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 1e-3
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.98, close.mean()
    # the render went through the swept path and overflowed p_max
    assert tsw.STATS["queries"] >= 3
    assert tsw.STATS["overflow_rays"] > 0
    assert pk.LAUNCHES == {"swept_phase_a": 0, "phase_b_chunks": 0}
    assert pk.PLAIN_ON_CUDA == {"swept_phase_a": 0, "phase_b_chunks": 0}


def test_scene_builder_takes_swept_and_refuses_other_traversals():
    b = SceneBuilder(device="cpu")
    b.add_material(kind=jmat.ROUGHPLASTIC)
    b.add_fibers(hairgen.gen_furball(n_fibers=30, n_segs=4), 0)
    cam = Camera.perspective(CAM, 12.0, 8, 8)
    s = b.build(cam, Film.make(8, 8, "tent"), spp=1, traversal="swept",
                swept_k=32)
    assert s.config.swept_c == s.arrays.hair_swept.seg_rows_t.shape[0] > 0
    assert (s.config.swept_pmax, s.config.swept_chunk) == (24, 64)
    # 'perray' and 'blocked', which an earlier slice refused, build the
    # hair's BVHArrays; 'tiled_sub' (ROADMAP item 8, refused by an earlier
    # slice) builds the same layout; a name of no traversal raises
    for other in ("perray", "blocked"):
        o = b.build(cam, Film.make(8, 8, "tent"), spp=1, traversal=other)
        assert o.config.traversal == other
        assert torch.equal(o.arrays.hair_bvh.node_left,
                           s.arrays.hair_bvh.node_left)
    o = b.build(cam, Film.make(8, 8, "tent"), spp=1, traversal="tiled_sub")
    assert o.config.traversal == "tiled_sub"
    assert torch.equal(o.arrays.hair_swept.sub_lo, s.arrays.hair_swept.sub_lo)
    with pytest.raises(ValueError, match="traversal"):
        b.build(cam, Film.make(8, 8, "tent"), spp=1, traversal="tiled32")


def test_public_builders_default_to_the_card(monkeypatch):
    """build_swept_hair, pack_materials, make_envmap and bake_sunsky put
    their tables on the card unless told "cpu": without a card, the
    default raises instead of falling back."""
    from hairpt_torch.models import emitters as tem
    from hairpt_torch.models.bsdf import registry as tmat
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fs = hairgen.segments(hairgen.gen_furball(n_fibers=8, n_segs=4))
    a = [fs[k] for k in ("p0", "p1", "n0", "n1", "radius")]
    rows = [tmat.default_material_row(kind=tmat.ROUGHPLASTIC)]
    img = np.ones((4, 8, 3), np.float32)
    calls = [lambda **kw: tsw.build_swept_hair(*a, K=32, **kw),
             lambda **kw: tmat.pack_materials(rows, **kw),
             lambda **kw: tem.make_envmap(img, **kw),
             lambda **kw: tem.bake_sunsky((0.0, 1.0, 0.0), res=8, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        assert call(device="cpu") is not None
