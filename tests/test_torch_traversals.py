"""The per-ray and the blocked BVH walks (traversal 'perray' and
'blocked': hairpt_torch/ops/intersect.py, ops/intersect_blocked.py) on
the CPU: their plain versions against hairpt's isec.closest_hit /
any_hit and closest_hit_blocked / any_hit_blocked on triangles and on
hair, against the port's packed walk on the same tree, and whole renders
and gradients under both traversals against the packed traversal.

The trees are the port's SAH builds, the rays tests/test_torch_packed.py's
(camera-like, grazing, clipped and escaped lanes at infinity; past
n_exact the edge rays, whose hit turns on the last bits: XLA:CPU
contracts a * b + c, so hairpt may pick the other neighbour there, and
those rays are held to the packed walk instead, which test_torch_packed
holds to kernel F's transcription). pid and hit flags are held exactly,
t within T_ULP of a float64 evaluation of the same primitive."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core.math import Ray as JRay
from hairpt.integrators import common as jcommon
from hairpt.ops import intersect as jisec
from hairpt.ops import intersect_blocked as jblk
from hairpt_torch.core.math import Ray
from hairpt_torch.integrators import common as tcommon
from hairpt_torch.integrators import inverse as tinv
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models import shapes as shp
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.ops import intersect as tisec
from hairpt_torch.ops import intersect_blocked as tblk
from hairpt_torch.ops import intersect_packed as tpk
from hairpt_torch.scene import hairgen as th
from hairpt_torch.scene.furball import furball_floor_scene
from hairpt_torch.scene.scene import HairGeom, TriGeom
from test_torch_packed import T_ULP, _hair_rays, _ripples, _t64, _tri_rays
from torch_threads import one_thread  # noqa: F401

JLEAF = {"tri": (jisec.tri_intersect_block, jblk.tri_leaf_block),
         "hair": (jisec.hair_intersect_block, jblk.hair_leaf_block)}


def _tree(leaf):
    """(FlatBVH, the sorted geometry as numpy fields, packed rows): the
    ripples beside the teapot stand-in, or a small furball's hair, as
    tests/test_torch_packed.py builds them."""
    if leaf == "tri":
        tea = shp.transform_mesh(shp.compute_smooth_normals(
            shp.teapot_standin(0.3)), np.array([[1, 0, 0, 4.0],
                                                [0, 1, 0, 0],
                                                [0, 0, 1, 0.0],
                                                [0, 0, 0, 1]]))
        m = shp.merge([_ripples(), tea])
        p, f = m.positions, m.faces
        v0, v1, v2 = (p[f[:, k]].astype(np.float32) for k in range(3))
        fb = tbvh.build(np.minimum(np.minimum(v0, v1), v2),
                        np.maximum(np.maximum(v0, v1), v2))
        o = fb.prim_order
        g = {"p0": v0[o], "e1": (v1 - v0)[o], "e2": (v2 - v0)[o]}
        rows = tpk.tri_pack_rows(v0[o], v1[o], v2[o],
                                 np.arange(len(o), dtype=np.int32))
    else:
        fs = th.gen_furball(n_fibers=60, n_segs=8, radius=0.02, seed=3,
                            center=(0, 0, 0), core_r=0.6, fiber_len=0.8)
        s = th.segments(fs)
        p0, p1, n0, n1, rad = (s[k] for k in ("p0", "p1", "n0", "n1",
                                              "radius"))
        tang = p1 - p0
        tang = tang / np.linalg.norm(tang, axis=-1, keepdims=True)
        expand = rad / np.maximum(np.minimum(
            np.abs(np.sum(n0 * tang, -1)), np.abs(np.sum(n1 * tang, -1))),
            0.3)
        fb = tbvh.build(np.minimum(p0, p1) - expand[:, None],
                        np.maximum(p0, p1) + expand[:, None])
        o = fb.prim_order
        g = {"p0": p0[o], "p1": p1[o], "n0": n0[o], "n1": n1[o],
             "radius": rad[o]}
        rows = tpk.hair_pack_rows(p0[o], p1[o], n0[o], n1[o], rad[o],
                                  np.arange(len(o), dtype=np.int32))
    g = {k: np.ascontiguousarray(v, np.float32) for k, v in g.items()}
    return fb, g, rows


@pytest.fixture(scope="module")
def trees():
    out = {}
    for leaf in ("tri", "hair"):
        fb, g, rows = _tree(leaf)
        rays = _tri_rays(rows, 600, 0) if leaf == "tri" \
            else _hair_rays(rows, 600, 1)
        tg = (TriGeom if leaf == "tri" else HairGeom)(
            **{k: torch.as_tensor(v) for k, v in g.items()})
        jg = (jisec.TriGeom if leaf == "tri" else jisec.HairGeom)(
            **{k: jnp.asarray(v) for k, v in g.items()})
        packed = tpk.pack_bvh(fb, rows)
        out[leaf] = dict(fb=fb, rows=rows, rays=rays, tg=tg, jg=jg,
                         tb=tisec.bvh_to_device(fb),
                         jb=jisec.bvh_to_device(fb), packed=packed)
    return out


def _shadow(ray):
    """Shadow-ray maxt: every 7th 0 (a dead lane), the rest clipped to 2."""
    maxt = np.where(np.arange(len(ray[3])) % 7 == 0, 0.0,
                    np.minimum(ray[3], 2.0)).astype(np.float32)
    return ray[:3] + (maxt,)


def _t_within_ulp(leaf, rows, ray, p, t, t_j, n_cond):
    by_id = rows.reshape(-1, 16)
    for i in np.nonzero(p >= 0)[0]:
        if i >= n_cond:
            continue
        t64 = _t64(leaf, by_id[int(p[i])], ray[0][i], ray[1][i])
        if leaf == "hair":
            t64 = min(t64, key=lambda x: abs(x - float(t[i])))
        ulp = float(np.spacing(np.float32(t64)))
        for name, x in (("port", t[i]), ("jax", t_j[i])):
            assert abs(float(x) - t64) <= T_ULP[leaf] * ulp, (name, i)


def _jax_walk(tr, leaf, ray, mode, block):
    jr = JRay(*[jnp.asarray(x) for x in ray])
    leaf_fn, blk_fn = JLEAF[leaf]
    if block is None:
        f = jisec.closest_hit if mode == "closest" else jisec.any_hit
        out = jax.jit(lambda r: f(tr["jb"], tr["jg"], leaf_fn, 4, r))(jr)
    else:
        pr, n = jcommon._pad_ray(jr, block)
        f = jblk.closest_hit_blocked if mode == "closest" \
            else jblk.any_hit_blocked
        out = jax.jit(lambda r: f(tr["jb"], tr["jg"], blk_fn, 4, r,
                                  block))(pr)
        out = tuple(x[:n] for x in out) if mode == "closest" else out[:n]
    return tuple(np.asarray(x) for x in out) if mode == "closest" \
        else np.asarray(out)


def _port_walk(tr, leaf, ray, mode, block):
    r = Ray(*[torch.as_tensor(x) for x in ray])
    if block is None:
        f = tisec.closest_hit if mode == "closest" else tisec.any_hit
        out = f(tr["tb"], tr["tg"], leaf, r)
    else:
        pr, n = tcommon._pad_ray(r, block)
        f = tblk.closest_hit_blocked if mode == "closest" \
            else tblk.any_hit_blocked
        out = f(tr["tb"], tr["tg"], leaf, pr, block)
        out = tuple(x[:n] for x in out) if mode == "closest" else out[:n]
    return tuple(x.numpy() for x in out) if mode == "closest" \
        else out.numpy()


@pytest.mark.parametrize("block", [None, 64, 256],
                         ids=["perray", "blocked64", "blocked256"])
@pytest.mark.parametrize("leaf", ["tri", "hair"])
@pytest.mark.parametrize("mode", ["closest", "any"])
def test_plain_walks_match_jax(trees, leaf, mode, block):
    """The plain per-ray walk (block None) and the plain blocked walk
    (rays padded to a multiple of `block` as common._pad_ray pads them:
    600 + the grazing and dead rays leave a partial last block) against
    hairpt's on the rays whose hit does not turn on the last bits: pid
    and hit flags exactly, t within T_ULP ulp of the float64 t where the
    test is well conditioned. The any hit runs shadow rays (every 7th
    with maxt 0)."""
    tr = trees[leaf]
    ray, n_exact, n_cond = tr["rays"]
    ray = tuple(x[:n_exact] for x in ray)
    if mode == "any":
        ray = _shadow(ray)
        occ_j = _jax_walk(tr, leaf, ray, mode, block)
        occ_t = _port_walk(tr, leaf, ray, mode, block)
        np.testing.assert_array_equal(occ_t, occ_j)
        assert 10 < occ_j.sum() < len(occ_j) - 10
        return
    t_j, p_j = _jax_walk(tr, leaf, ray, mode, block)
    t_t, p_t = _port_walk(tr, leaf, ray, mode, block)
    np.testing.assert_array_equal(p_t, p_j)
    assert 50 < int((p_j >= 0).sum()) < len(p_j) - 10
    assert np.isinf(t_t[p_t < 0]).all() and np.isinf(t_j[p_j < 0]).all()
    _t_within_ulp(leaf, tr["rows"], ray, p_t, t_t, t_j, n_cond)


@pytest.mark.parametrize("leaf", ["tri", "hair"])
@pytest.mark.parametrize("mode", ["closest", "any"])
def test_perray_equals_the_packed_walk(trees, leaf, mode):
    """On every ray, the edge rays included, the plain per-ray walk equals
    the packed walk on the same tree bit for bit (the same slab test and
    leaf arithmetic on the same float32 values; the packed rows' ids are
    the sorted indices). The any hit differs only where maxt <= mint,
    which the packed walk counts as no hit."""
    tr = trees[leaf]
    ray, _, _ = tr["rays"]
    if mode == "any":
        ray = _shadow(ray)
    r = Ray(*[torch.as_tensor(x) for x in ray])
    if mode == "closest":
        t_a, p_a = tisec.closest_hit(tr["tb"], tr["tg"], leaf, r)
        t_b, p_b = tpk.closest_hit_packed(tr["packed"], leaf, r)
        assert torch.equal(p_a, p_b)
        assert torch.equal(t_a.view(torch.int32), t_b.view(torch.int32))
    else:
        live = r.maxt > r.mint
        occ_a = tisec.any_hit(tr["tb"], tr["tg"], leaf, r)
        assert torch.equal(occ_a & live,
                           tpk.any_hit_packed(tr["packed"], leaf, r))


@pytest.mark.parametrize("block", [64, 256])
@pytest.mark.parametrize("leaf", ["tri", "hair"])
def test_blocked_equals_perray(trees, leaf, block):
    """On every ray the blocked walk's closest hit equals the per-ray
    walk's: a lane tests a leaf only where it enters the leaf's box, and
    every hit lies in the boxes of its leaf's ancestors, so walking the
    block's union of nodes (in the same preorder) adds no hit and breaks
    no tie. Its any hit equals the per-ray walk's on the lanes with
    maxt > mint."""
    tr = trees[leaf]
    ray, _, _ = tr["rays"]
    r = Ray(*[torch.as_tensor(x) for x in ray])
    pr, n = tcommon._pad_ray(r, block)
    t_a, p_a = tblk.closest_hit_blocked(tr["tb"], tr["tg"], leaf, pr, block)
    t_b, p_b = tisec.closest_hit(tr["tb"], tr["tg"], leaf, r)
    assert torch.equal(p_a[:n], p_b)
    assert torch.equal(t_a[:n].view(torch.int32), t_b.view(torch.int32))
    s = Ray(*[torch.as_tensor(x) for x in _shadow(ray)])
    ps, _ = tcommon._pad_ray(s, block)
    occ_a = tblk.any_hit_blocked(tr["tb"], tr["tg"], leaf, ps, block)[:n]
    occ_b = tisec.any_hit(tr["tb"], tr["tg"], leaf, s)
    assert torch.equal(occ_a, occ_b & (s.maxt > s.mint))


@pytest.mark.parametrize("leaf", ["tri", "hair"])
def test_perray_matches_brute_force(trees, leaf):
    """The per-ray walk finds each ray's closest primitive: against every
    primitive tested (brute_force_closest), pid exactly on the
    well-conditioned rays."""
    tr = trees[leaf]
    ray, n_exact, n_cond = tr["rays"]
    r = Ray(*[torch.as_tensor(x[:n_cond]) for x in ray])
    t_a, p_a = tisec.closest_hit(tr["tb"], tr["tg"], leaf, r)
    t_b, p_b = tisec.brute_force_closest(tr["tg"], leaf, r)
    assert torch.equal(p_a, p_b)
    assert torch.equal(t_a, t_b)


def test_pad_ray_matches_jax():
    """common._pad_ray against hairpt's: zero origins, direction +z,
    mint = maxt = 0, the length before padding."""
    rs = np.random.default_rng(2)
    ray = tuple(rs.random(s).astype(np.float32)
                for s in ((70, 3), (70, 3), (70,), (70,)))
    jr, jn = jcommon._pad_ray(JRay(*[jnp.asarray(x) for x in ray]), 64)
    tr, tn = tcommon._pad_ray(Ray(*[torch.as_tensor(x) for x in ray]), 64)
    assert jn == tn == 70
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    same, n = tcommon._pad_ray(Ray(*[torch.as_tensor(x[:64])
                                     for x in ray]), 64)
    assert n == 64 and same.o.shape[0] == 64


def test_walk_caps_and_block_checks_raise(trees):
    """A skip pointer that loops (a corrupt tree) stops both plain walks
    at 2 M steps with an error, as the kernels' cap does; the blocked
    walk refuses a ray count that is not a multiple of block, and a
    block that is not a multiple of 32."""
    tr = trees["tri"]
    m = shp.rectangle()
    v = [m.positions[m.faces[:, k]].astype(np.float32) for k in range(3)]
    fb = tbvh.build(np.minimum(np.minimum(*v[:2]), v[2]),
                    np.maximum(np.maximum(*v[:2]), v[2]))
    geom = TriGeom(*[torch.as_tensor(x[fb.prim_order])
                     for x in (v[0], v[1] - v[0], v[2] - v[0])])
    small = tisec.bvh_to_device(fb)
    bad = small._replace(node_skip=torch.zeros_like(small.node_skip),
                         node_min=torch.ones_like(small.node_min),
                         node_max=-torch.ones_like(small.node_max))
    ray = Ray(torch.zeros(64, 3), torch.tensor([[0.0, 0.0, 1.0]] * 64),
              torch.zeros(64), torch.full((64,), float("inf")))
    with pytest.raises(RuntimeError, match="2 M"):
        tisec.closest_hit(bad, geom, "tri", ray)
    with pytest.raises(RuntimeError, match="2 M"):
        tblk.closest_hit_blocked(bad, geom, "tri", ray, 64)
    with pytest.raises(ValueError, match="multiple of block"):
        tblk.any_hit_blocked(tr["tb"], tr["tg"], "tri", ray, 256)
    with pytest.raises(ValueError, match="multiple of 32"):
        tblk.closest_hit_blocked(tr["tb"], tr["tg"], "tri", ray, 48)


@pytest.fixture(scope="module")
def floor_renders():
    """The furball over the checkerboard (300 fibers, 24^2, depth 4) with
    each traversal of its packed trees: the images and the scenes."""
    out = {}
    for trav in ("packed", "perray", "blocked"):
        s = furball_floor_scene(quality=0.05, res=24, depth=4, device="cpu",
                                traversal=trav)
        out[trav] = (s, tpath.render(s, spp=1))
    return out


@pytest.mark.parametrize("trav", ["perray", "blocked"])
def test_traversal_render_equals_packed(floor_renders, trav):
    """A render with 'perray' or 'blocked' (triangles and hair through
    those walks) equals the packed traversal's bit for bit; the packed
    render is held to hairpt's in tests/test_torch_mesh.py."""
    s, img = floor_renders[trav]
    assert s.config.traversal == trav and s.config.block == 256
    assert s.arrays.tri_bvh is not None and s.arrays.hair_bvh is not None
    ref = floor_renders["packed"][1]
    assert float(ref.mean()) > 0
    assert torch.equal(img, ref)


def _grads(s):
    """(loss, d loss / d diffuse) of the differentiable mode and of
    path-replay backprop at depth 3, every lane of the film."""
    n = s.config.width * s.config.height
    lanes = (torch.arange(n), torch.zeros(n, dtype=torch.int64))
    s = s._replace(config=dataclasses.replace(s.config, max_depth=3))
    d = s.arrays.materials.diffuse.clone().requires_grad_()
    li = tpath.make_li_fn(s, differentiable=True)
    arr = s.arrays._replace(materials=s.arrays.materials._replace(
        diffuse=d))
    loss = li(arr, *lanes)[0].mean()
    loss.backward()
    params = {"diffuse": s.arrays.materials.diffuse.clone()}
    l_prb, g_prb = tinv.make_prb_loss_grad(s)(s.arrays, params, *lanes)
    return float(loss.detach()), d.grad, float(l_prb), g_prb["diffuse"]


@pytest.fixture(scope="module")
def packed_grads(floor_renders):
    return _grads(floor_renders["packed"][0])


@pytest.mark.parametrize("trav", ["perray", "blocked"])
def test_gradients_accept_the_walks(floor_renders, packed_grads, trav):
    """make_li_fn(differentiable=True) and path-replay backprop take both
    traversals: depth 3, the loss and its gradient with respect to the
    diffuse albedo equal the packed traversal's bit for bit (the walks
    give the same hits)."""
    got = _grads(floor_renders[trav][0])
    ref = packed_grads
    assert got[0] == ref[0] and got[2] == ref[2]
    assert torch.equal(got[1], ref[1]) and torch.equal(got[3], ref[3])
    assert float(got[1].abs().sum()) > 0
