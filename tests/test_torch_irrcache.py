"""Irradiance caching of hairpt_torch against hairpt's, and kernel L's
per-thread loop against its plain version, on the CPU: the area-lit box
of tests/test_bdpt.py (which hairpt's own irrcache tests render) and the
120-fiber hair stand-in of tests/torch_light_scenes.py (hairpt on its
packed walk, the port on the tiled traversal's plain versions).

Bounds: the cache's points and normals exactly (one numpy generator);
e_ind, r_grad and t_grad within 1e-5 of their largest value (the
estimator's sums and einsums in another order); the render pass fed one
cache, and the whole render with gradients on and off, by
torch_light_scenes.compare (the mean within 2e-3, >= 97% of the values
within 1e-3 relative + 1e-4). Kernel L's transcription against
interp_plain, which adds the records in L's order: has_cut and e bit for
bit on the edge cases: no record within the cutoff,
ndot exactly 0.2, a record at the lane's point, e_rec clamped at 0,
lanes that are not valid, and a chunk boundary of the plain version.
Each JAX function is compiled once."""
import numpy as np
import pytest
import torch

from hairpt.integrators import irrcache as jic
from hairpt_torch.integrators import irrcache as tic
from hairpt_torch.ops import irrcache_interp as L
import torch_light_scenes as scenes
from torch_threads import one_thread  # noqa: F401

RES = 12


@pytest.fixture(scope="module")
def box():
    return scenes.build(scenes.box, res=RES)


@pytest.fixture(scope="module")
def hair():
    return scenes.build(scenes.hair, res=RES)


def _to_port(cache):
    """hairpt's cache tuple (cpos, cnrm, e_ind[, r_grad, t_grad]) as the
    port's tensors."""
    return tuple(torch.as_tensor(np.array(x, np.float32)) for x in cache)


def _close_to_largest(a, b, rel=1e-5):
    a = a.numpy()
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * np.abs(b).max(), \
        (np.abs(a - b).max(), np.abs(b).max())


@pytest.mark.parametrize("grid", [None, (4, 8)], ids=["cosine", "grid"])
def test_cache_pass_matches_jax(box, grid):
    js, cs = box
    grads = grid is not None
    cj = jic.build_irradiance_cache(js, 96, 4, 3, grid=grid,
                                    gradients=grads)
    ct = tic.build_irradiance_cache(cs, 96, 4, 3, grid=grid,
                                    gradients=grads)
    assert len(cj) == len(ct) == (5 if grads else 3)
    np.testing.assert_array_equal(ct[0].numpy(), np.asarray(cj[0]))
    np.testing.assert_array_equal(ct[1].numpy(), np.asarray(cj[1]))
    assert float(ct[2].max()) > 0
    for a, b in zip(ct[2:], cj[2:]):
        _close_to_largest(a, b)


def test_cache_pass_refuses_a_scene_without_triangles():
    from hairpt_torch.scene.furball import furball_scene
    s = furball_scene(quality=0.01, res=8, depth=2, spp=1, device="cpu")
    assert s.arrays.tri is None
    with pytest.raises(ValueError, match="triangles"):
        tic.build_irradiance_cache(s, 16, 2)


@pytest.mark.parametrize("gradients", [False, True])
def test_render_pass_with_one_cache_matches_jax(hair, monkeypatch,
                                                gradients):
    """hairpt's render pass and the port's on hairpt's own cache (the
    hair stand-in, 128 points, grid (4, 8))."""
    js, cs = hair
    cache = jic.build_irradiance_cache(js, 128, 4, 1, grid=(4, 8),
                                       gradients=True)
    if not gradients:
        cache = cache[:3]
    monkeypatch.setattr(jic, "build_irradiance_cache",
                        lambda *a, **kw: cache)
    b = jic.render_irrcache(js, spp=2, seed=1, gradients=gradients)
    a = tic.render_irrcache(cs, spp=2, seed=1, cache=_to_port(cache))
    scenes.compare(a, b)


@pytest.mark.parametrize("gradients", [False, True])
def test_render_irrcache_matches_jax(box, gradients):
    js, cs = box
    kw = dict(n_points=96, m_rays=4, spp=2, seed=1, gradients=gradients,
              grid=(4, 8) if gradients else None)
    scenes.compare(tic.render_irrcache(cs, **kw),
                   jic.render_irrcache(js, **kw))


# ---------------------------------------------------------------------------
# kernel L: its per-thread loop against the plain version
# ---------------------------------------------------------------------------

def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _edge_case(grad: bool):
    """Lanes and 300 records (three tiles of L, the last partial) with
    the edge cases at fixed lanes: 0 no record within the cutoff, 1 ndot
    exactly 0.2 against record 0 (and its own point), 2 a record at its
    point, 3 e_rec clamped at 0 for every record it weights, 4-5 not
    valid; the rest random."""
    rng = np.random.default_rng(7)
    M, N = 300, 24
    cpos = rng.uniform(-1, 1, (M, 3)).astype(np.float32)
    cnrm = _unit(rng.normal(size=(M, 3)) + [0, 0, 3]).astype(np.float32)
    e_ind = rng.uniform(0, 2, (M, 3)).astype(np.float32)
    r_grad = rng.normal(0, 0.3, (M, 3, 3)).astype(np.float32)
    t_grad = rng.normal(0, 0.5, (M, 3, 3)).astype(np.float32)
    p = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    n = _unit(rng.normal(size=(N, 3)) + [0, 0, 3]).astype(np.float32)
    valid = np.ones(N, bool)
    p[0] = (40.0, 40.0, 40.0)                  # every arg above kappa
    n[1] = (0.0, 0.0, 1.0)
    cnrm[0] = (np.sqrt(np.float32(0.96)), 0.0, np.float32(0.2))
    p[1] = cpos[0]
    p[2] = cpos[5]
    n[2] = cnrm[5]
    p[3] = cpos[9] + np.float32(0.01)
    n[3] = cnrm[9]
    t_grad[:, :, :] = np.where(np.arange(M)[:, None, None] == 9,
                               np.float32(-1e4), t_grad)
    e_ind[9] = 0.5
    valid[4:6] = False
    p[5] = np.nan
    rec = L.Records(*[torch.as_tensor(x) for x in (cpos, cnrm, e_ind)]
                    + ([torch.as_tensor(r_grad), torch.as_tensor(t_grad)]
                       if grad else []))
    return torch.as_tensor(p), torch.as_tensor(n), torch.as_tensor(valid), \
        rec


def _rel(a, b):
    d = np.abs(a - b)
    m = np.maximum(np.abs(a), np.abs(b))
    return np.where(d == 0, 0.0, d / np.where(m == 0, 1.0, m))


@pytest.mark.parametrize("grad", [False, True], ids=["plain", "grad"])
def test_kernel_l_transcription_equals_plain(grad):
    p, n, valid, rec = _edge_case(grad)
    k, kappa = 0.25, 2.0
    e_p, cut_p = L.interp_plain(p, n, valid, rec, k, kappa)
    assert (n[1] @ rec.cnrm[0]).item() == np.float32(0.2)
    assert bool(cut_p[1:4].all()) and not bool(cut_p[0])
    assert not bool(cut_p[4:6].any()) and float(e_p[4:6].abs().max()) == 0
    assert float(e_p[0].min()) > 0
    for i in range(p.shape[0]):
        e_t, cut_t = L.interp_thread(p[i].numpy(), n[i].numpy(),
                                     bool(valid[i]), rec, k, kappa)
        assert cut_t == bool(cut_p[i]), i
        np.testing.assert_array_equal(e_t.view(np.int32),
                                      e_p[i].numpy().view(np.int32))
    # lane 3: record 9's e_rec is clamped to 0 and dominates its weight
    if grad:
        w, wc, e_rec = L.pair_terms(p[3:4], n[3:4], rec, k, kappa)
        assert float(e_rec[0, 9].abs().max()) == 0 and float(wc[0, 9]) > 0
    # the CPU wrapper is the plain version
    e_w, cut_w = L.interp(p, n, valid, rec, k, kappa)
    assert torch.equal(e_w, e_p) and torch.equal(cut_w, cut_p)


@pytest.mark.parametrize("chunk", [1, 5, 7])
def test_kernel_l_plain_chunks_agree(chunk):
    """Chunk boundaries of the plain version change nothing: each lane's
    sums run over its own row, in L's order."""
    p, n, valid, rec = _edge_case(True)
    e_a, cut_a = L.interp_plain(p, n, valid, rec, 0.25, 2.0)
    e_b, cut_b = L.interp_plain(p, n, valid, rec, 0.25, 2.0, chunk=chunk)
    assert torch.equal(cut_a, cut_b) and torch.equal(e_a, e_b)


def test_tiled_sums_follow_the_tile_order():
    """tiled_sums adds within each tile of L.TILE in order, then the tile
    sums in order (a partial last tile padded with exact zeros)."""
    x = torch.tensor(np.random.default_rng(2).random((3, 300)) * 1e3,
                     dtype=torch.float32)
    want = []
    for row in x.numpy():
        tot = np.float32(0)
        for t0 in range(0, 300, L.TILE):
            acc = np.float32(0)
            for v in row[t0:t0 + L.TILE]:
                acc = np.float32(acc + v)
            tot = np.float32(tot + acc)
        want.append(tot)
    np.testing.assert_array_equal(L.tiled_sums(x).numpy(),
                                  np.array(want, np.float32))


def test_kernel_l_plain_equals_the_dense_formula(hair):
    """interp_plain against the JAX package's dense formula (numpy, in
    float64) on the hair stand-in's camera lanes and a cache of it."""
    js, cs = hair
    cache = jic.build_irradiance_cache(js, 128, 4, 1, grid=(4, 8),
                                       gradients=True)
    from hairpt_torch.integrators.aux_integrators import camera_wave
    _, _, _, _, hit = camera_wave(cs, cs.arrays, 0)
    rec = L.Records(*_to_port(cache))
    e_p, cut_p = L.interp_plain(hit.p, hit.sh_n, hit.valid, rec)
    v = hit.valid.numpy()
    assert v.sum() > 20
    x = hit.p.numpy()[v].astype(np.float64)
    nn = hit.sh_n.numpy()[v].astype(np.float64)
    cpos, cnrm, e_ind, rg, tg = (np.asarray(c, np.float64) for c in cache)
    diff = x[:, None] - cpos[None]
    ndot = np.clip((nn[:, None] * cnrm[None]).sum(-1), -1, 1)
    arg = np.sqrt((diff ** 2).sum(-1)) / 0.25 \
        + np.sqrt(np.maximum(1 - ndot, 0)) + 1e-4
    w = np.where(ndot > 0.2, 1 / arg, 0.0)
    wc = np.where(arg < 2.0, w, 0.0)
    cut = wc.sum(-1) > 0
    w = np.where(cut[:, None], wc, w)
    cr = np.cross(np.broadcast_to(cnrm[None], diff.shape),
                  np.broadcast_to(nn[:, None], diff.shape))
    e_rec = np.maximum(e_ind[None] + np.einsum("nma,mac->nmc", cr, rg)
                       + np.einsum("nma,mac->nmc", diff, tg), 0)
    e = np.einsum("nm,nmc->nc", w, e_rec) \
        / np.maximum(w.sum(-1), 1e-9)[:, None]
    np.testing.assert_array_equal(cut_p.numpy()[v], cut)
    assert _rel(e_p.numpy()[v], e).max() <= 1e-4
