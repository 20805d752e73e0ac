"""The photon-map family of hairpt_torch against hairpt, on the CPU, and
kernel K's pair selection (ops/photon_query.py).

- K's per-thread loop, transcribed (photon_query.surface_thread /
  beam_thread), equals the plain versions' pair lists exactly on the edge
  cases: a cell range that reaches the last photon (the M - 1 clamp's
  duplicates), a cell with more than max_per_cell photons, query points
  outside the grid and non-finite ones, photons at exactly r^2, beam
  feet on step boundaries;
- the plain versions reproduce hairpt's dense masks exactly: the surface
  pairs' count per lane equals hairpt's gather_flux count, and the beam
  pairs equal the near mask of hairpt's bre_query loop (transcribed with
  jax.numpy below, the same expressions);
- gather_flux and bre_query against hairpt's on the same maps (1e-4,
  for bre_query 1e-3, relative + 1e-6 on >= 99.9% of the values: the
  sums' order differs);
- render_photonmap, render_ppm, render_sppm and
  render_volumetric_photonmap against hairpt's on the scenes of
  tests/torch_light_scenes.py (torch_light_scenes.compare's bounds), and
  a grid medium refused where hairpt's branch fails.

Each JAX function is compiled at most once (render_ppm compiles its
photon-map wave once per pass)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.integrators import photonmap as jpm
from hairpt.models import media as jmed
from hairpt_torch.integrators import photonmap as tpm
from hairpt_torch.models import media as tmed
from hairpt_torch.ops import photon_query as pq
import torch_light_scenes as scenes
from torch_threads import one_thread  # noqa: F401

MPC_S, MPC_B = 32, 16
FLUX_RTOL, FLUX_ATOL, FLUX_SHARE = 1e-4, 1e-6, 0.999
# the beam estimate: the Silverman kernel (1 - b^2 / r^2)^2 turns a
# last-bit difference of a photon's foot near its disc's rim into a
# relative one of the pair's weight (3e-4 of a lane's sum seen)
BRE_RTOL = 1e-3


# ---------------------------------------------------------------------------
# kernel K's loop against the plain versions
# ---------------------------------------------------------------------------

def _grid(pos, valid, radius, gr, beam=False):
    """A photon map's query arrays from deposits (build_photon_map's or
    build_volume_photon_map's sort and keys)."""
    t = [torch.as_tensor(x) for x in (pos, np.zeros_like(pos),
                                      np.zeros_like(pos), valid)]
    m = (tpm.build_volume_photon_map if beam else tpm.build_photon_map)(
        *t, radius, grid_res=gr)
    return m.grid()


def _surface_case(name):
    rs = np.random.RandomState(11)
    r = 0.5
    if name == "clamp":
        # the last cell holds 3 photons: its slots clamp to M - 1
        pos = rs.uniform(0.0, 3.0, size=(200, 3)).astype(np.float32)
        pos[-3:] = np.float32([[3.9, 3.9, 3.9], [3.95, 3.9, 3.9],
                               [3.9, 3.97, 3.95]])
        p = np.float32([[3.9, 3.9, 3.92], [3.7, 3.8, 3.9], [1.0, 1.0, 1.0]])
    elif name == "dense":
        pos = rs.uniform(0.0, 3.0, size=(300, 3)).astype(np.float32)
        pos[:80] = (1.2 + 0.3 * rs.random_sample((80, 3))).astype(np.float32)
        p = (1.3 + 0.2 * rs.random_sample((16, 3))).astype(np.float32)
    elif name == "outside":
        pos = rs.uniform(0.0, 3.0, size=(300, 3)).astype(np.float32)
        p = np.float32([[-0.7, 1.0, 1.0], [-5.0, 1.0, 1.0], [1.0, 9.0, 1.0],
                        [1e12, 0.0, 0.0], [np.inf, 1.0, 1.0],
                        [np.nan, 1.0, 1.0], [2.9, 2.9, 3.6],
                        [0.1, 0.1, 0.1]])
    else:   # exact: photons at exactly r^2 and just inside
        pos = rs.uniform(0.0, 3.0, size=(100, 3)).astype(np.float32)
        pos[:4] = np.float32([[1.5, 1.0, 1.0], [1.0, 1.5, 1.0],
                              [1.25, 1.0, 1.0], [1.0, 1.0, 0.5]])
        p = np.float32([[1.0, 1.0, 1.0]])
    valid = rs.random_sample(pos.shape[0]) < 0.9
    if name == "clamp":
        # invalid photons sort last: none here, so that the last cell is
        # the one at M - 1
        valid[:] = True
    valid[:4] = True
    return pos, valid, r, p


@pytest.mark.parametrize("case", ["clamp", "dense", "outside", "exact"])
def test_surface_transcription_equals_plain(case):
    pos, valid, r, p = _surface_case(case)
    g = _grid(pos, valid, r, 8)
    r2 = np.float32(r * r)
    lane, idx = pq.surface_pairs_plain(g, torch.as_tensor(p),
                                       torch.full((p.shape[0],), r2), MPC_S)
    want = [(i, k) for i in range(p.shape[0])
            for k in pq.surface_thread(g, p[i], r2, MPC_S)]
    assert list(zip(lane.tolist(), idx.tolist())) == want
    if case == "clamp":
        # the last photon is a pair more than once
        assert idx.tolist().count(g.M - 1) > 1
    if case == "exact":
        near = {tuple(g.pos[k].tolist()) for k in idx.tolist()}
        assert (1.25, 1.0, 1.0) in near and (1.5, 1.0, 1.0) not in near


def _beam_case(name):
    rs = np.random.RandomState(12)
    pos = rs.uniform(-2.0, 4.0, size=(600, 3)).astype(np.float32)
    if name == "boundary":
        # feet at multiples of h = 0.25 along +x: a foot on a step's lower
        # bound belongs to it, on its upper bound to the next
        k = np.arange(40, dtype=np.float32)
        pos[:40] = np.stack([k * np.float32(0.25),
                             np.float32(1.0) + (k % 3) * np.float32(0.05),
                             np.full(40, 1.0, np.float32)], -1)
    elif name == "dense":
        pos[:120] = (np.float32([1.0, 1.0, 1.0])
                     + 0.2 * rs.random_sample((120, 3))).astype(np.float32)
    valid = rs.random_sample(pos.shape[0]) < 0.9
    valid[:40] = True
    o = np.float32([[-0.5, 1.0, 1.0], [-0.5, 1.1, 1.0], [0.0, 0.9, 1.02],
                    [1.05, 1.05, -1.0], [-3.0, -3.0, -3.0]])
    d = np.float32([[1, 0, 0], [1, 0, 0], [1, 0, 0], [0, 0, 1],
                    [0.57735026, 0.57735026, 0.57735026]])
    t_end = np.float32([6.0, 2.5, 30.0, 4.0, 9.0])
    return pos, valid, o, d, t_end


@pytest.mark.parametrize("case", ["boundary", "dense", "random"])
def test_beam_transcription_equals_plain(case):
    pos, valid, o, d, t_end = _beam_case(case)
    g = _grid(pos, valid, 0.25, 32, beam=True)
    n_steps = 40
    lane, idx, sc = pq.beam_pairs_plain(
        g, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_end),
        n_steps, MPC_B)
    want = [(i, k, c) for i in range(o.shape[0])
            for k, c in pq.beam_thread(g, o[i], d[i], t_end[i], n_steps,
                                       MPC_B)]
    assert list(zip(lane.tolist(), idx.tolist(), sc.tolist())) == want
    assert len(want) > 0


# ---------------------------------------------------------------------------
# the plain versions against hairpt's dense masks, gather and beam
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixed():
    return scenes.build(scenes.mixed)


@pytest.fixture(scope="module")
def fog():
    return scenes.build(scenes.fog)


class _Rec:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _lanes(n, seed, lo, hi):
    rs = np.random.RandomState(seed)
    p = rs.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    w = rs.normal(size=(n, 3, 3)).astype(np.float32)
    q, _ = np.linalg.qr(w)
    return p, q.astype(np.float32)


def test_gather_flux_matches_jax(mixed):
    """hairpt's photon pass on the mixed scene, one map in both packages;
    lanes scattered over the photons' box: the count per lane exactly,
    the flux within the bounds."""
    js, cs = mixed
    dep = [np.array(x) for x in jpm.trace_photons(js, 1 << 12, 4, seed=5)]
    mj = jpm.build_photon_map(*[jnp.asarray(x) for x in dep], 0.4)
    mt = tpm.build_photon_map(*[torch.as_tensor(x) for x in dep], 0.4)
    n = 3000
    p, fr = _lanes(n, 6, dep[0][dep[3]].min(0), dep[0][dep[3]].max(0))
    p[:2000] = dep[0][dep[3]][:2000] + np.float32(0.05)
    p[-2:] = np.float32([np.inf, np.nan, 0.0])
    wi = np.abs(np.random.RandomState(7).normal(size=(n, 3))).astype(
        np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    mid = np.zeros(n, np.int32)
    uv = np.zeros((n, 2), np.float32)
    r2 = np.random.RandomState(8).uniform(0.02, 0.16, n).astype(np.float32)
    hj = _Rec(p=jnp.asarray(p), mat_id=jnp.asarray(mid), uv=jnp.asarray(uv))
    frj = _Rec(s=jnp.asarray(fr[:, 0]), t=jnp.asarray(fr[:, 1]),
               n=jnp.asarray(fr[:, 2]))
    acc_j, cnt_j = jpm.gather_flux(mj, js, hj, jnp.asarray(wi), frj,
                                   jnp.asarray(r2))
    ht = _Rec(p=torch.as_tensor(p), mat_id=torch.as_tensor(mid),
              uv=torch.as_tensor(uv))
    frt = _Rec(s=torch.as_tensor(fr[:, 0]), t=torch.as_tensor(fr[:, 1]),
               n=torch.as_tensor(fr[:, 2]))
    acc_t, cnt_t = tpm.gather_flux(mt, cs, ht, torch.as_tensor(wi), frt,
                                   torch.as_tensor(r2))
    lane, _ = pq.surface_pairs(mt.grid(), ht.p, torch.as_tensor(r2))
    np.testing.assert_array_equal(
        np.bincount(lane.numpy(), minlength=n), np.asarray(cnt_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert np.asarray(cnt_j).sum() > 1000
    ok = np.isclose(acc_t.numpy(), np.asarray(acc_j), rtol=FLUX_RTOL,
                    atol=FLUX_ATOL)
    assert ok.mean() >= FLUX_SHARE, ok.mean()


def _jax_beam_mask(vpm, o, d, t_end, n_steps, mpc):
    """hairpt's bre_query loop (photonmap.py:441-473), its near mask as a
    list of (lane, idx, step * 27 + cell) in the loop's order."""
    gr = vpm.grid_res
    h = 1.0 / vpm.inv_cell
    offs = jnp.arange(mpc)
    out = []
    for j in range(n_steps):
        jf = jnp.float32(j)
        t_mid = (jf + 0.5) * h
        p_step = o + d * t_mid
        q_ijk = ((p_step - vpm.grid_min) * vpm.inv_cell).astype(jnp.int32)
        lo_t = jf * h
        hi_t = lo_t + h
        ci = 0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    c = q_ijk + jnp.asarray([dx, dy, dz])
                    okc = jnp.all((c >= 0) & (c < gr), axis=-1)
                    key = (c[:, 0] * gr + c[:, 1]) * gr + c[:, 2]
                    start = jnp.searchsorted(vpm.cell, key)
                    idxs = jnp.minimum(start[:, None] + offs[None, :],
                                       vpm.cell.shape[0] - 1)
                    in_cell = vpm.cell[idxs] == key[:, None]
                    rel = vpm.pos[idxs] - o[:, None]
                    foot = jnp.einsum("nmi,ni->nm", rel, d)
                    b2 = jnp.sum(rel * rel, -1) - foot * foot
                    r2 = vpm.radius[idxs] ** 2
                    own = (foot >= lo_t) & (foot < hi_t)
                    near = in_cell & okc[:, None] & vpm.valid[idxs] \
                        & own & (b2 < r2) & (foot > 0) \
                        & (foot < t_end[:, None])
                    li, si = np.nonzero(np.asarray(near))
                    ix = np.asarray(idxs)[li, si]
                    out += [(int(a), int(b), j * 27 + ci)
                            for a, b in zip(li, ix)]
                    ci += 1
    return sorted(out, key=lambda x: x[0])     # stable: loop order kept


def test_beam_pairs_and_bre_query_match_jax(fog):
    """hairpt's volume photon pass on the fog scene, one map in both
    packages, beams from the camera: the plain pairs equal hairpt's near
    mask exactly; bre_query within the bounds."""
    js, cs = fog
    dep = [np.array(x) for x in
           jpm.trace_volume_photons(js, js.medium, 1 << 12, 6, seed=4)]
    vj = jpm.build_volume_photon_map(*[jnp.asarray(x) for x in dep], 0.35)
    vt = tpm.build_volume_photon_map(*[torch.as_tensor(x) for x in dep],
                                     0.35)
    rs = np.random.RandomState(9)
    n = 400
    o = np.tile(np.float32([[0.0, 0.0, -4.0]]), (n, 1))
    d = rs.normal(size=(n, 3)).astype(np.float32) * np.float32(0.25)
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_end = rs.uniform(2.0, 6.0, n).astype(np.float32)
    n_steps = 18
    want = _jax_beam_mask(vj, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(t_end), n_steps, MPC_B)
    lane, idx, sc = pq.beam_pairs(vt.grid(), torch.as_tensor(o),
                                  torch.as_tensor(d), torch.as_tensor(t_end),
                                  n_steps, MPC_B)
    assert len(want) > 500
    assert list(zip(lane.tolist(), idx.tolist(), sc.tolist())) == want
    acc_j = jpm.bre_query(vj, js.medium, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(t_end), n_steps)
    acc_t = tpm.bre_query(vt, cs.medium, torch.as_tensor(o),
                          torch.as_tensor(d), torch.as_tensor(t_end),
                          n_steps)
    ok = np.isclose(acc_t.numpy(), np.asarray(acc_j), rtol=BRE_RTOL,
                    atol=FLUX_ATOL)
    assert ok.mean() >= FLUX_SHARE and np.asarray(acc_j).max() > 0


# ---------------------------------------------------------------------------
# the renders
# ---------------------------------------------------------------------------

def test_render_photonmap_matches_jax(mixed):
    js, cs = mixed
    scenes.compare(tpm.render_photonmap(cs, 1 << 12, 0.35, 4, 2, seed=1),
                   jpm.render_photonmap(js, 1 << 12, 0.35, 4, 2, seed=1))


def test_render_ppm_matches_jax(mixed):
    js, cs = mixed
    scenes.compare(tpm.render_ppm(cs, 1 << 11, passes=2, radius0=0.4,
                                  spp=1, seed=2),
                   jpm.render_ppm(js, 1 << 11, passes=2, radius0=0.4, spp=1,
                                  seed=2))


def test_render_sppm_matches_jax(mixed):
    js, cs = mixed
    scenes.compare(tpm.render_sppm(cs, 1 << 11, passes=2, radius0=0.4,
                                   seed=3),
                   jpm.render_sppm(js, 1 << 11, passes=2, radius0=0.4,
                                   seed=3))


def test_render_volumetric_photonmap_matches_jax(fog):
    js, cs = fog
    scenes.compare(tpm.render_volumetric_photonmap(cs, 1 << 11, 0.35, 6,
                                                   spp=1, n_steps=20),
                   jpm.render_volumetric_photonmap(js, 1 << 11, 0.35, 6,
                                                   spp=1, n_steps=20))


def test_grid_medium_is_refused_where_jax_fails(fog):
    """hairpt's volumetric branch reads the fog's depth and fails on a
    grid medium (HeteroMedium has none); the port refuses it up front."""
    js, cs = fog
    data = np.full((4, 4, 4), 0.5, np.float32)
    box = ((-2.0, -4.0, -2.0), (2.0, 2.0, 2.0))
    jh = jmed.make_hetero_medium(jmed.make_grid_volume(data, *box),
                                 (0.3,) * 3, (0.05,) * 3)
    th = tmed.make_hetero_medium(tmed.make_grid_volume(data, *box,
                                                       device="cpu"),
                                 (0.3,) * 3, (0.05,) * 3)
    with pytest.raises(AttributeError, match="fog_depth"):
        jpm.render_volumetric_photonmap(js._replace(medium=jh), 64, 0.35,
                                        2, spp=1, n_steps=2)
    with pytest.raises(NotImplementedError, match="homogeneous"):
        tpm.render_volumetric_photonmap(cs._replace(medium=th), 64, 0.35,
                                        2, spp=1, n_steps=2)
