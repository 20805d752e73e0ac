"""The light tracers' building blocks in hairpt_torch against hairpt, on
the CPU: the emitted-ray samplers area_emit and delta_emit (each delta
kind), the pinhole camera_importance, the film's splat_add_only, the
photon, volume-photon and VPL passes' deposits (trace_photons,
trace_volume_photons, trace_vpls) on the small scenes of
tests/torch_light_scenes.py, and the photon maps' builds
(build_photon_map, build_volume_photon_map) from the same deposits, whose
order and keys must be exact.

Bounds: the samplers and the camera 1e-5 relative + 1e-6 (the same f32
arithmetic but for the transcendental functions' last bits); the
deposits 1e-4 relative + 1e-5 on >= 99% of the values and the flags
equal on >= 99% of the slots (a traced photon's hit point differs in
the last bits between the two packages' triangle tests, and a last-bit
change can move a Russian-roulette or a free-flight decision, after
which that photon's path differs). Each JAX function is traced once."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.film.film import Film as JFilm
from hairpt.film import film as jfilm
from hairpt.integrators import photonmap as jpm
from hairpt.integrators import vpl as jvpl
from hairpt.models import emitters as jem
from hairpt.models import sensors as jsens
from hairpt_torch.film import film as tfilm
from hairpt_torch.integrators import photonmap as tpm
from hairpt_torch.integrators import vpl as tvpl
from hairpt_torch.models import emitters as tem
from hairpt_torch.models import sensors as tsens
import torch_light_scenes as scenes
from torch_threads import one_thread  # noqa: F401

N = 4096
RTOL, ATOL = 1e-5, 1e-6
DEP_RTOL, DEP_ATOL, DEP_SHARE = 1e-4, 1e-5, 0.99


@pytest.fixture(scope="module")
def mixed():
    return scenes.build(scenes.mixed)


@pytest.fixture(scope="module")
def fog():
    return scenes.build(scenes.fog)


def _u(seed, shape):
    return np.random.RandomState(seed).random_sample(shape).astype(
        np.float32)


def _close(a, b, rtol=RTOL, atol=ATOL, share=1.0):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if b.dtype == bool or a.dtype == bool:
        assert (a == b).mean() >= share, (a == b).mean()
        return
    ok = np.isclose(a.astype(np.float64), b.astype(np.float64), rtol=rtol,
                    atol=atol) | (np.isnan(a) & np.isnan(b))
    assert ok.mean() >= share, (ok.mean(), np.abs(a - b).max())


def test_area_emit_matches_jax(mixed):
    js, cs = mixed
    u_sel, u_tri, u_dir = _u(0, N), _u(1, (N, 2)), _u(2, (N, 2))
    out_j = jem.area_emit(js.arrays.area, jnp.asarray(u_sel),
                          jnp.asarray(u_tri), jnp.asarray(u_dir))
    out_t = tem.area_emit(cs.arrays.area, torch.as_tensor(u_sel),
                          torch.as_tensor(u_tri), torch.as_tensor(u_dir))
    for a, b in zip(out_t, out_j):
        _close(a, b)


DELTA = {
    "point": dict(kind=jem.POINT, position=(-1.0, 2.0, 0.5),
                  intensity=(3.0, 2.0, 1.0)),
    "spot": dict(kind=jem.SPOT, position=(1.5, 3.0, -1.0),
                 direction=(-0.3, -1.0, 0.2), intensity=(10.0, 9.0, 8.0),
                 cutoff_deg=30.0, beam_deg=20.0),
    "directional": dict(kind=jem.DIRECTIONAL, direction=(0.3, -1.0, 0.2),
                        intensity=(0.4, 0.35, 0.3)),
    "collimated": dict(kind=jem.COLLIMATED, position=(0.0, 3.0, 0.0),
                       direction=(0.0, -1.0, 0.0), intensity=(5.0, 5.0, 5.0)),
}


@pytest.mark.parametrize("kind", list(DELTA))
def test_delta_emit_matches_jax(kind):
    """One light of each kind beside a point light (so the selection CDF
    has two entries): origin, direction, power, index and probability."""
    entries = [DELTA[kind], DELTA["point"]]
    jd = jem.make_delta_lights(entries)
    td = tem.make_delta_lights(entries, device="cpu")
    u_sel, u_dir = _u(3, N), _u(4, (N, 2))
    center, radius = np.float32([0.1, -0.2, 0.3]), np.float32(2.5)
    o_j, d_j, pw_j, (l_j, p_j) = jem.delta_emit(
        jd, jnp.asarray(u_sel), jnp.asarray(u_dir), jnp.asarray(center),
        jnp.asarray(radius))
    o_t, d_t, pw_t, (l_t, p_t) = tem.delta_emit(
        td, torch.as_tensor(u_sel), torch.as_tensor(u_dir),
        torch.as_tensor(center), torch.as_tensor(radius))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    for a, b in ((o_t, o_j), (d_t, d_j), (pw_t, pw_j), (p_t, p_j)):
        _close(a, b)


def test_camera_importance_matches_jax(mixed):
    """Points in front of, beside and behind the camera."""
    js, cs = mixed
    rs = np.random.RandomState(5)
    p = (rs.normal(size=(N, 3)) * 3.0).astype(np.float32)
    out_j = jsens.camera_importance(js.camera, jnp.asarray(p))
    out_t = tsens.camera_importance(cs.camera, torch.as_tensor(p))
    assert 0.05 < out_t[4].float().mean() < 0.95
    for a, b in zip(out_t, out_j):
        _close(a, b)


def test_splat_add_only_matches_jax():
    """Positions on, beside and off the film (the clip-and-drop rule),
    many on one pixel."""
    rs = np.random.RandomState(6)
    fl = JFilm.make(12, 8, "box")
    tf = tfilm.Film(12, 8, fl.filter_kind, fl.filter_radius, fl.gamma)
    pos = np.concatenate([
        rs.uniform(-3.0, 15.0, size=(N, 2)),
        np.float32([[0.0, 0.0], [12.0, 3.0], [11.999, 7.999], [-0.0, 8.0],
                    [3.5, 2.5]] * 8)]).astype(np.float32)
    val = rs.random_sample((pos.shape[0], 3)).astype(np.float32)
    img0 = rs.random_sample((8, 12, 3)).astype(np.float32)
    out_j = jfilm.splat_add_only(fl, jnp.asarray(pos), jnp.asarray(val),
                                 jnp.asarray(img0))
    out_t = tfilm.splat_add_only(tf, torch.as_tensor(pos),
                                 torch.as_tensor(val),
                                 torch.as_tensor(img0.copy()))
    _close(out_t, out_j)


def _deposits(out_t, out_j, n_fields):
    """Flags equal on >= DEP_SHARE; each float field within the bounds on
    >= DEP_SHARE of the slots that are valid in both."""
    valid_t = out_t[n_fields - 1].numpy()
    valid_j = np.asarray(out_j[n_fields - 1])
    assert valid_j.sum() > 100
    assert (valid_t == valid_j).mean() >= DEP_SHARE
    both = valid_t & valid_j
    for a, b in zip(out_t[:n_fields - 1], out_j[:n_fields - 1]):
        a, b = a.numpy()[both], np.asarray(b)[both]
        if a.dtype.kind in "iu":
            assert (a == b).mean() >= DEP_SHARE
        else:
            _close(a, b, DEP_RTOL, DEP_ATOL, DEP_SHARE)


def test_trace_photons_match_jax(mixed):
    js, cs = mixed
    _deposits(tpm.trace_photons(cs, 1 << 11, 4, seed=3),
              jpm.trace_photons(js, 1 << 11, 4, seed=3), 4)


def test_trace_volume_photons_match_jax(fog):
    js, cs = fog
    _deposits(tpm.trace_volume_photons(cs, cs.medium, 1 << 11, 6, seed=2),
              jpm.trace_volume_photons(js, js.medium, 1 << 11, 6, seed=2), 4)


def test_trace_vpls_match_jax(mixed):
    js, cs = mixed
    vt = tvpl.trace_vpls(cs, 256, 3, seed=1)
    vj = jvpl.trace_vpls(js, 256, 3, seed=1)
    _deposits(tuple(vt), tuple(vj), 10)


def _same_inputs(seed, m, lo, hi):
    """Deposits with clustered positions (dense cells), invalid slots
    with non-finite positions, shared by both builds."""
    rs = np.random.RandomState(seed)
    pos = rs.uniform(lo, hi, size=(m, 3)).astype(np.float32)
    pos[: m // 4] = (pos[: m // 4] * 0.05).astype(np.float32)
    valid = rs.random_sample(m) < 0.8
    pos[~valid] = np.float32([np.inf, np.nan, 0.0])
    pw = rs.random_sample((m, 3)).astype(np.float32)
    wi = rs.normal(size=(m, 3)).astype(np.float32)
    return pos, pw, wi, valid


def test_build_photon_map_is_exact():
    pos, pw, wi, valid = _same_inputs(7, 5000, -2.0, 3.0)
    mj = jpm.build_photon_map(jnp.asarray(pos), jnp.asarray(pw),
                              jnp.asarray(wi), jnp.asarray(valid), 0.3,
                              grid_res=32)
    mt = tpm.build_photon_map(*[torch.as_tensor(x) for x in
                                (pos, pw, wi, valid)], 0.3, grid_res=32)
    for f in ("pos", "power", "wi", "cell", "valid", "grid_min"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(mj, f)), err_msg=f)
    assert mt.inv_cell == float(mj.inv_cell) and mt.grid_res == mj.grid_res


def test_build_volume_photon_map_is_exact():
    """The hash shuffle, the stable sort and the keys exactly; the
    density-adapted radii within 1e-6 relative (a cube root)."""
    pos, pw, wi, valid = _same_inputs(8, 6000, -3.0, 4.0)
    mj = jpm.build_volume_photon_map(jnp.asarray(pos), jnp.asarray(pw),
                                     jnp.asarray(wi), jnp.asarray(valid),
                                     0.25, grid_res=32)
    mt = tpm.build_volume_photon_map(*[torch.as_tensor(x) for x in
                                       (pos, pw, wi, valid)], 0.25,
                                     grid_res=32)
    for f in ("pos", "power", "wi", "cell", "valid", "grid_min"):
        np.testing.assert_array_equal(getattr(mt, f).numpy(),
                                      np.asarray(getattr(mj, f)), err_msg=f)
    np.testing.assert_allclose(mt.radius.numpy(), np.asarray(mj.radius),
                               rtol=1e-6)
