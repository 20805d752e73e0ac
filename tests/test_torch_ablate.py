"""make_li_fn's ablate knobs in the port against hairpt's, on the CPU: one
wave of the small furball (tests/torch_furball.py: hairpt's tiled
traversal with its Pallas kernels in interpret mode, the port's plain
versions) under ('nonee',) and under ('noshadow', 'cheapshade',
'nosort'), each knob set against hairpt's wave under the same knobs,
with tests/test_torch_path.py's per-pixel tolerance (99% of the values
within 1e-3 relative + 1e-4 absolute). Two JAX compiles, one per knob
set; ablate=() is every other wave test's."""
import jax
import numpy as np
import pytest
import torch

from hairpt.integrators import path as jpath
from hairpt_torch.integrators import path as tpath
from torch_furball import jax_furball, torch_scene
from torch_threads import one_thread  # noqa: F401

RES = 32


@pytest.fixture(scope="module")
def scenes():
    scene = jax_furball(res=RES, depth=3)
    return scene, torch_scene(scene)


def _waves(scenes, knobs):
    scene, ts = scenes
    pix = np.arange(RES * RES, dtype=np.int32)
    smp = np.zeros_like(pix)
    li_j = jax.jit(jpath.make_li_fn(scene, ablate=knobs))
    rad_j, _, n_j = li_j(scene.arrays, pix, smp)
    li_t = tpath.make_li_fn(ts, ablate=knobs)
    rad_t, _, n_t = li_t(ts.arrays, torch.as_tensor(pix, dtype=torch.int64),
                         torch.as_tensor(smp, dtype=torch.int64))
    return np.asarray(rad_j), rad_t.numpy(), float(n_j), float(n_t)


@pytest.mark.parametrize("knobs", [("nonee",),
                                   ("noshadow", "cheapshade", "nosort")],
                         ids=lambda k: "+".join(k))
def test_ablated_wave_matches_hairpt(scenes, knobs):
    rad_j, rad_t, n_j, n_t = _waves(scenes, knobs)
    assert rad_t.shape == rad_j.shape == (RES * RES, 3)
    assert np.isfinite(rad_t).all() and rad_j.mean() > 0
    close = np.isclose(rad_t, rad_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()
    assert abs(n_t - n_j) <= 0.01 * n_j
    # the knobs took effect: the port's wave is not its unablated one
    full = _default_wave(scenes)
    assert not np.allclose(rad_t, full, rtol=1e-3, atol=1e-4)
    if knobs == ("nonee",):
        assert rad_t.mean() < full.mean()


def _default_wave(scenes):
    ts = scenes[1]
    pix = torch.arange(RES * RES)
    return tpath.make_li_fn(ts)(ts.arrays, pix,
                                torch.zeros_like(pix))[0].numpy()


def test_unknown_knob_raises(scenes):
    with pytest.raises(ValueError, match="ablate"):
        tpath.make_li_fn(scenes[1], ablate=("nofilm",))
