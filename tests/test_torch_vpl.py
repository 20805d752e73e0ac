"""Instant radiosity (virtual point lights) of hairpt_torch against
hairpt's, on the CPU (the scenes of tests/torch_light_scenes.py): the
VPL set of the mixed scene (every emitter group emits) and the renders
of the sphere under the environment, the mixed scene and the hair
stand-in.

Bounds: the VPL deposits 1e-4 relative + 1e-5 on >= 99% of the values of
the VPLs valid in both, the flags equal on >= 99%; the images
torch_light_scenes.compare's. Each JAX render is compiled once."""
import numpy as np
import pytest

from hairpt.integrators import vpl as jvpl
from hairpt_torch.integrators import vpl as tvpl
import torch_light_scenes as scenes
from torch_threads import one_thread  # noqa: F401


def test_vpl_set_matches_jax():
    js, cs = scenes.build(scenes.mixed)
    vt = tvpl.trace_vpls(cs, 512, 3, seed=4)
    vj = jvpl.trace_vpls(js, 512, 3, seed=4)
    valid_t, valid_j = vt.valid.numpy(), np.asarray(vj.valid)
    assert valid_j.sum() > 200 and (valid_t == valid_j).mean() >= 0.99
    both = valid_t & valid_j
    for f in tvpl.VPLSet._fields[:-1]:
        a = getattr(vt, f).numpy()[both]
        b = np.asarray(getattr(vj, f))[both]
        if b.dtype.kind in "iu":
            assert (a == b).mean() >= 0.99, f
        else:
            assert np.isclose(a, b, rtol=1e-4, atol=1e-5).mean() >= 0.99, f


@pytest.mark.parametrize("make", ["sphere", "mixed", "hair"])
def test_render_vpl_matches_jax(make):
    js, cs = scenes.build(getattr(scenes, make), res=12)
    scenes.compare(tvpl.render_vpl(cs, n_paths=16, spp=2, seed=1),
                   jvpl.render_vpl(js, n_paths=16, spp=2, seed=1))

