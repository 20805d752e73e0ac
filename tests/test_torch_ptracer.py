"""The adjoint particle tracer of hairpt_torch against hairpt's, on the
CPU (the scenes of tests/torch_light_scenes.py): the area-lit box, the
sphere under the environment, the mixed scene (environment, area, point
and spot lights: every emitter group and the s = 1 splats of the area
and the finite delta lights), the point light of the fog scene without
its fog, and the hair stand-in.

Bounds: torch_light_scenes.compare's (the mean within 2e-3 relative,
>= 97% of the pixel values within 1e-3 relative + 1e-4). Each JAX render
is compiled once."""
import pytest

from hairpt.integrators import ptracer as jpt
from hairpt_torch.integrators import ptracer as tpt
import torch_light_scenes as scenes
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("make", ["box", "sphere", "mixed", "fog", "hair"])
def test_render_ptracer_matches_jax(make):
    js, cs = scenes.build(getattr(scenes, make), res=12)
    if make == "fog":
        js, cs = js._replace(medium=None), cs._replace(medium=None)
    scenes.compare(tpt.render_ptracer(cs, n_paths=1 << 11, s_max=4, seed=2),
                   jpt.render_ptracer(js, n_paths=1 << 11, s_max=4, seed=2))


def test_ptracer_wave_count_follows_the_spp_budget():
    """max(1, W H spp // (4 n_paths)) waves: two at 16^2, 16 spp, 512
    paths; each wave's particles are a fresh seed (the image differs
    from one wave's)."""
    js, cs = scenes.build(scenes.box, res=16, spp=16)
    waves = []
    tpt.render_ptracer(cs, n_paths=512, s_max=2,
                       progress=lambda d, t, s, n: waves.append((d, t, n)))
    assert waves == [(1, 2, 512.0), (2, 2, 512.0)]
