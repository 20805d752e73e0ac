"""The bidirectional path tracer of hairpt_torch against hairpt's, on the
CPU (the scenes of tests/torch_light_scenes.py): generate_paths' eye and
light subpaths field by field, each (s, t) strategy's image alone
(render_bdpt's `strategies`, the MIS weights unchanged) on the mixed
scene at s_max = t_max = 3, and the whole render on the area-lit box,
the mixed scene (environment and area light; bdpt samples no delta
light, in either package) and the hair stand-in.

Bounds: the subpaths' fields 1e-4 relative + 1e-5 on >= 99% of the
valid vertices' values, the flags equal on >= 99%; the images
torch_light_scenes.compare's (the mean within 2e-3 relative, >= 97% of
the pixel values within 1e-3 relative + 1e-4), a strategy whose image
is black in hairpt black in the port within 1e-6. Each JAX render is
compiled once (one per strategy)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.integrators import bdpt as jbd
from hairpt_torch.integrators import bdpt as tbd
import torch_light_scenes as scenes
from torch_threads import one_thread  # noqa: F401

S_MAX = T_MAX = 3
STRATEGIES = [(0, 2), (0, 3)] + [(s, t) for s in (1, 2, 3)
                                 for t in (2, 3)] + [(2, 1), (3, 1)]


@pytest.fixture(scope="module")
def mixed():
    return scenes.build(scenes.mixed, res=8, depth=5)


def test_generate_paths_match_jax(mixed):
    js, cs = mixed
    n = js.config.width * js.config.height
    ej, lj = jbd.generate_paths(js, js.arrays, jnp.arange(n, dtype=jnp.uint32),
                                jnp.full((n,), 3, jnp.uint32), T_MAX, S_MAX)
    et, lt = tbd.generate_paths(cs, cs.arrays, torch.arange(n),
                                torch.full((n,), 3), T_MAX, S_MAX)
    for pj, pt in ((ej, et), (lj, lt)):
        valid_j = np.asarray(pj.valid)
        valid_t = pt.valid.numpy()
        assert (valid_j == valid_t).mean() >= 0.99 and valid_j[1:].any()
        both = valid_j & valid_t
        for f in jbd.VPath._fields:
            a = getattr(pt, f).numpy()
            b = np.asarray(getattr(pj, f))
            assert a.shape == b.shape, f
            a, b = a[both], b[both]
            if b.dtype == bool or b.dtype.kind in "iu":
                assert (a == b).mean() >= 0.99, f
            else:
                ok = np.isclose(a, b, rtol=1e-4, atol=1e-5)
                assert ok.mean() >= 0.99, (f, ok.mean())


@pytest.mark.parametrize("st", STRATEGIES, ids=lambda st: f"s{st[0]}_t{st[1]}")
def test_strategy_image_matches_jax(mixed, st):
    js, cs = mixed
    img_j = np.asarray(jbd.render_bdpt(js, spp=1, s_max=S_MAX, t_max=T_MAX,
                                       strategies={st}))
    img_t = tbd.render_bdpt(cs, spp=1, s_max=S_MAX, t_max=T_MAX,
                            strategies={st})
    if img_j.max() == 0:
        assert float(img_t.abs().max()) <= 1e-6
        return
    scenes.compare(img_t, img_j)


@pytest.mark.parametrize("make", ["box", "mixed", "hair"])
def test_render_bdpt_matches_jax(make):
    js, cs = scenes.build(getattr(scenes, make), res=12)
    scenes.compare(tbd.render_bdpt(cs, spp=2, s_max=3, t_max=3, seed=1),
                   jbd.render_bdpt(js, spp=2, s_max=3, t_max=3, seed=1))
