"""Path-replay backprop (hairpt_torch/integrators/prb.py) against the
port's differentiable mode, which tests/test_torch_grad.py holds to the
JAX package, on the small furball of tests/torch_furball.py. PRB replays
the same estimator with O(1) memory in depth: with RR off (rr_depth 999)
and no shadow-ray RR the two must agree to float tolerance, with the
JAX package's own bounds (tests/test_prb.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from hairpt_torch.integrators import inverse as tinv
from hairpt_torch.integrators import path as tpath
from torch_furball import GRAD_PARAMS, jax_furball, params_of, torch_scene
from torch_threads import one_thread  # noqa: F401

RES = 32
N = RES * RES
LOSS_RTOL = 1e-4
GRAD_ATOL = 5e-3       # of each parameter's largest |g|


@pytest.fixture(scope="module")
def base():
    scene = jax_furball(res=RES, depth=3, nee_rr=0.0, rr_depth=999)
    params = {k: torch.as_tensor(v) for k, v in params_of(scene).items()}
    return torch_scene(scene), params


def _depth(ts, depth, **cfg):
    return ts._replace(config=dataclasses.replace(ts.config,
                                                  max_depth=depth, **cfg))


def _lanes():
    return torch.arange(N), torch.zeros(N, dtype=torch.int64)


def _scan_ad(ts, params):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    li = tpath.make_li_fn(ts, differentiable=True)
    rad, _, _ = li(tinv.apply_params_arrays(ts.arrays, leaves,
                                            ts.marschner_rows), *_lanes())
    loss = rad.mean()
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("depth", [3, 5])
def test_prb_matches_scan_ad(base, depth):
    ts, params = base
    ts = _depth(ts, depth)
    l_scan, g_scan = _scan_ad(ts, params)
    l_prb, g_prb = tinv.make_prb_loss_grad(ts)(ts.arrays, params, *_lanes())
    assert float(l_prb) == pytest.approx(l_scan, rel=LOSS_RTOL)
    for k in GRAD_PARAMS:
        a, b = g_scan[k].numpy(), g_prb[k].numpy()
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b / scale, a / scale, atol=GRAD_ATOL,
                                   err_msg=k)


def test_prb_deep_path_finite_and_consistent(base):
    """Depth 16 with RR on (rr_depth 5): the gradient stays finite, and
    the red diffuse component has the depth-6 estimate's sign."""
    ts, params = base
    f6 = tinv.make_prb_loss_grad(_depth(ts, 6, rr_depth=5))
    f16 = tinv.make_prb_loss_grad(_depth(ts, 16, rr_depth=5))
    g6 = f6(ts.arrays, params, *_lanes())[1]
    g16 = f16(ts.arrays, params, *_lanes())[1]
    for k in GRAD_PARAMS:
        assert torch.isfinite(g16[k]).all(), k
    assert float(g6["diffuse"][0, 0]) * float(g16["diffuse"][0, 0]) > 0


def test_prb_refuses_shadow_ray_rr(base):
    ts, _ = base
    ts = ts._replace(config=dataclasses.replace(ts.config, nee_rr=0.01))
    with pytest.raises(ValueError):
        tinv.make_prb_loss_grad(ts)
