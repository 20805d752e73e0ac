"""The instanced stand-in (hairpt_torch.scene.scene_xmls.instanced)
rendered small by the port's loader and render against hairpt's render
of the same scene, on the CPU. hairpt's loader raises on the stand-in's
bitmap texture (ROADMAP Queue C), so its side is built by hand through
its SceneBuilder (tests/torch_instanced.py); the port's loader is held
to that build tensor for tensor in tests/test_torch_instancing.py. A
file of its own: hairpt's compile of the stand-in's render takes most of
a minute on a CPU."""
import os

import numpy as np

from hairpt.integrators import path as jpath
from hairpt.ops import bvh as jbvh
from hairpt_torch.integrators import path as tpath
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from torch_instanced import hand_build
from torch_threads import one_thread  # noqa: F401


def test_instanced_standin_render_matches_jax(monkeypatch, tmp_path):
    """The instanced stand-in with its 2 x 2 instance grid (hairpt's
    compile of the 64-instance loop takes over a minute on a CPU) at
    64 x 36, depth 3, the padded Sobol' sampler, 1 spp: the port's loader and
    render against hairpt's render of the same scene built by hand: the
    image mean within 1e-3 relative and >= 99% of pixel values within
    1e-3 relative + 1e-4."""
    monkeypatch.setattr(jbvh, "_NATIVE", tbvh._load_native())
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)
    xml = scene_xmls.write_scene(str(tmp_path), "instanced", grid=2)
    ts = txl.load_scene(xml, res_scale=0.05, spp_override=1,
                        max_depth_override=3, device="cpu")
    js = hand_build("hairpt", os.path.dirname(xml), grid=2)
    assert js.config.traversal == "packed" and len(js.arrays.inst.w2o) == 4
    img_j = np.asarray(jpath.render(js, spp=1))
    img_t = tpath.render(ts, spp=1).numpy()
    assert img_t.shape == img_j.shape == (36, 64, 3) and img_j.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 1e-3
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()
