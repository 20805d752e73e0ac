"""The small furball of the port's gradient tests, as
tests/test_torch_path.py builds it: bench.py's furball at quality 0.02
(120 fibers, 1,440 segments, C = 12 clusters of 128), fibers 20x thicker
and a 12-degree view so hair covers a good share of the film; true
Sobol', q < C so the completion loop runs. Built by hairpt and carried
across with hairpt_torch.convert."""
import dataclasses

import jax
import numpy as np

from hairpt.core import rng as jrng
from hairpt.film.film import Film as JFilm
from hairpt.models import emitters as jem
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.scene import hairgen as jh
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt_torch import convert

CAM = np.array([[-0.704024, 0.0939171, 0.703939, -10.6677],
                [1.05829e-08, 0.991217, -0.132245, 14.3141],
                [-0.710177, -0.0931033, -0.69784, 10.2879],
                [0, 0, 0, 1]])
DIFFUSE = (0.143016, 0.0156076, 1.80928e-05)
GRAD_PARAMS = ("diffuse", "specular", "alpha", "eta")


def jax_furball(res=32, depth=3, nee_rr=0.01, q=8, rr_depth=5):
    b = JSceneBuilder()
    m = b.add_material(kind=jmat.ROUGHPLASTIC, alpha=0.2, eta=1.55, dist=0,
                       diffuse=DIFFUSE)
    b.add_fibers(jh.gen_furball(n_fibers=120, radius=0.00216667 * 20), m)
    b.env = jem.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                            sky_scale=5.0, sun_scale=19.0912,
                            sun_radius_scale=37.9165, res=32)
    cam = JCamera.perspective(CAM, 12.0, res, res)
    m_res = max(1, int(np.ceil(np.log2(res))))
    scene = b.build(cam, JFilm.make(res, res, "tent"), spp=1,
                    max_depth=depth, sampler=(jrng.SOBOL_QMC, m_res, res),
                    traversal="tiled", swept_k=128, tiled_q=q, nee_rr=nee_rr)
    return scene._replace(config=dataclasses.replace(scene.config,
                                                     rr_depth=rr_depth))


def torch_scene(scene):
    arrays = jax.tree_util.tree_map(np.asarray, scene.arrays)
    return convert.convert_scene(scene, arrays, device="cpu")


def params_of(scene):
    """The material fields the gradient tests differentiate, as numpy."""
    mt = scene.arrays.materials
    return {k: np.array(getattr(mt, k)) for k in GRAD_PARAMS}
