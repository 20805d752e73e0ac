"""bench.py's north-star furball through the port's SceneBuilder."""
from __future__ import annotations

import numpy as np

from ..core import rng
from ..film.film import Film
from ..models import emitters as em
from ..models.bsdf import registry as mat
from ..models.sensors import Camera
from . import hairgen
from .scene import Scene, SceneBuilder

CAM_TO_WORLD = np.array([
    [-0.704024, 0.0939171, 0.703939, -10.6677],
    [1.05829e-08, 0.991217, -0.132245, 14.3141],
    [-0.710177, -0.0931033, -0.69784, 10.2879],
    [0, 0, 0, 1]])


DIFFUSE = (0.143016, 0.0156076, 1.80928e-05)

# the furball's materials: bench.py's rough plastic, and the corrected-mode
# Marschner hair BSDF with examples/inverse_furball.py's parameters
MATERIALS = {
    "roughplastic": dict(kind=mat.ROUGHPLASTIC, alpha=0.2, eta=1.55, dist=0,
                         diffuse=DIFFUSE),
    "marschner": dict(kind=mat.MARSCHNER_PURE, sigma_a=(0.5, 0.5, 0.5),
                      beta_r=0.1, eta=1.55, alpha=0.2, dist=0,
                      diffuse=DIFFUSE),
}


def furball_scene(quality: float = 14.0, res: int = 1024, depth: int = 65,
                  spp: int = 1, device=None, q: int = 2048,
                  nee_rr: float = 0.01, traversal: str = "tiled",
                  material: str = "roughplastic") -> Scene:
    """quality 14 is bench.py's full width: 84,000 fibers x 12 segments;
    the baked sunsky, true Sobol'. material: 'roughplastic' (alpha 0.2,
    eta 1.55, bench.py's), 'marschner' (MARSCHNER_PURE, sigma_a 0.5,
    beta_R 0.1, eta 1.55, alpha 0.2, bench.py's diffuse) or a material
    row for SceneBuilder.add_material. traversal
    'swept' takes the JAX package's swept defaults (p_max 24, chunks of
    64 pairs)."""
    b = SceneBuilder(device=device)
    m = b.add_material(**dict(MATERIALS[material] if isinstance(material, str)
                              else material))
    b.add_fibers(hairgen.gen_furball(n_fibers=int(6000 * quality),
                                     radius=0.00216667), m)
    b.env = em.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                           sky_scale=5.0, sun_scale=19.0912,
                           sun_radius_scale=37.9165, res=256,
                           device=b.device)
    cam = Camera.perspective(CAM_TO_WORLD, 35.0, res, res)
    m_res = max(1, int(np.ceil(np.log2(res))))
    return b.build(cam, Film.make(res, res, "tent"), spp=spp,
                   max_depth=depth, sampler=(rng.SOBOL_QMC, m_res, res),
                   traversal=traversal, swept_k=128, tiled_q=q,
                   nee_rr=nee_rr)
