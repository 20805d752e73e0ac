"""bench.py's north-star furball through the port's SceneBuilder, alone
or over a checkerboard floor."""
from __future__ import annotations

import numpy as np

from ..core import rng
from ..film.film import Film
from ..models import emitters as em
from ..models import shapes as shp
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


# the floor of furball_floor_scene: the rectangle ([-1, 1]^2, +z) scaled
# by 8, turned to face +y and put under the fur's droop at y = 7; a
# twosided diffuse with a checkerboard of 8 x 8 tiles per uv unit
FLOOR_TO_WORLD = np.array([[8.0, 0.0, 0.0, 0.0],
                           [0.0, 0.0, 8.0, 7.0],
                           [0.0, -8.0, 0.0, 0.0],
                           [0.0, 0.0, 0.0, 1.0]])
FLOOR_CHECKER = dict(color0=(0.7, 0.7, 0.7), color1=(0.15, 0.15, 0.15),
                     uscale=8.0, vscale=8.0)


def furball_floor_scene(quality: float = 0.1, res: int = 64, depth: int = 8,
                        spp: int = 1, device=None, q: int = 64,
                        traversal: str = "tiled") -> Scene:
    """The furball (bench.py's rough plastic; below quality 1 the fibers
    thicken by 1 / sqrt(quality), the scene loader's stand-in rule, which
    keeps the fur's coverage) over a checkerboard rectangle, framed by
    bench.py's camera:
    a hair scene with a mesh in it, its hair through the tiled, swept or
    packed traversal and its triangles through the packed walk. No
    shadow-ray RR."""
    b = SceneBuilder(device=device)
    m = b.add_material(**MATERIALS["roughplastic"])
    tex = b.add_checkerboard(**FLOOR_CHECKER)
    floor = b.add_material(kind=mat.DIFFUSE, twosided=True, tex_id=tex)
    b.add_mesh(shp.rectangle(), floor, to_world=FLOOR_TO_WORLD)
    b.add_fibers(hairgen.gen_furball(
        n_fibers=int(6000 * quality),
        radius=0.00216667 / np.sqrt(min(quality, 1.0))), m)
    b.env = em.bake_sunsky((-0.376047, 0.758426, 0.532333), turbidity=3.0,
                           sky_scale=5.0, sun_scale=19.0912,
                           sun_radius_scale=37.9165, res=256,
                           device=b.device)
    cam = Camera.perspective(CAM_TO_WORLD, 35.0, res, res)
    m_res = max(1, int(np.ceil(np.log2(res))))
    return b.build(cam, Film.make(res, res, "tent"), spp=spp,
                   max_depth=depth, sampler=(rng.SOBOL_QMC, m_res, res),
                   traversal=traversal, swept_k=128, tiled_q=q)
