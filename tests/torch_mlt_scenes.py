"""Small scenes for the path-space MLT, manifold walk and motion-vector
tests of the port (test_torch_mlt.py, test_torch_mlt_chains.py,
test_torch_manifold.py, test_torch_motion_vectors.py), built by hairpt's
SceneBuilder with its CPU default, the packed BVH walk (no Pallas kernel),
and carried across with hairpt_torch.convert (torch_light_scenes.build).

  mirror_box   the diffuse box with a mirror back wall and a small lamp of
               tests/test_mlt_mutators.py: E-D-S-D, E-D-D-S-D and
               E-S-D-S-D trajectories occur
  sphere_mesh  the unit mirror sphere of tests/test_manifold.py
  plane_mesh   the refraction plane of tests/test_manifold.py
"""
import numpy as np

from hairpt.core.math import matrix_lookat
from hairpt.film.film import Film
from hairpt.models import shapes as shp
from hairpt.models.bsdf import registry as R
from hairpt.models.sensors import Camera
from hairpt.scene.scene import SceneBuilder


def mirror_box(res=16, radiance=(14.0, 13.0, 11.0)):
    b = SceneBuilder()
    white = b.add_material(kind=R.DIFFUSE, diffuse=(0.65, 0.65, 0.65))
    green = b.add_material(kind=R.DIFFUSE, diffuse=(0.2, 0.65, 0.2))
    mirror = b.add_material(kind=R.CONDUCTOR, specular=(0.9, 0.9, 0.9),
                            eta=0.2, k=(3.9, 3.9, 3.9))
    quad = shp.rectangle()
    rot_floor = np.array([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0],
                          [0, 0, 0, 1]], np.float64)
    sc = np.diag([2.0, 2.0, 1.0, 1.0])
    tr = np.eye(4)
    tr[:3, 3] = [0, 0, 1.0]
    b.add_mesh(quad, white, to_world=tr @ rot_floor @ sc)
    back = np.eye(4)
    back[:3, 3] = [0, 1.0, 3.0]
    b.add_mesh(quad, mirror, to_world=back @ np.diag([1.0, 1.0, -1.0, 1.0])
               @ sc)
    left = np.array([[0, 0, 1, -1.8], [0, 1, 0, 1.0], [-1, 0, 0, 1.0],
                     [0, 0, 0, 1]], np.float64)
    b.add_mesh(quad, green, to_world=left @ sc)
    right = np.array([[0, 0, -1, 1.8], [0, 1, 0, 1.0], [1, 0, 0, 1.0],
                      [0, 0, 0, 1]], np.float64)
    b.add_mesh(quad, white, to_world=right @ sc)
    ceil = np.array([[1, 0, 0, 0], [0, 0, 1, 2.5], [0, -1, 0, 1.0],
                     [0, 0, 0, 1]], np.float64)
    b.add_mesh(quad, white, to_world=ceil @ sc)
    s_l = 0.35
    lamp = np.array([[s_l, 0, 0, 0.4], [0, 0, -s_l, 2.2], [0, s_l, 0, 0.8],
                     [0, 0, 0, 1]], np.float64)
    b.add_mesh(quad, white, to_world=lamp, radiance=radiance)
    cam = Camera.perspective(matrix_lookat((0.3, 1.2, -2.6), (0, 0.8, 1.0),
                                           (0, 1, 0)), 55.0, res, res)
    return b.build(cam, Film.make(res, res, "box"), spp=1, max_depth=6,
                   sampler=0, rr_depth=99, traversal="packed")


def _single_mesh(mesh):
    b = SceneBuilder()
    mid = b.add_material(kind=R.DIFFUSE, diffuse=(0.5, 0.5, 0.5))
    b.add_mesh(mesh, mid)
    cam = Camera.perspective(np.eye(4), 60.0, 8, 8)
    return b.build(cam, Film.make(8, 8, "box"), spp=1, max_depth=2,
                   traversal="packed")


def sphere_mesh():
    return _single_mesh(shp.sphere(1.0, 96, 192))


def plane_mesh():
    return _single_mesh(shp.rectangle())
