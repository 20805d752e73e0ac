"""Scene XMLs that stand in for the reference's scenes.

The reference's models/*/scene*.xml files are not in this repository.
These XMLs carry the parameters the repository records for them, under
the reference's directory and file names, so the loader's procedural
stand-in fibers (keyed by those names) take the place of the absent
.mitshair files:
- furball/scene.xml: bench.py's furball (scene/furball.py): its camera
  matrix, fov 35, the sunsky, rough plastic (ggx, alpha 0.2, intIOR 1.55,
  its diffuse reflectance) and hair radius 0.00216667; sobol 64 spp,
  ldrfilm 1024^2 with a tent filter, path maxDepth 65;
- straight-hair/scene_marschner.xml and scene_kkay.xml: the straight
  curtain (radius 0.00566563) with the Marschner and the Kajiya-Kay BSDF;
- hair-curl/scene.xml: the four clumps black_hair, red_hair, brown_hair
  and blonde_hair (radius 0.000444);
- curly-hair/scene.xml: the ringlets (radius 0.00559955) with the
  Marschner dielectric BSDF.
- teapot/scene.xml: the teapot scene as BASELINE.md records it (1280 x
  720, OBJ meshes and a rectangle, twosided diffuse and plastic, a
  checkerboard floor, an EXR envmap): path maxDepth 65, a perspective
  sensor framing the stand-in, teapot.obj under a twosided plastic (the
  OBJ is absent, so the loader gives the procedural teapot_standin with
  smooth normals), a rectangle floor under a twosided diffuse with a
  checkerboard reflectance, and an envmap whose EXR is absent (the
  loader then gives a constant 0.8 image). The geometry, the framing and
  the materials' values are this stand-in's own, not the reference's.
- instanced/scene.xml: a stand-in for the reference's shapegroup and
  instance plugins (src/shapes/{shapegroup,instance}.cpp) with every
  element the port reads besides: 64 instances (8 x 8, each with its own
  y rotation and a scale of 0.6-1.4) of one shapegroup holding the
  teapot stand-in (2,808 triangles, written as teapot.obj) under a
  twosided rough plastic; a 60 x 60 floor rectangle under a twosided
  diffuse with a 256^2 bitmap texture (floor.png) in a normal map
  (floor_normal.pfm); a heightfield with the loader's procedural ripples
  in a bump map (bump.png); a deformable sphere pair (sphere0.obj,
  sphere1.obj) at time 0.5 under the curvature texture; the constant
  0.8 envmap of a missing EXR; 1280 x 720, Sobol', maxDepth 65. Its
  files are written beside the XML by write_scene.
- motion/scene.xml: a stand-in for motion blur in the reference's XML
  syntax (the sensor's shutterOpen / shutterClose; <animation
  name="toWorld"> with <transform time="t"> keyframes on the sensor, a
  shape and an instance; a deformable pair), as the JAX loader reads it:
  the furball's fibers (the stand-in of furball.mitshair, keyed by the
  file name) under bench.py's rough plastic; teapot.obj (the 2,808-
  triangle stand-in) under a twosided plastic, moved rigidly between two
  keyframes (a translation and a y rotation); the sphere pair of the
  instanced stand-in as a deformable; a 4 x 4 grid of instances of one
  teapot shapegroup, each turning about y between its two keyframes; a
  perspective camera with two keyframes; shutter [0, 1], Sobol' with 4
  samples (four shutter times), 1024^2, the constant 0.8 envmap of a
  missing EXR, maxDepth 65. No reference scene is animated: the layout
  and the values are this stand-in's own.
- lit/scene.xml: a stand-in for the reference's area and delta lights
  (src/emitters/{area,point,spot,directional}.cpp) in the syntax the JAX
  loader reads (hairpt/scene/xml_loader.py:672-676 for a shape's
  <emitter type="area">, :851-863 for the point, spot, directional and
  collimated emitters): the furball's fibers and camera under bench.py's
  rough plastic (1,008,000 segments at hair quality 14), a rectangle
  area light above the fur facing down, a sphere area light beside it,
  a spot light behind it as the rim light, a point light, and the
  furball's sunsky; Sobol' 64 spp, 1024^2, maxDepth 65. No reference
  scene is lit so: the layout and the values are this stand-in's own.
- materials/scene.xml: a stand-in for the surface BSDFs, the wrapper
  materials and the thin lens in the reference's syntax
  (src/bsdfs/{roughdiffuse,conductor,roughconductor,dielectric,
  thindielectric,roughdielectric,difftrans,phong,ward,null,mixturebsdf,
  mask,coating,roughcoating}.cpp and src/sensors/thinlens.cpp, as
  hairpt/scene/xml_loader.py reads them): the furball's fibers under
  bench.py's rough plastic (1,008,000 segments at hair quality 14),
  ringed by one sphere per family (roughdiffuse, conductor Au,
  roughconductor Cu ggx 0.2, dielectric bk7, thindielectric,
  roughdielectric beckmann 0.1, difftrans, phong, ward, null, a 0.3
  mixture of a conductor and a diffuse, a mask of opacity 0.5 over a
  diffuse, a coating over a rough conductor, a rough coating over a
  diffuse), a checkerboard floor, the furball's sunsky and a thinlens
  camera (apertureRadius 0.02, focused on the furball); 1024^2, Sobol'
  64 spp, maxDepth 65. No reference scene uses these plugins: their
  users shoot hair beside glass and metal props with depth of field,
  and the layout and the values are this stand-in's own.
- fog/scene.xml: a stand-in for the reference's photon mapper in a
  participating medium (src/integrators/photonmapper/bre.cpp, the JAX
  package's volumetric branch of ppm): the lit stand-in's furball hair
  (1,008,000 segments at hair quality 14), its point light and the
  sunsky in a scene-scope homogeneous <medium> (sigmaS 0.1, sigmaA
  0.01, isotropic, fogDepth 8; hairpt/scene/xml_loader.py:866-948),
  integrator photonmapper; Sobol' 64 spp, 1024^2, maxDepth 65. The
  values are this stand-in's own.
- cloth/scene.xml: a stand-in for the reference's irawan woven cloth
  (src/bsdfs/irawan.cpp, as hairpt/scene/xml_loader.py:246-260 reads
  it) under hair: the furball's fibers, camera and sunsky (as
  furball()) standing on a 40 x 40 rectangle floor at y = 7.2 under a
  one-sided irawan that reads the weave file twill.wv (written beside
  the XML by cloth_files: the JAX package's built-in 2/2 twill with
  fineness 4, period 24 and dWarpUmaxOverDWarp 20, dWarpUmaxOverDWeft
  10, dWeftUmaxOverDWarp 10, dWeftUmaxOverDWeft 20 degrees, so that the
  TEA intensity variation and the Perlin umax noise run, and the warp
  yarn's kd and the fineness given through $warp_kd and $fineness),
  before a 24 x 24 backdrop facing the camera 9 units behind the
  furball's centre under a twosided irawan with the built-in plain weave
  (staple yarns, psi 30 degrees). repeatU = repeatV = 512 on the floor
  and 256 on the backdrop: one weave tile spans about 6 pixels at
  1024^2 (the backdrop 67 pixels per unit at 24 units from the camera,
  24 / 256 units per tile; the floor about 80 pixels per unit across at
  20 units, 40 / 512 units per tile). Sobol' 64 spp, 1024^2, maxDepth
  65. Its users put hair on fabric (portraits with hair on a collar or a
  scarf, fur on a cushion); the layout and the values are this
  stand-in's own.
The hair scenes' cameras are the framing of their generators (straight
and curly: from (0, 16.5, -25) at (0, 8.5, 0); hair-curl: from
(0, 5.9, 17) at (0, 6, 0)). Written files are for the CLI and the
tests; nothing reads them at import.
"""
from __future__ import annotations

import os

import numpy as np

from ..models import shapes as shp
from ..utils import io as io_utils
from .furball import CAM_TO_WORLD, DIFFUSE

SUN = ("<emitter type=\"sunsky\">"
       "<vector name=\"sunDirection\" x=\"-0.376047\" y=\"0.758426\" "
       "z=\"0.532333\"/><float name=\"turbidity\" value=\"3\"/>"
       "<float name=\"skyScale\" value=\"5\"/>"
       "<float name=\"sunScale\" value=\"19.0912\"/>"
       "<float name=\"sunRadiusScale\" value=\"37.9165\"/></emitter>")


def _rgb(v) -> str:
    return ", ".join(repr(float(x)) for x in v)


def _sensor(to_world: str, width: int, height: int, sampler: str = "sobol",
            spp: int = 64, fov: float = 35) -> str:
    return (f"<sensor type=\"perspective\"><float name=\"fov\" "
            f"value=\"{fov!r}\"/>"
            f"<transform name=\"toWorld\">{to_world}</transform>"
            f"<sampler type=\"{sampler}\"><integer name=\"sampleCount\" "
            f"value=\"{spp}\"/></sampler>"
            f"<film type=\"ldrfilm\"><integer name=\"width\" "
            f"value=\"{width}\"/><integer name=\"height\" value=\"{height}\"/>"
            f"<rfilter type=\"tent\"/></film></sensor>")


def _hair(filename: str, radius: float, material: str) -> str:
    return (f"<shape type=\"hair\"><string name=\"filename\" "
            f"value=\"{filename}\"/><float name=\"radius\" "
            f"value=\"{radius!r}\"/>{material}</shape>")


def _scene(body: str, depth=65, integrator="path") -> str:
    return (f"<?xml version=\"1.0\" encoding=\"utf-8\"?>\n"
            f"<scene version=\"0.5.0\"><integrator type=\"{integrator}\">"
            f"<integer name=\"maxDepth\" value=\"{depth}\"/></integrator>"
            f"{body}</scene>\n")


def furball(sampler="sobol", spp=64, res=1024, depth=65,
            emitter=SUN) -> str:
    """The furball; the tests and chip_smoke vary its sampler, sample
    count, resolution, depth and emitter."""
    m = " ".join(repr(float(x)) for x in CAM_TO_WORLD.reshape(-1))
    return _scene(
        _sensor(f"<matrix value=\"{m}\"/>", res, res, sampler, spp)
        + "<bsdf type=\"roughplastic\" id=\"fur\">"
          "<string name=\"distribution\" value=\"ggx\"/>"
          "<float name=\"alpha\" value=\"0.2\"/>"
          "<float name=\"intIOR\" value=\"1.55\"/>"
          f"<rgb name=\"diffuseReflectance\" value=\"{_rgb(DIFFUSE)}\"/>"
          "</bsdf>"
        + _hair("furball.mitshair", 0.00216667, "<ref id=\"fur\"/>")
        + emitter, depth)


_STRAIGHT_EYE = ("<lookat origin=\"0, 16.5, -25\" target=\"0, 8.5, 0\" "
                 "up=\"0, 1, 0\"/>")
_CURL_EYE = ("<lookat origin=\"0, 5.9, 17\" target=\"0, 6, 0\" "
             "up=\"0, 1, 0\"/>")
_KKAY = ("<bsdf type=\"kajiyakay\"{id}><rgb name=\"diffuseReflectance\" "
         "value=\"{d}\"/><rgb name=\"specularReflectance\" value=\"0.4\"/>"
         "<float name=\"exponent\" value=\"30\"/></bsdf>")


def straight(bsdf: str) -> str:
    """bsdf: 'marschner' or 'kajiyakay'."""
    mat = ("<bsdf type=\"marschner\" id=\"hair\"/>" if bsdf == "marschner"
           else _KKAY.format(id=" id=\"hair\"", d="0.1, 0.07, 0.05"))
    return _scene(_sensor(_STRAIGHT_EYE, 1024, 768) + mat
                  + _hair("straight.mitshair", 0.00566563,
                          "<ref id=\"hair\"/>") + SUN)


def hair_curl() -> str:
    """Four clumps: Marschner (black), Kajiya-Kay (red), marschner_diffuse
    (brown) and a twosided Kajiya-Kay (blonde)."""
    mats = {"black_hair": "<bsdf type=\"marschner\"/>",
            "red_hair": _KKAY.format(id="", d="0.5, 0.1, 0.05"),
            "brown_hair": "<bsdf type=\"marschner_diffuse\"/>",
            "blonde_hair": "<bsdf type=\"twosided\">"
                           + _KKAY.format(id="", d="0.8, 0.65, 0.35")
                           + "</bsdf>"}
    shapes = "".join(_hair(f"{k}.mitshair", 0.000444, v)
                     for k, v in mats.items())
    return _scene(_sensor(_CURL_EYE, 1024, 768) + shapes + SUN)


def curly() -> str:
    return _scene(_sensor(_STRAIGHT_EYE, 1024, 768)
                  + "<bsdf type=\"marschnerdielectric\" id=\"hair\"/>"
                  + _hair("curly.mitshair", 0.00559955, "<ref id=\"hair\"/>")
                  + SUN)


_TEAPOT_EYE = ("<lookat origin=\"0, 9, 22\" target=\"0, 2.5, 0\" "
               "up=\"0, 1, 0\"/>")
# the floor: the rectangle ([-1, 1]^2, +z) turned to face +y, 40 x 40
_FLOOR = ("<transform name=\"toWorld\"><scale value=\"20\"/>"
          "<rotate x=\"1\" angle=\"-90\"/></transform>")


def teapot(sampler="sobol", spp=64, width=1280, height=720, depth=65,
           floor_texture="checkerboard") -> str:
    """The teapot stand-in; the tests vary its sampler, film and depth,
    and the floor's texture type (its colours and scale stay)."""
    return _scene(
        _sensor(_TEAPOT_EYE, width, height, sampler, spp, fov=40.0)
        + "<bsdf type=\"twosided\" id=\"teapot\"><bsdf type=\"plastic\">"
          "<rgb name=\"diffuseReflectance\" value=\"0.6, 0.12, 0.08\"/>"
          "<float name=\"intIOR\" value=\"1.5\"/></bsdf></bsdf>"
        + "<bsdf type=\"twosided\" id=\"floor\"><bsdf type=\"diffuse\">"
          f"<texture type=\"{floor_texture}\" name=\"reflectance\">"
          "<rgb name=\"color0\" value=\"0.7\"/>"
          "<rgb name=\"color1\" value=\"0.15\"/>"
          "<float name=\"uscale\" value=\"8\"/>"
          "<float name=\"vscale\" value=\"8\"/></texture></bsdf></bsdf>"
        + "<shape type=\"obj\"><string name=\"filename\" "
          "value=\"teapot.obj\"/><ref id=\"teapot\"/></shape>"
        + f"<shape type=\"rectangle\">{_FLOOR}<ref id=\"floor\"/></shape>"
        + "<emitter type=\"envmap\"><string name=\"filename\" "
          "value=\"envmap.exr\"/></emitter>", depth)


_INST_EYE = ("<lookat origin=\"0, 24, 52\" target=\"0, 0, 8\" "
             "up=\"0, 1, 0\"/>")


def instance_poses(grid: int = 8):
    """(scale, y rotation in degrees, x, z) of the stand-in's instances:
    a grid x grid lattice 5 apart, scales 0.6-1.4 and angles from the
    golden ratio's sequence."""
    out = []
    for k in range(grid * grid):
        i, j = divmod(k, grid)
        frac = (k * 0.6180339887) % 1.0
        half = (grid - 1) / 2.0
        out.append((round(0.6 + 0.8 * frac, 4), round((k * 137.5) % 360, 4),
                    5.0 * (j - half), 5.0 * (i - half)))
    return out


def _instance(s, a, x, z) -> str:
    return (f"<shape type=\"instance\"><ref id=\"teapots\"/>"
            f"<transform name=\"toWorld\"><scale value=\"{s!r}\"/>"
            f"<rotate y=\"1\" angle=\"{a!r}\"/><translate x=\"{x!r}\" "
            f"z=\"{z!r}\"/></transform></shape>")


def instanced(sampler="sobol", spp=64, width=1280, height=720, depth=65,
              grid=8) -> str:
    """The instanced stand-in; the tests vary its sampler, film, depth
    and instance grid (grid x grid instances)."""
    tex = ("<texture type=\"bitmap\" name=\"{n}\"><string "
           "name=\"filename\" value=\"{f}\"/>{x}</texture>")
    return _scene(
        _sensor(_INST_EYE, width, height, sampler, spp, fov=45.0)
        + "<bsdf type=\"twosided\" id=\"teapot\"><bsdf "
          "type=\"roughplastic\"><rgb name=\"diffuseReflectance\" "
          "value=\"0.2, 0.35, 0.6\"/><float name=\"alpha\" "
          "value=\"0.15\"/><float name=\"intIOR\" value=\"1.5\"/>"
          "</bsdf></bsdf>"
        + "<bsdf type=\"normalmap\" id=\"floor\">"
        + tex.format(n="normals", f="floor_normal.pfm", x="")
        + "<bsdf type=\"twosided\"><bsdf type=\"diffuse\">"
        + tex.format(n="reflectance", f="floor.png",
                     x="<float name=\"uscale\" value=\"6\"/>"
                       "<float name=\"vscale\" value=\"6\"/>")
        + "</bsdf></bsdf></bsdf>"
        + "<bsdf type=\"bumpmap\" id=\"ripples\"><float name=\"scale\" "
          "value=\"0.01\"/>"
        + tex.format(n="map", f="bump.png", x="")
        + "<bsdf type=\"diffuse\"><rgb name=\"reflectance\" "
          "value=\"0.55, 0.5, 0.45\"/></bsdf></bsdf>"
        + "<bsdf type=\"diffuse\" id=\"blob\"><texture "
          "type=\"curvature\" name=\"reflectance\"><float "
          "name=\"scale\" value=\"0.5\"/></texture></bsdf>"
        + "<shape type=\"shapegroup\" id=\"teapots\"><shape type=\"obj\">"
          "<string name=\"filename\" value=\"teapot.obj\"/>"
          "<ref id=\"teapot\"/></shape></shape>"
        + "".join(_instance(*q) for q in instance_poses(grid))
        + "<shape type=\"rectangle\"><transform name=\"toWorld\">"
          "<scale value=\"30\"/><rotate x=\"1\" angle=\"-90\"/>"
          "</transform><ref id=\"floor\"/></shape>"
        + "<shape type=\"heightfield\"><float name=\"scale\" "
          "value=\"4\"/><transform name=\"toWorld\"><scale x=\"4\" "
          "y=\"4\" z=\"1\"/><rotate x=\"1\" angle=\"-90\"/>"
          "<translate x=\"-8\" y=\"0.5\" z=\"22\"/></transform>"
          "<ref id=\"ripples\"/></shape>"
        + "<shape type=\"deformable\"><string name=\"filename\" "
          "value=\"sphere0.obj\"/><string name=\"filename2\" "
          "value=\"sphere1.obj\"/><float name=\"time\" value=\"0.5\"/>"
          "<transform name=\"toWorld\"><scale value=\"2.5\"/>"
          "<translate x=\"8\" y=\"2.5\" z=\"22\"/></transform>"
          "<ref id=\"blob\"/></shape>"
        + "<emitter type=\"envmap\"><string name=\"filename\" "
          "value=\"envmap.exr\"/></emitter>", depth)


def write_obj(path: str, mesh):
    """Positions and faces of a mesh as a Wavefront OBJ (the loader then
    gives it smooth normals)."""
    with open(path, "w") as f:
        for v in np.asarray(mesh.positions, np.float64).tolist():
            f.write(f"v {v[0]!r} {v[1]!r} {v[2]!r}\n")
        for a, b, c in np.asarray(mesh.faces) + 1:
            f.write(f"f {a} {b} {c}\n")


def instanced_files(d: str):
    """The stand-in's meshes and images, made from fixed formulas."""
    motion_files(d)
    y, x = np.mgrid[0:256, 0:256] / 256.0
    tile = ((np.floor(x * 4) + np.floor(y * 4)) % 2)[..., None]
    stripe = 0.5 + 0.5 * np.sin(2 * np.pi * 8 * (x + 0.5 * y))[..., None]
    img = tile * np.array([0.8, 0.55, 0.3]) \
        + (1 - tile) * np.array([0.25, 0.4, 0.5]) * (0.6 + 0.4 * stripe)
    io_utils.write_png(os.path.join(d, "floor.png"), img)
    v, u = np.mgrid[0:64, 0:64] / 64.0
    n = np.stack([0.3 * np.sin(2 * np.pi * 2 * u),
                  0.3 * np.cos(2 * np.pi * 2 * v), np.ones_like(u)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    io_utils.write_pfm(os.path.join(d, "floor_normal.pfm"), n * 0.5 + 0.5)
    v, u = np.mgrid[0:128, 0:128] / 128.0
    h = 0.5 + 0.25 * (np.sin(2 * np.pi * 3 * u) + np.cos(2 * np.pi * 5 * v))
    io_utils.write_png(os.path.join(d, "bump.png"),
                       np.repeat(h[..., None], 3, -1))


_MOTION_EYES = (("-16, 17, 16", "0, 8.5, 0"), ("-15.2, 17.4, 16.6",
                                              "0.2, 8.5, 0"))


def _keyframes(*frames) -> str:
    """<animation name="toWorld"> of (time, transform children)."""
    return ("<animation name=\"toWorld\">"
            + "".join(f"<transform time=\"{t!r}\">{body}</transform>"
                      for t, body in frames) + "</animation>")


def _pose(scale, angle, x, y, z) -> str:
    return (f"<scale value=\"{scale!r}\"/><rotate y=\"1\" "
            f"angle=\"{angle!r}\"/><translate x=\"{x!r}\" y=\"{y!r}\" "
            f"z=\"{z!r}\"/>")


def motion(sampler="sobol", spp=4, res=1024, depth=65, hair=True,
           grid=4, swing=False) -> str:
    """The motion-blur stand-in; the tests vary its sampler, sample count,
    resolution and depth, leave out the hair (hair=False) and shrink the
    instance grid (grid x grid instances). swing=True swings the teapot
    out and back (keyframes at 0, 1/2 and 1, the first and last equal)
    and rests the deformable pair (its second file the first), so the
    triangles are the same at shutter times 1/4 and 3/4 (spp 2), while
    the camera and the instances still move."""
    cams = "".join(
        f"<transform time=\"{t!r}\"><lookat origin=\"{o}\" "
        f"target=\"{a}\" up=\"0, 1, 0\"/></transform>"
        for t, (o, a) in zip((0.0, 1.0), _MOTION_EYES))
    sensor = (f"<sensor type=\"perspective\"><float name=\"fov\" "
              f"value=\"45.0\"/><float name=\"shutterOpen\" value=\"0\"/>"
              f"<float name=\"shutterClose\" value=\"1\"/>"
              f"<animation name=\"toWorld\">{cams}</animation>"
              f"<sampler type=\"{sampler}\"><integer name=\"sampleCount\" "
              f"value=\"{spp}\"/></sampler><film type=\"ldrfilm\">"
              f"<integer name=\"width\" value=\"{res}\"/><integer "
              f"name=\"height\" value=\"{res}\"/><rfilter type=\"tent\"/>"
              f"</film></sensor>")
    half = (grid - 1) / 2.0
    insts = "".join(
        "<shape type=\"instance\"><ref id=\"teapots\"/>"
        + _keyframes((0.0, _pose(0.8, 30.0 * k, 4.0 * (j - half), 4.5,
                                 4.0 * (i - half))),
                     (1.0, _pose(0.8, 30.0 * k + 40.0, 4.0 * (j - half),
                                 4.5, 4.0 * (i - half))))
        + "</shape>"
        for k, (i, j) in enumerate((i, j) for i in range(grid)
                                   for j in range(grid)))
    fur = ("<bsdf type=\"roughplastic\" id=\"fur\">"
           "<string name=\"distribution\" value=\"ggx\"/>"
           "<float name=\"alpha\" value=\"0.2\"/>"
           "<float name=\"intIOR\" value=\"1.55\"/>"
           f"<rgb name=\"diffuseReflectance\" value=\"{_rgb(DIFFUSE)}\"/>"
           "</bsdf>"
           + _hair("furball.mitshair", 0.00216667, "<ref id=\"fur\"/>")) \
        if hair else ""
    return _scene(
        sensor + fur
        + "<bsdf type=\"twosided\" id=\"teapot\"><bsdf type=\"plastic\">"
          "<rgb name=\"diffuseReflectance\" value=\"0.6, 0.12, 0.08\"/>"
          "<float name=\"intIOR\" value=\"1.5\"/></bsdf></bsdf>"
        + "<bsdf type=\"twosided\" id=\"ware\"><bsdf "
          "type=\"roughplastic\"><rgb name=\"diffuseReflectance\" "
          "value=\"0.2, 0.35, 0.6\"/><float name=\"alpha\" "
          "value=\"0.15\"/><float name=\"intIOR\" value=\"1.5\"/>"
          "</bsdf></bsdf>"
        + "<bsdf type=\"diffuse\" id=\"blob\"><rgb name=\"reflectance\" "
          "value=\"0.55, 0.5, 0.45\"/></bsdf>"
        + "<shape type=\"obj\"><string name=\"filename\" "
          "value=\"teapot.obj\"/>"
        + (_keyframes((0.0, _pose(1.6, 0.0, -6.5, 6.0, 1.0)),
                      (0.5, _pose(1.6, 35.0, -5.3, 6.0, 1.0)),
                      (1.0, _pose(1.6, 0.0, -6.5, 6.0, 1.0))) if swing
           else _keyframes((0.0, _pose(1.6, 0.0, -6.5, 6.0, 1.0)),
                           (1.0, _pose(1.6, 35.0, -5.3, 6.0, 1.0))))
        + "<ref id=\"teapot\"/></shape>"
        + "<shape type=\"deformable\"><string name=\"filename\" "
          "value=\"sphere0.obj\"/><string name=\"filename2\" "
          f"value=\"sphere{0 if swing else 1}.obj\"/><transform "
          "name=\"toWorld\"><scale value=\"1.8\"/><translate x=\"4\" "
          "y=\"8.5\" z=\"6\"/></transform><ref id=\"blob\"/></shape>"
        + "<shape type=\"shapegroup\" id=\"teapots\"><shape type=\"obj\">"
          "<string name=\"filename\" value=\"teapot.obj\"/>"
          "<ref id=\"ware\"/></shape></shape>" + insts
        + "<emitter type=\"envmap\"><string name=\"filename\" "
          "value=\"envmap.exr\"/></emitter>", depth)


def motion_files(d: str):
    """The motion stand-in's meshes: teapot.obj and the sphere pair, as
    the instanced stand-in writes them."""
    write_obj(os.path.join(d, "teapot.obj"), shp.teapot_standin(scale=1.0))
    sph = shp.sphere(1.0, 16, 32)
    write_obj(os.path.join(d, "sphere0.obj"), sph)
    write_obj(os.path.join(d, "sphere1.obj"), sph._replace(
        positions=sph.positions * np.array([1.3, 0.7, 1.3])))


def lit(sampler="sobol", spp=64, res=1024, depth=65,
        integrator="path") -> str:
    """The lit furball; the tests and chip_smoke vary its sampler, sample
    count, resolution, depth and integrator type (the light tracers
    render it too)."""
    m = " ".join(repr(float(x)) for x in CAM_TO_WORLD.reshape(-1))
    return _scene(
        _sensor(f"<matrix value=\"{m}\"/>", res, res, sampler, spp)
        + "<bsdf type=\"roughplastic\" id=\"fur\">"
          "<string name=\"distribution\" value=\"ggx\"/>"
          "<float name=\"alpha\" value=\"0.2\"/>"
          "<float name=\"intIOR\" value=\"1.55\"/>"
          f"<rgb name=\"diffuseReflectance\" value=\"{_rgb(DIFFUSE)}\"/>"
          "</bsdf>"
        + _hair("furball.mitshair", 0.00216667, "<ref id=\"fur\"/>")
        # the panel above the fur, its +z face turned down
        + "<shape type=\"rectangle\"><transform name=\"toWorld\">"
          "<scale value=\"2.5\"/><rotate x=\"1\" angle=\"90\"/>"
          "<translate x=\"0\" y=\"17\" z=\"0\"/></transform>"
          "<emitter type=\"area\"><rgb name=\"radiance\" "
          "value=\"6, 5.6, 5\"/></emitter></shape>"
        + "<shape type=\"sphere\"><point name=\"center\" x=\"5\" "
          "y=\"11.5\" z=\"-3\"/><float name=\"radius\" value=\"0.6\"/>"
          "<emitter type=\"area\"><rgb name=\"radiance\" "
          "value=\"4, 6, 9\"/></emitter></shape>"
        + "<emitter type=\"spot\"><transform name=\"toWorld\"><lookat "
          "origin=\"8, 15, -8\" target=\"0, 11, 0\" up=\"0, 1, 0\"/>"
          "</transform><spectrum name=\"intensity\" value=\"300\"/>"
          "<float name=\"cutoffAngle\" value=\"25\"/></emitter>"
        + "<emitter type=\"point\"><point name=\"position\" x=\"-6\" "
          "y=\"16\" z=\"6\"/><rgb name=\"intensity\" "
          "value=\"60, 50, 40\"/></emitter>"
        + SUN, depth, integrator)


# the materials stand-in: the spheres' BSDFs, in ring order
MATERIAL_BSDFS = (
    ("roughdiffuse", "<rgb name=\"reflectance\" value=\"0.6, 0.5, 0.4\"/>"
     "<float name=\"alpha\" value=\"0.5\"/>"),
    ("conductor", "<string name=\"material\" value=\"Au\"/>"),
    ("roughconductor", "<string name=\"material\" value=\"Cu\"/>"
     "<string name=\"distribution\" value=\"ggx\"/>"
     "<float name=\"alpha\" value=\"0.2\"/>"),
    ("dielectric", "<string name=\"intIOR\" value=\"bk7\"/>"
     "<string name=\"extIOR\" value=\"air\"/>"),
    ("thindielectric", "<string name=\"intIOR\" value=\"bk7\"/>"),
    ("roughdielectric", "<string name=\"distribution\" value=\"beckmann\"/>"
     "<float name=\"alpha\" value=\"0.1\"/>"
     "<string name=\"intIOR\" value=\"bk7\"/>"),
    ("difftrans", ""),
    ("phong", "<rgb name=\"diffuseReflectance\" value=\"0.3, 0.05, 0.05\"/>"
     "<rgb name=\"specularReflectance\" value=\"0.4\"/>"
     "<float name=\"exponent\" value=\"40\"/>"),
    ("ward", "<rgb name=\"diffuseReflectance\" value=\"0.05, 0.2, 0.3\"/>"
     "<rgb name=\"specularReflectance\" value=\"0.3\"/>"
     "<float name=\"alpha\" value=\"0.15\"/>"),
    ("null", ""),
    ("mixturebsdf", "<string name=\"weights\" value=\"0.3, 0.7\"/>"
     "<bsdf type=\"conductor\"><string name=\"material\" value=\"Ag\"/>"
     "</bsdf><bsdf type=\"diffuse\"><rgb name=\"reflectance\" "
     "value=\"0.2, 0.5, 0.2\"/></bsdf>"),
    ("mask", "<rgb name=\"opacity\" value=\"0.5\"/><bsdf type=\"diffuse\">"
     "<rgb name=\"reflectance\" value=\"0.7, 0.7, 0.2\"/></bsdf>"),
    ("coating", "<string name=\"intIOR\" value=\"bk7\"/>"
     "<rgb name=\"sigmaA\" value=\"0.1, 0.2, 0.4\"/>"
     "<bsdf type=\"roughconductor\"><string name=\"material\" "
     "value=\"Al\"/><float name=\"alpha\" value=\"0.1\"/></bsdf>"),
    ("roughcoating", "<float name=\"alpha\" value=\"0.1\"/>"
     "<bsdf type=\"diffuse\"><rgb name=\"reflectance\" "
     "value=\"0.1, 0.3, 0.6\"/></bsdf>"),
)
# the focus distance: the furball's centre along the camera's axis; the
# ring of spheres is centred on the axis there, in the plane of the
# camera's x and y axes (radius 4.0: inside the 35 degree field), the
# spheres' radius 0.45
FOCUS_DISTANCE = float(np.dot(CAM_TO_WORLD[:3, 2], np.asarray(
    (0.0, 11.0, 0.0)) - CAM_TO_WORLD[:3, 3]))
RING_RADIUS = 4.0
PROP_RADIUS = 0.45


def material_centers():
    """The spheres' centres, in ring order."""
    c = CAM_TO_WORLD[:3, 3] + FOCUS_DISTANCE * CAM_TO_WORLD[:3, 2]
    ang = 2.0 * np.pi * np.arange(len(MATERIAL_BSDFS)) / len(MATERIAL_BSDFS)
    return [c + RING_RADIUS * (np.cos(a) * CAM_TO_WORLD[:3, 0]
                               + np.sin(a) * CAM_TO_WORLD[:3, 1])
            for a in ang]


def materials(sampler="sobol", spp=64, res=1024, depth=65, hair=True,
              aperture=0.02) -> str:
    """The materials stand-in; the tests and chip_smoke vary its sampler,
    sample count, resolution, depth and aperture, and drop the hair."""
    m = " ".join(repr(float(x)) for x in CAM_TO_WORLD.reshape(-1))
    cam = _sensor(f"<matrix value=\"{m}\"/>", res, res, sampler, spp).replace(
        "<sensor type=\"perspective\">",
        "<sensor type=\"thinlens\"><float name=\"apertureRadius\" "
        f"value=\"{aperture!r}\"/><float name=\"focusDistance\" "
        f"value=\"{FOCUS_DISTANCE!r}\"/>")
    body = cam + "".join(f"<bsdf type=\"{t}\" id=\"m{i}\">{props}</bsdf>"
                         for i, (t, props) in enumerate(MATERIAL_BSDFS))
    if hair:
        body += ("<bsdf type=\"roughplastic\" id=\"fur\">"
                 "<string name=\"distribution\" value=\"ggx\"/>"
                 "<float name=\"alpha\" value=\"0.2\"/>"
                 "<float name=\"intIOR\" value=\"1.55\"/>"
                 f"<rgb name=\"diffuseReflectance\" value=\"{_rgb(DIFFUSE)}\"/>"
                 "</bsdf>"
                 + _hair("furball.mitshair", 0.00216667, "<ref id=\"fur\"/>"))
    for i, c in enumerate(material_centers()):
        body += (f"<shape type=\"sphere\"><point name=\"center\" "
                 f"x=\"{float(c[0])!r}\" y=\"{float(c[1])!r}\" "
                 f"z=\"{float(c[2])!r}\"/>"
                 f"<float name=\"radius\" value=\"{PROP_RADIUS!r}\"/>"
                 f"<ref id=\"m{i}\"/></shape>")
    body += ("<shape type=\"rectangle\"><transform name=\"toWorld\"><scale "
             "value=\"20\"/><rotate x=\"1\" angle=\"-90\"/><translate "
             "y=\"6\"/></transform><bsdf type=\"diffuse\"><texture "
             "type=\"checkerboard\" name=\"reflectance\"><float "
             "name=\"uscale\" value=\"8\"/><float name=\"vscale\" "
             "value=\"8\"/></texture></bsdf></shape>")
    return _scene(body + SUN, depth)


def _fur_xml() -> str:
    return ("<bsdf type=\"roughplastic\" id=\"fur\">"
            "<string name=\"distribution\" value=\"ggx\"/>"
            "<float name=\"alpha\" value=\"0.2\"/>"
            "<float name=\"intIOR\" value=\"1.55\"/>"
            f"<rgb name=\"diffuseReflectance\" value=\"{_rgb(DIFFUSE)}\"/>"
            "</bsdf>"
            + _hair("furball.mitshair", 0.00216667, "<ref id=\"fur\"/>"))


# the media stand-in's smoke: a grid boxed around the furball (whose
# fibers reach 3.85 from (0, 11, 0))
SMOKE_MIN = (-5.0, 6.0, -5.0)
SMOKE_MAX = (5.0, 16.0, 5.0)
SMOKE_RES = 256


def smoke_density(res: int = SMOKE_RES) -> np.ndarray:
    """[res, res, res] float32 (z, y, x) procedural smoke in [0, 1]: a
    soft ball of radius 1 in the box's [-1, 1]^3 coordinates, thinned by
    a product of sines."""
    t = ((np.arange(res, dtype=np.float32) + 0.5) / res * 2.0 - 1.0)
    x, y, z = t[None, None, :], t[None, :, None], t[:, None, None]
    r = np.sqrt(x * x + y * y + z * z)
    turb = 0.55 + 0.25 * np.sin(7.0 * x + 2.0 * np.sin(5.0 * y)) \
        * np.sin(6.0 * y + 3.0 * z) + 0.2 * np.sin(9.0 * z - 4.0 * x)
    return (np.clip(1.0 - r, 0.0, 1.0) * np.clip(turb, 0.0, 1.0)) \
        .astype(np.float32)


def media(sampler="sobol", spp=64, res=1024, depth=65) -> str:
    """The media stand-in: the furball in a heterogeneous smoke (the grid
    volume smoke.vol, written by media_files), HG g 0.3, volpath; the
    tests and chip_smoke vary its sampler, sample count, resolution and
    depth."""
    m = " ".join(repr(float(x)) for x in CAM_TO_WORLD.reshape(-1))
    return _scene(
        _sensor(f"<matrix value=\"{m}\"/>", res, res, sampler, spp)
        + _fur_xml()
        + "<medium type=\"heterogeneous\" id=\"smoke\">"
          "<volume type=\"gridvolume\" name=\"density\">"
          "<string name=\"filename\" value=\"smoke.vol\"/></volume>"
          "<rgb name=\"sigmaS\" value=\"0.5\"/>"
          "<rgb name=\"sigmaA\" value=\"0.05\"/>"
          "<phase type=\"hg\"><float name=\"g\" value=\"0.3\"/></phase>"
          "</medium>"
        + SUN, depth, integrator="volpath")


def media_files(d: str, vol_res: int = SMOKE_RES):
    """Write the media stand-in's smoke.vol (vol_res^3 float32)."""
    from ..models.media import write_vol
    write_vol(os.path.join(d, "smoke.vol"), smoke_density(vol_res),
              SMOKE_MIN, SMOKE_MAX)


# the fog stand-in's homogeneous medium: sigma_t 0.11, so the furball 11
# to 15 from the camera keeps a quarter of its radiance and an escaping
# ray crosses an optical depth of 0.88; at a depth of 8 nearly all the
# volume photons (8 bounces) stay inside the photon map's 128 cells of
# radius 0.25 (32 units), which the camera's beams cross; a deeper fog's
# photons spread past that window
FOG_SIGMA_S = 0.1
FOG_SIGMA_A = 0.01
FOG_DEPTH = 8.0


def fog(sampler="sobol", spp=64, res=1024, depth=65,
        integrator="photonmapper") -> str:
    """The fog stand-in: the lit furball's hair (roughplastic), the lit
    stand-in's point light and the sunsky in a scene-scope homogeneous
    <medium> (isotropic phase, fogDepth FOG_DEPTH), rendered by the
    photon mapper (its volumetric branch: the beam radiance estimate);
    the tests and chip_smoke vary its sampler, sample count, resolution,
    depth and integrator type."""
    m = " ".join(repr(float(x)) for x in CAM_TO_WORLD.reshape(-1))
    return _scene(
        _sensor(f"<matrix value=\"{m}\"/>", res, res, sampler, spp)
        + _fur_xml()
        + "<emitter type=\"point\"><point name=\"position\" x=\"-6\" "
          "y=\"16\" z=\"6\"/><rgb name=\"intensity\" "
          "value=\"60, 50, 40\"/></emitter>"
        + "<medium type=\"homogeneous\" id=\"fog\">"
          f"<rgb name=\"sigmaS\" value=\"{FOG_SIGMA_S!r}\"/>"
          f"<rgb name=\"sigmaA\" value=\"{FOG_SIGMA_A!r}\"/>"
          f"<float name=\"fogDepth\" value=\"{FOG_DEPTH!r}\"/>"
          "<phase type=\"isotropic\"/></medium>"
        + SUN, depth, integrator)


def _cam_point(fwd: float, right: float, up: float):
    """A point fwd along the camera's axis from the furball's centre
    (towards the camera if negative), moved along its x and y axes."""
    c = np.asarray((0.0, 11.0, 0.0))
    return (c + fwd * CAM_TO_WORLD[:3, 2] + right * CAM_TO_WORLD[:3, 0]
            + up * CAM_TO_WORLD[:3, 1])


def _sphere(c, r: float, inner: str) -> str:
    return (f"<shape type=\"sphere\"><point name=\"center\" "
            f"x=\"{float(c[0])!r}\" y=\"{float(c[1])!r}\" "
            f"z=\"{float(c[2])!r}\"/><float name=\"radius\" "
            f"value=\"{r!r}\"/>{inner}</shape>")


def bounded(sampler="sobol", spp=64, res=1024, depth=65) -> str:
    """The bounded-media stand-in: the furball inside a null-bounded
    sphere (radius 4.2) of thin homogeneous fog, a dielectric sphere
    filled with a denser medium and a Hanrahan-Krueger (hk) sphere in
    front of it, a checkerboard floor and the sunsky; volpath."""
    m = " ".join(repr(float(x)) for x in CAM_TO_WORLD.reshape(-1))
    body = (_sensor(f"<matrix value=\"{m}\"/>", res, res, sampler, spp)
            + _fur_xml()
            + _sphere((0.0, 11.0, 0.0), 4.2,
                      "<medium type=\"homogeneous\" name=\"interior\">"
                      "<rgb name=\"sigmaS\" value=\"0.08, 0.09, 0.1\"/>"
                      "<rgb name=\"sigmaA\" value=\"0.01\"/>"
                      "<float name=\"g\" value=\"0.2\"/></medium>")
            + _sphere(_cam_point(-6.0, 2.5, -1.5), 0.7,
                      "<bsdf type=\"dielectric\"><float name=\"intIOR\" "
                      "value=\"1.33\"/></bsdf>"
                      "<medium type=\"homogeneous\" name=\"interior\">"
                      "<rgb name=\"sigmaS\" value=\"1.2, 0.8, 0.4\"/>"
                      "<rgb name=\"sigmaA\" value=\"0.05, 0.1, 0.3\"/>"
                      "</medium>")
            + _sphere(_cam_point(-6.0, -2.5, -1.5), 0.7,
                      "<bsdf type=\"hk\"><rgb name=\"sigmaS\" "
                      "value=\"2, 1.5, 1\"/><rgb name=\"sigmaA\" "
                      "value=\"0.05, 0.1, 0.2\"/><float name=\"thickness\" "
                      "value=\"0.5\"/><float name=\"g\" value=\"0.4\"/>"
                      "</bsdf>")
            + "<shape type=\"rectangle\"><transform name=\"toWorld\"><scale "
              "value=\"20\"/><rotate x=\"1\" angle=\"-90\"/><translate "
              "y=\"6\"/></transform><bsdf type=\"diffuse\"><texture "
              "type=\"checkerboard\" name=\"reflectance\"><float "
              "name=\"uscale\" value=\"8\"/><float name=\"vscale\" "
              "value=\"8\"/></texture></bsdf></shape>")
    return _scene(body + SUN, depth, integrator="volpath")


def subsurface(kind="dipole", sampler="sobol", spp=64, width=1280,
               height=720, depth=65) -> str:
    """The teapot stand-in with a <subsurface type="dipole"> or
    "singlescatter" (marble-like coefficients at 30x density: a dipole
    kernel radius of about half a unit on the ~5-unit teapot), path."""
    ss = (f"<subsurface type=\"{kind}\">"
          "<rgb name=\"sigmaS\" value=\"2.6, 3.2, 3.9\"/>"
          "<rgb name=\"sigmaA\" value=\"0.0021, 0.0041, 0.0071\"/>"
          "<float name=\"scale\" value=\"30\"/>"
          "<float name=\"intIOR\" value=\"1.3\"/>"
          + ("<float name=\"g\" value=\"0.3\"/>"
             if kind == "singlescatter" else "")
          + "</subsurface>")
    xml = teapot(sampler=sampler, spp=spp, width=width, height=height,
                 depth=depth)
    return xml.replace("value=\"teapot.obj\"/><ref id=\"teapot\"/>",
                       "value=\"teapot.obj\"/><ref id=\"teapot\"/>" + ss)


# the cloth stand-in: the JAX package's built-in twill with the noise
# turned on, its warp kd and fineness left to the XML's properties
TWILL_WV = """/* the 2/2 twill of hairpt's BUILTIN_WEAVES with intensity
   variation (fineness) and correlated umax noise (period, dUmax) */
weave {
  name = "2/2 twill, noisy",
  tileWidth = 4, tileHeight = 4,
  alpha = 0.15, beta = 8.0, ss = 0.2, hWidth = 0.5,
  warpArea = 2.0, weftArea = 1.0,
  fineness = $fineness, period = 24.0,
  dWarpUmaxOverDWarp = 20, dWarpUmaxOverDWeft = 10,
  dWeftUmaxOverDWarp = 10, dWeftUmaxOverDWeft = 20,
  pattern { 1, 1, 2, 2,  2, 1, 1, 2,  2, 2, 1, 1,  1, 2, 2, 1 },
  yarn { type = warp, psi = 0, umax = 40, kappa = 0.0,
         width = 1.2, length = 3.5, centerU = 0.5, centerV = 0.5,
         kd = $warp_kd, ks = {0.5, 0.5, 0.55} },
  yarn { type = weft, psi = 0, umax = 40, kappa = 0.0,
         width = 1.2, length = 3.5, centerU = 0.5, centerV = 0.5,
         kd = {0.6, 0.6, 0.62}, ks = {0.5, 0.5, 0.5} }
}
"""
# the $vars of twill.wv, given by the floor's irawan element
TWILL_PROPS = {"warp_kd": (0.1, 0.12, 0.35), "fineness": 4.0}
CLOTH_FLOOR_Y = 7.2
CLOTH_REPEAT = {"floor": 512, "backdrop": 256}
# the backdrop: 9 units beyond the furball's centre (0, 11, 0) along the
# camera's view axis, facing the camera
_VIEW = CAM_TO_WORLD[:3, 2]
_BACKDROP_C = np.array([0.0, 11.0, 0.0]) + 9.0 * _VIEW


def _irawan(weave: str, repeat: int, extra: str = "") -> str:
    return (f"<bsdf type=\"irawan\"><string name=\"filename\" "
            f"value=\"{weave}\"/><float name=\"repeatU\" "
            f"value=\"{repeat}\"/><float name=\"repeatV\" "
            f"value=\"{repeat}\"/>{extra}</bsdf>")


def cloth(sampler="sobol", spp=64, res=1024, depth=65, hair=True) -> str:
    """The cloth stand-in; the tests and chip_smoke vary its sampler,
    sample count, resolution and depth, and drop the hair."""
    m = " ".join(repr(float(x)) for x in CAM_TO_WORLD.reshape(-1))
    floor = _irawan("twill.wv", CLOTH_REPEAT["floor"],
                    f"<rgb name=\"warp_kd\" "
                    f"value=\"{_rgb(TWILL_PROPS['warp_kd'])}\"/>"
                    f"<float name=\"fineness\" "
                    f"value=\"{TWILL_PROPS['fineness']!r}\"/>")
    back = ("<bsdf type=\"twosided\">"
            + _irawan("plain", CLOTH_REPEAT["backdrop"]) + "</bsdf>")
    c = _BACKDROP_C
    t = c - _VIEW
    body = (_sensor(f"<matrix value=\"{m}\"/>", res, res, sampler, spp)
            + (_fur_xml() if hair else "")
            + "<shape type=\"rectangle\"><transform name=\"toWorld\">"
              "<scale value=\"20\"/><rotate x=\"1\" angle=\"-90\"/>"
              f"<translate y=\"{CLOTH_FLOOR_Y!r}\"/></transform>{floor}"
              "</shape>"
            + "<shape type=\"rectangle\"><transform name=\"toWorld\">"
              "<scale value=\"12\"/><lookat origin=\"" + _rgb(c)
            + "\" target=\"" + _rgb(t) + "\" up=\"0, 1, 0\"/>"
              f"</transform>{back}</shape>")
    return _scene(body + SUN, depth)


def cloth_files(d: str):
    """The cloth stand-in's weave file, twill.wv, in directory d."""
    with open(os.path.join(d, "twill.wv"), "w") as fh:
        fh.write(TWILL_WV)


def write_dae(path: str) -> str:
    """A small COLLADA document for the import command (the reference's
    mtsimport; hairpt/scene/collada.py reads it): Z_UP at centimetres, a
    cube (a polylist of quads with normals and texture coordinates) and a
    floor quad (triangles) under two lambert materials, each placed by a
    node's transform stack (translate, rotate, scale), and a camera
    placed by a lookat. Returns `path`."""
    cube = shp.cube()
    pos = " ".join(f"{v:g}" for v in cube.positions.reshape(-1))
    nrm = " ".join(f"{v:g}" for v in cube.normals.reshape(-1))
    uvs = " ".join(f"{v:g}" for v in cube.uvs.reshape(-1))
    nv = len(cube.positions)
    # the cube's triangles as a polylist of triangles (each corner
    # indexes position, normal and uv alike)
    idx = " ".join(f"{i} {i} {i}" for i in cube.faces.reshape(-1))
    doc = f"""<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><unit meter="0.01"/><up_axis>Z_UP</up_axis></asset>
  <library_cameras><camera id="cam" name="cam"><optics><technique_common>
    <perspective><xfov>40</xfov><aspect_ratio>1</aspect_ratio></perspective>
  </technique_common></optics></camera></library_cameras>
  <library_effects>
    <effect id="red-fx"><profile_COMMON><technique sid="common">
      <lambert><diffuse><color>0.8 0.1 0.2 1</color></diffuse></lambert>
    </technique></profile_COMMON></effect>
    <effect id="grey-fx"><profile_COMMON><technique sid="common">
      <lambert><diffuse><color>0.5 0.5 0.45 1</color></diffuse></lambert>
    </technique></profile_COMMON></effect>
  </library_effects>
  <library_materials>
    <material id="red-mat" name="red"><instance_effect url="#red-fx"/>
    </material>
    <material id="grey-mat" name="grey"><instance_effect url="#grey-fx"/>
    </material>
  </library_materials>
  <library_geometries>
    <geometry id="cube-geo" name="cube"><mesh>
      <source id="cube-pos"><float_array id="cube-pos-arr" count="{3 * nv}">
        {pos}</float_array><technique_common><accessor
        source="#cube-pos-arr" count="{nv}" stride="3"/></technique_common>
      </source>
      <source id="cube-nrm"><float_array id="cube-nrm-arr" count="{3 * nv}">
        {nrm}</float_array><technique_common><accessor
        source="#cube-nrm-arr" count="{nv}" stride="3"/></technique_common>
      </source>
      <source id="cube-uv"><float_array id="cube-uv-arr" count="{2 * nv}">
        {uvs}</float_array><technique_common><accessor
        source="#cube-uv-arr" count="{nv}" stride="2"/></technique_common>
      </source>
      <vertices id="cube-vtx"><input semantic="POSITION"
        source="#cube-pos"/></vertices>
      <polylist material="red" count="{len(cube.faces)}">
        <input semantic="VERTEX" source="#cube-vtx" offset="0"/>
        <input semantic="NORMAL" source="#cube-nrm" offset="1"/>
        <input semantic="TEXCOORD" source="#cube-uv" offset="2"/>
        <vcount>{" ".join("3" for _ in cube.faces)}</vcount>
        <p>{idx}</p>
      </polylist>
    </mesh></geometry>
    <geometry id="floor-geo" name="floor"><mesh>
      <source id="floor-pos"><float_array id="floor-pos-arr" count="12">
        -1 -1 0  1 -1 0  1 1 0  -1 1 0</float_array><technique_common>
        <accessor source="#floor-pos-arr" count="4" stride="3"/>
        </technique_common></source>
      <vertices id="floor-vtx"><input semantic="POSITION"
        source="#floor-pos"/></vertices>
      <triangles material="grey" count="2">
        <input semantic="VERTEX" source="#floor-vtx" offset="0"/>
        <p>0 1 2 0 2 3</p>
      </triangles>
    </mesh></geometry>
  </library_geometries>
  <library_visual_scenes><visual_scene id="vscene">
    <node id="camera-node"><lookat>600 -800 500 0 0 60 0 0 1</lookat>
      <instance_camera url="#cam"/></node>
    <node id="props">
      <node id="cube-node"><translate>0 0 100</translate>
        <rotate>0 0 1 30</rotate><scale>100 100 100</scale>
        <instance_geometry url="#cube-geo"><bind_material>
          <technique_common><instance_material symbol="red"
          target="#red-mat"/></technique_common></bind_material>
        </instance_geometry></node>
      <node id="floor-node"><scale>500 500 500</scale>
        <instance_geometry url="#floor-geo"><bind_material>
          <technique_common><instance_material symbol="grey"
          target="#grey-mat"/></technique_common></bind_material>
        </instance_geometry></node>
    </node>
  </visual_scene></library_visual_scenes>
  <scene><instance_visual_scene url="#vscene"/></scene>
</COLLADA>
"""
    with open(path, "w") as fh:
        fh.write(doc)
    return path


# name -> (directory, file name, XML builder[, writer of its files])
SCENES = {
    "furball": ("furball", "scene.xml", furball),
    "straight_marschner": ("straight-hair", "scene_marschner.xml",
                           lambda: straight("marschner")),
    "straight_kkay": ("straight-hair", "scene_kkay.xml",
                      lambda: straight("kajiyakay")),
    "hair_curl": ("hair-curl", "scene.xml", hair_curl),
    "curly": ("curly-hair", "scene.xml", curly),
    "teapot": ("teapot", "scene.xml", teapot),
    "instanced": ("instanced", "scene.xml", instanced, instanced_files),
    "motion": ("motion", "scene.xml", motion, motion_files),
    "lit": ("lit", "scene.xml", lit),
    "fog": ("fog", "scene.xml", fog),
    "materials": ("materials", "scene.xml", materials),
    "media": ("media", "scene.xml", media, media_files),
    "bounded": ("bounded", "scene.xml", bounded),
    "dipole": ("dipole", "scene.xml", subsurface),
    "singlescatter": ("singlescatter", "scene.xml",
                      lambda **kw: subsurface("singlescatter", **kw)),
    "cloth": ("cloth", "scene.xml", cloth, cloth_files),
}



def write_scene(root: str, name: str, **kw) -> str:
    """Write scene `name` under root/<its directory>/ (with its files,
    where it has any) and return the path; kw go to its XML builder
    (furball(), teapot(), instanced(), motion(), lit(), materials(),
    media(), fog(), bounded(), subsurface() and cloth() take any), but
    vol_res, which goes to media_files."""
    d, f, make, *files = SCENES[name]
    vol = {"vol_res": kw.pop("vol_res")} if "vol_res" in kw else {}
    os.makedirs(os.path.join(root, d), exist_ok=True)
    path = os.path.join(root, d, f)
    with open(path, "w") as fh:
        fh.write(make(**kw))
    for write in files:
        write(os.path.join(root, d), **vol)
    return path
