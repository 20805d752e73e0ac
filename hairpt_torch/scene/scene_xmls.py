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
The hair scenes' cameras are the framing of their generators (straight
and curly: from (0, 16.5, -25) at (0, 8.5, 0); hair-curl: from
(0, 5.9, 17) at (0, 6, 0)). Written files are for the CLI and the
tests; nothing reads them at import.
"""
from __future__ import annotations

import os

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


def _scene(body: str, depth=65) -> str:
    return (f"<?xml version=\"1.0\" encoding=\"utf-8\"?>\n"
            f"<scene version=\"0.5.0\"><integrator type=\"path\">"
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


# name -> (directory, file name, XML builder)
SCENES = {
    "furball": ("furball", "scene.xml", furball),
    "straight_marschner": ("straight-hair", "scene_marschner.xml",
                           lambda: straight("marschner")),
    "straight_kkay": ("straight-hair", "scene_kkay.xml",
                      lambda: straight("kajiyakay")),
    "hair_curl": ("hair-curl", "scene.xml", hair_curl),
    "curly": ("curly-hair", "scene.xml", curly),
    "teapot": ("teapot", "scene.xml", teapot),
}


def write_scene(root: str, name: str, **kw) -> str:
    """Write scene `name` under root/<its directory>/ and return the
    path; kw go to its XML builder (furball() and teapot() take any)."""
    d, f, make = SCENES[name]
    os.makedirs(os.path.join(root, d), exist_ok=True)
    path = os.path.join(root, d, f)
    with open(path, "w") as fh:
        fh.write(make(**kw))
    return path
