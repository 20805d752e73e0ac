"""Mitsuba scene-XML loader for the hair and mesh scenes (port of
hairpt/scene/xml_loader.py).

Parses the scene format of the reference's hair scenes (reference
src/librender/scenehandler.cpp; plain ElementTree here) and assembles the
scene through the port's SceneBuilder, with the JAX loader's defaults,
property rules, material ids and stand-ins: the same XML gives the same
scene arrays in both packages. `$key` placeholders are substituted from
`defines` (`mitsuba -D`).

What the port renders:
- `<integrator type="path">` with maxDepth, and the types volpath,
  volpath_simple, ptracer, bdpt, vpl, photonmapper, ppm, sppm, direct
  (maxDepth 2 unless --depth overrides it, as in the JAX loader), ao,
  irrcache, erpt, pssmlt, adaptive, multichannel and field, whose renders
  the CLI dispatches;
- every sensor of the JAX loader: perspective, thinlens (apertureRadius,
  focusDistance), orthographic, spherical, telecentric, radiancemeter,
  fluencemeter, irradiancemeter and perspective_rdist (kc), an unknown
  name becoming perspective as in the JAX loader (fov, fovAxis, a toWorld
  of matrix, translate, scale, rotate and lookat) with the independent,
  ldsampler, halton, hammersley, stratified and sobol samplers and an
  ldrfilm, hdrfilm, mfilm or tiledhdrfilm (RenderConfig.tiled_film: the
  CLI streams the path render to an EXR in bands) with any of the six
  reconstruction filters;
- the BSDFs diffuse, roughdiffuse, conductor and mirror (the named
  conductor presets), roughconductor, dielectric, thindielectric,
  roughdielectric, difftrans, plastic, roughplastic, phong, ward, null,
  kajiyakay, marschner (corrected, or faithful with `<boolean
  name="faithful">` / `-D marschner_faithful=true`), marschner_diffuse
  and marschnerdielectric, hk (sigmaS, sigmaA, thickness, g), and the
  wrappers mixturebsdf and blendbsdf, irawan (a built-in weave, plain or
  twill, or a weave file beside the XML, with repeatU / repeatV and the
  $var properties of its grammar; its textures are not read, as in the
  JAX loader), mask, coating and roughcoating over a nested BSDF (one
  level), each possibly wrapped in twosided and in a normalmap or
  bumpmap (its texture image read without de-gamma);
- a BSDF's checkerboard, gridtexture, wireframe, vertexcolors, curvature
  or bitmap texture (an 8-bit image de-gammaed with 2.2, or HDR, PFM or
  EXR; a missing file gives no texture), possibly under a scale texture;
- `<shape type="hair">` from a .mitshair file, or the procedural
  stand-in keyed by the scene directory and file name when the file is
  missing, with its toWorld (the radius scales with it);
- the mesh shapes obj, ply and serialized (a missing file becomes the
  teapot stand-in with smooth normals; a file without normals gets smooth
  ones unless faceNormals is set), rectangle, sphere (radius, center),
  disk, cube, cylinder, heightfield (from its image, or the JAX loader's
  procedural ripples when the file is missing) and deformable (the
  keyframe pair lerped at `time`), each with its toWorld;
- shapegroup and instance: a shapegroup's rectangle, sphere, cube, obj,
  ply and serialized children become prototypes, each instance adds
  every prototype of its group under its toWorld (the two-level walk,
  ops/instancing.py);
- motion blur: the sensor's shutterOpen and shutterClose and an
  `<animation name="toWorld">` of `<transform time="t">` keyframes
  (core/track.AnimatedTransform) on the sensor, a shape or an instance:
  each is placed at shutter open, and under an open shutter render()
  poses the camera, moves the animated meshes, re-lerps the deformable
  pairs and re-poses the animated instances at each sample's shutter
  time (an animated hair shape stays at shutter open, as in the JAX
  loader); the same animations, evaluated at the motion integrator's
  target time (its `time`, 1 by default), give the motion tables: the
  camera at that time and each animated mesh's relative motion
  T(time) T(shutterOpen)^-1;
- the sunsky, sky, sun, envmap (HDR, PFM, EXR or an 8-bit image) and
  constant emitters; the point, spot, directional and collimated emitters
  (position and direction from toWorld where absent; intensity, else
  irradiance, else power; cutoffAngle 20 and beamWidth 3/4 of it by
  default); a shape's `<emitter>` (an area light of its radiance) on
  every mesh shape, dropped on a hair shape as the JAX loader drops it;
- participating media: a shape's `<medium name="interior|exterior">`
  (a shape-bounded homogeneous medium; a shape with a medium and no BSDF
  gets the implicit null boundary), and the scene-level `<medium
  type="homogeneous|heterogeneous">` with its phase (isotropic, hg,
  rayleigh, kkay, kkay_is, microflake with stddev and orientation, a
  mixturephase of nested phases), a gridvolume (.vol) or a constvolume,
  scale, and a homogeneous fog's depth of four diagonals of the scene's
  bounding box (fogDepth overrides it); a sensor's `<medium>` is ignored,
  as the JAX loader ignores it, with a log line;
- a shape's `<subsurface type="dipole|singlescatter">` (a DIPOLE
  material row over the shape's BSDF; singlescatter sets the config's
  sss_single and sss_g);
- `<spectrum>` and `<blackbody>` values.
A `<texture>` at the scene's top level is ignored, as the JAX loader
ignores it (it reads only a BSDF's own texture).

Any integrator type is taken, as the JAX loader takes it (the motion
integrator's `time` a float target time or a string path configuration,
its `config` the configuration), and any film type's width, height,
gamma and filter are read; validation refuses the types neither package
knows, as hairpt's does, unless validate=False or the type is a `$var`.
Every LDR image (a bitmap texture, a normal or bump map, a heightfield,
an envmap) goes through utils/io.read_ldr, which reads what PIL opens as
PIL's convert("RGB") gives it: PNG, JPEG (its variants), BMP, TGA,
Netpbm, TIFF, GIF and WebP, found by their content as PIL finds them.
An image PIL opens and the port does not read (utils/io.probe_image: a
format such as QOI or JPEG 2000, or a variant such as a ZSTD TIFF)
raises NotImplementedError before any build work, naming ROADMAP item
13. Where PIL cannot decode a file either, a bitmap, normal map, bump map
or heightfield is missing (None, as in the JAX loader) and an envmap
raises ValueError, as the JAX loader's does, each with one warning
naming the file. The film's label[x, y] annotations and banner are read
as the JAX loader reads them.
Nothing else is dropped silently.
"""
from __future__ import annotations

import math
import os
import re
import time
import xml.etree.ElementTree as ET

import numpy as np

from ..core import rng as rng_mod
from ..core.math import matrix_lookat
from ..core.track import AnimatedTransform
from ..film.film import Film
from ..models import emitters as em
from ..models import media as med_mod
from ..models import shapes as shp
from ..models.bsdf import cloth as cloth_bsdf
from ..models.bsdf import registry as mat
from ..models import sensors
from ..models.sensors import Camera
from ..utils import io as io_utils
from ..utils import log as log_mod
from . import hairgen
from .scene import Scene, SceneBuilder

BSDF_KINDS = {
    "diffuse": mat.DIFFUSE,
    "roughdiffuse": mat.ROUGHDIFFUSE,
    "conductor": mat.CONDUCTOR,
    "mirror": mat.CONDUCTOR,
    "roughconductor": mat.ROUGHCONDUCTOR,
    "dielectric": mat.DIELECTRIC,
    "thindielectric": mat.THINDIELECTRIC,
    "plastic": mat.PLASTIC,
    "roughplastic": mat.ROUGHPLASTIC,
    "roughdielectric": mat.ROUGHDIELECTRIC,
    "difftrans": mat.DIFFTRANS,
    "mixturebsdf": mat.MIXTURE,
    "blendbsdf": mat.MIXTURE,
    "phong": mat.PHONG,
    "ward": mat.WARD,
    "null": mat.NULL,
    "kajiyakay": mat.KAJIYAKAY,
    # "marschner" = the fork's MarschnerDiffuse build; corrected mode is
    # the default, faithful quirks behind <boolean name="faithful">
    "marschner": mat.MARSCHNER_PURE,
    # alias used by some fork scene files (the class name, not the
    # plugin name)
    "marschner_diffuse": mat.MARSCHNER_PURE,
    "marschnerdielectric": mat.MARSCHNERDIELECTRIC,
    "hk": mat.HK,
    "irawan": mat.CLOTH,
    "mask": mat.MASK,
    "coating": mat.COATING,
    "roughcoating": mat.ROUGHCOATING,
}

SENSOR_KINDS = {
    "perspective": sensors.PERSPECTIVE, "thinlens": sensors.THINLENS,
    "orthographic": sensors.ORTHOGRAPHIC, "spherical": sensors.SPHERICAL,
    "telecentric": sensors.TELECENTRIC,
    "radiancemeter": sensors.RADIANCEMETER,
    "fluencemeter": sensors.FLUENCEMETER,
    "irradiancemeter": sensors.IRRADIANCEMETER,
    "perspective_rdist": sensors.PERSPECTIVE_RDIST,
}

# named IOR lookups used by the reference (src/bsdfs/ior.h data subset)
IOR_NAMES = {"air": 1.000277, "water": 1.3330, "bk7": 1.5046,
             "benzene": 1.501, "diamond": 2.419, "glass": 1.5046,
             "polypropylene": 1.49}

# the JAX loader's conductor presets: (eta, k rgb)
CONDUCTOR_PRESETS = {
    "Cu": (0.95, (3.9, 2.45, 2.14)),
    "Au": (0.40, (2.82, 2.35, 1.77)),
    "Ag": (0.14, (4.16, 3.44, 2.56)),
    "Al": (1.35, (7.47, 6.40, 5.30)),
    "Cr": (3.18, (3.33, 3.33, 3.33)),
    "none": (1e4, (0.0, 0.0, 0.0)),
}

_PHASE_KINDS = {"isotropic": med_mod.ISOTROPIC, "hg": med_mod.HG,
                "rayleigh": med_mod.RAYLEIGH, "kkay": med_mod.KKAY,
                "kkay_is": med_mod.KKAY_IS,
                "microflake": med_mod.MICROFLAKE,
                "mixturephase": med_mod.MIXTURE_PHASE}
# the images the loaders read linear, by their extension (any other file
# is an 8-bit image, which the JAX loader hands to PIL)
_LINEAR_EXTS = (".hdr", ".pfm", ".exr")
_DELTA_KINDS = {"point": em.POINT, "spot": em.SPOT,
                "directional": em.DIRECTIONAL, "collimated": em.COLLIMATED}


def _parse_rgb(s: str):
    parts = [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]
    if len(parts) == 1:
        parts = parts * 3
    return tuple(parts[:3])


def _subst(s: str, defines: dict) -> str:
    for k, v in defines.items():
        s = s.replace(f"${k}", str(v))
    return s


def _collect_props(node, defines):
    """Collect typed children (<float>, <rgb>, ...) into a dict."""
    props = {}
    for ch in node:
        name = ch.get("name")
        if ch.tag == "float":
            props[name] = float(_subst(ch.get("value"), defines))
        elif ch.tag == "integer":
            props[name] = int(float(_subst(ch.get("value"), defines)))
        elif ch.tag == "boolean":
            props[name] = _subst(ch.get("value"), defines).lower() == "true"
        elif ch.tag == "string":
            props[name] = _subst(ch.get("value"), defines)
        elif ch.tag in ("rgb", "spectrum", "srgb"):
            val = _subst(ch.get("value"), defines)
            if ch.tag == "spectrum" and ":" in val:
                # 'l1:v1 l2:v2 ...': an InterpolatedSpectrum integrated to
                # RGB through the CIE CMFs
                from ..core.spectrum import InterpolatedSpectrum
                props[name] = tuple(
                    InterpolatedSpectrum.from_string(val).to_rgb())
            else:
                props[name] = _parse_rgb(val)
        elif ch.tag == "blackbody":
            # <blackbody name="radiance" temperature="5000" [scale=..]/>:
            # Planck's law integrated against the CIE CMFs
            from ..core.spectrum import blackbody_rgb_exact
            temp = float(_subst(ch.get("temperature"), defines))
            sc = float(_subst(ch.get("scale", "1.0"), defines))
            props[name] = tuple(blackbody_rgb_exact(temp, scale=sc))
        elif ch.tag in ("vector", "point"):
            props[name] = (float(ch.get("x", 0)), float(ch.get("y", 0)),
                           float(ch.get("z", 0)))
    return props


def _parse_animation(node):
    """<animation name="toWorld"> with <transform time="t"> keyframes ->
    AnimatedTransform, or None without keyframes (reference:
    src/librender/scenehandler.cpp's animation tag, core/track.h)."""
    if node is None:
        return None
    keys = [(float(tr.get("time", 0.0)), _parse_transform(tr))
            for tr in node.findall("transform")]
    return AnimatedTransform(keys) if keys else None


def _parse_transform(node) -> np.ndarray:
    """Compose <matrix>/<translate>/<rotate>/<scale>/<lookat> children,
    applied in document order like the reference's Transform stack."""
    m = np.eye(4)
    for ch in node:
        if ch.tag == "matrix":
            vals = [float(x) for x in ch.get("value").split()]
            t = np.array(vals, np.float64).reshape(4, 4)
        elif ch.tag == "translate":
            t = np.eye(4)
            t[:3, 3] = [float(ch.get(a, 0)) for a in "xyz"]
        elif ch.tag == "scale":
            t = np.eye(4)
            if ch.get("value") is not None:
                s = float(ch.get("value"))
                sv = [s, s, s]
            else:
                sv = [float(ch.get(a, 1)) for a in "xyz"]
            t[0, 0], t[1, 1], t[2, 2] = sv
        elif ch.tag == "rotate":
            ax = np.array([float(ch.get(a, 0)) for a in "xyz"])
            ax = ax / np.linalg.norm(ax)
            ang = np.radians(float(ch.get("angle", 0)))
            K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                          [-ax[1], ax[0], 0]])
            R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
            t = np.eye(4)
            t[:3, :3] = R
        elif ch.tag == "lookat":
            origin = _parse_rgb(ch.get("origin"))
            target = _parse_rgb(ch.get("target"))
            up = _parse_rgb(ch.get("up", "0, 1, 0"))
            t = matrix_lookat(origin, target, up)
        else:
            continue
        m = t @ m
    return m


def _resolve_file(fname: str, scene_dir: str):
    """The JAX loader's lookup of an image file: relative to the scene's
    directory where it exists there, else as given; None if missing."""
    if fname and not os.path.isabs(fname):
        cand = os.path.join(scene_dir, fname)
        if os.path.exists(cand):
            fname = cand
    return fname if fname and os.path.exists(fname) else None


def _refuse_image(node, defines, scene_dir):
    """Refuse an existing image file the port cannot read, a format or a
    variant of one that PIL reads (io.probe_image reads its header)."""
    if node is None:
        return
    path = _resolve_file(_collect_props(node, defines).get("filename", ""),
                         scene_dir)
    if path is not None and not path.lower().endswith(_LINEAR_EXTS):
        io_utils.probe_image(path)


def _refuse_bsdf(node, defines, scene_dir):
    """Refuse a <bsdf> whose images the port cannot read."""
    while node.get("type") in ("twosided", "normalmap", "bumpmap"):
        if node.get("type") != "twosided":
            _refuse_image(node.find("texture"), defines, scene_dir)
        inner = node.find("bsdf")
        if inner is None:
            break
        node = inner
    tex = node.find("texture")
    if tex is not None and tex.get("type") == "scale" \
            and tex.find("texture") is not None:
        tex = tex.find("texture")
    if tex is not None and tex.get("type") == "bitmap":
        _refuse_image(tex, defines, scene_dir)


def _refuse_unported(root, defines, scene_dir):
    """Raise NotImplementedError for the first element the port does not
    render, before any build work."""
    for bsdf in root.iter("bsdf"):
        _refuse_bsdf(bsdf, defines, scene_dir)
    for shape in root.findall("shape"):
        if shape.get("type") == "heightfield":
            _refuse_image(shape, defines, scene_dir)
    for emit in root.findall("emitter"):
        if emit.get("type") == "envmap":
            fname = os.path.join(scene_dir, _collect_props(
                emit, defines).get("filename", ""))
            if os.path.isfile(fname) \
                    and not fname.lower().endswith(_LINEAR_EXTS):
                io_utils.probe_image(fname)


def _read_ldr(path: str, device, what: str):
    """io.read_ldr of an 8-bit image / 255 (float32), its size and
    decode seconds logged; where PIL cannot decode it either
    (ValueError), one warning naming the file and why, then the
    ValueError."""
    t0 = time.time()
    try:
        u8 = io_utils.read_ldr(path, device=device)
    except ValueError as e:
        log_mod.get("xml").warning("%s %s cannot be decoded (%s)", what,
                                   path, e)
        raise
    log_mod.get("xml").info("%s %s: %dx%d decoded in %.3f s", what, path,
                            u8.shape[1], u8.shape[0], time.time() - t0)
    return u8.astype(np.float32) / 255.0


def _read_texture_image(fname: str, scene_dir: str, gamma: float = 2.2,
                        device=None):
    """A texture image (HDR, PFM and EXR linear; an 8-bit image with the
    given de-gamma), or None when missing or when PIL cannot decode it
    either (the JAX loader's _read_texture_image, which returns None
    where PIL fails; the port logs a warning). A valid file the port does
    not read raised before the build (_refuse_unported). A JPEG's block
    stage runs on `device`."""
    path = _resolve_file(fname, scene_dir)
    if path is None:
        return None
    if path.lower().endswith(_LINEAR_EXTS):
        return _read_env_image(path)
    try:
        arr = _read_ldr(path, device, "the texture image")
    except ValueError:
        return None
    return arr ** gamma if gamma != 1.0 else arr


def _iors(p):
    """(intIOR, extIOR) of a BSDF's properties, a name looked up in
    IOR_NAMES (bk7 and air by default)."""
    int_ior = p.get("intIOR", "bk7")
    ext_ior = p.get("extIOR", "air")
    if isinstance(int_ior, str):
        int_ior = IOR_NAMES.get(int_ior, 1.5046)
    if isinstance(ext_ior, str):
        ext_ior = IOR_NAMES.get(ext_ior, 1.000277)
    return int_ior, ext_ior


def _material_row_from_bsdf(node, defines, builder: SceneBuilder,
                            scene_dir: str = ""):
    """Translate a <bsdf> element (possibly twosided-wrapped, possibly
    under a normalmap or bumpmap) into a material row, with the JAX
    loader's property rules; its textures are added to `builder`'s
    texture table."""
    twosided = False
    nrm = None  # (0 normalmap / 1 bumpmap, its texture element, scale)
    while node.get("type") in ("twosided", "normalmap", "bumpmap"):
        ntype = node.get("type")
        if ntype == "twosided":
            twosided = True
        else:
            p_w = _collect_props(node, defines)
            nrm = (0 if ntype == "normalmap" else 1, node.find("texture"),
                   float(p_w.get("scale", 1.0)))
        inner = node.find("bsdf")
        if inner is None:
            break
        node = inner
    btype = node.get("type")
    kind = BSDF_KINDS.get(btype)
    if kind is None:
        kind = mat.DIFFUSE  # fallback for unknown plugins
    p = _collect_props(node, defines)

    # "marschner" defaults to the corrected mode (true pdf, MIS
    # compatible); the fork's MarschnerDiffuse behaviour is kept behind
    # <boolean name="faithful" value="true"/> or -D marschner_faithful=true
    faithful = p.get("faithful",
                     str(defines.get("marschner_faithful",
                                     "false")).lower() == "true")
    if btype == "marschner" and bool(faithful):
        kind = mat.MARSCHNER

    if kind == mat.MIXTURE:
        # the two nested rows first (mixturebsdf.cpp, blendbsdf.cpp)
        children = node.findall("bsdf")[:2]
        sub_ids = [builder.add_material(
            **_material_row_from_bsdf(c, defines, builder, scene_dir))
            for c in children]
        while len(sub_ids) < 2:
            sub_ids.append(builder.add_material(kind=mat.DIFFUSE))
        weights = [float(x) for x in str(p.get("weights", "0.5, 0.5"))
                   .replace(",", " ").split()] if "weights" in p else None
        w = weights[0] if weights else p.get("weight", 0.5)
        return dict(kind=mat.MIXTURE, twosided=twosided,
                    mix_a=sub_ids[0], mix_b=sub_ids[1], mix_w=w)
    if kind in (mat.MASK, mat.COATING, mat.ROUGHCOATING):
        inner = node.find("bsdf")
        nested_id = builder.add_material(
            **_material_row_from_bsdf(inner, defines, builder, scene_dir)) \
            if inner is not None else builder.add_material(kind=mat.DIFFUSE)
        if kind == mat.MASK:
            return dict(kind=mat.MASK, twosided=twosided, mix_a=nested_id,
                        diffuse=p.get("opacity", (0.5, 0.5, 0.5)))
        int_ior, ext_ior = _iors(p)
        sa = np.asarray(p.get("sigmaA", (0.0, 0.0, 0.0)), np.float32)
        return dict(kind=kind, twosided=twosided, mix_a=nested_id,
                    eta=float(int_ior) / float(ext_ior),
                    sigma_a=tuple(sa * float(p.get("thickness", 1.0))),
                    alpha=float(p.get("alpha", 0.1)),
                    dist=0 if p.get("distribution", "ggx") != "beckmann"
                    else 1,
                    specular=p.get("specularReflectance", (1.0, 1.0, 1.0)))

    if kind == mat.CLOTH:
        # irawan woven cloth (src/bsdfs/irawan.cpp): a weave DSL file
        # relative to the scene's directory (or a built-in name),
        # repeatU / repeatV, and the properties forwarded to the pattern
        # grammar's $var substitution
        fname = str(p.get("filename", "plain"))
        text = cloth_bsdf.BUILTIN_WEAVES.get(fname)
        if text is None:
            with open(os.path.join(scene_dir, fname)) as fh:
                text = fh.read()
        return dict(kind=mat.CLOTH, twosided=twosided,
                    weave=cloth_bsdf.parse_weave(text, p),
                    repeat_u=float(p.get("repeatU", 1.0)),
                    repeat_v=float(p.get("repeatV", 1.0)))

    row = dict(kind=kind, twosided=twosided)
    int_ior, ext_ior = _iors(p)
    defaults_eta = {"marschner": 1.55, "marschnerdielectric": 1.501}
    row["eta"] = float(int_ior) / float(ext_ior) if "intIOR" in p or \
        "extIOR" in p else defaults_eta.get(btype, 1.5046)

    if "reflectance" in p:
        row["diffuse"] = p["reflectance"]
    if "diffuseReflectance" in p:
        row["diffuse"] = p["diffuseReflectance"]
    if "specularReflectance" in p:
        row["specular"] = p["specularReflectance"]
    if "specularTransmittance" in p:
        row["transmit"] = p["specularTransmittance"]
    if "exponent" in p:
        row["exponent"] = p["exponent"]
    if "alpha" in p:
        row["alpha"] = p["alpha"]
    if "nonlinear" in p:
        row["nonlinear"] = p["nonlinear"]
    if btype == "hk":
        # sigma_s -> transmit, sigma_a, thickness -> alpha, HG g -> beta_r
        row["transmit"] = p.get("sigmaS", (2.0, 2.0, 2.0))
        row["sigma_a"] = p.get("sigmaA", (0.05, 0.05, 0.05))
        row["alpha"] = float(p.get("thickness", 1.0))
        row["beta_r"] = float(p.get("g", 0.0))
    row["dist"] = 0 if p.get("distribution", "ggx") != "beckmann" else 1
    if btype == "marschner":
        # hardcoded in the reference ctor (marschner_diffuse.cpp:125,152-157)
        row["sigma_a"] = (0.5, 0.5, 0.5)
        row["beta_r"] = 0.1
        row["scale_tilt"] = -0.1
        row.setdefault("specular", (0.5, 0.5, 0.5))
        row.setdefault("transmit", (0.5, 0.5, 0.5))
    if btype in ("conductor", "mirror", "roughconductor"):
        # the named conductor presets, (eta, k rgb) at the R, G and B
        # wavelengths (the reference ships spectral .spd tables)
        eta_c, k_c = CONDUCTOR_PRESETS.get(p.get("material", "Cu"),
                                           CONDUCTOR_PRESETS["Cu"])
        row["eta"] = eta_c
        row["k"] = k_c
        if btype == "mirror":
            row["eta"] = 1e4  # F -> 1
            row["k"] = (0.0, 0.0, 0.0)

    # the texture child (the teapot floor's checkerboard), possibly under
    # a scale texture (src/textures/scale.cpp: a constant times it)
    tex = node.find("texture")
    tex_gain = 1.0
    if tex is not None and tex.get("type") == "scale":
        sp_ = _collect_props(tex, defines)
        tex_gain = float(np.mean(sp_.get("scale", sp_.get("value", 1.0))))
        inner_tex = tex.find("texture")
        if inner_tex is not None:
            tex = inner_tex
    ttype = tex.get("type") if tex is not None else None
    if ttype is not None:
        tp = _collect_props(tex, defines)
    if ttype == "wireframe":
        row["tex_id"] = builder.add_wireframe_texture(
            color0=np.asarray(tp.get("interiorColor", (0.5,) * 3))
            * tex_gain,
            color1=np.asarray(tp.get("edgeColor", (0.1,) * 3)) * tex_gain,
            line_width=tp.get("lineWidth", 0.05))
    elif ttype == "vertexcolors":
        row["tex_id"] = builder.add_vertexcolor_texture()
    elif ttype == "curvature":
        row["tex_id"] = builder.add_vertexcolor_texture()
        builder.curvature_scale = float(tp.get("scale", 1.0))
        row["__curvature__"] = True
    elif ttype == "gridtexture":
        row["tex_id"] = builder.add_gridtexture(
            color0=np.asarray(tp.get("color0", (0.2,) * 3)) * tex_gain,
            color1=np.asarray(tp.get("color1", (0.4,) * 3)) * tex_gain,
            line_width=tp.get("lineWidth", 0.01),
            uscale=tp.get("uscale", 1.0), vscale=tp.get("vscale", 1.0),
            uoffset=tp.get("uoffset", 0.0), voffset=tp.get("voffset", 0.0))
    elif ttype == "checkerboard":
        row["tex_id"] = builder.add_checkerboard(
            color0=np.asarray(tp.get("color0", (0.4,) * 3)) * tex_gain,
            color1=np.asarray(tp.get("color1", (0.2,) * 3)) * tex_gain,
            uscale=tp.get("uscale", 1.0), vscale=tp.get("vscale", 1.0),
            uoffset=tp.get("uoffset", 0.0), voffset=tp.get("voffset", 0.0))
    elif ttype == "bitmap":
        img = _read_texture_image(tp.get("filename", ""), scene_dir,
                                  device=builder.device)
        if img is not None:
            row["tex_id"] = builder.add_bitmap_texture(
                np.asarray(img) * tex_gain, uscale=tp.get("uscale", 1.0),
                vscale=tp.get("vscale", 1.0),
                uoffset=tp.get("uoffset", 0.0),
                voffset=tp.get("voffset", 0.0))
    if nrm is not None and nrm[1] is not None:
        # the normal or bump texture, read without de-gamma
        ntp = _collect_props(nrm[1], defines)
        nimg = _read_texture_image(ntp.get("filename", ""), scene_dir,
                                   gamma=1.0, device=builder.device)
        if nimg is not None:
            row["nrm_tex_id"] = builder.add_bitmap_texture(
                nimg, uscale=ntp.get("uscale", 1.0),
                vscale=ntp.get("vscale", 1.0),
                uoffset=ntp.get("uoffset", 0.0),
                voffset=ntp.get("voffset", 0.0))
            row["nrm_kind"] = nrm[0]
            row["nrm_scale"] = nrm[2]
    return row


def _standin_fibers(scene_dir: str, filename: str, radius: float,
                    quality: float):
    """Procedural replacement for a missing .mitshair file, keyed by the
    scene directory and file name. quality < 1 cuts the fiber count and
    enlarges the radius by 1/sqrt(quality), which keeps the projected
    coverage (the reference's stochastic `reduction`, hair.cpp:620-628)."""
    key = (os.path.basename(os.path.normpath(scene_dir)) + " "
           + os.path.basename(filename)).lower()
    q = quality
    radius = radius / np.sqrt(min(max(q, 1e-6), 1.0))
    if "furball" in key:
        return hairgen.gen_furball(n_fibers=int(6000 * q), radius=radius)
    if "curly" in key:
        return hairgen.gen_curly_hair(n_fibers=int(500 * q), radius=radius)
    if "black_hair" in key or "red_hair" in key or "brown_hair" in key \
            or "blonde_hair" in key:
        idx = ["black_hair", "red_hair", "brown_hair",
               "blonde_hair"].index(key.split()[-1].split(".")[0])
        clumps = hairgen.gen_hair_curl(n_fibers_per_clump=int(220 * q),
                                       radius=radius)
        return clumps[idx]
    return hairgen.gen_straight_hair(n_fibers=int(800 * q), radius=radius)


def _mesh_shape(stype: str, p: dict, scene_dir: str, to_world,
                device=None):
    """(mesh, toWorld) of a mesh shape with the JAX loader's rules, or
    None for a shape of another type."""
    if stype == "heightfield":
        img = _read_texture_image(p.get("filename", ""), scene_dir,
                                  gamma=1.0, device=device)
        return shp.heightfield(img.mean(-1) if img is not None
                               else _ripples(),
                               scale_z=float(p.get("scale", 1.0))), to_world
    if stype in ("obj", "ply", "serialized"):
        fname = os.path.join(scene_dir, p.get("filename", ""))
        if not os.path.exists(fname):
            return shp.compute_smooth_normals(shp.teapot_standin()), to_world
        if stype == "obj":
            mesh = shp.load_obj(fname)
        elif stype == "ply":
            mesh = shp.load_ply_ascii(fname)
        else:
            mesh = shp.load_serialized(fname, p.get("shapeIndex", 0))
        if mesh.normals is None and p.get("faceNormals", False) is False:
            mesh = shp.compute_smooth_normals(mesh)
        return mesh, to_world
    if stype == "sphere":
        t2 = to_world.copy()
        if "center" in p:
            t2[:3, 3] += np.asarray(p["center"])
        return shp.sphere(p.get("radius", 1.0)), t2
    if stype == "cylinder":
        return shp.cylinder(p.get("radius", 1.0)), to_world
    simple = {"rectangle": shp.rectangle, "disk": shp.disk, "cube": shp.cube}
    if stype in simple:
        return simple[stype](), to_world
    return None


def _ripples(g: int = 65):
    """The JAX loader's heightfield for a missing image: gentle ripples."""
    yy, xx = np.meshgrid(np.linspace(0, 4 * np.pi, g),
                         np.linspace(0, 4 * np.pi, g))
    return 0.1 * np.sin(xx) * np.cos(yy)


def _shape_group(shape, defines, scene_dir, mat_ids, mid, b) -> list:
    """A shapegroup's children as prototypes (reference:
    src/shapes/shapegroup.cpp), with the JAX loader's rules: rectangle,
    sphere (radius), cube, and obj, ply or serialized files that exist,
    each with its toWorld and smooth normals where it has none, under
    its own <ref> or the group's material. Returns their indices."""
    group = []
    for child in shape.findall("shape"):
        cp = _collect_props(child, defines)
        ctype = child.get("type")
        cmesh = None
        if ctype == "rectangle":
            cmesh = shp.rectangle()
        elif ctype == "sphere":
            cmesh = shp.sphere(cp.get("radius", 1.0))
        elif ctype == "cube":
            cmesh = shp.cube()
        elif ctype in ("obj", "ply", "serialized"):
            fn = os.path.join(scene_dir, cp.get("filename", ""))
            if os.path.exists(fn):
                cmesh = shp.load_obj(fn) if ctype == "obj" else (
                    shp.load_ply_ascii(fn) if ctype == "ply"
                    else shp.load_serialized(fn))
        if cmesh is None:
            continue
        ctr = child.find("transform")
        if ctr is not None:
            cmesh = shp.transform_mesh(cmesh, _parse_transform(ctr))
        if cmesh.normals is None:
            cmesh = shp.compute_smooth_normals(cmesh)
        cref = child.find("ref")
        cmid = mat_ids.get(cref.get("id")) if cref is not None else mid
        group.append(b.add_prototype(cmesh, cmid if cmid is not None
                                     else mid))
    return group


def _deformable(p, defines, scene_dir, mid, to_world, b, radiance=None):
    """A keyframe morph (reference: src/shapes/deformable.cpp) lerped at
    `time` (-D time=t, else its own), as the JAX loader adds it (an area
    light where radiance is given); a missing file adds nothing."""
    f0 = os.path.join(scene_dir, p.get("filename", ""))
    f1 = os.path.join(scene_dir, p.get("filename2", p.get("filename", "")))
    if not os.path.exists(f0):
        return
    t_anim = float(defines.get("time", p.get("time", 0.0)))

    def load(f):
        return shp.load_obj(f) if f.endswith(".obj") \
            else shp.load_serialized(f)
    m0 = load(f0)
    m1 = load(f1) if os.path.exists(f1) and f1 != f0 else m0
    b.add_morph_mesh(m0, m1, mid, to_world=to_world, radiance=radiance,
                     time=t_anim)


def _read_env_image(fname: str, device=None):
    """An envmap image: HDR, PFM and EXR linear, an LDR image de-gammaed
    with 2.2 (the JAX loader's envmap branch)."""
    low = fname.lower()
    if low.endswith(".hdr"):
        return io_utils.read_hdr(fname)
    if low.endswith(".pfm"):
        return io_utils.read_pfm(fname)
    if low.endswith(".exr"):
        from ..utils import exr as exr_utils
        return exr_utils.read_exr(fname)[..., :3]
    # PIL's failure raises here, as in the JAX loader
    return _read_ldr(fname, device, "the envmap image") ** 2.2


def load_scene(path: str, defines: dict | None = None,
               spp_override: int | None = None,
               res_scale: float = 1.0,
               hair_quality: float = 1.0,
               max_depth_override: int | None = None,
               validate: bool = True, device=None) -> Scene:
    """The scene of a scene XML, its tables on `device` (the card unless
    "cpu"). The arguments are the JAX loader's."""
    defines = defines or {}
    scene_dir = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    if validate:
        from .xml_validate import validate as _validate_xml
        _validate_xml(root, path)
    _refuse_unported(root, defines, scene_dir)
    b = SceneBuilder(device=device)

    # integrator
    max_depth = 65
    integrator_type = "path"
    motion_time = 1.0
    motion_cfg = "d"
    for integ in root.findall("integrator"):
        ip = _collect_props(integ, defines)
        max_depth = ip.get("maxDepth", 65)
        integrator_type = integ.get("type") or "path"
        if integrator_type == "direct":
            max_depth = 2
        elif integrator_type == "motion":
            # the reference overloads `time`: a float is the target time,
            # a string the path configuration (motion.cpp)
            tm = ip.get("time", 1.0)
            if isinstance(tm, str) and not tm.replace(".", "", 1).isdigit():
                motion_cfg = tm
            else:
                motion_time = float(tm)
            motion_cfg = ip.get("config", motion_cfg)
    if max_depth_override is not None:
        max_depth = max_depth_override

    # sensor + film + sampler
    cam = film = None
    spp = 16
    sampler_kind = rng_mod.SOBOL
    shutter_open = 0.0
    tiled_film = False
    for sensor in root.findall("sensor"):
        if sensor.find("medium") is not None:
            # the JAX loader reads no sensor medium either
            log_mod.get("xml").info("%s: the sensor's <medium> is "
                                    "ignored, as the JAX loader ignores it",
                                    path)
        p = _collect_props(sensor, defines)
        fov = p.get("fov", 35.0)
        shutter_open = float(p.get("shutterOpen", 0.0))
        b.shutter = (shutter_open,
                     float(p.get("shutterClose", shutter_open)))
        tr = sensor.find("transform")
        to_world = _parse_transform(tr) if tr is not None else np.eye(4)
        anim = _parse_animation(sensor.find("animation"))
        if anim is not None:
            to_world = anim.eval(shutter_open)
            b.camera_anim = anim
        sam = sensor.find("sampler")
        if sam is not None:
            sp = _collect_props(sam, defines)
            spp = sp.get("sampleCount", 16)
            stype_s = sam.get("type", "independent")
            if stype_s in ("halton", "hammersley"):
                sampler_kind = rng_mod.HALTON
            elif stype_s == "sobol":
                sampler_kind = "sobol"  # resolved once the film is known
            elif stype_s == "ldsampler":
                sampler_kind = rng_mod.SOBOL
            elif stype_s == "stratified":
                sampler_kind = (rng_mod.STRATIFIED, int(spp))
            else:
                sampler_kind = rng_mod.INDEPENDENT
        fm = sensor.find("film")
        w, h, gamma, rfilter = 768, 576, 2.2, "tent"
        tiled_film = fm is not None and fm.get("type") == "tiledhdrfilm"
        # label[x, y] annotations and the banner flag
        # (src/films/annotations.h, banner.h)
        annotations, banner = [], False
        if fm is not None:
            fp = _collect_props(fm, defines)
            w = fp.get("width", 768)
            h = fp.get("height", 576)
            gamma = fp.get("gamma", 2.2)
            rf = fm.find("rfilter")
            if rf is not None:
                rfilter = rf.get("type", "tent")
            banner = bool(fp.get("banner", False))
            for k, v in fp.items():
                m_lab = re.match(r"^label\[(-?\d+),(-?\d+)\]$",
                                 k.replace(" ", ""))
                if m_lab and isinstance(v, str):
                    annotations.append((int(m_lab.group(1)),
                                        int(m_lab.group(2)), v))
        w = max(8, int(round(w * res_scale)))
        h = max(8, int(round(h * res_scale)))
        film = Film.make(w, h, rfilter, gamma, annotations=annotations,
                         banner=banner)
        kc = [float(x) for x in str(p["kc"]).replace(",", " ").split()[:2]] \
            if "kc" in p else [0.0, 0.0]
        cam = Camera.perspective(
            to_world, fov, w, h, fov_axis=p.get("fovAxis", "x"),
            kind=SENSOR_KINDS.get(sensor.get("type", "perspective"),
                                  sensors.PERSPECTIVE),
            aperture_radius=float(p.get("apertureRadius", 0.0)),
            focus_distance=float(p.get("focusDistance", 1.0)))
        cam = cam._replace(kc0=kc[0], kc1=kc[1] if len(kc) > 1 else 0.0)
        if anim is not None:
            b.camera1 = cam._replace(to_world=np.asarray(
                anim.eval(motion_time), np.float32))
    if cam is None:
        raise ValueError(f"{path}: the scene has no <sensor>")
    if spp_override is not None:
        spp = spp_override

    # materials by id, in document order
    mat_ids = {}
    for bsdf in root.findall("bsdf"):
        row = _material_row_from_bsdf(bsdf, defines, b, scene_dir)
        mat_ids[bsdf.get("id")] = b.add_material(**row)

    # shapes (a shape of an unknown type gets its material and no
    # geometry, as in the JAX loader; so do a shapegroup and an instance)
    shape_groups = {}
    sss_single = False
    sss_g = 0.0
    for shape in root.findall("shape"):
        p = _collect_props(shape, defines)
        tr = shape.find("transform")
        to_world = _parse_transform(tr) if tr is not None else np.eye(4)
        anim = _parse_animation(shape.find("animation"))
        if anim is not None:
            to_world = anim.eval(shutter_open)
        first_mesh = len(b.tri_meshes)
        # a subsurface element makes the shape a DIPOLE material
        ss_el = shape.find("subsurface")
        dipole_mat = None
        if ss_el is not None and ss_el.get("type") in ("dipole",
                                                       "singlescatter"):
            sp2 = _collect_props(ss_el, defines)
            int_ior = sp2.get("intIOR", 1.5)
            if isinstance(int_ior, str):
                int_ior = IOR_NAMES.get(int_ior, 1.5)
            dipole_mat = b.add_material(
                kind=mat.DIPOLE,
                transmit=sp2.get("sigmaS", (2.6, 3.2, 3.9)),
                sigma_a=sp2.get("sigmaA", (0.0021, 0.0041, 0.0071)),
                eta=float(int_ior), mix_w=float(sp2.get("scale", 1.0)))
            if ss_el.get("type") == "singlescatter":
                sss_single = True
                sss_g = float(sp2.get("g", 0.0))
        mid = None
        ref = shape.find("ref")
        if ref is not None and ref.get("id") in mat_ids:
            mid = mat_ids[ref.get("id")]
        else:
            inline = shape.find("bsdf")
            if inline is not None:
                mid = b.add_material(**_material_row_from_bsdf(
                    inline, defines, b, scene_dir))
        if dipole_mat is not None:
            mid = dipole_mat  # subsurface overrides the surface BSDF
        # shape-bounded media (<medium name="interior|exterior">)
        med_int = med_ext = 0
        for md_el in shape.findall("medium"):
            mp2 = _collect_props(md_el, defines)
            med_id = b.add_medium(mp2.get("sigmaS", (0.5, 0.5, 0.5)),
                                  mp2.get("sigmaA", (0.1, 0.1, 0.1)),
                                  g=float(mp2.get("g", 0.0)))
            if md_el.get("name") == "exterior":
                med_ext = med_id
            else:
                med_int = med_id
        if mid is None and (med_int or med_ext):
            # a medium boundary without a BSDF: the implicit null boundary
            mid = b.add_material(kind=mat.NULL)
        if mid is None:
            mid = b.add_material(kind=mat.DIFFUSE)
        # an area light: the radiance of the shape's last <emitter>
        radiance = None
        for emit in shape.findall("emitter"):
            radiance = _collect_props(emit, defines).get("radiance",
                                                         (1.0, 1.0, 1.0))
        stype = shape.get("type")
        if stype == "shapegroup":
            shape_groups[shape.get("id")] = _shape_group(
                shape, defines, scene_dir, mat_ids, mid, b)
            continue
        if stype == "instance":
            gref = shape.find("ref")
            for pidx in shape_groups.get(
                    gref.get("id") if gref is not None else None, []):
                b.add_instance(pidx, to_world, anim=anim)
            continue
        if stype != "hair":
            if stype == "deformable":
                _deformable(p, defines, scene_dir, mid, to_world, b,
                            radiance)
            else:
                got = _mesh_shape(stype, p, scene_dir, to_world, b.device)
                if got is not None:
                    b.add_mesh(got[0], mid, to_world=got[1],
                               radiance=radiance)
            if anim is not None:
                # stored at shutter open, moved by anim(t) inv(anim(open));
                # the motion integrator's relative motion to motion_time
                rel = (anim.eval(motion_time)
                       @ np.linalg.inv(to_world)).astype(np.float32)
                for k in range(first_mesh, len(b.tri_meshes)):
                    b.animated_meshes[k] = anim
                    b.mesh_motion[k] = rel
            if med_int or med_ext:
                for k in range(first_mesh, len(b.tri_meshes)):
                    b.mesh_media[k] = (med_int, med_ext)
            continue
        radius = p.get("radius", 0.025)
        fname = os.path.join(scene_dir, p.get("filename", ""))
        if os.path.exists(fname):
            fs = hairgen.load_hair_file(
                fname, radius,
                angle_threshold_deg=p.get("angleThreshold", 1.0),
                reduction=p.get("reduction", 0.0))
        else:
            fs = _standin_fibers(scene_dir, p.get("filename", ""), radius,
                                 hair_quality)
        if not np.allclose(to_world, np.eye(4)):
            verts = fs.vertices @ to_world[:3, :3].T + to_world[:3, 3]
            # the radius scales with the transform (hair.cpp:632-633)
            sc = np.cbrt(abs(np.linalg.det(to_world[:3, :3])))
            fs = hairgen.FiberSet(verts, fs.vertex_starts_fiber,
                                  fs.radius * sc)
        b.add_fibers(fs, mid)

    # emitters: the environment (the last one wins) and the delta lights,
    # as in the JAX loader (xml_loader.py:822-863)
    for emit in root.findall("emitter"):
        etype = emit.get("type")
        p = _collect_props(emit, defines)
        tr = emit.find("transform")
        to_world = _parse_transform(tr) if tr is not None else np.eye(4)
        if etype in ("sunsky", "sky", "sun"):
            b.env = em.bake_sunsky(
                p.get("sunDirection", (0.0, 1.0, 0.0)),
                turbidity=p.get("turbidity", 3.0),
                sky_scale=p.get("skyScale", 1.0),
                sun_scale=p.get("sunScale", 1.0),
                sun_radius_scale=p.get("sunRadiusScale", 1.0),
                with_sun=(etype != "sky"), with_sky=(etype != "sun"),
                device=b.device)
        elif etype == "envmap":
            fname = os.path.join(scene_dir, p.get("filename", ""))
            if os.path.exists(fname):
                img = _read_env_image(fname, b.device)
            else:
                img = np.full((64, 128, 3), 0.8, np.float32)
            b.env = em.make_envmap(img, to_world[:3, :3],
                                   scale=p.get("scale", 1.0),
                                   device=b.device)
        elif etype == "constant":
            b.env = em.make_constant(p.get("radiance", (1.0, 1.0, 1.0)),
                                     device=b.device)
        elif etype in _DELTA_KINDS:
            cutoff = p.get("cutoffAngle", 20.0)
            b.delta_lights.append(dict(
                kind=_DELTA_KINDS[etype],
                position=p.get("position", tuple(to_world[:3, 3])),
                direction=p.get("direction",
                                tuple(to_world[:3, :3] @ [0, 0, 1])),
                intensity=p.get("intensity", p.get(
                    "irradiance", p.get("power", (1.0, 1.0, 1.0)))),
                cutoff_deg=cutoff,
                beam_deg=p.get("beamWidth", cutoff * 0.75)))

    for md in root.findall("medium"):
        b.medium = _scene_medium(md, defines, scene_dir, b)

    if sampler_kind == "sobol":
        # true high-dimensional Sobol' with the per-pixel
        # elementary-interval lookup at resolution 2^m
        m_res = max(1, math.ceil(math.log2(max(film.width, film.height))))
        sampler_kind = (rng_mod.SOBOL_QMC, m_res, film.width)

    return b.build(cam, film, spp=int(spp), max_depth=int(max_depth),
                   sampler=sampler_kind, integrator=integrator_type,
                   sss_single=sss_single, sss_g=sss_g,
                   motion_config=motion_cfg, tiled_film=tiled_film)


def _scene_medium(md, defines, scene_dir: str, b: SceneBuilder):
    """A scene-level <medium type="homogeneous|heterogeneous"> (the JAX
    loader's rules, xml_loader.py:866-948): its phase (any kind, a
    mixture's children, a micro-flake's stddev and orientation), a
    gridvolume or constvolume with its scale, or a homogeneous fog whose
    depth is four diagonals of the scene's bounding box."""
    mp = _collect_props(md, defines)
    ph_el = md.find("phase")
    pk = med_mod.HG
    g_val = float(mp.get("g", 0.0))
    kkay_p = {}
    if ph_el is not None:
        pp = _collect_props(ph_el, defines)
        pk = _PHASE_KINDS.get(ph_el.get("type", "isotropic"), med_mod.HG)
        g_val = float(pp.get("g", g_val))
        kkay_p = dict(ks=float(pp.get("ks", 0.4)),
                      kd=float(pp.get("kd", 0.2)),
                      exponent=float(pp.get("exponent", 4.0)))
        if pk == med_mod.MICROFLAKE:
            kkay_p = dict(stddev=float(pp.get("stddev", 0.3)),
                          orientation=tuple(np.asarray(
                              pp.get("orientation", (0.0, 0.0, 1.0)),
                              np.float32)))
        if pk == med_mod.MIXTURE_PHASE:
            ws = [float(x) for x in re.split(
                r"[,\s]+", str(pp.get("weights", "")).strip()) if x]
            kids = ph_el.findall("phase")
            mix = []
            for i, ch in enumerate(kids):
                cp = _collect_props(ch, defines)
                ck = _PHASE_KINDS.get(ch.get("type", "isotropic"),
                                      med_mod.ISOTROPIC)
                cw = ws[i] if i < len(ws) else 1.0 / max(len(kids), 1)
                mix.append((ck, cw, float(cp.get("g", 0.0))))
            kkay_p = dict(mix=tuple(mix))
    sig_s = mp.get("sigmaS", (0.5, 0.5, 0.5))
    sig_a = mp.get("sigmaA", (0.1, 0.1, 0.1))
    if md.get("type") == "heterogeneous":
        vol = None
        for ve in md.findall("volume"):
            vp = _collect_props(ve, defines)
            if ve.get("type") == "gridvolume" and "filename" in vp:
                fname = vp["filename"]
                if not os.path.isabs(fname):
                    fname = os.path.join(scene_dir, fname)
                vol = med_mod.load_vol(fname, device=b.device)
            elif ve.get("type") == "constvolume":
                val = float(np.mean(vp.get("value", 1.0)))
                vol = med_mod.make_grid_volume(
                    np.full((2, 2, 2), val, np.float32), (-1e3,) * 3,
                    (1e3,) * 3, device=b.device)
        if vol is None:
            raise ValueError("heterogeneous medium needs a gridvolume")
        return med_mod.make_hetero_medium(
            vol, sig_s, sig_a, g=g_val, phase_kind=pk,
            density_scale=float(mp.get("scale", 1.0)))
    # a finite fog: a ray to the environment crosses ~4 bounding-box
    # diagonals of medium
    pts = [np.asarray(m.positions).reshape(-1, 3) for m, _, _ in b.tri_meshes]
    pts += [np.asarray(fs.vertices).reshape(-1, 3) for fs, _ in b.fibers]
    if pts:
        allp = np.concatenate(pts, 0)
        diag = float(np.linalg.norm(allp.max(0) - allp.min(0)))
    else:
        diag = 10.0
    return med_mod.make_medium(
        sig_s, sig_a, g=g_val, phase_kind=pk,
        fog_depth=float(mp.get("fogDepth", max(4.0 * diag, 1.0))),
        device=b.device, **kkay_p)
