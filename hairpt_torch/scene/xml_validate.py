"""Structural scene-XML validation, early and with every error collected
(port of hairpt/scene/xml_validate.py).

Counterpart of the reference's XSD validation (data/schema/scene.xsd,
src/librender/scenehandler.cpp:197) and PluginManager's unknown-plugin
errors: the scene root and its version attribute, required attributes
per tag, tag placement, known plugin `type` names per category and
property values that parse, all reported at once in one SceneXMLError
with element paths (scene/shape[2]/bsdf). `$var` placeholders are
wildcards, since substitution happens at load time.

The names it accepts are the JAX package's, not the subset the port
renders: the same XML validates, and fails, the same way in both
packages. What the port cannot render is refused by the loader.
"""
from __future__ import annotations

import re


class SceneXMLError(ValueError):
    """All structural problems found in a scene XML, with element paths."""

    def __init__(self, errors):
        self.errors = list(errors)
        msg = "scene XML validation failed:\n" + "\n".join(
            f"  - {e}" for e in self.errors)
        super().__init__(msg)


# property tags: required attributes
_PROP_TAGS = {
    "float": ("name", "value"),
    "integer": ("name", "value"),
    "boolean": ("name", "value"),
    "string": ("name", "value"),
    "rgb": ("name", "value"),
    "srgb": ("name", "value"),
    "spectrum": ("name", "value"),
    "vector": ("name",),
    "point": ("name",),
    "blackbody": ("name", "temperature"),
}

# plugin tags (require `type`) and where they may appear
_PLUGIN_PARENTS = {
    "integrator": {"scene", "integrator"},
    "sensor": {"scene"},
    "film": {"sensor"},
    "sampler": {"sensor"},
    "rfilter": {"film"},
    "emitter": {"scene", "shape"},
    "shape": {"scene", "shape"},          # shapegroup nests shapes
    "bsdf": {"scene", "shape", "bsdf"},   # twosided/coating/mixture nest
    "texture": {"scene", "bsdf", "texture", "shape"},
    "medium": {"scene", "shape", "sensor"},
    # bsdf: the fork's Marschner BSDFs accept a phase child
    # (marschner.cpp:160-162 instantiates kkay as the default phase)
    "phase": {"medium", "phase", "bsdf"},
    "volume": {"medium"},
    "subsurface": {"scene", "shape"},
}

_TRANSFORM_CHILDREN = {"matrix", "translate", "rotate", "scale", "lookat"}
_OTHER_TAGS = {"transform", "animation", "ref", "default", "alias",
               "include", "null"}

# known plugin type names per category. Mirrors what the loader + model
# registries actually implement; unknown names error early the way
# PluginManager does (plugin.cpp:118 'plugin not found').
_KNOWN_TYPES = {
    "integrator": {"path", "direct", "ao", "volpath", "volpath_simple",
                   "bdpt", "pssmlt", "mlt", "erpt", "photonmapper", "ppm",
                   "sppm", "ptracer", "vpl", "adaptive", "irrcache",
                   "multichannel", "field", "motion"},
    "sensor": {"perspective", "thinlens", "orthographic", "telecentric",
               "spherical", "radiancemeter", "fluencemeter",
               "irradiancemeter", "perspective_rdist"},
    "film": {"hdrfilm", "ldrfilm", "mfilm", "tiledhdrfilm"},
    "sampler": {"independent", "stratified", "ldsampler", "halton",
                "hammersley", "sobol"},
    "rfilter": {"box", "tent", "gaussian", "mitchell", "catmullrom",
                "lanczos"},
    "emitter": {"point", "spot", "area", "constant", "directional",
                "collimated", "envmap", "sky", "sun", "sunsky"},
    "shape": {"obj", "ply", "serialized", "sphere", "cylinder", "disk",
              "rectangle", "cube", "instance", "shapegroup", "deformable",
              "heightfield", "hair"},
    "texture": {"checkerboard", "bitmap", "gridtexture", "scale",
                "vertexcolors", "wireframe", "curvature"},
    "medium": {"homogeneous", "heterogeneous"},
    "phase": {"hg", "isotropic", "rayleigh", "kkay", "microflake",
              "mixturephase"},
    "volume": {"constvolume", "gridvolume", "hgridvolume", "volcache"},
    "subsurface": {"dipole", "singlescatter"},
}


def _bsdf_types():
    from . import xml_loader
    return set(xml_loader.BSDF_KINDS.keys()) | {"twosided", "bumpmap",
                                                "normalmap"}


def _path(stack, tag, idx):
    return "/".join(stack + [f"{tag}[{idx}]" if idx else tag])


def validate(root, path_hint: str = "") -> None:
    """Raise SceneXMLError listing every structural problem, or return
    None for a valid tree. `root` is the parsed <scene> element."""
    errors = []
    unknowns = []
    known = dict(_KNOWN_TYPES)
    known["bsdf"] = _bsdf_types()

    if root.tag != "scene":
        errors.append(f"root element is <{root.tag}>, expected <scene>")
    elif root.get("version") is None:
        errors.append("<scene> is missing the required version attribute "
                      "(scenehandler.h:51 VersionException parity)")

    def has_var(v):
        return v is not None and "$" in v

    def walk(el, stack):
        for i, ch in enumerate(el):
            tag = ch.tag
            here = "/".join(stack + [tag])
            if tag in _PROP_TAGS:
                for attr in _PROP_TAGS[tag]:
                    if ch.get(attr) is None:
                        # <spectrum filename=...> form also legal
                        if tag == "spectrum" and attr == "value" \
                                and ch.get("filename") is not None:
                            continue
                        errors.append(f"{here}: <{tag}> missing required "
                                      f"attribute '{attr}'")
                val = ch.get("value")
                if tag in ("float", "integer") and val is not None \
                        and not has_var(val):
                    try:
                        float(val)
                    except ValueError:
                        errors.append(f"{here}: {tag} value '{val}' is "
                                      "not numeric")
                if tag in ("rgb", "srgb") and val is not None \
                        and not has_var(val):
                    n = len([x for x in re.split(r"[,\s]+", val.strip())
                             if x])
                    if n not in (1, 3):
                        errors.append(f"{here}: {tag} value needs 1 or 3 "
                                      f"components, got {n}")
            elif tag in _PLUGIN_PARENTS:
                parent = stack[-1].split("[")[0] if stack else "?"
                if parent not in _PLUGIN_PARENTS[tag]:
                    allowed = ", ".join(sorted(_PLUGIN_PARENTS[tag]))
                    errors.append(f"{here}: <{tag}> not allowed under "
                                  f"<{parent}> (allowed under: {allowed})")
                t = ch.get("type")
                if t is None:
                    if ch.get("ref") is None and tag != "medium":
                        errors.append(f"{here}: <{tag}> missing required "
                                      "attribute 'type'")
                elif not has_var(t) and t not in known.get(tag, {t}):
                    errors.append(
                        f"{here}: unknown {tag} type '{t}' (known: "
                        f"{', '.join(sorted(known[tag]))})")
                walk(ch, stack + [tag])
            elif tag == "transform":
                for tch in ch:
                    if tch.tag not in _TRANSFORM_CHILDREN:
                        errors.append(
                            f"{here}/{tch.tag}: invalid transform child "
                            f"(allowed: {', '.join(sorted(_TRANSFORM_CHILDREN))})")
            elif tag == "animation":
                for tch in ch:
                    if tch.tag != "transform":
                        errors.append(f"{here}/{tch.tag}: <animation> may "
                                      "only contain <transform> keyframes")
                walk(ch, stack + [tag])
            elif tag == "ref":
                if ch.get("id") is None:
                    errors.append(f"{here}: <ref> missing required "
                                  "attribute 'id'")
            elif tag == "default":
                if ch.get("name") is None or ch.get("value") is None:
                    errors.append(f"{here}: <default> needs name + value")
            elif tag in _OTHER_TAGS:
                pass
            else:
                # unknown elements warn instead of failing: the loader
                # ignores vendor and extension tags, so only malformed
                # known elements are errors (validate=False on
                # load_scene skips even the warning)
                unknowns.append(f"{here}: unknown element <{tag}> "
                                "(ignored)")

    walk(root, ["scene"])
    if unknowns:
        from ..utils import log as _log
        for u in unknowns:
            _log.get("scene").warning(u)
    if errors:
        raise SceneXMLError(errors)
