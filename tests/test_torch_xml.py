"""The scene-XML entry point's modules against hairpt's, on the CPU: the
validator, the loader (carried across with hairpt_torch.convert; hair
and mesh scenes), the
.mitshair reader, the image writers, the HALTON and STRATIFIED samplers,
the reconstruction filters, the constant environment and the diffuse
BSDF.

The scene XMLs are hairpt_torch.scene.scene_xmls' stand-ins for the
reference's scenes (and variants of them), written under tmp_path with
the reference's directory names, so both loaders build the same
procedural stand-in fibers. Both packages' scene builds order the hair
segments with the SAH builder of csrc/bvh_builder.cpp; hairpt compiles
it with -march=native, whose contracted multiply-adds move split
decisions, the port without contraction. The loader tests load the
port's build of that source into both packages (`same_bvh`), so the
trees, and with them every array, are the same."""
import os
import xml.etree.ElementTree as ET

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core import rng as jrng
from hairpt.film import film as jfilm
from hairpt.film import rfilter as jrf
from hairpt.models import emitters as jem
from hairpt.models.bsdf import registry as jmat
from hairpt.models.bsdf import simple as jsimple  # noqa: F401 (registers)
from hairpt.ops import bvh as jbvh
from hairpt.scene import hairgen as jh
from hairpt.scene import xml_loader as jxl
from hairpt.scene import xml_validate as jxv
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from hairpt.utils import exr as jexr
from hairpt.utils import io as jio
from hairpt_torch import convert
from hairpt_torch.core import rng as trng
from hairpt_torch.film import film as tfilm
from hairpt_torch.film import rfilter as trf
from hairpt_torch.models import emitters as tem
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import hairgen as th
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.scene import xml_validate as txv
from hairpt_torch.scene.scene import SceneBuilder as TSceneBuilder
from hairpt_torch.utils import exr as texr
from hairpt_torch.utils import io as tio
from test_torch_mesh import _write_files
from torch_threads import one_thread  # noqa: F401

LOAD = dict(spp_override=2, res_scale=0.02, hair_quality=0.02,
            max_depth_override=3)
CONST = ("<emitter type=\"constant\"><rgb name=\"radiance\" "
         "value=\"0.7, 0.8, 1.1\"/></emitter>")
# Marschner hair tables: the port's precompute sums in another order
# (tests/test_torch_hair_render.py): within 2e-6 of the largest value
HAIR_TABLE_REL = 2e-6


@pytest.fixture
def same_bvh(monkeypatch):
    lib = tbvh._load_native()
    assert lib is not None
    monkeypatch.setattr(jbvh, "_NATIVE", lib)
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)


def _exr_env(d):
    """An EXR envmap beside the scene: a sky gradient with a hot spot."""
    img = np.zeros((16, 32, 3), np.float32)
    img[:] = np.linspace(0.2, 1.5, 16)[:, None, None]
    img[3, 7] = (40.0, 30.0, 20.0)
    jexr.write_exr(os.path.join(d, "sky.exr"), img, half=False)
    return ("<emitter type=\"envmap\"><string name=\"filename\" "
            "value=\"sky.exr\"/><float name=\"scale\" value=\"2\"/>"
            "<transform name=\"toWorld\"><rotate y=\"1\" angle=\"30\"/>"
            "</transform></emitter>")


# case -> (scene name, XML builder kwargs, defines)
CASES = {
    "furball": ("furball", {}, {}),
    "straight_kkay": ("straight_kkay", {}, {}),
    "straight_marschner": ("straight_marschner", {}, {}),
    "straight_marschner_faithful": ("straight_marschner", {},
                                    {"marschner_faithful": "true"}),
    "dielectric_curly": ("curly", {}, {}),
    "hair_curl": ("hair_curl", {}, {}),
    "constant": ("furball", {"emitter": CONST}, {}),
    "exr_envmap": ("furball", {"emitter": "exr"}, {}),
}
# the furball with its hair shape's BSDF removed (the default DIFFUSE row
# beside the unused rough plastic), a scale and translation on the hair
# (its radius scales too), a <spectrum> reflectance and a <blackbody>
# constant environment
CASES["diffuse_spectra_transform"] = ("furball", {"emitter": "blackbody"},
                                      {})
EDITS = {"diffuse_spectra_transform": [
    ("<ref id=\"fur\"/>", "<transform name=\"toWorld\"><scale "
     "value=\"1.5\"/><translate y=\"0.5\"/></transform>"),
    ("<rgb name=\"diffuseReflectance\"",
     "<spectrum name=\"diffuseReflectance\" value=\"400:0.1, 500:0.3, "
     "600:0.5, 700:0.2\"/><rgb name=\"unused\""),
]}
for _s in ("independent", "ldsampler", "halton", "hammersley",
           "stratified", "sobol"):
    CASES[f"sampler_{_s}"] = ("furball", {"sampler": _s, "spp": 4,
                                          "emitter": CONST}, {})
# the teapot stand-in (a missing OBJ, twosided plastic, a twosided diffuse
# rectangle with a checkerboard, a missing envmap EXR), its floor with
# the other procedural textures, every mesh shape (the readers' files
# beside the XML: tests/test_torch_mesh.py's) with a scaled texture, and
# the furball over a textured rectangle
CASES["teapot"] = ("teapot", {}, {})
for _t in ("gridtexture", "wireframe", "vertexcolors"):
    CASES[f"teapot_{_t}"] = ("teapot", {"floor_texture": _t}, {})
CASES["mesh_shapes"] = ("teapot", {}, {})
CASES["furball_over_rectangle"] = ("furball", {"emitter": CONST}, {})
# the lit stand-in: a rectangle and a sphere area light, a spot and a point
# light beside the sunsky
CASES["lit"] = ("lit", {}, {})
MESH_SHAPES = (
    "<shape type=\"sphere\"><float name=\"radius\" value=\"0.7\"/>"
    "<point name=\"center\" x=\"1\" y=\"2\" z=\"3\"/><bsdf "
    "type=\"diffuse\"><texture type=\"vertexcolors\" "
    "name=\"reflectance\"/></bsdf></shape>"
    "<shape type=\"disk\"><transform name=\"toWorld\"><translate "
    "x=\"2\"/></transform><bsdf type=\"plastic\"><texture "
    "type=\"scale\" name=\"diffuseReflectance\"><float name=\"scale\" "
    "value=\"0.5\"/><texture type=\"checkerboard\"/></texture></bsdf>"
    "</shape>"
    "<shape type=\"cube\"><transform name=\"toWorld\"><scale "
    "value=\"0.5\"/><rotate y=\"1\" angle=\"30\"/></transform><bsdf "
    "type=\"diffuse\"><texture type=\"wireframe\" name=\"reflectance\">"
    "<float name=\"lineWidth\" value=\"0.1\"/></texture></bsdf></shape>"
    "<shape type=\"cylinder\"><float name=\"radius\" value=\"0.3\"/>"
    "<ref id=\"floor\"/></shape>"
    "<shape type=\"obj\"><string name=\"filename\" value=\"m.obj\"/>"
    "<boolean name=\"faceNormals\" value=\"true\"/></shape>"
    "<shape type=\"obj\"><string name=\"filename\" value=\"p.obj\"/>"
    "</shape>"
    "<shape type=\"ply\"><string name=\"filename\" value=\"a.ply\"/>"
    "</shape>"
    "<shape type=\"serialized\"><string name=\"filename\" "
    "value=\"m.serialized\"/><ref id=\"teapot\"/></shape>")
EDITS["mesh_shapes"] = [("<emitter type=\"envmap\"",
                         MESH_SHAPES + "<emitter type=\"envmap\"")]
EDITS["furball_over_rectangle"] = [(
    "<emitter type=\"constant\"",
    "<shape type=\"rectangle\"><transform name=\"toWorld\"><scale "
    "value=\"8\"/><rotate x=\"1\" angle=\"-90\"/><translate "
    "y=\"7\"/></transform><bsdf type=\"twosided\"><bsdf "
    "type=\"diffuse\"><texture type=\"checkerboard\" "
    "name=\"reflectance\"/></bsdf></bsdf></shape>"
    "<emitter type=\"constant\"")]


def _write(tmp_path, case):
    name, kw, defines = CASES[case]
    kw = dict(kw)
    if kw.get("emitter") == "exr":
        d = tmp_path / scene_xmls.SCENES[name][0]
        d.mkdir(parents=True, exist_ok=True)
        kw["emitter"] = _exr_env(str(d))
    if kw.get("emitter") == "blackbody":
        kw["emitter"] = ("<emitter type=\"constant\"><blackbody "
                         "name=\"radiance\" temperature=\"5000\" "
                         "scale=\"2e-8\"/></emitter>")
    if case == "mesh_shapes":
        d = tmp_path / scene_xmls.SCENES[name][0]
        d.mkdir(parents=True, exist_ok=True)
        _write_files(d)
    path = scene_xmls.write_scene(str(tmp_path), name, **kw)
    text = open(path).read()
    for old, new in EDITS.get(case, ()):
        assert old in text
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return path, defines


def _arrays_equal(a, b, path=""):
    if hasattr(a, "_fields"):
        for f in a._fields:
            _arrays_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
        return
    if a is None or b is None:
        assert a is None and b is None, path
        return
    x, y = a.numpy(), b.numpy()
    assert x.dtype == y.dtype and x.shape == y.shape, path
    if ".hair_tables." in path:
        np.testing.assert_allclose(x, y, rtol=0, atol=HAIR_TABLE_REL
                                   * np.abs(y).max(), err_msg=path)
    elif x.dtype == np.float32:
        # bit for bit (seg_rows_t's id row holds NaN patterns)
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32),
                                      err_msg=path)
    else:
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_matches_jax(tmp_path, same_bvh, case):
    """hairpt_torch's load_scene against hairpt's, carried across with
    convert_scene (its traversal set to the port's tiled, q = 2048): the
    config, camera, film, active kinds and Marschner rows equal; every
    array bit for bit, but the Marschner hair tables (HAIR_TABLE_REL)."""
    path, defines = _write(tmp_path, case)
    js = jxl.load_scene(path, dict(defines), **LOAD)
    ts = txl.load_scene(path, dict(defines), **LOAD, device="cpu")
    jt = js._replace(config=dataclasses.replace(
        js.config, traversal="tiled", tiled_q=2048))
    cs = convert.convert_scene(jt, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    assert ts.config == cs.config
    assert ts.active_kinds == cs.active_kinds
    assert ts.marschner_rows == cs.marschner_rows
    assert ts.film == cs.film
    for x, y in zip(ts.camera, cs.camera):
        np.testing.assert_array_equal(x, y)
    _arrays_equal(ts.arrays, cs.arrays)
    if case == "straight_marschner_faithful":
        assert tmat.MARSCHNER in ts.active_kinds
    if case == "diffuse_spectra_transform":
        assert ts.arrays.materials.kind.tolist() == [tmat.ROUGHPLASTIC,
                                                     tmat.DIFFUSE]
        assert set(ts.arrays.hair_mat_id.tolist()) == {1}
    if case.startswith("sampler_"):
        assert ts.config.sampler == js.config.sampler
    if case.startswith("teapot") or case == "mesh_shapes":
        assert ts.arrays.hair is None and ts.arrays.tri is not None
        assert tmat.PLASTIC in ts.active_kinds
        assert ts.arrays.checkers is not None
    if case == "lit":
        assert ts.arrays.area is not None and ts.arrays.delta is not None
        assert ts.config.nee_probs == (1 / 3,) * 3
    if case == "furball_over_rectangle":
        assert ts.arrays.tri.p0.shape == (2, 3)
        assert ts.arrays.hair is not None


def test_loader_reads_every_hair_kind(tmp_path, same_bvh):
    """The stand-ins' materials as the XMLs declare them: rough plastic,
    Kajiya-Kay, corrected Marschner (and through its alias), the
    dielectric, and twosided."""
    kinds = {}
    for name in ("furball", "straight_kkay", "straight_marschner",
                 "hair_curl", "curly"):
        s = txl.load_scene(scene_xmls.write_scene(str(tmp_path), name),
                           **LOAD, device="cpu")
        kinds[name] = s.arrays.materials.kind.tolist()
        if name == "hair_curl":
            assert s.arrays.materials.twosided.tolist() == [False, False,
                                                            False, True]
    assert kinds == {"furball": [tmat.ROUGHPLASTIC],
                     "straight_kkay": [tmat.KAJIYAKAY],
                     "straight_marschner": [tmat.MARSCHNER_PURE],
                     "hair_curl": [tmat.MARSCHNER_PURE, tmat.KAJIYAKAY,
                                   tmat.MARSCHNER_PURE, tmat.KAJIYAKAY],
                     "curly": [tmat.MARSCHNERDIELECTRIC]}


# --- validator -------------------------------------------------------------

MALFORMED = """
<scene version="0.5.0">
  <integrator type="warpfield"/>
  <sensor type="perspective">
    <float name="fov"/>
    <rgb name="tint" value="0.1, 0.2"/>
  </sensor>
  <film type="hdrfilm"/>
  <bsdf type="nosuchbsdf" id="m"/>
  <shape type="sphere"><ref/></shape>
  <frobnicate/>
</scene>"""
NO_VERSION = "<scene><shape type='sphere'/></scene>"
WILDCARD = """
<scene version="0.5.0">
  <integrator type="$kind"><integer name="maxDepth" value="$d"/>
  </integrator>
</scene>"""


def _errors(mod, root):
    try:
        mod.validate(root)
    except mod.SceneXMLError as e:
        return e.errors
    return None


@pytest.mark.parametrize("text", [MALFORMED, NO_VERSION, WILDCARD],
                         ids=["malformed", "no_version", "wildcard"])
def test_validator_matches_jax(text):
    root = ET.fromstring(text)
    assert _errors(txv, root) == _errors(jxv, root)


def test_validator_accepts_every_stand_in_scene(tmp_path):
    for name in scene_xmls.SCENES:
        root = ET.parse(scene_xmls.write_scene(str(tmp_path), name)).getroot()
        assert _errors(txv, root) is None and _errors(jxv, root) is None


def test_validator_accepts_what_the_port_refuses():
    """A scene of the JAX package's names that the port does not render
    validates in both packages; the loader refuses it."""
    root = ET.fromstring("""<scene version="0.5.0">
      <integrator type="bdpt"/><bsdf type="roughconductor" id="c"/>
      <shape type="obj"><ref id="c"/></shape>
      <emitter type="point"/></scene>""")
    assert _errors(txv, root) is None and _errors(jxv, root) is None


# --- .mitshair -------------------------------------------------------------

def _write_binary(path, data):
    with open(path, "wb") as f:
        f.write(b"BINARY_HAIR")
        f.write(np.uint32(len(data)).tobytes())
        f.write(np.asarray(data, "<f4").tobytes())


def _hair_file(tmp_path, kind):
    fs = jh.gen_curly_hair(n_fibers=40, n_segs=30)
    p = str(tmp_path / f"{kind}.mitshair")
    if kind == "saved":
        jh.save_hair_binary(p, fs)
    elif kind == "runs":
        # a leading separator, runs of two and three separators, a NaN one
        v = np.asarray(fs.vertices, np.float32)
        rows, nsep = [], [1, 2, 3, 1]
        for i, start in enumerate(fs.vertex_starts_fiber):
            if start:
                k = nsep[(i // 31) % 4]
                rows += [[np.inf, np.inf, np.inf]] * k
                if (i // 31) % 5 == 4:
                    rows.append([np.nan, 0.0, 0.0])
            rows.append(v[i])
        _write_binary(p, np.asarray(rows, np.float32))
    else:
        lines = ["", ""]
        for i, start in enumerate(fs.vertex_starts_fiber):
            if start and i:
                lines += [""] * (1 + (i // 31) % 2) + ["# fiber"][:i % 2]
            lines.append(" ".join(f"{x:.9g}" for x in fs.vertices[i]))
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
    return p


@pytest.mark.parametrize("kind", ["saved", "runs", "ascii"])
@pytest.mark.parametrize("angle,reduction", [(0.0, 0.0), (1.0, 0.3)])
def test_hair_file_matches_jax(tmp_path, kind, angle, reduction):
    """load_hair_file (the port's vectorised separator scan) against the
    JAX loop: vertices, fiber starts and radius equal, with the 1-degree
    merge and the seeded reduction."""
    p = _hair_file(tmp_path, kind)
    a = jh.load_hair_file(p, 0.01, angle_threshold_deg=angle,
                          reduction=reduction)
    b = th.load_hair_file(p, 0.01, angle_threshold_deg=angle,
                          reduction=reduction)
    np.testing.assert_array_equal(b.vertices, a.vertices)
    np.testing.assert_array_equal(b.vertex_starts_fiber,
                                  a.vertex_starts_fiber)
    assert b.radius == a.radius and b.vertex_starts_fiber.sum() > 10


def test_save_hair_binary_matches_jax(tmp_path):
    fs = jh.gen_hair_curl(n_fibers_per_clump=9)[1]
    jh.save_hair_binary(str(tmp_path / "a"), fs)
    th.save_hair_binary(str(tmp_path / "b"), fs)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


# --- image IO --------------------------------------------------------------

def _image(h=13, w=17):
    rs = np.random.default_rng(5)
    img = (rs.random((h, w, 3)) * 2.0).astype(np.float32)
    img[0, 0] = (0.0, 1e-5, 700.0)
    return img


@pytest.mark.parametrize("fmt", ["pfm", "npy", "exr_half", "exr_float"])
def test_hdr_writers_match_jax(tmp_path, fmt):
    """Byte-equal files and equal values read back, in both packages'
    readers."""
    img = _image()
    a, b = str(tmp_path / f"a.{fmt[:3]}"), str(tmp_path / f"b.{fmt[:3]}")
    if fmt == "pfm":
        jio.write_pfm(a, img)
        tio.write_pfm(b, img)
        back = (tio.read_pfm(b), jio.read_pfm(b))
    elif fmt == "npy":
        jio.write_npy(a, img)
        tio.write_npy(b, img)
        back = (np.load(b), np.load(a))
    else:
        half = fmt == "exr_half"
        jexr.write_exr(a, img, half=half)
        texr.write_exr(b, img, half=half)
        back = (texr.read_exr(b), jexr.read_exr(b))
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(back[0], back[1])
    ref = img.astype(np.float16).astype(np.float32) if fmt == "exr_half" \
        else img
    np.testing.assert_array_equal(back[0], ref)


@pytest.mark.parametrize("fmt", ["png", "bmp", "tga"])
def test_ldr_writers_decode_like_jax(tmp_path, fmt):
    """The port's own PNG, BMP and TGA writers decode (through PIL) to
    the pixels of hairpt's PIL-written files."""
    Image = pytest.importorskip("PIL.Image")
    ldr = jio.tonemap_srgb(_image(), 2.2)
    np.testing.assert_array_equal(tio.tonemap_srgb(_image(), 2.2), ldr)
    a, b = str(tmp_path / f"a.{fmt}"), str(tmp_path / f"b.{fmt}")
    getattr(jio, f"write_{fmt}")(a, ldr)
    getattr(tio, f"write_{fmt}")(b, ldr)
    pa = np.asarray(Image.open(a).convert("RGB"))
    pb = np.asarray(Image.open(b).convert("RGB"))
    assert pb.shape == (13, 17, 3)
    np.testing.assert_array_equal(pb, pa)


# --- samplers, filters, constant environment, diffuse ----------------------

@pytest.mark.parametrize("mode", [jrng.HALTON, (jrng.STRATIFIED, 16),
                                  (jrng.STRATIFIED, 8), (jrng.STRATIFIED, 6)],
                         ids=["halton", "stratified16", "stratified8",
                              "stratified6"])
def test_sampler_modes_match_jax(mode):
    """Equal samples for the same (pixel, sample, dim), dims past the
    Faure table included; non-power-of-two stratified spp fall back to
    independent samples in both."""
    rs = np.random.default_rng(6)
    pix = rs.integers(0, 2 ** 20, 3000).astype(np.uint32)
    smp = rs.integers(0, 70000, 3000).astype(np.uint32)
    s = trng.Sampler(mode, torch.as_tensor(pix.astype(np.int64)),
                     torch.as_tensor(smp.astype(np.int64)))
    for dim in (0, 4, 19, 62, 63, 70):
        a = jrng.next_2d(mode, jnp.asarray(pix), jnp.asarray(smp), dim)
        np.testing.assert_array_equal(s.next_2d(dim).numpy(), np.asarray(a))
        a = jrng.next_1d(mode, jnp.asarray(pix), jnp.asarray(smp), dim)
        np.testing.assert_array_equal(s.next_1d(dim).numpy(), np.asarray(a))


@pytest.mark.parametrize("name", sorted(jrf.FILTERS))
def test_filter_and_splat_match_jax(name):
    """filter_eval within 1e-6 and the developed splat within 1e-6
    relative (sums of up to 49 taps per pixel, added in another order)."""
    rs = np.random.default_rng(7)
    d = ((rs.random((2, 4000)) - 0.5) * 8).astype(np.float32)
    kind, r = jrf.FILTERS[name]
    assert trf.FILTERS[name] == (kind, r)
    np.testing.assert_allclose(
        trf.filter_eval(kind, r, torch.as_tensor(d[0]),
                        torch.as_tensor(d[1])).numpy(),
        np.asarray(jrf.filter_eval(kind, r, jnp.asarray(d[0]),
                                   jnp.asarray(d[1]))), rtol=0, atol=1e-6)
    pos = (rs.random((3000, 2)) * (24, 16)).astype(np.float32)
    val = rs.random((3000, 3)).astype(np.float32)
    fj, ft = jfilm.Film.make(24, 16, name), tfilm.Film.make(24, 16, name)
    ij, wj = jfilm.splat_samples(fj, jnp.asarray(pos), jnp.asarray(val),
                                 *jfilm.zeros(fj))
    it, wt = tfilm.splat_samples(ft, torch.as_tensor(pos),
                                 torch.as_tensor(val),
                                 *tfilm.zeros(ft, "cpu"))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tfilm.develop(it, wt).numpy(),
                               np.asarray(jfilm.develop(ij, wj)), rtol=1e-6,
                               atol=1e-6)


def test_make_constant_matches_jax():
    ej = jem.make_constant((0.7, 0.8, 1.1))
    et = tem.make_constant((0.7, 0.8, 1.1), device="cpu")
    for f in tem.EnvMap._fields:
        np.testing.assert_array_equal(getattr(et, f).numpy(),
                                      np.asarray(getattr(ej, f)), err_msg=f)


def _dirs(seed, n=4096):
    rs = np.random.default_rng(seed)
    w = rs.normal(size=(n, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w[:, 2] = np.where(rs.random(n) < 0.9, np.abs(w[:, 2]), -np.abs(w[:, 2]))
    return w


def test_diffuse_matches_jax():
    """The diffuse BSDF's eval, pdf and sample against hairpt's, with
    tests/test_torch_bsdf.py's tolerances."""
    rows = [dict(kind=jmat.DIFFUSE, diffuse=(0.2, 0.5, 0.8)),
            dict(kind=jmat.DIFFUSE)]
    bj, bt = JSceneBuilder(), TSceneBuilder(device="cpu")
    for r in rows:
        bj.add_material(**dict(r))
        bt.add_material(**dict(r))
    tj = jmat.pack_materials(bj.materials)
    tt = tmat.pack_materials(bt.materials, device="cpu")
    for f in tmat.MaterialTable._fields:
        if f == "cloth":  # no irawan row: no weave table
            assert getattr(tt, f) is None and getattr(tj, f) is None
            continue
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(tj, f)), err_msg=f)
    n = 4096
    mid = np.random.default_rng(8).integers(0, 2, n).astype(np.int32)
    gj = jmat.gather(tj, None, jnp.asarray(mid), jnp.zeros((n, 2)))
    gt = tmat.gather(tt, None, torch.as_tensor(mid))
    wi, wo = _dirs(9), _dirs(10)
    k = (jmat.DIFFUSE,)
    fj, pj = jmat.eval_pdf(k, gj, jnp.asarray(wi), jnp.asarray(wo))
    ft, pt = tmat.eval_pdf(k, gt, torch.as_tensor(wi), torch.as_tensor(wo))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4,
                               atol=1e-6)
    rs = np.random.default_rng(11)
    u = [rs.random(n).astype(np.float32),
         rs.random((n, 2)).astype(np.float32),
         rs.random((n, 2)).astype(np.float32)]
    ref = jmat.sample(k, gj, jnp.asarray(wi), *map(jnp.asarray, u))
    got = tmat.sample(k, gt, torch.as_tensor(wi), *map(torch.as_tensor, u))
    wo_j, w_j, p_j, d_j, e_j = (np.asarray(x) for x in ref)
    wo_t, w_t, p_t, d_t, e_t = (x.numpy() for x in got)
    np.testing.assert_allclose(wo_t, wo_j, atol=2e-5)
    ok = p_j > 0
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(p_t > 0, ok)
    np.testing.assert_allclose(p_t[ok], p_j[ok], rtol=5e-4)
    np.testing.assert_allclose(w_t, w_j, rtol=5e-4, atol=1e-6)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(e_t, e_j)
