"""Bitmap textures, normal and bump maps and the loader's new elements in
the port against hairpt, on the CPU: the mip pyramid (exact), the
bitmap's bilinear, trilinear (lod) and EWA (duv) lookups,
perturb_shading_frame's normal and bump maps, the camera hit's uv
Jacobian, the PNG reader against PIL, the loaders on a scene of
shapegroup, instances, a heightfield image, normal and bump maps and a
deformable pair under the curvature texture (tensor for tensor), a
top-level <texture> (ignored by both) and the loader's refusals. The
render of the instanced stand-in is tests/test_torch_instanced_render.py.

hairpt's loader raises on any bitmap texture of a BSDF (an `import os`
inside its _material_row_from_bsdf makes `os` a local there; ROADMAP
Queue C), so the scene its loader reads here has normal and bump maps
but no bitmap reflectance."""
import dataclasses
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hairpt.integrators import common as jcommon
from hairpt.integrators import path as jpath
from hairpt.models import sensors as jsensors
from hairpt.models.bsdf import registry as jmat
from hairpt.ops import bvh as jbvh
from hairpt.scene import scene as jscene
from hairpt.scene import xml_loader as jxl
from hairpt_torch import convert
from hairpt_torch.integrators import common as tcommon
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models import sensors as tsensors
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import scene as tscene
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.utils import io as tio
from torch_threads import one_thread  # noqa: F401

N = 4096
R = 32
ATOL = 1e-5


@pytest.fixture
def same_bvh(monkeypatch):
    lib = tbvh._load_native()
    assert lib is not None
    monkeypatch.setattr(jbvh, "_NATIVE", lib)
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)


def _tables(seed=0):
    """A texture table of a checkerboard, two R x R bitmaps (one scaled
    and offset), a grid and a vertex-colour texture, in both packages."""
    rs = np.random.default_rng(seed)
    rows = [
        (tmat.TEX_CHECKER, (0.7, 0.6, 0.5), (0.1, 0.2, 0.3), (3.0, 2.0),
         (0.1, 0.2), 0.01),
        (tmat.TEX_BITMAP, (0, 0, 0), (0, 0, 0), (1.0, 1.0), (0.0, 0.0),
         0.01, rs.random((R, R, 3)).astype(np.float32)),
        (tmat.TEX_BITMAP, (0, 0, 0), (0, 0, 0), (2.5, 0.75), (0.3, -0.4),
         0.01, rs.random((R, R, 3)).astype(np.float32)),
        (tmat.TEX_GRID, (0.2, 0.3, 0.4), (0.9, 0.8, 0.7), (2.0, 2.0),
         (0.0, 0.0), 0.05),
        (tmat.TEX_VERTEXCOLORS, (1, 1, 1), (1, 1, 1), (1.0, 1.0),
         (0.0, 0.0), 0.01),
    ]
    t = tmat.pack_checkers(rows, device="cpu")
    j = jmat.CheckerboardTable(**{f: jnp.asarray(getattr(t, f).numpy())
                                  for f in jmat.CheckerboardTable._fields})
    return t, j


def _lanes(seed=1):
    rs = np.random.default_rng(seed)
    f = np.float32
    uv = rs.uniform(-3, 3, (N, 2)).astype(f)
    tid = rs.integers(-1, 5, N).astype(np.int32)
    base = rs.random((N, 3)).astype(f)
    bary = rs.dirichlet((1, 1, 1), N)[:, 1:].astype(f)
    vcol = rs.random((N, 3)).astype(f)
    lod = rs.uniform(-1.0, 5.0, N).astype(f)
    # footprint Jacobians: zero on a quarter of the lanes, up to a few
    # texels and anisotropic on the rest
    dx = (rs.normal(size=(N, 2)) * rs.uniform(0, 0.2, (N, 1))).astype(f)
    dy = (rs.normal(size=(N, 2)) * rs.uniform(0, 0.05, (N, 1))).astype(f)
    zero = rs.random(N) < 0.25
    dx[zero] = 0
    dy[zero] = 0
    return uv, tid, base, bary, vcol, lod, dx, dy


def test_build_mips_matches_jax():
    """The pre-blurred pyramid, bit for bit."""
    bm = np.random.default_rng(2).random((3, 64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(tscene._build_mips(bm),
                                  jscene._build_mips(bm))
    t, j = _tables()
    assert t.mips.shape == (5, 4, R, R, 3)
    np.testing.assert_array_equal(
        t.mips.numpy(), jscene._build_mips(t.bitmaps.numpy()))


@pytest.mark.parametrize("mode", ["bilinear", "lod", "ewa"])
def test_bitmap_lookups_match_jax(mode):
    """eval_checkerboard with bitmap lanes among the procedural kinds:
    bilinear (no footprint), trilinear at random levels of detail, and
    EWA where the lane has a uv Jacobian (a quarter without one keep the
    trilinear value): within 1e-5 of hairpt's."""
    t, j = _tables()
    uv, tid, base, bary, vcol, lod, dx, dy = _lanes()
    lod_ = None if mode == "bilinear" else lod
    duv = (dx, dy) if mode == "ewa" else None
    ref = np.asarray(jmat.eval_checkerboard(
        j, jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(base),
        None if lod_ is None else jnp.asarray(lod_), jnp.asarray(bary),
        jnp.asarray(vcol),
        None if duv is None else tuple(jnp.asarray(x) for x in duv)))
    got = tmat.eval_checkerboard(
        t, torch.as_tensor(tid), torch.as_tensor(uv), torch.as_tensor(base),
        torch.as_tensor(bary), torch.as_tensor(vcol),
        lod=None if lod_ is None else torch.as_tensor(lod_),
        duv=None if duv is None else tuple(torch.as_tensor(x)
                                           for x in duv)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    bm = np.isin(tid, (1, 2))
    assert bm.sum() > N // 4
    if mode != "bilinear":
        plain = tmat.eval_checkerboard(
            t, torch.as_tensor(tid), torch.as_tensor(uv),
            torch.as_tensor(base)).numpy()
        assert np.abs(got - plain)[bm].max() > 1e-3


def test_ewa_eval_bitmap_matches_jax():
    """ewa_eval_bitmap on its own (7 probes, max_aniso 4), isotropic and
    strongly anisotropic footprints: within 1e-5."""
    t, j = _tables()
    uv, tid, _, _, _, _, dx, dy = _lanes(seed=3)
    tid = np.where(tid % 2 == 0, 1, 2).astype(np.int32)
    dx[:N // 2] *= 20.0
    su, sv = uv[:, 0], uv[:, 1]
    ref = np.asarray(jmat.ewa_eval_bitmap(j, jnp.asarray(tid),
                                          jnp.asarray(su), jnp.asarray(sv),
                                          jnp.asarray(dx), jnp.asarray(dy)))
    got = tmat.ewa_eval_bitmap(t, torch.as_tensor(tid).long(),
                               torch.as_tensor(su), torch.as_tensor(sv),
                               torch.as_tensor(dx), torch.as_tensor(dy))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("kind", [0, 1], ids=["normalmap", "bumpmap"])
def test_perturb_shading_frame_matches_jax(kind):
    """A normal map (rgb * 2 - 1 in the tangent frame) and a bump map
    (differences of the height's luminance at 1 / R, scale 0.05) on
    random frames, lanes without a map keeping theirs: within 1e-5."""
    t, j = _tables()
    rs = np.random.default_rng(4 + kind)
    rows = [dict(nrm_tex_id=-1), dict(nrm_tex_id=1, nrm_kind=kind,
                                      nrm_scale=0.05),
            dict(nrm_tex_id=2, nrm_kind=kind, nrm_scale=0.05)]
    tm = tmat.pack_materials([tmat.default_material_row(**r) for r in rows],
                             device="cpu")
    jm = jmat.pack_materials([jmat.default_material_row(**r) for r in rows])
    n = rs.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    s = np.cross(n, rs.normal(size=(N, 3)))
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    tt = np.cross(n, s)
    f = np.float32
    mid = rs.integers(0, 3, N).astype(np.int32)
    uv = rs.uniform(-2, 2, (N, 2)).astype(f)
    ins = [x.astype(f) for x in (n, s, tt)]
    ref = jmat.perturb_shading_frame(jm, j, jnp.asarray(mid), jnp.asarray(uv),
                                     *(jnp.asarray(x) for x in ins))
    got = tmat.perturb_shading_frame(tm, t, torch.as_tensor(mid),
                                     torch.as_tensor(uv),
                                     *(torch.as_tensor(x) for x in ins))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    moved = np.abs(got[0].numpy() - ins[0]).max(-1) > 1e-3
    assert moved[mid > 0].mean() > 0.5 and not moved[mid == 0].any()


def test_camera_uv_partials_matches_jax(same_bvh, tmp_path):
    """The camera hit's uv Jacobian on the teapot stand-in's camera wave
    (the floor's uv, the teapot's zero uv): within 1e-4 relative and
    1e-6 absolute on lanes that hit the same triangle; zero where the
    uv is degenerate or the ray misses."""
    xml = scene_xmls.write_scene(str(tmp_path), "teapot", width=64,
                                 height=36)
    js = jxl.load_scene(xml, spp_override=1)
    ts = txl.load_scene(xml, spp_override=1, device="cpu")
    rs = np.random.default_rng(5)
    pos = (rs.random((N, 2)) * (64, 36)).astype(np.float32)
    jray = jsensors.sample_ray(js.camera, jnp.asarray(pos))
    tray = tsensors.sample_ray(ts.camera, torch.as_tensor(pos))
    jh = jcommon.scene_intersect(js.arrays, jray, "packed")
    th = tcommon.scene_intersect(ts.arrays, tray, 128, traversal="packed")
    same = np.asarray(jh.prim) == th.prim.numpy()
    assert same.mean() > 0.999
    jd = jpath._camera_uv_partials(js.arrays, js.camera, jnp.asarray(pos),
                                   jnp.zeros((N, 2)), jray, jh)
    td = tpath._camera_uv_partials(ts.arrays, ts.camera,
                                   torch.as_tensor(pos), tray, th)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   rtol=1e-4, atol=1e-6)
    nz = (np.abs(td[0].numpy()).sum(-1) > 0)
    assert 0.1 < nz.mean() < 0.9


# --- the PNG reader ----------------------------------------------------------

CHANNELS = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
CTYPE = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_filtered(path, img, mode):
    """An 8-bit PNG whose row y carries filter y % 5 (none, sub, up,
    average, Paeth), written by the test's own encoder."""
    h, w = img.shape[:2]
    c = CHANNELS[mode]
    raw = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        ft = y % 5
        row = raw[y]
        left = np.concatenate([np.zeros(c, np.int64), row[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if ft == 0:
            f = row
        elif ft == 1:
            f = row - left
        elif ft == 2:
            f = row - prior
        elif ft == 3:
            f = row - (left + prior) // 2
        else:
            f = row - np.array([_paeth(a, b, cc) for a, b, cc in
                                zip(left, prior, upleft)])
        out += bytes([ft]) + bytes((f % 256).astype(np.uint8))
        prior = row

    def chunk(k, d):
        return (struct.pack(">I", len(d)) + k + d
                + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, CTYPE[mode],
                                            0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(bytes(out))))
        fh.write(chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", sorted(CHANNELS))
def test_read_png_matches_pil(tmp_path, mode):
    """Each 8-bit colour type, with every scanline filter (rows cycling
    through the five), and as PIL writes it: read_png equals PIL's array,
    png_rgb PIL's convert("RGB")."""
    rs = np.random.default_rng(CTYPE[mode])
    img = rs.integers(0, 256, (23, 19, CHANNELS[mode]), dtype=np.uint8)
    img = img[..., 0] if mode == "L" else img
    for name, write in (("f.png", lambda p: _png_filtered(p, img, mode)),
                        ("pil.png", lambda p: Image.fromarray(img, mode)
                         .save(p))):
        p = str(tmp_path / name)
        write(p)
        ref = Image.open(p)
        got = tio.read_png(p)
        np.testing.assert_array_equal(got, np.asarray(ref))
        np.testing.assert_array_equal(tio.png_rgb(got),
                                      np.asarray(ref.convert("RGB")))


def test_read_png_reads_write_png_and_refuses_the_rest(tmp_path):
    """io.write_png's files read back exactly; 16-bit, palette and
    interlaced PNGs, which an earlier slice refused here, read as PIL
    reads them (read_png: PIL's array, the palette's colours for "P";
    png_rgb: PIL's convert("RGB")). tests/test_torch_ldr_readers.py holds
    every other PNG variant to hairpt's read_image."""
    img = np.random.default_rng(9).integers(0, 256, (17, 29, 3),
                                            dtype=np.uint8)
    p = str(tmp_path / "w.png")
    tio.write_png(p, img)
    np.testing.assert_array_equal(tio.read_png(p), img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(
        str(tmp_path / "16.png"))
    Image.fromarray(img).convert("P").save(str(tmp_path / "p.png"))
    # interlaced: write_png's pixels in Adam7's seven passes, the IHDR's
    # interlace byte set
    raw = bytearray(open(p, "rb").read())
    raw[28] = 1
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])) & 0xFFFFFFFF)
    passes = b"".join(
        b"".join(b"\0" + img[y, x0::dx].tobytes()
                 for y in range(y0, img.shape[0], dy))
        for x0, y0, dx, dy in tio._ADAM7 if img[y0::dy, x0::dx].size)
    idat = zlib.compress(passes)
    (tmp_path / "i.png").write_bytes(
        bytes(raw[:33]) + struct.pack(">I", len(idat)) + b"IDAT" + idat
        + struct.pack(">I", zlib.crc32(b"IDAT" + idat) & 0xFFFFFFFF)
        + b"\0\0\0\0IEND\xaeB`\x82")
    for f in ("16.png", "p.png", "i.png"):
        ref = Image.open(str(tmp_path / f))
        got = tio.read_png(str(tmp_path / f))
        want = np.asarray(ref.convert("RGB") if f == "p.png" else ref)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tio.png_rgb(got),
                                      np.asarray(ref.convert("RGB")))


# --- the loader --------------------------------------------------------------

def _loader_scene(d):
    """A scene of every element of this slice hairpt's loader reads: a
    shapegroup (an OBJ under its own material, a cube under the group's)
    in three instances, a normal-mapped (PFM) and a bump-mapped (PNG)
    diffuse, a heightfield from a PNG, a deformable pair at time 0.25
    under the curvature texture, a top-level texture and a PNG
    envmap."""
    scene_xmls.instanced_files(d)
    inst = "".join(
        f"<shape type=\"instance\"><ref id=\"g\"/><transform name=\"toWorld\">"
        f"<rotate y=\"1\" angle=\"{a}\"/><translate x=\"{x}\"/></transform>"
        f"</shape>" for a, x in ((0, -3), (40, 0), (200, 3)))
    return (
        "<?xml version=\"1.0\"?><scene version=\"0.5.0\">"
        "<integrator type=\"path\"><integer name=\"maxDepth\" value=\"3\"/>"
        "</integrator>"
        "<sensor type=\"perspective\"><float name=\"fov\" value=\"40\"/>"
        "<transform name=\"toWorld\"><lookat origin=\"0, 6, 14\" "
        "target=\"0, 0, 0\"/></transform><sampler type=\"independent\">"
        "<integer name=\"sampleCount\" value=\"1\"/></sampler>"
        "<film type=\"hdrfilm\"><integer name=\"width\" value=\"24\"/>"
        "<integer name=\"height\" value=\"16\"/></film></sensor>"
        "<texture type=\"checkerboard\" id=\"unused\"/>"
        "<bsdf type=\"plastic\" id=\"pl\"/>"
        "<bsdf type=\"normalmap\" id=\"nm\"><texture type=\"bitmap\">"
        "<string name=\"filename\" value=\"floor_normal.pfm\"/></texture>"
        "<bsdf type=\"diffuse\"/></bsdf>"
        "<bsdf type=\"bumpmap\" id=\"bm\"><float name=\"scale\" "
        "value=\"0.1\"/>"
        "<texture type=\"bitmap\"><string name=\"filename\" "
        "value=\"bump.png\"/><float name=\"uscale\" value=\"2\"/></texture>"
        "<bsdf type=\"twosided\"><bsdf type=\"diffuse\"/></bsdf></bsdf>"
        "<bsdf type=\"diffuse\" id=\"cv\"><texture type=\"curvature\">"
        "<float name=\"scale\" value=\"0.7\"/></texture></bsdf>"
        "<shape type=\"shapegroup\" id=\"g\"><shape type=\"obj\"><string "
        "name=\"filename\" value=\"teapot.obj\"/><ref id=\"pl\"/></shape>"
        "<shape type=\"cube\"><transform name=\"toWorld\"><translate "
        "y=\"3\"/></transform></shape></shape>" + inst
        + "<shape type=\"rectangle\"><transform name=\"toWorld\"><scale "
          "value=\"8\"/><rotate x=\"1\" angle=\"-90\"/></transform><ref "
          "id=\"nm\"/></shape>"
        "<shape type=\"heightfield\"><string name=\"filename\" "
        "value=\"bump.png\"/><float name=\"scale\" value=\"0.5\"/><ref "
        "id=\"bm\"/></shape>"
        "<shape type=\"deformable\"><string name=\"filename\" "
        "value=\"sphere0.obj\"/><string name=\"filename2\" "
        "value=\"sphere1.obj\"/><float name=\"time\" value=\"0.25\"/>"
        "<ref id=\"cv\"/></shape>"
        "<emitter type=\"envmap\"><string name=\"filename\" "
        "value=\"floor.png\"/></emitter></scene>")


def _tensors(a, path="arrays"):
    if torch.is_tensor(a):
        yield path, a
    elif hasattr(a, "_fields"):
        for f in a._fields:
            yield from _tensors(getattr(a, f), f"{path}.{f}")


def test_loaders_agree_on_the_new_elements(same_bvh, tmp_path):
    """shapegroup and instance, normalmap and bumpmap, heightfield from
    an image, deformable at `time`, the curvature texture, a top-level
    <texture> (ignored) and a PNG envmap, through both loaders: every
    tensor equal (hairpt's scene through hairpt_torch.convert), the
    config, the material kinds and has_normal_maps."""
    d = tmp_path / "scene"
    d.mkdir()
    (d / "scene.xml").write_text(_loader_scene(str(d)))
    js = jxl.load_scene(str(d / "scene.xml"))
    ts = txl.load_scene(str(d / "scene.xml"), device="cpu")
    cs = convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    # the port's SceneBuilder defaults the hair traversal to 'tiled' (this
    # scene has no hair)
    assert ts.config == dataclasses.replace(cs.config, traversal="tiled",
                                            tiled_q=ts.config.tiled_q)
    assert ts.active_kinds == cs.active_kinds
    assert ts.has_normal_maps and cs.has_normal_maps
    got, ref = dict(_tensors(ts.arrays)), dict(_tensors(cs.arrays))
    assert got.keys() == ref.keys()
    for k, v in got.items():
        r = ref[k]
        assert v.dtype == r.dtype and v.shape == r.shape, k
        if v.is_floating_point():
            v, r = v.view(torch.int32), r.view(torch.int32)
        assert torch.equal(v, r), k
    assert len(ts.arrays.inst.proto_ids) == 6      # 3 instances x 2
    assert (ts.arrays.tri_shading.vc0 != 1).any()  # curvature colours


def test_top_level_texture_is_ignored(same_bvh, tmp_path):
    """A <texture> at the scene's top level gives the same scene as none
    in the port, as in hairpt."""
    xml = scene_xmls.write_scene(str(tmp_path), "teapot", width=32,
                                 height=18)
    body = open(xml).read()
    xml2 = str(tmp_path / "teapot" / "top.xml")
    with open(xml2, "w") as f:
        f.write(body.replace("<bsdf ", "<texture type=\"checkerboard\" "
                             "id=\"top\"/><bsdf ", 1))
    a = txl.load_scene(xml, device="cpu")
    b = txl.load_scene(xml2, device="cpu")
    j = jxl.load_scene(xml2)
    assert len(j.arrays.materials.kind) == len(b.arrays.materials.kind)
    for (k, v), (_, w) in zip(_tensors(a.arrays), _tensors(b.arrays)):
        if v.is_floating_point():
            v, w = v.view(torch.int32), w.view(torch.int32)
        assert torch.equal(v, w), k


def _same_tensors(a, b):
    got, ref = dict(_tensors(a)), dict(_tensors(b))
    assert got.keys() == ref.keys()
    for k, v in got.items():
        r = ref[k]
        assert v.dtype == r.dtype and v.shape == r.shape, k
        if v.is_floating_point():
            v, r = v.view(torch.int32), r.view(torch.int32)
        assert torch.equal(v, r), k


@pytest.mark.parametrize("case", ["animated_instance", "open_shutter",
                                  "jpeg_bitmap", "jpeg_heightfield",
                                  "qoi_bitmap", "zstd_tiff_heightfield",
                                  "jp2_envmap"])
def test_loader_refuses_the_rest(same_bvh, tmp_path, case):
    """What an earlier slice refused here now loads. A JPEG heightfield
    (ROADMAP item 13's): both loaders give the same arrays. A JPEG bitmap
    texture: hairpt's bitmap branch cannot run (ROADMAP Queue C), so the
    port's texture table is held to its own load of the same pixels
    written as a PNG. An animated instance and a deformable under an open
    shutter (motion blur): both loaders give the same arrays, the same
    shutter, and, at shutter time 0.5, the same re-posed instance table
    (repose_inst) or rebuilt triangles (rebuild_geo). A QOI bitmap, a
    ZSTD-compressed TIFF heightfield and a JPEG 2000 envmap (formats and
    variants PIL reads and the port does not, ROADMAP item 13) raise
    NotImplementedError before any build, naming the item. (A GIF bitmap,
    a CMYK JPEG bitmap and an arithmetic-coded JPEG envmap, this test's
    refusals before, are read now: tests/test_torch_gif.py,
    tests/test_torch_jpeg_variants.py.)"""
    scene_xmls.instanced_files(str(tmp_path))
    Image.new("RGB", (4, 4), (9, 80, 200)).save(tmp_path / "t.qoi")
    Image.new("RGB", (8, 8), (10, 20, 30)).save(tmp_path / "h.tif",
                                                compression="zstd")
    Image.new("RGB", (8, 8), (90, 20, 30)).save(tmp_path / "a.jp2")
    Image.fromarray(np.random.default_rng(4).integers(
        0, 256, (20, 30, 3), dtype=np.uint8)).save(tmp_path / "t.jpg",
                                                    quality=90)
    sensor = ("<sensor type=\"perspective\"><float name=\"shutterClose\" "
              "value=\"{c}\"/><film type=\"hdrfilm\"><integer "
              "name=\"width\" value=\"16\"/><integer name=\"height\" "
              "value=\"12\"/></film></sensor>")
    body, item = {
        "animated_instance": (
            "<shape type=\"shapegroup\" id=\"g\"><shape type=\"cube\"/>"
            "</shape><shape type=\"instance\"><ref id=\"g\"/><animation "
            "name=\"toWorld\"><transform time=\"0\"/><transform time=\"1\">"
            "<translate x=\"1\"/></transform></animation></shape>", None),
        "open_shutter": (
            "<shape type=\"deformable\"><string name=\"filename\" "
            "value=\"sphere0.obj\"/><string name=\"filename2\" "
            "value=\"sphere1.obj\"/></shape>", None),
        "jpeg_bitmap": (
            "<shape type=\"cube\"><bsdf type=\"diffuse\"><texture "
            "type=\"bitmap\"><string name=\"filename\" value=\"t.jpg\"/>"
            "</texture></bsdf></shape>", "bitmap"),
        "jpeg_heightfield": (
            "<shape type=\"heightfield\"><string name=\"filename\" "
            "value=\"t.jpg\"/></shape>", None),
        "qoi_bitmap": (
            "<shape type=\"cube\"><bsdf type=\"diffuse\"><texture "
            "type=\"bitmap\"><string name=\"filename\" value=\"t.qoi\"/>"
            "</texture></bsdf></shape>", "13"),
        "zstd_tiff_heightfield": (
            "<shape type=\"heightfield\"><string name=\"filename\" "
            "value=\"h.tif\"/></shape>", "13"),
        "jp2_envmap": (
            "<shape type=\"cube\"/><emitter type=\"envmap\"><string "
            "name=\"filename\" value=\"a.jp2\"/></emitter>", "13")}[case]
    p = tmp_path / "scene.xml"
    p.write_text(f"<scene version=\"0.5.0\">"
                 f"{sensor.format(c=1.0 if item is None else 0.0)}"
                 f"{body}</scene>")
    if item == "bitmap":
        ts = txl.load_scene(str(p), device="cpu")
        png = tmp_path / "t.png"
        tio.write_png(str(png), tio.read_image(str(tmp_path / "t.jpg"),
                                               device="cpu"))
        p.write_text(p.read_text().replace("t.jpg", "t.png"))
        _same_tensors(ts.arrays, txl.load_scene(str(p), device="cpu").arrays)
        assert ts.arrays.checkers.kind.tolist() == [tmat.TEX_BITMAP]
        return
    if item is None:
        ts = txl.load_scene(str(p), device="cpu")
        js = jxl.load_scene(str(p))
        if case == "jpeg_heightfield":
            assert ts.shutter == tuple(js.shutter)
            _same_tensors(ts.arrays, convert.convert_arrays(
                jax.tree_util.tree_map(np.asarray, js.arrays),
                device="cpu"))
            return
        assert ts.shutter == tuple(js.shutter) == (0.0, 1.0)

        def port(arrays):
            return convert.convert_arrays(
                jax.tree_util.tree_map(np.asarray, arrays), device="cpu")
        _same_tensors(ts.arrays, port(js.arrays))
        if case == "animated_instance":
            assert ts.rebuild_geo is None and js.rebuild_geo is None
            _same_tensors(ts.repose_inst(ts.arrays, 0.5).inst,
                          port(js.repose_inst(js.arrays, 0.5)).inst)
        else:
            assert ts.repose_inst is None and js.repose_inst is None
            _same_tensors(ts.rebuild_geo(0.5), port(js.rebuild_geo(0.5)))
        return

    def no_build(*a, **kw):
        raise AssertionError("the scene was built")
    mp = pytest.MonkeyPatch()
    mp.setattr(txl.SceneBuilder, "__init__", no_build)
    try:
        with pytest.raises(NotImplementedError, match=f"item {item}\\)"):
            txl.load_scene(str(p), device="cpu")
    finally:
        mp.undo()
