"""`python -m hairpt_torch.cli render` on the CPU: the slice as a whole
against hairpt (the furball and teapot stand-in XMLs, loaded and rendered
by hairpt with its CPU default, the packed BVH walk, which has no Pallas
kernel and compiles once per scene; the port's CLI with --cpu, the tiled
traversal's plain versions for the hair and the packed walk's for the
triangles), the options, the refusals, the exit without a card, and the
render's checkpoint and partial-image flush.

Both scene builds order the hair with the port's build of
csrc/bvh_builder.cpp (see tests/test_torch_xml.py)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hairpt.integrators import path as jpath
from hairpt.ops import bvh as jbvh
from hairpt.scene import xml_loader as jxl
from hairpt_torch import cli
from hairpt_torch.integrators import aux_integrators as taux
from hairpt_torch.integrators import path as tpath
from hairpt_torch.integrators import ptracer as tptracer
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--spp", "2", "--res-scale", "0.02", "--hair-quality", "0.02",
         "--depth", "3"]
LOAD = dict(spp_override=2, res_scale=0.02, hair_quality=0.02,
            max_depth_override=3)


@pytest.fixture(scope="module")
def whole(tmp_path_factory):
    """hairpt's load_scene and render of the furball XML at 20^2, 2 spp,
    depth 3, and the port's CLI on the same XML with --cpu."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", tbvh._load_native())
    mp.setattr(jbvh, "_NATIVE_TRIED", True)
    root = tmp_path_factory.mktemp("scenes")
    xml = scene_xmls.write_scene(str(root), "furball")
    img_j = np.asarray(jpath.render(jxl.load_scene(xml, **LOAD)))
    out = root / "out" / "furball.png"
    out.parent.mkdir()
    rc = cli.main(["render", xml, "-o", str(out), "--cpu"] + SMALL)
    yield dict(root=root, xml=xml, img_j=img_j, out=out, rc=rc)
    mp.undo()


def test_cli_writes_every_output(whole):
    out = whole["out"]
    assert whole["rc"] == 0
    for ext in ("png", "exr", "npy", "pfm"):
        assert out.with_suffix(f".{ext}").stat().st_size > 0, ext
    img = np.load(out.with_suffix(".npy"))
    assert img.shape == (20, 20, 3) and np.isfinite(img).all()
    from hairpt_torch.utils import exr, io
    np.testing.assert_array_equal(io.read_pfm(str(out.with_suffix(".pfm"))),
                                  img)
    np.testing.assert_array_equal(
        exr.read_exr(str(out.with_suffix(".exr"))),
        img.astype(np.float16).astype(np.float32))


def test_cli_image_matches_jax(whole):
    """The image mean within 1e-3 relative and >= 99% of pixel values
    within 1e-3 relative + 1e-4 (tests/test_torch_hair_render.py's
    criterion: the packed walk and the tiled plain versions find the
    same closest hits; paths diverge only where float32 rounding flips a
    sampling decision)."""
    img_t = np.load(whole["out"].with_suffix(".npy"))
    img_j = whole["img_j"]
    assert img_t.shape == img_j.shape and img_j.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 1e-3
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()


TEAPOT = ["--spp", "4", "--res-scale", "0.05", "--depth", "8"]
TEAPOT_LOAD = dict(spp_override=4, res_scale=0.05, max_depth_override=8)


@pytest.fixture(scope="module")
def teapot(tmp_path_factory):
    """hairpt's load_scene and render of the teapot stand-in XML at 64 x
    36, 4 spp, depth 8, and the port's CLI on the same XML with --cpu."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbvh, "_NATIVE", tbvh._load_native())
    mp.setattr(jbvh, "_NATIVE_TRIED", True)
    root = tmp_path_factory.mktemp("teapot")
    xml = scene_xmls.write_scene(str(root), "teapot")
    img_j = np.asarray(jpath.render(jxl.load_scene(xml, **TEAPOT_LOAD)))
    out = root / "out" / "teapot.png"
    out.parent.mkdir()
    rc = cli.main(["render", xml, "-o", str(out), "--cpu"] + TEAPOT)
    yield dict(img_j=img_j, out=out, rc=rc)
    mp.undo()


def test_cli_renders_the_teapot_like_jax(teapot):
    """The teapot stand-in (teapot_standin under twosided plastic, a
    checkerboard floor, the constant envmap of a missing EXR) through the
    CLI: exit 0, every output, and the image against hairpt's with
    test_cli_image_matches_jax's bounds."""
    out = teapot["out"]
    assert teapot["rc"] == 0
    for ext in ("png", "exr", "npy", "pfm"):
        assert out.with_suffix(f".{ext}").stat().st_size > 0, ext
    img_t = np.load(out.with_suffix(".npy"))
    img_j = teapot["img_j"]
    assert img_t.shape == img_j.shape == (36, 64, 3) and img_j.mean() > 0
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 1e-3
    close = np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4)
    assert close.mean() >= 0.99, close.mean()


def test_cli_npy_equals_in_process_render(whole):
    scene = txl.load_scene(whole["xml"], **LOAD, device="cpu")
    img = tpath.render(scene).numpy()
    np.testing.assert_array_equal(np.load(whole["out"].with_suffix(".npy")),
                                  img)


@pytest.fixture
def fake_render(monkeypatch):
    """Replace the render with a record of the scene it was given."""
    seen = []

    def render(scene, **kw):
        seen.append((scene, kw))
        return torch.zeros(scene.config.height, scene.config.width, 3)
    monkeypatch.setattr(tpath, "render", render)
    return seen


def test_cli_options_reach_the_config(tmp_path, fake_render):
    """-D substitution, --depth, --spp, --res-scale and --seed."""
    xml = str(tmp_path / "furball" / "scene.xml")
    os.makedirs(os.path.dirname(xml))
    with open(xml, "w") as f:
        f.write(scene_xmls.furball(depth="$depth", spp="$n"))
    out = str(tmp_path / "o.png")
    base = ["render", xml, "-o", out, "--cpu", "--hair-quality", "0.02",
            "-D", "depth=7", "-D", "n=5"]
    assert cli.main(base + ["--res-scale", "0.02"]) == 0
    cfg = fake_render[-1][0].config
    assert (cfg.max_depth, cfg.spp, cfg.width) == (7, 5, 20)
    assert cli.main(base + ["--depth", "4", "--spp", "3", "--res-scale",
                            "0.01", "--seed", "9"]) == 0
    scene, kw = fake_render[-1]
    assert (scene.config.max_depth, scene.config.spp,
            scene.config.width) == (4, 3, 10)
    assert kw["seed"] == 9 and scene.config.sampler[0] == 4
    assert os.path.exists(out)


def test_cli_define_selects_the_faithful_marschner(tmp_path, fake_render):
    xml = scene_xmls.write_scene(str(tmp_path), "straight_marschner")
    out = str(tmp_path / "o.png")
    for define, kind in ((["-D", "marschner_faithful=true"], tmat.MARSCHNER),
                         ([], tmat.MARSCHNER_PURE)):
        assert cli.main(["render", xml, "-o", out, "--cpu"] + SMALL
                        + define) == 0
        assert fake_render[-1][0].arrays.materials.kind.tolist() == [kind]


def test_cli_skip_existing(tmp_path, fake_render):
    xml = scene_xmls.write_scene(str(tmp_path), "furball")
    out = tmp_path / "o.png"
    out.write_bytes(b"old")
    assert cli.main(["render", xml, "-o", str(out), "--cpu", "-x"]
                    + SMALL) == 0
    assert fake_render == [] and out.read_bytes() == b"old"
    assert not (tmp_path / "o.npy").exists()


def test_cli_refuses_jpeg_before_the_build(tmp_path):
    """JPEG output, which an earlier slice refused here, renders: -o o.jpg
    writes write_jpg(tonemap(.npy)) at quality 95 (with .exr, .npy and
    .pfm beside it), and PIL reads it with the quantization tables of its
    own quality-95 file of the same pixels (hairpt's write_jpg), its
    decode within 2 levels of that file's."""
    from PIL import Image
    from hairpt.utils import io as jio
    from hairpt_torch.utils import io as tio
    xml = scene_xmls.write_scene(str(tmp_path), "furball")
    out = tmp_path / "o.jpg"
    assert cli.main(["render", xml, "-o", str(out), "--cpu"] + SMALL) == 0
    for ext in ("exr", "npy", "pfm"):
        assert (tmp_path / f"o.{ext}").exists()
    ldr = tio.tonemap_srgb(np.load(tmp_path / "o.npy"), 2.2)
    ref = tmp_path / "ref.jpg"
    tio.write_jpg(str(ref), ldr, device="cpu")
    assert out.read_bytes() == ref.read_bytes()
    jio.write_jpg(str(tmp_path / "j.jpg"), ldr)
    im_t, im_j = Image.open(out), Image.open(tmp_path / "j.jpg")
    assert im_t.quantization == im_j.quantization
    d = np.abs(np.asarray(im_t.convert("RGB"), int)
               - np.asarray(im_j.convert("RGB"), int))
    assert d.max() <= 2


SENSOR = ("<sensor type=\"{kind}\"><film type=\"hdrfilm\"><integer "
          "name=\"width\" value=\"16\"/><integer name=\"height\" "
          "value=\"16\"/></film></sensor>")
HAIR = ("<shape type=\"hair\"><string name=\"filename\" "
        "value=\"furball.mitshair\"/></shape>")
REFUSED = {
    # an instance of a shapegroup renders, an animated one too (item 11c,
    # refused by an earlier slice): item None, the CLI renders it
    "shapegroup": (SENSOR.format(kind="perspective")
                   + "<shape type=\"shapegroup\" id=\"g\"><shape "
                     "type=\"sphere\"/></shape><shape type=\"instance\">"
                     "<ref id=\"g\"/><animation name=\"toWorld\"><transform "
                     "time=\"0\"><translate z=\"5\"/></transform>"
                     "<transform time=\"1\"><translate x=\"1\" z=\"5\"/>"
                     "</transform></animation></shape>"
                   + HAIR + "<emitter type=\"constant\"/>", None),
    # a point light and an area light (an emitter inside a hair shape,
    # which both loaders drop) render (item 13's lights, refused by an
    # earlier slice)
    "point_light": (SENSOR.format(kind="perspective") + HAIR
                    + "<emitter type=\"point\"/>", None),
    # the other sensors and the surface BSDFs render (item 13's, refused
    # by an earlier slice)
    "orthographic": (SENSOR.format(kind="orthographic") + HAIR, None),
    # the direct integrator renders (item 13's, refused by an earlier
    # slice): the path render at depth 2
    "direct": ("<integrator type=\"direct\"/>"
               + SENSOR.format(kind="perspective") + HAIR
               + "<emitter type=\"constant\"/>", None),
    # a PNG bitmap renders, and a JPEG one (item 13's, refused by an
    # earlier slice)
    "bitmap": (SENSOR.format(kind="perspective")
               + "<bsdf type=\"diffuse\" id=\"d\"><texture "
                 "type=\"bitmap\" name=\"reflectance\"><string "
                 "name=\"filename\" value=\"t.jpg\"/></texture></bsdf>"
               + HAIR, None),
    # a scene medium, an hk BSDF and volpath render (item 13's, refused
    # by an earlier slice; the path integrator leaves the medium out);
    # ptracer renders (item 13's light tracers, refused by an earlier
    # slice; given an emitter to trace from); irawan renders (item 13's,
    # refused by an earlier slice)
    "medium": (SENSOR.format(kind="perspective") + HAIR
               + "<medium type=\"homogeneous\"/>", None),
    "ptracer": ("<integrator type=\"ptracer\"/>"
                + SENSOR.format(kind="perspective") + HAIR
                + "<emitter type=\"constant\"/>", None),
    "conductor": (SENSOR.format(kind="perspective")
                  + "<bsdf type=\"conductor\" id=\"c\"/>" + HAIR, None),
    "hk": (SENSOR.format(kind="perspective")
           + "<bsdf type=\"hk\" id=\"h\"/>" + HAIR, None),
    "irawan": (SENSOR.format(kind="perspective")
               + "<bsdf type=\"irawan\" id=\"c\"/>" + HAIR, None),
    "area_light": (SENSOR.format(kind="perspective")
                   + HAIR.replace("</shape>",
                                  "<emitter type=\"area\"/></shape>"),
                   None),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_cli_refuses_what_the_port_does_not_render(tmp_path, monkeypatch,
                                                   case):
    """Each raises NotImplementedError naming its ROADMAP item, before any
    build work; what a later slice ported (item None) renders through the
    CLI, its image equal to a render of load_scene's scene."""
    body, item = REFUSED[case]
    d = tmp_path / "furball"
    d.mkdir()
    (d / "scene.xml").write_text(f"<scene version=\"0.5.0\">{body}</scene>")
    from PIL import Image
    Image.fromarray(np.random.default_rng(5).integers(
        0, 256, (8, 12, 3), dtype=np.uint8)).save(d / "t.jpg")
    if item is None:
        flags = ["--cpu", "--spp", "1", "--depth", "2", "--hair-quality",
                 "0.01"]
        out = tmp_path / "o.png"
        assert cli.main(["render", str(d / "scene.xml"), "-o", str(out)]
                        + flags) == 0
        img = np.load(tmp_path / "o.npy")
        s = txl.load_scene(str(d / "scene.xml"), spp_override=1,
                           max_depth_override=2, hair_quality=0.01,
                           device="cpu")
        if case == "shapegroup":
            assert len(s.arrays.inst.proto_ids) == 1 and img.mean() > 0
        if case == "point_light":
            assert s.arrays.delta.kind.tolist() == [0]
        if case == "orthographic":
            assert s.camera.kind == 2
        if case == "bitmap":
            assert s.arrays.checkers.kind.tolist() == [tmat.TEX_BITMAP]
        if case == "conductor":
            assert s.arrays.materials.kind.tolist()[0] == 2
        if case == "medium":
            assert s.medium is not None and s.config.integrator == "path"
        if case == "hk":
            assert s.arrays.materials.kind.tolist()[0] == tmat.HK
        if case == "irawan":
            assert s.arrays.materials.kind.tolist()[0] == tmat.CLOTH
            assert s.arrays.materials.cloth.tile_w.tolist() == [2.0]
        if case == "area_light":
            # the hair shape's emitter is dropped: no light at all
            assert s.arrays.area is None and s.config.nee_probs == (0.0,) * 3
        if case == "ptracer":
            assert s.config.integrator == "ptracer"
            ref = tptracer.render_ptracer(s)
        elif case == "direct":
            assert s.config.integrator == "direct"
            ref = taux.render_direct(s)
        else:
            ref = tpath.render(s, spp=1)
        np.testing.assert_array_equal(img, ref.numpy())
        return
    monkeypatch.setattr(txl.SceneBuilder, "__init__", None)
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}\\)"):
        cli.main(["render", str(d / "scene.xml"), "-o",
                  str(tmp_path / "o.png"), "--cpu"])


@pytest.mark.parametrize("extra", [["-o", "out.jpg"], ["--bands", "4"],
                                   ["--integrator", "motion"], ["--stats"],
                                   ["--profile", "trace"],
                                   ["--integrator", "mlt"]],
                         ids=lambda e: "_".join(e) if e[0] == "--integrator"
                         and e[1] == "mlt" else e[0])
def test_cli_refuses_unported_options(tmp_path, extra, monkeypatch, capsys):
    """JPEG output renders now, as the other options do (--spectral and
    the direct integrator render too: JPEG output and the motion
    integrator took their places here). Their cases check that the CLI
    takes them, loads the scene (at LOAD's size, mlt
    bound to 256 chains here; test_torch_aux_cli.py holds the mlt and
    motion images to the in-process renders) and writes its outputs:
    --bands 4 the banded EXR (16-row bands: the EXR's blocks) equal to
    render_tiled_exr's within half rounding, --stats the counters' table
    with the render's rays, --profile the Chrome trace of the render."""
    import functools
    from hairpt_torch.film import tiled as ttiled
    from hairpt_torch.integrators import mlt as tmlt
    from hairpt_torch.utils import exr as texr
    xml = scene_xmls.write_scene(str(tmp_path), "furball")
    load = txl.load_scene
    monkeypatch.setattr(txl, "load_scene", lambda path, defines=None,
                        **kw: load(path, defines, **dict(kw, **LOAD)))
    monkeypatch.setattr(tmlt, "render_mlt", functools.partial(
        tmlt.render_mlt, n_chains=256, n_mutations=5, n_boot=2))
    out = tmp_path / "o.png"
    capsys.readouterr()
    if extra[0] == "-o":
        out, extra = tmp_path / "o.jpg", []
    assert cli.main(["render", xml, "-o", str(out), "--cpu"]
                    + [str(tmp_path / e) if e == "trace" else e
                       for e in extra]) == 0
    if out.suffix == ".jpg":
        from hairpt_torch.utils import io as tio
        img = np.load(tmp_path / "o.npy")
        got = tio.read_image(str(out), device="cpu")
        want = tio.tonemap_srgb(img, 2.2)
        assert got.shape == want.shape == (20, 20, 3)
        assert np.abs(got - want).mean() < 0.05
        return
    if extra[0] == "--bands":
        assert not out.exists() and not (tmp_path / "o.npy").exists()
        got = texr.read_exr(str(tmp_path / "o.exr"))[..., :3]
        ref = str(tmp_path / "ref.exr")
        ttiled.render_tiled_exr(txl.load_scene(xml, device="cpu"), ref,
                                band_rows=4, half=False)
        want = texr.read_exr(ref)[..., :3]
        assert got.shape == want.shape == (20, 20, 3) and want.mean() > 0
        np.testing.assert_allclose(got, want, rtol=2.0 ** -11, atol=2e-7)
        return
    img = np.load(tmp_path / "o.npy")
    assert img.ndim == 3 and img.shape[-1] == 3 and out.exists()
    if extra[0] == "--stats":
        err = capsys.readouterr().err
        assert "Render statistics" in err and "Rays traced" in err
        assert "Sample waves           : 2" in err
    if extra[0] == "--profile":
        import json
        with open(tmp_path / "trace" / "trace.json") as fh:
            events = json.load(fh)["traceEvents"]
        assert len(events) > 100


def test_cli_renders_volpath(tmp_path):
    """--integrator volpath on the media stand-in (the furball in a 16^3
    smoke grid): the image equals render_volpath of load_scene's scene."""
    from hairpt_torch.integrators import volpath
    xml = scene_xmls.write_scene(str(tmp_path), "media", vol_res=16)
    out = tmp_path / "v.png"
    assert cli.main(["render", xml, "-o", str(out), "--cpu",
                     "--integrator", "volpath"] + SMALL) == 0
    img = np.load(tmp_path / "v.npy")
    s = txl.load_scene(xml, device="cpu", **LOAD)
    ref = volpath.render_volpath(s, spp=2).numpy()
    assert s.medium is not None and img.mean() > 0
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("cmd", ["util", "import"])
def test_cli_refuses_unported_commands(cmd, tmp_path):
    """The util and import commands run now (tests/test_torch_util_cli.py
    and tests/test_torch_collada.py hold them to hairpt's): util tonemap
    of an .npy on the CPU, import of the COLLADA stand-in; an unknown
    tool is an argparse error."""
    if cmd == "util":
        src = tmp_path / "a.npy"
        np.save(src, np.full((4, 6, 3), 0.25, np.float32))
        out = tmp_path / "a.png"
        assert cli.main(["util", "tonemap", str(src), "-o", str(out),
                         "--cpu"]) == 0
        from hairpt_torch.utils import io as tio
        assert (tio.read_png(str(out)) == 136).all()
        with pytest.raises(SystemExit):
            cli.main(["util", "nosuchtool", str(src), "-o", str(out)])
    else:
        dae = scene_xmls.write_dae(str(tmp_path / "p.dae"))
        assert cli.main(["import", dae, str(tmp_path / "s.xml")]) == 0
        s = txl.load_scene(str(tmp_path / "s.xml"), device="cpu",
                           res_scale=0.03125, spp_override=1)
        assert s.arrays.tri is not None and s.config.width == 16


def test_cli_without_a_card_exits_nonzero(tmp_path):
    """No --cpu and no card: a non-zero exit, no output, nothing built."""
    xml = scene_xmls.write_scene(str(tmp_path), "furball")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    res = subprocess.run([sys.executable, "-m", "hairpt_torch.cli", "render",
                          xml, "-o", str(tmp_path / "o.png")] + SMALL,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA" in res.stderr and "scene built" not in res.stderr
    assert not any(p.name.startswith("o.") for p in tmp_path.iterdir())


def test_checkpoint_resume_is_exact_and_flush_develops(tmp_path, whole):
    """2 spp, interrupted, then resumed from the checkpoint to 4, equals
    an uninterrupted 4 spp render bit for bit; flush_cb gets the
    developed image of the waves so far."""
    scene = txl.load_scene(whole["xml"], **LOAD, device="cpu")
    ref = tpath.render(scene, spp=4)
    ck = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def stop_at_2(done, total, secs, n_rays):
        if done == 2:
            raise Stop
    with pytest.raises(Stop):
        tpath.render(scene, spp=4, checkpoint=ck, progress=stop_at_2)
    saved = np.load(ck)
    assert int(saved["next_sample"]) == 2 and int(saved["spp"]) == 4
    flushed, waves = [], []
    img = tpath.render(scene, spp=4, checkpoint=ck, flush_every=1e-9,
                       flush_cb=flushed.append,
                       progress=lambda d, t, s, n: waves.append(d))
    assert waves == [3, 4]
    torch.testing.assert_close(img, ref, rtol=0, atol=0)
    assert len(flushed) == 2
    torch.testing.assert_close(flushed[-1], ref, rtol=0, atol=0)
    assert int(np.load(ck)["next_sample"]) == 4
