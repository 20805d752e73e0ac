"""Integrator and film types the port does not list, and the CLI's image
output by extension, against hairpt on the CPU.

The loaders: an unknown integrator or film type fails validation in both
packages (SceneXMLError, as PluginManager would), and with validate=False
(or a `$var` type, which validation lets through) both take it, the
integrator type as given and the film's width, height and gamma read as
any film's. The CLI: an integrator name it does not list
renders with the path integrator, or streams the banded EXR under
--bands, as hairpt's CLI does (both CLIs run on the same XML); -o picks the writer by the
extension as PIL does: .tif and .ppm write PIL's bytes of the tonemapped
image, .gif (PIL writes it, the port does not yet) raises
NotImplementedError before the render, and an extension PIL has no
writer for raises ValueError before the render; util does the same
before reading its inputs."""
import io

import jax
import numpy as np
import pytest
from PIL import Image

import hairpt.cli as jcli
from hairpt.ops import bvh as jbvh
from hairpt.scene import xml_loader as jxl
from hairpt.scene.xml_validate import SceneXMLError as JSceneXMLError
from hairpt_torch import cli
from hairpt_torch.integrators import path as tpath
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.scene.xml_validate import SceneXMLError
from hairpt_torch.utils import exr as texr
from hairpt_torch.utils import io as tio
from torch_threads import one_thread  # noqa: F401

SMALL = ["--spp", "1", "--res-scale", "0.02", "--hair-quality", "0.02",
         "--depth", "2"]
LOAD = dict(spp_override=1, res_scale=0.02, hair_quality=0.02,
            max_depth_override=2)
# half precision: 11 significant bits, round to nearest; 2^-24 the
# smallest subnormal step (tests/test_torch_tiled_film.py)
HALF_RTOL = 2.0 ** -11
HALF_ATOL = 2.0 ** -24


def _xml(tmp_path, integrator="path", film="ldrfilm"):
    xml = scene_xmls.write_scene(str(tmp_path), "furball")
    src = open(xml).read()
    src = src.replace('<integrator type="path">',
                      f'<integrator type="{integrator}">', 1)
    src = src.replace('<film type="ldrfilm">', f'<film type="{film}">' if
                      film else "<film>", 1)
    src = src.replace('<integer name="height" value="1024"/>',
                      '<integer name="height" value="768"/><float '
                      'name="gamma" value="1.8"/>', 1)
    with open(xml, "w") as f:
        f.write(src)
    return xml


@pytest.mark.parametrize("case", ["integrator", "film"])
def test_validation_refuses_unknown_types_in_both(tmp_path, case):
    xml = _xml(tmp_path, **{case: "nosuchtype"})
    with pytest.raises(JSceneXMLError, match="nosuchtype"):
        jxl.load_scene(xml, **LOAD)
    with pytest.raises(SceneXMLError, match="nosuchtype"):
        txl.load_scene(xml, device="cpu", **LOAD)


@pytest.mark.parametrize("integrator,film,validate", [
    ("nosuchtype", "ldrfilm", False), ("$integ", "ldrfilm", True),
    ("path", "nosuchfilm", False), ("path", "$film", True),
    ("path", None, False), ("volpath_simple", "hdrfilm", True)])
def test_loaders_take_unknown_types_as_hairpt(tmp_path, integrator, film,
                                              validate):
    """The integrator type as given, the film's size and gamma."""
    xml = _xml(tmp_path, integrator, film)
    js = jxl.load_scene(xml, validate=validate, **LOAD)
    ts = txl.load_scene(xml, validate=validate, device="cpu", **LOAD)
    assert ts.config.integrator == js.config.integrator == integrator
    assert (ts.config.width, ts.config.height) == \
        (js.config.width, js.config.height) == (20, 15)
    assert ts.film.gamma == js.film.gamma == 1.8
    assert ts.config.tiled_film == js.config.tiled_film is False


@pytest.fixture
def jax_cli(monkeypatch):
    """hairpt's CLI main, its scene build ordering the hair with the
    port's build of csrc/bvh_builder.cpp (tests/test_torch_cli.py) and
    its JAX compilation cache left where the test session has it."""
    monkeypatch.setattr(jbvh, "_NATIVE", tbvh._load_native())
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    return jcli.main


def _agree(got, want):
    """tests/test_torch_cli.py's criterion for the port's render against
    hairpt's, with half rounding added (the banded EXRs): the means
    within 2e-3 relative, >= 97% of the values within 1e-3 relative +
    1e-4."""
    assert got.shape == want.shape == (15, 20, 3) and want.mean() > 0
    assert abs(got.mean() - want.mean()) / want.mean() < 2e-3
    close = np.abs(got - want) <= (1e-3 + HALF_RTOL) * np.abs(want) + 1e-4
    assert close.mean() >= 0.97, close.mean()


@pytest.mark.parametrize("name", ["nosuchtype", "$integ"])
def test_cli_renders_an_unknown_integrator_with_path(tmp_path, jax_cli,
                                                     name):
    """--integrator with a name the CLI does not list, and a `$var` type
    in the XML: the port's CLI renders the path image, as hairpt's CLI
    does on the same XML and arguments (and equal to the port's
    in-process path.render); under --bands it streams the banded EXR
    and writes no 8-bit image, the EXR within half rounding of the
    port's path image and agreeing with hairpt's. (hairpt's banded
    render is held to the port's in tests/test_torch_tiled_film.py.)"""
    if name.startswith("$"):
        xml, extra = _xml(tmp_path, integrator=name), []
    else:
        xml, extra = _xml(tmp_path), ["--integrator", name]
    out, j_out = tmp_path / "o.png", tmp_path / "j.png"
    assert cli.main(["render", xml, "-o", str(out), "--cpu"] + SMALL
                    + extra) == 0
    jax_cli(["render", xml, "-o", str(j_out), "--cpu"] + SMALL + extra)
    img = np.load(tmp_path / "o.npy")
    want = np.load(tmp_path / "j.npy").astype(np.float64)
    _agree(img.astype(np.float64), want)
    s = txl.load_scene(xml, device="cpu", **LOAD)
    np.testing.assert_array_equal(img, tpath.render(s, spp=1).numpy())
    banded = tmp_path / "b.png"
    assert cli.main(["render", xml, "-o", str(banded), "--cpu", "--bands",
                     "4"] + SMALL + extra) == 0
    assert not banded.exists()
    got = texr.read_exr(str(tmp_path / "b.exr"))[..., :3].astype(np.float64)
    assert (np.abs(got - img) <= HALF_RTOL * 1.01 * np.abs(img)
            + HALF_ATOL).all(), np.abs(got - img).max()
    _agree(got, want)


@pytest.mark.parametrize("ext,fmt", [("tif", "TIFF"), ("tiff", "TIFF"),
                                     ("ppm", "PPM"), ("pnm", "PPM")])
def test_cli_writes_the_format_its_extension_names(tmp_path, ext, fmt):
    """-o x.tif / x.ppm: PIL's bytes of the tonemapped image under that
    name (never PNG bytes), the EXR, .npy and .pfm beside it."""
    xml = _xml(tmp_path)
    out = tmp_path / f"o.{ext}"
    assert cli.main(["render", xml, "-o", str(out), "--cpu"] + SMALL) == 0
    ldr = tio.tonemap_srgb(np.load(tmp_path / "o.npy"), 1.8)
    u8 = np.clip(ldr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    ref = io.BytesIO()
    Image.fromarray(u8).save(ref, fmt)
    assert out.read_bytes() == ref.getvalue()
    assert Image.open(out).format == fmt
    for other in ("exr", "npy", "pfm"):
        assert (tmp_path / f"o.{other}").exists()


@pytest.mark.parametrize("ext,err", [("gif", NotImplementedError),
                                     ("webp", NotImplementedError),
                                     ("jp2", NotImplementedError),
                                     ("npy", ValueError),
                                     ("xyz", ValueError)])
def test_cli_refuses_an_unwritable_extension_before_the_render(
        tmp_path, monkeypatch, ext, err):
    """A format PIL writes and the port does not yet: NotImplementedError
    naming ROADMAP item 13; one PIL has no writer for: ValueError (PIL
    raises it after the render); both before the render, nothing
    written."""
    xml = _xml(tmp_path)

    def no_render(*a, **kw):
        raise AssertionError("rendered")
    monkeypatch.setattr(tpath, "render", no_render)
    match = "ROADMAP item 13" if err is NotImplementedError else ext
    with pytest.raises(err, match=match):
        cli.main(["render", xml, "-o", str(tmp_path / f"o.{ext}"), "--cpu"]
                 + SMALL)
    assert not list(tmp_path.glob("o.*"))


@pytest.mark.parametrize("ext", ["tif", "ppm", "gif", "foo"])
def test_util_output_by_extension(tmp_path, ext):
    """util tonemap: .tif and .ppm written as PIL writes them; .gif and an
    unknown extension refused before any input is read."""
    src = tmp_path / "a.npy"
    np.save(src, np.random.default_rng(2).uniform(0, 1, (5, 7, 3))
            .astype(np.float32))
    out = tmp_path / f"a.{ext}"
    args = ["util", "tonemap", str(src), "-o", str(out), "--cpu"]
    if ext in ("gif", "foo"):
        src.unlink()    # nothing may be read first
        with pytest.raises(NotImplementedError if ext == "gif"
                           else ValueError):
            cli.main(args)
        return
    assert cli.main(args) == 0
    png = tmp_path / "a.png"
    assert cli.main(["util", "tonemap", str(src), "-o", str(png),
                     "--cpu"]) == 0
    ref = io.BytesIO()
    Image.fromarray(tio.read_png(str(png))).save(
        ref, {"tif": "TIFF", "ppm": "PPM"}[ext])
    assert out.read_bytes() == ref.getvalue()
