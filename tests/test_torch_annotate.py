"""The film's label[] annotations and banner in the port against hairpt,
on the CPU: io.annotate_image against hairpt's (PIL's FreeType font
against the port's bitmap font, so the pixels are compared outside each
label's box and the banner's box, where they are equal to the bit, and
inside only for having drawn something), the label grammar's
substitutions, the XML loaders' films, and the CLI's annotated JPEG
against write_jpg(annotate_image(tonemap(.npy))) of its own .npy, byte
for byte."""
import numpy as np
import pytest
from PIL import Image, ImageDraw

from hairpt.scene import xml_loader as jxl
from hairpt.utils import io as jio
from hairpt_torch import cli
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.utils import font
from hairpt_torch.utils import io as tio
from hairpt_torch.utils import jpeg as tjpeg
from torch_threads import one_thread  # noqa: F401

H, W = 48, 96
SUBST = {"scene.renderTime": 1.5, "film.width": 64, "film.height": 48,
         "sampler.sampleCount": 4, "integrator.maxDepth": 8}
LABELS = [
    (0, 0, "top left"),
    (W - 20, H - 10, "corner"),
    (-10, -5, "off the edge"),
    (W + 5, 3, "gone"),
    (3, 16, "t=$scene['renderTime']s $film['width']x$film['height']"),
    (3, 30, "spp $sampler['sampleCount'] d $integrator[ 'maxDepth' ] "
            "[$foo['bar']]"),
]
EXPECTED = ["top left", "corner", "off the edge", "gone", "t=1.50s 64x48",
            "spp 4 d 8 []"]


def _pil_width(text):
    d = ImageDraw.Draw(Image.new("RGB", (8, 8)))
    return int(np.ceil(d.textlength(text)))


def _boxes(labels, subst, h, w, banner):
    """[x0, x1) x [y0, y1) of every label and of the banner: the text's
    cell rows and the wider of the two packages' text, one column more
    on the left, where PIL's antialiased "s" reaches past its origin."""
    out = []
    for (x, y, _), text in zip(labels, [font.substitute(t, subst)
                                        for _, _, t in labels]):
        tw = max(font.text_width(text), _pil_width(text))
        out.append((x - 1, x + tw + 2, y, y + 14, text))
    if banner:
        tw = max(font.text_width("hairpt"), _pil_width("hairpt"))
        out.append((w - tw - 5, w, h - 14, h, "hairpt"))
    return out


def test_substitutions_follow_hairpt_grammar():
    assert [font.substitute(t, SUBST) for _, _, t in LABELS] == EXPECTED
    assert font.substitute("$scene['renderTime']", None) == ""


def test_annotate_matches_hairpt_outside_the_text():
    img = np.random.default_rng(11).random((H, W, 3)).astype(np.float32)
    got = tio.annotate_image(img, LABELS, SUBST, banner=True)
    want = jio.annotate_image(img, LABELS, SUBST, banner=True)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (H, W, 3)
    base = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8) / np.float32(
        255.0)
    inside = np.zeros((H, W), bool)
    for x0, x1, y0, y1, text in _boxes(LABELS, SUBST, H, W, True):
        box = np.zeros((H, W), bool)
        box[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = True
        inside |= box
        if box.any() and text:
            # both packages drew something of every visible label
            for out in (got, want):
                assert (out[box] != base[box]).any(), text
    np.testing.assert_array_equal(got[~inside].view(np.int32),
                                  want[~inside].view(np.int32))
    # outside the text the image is the input rounded to 8 bits
    np.testing.assert_array_equal(got[~inside], base[~inside])
    # labels white, banner gray
    assert (got * 255 == 255).all(-1).any()
    x0, x1, y0, y1, _ = _boxes(LABELS, SUBST, H, W, True)[-1]
    assert (np.round(got[y0:y1, x0:x1] * 255) == 160).all(-1).any()


def test_annotate_without_labels_is_the_8bit_image():
    img = np.random.default_rng(2).random((9, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(tio.annotate_image(img, (), None),
                                  jio.annotate_image(img, (), None))


FILM = ('<film type="hdrfilm"><integer name="width" value="64"/>'
        '<integer name="height" value="48"/>'
        '<string name="label[4, 6]" value="spp $sampler[\'sampleCount\']"/>'
        '<string name="label[ 10,-3 ]" value="$film[\'width\']"/>'
        '<boolean name="banner" value="true"/></film>')


def test_loaders_carry_the_same_annotations(tmp_path):
    p = tmp_path / "scene.xml"
    p.write_text(f'<scene version="0.5.0"><sensor type="perspective">'
                 f'{FILM}</sensor><shape type="sphere"/>'
                 f'<emitter type="constant"/></scene>')
    ts = txl.load_scene(str(p), device="cpu")
    js = jxl.load_scene(str(p))
    assert ts.film.annotations == tuple(js.film.annotations) == (
        (4, 6, "spp $sampler['sampleCount']"), (10, -3, "$film['width']"))
    assert ts.film.banner is js.film.banner is True


def test_cli_writes_the_annotated_jpeg(tmp_path):
    """render -o out.jpg --cpu on the small furball with two labels (no
    renderTime) and the banner: the JPEG is write_jpg(annotate_image(
    tonemap(.npy))) byte for byte. Its decode against the tonemapped .npy
    outside the text: PSNR 30.0 dB on this 64^2 1-spp frame, where hair
    edges fill most of the frame and 4:2:0 halves the chroma of its
    reddish noise; the bound is 28 dB (chip_smoke's 1024^2 frame is held
    to its own bound)."""
    xml = scene_xmls.write_scene(str(tmp_path), "furball")
    src = open(xml).read()
    film_end = '<rfilter type="tent"/></film>'
    labels = ('<string name="label[2, 2]" value="$film[\'width\']x'
              '$film[\'height\'] spp $sampler[\'sampleCount\']"/>'
              '<string name="label[2, 30]" value="d=$integrator['
              '\'maxDepth\']"/><boolean name="banner" value="true"/>')
    open(xml, "w").write(src.replace(film_end, labels + film_end))
    out = tmp_path / "o.jpg"
    assert cli.main(["render", xml, "-o", str(out), "--cpu", "--spp", "1",
                     "--res-scale", "0.0625", "--hair-quality", "0.02",
                     "--depth", "3"]) == 0
    img = np.load(tmp_path / "o.npy")
    assert img.shape == (64, 64, 3)
    s = txl.load_scene(xml, spp_override=1, res_scale=0.0625,
                       hair_quality=0.02, max_depth_override=3,
                       device="cpu")
    assert len(s.film.annotations) == 2 and s.film.banner
    subst = {"film.width": 64, "film.height": 64, "sampler.sampleCount": 1,
             "integrator.maxDepth": 3}
    ldr = tio.annotate_image(tio.tonemap_srgb(img, s.film.gamma),
                             s.film.annotations, subst, True)
    ref = tmp_path / "ref.jpg"
    tio.write_jpg(str(ref), ldr, device="cpu")
    assert out.read_bytes() == ref.read_bytes()
    for ext in ("exr", "pfm"):
        assert (tmp_path / f"o.{ext}").exists()
    dec = tjpeg.read_jpeg(str(out), "cpu").numpy().astype(np.float64)
    inside = np.zeros((64, 64), bool)
    for x0, x1, y0, y1, _ in _boxes(s.film.annotations, subst, 64, 64,
                                    True):
        inside[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = True
    tm = np.clip(tio.tonemap_srgb(img, s.film.gamma) * 255.0, 0, 255)
    mse = ((dec - tm)[~inside] ** 2).mean()
    psnr = 10 * np.log10(255.0 ** 2 / mse)
    assert psnr >= 28.0, psnr
    # each label's box holds white pixels
    for x0, x1, y0, y1, text in _boxes(s.film.annotations, subst, 64, 64,
                                       False):
        assert (dec[y0:y1, x0:x1] > 200).all(-1).any(), text


@pytest.mark.parametrize("ext", ["png", "bmp", "tga"])
def test_annotations_reach_every_ldr_output(tmp_path, ext, monkeypatch):
    """The other 8-bit outputs carry the same annotated pixels."""
    xml = scene_xmls.write_scene(str(tmp_path), "furball")
    src = open(xml).read()
    film_end = '<rfilter type="tent"/></film>'
    open(xml, "w").write(src.replace(
        film_end, '<string name="label[1, 1]" value="$film[\'width\']"/>'
        + film_end))
    out = tmp_path / f"o.{ext}"
    assert cli.main(["render", xml, "-o", str(out), "--cpu", "--spp", "1",
                     "--res-scale", "0.03125", "--hair-quality", "0.02",
                     "--depth", "2"]) == 0
    img = np.load(tmp_path / "o.npy")
    want = tio.annotate_image(tio.tonemap_srgb(img, 2.2), [(1, 1, "32")])
    np.testing.assert_array_equal(tio.read_image(str(out), device="cpu"),
                                  want)
