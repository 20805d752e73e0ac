"""The JPEG variants PIL decodes and utils/jpeg.py now reads, against
hairpt's _read_texture_image (PIL's Image.open(...).convert("RGB") / 255),
on the CPU, bit for bit: sampling factors up to 4 (4:1:1, 4:4:0, 3:1,
...), four components (CMYK, and YCCK under Adobe transform 2, which
PIL inverts as Adobe's convention and takes to RGB with its cmyk2rgb),
arithmetic coding (SOF9 and SOF10 with DAC and restarts: libjpeg's
jdarith.c) and lossless SOF3 (predictors 1-7, point transform). PIL
cannot write them: tests/torch_jpeg_enc.py writes them over the
coefficients of PIL's own baseline files, so each also decodes in PIL to
the pixels of a Huffman file of the same blocks. The variants PIL fails
on (12-bit, hierarchical, a height in DNL, two components, a fractional
sampling ratio) are a missing texture with a warning, as in hairpt."""
import logging

import numpy as np
import pytest
from PIL import Image

from hairpt.scene.xml_loader import _read_texture_image as jread
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.utils import io as tio
from hairpt_torch.utils import jpeg as tjpeg
from torch_jpeg_enc import (arith_jpeg, component_blocks, huffman_jpeg,
                            lossless_jpeg)
from torch_threads import one_thread  # noqa: F401

W, H = 37, 29


def _same(path):
    want = jread(str(path), "", gamma=1.0)
    assert want is not None, "PIL cannot read the file"
    got = tio.read_image(str(path), device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return want


SAMPLINGS = {
    "gray": [(1, 1)], "444": [(1, 1)] * 3, "420": [(2, 2), (1, 1), (1, 1)],
    "422": [(2, 1), (1, 1), (1, 1)], "440": [(1, 2), (1, 1), (1, 1)],
    "411": [(4, 1), (1, 1), (1, 1)], "410": [(4, 2), (1, 1), (1, 1)],
    "141": [(1, 4), (1, 1), (1, 1)], "311": [(3, 1), (1, 1), (1, 1)],
    "mixed": [(2, 2), (2, 1), (1, 2)], "44_22_11": [(4, 4), (2, 2), (1, 1)],
    "421_on_gray": [(2, 2)]}


@pytest.mark.parametrize("coding", ["huffman", "arith", "arith_prog"])
@pytest.mark.parametrize("layout", sorted(SAMPLINGS))
def test_sampling_factors(tmp_path, layout, coding):
    """Every layout of sampling factors up to 4, Huffman and arithmetic
    coded: libjpeg's fancy upsampling at ratio 2 (box where a component
    is 2 samples wide or less), box replication at 3 and 4."""
    rng = np.random.default_rng(len(layout) * 7 + len(coding))
    samp = SAMPLINGS[layout]
    blocks, q = component_blocks(rng, W, H, samp)
    if coding == "huffman":
        data = huffman_jpeg(W, H, samp, blocks, q)
    else:
        data = arith_jpeg(W, H, samp, blocks, q,
                          progressive=coding == "arith_prog")
    p = tmp_path / "x.jpg"
    p.write_bytes(data)
    if layout == "44_22_11":
        # 21 blocks in an MCU: past libjpeg's 10, PIL fails
        assert jread(str(p), "", gamma=1.0) is None
        with pytest.raises(ValueError, match="10 blocks"):
            tio.read_image(str(p), device="cpu")
        return
    want = _same(p)
    if coding != "huffman":
        # the same blocks Huffman-coded: the same pixels in PIL
        q2 = tmp_path / "h.jpg"
        q2.write_bytes(huffman_jpeg(W, H, samp, blocks, q))
        np.testing.assert_array_equal(jread(str(q2), "", gamma=1.0), want)


@pytest.mark.parametrize("adobe", [None, 0, 1, 2])
@pytest.mark.parametrize("coding", ["huffman", "arith"])
@pytest.mark.parametrize("layout", ["1111", "2211"])
def test_four_components(tmp_path, adobe, coding, layout):
    """CMYK (no Adobe marker, or transform 0) and YCCK (transform 2, and
    1, which libjpeg takes as YCCK too), at full and 2 x 2 sampling."""
    rng = np.random.default_rng(adobe or 9)
    samp = [(1, 1)] * 4 if layout == "1111" else [(2, 2), (1, 1), (1, 1),
                                                  (2, 2)]
    blocks, q = component_blocks(rng, W, H, samp)
    make = huffman_jpeg if coding == "huffman" else arith_jpeg
    p = tmp_path / "x.jpg"
    p.write_bytes(make(W, H, samp, blocks, q, adobe=adobe))
    _same(p)


def test_pil_cmyk(tmp_path):
    """PIL's own CMYK JPEG (its Adobe marker, inverted samples): stored
    (98, 53, 126, 0) reads as PIL reads it."""
    p = tmp_path / "c.jpg"
    a = np.random.default_rng(3).integers(0, 256, (H, W, 4), dtype=np.uint8)
    a[0, 0] = (98, 53, 126, 0)
    Image.fromarray(a, "CMYK").save(p, quality=95)
    _same(p)


@pytest.mark.parametrize("restart", [0, 1, 3])
@pytest.mark.parametrize("dac", [None, (0, 1, 5), (1, 3, 2), (2, 5, 30)])
@pytest.mark.parametrize("prog", [False, True])
def test_arithmetic_conditioning_and_restarts(tmp_path, restart, dac, prog):
    """SOF9 / SOF10 with DAC conditioning (DC L and U, AC K) and restart
    intervals (the statistics reset at each)."""
    rng = np.random.default_rng(restart * 5 + (dac or (0,))[0] + prog)
    samp = SAMPLINGS["420"]
    blocks, q = component_blocks(rng, W, H, samp, quality=60)
    p = tmp_path / "x.jpg"
    p.write_bytes(arith_jpeg(W, H, samp, blocks, q, progressive=prog,
                             restart=restart, dac=dac))
    _same(p)


def test_huffman_restarts_and_rgb_ids(tmp_path):
    """A restart interval of one MCU under the Annex K tables, and RGB
    component ids (no colour transform)."""
    rng = np.random.default_rng(4)
    blocks, q = component_blocks(rng, W, H, SAMPLINGS["444"])
    p = tmp_path / "x.jpg"
    p.write_bytes(huffman_jpeg(W, H, SAMPLINGS["444"], blocks, q,
                               restart=1, ids=[ord("R"), ord("G"),
                                               ord("B")]))
    _same(p)


def _planes(rng, n, shapes):
    out = []
    for (h, w) in shapes[:n]:
        y, x = np.mgrid[0:h, 0:w]
        g = rng.uniform(60, 190) + 50 * np.sin(x / 5.0 + y / rng.uniform(
            3, 7)) + rng.normal(0, 6, (h, w))
        out.append(np.clip(g, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("pt", [0, 2])
def test_lossless_gray(tmp_path, psv, pt):
    """Lossless SOF3, one component: each predictor, point transform 0
    and 2 (samples shifted back up)."""
    rng = np.random.default_rng(psv * 3 + pt)
    p = tmp_path / "x.jpg"
    p.write_bytes(lossless_jpeg(_planes(rng, 1, [(H, W)]), psv=psv, pt=pt))
    _same(p)


@pytest.mark.parametrize("case", ["rgb_adobe0", "rgb_ids", "ycc",
                                  "restart", "subsampled", "cmyk", "ycck"])
def test_lossless_colour(tmp_path, case):
    """Lossless SOF3 with three and four components: RGB (Adobe transform
    0 or R, G, B ids), ids 1, 2, 3 (libjpeg-turbo converts no colour in
    lossless mode: the planes as stored), a restart interval of one MCU
    row, 2 x 1 subsampled chroma, and CMYK under Adobe transform 0 (under
    2, YCCK, PIL fails)."""
    rng = np.random.default_rng(len(case))
    kw, shapes = {}, [(H, W)] * 3
    if case in ("cmyk", "ycck"):
        kw["adobe"] = 0 if case == "cmyk" else 2
        p = tmp_path / "x.jpg"
        p.write_bytes(lossless_jpeg(_planes(rng, 4, [(H, W)] * 4), psv=4,
                                    **kw))
        if case == "ycck":
            # PIL asks libjpeg-turbo for CMYK, which it cannot convert to
            # in lossless mode: PIL fails
            assert jread(str(p), "", gamma=1.0) is None
            with pytest.raises(ValueError, match="lossless YCCK"):
                tio.read_image(str(p), device="cpu")
            return
        _same(p)
        return
    if case == "rgb_adobe0":
        kw["adobe"] = 0
    elif case in ("rgb_ids", "restart"):
        kw["ids"] = [ord("R"), ord("G"), ord("B")]
        if case == "restart":
            kw["restart"] = W
    elif case == "subsampled":
        kw.update(adobe=0, sampling=[(2, 1), (1, 1), (1, 1)])
        shapes = [(H, 2 * 19), (H, 19), (H, 19)]
    p = tmp_path / "x.jpg"
    p.write_bytes(lossless_jpeg(_planes(rng, 3, shapes), psv=1 + len(case)
                                % 7, **kw))
    _same(p)


def _baseline(tmp_path):
    rng = np.random.default_rng(8)
    blocks, q = component_blocks(rng, W, H, SAMPLINGS["420"])
    return huffman_jpeg(W, H, SAMPLINGS["420"], blocks, q), blocks, q


@pytest.mark.parametrize("case", ["12bit", "hierarchical", "dnl",
                                  "two_components", "fractional",
                                  "arith_truncated"])
def test_variants_pil_fails_on_are_missing_textures(tmp_path, case, caplog):
    """A variant this PIL fails on: hairpt's _read_texture_image gives
    None, read_image raises ValueError, and the port's loader gives a
    missing texture with one warning naming the file; hairpt's envmap
    raises, and so does the port's loader."""
    data, blocks, q = _baseline(tmp_path)
    sof = data.index(b"\xff\xc0")
    if case == "12bit":
        b = bytearray(data)
        b[sof + 4] = 12
        data = bytes(b)
    elif case == "hierarchical":
        data = data[:sof + 1] + b"\xc5" + data[sof + 2:]
    elif case == "dnl":
        data = huffman_jpeg(W, H, SAMPLINGS["420"], blocks, q, dnl=True)
    elif case == "two_components":
        rng = np.random.default_rng(1)
        samp = [(1, 1), (1, 1)]
        bl, q2 = component_blocks(rng, W, H, samp)
        data = huffman_jpeg(W, H, samp, bl, q2)
    elif case == "fractional":
        rng = np.random.default_rng(2)
        samp = [(3, 1), (2, 1), (1, 1)]
        bl, q2 = component_blocks(rng, W, H, samp)
        data = huffman_jpeg(W, H, samp, bl, q2)
    else:
        data = arith_jpeg(W, H, SAMPLINGS["420"], blocks, q)
        data = data[:len(data) // 3]
    p = tmp_path / "x.jpg"
    p.write_bytes(data)
    assert jread(str(p), "", gamma=1.0) is None
    tio.probe_image(str(p))
    with pytest.raises(ValueError):
        tio.read_image(str(p), device="cpu")
    caplog.set_level(logging.WARNING)
    assert txl._read_texture_image(str(p), str(tmp_path), device="cpu") \
        is None
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 1 and "x.jpg" in warned[0].getMessage()
    with pytest.raises(ValueError):
        txl._read_env_image(str(p), "cpu")


def test_arith_lossless_is_refused_naming_the_item(tmp_path):
    """Arithmetic-coded lossless (SOF11) is not ported: probe_image and
    read_image raise NotImplementedError naming ROADMAP item 13."""
    data, _, _ = _baseline(tmp_path)
    sof = data.index(b"\xff\xc0")
    p = tmp_path / "x.jpg"
    p.write_bytes(data[:sof + 1] + b"\xcb" + data[sof + 2:])
    for read in (tio.probe_image,
                 lambda q: tio.read_image(q, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            read(str(p))


def test_block_stage_sides_agree():
    """decode on a given device returns the same pixels through the
    integer block stage; here both sides are the CPU's (the card's run is
    chip_smoke phase 23b)."""
    rng = np.random.default_rng(12)
    blocks, q = component_blocks(rng, W, H, SAMPLINGS["411"])
    data = arith_jpeg(W, H, SAMPLINGS["411"], blocks, q, progressive=True)
    a = tjpeg.decode(data, "cpu").numpy()
    b = tjpeg.decode(data, "cpu").numpy()
    assert a.shape == (H, W, 3) and (a == b).all()


def test_mpo_first_frame(tmp_path):
    """An MPO (two JPEGs and the MP index, as PIL saves it): PIL opens its
    first frame, and the port, which finds a JPEG by its content, reads
    the same frame."""
    rng = np.random.default_rng(30)
    frames = [Image.fromarray(rng.integers(0, 256, (24, 30, 3),
                                           dtype=np.uint8)) for _ in range(2)]
    p = tmp_path / "x.mpo"
    frames[0].save(p, save_all=True, append_images=frames[1:])
    assert Image.open(p).format == "MPO"
    _same(p)
