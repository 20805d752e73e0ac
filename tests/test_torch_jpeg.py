"""The port's JPEG codec (hairpt_torch/utils/jpeg.py) against PIL, which
the JAX package codes its JPEGs through, on the CPU.

Decoder: PIL's JPEGs of seeded images at sizes that are and are not
whole MCUs, in 4:4:4, 4:2:2, 4:2:0 and gray, at quality 50, 75 and 95,
progressive and with restart intervals, read by the port's
io.read_image and by hairpt's read_image. Both run libjpeg's integer
arithmetic, so the tolerance is the acceptance bound: equal on at least
99.9% of the channel values and within 2 levels on all (on this
machine's Pillow they are equal on all). Truncated files, and the
variants PIL fails on (12-bit, hierarchical), raise ValueError, which
the loader turns into a missing texture with a warning; arithmetic-coded,
CMYK and 4:1:1 files decode (tests/test_torch_jpeg_variants.py), and
so does data that ends at a marker before its MCUs do, as libjpeg
decodes it, but for a progressive file whose later scans are gone.

Encoder: PIL opens the port's files with its own quantization tables
and sampling at the same quality; PIL's decode of the port's file is
within 2 levels of its decode of hairpt's write_jpg file on every value
and equal on at least 99%; the port's decode of its own file equals
PIL's."""
import io

import numpy as np
import pytest
import torch
from PIL import Image, JpegImagePlugin

from hairpt.utils import io as jio
from hairpt_torch.utils import io as tio
from hairpt_torch.utils import jpeg as tjpeg
from torch_threads import one_thread  # noqa: F401

SIZES = [(48, 64), (45, 67), (1, 1), (300, 8)]
VARIANTS = {
    "444_q95": ("RGB", dict(quality=95, subsampling=0)),
    "422_q75": ("RGB", dict(quality=75, subsampling=1)),
    "420_q50": ("RGB", dict(quality=50, subsampling=2)),
    "420_q95": ("RGB", dict(quality=95)),
    "gray_q75": ("L", dict(quality=75)),
    "progressive": ("RGB", dict(quality=90, progressive=True)),
    "progressive_gray": ("L", dict(quality=60, progressive=True)),
    "restart": ("RGB", dict(quality=85, restart_marker_blocks=3)),
    "progressive_restart": ("RGB", dict(quality=80, progressive=True,
                                        restart_marker_rows=1,
                                        subsampling=1)),
}


def _image(h, w, seed):
    """A smooth pattern with noise: every DCT band carries energy."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255) \
        .astype(np.uint8)


def _levels_close(got, want, exact_share):
    d = np.abs(np.round(got * 255).astype(int)
               - np.round(want * 255).astype(int))
    assert got.shape == want.shape
    assert d.max() <= 2, d.max()
    assert (d == 0).mean() >= exact_share, (d == 0).mean()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decoder_matches_hairpt(tmp_path, size, variant):
    mode, kw = VARIANTS[variant]
    a = _image(*size, seed=size[0] * 7 + size[1])
    src = Image.fromarray(a if mode == "RGB" else a[..., 0])
    p = str(tmp_path / "x.jpg")
    src.save(p, **kw)
    got = tio.read_image(p, device="cpu")
    want = jio.read_image(p)
    assert got.dtype == np.float32
    _levels_close(got, want, 0.999)


def test_decoder_refuses_what_it_does_not_decode(tmp_path, caplog):
    """A variant PIL fails on is a missing texture, with the warning: a
    truncated file, a 12-bit and a hierarchical frame raise ValueError
    from decode (the header probe passes them, leaving them to decode),
    hairpt's _read_texture_image gives None, and so does the port's
    loader, with one warning naming the file. The variants an earlier
    slice refused here and PIL reads (arithmetic-coded, CMYK, 4:1:1)
    decode to PIL's pixels."""
    import logging
    from hairpt.scene.xml_loader import _read_texture_image as jread
    from hairpt_torch.scene import xml_loader as txl
    b = io.BytesIO()
    Image.fromarray(_image(40, 40, 1)).save(b, "JPEG", quality=90)
    data = b.getvalue()
    tjpeg.probe(data)
    sof = data.index(b"\xff\xc0")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    # each file with what its ValueError says
    fails = {f"cut{c}": (data[:c], "truncated")
             for c in (len(data) // 2, len(data) - 2, 30)}
    fails["12-bit"] = (bytes(twelve), "12-bit")
    fails["hierarchical"] = (data[:sof + 1] + b"\xc5" + data[sof + 2:],
                             "hierarchical")
    caplog.set_level(logging.WARNING)
    for what, (bad, says) in fails.items():
        tjpeg.probe(bad)
        with pytest.raises(ValueError, match=says):
            tjpeg.decode(bad, "cpu")
        p = tmp_path / f"{what}.jpg"
        p.write_bytes(bad)
        assert jread(str(p), "", gamma=1.0) is None
        caplog.clear()
        assert txl._read_texture_image(str(p), "", device="cpu") is None
        msgs = [r.getMessage() for r in caplog.records
                if r.levelno == logging.WARNING]
        assert len(msgs) == 1 and f"{what}.jpg" in msgs[0]
    b = io.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(b, "JPEG")
    from torch_jpeg_enc import arith_jpeg, component_blocks, huffman_jpeg
    samp = [(2, 2), (1, 1), (1, 1)]
    blocks, q = component_blocks(np.random.default_rng(2), 40, 40, samp)
    s411 = [(4, 1), (1, 1), (1, 1)]
    b411, q411 = component_blocks(np.random.default_rng(3), 40, 40, s411)
    # a baseline file whose header claims 4:1:1 sampling: libjpeg decodes
    # it with a warning (its data ends before the MCUs the header asks
    # for), and so does the port
    h411 = bytearray(data)
    h411[sof + 11] = 0x41
    read = {"arithmetic": arith_jpeg(40, 40, samp, blocks, q),
            "CMYK": b.getvalue(),
            "4:1:1": huffman_jpeg(40, 40, s411, b411, q411),
            "header 4:1:1": bytes(h411)}
    for what, good in read.items():
        p = tmp_path / f"{what.replace(':', '').replace(' ', '_')}.jpg"
        p.write_bytes(good)
        want = jread(str(p), "", gamma=1.0)
        assert want is not None
        np.testing.assert_array_equal(
            tio.read_image(str(p), device="cpu"), want)


def _scan_end(data, k):
    """The offset just past the k-th (0-based) SOS marker's header."""
    i = -1
    for _ in range(k + 1):
        i = data.index(b"\xff\xda", i + 1)
    return i + 2 + int.from_bytes(data[i + 2:i + 4], "big")


def _short(kind):
    """A JPEG whose entropy-coded data ends at a marker before its MCUs
    do, with the markers that follow intact or cut to EOI: Huffman
    baseline, restart intervals and progressive files from PIL;
    arithmetic-coded and lossless ones from the tests' writers."""
    from torch_jpeg_enc import arith_jpeg, component_blocks, lossless_jpeg
    if kind.startswith(("arith", "lossless")):
        if kind.startswith("arith"):
            samp = [(2, 2), (1, 1), (1, 1)]
            blocks, q = component_blocks(np.random.default_rng(2), 48, 64,
                                         samp)
            d = arith_jpeg(48, 64, samp, blocks, q, restart=2)
        else:
            y, x = np.mgrid[0:40, 0:50]
            d = lossless_jpeg([((x * 3 + y * 2 + 40 * k) % 256)
                               .astype(np.uint8) for k in range(3)], psv=4,
                              adobe=0, restart=50)
        r = d.index(b"\xff\xd1")
        # four bytes short of the second restart marker, then that marker
        # and the rest, or EOI
        return d[:r - 4] + (d[r:] if kind.endswith("interval") else
                            b"\xff\xd9")
    b = io.BytesIO()
    save = dict(progressive=True) if kind.startswith("prog") else \
        dict(restart_marker_blocks=4) if kind.startswith("rst") else {}
    Image.fromarray(_image(64, 48, 1)).save(b, "JPEG", quality=90, **save)
    d = b.getvalue()
    if kind.startswith("prog"):
        s = _scan_end(d, 1)
        e = d.index(b"\xff", s)
        while d[e + 1] == 0:
            e = d.index(b"\xff", e + 1)
        # half of the second scan's data, then the later scans or EOI
        return d[:s + (e - s) // 2] + (d[e:] if kind == "prog_scan"
                                       else b"\xff\xd9")
    s = _scan_end(d, 0)
    if kind.startswith("rst"):
        r = d.index(b"\xff\xd1", s)
        # five bytes short of the second restart marker, then that marker
        # and the rest, or EOI
        return d[:r - 5] + (d[r:] if kind == "rst_interval" else
                            b"\xff\xd9")
    return d[:s + (len(d) - s) * 6 // 10] + b"\xff\xd9"


@pytest.mark.parametrize("kind", ["baseline_eoi", "rst_interval", "rst_eoi",
                                  "prog_scan", "prog_eoi", "arith_interval",
                                  "arith_eoi", "lossless_interval",
                                  "lossless_eoi"])
def test_short_entropy_data_decodes_as_libjpeg(tmp_path, kind):
    """Data that ends at a marker before its MCUs do: libjpeg warns, reads
    zero bits for the MCU that runs out and leaves the interval's later
    MCUs as they were (a scan cut to EOI: its later intervals empty; an
    arithmetic decoder reads zeros on; a lossless scan restarts its
    prediction on the MCU rows after the one that ran out), so PIL gives
    an image and so does the port, equal. A progressive file
    whose later scans are gone is smoothed by libjpeg (its block
    smoothing, not ported): NotImplementedError naming ROADMAP item 13,
    from the header probe and from decode."""
    data = _short(kind)
    p = tmp_path / f"{kind}.jpg"
    p.write_bytes(data)
    want = np.asarray(Image.open(p).convert("RGB"))
    assert want.shape[2] == 3 and want.std() > 0
    if kind == "prog_eoi":
        for read in (tjpeg.probe, lambda d: tjpeg.decode(d, "cpu")):
            with pytest.raises(NotImplementedError,
                               match="block smoothing.*ROADMAP item 13"):
                read(data)
        return
    tjpeg.probe(data)
    np.testing.assert_array_equal(tjpeg.decode(data, "cpu").numpy(), want)


@pytest.mark.parametrize("quality", [95, 75])
@pytest.mark.parametrize("size", [(48, 64), (45, 67), (1, 1), (17, 300)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_matches_pil(tmp_path, quality, size):
    a = _image(*size, seed=quality + size[1])
    mine, ref = str(tmp_path / "t.jpg"), str(tmp_path / "j.jpg")
    tio.write_jpg(mine, a.astype(np.float32) / 255.0, quality=quality,
                  device="cpu")
    jio.write_jpg(ref, a.astype(np.float32) / 255.0, quality=quality)
    im_t, im_j = Image.open(mine), Image.open(ref)
    assert im_t.format == "JPEG" and im_t.size == (size[1], size[0])
    assert im_t.quantization == im_j.quantization
    assert JpegImagePlugin.get_sampling(im_t) \
        == JpegImagePlugin.get_sampling(im_j) == 2
    pil_t = np.asarray(im_t.convert("RGB"), np.float32) / 255.0
    pil_j = np.asarray(im_j.convert("RGB"), np.float32) / 255.0
    _levels_close(pil_t, pil_j, 0.99)
    own = tjpeg.read_jpeg(mine, "cpu").numpy()
    np.testing.assert_array_equal(own, np.asarray(im_t.convert("RGB")))


def test_encoder_takes_uint8_and_float(tmp_path):
    """write_jpg takes uint8 as well as the float image it rounds (the
    JAX package's rounding), and encode the uint8 tensor: the same
    bytes."""
    a = _image(20, 30, 5)
    p1, p2 = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    tio.write_jpg(p1, a, device="cpu")
    tio.write_jpg(p2, a.astype(np.float32) / 255.0, device="cpu")
    data = open(p1, "rb").read()
    assert data == open(p2, "rb").read()
    assert data == tjpeg.encode(torch.as_tensor(a), 95)


def test_vertical_upsampling_is_the_transposed_horizontal():
    """4:4:0 (PIL writes none): jdsample.c's h1v2 triangle filter is its
    h2v1 filter down the columns, which the 4:2:2 files above hold to
    PIL; a plane 2 samples wide or less takes box replication across,
    the triangle filter down."""
    p = torch.as_tensor(np.random.default_rng(8).integers(0, 256, (7, 5)))
    np.testing.assert_array_equal(tjpeg.upsample(p, 1, 2).numpy(),
                                  tjpeg.upsample(p.T, 2, 1).T.numpy())
    narrow = p[:, :2]
    assert torch.equal(tjpeg.upsample(narrow, 2, 1),
                       narrow.repeat_interleave(2, 1))
    assert tjpeg.upsample(narrow, 1, 2).shape == (14, 2)
