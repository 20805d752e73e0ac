"""The port's JPEG codec (hairpt_torch/utils/jpeg.py) against PIL, which
the JAX package codes its JPEGs through, on the CPU.

Decoder: PIL's JPEGs of seeded images at sizes that are and are not
whole MCUs, in 4:4:4, 4:2:2, 4:2:0 and gray, at quality 50, 75 and 95,
progressive and with restart intervals, read by the port's
io.read_image and by hairpt's read_image. Both run libjpeg's integer
arithmetic, so the tolerance is the acceptance bound: equal on at least
99.9% of the channel values and within 2 levels on all (on this
machine's Pillow they are equal on all). Truncated files raise
ValueError; arithmetic-coded, CMYK, 12-bit and 4:1:1 files raise
NotImplementedError.

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


def test_decoder_refuses_what_it_does_not_decode(tmp_path):
    """A truncated file raises ValueError. Valid files the port does not
    decode (arithmetic-coded, CMYK, 12-bit, 4:1:1) raise
    NotImplementedError naming what they are and ROADMAP item 13, from
    decode and from the header probe alike; the probe passes a baseline
    file and leaves a truncated one to decode."""
    b = io.BytesIO()
    Image.fromarray(_image(40, 40, 1)).save(b, "JPEG", quality=90)
    data = b.getvalue()
    tjpeg.probe(data)
    for cut in (len(data) // 2, len(data) - 2, 30):
        tjpeg.probe(data[:cut])
        with pytest.raises(ValueError, match="truncated"):
            tjpeg.decode(data[:cut], "cpu")
    sof = data.index(b"\xff\xc0")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    h411 = bytearray(data)
    h411[sof + 11] = 0x41
    b = io.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(b, "JPEG")
    unported = {
        "arithmetic": data[:sof + 1] + b"\xc9" + data[sof + 2:],
        "CMYK": b.getvalue(), "12-bit": bytes(twelve),
        "sampling factors": bytes(h411)}
    for what, bad in unported.items():
        for read in (tjpeg.probe, lambda d: tjpeg.decode(d, "cpu")):
            with pytest.raises(NotImplementedError,
                               match=f"{what}.*ROADMAP item 13"):
                read(bad)


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
