"""The port's WebP reader (hairpt_torch/utils/webp.py) against hairpt's
_read_texture_image (PIL's Image.open(...).convert("RGB") / 255, through
libwebp), on the CPU, bit for bit: lossless VP8L files PIL writes (every
quality and method, palettes of 2 to 256 colours, alpha, sizes down to
1 x 1), lossy VP8 files (quality 1 to 100, methods 0 to 6, odd sizes,
alpha in an ALPH chunk), animations (frame 0), and files rebuilt here
from PIL's: a first frame at an offset on a larger canvas, and VP8 key
frames whose first partition is re-encoded (a test-side boolean
encoder) with the simple loop filter, other sharpness levels and filter
levels 0 and 63. PIL decodes each rebuilt file, which checks the
rebuilding."""
import io
import struct

import numpy as np
import pytest
from PIL import Image

from hairpt.scene.xml_loader import _read_texture_image as jread
from hairpt_torch.utils import io as tio
from hairpt_torch.utils import webp as twebp
from torch_threads import one_thread  # noqa: F401

RNG = np.random.default_rng(17)


def _same(path):
    want = jread(str(path), "", gamma=1.0)
    assert want is not None, "PIL cannot read the file"
    got = tio.read_image(str(path), device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _image(h, w, kind="photo", seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "photo":
        base = np.stack([128 + 70 * np.sin(x / 6 + y / 9),
                         128 + 60 * np.cos(x / 5 - y / 7),
                         128 + 50 * np.sin((x + y) / 8)], -1)
        return np.clip(base + rng.normal(0, 12, base.shape), 0,
                       255).astype(np.uint8)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    n = int(kind.split("_")[1])
    pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return pal[(x // 3 + y // 2 + rng.integers(0, 2, (h, w))) % n]


LOSSLESS = [("photo", 37, 45, {}), ("photo", 37, 45, {"quality": 0}),
            ("photo", 37, 45, {"method": 0}), ("photo", 64, 64,
                                               {"method": 6}),
            ("noise", 20, 30, {}), ("pal_2", 33, 41, {}),
            ("pal_3", 17, 9, {}), ("pal_4", 24, 31, {}),
            ("pal_13", 40, 40, {}), ("pal_16", 19, 50, {}),
            ("pal_200", 45, 37, {}), ("photo", 1, 1, {}),
            ("photo", 2, 3, {}), ("photo", 1, 77, {}), ("photo", 90, 1, {}),
            ("photo", 129, 100, {"quality": 100, "method": 5})]


@pytest.mark.parametrize("case", range(len(LOSSLESS)))
def test_lossless(tmp_path, case):
    kind, h, w, kw = LOSSLESS[case]
    p = tmp_path / "x.webp"
    Image.fromarray(_image(h, w, kind, case)).save(p, lossless=True, **kw)
    _same(p)


@pytest.mark.parametrize("exact", [False, True])
def test_lossless_alpha(tmp_path, exact):
    """VP8L with alpha (an alpha ramp and transparent pixels whose colour
    libwebp keeps only with exact)."""
    a = _image(31, 29, "photo", 3)
    alpha = np.tile(np.arange(29, dtype=np.uint8) * 8, (31, 1))
    alpha[5:9] = 0
    p = tmp_path / "x.webp"
    Image.fromarray(np.dstack([a, alpha]), "RGBA").save(
        p, lossless=True, exact=exact)
    _same(p)


LOSSY = [(37, 45, {"quality": 80}), (37, 45, {"quality": 1}),
         (37, 45, {"quality": 30}), (37, 45, {"quality": 100}),
         (64, 48, {"quality": 75, "method": 0}),
         (64, 48, {"quality": 75, "method": 6}),
         (1, 1, {}), (7, 5, {}), (16, 16, {}), (17, 33, {}),
         (100, 61, {"quality": 50}), (48, 160, {"quality": 90})]


@pytest.mark.parametrize("kind", ["photo", "noise", "pal_4"])
@pytest.mark.parametrize("case", range(len(LOSSY)))
def test_lossy(tmp_path, case, kind):
    h, w, kw = LOSSY[case]
    p = tmp_path / "x.webp"
    Image.fromarray(_image(h, w, kind, case)).save(p, **kw)
    _same(p)


@pytest.mark.parametrize("quality", [20, 90])
def test_lossy_alpha(tmp_path, quality):
    """Lossy colour with an ALPH chunk (dropped by convert("RGB"))."""
    a = _image(40, 33, "photo", 5)
    alpha = np.tile(np.arange(33, dtype=np.uint8) * 7, (40, 1))
    p = tmp_path / "x.webp"
    Image.fromarray(np.dstack([a, alpha]), "RGBA").save(
        p, quality=quality, alpha_quality=50)
    _same(p)


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_first_frame(tmp_path, lossless):
    frames = [Image.fromarray(_image(30, 40, "photo", k)) for k in range(3)]
    p = tmp_path / "x.webp"
    frames[0].save(p, save_all=True, append_images=frames[1:],
                   lossless=lossless, duration=50)
    _same(p)


def _chunk(tag, body):
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _bitstream(data: bytes):
    return next((t, b) for t, b in twebp._chunks(data, 12, len(data))
                if t in (b"VP8 ", b"VP8L"))


@pytest.mark.parametrize("lossless", [False, True])
def test_first_frame_at_an_offset(tmp_path, lossless):
    """A VP8X canvas with ANIM and one ANMF at (6, 4): WebPAnimDecoder
    draws it on a canvas of zeros."""
    b = io.BytesIO()
    Image.fromarray(_image(20, 24, "photo", 9)).save(b, "WEBP",
                                                     lossless=lossless)
    tag, bits = _bitstream(b.getvalue())
    cw, ch = 40, 30

    def u24(v):
        return struct.pack("<I", v)[:3]
    vp8x = _chunk(b"VP8X", bytes([0x02, 0, 0, 0]) + u24(cw - 1) + u24(ch - 1))
    anim = _chunk(b"ANIM", b"\0\0\0\0\0\0")
    anmf = _chunk(b"ANMF", u24(3) + u24(2) + u24(23) + u24(19) + u24(100)
                  + bytes([0]) + _chunk(tag, bits))
    body = b"WEBP" + vp8x + anim + anmf
    p = tmp_path / "x.webp"
    p.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    _same(p)


class _BoolEncoder:
    """RFC 6386's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def write(self, prob, bit):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def flush(self):
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _refilter(body: bytes, simple=None, level=None, sharpness=None):
    """The VP8 key frame with its first partition re-encoded after the
    filter header's fields are replaced."""
    part0 = (body[0] | (body[1] << 8) | (body[2] << 16)) >> 5
    calls = []
    orig = twebp._Bool.bit

    def rec(self, prob):
        b = orig(self, prob)
        if self.end == 10 + part0:
            calls.append([prob, b])
        return b
    twebp._Bool.bit = rec
    try:
        hd = twebp._Header(body)
        twebp._modes(hd, (hd.w + 15) >> 4, (hd.h + 15) >> 4)
    finally:
        twebp._Bool.bit = orig
    # the filter header's position: after colour space, clamping and the
    # segment header
    i = 2
    use_seg = calls[i][1]
    i += 1
    if use_seg:
        upd_map, upd_data = calls[i][1], calls[i + 1][1]
        i += 2
        if upd_data:
            i += 1
            for nbits in (7,) * 4 + (6,) * 4:
                flag = calls[i][1]
                i += 1 + (nbits + 1 if flag else 0)
        if upd_map:
            for _ in range(3):
                flag = calls[i][1]
                i += 1 + (8 if flag else 0)
    fields = {i: simple}
    for k in range(6):
        fields[i + 1 + k] = None if level is None else (level >> (5 - k)) & 1
    for k in range(3):
        fields[i + 7 + k] = None if sharpness is None else \
            (sharpness >> (2 - k)) & 1
    enc = _BoolEncoder()
    for j, (prob, b) in enumerate(calls):
        v = fields.get(j)
        enc.write(prob, b if v is None else v)
    p0 = enc.flush()
    tag = (len(p0) << 5) | (body[0] & 0x1F)
    return struct.pack("<I", tag)[:3] + body[3:10] + p0 + body[10 + part0:]


@pytest.mark.parametrize("change", ["simple", "simple_sharp5", "sharp2",
                                    "sharp7", "level0", "level63",
                                    "simple_level63"])
def test_loop_filter_variants(tmp_path, change):
    kw = {"simple": dict(simple=1), "simple_sharp5": dict(simple=1,
                                                          sharpness=5),
          "sharp2": dict(sharpness=2), "sharp7": dict(sharpness=7),
          "level0": dict(level=0), "level63": dict(level=63),
          "simple_level63": dict(simple=1, level=63)}[change]
    b = io.BytesIO()
    Image.fromarray(_image(50, 70, "photo", 2)).save(b, "WEBP", quality=40)
    tag, bits = _bitstream(b.getvalue())
    body = b"WEBP" + _chunk(b"VP8 ", _refilter(bits, **kw))
    p = tmp_path / "x.webp"
    p.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    _same(p)


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("cut", [0.3, 0.9])
def test_truncated_webp_is_a_value_error(tmp_path, lossless, cut):
    """A WebP cut short: PIL fails (hairpt's texture is missing) and the
    port raises ValueError."""
    p = tmp_path / "x.webp"
    Image.fromarray(_image(40, 40, "photo", 1)).save(p, lossless=lossless)
    data = p.read_bytes()
    p.write_bytes(data[:int(len(data) * cut)])
    assert jread(str(p), "", gamma=1.0) is None
    with pytest.raises(ValueError):
        tio.read_image(str(p), device="cpu")
