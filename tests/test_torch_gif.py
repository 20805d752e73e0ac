"""The port's GIF reader (hairpt_torch/utils/gif.py) against hairpt's
_read_texture_image (PIL's Image.open(...).convert("RGB") / 255), on the
CPU: files PIL writes (palette, gray, RGB quantized, interlaced or not,
transparent, animated, large enough to fill the LZW table) and files
built here with a test-side LZW encoder where PIL does not write them
(GIF87a, a local colour table, a frame offset inside the logical screen
and one reaching past it, a transparent index, no colour table, a short
palette, small code sizes). PIL decodes each built file itself, which
checks the test's writer. The tolerance is none."""
import struct

import numpy as np
import pytest
from PIL import Image

from hairpt.scene.xml_loader import _read_texture_image as jread
from hairpt_torch.utils import io as tio
from torch_threads import one_thread  # noqa: F401

RNG = np.random.default_rng(11)


def _same(path):
    want = jread(str(path), "", gamma=1.0)
    assert want is not None, "PIL cannot read the file"
    got = tio.read_image(str(path), device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def lzw_encode(idx: bytes, min_size: int) -> bytes:
    """GIF LZW, codes least significant bit first, a Clear first and
    before the table fills, End last."""
    clear, out = 1 << min_size, bytearray()
    acc = nacc = 0
    size = min_size + 1

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        nonlocal size
        emit(clear)
        size = min_size + 1
        return {bytes([i]): i for i in range(clear)}, clear + 2, True

    table, dec_len, first = reset()

    def sent():
        nonlocal dec_len, first, size
        if not first:
            dec_len += 1
        first = False
        if dec_len == (1 << size) and size < 12:
            size += 1

    w = b""
    for c in idx:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        sent()
        table[wc] = len(table) + 2
        w = bytes([c])
        if len(table) + 2 >= 4094:
            emit(table[w])
            table, dec_len, first = reset()
            w = b""
    if w:
        emit(table[w])
        sent()
    emit(clear + 1)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(b: bytes) -> bytes:
    return b"".join(bytes([len(b[i:i + 255])]) + b[i:i + 255]
                    for i in range(0, len(b), 255)) + b"\0"


def _gif(path, idx, screen, pos=(0, 0), gpal=None, lpal=None, trans=None,
         interlace=False, version=b"GIF89a", min_size=8, frames=1):
    """A GIF of palette indices idx [h, w] at pos on the logical screen
    (w, h) with the given tables (arrays [n, 3], n a power of two)."""
    h, w = idx.shape

    def table_bits(p):
        return int(np.log2(len(p))) - 1

    out = bytearray(version + struct.pack("<HH", *screen))
    flags = 0
    if gpal is not None:
        flags = 0x80 | 0x70 | table_bits(gpal)
    out += bytes([flags, 0, 0])
    if gpal is not None:
        out += np.asarray(gpal, np.uint8).tobytes()
    for k in range(frames):
        if trans is not None:
            out += b"\x21\xf9\x04" + bytes([1]) + b"\0\0" + bytes([trans]) \
                + b"\0"
        fl = 0x40 if interlace else 0
        if lpal is not None:
            fl |= 0x80 | table_bits(lpal)
        out += b"," + struct.pack("<HHHHB", *pos, w, h, fl)
        if lpal is not None:
            out += np.asarray(lpal, np.uint8).tobytes()
        rows = np.arange(h)
        if interlace:
            rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4],
                                   rows[1::2]])
        src = idx[rows] if k == 0 else (idx[rows] + 1) % (1 << min_size)
        out += bytes([min_size]) + _sub_blocks(
            lzw_encode(src.astype(np.uint8).tobytes(), min_size))
    out += b";"
    with open(path, "wb") as f:
        f.write(bytes(out))


PAL = RNG.integers(0, 256, (256, 3), dtype=np.uint8)


@pytest.mark.parametrize("case", [
    "plain", "gif87a", "local_table", "offset", "past_screen", "transparent",
    "transparent_offset", "no_table", "gray_ramp", "short_table",
    "code_size_2", "interlaced", "interlaced_odd", "animated",
    "long_stream", "index_past_table"])
def test_built_gifs(tmp_path, case):
    p = tmp_path / "x.gif"
    idx = RNG.integers(0, 256, (13, 21))
    kw = dict(screen=(21, 13), gpal=PAL)
    if case == "gif87a":
        kw["version"] = b"GIF87a"
    elif case == "local_table":
        kw["lpal"] = PAL[::-1]
    elif case == "offset":
        kw.update(screen=(30, 20), pos=(5, 4))
    elif case == "past_screen":
        kw.update(screen=(10, 8), pos=(3, 2))
    elif case == "transparent":
        kw["trans"] = 17
    elif case == "transparent_offset":
        kw.update(screen=(30, 20), pos=(6, 3), trans=200)
    elif case == "no_table":
        kw["gpal"] = None
    elif case == "gray_ramp":
        kw["gpal"] = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    elif case == "short_table":
        idx = RNG.integers(0, 16, (13, 21))
        kw["gpal"] = PAL[:16]
    elif case == "code_size_2":
        idx = RNG.integers(0, 4, (13, 21))
        kw.update(gpal=PAL[:4], min_size=2)
    elif case in ("interlaced", "interlaced_odd"):
        kw["interlace"] = True
        if case == "interlaced_odd":
            idx = RNG.integers(0, 256, (11, 9))
            kw["screen"] = (9, 11)
    elif case == "animated":
        kw["frames"] = 3
    elif case == "long_stream":
        idx = RNG.integers(0, 256, (90, 100))
        kw["screen"] = (100, 90)
    elif case == "index_past_table":
        kw["gpal"] = PAL[:32]
    _gif(p, idx, **kw)
    _same(p)


@pytest.mark.parametrize("mode", ["P", "L", "RGB", "RGBA", "1", "P_trans",
                                  "big", "animated"])
@pytest.mark.parametrize("interlace", [True, False])
def test_pil_writes(tmp_path, mode, interlace):
    """GIFs as PIL writes them (its LZW encoder keeps the table full until
    a Clear in the big random image)."""
    p = tmp_path / "x.gif"
    a = RNG.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    if mode == "big":
        im = Image.fromarray(RNG.integers(0, 256, (200, 180),
                                          dtype=np.uint8), "L")
    elif mode == "P_trans":
        im = Image.fromarray(a[..., :3]).quantize(64)
        im.info["transparency"] = 5
    elif mode == "animated":
        frames = [Image.fromarray(a[..., :3] // (k + 1)) for k in range(3)]
        frames[0].save(p, save_all=True, append_images=frames[1:],
                       interlace=interlace)
        _same(p)
        return
    elif mode == "P":
        im = Image.fromarray(a[..., :3]).quantize(200)
    else:
        im = Image.fromarray(a).convert(mode)
    im.save(p, interlace=interlace)
    _same(p)


@pytest.mark.parametrize("cut", [20, 60, -3])
def test_truncated_gif_is_a_value_error(tmp_path, cut):
    """A GIF cut inside its image data: PIL fails (hairpt's texture is
    missing) and the port raises ValueError."""
    p = tmp_path / "x.gif"
    Image.fromarray(RNG.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                    ).save(p)
    data = p.read_bytes()
    p.write_bytes(data[:cut] if cut > 0 else data[:cut - 40])
    assert jread(str(p), "", gamma=1.0) is None
    with pytest.raises(ValueError):
        tio.read_image(str(p), device="cpu")


def test_apng_default_image(tmp_path):
    """An animated PNG (.apng, as PIL saves it): PIL opens frame 0, the
    default image, which the port's PNG reader reads from the IDAT."""
    frames = [Image.fromarray(RNG.integers(0, 256, (20, 24, 3),
                                           dtype=np.uint8)) for _ in range(3)]
    p = tmp_path / "x.apng"
    frames[0].save(p, save_all=True, append_images=frames[1:])
    _same(p)
