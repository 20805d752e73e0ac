"""The port's TIFF reader and writer (hairpt_torch/utils/tiff.py) against
hairpt's _read_texture_image (PIL's Image.open(...).convert("RGB") / 255),
on the CPU: files PIL writes (each mode, each compression it writes
through libtiff, JPEG included) and files built here with struct, zlib
and a test-side LZW encoder where PIL does not write them (both byte
orders, tiles, planar samples, predictors 2 and 3, fill order 2, every
bit depth and photometric of Pillow's table). PIL decodes each built file
itself, which checks the test's writer. The tolerance is none: the two float
images are equal value for value. write_tiff is held to PIL's bytes."""
import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from hairpt.scene.xml_loader import _read_texture_image as jread
from hairpt_torch.utils import io as tio
from hairpt_torch.utils import tiff as ttiff
from test_torch_ldr_textures import same_bvh  # noqa: F401
from torch_threads import one_thread  # noqa: F401

H, W = 13, 20
RNG = np.random.default_rng(7)


def _same(path):
    want = jread(str(path), "", gamma=1.0)
    assert want is not None, "PIL cannot read the file"
    got = tio.read_image(str(path), device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, the width growing one code early, Clear
    first and before the table fills, EOI last)."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def emit(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def reset():
        nonlocal nbits
        emit(256)
        nbits = 9
        return {bytes([i]): i for i in range(256)}, 258, True

    table, dec_len, first = reset()
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        if not first:
            dec_len += 1
        first = False
        if dec_len + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
        table[wc] = len(table) + 2
        w = bytes([c])
        if len(table) + 2 >= 4093:
            emit(table[w])
            table, dec_len, first = reset()
            w = b""
    if w:
        emit(table[w])
        if not first:
            dec_len += 1
        if dec_len + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
    emit(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
        else:
            k = i
            while k < len(data) and k - i < 128 and (
                    k + 1 >= len(data) or data[k + 1] != data[k]):
                k += 1
            k = max(k, i + 1)
            out += bytes([k - i - 1]) + data[i:k]
            i = k
    return bytes(out)


def _rows_bytes(s, bps, bo, sf):
    """Samples [rows, cols, n] -> row-padded bytes [rows, stride]."""
    r = s.shape[0]
    if bps in (8, 16, 32):
        dt = {8: "u1", 16: "u2", 32: "u4"}[bps]
        if sf == 2:
            dt = dt.replace("u", "i")
        if sf == 3:
            dt = "f4"
        return s.astype(bo + dt).reshape(r, -1).view(np.uint8)
    bits = ((s.reshape(r, -1)[..., None].astype(np.int64)
             >> np.arange(bps - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(r, -1), axis=1)


def _predict(s, bps, sf, pred):
    """The differencing of predictor 2 (integer words) or 3 (float byte
    planes) on one chunk's samples [rows, cols, n] -> the chunk bytes."""
    if pred == 2:
        u = s.astype({8: "u1", 16: "u2", 32: "u4"}[bps] if sf != 3
                     else "f4")
        u = u.view({8: "u1", 16: "u2", 32: "u4"}[bps])
        d = u.copy()
        d[:, 1:] = u[:, 1:] - u[:, :-1]
        return d
    r, c, n = s.shape
    be = s.astype(">f4").reshape(r, c * n).view(np.uint8).reshape(r, c * n, 4)
    planes = be.transpose(0, 2, 1).reshape(r, -1).reshape(r, -1, n)
    d = planes.copy()
    d[:, 1:] = planes[:, 1:] - planes[:, :-1]
    return d.reshape(r, -1)


def _tiff(path, s, photo, bps, bo="<", sf=1, extra=(), comp=1, pred=1,
          planar=1, tile=None, rps=5, fill=1, cmap=None, orient=None):
    """A TIFF of samples s [H, W, n] with the given layout."""
    h, w, n = s.shape
    chunks = []
    if tile:
        tw, th = tile
        grid = [(x, y, tw, th) for y in range(0, h, th)
                for x in range(0, w, tw)]
    else:
        grid = [(0, y, w, min(rps, h - y)) for y in range(0, h, rps)]
    planes = range(n) if planar == 2 else [None]
    for p in planes:
        for x, y, cw, ch in grid:
            blk = np.zeros((ch, cw, n), s.dtype)
            part = s[y:y + ch, x:x + cw]
            blk[:part.shape[0], :part.shape[1]] = part
            if p is not None:
                blk = blk[..., p:p + 1]
            if pred == 1:
                b = _rows_bytes(blk, bps, bo, sf)
            else:
                b = _predict(blk, bps, sf, pred)
                if pred == 2:
                    b = b.astype(bo + b.dtype.str[1:]).reshape(
                        b.shape[0], -1).view(np.uint8)
            raw = {1: lambda d: d, 32773: _packbits, 5: lzw_encode,
                   8: zlib.compress, 32946: zlib.compress,
                   34925: lambda d: d}[comp](b.tobytes())
            if fill == 2:
                raw = ttiff._REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
            chunks.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * n),
            259: (3, [comp]), 262: (3, [photo]), 277: (3, [n]),
            284: (3, [planar])}
    if sf != 1:
        tags[339] = (3, [sf] * n)
    if extra:
        tags[338] = (3, list(extra))
    if pred != 1:
        tags[317] = (3, [pred])
    if fill != 1:
        tags[266] = (3, [fill])
    if cmap is not None:
        tags[320] = (3, list(cmap))
    if orient is not None:
        tags[274] = (3, [orient])
    data_off = 8
    blob = b"".join(chunks)
    offs = np.cumsum([0] + [len(c) for c in chunks])[:-1] + data_off
    if tile:
        tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]),
                     324: (4, offs.tolist()),
                     325: (4, [len(c) for c in chunks])})
    else:
        tags.update({273: (4, offs.tolist()), 278: (3, [rps]),
                     279: (4, [len(c) for c in chunks])})
    ifd_off = data_off + len(blob)
    ifd_off += ifd_off & 1
    entries, tail = [], b""
    tail_off = ifd_off + 2 + 12 * len(tags) + 4
    for tag in sorted(tags):
        typ, vals = tags[tag]
        fmt = "H" if typ == 3 else "I"
        val = struct.pack(f"{bo}{len(vals)}{fmt}", *vals)
        if len(val) <= 4:
            entries.append(struct.pack(f"{bo}HHI", tag, typ, len(vals))
                           + val.ljust(4, b"\0"))
        else:
            entries.append(struct.pack(f"{bo}HHII", tag, typ, len(vals),
                                       tail_off + len(tail)))
            tail += val
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(
        bo + "I", ifd_off)
    body = head + blob + b"\0" * (ifd_off - data_off - len(blob))
    body += struct.pack(bo + "H", len(tags)) + b"".join(entries) \
        + struct.pack(bo + "I", 0) + tail
    with open(path, "wb") as f:
        f.write(body)


def _samples(kind, n=1):
    if kind == "float":
        v = RNG.uniform(-20.0, 300.0, (H, W, n)).astype(np.float32)
        v[0, :4, 0] = [1.63, 1.71, np.float32(254.99), 0.5]
        return v
    top = {"bit": 1, "2": 3, "4": 15, "8": 255, "12": 4095, "16": 65535,
           "s16": 0, "32": 0, "s32": 0}[kind]
    if kind == "s16":
        return RNG.integers(-400, 600, (H, W, n)).astype(np.int16)
    if kind in ("32", "s32"):
        v = RNG.integers(-300 if kind == "s32" else 0, 600, (H, W, n))
        return v.astype(np.int32 if kind == "s32" else np.uint32)
    v = RNG.integers(0, top + 1, (H, W, n))
    if kind == "16":
        v[0, 0, 0] = 55745
        v[0, 1, 0] = 200
    return v.astype(np.uint16 if top > 255 else np.uint8)


# (name, photometric, sample kind, samples, bits, sample format, extra)
LAYOUTS = [
    ("bit_white0", 0, "bit", 1, 1, 1, ()),
    ("bit_black0", 1, "bit", 1, 1, 1, ()),
    ("gray2_white0", 0, "2", 1, 2, 1, ()),
    ("gray2", 1, "2", 1, 2, 1, ()),
    ("gray4_white0", 0, "4", 1, 4, 1, ()),
    ("gray4", 1, "4", 1, 4, 1, ()),
    ("gray8_white0", 0, "8", 1, 8, 1, ()),
    ("gray8", 1, "8", 1, 8, 1, ()),
    ("gray8_signed", 1, "8", 1, 8, 2, ()),
    ("gray12", 1, "12", 1, 12, 1, ()),
    ("gray16", 1, "16", 1, 16, 1, ()),
    ("gray16_white0", 0, "16", 1, 16, 1, ()),
    ("gray16_signed", 1, "s16", 1, 16, 2, ()),
    ("gray32", 1, "32", 1, 32, 1, ()),
    ("gray32_signed", 1, "s32", 1, 32, 2, ()),
    ("float", 1, "float", 1, 32, 3, ()),
    ("float_white0", 0, "float", 1, 32, 3, ()),
    ("gray_alpha", 1, "8", 2, 8, 1, (2,)),
    ("rgb", 2, "8", 3, 8, 1, ()),
    ("rgbx", 2, "8", 4, 8, 1, (0,)),
    ("rgba", 2, "8", 4, 8, 1, (2,)),
    ("rgba_assoc", 2, "8", 4, 8, 1, (1,)),
    ("rgba_assoc_x", 2, "8", 5, 8, 1, (1, 0)),
    ("rgb16", 2, "16", 3, 16, 1, ()),
    ("rgba16_assoc", 2, "16", 4, 16, 1, (1,)),
    ("rgbx16", 2, "16", 4, 16, 1, (0,)),
    ("palette1", 3, "bit", 1, 1, 1, ()),
    ("palette2", 3, "2", 1, 2, 1, ()),
    ("palette4", 3, "4", 1, 4, 1, ()),
    ("palette8", 3, "8", 1, 8, 1, ()),
    ("palette8_x", 3, "8", 2, 8, 1, (0,)),
    ("cmyk", 5, "8", 4, 8, 1, ()),
    ("cmyk_x", 5, "8", 5, 8, 1, (0,)),
    ("cmyk16", 5, "16", 4, 16, 1, ()),
]


def _layout_file(path, name, bo="<", **kw):
    _, photo, kind, n, bps, sf, extra = next(c for c in LAYOUTS
                                             if c[0] == name)
    s = _samples(kind, n)
    cmap = None
    if photo == 3:
        cmap = RNG.integers(0, 65536, 3 * (1 << bps)).tolist()
    _tiff(path, s, photo, bps, bo=bo, sf=sf, extra=extra, cmap=cmap, **kw)


@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("name", [c[0] for c in LAYOUTS])
def test_layouts(tmp_path, name, bo):
    """Every photometric, bit depth and extra-sample layout of Pillow's
    table, in strips, in both byte orders (the big-endian table has no
    12-bit, 32-bit unsigned or 16-bit WhiteIsZero key: PIL fails, and the
    port raises ValueError)."""
    p = tmp_path / "x.tif"
    _layout_file(p, name, bo)
    lay_key = next(c for c in LAYOUTS if c[0] == name)
    if bo == ">" and name in ("gray12", "gray32", "gray16_white0"):
        assert jread(str(p), "", gamma=1.0) is None
        with pytest.raises(ValueError):
            tio.read_image(str(p), device="cpu")
        return
    assert lay_key
    _same(p)


ORGS = [("strips", {}), ("one_strip", {"rps": H}),
        ("tiles", {"tile": (16, 16)}),
        ("planar_strips", {"planar": 2}),
        ("planar_tiles", {"planar": 2, "tile": (16, 16)})]
CODECS = [("raw", 1), ("packbits", 32773), ("lzw", 5), ("deflate", 32946),
          ("adobe_deflate", 8)]


@pytest.mark.parametrize("org", [o[0] for o in ORGS])
@pytest.mark.parametrize("codec", [c[0] for c in CODECS])
def test_organisations_and_codecs(tmp_path, org, codec):
    """Strips and tiles, chunky and planar, under each compression, on
    RGB and (big-endian) 16-bit RGB samples. Pillow reads uncompressed
    planar 16-bit samples with its own raw decoder as 8-bit planes, which
    the port does not follow (ROADMAP item 13)."""
    kw = dict(dict(ORGS)[org], comp=dict(CODECS)[codec])
    for name, bo in (("rgb", "<"), ("rgb16", ">")):
        p = tmp_path / f"{name}.tif"
        _layout_file(p, name, bo, **kw)
        if name == "rgb16" and codec == "raw" and "planar" in org:
            with pytest.raises(NotImplementedError, match="item 13"):
                tio.probe_image(str(p))
            continue
        _same(p)


@pytest.mark.parametrize("case", ["rgb8", "gray16_mm", "rgba16", "gray32",
                                  "float_p3", "float_p3_planar",
                                  "float_p3_mm_tiles", "rgb8_tiles"])
@pytest.mark.parametrize("codec", ["lzw", "deflate"])
def test_predictors(tmp_path, case, codec):
    """Predictor 2 on 8-, 16- and 32-bit words and predictor 3 on float
    samples, chunky and planar, in strips and tiles."""
    name, bo, kw = {
        "rgb8": ("rgb", "<", {}), "gray16_mm": ("gray16", ">", {}),
        "rgba16": ("rgba16_assoc", "<", {}), "gray32": ("gray32", "<", {}),
        "float_p3": ("float", "<", {}),
        "float_p3_planar": ("float", "<", {"planar": 2}),
        "float_p3_mm_tiles": ("float", ">", {"tile": (16, 16)}),
        "rgb8_tiles": ("rgb", ">", {"tile": (16, 16)})}[case]
    p = tmp_path / "x.tif"
    _layout_file(p, name, bo, comp=dict(CODECS)[codec],
                 pred=3 if "p3" in case else 2, **kw)
    _same(p)


@pytest.mark.parametrize("name", ["bit_black0", "gray4", "gray8", "rgb",
                                  "palette2", "gray16"])
def test_fill_order_2(tmp_path, name):
    """FillOrder 2: each byte bit-reversed (a 16-bit gray has no such key
    in Pillow's table: PIL fails and the port raises ValueError)."""
    p = tmp_path / "x.tif"
    _layout_file(p, name, "<", fill=2, comp=5)
    if name == "gray16":
        # Pillow's key for it exists ('I;16R'); read as PIL does
        pass
    _same(p)


PIL_MODES = ["RGB", "RGBA", "L", "1", "P", "CMYK", "I;16", "F", "LA", "I"]


@pytest.mark.parametrize("comp", [None, "packbits", "tiff_lzw",
                                  "tiff_deflate", "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", PIL_MODES)
def test_pil_writes(tmp_path, mode, comp):
    """Each mode PIL writes, under each lossless compression it writes."""
    base = RNG.integers(0, 256, (H, W, 4), dtype=np.uint8)
    if mode == "I;16":
        im = Image.fromarray(RNG.integers(0, 1000, (H, W)).astype(np.uint16))
    elif mode == "I":
        im = Image.fromarray(RNG.integers(-50, 400, (H, W)).astype(np.int32))
    elif mode == "F":
        im = Image.fromarray(RNG.uniform(-5, 260, (H, W)).astype(np.float32))
    elif mode == "P":
        im = Image.fromarray(base[..., :3]).quantize(37)
    else:
        im = Image.fromarray(base).convert(mode)
    p = tmp_path / "x.tif"
    im.save(p, compression=comp)
    _same(p)


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("size", [(13, 20), (40, 33)])
def test_pil_writes_jpeg(tmp_path, mode, size):
    """JPEG-compressed TIFFs as PIL writes them through libtiff (YCbCr
    with subsampled chroma and JPEGTables, or one gray component)."""
    im = Image.fromarray(RNG.integers(0, 256, size + (3,), dtype=np.uint8)
                         ).convert(mode)
    p = tmp_path / "x.tif"
    im.save(p, compression="jpeg", quality=85)
    _same(p)


@pytest.mark.parametrize("orient", range(1, 9))
def test_orientation_is_applied(tmp_path, orient):
    """Pillow's TIFF plugin turns the image upright by its Orientation tag
    as it loads (ImageOps.exif_transpose); orientations 5-8 swap the
    width and the height."""
    p = tmp_path / "x.tif"
    _layout_file(p, "rgb", orient=orient, comp=5)
    _same(p)


@pytest.mark.parametrize("name", ["float", "gray16_signed",
                                  "gray32_signed", "gray16"])
@pytest.mark.parametrize("codec", ["raw", "deflate"])
def test_big_endian_words(tmp_path, name, codec):
    """Big-endian signed and float words: read as stored when
    uncompressed; byte-swapped when compressed, as Pillow unpacks
    libtiff's native-order words with its big-endian rawmodes."""
    p = tmp_path / "x.tif"
    _layout_file(p, name, ">", comp=dict(CODECS)[codec])
    _same(p)


@pytest.mark.parametrize("case", ["lzma", "ccitt", "ycbcr_raw", "lab",
                                  "bigtiff"])
def test_unported_tiffs_raise_naming_the_item(tmp_path, case):
    """Compressions PIL reads through libtiff and the port does not, and
    YCbCr other than JPEG-compressed, CIELab and BigTIFF: probe_image and
    read_image raise NotImplementedError naming ROADMAP item 13."""
    p = tmp_path / "x.tif"
    if case == "lzma":
        _layout_file(p, "rgb", comp=34925)
    elif case == "ccitt":
        _tiff(p, _samples("bit"), 0, 1, comp=1)
        data = bytearray(p.read_bytes())
        i = data.index(struct.pack("<HHI", 259, 3, 1))
        data[i + 8:i + 10] = struct.pack("<H", 3)
        p.write_bytes(bytes(data))
    elif case == "ycbcr_raw":
        _tiff(p, _samples("8", 3), 6, 8)
    elif case == "lab":
        _tiff(p, _samples("8", 3), 8, 8)
    else:
        p.write_bytes(b"II+\x00" + bytes(12))
    for read in (tio.probe_image,
                 lambda q: tio.read_image(q, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            read(str(p))


@pytest.mark.parametrize("case", ["truncated", "no_layout", "bad_codec"])
def test_what_pil_fails_on_is_a_value_error(tmp_path, case):
    """A truncated strip, a sample layout outside Pillow's table and an
    unknown compression code: hairpt's PIL fails (a missing texture) and
    the port raises ValueError."""
    p = tmp_path / "x.tif"
    if case == "truncated":
        _layout_file(p, "rgb", rps=H)
        p.write_bytes(p.read_bytes()[:300])
    elif case == "no_layout":
        _tiff(p, _samples("8", 2), 2, 8)
    else:
        _layout_file(p, "rgb")
        data = bytearray(p.read_bytes())
        i = data.index(struct.pack("<HHI", 259, 3, 1))
        data[i + 8:i + 10] = struct.pack("<H", 9)
        p.write_bytes(bytes(data))
    assert jread(str(p), "", gamma=1.0) is None
    tio.probe_image(str(p))
    with pytest.raises(ValueError):
        tio.read_image(str(p), device="cpu")


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (13, 20), (300, 200)])
def test_write_tiff_is_pils_bytes(tmp_path, size):
    """write_tiff of a float image (rounded as the JAX package rounds)
    and of its uint8 pixels: PIL's default save of the same pixels, byte
    for byte; read back exactly."""
    a = RNG.integers(0, 256, size + (3,), dtype=np.uint8)
    ref = io.BytesIO()
    Image.fromarray(a).save(ref, "TIFF")
    p = tmp_path / "x.tif"
    tio.write_tiff(str(p), a.astype(np.float32) / 255.0)
    assert p.read_bytes() == ref.getvalue()
    tio.write_tiff(str(p), a)
    assert p.read_bytes() == ref.getvalue()
    np.testing.assert_array_equal(tio.read_ldr(str(p)), a)


def _formats(d, combo):
    """The loader scene's images in the new formats."""
    from torch_jpeg_enc import arith_jpeg, component_blocks
    rng = np.random.default_rng(23)
    y, x = np.mgrid[0:24, 0:40]
    nrm = np.stack([128 + 60 * np.sin(x / 4.0), 128 + 60 * np.cos(y / 3.0),
                    np.full_like(x, 230.0)], -1).astype(np.uint8)
    bump = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    hf = (128 + 100 * np.sin(x / 5.0) * np.cos(y / 4.0)).astype(np.uint8)
    height = np.stack([hf, hf // 2, 255 - hf], -1)
    env = np.stack([x * 6, y * 10, np.full_like(x, 90)], -1).astype(np.uint8)
    if combo == "tif_webp_gif":
        Image.fromarray(nrm).save(d / "normal.webp", lossless=True)
        Image.fromarray(bump).save(d / "bump.gif")
        _tiff(d / "height.tif", height, 2, 8, comp=5, pred=2)
        Image.fromarray(env).save(d / "env.webp", quality=70)
        return "normal.webp", "bump.gif", "height.tif", "env.webp"
    Image.fromarray(nrm).save(d / "normal.ppm")
    Image.fromarray(bump[..., 0]).save(d / "bump.pgm")
    samp = [(2, 2), (1, 1), (1, 1)]
    blocks, q = component_blocks(rng, 40, 24, samp)
    (d / "height.jpg").write_bytes(arith_jpeg(40, 24, samp, blocks, q,
                                              progressive=True))
    Image.fromarray(env).save(d / "env.tif", compression="tiff_deflate")
    return "normal.ppm", "bump.pgm", "height.jpg", "env.tif"


@pytest.mark.parametrize("combo", ["tif_webp_gif", "ppm_arith_jpeg"])
def test_loaders_agree_on_the_new_formats(same_bvh, tmp_path, combo):
    """A normal map, a bump map, a heightfield and an envmap in the new
    formats, loaded by both packages (no render): every tensor of the
    port's scene equals hairpt's carried across, bit for bit."""
    import dataclasses
    import jax
    import torch
    from hairpt.scene import xml_loader as jxl
    from hairpt_torch import convert
    from hairpt_torch.scene import xml_loader as txl
    from test_torch_ldr_textures import SCENE, _tensors
    names = _formats(tmp_path, combo)
    xml = tmp_path / "scene.xml"
    body = SCENE.replace("normal.{ext}", names[0])
    for old, new in zip(("bump.bmp", "height.tga", "env.jpg"), names[1:]):
        body = body.replace(old, new)
    xml.write_text(body)
    js = jxl.load_scene(str(xml))
    ts = txl.load_scene(str(xml), device="cpu")
    cs = convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    assert ts.config == dataclasses.replace(cs.config, traversal="tiled",
                                            tiled_q=ts.config.tiled_q)
    got, ref = dict(_tensors(ts.arrays)), dict(_tensors(cs.arrays))
    assert got.keys() == ref.keys()
    for k, v in got.items():
        r = ref[k]
        assert v.dtype == r.dtype and v.shape == r.shape, k
        if v.is_floating_point():
            v, r = v.view(torch.int32), r.view(torch.int32)
        assert torch.equal(v, r), k
    assert ts.arrays.checkers.bitmaps.shape[0] == 2
    assert ts.arrays.env.image.std() > 0


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_images")
with np.load(os.path.join(FIXTURES, "expected.npz")) as _npz:
    FIXTURE_NAMES = sorted(_npz.files)


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixtures_decode_as_pil(name):
    """The committed fixtures of chip_smoke phase 23 (one per reader
    branch, tests/torch_images/make_fixtures.py): PIL decodes each to its
    committed array, and so does the port, bit for bit."""
    p = os.path.join(FIXTURES, name)
    with np.load(os.path.join(FIXTURES, "expected.npz")) as npz:
        want = npz[name]
    np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")),
                                  want)
    np.testing.assert_array_equal(tio.read_ldr(p, device="cpu"), want)


with open(os.path.join(FIXTURES, "large.json")) as _f:
    LARGE = json.load(_f)


@pytest.mark.parametrize("name", sorted(LARGE))
def test_large_fixtures_decode_as_pil(name):
    """The fixtures of a size users have (large.json records the shape and
    SHA-256 of PIL's array, too large to commit): PIL's decode matches
    the record, and the port's equals PIL's bit for bit."""
    p = os.path.join(FIXTURES, name)
    want = np.asarray(Image.open(p).convert("RGB"))
    assert list(want.shape) == LARGE[name]["shape"]
    assert hashlib.sha256(want.tobytes()).hexdigest() == \
        LARGE[name]["sha256"]
    np.testing.assert_array_equal(tio.read_ldr(p, device="cpu"), want)


def test_fixtures_stay_small():
    total = sum(os.path.getsize(os.path.join(FIXTURES, n))
                for n in os.listdir(FIXTURES))
    assert len(FIXTURE_NAMES) >= 30 and total < 300_000
