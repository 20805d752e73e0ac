"""The port's PNG, BMP and TGA readers (hairpt_torch/utils/io.py) against
hairpt's read_image (PIL's convert("RGB") / 255), on the CPU: every
variant the readers take, written by PIL where PIL writes it and built
here with struct and zlib where it does not (PNG at bit depths 1, 2, 4
and 16, every colour type Adam7-interlaced; RLE4 / RLE8 and bit-field
BMPs, top-down rows; TGA types 1, 3 and 11 with the bottom-left origin,
16-bit pixels and 16-bit colour maps). The tolerance is none: the two
float images are equal value for value. Formats PIL opens and the port
does not read (QOI, SGI, PCX, JPEG 2000, a ZSTD TIFF) raise naming the
ROADMAP item."""
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from hairpt.utils import io as jio
from hairpt_torch.utils import io as tio
from torch_threads import one_thread  # noqa: F401

H, W = 13, 11
RNG = np.random.default_rng(3)
RGB = RNG.integers(0, 256, (H, W, 3), dtype=np.uint8)
RGBA = RNG.integers(0, 256, (H, W, 4), dtype=np.uint8)
GRAY = RGB[..., 0]


def _same(path):
    got = tio.read_image(str(path), device="cpu")
    want = jio.read_image(str(path))
    assert got.dtype == np.float32 and got.shape == want.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png(path, samples, depth, ctype, interlace=0, plte=None):
    """A PNG of integer samples [h, w, c], rows filtered with None, Sub
    and Up in turn, Adam7-interlaced if asked."""
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    s = samples.reshape(H, W, ch)
    bpp = max(1, ch * depth // 8)

    def rows(sub):
        ph = sub.shape[0]
        if depth == 16:
            b = sub.astype(">u2").reshape(ph, -1).view(np.uint8)
        elif depth == 8:
            b = sub.reshape(ph, -1).astype(np.uint8)
        else:
            bits = ((sub[..., 0][..., None] >> np.arange(depth - 1, -1, -1))
                    & 1).astype(np.uint8).reshape(ph, -1)
            b = np.packbits(bits, axis=1)
        out = bytearray()
        for i, r in enumerate(b.astype(int)):
            ft = i % 3
            if ft == 1:
                f = r - np.concatenate([np.zeros(bpp, int), r[:-bpp]])
            elif ft == 2 and i:
                f = r - b[i - 1].astype(int)
            else:
                ft, f = 0, r
            out += bytes([ft]) + (f % 256).astype(np.uint8).tobytes()
        return bytes(out)
    if interlace:
        data = b"".join(rows(s[y0::dy, x0::dx])
                        for x0, y0, dx, dy in tio._ADAM7
                        if s[y0::dy, x0::dx].size)
    else:
        data = rows(s)

    def chunk(k, d):
        return (struct.pack(">I", len(d)) + k + d
                + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", W, H, depth, ctype, 0, 0, interlace)))
        if plte is not None:
            f.write(chunk(b"PLTE", plte))
        f.write(chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


PNG_BUILT = [(d, c, i) for i in (0, 1)
             for d, c in [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (1, 3),
                          (2, 3), (4, 3), (8, 3), (8, 2), (16, 2), (8, 4),
                          (16, 4), (8, 6), (16, 6)]]


@pytest.mark.parametrize("depth,ctype,interlace", PNG_BUILT,
                         ids=lambda v: str(v))
def test_png_built_here(tmp_path, depth, ctype, interlace):
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(depth * 10 + ctype + interlace)
    samples = rng.integers(0, 1 << depth, (H, W, ch))
    plte = rng.integers(0, 256, 3 * (1 << depth), dtype=np.uint8) \
        .tobytes() if ctype == 3 else None
    p = tmp_path / "x.png"
    _png(str(p), samples, depth, ctype, interlace, plte)
    _same(p)


PNG_PIL = {
    "RGB": lambda p: Image.fromarray(RGB).save(p),
    "RGBA": lambda p: Image.fromarray(RGBA).save(p),
    "L": lambda p: Image.fromarray(GRAY).save(p),
    "LA": lambda p: Image.fromarray(RGBA[..., :2], "LA").save(p),
    "1": lambda p: Image.fromarray(GRAY > 128).save(p),
    "P": lambda p: Image.fromarray(RGB).convert("P").save(p),
    "P_trns": lambda p: Image.fromarray(RGB).convert("P").save(
        p, transparency=3),
    "P4": lambda p: Image.fromarray(RGB).quantize(16).save(p, bits=4),
    "I16": lambda p: Image.fromarray(GRAY.astype(np.uint16) * 257).save(p),
    "I16_low": lambda p: Image.fromarray(GRAY.astype(np.uint16)).save(p),
}


@pytest.mark.parametrize("kind", sorted(PNG_PIL))
def test_png_written_by_pil(tmp_path, kind):
    p = str(tmp_path / "x.png")
    PNG_PIL[kind](p)
    _same(p)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

def _bmp(path, bits, pixel_bytes, comp=0, palette=None, masks=None,
         top_down=False, header=40):
    extra = b"" if masks is None else struct.pack(f"<{len(masks)}I", *masks)
    pal = b"" if palette is None else palette
    off = 14 + header + len(extra) + len(pal)
    if header == 40:
        hdr = struct.pack("<IiiHHIIiiII", 40, W, -H if top_down else H, 1,
                          bits, comp, len(pixel_bytes), 2835, 2835,
                          0 if palette is None else len(pal) // 4, 0)
    else:
        hdr = struct.pack("<IHHHH", 12, W, H, 1, bits)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", off + len(pixel_bytes), 0, 0,
                                    off) + hdr + extra + pal + pixel_bytes)


def _rows(arr, bits):
    """Rows of samples [H, W] or [H, W, k] bytes, bottom-up, padded to
    4 bytes."""
    stride = (W * bits + 31) // 32 * 4
    out = bytearray()
    for r in arr[::-1]:
        if bits < 8:
            bb = ((r[:, None] >> np.arange(bits - 1, -1, -1)) & 1) \
                .astype(np.uint8).reshape(-1)
            b = np.packbits(bb).tobytes()
        else:
            b = np.ascontiguousarray(r).tobytes()
        out += b + b"\0" * (stride - len(b))
    return bytes(out)


def _rle(idx, four):
    """BI_RLE8 / BI_RLE4 of palette indices [H, W] (bottom-up): runs of
    equal pixels and absolute blocks of 4 pixels, an end-of-line after
    each row. The absolute blocks keep an even byte count: PIL's decoder
    misreads the word-alignment pad after an odd one."""
    out = bytearray()
    for r in idx[::-1]:
        x = 0
        while x < W:
            n = 1
            while x + n < W and r[x + n] == r[x] and n < 255:
                n += 1
            if n >= 2 or W - x < 4:
                v = (r[x] << 4) | r[x] if four else r[x]
                out += bytes([n, v])
                x += n
            else:
                lit = [int(v) for v in r[x:x + 4]]
                body = bytes([lit[0] << 4 | lit[1], lit[2] << 4 | lit[3]]) \
                    if four else bytes(lit)
                out += bytes([0, 4]) + body
                x += 4
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _pal(n):
    return np.random.default_rng(n).integers(0, 256, (n, 4), np.uint8) \
        .tobytes()


def _bmp_case(path, case):
    rng = np.random.default_rng(len(case))
    if case in ("rle8", "rle4"):
        n = 16 if case == "rle4" else 256
        # runs as well as scattered pixels
        idx = np.repeat(rng.integers(0, n, (H, W // 3 + 1)), 3, 1)[:, :W]
        idx[::4, 1::2] = rng.integers(0, n, idx[::4, 1::2].shape)
        _bmp(path, 4 if case == "rle4" else 8, _rle(idx, case == "rle4"),
             comp=2 if case == "rle4" else 1, palette=_pal(n))
    elif case in ("pal1", "pal4", "pal8", "pal8_topdown"):
        bits = int(case[3])
        idx = rng.integers(0, 1 << bits, (H, W), np.uint8)
        pix = _rows(idx[::-1] if "topdown" in case else idx, bits)
        _bmp(path, bits, pix, palette=_pal(1 << bits),
             top_down="topdown" in case)
    elif case == "core24":
        _bmp(path, 24, _rows(RGB[..., ::-1], 24), header=12)
    elif case in ("rgb16", "bitfields565", "bitfields555"):
        v = rng.integers(0, 1 << 16, (H, W)).astype("<u2")
        masks = {"rgb16": None, "bitfields565": (0xF800, 0x7E0, 0x1F),
                 "bitfields555": (0x7C00, 0x3E0, 0x1F)}[case]
        _bmp(path, 16, _rows(v.view(np.uint8).reshape(H, W, 2), 16),
             comp=0 if masks is None else 3, masks=masks)
    elif case in ("rgb32", "bitfields32", "topdown24"):
        if case == "topdown24":
            _bmp(path, 24, _rows(RGB[::-1, :, ::-1], 24), top_down=True)
            return
        v = RGBA[..., [2, 1, 0, 3]]
        _bmp(path, 32, _rows(v, 32), comp=3 if case == "bitfields32"
             else 0, masks=(0xFF0000, 0xFF00, 0xFF) if case == "bitfields32"
             else None)
    else:
        mode, arr = {"pil_rgb": ("RGB", RGB), "pil_l": ("L", GRAY),
                     "pil_rgba": ("RGBA", RGBA),
                     "pil_1": ("1", GRAY > 100)}.get(case, (None, None))
        if mode is not None:
            Image.fromarray(arr).save(path)
        else:
            Image.fromarray(RGB).convert("P").save(path)


BMP_CASES = ["rle8", "rle4", "pal1", "pal4", "pal8", "pal8_topdown",
             "core24", "rgb16", "bitfields565", "bitfields555", "rgb32",
             "bitfields32", "topdown24", "pil_rgb", "pil_l", "pil_rgba",
             "pil_1", "pil_p"]


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmp(tmp_path, case):
    p = str(tmp_path / "x.bmp")
    _bmp_case(p, case)
    _same(p)


# ---------------------------------------------------------------------------
# TGA
# ---------------------------------------------------------------------------

def _tga(path, itype, depth, pixels, cmap=None, cmap_depth=0, top=False,
         rle=False):
    """pixels: [H * W, bytes] in file order (bottom row first unless
    top); run-length packets within a row, as the format asks."""
    nb = pixels.shape[1]
    if rle:
        body = bytearray()
        for row in pixels.reshape(H, W, nb):
            i = 0
            while i < W:
                n = 1
                while i + n < W and np.array_equal(row[i + n], row[i]):
                    n += 1
                if n > 1:
                    body += bytes([0x80 | (n - 1)]) + row[i].tobytes()
                else:
                    n = min(W - i, 3)
                    body += bytes([n - 1]) + row[i:i + n].tobytes()
                i += n
        data = bytes(body)
    else:
        data = pixels.tobytes()
    cm = b"" if cmap is None else cmap
    n_cm = 0 if cmap is None else len(cmap) // ((cmap_depth + 7) // 8)
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0 if cmap is None else 1, itype,
                      0, n_cm, cmap_depth, 0, 0, W, H, depth,
                      0x20 if top else 0)
    assert nb == (depth + 7) // 8
    with open(path, "wb") as f:
        f.write(hdr + cm + data)


def _tga_case(path, case):
    rng = np.random.default_rng(len(case) + 7)
    if case.startswith("pil_"):
        mode, comp, ori = case[4:].split("_")
        arr = {"RGB": RGB, "RGBA": RGBA, "L": GRAY,
               "LA": RGBA[..., :2]}.get(mode)
        img = Image.fromarray(RGB).convert("P") if mode == "P" \
            else Image.fromarray(arr, mode)
        img.save(path, compression="tga_rle" if comp == "rle" else None,
                 orientation=1 if ori == "top" else -1)
        return
    kind, top = case.rsplit("_", 1)
    top = top == "top"
    if kind in ("type1", "type9", "type1_cm16"):
        idx = rng.integers(0, 40, (H * W, 1), np.uint8)
        depth = int(kind[-2:]) if "_cm" in kind else 24
        cm = rng.integers(0, 256, (40, depth // 8), np.uint8).tobytes()
        _tga(path, 9 if kind == "type9" else 1, 8, idx, cm, depth, top,
             rle=kind == "type9")
    elif kind in ("type3", "type11"):
        g = np.repeat(rng.integers(0, 256, (H * W // 2 + 1, 1), np.uint8),
                      2, 0)[:H * W]
        _tga(path, 11 if kind == "type11" else 3, 8, g, top=top,
             rle=kind == "type11")
    else:
        depth = int(kind.split("_")[1])
        px = rng.integers(0, 256, (H * W, (depth + 7) // 8), np.uint8)
        px[H * W // 2:H * W // 2 + 9] = px[H * W // 2]
        _tga(path, 10 if "rle" in kind else 2, depth, px, top=top,
             rle="rle" in kind)


TGA_CASES = [f"{k}_{o}" for o in ("bottom", "top")
             for k in ("type1", "type9", "type1_cm16",
                       "type3", "type11", "type2_16", "type2_24",
                       "type2_32", "rle_16", "rle_24", "rle_32")] \
    + [f"pil_{m}_{c}_{o}" for m in ("RGB", "RGBA", "L", "LA", "P")
       for c in ("raw", "rle") for o in ("top", "bottom")]


@pytest.mark.parametrize("case", TGA_CASES)
def test_tga(tmp_path, case):
    p = str(tmp_path / "x.tga")
    _tga_case(p, case)
    _same(p)


@pytest.mark.parametrize("ext", ["qoi", "sgi", "pcx", "jp2", "tif_zstd"])
def test_other_formats_raise_naming_the_item(tmp_path, ext):
    """Formats and variants PIL reads and the port does not: read_image
    and the header probe both raise NotImplementedError naming the item.
    (GIF, TIFF, WebP and 1-bit TGA, an earlier slice's cases here, are
    read now: tests/test_torch_{gif,tiff,webp}.py and test_tga_1bit.)"""
    p = tmp_path / f"x.{ext.split('_')[0]}"
    if ext == "tif_zstd":
        Image.fromarray(RGB).save(p, compression="zstd")
    else:
        Image.fromarray(RGB).save(p)
    # PIL reads each of them
    assert np.asarray(Image.open(p).convert("RGB")).shape == RGB.shape
    for read in (tio.read_image, tio.probe_image):
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            read(str(p), **({"device": "cpu"} if read is tio.read_image
                            else {}))


def _tga1(path, bits, rle, top):
    """A 1-bit gray TGA (type 3, or 11 with one raw packet per row)."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    if not top:
        rows = rows[::-1]
    data = b"".join(bytes([len(r) - 1]) + r.tobytes() for r in rows) if rle \
        else rows.tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<BBBHHBHHHHBB", 0, 0, 11 if rle else 3, 0, 0, 0,
                            0, 0, w, h, 1, 0x20 if top else 0) + data)


@pytest.mark.parametrize("case", ["pil", "raw_top", "raw_bottom", "rle_top",
                                  "rle_bottom", "pil_rle"])
def test_tga_1bit(tmp_path, case):
    """1-bit TGA, which an earlier slice refused: PIL's own file and raw
    rows either way up read as PIL reads them; a run-length 1-bit file,
    PIL's own or built here, PIL's decoder fails on (a missing texture in
    hairpt), and the port raises ValueError."""
    p = tmp_path / "x.tga"
    bits = RGB[..., 0] > 127
    if case.startswith("pil"):
        Image.fromarray(bits).save(p, compression="tga_rle" if case ==
                                   "pil_rle" else None)
    else:
        kind, top = case.split("_")
        _tga1(p, bits, kind == "rle", top == "top")
    if "rle" in case:
        with pytest.raises(OSError):
            Image.open(p).convert("RGB")
        with pytest.raises(ValueError):
            tio.read_image(str(p), device="cpu")
        return
    _same(p)
