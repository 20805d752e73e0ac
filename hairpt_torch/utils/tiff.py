"""TIFF images, as the JAX package reads them through PIL (Pillow's TIFF
plugin over libtiff) and writes them with PIL's default save.

read_tiff reads the first IFD only, of either byte order, as
Image.open opens it, and gives PIL's convert("RGB") of it:
- strips and tiles, chunky (PlanarConfiguration 1) and planar (2);
- compression none, PackBits, LZW (MSB-first codes), Deflate and Adobe
  Deflate, with predictor 2 (horizontal differencing) and 3 (libtiff's
  floating-point byte planes), and JPEG (compression 7: each strip or
  tile a JPEG stream after the JPEGTables, decoded by utils/jpeg.py,
  YCbCr converted to RGB as libtiff's JPEGCOLORMODE_RGB has libjpeg do
  it, other photometrics taken as stored);
- FillOrder 2 (every byte of a chunk bit-reversed before decoding);
- the sample layouts of Pillow's OPEN_INFO table that convert("RGB")
  reads, with its rules: bilevel, 2-, 4- and 8-bit gray (WhiteIsZero
  inverted, but not at 16 bits), 12-, 16- and 32-bit integer gray and
  32-bit float gray clipped to 0..255 (a float truncated toward zero),
  RGB and CMYK at 8 and 16 bits (a 16-bit sample's high byte), palette
  images at 1, 2, 4 and 8 bits (the colour map's high bytes), extra
  samples dropped, associated alpha (ExtraSamples 1) divided out as
  Pillow's RGBa unpacker does, CMYK through Pillow's cmyk2rgb.
The Orientation tag turns the image upright, as Pillow's TIFF plugin
applies ImageOps.exif_transpose when it loads; the big-endian signed and
float samples that Pillow reads through libtiff (compressed) come out
byte-swapped, as Pillow unpacks them. A layout or a
compression outside Pillow's tables raises ValueError (PIL fails on it
too); the other compressions PIL reads through libtiff (CCITT, old-style
JPEG, LZMA, ZSTD, WebP, ...), YCbCr other than JPEG-compressed, CIELab,
old-style (LSB-first) LZW, BigTIFF and uncompressed planar samples of
other than 8 bits (which Pillow's raw decoder reads as 8-bit planes) raise
NotImplementedError (ROADMAP item 13).

encode_rgb writes an uncompressed RGB TIFF byte for byte as PIL's
default save does: little-endian, one IFD of ten entries at offset 8,
BitsPerSample's three values after it and the pixels in one strip from
offset 140.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from .io import ITEM_13

# tags
WIDTH, HEIGHT, BPS, COMPRESSION, PHOTOMETRIC, FILLORDER = (256, 257, 258,
                                                           259, 262, 266)
STRIP_OFFSETS, SPP, ROWS_PER_STRIP, STRIP_COUNTS = 273, 277, 278, 279
PLANAR, PREDICTOR, COLORMAP = 284, 317, 320
TILE_W, TILE_H, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
EXTRA, SAMPLE_FORMAT, JPEG_TABLES, ORIENTATION = 338, 339, 347, 274

# compression code -> the name the port decodes it by; Pillow's other
# codes (its COMPRESSION_INFO) are decoded by libtiff and not ported
_CODECS = {1: "raw", 32773: "packbits", 5: "lzw", 8: "deflate",
           32946: "deflate", 7: "jpeg"}
_PIL_CODECS = {2, 3, 4, 6, 32771, 32809, 34676, 34677, 34925, 50000, 50001}

# Pillow 12.1's OPEN_INFO keys (photometric, sample format, bits per
# sample, extra samples) -> the port's conversion; fill order 2 only
# where Pillow has a key for it; the big-endian table lacks _II_ONLY
_G = "gray"
_LAYOUTS = {
    (0, (1,), (1,), ()): "bit", (1, (1,), (1,), ()): "bit",
    (0, (1,), (2,), ()): _G, (1, (1,), (2,), ()): _G,
    (0, (1,), (4,), ()): _G, (1, (1,), (4,), ()): _G,
    (0, (1,), (8,), ()): _G, (1, (1,), (8,), ()): _G,
    (1, (2,), (8,), ()): _G,
    (1, (1,), (12,), ()): "clip", (0, (1,), (16,), ()): "clip",
    (1, (1,), (16,), ()): "clip", (1, (2,), (16,), ()): "clip",
    (0, (3,), (32,), ()): "float", (1, (1,), (32,), ()): "clip",
    (1, (2,), (32,), ()): "clip", (1, (3,), (32,), ()): "float",
    (1, (1,), (8, 8), (2,)): "LA",
    (2, (1,), (8, 8, 8), ()): "RGB", (2, (1,), (8, 8, 8, 8), ()): "RGB",
    (2, (1,), (8, 8, 8, 8), (0,)): "RGB",
    (2, (1,), (8, 8, 8, 8, 8), (0, 0)): "RGB",
    (2, (1,), (8, 8, 8, 8, 8, 8), (0, 0, 0)): "RGB",
    (2, (1,), (8, 8, 8, 8), (1,)): "RGBa",
    (2, (1,), (8, 8, 8, 8, 8), (1, 0)): "RGBa",
    (2, (1,), (8, 8, 8, 8, 8, 8), (1, 0, 0)): "RGBa",
    (2, (1,), (8, 8, 8, 8), (2,)): "RGB",
    (2, (1,), (8, 8, 8, 8, 8), (2, 0)): "RGB",
    (2, (1,), (8, 8, 8, 8, 8, 8), (2, 0, 0)): "RGB",
    (2, (1,), (8, 8, 8, 8), (999,)): "RGB",
    (2, (1,), (16, 16, 16), ()): "RGB",
    (2, (1,), (16, 16, 16, 16), ()): "RGB",
    (2, (1,), (16, 16, 16, 16), (0,)): "RGB",
    (2, (1,), (16, 16, 16, 16), (1,)): "RGBa",
    (2, (1,), (16, 16, 16, 16), (2,)): "RGB",
    (3, (1,), (1,), ()): "P", (3, (1,), (2,), ()): "P",
    (3, (1,), (4,), ()): "P", (3, (1,), (8,), ()): "P",
    (3, (1,), (8, 8), (0,)): "P", (3, (1,), (8, 8), (2,)): "P",
    (5, (1,), (8, 8, 8, 8), ()): "CMYK",
    (5, (1,), (8, 8, 8, 8, 8), (0,)): "CMYK",
    (5, (1,), (8, 8, 8, 8, 8, 8), (0, 0)): "CMYK",
    (5, (1,), (16, 16, 16, 16), ()): "CMYK",
    (6, (1,), (8,), ()): "YCbCr", (6, (1,), (8, 8, 8), ()): "YCbCr",
    (8, (1,), (8, 8, 8), ()): "LAB",
}
_II_ONLY = {(1, (1,), (32,), ()), (1, (1,), (12,), ()),
            (0, (1,), (16,), ())}
_FILL2 = {(p, (1,), (b,), ()) for p in (0, 1, 3) for b in (1, 2, 4, 8)} \
    | {(2, (1,), (8, 8, 8), ()), (1, (1,), (16,), ())}
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B",
          8: "h", 9: "i", 10: "ii", 11: "f", 12: "d", 13: "I"}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)


def _unported(what: str):
    return NotImplementedError(f"a TIFF with {what} is {ITEM_13}")


def _ifd(data: bytes):
    """(byte order '<' or '>', {tag: tuple of values}) of the first IFD."""
    if data[:4] in (b"II+\x00", b"MM\x00+"):
        raise _unported("the BigTIFF layout")
    if data[:4] not in (b"II*\x00", b"MM\x00*"):
        raise ValueError("not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    off = struct.unpack(bo + "I", data[4:8])[0]
    if off + 2 > len(data):
        raise ValueError("truncated TIFF: no IFD")
    n = struct.unpack(bo + "H", data[off:off + 2])[0]
    tags = {}
    for i in range(n):
        e = off + 2 + 12 * i
        if e + 12 > len(data):
            raise ValueError("truncated TIFF IFD")
        tag, typ, cnt = struct.unpack(bo + "HHI", data[e:e + 8])
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize("<" + fmt) * cnt
        pos = e + 8 if size <= 4 else struct.unpack(bo + "I",
                                                    data[e + 8:e + 12])[0]
        raw = data[pos:pos + size]
        if len(raw) < size:
            raise ValueError(f"truncated TIFF tag {tag}")
        if typ == 2:
            tags[tag] = (raw,)
        elif typ == 7:
            tags[tag] = (raw,)
        else:
            v = struct.unpack(f"{bo}{fmt * cnt}", raw)
            if typ in (5, 10):
                v = tuple(v[i] / v[i + 1] if v[i + 1] else 0.0
                          for i in range(0, len(v), 2))
            tags[tag] = v
    return bo, tags


class _Layout:
    """The first IFD's layout as Pillow's TiffImageFile._setup reads it."""

    def __init__(self, data: bytes):
        self.bo, t = _ifd(data)
        self.t = t
        code = t.get(COMPRESSION, (1,))[0]
        if code not in _CODECS and code not in _PIL_CODECS:
            raise ValueError(f"TIFF compression {code} (PIL fails on it)")
        if code in _PIL_CODECS:
            raise _unported(f"compression {code}")
        self.codec = _CODECS[code]
        self.planar = t.get(PLANAR, (1,))[0]
        photo = t.get(PHOTOMETRIC, (0,))[0]
        fill = t.get(FILLORDER, (1,))[0]
        if WIDTH not in t or HEIGHT not in t:
            raise ValueError("TIFF without its dimensions")
        self.w, self.h = t[WIDTH][0], t[HEIGHT][0]
        self.orientation = t.get(ORIENTATION, (1,))[0]
        sf = t.get(SAMPLE_FORMAT, (1,))
        if len(sf) > 1 and max(sf) == min(sf) == 1:
            sf = (1,)
        bps = t.get(BPS, (1,))
        extra = t.get(EXTRA, ())
        spp = t.get(SPP, (1,))[0]
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        if len(bps) != spp:
            raise ValueError("TIFF: unknown data organization")
        key = (photo, tuple(sf), tuple(bps), tuple(extra))
        kind = _LAYOUTS.get(key)
        if kind is None or (self.bo == ">" and key in _II_ONLY) \
                or (fill == 2 and key not in _FILL2) \
                or fill not in (1, 2):
            raise ValueError(f"TIFF sample layout {key} (fill order {fill}):"
                             f" PIL has no mode for it")
        if kind == "LAB":
            raise _unported("CIELab samples")
        if kind == "YCbCr" and (self.codec != "jpeg" or spp != 3
                                or self.planar != 1):
            raise _unported("YCbCr samples other than JPEG-compressed")
        self.photo, self.kind, self.fill = photo, kind, fill
        self.sf, self.bps, self.spp, self.extra = sf[0], bps[0], spp, extra
        if self.codec == "raw" and self.planar == 2 and self.bps != 8 \
                and spp > 1:
            # Pillow's own raw decoder reads each plane with one letter of
            # the rawmode ("R" of "RGB;16B"): 8-bit samples and row
            # strides other than the file's
            raise _unported("uncompressed planar samples of other than 8 "
                            "bits (Pillow reads them as 8-bit planes)")
        # Pillow unpacks libtiff's native-order words of these big-endian
        # layouts with its big-endian rawmodes (F;32BF, I;16BS, I;32BS):
        # the values come out byte-swapped
        self.swapped = self.bo == ">" and self.codec != "raw" and (
            sf[0] == 3 or sf[0] == 2 and bps[0] in (16, 32))
        self.predictor = t.get(PREDICTOR, (1,))[0]
        if self.predictor not in (1, 2, 3):
            raise ValueError(f"TIFF predictor {self.predictor}")
        if self.codec == "jpeg" and self.bps != 8:
            raise ValueError("a JPEG-compressed TIFF of other than 8 bits")
        if self.codec != "lzw":
            return
        chunks = self.chunks()
        first = chunks[0][0] if chunks else 0
        if data[first:first + 1] == b"\x00" \
                and data[first + 1:first + 2] and data[first + 1] & 1:
            raise _unported("old-style (LSB-first) LZW")

    def chunks(self):
        """[(offset, byte count, plane, x0, y0, chunk width, chunk rows)]"""
        t = self.t
        tiled = TILE_OFFSETS in t
        if tiled:
            offs, counts = t[TILE_OFFSETS], t.get(TILE_COUNTS)
            cw, ch = t[TILE_W][0], t[TILE_H][0]
        elif STRIP_OFFSETS in t:
            offs, counts = t[STRIP_OFFSETS], t.get(STRIP_COUNTS)
            cw, ch = self.w, min(t.get(ROWS_PER_STRIP, (self.h,))[0], self.h)
        else:
            raise ValueError("TIFF: unknown data organization")
        if ch <= 0 or cw <= 0:
            raise ValueError("TIFF: empty strips or tiles")
        nx, ny = -(-self.w // cw), -(-self.h // ch)
        planes = self.spp if self.planar == 2 else 1
        if len(offs) < nx * ny * planes:
            raise ValueError("TIFF: fewer strips or tiles than the image "
                             "needs")
        out = []
        for k in range(nx * ny * planes):
            p, r = divmod(k, nx * ny)
            yi, xi = divmod(r, nx)
            n = counts[k] if counts is not None and k < len(counts) else None
            out.append((offs[k], n, p, xi * cw, yi * ch, cw, ch))
        return out


def probe(data: bytes):
    """Raise NotImplementedError where `data` is a TIFF that read_tiff
    does not read, from its first IFD; data PIL cannot read either is
    left to read_tiff (ValueError)."""
    try:
        _Layout(data)
    except (ValueError, struct.error, KeyError, IndexError):
        pass


# ---------------------------------------------------------------------------
# decompression
# ---------------------------------------------------------------------------

def _packbits(src: bytes, size: int) -> bytes:
    out = bytearray()
    i, n = 0, len(src)
    while i < n and len(out) < size:
        c = src[i]
        i += 1
        if c < 128:
            out += src[i:i + c + 1]
            i += c + 1
        elif c > 128:
            out += src[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def lzw_tiff(src: bytes, size: int) -> bytes:
    """libtiff's LZW decoder (MSB-first codes, 9 to 12 bits, the code
    width growing one code early; Clear 256, EOI 257), up to `size`
    bytes."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, bitbuf, nbuf, i = 9, 0, 0, 0
    prev = None
    n = len(src)
    while len(out) < size:
        while nbuf < nbits:
            if i >= n:
                return bytes(out)
            bitbuf = (bitbuf << 8) | src[i]
            i += 1
            nbuf += 8
        code = (bitbuf >> (nbuf - nbits)) & ((1 << nbits) - 1)
        nbuf -= nbits
        bitbuf &= (1 << nbuf) - 1
        if code == 256:
            table = table[:258]
            nbits = 9
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            if code >= 256:
                raise ValueError("corrupt TIFF LZW data")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt TIFF LZW data")
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
    return bytes(out)


def _inflate(src: bytes, size: int) -> bytes:
    d = zlib.decompressobj()
    try:
        out = d.decompress(src, size)
    except zlib.error as e:
        raise ValueError(f"corrupt TIFF Deflate data: {e}")
    return out


# ---------------------------------------------------------------------------
# samples
# ---------------------------------------------------------------------------

def _dtype(lay, bo):
    if lay.sf == 3:
        return np.dtype(bo + "f4")
    if lay.bps == 16:
        return np.dtype(bo + ("i2" if lay.sf == 2 else "u2"))
    if lay.bps == 32:
        return np.dtype(bo + ("i4" if lay.sf == 2 else "u4"))
    return np.dtype(np.int8 if lay.sf == 2 else np.uint8)


def _chunk_samples(lay, raw: bytes, rows: int, cols: int, nsamp: int):
    """Decompressed chunk bytes -> samples [rows, cols, nsamp] (numbers,
    unpacked below 8 bits), the predictor undone per row."""
    bps = lay.bps
    if bps in (8, 16, 32):
        nb = bps // 8
        need = rows * cols * nsamp * nb
        if len(raw) < need:
            raise ValueError("truncated TIFF strip or tile")
        b = np.frombuffer(raw[:need], np.uint8).reshape(rows, cols * nsamp
                                                        * nb)
        if lay.predictor == 3:
            if lay.sf != 3:
                raise ValueError("TIFF predictor 3 on integer samples")
            # libtiff's fpAcc: the row's bytes summed with a stride of
            # nsamp, then read as the samples' most significant bytes,
            # the next bytes, ..., each plane cols * nsamp long
            acc = np.cumsum(b.reshape(rows, -1, nsamp), axis=1,
                            dtype=np.uint8).reshape(rows, nb, cols * nsamp)
            be = np.ascontiguousarray(acc.transpose(0, 2, 1))
            return be.view(">f4").reshape(rows, cols, nsamp) \
                .astype(np.float32)
        v = b.copy().view(_dtype(lay, lay.bo)).reshape(rows, cols, nsamp)
        v = v.astype(v.dtype.newbyteorder("="))
        if lay.predictor == 2:
            # libtiff's horAcc8/16/32: sums of the unsigned words
            u = v.view(f"u{nb}")
            v = np.cumsum(u, axis=1, dtype=u.dtype).view(v.dtype)
        return v
    # 1, 2, 4 (and 12) bits: rows padded to a byte
    stride = -(-cols * nsamp * bps // 8)
    if len(raw) < rows * stride:
        raise ValueError("truncated TIFF strip or tile")
    b = np.frombuffer(raw[:rows * stride], np.uint8).reshape(rows, stride)
    bits = np.unpackbits(b, axis=1)[:, :cols * nsamp * bps] \
        .reshape(rows, cols * nsamp, bps).astype(np.uint16)
    if lay.predictor != 1:
        # libtiff's predictors take 8, 16, 32 and 64-bit samples only
        raise ValueError(f"TIFF predictor {lay.predictor} on {bps}-bit "
                         f"samples")
    return (bits << np.arange(bps - 1, -1, -1, dtype=np.uint16)).sum(
        -1, dtype=np.uint16).reshape(rows, cols, nsamp)


def _jpeg_chunk(lay, tables: bytes, body: bytes, device):
    """A JPEG-compressed chunk: the stream after the JPEGTables, YCbCr
    converted to RGB, other photometrics as stored."""
    import torch
    from . import jpeg
    if tables:
        stream = tables[:-2] + body[2:] if tables[-2:] == b"\xff\xd9" \
            else tables + body[2:]
    else:
        stream = body
    out = jpeg.decode(stream, device, colorspace="ycc" if lay.photo == 6
                      else "none")
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
    return out[..., None] if out.ndim == 2 else out


def _samples(data: bytes, lay, device):
    """The image's samples [h, w, spp]."""
    img = None
    tables = lay.t.get(JPEG_TABLES, (b"",))[0]
    for off, count, plane, x0, y0, cw, ch in lay.chunks():
        nsamp = 1 if lay.planar == 2 else lay.spp
        if count is None:
            count = len(data) - off
        src = data[off:off + count]
        if lay.fill == 2:
            src = _REVERSE[np.frombuffer(src, np.uint8)].tobytes()
        # JPEG strips hold the rows they code; the others a whole chunk
        rows = min(ch, lay.h - y0) if TILE_OFFSETS not in lay.t else ch
        size = -(-cw * nsamp * lay.bps // 8) * rows
        if lay.codec == "jpeg":
            s = _jpeg_chunk(lay, tables, src, device)
        else:
            if lay.codec == "raw":
                raw = src
            elif lay.codec == "packbits":
                raw = _packbits(src, size)
            elif lay.codec == "lzw":
                raw = lzw_tiff(src, size)
            else:
                raw = _inflate(src, size)
            s = _chunk_samples(lay, raw, rows, cw, nsamp)
        if img is None:
            img = np.zeros((lay.h, lay.w, lay.spp), s.dtype)
        hh = min(s.shape[0], lay.h - y0)
        ww = min(s.shape[1], lay.w - x0)
        if lay.planar == 2:
            img[y0:y0 + hh, x0:x0 + ww, plane] = s[:hh, :ww, 0]
        else:
            img[y0:y0 + hh, x0:x0 + ww] = s[:hh, :ww, :lay.spp]
    return img


def _unpremultiply(rgb, a):
    """Pillow's RGBa unpacker: c * 255 // a (0 where a is 0, c where 255),
    clipped to 255."""
    a = a.astype(np.int64)[..., None]
    c = rgb.astype(np.int64)
    out = np.where(a == 0, 0, np.minimum(c * 255 // np.maximum(a, 1), 255))
    return np.where(a == 255, c, out).astype(np.uint8)


def _to_rgb(lay, s, t):
    kind = lay.kind
    if kind == "bit":
        g = (s[..., 0] > 0) if lay.photo == 1 else (s[..., 0] == 0)
        g = g.astype(np.uint8) * 255
    elif kind == _G:
        top = (1 << lay.bps) - 1
        # a signed 8-bit sample is read as its byte (Pillow's "L")
        v = s[..., 0].astype(np.int64) & 0xFF if lay.sf == 2 \
            else s[..., 0].astype(np.int64)
        if lay.photo == 0:
            v = top - v
        g = (v * (255 // top)).astype(np.uint8)
    elif kind == "clip":
        g = np.clip(s[..., 0].astype(np.int64), 0, 255).astype(np.uint8)
    elif kind == "float":
        f = s[..., 0].astype(np.float64)
        g = np.where(f <= 0, 0, np.where(f >= 255, 255, np.trunc(
            np.nan_to_num(f, nan=0.0)))).astype(np.uint8)
    elif kind == "LA":
        g = s[..., 0].astype(np.uint8)
    elif kind in ("RGB", "RGBa", "YCbCr"):
        c = s[..., :3]
        a = s[..., 3] if kind == "RGBa" else None
        if lay.bps == 16:
            c = (c >> 8).astype(np.uint8)
            a = None if a is None else (a >> 8).astype(np.uint8)
        c = c.astype(np.uint8)
        return c if a is None else _unpremultiply(c, a)
    elif kind == "P":
        cmap = np.asarray(t.get(COLORMAP, ()), np.int64)
        n = 1 << lay.bps
        if cmap.size < 3 * n:
            raise ValueError("TIFF palette image without its colour map")
        pal = np.zeros((256, 3), np.uint8)
        pal[:n] = (cmap[:3 * n].reshape(3, n).T // 256).astype(np.uint8)
        return pal[s[..., 0].astype(np.int64)]
    elif kind == "CMYK":
        c = s[..., :4]
        if lay.bps == 16:
            c = c >> 8
        from .jpeg import cmyk_to_rgb
        return cmyk_to_rgb(c.astype(np.int64)).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=-1)


def read_tiff(path: str, device=None) -> np.ndarray:
    """A TIFF's first image as uint8 RGB [H, W, 3], PIL's
    Image.open(path).convert("RGB"). JPEG-compressed chunks run their
    block stage on `device` (the card unless "cpu")."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        lay = _Layout(data)
        s = _samples(data, lay, device)
    except (struct.error, KeyError, IndexError) as e:
        raise ValueError(f"{path}: corrupt TIFF ({e!r})")
    if s is None:
        raise ValueError(f"{path}: a TIFF without strips or tiles")
    if lay.swapped:
        s = s.byteswap()
    return np.ascontiguousarray(_orient(_to_rgb(lay, s, lay.t),
                                        lay.orientation))


def _orient(img, o: int):
    """ImageOps.exif_transpose, which Pillow's TIFF plugin applies as it
    loads: orientations 2-8 flipped, rotated or transposed upright."""
    if o == 2:
        return img[:, ::-1]
    if o == 3:
        return img[::-1, ::-1]
    if o == 4:
        return img[::-1]
    if o == 5:
        return img.transpose(1, 0, 2)
    if o == 6:
        return np.rot90(img, -1)
    if o == 7:
        return img.transpose(1, 0, 2)[::-1, ::-1]
    if o == 8:
        return np.rot90(img, 1)
    return img


def encode_rgb(u8: np.ndarray) -> bytes:
    """An uncompressed RGB TIFF of uint8 [H, W, 3], PIL's default save."""
    h, w = u8.shape[:2]
    body = np.ascontiguousarray(u8, np.uint8).tobytes()
    entries = ((256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, 134),
               (259, 3, 1, 1), (262, 3, 1, 2), (273, 4, 1, 140),
               (277, 3, 1, 3), (278, 4, 1, h), (279, 4, 1, len(body)),
               (284, 3, 1, 1))
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII", *e) if e[1] == 4 or e[2] > 1
        else struct.pack("<HHIHH", *e, 0) for e in entries) \
        + struct.pack("<I", 0)
    return b"II*\x00" + struct.pack("<I", 8) + ifd \
        + struct.pack("<HHH", 8, 8, 8) + body
