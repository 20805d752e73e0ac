"""Image / array IO (port of hairpt/utils/io.py).

PNG (ldrfilm), JPEG, BMP and TGA, .npy (the fork's mfilm addition), PFM
(hdrfilm) and Radiance RGBE .hdr input (envmap textures), as in the JAX
package. The JAX package codes its LDR images through PIL; the port
needs no imaging library. It writes PNG as one zlib IDAT of unfiltered
rows (filter byte 0) with CRCs from zlib.crc32, BMP as a 24-bit
bottom-up bitmap, TGA as an uncompressed true-colour image, JPEG
through utils/jpeg.py (libjpeg's integer arithmetic, on the card unless
device="cpu"), and TIFF (utils/tiff.py) and binary PPM (utils/netpbm.py)
byte for byte as PIL saves them; ldr_writer picks the writer by the
extension, as PIL does. It reads the PNG (read_png), BMP (read_bmp), TGA
(read_tga), JPEG (utils/jpeg.py), Netpbm (utils/netpbm.py), TIFF
(utils/tiff.py), GIF (utils/gif.py) and WebP (utils/webp.py) files that
the JAX package's loaders read through PIL, as PIL's convert("RGB")
reads them. The other formats PIL opens (JPEG 2000, QOI, SGI, PCX, ...)
and the variants the readers' probes name are not ported yet (ROADMAP
item 13): they raise NotImplementedError, which probe_image finds from a
file's extension and header; data that PIL cannot decode either raises
ValueError. annotate_image draws the film's label[] annotations and
banner with the port's bitmap font (utils/font.py).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

ITEM_13 = "not ported yet (ROADMAP item 13)"
# the TGA extensions (a TGA has no magic number: PIL opens one by trying
# its header after the formats that have one)
_TGA_EXTS = ("tga", "icb", "vda", "vst")
# the extensions of the other formats read_ldr reads
_OWN_EXTS = ("png", "apng", "jpg", "jpeg", "jpe", "jfif", "bmp", "dib",
             "gif", "tif", "tiff", "webp", "pbm", "pgm", "ppm", "pnm")
# Pillow 12.1's registered extensions (Image.registered_extensions()):
# the formats it opens, and those of them it also writes (Image.SAVE)
PIL_OPEN_EXTS = frozenset((
    "apng avif avifs blp bmp bufr bw cur dcx dds dib emf eps fit fits flc "
    "fli ftc ftu gbr gif grib h5 hdf icb icns ico iim im j2c j2k jfif jp2 "
    "jpc jpe jpeg jpf jpg jpx mpeg mpg mpo msp palm pbm pcd pcx pdf pfm "
    "pgm png pnm ppm ps psd pxr qoi ras rgb rgba sgi tga tif tiff vda vst "
    "webp wmf xbm xpm").split())
PIL_SAVE_EXTS = frozenset((
    "apng avif avifs blp bmp bufr bw dds dib emf eps gif grib h5 hdf icb "
    "icns ico im j2c j2k jfif jp2 jpc jpe jpeg jpf jpg jpx mpo msp palm "
    "pbm pcx pdf pfm pgm png pnm ppm ps qoi rgb rgba sgi tga tif tiff vda "
    "vst webp wmf xbm").split())


# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr) reader — used by envmap emitters
# ---------------------------------------------------------------------------

def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance RGBE file → float32 [H, W, 3] linear RGB."""
    with open(path, "rb") as f:
        data = f.read()
    # header
    end = data.find(b"\n\n")
    if end < 0:
        raise ValueError("invalid hdr header")
    header = data[:end].decode("latin1")
    if "-Y" in data[end + 2:end + 100].decode("latin1"):
        dim_line_end = data.find(b"\n", end + 2)
        dims = data[end + 2:dim_line_end].decode("latin1").split()
    else:
        raise ValueError("unsupported hdr layout")
    # format: -Y H +X W
    H = int(dims[1]); W = int(dims[3])
    pos = dim_line_end + 1
    img = np.zeros((H, W, 4), np.uint8)
    for y in range(H):
        # check for new-style RLE scanline
        if pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2 \
                and (data[pos + 2] << 8 | data[pos + 3]) == W:
            pos += 4
            row = np.zeros((4, W), np.uint8)
            for c in range(4):
                x = 0
                while x < W:
                    cnt = data[pos]; pos += 1
                    if cnt > 128:  # run
                        row[c, x:x + cnt - 128] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:          # literal
                        row[c, x:x + cnt] = np.frombuffer(
                            data[pos:pos + cnt], np.uint8)
                        pos += cnt
                        x += cnt
            img[y] = row.T
        else:  # flat RGBE pixels
            row = np.frombuffer(data[pos:pos + 4 * W], np.uint8).reshape(W, 4)
            img[y] = row
            pos += 4 * W
    rgbe = img.astype(np.float32)
    exp = np.ldexp(1.0, img[..., 3].astype(np.int32) - 136)  # 128 + 8
    rgb = rgbe[..., :3] * exp[..., None]
    rgb[img[..., 3] == 0] = 0.0
    return rgb.astype(np.float32)


def _to_u8(img: np.ndarray) -> np.ndarray:
    """Float [H, W, 3] in [0, 1] (gamma encoded) or uint8 -> uint8, the
    JAX package's rounding."""
    if img.dtype != np.uint8:
        img = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------

def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """img: float [H, W, 3] in [0, 1] (already gamma encoded) or uint8.
    8-bit RGB, one IDAT, filter type 0 on every row."""
    u8 = _to_u8(img)
    h, w = u8.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           u8.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_png_chunk(b"IEND", b""))


def write_bmp(path: str, img: np.ndarray):
    """24-bit BGR bitmap, rows bottom-up and padded to 4 bytes."""
    u8 = _to_u8(img)
    h, w = u8.shape[:2]
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = u8[::-1, :, ::-1].reshape(h, 3 * w)
    size = stride * h
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", 54 + size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, size,
                            2835, 2835, 0, 0))
        f.write(rows.tobytes())


def write_tga(path: str, img: np.ndarray):
    """Uncompressed true-colour TGA, BGR, top-left origin."""
    u8 = _to_u8(img)
    h, w = u8.shape[:2]
    with open(path, "wb") as f:
        f.write(struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h,
                            24, 0x20))
        f.write(np.ascontiguousarray(u8[:, :, ::-1]).tobytes())


def write_jpg(path: str, img: np.ndarray, quality: int = 95, device=None):
    """JPEG writer (the JAX package's write_jpg: PIL at quality 95 by
    default): baseline 4:2:0 through utils/jpeg.py, its block stage on
    `device` (the card unless "cpu")."""
    import torch
    from .. import resolve_device
    from . import jpeg
    u8 = torch.as_tensor(_to_u8(img), device=resolve_device(device))
    with open(path, "wb") as f:
        f.write(jpeg.encode(u8, quality))


def write_tiff(path: str, img: np.ndarray):
    """An uncompressed RGB TIFF, PIL's default save byte for byte."""
    from . import tiff
    with open(path, "wb") as f:
        f.write(tiff.encode_rgb(_to_u8(img)))


def write_ppm(path: str, img: np.ndarray):
    """A binary PPM (P6), PIL's save byte for byte (PIL writes P6 for an
    RGB image under any Netpbm extension)."""
    from . import netpbm
    with open(path, "wb") as f:
        f.write(netpbm.encode_p6(_to_u8(img)))


_WRITERS = {"png": "png", "apng": "png", "jpg": "jpeg", "jpeg": "jpeg",
            "jpe": "jpeg", "jfif": "jpeg", "bmp": "bmp", "tga": "tga",
            "icb": "tga", "vda": "tga", "vst": "tga", "tif": "tiff",
            "tiff": "tiff", "ppm": "ppm", "pgm": "ppm", "pbm": "ppm",
            "pnm": "ppm", "pfm": "ppm"}


def ldr_writer(path: str, device=None, quality: int = 95):
    """The writer of an 8-bit RGB image at `path`, chosen by its
    extension as PIL's save chooses the format: PNG, JPEG (at `quality`,
    its block stage on `device`), BMP, TGA, TIFF and PPM. An extension
    whose format PIL writes and the port does not yet (GIF, WebP, ...)
    raises NotImplementedError (ROADMAP item 13); one PIL has no writer
    for raises ValueError, as PIL's save does."""
    ext = path.rsplit(".", 1)[-1].lower() if "." in path else ""
    kind = _WRITERS.get(ext)
    if kind == "jpeg":
        return lambda p, img: write_jpg(p, img, quality, device=device)
    if kind is not None:
        return {"png": write_png, "bmp": write_bmp, "tga": write_tga,
                "tiff": write_tiff, "ppm": write_ppm}[kind]
    if ext in PIL_SAVE_EXTS:
        raise NotImplementedError(f"{path}: writing the .{ext} image "
                                  f"format is {ITEM_13}")
    raise ValueError(f"{path}: unknown file extension .{ext} (no image "
                     f"format writes it)")


# colour type -> channels
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth_row(f, prior, bpp):
    """Undo the Paeth filter of one scanline (bytes, in Python: each byte
    depends on the one bpp before it)."""
    out = bytearray(f)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(f, prior, bpp):
    out = bytearray(f)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(raw, rows: int, stride: int, bpp: int, path: str):
    """Undo the scanline filters of `rows` rows of `stride` bytes (each
    row led by its filter byte) -> uint8 [rows, stride]."""
    raw = raw.reshape(rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(rows):
        ft, f = int(raw[y, 0]), raw[y, 1:]
        if ft == 0:
            row = f.copy()
        elif ft == 1:
            pad = (-stride) % bpp
            row = np.cumsum(np.concatenate([f, np.zeros(pad, np.uint8)])
                            .reshape(-1, bpp), axis=0, dtype=np.uint8) \
                .reshape(-1)[:stride]
        elif ft == 2:
            row = f + prior
        elif ft == 3:
            row = np.frombuffer(_average_row(f.tobytes(), prior.tobytes(),
                                             bpp), np.uint8)
        elif ft == 4:
            row = np.frombuffer(_paeth_row(f.tobytes(), prior.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"{path}: scanline filter {ft}")
        out[y] = row
        prior = out[y]
    return out


def _unpack_samples(rows, width: int, channels: int, depth: int):
    """Scanline bytes [h, stride] -> samples [h, width, channels] (uint8,
    uint16 at depth 16), the sub-byte depths MSB first."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        return rows[:, :2 * width * channels].copy().view(">u2") \
            .astype(np.uint16).reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth] \
        .reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def read_png(path: str) -> np.ndarray:
    """Any PNG (bit depths 1, 2, 4, 8 and 16; gray, RGB, palette, gray +
    alpha and RGBA; interlaced or not) in PIL's array layout: gray uint8
    [H, W] (depths 1, 2 and 4 scaled to 0..255 as PIL's "1" / "L" modes
    read them) or, at depth 16, uint16 [H, W] ("I;16"); gray + alpha, RGB
    and RGBA uint8 [H, W, C] (depth 16: the high byte, as PIL reads them);
    a palette image as its uint8 RGB colours [H, W, 3] (tRNS dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, ihdr, idat, plte = 8, None, [], b""
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth "
                         f"{depth}")
    ch = _PNG_CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    samples = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * ch * depth // 8)
        rows = _unfilter(raw[pos:pos + ph * (stride + 1)], ph, stride, bpp,
                         path)
        pos += ph * (stride + 1)
        samples[y0::dy, x0::dx] = _unpack_samples(rows, pw, ch, depth)
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pv = np.frombuffer(plte, np.uint8)[:768].reshape(-1, 3)
        pal[:len(pv)] = pv
        return pal[samples[..., 0]]
    if ctype == 0:
        g = samples[..., 0]
        return g if depth >= 8 else (g * (255 // ((1 << depth) - 1))) \
            .astype(np.uint8)
    if depth == 16:
        return (samples >> 8).astype(np.uint8)
    return samples


def png_rgb(img: np.ndarray) -> np.ndarray:
    """read_png's array as uint8 RGB (PIL's convert("RGB"): gray
    replicated, 16-bit gray clipped to 255, alpha dropped)."""
    if img.ndim == 2:
        return np.repeat(np.minimum(img, 255).astype(np.uint8)[..., None],
                         3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def _channel(pix, mask: int):
    """The field under `mask` of every pixel, scaled to 0..255 as PIL's
    unpackers scale 5- and 6-bit fields (v * 255 // max)."""
    if mask == 0:
        return np.zeros(pix.shape, np.uint8)
    shift = (mask & -mask).bit_length() - 1
    top = mask >> shift
    v = (pix.astype(np.int64) & mask) >> shift
    return (v * 255 // top).astype(np.uint8)


def _rle_bmp(buf, w: int, h: int, four: bool):
    """Decode BI_RLE8 / BI_RLE4 palette indices -> [h, w], bottom row
    first (pixels the stream skips stay index 0)."""
    out = np.zeros((h, w), np.uint8)
    x = y = i = 0
    n = len(buf)
    while i + 1 < n and y < h:
        a, b = buf[i], buf[i + 1]
        i += 2
        if a:
            px = [b >> 4, b & 15] if four else [b]
            for k in range(a):
                if x < w:
                    out[y, x] = px[k % len(px)]
                x += 1
        elif b == 0:
            x, y = 0, y + 1
        elif b == 1:
            break
        elif b == 2:
            x += buf[i]
            y += buf[i + 1]
            i += 2
        else:
            if four:
                nb = (b + 1) // 2
                vals = [v for c in buf[i:i + nb] for v in (c >> 4, c & 15)]
            else:
                nb = b
                vals = list(buf[i:i + nb])
            for k in range(b):
                if x < w and y < h:
                    out[y, x] = vals[k]
                x += 1
            i += nb + (nb & 1)
    return out


def read_bmp(path: str) -> np.ndarray:
    """A Windows or OS/2 bitmap as uint8 RGB [H, W, 3]: 1, 4 and 8 bits
    with a palette (uncompressed, BI_RLE8 or BI_RLE4), 16, 24 and 32 bits
    (BI_RGB, or BI_BITFIELDS masks), bottom-up or top-down; PIL's
    convert("RGB") of it (alpha dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path} is not a BMP file")
    off = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    if hsize == 12:
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        comp, ncol, pal_entry = 0, 0, 3
    else:
        w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
        ncol = struct.unpack("<I", data[46:50])[0]
        pal_entry = 4
    top_down = h < 0
    h = abs(h)
    masks = None
    if comp in (3, 6):
        if hsize >= 52:
            masks = struct.unpack("<IIII", data[54:70])
        else:
            nm = 4 if comp == 6 else 3
            masks = struct.unpack(f"<{nm}I", data[54:54 + 4 * nm]) + \
                ((0,) if nm == 3 else ())
    elif comp not in (0, 1, 2):
        # BI_JPEG / BI_PNG (printer bitmaps): PIL does not read them either
        raise ValueError(f"{path}: BMP compression {comp}")
    body = np.frombuffer(data, np.uint8, offset=off)
    if bits <= 8:
        ncol = ncol or (1 << bits)
        p0 = 14 + hsize + (12 if comp == 3 and hsize == 40 else 0)
        pal = np.zeros((256, 3), np.uint8)
        pv = np.frombuffer(data[p0:p0 + ncol * pal_entry], np.uint8) \
            .reshape(-1, pal_entry)[:, 2::-1]
        pal[:len(pv)] = pv
        if comp in (1, 2):
            idx = _rle_bmp(body, w, h, comp == 2)
        else:
            stride = (w * bits + 31) // 32 * 4
            rows = body[:stride * h].reshape(h, stride)
            idx = _unpack_samples(rows, w, 1, bits)[..., 0] if bits < 8 \
                else rows[:, :w]
        img = pal[idx]
    else:
        stride = (w * bits + 31) // 32 * 4
        rows = body[:stride * h].reshape(h, stride)
        if bits == 24:
            img = rows[:, :3 * w].reshape(h, w, 3)[..., ::-1]
        else:
            nb = bits // 8
            pix = rows[:, :nb * w].copy().view("<u2" if nb == 2 else "<u4") \
                .reshape(h, w)
            if masks is None:
                masks = (0x7C00, 0x3E0, 0x1F, 0) if bits == 16 \
                    else (0xFF0000, 0xFF00, 0xFF, 0)
            img = np.stack([_channel(pix, m) for m in masks[:3]], -1)
    return np.ascontiguousarray(img if top_down else img[::-1])


def _tga_pixels(raw, depth: int):
    """TGA pixel bytes [n, depth / 8] -> uint8 RGB [n, 3] (gray for one
    byte)."""
    if depth in (15, 16):
        pix = raw[:, 0].astype(np.int64) | (raw[:, 1].astype(np.int64) << 8)
        return np.stack([_channel(pix, m) for m in (0x7C00, 0x3E0, 0x1F)],
                        -1)
    if depth == 8:
        return np.repeat(raw[:, :1], 3, axis=-1)
    # BGR or BGRA
    return raw[:, 2::-1]


def _tga_rle(data, pos: int, n: int, nb: int):
    """Expand TGA run-length packets to n pixels of nb bytes each."""
    out = np.zeros((n, nb), np.uint8)
    k = 0
    while k < n:
        if pos >= len(data):
            raise ValueError("truncated TGA run-length data")
        hdr = data[pos]
        pos += 1
        cnt = (hdr & 0x7F) + 1
        cnt_ = min(cnt, n - k)
        if hdr & 0x80:
            out[k:k + cnt_] = np.frombuffer(data[pos:pos + nb], np.uint8)
            pos += nb
        else:
            out[k:k + cnt_] = np.frombuffer(data[pos:pos + cnt_ * nb],
                                            np.uint8).reshape(-1, nb)
            pos += cnt * nb
        k += cnt_
    return out


def _tga_check(path: str, data: bytes):
    """Refuse a TGA header PIL does not read either (ValueError): an
    image type other than 1, 2, 3 and their run-length forms, or a short
    header."""
    if len(data) < 18:
        raise ValueError(f"{path}: truncated TGA header")
    itype = data[2]
    if itype not in (1, 2, 3, 9, 10, 11):
        raise ValueError(f"{path}: TGA image type {itype}")


def _tga_bits(data, pos: int, w: int, h: int):
    """A 1-bit gray TGA's rows as 0 / 255 [h, w]: rows of ceil(w / 8)
    bytes, most significant bit first."""
    stride = (w + 7) // 8
    rows = np.frombuffer(data[pos:pos + stride * h], np.uint8)
    if len(rows) < stride * h:
        raise ValueError("truncated TGA pixel data")
    bits = np.unpackbits(rows.reshape(h, stride), axis=1)[:, :w]
    return (bits * 255).astype(np.uint8)


def read_tga(path: str) -> np.ndarray:
    """A Truevision TGA as uint8 RGB [H, W, 3]: image types 1, 2, 3 and
    their run-length forms 9, 10, 11; 8, 15, 16, 24 and 32 bits per pixel
    and 1-bit gray, uncompressed (a colour map of 15, 16, 24 or 32 bits);
    top-left or bottom-left origin; PIL's convert("RGB") of it."""
    with open(path, "rb") as f:
        data = f.read()
    _tga_check(path, data)
    (id_len, cm_type, itype, cm_first, cm_len, cm_depth, _, _, w, h, depth,
     flags) = struct.unpack("<BBBHHBHHHHBB", data[:18])
    pos = 18 + id_len
    cmap = None
    if cm_type:
        eb = (cm_depth + 7) // 8
        entries = np.frombuffer(data[pos:pos + cm_len * eb], np.uint8) \
            .reshape(-1, eb)
        pos += cm_len * eb
        cmap = np.zeros((cm_first + cm_len + 256, 3), np.uint8)
        cmap[cm_first:cm_first + len(entries)] = _tga_pixels(entries,
                                                             cm_depth)
    nb = (depth + 7) // 8
    if itype == 11 and depth == 1:
        raise ValueError(f"{path}: a run-length 1-bit TGA, which PIL's "
                         f"decoder fails on")
    if itype == 3 and depth == 1:
        img = np.repeat(_tga_bits(data, pos, w, h).reshape(-1, 1), 3,
                        axis=-1)
    elif itype >= 9:
        raw = _tga_rle(data, pos, w * h, nb)
    else:
        raw = np.frombuffer(data[pos:pos + w * h * nb], np.uint8)
        if len(raw) < w * h * nb:
            raise ValueError(f"{path}: truncated TGA pixel data")
        raw = raw.reshape(-1, nb)
    if itype in (3, 11) and depth == 1:
        pass
    elif itype in (1, 9):
        idx = raw[:, 0].astype(np.int64) if nb == 1 else \
            raw[:, 0].astype(np.int64) | (raw[:, 1].astype(np.int64) << 8)
        img = cmap[idx]
    elif itype in (3, 11):
        img = np.repeat(raw[:, :1], 3, axis=-1)
    else:
        img = _tga_pixels(raw, depth)
    img = img.reshape(h, w, 3)
    if not flags & 0x20:
        img = img[::-1]
    if flags & 0x10:
        img = img[:, ::-1]
    return np.ascontiguousarray(img)


def _ext(path: str) -> str:
    return path.rsplit(".", 1)[-1].lower() if "." in path else ""


def sniff(head: bytes, path: str) -> str:
    """The format of an 8-bit image file from its first 16 bytes, as
    PIL's Image.open finds it (by content; TGA, which has no magic
    number, by the extension): "png", "jpeg", "bmp", "gif", "tiff",
    "webp", "netpbm" or "tga". NotImplementedError for a format PIL opens
    and the port does not read (ROADMAP item 13), ValueError for a file
    PIL cannot identify either."""
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if head[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if head[:2] == b"BM":
        return "bmp"
    if head[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "tiff"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "webp"
    if head[:1] == b"P" and head[1:2] in (b"1", b"2", b"3", b"4", b"5",
                                          b"6"):
        return "netpbm"
    ext = _ext(path)
    if ext in _TGA_EXTS:
        return "tga"
    if ext not in _OWN_EXTS and ext in PIL_OPEN_EXTS \
            or head[:2] in (b"P0", b"Pf", b"Py") \
            or head[:4] in (b"II+\x00", b"MM\x00+"):
        raise NotImplementedError(f"{path}: the .{ext} image format (or "
                                  f"this variant of it) is {ITEM_13}")
    raise ValueError(f"{path}: not an image file PIL identifies")


def _head(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read(16)


def probe_image(path: str):
    """Raise NotImplementedError where `path` is an image the JAX package
    reads through PIL and read_ldr does not (ROADMAP item 13), from its
    header alone. Data PIL cannot decode either is left to read_ldr,
    which raises ValueError for it."""
    try:
        kind = sniff(_head(path), path)
        if kind not in ("jpeg", "tiff", "netpbm"):
            return
        with open(path, "rb") as f:
            data = f.read()
        if kind == "jpeg":
            from . import jpeg
            jpeg.probe(data)
        elif kind == "tiff":
            from . import tiff
            tiff.probe(data)
        else:
            from . import netpbm
            netpbm.header(data)
    except ValueError:
        # PIL cannot decode it either: read_ldr's ValueError
        pass


def read_ldr(path: str, device=None) -> np.ndarray:
    """An 8-bit image as PIL's Image.open(path).convert("RGB") gives it:
    uint8 [H, W, 3], the format found by sniff. A JPEG's block stage
    (also a JPEG-compressed TIFF's) runs on `device` (the card unless
    "cpu")."""
    kind = sniff(_head(path), path)
    if kind == "png":
        return png_rgb(read_png(path))
    if kind == "jpeg":
        from . import jpeg
        u8 = jpeg.read_jpeg(path, device).cpu().numpy()
        return np.repeat(u8[..., None], 3, axis=-1) if u8.ndim == 2 else u8
    if kind == "bmp":
        return read_bmp(path)
    if kind == "tga":
        return read_tga(path)
    if kind == "netpbm":
        from . import netpbm
        return netpbm.read_netpbm(path)
    if kind == "tiff":
        from . import tiff
        return tiff.read_tiff(path, device)
    if kind == "gif":
        from . import gif
        return gif.read_gif(path)
    from . import webp
    return webp.read_webp(path)


def read_image(path: str, device=None) -> np.ndarray:
    """Load any supported bitmap, the JAX package's read_image dispatch:
    HDR, PFM, EXR and .npy linear; PNG, JPEG, BMP, TGA, Netpbm, TIFF, GIF
    and WebP as gamma-encoded [0, 1] float32 RGB (PIL's convert("RGB") /
    255; read_ldr). A JPEG's block stage runs on `device` (the card
    unless "cpu"). The formats PIL opens beyond those, and the variants
    probe_image finds, are not ported (ROADMAP item 13) and raise
    NotImplementedError; data PIL cannot decode either raises
    ValueError."""
    ext = _ext(path)
    if ext == "hdr":
        return read_hdr(path)
    if ext == "pfm":
        return read_pfm(path)
    if ext == "exr":
        from . import exr as exr_mod
        return exr_mod.read_exr(path)
    if ext == "npy":
        return np.load(path).astype(np.float32)
    return read_ldr(path, device).astype(np.float32) / 255.0


def annotate_image(img: np.ndarray, labels, subst: dict | None = None,
                   banner: bool = False) -> np.ndarray:
    """Draw the film's label[] annotations and the banner onto a
    gamma-encoded float [0, 1] image, as the JAX package's annotate_image
    does (reference: src/films/annotations.h, banner.h): `$source['key']`
    placeholders substituted from `subst` (floats with 2 decimals, an
    unknown key as ""), each label white with its top-left at (x, y), the
    banner "hairpt" in (160, 160, 160) at (W - its width - 4, H - 14).
    The text is the port's bitmap font (utils/font.py), clipped to the
    image; the JAX package's is PIL's font. Returns the 8-bit image / 255,
    float32."""
    from . import font
    u8 = _to_u8(img).copy()
    for x, y, text in labels or ():
        font.draw_text(u8, int(x), int(y), font.substitute(str(text), subst),
                       (255, 255, 255))
    if banner:
        tag = "hairpt"
        font.draw_text(u8, u8.shape[1] - font.text_width(tag) - 4,
                       u8.shape[0] - 14, tag, (160, 160, 160))
    return u8.astype(np.float32) / 255.0


def write_npy(path: str, img: np.ndarray):
    np.save(path, np.asarray(img, np.float32))


def write_pfm(path: str, img: np.ndarray):
    """Portable FloatMap, float32 RGB (hdrfilm PFM output)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little endian
        f.write(np.flipud(img).astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        assert f.readline().strip() == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    return np.flipud(data.reshape(h, w, 3)).copy()


def tonemap_srgb(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    return np.clip(np.asarray(img), 0.0, 1.0) ** (1.0 / gamma)
