"""Image / array IO (port of hairpt/utils/io.py).

PNG (ldrfilm), .npy (the fork's mfilm addition), PFM (hdrfilm) and
Radiance RGBE .hdr input (envmap textures), as in the JAX package. The
JAX package writes PNG, BMP and TGA through PIL; the port writes them
itself with numpy and zlib, so it needs no imaging library: PNG as one
zlib IDAT of unfiltered rows (filter byte 0) with CRCs from zlib.crc32,
BMP as a 24-bit bottom-up bitmap, TGA as an uncompressed true-colour
image. The JAX package reads LDR images (bitmap textures, normal and bump
maps, heightfields, envmaps) through PIL; the port reads PNG itself
(read_png: 8-bit gray, gray + alpha, RGB and RGBA, the five scanline
filters, not interlaced). Other PNGs, JPEG input and output are not
ported yet (ROADMAP item 13) and raise.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

ITEM_13 = "not ported yet (ROADMAP item 13)"


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


def write_jpg(path: str, img: np.ndarray, quality: int = 95):
    raise NotImplementedError(f"JPEG output is {ITEM_13}")


# colour type -> channels, for the 8-bit PNGs read_png takes
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG of colour type gray, gray + alpha, RGB
    or RGBA as uint8 [H, W] (gray) or [H, W, C], PIL's array layout.
    Any other PNG raises NotImplementedError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"{path}: PNG with bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}: only 8-bit, non-interlaced gray, gray + "
            f"alpha, RGB and RGBA are read; the rest is {ITEM_13}")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, f = int(raw[y, 0]), raw[y, 1:]
        if ft == 0:
            row = f.copy()
        elif ft == 1:
            row = np.cumsum(f.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
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
    img = out.reshape(h, w, bpp)
    return img[..., 0] if bpp == 1 else img


def png_rgb(img: np.ndarray) -> np.ndarray:
    """read_png's array as RGB (PIL's convert("RGB"): gray replicated,
    alpha dropped)."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


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
