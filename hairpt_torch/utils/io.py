"""Image / array IO (port of hairpt/utils/io.py).

PNG (ldrfilm), .npy (the fork's mfilm addition), PFM (hdrfilm) and
Radiance RGBE .hdr input (envmap textures), as in the JAX package. The
JAX package writes PNG, BMP and TGA through PIL; the port writes them
itself with numpy and zlib, so it needs no imaging library: PNG as one
zlib IDAT of unfiltered rows (filter byte 0) with CRCs from zlib.crc32,
BMP as a 24-bit bottom-up bitmap, TGA as an uncompressed true-colour
image. JPEG output and the LDR readers (PNG / JPEG envmaps and textures)
are not ported yet (ROADMAP item 13) and raise.
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


def read_png(path: str) -> np.ndarray:
    raise NotImplementedError(f"reading PNG images is {ITEM_13}")


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
