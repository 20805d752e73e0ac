"""GIF images (GIF87a and GIF89a), as the JAX package reads them through
PIL: frame 0 as Pillow's GIF plugin composes it, then convert("RGB").

Pillow's rules for frame 0, which read_gif follows: the canvas is the
logical screen, grown to hold the frame where the frame reaches past it;
it starts as palette index 0, or as the frame's transparent index where
its graphic control extension sets one; the frame's pixels (the
transparent index among them) are written over its rectangle, rows in
the four interlace passes where the frame is interlaced; the palette is
the frame's local table, else the global one (no table at all: the index
is the gray level); an index past the table's entries is black. The
image data is LZW with codes least significant bit first, from the
minimum code size up to 12 bits, Clear and End codes, and the table kept
full at 4,096 entries until a Clear. Data that ends before the frame's
End code raises ValueError, as Pillow's decoder fails on it.
"""
from __future__ import annotations

import struct

import numpy as np


def lzw_gif(data: bytes, min_size: int, n_pixels: int):
    """The GIF LZW indices of one frame (at most n_pixels) and whether
    the End code was reached."""
    clear = 1 << min_size
    eoi = clear + 1
    size = min_size + 1
    table = [bytes([i]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    prev = None
    bitbuf = nbuf = i = 0
    n = len(data)
    while len(out) < n_pixels:
        while nbuf < size:
            if i >= n:
                return bytes(out), False
            bitbuf |= data[i] << nbuf
            i += 1
            nbuf += 8
        code = bitbuf & ((1 << size) - 1)
        bitbuf >>= size
        nbuf -= size
        if code == clear:
            table = table[:clear + 2]
            size = min_size + 1
            prev = None
            continue
        if code == eoi:
            return bytes(out), True
        if prev is None:
            if code >= len(table):
                raise ValueError("corrupt GIF LZW data")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and len(table) < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt GIF LZW data")
        out += entry
        prev = entry
        if len(table) == (1 << size) and size < 12:
            size += 1
    return bytes(out[:n_pixels]), True


def _blocks(data: bytes, pos: int):
    """The concatenated data sub-blocks from pos and the position after
    their terminator."""
    out = []
    while pos < len(data):
        k = data[pos]
        pos += 1
        if k == 0:
            return b"".join(out), pos, True
        out.append(data[pos:pos + k])
        pos += k
    return b"".join(out), pos, False


def _palette(p: bytes):
    """A colour table as [256, 3] uint8 (black past its entries) and
    whether Pillow keeps it (an identity gray ramp is dropped: mode L,
    the same pixels)."""
    pal = np.zeros((256, 3), np.uint8)
    v = np.frombuffer(p, np.uint8).reshape(-1, 3)
    pal[:len(v)] = v
    return pal


def read_gif(path: str) -> np.ndarray:
    """Frame 0 of a GIF as uint8 RGB [H, W, 3], PIL's
    Image.open(path).convert("RGB")."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{path}: not a GIF file")
    sw, sh, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    gpal = None
    if flags & 0x80:
        nb = 3 << ((flags & 7) + 1)
        gpal = _palette(data[pos:pos + nb])
        pos += nb
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError(f"{path}: a GIF without an image")
        c = data[pos]
        pos += 1
        if c == 0x21:
            label = data[pos]
            pos += 1
            block, pos, _ = _blocks(data, pos)
            if label == 0xF9 and block and block[0] & 1 and len(block) >= 4:
                transparency = block[3]
            continue
        if c != 0x2C:
            # Pillow skips any other byte between blocks
            continue
        if pos + 9 > len(data):
            raise ValueError(f"{path}: truncated GIF image descriptor")
        x0, y0, fw, fh, fl = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        pal = gpal
        if fl & 0x80:
            nb = 3 << ((fl & 7) + 1)
            pal = _palette(data[pos:pos + nb])
            pos += nb
        break
    if pos >= len(data):
        raise ValueError(f"{path}: truncated GIF image data")
    min_size = data[pos]
    if not 1 <= min_size <= 11:
        raise ValueError(f"{path}: GIF LZW code size {min_size}")
    lzw, pos, _ = _blocks(data, pos + 1)
    idx, ended = lzw_gif(lzw, min_size, fw * fh)
    if not ended and len(idx) < fw * fh:
        raise ValueError(f"{path}: truncated GIF image data")
    W, H = max(sw, x0 + fw), max(sh, y0 + fh)
    canvas = np.full((H, W), transparency or 0, np.uint8)
    frame = np.frombuffer(idx, np.uint8)
    if fw and fh:
        rows = np.arange(fh)
        if fl & 0x40:
            rows = np.concatenate([rows[0::8], rows[4::8], rows[2::4],
                                   rows[1::2]])
        full = len(frame) // fw
        ys = rows[:full]
        canvas[y0 + ys, x0:x0 + fw] = frame[:full * fw].reshape(full, fw)
        rest = len(frame) - full * fw
        if rest and full < fh:
            canvas[y0 + rows[full], x0:x0 + rest] = frame[full * fw:]
    if pal is None:
        return np.repeat(canvas[..., None], 3, axis=-1)
    return pal[canvas]
