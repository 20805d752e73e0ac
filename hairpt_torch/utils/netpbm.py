"""Netpbm images (PBM, PGM, PPM: P1-P6), as the JAX package reads them
through PIL's PPM plugin and writes them with its PPM writer.

The header is the magic number, then whitespace-separated width, height
and (but for the bitmaps) maxval, with `#` comments to the end of a line;
the raster starts after the one whitespace byte that ends the last
token. What PIL's convert("RGB") then gives, and so read_netpbm:
- P1 / P4 bitmaps: 1 is black (0), 0 white (255); P4 rows padded to a
  byte, most significant bit first.
- P2 / P5 gray: maxval 255 as is; maxval 65,535 (raw) the 16-bit value
  clipped to 255; any other maxval scaled to 0..255 when it is below 256
  and to 0..65,535 above it, rounding half to even (Python's round of
  v / maxval * top), then clipped to 255.
- P3 / P6 colour: each sample scaled to 0..255 the same way (16-bit
  samples above maxval 255, big-endian).
PIL's own extensions (Pf, P0CMYK, PyP, ...) are not read (ROADMAP item
13); corrupt or truncated data raises ValueError.
"""
from __future__ import annotations

import numpy as np

_WS = b" \t\n\x0b\x0c\r"
_MAGIC = {b"P1": 1, b"P2": 2, b"P3": 3, b"P4": 4, b"P5": 5, b"P6": 6}
# the magic numbers PIL's plugin opens beyond P1-P6
_PIL_ONLY = (b"Pf", b"P0CMYK", b"PyP", b"PyRGBA", b"PyCMYK")


def _token(data: bytes, pos: int):
    """PIL's header token from pos: whitespace skipped, `#` comments to
    the next CR or LF dropped; (token, the position after the whitespace
    byte that ended it)."""
    tok = b""
    n = len(data)
    while len(tok) <= 10:
        if pos >= n:
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WS:
            if not tok:
                continue
            break
        if c == b"#":
            while pos < n and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        tok += c
    if not tok or len(tok) > 10 or not tok.isdigit():
        raise ValueError(f"bad Netpbm header token {tok[:12]!r}")
    return int(tok), pos


def header(data: bytes):
    """(kind 1..6, width, height, maxval, raster offset); maxval 1 for the
    bitmaps. NotImplementedError for PIL's own extensions."""
    magic = b""
    pos = 0
    while pos < min(len(data), 6):
        c = data[pos:pos + 1]
        pos += 1
        if c in _WS:
            break
        magic += c
    if magic in _PIL_ONLY:
        raise NotImplementedError(f"the {magic.decode()} Netpbm extension "
                                  f"is not ported yet (ROADMAP item 13)")
    if magic not in _MAGIC:
        raise ValueError("not a Netpbm file")
    kind = _MAGIC[magic]
    w, pos = _token(data, pos)
    h, pos = _token(data, pos)
    maxval = 1
    if kind not in (1, 4):
        maxval, pos = _token(data, pos)
        if not 0 < maxval < 65536:
            raise ValueError(f"Netpbm maxval {maxval}")
    return kind, w, h, maxval, pos


def _plain_tokens(body: bytes) -> bytes:
    """The raster of a plain (ASCII) file with its `#` comments (to the
    next CR or LF) removed."""
    out = []
    i = 0
    while True:
        j = body.find(b"#", i)
        if j < 0:
            out.append(body[i:])
            break
        out.append(body[i:j])
        ends = [e for e in (body.find(b"\n", j), body.find(b"\r", j))
                if e >= 0]
        if not ends:
            break
        i = min(ends) + 1
    return b"".join(out)


def _scale(v, maxval: int, top: int):
    """round(v / maxval * top) with Python's rounding (half to even)."""
    return np.round(v.astype(np.float64) / maxval * top)


def read_netpbm(path: str) -> np.ndarray:
    """A P1-P6 file as uint8 RGB [H, W, 3], PIL's convert("RGB") of it."""
    with open(path, "rb") as f:
        data = f.read()
    kind, w, h, maxval, pos = header(data)
    bands = 3 if kind in (3, 6) else 1
    n = w * h * bands
    body = data[pos:]
    if kind == 1:
        bits = np.frombuffer(b"".join(_plain_tokens(body).split()), np.uint8)
        if bits.size < w * h or not np.isin(bits[:w * h], (48, 49)).all():
            raise ValueError(f"{path}: bad or truncated P1 raster")
        g = np.where(bits[:w * h] == 49, 0, 255).astype(np.uint8)
    elif kind == 4:
        stride = (w + 7) // 8
        raw = np.frombuffer(body[:stride * h], np.uint8)
        if raw.size < stride * h:
            raise ValueError(f"{path}: truncated P4 raster")
        bits = np.unpackbits(raw.reshape(h, stride), axis=1)[:, :w]
        g = np.where(bits == 1, 0, 255).astype(np.uint8)
    else:
        if kind in (2, 3):
            toks = _plain_tokens(body).split()[:n]
            if len(toks) < n or any(len(t) > 10 for t in toks):
                raise ValueError(f"{path}: bad or truncated plain raster")
            v = np.array([int(t) for t in toks], np.int64)
            if (v < 0).any() or (v > maxval).any():
                raise ValueError(f"{path}: a sample outside 0..{maxval}")
            top = 65535 if maxval > 255 and bands == 1 else 255
            g = np.minimum(_scale(v, maxval, top), 255).astype(np.uint8)
        else:
            wide = maxval > 255
            raw = np.frombuffer(body[:n * (2 if wide else 1)],
                                ">u2" if wide else np.uint8)
            if raw.size < n:
                raise ValueError(f"{path}: truncated raw raster")
            if maxval == 255:
                g = raw
            elif maxval == 65535 and bands == 1:
                g = np.minimum(raw, 255).astype(np.uint8)
            else:
                top = 65535 if wide and bands == 1 else 255
                g = np.minimum(np.minimum(_scale(raw, maxval, top), top),
                               255).astype(np.uint8)
    g = np.asarray(g, np.uint8).reshape(h, w, bands)
    return np.ascontiguousarray(np.repeat(g, 3, -1) if bands == 1 else g)


def encode_p6(u8: np.ndarray) -> bytes:
    """A binary PPM of uint8 RGB [H, W, 3], PIL's bytes for it."""
    h, w = u8.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
        u8, np.uint8).tobytes()
