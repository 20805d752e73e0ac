"""WebP images, as the JAX package reads them through PIL: Pillow's WebP
plugin decodes with libwebp's WebPAnimDecoder (its RGBA mode) and
convert("RGB") drops the alpha. read_webp gives the same uint8 RGB, with
no imaging library:

- the RIFF container: a simple file (one VP8 or VP8L chunk), or VP8X
  with its canvas, ALPH (the alpha plane, which convert("RGB") drops),
  ICCP, EXIF and XMP (skipped), and ANIM / ANMF: the first frame, which
  WebPAnimDecoder draws at its offset on a canvas of zeros (black where
  the frame does not cover it; the first frame is not blended).
- VP8L (lossless, libwebp's vp8l_dec.c): the LSB-first bit reader,
  canonical Huffman codes (simple and normal, with the code-length code
  and its repeat codes), meta Huffman codes, the color cache, LZ77
  backward references with the 120 plane codes, and the inverse
  predictor (14 modes), cross-color, subtract-green and color-indexing
  transforms.
- VP8 (lossy, libwebp's vp8_dec.c, tree_dec.c, quant_dec.c and
  frame_dec.c): libwebp's boolean decoder (VP8GetBit, VP8GetSigned),
  the frame header with segments, quantizers and loop-filter deltas,
  the coefficient probabilities (the VP8 defaults and update
  probabilities of RFC 6386), the intra modes (16 x 16, 4 x 4 and
  chroma), the tokens with their contexts, dequantization, the inverse
  WHT and DCT, intra prediction from the unfiltered neighbours (127 above
  the frame, 129 left of it), then the simple or normal loop filter over
  the frame in macroblock order.
- libwebp's default output path: fancy upsampling of the chroma (its
  UpsampleRgbaLinePair, the first and an even height's last row
  mirrored) and its 14-bit fixed-point YUV to RGB (VP8YUVToR/G/B).

The decoders are bit-serial Python over numpy on the host (no tensor
stage: the work is the entropy decoding); the scene loader logs their
seconds.
Data libwebp rejects raises ValueError, as PIL fails on it.
"""
from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# the RIFF container
# ---------------------------------------------------------------------------


def _chunks(data: bytes, pos: int, end: int):
    """[(fourcc, payload)] from pos to end; a chunk cut short raises."""
    out = []
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if len(body) < size:
            raise ValueError("truncated WebP chunk")
        out.append((tag, body))
        pos += 8 + size + (size & 1)
    return out


def _u24(b: bytes) -> int:
    return b[0] | (b[1] << 8) | (b[2] << 16)


def _first_frame(data: bytes):
    """(canvas width, height, frame x, y, fourcc, bitstream) of the first
    frame, as WebPDemux gives it to WebPAnimDecoder."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    riff = struct.unpack("<I", data[4:8])[0]
    if riff + 8 > len(data):
        raise ValueError("truncated WebP file")
    chunks = _chunks(data, 12, riff + 8)
    if not chunks:
        raise ValueError("a WebP file without chunks")
    tag, body = chunks[0]
    if tag in (b"VP8 ", b"VP8L"):
        w, h = _bitstream_size(tag, body)
        return w, h, 0, 0, tag, body
    if tag != b"VP8X" or len(body) < 10:
        raise ValueError(f"a WebP file starting with chunk {tag!r}")
    cw, ch = 1 + _u24(body[4:7]), 1 + _u24(body[7:10])
    for tag, b in chunks[1:]:
        if tag == b"ANMF":
            if len(b) < 16:
                raise ValueError("truncated ANMF chunk")
            x0, y0 = 2 * _u24(b[0:3]), 2 * _u24(b[3:6])
            for t2, b2 in _chunks(b, 16, len(b)):
                if t2 in (b"VP8 ", b"VP8L"):
                    return cw, ch, x0, y0, t2, b2
            raise ValueError("an ANMF chunk without a bitstream")
        if tag in (b"VP8 ", b"VP8L"):
            return cw, ch, 0, 0, tag, b
    raise ValueError("a WebP file without a bitstream")


def _bitstream_size(tag, body):
    if tag == b"VP8L":
        if len(body) < 5 or body[0] != 0x2F:
            raise ValueError("bad VP8L signature")
        bits = int.from_bytes(body[1:5], "little")
        if bits >> 29:
            raise ValueError("VP8L version other than 0")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if len(body) < 10 or body[3:6] != b"\x9d\x01\x2a":
        raise ValueError("bad VP8 start code")
    return ((body[6] | (body[7] << 8)) & 0x3FFF,
            (body[8] | (body[9] << 8)) & 0x3FFF)


def read_webp(path: str) -> np.ndarray:
    """The first frame of a WebP file as uint8 RGB [H, W, 3], PIL's
    Image.open(path).convert("RGB")."""
    with open(path, "rb") as f:
        data = f.read()
    cw, ch, x0, y0, tag, body = _first_frame(data)
    try:
        if tag == b"VP8L":
            argb = decode_vp8l(body)
            rgb = np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF,
                            argb & 0xFF], -1).astype(np.uint8)
        else:
            rgb = decode_vp8(body)
    except (IndexError, KeyError) as e:
        raise ValueError(f"{path}: corrupt WebP bitstream ({e!r})")
    fh, fw = rgb.shape[:2]
    if x0 + fw > cw or y0 + fh > ch:
        raise ValueError(f"{path}: a WebP frame past its canvas")
    out = np.zeros((ch, cw, 3), np.uint8)
    out[y0:y0 + fh, x0:x0 + fw] = rgb
    return out


# ---------------------------------------------------------------------------
# VP8L (lossless)
# ---------------------------------------------------------------------------

class _LBits:
    """VP8L's bit reader: least significant bit first."""
    __slots__ = ("data", "pos", "buf", "n", "used")

    def __init__(self, data: bytes, start: int):
        self.data, self.pos, self.buf, self.n, self.used = data, start, 0, 0, \
            8 * start

    def fill(self, k: int):
        while self.n < k:
            if self.pos < len(self.data):
                self.buf |= self.data[self.pos] << self.n
            self.pos += 1
            self.n += 8

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        if self.n < k:
            self.fill(k)
        v = self.buf & ((1 << k) - 1)
        self.buf >>= k
        self.n -= k
        self.used += k
        return v


def _reverse(code: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r


_ROOT = 8


def _huffman(lengths):
    """A canonical Huffman code from its code lengths, as a decoding table
    (root table over the next _ROOT bits, longer codes by (length, bits));
    one symbol: a zero-bit code. An incomplete or over-full code raises,
    as libwebp rejects it."""
    nz = sorted((ln, s) for s, ln in enumerate(lengths) if ln)
    if not nz:
        raise ValueError("a VP8L Huffman code without symbols")
    if len(nz) == 1:
        return None, 0, nz[0][1], 0
    if sum(1 << (15 - ln) for ln, _ in nz) != 1 << 15:
        raise ValueError("an incomplete VP8L Huffman code")
    maxlen = nz[-1][0]
    root = [None] * (1 << _ROOT)
    long = {}
    code, prev = 0, nz[0][0]
    for ln, s in nz:
        code <<= ln - prev
        prev = ln
        rev = _reverse(code, ln)
        if ln <= _ROOT:
            for k in range(1 << (_ROOT - ln)):
                root[rev | (k << ln)] = (s, ln)
        else:
            long[(ln, rev)] = s
        code += 1
    return root, maxlen, None, long


def _symbol(br: _LBits, t) -> int:
    root, maxlen, single, long = t
    if root is None:
        return single
    if br.n < maxlen:
        br.fill(maxlen)
    e = root[br.buf & ((1 << _ROOT) - 1)]
    if e is not None:
        s, ln = e
    else:
        for ln in range(_ROOT + 1, maxlen + 1):
            s = long.get((ln, br.buf & ((1 << ln) - 1)))
            if s is not None:
                break
        else:
            raise ValueError("corrupt VP8L Huffman data")
    br.buf >>= ln
    br.n -= ln
    br.used += ln
    return s


_CODE_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14,
               15)


def _read_code(br: _LBits, size: int):
    """ReadHuffmanCode: a simple (one or two symbols) or a normal code."""
    lengths = [0] * size
    if br.read(1):
        n = br.read(1) + 1
        s0 = br.read(8 if br.read(1) else 1)
        syms = [s0] + ([br.read(8)] if n == 2 else [])
        for s in syms:
            if s >= size:
                raise ValueError("a VP8L simple code's symbol past its "
                                 "alphabet")
            lengths[s] = 1
        return _huffman(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CODE_ORDER[i]] = br.read(3)
    table = _huffman(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > size:
            raise ValueError("a VP8L code's max_symbol past its alphabet")
    else:
        max_symbol = size
    sym, prev = 0, 8
    while sym < size:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = _symbol(br, table)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
        else:
            slot = c - 16
            rep = br.read((2, 3, 7)[slot]) + (3, 3, 11)[slot]
            if sym + rep > size:
                raise ValueError("a VP8L code-length repeat past its "
                                 "alphabet")
            v = prev if c == 16 else 0
            lengths[sym:sym + rep] = [v] * rep
            sym += rep
    return _huffman(lengths)


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _prefix(br: _LBits, sym: int) -> int:
    """A length or distance from its prefix symbol and extra bits."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


# the 120 short distance codes: (dx, dy), distance dx + dy * width
_PLANE = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1),
    (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1), (-3, 1),
    (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0), (1, 4), (-1, 4), (4, 1),
    (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2), (-4, 2), (0, 5),
    (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0), (1, 5), (-1, 5), (5, 1),
    (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4), (-4, 4), (3, 5),
    (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0), (1, 6), (-1, 6), (6, 1),
    (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5), (-4, 5), (5, 4),
    (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7),
    (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1), (4, 6), (-4, 6), (6, 4),
    (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2), (3, 7), (-3, 7), (7, 3),
    (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7), (-4, 7),
    (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6), (8, 3), (5, 7),
    (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6),
    (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))


def _pixels(br: _LBits, w: int, h: int, groups, meta, meta_bits: int,
            meta_w: int, cache_bits: int):
    """DecodeImageData: literals, backward references and color-cache
    hits -> ARGB words [w * h]."""
    n = w * h
    out = [0] * n
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0
    i = 0
    g = groups[0]
    while i < n:
        if meta is not None:
            y, x = divmod(i, w)
            g = groups[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        code = _symbol(br, g[0])
        if code < 256:
            r = _symbol(br, g[1])
            b = _symbol(br, g[2])
            a = _symbol(br, g[3])
            out[i] = (a << 24) | (r << 16) | (code << 8) | b
            i += 1
        elif code < 280:
            length = _prefix(br, code - 256)
            dcode = _prefix(br, _symbol(br, g[4]))
            if dcode > 120:
                dist = dcode - 120
            else:
                dx, dy = _PLANE[dcode - 1]
                dist = max(dx + dy * w, 1)
            if dist > i or length > n - i:
                raise ValueError("a VP8L backward reference outside the "
                                 "image")
            for k in range(i, i + length):
                out[k] = out[k - dist]
            i += length
        else:
            key = code - 280
            if cache is None or key >= len(cache):
                raise ValueError("a VP8L color-cache code without its cache")
            while cached < i:
                c = out[cached]
                cache[((c * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = c
                cached += 1
            out[i] = cache[key]
            i += 1
    return out


def _stream(br: _LBits, w: int, h: int, level0: bool):
    """DecodeImageStream: transforms (level 0), color cache, meta Huffman
    codes (level 0), the codes, the pixels; the transforms undone."""
    transforms, tw = [], w
    if level0:
        seen = set()
        while br.read(1):
            t = br.read(2)
            if t in seen:
                raise ValueError("a VP8L transform used twice")
            seen.add(t)
            if t in (0, 1):
                bits = br.read(3) + 2
                sub = _stream(br, _sub(tw, bits), _sub(h, bits), False)
                transforms.append((t, tw, bits, sub))
            elif t == 2:
                transforms.append((2, tw, 0, None))
            else:
                ncol = br.read(8) + 1
                bits = 0 if ncol > 16 else 1 if ncol > 4 else 2 if ncol > 2 \
                    else 3
                pal = _stream(br, ncol, 1, False)
                transforms.append((3, tw, bits, pal))
                tw = _sub(tw, bits)
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"VP8L color cache of {cache_bits} bits")
    meta, meta_bits, meta_w, ngroups = None, 0, 0, 1
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = _sub(tw, meta_bits)
        meta = [(p >> 8) & 0xFFFF for p in
                _stream(br, meta_w, _sub(h, meta_bits), False)]
        ngroups = max(meta) + 1
    green = 256 + 24 + ((1 << cache_bits) if cache_bits else 0)
    groups = [[_read_code(br, s) for s in (green, 256, 256, 256, 40)]
              for _ in range(ngroups)]
    pix = _pixels(br, tw, h, groups, meta, meta_bits, meta_w, cache_bits)
    if not level0:
        return pix
    img = np.asarray(pix, np.int64).reshape(h, tw)
    for t in reversed(transforms):
        img = _undo(t, img)
    return img


def _channels(p):
    return (p >> 24) & 0xFF, (p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF


def _avg2(a, b):
    return tuple((x + y) >> 1 for x, y in zip(a, b))


def _clip255(v):
    return 0 if v < 0 else 255 if v > 255 else v


def _predict(mode, L, T, TR, TL):
    """VP8L's predictors on (a, r, g, b) tuples."""
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg2(_avg2(L, TR), T)
    if mode == 6:
        return _avg2(L, TL)
    if mode == 7:
        return _avg2(L, T)
    if mode == 8:
        return _avg2(TL, T)
    if mode == 9:
        return _avg2(T, TR)
    if mode == 10:
        return _avg2(_avg2(L, TL), _avg2(T, TR))
    if mode == 11:
        pa_pb = sum(abs(lc - c) - abs(t - c) for lc, t, c in zip(L, T, TL))
        return T if pa_pb <= 0 else L
    if mode == 12:
        return tuple(_clip255(a + b - c) for a, b, c in zip(L, T, TL))
    if mode == 13:
        ave = _avg2(L, T)
        # C's division truncates toward zero
        return tuple(_clip255(a + int((a - c) / 2)) for a, c in zip(ave, TL))
    return (255, 0, 0, 0)


def _undo(t, img):
    """One inverse transform on ARGB int64 [h, width]."""
    kind, width, bits, data = t
    h = img.shape[0]
    if kind == 2:
        g = (img >> 8) & 0xFF
        r = (((img >> 16) & 0xFF) + g) & 0xFF
        b = ((img & 0xFF) + g) & 0xFF
        return (img & 0xFF00FF00) | (r << 16) | b
    if kind == 3:
        pal = [0] * (256 if bits == 0 else 1 << (8 >> bits))
        prev = (0, 0, 0, 0)
        for k, p in enumerate(data):
            c = tuple((x + y) & 0xFF for x, y in zip(_channels(p), prev))
            prev = c
            if k < len(pal):
                pal[k] = (c[0] << 24) | (c[1] << 16) | (c[2] << 8) | c[3]
        pal = np.asarray(pal, np.int64)
        x = np.arange(width)
        packed = (img[:, x >> bits] >> 8) & 0xFF
        bpp = 8 >> bits
        idx = (packed >> ((x & ((1 << bits) - 1)) * bpp)) & ((1 << bpp) - 1)
        return pal[idx]
    tiles = _sub(width, bits)
    sub = np.asarray(data, np.int64).reshape(-1, tiles)
    ys, xs = np.arange(h) >> bits, np.arange(width) >> bits
    per = sub[ys[:, None], xs[None, :]]
    if kind == 1:
        def s8(v):
            return ((v & 0xFF) ^ 0x80) - 0x80
        g2r, g2b, r2b = s8(per), s8(per >> 8), s8(per >> 16)
        g = s8(img >> 8)
        r = (((img >> 16) & 0xFF) + ((g2r * g) >> 5)) & 0xFF
        b = ((img & 0xFF) + ((g2b * g) >> 5) + ((r2b * s8(r)) >> 5)) & 0xFF
        return (img & 0xFF00FF00) | (r << 16) | b
    # predictor: row by row, each pixel from its decoded neighbours
    modes = ((per >> 8) & 0xF).tolist()
    res = img.tolist()
    out = [[(0, 0, 0, 0)] * width for _ in range(h)]
    for y in range(h):
        row, orow = res[y], out[y]
        up = out[y - 1] if y else None
        for x in range(width):
            if y == 0:
                p = (255, 0, 0, 0) if x == 0 else orow[x - 1]
            elif x == 0:
                p = up[0]
            else:
                tr = up[x + 1] if x + 1 < width else orow[0]
                p = _predict(modes[y][x], orow[x - 1], up[x], tr, up[x - 1])
            orow[x] = tuple((a + b) & 0xFF for a, b in
                            zip(_channels(row[x]), p))
    a = np.asarray(out, np.int64).reshape(h, width, 4)
    return (a[..., 0] << 24) | (a[..., 1] << 16) | (a[..., 2] << 8) | a[..., 3]


def decode_vp8l(body: bytes) -> np.ndarray:
    """A VP8L bitstream -> ARGB int64 [H, W]."""
    w, h = _bitstream_size(b"VP8L", body)
    br = _LBits(body, 5)
    img = _stream(br, w, h, True)
    if br.used > 8 * len(body):
        raise ValueError("truncated VP8L bitstream")
    return img


# the VP8 tables as hex strings (RFC 6386)
_UPD_HEX = (
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0"
    "f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdfffffffffffffffffff4"
    "fcffffffffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6fe"
    "ffffffffffffffffeffdfefffffffffffffffffefffefffffffffffffffffff8feff"
    "fffffffffffffffbfffefffffffffffffffffffffffffffffffffffffffffdfeffff"
    "fffffffffffffbfefefffffffffffffffffefffefffffffffffffffffffefdfffeff"
    "fffffffffffafffefffefffffffffffffeffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffd9ffffffffffffff"
    "ffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffffffff"
    "ffffdffefeffffffffffffffffeefdfefefffffffffffffffff8feffffffffffffff"
    "fff9fefffffffffffffffffffffffffffffffffffffffffffdffffffffffffffffff"
    "f7fefffffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffc"
    "fffffffffffffffffffffffffffffffffffffffffffffefefffffffffffffffffdff"
    "fffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffff"
    "fffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feff"
    "fffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeffffff"
    "fffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffff"
    "fffffffffffffffffffffffffffffffffefffffffffffffffffffefeffffffffffff"
    "fffffffefffffffffffffffffffffffffffffffffffffffffffeffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffff8fffffffffffffffffffffafefcfefffffffffffffff8fe"
    "f9fdfffffffffffffffffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefb"
    "fefefffffffffffffffefcfffffffffffffffff8fefdfffffffffffffffffdfffefe"
    "fffffffffffffffffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffff"
    "fffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffeffffffff"
    "fffffffffffffcfffffffffffffffffff9fffefffffffffffffffffffffeffffffff"
    "fffffffffffffdfffffffffffffffffaffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffff")

_P0_HEX = (
    "808080808080808080808080808080808080808080808080808080808080808080fd"
    "88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162"
    "f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9"
    "fff3ff8080808080b896f7ffece080808080804d6ed8ffece680808080800165fbff"
    "f1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5"
    "ff8080808080cfa0faffee8080808080806667e7ffd3ab80808080800198fcfff0ff"
    "8080808080b187f3ffeae180808080805081d3ffc2e080808080800101ff80808080"
    "80808080f601ff8080808080808080ff80808080808080808080c623eddfc1bba2a0"
    "919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ffff80"
    "8080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff"
    "806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff8080808080"
    "6db2f1ffe7f5ffff8080802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e"
    "88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8f"
    "f1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798deb"
    "ffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ff"
    "ff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1"
    "b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fad3d1"
    "ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba80"
    "80808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff8080"
    "8080808d7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff808080"
    "80809501ff808080808080808001e2ff8080808080808080f7c0ff80808080808080"
    "80f080ff80808080808080800186fcffff808080808080d53efaffff808080808080"
    "375dff80808080808080808080808080808080808080808080808080808080808080"
    "80808080808080808080ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e"
    "8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2"
    "e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80184782db"
    "9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7"
    "c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4ad"
    "ffcb80808001def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ff"
    "ff8080800179ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd"
    "8080800101ff8080808080808080f401ff8080808080808080ee01ff808080808080"
    "8080")

_BMODES_HEX = (
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd11"
    "0d98721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e371388"
    "a021ce473f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64"
    "829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d41"
    "2669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511"
    "c2422d1966c5bd171216585893962a2e2dc4cd2b61b775552623b33d2735c8571a15"
    "2be8ab3822336872661d5d4d271c55ab3aa55a6240221674ce17222ba6496b36201a"
    "3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f5539323033c165"
    "239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d"
    "582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022"
    "c5ab29280566d3b70401dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952"
    "731a3bb33f3b5ab43ba65d499a282815748fd12227af2f0f10b722df312db72e1121"
    "b706620f20b7392e16188001361125412049731c801780cd2803097333c01206df57"
    "2509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6"
    "d51e221a8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ff"
    "a02b33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58"
    "685575af525f543559806471652d4b4f7b2f338051ab013911054766393529312621"
    "0d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a"
    "39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771c"
    "de25442d8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c"
    "4020c9554b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f14"
    "5287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db78016"
    "1a1183f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f"
    "1c551a555580802092ab120b073f90ab0404f6231b0a92aeab0c1a80be502363b450"
    "7e362d557e2f57b033291420654b808b769274805538290fb0ec5525093e471e1177"
    "76ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151bc402029"
    "1475978e1415a370130c3dc380300418")


# ---------------------------------------------------------------------------
# VP8 (lossy)
# ---------------------------------------------------------------------------

class _Bool:
    """libwebp's VP8BitReader: range_ is the range minus one, value_ holds
    the bits not yet consumed below position bits_; past the data, one
    zero byte and then zeros."""
    __slots__ = ("data", "pos", "end", "value", "range", "bits", "eof")

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.range, self.bits, self.eof = 0, 254, -8, False

    def _load(self):
        if self.pos < self.end:
            self.value = (self.value << 8) | self.data[self.pos]
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        rng = self.range
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = (rng * prob) >> 8
        if (self.value >> pos) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 7 ^ (rng.bit_length() - 1)
        self.bits -= shift
        self.range = (rng << shift) - 1
        return bit

    def signed(self, v: int) -> int:
        """VP8GetSigned: one bit at probability 1/2, taken as the sign."""
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range >> 1
        neg = (self.value >> pos) > split
        self.bits -= 1
        if neg:
            self.range = (self.range - 1) | 1
            self.value -= (split + 1) << pos
            return -v
        self.range |= 1
        return v

    def value_bits(self, n: int) -> int:
        v = 0
        while n > 0:
            n -= 1
            v |= self.bit(0x80) << n
        return v

    def signed_value(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.value_bits(1) else v


_DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20,
    21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69,
    70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86,
    87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112,
    114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143,
    145, 148, 151, 154, 157)
_AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96,
    98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173,
    177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229,
    234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# RFC 6386's coefficient update probabilities and default coefficient
# probabilities [4 types][8 bands][3 contexts][11], and the key frames'
# 4x4 mode probabilities [10 above][10 left][9], in libwebp's mode order
# (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
_UPD = np.frombuffer(bytes.fromhex("".join(_UPD_HEX)), np.uint8) \
    .reshape(4, 8, 3, 11).tolist()
_PROBA0 = np.frombuffer(bytes.fromhex("".join(_P0_HEX)), np.uint8) \
    .reshape(4, 8, 3, 11).tolist()
_BMODES = np.frombuffer(bytes.fromhex("".join(_BMODES_HEX)), np.uint8) \
    .reshape(10, 10, 9).tolist()
# 16x16 and chroma modes, numbered as the 4x4 modes they share
DC, TM, VE, HE = 0, 1, 2, 3


def _clip(v: int, m: int) -> int:
    return 0 if v < 0 else m if v > m else v


class _Header:
    """The key frame's header from the first partition."""

    def __init__(self, body: bytes):
        if len(body) < 10:
            raise ValueError("truncated VP8 frame header")
        bits = body[0] | (body[1] << 8) | (body[2] << 16)
        if bits & 1:
            raise ValueError("a VP8 interframe (not a key frame)")
        if (bits >> 1) & 7 > 3:
            raise ValueError("VP8 profile past 3")
        if not (bits >> 4) & 1:
            raise ValueError("a VP8 frame not for display")
        part0 = bits >> 5
        self.w, self.h = _bitstream_size(b"VP8 ", body)
        if self.w == 0 or self.h == 0:
            raise ValueError("an empty VP8 frame")
        if 10 + part0 > len(body):
            raise ValueError("truncated VP8 first partition")
        br = self.br = _Bool(body, 10, 10 + part0)
        br.value_bits(1)    # colour space
        br.value_bits(1)    # clamping type
        self.use_segment = br.value_bits(1)
        self.update_map, absolute = 0, 1
        quant, fstr, self.seg_probs = [0] * 4, [0] * 4, [255] * 3
        if self.use_segment:
            self.update_map = br.value_bits(1)
            if br.value_bits(1):
                absolute = br.value_bits(1)
                quant = [br.signed_value(7) if br.value_bits(1) else 0
                         for _ in range(4)]
                fstr = [br.signed_value(6) if br.value_bits(1) else 0
                        for _ in range(4)]
            if self.update_map:
                self.seg_probs = [br.value_bits(8) if br.value_bits(1)
                                  else 255 for _ in range(3)]
        simple = br.value_bits(1)
        level = br.value_bits(6)
        sharp = br.value_bits(3)
        ref_d, mode_d = [0] * 4, [0] * 4
        use_delta = br.value_bits(1)
        if use_delta and br.value_bits(1):
            for d in (ref_d, mode_d):
                for i in range(4):
                    if br.value_bits(1):
                        d[i] = br.signed_value(6)
        self.filter = 0 if level == 0 else 1 if simple else 2
        # token partitions
        nparts = 1 << br.value_bits(2)
        start, end = 10 + part0, len(body)
        if end - start < 3 * (nparts - 1):
            raise ValueError("truncated VP8 partition sizes")
        p = start + 3 * (nparts - 1)
        self.parts = []
        for i in range(nparts - 1):
            size = min(_u24(body[start + 3 * i:start + 3 * i + 3]), end - p)
            self.parts.append(_Bool(body, p, p + size))
            p += size
        if p >= end:
            raise ValueError("truncated VP8 token partitions")
        self.parts.append(_Bool(body, p, end))
        # quantizers (VP8ParseQuant)
        q0 = br.value_bits(7)
        dq = [br.signed_value(4) if br.value_bits(1) else 0
              for _ in range(5)]
        self.dqm = []
        for s in range(4):
            if self.use_segment:
                q = quant[s] + (0 if absolute else q0)
            elif s:
                self.dqm.append(self.dqm[0])
                continue
            else:
                q = q0
            y2ac = (_AC_TABLE[_clip(q + dq[2], 127)] * 101581) >> 16
            self.dqm.append((
                (_DC_TABLE[_clip(q + dq[0], 127)], _AC_TABLE[_clip(q, 127)]),
                (_DC_TABLE[_clip(q + dq[1], 127)] * 2, max(y2ac, 8)),
                (_DC_TABLE[_clip(q + dq[3], 117)],
                 _AC_TABLE[_clip(q + dq[4], 127)])))
        br.value_bits(1)    # refresh entropy probabilities: ignored
        self.proba = [[[[br.value_bits(8) if br.bit(_UPD[t][b][c][p])
                         else _PROBA0[t][b][c][p] for p in range(11)]
                        for c in range(3)] for b in range(8)]
                      for t in range(4)]
        self.use_skip = br.value_bits(1)
        self.skip_p = br.value_bits(8) if self.use_skip else 0
        # the loop filter's strengths per segment and 4x4 flag
        self.fstrength = []
        for s in range(4):
            base = level
            if self.use_segment:
                base = fstr[s] + (0 if absolute else level)
            row = []
            for i4 in (0, 1):
                lv = base
                if use_delta:
                    lv += ref_d[0] + (mode_d[0] if i4 else 0)
                lv = _clip(lv, 63)
                if lv > 0:
                    il = lv
                    if sharp > 0:
                        il >>= 2 if sharp > 4 else 1
                        il = min(il, 9 - sharp)
                    il = max(il, 1)
                    row.append((2 * lv + il, il,
                                2 if lv >= 40 else 1 if lv >= 15 else 0))
                else:
                    row.append((0, 0, 0))
            self.fstrength.append(row)


def _modes(hd: _Header, mbw: int, mbh: int):
    """Each macroblock's (segment, skip, is 4x4, 16 4x4 modes or the 16x16
    mode, chroma mode), from the first partition (ParseIntraMode)."""
    br = hd.br
    top = [0] * (4 * mbw)
    out = []
    for _ in range(mbh):
        left = [0] * 4
        row = []
        for mx in range(mbw):
            seg = 0
            if hd.update_map:
                p = hd.seg_probs
                seg = br.bit(p[1]) if not br.bit(p[0]) else br.bit(p[2]) + 2
            skip = br.bit(hd.skip_p) if hd.use_skip else 0
            i4 = not br.bit(145)
            if not i4:
                ym = (TM if br.bit(128) else HE) if br.bit(156) else \
                    (VE if br.bit(163) else DC)
                top[4 * mx:4 * mx + 4] = [ym] * 4
                left = [ym] * 4
                modes = ym
            else:
                modes = []
                for y in range(4):
                    ym = left[y]
                    for x in range(4):
                        pr = _BMODES[top[4 * mx + x]][ym]
                        if not br.bit(pr[0]):
                            ym = 0
                        elif not br.bit(pr[1]):
                            ym = 1
                        elif not br.bit(pr[2]):
                            ym = 2
                        elif not br.bit(pr[3]):
                            ym = (3 if not br.bit(pr[4]) else
                                  4 if not br.bit(pr[5]) else 5)
                        else:
                            ym = (6 if not br.bit(pr[6]) else
                                  7 if not br.bit(pr[7]) else
                                  8 if not br.bit(pr[8]) else 9)
                        top[4 * mx + x] = ym
                    modes += top[4 * mx:4 * mx + 4]
                    left[y] = ym
            uv = DC if not br.bit(142) else VE if not br.bit(114) else \
                TM if br.bit(183) else HE
            row.append((seg, skip, i4, modes, uv))
        out.append(row)
    if br.eof:
        raise ValueError("truncated VP8 first partition")
    return out


def _large(br: _Bool, p) -> int:
    """GetLargeValue: a token's value past 1."""
    if not br.bit(p[3]):
        if not br.bit(p[4]):
            return 2
        return 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        v = 7 + 2 * br.bit(165)
        return v + br.bit(145)
    bit1 = br.bit(p[8])
    bit0 = br.bit(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for pr in _CAT[cat]:
        v += v + br.bit(pr)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bool, bands, ctx: int, dq, n: int, out, base: int) -> int:
    """GetCoeffs: one 4x4 block's tokens from position n, dequantized into
    out[base:base + 16] (natural order); the position after its last
    nonzero coefficient."""
    p = bands[_BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = bands[_BANDS[n]][0]
        nxt = bands[_BANDS[n + 1]]
        if not br.bit(p[2]):
            v = 1
            p = nxt[1]
        else:
            v = _large(br, p)
            p = nxt[2]
        out[base + _ZIGZAG[n]] = br.signed(v) * dq[1 if n > 0 else 0]
        n += 1
    return 16


def _wht(dc):
    """TransformWHT: the 16 Y2 coefficients -> the Y blocks' DCs."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i] = a0 + a1, a0 - a1
        tmp[4 + i], tmp[12 + i] = a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d - tmp[4 * i + 3]
        out[4 * i] = (a0 + a1) >> 3
        out[4 * i + 1] = (a3 + a2) >> 3
        out[4 * i + 2] = (a0 - a1) >> 3
        out[4 * i + 3] = (a3 - a2) >> 3
    return out


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct_add(c, base: int, dst, y0: int, x0: int):
    """TransformOne: the inverse DCT of c[base:base + 16] added to the
    4x4 block of dst at (y0, x0), clipped to 0..255."""
    tmp = [0] * 16
    for i in range(4):
        a = c[base + i] + c[base + 8 + i]
        b = c[base + i] - c[base + 8 + i]
        cc = _mul2(c[base + 4 + i]) - _mul1(c[base + 12 + i])
        d = _mul1(c[base + 4 + i]) + _mul2(c[base + 12 + i])
        tmp[4 * i:4 * i + 4] = (a + d, b + cc, b - cc, a - d)
    for i in range(4):
        dc = tmp[i] + 4
        a = dc + tmp[8 + i]
        b = dc - tmp[8 + i]
        cc = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        d = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        row = dst[y0 + i]
        for x, v in enumerate((a + d, b + cc, b - cc, a - d)):
            s = row[x0 + x] + (v >> 3)
            row[x0 + x] = 0 if s < 0 else 255 if s > 255 else s


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2v(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top, left, tl):
    """libwebp's 4x4 predictors: top = the 8 pixels above (4 and the 4
    above-right), left = the 4 to the left, tl = above-left; -> 4 rows."""
    A, B, C, D, E, F, G, Hh = top
    I, J, K, L = left
    X = tl
    if mode == 0:   # DC
        v = (sum(top[:4]) + sum(left) + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == 1:   # TM
        return [[_clip(t + lft - X, 255) for t in top[:4]] for lft in left]
    if mode == 2:   # VE
        r = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [list(r) for _ in range(4)]
    if mode == 3:   # HE
        vals = (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                _avg3(K, L, L))
        return [[v] * 4 for v in vals]
    d = [[0] * 4 for _ in range(4)]

    def put(v, *xy):
        for x, y in xy:
            d[y][x] = v
    if mode == 4:   # RD
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == 5:     # VR
        put(_avg2v(X, A), (0, 0), (1, 2))
        put(_avg2v(A, B), (1, 0), (2, 2))
        put(_avg2v(B, C), (2, 0), (3, 2))
        put(_avg2v(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == 6:     # LD
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, Hh), (3, 2), (2, 3))
        put(_avg3(G, Hh, Hh), (3, 3))
    elif mode == 7:     # VL
        put(_avg2v(A, B), (0, 0))
        put(_avg2v(B, C), (1, 0), (0, 2))
        put(_avg2v(C, D), (2, 0), (1, 2))
        put(_avg2v(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, Hh), (3, 3))
    elif mode == 8:     # HD
        put(_avg2v(I, X), (0, 0), (2, 1))
        put(_avg2v(J, I), (0, 1), (2, 2))
        put(_avg2v(K, J), (0, 2), (2, 3))
        put(_avg2v(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(J, I, X), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:               # HU
        put(_avg2v(I, J), (0, 0))
        put(_avg2v(J, K), (2, 0), (0, 1))
        put(_avg2v(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return d


def _pred_block(mode: int, size: int, top, left, tl, mx: int, my: int):
    """The 16x16 and chroma predictors, DC without the edges it lacks
    (CheckMode: DC from the left only on the top row, the top only on the
    left column, 128 at the corner)."""
    if mode == DC:
        sh = 4 if size == 16 else 3
        if mx and my:
            v = (sum(top) + sum(left) + size) >> (sh + 1)
        elif my:
            v = (sum(top) + (size >> 1)) >> sh
        elif mx:
            v = (sum(left) + (size >> 1)) >> sh
        else:
            v = 0x80
        return [[v] * size for _ in range(size)]
    if mode == TM:
        return [[_clip(t + lft - tl, 255) for t in top] for lft in left]
    if mode == VE:
        return [list(top) for _ in range(size)]
    return [[lft] * size for lft in left]


def decode_vp8(body: bytes) -> np.ndarray:
    """A VP8 key frame -> uint8 RGB [H, W, 3] (libwebp's decode, fancy
    upsampling and YUV to RGB)."""
    hd = _Header(body)
    mbw, mbh = (hd.w + 15) >> 4, (hd.h + 15) >> 4
    modes = _modes(hd, mbw, mbh)
    Y = [[0] * (16 * mbw) for _ in range(16 * mbh)]
    U = [[0] * (8 * mbw) for _ in range(8 * mbh)]
    V = [[0] * (8 * mbw) for _ in range(8 * mbh)]
    top_nz = [[0] * 8 for _ in range(mbw)]     # 4 Y, 2 U, 2 V per column
    top_dc = [0] * mbw
    finfo = []
    for my in range(mbh):
        br = hd.parts[my & (len(hd.parts) - 1)]
        left_nz, left_dc = [0] * 8, 0
        frow = []
        for mx in range(mbw):
            seg, skip, i4, imodes, uvmode = modes[my][mx]
            c = [0] * 384
            nonzero = False
            if not skip:
                y1, y2, uvq = hd.dqm[seg]
                tnz = top_nz[mx]
                if not i4:
                    dc = [0] * 16
                    nz = _coeffs(br, hd.proba[1], top_dc[mx] + left_dc, y2,
                                 0, dc, 0)
                    top_dc[mx] = left_dc = int(nz > 0)
                    if nz > 1:
                        dcs = _wht(dc)
                    else:
                        dcs = [(dc[0] + 3) >> 3] * 16
                    for k in range(16):
                        c[16 * k] = dcs[k]
                    first, bands = 1, hd.proba[0]
                else:
                    first, bands = 0, hd.proba[3]
                for y in range(4):
                    for x in range(4):
                        nz = _coeffs(br, bands, left_nz[y] + tnz[x], y1,
                                     first, c, 16 * (4 * y + x))
                        f = int(nz > first)
                        left_nz[y] = tnz[x] = f
                for ch in (4, 6):
                    base = 256 if ch == 4 else 320
                    for y in range(2):
                        for x in range(2):
                            nz = _coeffs(br, hd.proba[2],
                                         left_nz[ch + y] + tnz[ch + x], uvq,
                                         0, c, base + 16 * (2 * y + x))
                            left_nz[ch + y] = tnz[ch + x] = int(nz > 0)
                nonzero = any(c)
                if br.eof:
                    raise ValueError("truncated VP8 token partition")
            else:
                left_nz[:] = [0] * 8
                top_nz[mx][:] = [0] * 8
                if not i4:
                    top_dc[mx] = left_dc = 0
            lim, il, hev = hd.fstrength[seg][int(i4)]
            frow.append((lim, il, hev, i4 or nonzero))
            _reconstruct(Y, U, V, c, mx, my, mbw, i4, imodes, uvmode)
        finfo.append(frow)
    y = np.asarray(Y, np.int32)
    u = np.asarray(U, np.int32)
    v = np.asarray(V, np.int32)
    if hd.filter:
        _loop_filter(y, u, v, finfo, hd.filter == 1)
    return yuv_to_rgb(y[:hd.h, :hd.w], u[:(hd.h + 1) // 2, :(hd.w + 1) // 2],
                      v[:(hd.h + 1) // 2, :(hd.w + 1) // 2])


def _reconstruct(Y, U, V, c, mx: int, my: int, mbw: int, i4: bool,
                 imodes, uvmode: int):
    """One macroblock's prediction plus residual into the unfiltered
    planes (the neighbours unfiltered, 127 above the frame, 129 left of
    it)."""
    x0, y0 = 16 * mx, 16 * my
    if my:
        top = Y[y0 - 1][x0:x0 + 16]
        if mx < mbw - 1:
            tr = Y[y0 - 1][x0 + 16:x0 + 20]
        else:
            tr = [Y[y0 - 1][x0 + 15]] * 4
        tl = Y[y0 - 1][x0 - 1] if mx else 129
    else:
        top, tr, tl = [127] * 16, [127] * 4, 127
    left = [Y[y0 + j][x0 - 1] for j in range(16)] if mx else [129] * 16
    if not i4:
        p = _pred_block(imodes, 16, top, left, tl, mx, my)
        for j in range(16):
            Y[y0 + j][x0:x0 + 16] = p[j]
        for n in range(16):
            _idct_add(c, 16 * n, Y, y0 + 4 * (n >> 2), x0 + 4 * (n & 3))
    else:
        for n in range(16):
            by, bx = n >> 2, n & 3
            yy, xx = y0 + 4 * by, x0 + 4 * bx
            if by == 0:
                t8 = (top + tr)[4 * bx:4 * bx + 8]
                tlb = tl if bx == 0 else top[4 * bx - 1]
            else:
                above = Y[yy - 1]
                t8 = above[xx:xx + 4] + (above[xx + 4:xx + 8] if bx < 3
                                         else tr)
                tlb = above[xx - 1] if (bx or mx) else 129
            lft = [Y[yy + j][xx - 1] for j in range(4)] if (bx or mx) \
                else [129] * 4
            p = _pred4(imodes[n], t8, lft, tlb)
            for j in range(4):
                Y[yy + j][xx:xx + 4] = p[j]
            _idct_add(c, 16 * n, Y, yy, xx)
    for P, base in ((U, 256), (V, 320)):
        cx, cy = 8 * mx, 8 * my
        if my:
            top = P[cy - 1][cx:cx + 8]
            tl = P[cy - 1][cx - 1] if mx else 129
        else:
            top, tl = [127] * 8, 127
        left = [P[cy + j][cx - 1] for j in range(8)] if mx else [129] * 8
        p = _pred_block(uvmode, 8, top, left, tl, mx, my)
        for j in range(8):
            P[cy + j][cx:cx + 8] = p[j]
        for n in range(4):
            _idct_add(c, base + 16 * n, P, cy + 4 * (n >> 1),
                      cx + 4 * (n & 1))


# the loop filter, one edge at a time over numpy lines [n, 8]: p3 p2 p1 p0
# q0 q1 q2 q3 across the edge

def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _u8(v):
    return np.clip(v, 0, 255)


def _filter_lines(s, thresh: int, ilevel: int, hev_t: int, simple: bool,
                  mb_edge: bool):
    """One edge's filter on lines s [n, 8] (int32, changed in place)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (s[:, k] for k in range(8))
    t2 = 2 * thresh + 1
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if simple:
        f2 = need
    else:
        need &= (np.abs(p3 - p2) <= ilevel) & (np.abs(p2 - p1) <= ilevel) \
            & (np.abs(p1 - p0) <= ilevel) & (np.abs(q3 - q2) <= ilevel) \
            & (np.abs(q2 - q1) <= ilevel) & (np.abs(q1 - q0) <= ilevel)
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
        f2 = need & hev
        other = need & ~hev
    new = s.copy()
    # DoFilter2
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    new[:, 3] = np.where(f2, _u8(p0 + a2), new[:, 3])
    new[:, 4] = np.where(f2, _u8(q0 - a1), new[:, 4])
    if not simple:
        if mb_edge:     # DoFilter6
            a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
            b1 = (27 * a + 63) >> 7
            b2 = (18 * a + 63) >> 7
            b3 = (9 * a + 63) >> 7
            for k, v in ((1, p2 + b3), (2, p1 + b2), (3, p0 + b1),
                         (4, q0 - b1), (5, q1 - b2), (6, q2 - b3)):
                new[:, k] = np.where(other, _u8(v), new[:, k])
        else:           # DoFilter4
            a = 3 * (q0 - p0)
            b1 = _sclip2((a + 4) >> 3)
            b2 = _sclip2((a + 3) >> 3)
            b3 = (b1 + 1) >> 1
            for k, v in ((2, p1 + b3), (3, p0 + b2), (4, q0 - b1),
                         (5, q1 - b3)):
                new[:, k] = np.where(other, _u8(v), new[:, k])
    s[:] = new


def _edge(P, vertical: bool, pos: int, start: int, n: int, *args):
    """Filter the edge before column (vertical) or row pos, along n
    pixels from start."""
    if vertical:
        s = P[start:start + n, pos - 4:pos + 4]
        _filter_lines(s, *args)
    else:
        s = np.ascontiguousarray(P[pos - 4:pos + 4, start:start + n].T)
        _filter_lines(s, *args)
        P[pos - 4:pos + 4, start:start + n] = s.T


def _loop_filter(y, u, v, finfo, simple: bool):
    """The loop filter over the frame, macroblock by macroblock: the left
    edge, the inner vertical edges, the top edge, the inner horizontal
    edges (simple: luma only)."""
    for my, row in enumerate(finfo):
        for mx, (lim, il, hev, inner) in enumerate(row):
            if lim == 0:
                continue
            x0, y0, cx, cy = 16 * mx, 16 * my, 8 * mx, 8 * my
            for vertical, at_edge, pos_y, pos_c in (
                    (True, mx > 0, x0, cx), (False, my > 0, y0, cy)):
                ys, cs = (y0, cy) if vertical else (x0, cx)
                if at_edge:
                    _edge(y, vertical, pos_y, ys, 16, lim + 4, il, hev,
                          simple, True)
                    if not simple:
                        for P in (u, v):
                            _edge(P, vertical, pos_c, cs, 8, lim + 4, il,
                                  hev, False, True)
                if inner:
                    for k in (4, 8, 12):
                        _edge(y, vertical, pos_y + k, ys, 16, lim, il, hev,
                              simple, False)
                    if not simple:
                        for P in (u, v):
                            _edge(P, vertical, pos_c + 4, cs, 8, lim, il,
                                  hev, False, False)


def _mult_hi(v, c):
    return (v * c) >> 8


def _clip8(v):
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def _upsample(top, cur, bottom: bool, w: int):
    """UpsampleRgbaLinePair's chroma for one output row of width w from
    the chroma rows top (the nearer) and cur."""
    out = np.zeros(w, np.int64)
    tl, l0 = top[0], cur[0]
    out[0] = (3 * l0 + tl + 2) >> 2 if bottom else (3 * tl + l0 + 2) >> 2
    lp = (w - 1) >> 1
    if lp:
        a, b = top[:lp + 1], cur[:lp + 1]
        tl_, t_, l_, c_ = a[:-1], a[1:], b[:-1], b[1:]
        avg = tl_ + t_ + l_ + c_ + 8
        d12 = (avg + 2 * (t_ + l_)) >> 3
        d03 = (avg + 2 * (tl_ + c_)) >> 3
        if bottom:
            out[1:2 * lp:2] = (d03 + l_) >> 1
            out[2:2 * lp + 1:2] = (d12 + c_) >> 1
        else:
            out[1:2 * lp:2] = (d12 + tl_) >> 1
            out[2:2 * lp + 1:2] = (d03 + t_) >> 1
    if not w & 1:
        tl, l0 = top[lp], cur[lp]
        out[w - 1] = (3 * l0 + tl + 2) >> 2 if bottom else \
            (3 * tl + l0 + 2) >> 2
    return out


def yuv_to_rgb(y, u, v) -> np.ndarray:
    """libwebp's fancy upsampling and VP8YUVToR/G/B on the cropped planes
    y [H, W], u, v [(H + 1) / 2, (W + 1) / 2] -> uint8 RGB [H, W, 3]."""
    H, W = y.shape
    ch = u.shape[0]
    uu = np.zeros((H, W), np.int64)
    vv = np.zeros((H, W), np.int64)
    for r in range(H):
        k = (r + 1) >> 1
        if r == 0:
            a, b, bottom = 0, 0, False
        elif r & 1:
            a, b, bottom = k - 1, min(k, ch - 1), False
        else:
            a, b, bottom = k - 1, k, True
        uu[r] = _upsample(u[a].astype(np.int64), u[b].astype(np.int64),
                          bottom, W)
        vv[r] = _upsample(v[a].astype(np.int64), v[b].astype(np.int64),
                          bottom, W)
    yy = _mult_hi(y.astype(np.int64), 19077)
    r = _clip8(yy + _mult_hi(vv, 26149) - 14234)
    g = _clip8(yy - _mult_hi(uu, 6419) - _mult_hi(vv, 13320) + 8708)
    b = _clip8(yy + _mult_hi(uu, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)
