"""JPEG codec (the port's counterpart of the JPEG plugin of the imaging
library behind hairpt/utils/io.py write_jpg and read_image).

Decoder: baseline and extended sequential (SOF0/SOF1) and progressive
(SOF2) Huffman JPEG, 8-bit, one component (gray) or three (YCbCr, or RGB
under an Adobe marker with transform 0) with sampling factors 1 or 2 per
axis, restart intervals, APPn and COM skipped. Encoder: baseline 4:2:0
YCbCr with the Annex K Huffman tables, the IJG quality scaling of the
Annex K quantization tables, a JFIF APP0 header and one DQT and one DHT
marker per table, in libjpeg's marker order.

The arithmetic is libjpeg's integer arithmetic, step for step: the
fixed-point colour conversion tables (jccolor.c, jdcolor.c), h2v2 / h2v1
downsampling with the alternating bias (jcsample.c), the "islow" forward
and inverse DCT (jfdctint.c, jidctint.c) with libjpeg's range limit,
quantization rounding half away from zero, and "fancy" triangle
upsampling (jdsample.c: h2v1, h1v2 and h2v2; box replication where a
component is 2 samples wide or less). Image edges follow libjpeg: the
last column and row replicated before downsampling, dummy blocks in a
partial MCU carrying the previous block's DC. That block stage runs as
integer tensor operations on the image's device, so the card and the CPU
give the same bytes and the same pixels. The entropy stage runs on the
host: the encoder's run/size symbols and bit packing with numpy, the
decoder's Huffman lookup through a 65,536-entry table over a 16-bit
peek, one symbol at a time.

Arithmetic-coded, lossless, hierarchical, 12-bit and four-component
(CMYK / YCCK) files, subsampling beyond 2:1 (4:1:1) and a height given
in a DNL marker are valid JPEG that the decoder does not read: they
raise NotImplementedError naming what they are and ROADMAP item 13
(probe finds them from the markers before the first scan). Corrupt or
truncated data raises ValueError.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from .. import resolve_device

# zigzag position k -> natural (row-major) index within an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)
UNZIGZAG = np.argsort(ZIGZAG)

# Annex K quantization tables, natural order
STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61,
              12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56,
              14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77,
              24, 35, 55, 64, 81, 104, 113, 92,
              49, 64, 78, 87, 103, 121, 120, 101,
              72, 92, 95, 98, 112, 100, 103, 99], np.int64),
    np.array([17, 18, 24, 47, 99, 99, 99, 99,
              18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99,
              47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64))

# Annex K Huffman tables: (code counts of lengths 1..16, symbols)


def _runs(*spans):
    """Symbols listed as (first, last) spans of consecutive bytes."""
    return bytes(v for a, b in spans for v in range(a, b + 1))


_AC_LUM_VALS = bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a]) + _runs(
    (0x34, 0x3a), (0x43, 0x4a), (0x53, 0x5a), (0x63, 0x6a), (0x73, 0x7a),
    (0x83, 0x8a), (0x92, 0x9a), (0xa2, 0xaa), (0xb2, 0xba), (0xc2, 0xca),
    (0xd2, 0xda), (0xe1, 0xea), (0xf1, 0xfa))
_AC_CHR_VALS = bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a]) + _runs(
    (0x35, 0x3a), (0x43, 0x4a), (0x53, 0x5a), (0x63, 0x6a), (0x73, 0x7a),
    (0x82, 0x8a), (0x92, 0x9a), (0xa2, 0xaa), (0xb2, 0xba), (0xc2, 0xca),
    (0xd2, 0xda), (0xe2, 0xea), (0xf2, 0xfa))
STD_HUFF = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
             _AC_LUM_VALS),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
             _AC_CHR_VALS),
}

# islow DCT constants (CONST_BITS 13)
CONST_BITS = 13
PASS1_BITS = 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _fix16(x: float) -> int:
    """libjpeg's FIX(x) at SCALEBITS 16."""
    return int(x * 65536 + 0.5)


# ---------------------------------------------------------------------------
# the block stage: integer tensor operations on the image's device
# ---------------------------------------------------------------------------

def quality_tables(quality: int):
    """The IJG scaling of the Annex K tables (jcparam.c jpeg_set_quality,
    baseline-forced): two int64 [64] tables in natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in STD_QUANT)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _butterfly_odd(t0, t1, t2, t3):
    """The shared odd part of jfdctint / jidctint (inputs tmp4..7 of the
    forward DCT, tmp0..3 of the inverse)."""
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * _F1175
    t0 = t0 * _F0298
    t1 = t1 * _F2053
    t2 = t2 * _F3072
    t3 = t3 * _F1501
    z1 = z1 * -_F0899
    z2 = z2 * -_F2562
    z3 = z3 * -_F1961 + z5
    z4 = z4 * -_F0390 + z5
    return t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4


def _fdct_1d(x, first: bool):
    """One pass of jpeg_fdct_islow: the eight outputs of the eight inputs
    x[0..7] (rows first, then columns)."""
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    sh = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    if first:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, sh)
    out[6] = _descale(z1 - tmp12 * _F1847, sh)
    o7, o5, o3, o1 = _butterfly_odd(tmp4, tmp5, tmp6, tmp7)
    out[7], out[5] = _descale(o7, sh), _descale(o5, sh)
    out[3], out[1] = _descale(o3, sh), _descale(o1, sh)
    return out


def fdct_islow(blocks):
    """jpeg_fdct_islow on int64 [N, 8, 8] level-shifted samples: the DCT
    coefficients scaled up by 8, natural order."""
    rows = _fdct_1d([blocks[:, :, k] for k in range(8)], True)
    b = torch.stack(rows, dim=-1)
    cols = _fdct_1d([b[:, k, :] for k in range(8)], False)
    return torch.stack(cols, dim=-2)


def quantize(coef, qtable):
    """coef [N, 8, 8] (scaled by 8) over the natural-order table: libjpeg's
    division by 8 q rounding half away from zero."""
    d = (qtable.reshape(8, 8) * 8).to(coef)
    mag = (coef.abs() + d // 2) // d
    return torch.where(coef < 0, -mag, mag)


def _idct_1d(x, first: bool):
    z1 = (x[2] + x[6]) * _F0541
    tmp2 = z1 - x[6] * _F1847
    tmp3 = z1 + x[2] * _F0765
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = _butterfly_odd(x[7], x[5], x[3], x[1])
    sh = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS + 3
    return [_descale(v, sh) for v in (
        tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
        tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3)]


def idct_islow(coef):
    """jpeg_idct_islow on int64 [N, 8, 8] dequantized coefficients
    (natural order) -> samples [N, 8, 8] through libjpeg's range limit
    (the value wrapped to [-512, 512), then 128 added and clamped)."""
    cols = _idct_1d([coef[:, k, :] for k in range(8)], True)
    ws = torch.stack(cols, dim=-2)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], False)
    v = torch.stack(rows, dim=-1)
    v = ((v + 512) & 1023) - 512
    return torch.clamp(v + 128, 0, 255)


def rgb_to_ycc(rgb):
    """jccolor.c rgb_ycc_convert: int64 [..., 3] -> (Y, Cb, Cr)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    half = 1 << 15
    off = (128 << 16) + half - 1
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g
         + _fix16(0.11400) * b + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g
          + _fix16(0.50000) * b + off) >> 16
    cr = (_fix16(0.50000) * r - _fix16(0.41869) * g
          - _fix16(0.08131) * b + off) >> 16
    return y, cb, cr


def ycc_to_rgb(y, cb, cr):
    """jdcolor.c ycc_rgb_convert -> int64 [..., 3] in 0..255."""
    half = 1 << 15
    x_cb = cb - 128
    x_cr = cr - 128
    r = y + ((_fix16(1.40200) * x_cr + half) >> 16)
    g = y + ((-_fix16(0.34414) * x_cb + half - _fix16(0.71414) * x_cr)
             >> 16)
    b = y + ((_fix16(1.77200) * x_cb + half) >> 16)
    return torch.clamp(torch.stack([r, g, b], -1), 0, 255)


def _pad_edge(plane, rows: int, cols: int):
    """Replicate a [h, w] plane's last row and column out to rows x cols."""
    h, w = plane.shape
    if rows > h:
        plane = torch.cat([plane, plane[-1:].expand(rows - h, w)], 0)
    if cols > w:
        plane = torch.cat([plane, plane[:, -1:].expand(-1, cols - w)], 1)
    return plane


def downsample_h2v2(plane):
    """jcsample.c h2v2_downsample: 2x2 means with bias 1, 2, 1, 2, ..
    across each output row."""
    h, w = plane.shape
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] \
        + plane[1::2, 1::2]
    bias = torch.tensor([1, 2], device=plane.device).repeat(w // 4 + 1)
    return (s + bias[:w // 2]) >> 2


def _blocks(plane):
    """[8 bh, 8 bw] -> [bh * bw, 8, 8] in raster order."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3) \
        .reshape(-1, 8, 8)


def _unblocks(blocks, bh: int, bw: int):
    return blocks.reshape(bh, bw, 8, 8).permute(0, 2, 1, 3) \
        .reshape(bh * 8, bw * 8)


def _shift(t, dim: int, step: int):
    """t moved one place along dim (step -1: the previous element, +1:
    the next), its edge element replicated."""
    n = t.shape[dim]
    if step < 0:
        idx = torch.clamp(torch.arange(n, device=t.device) - 1, min=0)
    else:
        idx = torch.clamp(torch.arange(n, device=t.device) + 1, max=n - 1)
    return t.index_select(dim, idx)


def _interleave(a, b, dim: int):
    return torch.stack([a, b], dim + 1).flatten(dim, dim + 1)


def upsample(plane, hx: int, vx: int):
    """jdsample.c: a [h, w] component plane expanded hx times across and
    vx times down. Triangle ("fancy") filters for 2x1, 1x2 and 2x2 where
    the plane is more than 2 samples wide (1x2 always), box replication
    otherwise."""
    h, w = plane.shape
    if (hx, vx) == (1, 1):
        return plane
    if (hx, vx) == (1, 2):
        up = (3 * plane + _shift(plane, 0, -1) + 1) >> 2
        dn = (3 * plane + _shift(plane, 0, 1) + 2) >> 2
        return _interleave(up, dn, 0)
    if (hx, vx) in ((2, 1), (2, 2)) and w > 2:
        if vx == 1:
            t = plane
            ev = (3 * t + _shift(t, 1, -1) + 1) >> 2
            od = (3 * t + _shift(t, 1, 1) + 2) >> 2
            return _interleave(ev, od, 1)
        outs = []
        for nb in (_shift(plane, 0, -1), _shift(plane, 0, 1)):
            t = 3 * plane + nb
            ev = (3 * t + _shift(t, 1, -1) + 8) >> 4
            od = (3 * t + _shift(t, 1, 1) + 7) >> 4
            outs.append(_interleave(ev, od, 1))
        return _interleave(outs[0], outs[1], 0)
    return plane.repeat_interleave(vx, 0).repeat_interleave(hx, 1)


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------

def _huff_codes(counts, vals):
    """Canonical codes: symbol -> (code, length)."""
    out = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _huff_lut(counts, vals):
    """The decoder's table: for every 16-bit peek, (length << 8) | symbol
    of the code it starts with, 0 where no code matches."""
    lut = np.zeros(1 << 16, np.int64)
    for sym, (code, length) in _huff_codes(counts, vals).items():
        lo = code << (16 - length)
        lut[lo:lo + (1 << (16 - length))] = (length << 8) | sym
    return lut.tolist()


def _enc_tables(counts, vals):
    """symbol -> code and length arrays for the encoder."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    for sym, (c, n) in _huff_codes(counts, vals).items():
        code[sym] = c
        size[sym] = n
    return code, size


_BITLEN = np.zeros(1 << 16, np.int64)
for _b in range(1, 17):
    _BITLEN[1 << (_b - 1):1 << _b] = _b


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _coefficients_420(u8, quality: int):
    """The quantized coefficients of a 4:2:0 encode, on u8's device:
    (Y [yh, yw, 64], Cb [ch, cw, 64], Cr) in zigzag order, the block grids
    padded to whole MCUs with libjpeg's dummy blocks."""
    dev = u8.device
    H, W = u8.shape[:2]
    mx, my = -(-W // 16), -(-H // 16)
    y, cb, cr = rgb_to_ycc(u8.to(torch.int64))
    qy, qc = (torch.as_tensor(t, device=dev) for t in quality_tables(
        quality))
    # Y: the image's last row and column replicated to whole MCUs
    yp = _pad_edge(y, 16 * my, 16 * mx)
    # chroma: rows to an even count and columns to twice the component's
    # blocks, downsampled, then rows to whole blocks
    ch = []
    for c in (cb, cr):
        c = _pad_edge(c, H + (H & 1), 16 * mx)
        c = downsample_h2v2(c)
        ch.append(_pad_edge(c, 8 * my, 8 * mx))
    zz = torch.as_tensor(ZIGZAG, device=dev)

    def code(plane, q, bh, bw):
        blk = fdct_islow(_blocks(plane) - 128)
        return quantize(blk, q).reshape(bh, bw, 64)[..., zz]

    yq = code(yp, qy, 2 * my, 2 * mx)
    # dummy blocks: Y's block grid past the image's blocks (libjpeg
    # jccoefct.c compress_data: zero AC, DC of the block before it in the
    # MCU)
    ywb, yhb = -(-W // 8), -(-H // 8)
    if ywb & 1:
        yq[:, ywb] = 0
        yq[:, ywb, 0] = yq[:, ywb - 1, 0]
    if yhb & 1:
        yq[yhb] = 0
        yq[yhb, :, 0] = yq[yhb - 1, 1::2, 0].repeat_interleave(2)
    return yq, code(ch[0], qc, my, mx), code(ch[1], qc, my, mx)


def _scan_symbols(zz, tables):
    """The Huffman items of blocks zz [N, 64] (zigzag, in scan order) that
    share one component's tables: (block, order key, bits, length) with
    the code and its appended value bits packed into one item."""
    (dc_code, dc_size), (ac_code, ac_size) = tables
    n = zz.shape[0]
    dc = zz[:, 0]
    diff = np.diff(dc, prepend=0)
    ev_blk, ev_key, ev_bits, ev_len = [], [], [], []

    def add(blk, key, sym_code, sym_len, v, vlen):
        vbits = np.where(v < 0, v + (1 << vlen) - 1, v) & ((1 << vlen) - 1)
        ev_blk.append(blk)
        ev_key.append(key)
        ev_bits.append((sym_code << vlen) | vbits)
        ev_len.append(sym_len + vlen)

    s = _BITLEN[np.abs(diff)]
    add(np.arange(n), np.zeros(n, np.int64), dc_code[s], dc_size[s], diff, s)
    ac = zz[:, 1:]
    b, k = np.nonzero(ac)
    k = k + 1
    v = ac[b, k - 1]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    prev_k = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev_k - 1
    s = _BITLEN[np.abs(v)]
    sym = ((run & 15) << 4) | s
    add(b, k * 32 + 16, ac_code[sym], ac_size[sym], v, s)
    # ZRL (run of 16 zeros) before each coefficient that needs them
    nz = run >> 4
    if nz.any():
        rep = np.repeat(np.arange(len(b)), nz)
        j = np.arange(len(rep)) - np.repeat(np.cumsum(nz) - nz, nz)
        add(b[rep], k[rep] * 32 + j, np.full(len(rep), ac_code[0xF0]),
            np.full(len(rep), ac_size[0xF0]), np.zeros(len(rep), np.int64),
            np.zeros(len(rep), np.int64))
    # EOB where the last coefficient is zero
    last = np.zeros(n, np.int64)
    last[b] = k
    eob = np.nonzero(last < 63)[0]
    add(eob, np.full(len(eob), 64 * 32), np.full(len(eob), ac_code[0]),
        np.full(len(eob), ac_size[0]), np.zeros(len(eob), np.int64),
        np.zeros(len(eob), np.int64))
    return (np.concatenate(ev_blk), np.concatenate(ev_key),
            np.concatenate(ev_bits), np.concatenate(ev_len))


def _pack_bits(bits, lengths) -> bytes:
    """Items of up to 32 bits, MSB first, padded with 1 bits to a byte and
    0xFF stuffed with 0x00."""
    aligned = (bits.astype(np.uint64) << (32 - lengths).astype(np.uint64)) \
        .astype(">u4")
    unpacked = np.unpackbits(aligned.view(np.uint8)).reshape(-1, 32)
    stream = unpacked[np.arange(32)[None, :] < lengths[:, None]]
    pad = (-len(stream)) % 8
    stream = np.concatenate([stream, np.ones(pad, np.uint8)])
    out = np.packbits(stream)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _marker(code: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(payload) + 2) + payload


def encode(img, quality: int = 95) -> bytes:
    """A baseline 4:2:0 JPEG of the uint8 RGB tensor img [H, W, 3]: the
    block stage on img's device, the entropy stage on the host."""
    H, W = int(img.shape[0]), int(img.shape[1])
    comps = _coefficients_420(img, quality)
    yq, cbq, crq = (c.cpu().numpy() for c in comps)
    my, mx = cbq.shape[:2]
    # the MCU order: Y's 2x2 blocks, then Cb, then Cr
    yblk = yq.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4) \
        .reshape(my * mx, 4, 64)
    tabs = [(_enc_tables(*STD_HUFF[(0, t)]), _enc_tables(*STD_HUFF[(1, t)]))
            for t in (0, 1)]
    items = []
    for zz, slot, t in ((yblk.reshape(-1, 64), None, 0),
                        (cbq.reshape(-1, 64), 4, 1),
                        (crq.reshape(-1, 64), 5, 1)):
        blk, key, bits, ln = _scan_symbols(zz.astype(np.int64), tabs[t])
        mcu = blk // 4 if slot is None else blk
        pos = blk % 4 if slot is None else np.full(len(blk), slot)
        items.append((mcu * 6 + pos, key, bits, ln))
    blk, key, bits, ln = (np.concatenate(x) for x in zip(*items))
    order = np.lexsort((key, blk))
    data = _pack_bits(bits[order], ln[order])
    q = quality_tables(quality)
    out = [b"\xff\xd8",
           _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in (0, 1):
        out.append(_marker(0xDB, bytes([t]) + bytes(
            q[t][ZIGZAG].astype(np.uint8))))
    out.append(_marker(0xC0, struct.pack(">BHHB", 8, H, W, 3)
                       + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for t in (0, 1):
        for cls in (0, 1):
            counts, vals = STD_HUFF[(cls, t)]
            out.append(_marker(0xC4, bytes([(cls << 4) | t]) + bytes(counts)
                               + bytes(vals)))
    out.append(_marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63,
                                    0])))
    out += [data, b"\xff\xd9"]
    return b"".join(out)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

_REFUSED_SOF = {
    0xC3: "lossless (SOF3)", 0xC5: "hierarchical (SOF5)",
    0xC6: "hierarchical (SOF6)", 0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical (SOF14)",
    0xCF: "arithmetic-coded hierarchical (SOF15)",
}


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item "
                               f"13)")


def _check_frame(payload: bytes):
    """Raise NotImplementedError for a frame header the decoder does not
    read: not 8-bit, not 1 or 3 components, a zero dimension (the height
    in a DNL marker) or a component subsampled other than 1:1 or 2:1 on
    an axis."""
    if len(payload) < 6 or len(payload) < 6 + 3 * payload[5]:
        return
    prec, H, W, nc = struct.unpack(">BHHB", payload[:6])
    if prec != 8:
        raise _unported(f"{prec}-bit JPEG")
    if nc not in (1, 3):
        raise _unported(f"{nc}-component (CMYK / YCCK) JPEG")
    if H == 0 or W == 0:
        raise _unported("JPEG with its height in a DNL marker")
    hv = [payload[7 + 3 * i] for i in range(nc)]
    h, v = [x >> 4 for x in hv], [x & 15 for x in hv]
    for a, b in zip(h, v):
        if max(h) % a or max(v) % b or max(h) // a > 2 or max(v) // b > 2:
            raise _unported(f"JPEG with sampling factors {h} x {v} (a ratio "
                           f"other than 1 or 2)")


def _check_marker(code: int, payload: bytes):
    """Raise NotImplementedError for a marker of a valid JPEG that the
    decoder does not read (its frame header included)."""
    if code in _REFUSED_SOF:
        raise _unported(f"{_REFUSED_SOF[code]} JPEG")
    if code == 0xCC:
        raise _unported("arithmetic-coded JPEG (DAC marker)")
    if code in (0xDE, 0xDF):
        raise _unported("hierarchical JPEG (DHP / EXP marker)")
    if code == 0xDC:
        raise _unported("JPEG with a DNL marker")
    if code in (0xC0, 0xC1, 0xC2):
        _check_frame(payload)


def probe(data: bytes):
    """Raise NotImplementedError where `data` is a JPEG that decode() does
    not read, from its markers before the first scan, without decoding;
    corrupt or truncated data is left to decode()."""
    if data[:2] != b"\xff\xd8":
        return
    pos, n = 2, len(data)
    while pos + 4 <= n and data[pos] == 0xFF:
        code = data[pos + 1]
        if code == 0xFF:
            pos += 1
            continue
        if code in (0xDA, 0xD9):
            return
        if 0xD0 <= code <= 0xD7 or code == 0x01:
            pos += 2
            continue
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if end > n:
            return
        _check_marker(code, data[pos + 4:end])
        pos = end


class _Frame:
    def __init__(self, payload: bytes, progressive: bool):
        _, self.H, self.W, nc = struct.unpack(">BHHB", payload[:6])
        self.progressive = progressive
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(nc):
            cid, hv, tq = payload[6 + 3 * i:9 + 3 * i]
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.h), max(self.v)
        self.mcux = -(-self.W // (8 * self.hmax))
        self.mcuy = -(-self.H // (8 * self.vmax))
        # per component: the sample grid, its blocks and the padded grid
        self.cw = [-(-self.W * h // self.hmax) for h in self.h]
        self.ch = [-(-self.H * v // self.vmax) for v in self.v]
        self.wib = [-(-w // 8) for w in self.cw]
        self.hib = [-(-h // 8) for h in self.ch]
        self.bw = [self.mcux * h for h in self.h]
        self.bh = [self.mcuy * v for v in self.v]
        self.coef = [[0] * (bw * bh * 64) for bw, bh in zip(self.bw,
                                                            self.bh)]
        self.qt = [None] * nc


def _segments(data: bytes, pos: int):
    """The entropy-coded data from pos: its restart segments (byte-stuffing
    removed) and the position of the marker that ends it."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.nonzero(arr[:-1] == 0xFF)[0]
    nxt = arr[ff + 1]
    mk = ff[(nxt != 0) & (nxt != 0xFF)]
    mk_code = arr[mk + 1]
    end_i = np.nonzero((mk_code < 0xD0) | (mk_code > 0xD7))[0]
    if len(end_i) == 0:
        raise ValueError("truncated JPEG: the file ends inside a scan")
    end = int(mk[end_i[0]])
    rst = mk[:end_i[0]]
    bounds = [0] + [int(r) + 2 for r in rst]
    ends = [int(r) for r in rst] + [end]
    segs = []
    for a, b in zip(bounds, ends):
        # fill bytes (0xFF before a marker) carry no data
        while b > a and arr[b - 1] == 0xFF:
            b -= 1
        s = arr[a:b]
        keep = np.ones(len(s), bool)
        keep[1:] = ~((s[1:] == 0) & (s[:-1] == 0xFF))
        segs.append(s[keep])
    return segs, pos + end


def _windows(seg):
    """For every byte offset i, bytes i..i+7 as a big-endian integer."""
    n = len(seg)
    b = np.concatenate([seg, np.zeros(8, np.uint8)]).astype(np.uint64)
    w = np.zeros(n + 1, np.uint64)
    for j in range(8):
        w |= b[j:j + n + 1] << np.uint64(56 - 8 * j)
    return w.tolist()


def _bad():
    raise ValueError("corrupt JPEG data: no Huffman code matches")


def _decode_scan(fr, comps, tabs, ss, se, ah, al, segs, restart):
    """Huffman-decode one scan into fr.coef (zigzag order, flat per
    component). comps: the scan's component indices; tabs: per scan
    component (DC lut, AC lut)."""
    # the scan's blocks in order: (component, flat offset)
    if len(comps) == 1:
        ci = comps[0]
        bw = fr.bw[ci]
        order = [(0, (by * bw + bx) * 64) for by in range(fr.hib[ci])
                 for bx in range(fr.wib[ci])]
        per_mcu = 1
    else:
        order = []
        for my in range(fr.mcuy):
            for mx in range(fr.mcux):
                for j, ci in enumerate(comps):
                    h, v, bw = fr.h[ci], fr.v[ci], fr.bw[ci]
                    for yi in range(v):
                        for xi in range(h):
                            order.append((j, ((my * v + yi) * bw + mx * h
                                              + xi) * 64))
        per_mcu = len(order) // (fr.mcux * fr.mcuy)
    step = restart * per_mcu if restart else len(order)
    n_seg = -(-len(order) // step)
    if len(segs) < n_seg:
        raise ValueError("truncated JPEG: a scan has fewer restart "
                         "intervals than its MCUs need")
    coefs = [fr.coef[ci] for ci in comps]
    for si in range(n_seg):
        chunk = order[si * step:(si + 1) * step]
        W = _windows(segs[si])
        if fr.progressive:
            p = _decode_progressive(W, chunk, coefs, tabs, ss, se, ah, al,
                                    len(comps))
        else:
            p = _decode_sequential(W, chunk, coefs, tabs, len(comps))
        if p > 8 * len(segs[si]):
            raise ValueError("truncated JPEG: the entropy-coded data ends "
                             "inside a block")


def _decode_sequential(W, chunk, coefs, tabs, nc):
    p = 0
    pred = [0] * nc
    for j, base in chunk:
        coef = coefs[j]
        dcl, acl = tabs[j]
        w = W[p >> 3] << (p & 7)
        e = dcl[(w >> 48) & 0xFFFF] or _bad()
        ln = e >> 8
        s = e & 15
        if s:
            v = (w >> (64 - ln - s)) & ((1 << s) - 1)
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            pred[j] += v
        p += ln + s
        coef[base] = pred[j]
        k = 1
        while k < 64:
            w = W[p >> 3] << (p & 7)
            e = acl[(w >> 48) & 0xFFFF] or _bad()
            ln = e >> 8
            s = e & 15
            if s:
                k += (e >> 4) & 15
                if k > 63:
                    _bad()
                v = (w >> (64 - ln - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                coef[base + k] = v
                p += ln + s
                k += 1
            else:
                p += ln
                if (e >> 4) & 15 != 15:
                    break
                k += 16
    return p


def _decode_progressive(W, chunk, coefs, tabs, ss, se, ah, al, nc):
    """jdphuff.c's four scan kinds: DC first / refine, AC first / refine
    (with end-of-band runs)."""
    p = 0
    pred = [0] * nc
    eobrun = 0
    p1 = 1 << al
    m1 = -1 << al
    for j, base in chunk:
        coef = coefs[j]
        dcl, acl = tabs[j]
        if ss == 0:
            if ah == 0:
                w = W[p >> 3] << (p & 7)
                e = dcl[(w >> 48) & 0xFFFF] or _bad()
                ln = e >> 8
                s = e & 15
                if s:
                    v = (w >> (64 - ln - s)) & ((1 << s) - 1)
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    pred[j] += v
                p += ln + s
                coef[base] = pred[j] << al
            else:
                if (W[p >> 3] >> (63 - (p & 7))) & 1:
                    coef[base] |= p1
                p += 1
            continue
        k = ss
        if ah == 0:
            if eobrun:
                eobrun -= 1
                continue
            while k <= se:
                w = W[p >> 3] << (p & 7)
                e = acl[(w >> 48) & 0xFFFF] or _bad()
                ln = e >> 8
                r = (e >> 4) & 15
                s = e & 15
                if s:
                    k += r
                    if k > 63:
                        _bad()
                    v = (w >> (64 - ln - s)) & ((1 << s) - 1)
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    coef[base + k] = v << al
                    p += ln + s
                elif r == 15:
                    p += ln
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (w >> (64 - ln - r)) & ((1 << r) - 1)
                    p += ln + r
                    eobrun -= 1
                    break
                k += 1
            continue
        # AC refinement
        if eobrun == 0:
            while k <= se:
                w = W[p >> 3] << (p & 7)
                e = acl[(w >> 48) & 0xFFFF] or _bad()
                ln = e >> 8
                r = (e >> 4) & 15
                s = e & 15
                p += ln
                if s:
                    s = p1 if (W[p >> 3] >> (63 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += ((W[p >> 3] << (p & 7)) >> (64 - r)) \
                            & ((1 << r) - 1)
                        p += r
                    break
                while k <= se:
                    c = coef[base + k]
                    if c:
                        if (W[p >> 3] >> (63 - (p & 7))) & 1 \
                                and not c & p1:
                            coef[base + k] = c + (p1 if c >= 0 else m1)
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > 63:
                        _bad()
                    coef[base + k] = s
                k += 1
        if eobrun > 0:
            while k <= se:
                c = coef[base + k]
                if c:
                    if (W[p >> 3] >> (63 - (p & 7))) & 1 and not c & p1:
                        coef[base + k] = c + (p1 if c >= 0 else m1)
                    p += 1
                k += 1
            eobrun -= 1
    return p


def _parse(data: bytes):
    """Walk the markers, decoding every scan: the frame with its
    coefficients, and whether an Adobe marker says RGB."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos = 2
    qt, huff = {}, {}
    fr = None
    restart = 0
    adobe_rgb = False
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError("truncated JPEG: no EOI marker")
        code = data[pos]
        pos += 1
        if code == 0xD9:
            break
        if 0xD0 <= code <= 0xD7 or code == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError("truncated JPEG: a marker's length is "
                             "missing")
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        payload = data[pos + 2:pos + length]
        if len(payload) < length - 2:
            raise ValueError("truncated JPEG: a marker's payload is cut")
        pos += length
        _check_marker(code, payload)
        if code in (0xC0, 0xC1, 0xC2):
            fr = _Frame(payload, code == 0xC2)
        elif code == 0xDB:
            i = 0
            while i < len(payload):
                pq, tq = payload[i] >> 4, payload[i] & 15
                if pq:
                    qt[tq] = np.frombuffer(payload[i + 1:i + 129], ">u2") \
                        .astype(np.int64)
                    i += 129
                else:
                    qt[tq] = np.frombuffer(payload[i + 1:i + 65], np.uint8) \
                        .astype(np.int64)
                    i += 65
        elif code == 0xC4:
            i = 0
            while i < len(payload):
                tc, th = payload[i] >> 4, payload[i] & 15
                counts = payload[i + 1:i + 17]
                nv = sum(counts)
                huff[(tc, th)] = _huff_lut(counts, payload[i + 17:
                                                           i + 17 + nv])
                i += 17 + nv
        elif code == 0xDD:
            restart = struct.unpack(">H", payload[:2])[0]
        elif code == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12:
            adobe_rgb = payload[11] == 0
        elif code == 0xDA:
            if fr is None:
                raise ValueError("JPEG scan before its frame header")
            ns = payload[0]
            comps, tabs = [], []
            for i in range(ns):
                cid, t = payload[1 + 2 * i:3 + 2 * i]
                ci = fr.ids.index(cid)
                comps.append(ci)
                if fr.qt[ci] is None:
                    fr.qt[ci] = qt[fr.tq[ci]]
                tabs.append((huff.get((0, t >> 4)), huff.get((1, t & 15))))
            ss, se, a = payload[1 + 2 * ns:4 + 2 * ns]
            segs, pos = _segments(data, pos)
            _decode_scan(fr, comps, tabs, ss, se, a >> 4, a & 15, segs,
                         restart)
    if fr is None:
        raise ValueError("JPEG without a frame header")
    return fr, adobe_rgb


def decode(data: bytes, device=None):
    """Decode a JPEG: uint8 [H, W] (gray) or [H, W, 3] (RGB) on `device`
    (the card unless "cpu"); the entropy stage on the host."""
    dev = resolve_device(device)
    fr, adobe_rgb = _parse(data)
    zz = torch.as_tensor(UNZIGZAG, device=dev)
    planes = []
    for ci in range(len(fr.ids)):
        if fr.qt[ci] is None:
            raise ValueError("truncated JPEG: a component has no scan")
        c = torch.as_tensor(np.asarray(fr.coef[ci], np.int64), device=dev)
        c = c.reshape(-1, 64)[:, zz]
        c = c * torch.as_tensor(fr.qt[ci][UNZIGZAG], device=dev)
        s = idct_islow(c.reshape(-1, 8, 8))
        plane = _unblocks(s, fr.bh[ci], fr.bw[ci])[:fr.ch[ci], :fr.cw[ci]]
        plane = upsample(plane, fr.hmax // fr.h[ci], fr.vmax // fr.v[ci])
        planes.append(plane[:fr.H, :fr.W])
    if len(planes) == 1:
        out = planes[0]
    elif adobe_rgb or fr.ids == [ord("R"), ord("G"), ord("B")]:
        out = torch.stack(planes, -1)
    else:
        out = ycc_to_rgb(*planes)
    return out.to(torch.uint8)


def read_jpeg(path: str, device=None):
    with open(path, "rb") as f:
        return decode(f.read(), device)
