"""JPEG codec (the port's counterpart of the JPEG plugin of the imaging
library behind hairpt/utils/io.py write_jpg and read_image).

Decoder: what libjpeg-turbo's 8-bit decoder gives PIL: baseline and
extended sequential (SOF0/SOF1) and progressive (SOF2) Huffman JPEG,
arithmetic-coded sequential and progressive JPEG (SOF9/SOF10, with DAC
conditioning: jdarith.c's QM decoder and its four progressive scan
kinds), and lossless JPEG (SOF3: predictors 1-7, the point transform,
restart intervals of whole MCU rows; libjpeg-turbo converts no colour
in lossless mode); 8-bit, one component (gray), three (YCbCr, or RGB
under an Adobe marker with transform 0 or R, G, B component ids) or four
(CMYK, or YCCK under an Adobe transform other than 0, then inverted as
PIL assumes Adobe's convention and taken to RGB by Pillow's cmyk2rgb);
sampling factors up to 4 whose ratios are whole; restart intervals; APPn
and COM skipped. Encoder: baseline 4:2:0 YCbCr with the Annex K Huffman
tables, the IJG quality scaling of the Annex K quantization tables, a
JFIF APP0 header and one DQT and one DHT marker per table, in libjpeg's
marker order.

The arithmetic is libjpeg's integer arithmetic, step for step: the
fixed-point colour conversion tables (jccolor.c, jdcolor.c), h2v2 / h2v1
downsampling with the alternating bias (jcsample.c), the "islow" forward
and inverse DCT (jfdctint.c, jidctint.c) with libjpeg's range limit,
quantization rounding half away from zero, and the upsampling of
jdsample.c: "fancy" triangle filters at ratio 2 (h2v1, h1v2 and h2v2;
box replication where a component is 2 samples wide or less), box
replication at ratios 3 and 4 (int_upsample), box replication for a
lossless frame. Image edges follow libjpeg: the last column and row
replicated before downsampling, dummy blocks in a partial MCU carrying
the previous block's DC. That block stage runs as integer tensor
operations on the image's device, so the card and the CPU give the same
bytes and the same pixels. The entropy stage runs on the host: the
encoder's run/size symbols and bit packing with numpy, the decoder's
Huffman lookup through a 65,536-entry table over a 16-bit peek, one
symbol at a time, or its arithmetic decoder one binary decision at a
time.

The variants libjpeg-turbo's 8-bit decoder (so PIL) fails on raise
ValueError, as corrupt or truncated data does: 12-bit and hierarchical
frames, a height left to a DNL marker, two components, fractional
sampling ratios, an MCU of more than 10 blocks and a lossless YCCK
frame. Entropy-coded data that ends at a marker before its MCUs do
decodes as libjpeg decodes it (the MCU that runs out reads zero bits,
the rest of its restart interval keeps what earlier scans gave it; in a
lossless scan the MCU row that runs out reads zero bits and the later
rows restart the prediction on zero differences), and
a run past a block's end writes its last coefficient, as libjpeg's
does. Arithmetic-coded lossless (SOF11), and a progressive file whose
scans leave AC coefficients 1-9 incomplete (libjpeg smooths its blocks),
raise NotImplementedError naming ROADMAP item 13 (probe finds them from
the markers).
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

# SOF markers: code -> (progressive, arithmetic, lossless)
_SOF = {0xC0: (False, False, False), 0xC1: (False, False, False),
        0xC2: (True, False, False), 0xC3: (False, False, True),
        0xC9: (False, True, False), 0xCA: (True, True, False)}
# the frames libjpeg-turbo does not decode: PIL fails on them
_FAILS = {0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
          0xC7: "hierarchical lossless (SOF7)",
          0xCD: "arithmetic-coded hierarchical (SOF13)",
          0xCE: "arithmetic-coded hierarchical (SOF14)",
          0xCF: "arithmetic-coded hierarchical (SOF15)"}


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP item "
                               f"13)")


def _check_frame(payload: bytes):
    """Raise ValueError for a frame header PIL (its plugin or
    libjpeg-turbo's 8-bit decoder) fails on: not 8-bit, other than 1, 3
    or 4 components, a zero dimension (the height left to a DNL marker)
    or a component's sampling factor not dividing the largest."""
    if len(payload) < 6 or len(payload) < 6 + 3 * payload[5]:
        raise ValueError("truncated JPEG frame header")
    prec, H, W, nc = struct.unpack(">BHHB", payload[:6])
    if prec != 8:
        raise ValueError(f"cannot handle {prec}-bit JPEG samples")
    if nc not in (1, 3, 4):
        raise ValueError(f"cannot handle a {nc}-component JPEG")
    if H == 0 or W == 0:
        raise ValueError("an empty JPEG frame (its height in a DNL "
                         "marker, which libjpeg does not read)")
    hv = [payload[7 + 3 * i] for i in range(nc)]
    h, v = [x >> 4 for x in hv], [x & 15 for x in hv]
    if min(h + v) < 1 or max(h + v) > 4:
        raise ValueError(f"JPEG sampling factors {h} x {v}")
    for a, b in zip(h, v):
        if max(h) % a or max(v) % b:
            raise ValueError(f"JPEG sampling factors {h} x {v} (a "
                             f"fractional ratio)")


def _check_marker(code: int, payload: bytes):
    """Raise for a frame marker the decoder does not read: ValueError
    where PIL fails too, NotImplementedError for arithmetic-coded
    lossless (SOF11)."""
    if code in _FAILS:
        raise ValueError(f"{_FAILS[code]} JPEG: libjpeg does not decode it")
    if code == 0xCB:
        raise _unported("arithmetic-coded lossless (SOF11) JPEG")
    if code in _SOF:
        _check_frame(payload)


def _smooths(progressive: bool, bits, quant) -> bool:
    """Whether libjpeg smooths a progressive frame's blocks at output
    (jdcoefct.c smoothing_ok, libjpeg-turbo's default do_block_smoothing):
    every component has a quantization table latched whose first ten
    zigzag values are nonzero and has DC data, and some component's
    coefficients 1-9 are not all complete. bits: per component, the
    point transform of the last scan that held each of zigzag
    coefficients 0-9 (-1: none)."""
    if not progressive:
        return False
    useful = False
    for b, q in zip(bits, quant):
        if q is None or not all(q[:10]) or b[0] < 0:
            return False
        useful = useful or any(b[1:10])
    return useful


def _smoothing():
    return _unported("a progressive JPEG whose scans leave AC coefficients "
                     "1-9 incomplete (a file cut short; libjpeg's block "
                     "smoothing)")


def _scan_bits(bits, comps, ss: int, se: int, al: int):
    """Record a progressive scan's point transform for the coefficients
    0-9 it holds (libjpeg's coef_bits)."""
    for ci in comps:
        for k in range(ss, min(se, 9) + 1):
            bits[ci][k] = al


def _scan_end(data: bytes, pos: int) -> int:
    """The position of the marker that ends the entropy-coded data from
    pos (not a restart marker), or -1 where the file ends first."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.nonzero(arr[:-1] == 0xFF)[0]
    code = arr[ff + 1]
    end = ff[(code != 0) & (code != 0xFF) & ((code < 0xD0) | (code > 0xD7))]
    return pos + int(end[0]) if len(end) else -1


def probe(data: bytes):
    """Raise NotImplementedError where `data` is a JPEG that decode() does
    not read, from its markers without decoding (a progressive file's
    scan headers too); data PIL fails on is left to decode()
    (ValueError)."""
    if data[:2] != b"\xff\xd8":
        return
    pos, n = 2, len(data)
    progressive, ids, tq, qt, bits, quant = False, [], [], {}, [], []
    while pos + 2 <= n and data[pos] == 0xFF:
        code = data[pos + 1]
        if code == 0xFF:
            pos += 1
            continue
        if code == 0xD9:
            break
        if 0xD0 <= code <= 0xD7 or code == 0x01:
            pos += 2
            continue
        if pos + 4 > n:
            return
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if end > n:
            return
        payload = data[pos + 4:end]
        if code == 0xCB:
            _check_marker(code, payload)
        elif code in _SOF and len(payload) >= 6:
            progressive = _SOF[code][0]
            if not progressive:
                return
            ids = list(payload[6::3])
            tq = list(payload[8::3])
            bits = [[-1] * 10 for _ in ids]
            quant = [None] * len(ids)
        elif code == 0xDB:
            i = 0
            while i < len(payload):
                wide = payload[i] >> 4
                qt[payload[i] & 15] = [
                    int.from_bytes(payload[i + 1 + k * (1 + wide):
                                           i + 2 + k * (1 + wide) + wide],
                                   "big") for k in range(10)]
                i += 129 if wide else 65
        elif code == 0xDA:
            if not progressive or not payload:
                return
            ns = payload[0]
            comps = [ids.index(c) for c in payload[1:1 + 2 * ns:2]
                     if c in ids]
            if len(payload) < 4 + 2 * ns:
                return
            for ci in comps:
                if quant[ci] is None:
                    quant[ci] = list(qt.get(tq[ci], [1] * 10))
            ss, se, a = payload[1 + 2 * ns:4 + 2 * ns]
            _scan_bits(bits, comps, ss, se, a & 15)
            end = _scan_end(data, end)
            if end < 0:
                return
        pos = end
    if _smooths(progressive, bits, quant):
        raise _smoothing()


class _Frame:
    """A frame header's geometry. A DCT frame's unit is an 8 x 8 block
    (its coefficients zigzag-ordered, 64 per block in coef), a lossless
    frame's one sample (its differences, then its samples, in coef)."""

    def __init__(self, payload: bytes, code: int):
        _, self.H, self.W, nc = struct.unpack(">BHHB", payload[:6])
        self.progressive, self.arith, self.lossless = _SOF[code]
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(nc):
            cid, hv, tq = payload[6 + 3 * i:9 + 3 * i]
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        u = self.unit = 1 if self.lossless else 8
        self.n = u * u
        self.hmax, self.vmax = max(self.h), max(self.v)
        self.mcux = -(-self.W // (u * self.hmax))
        self.mcuy = -(-self.H // (u * self.vmax))
        # per component: the sample grid, its units and the padded grid
        self.cw = [-(-self.W * h // self.hmax) for h in self.h]
        self.ch = [-(-self.H * v // self.vmax) for v in self.v]
        self.wib = [-(-w // u) for w in self.cw]
        self.hib = [-(-h // u) for h in self.ch]
        self.bw = [self.mcux * h for h in self.h]
        self.bh = [self.mcuy * v for v in self.v]
        self.coef = [[0] * (bw * bh * self.n) for bw, bh in zip(self.bw,
                                                                self.bh)]
        self.qt = [None] * nc
        # a progressive frame's coef_bits for zigzag coefficients 0-9
        self.bits = [[-1] * 10 for _ in range(nc)]
        # the arithmetic conditioning (DAC): DC (L, U) and AC K per table
        self.dc_lu = {t: (0, 1) for t in range(4)}
        self.ac_k = {t: 5 for t in range(4)}


def _segments(data: bytes, pos: int):
    """The entropy-coded data from pos: its restart segments (byte-stuffing
    removed) and the position of the marker that ends it."""
    end = _scan_end(data, pos)
    if end < 0:
        raise ValueError("truncated JPEG: the file ends inside a scan")
    arr = np.frombuffer(data, np.uint8, count=end - pos, offset=pos)
    ff = np.nonzero(arr[:-1] == 0xFF)[0]
    code = arr[ff + 1]
    rst = ff[(code >= 0xD0) & (code <= 0xD7)]
    bounds = [0] + [int(r) + 2 for r in rst]
    ends = [int(r) for r in rst] + [len(arr)]
    segs = []
    for a, b in zip(bounds, ends):
        # fill bytes (0xFF before a marker) carry no data
        while b > a and arr[b - 1] == 0xFF:
            b -= 1
        s = arr[a:b]
        keep = np.ones(len(s), bool)
        keep[1:] = ~((s[1:] == 0) & (s[:-1] == 0xFF))
        segs.append(s[keep])
    return segs, end


def _windows(seg, pad: int = 0):
    """For every byte offset i, bytes i..i+7 as a big-endian integer;
    `pad` more offsets past the data, all zero bits."""
    n = len(seg)
    b = np.concatenate([seg, np.zeros(8 + pad, np.uint8)]).astype(np.uint64)
    w = np.zeros(n + 1 + pad, np.uint64)
    for j in range(8):
        w |= b[j:j + n + 1 + pad] << np.uint64(56 - 8 * j)
    return w.tolist()


def _bad():
    raise ValueError("corrupt JPEG data: no Huffman code matches")


def _decode_scan(fr, comps, tabs, ss, se, ah, al, segs, restart):
    """Entropy-decode one scan into fr.coef (flat per component).
    comps: the scan's component indices; tabs: per scan component its
    (DC, AC) Huffman luts, or its (DC, AC) table numbers for arithmetic
    coding."""
    # the scan's units in order: (component, flat offset)
    n = fr.n
    if len(comps) == 1:
        ci = comps[0]
        bw = fr.bw[ci]
        order = [(0, (by * bw + bx) * n) for by in range(fr.hib[ci])
                 for bx in range(fr.wib[ci])]
        per_mcu = 1
        per_row = fr.wib[ci]
    else:
        order = []
        for my in range(fr.mcuy):
            for mx in range(fr.mcux):
                for j, ci in enumerate(comps):
                    h, v, bw = fr.h[ci], fr.v[ci], fr.bw[ci]
                    for yi in range(v):
                        for xi in range(h):
                            order.append((j, ((my * v + yi) * bw + mx * h
                                              + xi) * n))
        per_mcu = len(order) // (fr.mcux * fr.mcuy)
        per_row = fr.mcux
    step = restart * per_mcu if restart else len(order)
    n_seg = -(-len(order) // step)
    if fr.lossless and restart and restart % per_row:
        raise ValueError("a lossless JPEG's restart interval is not a "
                         "whole number of MCU rows")
    coefs = [fr.coef[ci] for ci in comps]
    # a restart interval whose data ends at a marker before its MCUs do
    # (libjpeg's "premature end of data segment" warning): the MCU that
    # runs out reads zero bits, the interval's later MCUs keep what
    # earlier scans gave them (jdhuff.c's insufficient_data). A scan that
    # ends at a marker other than the awaited restart leaves its later
    # intervals empty (jdmarker.c's resync, action 3): the flag stays set
    # across them, and an arithmetic decoder reads zeros through them. A
    # lossless scan runs out by MCU rows (jdlhuff.c): the row that runs
    # out reads zero bits, the later rows restart the prediction on zero
    # differences.
    empty = np.zeros(0, np.uint8)
    short = False
    # the lossless MCU rows that start the scan or a restart interval, or
    # follow the data's end, use the first row's prediction
    row = per_mcu * per_row
    first = {si * step // row for si in range(n_seg)}
    for si in range(n_seg):
        chunk = order[si * step:(si + 1) * step]
        seg = segs[si] if si < len(segs) else empty
        if fr.arith:
            _decode_arith(fr, seg, chunk, coefs, tabs, ss, se, ah, al,
                          len(comps))
            continue
        if si >= len(segs) and short:
            if fr.lossless:
                first.update(range(si * step // row,
                                   (si * step + len(chunk)) // row))
            continue
        # room for an MCU (a lossless MCU row) of zero bits past the data:
        # at most 256 bytes a unit (4 a lossless one)
        W = _windows(seg, 4 * row if fr.lossless else 256 * per_mcu)
        stop = 8 * len(seg)
        try:
            if fr.lossless:
                p, done = _decode_lossless(W, chunk, coefs, tabs, stop, row)
                if p > stop:
                    first.update(range((si * step + done) // row,
                                       (si * step + len(chunk)) // row))
            elif fr.progressive:
                p = _decode_progressive(W, chunk, coefs, tabs, ss, se, ah,
                                        al, len(comps), stop, per_mcu)
            else:
                p = _decode_sequential(W, chunk, coefs, tabs, len(comps),
                                       stop, per_mcu)
        except TypeError:
            raise ValueError("corrupt JPEG: a scan names a Huffman table "
                             "the file does not define") from None
        short = p > stop
    if fr.lossless:
        for j, ci in enumerate(comps):
            v = 1 if len(comps) == 1 else fr.v[ci]
            rows = fr.hib[ci] if len(comps) == 1 else fr.bh[ci]
            _undifference(fr, ci, rows, {r * v for r in first}, ss, al)


def _decode_lossless(W, chunk, coefs, tabs, stop, row):
    """The Huffman-coded differences of a lossless scan (category s, then
    s bits; 16: 32,768), up to the MCU row (`row` units) that reads past
    bit `stop`. Returns the bits read and the units decoded."""
    p = 0
    for i, (j, base) in enumerate(chunk):
        if p > stop and not i % row:
            return p, i
        dcl = tabs[j][0]
        w = W[p >> 3] << (p & 7)
        e = dcl[(w >> 48) & 0xFFFF] or _bad()
        ln = e >> 8
        s = e & 31
        if s == 16:
            v = 32768
        elif s:
            v = (w >> (64 - ln - s)) & ((1 << s) - 1)
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
        else:
            v = 0
        p += ln + (s if s < 16 else 0)
        coefs[j][base] = v
    return p, len(chunk)


def _undifference(fr, ci, rows: int, first_rows, psv: int, pt: int):
    """libjpeg's lossless prediction (jdpred.c) over component ci's
    differences, in place: a first row predicted from 2^(P - Pt - 1),
    then its left neighbour; later rows' first sample from above, the
    rest by predictor psv; sums modulo 2^16, then shifted up by Pt and
    cut to 8 bits."""
    bw = fr.bw[ci]
    width = fr.wib[ci] if rows == fr.hib[ci] else bw
    c = fr.coef[ci]
    top = 1 << (8 - pt - 1)
    prev = None
    for y in range(rows):
        row = c[y * bw:y * bw + width]
        out = [0] * width
        if y in first_rows or prev is None:
            acc = top
            for x in range(width):
                acc = (row[x] + acc) & 0xFFFF
                out[x] = acc
        else:
            out[0] = (row[0] + prev[0]) & 0xFFFF
            for x in range(1, width):
                ra, rb, rc = out[x - 1], prev[x], prev[x - 1]
                if psv == 1:
                    pr = ra
                elif psv == 2:
                    pr = rb
                elif psv == 3:
                    pr = rc
                elif psv == 4:
                    pr = ra + rb - rc
                elif psv == 5:
                    pr = ra + ((rb - rc) >> 1)
                elif psv == 6:
                    pr = rb + ((ra - rc) >> 1)
                else:
                    pr = (ra + rb) >> 1
                out[x] = (row[x] + pr) & 0xFFFF
        prev = out
        c[y * bw:y * bw + width] = [(v << pt) & 0xFF for v in out]


# libjpeg's jaricom.c table: (Qe << 16) | (next MPS index << 8) |
# (switch << 7) | next LPS index, per state
def _v(qe, lps, mps, switch):
    return (qe << 16) | (mps << 8) | (switch << 7) | lps


ARITAB = [_v(*r) for r in (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))]


def _decode_arith(fr, seg, chunk, coefs, tabs, ss, se, ah, al, nc):
    """libjpeg's jdarith.c over one restart interval: the QM decoder
    (arith_decode) and decode_mcu (sequential) or decode_mcu_DC_first /
    AC_first / DC_refine / AC_refine (progressive), the statistics bins
    zeroed at the interval's start."""
    data = seg.tolist()
    nd = len(data)
    # the decoder state: c, a, ct, the read position
    st_c, st_a, st_ct, st_pos = 0, 0, -16, 0
    bad = [False]

    def decode(bins, i):
        nonlocal st_c, st_a, st_ct, st_pos
        while st_a < 0x8000:
            st_ct -= 1
            if st_ct < 0:
                # past the interval's data: zeros, as after a marker
                b = data[st_pos] if st_pos < nd else 0
                st_pos += 1
                st_c = (st_c << 8) | b
                st_ct += 8
                if st_ct < 0:
                    st_ct += 1
                    if st_ct == 0:
                        st_a = 0x8000
            st_a <<= 1
        sv = bins[i]
        qe = ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        qe >>= 8
        nm = qe & 0xFF
        qe >>= 8
        temp = st_a - qe
        st_a = temp
        temp <<= st_ct
        if st_c >= temp:
            st_c -= temp
            if st_a < qe:
                st_a = qe
                bins[i] = (sv & 0x80) ^ nm
            else:
                st_a = qe
                bins[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif st_a < 0x8000:
            if st_a < qe:
                bins[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                bins[i] = (sv & 0x80) ^ nm
        return sv >> 7

    fixed = [113]
    dc_stats = {t: [0] * 64 for t in range(4)}
    ac_stats = {t: [0] * 256 for t in range(4)}
    last_dc = [0] * nc
    dc_ctx = [0] * nc

    def dc_diff(j, tbl):
        bins = dc_stats[tbl]
        st = dc_ctx[j]
        if decode(bins, st) == 0:
            dc_ctx[j] = 0
            return 0
        sign = decode(bins, st + 1)
        st += 2 + sign
        m = decode(bins, st)
        if m:
            st = 20
            while decode(bins, st):
                m <<= 1
                if m == 0x8000:
                    bad[0] = True
                    return 0
                st += 1
        lo, up = fr.dc_lu[tbl]
        if m < (1 << lo) >> 1:
            dc_ctx[j] = 0
        elif m > (1 << up) >> 1:
            dc_ctx[j] = 12 + sign * 4
        else:
            dc_ctx[j] = 4 + sign * 4
        v = m
        st += 14
        m >>= 1
        while m:
            if decode(bins, st):
                v |= m
            m >>= 1
        v += 1
        return -v if sign else v

    def ac_value(bins, st, k, tbl):
        """The nonzero value after its position: sign, category, bits."""
        sign = decode(fixed, 0)
        st += 2
        m = decode(bins, st)
        if m:
            if decode(bins, st):
                m <<= 1
                st = 189 if k <= fr.ac_k[tbl] else 217
                while decode(bins, st):
                    m <<= 1
                    if m == 0x8000:
                        bad[0] = True
                        return 0
                    st += 1
        v = m
        st += 14
        m >>= 1
        while m:
            if decode(bins, st):
                v |= m
            m >>= 1
        v += 1
        return -v if sign else v

    def ac_run(coef, base, tbl, k0, k1, shift):
        bins = ac_stats[tbl]
        k = k0
        while k <= k1:
            st = 3 * (k - 1)
            if decode(bins, st):
                return
            while decode(bins, st + 1) == 0:
                st += 3
                k += 1
                if k > k1:
                    bad[0] = True
                    return
            v = ac_value(bins, st, k, tbl)
            if bad[0]:
                return
            coef[base + k] = v << shift if v >= 0 else -((-v) << shift)
            k += 1

    for j, base in chunk:
        if bad[0]:
            # libjpeg stops decoding the interval after a bad code
            break
        coef = coefs[j]
        dct, act = tabs[j]
        if not fr.progressive:
            last_dc[j] += dc_diff(j, dct)
            coef[base] = last_dc[j]
            ac_run(coef, base, act, 1, 63, 0)
        elif ss == 0:
            if ah == 0:
                last_dc[j] += dc_diff(j, dct)
                coef[base] = last_dc[j] << al
            elif decode(fixed, 0):
                coef[base] |= 1 << al
        elif ah == 0:
            ac_run(coef, base, act, ss, se, al)
        else:
            # AC refinement (decode_mcu_AC_refine)
            bins = ac_stats[act]
            p1, m1 = 1 << al, -1 << al
            kex = se
            while kex > 0 and not coef[base + kex]:
                kex -= 1
            k = ss
            while k <= se:
                st = 3 * (k - 1)
                if k > kex and decode(bins, st):
                    break
                while True:
                    c = coef[base + k]
                    if c:
                        if decode(bins, st + 2):
                            coef[base + k] = c + (m1 if c < 0 else p1)
                        break
                    if decode(bins, st + 1):
                        coef[base + k] = m1 if decode(fixed, 0) else p1
                        break
                    st += 3
                    k += 1
                    if k > se:
                        bad[0] = True
                        break
                if bad[0]:
                    break
                k += 1


def _decode_sequential(W, chunk, coefs, tabs, nc, stop, per_mcu):
    """A baseline or extended Huffman scan, up to the MCU that reads past
    bit `stop`; a run past the block's end writes its last coefficient
    (libjpeg's jpeg_natural_order ends in 16 entries of 63)."""
    p = 0
    pred = [0] * nc
    for i, (j, base) in enumerate(chunk):
        if p > stop and not i % per_mcu:
            break
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
                k = min(k + ((e >> 4) & 15), 63)
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


def _decode_progressive(W, chunk, coefs, tabs, ss, se, ah, al, nc, stop,
                        per_mcu):
    """jdphuff.c's four scan kinds: DC first / refine, AC first / refine
    (with end-of-band runs), up to the MCU that reads past bit `stop`; a
    run past the block's end writes its last coefficient."""
    p = 0
    pred = [0] * nc
    eobrun = 0
    p1 = 1 << al
    m1 = -1 << al
    for i, (j, base) in enumerate(chunk):
        if p > stop and not i % per_mcu:
            break
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
                    k = min(k + r, 63)
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
                    coef[base + min(k, 63)] = s
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
    coefficients (or a lossless frame's samples) and the Adobe marker's
    transform (None without one)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    pos = 2
    qt, huff = {}, {}
    fr = None
    restart = 0
    adobe = None
    dac = []
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
        if code in _SOF:
            fr = _Frame(payload, code)
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
        elif code == 0xCC:
            dac += [payload[i:i + 2] for i in range(0, len(payload) - 1, 2)]
        elif code == 0xDD:
            restart = struct.unpack(">H", payload[:2])[0]
        elif code == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12:
            adobe = payload[11]
        elif code == 0xDA:
            if fr is None:
                raise ValueError("JPEG scan before its frame header")
            for tcb, val in dac:
                if tcb >> 4:
                    fr.ac_k[tcb & 15] = val
                else:
                    fr.dc_lu[tcb & 15] = (val & 15, val >> 4)
            dac = []
            ns = payload[0]
            comps, tabs = [], []
            for i in range(ns):
                cid, t = payload[1 + 2 * i:3 + 2 * i]
                if cid not in fr.ids:
                    raise ValueError("a JPEG scan names no component of its "
                                     "frame")
                ci = fr.ids.index(cid)
                comps.append(ci)
                if fr.qt[ci] is None:
                    fr.qt[ci] = qt.get(fr.tq[ci], np.ones(64, np.int64))
                if fr.arith:
                    tabs.append((t >> 4, t & 15))
                else:
                    tabs.append((huff.get((0, t >> 4)), huff.get((1, t & 15))))
            if ns > 1 and sum(fr.h[ci] * fr.v[ci] for ci in comps) > 10:
                raise ValueError("a JPEG MCU of more than 10 blocks "
                                 "(libjpeg's limit)")
            ss, se, a = payload[1 + 2 * ns:4 + 2 * ns]
            segs, pos = _segments(data, pos)
            _scan_bits(fr.bits, comps, ss, se, a & 15)
            _decode_scan(fr, comps, tabs, ss, se, a >> 4, a & 15, segs,
                         restart)
    if fr is None:
        raise ValueError("JPEG without a frame header")
    if _smooths(fr.progressive, fr.bits, fr.qt):
        raise _smoothing()
    return fr, adobe


def cmyk_to_rgb(cmyk):
    """Pillow's cmyk2rgb on int64 values 0..255 [..., 4], a tensor (the
    JPEG decoder's) or a numpy array (utils/tiff.py's): nk = 255 - k,
    each of c, m, y to nk - c * nk / 255 (MULDIV255's rounding), which
    lies in 0..nk, so Pillow's clip to 0..255 changes nothing."""
    nk = 255 - cmyk[..., 3:]
    t = cmyk[..., :3] * nk + 128
    return nk - (((t >> 8) + t) >> 8)


def decode(data: bytes, device=None, colorspace=None):
    """Decode a JPEG as PIL's convert("RGB") reads it: uint8 [H, W] (gray)
    or [H, W, 3] (RGB) on `device` (the card unless "cpu"); the entropy
    stage on the host. Three components are YCbCr unless an Adobe marker
    says transform 0 or the component ids are R, G, B (a lossless frame's
    are never converted: libjpeg-turbo converts no colour in lossless
    mode); four are CMYK, or YCCK under an Adobe transform other than 0
    (libjpeg's conversion to CMYK; PIL fails on a lossless one), then
    inverted as PIL assumes Adobe's convention and taken to
    RGB by Pillow's cmyk2rgb. colorspace "ycc" or "none" forces three
    components' transform (YCbCr to RGB, or none), as libtiff sets
    libjpeg's jpeg_color_space for a JPEG-compressed TIFF."""
    dev = resolve_device(device)
    fr, adobe = _parse(data)
    zz = torch.as_tensor(UNZIGZAG, device=dev)
    planes = []
    for ci in range(len(fr.ids)):
        if fr.qt[ci] is None:
            raise ValueError("truncated JPEG: a component has no scan")
        c = torch.as_tensor(np.asarray(fr.coef[ci], np.int64), device=dev)
        if fr.lossless:
            plane = c.reshape(fr.bh[ci], fr.bw[ci])[:fr.ch[ci], :fr.cw[ci]]
            # libjpeg's fancy upsampling needs DCT blocks: box here
            plane = plane.repeat_interleave(fr.vmax // fr.v[ci], 0) \
                .repeat_interleave(fr.hmax // fr.h[ci], 1)
        else:
            c = c.reshape(-1, 64)[:, zz]
            c = c * torch.as_tensor(fr.qt[ci][UNZIGZAG], device=dev)
            s = idct_islow(c.reshape(-1, 8, 8))
            plane = _unblocks(s, fr.bh[ci], fr.bw[ci])[:fr.ch[ci],
                                                        :fr.cw[ci]]
            plane = upsample(plane, fr.hmax // fr.h[ci],
                             fr.vmax // fr.v[ci])
        planes.append(plane[:fr.H, :fr.W])
    if len(planes) == 1:
        out = planes[0]
    elif len(planes) == 4:
        if adobe not in (None, 0) and fr.lossless:
            raise ValueError("a lossless YCCK JPEG: libjpeg-turbo converts "
                             "no colour in lossless mode and PIL asks for "
                             "CMYK")
        if adobe not in (None, 0):
            # YCCK -> CMYK (jdcolor.c ycck_cmyk_convert)
            rgb = ycc_to_rgb(*planes[:3])
            planes = [255 - rgb[..., 0], 255 - rgb[..., 1], 255 - rgb[..., 2],
                      planes[3]]
        # PIL's "CMYK;I" rawmode, then its cmyk2rgb
        out = cmyk_to_rgb(255 - torch.stack(planes, -1))
    elif colorspace == "none" or colorspace is None and (
            adobe == 0 or fr.lossless
            or fr.ids == [ord("R"), ord("G"), ord("B")]):
        out = torch.stack(planes, -1)
    else:
        out = ycc_to_rgb(*planes)
    return out.to(torch.uint8)


def read_jpeg(path: str, device=None):
    with open(path, "rb") as f:
        return decode(f.read(), device)
