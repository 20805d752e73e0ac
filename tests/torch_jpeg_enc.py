"""Test-side JPEG writers for the variants PIL cannot write: any
component layout (1, 3 or 4 components, sampling factors up to 4) over
given DCT coefficients, coded with Huffman tables (Annex K's) or with
libjpeg's arithmetic coder (a transcription of jcarith.c: sequential
SOF9 and progressive SOF10 with DAC conditioning and restarts), and
lossless SOF3 files (predictors 1-7, point transform). The coefficients
come from PIL's own baseline files (coefficients_of), so a file written
here decodes, in PIL, to the same pixels as PIL's file of the same
blocks; PIL decoding each written file also checks the writers."""
import io
import struct

import numpy as np
from PIL import Image

from hairpt_torch.utils import jpeg as tjpeg


def coefficients_of(gray: np.ndarray, quality: int):
    """A gray uint8 image [8 bh, 8 bw] through PIL's baseline encoder:
    (its quantized blocks [bh, bw, 64] in zigzag order, its luminance
    table in natural order)."""
    b = io.BytesIO()
    Image.fromarray(gray, "L").save(b, "JPEG", quality=quality)
    fr, _ = tjpeg._parse(b.getvalue())
    blocks = np.asarray(fr.coef[0], np.int64).reshape(fr.bh[0], fr.bw[0], 64)
    return blocks, np.asarray(fr.qt[0], np.int64)


def component_blocks(rng, W, H, sampling, quality=85):
    """Random smooth planes for a frame W x H with the given (h, v) per
    component: each component's blocks [bh, bw, 64] (zigzag) and one
    quantization table (natural order) that all of them share."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    out, table = [], None
    for h, v in sampling:
        bw, bh = mcux * h, mcuy * v
        y, x = np.mgrid[0:8 * bh, 0:8 * bw]
        base = rng.uniform(40, 215)
        fx, fy = rng.uniform(3, 9), rng.uniform(4, 11)
        g = base + 35 * np.sin(x / fx + y / fy) \
            + rng.normal(0, 9, (8 * bh, 8 * bw))
        blocks, table = coefficients_of(np.clip(g, 0, 255).astype(np.uint8),
                                        quality)
        out.append(blocks)
    return out, table


def _marker(code, payload):
    return struct.pack(">BBH", 0xFF, code, len(payload) + 2) + payload


class _Bits:
    """MSB-first bits with 0xFF stuffing, padded with 1 bits."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _category(v):
    return int(abs(v)).bit_length()


def _value_bits(v, s):
    return v if v >= 0 else v + (1 << s) - 1


def _units(W, H, sampling, comps, unit=8):
    """The scan's units in order: (component, by, bx), and the units per
    MCU (as the decoder orders them)."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-W // (unit * hmax)), -(-H // (unit * vmax))
    if len(comps) == 1:
        c = comps[0]
        h, v = sampling[c]
        cw, ch = -(-W * h // hmax), -(-H * v // vmax)
        return [(c, by, bx) for by in range(-(-ch // unit))
                for bx in range(-(-cw // unit))], 1
    order = []
    for my in range(mcuy):
        for mx in range(mcux):
            for c in comps:
                h, v = sampling[c]
                order += [(c, my * v + yi, mx * h + xi) for yi in range(v)
                          for xi in range(h)]
    return order, sum(sampling[c][0] * sampling[c][1] for c in comps)


def _header(W, H, sampling, qtable, sof, adobe=None, ids=None, height=None,
            precision=8):
    ids = ids or list(range(1, len(sampling) + 1))
    out = [b"\xff\xd8"]
    if adobe is not None:
        out.append(_marker(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                        adobe)))
    if qtable is not None:
        out.append(_marker(0xDB, bytes([0]) + bytes(
            qtable[tjpeg.ZIGZAG].astype(np.uint8))))
    comp = b"".join(bytes([ids[i], (h << 4) | v, 0])
                    for i, (h, v) in enumerate(sampling))
    out.append(_marker(sof, struct.pack(">BHHB", precision,
                                        H if height is None else height, W,
                                        len(sampling)) + comp))
    return out, ids


def huffman_jpeg(W, H, sampling, blocks, qtable, adobe=None, ids=None,
                 restart=0, dnl=False, sof=0xC0):
    """A sequential Huffman JPEG (Annex K's luminance tables for every
    component) of the given blocks, one interleaved scan; dnl: the
    frame's height 0 and a DNL marker after the scan."""
    out, ids = _header(W, H, sampling, qtable, sof, adobe, ids,
                       0 if dnl else None)
    dcc, dcv = tjpeg.STD_HUFF[(0, 0)]
    acc, acv = tjpeg.STD_HUFF[(1, 0)]
    out.append(_marker(0xC4, bytes([0x00]) + bytes(dcc) + dcv))
    out.append(_marker(0xC4, bytes([0x10]) + bytes(acc) + acv))
    if restart:
        out.append(_marker(0xDD, struct.pack(">H", restart)))
    n = len(sampling)
    out.append(_marker(0xDA, bytes([n]) + b"".join(
        bytes([ids[i], 0x00]) for i in range(n)) + bytes([0, 63, 0])))
    dc = tjpeg._huff_codes(dcc, dcv)
    ac = tjpeg._huff_codes(acc, acv)
    order, per = _units(W, H, sampling, list(range(n)))
    bits, pred = _Bits(), [0] * n
    for i, (c, by, bx) in enumerate(order):
        if restart and i and i % (restart * per) == 0:
            out.append(bits.flush())
            out.append(bytes([0xFF, 0xD0 + (i // (restart * per) - 1) % 8]))
            bits, pred = _Bits(), [0] * n
        z = blocks[c][by, bx]
        d = int(z[0]) - pred[c]
        pred[c] = int(z[0])
        s = _category(d)
        bits.put(*dc[s])
        bits.put(_value_bits(d, s), s)
        run = 0
        last = max([k for k in range(1, 64) if z[k]] or [0])
        for k in range(1, last + 1):
            v = int(z[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac[0xF0])
                run -= 16
            s = _category(v)
            bits.put(*ac[(run << 4) | s])
            bits.put(_value_bits(v, s), s)
            run = 0
        if last < 63:
            bits.put(*ac[0])
    out.append(bits.flush())
    if dnl:
        out.append(_marker(0xDC, struct.pack(">H", H)))
    out.append(b"\xff\xd9")
    return b"".join(out)


class _ArithEncoder:
    """jcarith.c's arith_encode and finish_pass."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit_stacked(self, byte):
        if self.zc:
            self.out += b"\0" * self.zc
            self.zc = 0
        self.out.append(byte)

    def encode(self, bins, i, val):
        sv = bins[i]
        qe = tjpeg.ARITAB[sv & 0x7F]
        nl = qe & 0xFF
        qe >>= 8
        nm = qe & 0xFF
        qe >>= 8
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._emit_stacked(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self.out.append(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._emit_stacked(self.buffer)
                    if self.sc:
                        if self.zc:
                            self.out += b"\0" * self.zc
                            self.zc = 0
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_stacked(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_stacked(self.buffer)
            if self.sc:
                if self.zc:
                    self.out += b"\0" * self.zc
                    self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            if self.zc:
                self.out += b"\0" * self.zc
                self.zc = 0
            b = (self.c >> 19) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
        return bytes(self.out)


def _shr(v, al):
    """The point transform of an AC coefficient: |v| >> al, signed."""
    return (abs(v) >> al) * (1 if v >= 0 else -1)


def _arith_scan(order, per, blocks, n_comp, restart, kind, ss, se, ah, al,
                dc_lu, ac_k):
    """One scan's arithmetic-coded bytes (restart markers included):
    jcarith.c's encode_mcu / encode_mcu_DC_first / AC_first / DC_refine /
    AC_refine."""
    parts = []
    enc = None

    def start():
        nonlocal enc
        enc = _ArithEncoder()
        return ({t: [0] * 64 for t in range(4)},
                {t: [0] * 256 for t in range(4)}, [0] * n_comp,
                [0] * n_comp)

    dc_stats, ac_stats, last_dc, dc_ctx = start()
    fixed = [113]

    def put_dc(c, diff):
        bins = dc_stats[0]
        st = dc_ctx[c]
        if diff == 0:
            enc.encode(bins, st, 0)
            dc_ctx[c] = 0
            return
        enc.encode(bins, st, 1)
        if diff > 0:
            enc.encode(bins, st + 1, 0)
            st += 2
            dc_ctx[c] = 4
        else:
            diff = -diff
            enc.encode(bins, st + 1, 1)
            st += 3
            dc_ctx[c] = 8
        m = 0
        diff -= 1
        if diff:
            enc.encode(bins, st, 1)
            m = 1
            v2 = diff
            st = 20
            v2 >>= 1
            while v2:
                enc.encode(bins, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
        enc.encode(bins, st, 0)
        lo, up = dc_lu
        if m < (1 << lo) >> 1:
            dc_ctx[c] = 0
        elif m > (1 << up) >> 1:
            dc_ctx[c] += 8
        st += 14
        m >>= 1
        while m:
            enc.encode(bins, st, 1 if m & diff else 0)
            m >>= 1

    def put_ac_value(bins, st, k, v):
        st += 2
        m = 0
        v -= 1
        if v:
            enc.encode(bins, st, 1)
            m = 1
            v2 = v >> 1
            if v2:
                enc.encode(bins, st, 1)
                m <<= 1
                st = 189 if k <= ac_k else 217
                v2 >>= 1
                while v2:
                    enc.encode(bins, st, 1)
                    m <<= 1
                    st += 1
                    v2 >>= 1
        enc.encode(bins, st, 0)
        st += 14
        m >>= 1
        while m:
            enc.encode(bins, st, 1 if m & v else 0)
            m >>= 1

    def put_ac(z, k0, k1, shift):
        bins = ac_stats[0]
        vals = [_shr(int(z[k]), shift) for k in range(64)]
        ke = k1
        while ke >= k0 and vals[ke] == 0:
            ke -= 1
        k = k0
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(bins, st, 0)
            while vals[k] == 0:
                enc.encode(bins, st + 1, 0)
                st += 3
                k += 1
            enc.encode(bins, st + 1, 1)
            v = vals[k]
            enc.encode(fixed, 0, 0 if v > 0 else 1)
            put_ac_value(bins, st, k, abs(v))
            k += 1
        if k <= k1:
            enc.encode(bins, 3 * (k - 1), 1)

    def put_ac_refine(z):
        bins = ac_stats[0]
        ke = se
        while ke > 0 and _shr(int(z[ke]), al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and _shr(int(z[kex]), ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(bins, st, 0)
            while True:
                v = _shr(int(z[k]), al)
                if v:
                    av = abs(v)
                    if av >> 1:
                        enc.encode(bins, st + 2, av & 1)
                    else:
                        enc.encode(bins, st + 1, 1)
                        enc.encode(fixed, 0, 0 if v > 0 else 1)
                    break
                enc.encode(bins, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(bins, 3 * (k - 1), 1)

    for i, (c, by, bx) in enumerate(order):
        if restart and i and i % (restart * per) == 0:
            parts.append(enc.finish())
            parts.append(bytes([0xFF, 0xD0 + (i // (restart * per) - 1) % 8]))
            dc_stats, ac_stats, last_dc, dc_ctx = start()
        z = blocks[c][by, bx]
        j = c if n_comp > 1 else 0
        if kind == "seq":
            put_dc(j, int(z[0]) - last_dc[j])
            last_dc[j] = int(z[0])
            put_ac(z, 1, 63, 0)
        elif kind == "dc_first":
            v = int(z[0]) >> al
            put_dc(j, v - last_dc[j])
            last_dc[j] = v
        elif kind == "dc_refine":
            enc.encode(fixed, 0, (int(z[0]) >> al) & 1)
        elif kind == "ac_first":
            put_ac(z, ss, se, al)
        else:
            put_ac_refine(z)
    parts.append(enc.finish())
    return b"".join(parts)


# libjpeg's default progression for the scans, (components, Ss, Se, Ah,
# Al): None = all components interleaved
PROGRESSION = [(None, 0, 0, 0, 1), ("each", 1, 5, 0, 2),
               ("each", 6, 63, 0, 2), ("each", 1, 63, 2, 1),
               (None, 0, 0, 1, 0), ("each", 1, 63, 1, 0)]


def arith_jpeg(W, H, sampling, blocks, qtable, progressive=False, adobe=None,
               ids=None, restart=0, dac=None):
    """An arithmetic-coded JPEG (SOF9, or SOF10 with PROGRESSION) of the
    given blocks; dac: (DC L, DC U, AC K) for table 0, written in a DAC
    marker."""
    out, ids = _header(W, H, sampling, qtable, 0xCA if progressive else 0xC9,
                       adobe, ids)
    lo, up, k = dac or (0, 1, 5)
    if dac:
        out.append(_marker(0xCC, bytes([0x00, (up << 4) | lo, 0x10, k])))
    if restart:
        out.append(_marker(0xDD, struct.pack(">H", restart)))
    n = len(sampling)
    scans = [(None, 0, 63, 0, 0)] if not progressive else PROGRESSION
    for comps, ss, se, ah, al in scans:
        groups = [list(range(n))] if comps is None else [[c] for c in
                                                         range(n)]
        for g in groups:
            out.append(_marker(0xDA, bytes([len(g)]) + b"".join(
                bytes([ids[c], 0x00]) for c in g) + bytes([ss, se,
                                                           (ah << 4) | al])))
            order, per = _units(W, H, sampling, g)
            kind = "seq" if not progressive else (
                ("dc_first" if ah == 0 else "dc_refine") if ss == 0
                else ("ac_first" if ah == 0 else "ac_refine"))
            out.append(_arith_scan(order, per, blocks, len(g), restart, kind,
                                   ss, se, ah, al, (lo, up), k))
    out.append(b"\xff\xd9")
    return b"".join(out)


def lossless_jpeg(planes, psv=1, pt=0, adobe=None, ids=None,
                  sampling=None, restart=0):
    """A lossless (SOF3) JPEG of uint8 sample planes (component sizes as
    the sampling factors give them), one interleaved scan, Huffman table
    0 for every component: categories 0-13 in 4 bits, 14-16 in 5."""
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    H, W = planes[0].shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    W = W * hmax // sampling[0][0]
    H = H * vmax // sampling[0][1]
    out, ids = _header(W, H, sampling, None, 0xC3, adobe, ids)
    counts = [0, 0, 0, 14, 3] + [0] * 11
    vals = bytes(range(17))
    out.append(_marker(0xC4, bytes([0x00]) + bytes(counts) + vals))
    if restart:
        out.append(_marker(0xDD, struct.pack(">H", restart)))
    out.append(_marker(0xDA, bytes([n]) + b"".join(
        bytes([ids[i], 0x00]) for i in range(n)) + bytes([psv, 0, pt])))
    codes = tjpeg._huff_codes(counts, vals)
    mcux, mcuy = -(-W // hmax), -(-H // vmax)
    # each component padded to whole MCUs by edge replication
    grids = []
    for p, (h, v) in zip(planes, sampling):
        g = np.pad(p.astype(np.int64) >> pt,
                   ((0, mcuy * v - p.shape[0]), (0, mcux * h - p.shape[1])),
                   mode="edge")
        grids.append(g)
    order, per = _units(W, H, sampling, list(range(n)), unit=1)
    per_row = mcux
    first = set()
    if restart:
        first = {i // per // per_row for i in range(0, len(order),
                                                     restart * per)}
    bits = _Bits()
    top = 1 << (8 - pt - 1)
    for i, (c, y, x) in enumerate(order):
        if restart and i and i % (restart * per) == 0:
            out.append(bits.flush())
            out.append(bytes([0xFF, 0xD0 + (i // (restart * per) - 1) % 8]))
            bits = _Bits()
        g = grids[c]
        v = sampling[c][1]
        first_row = y == 0 or (y % v == 0 and y // v in first)
        if first_row:
            pred = top if x == 0 else int(g[y, x - 1])
        elif x == 0:
            pred = int(g[y - 1, 0])
        else:
            ra, rb, rc = int(g[y, x - 1]), int(g[y - 1, x]), \
                int(g[y - 1, x - 1])
            pred = [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                    rb + ((ra - rc) >> 1), (ra + rb) >> 1][psv]
        d = int(g[y, x]) - pred
        s = _category(d)
        bits.put(*codes[s])
        if s < 16:
            bits.put(_value_bits(d, s), s)
    out.append(bits.flush())
    out.append(b"\xff\xd9")
    return b"".join(out)
