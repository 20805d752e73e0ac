"""Minimal OpenEXR 2.0 scanline reader/writer, pure numpy + zlib (port of
hairpt/utils/exr.py, unchanged in behaviour).

Single-part scanline images, HALF or FLOAT channels, NONE / ZIPS / ZIP
compression, increasing-Y line order (the reference hdrfilm's default EXR
output, src/films/hdrfilm.cpp:205). The ZIP predictor+interleave
transform follows the OpenEXR file-format specification ("zip
compression: the data is split into two halves, delta encoded, then
deflated").

Not supported (raises): tiled/deep/multipart files, PIZ/PXR24/B44/DWA
compression, subsampled channels.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


# ---------------------------------------------------------------------------
# the ZIP pixel-data transform (split halves + byte delta, then deflate)
# ---------------------------------------------------------------------------

def _zip_compress(raw: bytes) -> bytes:
    b = np.frombuffer(raw, np.uint8)
    n = b.size
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = b[0::2]
    tmp[half:] = b[1::2]
    # delta encode: t[i] = t[i] - t[i-1] + 384 (mod 256)
    out = np.empty(n, np.uint8)
    out[0] = tmp[0]
    d = tmp[1:].astype(np.int32) - tmp[:-1].astype(np.int32) + (128 + 256)
    out[1:] = (d & 0xFF).astype(np.uint8)
    return zlib.compress(out.tobytes())


def _zip_decompress(data: bytes, raw_size: int) -> bytes:
    tmp = np.frombuffer(zlib.decompress(data), np.uint8).copy()
    if tmp.size != raw_size:
        raise ValueError("EXR zip chunk has wrong decompressed size")
    # un-delta (prefix sum mod 256)
    tmp[1:] = (tmp[1:].astype(np.int64) - (128 + 256)) & 0xFF
    tmp = np.cumsum(tmp.astype(np.int64)) & 0xFF
    tmp = tmp.astype(np.uint8)
    # un-split
    half = (raw_size + 1) // 2
    out = np.empty(raw_size, np.uint8)
    out[0::2] = tmp[:half]
    out[1::2] = tmp[half:]
    return out.tobytes()


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _attr(name: str, typ: str, data: bytes) -> bytes:
    return name.encode() + b"\0" + typ.encode() + b"\0" \
        + struct.pack("<i", len(data)) + data


class ExrScanlineWriter:
    """Incremental scanline-EXR writer: scanline bands are compressed and
    appended as they arrive, so the full image never has to be resident —
    the out-of-core accumulation mode of the reference's tiledhdrfilm
    (src/films/tiledhdrfilm.cpp, which streams blocks through IlmImf's
    TiledOutputFile). The chunk offset table is back-patched on close().

    Usage:
        w = ExrScanlineWriter(path, h, w, channels=3)
        w.write_band(y0, band)   # bands in increasing-y order;
                                 # y0 multiple of the compression block
        w.close()
    """

    def __init__(self, path: str, height: int, width: int,
                 channels: int = 3, *, half: bool = True,
                 compression: str = "zip"):
        self.h, self.w, self.c = height, width, channels
        names = {1: ["Y"], 3: ["R", "G", "B"],
                 4: ["R", "G", "B", "A"]}[channels]
        self._comp = {"none": _COMP_NONE, "zips": _COMP_ZIPS,
                      "zip": _COMP_ZIP}[compression]
        self._dtype = np.float16 if half else np.float32
        pt = _PT_HALF if half else _PT_FLOAT
        # channel list, sorted by name (EXR requirement)
        self._order = np.argsort(names)
        chans = b""
        for i in self._order:
            chans += names[i].encode() + b"\0" + struct.pack(
                "<iBBBBii", pt, 0, 0, 0, 0, 1, 1)
        chans += b"\0"
        box = struct.pack("<4i", 0, 0, width - 1, height - 1)
        header = b"".join([
            _attr("channels", "chlist", chans),
            _attr("compression", "compression",
                  struct.pack("<B", self._comp)),
            _attr("dataWindow", "box2i", box),
            _attr("displayWindow", "box2i", box),
            _attr("lineOrder", "lineOrder", struct.pack("<B", 0)),
            _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            _attr("screenWindowCenter", "v2f",
                  struct.pack("<2f", 0.0, 0.0)),
            _attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\0",
        ])
        self.lpb = _LINES_PER_BLOCK[self._comp]
        self._n_blocks = (height + self.lpb - 1) // self.lpb
        self._offsets = []
        self._next_y = 0
        self._f = open(path, "wb")
        self._f.write(struct.pack("<ii", _MAGIC, 2))
        self._f.write(header)
        self._table_pos = self._f.tell()
        self._f.write(b"\0" * (8 * self._n_blocks))

    def write_band(self, y0: int, band: np.ndarray) -> None:
        """Append rows [y0, y0 + band.shape[0]). y0 must equal the next
        unwritten row and be a multiple of the compression block size;
        the band height must be a multiple too (except the final band)."""
        band = np.asarray(band, np.float32)
        if band.ndim == 2:
            band = band[..., None]
        ny, w, c = band.shape
        if (y0, w, c) != (self._next_y, self.w, self.c):
            raise ValueError("bands must arrive contiguous in y with the "
                             "declared width/channels")
        if y0 % self.lpb != 0:
            raise ValueError(f"band start must align to {self.lpb} rows")
        if ny % self.lpb != 0 and y0 + ny != self.h:
            raise ValueError(f"band height must be a multiple of "
                             f"{self.lpb} (except the last)")
        pix = band.astype(self._dtype)
        for b0 in range(0, ny, self.lpb):
            nb = min(self.lpb, ny - b0)
            rows = []
            for y in range(b0, b0 + nb):
                for i in self._order:
                    rows.append(pix[y, :, i].tobytes())
            raw = b"".join(rows)
            if self._comp == _COMP_NONE:
                data = raw
            else:
                z = _zip_compress(raw)
                data = z if len(z) < len(raw) else raw
            self._offsets.append(self._f.tell())
            self._f.write(struct.pack("<ii", y0 + b0, len(data)))
            self._f.write(data)
        self._next_y = y0 + ny

    def close(self) -> None:
        if self._next_y != self.h:
            raise ValueError(f"only {self._next_y}/{self.h} rows written")
        self._f.seek(self._table_pos)
        self._f.write(struct.pack(f"<{self._n_blocks}Q", *self._offsets))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.close()
        else:
            self._f.close()
        return False


def write_exr(path: str, img: np.ndarray, *, half: bool = True,
              compression: str = "zip") -> None:
    """Write [H, W] or [H, W, C] float data as scanline EXR.

    C=1 writes channel "Y"; C=3 writes R,G,B; C=4 writes R,G,B,A.
    half: store as float16 (the reference hdrfilm default); else float32.
    compression: "none" | "zips" | "zip".
    """
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    with ExrScanlineWriter(path, h, w, c, half=half,
                           compression=compression) as out:
        out.write_band(0, img)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _read_cstr(buf: bytes, pos: int):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin1"), end + 1


def read_exr(path: str) -> np.ndarray:
    """Read a single-part scanline EXR → float32 [H, W, C].

    Channels are returned in R,G,B(,A) order when present, otherwise in
    file (alphabetical) order.
    """
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200 or version & 0x800 or version & 0x1000:
        raise ValueError("tiled/deep/multipart EXR not supported")

    pos = 8
    channels = []   # (name, pixel_type)
    comp = None
    dw = None
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_cstr(buf, pos)
        typ, pos = _read_cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        data = buf[pos:pos + size]
        pos += size
        if name == "channels":
            p = 0
            while data[p] != 0:
                cname, p = _read_cstr(data, p)
                ptype, = struct.unpack_from("<i", data, p)
                xs, ys = struct.unpack_from("<ii", data, p + 8)
                if xs != 1 or ys != 1:
                    raise ValueError("subsampled channels not supported")
                p += 16
                channels.append((cname, ptype))
        elif name == "compression":
            comp = data[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", data)
    if comp not in _LINES_PER_BLOCK:
        raise ValueError(f"unsupported EXR compression {comp}")
    x0, y0, x1, y1 = dw
    w, h = x1 - x0 + 1, y1 - y0 + 1

    dts = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}
    sizes = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}
    row_bytes = sum(w * sizes[pt] for _, pt in channels)

    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = (h + lpb - 1) // lpb
    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)

    out = {cname: np.zeros((h, w), np.float32) for cname, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8:off + 8 + size]
        ny = min(lpb, y1 - y + 1)
        raw_size = row_bytes * ny
        raw = data if (comp == _COMP_NONE or size == raw_size) \
            else _zip_decompress(data, raw_size)
        p = 0
        for dy in range(ny):
            for cname, pt in channels:
                nbytes = w * sizes[pt]
                vals = np.frombuffer(raw[p:p + nbytes], dts[pt])
                out[cname][y - y0 + dy] = vals.astype(np.float32)
                p += nbytes
    have = [c for c, _ in channels]
    if all(c in have for c in ("R", "G", "B")):
        names = ["R", "G", "B"] + (["A"] if "A" in have else [])
    else:
        names = have
    return np.stack([out[c] for c in names], axis=-1)
