"""Write the image fixtures of chip_smoke.py phase 23 and
tests/test_torch_tiff.py::test_fixtures_decode_as_pil: one small file for
each branch of the port's readers (Netpbm, TIFF, GIF, the JPEG variants,
WebP, 1-bit TGA), and expected.npz, the uint8 RGB array PIL's
Image.open(file).convert("RGB") gives for each. The machine with the card
has no PIL, so its checks read the committed arrays. The textures of a
size users have (LARGE: a 1024 x 512 lossy WebP envmap) are recorded in
large.json by the shape and SHA-256 of that array instead, the array
being too large to commit. The files PIL
cannot write are built with the tests' writers (tests/torch_jpeg_enc.py,
test_torch_tiff._tiff, test_torch_gif._gif, test_torch_webp._refilter).
Five of them are phase 23a's scene textures (TEXTURES).

    python tests/torch_images/make_fixtures.py
"""
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

# phase 23a's floor: bitmap, normal map, backdrop bitmap, heightfield,
# envmap
TEXTURES = {"bitmap": "lzw_pred2.tif", "normal": "normal_lossless.webp",
            "backdrop": "backdrop.gif", "height": "height_arith.jpg",
            "envmap": "env_lossy.webp"}
# of a size users have; 23a's envmap at full width (23c keeps TEXTURES)
LARGE = ("env_1k.webp",)


def _smooth(h, w, seed, channels=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    f = [rng.uniform(3, 9, 2) for _ in range(channels)]
    a = np.stack([128 + 80 * np.sin(x / fx + y / fy) for fx, fy in f], -1)
    a += rng.normal(0, 4, a.shape)
    return np.clip(a, 0, 255).astype(np.uint8)


def _sky(h, w, seed):
    """An LDR sky envmap, latitude-longitude: a graded sky with soft
    clouds and a sun over a darker ground, a little sensor noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    t = y / h
    sky = np.stack([0.35 + 0.5 * t, 0.55 + 0.35 * t, 0.95 - 0.2 * t], -1)
    for _ in range(12):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h * 0.5)
        r = rng.uniform(20, 90)
        sky += 0.35 * np.exp(-((x - cx) ** 2 + 4 * (y - cy) ** 2)
                             / r ** 2)[..., None]
    sky += 0.6 * np.exp(-((x - 0.7 * w) ** 2 + (y - 0.2 * h) ** 2)
                        / 64.0)[..., None]
    ground = np.stack([0.35 + 0.05 * np.sin(x / 17),
                       0.3 + 0.05 * np.sin(y / 9), 0.22 + 0 * x], -1)
    sky = np.where((t > 0.55)[..., None], ground, sky)
    a = sky * 255 + rng.normal(0, 1.5, sky.shape)
    return np.clip(a, 0, 255).astype(np.uint8)


def _netpbm(out):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (9, 13))
    out["p1.pbm"] = b"P1\n# plain\n13 9\n" + b"\n".join(
        b" ".join(b"%d" % v for v in r) for r in bits) + b"\n"
    out["p4.pbm"] = b"P4\n13 9\n" + np.packbits(
        bits.astype(np.uint8), axis=1).tobytes()
    g = rng.integers(0, 1001, (11, 14))
    out["p2_1000.pgm"] = b"P2\n14 11\n1000\n" + b"\n".join(
        b" ".join(b"%d" % v for v in r) for r in g) + b"\n"
    g16 = rng.integers(0, 65536, (11, 14))
    out["p5_65535.pgm"] = b"P5\n14 11\n65535\n" + g16.astype(">u2").tobytes()
    c = rng.integers(0, 4096, (10, 12, 3))
    out["p6_4095.ppm"] = b"P6\n12 10\n4095\n" + c.astype(">u2").tobytes()
    c8 = _smooth(10, 12, 2)
    out["p3.ppm"] = b"P3\n12 10\n255\n" + b"\n".join(
        b" ".join(b"%d" % v for v in r.reshape(-1)) for r in c8) + b"\n"


def _pil(im, fmt, **kw):
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def _tiffs(out, tmp):
    from test_torch_tiff import _tiff
    rng = np.random.default_rng(3)

    def built(name, s, photo, bps, **kw):
        p = os.path.join(tmp, name)
        _tiff(p, s, photo, bps, **kw)
        out[name] = open(p, "rb").read()
    out["rgb_raw.tif"] = _pil(Image.fromarray(_smooth(12, 17, 4)), "TIFF")
    built("lzw_pred2.tif", _smooth(96, 96, 5), 2, 8, comp=5, pred=2, rps=16)
    built("packbits_tiles_planar_mm.tif", _smooth(20, 37, 6), 2, 8,
          bo=">", comp=32773, planar=2, tile=(16, 16))
    built("float_pred3.tif", rng.uniform(-10, 300, (13, 19, 1))
          .astype(np.float32), 1, 32, sf=3, comp=32946, pred=3)
    built("gray16_adobe_deflate.tif", rng.integers(0, 600, (13, 19, 1))
          .astype(np.uint16), 0, 16, comp=8)
    built("palette4.tif", rng.integers(0, 16, (13, 19, 1)).astype(np.uint8),
          3, 4, cmap=rng.integers(0, 65536, 48).tolist())
    built("cmyk.tif", rng.integers(0, 256, (13, 19, 4)).astype(np.uint8), 5,
          8, comp=5)
    built("rgba_assoc.tif", rng.integers(0, 256, (13, 19, 4))
          .astype(np.uint8), 2, 8, extra=(1,), comp=32946)
    built("fill2_bilevel.tif", rng.integers(0, 2, (13, 19, 1))
          .astype(np.uint8), 0, 1, fill=2, comp=5)
    built("orient6.tif", _smooth(13, 19, 7), 2, 8, orient=6)
    out["jpeg_ycbcr.tif"] = _pil(Image.fromarray(_smooth(40, 33, 8)), "TIFF",
                                 compression="jpeg", quality=80)


def _gifs(out, tmp):
    from test_torch_gif import PAL, _gif
    a = _smooth(32, 64, 9)
    out["backdrop.gif"] = _pil(Image.fromarray(a).quantize(64), "GIF",
                               interlace=True)
    p = os.path.join(tmp, "g.gif")
    idx = np.random.default_rng(10).integers(0, 256, (11, 13))
    _gif(p, idx, screen=(20, 16), pos=(4, 3), gpal=PAL, lpal=PAL[::-1],
         trans=7)
    out["local_offset_trans.gif"] = open(p, "rb").read()


def _jpegs(out):
    from torch_jpeg_enc import (arith_jpeg, component_blocks, huffman_jpeg,
                                lossless_jpeg)
    rng = np.random.default_rng(11)
    s411 = [(4, 1), (1, 1), (1, 1)]
    b, q = component_blocks(rng, 37, 21, s411)
    out["s411.jpg"] = huffman_jpeg(37, 21, s411, b, q)
    cmyk = np.random.default_rng(12).integers(0, 256, (14, 18, 4),
                                              dtype=np.uint8)
    out["cmyk.jpg"] = _pil(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=90)
    s4 = [(2, 2), (1, 1), (1, 1), (2, 2)]
    b, q = component_blocks(rng, 29, 22, s4)
    out["ycck.jpg"] = huffman_jpeg(29, 22, s4, b, q, adobe=2)
    s420 = [(2, 2), (1, 1), (1, 1)]
    b, q = component_blocks(rng, 33, 27, s420)
    out["arith_seq.jpg"] = arith_jpeg(33, 27, s420, b, q)
    out["arith_prog_rst_dac.jpg"] = arith_jpeg(33, 27, s420, b, q,
                                               progressive=True, restart=2,
                                               dac=(1, 3, 2))
    b, q = component_blocks(rng, 65, 65, s420)
    out["height_arith.jpg"] = arith_jpeg(65, 65, s420, b, q)
    g = _smooth(17, 23, 13, 1)[..., 0]
    out["lossless_gray.jpg"] = lossless_jpeg([g], psv=7)
    c = _smooth(17, 23, 14)
    out["lossless_rgb.jpg"] = lossless_jpeg([c[..., k] for k in range(3)],
                                            psv=4, adobe=0)


def _webps(out):
    from test_torch_webp import _bitstream, _chunk, _refilter
    out["normal_lossless.webp"] = _pil(Image.fromarray(_smooth(64, 64, 15)),
                                       "WEBP", lossless=True)
    pal = np.random.default_rng(16).integers(0, 256, (5, 3), dtype=np.uint8)
    y, x = np.mgrid[0:19, 0:27]
    out["palette_lossless.webp"] = _pil(Image.fromarray(pal[(x // 4 + y // 3)
                                                            % 5]), "WEBP",
                                        lossless=True)
    out["env_lossy.webp"] = _pil(Image.fromarray(_smooth(64, 128, 17)),
                                 "WEBP", quality=70)
    out["env_1k.webp"] = _pil(Image.fromarray(_sky(512, 1024, 23)), "WEBP",
                              quality=80)
    rgba = np.dstack([_smooth(21, 30, 18), np.tile(
        np.arange(30, dtype=np.uint8) * 8, (21, 1))])
    out["lossy_alpha.webp"] = _pil(Image.fromarray(rgba, "RGBA"), "WEBP",
                                   quality=60)
    frames = [Image.fromarray(_smooth(18, 24, 19 + k)) for k in range(2)]
    b = io.BytesIO()
    frames[0].save(b, "WEBP", save_all=True, append_images=frames[1:])
    out["anim.webp"] = b.getvalue()
    tag, bits = _bitstream(_pil(Image.fromarray(_smooth(30, 45, 21)), "WEBP",
                                quality=40))
    body = b"WEBP" + _chunk(b"VP8 ", _refilter(bits, simple=1, sharpness=3))
    out["simple_filter.webp"] = b"RIFF" + struct.pack("<I", len(body)) + body


def main():
    import tempfile
    files = {}
    with tempfile.TemporaryDirectory() as tmp:
        _netpbm(files)
        _tiffs(files, tmp)
        _gifs(files, tmp)
        _jpegs(files)
        _webps(files)
        bits = np.random.default_rng(22).integers(0, 2, (9, 21)).astype(bool)
        files["bits1.tga"] = _pil(Image.fromarray(bits), "TGA")
        arrays, large = {}, {}
        for name, data in sorted(files.items()):
            p = os.path.join(HERE, name)
            with open(p, "wb") as f:
                f.write(data)
            a = np.asarray(Image.open(p).convert("RGB"))
            if name in LARGE:
                large[name] = {"shape": list(a.shape), "sha256":
                               hashlib.sha256(a.tobytes()).hexdigest()}
            else:
                arrays[name] = a
    np.savez_compressed(os.path.join(HERE, "expected.npz"), **arrays)
    with open(os.path.join(HERE, "large.json"), "w") as f:
        json.dump(large, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n))
                for n in os.listdir(HERE) if not n.endswith(".py"))
    print(f"{len(files)} fixtures, expected.npz and large.json, {total} "
          f"bytes")


if __name__ == "__main__":
    main()
