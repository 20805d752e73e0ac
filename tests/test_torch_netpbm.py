"""The port's Netpbm reader and PPM writer (hairpt_torch/utils/netpbm.py)
against hairpt's _read_texture_image (PIL's Image.open(...).convert("RGB")
/ 255) and PIL's save, on the CPU: P1-P6, plain and raw, with comments
in the header and the raster, maxval from 1 to 65,535 (16-bit gray
clipped to 255, 16-bit colour scaled by 255 / 65,535 and rounded). The
tolerance is none."""
import io

import numpy as np
import pytest
from PIL import Image

from hairpt.scene.xml_loader import _read_texture_image as jread
from hairpt_torch.utils import io as tio
from torch_threads import one_thread  # noqa: F401

H, W = 7, 10
RNG = np.random.default_rng(5)


def _same(path):
    want = jread(str(path), "", gamma=1.0)
    assert want is not None, "PIL cannot read the file"
    got = tio.read_image(str(path), device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _file(kind, maxval, comments):
    """A P<kind> file of random samples at maxval."""
    bands = 3 if kind in (3, 6) else 1
    top = 1 if kind in (1, 4) else maxval
    v = RNG.integers(0, top + 1, (H, W, bands))
    if kind in (2, 5) and maxval == 65535:
        v[0, 0] = 55745
    c = b"# a comment\n" if comments else b""
    head = b"P%d\n" % kind + c + b"%d %d\n" % (W, H) + c
    if kind not in (1, 4):
        head += b"%d\n" % maxval
    if kind == 1:
        body = b"\n".join(b"".join(b"%d" % x for x in row) + (
            b" # row\n" if comments else b"") for row in v[..., 0])
    elif kind in (2, 3):
        body = b"\n".join(b" ".join(b"%d" % x for x in row.reshape(-1))
                          + (b" # row" if comments else b"") for row in v)
    elif kind == 4:
        body = np.packbits(v[..., 0].astype(np.uint8), axis=1).tobytes()
    else:
        dt = ">u2" if maxval > 255 else np.uint8
        body = v.astype(dt).tobytes()
    return head + body + b"\n"


CASES = [(k, m, c) for k in (1, 4) for m in (1,) for c in (False, True)] + [
    (k, m, c) for k in (2, 3, 5, 6)
    for m in (1, 7, 100, 255, 256, 1000, 4095, 65535)
    for c in (False, True) if not (c and m not in (255, 1000))]


@pytest.mark.parametrize("kind,maxval,comments", CASES,
                         ids=lambda v: str(v))
def test_netpbm_reader(tmp_path, kind, maxval, comments):
    p = tmp_path / ("x." + {1: "pbm", 4: "pbm", 2: "pgm", 5: "pgm"}.get(
        kind, "ppm"))
    p.write_bytes(_file(kind, maxval, comments))
    _same(p)


@pytest.mark.parametrize("mode", ["RGB", "L", "1", "I;16"])
def test_pil_writes(tmp_path, mode):
    p = tmp_path / "x.ppm"
    a = RNG.integers(0, 256, (H, W, 3), dtype=np.uint8)
    im = Image.fromarray(a).convert(mode) if mode != "I;16" else \
        Image.fromarray(RNG.integers(0, 3000, (H, W)).astype(np.uint16))
    im.save(p)
    _same(p)


@pytest.mark.parametrize("case", ["truncated_raw", "bad_token",
                                  "sample_past_maxval", "maxval_0"])
def test_what_pil_fails_on_is_a_value_error(tmp_path, case):
    p = tmp_path / "x.ppm"
    data = {"truncated_raw": _file(6, 255, False)[:40],
            "bad_token": b"P3\n2 2\n255\n1 2 x 4 5 6 7 8 9 1 2 3\n",
            "sample_past_maxval": b"P2\n2 1\n10\n3 11\n",
            "maxval_0": b"P5\n2 1\n0\n\x00\x00"}[case]
    p.write_bytes(data)
    assert jread(str(p), "", gamma=1.0) is None
    with pytest.raises(ValueError):
        tio.read_image(str(p), device="cpu")


def test_pil_extensions_raise_naming_the_item(tmp_path):
    """PIL's own Netpbm extensions (here a grayscale float Pf) are not
    ported: NotImplementedError naming ROADMAP item 13."""
    p = tmp_path / "x.ppm"
    Image.fromarray(RNG.uniform(0, 1, (H, W)).astype(np.float32)).save(
        p, "PPM")
    assert p.read_bytes()[:2] == b"Pf"
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        tio.probe_image(str(p))


@pytest.mark.parametrize("ext", ["ppm", "pgm", "pbm", "pnm"])
@pytest.mark.parametrize("size", [(1, 1), (7, 10), (64, 33)])
def test_write_ppm_is_pils_bytes(tmp_path, ext, size):
    """write_ppm of a float image and of its uint8 pixels: PIL's save of
    the same RGB pixels (P6 under every Netpbm extension), byte for
    byte."""
    a = RNG.integers(0, 256, size + (3,), dtype=np.uint8)
    ref = io.BytesIO()
    Image.fromarray(a).save(ref, "PPM")
    p = tmp_path / f"x.{ext}"
    tio.write_ppm(str(p), a.astype(np.float32) / 255.0)
    assert p.read_bytes() == ref.getvalue()
    tio.write_ppm(str(p), a)
    assert p.read_bytes() == ref.getvalue()
    np.testing.assert_array_equal(tio.read_ldr(str(p)), a)
