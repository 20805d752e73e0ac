"""The statistics table, the resampler and the util command on the CPU
against hairpt: format_stats's text for the same counters of every kind;
resample_matrix and resample for the six filters and the four boundary
modes, up and down and with clamp="auto", within 1e-5; and
`python -m hairpt_torch.cli util` (tonemap, addimages, joinrgb,
resample, with --cpu) against hairpt's CLI on the same inputs (.npy,
.pfm and .exr made from a numpy seed), the PNG outputs decoded through
the port's read_png and equal pixel for pixel."""

import numpy as np
import pytest
import torch

import hairpt.cli as jcli
from hairpt.utils import resample as jrs
from hairpt.utils import stats as jstats
from hairpt_torch import cli as tcli
from hairpt_torch.film.rfilter import FILTERS
from hairpt_torch.utils import exr as texr
from hairpt_torch.utils import io as tio
from hairpt_torch.utils import resample as trs
from hairpt_torch.utils import stats as tstats
from torch_threads import one_thread  # noqa: F401


def _record(mod):
    mod.reset()
    mod.record("Path tracer", "Rays traced", 123456789)
    mod.record("Path tracer", "Rays traced", 1)
    mod.record("Path tracer", "Camera samples", 2.5)
    mod.record("Path tracer", "Rays per camera sample", 77.0, 20.0,
               kind="average")
    mod.record("Intersection", "Hits", 3, 4, kind="percentage")
    mod.record("Intersection", "Hits", 5, 12, kind="percentage")
    for name, v in (("small", 512), ("kib", 5000), ("mib", 7.5e6),
                    ("gib", 3.3e12)):
        mod.record("Memory", name, v, kind="memory")
    mod.record("Memory", "rate", 1e9, 3.0, kind="rate")
    return mod.format_stats()


def test_format_stats_matches_hairpt():
    jstats.reset()
    tstats.reset()
    assert tstats.format_stats() == jstats.format_stats()
    assert _record(tstats) == _record(jstats)
    jstats.reset()
    tstats.reset()


CASES = [(f, b) for f in sorted(FILTERS) for b in trs.BOUNDARIES]


@pytest.mark.parametrize("filt,boundary", CASES,
                         ids=[f"{f}-{b}" for f, b in CASES])
def test_resample_matches_hairpt(filt, boundary):
    """Both axes' weight matrices, up (13 to 29) and down (29 to 13), and
    the resampled image of each, within 1e-5; clamp="auto" too."""
    for src, dst in ((13, 29), (29, 13)):
        np.testing.assert_allclose(
            trs.resample_matrix(filt, src, dst, boundary),
            jrs.resample_matrix(filt, src, dst, boundary), rtol=0,
            atol=1e-5)
    rs = np.random.RandomState(len(filt) * 7 + len(boundary))
    img = rs.uniform(-0.5, 3.0, (13, 17, 3)).astype(np.float32)
    for w, h, clamp in ((29, 23, None), (7, 5, None), (29, 23, "auto")):
        want = np.asarray(jrs.resample(img, w, h, filt, boundary, clamp))
        got = trs.resample(img, w, h, filt, boundary, clamp, device="cpu")
        assert got.shape == (h, w, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_resample_gray_and_range_clamp():
    img = np.random.RandomState(1).uniform(0, 1, (16, 24)) \
        .astype(np.float32)
    want = np.asarray(jrs.resample(img, 9, 11, "mitchell", "mirror",
                                   (0.2, 0.8)))
    got = trs.resample(torch.as_tensor(img), 9, 11, "mitchell", "mirror",
                       (0.2, 0.8))
    assert got.shape == (11, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="boundary"):
        trs.resample_matrix("box", 4, 2, "reflect")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("util")
    rs = np.random.RandomState(3)
    a = rs.uniform(0, 1.5, (20, 28, 3)).astype(np.float32)
    b = rs.uniform(0, 1.0, (20, 28, 3)).astype(np.float32)
    c = rs.uniform(0, 2.0, (20, 28)).astype(np.float32)
    np.save(d / "a.npy", a)
    tio.write_pfm(str(d / "b.pfm"), b)
    texr.write_exr(str(d / "c.exr"), np.stack([c, c, c], -1), half=False)
    return d


TOOLS = {
    "tonemap": (["a.npy", "--gamma", "2.4"], "png"),
    "addimages": (["a.npy", "b.pfm", "c.exr", "--weights", "0.5,2,-1"],
                  "npy"),
    "joinrgb": (["c.exr", "b.pfm", "a.npy"], "pfm"),
    "resample": (["a.npy", "--size", "40x13", "--filter", "catmullrom",
                  "--boundary", "wrap", "--clamp"], "exr"),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_util_command_matches_hairpt(inputs, tool):
    """The port's util command (--cpu) against hairpt's on the same
    inputs: an 8-bit output equal pixel for pixel (both decoded by the
    port's read_png), a float one within 1e-5."""
    args, ext = TOOLS[tool]
    argv = [tool] + [str(inputs / a) if "." in a and not a[0].isdigit()
                     and "," not in a else a for a in args]
    out_j, out_t = str(inputs / f"{tool}_j.{ext}"), \
        str(inputs / f"{tool}_t.{ext}")
    assert jcli.main(["util"] + argv + ["-o", out_j]) == 0
    assert tcli.main(["util"] + argv + ["-o", out_t, "--cpu"]) == 0
    if ext == "png":
        got, want = tio.read_png(out_t), tio.read_png(out_j)
        assert got.dtype == np.uint8 and got.shape == (20, 28, 3)
        np.testing.assert_array_equal(got, want)
        return
    read = {"npy": np.load, "pfm": tio.read_pfm,
            "exr": lambda p: texr.read_exr(p)[..., :3]}[ext]
    got, want = read(out_t), read(out_j)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if tool == "resample":
        assert got.shape == (13, 40, 3)


def test_util_refuses_jpeg_and_unknown_inputs(inputs):
    """A .jpg output, which an earlier slice refused here, is written as
    hairpt's util writes it (PIL at its default quality, 75): the same
    quantization tables and sampling, PIL's decodes within 2 levels and
    equal on 99% of the values. An input other than .npy, .pfm, .hdr and
    .exr still raises, as in hairpt."""
    from PIL import Image, JpegImagePlugin
    out_t, out_j = str(inputs / "t.jpg"), str(inputs / "t_j.jpg")
    assert tcli.main(["util", "tonemap", str(inputs / "a.npy"), "-o",
                      out_t, "--cpu"]) == 0
    assert jcli.main(["util", "tonemap", str(inputs / "a.npy"), "-o",
                      out_j]) == 0
    im_t, im_j = Image.open(out_t), Image.open(out_j)
    assert im_t.quantization == im_j.quantization
    assert JpegImagePlugin.get_sampling(im_t) \
        == JpegImagePlugin.get_sampling(im_j)
    d = np.abs(np.asarray(im_t.convert("RGB"), int)
               - np.asarray(im_j.convert("RGB"), int))
    assert d.max() <= 2 and (d == 0).mean() >= 0.99
    png = str(inputs / "x.png")
    tio.write_png(png, np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="unsupported input"):
        tcli.main(["util", "tonemap", png, "-o", str(inputs / "y.png"),
                   "--cpu"])
