"""The out-of-core banded render (hairpt_torch/film/tiled.py) on the CPU:
the teapot stand-in at 48 x 40 (a Gaussian filter, radius 2, so each
band renders a 2-row apron on either side; depth 3, 2 spp) rendered in
bands of 16 rows by hairpt's render_tiled_exr (its CPU default, the
packed BVH walk: one JAX compile of the band wave) and by the port's;
the two EXRs decode within half precision's rounding of each other where
the two float renders agree, and the port's EXR within half rounding of
its own monolithic path.render, pixel for pixel. The stats the banded
render records count its band waves' lanes and rays."""
import numpy as np

from hairpt.film import tiled as jtiled
from hairpt.scene import xml_loader as jxl
from hairpt.utils import exr as jexr
from hairpt_torch.film import tiled as ttiled
from hairpt_torch.integrators import path as tpath
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.utils import exr as texr
from hairpt_torch.utils import stats as tstats
from torch_threads import one_thread  # noqa: F401

W, H, BAND = 48, 40, 16
# half precision: 11 significant bits, round to nearest; 2^-24 the
# smallest subnormal step
HALF_RTOL = 2.0 ** -11
HALF_ATOL = 2.0 ** -24


def _xml(tmp_path):
    path = scene_xmls.write_scene(str(tmp_path), "teapot", width=W,
                                  height=H, depth=3, spp=2)
    text = open(path).read()
    assert text.count("<rfilter type=\"tent\"/>") == 1
    with open(path, "w") as fh:
        fh.write(text.replace("<rfilter type=\"tent\"/>",
                              "<rfilter type=\"gaussian\"/>"))
    return path


def test_banded_exr_matches_hairpt_and_the_monolithic_render(tmp_path):
    path = _xml(tmp_path)
    js = jxl.load_scene(path)
    ts = txl.load_scene(path, device="cpu")
    assert ts.film.filter_radius == 2.0
    j_exr, t_exr = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    jtiled.render_tiled_exr(js, j_exr, band_rows=BAND)
    tstats.reset()
    ttiled.render_tiled_exr(ts, t_exr, band_rows=BAND)
    # the counters: 3 bands x 2 samples of (16 + 2 x 2) x 48 lanes
    reg = {n: c.value for n, c in tstats._registry["Path tracer"].items()}
    assert reg["Sample waves"] == 6
    assert reg["Camera samples"] == 6 * (BAND + 4) * W
    assert reg["Rays traced"] >= reg["Camera samples"]
    got = texr.read_exr(t_exr)[..., :3].astype(np.float64)
    want = jexr.read_exr(j_exr)[..., :3].astype(np.float64)
    assert got.shape == want.shape == (H, W, 3) and want.mean() > 0
    mono = tpath.render(ts).numpy().astype(np.float64)
    # the port's bands against its own monolithic render: every value
    # within half rounding (the splats' float sums in another order)
    assert (np.abs(got - mono) <= HALF_RTOL * 1.01 * np.abs(mono)
            + HALF_ATOL).all(), np.abs(got - mono).max()
    # against hairpt's bands: half rounding on top of the two float
    # renders' agreement (1e-3 relative, compare()'s rule) on >= 97% of
    # the values, and the means within 2e-3
    close = np.abs(got - want) <= (1e-3 + HALF_RTOL) * np.abs(want) + 1e-4
    assert close.mean() >= 0.97, close.mean()
    assert abs(got.mean() - want.mean()) / want.mean() < 2e-3
