"""`python -m hairpt_torch.cli render` with the auxiliary,
irradiance-cache, Markov-chain and spectral integrators, on the CPU: the
lit stand-in XML (the furball's hair at quality 0.02, an area-lit panel
and sphere, a spot and a point light, the sunsky; 16^2, depth 3) through --integrator direct, ao, irrcache,
erpt, pssmlt, adaptive, multichannel and field:<name>, through an XML's
<integrator type=...>, and through --spectral / --dispersion. Each CLI
image must be finite and equal to the in-process render of load_scene's
scene with the arguments the CLI passes (hairpt/cli.py:203-282). The
Markov-chain integrators and the cache run at smaller sizes than their
defaults here (the tests bind them with functools.partial for both the
CLI and the reference): the defaults' 16,384 chains and 4,096 records
take minutes on one CPU thread; so do mlt's 16,384 chains, bound here
too. The motion integrator renders the stand-in's zero motion (it has
no animation: within 1e-3 px, the reprojection's rounding) and +inf
where nothing is hit."""
import functools

import numpy as np
import pytest

from hairpt_torch import cli
from hairpt_torch.integrators import aux_integrators as taux
from hairpt_torch.integrators import erpt as terpt
from hairpt_torch.integrators import irrcache as tic
from hairpt_torch.integrators import mlt as tmlt
from hairpt_torch.integrators import motion as tmotion
from hairpt_torch.integrators import pssmlt as tpss
from hairpt_torch.integrators import spectral as tspec
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from torch_threads import one_thread  # noqa: F401

RES = 16
SMALL = ["--spp", "2", "--hair-quality", "0.02", "--depth", "3"]
LOAD = dict(spp_override=2, hair_quality=0.02, max_depth_override=3)


@pytest.fixture(autouse=True)
def smaller(monkeypatch):
    """pssmlt, erpt and irrcache at test sizes, for the CLI and the
    reference alike."""
    for mod, name, kw in ((tpss, "render_pssmlt",
                           dict(n_chains=256, n_mutations=3)),
                          (terpt, "render_erpt",
                           dict(n_seeds=256, n_mutations=3)),
                          (tic, "render_irrcache",
                           dict(n_points=64, grid=(4, 8))),
                          (tmlt, "render_mlt",
                           dict(n_chains=256, n_mutations=5, n_boot=2))):
        monkeypatch.setattr(mod, name,
                            functools.partial(getattr(mod, name), **kw))


@pytest.fixture(scope="module")
def lit(tmp_path_factory):
    root = tmp_path_factory.mktemp("aux_cli")
    xml = scene_xmls.write_scene(str(root), "lit", res=RES)
    return root, xml, txl.load_scene(xml, device="cpu", **LOAD)


def _cli(root, xml, name, extra):
    out = root / f"{name.replace(':', '_')}.png"
    assert cli.main(["render", xml, "-o", str(out), "--cpu"] + SMALL
                    + extra) == 0
    img = np.load(out.with_suffix(".npy"))
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert np.abs(img).mean() > 0
    return out, img


# what the CLI calls for each name (hairpt/cli.py:203-282), seed 0
REFERENCE = {
    "direct": lambda s: taux.render_direct(s, seed=0),
    "ao": lambda s: taux.render_ao(s, spp=s.config.spp),
    "irrcache": lambda s: tic.render_irrcache(s, spp=s.config.spp, seed=0),
    "erpt": lambda s: terpt.render_erpt(s, seed=0),
    "pssmlt": lambda s: tpss.render_pssmlt(s, seed=0),
    "adaptive": lambda s: taux.render_adaptive(s, seed=0),
    "field:albedo": lambda s: taux.render_field(s, "albedo"),
    "field": lambda s: taux.render_field(s, "shNormal"),
}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_cli_integrator_equals_in_process_render(lit, name):
    root, xml, scene = lit
    _, img = _cli(root, xml, name, ["--integrator", name])
    np.testing.assert_array_equal(img, REFERENCE[name](scene).numpy())


def test_cli_multichannel_writes_its_channels(lit):
    root, xml, scene = lit
    out, img = _cli(root, xml, "multi", ["--integrator", "multichannel"])
    want = taux.render_multichannel(scene, spp=scene.config.spp, seed=0)
    np.testing.assert_array_equal(img, want["radiance"].numpy())
    for ch in ("shNormal", "distance", "albedo"):
        got = np.load(root / f"multi.{ch}.npy")
        np.testing.assert_array_equal(got, want[ch].numpy())
    assert np.load(root / "multi.distance.npy").max() > 10


@pytest.mark.parametrize("xml_type", ["direct", "ao", "field"])
def test_xml_integrator_routes_like_jax(tmp_path, xml_type):
    """<integrator type=...> picks the render without --integrator;
    direct's maxDepth is 2 unless --depth overrides it."""
    xml = scene_xmls.write_scene(str(tmp_path), "lit", res=RES,
                                 integrator=xml_type)
    s = txl.load_scene(xml, device="cpu", spp_override=2,
                       hair_quality=0.02)
    assert s.config.integrator == xml_type
    assert s.config.max_depth == (2 if xml_type == "direct" else 65)
    s3 = txl.load_scene(xml, device="cpu", **LOAD)
    assert s3.config.max_depth == 3
    _, img = _cli(tmp_path, xml, xml_type, [])
    np.testing.assert_array_equal(img, REFERENCE[xml_type](s3).numpy())


@pytest.mark.parametrize("extra", [["--spectral", "3"],
                                   ["--spectral", "6", "--dispersion",
                                    "0.0042"]],
                         ids=["spectral3", "spectral6_dispersion"])
def test_cli_spectral(lit, extra):
    root, xml, scene = lit
    _, img = _cli(root, xml, "_".join(extra), extra)
    cb = float(extra[3]) if len(extra) > 2 else 0.0
    want = tspec.render_spectral(scene, n_bins=int(extra[1]),
                                 spp=scene.config.spp, seed=0, cauchy_b=cb)
    np.testing.assert_array_equal(img, want.numpy())


@pytest.mark.parametrize("name", ["mlt", "motion"])
def test_mlt_and_motion_still_raise(tmp_path, lit, name):
    """They used to raise (ROADMAP item 13); now --integrator mlt and
    motion, and an XML of that integrator type, render: the CLI's image
    equals render_mlt's (seed 0) or render_motion's of the loaded
    scene."""
    root, xml, scene = lit
    ref = {"mlt": lambda s: tmlt.render_mlt(s, seed=0),
           "motion": lambda s: tmotion.render_motion(s)}[name]
    out = root / f"{name}.npy"
    assert cli.main(["render", xml, "-o", str(out.with_suffix(".png")),
                     "--cpu", "--integrator", name] + SMALL) == 0
    img = np.load(out)
    np.testing.assert_array_equal(img, ref(scene).numpy())
    x2 = scene_xmls.write_scene(str(tmp_path), "lit", res=RES,
                                integrator=name)
    s2 = txl.load_scene(x2, device="cpu", **LOAD)
    assert s2.config.integrator == name
    assert cli.main(["render", x2, "-o", str(tmp_path / "o.png"),
                     "--cpu"] + SMALL) == 0
    img2 = np.load(tmp_path / "o.npy")
    np.testing.assert_array_equal(img2, ref(s2).numpy())
    if name == "mlt":
        assert np.isfinite(img).all() and img.mean() > 0
    else:
        fin = np.isfinite(img)
        assert fin.any() and (np.abs(img[fin]) < 1e-3).all() \
            and (img[~fin] == np.inf).all()
