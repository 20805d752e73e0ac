"""The light tracers through `python -m hairpt_torch.cli render` on the CPU:
each of ptracer, bdpt, vpl, ppm, photonmapper and sppm renders the lit
stand-in (scene_xmls.lit at 16^2, hair quality 0.01, depth 3) finite,
its image equal to the in-process render of load_scene's scene, and the
fog stand-in's photonmapper its volumetric photon map; an XML's
<integrator type=...> (with and without a scene medium) reaches the same
render function as in hairpt's CLI (both CLIs run with their loaders and
renders replaced by records); both loaders read the fog stand-in's
integrator type and medium alike.

Both scene builds order the hair with the port's build of
csrc/bvh_builder.cpp (see tests/test_torch_xml.py)."""
import types

import jax
import numpy as np
import pytest
import torch

import hairpt.cli as jcli
from hairpt.integrators import bdpt as jbdpt
from hairpt.integrators import path as jpath
from hairpt.integrators import photonmap as jpm
from hairpt.integrators import ptracer as jpt
from hairpt.integrators import volpath as jvp
from hairpt.integrators import vpl as jvpl
from hairpt.ops import bvh as jbvh
from hairpt.scene import xml_loader as jxl
from hairpt_torch import cli
from hairpt_torch.integrators import bdpt as tbdpt
from hairpt_torch.integrators import path as tpath
from hairpt_torch.integrators import photonmap as tpm
from hairpt_torch.integrators import ptracer as tpt
from hairpt_torch.integrators import volpath as tvp
from hairpt_torch.integrators import vpl as tvpl
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from torch_threads import one_thread  # noqa: F401

SMALL = ["--spp", "1", "--res-scale", "0.015625", "--hair-quality", "0.01",
         "--depth", "3"]
LOAD = dict(spp_override=1, res_scale=0.015625, hair_quality=0.01,
            max_depth_override=3)


@pytest.fixture(scope="module")
def lit(tmp_path_factory):
    root = tmp_path_factory.mktemp("lit")
    return str(root), scene_xmls.write_scene(str(root), "lit")


RENDER = {
    "ptracer": lambda s: tpt.render_ptracer(s),
    "bdpt": lambda s: tbdpt.render_bdpt(s, spp=s.config.spp),
    "vpl": lambda s: tvpl.render_vpl(s, spp=s.config.spp),
    "ppm": lambda s: tpm.render_ppm(s),
    "photonmapper": lambda s: tpm.render_ppm(s),
    "sppm": lambda s: tpm.render_sppm(s),
}


@pytest.mark.parametrize("integ", list(RENDER))
def test_cli_light_tracer_equals_in_process_render(lit, integ):
    root, xml = lit
    out = f"{root}/{integ}.png"
    assert cli.main(["render", xml, "-o", out, "--cpu", "--integrator",
                     integ] + SMALL) == 0
    img = np.load(f"{root}/{integ}.npy")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0
    s = txl.load_scene(xml, device="cpu", **LOAD)
    np.testing.assert_array_equal(img, RENDER[integ](s).numpy())


def test_cli_fog_renders_its_volumetric_photon_map(tmp_path):
    xml = scene_xmls.write_scene(str(tmp_path), "fog")
    out = str(tmp_path / "fog.png")
    assert cli.main(["render", xml, "-o", out, "--cpu"] + SMALL) == 0
    img = np.load(str(tmp_path / "fog.npy"))
    s = txl.load_scene(xml, device="cpu", **LOAD)
    assert s.config.integrator == "photonmapper" and s.medium is not None
    assert np.isfinite(img).all() and img.mean() > 0
    np.testing.assert_array_equal(
        img, tpm.render_volumetric_photonmap(s).numpy())


def test_loaders_agree_on_the_fog_xml(tmp_path, monkeypatch):
    monkeypatch.setattr(jbvh, "_NATIVE", tbvh._load_native())
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)
    xml = scene_xmls.write_scene(str(tmp_path), "fog", res=16)
    load = dict(hair_quality=0.01, spp_override=1)
    js = jxl.load_scene(xml, **load)
    ts = txl.load_scene(xml, device="cpu", **load)
    assert js.config.integrator == ts.config.integrator == "photonmapper"
    for f in ("sigma_t", "albedo", "g", "fog_depth"):
        np.testing.assert_array_equal(getattr(ts.medium, f).numpy(),
                                      np.asarray(getattr(js.medium, f)))
    assert ts.medium.phase_kind == js.medium.phase_kind
    np.testing.assert_array_equal(ts.arrays.delta.position.numpy(),
                                  np.asarray(js.arrays.delta.position))


# the render functions each CLI may reach, by module and name
JAX_FNS = [(jpath, "render"), (jvp, "render_volpath"),
           (jpt, "render_ptracer"), (jbdpt, "render_bdpt"),
           (jvpl, "render_vpl"), (jpm, "render_ppm"), (jpm, "render_sppm"),
           (jpm, "render_volumetric_photonmap")]
PORT_FNS = [(tpath, "render"), (tvp, "render_volpath"),
            (tpt, "render_ptracer"), (tbdpt, "render_bdpt"),
            (tvpl, "render_vpl"), (tpm, "render_ppm"), (tpm, "render_sppm"),
            (tpm, "render_volumetric_photonmap")]
TYPES = ["path", "volpath", "volpath_simple", "ptracer", "bdpt", "vpl",
         "photonmapper", "ppm", "sppm"]


def _fake_scene(integ, medium):
    cfg = types.SimpleNamespace(width=4, height=4, spp=1, max_depth=3,
                                integrator=integ, tiled_film=False)
    film = types.SimpleNamespace(gamma=2.2, annotations=(), banner=False)
    return types.SimpleNamespace(config=cfg, medium=medium, active_kinds=(),
                                 film=film)


def _record(monkeypatch, fns, seen, zeros):
    for mod, name in fns:
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: (
            seen.append(_n), zeros())[1])


@pytest.mark.parametrize("medium", [False, True], ids=["", "medium"])
@pytest.mark.parametrize("integ", TYPES)
def test_xml_integrator_routes_as_jax(tmp_path, monkeypatch, integ, medium):
    xml = tmp_path / "scene.xml"
    xml.write_text(f"<scene version=\"0.5.0\"><integrator type=\"{integ}\""
                   f"/></scene>")
    med = object() if medium else None
    seen_j, seen_t = [], []
    _record(monkeypatch, JAX_FNS, seen_j, lambda: np.zeros((4, 4, 3),
                                                           np.float32))
    _record(monkeypatch, PORT_FNS, seen_t, lambda: torch.zeros(4, 4, 3))
    monkeypatch.setattr(jxl, "load_scene",
                        lambda *a, **k: _fake_scene(integ, med))
    monkeypatch.setattr(txl, "load_scene",
                        lambda *a, **k: _fake_scene(integ, med))
    # hairpt's CLI points the JAX compilation cache at the repository
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    jcli.main(["render", str(xml), "-o", str(tmp_path / "j.png"), "--cpu"])
    assert cli.main(["render", str(xml), "-o", str(tmp_path / "t.png"),
                     "--cpu"]) == 0
    assert len(seen_j) == 1 and seen_t == seen_j
