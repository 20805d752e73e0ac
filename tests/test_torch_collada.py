"""COLLADA import (hairpt_torch/scene/collada.py and the CLI's import
command) against hairpt's on the CPU, on tests/test_collada.py's
document (a polylist quad under a node stack, Z_UP at centimetres, a
lambert material) and on scene_xmls.write_dae's (a cube with normals and
texture coordinates, a floor quad, two materials, a camera by lookat):
the imported meshes, materials and cameras equal; the OBJ files and the
scene XML that convert writes equal; and the port's loader renders the
port's XML (a sensor and a constant emitter grafted in, as
tests/test_collada.py does) equal to hairpt's XML."""
import os

import numpy as np
import pytest

from hairpt.scene import collada as jcol
from hairpt_torch import cli as tcli
from hairpt_torch.integrators import path as tpath
from hairpt_torch.scene import collada as tcol
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from test_collada import DAE
from torch_threads import one_thread  # noqa: F401


def _docs(d):
    quad = os.path.join(str(d), "quad.dae")
    with open(quad, "w") as fh:
        fh.write(DAE)
    return {"quad": quad,
            "props": scene_xmls.write_dae(os.path.join(str(d), "props.dae"))}


@pytest.mark.parametrize("doc", ["quad", "props"])
def test_load_collada_matches_hairpt(tmp_path, doc):
    path = _docs(tmp_path)[doc]
    mj, cj = jcol.load_collada(path)
    mt, ct = tcol.load_collada(path)
    assert len(mt) == len(mj) and len(ct) == len(cj)
    assert len(mt) == (1 if doc == "quad" else 2)
    for a, b in zip(mt, mj):
        assert (a.name, a.diffuse, a.material) == (b.name, b.diffuse,
                                                   b.material)
        for f in ("positions", "normals", "uvs", "faces"):
            x, y = getattr(a.mesh, f), getattr(b.mesh, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=f)
    for a, b in zip(ct, cj):
        assert (a.name, a.fov_deg, a.aspect) == (b.name, b.fov_deg, b.aspect)
        np.testing.assert_array_equal(a.to_world, b.to_world)
    if doc == "props":
        assert len(ct) == 1 and mt[0].mesh.uvs is not None


SENSOR = ('<sensor type="perspective"><float name="fov" value="60"/>'
          '<transform name="toWorld"><lookat origin="{o}" target="{t}" '
          'up="{u}"/></transform><sampler type="independent">'
          '<integer name="sampleCount" value="2"/></sampler>'
          '<film type="hdrfilm"><integer name="width" value="16"/>'
          '<integer name="height" value="16"/><rfilter type="box"/></film>'
          '</sensor><emitter type="constant"/>')


@pytest.mark.parametrize("doc", ["quad", "props"])
def test_convert_matches_hairpt_and_renders(tmp_path, doc):
    """hairpt's convert and the port's import command write the same OBJ
    files and XML; the port renders both XMLs (a sensor looking at the
    props and a constant emitter grafted in) to the same image."""
    path = _docs(tmp_path)[doc]
    dj, dt = tmp_path / "j", tmp_path / "t"
    xj = jcol.convert(path, str(dj / "scene.xml"))
    assert tcli.main(["import", path, str(dt / "scene.xml")]) == 0
    files = sorted(os.listdir(dj))
    assert files == sorted(os.listdir(dt)) and len(files) >= 2
    for f in files:
        assert (dj / f).read_text() == (dt / f).read_text(), f
    eye = ("1.01, 0.05, -0.01", "1.01, 0, -0.01", "0, 0, 1") \
        if doc == "quad" else ("6, 6, 9", "0, 1, 0", "0, 1, 0")
    imgs = []
    for xml in (xj, str(dt / "scene.xml")):
        text = open(xml).read()
        # the props document's own camera is replaced, as it looks away
        # (ROADMAP Queue C); the quad has none
        text = text.split("<sensor")[0] + text[text.find("</sensor>") + 9:] \
            if "<sensor" in text else text
        with open(xml, "w") as fh:
            fh.write(text.replace("</scene>", SENSOR.format(o=eye[0],
                                                            t=eye[1],
                                                            u=eye[2])
                                  + "</scene>"))
        s = txl.load_scene(xml, device="cpu", max_depth_override=3)
        imgs.append(tpath.render(s).numpy())
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert np.isfinite(imgs[1]).all() and imgs[1].mean() > 0
    # the props' red cube is in view: red dominates somewhere
    assert (imgs[1][..., 0] > imgs[1][..., 2] + 0.05).any()
