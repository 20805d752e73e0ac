"""The XML loader's LDR images in the port against hairpt's loader, on the
CPU: a JPEG normal map, a BMP bump map, a TGA heightfield and a JPEG
envmap (each of them refused by the port before this slice), loaded by
both packages; every tensor of the port's scene equals hairpt's scene
carried across with hairpt_torch.convert, bit for bit."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from hairpt.ops import bvh as jbvh
from hairpt.scene import xml_loader as jxl
from hairpt_torch import convert
from hairpt_torch.ops import bvh as tbvh
from hairpt_torch.scene import xml_loader as txl
from torch_threads import one_thread  # noqa: F401


@pytest.fixture
def same_bvh(monkeypatch):
    lib = tbvh._load_native()
    assert lib is not None
    monkeypatch.setattr(jbvh, "_NATIVE", lib)
    monkeypatch.setattr(jbvh, "_NATIVE_TRIED", True)


def _images(d, normal_ext):
    rng = np.random.default_rng(17)
    y, x = np.mgrid[0:24, 0:40]
    nrm = np.stack([128 + 60 * np.sin(x / 4.0), 128 + 60 * np.cos(y / 3.0),
                    np.full_like(x, 230.0)], -1).astype(np.uint8)
    Image.fromarray(nrm).save(d / f"normal.{normal_ext}")
    Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)) \
        .save(d / "bump.bmp")
    hf = (128 + 100 * np.sin(x / 5.0) * np.cos(y / 4.0)).astype(np.uint8)
    Image.fromarray(np.stack([hf, hf // 2, 255 - hf], -1)) \
        .save(d / "height.tga", compression="tga_rle")
    env = np.stack([x * 6, y * 10, np.full_like(x, 90)], -1).astype(np.uint8)
    Image.fromarray(env).save(d / "env.jpg", quality=90)


SCENE = (
    "<?xml version=\"1.0\"?><scene version=\"0.5.0\">"
    "<integrator type=\"path\"><integer name=\"maxDepth\" value=\"3\"/>"
    "</integrator>"
    "<sensor type=\"perspective\"><float name=\"fov\" value=\"40\"/>"
    "<transform name=\"toWorld\"><lookat origin=\"0, 6, 14\" "
    "target=\"0, 0, 0\"/></transform><sampler type=\"independent\">"
    "<integer name=\"sampleCount\" value=\"1\"/></sampler>"
    "<film type=\"hdrfilm\"><integer name=\"width\" value=\"24\"/>"
    "<integer name=\"height\" value=\"16\"/></film></sensor>"
    "<bsdf type=\"normalmap\" id=\"nm\"><texture type=\"bitmap\">"
    "<string name=\"filename\" value=\"normal.{ext}\"/></texture>"
    "<bsdf type=\"diffuse\"/></bsdf>"
    "<bsdf type=\"bumpmap\" id=\"bm\"><float name=\"scale\" value=\"0.1\"/>"
    "<texture type=\"bitmap\"><string name=\"filename\" value=\"bump.bmp\"/>"
    "<float name=\"uscale\" value=\"2\"/></texture>"
    "<bsdf type=\"diffuse\"/></bsdf>"
    "<shape type=\"rectangle\"><transform name=\"toWorld\"><scale "
    "value=\"8\"/><rotate x=\"1\" angle=\"-90\"/></transform><ref "
    "id=\"nm\"/></shape>"
    "<shape type=\"cube\"><ref id=\"bm\"/></shape>"
    "<shape type=\"heightfield\"><string name=\"filename\" "
    "value=\"height.tga\"/><float name=\"scale\" value=\"0.5\"/></shape>"
    "<emitter type=\"envmap\"><string name=\"filename\" "
    "value=\"env.jpg\"/></emitter></scene>")


def _tensors(a, path="arrays"):
    if torch.is_tensor(a):
        yield path, a
    elif hasattr(a, "_fields"):
        for f in a._fields:
            yield from _tensors(getattr(a, f), f"{path}.{f}")


@pytest.mark.parametrize("normal_ext", ["jpg", "bmp"])
def test_loaders_agree_on_ldr_images(same_bvh, tmp_path, normal_ext):
    _images(tmp_path, normal_ext)
    xml = tmp_path / "scene.xml"
    xml.write_text(SCENE.replace("{ext}", normal_ext))
    js = jxl.load_scene(str(xml))
    ts = txl.load_scene(str(xml), device="cpu")
    cs = convert.convert_scene(js, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    assert ts.config == dataclasses.replace(cs.config, traversal="tiled",
                                            tiled_q=ts.config.tiled_q)
    assert ts.has_normal_maps and cs.has_normal_maps
    got, ref = dict(_tensors(ts.arrays)), dict(_tensors(cs.arrays))
    assert got.keys() == ref.keys()
    for k, v in got.items():
        r = ref[k]
        assert v.dtype == r.dtype and v.shape == r.shape, k
        if v.is_floating_point():
            v, r = v.view(torch.int32), r.view(torch.int32)
        assert torch.equal(v, r), k
    # the images reached the scene: two bitmaps and a non-constant envmap
    assert ts.arrays.checkers.bitmaps.shape[0] == 2
    assert ts.arrays.env.image.std() > 0
