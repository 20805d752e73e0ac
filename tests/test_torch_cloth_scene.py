"""The irawan cloth through the scene XML on the CPU: the cloth stand-in
(scene_xmls.cloth: the furball's fibers on a floor whose irawan reads the
weave file twill.wv with $vars, before a twosided plain-weave backdrop)
loaded by both packages' loaders, hairpt's carried across with
hairpt_torch.convert: every array equal (the cloth tables' spec_norm
within 1e-5, the Monte Carlo sums' order); and the stand-in without its
hair (triangles only, 32^2, depth 4, 2 spp) rendered by hairpt (its CPU
default, the packed BVH walk: one JAX compile) and by the port, held as
tests/torch_light_scenes.compare holds the light tracers, with
path.render's statistics counters (the timers left out) equal to
hairpt's."""
import dataclasses

import jax
import numpy as np
import pytest

from hairpt.integrators import path as jpath
from hairpt.scene import xml_loader as jxl
from hairpt.utils import stats as jstats
from hairpt_torch import convert
from hairpt_torch.integrators import path as tpath
from hairpt_torch.models.bsdf import cloth as tcloth
from hairpt_torch.models.bsdf import registry as tmat
from hairpt_torch.scene import scene_xmls
from hairpt_torch.scene import xml_loader as txl
from hairpt_torch.utils import stats as tstats
from test_torch_xml import LOAD, _arrays_equal, same_bvh  # noqa: F401
from torch_light_scenes import compare
from torch_threads import one_thread  # noqa: F401


def _split_cloth(arrays):
    """(the arrays without the cloth table, the cloth table)."""
    m = arrays.materials
    return arrays._replace(materials=m._replace(cloth=None)), m.cloth


def test_loader_and_convert_carry_the_cloth(tmp_path, same_bvh):
    """The stand-in through hairpt's loader and convert_scene, and through
    the port's loader: config, kinds and every array equal; the two weaves
    (the file's noisy twill with its $vars, the built-in plain) in the
    ClothTable, repeats as the XML gives them."""
    path = scene_xmls.write_scene(str(tmp_path), "cloth", res=64)
    js = jxl.load_scene(path, **LOAD)
    ts = txl.load_scene(path, **LOAD, device="cpu")
    jt = js._replace(config=dataclasses.replace(
        js.config, traversal="tiled", tiled_q=2048))
    cs = convert.convert_scene(jt, jax.tree_util.tree_map(np.asarray,
                                                          js.arrays),
                               device="cpu")
    assert ts.config == cs.config and ts.active_kinds == cs.active_kinds
    assert tmat.CLOTH in ts.active_kinds
    a_t, cl_t = _split_cloth(ts.arrays)
    a_c, cl_c = _split_cloth(cs.arrays)
    _arrays_equal(a_t, a_c)
    for f in tcloth.ClothTable._fields:
        x, y = getattr(cl_t, f).numpy(), getattr(cl_c, f).numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, f
        if f == "spec_norm":
            np.testing.assert_allclose(x, y, rtol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)
    reps = scene_xmls.CLOTH_REPEAT
    assert cl_t.repeat_u.tolist() == [reps["floor"], reps["backdrop"]]
    assert cl_t.fineness.tolist() == [scene_xmls.TWILL_PROPS["fineness"],
                                      0.0]
    np.testing.assert_allclose(cl_t.yarn_kd[0, 0].numpy(),
                               scene_xmls.TWILL_PROPS["warp_kd"])
    kinds = ts.arrays.materials.kind.tolist()
    assert kinds.count(tmat.CLOTH) == 2
    assert ts.arrays.materials.twosided[kinds.index(tmat.CLOTH) + 1]


def test_cloth_render_matches_hairpt(tmp_path):
    """The stand-in without its hair: hairpt's render and the port's of
    the same XML (both loaders), the image held to hairpt's, and
    path.render's counters equal to hairpt's but the timers."""
    path = scene_xmls.write_scene(str(tmp_path), "cloth", res=32, depth=4,
                                  spp=2, hair=False)
    js = jxl.load_scene(path)
    ts = txl.load_scene(path, device="cpu")
    assert ts.arrays.hair is None and tmat.CLOTH in ts.active_kinds
    jstats.reset()
    tstats.reset()
    img_j = np.asarray(jpath.render(js))
    img_t = tpath.render(ts)
    compare(img_t, img_j)

    def counters(reg):
        return {(c, n): (v.kind, v.value, v.base)
                for c, cs in reg.items() for n, v in cs.items()
                if "time" not in n and "rate" not in n}
    got, want = counters(tstats._registry), counters(jstats._registry)
    assert got == want and ("Path tracer", "Rays traced") in got
