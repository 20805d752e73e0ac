"""hairpt_torch.parallel.mesh over four gloo ranks on the CPU against
hairpt.parallel.mesh over virtual CPU devices (conftest.py gives eight).

One set of four ranks (tests/torch_parallel.py, no JAX) runs as
subprocesses on a free local port, each with a hard timeout, while this
process computes hairpt's results: the sharded render of
tests/test_grad_and_sharding.py's diffuse sphere over a 1-D mesh of four
and a 2 x 2 mesh, and one train step over each. Bounds: the images'
rtol 2e-4 / atol 2e-5 (tests/test_grad_and_sharding.py:109) and the
parameters' 1e-5 relative."""
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core.math import matrix_lookat as jlookat
from hairpt.film.film import Film as JFilm
from hairpt.models import emitters as jem
from hairpt.models import shapes as jshp
from hairpt.models.bsdf import registry as jmat
from hairpt.models.sensors import Camera as JCamera
from hairpt.parallel import mesh as jmesh
from hairpt.scene.scene import SceneBuilder as JSceneBuilder
from torch_threads import one_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 4
RANK_TIMEOUT = 120


def _jax_diffuse_scene(w=16, h=16):
    """tests/test_grad_and_sharding.py's _diffuse_scene."""
    b = JSceneBuilder()
    m = b.add_material(kind=jmat.DIFFUSE, diffuse=(0.4, 0.5, 0.6),
                       twosided=True)
    b.add_mesh(jshp.sphere(1.0, 16, 32), m)
    b.env = jem.make_constant((1.0, 0.9, 0.8))
    cam = JCamera.perspective(jlookat((0, 0, -4), (0, 0, 0), (0, 1, 0)),
                              45.0, w, h)
    return b.build(cam, JFilm.make(w, h, "box"), spp=1, max_depth=3,
                   sampler=0, strict_normals=False)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_rank(rank, port, out_dir):
    env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
               WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return subprocess.run([sys.executable, os.path.join(HERE,
                                                        "torch_parallel.py"),
                           out_dir], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=RANK_TIMEOUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("ranks"))
    port = _free_port()
    with ThreadPoolExecutor(WORLD) as ex:
        futs = [ex.submit(_run_rank, r, port, out_dir) for r in range(WORLD)]
        # hairpt's side while the ranks run
        scene = _jax_diffuse_scene()
        meshes = {"1d": jmesh.default_mesh(4),
                  "2d": jmesh.multihost_mesh(2, 2)}
        target = jnp.zeros((16, 16, 3), jnp.float32)
        params = {"diffuse": scene.arrays.materials.diffuse}
        ref = {}
        for name, m in meshes.items():
            ref[f"img_{name}"] = np.asarray(jmesh.render_sharded(scene, m,
                                                                 spp=2))
            p, loss = jmesh.make_train_step(scene, m, target, spp=1,
                                            lr=0.05)(params, jnp.uint32(0))
            ref[f"step_{name}"] = np.asarray(p["diffuse"])
            ref[f"loss_{name}"] = float(loss)
        procs = [f.result() for f in futs]
    for r, pr in enumerate(procs):
        assert pr.returncode == 0, f"rank {r}:\n{pr.stderr[-4000:]}"
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
             for r in range(WORLD)]
    return ranks, ref


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_sharded_render_matches_jax(runs, mesh):
    """render_sharded over default_mesh(4) and multihost_mesh(2, 2)
    against hairpt's over the same meshes, on every rank."""
    ranks, ref = runs
    assert ref[f"img_{mesh}"].mean() > 0
    for out in ranks:
        np.testing.assert_allclose(out[f"img_{mesh}"], ref[f"img_{mesh}"],
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_train_step_matches_jax(runs, mesh):
    """One make_train_step over default_mesh(4) at lr 0.05 against
    hairpt's over a 1-D mesh of four and a 2 x 2 mesh (JAX's update does
    not depend on the device count): the same parameters on every rank,
    within 1e-5 relative, and the same loss."""
    ranks, ref = runs
    want = ref[f"step_{mesh}"]
    for out in ranks:
        np.testing.assert_allclose(out["diffuse_step"], want, rtol=1e-5)
        np.testing.assert_allclose(out["loss"], ref[f"loss_{mesh}"],
                                   rtol=1e-5)
    assert not np.array_equal(want, np.asarray([[0.4, 0.5, 0.6]],
                                               np.float32))


def test_sharded_renders_repeat_bit_for_bit(runs):
    """Two sharded renders on the same ranks are equal bit for bit
    (hairpt's test_virtual_mesh_film_parity_256 rule), and every rank
    holds the same image."""
    ranks, _ = runs
    for out in ranks:
        assert np.array_equal(out["img_1d"], out["img_1d_again"])
        assert np.array_equal(out["img_1d"], ranks[0]["img_1d"])


def test_gradient_does_not_scale_with_the_world_size(runs):
    """A Marschner furball's step over two ranks (sigma_a and beta_r, the
    hair tables recomputed on each) equals the one-process step within
    1e-5 relative, on both ranks: a gradient doubled by a second
    all_reduce, or by the backward of a differentiable one, would move
    the parameters twice as far."""
    ranks, _ = runs
    r0 = ranks[0]
    for k in ("sigma_a", "beta_r"):
        moved = r0[f"hair1_{k}"] - r0[f"hair0_{k}"]
        assert np.abs(moved).max() > 0, k
        for out in ranks[:2]:
            np.testing.assert_allclose(out[f"hair_{k}"], r0[f"hair1_{k}"],
                                       rtol=1e-5, atol=1e-7)


def test_multihost_mesh_raises_with_too_few_ranks(runs):
    ranks, _ = runs
    assert all(bool(out["too_few_raises"]) for out in ranks)


def test_ranks_import_no_jax(runs):
    """No rank loaded jax or hairpt."""
    ranks, _ = runs
    assert not any(bool(out["jax_loaded"]) for out in ranks)


def test_init_on_the_card_without_cuda_raises(monkeypatch):
    """init() asked for the card (the default) on a machine without CUDA
    raises before it joins any group."""
    from hairpt_torch.parallel import mesh as tmesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.init()
    assert not torch.distributed.is_initialized()
