"""One gloo rank of tests/test_torch_parallel.py, and the scenes it
renders: the port's copies of tests/test_grad_and_sharding.py's
_diffuse_scene and _hair_scene. Run by the test as

    RANK=r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_parallel.py OUT_DIR

rank r writes OUT_DIR/rank{r}.npz. Imports no JAX."""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hairpt_torch.core.math import matrix_lookat  # noqa: E402
from hairpt_torch.film import film as film_mod  # noqa: E402
from hairpt_torch.film.film import Film  # noqa: E402
from hairpt_torch.integrators import inverse, path  # noqa: E402
from hairpt_torch.models import emitters as em  # noqa: E402
from hairpt_torch.models import shapes as shp  # noqa: E402
from hairpt_torch.models.bsdf import registry as mat  # noqa: E402
from hairpt_torch.models.sensors import Camera  # noqa: E402
from hairpt_torch.scene import hairgen  # noqa: E402
from hairpt_torch.scene.scene import SceneBuilder  # noqa: E402

LR = 0.05


def diffuse_scene(w=16, h=16, device="cpu"):
    b = SceneBuilder(device=device)
    m = b.add_material(kind=mat.DIFFUSE, diffuse=(0.4, 0.5, 0.6),
                       twosided=True)
    b.add_mesh(shp.sphere(1.0, 16, 32), m)
    b.env = em.make_constant((1.0, 0.9, 0.8), device=device)
    cam = Camera.perspective(matrix_lookat((0, 0, -4), (0, 0, 0), (0, 1, 0)),
                             45.0, w, h)
    return b.build(cam, Film.make(w, h, "box"), spp=1, max_depth=3,
                   sampler=0, strict_normals=False, traversal="packed")


def hair_scene(w=8, h=8, device="cpu"):
    b = SceneBuilder(device=device)
    m = b.add_material(kind=mat.MARSCHNER, sigma_a=(0.5, 0.5, 0.5),
                       beta_r=0.1, eta=1.55, alpha=0.2,
                       diffuse=(0.3, 0.1, 0.02))
    fs = hairgen.gen_furball(n_fibers=150, n_segs=5, radius=0.03, seed=2,
                             center=(0, 0, 0), core_r=0.5, fiber_len=0.6)
    b.add_fibers(fs, m)
    b.env = em.make_constant((1.0, 1.0, 1.0), device=device)
    cam = Camera.perspective(matrix_lookat((0, 0.4, -3), (0, 0, 0),
                                           (0, 1, 0)), 45.0, w, h)
    return b.build(cam, Film.make(w, h, "box"), spp=1, max_depth=3,
                   sampler=0, traversal="packed")


def one_process_step(scene, target, params, seed=0, spp=1, lr=LR):
    """make_train_step's step in one process: the differentiable mode
    over every pixel at sample index seed * 131 + s, the loss on the
    developed film, SGD."""
    dev = scene.arrays.device
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    arrays = inverse.apply_params(scene, leaves)
    li = path.make_li_fn(scene, differentiable=True)
    n = scene.config.width * scene.config.height
    pix = torch.arange(n, device=dev)
    image, weight = film_mod.zeros(scene.film, dev)
    for s in range(spp):
        rad, pos, _ = li(arrays, pix, torch.full_like(pix, seed * 131 + s))
        rad = torch.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0)
        image, weight = film_mod.splat_samples(scene.film, pos, rad, image,
                                               weight)
    loss = torch.mean((film_mod.develop(image, weight) - target) ** 2)
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return {k: (leaves[k] - lr * g).detach()
            for k, g in zip(names, grads)}, float(loss)


def main(out_dir):
    torch.set_num_threads(1)
    from hairpt_torch.parallel import mesh as pmesh
    pmesh.init(device="cpu")
    rank = torch.distributed.get_rank()
    out = {}
    scene = diffuse_scene()
    m4 = pmesh.default_mesh(4)
    m22 = pmesh.multihost_mesh(2, 2)
    out["img_1d"] = pmesh.render_sharded(scene, m4, spp=2).numpy()
    out["img_1d_again"] = pmesh.render_sharded(scene, m4, spp=2).numpy()
    out["img_2d"] = pmesh.render_sharded(scene, m22, spp=2).numpy()
    try:
        pmesh.multihost_mesh(2, 4)
        out["too_few_raises"] = False
    except RuntimeError:
        out["too_few_raises"] = True
    target = torch.zeros((16, 16, 3))
    step = pmesh.make_train_step(scene, m4, target, spp=1, lr=LR)
    p, loss = step({"diffuse": scene.arrays.materials.diffuse}, 0)
    out["diffuse_step"] = p["diffuse"].numpy()
    out["loss"] = float(loss)
    # a Marschner furball's step over the first two ranks against the
    # one-process step: a gradient scaled by the world size shows here
    hs = hair_scene()
    m2 = pmesh.default_mesh(2)
    params = {"sigma_a": hs.arrays.materials.sigma_a,
              "beta_r": hs.arrays.materials.beta_r}
    if rank < 2:
        step2 = pmesh.make_train_step(hs, m2, torch.zeros((8, 8, 3)), spp=1,
                                      lr=LR)
        p2, _ = step2(params, 3)
        out.update({f"hair_{k}": v.numpy() for k, v in p2.items()})
        if rank == 0:
            p1, _ = one_process_step(hs, torch.zeros((8, 8, 3)), params,
                                     seed=3)
            out.update({f"hair1_{k}": v.numpy() for k, v in p1.items()})
            out.update({f"hair0_{k}": v.numpy() for k, v in params.items()})
    out["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "hairpt."))
                            or m == "hairpt" for m in sys.modules)
    torch.distributed.barrier()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
