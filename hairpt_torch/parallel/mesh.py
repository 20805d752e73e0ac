"""Rendering and the inverse-rendering step across GPUs (port of
hairpt/parallel/mesh.py).

The image-space data parallelism of the reference's scheduler (blocks of
pixels across cores and machines) becomes a pixel wave split over the
ranks of a torch.distributed DeviceMesh: every rank builds the same scene
itself (the SAH builder is deterministic, so no scene table is ever sent
over the group), traces its own contiguous chunk of the pixel list, and
the films are summed with one all_reduce per wave.

Launch one process per GPU with torchrun, which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    torchrun --nproc-per-node=N my_render.py   # calls init() first

init() puts each rank on the card LOCAL_RANK and uses NCCL; gloo only
when asked for (device="cpu", or backend="gloo" for several ranks sharing
one card). There is no fallback: a rank without a card of its own, or a
card build of torch without NCCL, raises.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device
from ..film import film as film_mod
from ..integrators import inverse as inverse_mod
from ..integrators import path as path_int

def init(device=None, backend: str | None = None,
         init_method: str | None = None, rank: int | None = None,
         world_size: int | None = None) -> torch.device:
    """Join the process group and return this rank's device. rank,
    world_size and the rendezvous default to torchrun's variables (RANK,
    WORLD_SIZE, env:// through MASTER_ADDR and MASTER_PORT); LOCAL_RANK
    picks the card. On the card (the default) the backend is NCCL and
    each rank needs a card of its own; backend="gloo" lets ranks share
    cards (rank LOCAL_RANK on card LOCAL_RANK mod the card count);
    device="cpu" runs gloo on the CPU."""
    dev = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else world_size
    local = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        backend = backend or "nccl"
        n_cards = torch.cuda.device_count()
        if backend == "nccl":
            if not dist.is_nccl_available():
                raise RuntimeError("hairpt_torch.parallel: this torch has "
                                   "no NCCL; pass backend='gloo' to share "
                                   "cards over gloo")
            if local >= n_cards:
                raise RuntimeError(f"hairpt_torch.parallel: local rank "
                                   f"{local} has no card of its own "
                                   f"({n_cards} visible)")
            dev = torch.device("cuda", local)
        else:
            dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    else:
        backend = backend or "gloo"
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return dev


def _device_type() -> str:
    """The meshes' device type: NCCL's ranks hold cards; gloo's groups
    take tensors on either device."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def default_mesh(n_devices: int | None = None) -> DeviceMesh:
    """A 1-D mesh named ("tiles",) over the first n_devices ranks (all of
    them by default). Every rank of the group calls it."""
    n = dist.get_world_size() if n_devices is None else n_devices
    if n > dist.get_world_size():
        raise RuntimeError(f"need {n} ranks, have {dist.get_world_size()}")
    return DeviceMesh(_device_type(), torch.arange(n),
                      mesh_dim_names=("tiles",))


def multihost_mesh(n_hosts: int, chips_per_host: int) -> DeviceMesh:
    """A 2-D (hosts x chips) mesh named ("hosts", "chips"), ranks
    host-major as torchrun numbers them; pixels split over both
    dimensions and the film is summed over both. Raises when there are
    fewer than n_hosts * chips_per_host ranks."""
    need = n_hosts * chips_per_host
    have = dist.get_world_size()
    if have < need:
        raise RuntimeError(f"need {need} devices, have {have}")
    return DeviceMesh(_device_type(),
                      torch.arange(need).reshape(n_hosts, chips_per_host),
                      mesh_dim_names=("hosts", "chips"))


def _mesh_group(mesh: DeviceMesh):
    """The process group over every rank of the mesh (all dimensions)."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    ranks = mesh.mesh.flatten().tolist()
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks)


def _my_pixels(mesh: DeviceMesh, n_pix: int, device):
    """This rank's contiguous chunk of the pixel list in plain pixel
    order: chunk i of torch.tensor_split(arange(n_pix), mesh size), i the
    rank's row-major place in the mesh."""
    flat = mesh.mesh.flatten().tolist()
    me = dist.get_rank()
    if me not in flat:
        raise RuntimeError(f"rank {me} is not in the mesh {flat}")
    return torch.tensor_split(torch.arange(n_pix, device=device),
                              len(flat))[flat.index(me)]


def _reduce_film(image, weight, group):
    """One SUM all_reduce of the image and the weight together."""
    h, w = weight.shape
    buf = torch.cat([image.reshape(-1), weight.reshape(-1)])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf[:h * w * 3].view(h, w, 3), buf[h * w * 3:].view(h, w)


def make_sharded_wave(scene, mesh: DeviceMesh, differentiable: bool = False):
    """Returns (wave, n_pixels_per_rank): wave(sample_id, image, weight)
    -> (image, weight) traces this rank's pixels at sample index
    sample_id, splats them into a film of its own (non-finite radiance
    zeroed) and adds the film summed over the mesh. Unlike the JAX
    package, the shards need not be equal, so there are no padding lanes
    (they would add only zeros). With differentiable=True the radiance is
    the differentiable mode's, and the summed film carries the gradient
    of this rank's own film only (sum the parameter gradients over the
    mesh afterwards, as make_train_step does)."""
    cfg = scene.config
    dev = scene.arrays.device
    pix = _my_pixels(mesh, cfg.width * cfg.height, dev)
    group = _mesh_group(mesh)
    li = path_int.make_li_fn(scene, differentiable=differentiable)
    fl = scene.film

    def wave(sample_id, image, weight, arrays=None):
        arrays = scene.arrays if arrays is None else arrays
        sample_idx = torch.full_like(pix, int(sample_id))
        radiance, pos, _ = li(arrays, pix, sample_idx)
        radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0,
                                    neginf=0.0)
        img_l, wt_l = film_mod.splat_samples(fl, pos, radiance,
                                             *film_mod.zeros(fl, dev))
        img_r, wt_r = _reduce_film(img_l.detach(), wt_l, group)
        # the summed value, the gradient of this rank's own film
        img_w = img_l + (img_r - img_l).detach()
        return image + img_w, weight + wt_r

    return wave, int(pix.shape[0])


def render_sharded(scene, mesh: DeviceMesh | None = None, spp=None,
                   seed: int = 0):
    """The full frame with the pixel wave split over the mesh: sample
    index s + seed * 65536 for s < spp, the developed image on every
    rank."""
    mesh = mesh or default_mesh()
    spp = spp if spp is not None else scene.config.spp
    wave, _ = make_sharded_wave(scene, mesh)
    image, weight = film_mod.zeros(scene.film, scene.arrays.device)
    with torch.no_grad():
        for s in range(spp):
            image, weight = wave(s + seed * 65536, image, weight)
    return film_mod.develop(image, weight)


def make_train_step(scene, mesh: DeviceMesh, target, spp: int = 1,
                    lr: float = 0.05):
    """The sharded inverse-rendering step: train_step(params, seed) ->
    (params, loss). It renders the differentiable mode with the pixels
    split over the mesh (sample index seed * 131 + s), takes the loss
    mean((develop(image) - target)^2) on the summed film, backpropagates
    through inverse.apply_params (a Marschner row's tables recomputed on
    every rank), sums the parameter gradients over the mesh once and
    applies SGD, so every rank holds the same parameters. The loss is the
    same on every rank; the film's all_reduce is outside the graph, so
    the summed gradient is the one-process gradient, not world_size times
    it."""
    dev = scene.arrays.device
    wave, _ = make_sharded_wave(scene, mesh, differentiable=True)
    group = _mesh_group(mesh)
    target = torch.as_tensor(target, device=dev)

    def train_step(params: dict, seed: int):
        leaves = {k: torch.as_tensor(v, device=dev).detach().clone()
                  .requires_grad_() for k, v in params.items()}
        arrays = inverse_mod.apply_params(scene, leaves)
        image, weight = film_mod.zeros(scene.film, dev)
        for s in range(spp):
            image, weight = wave(int(seed) * 131 + s, image, weight,
                                 arrays=arrays)
        loss = torch.mean((film_mod.develop(image, weight) - target) ** 2)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(names, grads)]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        out, i = {}, 0
        for k, g in zip(names, grads):
            out[k] = (leaves[k] - lr * flat[i:i + g.numel()].view_as(g)) \
                .detach()
            i += g.numel()
        return out, loss.detach()

    return train_step
