"""Energy-redistribution path tracing, Cline et al. 2005 (port of
hairpt/integrators/erpt.py; reference src/integrators/erpt/*).

A pool of primary samples stratified over the pixels estimates the mean
image luminance b; n chains start at pool entries resampled in
proportion to their luminance (stratified over the CDF); each of the K
small-step mutations splats both states, (1 - a) C(x) / L(x) b / K and
a C(y) / L(y) b / K, so every deposit carries luminance b / K; the image
is scaled by W H / n. The mutations are a Python loop (the JAX package's
lax.scan). Seeds, salts and the uint32 keys (seed * 131 + salt) are the
JAX package's, mod 2^32.
"""
from __future__ import annotations

import torch

from ..core import rng
from .pssmlt import (Chains, fresh_uniforms, gauss_step, make_eval_u,
                     pick_from_pool, splat_chains, wrap01)


def erpt_chains(scene, n_seeds: int = 1 << 14, n_mutations: int = 16,
                sigma: float = 0.014, seed: int = 0) -> Chains:
    """render_erpt's chains (pssmlt.Chains): the pool is evaluated here,
    each step as the returned iterator reaches it. The deposits carry
    the equal quanta b / K, before render_erpt's final scale."""
    cfg = scene.config
    arr = scene.arrays
    dev = arr.device
    n = n_seeds
    eval_u, n_dims = make_eval_u(scene)
    idx = torch.arange(n, device=dev)

    u0 = fresh_uniforms(idx, seed * 131 + 1, 0, n_dims)
    # the image-plane dims stratified over the pixels: lane i covers
    # pixel i mod W H, jittered
    pix = idx % (cfg.width * cfg.height)
    u0[:, 0] = ((pix % cfg.width).to(torch.float32) + u0[:, 0]) / cfg.width
    u0[:, 1] = ((pix // cfg.width).to(torch.float32) + u0[:, 1]) \
        / cfg.height
    pos0, rgb0, l0 = eval_u(arr, u0)
    b = torch.mean(l0)
    u_r = rng.uniform_1d(idx, (seed * 131 + 3) & rng.M32, 0)
    pick = pick_from_pool(l0, (idx.to(torch.float32) + u_r) / n)

    def steps():
        u, pos, rgb, l = u0[pick], pos0[pick], rgb0[pick], l0[pick]
        share = b / n_mutations
        for it in range(n_mutations):
            gauss = gauss_step(idx, seed + 5, n_dims, it * 2 + 1,
                               it * 2 + 2)
            u_prop = wrap01(u + sigma * gauss)
            pos_p, rgb_p, l_p = eval_u(arr, u_prop)
            a = torch.clamp(l_p / torch.clamp(l, min=1e-12), 0.0, 1.0)
            dep_c = torch.where((l > 1e-12)[:, None],
                                rgb / torch.clamp(l, min=1e-12)[:, None]
                                * ((1.0 - a) * share)[:, None], 0.0)
            dep_p = torch.where((l_p > 1e-12)[:, None],
                                rgb_p / torch.clamp(l_p, min=1e-12)[:, None]
                                * (a * share)[:, None], 0.0)
            acc = rng.uniform_1d(idx, (seed + 6) & rng.M32, it) < a
            yield ((pos, dep_c), (pos_p, dep_p)), acc
            u = torch.where(acc[:, None], u_prop, u)
            pos = torch.where(acc[:, None], pos_p, pos)
            rgb = torch.where(acc[:, None], rgb_p, rgb)
            l = torch.where(acc, l_p, l)

    return Chains(b, pick, steps())


def render_erpt(scene, n_seeds: int = 1 << 14, n_mutations: int = 16,
                sigma: float = 0.014, seed: int = 0, progress=None):
    """ERPT render: n_seeds chains of n_mutations small steps of size
    sigma. Returns the [H, W, 3] image. progress: callable(step,
    n_mutations, seconds, n_seeds) per step."""
    cfg = scene.config
    steps = erpt_chains(scene, n_seeds, n_mutations, sigma, seed).steps
    splat = splat_chains(scene, steps, n_mutations, n_seeds, progress)
    return splat * ((cfg.width * cfg.height) / n_seeds)
