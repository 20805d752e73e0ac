"""Primary-sample-space Metropolis light transport, Kelemen style (port
of hairpt/integrators/pssmlt.py; reference src/integrators/pssmlt/*).

One Markov chain per lane: n_chains chains advance in lockstep, each
proposal one wave of the path estimator with explicit primary samples
(path.make_li_fn(n_uniform_dims=...)). The chains start from a seed pool
of large-step samples resampled in proportion to their luminance, and
the image is scaled by the pool's mean luminance b. The JAX package's
lax.scan over the mutations is a Python loop here; the uniforms of a
step are one broadcast hash over a dim index tensor (the JAX package
makes one call per dim), with the same values. Seeds, salts and the
uint32 keys (seed * 7919 + salt, idx * 131 + dim) are the JAX package's,
mod 2^32.
"""
from __future__ import annotations

import math
import time
from typing import Iterator, NamedTuple

import torch

from ..core import rng
from ..film import film as film_mod
from . import path as path_int


def _luminance(c):
    # a product with the weights, as the JAX package's pssmlt computes it
    # (path._luminance adds the three products)
    return c @ torch.tensor(path_int.LUM, dtype=torch.float32,
                            device=c.device)


def n_pss_dims(cfg):
    """2 (the pixel) + the camera's 4 + 16 per bounce."""
    return 2 + path_int.DIM_BASE + path_int.DIM_STRIDE * max(
        cfg.max_depth - 1, 1)


def wrap01(x):
    """x mod 1.0 with jnp.mod's rule: the truncated remainder, plus 1
    where it is negative (a tiny negative x rounds to exactly 1.0)."""
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0, r + 1.0, r)


def make_eval_u(scene):
    """(eval_u, n_dims): eval_u(arr, u [N, n_dims]) -> (pos [N, 2],
    rgb [N, 3], lum [N]), the path estimator at the primary samples u:
    u[:, 0:2] pick the pixel, the camera jitter dims read the fractional
    position inside it, the rest are the path's dims."""
    cfg = scene.config
    n_dims = n_pss_dims(cfg)
    li_fn = path_int.make_li_fn(scene, n_uniform_dims=n_dims - 2)

    def eval_u(arr, u):
        n = u.shape[0]
        px = torch.clamp(u[:, 0] * cfg.width, 0, cfg.width - 1e-3)
        py = torch.clamp(u[:, 1] * cfg.height, 0, cfg.height - 1e-3)
        pix = py.to(torch.int64) * cfg.width + px.to(torch.int64)
        uu = u[:, 2:].clone()
        uu[:, path_int.DIM_CAM_POS] = px - torch.floor(px)
        uu[:, path_int.DIM_CAM_POS + 1] = py - torch.floor(py)
        rgb, pos, _ = li_fn(arr, pix, torch.zeros_like(pix), uniforms=uu)
        rgb = torch.nan_to_num(rgb, nan=0.0, posinf=0.0, neginf=0.0)
        return pos, rgb, _luminance(rgb)

    return eval_u, n_dims


def fresh_uniforms(idx, key: int, it: int, n_dims: int):
    """[N, n_dims]: column d of lane i is uniform_1d(i, key, it * n_dims
    + d), all u32."""
    dims = (it * n_dims + torch.arange(n_dims, device=idx.device)) \
        & rng.M32
    return rng.uniform_1d(idx[:, None], key & rng.M32, dims[None, :])


def gauss_step(idx, key: int, n_dims: int, dim1: int, dim2: int):
    """[N, n_dims] Box-Muller normals from the uniforms keyed by (idx *
    131 + d, key) at dims dim1 and dim2."""
    pix = (idx[:, None] * 131
           + torch.arange(n_dims, device=idx.device)[None, :]) & rng.M32
    g1 = rng.uniform_1d(pix, key & rng.M32, dim1 & rng.M32)
    g2 = rng.uniform_1d(pix, key & rng.M32, dim2 & rng.M32)
    return torch.sqrt(-2.0 * torch.log(torch.clamp(g1, min=1e-12))) \
        * torch.cos(2 * math.pi * g2)


def pick_from_pool(l_pool, u):
    """Lanes of the pool picked in proportion to l_pool by u [N] (the
    normalised cumulative sum searched from the left, clipped)."""
    n = l_pool.shape[0]
    cdf = torch.cumsum(l_pool, 0) / torch.clamp(torch.sum(l_pool),
                                                min=1e-20)
    return torch.clamp(torch.searchsorted(cdf, u), 0, n - 1)


class Chains(NamedTuple):
    """The Markov chains of a Metropolis render: b the seed pool's mean
    luminance (a 0-d tensor), pick [N] the pool lane each chain starts
    from, steps an iterator that runs one step per item and yields
    (splats, acc): splats the two (pos [N, 2], rgb [N, 3]) deposits of
    the step, at the current and the proposed states, acc [N] its accept
    flags."""
    b: torch.Tensor
    pick: torch.Tensor
    steps: Iterator


def pssmlt_chains(scene, n_chains: int = 1 << 14, n_mutations: int = 64,
                  p_large: float = 0.3, sigma: float = 0.014,
                  seed: int = 0) -> Chains:
    """render_pssmlt's chains: the pool is evaluated here, each step as
    the returned iterator reaches it. The deposits carry the Kelemen
    weights, before render_pssmlt's final scale."""
    arr = scene.arrays
    dev = arr.device
    n = n_chains
    eval_u, n_dims = make_eval_u(scene)
    idx = torch.arange(n, device=dev)

    u_pool = fresh_uniforms(idx, seed * 7919 + 1, 0, n_dims)
    pos_pl, rgb_pl, l_pl = eval_u(arr, u_pool)
    pick = pick_from_pool(l_pl, rng.uniform_1d(idx, (seed + 9) & rng.M32,
                                               0))

    def steps():
        u, pos, rgb, l = u_pool[pick], pos_pl[pick], rgb_pl[pick], \
            l_pl[pick]
        for it in range(n_mutations):
            u_large = fresh_uniforms(idx, seed * 7919 + 2, it + 1, n_dims)
            gauss = gauss_step(idx, seed, n_dims, it * 3 + 1, it * 3 + 2)
            u_small = wrap01(u + sigma * gauss)
            is_large = rng.uniform_1d(idx, (seed + 3) & rng.M32,
                                      it) < p_large
            u_prop = torch.where(is_large[:, None], u_large, u_small)
            pos_p, rgb_p, l_p = eval_u(arr, u_prop)
            a = torch.clamp(l_p / torch.clamp(l, min=1e-12), 0.0, 1.0)
            a = torch.where(l <= 0, 1.0, a)
            w_cur = (1.0 - a) / torch.clamp(l, min=1e-12)
            w_prop = a / torch.clamp(l_p, min=1e-12)
            splats = ((pos, rgb * torch.where(l > 0, w_cur, 0.0)[:, None]),
                      (pos_p,
                       rgb_p * torch.where(l_p > 0, w_prop, 0.0)[:, None]))
            acc = rng.uniform_1d(idx, (seed + 4) & rng.M32, it) < a
            yield splats, acc
            u = torch.where(acc[:, None], u_prop, u)
            pos = torch.where(acc[:, None], pos_p, pos)
            rgb = torch.where(acc[:, None], rgb_p, rgb)
            l = torch.where(acc, l_p, l)

    return Chains(torch.mean(l_pl), pick, steps())


def splat_chains(scene, steps, n_mutations: int, n: int, progress=None):
    """The [H, W, 3] sum of every step's deposits through
    film.splat_add_only. progress: callable(step, n_mutations, seconds,
    n) per step."""
    cfg = scene.config
    splat = torch.zeros((cfg.height, cfg.width, 3),
                        device=scene.arrays.device)
    t0 = time.time()
    for it, (splats, _) in enumerate(steps):
        for pos, rgb in splats:
            splat = film_mod.splat_add_only(scene.film, pos, rgb, splat)
        if progress is not None:
            progress(it + 1, n_mutations, time.time() - t0, float(n))
        t0 = time.time()
    return splat


def render_pssmlt(scene, n_chains: int = 1 << 14, n_mutations: int = 64,
                  p_large: float = 0.3, sigma: float = 0.014, seed: int = 0,
                  progress=None):
    """Metropolis render: n_chains chains x n_mutations steps; p_large the
    large-step probability, sigma the small step's size. Returns the
    [H, W, 3] image (the splats scaled by b W H / (n_chains
    n_mutations)). progress: callable(step, n_mutations, seconds,
    n_chains) per step."""
    cfg = scene.config
    b, _, steps = pssmlt_chains(scene, n_chains, n_mutations, p_large,
                                sigma, seed)
    splat = splat_chains(scene, steps, n_mutations, n_chains, progress)
    return splat * (b * (cfg.width * cfg.height) / (n_chains * n_mutations))
