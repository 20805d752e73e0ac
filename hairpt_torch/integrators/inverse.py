"""Inverse rendering: fit material parameters to a target image (port of
hairpt/integrators/inverse.py).

Gradients of pixel values with respect to the material table flow
through the differentiable render (path.make_li_fn(differentiable=True))
or through path-replay backprop (prb.py). A parameter replaces its
table field as it is; sigma_a, beta_r and eta also rebuild the Marschner
azimuthal tables of the scene's Marschner rows (recompute_hair_tables),
so their gradients reach the tables' differentiable precompute. The
fields derived from eta at build time (ext_trans, int_fdr) are not
recomputed, as in the JAX package.
"""
from __future__ import annotations

import glob
import math
import os
import time

import numpy as np
import torch

from ..film import film as film_mod
from ..models.bsdf import hair as hair_bsdf
from . import path as path_int
from . import prb

_HAIR_PARAMS = {"sigma_a", "beta_r", "eta"}


def recompute_hair_tables(materials, marschner_rows):
    """Rebuild the Marschner azimuthal tables from the (possibly updated)
    material parameters: differentiable with respect to sigma_a, beta_r
    and eta; the sampling tables are built from detached values."""
    if not marschner_rows:
        return None
    return hair_bsdf.hair_tables(torch.stack([
        hair_bsdf.precompute_azimuthal(materials.sigma_a[r],
                                       materials.beta_r[r],
                                       materials.eta[r])
        for r in marschner_rows]))


def apply_params_arrays(arrays, params: dict, marschner_rows):
    """The scene arrays with material-table fields replaced by `params`
    (keys: float fields of the table, e.g. 'diffuse', 'alpha', 'eta',
    'sigma_a', 'beta_r'). sigma_a, beta_r and eta rebuild the hair tables
    of marschner_rows (Scene.marschner_rows)."""
    fields = [f for g, f in prb.float_theta(arrays) if g == "materials"]
    unknown = [k for k in params if k not in fields]
    if unknown:
        raise KeyError(f"{unknown} are not float fields of the material "
                       f"table ({sorted(fields)})")
    mats = arrays.materials._replace(**params)
    ht = arrays.hair_tables
    if marschner_rows and (_HAIR_PARAMS & set(params)):
        ht = recompute_hair_tables(mats, marschner_rows)
    return arrays._replace(materials=mats, hair_tables=ht)


def apply_params(scene, params: dict):
    return apply_params_arrays(scene.arrays, params, scene.marschner_rows)


def make_prb_loss_grad(scene, loss_fn=None):
    """Path-replay-backprop loss and gradient at the params level: O(1)
    memory in depth, so gradients run at the workload's depth 65.

    Returns f(arrays_base, params, pixel_idx, sample_idx, *loss_args)
        -> (loss, d_params): PRB's gradient with respect to the material
    fields and the hair tables, carried back through apply_params_arrays
    (the tables' precompute included) to each entry of `params` (for
    example a [3] diffuse broadcast over the table, or sigma_a)."""
    gradf = prb.make_prb_grad_fn(scene, loss_fn=loss_fn)
    rows = scene.marschner_rows

    def f(arrays_base, params, pixel_idx, sample_idx, *loss_args):
        names = list(params)
        dev = arrays_base.device
        with torch.enable_grad():
            p = {k: torch.as_tensor(params[k], device=dev).detach()
                 .requires_grad_() for k in names}
            theta = prb.float_theta(apply_params_arrays(arrays_base, p,
                                                        rows))
        outs = [k for k in theta if theta[k].requires_grad]
        arrs = prb.with_theta(arrays_base, {
            k: v.detach().requires_grad_(k in outs)
            for k, v in theta.items()})
        (loss, _), d_theta = gradf(arrs, pixel_idx, sample_idx, *loss_args)
        d = torch.autograd.grad([theta[k] for k in outs],
                                [p[k] for k in names],
                                grad_outputs=[d_theta[k] for k in outs],
                                allow_unused=True)
        return loss, {k: torch.zeros_like(p[k]) if g is None else g
                      for k, g in zip(names, d)}

    return f


def make_render_fn(scene, spp: int, antithetic=False):
    """A differentiable renderer: render(arrays_base, params, seed) ->
    image [H, W, 3]. Lanes in plain pixel order, sample index s +
    seed * 65536 for s < spp.

    antithetic: each sample index also renders the (u, 1 - u)-mirrored
    BSDF sample dims and splats both (two waves per sample)."""
    lis = [path_int.make_li_fn(scene, differentiable=True)]
    if antithetic:
        lis.append(path_int.make_li_fn(scene, differentiable=True,
                                       antithetic=antithetic))
    cfg = scene.config
    n_pix = cfg.width * cfg.height
    fl = scene.film
    rows = scene.marschner_rows

    def render(arrays_base, params, seed: int):
        arrays = apply_params_arrays(arrays_base, params, rows)
        dev = arrays.device
        image, weight = film_mod.zeros(fl, dev)
        pixel_idx = torch.arange(n_pix, device=dev)
        for s in range(spp):
            sample_idx = torch.full((n_pix,), s + seed * 65536,
                                    dtype=torch.int64, device=dev)
            for li in lis:
                radiance, pos, _ = li(arrays, pixel_idx, sample_idx)
                radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0,
                                            neginf=0.0)
                image, weight = film_mod.splat_samples(fl, pos, radiance,
                                                       image, weight)
        return film_mod.develop(image, weight)

    return render


def render_image(scene, params: dict, spp: int, seed: int = 0):
    """Differentiable low-spp render with the given parameter overrides."""
    return make_render_fn(scene, spp)(scene.arrays, params, seed)


def loss_fn(scene, params: dict, target, spp: int, seed: int = 0):
    img = render_image(scene, params, spp, seed)
    return torch.mean((img - target) ** 2)


def cosine_decay(lr: float, horizon: int, alpha: float = 0.1):
    """optax.cosine_decay_schedule(lr, horizon, alpha) as a function of
    the step: lr down to alpha * lr over `horizon` steps, then flat."""
    horizon = max(horizon, 1)

    def schedule(step: int) -> float:
        c = 0.5 * (1.0 + math.cos(math.pi * min(step, horizon) / horizon))
        return lr * ((1.0 - alpha) * c + alpha)
    return schedule


def _blurred_norm(target):
    """1 / (t^2 + 1e-2) of the target box-blurred 16 times: the weight of
    the 'cross' loss. The blur keeps the dark regions' weight and
    decorrelates it from the per-pixel noise of the residual."""
    tb = np.asarray(target.detach().cpu(), np.float64)
    for _ in range(16):
        tb = (tb + np.roll(tb, 1, 0) + np.roll(tb, -1, 0)
              + np.roll(tb, 1, 1) + np.roll(tb, -1, 1)) / 5.0
    return torch.as_tensor(1.0 / (tb ** 2 + 1e-2), dtype=torch.float32,
                           device=target.device)


def _checkpoints(ckdir):
    """(step, path) of each checkpoint in ckdir, oldest first."""
    out = []
    for path in glob.glob(os.path.join(ckdir, "step_*.pt")):
        out.append((int(os.path.basename(path)[5:-3]), path))
    return sorted(out)


def fit(scene, target, params0: dict, steps: int = 32, lr: float = 0.05,
        spp: int = 2, verbose: bool = False,
        checkpoint_dir: str | None = None, checkpoint_every: int = 8,
        loss_kind: str = "mse", decay_steps: int | None = None,
        antithetic=False):
    """Adam over the selected parameters under a cosine decay of the
    learning rate to lr / 10. Returns (params, losses).

    loss_kind: 'mse'; 'relative' (per-pixel MSE over the detached
    image's square + 1e-2); 'cross' (E[(A - t)(B - t)] of two independent
    renders of spp // 2 each, weighted by _blurred_norm(target)).

    checkpoint_dir: params, optimizer state, step, the decay horizon and
    the losses so far are saved with torch.save every `checkpoint_every`
    steps and after the last; a call that finds a checkpoint there
    resumes after its step, on the saved horizon unless decay_steps is
    given, and returns the saved losses with the new ones."""
    if loss_kind not in ("mse", "relative", "cross"):
        raise ValueError(f"loss_kind {loss_kind!r}")
    dev = scene.arrays.device
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              .detach().clone().requires_grad_() for k, v in params0.items()}
    names = list(params)

    start, horizon, losses, saved = 0, None, [], None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        found = _checkpoints(checkpoint_dir)
        if found:
            saved = torch.load(found[-1][1], map_location=dev,
                               weights_only=True)
            start = int(saved["step"]) + 1
            horizon = int(saved["horizon"])
            losses = list(saved["losses"])
            with torch.no_grad():
                for k in names:
                    params[k].copy_(saved["params"][k])
    if decay_steps is not None:
        horizon = decay_steps
    elif horizon is None:
        horizon = steps
    schedule = cosine_decay(lr, horizon, alpha=0.1)
    opt = torch.optim.Adam([params[k] for k in names], lr=lr)
    if saved is not None:
        opt.load_state_dict(saved["opt_state"])
    for group in opt.param_groups:
        group["lr"] = schedule(start)

    render = make_render_fn(scene, max(1, spp // 2) if loss_kind == "cross"
                            else spp, antithetic=antithetic)
    wnorm = _blurred_norm(target) if loss_kind == "cross" else None
    arrays_base = scene.arrays
    trace = []
    for i in range(start, steps):
        t0 = time.time()
        if loss_kind == "cross":
            a = render(arrays_base, params, i * 2)
            b = render(arrays_base, params, i * 2 + 1)
            loss = torch.mean((a - target) * (b - target) * wnorm)
        else:
            img = render(arrays_base, params, i)
            d2 = (img - target) ** 2
            if loss_kind == "relative":
                d2 = d2 / (img.detach() ** 2 + 1e-2)
            loss = torch.mean(d2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            # one degenerate sample can poison the whole gradient with a
            # NaN, and Adam's state with it for good
            for k in names:
                g = params[k].grad
                if g is None:
                    params[k].grad = torch.zeros_like(params[k])
                else:
                    g.copy_(torch.nan_to_num(g, nan=0.0, posinf=0.0,
                                             neginf=0.0))
            opt.step()
            # physical clamps
            for k, lo, hi in (("sigma_a", 0.0, 10.0), ("beta_r", 0.02, 1.0),
                              ("diffuse", 0.0, 1.0)):
                if k in params:
                    params[k].clamp_(lo, hi)
        for group in opt.param_groups:
            group["lr"] = schedule(i + 1)
        losses.append(float(loss.detach()))
        trace.append({k: params[k].detach().cpu().numpy().copy()
                      for k in names})
        if verbose:
            print(f"step {i}: loss {losses[-1]:.6f} "
                  f"({time.time() - t0:.1f}s)")
        if checkpoint_dir and ((i + 1) % checkpoint_every == 0
                               or i == steps - 1):
            torch.save({"params": {k: params[k].detach() for k in names},
                        "opt_state": opt.state_dict(), "step": i,
                        "horizon": horizon, "losses": losses},
                       os.path.join(checkpoint_dir, f"step_{i}.pt"))
            for _, old in _checkpoints(checkpoint_dir)[:-2]:
                os.remove(old)
    fit.last_trace = trace
    return {k: params[k].detach() for k in names}, losses
