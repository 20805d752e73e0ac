"""Where a wave's time goes: one full-width furball wave, or one
gradient step, under torch.profiler, on the card.

    python3 -m hairpt_torch.tools.profile_wave [--depth 65] [--res 1024]
        [--traversal tiled|swept] [--mode wave|fwd_bwd|prb] [--out FILE]

--mode fwd_bwd profiles bench.py's train step (the differentiable mode,
mean radiance, a 3-vector diffuse; --depth defaults to 16 there) with a
range around its backward pass; --mode prb one path-replay-backprop step
(nee_rr 0) with a range around its primal forward pass. Runs one
warm-up wave or step, then profiles one with CPU and CUDA activities.
The port's layers are marked as profiler ranges from the outside, so
the port's own code carries no instrumentation: for the
tiled traversal phase A, routing, phase B and the Morton sort; for the
swept traversal its phase A (the swept phase-A kernel's wrapper) and,
inside it, the ray order it takes its tiles in, the pair routing, the
chunk gather and phase B (kernel E). Prints the wave's wall time, the
summed device kernel time and the idle share, the device time under
each range, and the kernels with the most device time.
"""
from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time


def _wrap(mod, name, label):
    import torch
    fn = getattr(mod, name)

    @functools.wraps(fn)
    def inner(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    setattr(mod, name, inner)


def _step(mode, scene):
    """run(sample): one wave, fwd+bwd step or PRB step of the scene."""
    import torch
    from hairpt_torch.integrators import inverse, path

    cfg = scene.config
    n = cfg.width * cfg.height
    dev = scene.arrays.hair.p0.device
    pix = torch.arange(n, device=dev)
    p0 = torch.tensor((0.143016, 0.0156076, 1.80928e-05), device=dev)
    mats = scene.arrays.materials
    if mode == "wave":
        return lambda s: path.render(scene, spp=1, seed=s)
    if mode == "prb":
        f = inverse.make_prb_loss_grad(scene)
        return lambda s: f(scene.arrays,
                           {"diffuse": p0.expand_as(mats.diffuse)}, pix,
                           torch.full_like(pix, s))
    li = path.make_li_fn(scene, differentiable=True)

    def fwd_bwd(s):
        p = p0.clone().requires_grad_()
        arr = scene.arrays._replace(materials=mats._replace(
            diffuse=p.expand_as(mats.diffuse)))
        rad, _, _ = li(arr, pix, torch.full_like(pix, s))
        torch.nan_to_num(rad, nan=0.0, posinf=0.0, neginf=0.0) \
            .mean().backward()
        return p.grad
    return fwd_bwd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=None,
                    help="65, or 16 for --mode fwd_bwd")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--quality", type=float, default=14.0)
    ap.add_argument("--traversal", default="tiled",
                    choices=("tiled", "swept"))
    ap.add_argument("--mode", default="wave",
                    choices=("wave", "fwd_bwd", "prb"))
    ap.add_argument("--out", default=None,
                    help="also write the report to this file")
    args = ap.parse_args(argv)
    if args.depth is None:
        args.depth = 16 if args.mode == "fwd_bwd" else 65

    import torch
    if not torch.cuda.is_available():
        print("profile_wave: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import intersect_swept as iswept
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import phaseb_kernels as pk
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene.furball import furball_scene

    if args.traversal == "swept":
        ranges = (("query", iswept, "swept_closest_hit"),
                  ("phase_a", pk, "swept_phase_a"),
                  ("tile_order", pk, "tile_order"),
                  ("routing", iswept, "_route_pairs"),
                  ("chunk_rays", iswept, "_chunk_rays"),
                  ("phase_b", pk, "phase_b_chunks"))
    else:
        ranges = (("query", itiled, "_query_chunk"),
                  ("phase_a", tk, "cull_phase_a"),
                  ("routing", itiled, "_tile_slots"),
                  ("phase_b", tk, "phase_b"),
                  ("morton_sort", itiled, "_morton_sort_rays"))
    if args.mode == "fwd_bwd":
        ranges += (("backward", torch.Tensor, "backward"),)
    for label, mod, name in ranges:
        _wrap(mod, name, label)
    if args.mode == "prb":
        # PRB's primal pass is the forward estimator make_li_fn returns
        made = path.make_li_fn

        def make_ranged(*a, **k):
            li = made(*a, **k)

            def ranged(*la, **lk):
                with torch.profiler.record_function("primal"):
                    return li(*la, **lk)
            return ranged
        path.make_li_fn = make_ranged
        ranges += (("primal", None, None),)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    scene = furball_scene(quality=args.quality, res=args.res,
                          depth=args.depth, device="cuda",
                          traversal=args.traversal,
                          nee_rr=0.0 if args.mode == "prb" else 0.01)
    run = _step(args.mode, scene)
    run(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(1)
        torch.cuda.synchronize()
        wall = time.time() - t0
    ev = prof.key_averages()
    labels = tuple(label for label, _, _ in ranges)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    # kernels: device-side events other than the range annotations (host
    # ops also report their kernels' time and would count it twice)
    kernels = [e for e in ev if on_device(e) and e.key not in labels
               and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    lines = [smi,
             f"{args.traversal} {args.mode} {args.res}^2 depth "
             f"{args.depth}: wall "
             f"{wall:.3f} s "
             f"(under the profiler), device kernel time {busy:.3f} s, "
             f"idle share {max(0.0, 1 - busy / wall):.3f}"]
    for label in labels:
        host = sum(e.cpu_time_total for e in ev
                   if e.key == label and not on_device(e))
        dev = sum(dev_us(e) for e in ev if e.key == label and on_device(e))
        calls = max([e.count for e in ev if e.key == label], default=0)
        lines.append(f"range {label:12s} calls {calls:6d}  device "
                     f"{dev / 1e3:10.1f} ms  host {host / 1e3:10.1f} ms")
    lines.append("kernels by device time:")
    for e in sorted(kernels, key=dev_us, reverse=True)[:25]:
        lines.append(f"  {dev_us(e) / 1e3:10.1f} ms  {e.count:7d}x  "
                     f"{e.key[:100]}")
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
