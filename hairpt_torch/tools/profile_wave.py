"""Where a wave's time goes: one full-width furball wave under
torch.profiler, on the card.

    python3 -m hairpt_torch.tools.profile_wave [--depth 65] [--res 1024]
        [--traversal tiled|swept] [--out FILE]

Renders one warm-up wave, then profiles one wave with CPU and CUDA
activities. The port's layers are marked as profiler ranges from the
outside, so the port's own code carries no instrumentation: for the
tiled traversal phase A, routing, phase B and the Morton sort; for the
swept traversal its phase A (plain torch), the pair routing, the chunk
gather and phase B (kernel E). Prints the wave's wall time, the summed
device kernel time and the idle share, the device time under each
range, and the kernels with the most device time.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=65)
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--quality", type=float, default=14.0)
    ap.add_argument("--traversal", default="tiled",
                    choices=("tiled", "swept"))
    ap.add_argument("--out", default=None,
                    help="also write the report to this file")
    args = ap.parse_args(argv)

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
                  ("phase_a", iswept, "_phase_a_dense"),
                  ("routing", iswept, "_route_pairs"),
                  ("chunk_rays", iswept, "_chunk_rays"),
                  ("phase_b", pk, "phase_b_chunks"))
    else:
        ranges = (("query", itiled, "_query_chunk"),
                  ("phase_a", tk, "cull_phase_a"),
                  ("routing", itiled, "_tile_slots"),
                  ("phase_b", tk, "phase_b"),
                  ("morton_sort", itiled, "_morton_sort_rays"))
    for label, mod, name in ranges:
        _wrap(mod, name, label)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    scene = furball_scene(quality=args.quality, res=args.res,
                          depth=args.depth, device="cuda",
                          traversal=args.traversal)
    path.render(scene, spp=1, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        path.render(scene, spp=1, seed=1)
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
             f"{args.traversal} wave {args.res}^2 depth {args.depth}: wall "
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
