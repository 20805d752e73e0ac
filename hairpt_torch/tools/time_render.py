"""Seconds per wave and Mrays/s of the full-width furball render, on the
card.

    python3 -m hairpt_torch.tools.time_render [--traversal tiled|swept]
        [--material roughplastic|marschner] [--waves 2] [--res 1024]
        [--depth 65] [--label NAME]

Builds the furball through SceneBuilder, renders one warm-up wave, then
times `--waves` 1-spp waves (host clock around torch.cuda.synchronize(),
rays counted as path.render counts them) and prints one JSON line with
the card's name and power limit, s/wave, rays/wave, Mrays/s, the image
mean and the kernels' launches over the timed waves. To time another
checkout of the package on the same card, run this file with that
checkout first on PYTHONPATH (the default traversal and material use
only what every version of the package has).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traversal", default="tiled",
                    choices=("tiled", "swept"))
    ap.add_argument("--material", default="roughplastic",
                    choices=("roughplastic", "marschner"))
    ap.add_argument("--waves", type=int, default=2)
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=65)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_render: needs a CUDA card", file=sys.stderr)
        return 2
    import hairpt_torch
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import phaseb_kernels as pk
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene.furball import furball_scene

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    kw = {} if args.traversal == "tiled" else {"traversal": args.traversal}
    if args.material != "roughplastic":
        kw["material"] = args.material
    scene = furball_scene(res=args.res, depth=args.depth, device="cuda",
                          **kw)
    times, rays = [], []

    def progress(done, total, secs, n_rays):
        times.append(secs)
        rays.append(n_rays)

    path.render(scene, spp=1, seed=0, progress=progress)
    times.clear()
    rays.clear()
    tk.reset_counts()
    pk.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    img = path.render(scene, spp=args.waves, seed=1, progress=progress)
    torch.cuda.synchronize()
    secs = (time.time() - t0) / args.waves
    rays_w = sum(rays) / len(rays)
    print(json.dumps({
        "label": args.label, "package": hairpt_torch.__file__,
        "card": smi, "traversal": args.traversal,
        "material": args.material, "res": args.res,
        "depth": args.depth, "waves": args.waves, "s_per_wave": secs,
        "wave_seconds": times, "rays_per_wave": rays_w,
        "mrays_per_s": rays_w / secs / 1e6,
        "image_mean": float(img.mean()),
        "launches": dict(tk.LAUNCHES, **pk.LAUNCHES),
        "plain_on_cuda": dict(tk.PLAIN_ON_CUDA, **pk.PLAIN_ON_CUDA)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
