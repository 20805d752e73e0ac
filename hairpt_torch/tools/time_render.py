"""Seconds per wave and Mrays/s of the full-width furball render, or of
a mesh stand-in's, on the card.

    python3 -m hairpt_torch.tools.time_render [--traversal tiled|swept]
        [--material roughplastic|marschner] [--waves 2] [--res 1024]
        [--depth 65] [--scene furball|teapot|instanced] [--label NAME]

Builds the furball through SceneBuilder (or loads the teapot or the
instanced stand-in of scene/scene_xmls.py at 1280 x 720, written into a
temporary directory), renders one warm-up wave, then
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
    ap.add_argument("--scene", default="furball",
                    choices=("furball", "teapot", "instanced"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_render: needs a CUDA card", file=sys.stderr)
        return 2
    import hairpt_torch
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import intersect_packed as ipk
    from hairpt_torch.ops import phaseb_kernels as pk
    from hairpt_torch.ops import tiled_kernels as tk
    from hairpt_torch.scene.furball import furball_scene
    counters = [tk, pk, ipk]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    kw = {} if args.traversal == "tiled" else {"traversal": args.traversal}
    if args.material != "roughplastic":
        kw["material"] = args.material
    if args.scene == "furball":
        scene = furball_scene(res=args.res, depth=args.depth, device="cuda",
                              **kw)
    else:
        import tempfile
        from hairpt_torch.scene import scene_xmls
        from hairpt_torch.scene.xml_loader import load_scene
        if args.scene == "instanced":
            from hairpt_torch.ops import instancing
            counters.append(instancing)
        with tempfile.TemporaryDirectory() as tmp:
            scene = load_scene(scene_xmls.write_scene(tmp, args.scene),
                               spp_override=1, max_depth_override=args.depth,
                               device="cuda")
    times, rays = [], []

    def progress(done, total, secs, n_rays):
        times.append(secs)
        rays.append(n_rays)

    path.render(scene, spp=1, seed=0, progress=progress)
    times.clear()
    rays.clear()
    for c in counters:
        c.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    img = path.render(scene, spp=args.waves, seed=1, progress=progress)
    torch.cuda.synchronize()
    secs = (time.time() - t0) / args.waves
    rays_w = sum(rays) / len(rays)
    print(json.dumps({
        "label": args.label, "package": hairpt_torch.__file__,
        "card": smi, "scene": args.scene, "traversal": args.traversal,
        "material": args.material, "res": args.res,
        "depth": args.depth, "waves": args.waves, "s_per_wave": secs,
        "wave_seconds": times, "rays_per_wave": rays_w,
        "mrays_per_s": rays_w / secs / 1e6,
        "image_mean": float(img.mean()),
        "launches": {k: v for c in counters for k, v in c.LAUNCHES.items()},
        "plain_on_cuda": {k: v for c in counters
                          for k, v in c.PLAIN_ON_CUDA.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
