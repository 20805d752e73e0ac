"""Furball inverse rendering on the card (the twin of
examples/inverse_furball.py): fit the Marschner hair absorption (sigma_a)
and longitudinal roughness (beta_R) to a target image rendered with the
true parameters. Gradients flow through the whole wavefront path tracer
and the azimuthal tables' precompute.

    python3 -m hairpt_torch.tools.inverse_furball [--steps 24] [--res 256]
        [--fibers 6000] [--spp 2] [--depth 3] [--sun-scale 3.0]
        [--no-antithetic] [--log FILE] [--device cuda|cpu]

The scene, defaults and log format are the example's: a faithful-mode
MARSCHNER furball (6,000 fibers x 8 segments), the padded Sobol'
sampler, the cross loss, antithetic BSDF-sample pairing, Adam under a
cosine decay; the recovered parameters are tail-averaged over the last
third of the steps. Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import datetime
import sys

import numpy as np

TRUE_PARAMS = {"sigma_a": [[0.9, 0.45, 0.25]], "beta_r": [0.16]}
START_PARAMS = {"sigma_a": [[0.5, 0.5, 0.5]], "beta_r": [0.10]}


def build_scene(res: int, fibers: int, depth: int, sun_scale: float,
                device):
    from hairpt_torch.core import rng
    from hairpt_torch.core.math import matrix_lookat
    from hairpt_torch.film.film import Film
    from hairpt_torch.models import emitters as em
    from hairpt_torch.models.bsdf import registry as mat
    from hairpt_torch.models.sensors import Camera
    from hairpt_torch.scene import hairgen
    from hairpt_torch.scene.scene import SceneBuilder

    b = SceneBuilder(device=device)
    m = b.add_material(kind=mat.MARSCHNER, sigma_a=(0.5, 0.5, 0.5),
                       beta_r=0.1, eta=1.55, alpha=0.2,
                       diffuse=(0.143016, 0.0156076, 1.80928e-05))
    b.add_fibers(hairgen.gen_furball(n_fibers=fibers, n_segs=8, radius=0.02,
                                     seed=1, center=(0, 0, 0), core_r=0.6,
                                     fiber_len=0.8), m)
    b.env = em.bake_sunsky((0.19, 0.758, -0.623), turbidity=3.0,
                           sky_scale=5.0, sun_scale=sun_scale,
                           sun_radius_scale=37.9165, res=64,
                           device=b.device)
    cam = Camera.perspective(
        matrix_lookat((0, 0.5, -3.2), (0, 0, 0), (0, 1, 0)), 35.0, res, res)
    return b.build(cam, Film.make(res, res, "tent"), spp=1, max_depth=depth,
                   sampler=rng.SOBOL)


def run(args) -> dict:
    """The fit. Returns the losses, the trace, the tail-averaged and final
    parameters and the true ones (numpy)."""
    import torch
    from hairpt_torch.integrators import inverse

    scene = build_scene(args.res, args.fibers, args.depth, args.sun_scale,
                        args.device)
    dev = scene.arrays.hair.p0.device
    true_params = {k: torch.tensor(v, device=dev)
                   for k, v in TRUE_PARAMS.items()}
    sa_t = np.asarray(TRUE_PARAMS["sigma_a"][0], np.float32)
    br_t = float(np.float32(TRUE_PARAMS["beta_r"][0]))
    print(f"rendering target with true params sigma_a={sa_t} "
          f"beta_r={br_t:.3f}", file=sys.stderr)
    with torch.no_grad():
        target = inverse.render_image(scene, true_params, spp=args.spp * 2)
    params0 = {k: torch.tensor(v, device=dev)
               for k, v in START_PARAMS.items()}
    params, losses = inverse.fit(scene, target, params0, steps=args.steps,
                                 lr=0.05, spp=args.spp, verbose=True,
                                 loss_kind="cross",
                                 antithetic=not args.no_antithetic)
    # tail-averaged estimate: the MC gradient noise makes the late
    # iterates a random walk around the optimum; the mean of the last
    # third is the low-variance readout (Polyak-style)
    trace = inverse.fit.last_trace
    tail = trace[len(trace) * 2 // 3:]
    return dict(
        losses=losses, trace=trace,
        sigma_a=np.mean([t["sigma_a"][0] for t in tail], axis=0),
        beta_r=float(np.mean([t["beta_r"][0] for t in tail])),
        sigma_a_final=params["sigma_a"].cpu().numpy()[0],
        beta_r_final=float(params["beta_r"].cpu().numpy()[0]),
        sigma_a_true=sa_t, beta_r_true=br_t,
        backend=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"))


def write_log(path, args, r):
    sa, br, sa_t, br_t = (r["sigma_a"], r["beta_r"], r["sigma_a_true"],
                          r["beta_r_true"])
    saf, brf = r["sigma_a_final"], r["beta_r_final"]
    with open(path, "w") as f:
        f.write("# furball inverse rendering (BASELINE.json config 5)\n")
        f.write(f"# {datetime.datetime.now().isoformat()} backend="
                f"{r['backend']} res={args.res} fibers={args.fibers} "
                f"spp={args.spp} depth={args.depth} steps={args.steps}\n")
        f.write("# loss curve (two-sample cross loss per step)\n")
        for i, loss in enumerate(r["losses"]):
            f.write(f"step {i:3d}  loss {loss:.6f}\n")
        f.write("# recovered (tail-averaged over the last third of steps) "
                "vs true\n")
        f.write(f"sigma_a  recovered {sa[0]:.4f} {sa[1]:.4f} {sa[2]:.4f}"
                f"   true {sa_t[0]:.4f} {sa_t[1]:.4f} {sa_t[2]:.4f}\n")
        f.write(f"beta_r   recovered {br:.4f}           true "
                f"{br_t:.4f}\n")
        f.write(f"# final-step params: sigma_a {saf[0]:.4f} {saf[1]:.4f} "
                f"{saf[2]:.4f}, beta_r {brf:.4f}\n")
        f.write("# estimator: antithetic BSDF-sample pairing "
                f"{'ON' if not args.no_antithetic else 'OFF'} "
                "(see inverse.make_render_fn)\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--fibers", type=int, default=6000)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--sun-scale", type=float, default=3.0,
                    help="sun radiance scale; the reference furball's "
                         "19.1 makes firefly paths dominate gradient "
                         "variance at low spp, 3.0 keeps the 24-step "
                         "budget convergent")
    ap.add_argument("--no-antithetic", action="store_true",
                    help="disable the antithetic BSDF-sample pairing")
    ap.add_argument("--log", type=str, default=None,
                    help="write the loss curve and the recovered-vs-true "
                         "table to this file")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    r = run(args)
    print(f"recovered sigma_a = {r['sigma_a']} (final {r['sigma_a_final']}, "
          f"true {r['sigma_a_true']})")
    print(f"recovered beta_r  = {r['beta_r']:.3f} (final "
          f"{r['beta_r_final']:.3f}, true {r['beta_r_true']:.3f})")
    print(f"loss: {r['losses'][0]:.5f} -> {r['losses'][-1]:.5f}")
    if args.log:
        write_log(args.log, args, r)
        print(f"wrote {args.log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
