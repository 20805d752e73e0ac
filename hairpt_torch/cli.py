"""Headless renderer CLI (port of hairpt/cli.py's render command;
counterpart of the reference's `mitsuba` executable).

    python -m hairpt_torch.cli render scene.xml -o out.png [-D key=value]
        [--spp N] [--res-scale S] [--hair-quality Q] [--depth D]
        [--seed S] [-v|-q] [-l log] [-w] [--cpu] [-r SEC]
        [--checkpoint F.npz] [-x] [--progress]

Loads a scene XML (scene/xml_loader.py: the hair scenes), renders it with
the path integrator, or with the one the XML's <integrator> or
--integrator names, as the JAX package's CLI dispatches them: volpath
(volpath_simple = volpath), ptracer, bdpt, vpl, ppm (photonmapper = ppm;
in a scene with a medium the volumetric photon map), sppm, direct, ao,
irrcache, erpt, pssmlt, mlt (path-space MLT), motion (the motion-vector
AOV, in the XML's path configuration), adaptive, multichannel (the
radiance image, and each other channel as <base>.<channel>.npy beside it)
and field:<name> (one of aux_integrators.FIELDS; field alone is
shNormal); --spectral N
renders N wavelength bins (--dispersion B: Cauchy dispersion of every
eta) whatever the integrator. It runs on the card, or on the CPU with
--cpu (the plain versions of the kernels), and writes the image named by
-o (.png, .exr, .bmp or .tga) with .exr, .npy and .pfm of the linear
radiance beside it. A scene with a dipole subsurface material gets its
irradiance prepass (integrators/sss.attach_dipole) before the render.
Without --cpu a machine with no card exits non-zero before loading
anything. What the port does not render raises NotImplementedError
naming its ROADMAP item: the --bands, --profile and --stats options,
JPEG output and the util and import commands.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ITEM_13 = "ROADMAP item 13"
INTEGRATORS = ("path", "volpath", "volpath_simple", "ptracer", "bdpt",
               "vpl", "photonmapper", "ppm", "sppm", "direct", "ao",
               "irrcache", "erpt", "pssmlt", "mlt", "motion", "adaptive",
               "multichannel", "field")
# the JAX package's CLI aliases
ALIASES = {"volpath_simple": "volpath", "photonmapper": "ppm"}


def _refuse(what: str):
    raise NotImplementedError(f"{what} is not ported yet ({ITEM_13})")


def _parser():
    ap = argparse.ArgumentParser(prog="hairpt_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render")
    r.add_argument("scene")
    r.add_argument("-o", "--output", default=None)
    r.add_argument("-D", "--define", action="append", default=[])
    r.add_argument("--spp", type=int, default=None)
    r.add_argument("--res-scale", type=float, default=1.0)
    r.add_argument("--hair-quality", type=float, default=1.0)
    r.add_argument("--depth", type=int, default=None)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--stats", action="store_true",
                   help="the render-statistics table (not ported)")
    r.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v debug, -vv trace (mitsuba -v)")
    r.add_argument("-q", "--quiet", action="store_true",
                   help="warnings and errors only")
    r.add_argument("-l", "--log", default=None,
                   help="also append the log to this file")
    r.add_argument("-w", "--warn-error", action="store_true",
                   help="treat warnings as errors (mitsuba -w)")
    r.add_argument("--cpu", action="store_true",
                   help="render on the CPU with the kernels' plain "
                        "versions (the default is the card)")
    r.add_argument("-r", "--refresh", type=float, default=0.0,
                   help="write the partial image every N seconds "
                        "(mitsuba -r)")
    r.add_argument("--checkpoint", default=None,
                   help="npz film checkpoint: saved per wave, resumed if "
                        "present (exact accumulator resume)")
    r.add_argument("-x", "--skip-existing", action="store_true",
                   help="skip the render if the output exists (mitsuba -x)")
    r.add_argument("--progress", action="store_true",
                   help="per-wave progress and ETA")
    r.add_argument("--profile", default=None,
                   help="a profiler trace (not ported)")
    r.add_argument("--bands", type=int, default=0,
                   help="out-of-core banded render (not ported)")
    r.add_argument("--spectral", type=int, default=0, metavar="N",
                   help="render with N spectral bins (a multiple of 3) "
                        "instead of RGB")
    r.add_argument("--dispersion", type=float, default=0.0,
                   help="Cauchy B coefficient (um^2) of dielectric "
                        "dispersion in --spectral mode (0.0042: BK7)")
    r.add_argument("--integrator", default=None,
                   help=", ".join(INTEGRATORS) + ", field:<name> (default: "
                        "the scene XML's)")
    for name in ("util", "import"):
        u = sub.add_parser(name, help="not ported")
        u.add_argument("args", nargs="*")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.cmd != "render":
        _refuse(f"the {args.cmd} command")

    from .utils import log as log_mod
    logger = log_mod.setup(verbosity=args.verbose, quiet=args.quiet,
                           logfile=args.log,
                           warnings_as_errors=args.warn_error)

    if args.bands > 0:
        _refuse("the banded render (--bands)")
    if args.profile:
        _refuse("--profile")
    if args.stats:
        _refuse("--stats")
    if args.integrator is not None \
            and args.integrator.split(":", 1)[0] not in INTEGRATORS:
        _refuse(f"the {args.integrator} integrator")
    out = args.output or "output.png"
    base, ext = out.rsplit(".", 1) if "." in os.path.basename(out) \
        else (out, "png")
    ext = ext.lower()
    if ext in ("jpg", "jpeg"):
        _refuse("JPEG output")

    import torch
    if not args.cpu and not torch.cuda.is_available():
        logger.error("no CUDA card (torch.cuda.is_available() is False); "
                     "pass --cpu to render on the CPU")
        return 2
    device = "cpu" if args.cpu else "cuda"

    from .integrators import path as path_int
    from .scene.xml_loader import load_scene
    from .utils import exr as exr_utils
    from .utils import io as io_utils

    defines = dict(d.split("=", 1) for d in args.define)
    t0 = time.time()
    scene = load_scene(args.scene, defines, spp_override=args.spp,
                       res_scale=args.res_scale,
                       hair_quality=args.hair_quality,
                       max_depth_override=args.depth, device=device)
    t1 = time.time()
    logger.info("scene built in %.2fs (%dx%d @ %dspp, depth %d)",
                t1 - t0, scene.config.width, scene.config.height,
                scene.config.spp, scene.config.max_depth)

    if args.skip_existing and os.path.exists(out):
        logger.info("output %s exists, skipping (-x)", out)
        return 0

    elapsed = [0.0]

    def _progress(done, total, secs, n_rays):
        elapsed[0] += secs
        eta = elapsed[0] / max(done, 1) * (total - done)
        logger.info("wave %d/%d (%.1fs elapsed, ETA %.1fs)", done, total,
                    elapsed[0], eta)

    def _flush(partial):
        io_utils.write_png(base + ".partial.png",
                           io_utils.tonemap_srgb(partial.cpu().numpy(),
                                                 scene.film.gamma))
        logger.info("flushed partial image (-r)")

    from .models.bsdf import registry as mat
    if mat.DIPOLE in scene.active_kinds:
        from .integrators.sss import attach_dipole
        scene = attach_dipole(scene)
        logger.info("dipole irradiance prepass done")
    # no --integrator: the scene XML's integrator type
    integ = args.integrator or scene.config.integrator or "path"
    integ = ALIASES.get(integ, integ)
    prog = _progress if args.progress else None
    if args.spectral:
        from .integrators.spectral import render_spectral
        img = render_spectral(scene, n_bins=args.spectral,
                              spp=scene.config.spp, seed=args.seed,
                              cauchy_b=args.dispersion)
    elif integ == "ao":
        from .integrators import aux_integrators as aux
        img = aux.render_ao(scene, spp=scene.config.spp, progress=prog)
    elif integ == "direct":
        from .integrators import aux_integrators as aux
        img = aux.render_direct(scene, seed=args.seed, progress=prog)
    elif integ == "irrcache":
        from .integrators import irrcache
        img = irrcache.render_irrcache(scene, spp=scene.config.spp,
                                       seed=args.seed, progress=prog)
    elif integ == "erpt":
        from .integrators import erpt
        img = erpt.render_erpt(scene, seed=args.seed, progress=prog)
    elif integ == "pssmlt":
        from .integrators import pssmlt
        img = pssmlt.render_pssmlt(scene, seed=args.seed, progress=prog)
    elif integ == "mlt":
        from .integrators import mlt
        img = mlt.render_mlt(scene, seed=args.seed, progress=prog)
    elif integ == "motion":
        from .integrators import motion
        img = motion.render_motion(scene)
    elif integ == "adaptive":
        from .integrators import aux_integrators as aux
        img = aux.render_adaptive(scene, seed=args.seed, progress=prog)
    elif integ == "multichannel":
        from .integrators import aux_integrators as aux
        chans = aux.render_multichannel(scene, spp=scene.config.spp,
                                        seed=args.seed)
        for name, im in chans.items():
            if name != "radiance":
                io_utils.write_npy(f"{base}.{name}.npy", im.cpu().numpy())
        img = chans["radiance"]
    elif integ.startswith("field"):
        from .integrators import aux_integrators as aux
        name = integ.split(":", 1)[1] if ":" in integ else "shNormal"
        img = aux.render_field(scene, name, progress=prog)
    elif integ == "volpath":
        from .integrators import volpath
        img = volpath.render_volpath(scene, spp=scene.config.spp,
                                     seed=args.seed, progress=prog)
    elif integ == "ptracer":
        from .integrators import ptracer
        img = ptracer.render_ptracer(scene, seed=args.seed, progress=prog)
    elif integ == "bdpt":
        from .integrators import bdpt
        img = bdpt.render_bdpt(scene, spp=scene.config.spp, seed=args.seed,
                               progress=prog)
    elif integ == "vpl":
        from .integrators import vpl
        img = vpl.render_vpl(scene, spp=scene.config.spp, seed=args.seed,
                             progress=prog)
    elif integ == "ppm":
        from .integrators import photonmap
        if scene.medium is not None:
            # a scene medium: the beam radiance estimate (photonmapper/
            # bre.cpp)
            img = photonmap.render_volumetric_photonmap(
                scene, seed=args.seed, progress=prog)
        else:
            img = photonmap.render_ppm(scene, seed=args.seed, progress=prog)
    elif integ == "sppm":
        from .integrators import photonmap
        img = photonmap.render_sppm(scene, seed=args.seed, progress=prog)
    else:
        img = path_int.render(scene, seed=args.seed,
                              progress=prog, flush_every=args.refresh,
                              flush_cb=_flush if args.refresh > 0 else None,
                              checkpoint=args.checkpoint)
    img = img.cpu().numpy()
    t2 = time.time()
    n_rays_lb = scene.config.width * scene.config.height * scene.config.spp
    logger.info("rendered in %.2fs (>=%.2f Mprimary-rays/s)", t2 - t1,
                n_rays_lb / max(t2 - t1, 1e-9) / 1e6)

    ldr = io_utils.tonemap_srgb(img, scene.film.gamma)
    if ext == "exr":
        exr_utils.write_exr(out, img)
        io_utils.write_png(base + ".png", ldr)
    else:
        writer = {"bmp": io_utils.write_bmp,
                  "tga": io_utils.write_tga}.get(ext, io_utils.write_png)
        writer(out, ldr)
        exr_utils.write_exr(base + ".exr", img)
    io_utils.write_npy(base + ".npy", img)
    io_utils.write_pfm(base + ".pfm", img)
    logger.info("wrote %s.{%s,exr,npy,pfm}", base, ext)
    return 0


if __name__ == "__main__":
    sys.exit(main())
