"""Headless renderer CLI (port of hairpt/cli.py; counterpart of the
reference's `mitsuba`, `mtsutil` and `mtsimport` executables).

    python -m hairpt_torch.cli render scene.xml -o out.png [-D key=value]
        [--spp N] [--res-scale S] [--hair-quality Q] [--depth D]
        [--seed S] [-v|-q] [-l log] [-w] [--cpu] [-r SEC]
        [--checkpoint F.npz] [-x] [--progress] [--stats] [--profile DIR]
        [--bands N]
    python -m hairpt_torch.cli util {tonemap,addimages,joinrgb,resample}
        inputs... -o out [--gamma G] [--weights w,..] [--size WxH]
        [--filter F] [--boundary B] [--clamp] [--cpu]
    python -m hairpt_torch.cli import scene.dae scene.xml [--obj-dir D]

render loads a scene XML (scene/xml_loader.py), renders it with the path
integrator, or with the one the XML's <integrator> or --integrator
names, as the JAX package's CLI dispatches them: volpath (volpath_simple
= volpath), ptracer, bdpt, vpl, ppm (photonmapper = ppm; in a scene with
a medium the volumetric photon map), sppm, direct, ao, irrcache, erpt,
pssmlt, mlt (path-space MLT), motion (the motion-vector AOV, in the XML's
path configuration), adaptive, multichannel (the radiance image, and
each other channel as <base>.<channel>.npy beside it) and field:<name>
(one of aux_integrators.FIELDS; field alone is shNormal); any other
name renders with the path integrator, as in the JAX package; --spectral N
renders N wavelength bins (--dispersion B: Cauchy dispersion of every
eta) whatever the integrator. The path integrator renders in bands of N
rows streamed to <base>.exr (film/tiled.py) under --bands N or a
tiledhdrfilm (64 rows unless --bands says), and under --profile DIR
inside torch.profiler (CPU and CUDA activities), its Chrome trace written
to DIR/trace.json; --stats prints utils/stats' table after any
integrator (only the path render records counters, as in the JAX
package; the banded render records its own). It runs on the card, or on
the CPU with --cpu (the plain versions of the kernels), and writes the
image named by -o in the format its extension names, as the JAX
package's PIL picks it (utils/io.ldr_writer: .png, .jpg / .jpeg at
quality 95, .bmp, .tga, .tif / .tiff and .ppm / .pgm / .pbm / .pnm; .exr
with a .png beside it; a format PIL writes and the port does not yet,
such as .gif or .webp, raises NotImplementedError naming ROADMAP item
13, and an extension PIL has no writer for ValueError, both before the
render) with .exr, .npy and .pfm of the linear radiance beside it; the
film's label[] annotations and banner are drawn onto the 8-bit image
(utils/io.annotate_image), as the JAX package's CLI draws them, except
under the banded render, which writes only its EXR. A scene
with a dipole subsurface material gets its irradiance prepass
(integrators/sss.attach_dipole) before the render. util (the
reference's mtsutil tools) reads .npy, .pfm, .hdr and .exr images and
computes on the card, or on the CPU with --cpu; import
(mtsimport) converts a COLLADA document into OBJ meshes and a scene XML
(scene/collada.py). Without --cpu a machine with no card exits non-zero
before loading anything. util writes its 8-bit outputs by the same
rules, checked before it reads its inputs, a .jpg at quality 75 (the
JAX package's util saves it through PIL at PIL's default quality).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

INTEGRATORS = ("path", "volpath", "volpath_simple", "ptracer", "bdpt",
               "vpl", "photonmapper", "ppm", "sppm", "direct", "ao",
               "irrcache", "erpt", "pssmlt", "mlt", "motion", "adaptive",
               "multichannel", "field")
# the JAX package's CLI aliases
ALIASES = {"volpath_simple": "volpath", "photonmapper": "ppm"}


def _ldr_writer(path: str, device, quality: int = 95):
    """The writer of an 8-bit image by its extension, as the JAX
    package's PIL picks the format (utils/io.ldr_writer: PNG without an
    extension; a format PIL writes and the port does not yet raises
    NotImplementedError, one PIL has no writer for ValueError); a JPEG at
    `quality`, its block stage on `device`."""
    from .utils import io as io_utils
    if "." not in os.path.basename(path):
        return io_utils.write_png
    return io_utils.ldr_writer(path, device, quality)


def _read_any(path):
    """An image of the util command: .npy, .pfm, .hdr or .exr."""
    import numpy as np
    from .utils import exr as exr_utils
    from .utils import io as io_utils
    p = path.lower()
    if p.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if p.endswith(".pfm"):
        return io_utils.read_pfm(path)
    if p.endswith(".hdr"):
        return io_utils.read_hdr(path)
    if p.endswith(".exr"):
        return exr_utils.read_exr(path)[..., :3]
    raise ValueError(f"unsupported input format: {path}")


def _write_any(path, img, device):
    import numpy as np
    from .utils import exr as exr_utils
    from .utils import io as io_utils
    p = path.lower()
    if p.endswith(".npy"):
        np.save(path, img)
    elif p.endswith(".pfm"):
        io_utils.write_pfm(path, img)
    elif p.endswith(".exr"):
        exr_utils.write_exr(path, img)
    else:
        # the JAX package's util writes through PIL at its default quality
        _ldr_writer(path, device, quality=75)(path, img)


def _util_main(args):
    """The reference's mtsutil image tools, as the JAX package's CLI has
    them: tonemap (HDR to a gamma-encoded 8-bit image), addimages (a
    weighted sum), joinrgb (three single-channel images to RGB) and
    resample (utils/resample.py: any reconstruction filter and boundary
    mode). The images are read on the host and computed on the card, or
    on the CPU with --cpu."""
    import numpy as np
    import torch
    from .utils import log as log_mod
    logger = log_mod.setup()
    if not args.cpu and not torch.cuda.is_available():
        logger.error("no CUDA card (torch.cuda.is_available() is False); "
                     "pass --cpu to compute on the CPU")
        return 2
    dev = torch.device("cpu" if args.cpu else "cuda")
    if args.tool == "tonemap" or not args.output.lower().endswith(
            (".npy", ".pfm", ".exr")):
        # an output format the port cannot write fails before any work
        _ldr_writer(args.output, dev, quality=75)
    imgs = [torch.as_tensor(_read_any(p), device=dev) for p in args.inputs]
    if args.tool == "tonemap":
        out = torch.clamp(imgs[0], 0.0, 1.0) ** (1.0 / args.gamma)
        _ldr_writer(args.output, dev, quality=75)(args.output,
                                                  out.cpu().numpy())
    else:
        if args.tool == "addimages":
            w = [float(x) for x in args.weights.split(",")] \
                if args.weights else [1.0] * len(imgs)
            out = sum(wi * im for wi, im in zip(w, imgs))
        elif args.tool == "resample":
            from .utils.resample import resample
            w, h = (int(x) for x in args.size.split("x"))
            out = resample(imgs[0], w, h, filter_name=args.filter,
                           boundary=args.boundary,
                           clamp="auto" if args.clamp else None)
        else:  # joinrgb
            if len(imgs) != 3:
                raise ValueError("joinrgb needs R, G, B inputs")
            out = torch.stack([im if im.dim() == 2 else im[..., 0]
                               for im in imgs], -1)
        _write_any(args.output, out.cpu().numpy().astype(np.float32), dev)
    print(f"[hairpt_torch] wrote {args.output}", file=sys.stderr)
    return 0


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
                   help="print the render-statistics table at exit "
                        "(Statistics::printStats)")
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
                   help="write a torch.profiler Chrome trace of the path "
                        "render to this directory")
    r.add_argument("--bands", type=int, default=0,
                   help="out-of-core: render N-row bands streamed to the "
                        "output EXR (tiledhdrfilm; path only)")
    r.add_argument("--spectral", type=int, default=0, metavar="N",
                   help="render with N spectral bins (a multiple of 3) "
                        "instead of RGB")
    r.add_argument("--dispersion", type=float, default=0.0,
                   help="Cauchy B coefficient (um^2) of dielectric "
                        "dispersion in --spectral mode (0.0042: BK7)")
    r.add_argument("--integrator", default=None,
                   help=", ".join(INTEGRATORS) + ", field:<name> (default: "
                        "the scene XML's)")
    # the reference's mtsutil tools (src/utils/{tonemap,addimages,
    # joinrgb}.cpp) and Bitmap::resample
    u = sub.add_parser("util")
    u.add_argument("tool", choices=["tonemap", "addimages", "joinrgb",
                                    "resample"])
    u.add_argument("inputs", nargs="+",
                   help="input images (.npy/.pfm/.exr/.hdr)")
    u.add_argument("-o", "--output", required=True)
    u.add_argument("--gamma", type=float, default=2.2)
    u.add_argument("--weights", default=None,
                   help="comma-separated blend weights (addimages)")
    u.add_argument("--size", default="256x256",
                   help="WxH output size (resample)")
    u.add_argument("--filter", default="lanczos",
                   choices=["box", "tent", "gaussian", "mitchell",
                            "catmullrom", "lanczos"])
    u.add_argument("--boundary", default="clamp",
                   choices=["clamp", "wrap", "mirror", "zero"])
    u.add_argument("--clamp", action="store_true",
                   help="clamp the output to the source's range "
                        "(anti-ringing)")
    u.add_argument("--cpu", action="store_true",
                   help="compute on the CPU (the default is the card)")
    # the reference's mtsimport (src/converter/collada.cpp): COLLADA to
    # mesh files and a scene XML
    imp = sub.add_parser("import")
    imp.add_argument("dae", help="input COLLADA .dae file")
    imp.add_argument("output", help="output scene .xml path")
    imp.add_argument("--obj-dir", default=None,
                     help="directory for the extracted OBJ meshes "
                          "(default: next to the XML)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.cmd == "util":
        return _util_main(args)
    if args.cmd == "import":
        from .scene.collada import convert
        print(f"wrote {convert(args.dae, args.output, obj_dir=args.obj_dir)}")
        return 0

    from .utils import log as log_mod
    logger = log_mod.setup(verbosity=args.verbose, quiet=args.quiet,
                           logfile=args.log,
                           warnings_as_errors=args.warn_error)

    out = args.output or "output.png"
    base, ext = out.rsplit(".", 1) if "." in os.path.basename(out) \
        else (out, "png")
    ext = ext.lower()

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
    from .utils import stats as stats_mod

    stats_mod.reset()

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
    # every listed integrator but path dispatches to its own render; any
    # other name is the path integrator's
    banded = not args.spectral and not integ.startswith("field") \
        and (integ == "path" or integ not in INTEGRATORS) \
        and (args.bands > 0 or scene.config.tiled_film)
    # the 8-bit image's writer, found before the render (the JAX
    # package's PIL raises for an extension it cannot write after it)
    write_ldr = None if banded or ext == "exr" else _ldr_writer(out, device)
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
    elif banded:
        # out-of-core banded path render streamed straight to the EXR
        from .film.tiled import render_tiled_exr
        render_tiled_exr(scene, base + ".exr", band_rows=args.bands or 64,
                         seed=args.seed)
        logger.info("rendered in %.2fs, streamed %s.exr (%dx%d)",
                    time.time() - t1, base, scene.config.width,
                    scene.config.height)
        if args.stats:
            stats_mod.print_stats()
        return 0
    else:
        kw = dict(seed=args.seed, progress=prog, flush_every=args.refresh,
                  flush_cb=_flush if args.refresh > 0 else None,
                  checkpoint=args.checkpoint)
        if args.profile:
            img = _profiled(args.profile, device, logger,
                            lambda: path_int.render(scene, **kw))
        else:
            img = path_int.render(scene, **kw)
    img = img.cpu().numpy()
    t2 = time.time()
    if device == "cuda":
        # the kernels this render launched (the counts of the tiled query's
        # A and B and the packed walk's F)
        from .ops import intersect_packed, tiled_kernels
        launched = {k: v for k, v in dict(tiled_kernels.LAUNCHES,
                                          **intersect_packed.LAUNCHES)
                    .items() if v}
        logger.info("kernel launches: %s", launched)
    n_rays_lb = scene.config.width * scene.config.height * scene.config.spp
    logger.info("rendered in %.2fs (>=%.2f Mprimary-rays/s)", t2 - t1,
                n_rays_lb / max(t2 - t1, 1e-9) / 1e6)
    if args.stats:
        # the counters' table at exit (reference: Statistics::printStats,
        # mitsuba.cpp:408)
        stats_mod.print_stats()

    ldr = io_utils.tonemap_srgb(img, scene.film.gamma)
    fl = scene.film
    if fl.annotations or fl.banner:
        subst = {"scene.renderTime": time.time() - t1,
                 "film.width": scene.config.width,
                 "film.height": scene.config.height,
                 "sampler.sampleCount": scene.config.spp,
                 "integrator.maxDepth": scene.config.max_depth}
        ldr = io_utils.annotate_image(ldr, fl.annotations, subst, fl.banner)
    if ext == "exr":
        exr_utils.write_exr(out, img)
        io_utils.write_png(base + ".png", ldr)
    else:
        write_ldr(out, ldr)
        exr_utils.write_exr(base + ".exr", img)
    io_utils.write_npy(base + ".npy", img)
    io_utils.write_pfm(base + ".pfm", img)
    logger.info("wrote %s.{%s,exr,npy,pfm}", base, ext)
    return 0


def _profiled(out_dir, device, logger, render):
    """render() inside torch.profiler (CPU activity, and CUDA on the
    card), its Chrome trace written to out_dir/trace.json (the JAX
    package's CLI writes a jax.profiler trace there)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        img = render()
    trace = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace)
    logger.info("wrote the profiler trace %s", trace)
    return img


if __name__ == "__main__":
    sys.exit(main())
