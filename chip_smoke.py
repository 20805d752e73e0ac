#!/usr/bin/env python3
"""Smoke run of hairpt_torch on one CUDA card: the quickest proof that the
port builds, that its kernels agree with their plain versions, and that
the full-width furball forward render runs through them.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each prints one line with its elapsed seconds):
  0. the card (nvidia-smi name and power limit) and torch/CUDA versions;
  1. build the CUDA kernels (nvcc, sm_90a) and the BVH builder (g++), in
     parallel;
  2. build the full-width furball scene (84,000 fibers x 12 segments,
     K = 128), take a real camera wave and a first-bounce wave (uniformly
     random directions at the camera hit points, Morton-sorted as the
     bounce queries are), and hold kernel A (phase-A cull) and kernel B
     (phase-B cylinder test, closest and any-hit) against their plain
     PyTorch versions on a subset of 512 tiles per wave, and kernel B on
     every tile of the camera wave; time each kernel and its plain version
     at the camera wave's shapes;
  3. a small furball rendered on the card and with the plain versions on
     the CPU: the image means must agree;
  4. the full-width render (1024^2, depth 65, true Sobol', q = 2048,
     shadow-ray RR 0.01, rough plastic, baked sunsky) through SceneBuilder
     -> build -> render: one warm-up wave and two timed 1-spp waves, with
     the kernels' launch counts taken over the timed waves.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failed check exits
non-zero before that line. Without CUDA the script exits non-zero at once.
"""
from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time

# a hang anywhere exits non-zero with every thread's traceback
faulthandler.dump_traceback_later(720, exit=True)

T_START = time.time()

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per (ray, cluster) slab test and per (ray, segment)
# cylinder test, counted from the kernels' source (a division and a
# square root count as one each)
SLAB_FLOPS = 30
CYL_FLOPS = 90

SUBSET_TILES = 512

# tolerances of the kernel checks, with their reasons:
#  te: exact or one bf16 step apart (the kernel and the plain version
#      truncate the same f32 minimum; one step allows for a different
#      f32 rounding of the slab arithmetic)
TE_MAX_BF16_STEPS = 1
#  t_pmax: 1e-6 relative (the same f32 entry t, bit-equal expected)
TPMAX_RTOL = 1e-6
#  pid: >= 99.9% equal (exact equality expected with --fmad=false; the
#       margin covers equal-t ties that rounding could reorder)
PID_MIN_AGREE = 0.999
#  t: 1e-5 relative where both hit
T_RTOL = 1e-5
#  small render, card vs CPU: image means within 2% (paths can diverge
#  where CPU and GPU transcendentals round differently)
MEAN_RTOL = 0.02


class SmokeFailure(Exception):
    pass


def log(msg):
    print(f"[smoke {time.time() - T_START:7.1f}s] {msg}", flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bench_scene(quality, res, depth, spp, device, q=2048):
    from hairpt_torch.scene.furball import furball_scene
    return furball_scene(quality=quality, res=res, depth=depth, spp=spp,
                         device=device, q=q)


def cuda_ms(fn, reps, warm=True):
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def waves(scene):
    """A camera wave and a first-bounce wave of the scene, as Ray."""
    import numpy as np
    import torch
    from hairpt_torch.core import rng, warps
    from hairpt_torch.core.math import Ray
    from hairpt_torch.integrators import common
    from hairpt_torch.models import sensors
    from hairpt_torch.ops import intersect_tiled as itiled

    cfg = scene.config
    arr = scene.arrays
    dev = arr.hair.p0.device
    pixel = torch.as_tensor(common.block_swizzle(cfg.width, cfg.height),
                            device=dev)
    smp = rng.Sampler(cfg.sampler, pixel, torch.zeros_like(pixel))
    jitter = smp.next_2d(0)
    pos = torch.stack([(smp.pixel % cfg.width).float() + jitter[:, 0],
                       (smp.pixel // cfg.width).float() + jitter[:, 1]], -1)
    cam_ray = sensors.sample_ray(scene.camera, pos)
    hit = common.scene_intersect(arr, cam_ray, cfg.tiled_q)
    n = pixel.shape[0]
    u = torch.as_tensor(np.random.default_rng(7).random((n, 2)),
                        dtype=torch.float32, device=dev)
    d = warps.square_to_uniform_sphere(u)
    d = torch.where((torch.sum(d * hit.geo_n, -1) < 0)[:, None], -d, d)
    o = hit.p + hit.geo_n * cfg.ray_eps
    o = torch.where(hit.valid[:, None], o, cam_ray.o)
    bounce = Ray(o=o, d=d, mint=torch.zeros(n, device=dev),
                 maxt=torch.where(hit.valid, float("inf"), 0.0))
    bounce, _ = itiled._morton_sort_rays(arr.hair_swept, bounce)
    return {"camera": cam_ray, "bounce": bounce}, float(hit.valid.float()
                                                         .mean())


def check_kernels(scene, report):
    """Phase 2: kernels against their plain versions on the card."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    arr = scene.arrays
    sw = arr.hair_swept
    C, _, K = sw.seg_rows_t.shape
    q = scene.config.tiled_q
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    ks = itiled.KeySpace(C)
    wv, hit_frac = waves(scene)
    log(f"waves: camera hit fraction {hit_frac:.4f}")
    errs = {"cull_phase_a": 0.0, "phase_b": 0.0}
    for name, ray in wv.items():
        ray_p, _ = itiled._pad_rays(ray, tk.TILE)
        r8 = itiled.rays8_of(ray_p)
        T = r8.shape[0]
        te_k, tpm_k = tk.cull_phase_a(r8, bounds)
        live = torch.nonzero((r8[:, 7, :] > r8[:, 6, :]).any(1)).squeeze(1)
        sel = torch.linspace(0, live.numel() - 1, min(SUBSET_TILES,
                                                      live.numel()),
                             device=r8.device).round().long()
        idx = torch.unique(live[sel])
        te_p, tpm_p = tk.cull_phase_a_plain(r8[idx], bounds)
        a = te_k[idx].view(torch.int16).int() & 0x7FFF
        b = te_p.view(torch.int16).int() & 0x7FFF
        steps = int((a - b).abs().max())
        fin = torch.isfinite(te_p.float())
        te_err = float((te_k[idx].float() - te_p.float())[fin].abs().max()) \
            if bool(fin.any()) else 0.0
        both_neg = (tpm_k[idx] < 0) & (tpm_p < 0)
        tp_rel = torch.where(
            both_neg, 0.0, (tpm_k[idx] - tpm_p).abs()
            / tpm_p.abs().clamp(min=1e-30))
        log(f"{name}: kernel A on {T} tiles vs plain on {idx.numel()}: "
            f"max bf16 step diff {steps}, max |te diff| {te_err:.3g}, "
            f"max t_pmax rel diff {float(tp_rel.max()):.3g}, "
            f"candidates/tile {float(fin.sum(1).float().mean()):.1f}")
        require(steps <= TE_MAX_BF16_STEPS,
                f"{name}: kernel A te differs by {steps} bf16 steps")
        require(float(tp_rel.max()) <= TPMAX_RTOL,
                f"{name}: kernel A t_pmax rel diff {float(tp_rel.max())}")
        errs["cull_phase_a"] = max(errs["cull_phase_a"], te_err)

        slots, cnt, tmin, tscale, ov, _ = itiled._tile_slots(
            ks.keys(te_k[idx]), ks, q)
        r8s = r8[idx].contiguous()
        tps = tpm_k[idx].contiguous()
        for any_hit in (False, True):
            mode = "any" if any_hit else "closest"
            t_k, p_k, run_k = tk.phase_b(slots, cnt, tmin, tscale, r8s, tps,
                                         sw.seg_rows_t, any_hit, True)
            t_p, p_p, run_p = tk.phase_b_plain(slots, cnt, tmin, tscale,
                                               r8s, tps, sw.seg_rows_t,
                                               any_hit, True)
            agree = float((p_k == p_p).float().mean())
            both = (p_k >= 0) & (p_p >= 0)
            t_rel = float(((t_k - t_p).abs() / t_p.abs().clamp(min=1e-30))
                          [both].max()) if bool(both.any()) else 0.0
            t_abs = float((t_k - t_p)[both].abs().max()) \
                if bool(both.any()) else 0.0
            log(f"{name}: kernel B {mode} on {idx.numel()} tiles "
                f"(mean cnt {float(cnt.float().mean()):.1f}, overflow tiles "
                f"{ov}): pid agree {agree:.6f}, max t rel diff {t_rel:.3g}, "
                f"hits {int((p_k >= 0).sum())}, slots run equal "
                f"{float((run_k == run_p).float().mean()):.4f}")
            require(agree >= PID_MIN_AGREE,
                    f"{name}/{mode}: kernel B pid agreement {agree}")
            if not any_hit:
                require(t_rel <= T_RTOL,
                        f"{name}/{mode}: kernel B t rel diff {t_rel}")
                errs["phase_b"] = max(errs["phase_b"], t_abs)

        if name == "camera":
            report["cam"] = dict(r8=r8, te=te_k, tpm=tpm_k)
    return errs


def time_kernels(scene, report, errs):
    """Kernel and plain times at the camera wave's shapes, with bounds."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C, _, K = sw.seg_rows_t.shape
    q = scene.config.tiled_q
    cam = report["cam"]
    r8 = cam["r8"]
    T = r8.shape[0]
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    ms_a = cuda_ms(lambda: tk.cull_phase_a(r8, bounds), 5)
    plain_a = cuda_ms(lambda: tk.cull_phase_a_plain(r8, bounds), 1,
                      warm=False)
    live_tiles = int((r8[:, 7, :] > r8[:, 6, :]).any(1).sum())
    bytes_a = T * 8 * 64 * 4 + 6 * C * 4 + T * C * 2 + T * 64 * 4
    flops_a = live_tiles * 64 * C * SLAB_FLOPS
    b_a = max(bytes_a / HBM_BYTES_PER_S, flops_a / F32_FLOPS_PER_S) * 1e3

    ks = itiled.KeySpace(C)
    slots, cnt, tmin, tscale, _, _ = itiled._tile_slots(
        ks.keys(cam["te"]), ks, q)
    args = (slots, cnt, tmin, tscale, r8, cam["tpm"], sw.seg_rows_t)
    ms_b = cuda_ms(lambda: tk.phase_b(*args), 3)
    t_k, p_k, run = tk.phase_b(*args, False, True)
    plain = {}

    def run_plain():
        plain["out"] = tk.phase_b_plain(*args, False, True)
    plain_b = cuda_ms(run_plain, 1, warm=False)
    t_p, p_p, run_p = plain["out"]
    agree = float((p_k == p_p).float().mean())
    both = (p_k >= 0) & (p_p >= 0)
    t_rel = float(((t_k - t_p).abs() / t_p.abs().clamp(min=1e-30))[both]
                  .max()) if bool(both.any()) else 0.0
    log(f"camera: kernel B closest on all {T} tiles: pid agree "
        f"{agree:.6f}, max t rel diff {t_rel:.3g}, slots run equal "
        f"{float((run == run_p).float().mean()):.4f}")
    require(agree >= PID_MIN_AGREE and t_rel <= T_RTOL,
            f"camera, all tiles: kernel B pid agreement {agree}, t rel "
            f"diff {t_rel}")
    n_slots = int(run.long().sum())
    bytes_b = (n_slots * (16 * K * 4 + 4)
               + T * (8 * 64 * 4 + 64 * 4 + 12) + T * 64 * 8)
    flops_b = n_slots * 64 * K * CYL_FLOPS
    b_b = max(bytes_b / HBM_BYTES_PER_S, flops_b / F32_FLOPS_PER_S) * 1e3
    log(f"kernel A: {ms_a:.3f} ms on {T} tiles x {C} clusters "
        f"(bound {b_a:.3f} ms, by operations), plain {plain_a:.1f} ms")
    log(f"kernel B: {ms_b:.3f} ms on {T} tiles, {n_slots} slots tested "
        f"(bound {b_b:.3f} ms, by operations), plain {plain_b:.1f} ms")
    return [
        dict(name="cull_phase_a", route="cuda",
             source="hairpt_torch/csrc/tiled.cu",
             replaces="hairpt/ops/pallas_tiled.py:882", launches=0,
             max_abs_err=errs["cull_phase_a"], ms=ms_a, plain_ms=plain_a,
             bound_ms=b_a,
             bound_by="operations" if flops_a / F32_FLOPS_PER_S
             >= bytes_a / HBM_BYTES_PER_S else "bytes",
             library_ms=None, tiles=T),
        dict(name="phase_b", route="cuda",
             source="hairpt_torch/csrc/tiled.cu",
             replaces="hairpt/ops/pallas_tiled.py:396", launches=0,
             max_abs_err=errs["phase_b"], ms=ms_b, plain_ms=plain_b,
             bound_ms=b_b,
             bound_by="operations" if flops_b / F32_FLOPS_PER_S
             >= bytes_b / HBM_BYTES_PER_S else "bytes",
             library_ms=None, tiles=T, slots_tested=n_slots),
    ]


def small_reference():
    """Phase 3: a small furball on the card and on the CPU."""
    from hairpt_torch.integrators import path

    means = {}
    for dev in ("cuda", "cpu"):
        s = bench_scene(quality=0.1, res=64, depth=8, spp=1, device=dev,
                        q=64)
        means[dev] = float(path.render(s, spp=1).mean())
    rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]), 1e-12)
    log(f"small furball (600 fibers, 64^2, depth 8, q 64): image mean "
        f"card {means['cuda']:.6f}, CPU {means['cpu']:.6f}, rel diff "
        f"{rel:.3g}")
    require(means["cpu"] > 0 and rel <= MEAN_RTOL,
            f"small render: card and CPU means differ by {rel}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import hairpt_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the hairpt_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import _native, bvh
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    try:
        # ---- 0. the card ----
        t0 = time.time()
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError) as e:
            smi = f"nvidia-smi failed: {e}"
        print(smi, flush=True)
        kind = torch.cuda.get_device_name(0)
        log(f"phase 0 ({time.time() - t0:.1f}s): {kind}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}, python "
            f"{sys.version.split()[0]}")

        # ---- 1. builds ----
        t0 = time.time()
        with ThreadPoolExecutor(2) as ex:
            f_k = ex.submit(tk.lib)
            f_b = ex.submit(bvh._load_native)
            f_k.result()
            require(f_b.result() is not None, "the BVH builder did not build")
        for name, s in _native.BUILD_SECONDS.items():
            log(f"built {name} in {s:.1f}s")
        for line in _native.BUILD_LOG.get("hairpt_tiled", "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
        log(f"phase 1 ({time.time() - t0:.1f}s): builds done")

        # ---- 2. kernels against plain versions ----
        t0 = time.time()
        scene = bench_scene(quality=14.0, res=1024, depth=65, spp=1,
                            device="cuda")
        sw = scene.arrays.hair_swept
        C, _, K = sw.seg_rows_t.shape
        log(f"scene: {scene.arrays.hair.p0.shape[0]} segments, C={C}, "
            f"K={K}, seg_rows_t {sw.seg_rows_t.numel() * 4 / 1e6:.1f} MB, "
            f"built in {time.time() - t0:.1f}s")
        t1 = time.time()
        report = {}
        errs = check_kernels(scene, report)
        kernels = time_kernels(scene, report, errs)
        del report
        log(f"phase 2 ({time.time() - t0:.1f}s): kernels match their plain "
            f"versions (checks {time.time() - t1:.1f}s)")

        # ---- 3. small render, card against CPU ----
        t0 = time.time()
        small_reference()
        log(f"phase 3 ({time.time() - t0:.1f}s): small render agrees")

        # ---- 4. the full-width render ----
        t0 = time.time()
        times, rays = [], []

        def progress(done, total, secs, n_rays):
            torch.cuda.synchronize()
            times.append(secs)
            rays.append(n_rays)

        path.render(scene, spp=1, seed=0, progress=progress)
        warm = times[0]
        n_timed = 2 if warm <= 60.0 else 1
        log(f"warm-up wave: {warm:.2f}s, {rays[0]:.0f} rays"
            + ("" if n_timed == 2 else "; over 60 s, so ONE timed wave"))
        times.clear()
        rays.clear()
        tk.reset_counts()
        itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        img = path.render(scene, spp=n_timed, seed=1, progress=progress)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        plain_cuda = dict(tk.PLAIN_ON_CUDA)
        mean = float(img.mean())
        secs = sum(times) / len(times)
        rays_w = sum(rays) / len(rays)
        log(f"render: {n_timed} timed waves of 1 spp at 1024^2, depth 65: "
            f"{rays_w:.0f} rays/wave, {secs:.3f} s/wave, "
            f"{rays_w / secs / 1e6:.4f} Mrays/s")
        log(f"image mean {mean:.6f}, shape {tuple(img.shape)}; max "
            f"completion passes {itiled.STATS['max_passes']}, queries "
            f"{itiled.STATS['queries']}, overflow tiles "
            f"{itiled.STATS['overflow_tiles']}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"launches over the timed waves: {launches}; plain-version "
            f"calls on CUDA tensors: {plain_cuda}")
        require(np.isfinite(mean) and mean > 0, f"image mean {mean}")
        require(bool(torch.isfinite(img).all()), "non-finite pixels")
        require(all(v > 0 for v in launches.values()),
                f"a kernel was not launched on the main path: {launches}")
        require(all(v == 0 for v in plain_cuda.values()),
                f"plain versions ran on CUDA tensors: {plain_cuda}")
        log(f"phase 4 ({time.time() - t0:.1f}s): render ok")

        for k in kernels:
            k["launches"] = launches[k["name"]]
            k["launches_per_wave"] = launches[k["name"]] / n_timed
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
