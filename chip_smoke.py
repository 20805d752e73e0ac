#!/usr/bin/env python3
"""Smoke run of hairpt_torch on one CUDA card: the quickest proof that the
port builds, that its kernels agree with their plain versions, and that
the full-width furball forward render runs through them, with the tiled
and with the swept traversal.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each prints one line with its elapsed seconds):
  0. the card (nvidia-smi name and power limit) and torch/CUDA versions;
  1. build the three CUDA libraries (nvcc, sm_90a: tiled.cu with kernels
     A and B, octets.cu with C and D, phaseb.cu with E) and the BVH
     builder (g++), all in parallel;
  2. build the full-width furball scene (84,000 fibers x 12 segments,
     K = 128), take a real camera wave and a first-bounce wave (uniformly
     random directions at the camera hit points, Morton-sorted as the
     bounce queries are), and
       a. hold kernel A (phase-A cull, with and without its octet output)
          and kernel B (dense phase B, closest and any hit) against their
          plain PyTorch versions on EVERY tile of both waves, with the
          share of (tile, cluster) pairs that pass A's tile test
          (group_cull_plain) and of (ray, slot) pairs that pass B's slot
          cull; kernels
          C, D (octet and stream phase B, closest and any hit) on a
          subset of 512 tiles per wave; time A on both whole waves beside
          its bounds, and B, C and D beside the bound they share;
       b. run both whole waves through tiled_closest_hit / tiled_any_hit
          with octets=True and with streams=True (q = 2048, the JAX
          default stream_qo = 512) and compare each with
          the dense query; the launches of A's octet variant, C and D are
          counted over these queries;
       c. hold kernel E (the swept traversal's chunk test) against its
          plain version on >= 8,192 of each wave's chunks, pid exactly;
     and time every kernel and its plain version at the camera wave's
     shapes;
  3. a small furball rendered on the card and with the plain versions on
     the CPU, with the tiled and with the swept traversal: the image means
     must agree;
  4. the full-width render (1024^2, depth 65, true Sobol', q = 2048,
     shadow-ray RR 0.01, rough plastic, baked sunsky) through SceneBuilder
     -> build -> render: one warm-up wave and two timed 1-spp waves, with
     kernels A and B's launch counts taken over the timed waves;
  5. the same render with traversal='swept' (p_max 24, chunks of 64): one
     warm-up wave and one or two timed waves, kernel E's launches counted
     over them.
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
faulthandler.dump_traceback_later(900, exit=True)

T_START = time.time()

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per (ray, cluster) slab test and per (ray, segment)
# cylinder test, counted from the kernels' source (a division and a
# square root count as one each): the tiled kernels' test (B, C, D) and
# kernel E's, which divides twice and evaluates the miter planes at the
# hit points
SLAB_FLOPS = 30
CYL_FLOPS = 90
# f32 operations of kernel A's tile test of one (tile, cluster) pair,
# counted from tiled.cu's tile_pass the same way (per face 2 subtractions,
# 4 products, 6 min/max; 2 min/max per axis; 4 across the axes, 2 to
# widen, 3 compares)
TILE_TEST_FLOPS = 87
CHUNK_CYL_FLOPS = 105

SUBSET_TILES = 512
E_SUBSET_CHUNKS = 8192

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
#  octet bits of kernel A: exact (the same hit predicate as te)
#  kernel E: pid and hit flags exactly equal, t within T_RTOL (the same
#      arithmetic without fused multiply-adds on both sides, and a tie rule,
#      the largest pid at the minimum t, that no order of the lanes changes)
#  octet and stream queries against the dense query at full width: hit
#  flags equal, pid >= PID_MIN_AGREE equal (the modes break equal-t ties
#  by slot order, kernel B by the largest pid), t within T_RTOL


class SmokeFailure(Exception):
    pass


def log(msg):
    print(f"[smoke {time.time() - T_START:7.1f}s] {msg}", flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bench_scene(quality, res, depth, spp, device, q=2048, traversal="tiled"):
    from hairpt_torch.scene.furball import furball_scene
    return furball_scene(quality=quality, res=res, depth=depth, spp=spp,
                         device=device, q=q, traversal=traversal)


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


def bound_ms(n_bytes, flops):
    """(least time in ms, 'bytes' or 'operations')."""
    tb, to = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(tb, to) * 1e3, ("operations" if to >= tb else "bytes")


def compare(t_k, p_k, t_p, p_p):
    """(pid agreement, max t rel diff, max |t diff|) where both hit."""
    agree = float((p_k == p_p).float().mean())
    both = (p_k >= 0) & (p_p >= 0)
    if not bool(both.any()):
        return agree, 0.0, 0.0
    d = (t_k - t_p)[both].abs()
    rel = d / t_p[both].abs().clamp(min=1e-30)
    return agree, float(rel.max()), float(d.max())


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


def check_kernel_a(r8, bounds, name):
    """Phase 2a: kernel A (both instances) against its plain version on
    EVERY tile of a wave (one plain call with emit_oct serves both), and
    the share of (tile, cluster) pairs that pass its tile test.
    Returns (te, t_pmax, oct, max |te diff|, facts for the kernels line)."""
    import torch
    from hairpt_torch.ops import tiled_kernels as tk

    T, C = r8.shape[0], bounds.shape[1]
    te_k, tpm_k = tk.cull_phase_a(r8, bounds)
    te_o, tpm_o, oct_k = tk.cull_phase_a(r8, bounds, emit_oct=True)
    require(torch.equal(te_o.view(torch.int16), te_k.view(torch.int16))
            and torch.equal(tpm_o.view(torch.int32), tpm_k.view(torch.int32)),
            f"{name}: kernel A's two instances differ in te or t_pmax")
    out = {}
    plain_ms = cuda_ms(lambda: out.update(p=tk.cull_phase_a_plain(
        r8, bounds, emit_oct=True)), 1, warm=False)
    te_p, tpm_p, oct_p = out.pop("p")
    a = te_k.view(torch.int16).int() & 0x7FFF
    b = te_p.view(torch.int16).int() & 0x7FFF
    steps = int((a - b).abs().max())
    words = int((te_k.view(torch.int16) != te_p.view(torch.int16)).sum())
    fin = torch.isfinite(te_p.float())
    te_err = float((te_k.float() - te_p.float())[fin].abs().max()) \
        if bool(fin.any()) else 0.0
    both_neg = (tpm_k < 0) & (tpm_p < 0)
    tp_rel = float(torch.where(both_neg, 0.0, (tpm_k - tpm_p).abs()
                               / tpm_p.abs().clamp(min=1e-30)).max())
    oct_bad = int((oct_k != oct_p).sum())
    del te_p, tpm_p, oct_p
    # the tile test's passes (its plain version) beside the clusters the
    # tiles' rays enter
    n_pass = sum(int(tk.group_cull_plain(r8[t0:t0 + 256], bounds).sum())
                 for t0 in range(0, T, 256))
    live = r8[:, 7, :] > r8[:, 6, :]
    live_t = int(live.any(1).sum())
    hit_t = int(fin.sum())
    # the per-ray tests this wave needs: each live ray of a tile against
    # the clusters some ray of the tile enters
    n_ray_tests = int((fin.sum(1) * live.sum(1)).sum())
    facts = dict(live_tiles=live_t, tile_pass=n_pass,
                 tile_pass_share=n_pass / max(1, live_t * C),
                 tile_union_share=hit_t / max(1, live_t * C),
                 ray_tests=n_ray_tests, plain_ms=plain_ms)
    log(f"{name}: kernel A vs plain on all {T} tiles (plain {plain_ms:.1f} "
        f"ms): max bf16 step diff {steps}, te words differing {words}, max "
        f"|te diff| {te_err:.3g}, max t_pmax rel diff {tp_rel:.3g}, octet "
        f"words differing {oct_bad}; candidates/tile "
        f"{float(fin.sum(1).float().mean()):.1f}")
    log(f"{name}: of the live (tile, cluster) pairs the tile test passes "
        f"{facts['tile_pass_share']:.5f} ({n_pass} of {live_t * C}), rays "
        f"enter {facts['tile_union_share']:.5f} ({hit_t}); per-ray tests "
        f"needed {n_ray_tests}")
    require(steps <= TE_MAX_BF16_STEPS,
            f"{name}: kernel A te differs by {steps} bf16 steps")
    require(tp_rel <= TPMAX_RTOL,
            f"{name}: kernel A t_pmax rel diff {tp_rel}")
    require(oct_bad == 0, f"{name}: kernel A octet words differ in "
            f"{oct_bad} entries")
    return te_k, tpm_k, oct_k, te_err, facts


def check_kernels(scene, wv, report):
    """Phase 2a: kernel A (both instances) against its plain version on
    every tile of each wave, and kernels C, D on 512 live tiles."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    arr = scene.arrays
    sw = arr.hair_swept
    C, _, K = sw.seg_rows_t.shape
    q = scene.config.tiled_q
    qo = min(max(256, q // 4), q)     # the JAX default stream_qo
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    ks = itiled.KeySpace(C)
    errs = {k: 0.0 for k in ("cull_phase_a", "cull_phase_a_oct", "phase_b",
                             "phase_b_oct", "stream_phase_b")}
    for name, ray in wv.items():
        ray_p, _ = itiled._pad_rays(ray, tk.TILE)
        r8 = itiled.rays8_of(ray_p)
        te_k, tpm_k, oct_k, te_err, facts = check_kernel_a(r8, bounds, name)
        errs["cull_phase_a"] = max(errs["cull_phase_a"], te_err)
        errs["cull_phase_a_oct"] = max(errs["cull_phase_a_oct"], te_err)
        live = torch.nonzero((r8[:, 7, :] > r8[:, 6, :]).any(1)).squeeze(1)
        sel = torch.linspace(0, live.numel() - 1, min(SUBSET_TILES,
                                                      live.numel()),
                             device=r8.device).round().long()
        idx = torch.unique(live[sel])

        key = ks.keys(te_k[idx])
        slots, cnt, tmin, tscale, ov, _, oct_sl = itiled._tile_slots(
            key, ks, q, oct=oct_k[idx])
        cids, strm, off, cnt_s, tmin_s, tsc_s, ov_s, _ = \
            itiled._octet_streams(key, ks, oct_k[idx], q, qo)
        r8s = r8[idx].contiguous()
        tps = tpm_k[idx].contiguous()
        seg = sw.seg_rows_t
        runs = {
            "phase_b_oct": (
                lambda ah: tk.phase_b_oct(slots, cnt, tmin, tscale, oct_sl,
                                          r8s, tps, seg, ah),
                lambda ah: tk.phase_b_oct_plain(slots, cnt, tmin, tscale,
                                                oct_sl, r8s, tps, seg, ah)),
            "stream_phase_b": (
                lambda ah: tk.stream_phase_b(cids, strm, off, cnt_s, tmin_s,
                                             tsc_s, r8s, tps, seg, ah),
                lambda ah: tk.stream_phase_b_plain(cids, strm, off, cnt_s,
                                                   tmin_s, tsc_s, r8s, tps,
                                                   seg, ah)),
        }
        for kname, (kern, plain) in runs.items():
            for any_hit in (False, True):
                mode = "any" if any_hit else "closest"
                out_k, out_p = kern(any_hit), plain(any_hit)
                agree, t_rel, t_abs = compare(out_k[0], out_k[1], out_p[0],
                                              out_p[1])
                hits_equal = bool(torch.equal(out_k[1] >= 0, out_p[1] >= 0))
                log(f"{name}: {kname} {mode} on {idx.numel()} tiles (mean "
                    f"cnt {float(cnt.float().mean()):.1f}, overflow tiles "
                    f"{ov if kname != 'stream_phase_b' else ov_s}): pid "
                    f"agree {agree:.6f}, hit flags equal {hits_equal}, max t "
                    f"rel diff {t_rel:.3g}, hits "
                    f"{int((out_k[1] >= 0).sum())}")
                require(agree >= PID_MIN_AGREE and hits_equal,
                        f"{name}/{mode}: {kname} pid agreement {agree}, hit "
                        f"flags equal {hits_equal}")
                if not any_hit:
                    require(t_rel <= T_RTOL,
                            f"{name}/{mode}: {kname} t rel diff {t_rel}")
                    errs[kname] = max(errs[kname], t_abs)
        report[name] = dict(r8=r8, te=te_k, tpm=tpm_k, oct=oct_k, a=facts)
    return errs


def check_phase_b(scene, report, errs):
    """Phase 2a: kernel B against its plain version on EVERY tile of both
    waves (the first routing pass of each whole wave), closest and any
    hit: hit flags exactly equal, pid >= PID_MIN_AGREE (the differing
    pids are counted), t within T_RTOL, slots run equal on every tile.
    Logs the share of (ray, slot) pairs that pass the kernel's slot cull.
    Returns the plain version's time on the camera wave (closest hit)."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C = sw.seg_rows_t.shape[0]
    q = scene.config.tiled_q
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    ks = itiled.KeySpace(C)
    plain_ms = None
    for name, w in report.items():
        slots, cnt, tmin, tscale, ov, _ = itiled._tile_slots(
            ks.keys(w["te"]), ks, q)
        args = (slots, cnt, tmin, tscale, w["r8"], w["tpm"], sw.seg_rows_t)
        T = slots.shape[0]
        for any_hit in (False, True):
            mode = "any" if any_hit else "closest"
            pairs = torch.zeros((T,), dtype=torch.int32, device=slots.device)
            t_k, p_k, run_k = tk.phase_b(*args, bounds, any_hit, True,
                                         pairs_out=pairs)
            out = {}
            ms = cuda_ms(lambda: out.update(p=tk.phase_b_plain(
                *args, any_hit, True)), 1, warm=False)
            if name == "camera" and not any_hit:
                plain_ms = ms
            t_p, p_p, run_p = out["p"]
            agree, t_rel, t_abs = compare(t_k, p_k, t_p, p_p)
            hits_equal = bool(torch.equal(p_k >= 0, p_p >= 0))
            run_equal = float((run_k == run_p).float().mean())
            n_run = int(run_k.long().sum())
            n_pairs = int(pairs.long().sum())
            log(f"{name}: kernel B {mode} on all {T} tiles ({n_run} slots "
                f"run, overflow tiles {ov}; plain {ms:.1f} ms): hit flags "
                f"equal {hits_equal}, pid agree {agree:.6f} "
                f"({int((p_k != p_p).sum())} differ), max t rel diff "
                f"{t_rel:.3g}, slots run equal {run_equal:.4f}; (ray, slot) "
                f"pairs passing the slot cull {n_pairs} of {64 * n_run} "
                f"({n_pairs / max(1, 64 * n_run):.4f})")
            require(hits_equal and agree >= PID_MIN_AGREE
                    and t_rel <= T_RTOL and run_equal == 1.0,
                    f"{name}/{mode}, all tiles: kernel B hit flags equal "
                    f"{hits_equal}, pid agreement {agree}, t rel diff "
                    f"{t_rel}, slots run equal {run_equal}")
            errs["phase_b"] = max(errs["phase_b"], t_abs)
            if not any_hit:
                w["cull_pairs"] = n_pairs
                w["cull_share"] = n_pairs / max(1, 64 * n_run)
    return plain_ms


def bcd_bound(n_blk, n_tst, T, K):
    """The bound B, C and D share on one routed wave (they compute one
    function: each tile's closest hits over the same slots): the fewest
    ray-cluster tests of the three (n_tst: kernel B's pairs that pass its
    slot cull, or kernel D's per-octet walks where those are fewer) and
    the distinct (tile, cluster) segment blocks D's walks touch (n_blk),
    each read once per tile. (ms, 'bytes'/'operations')."""
    return bound_ms(n_blk * (16 * K * 4 + 4) + T * (8 * 64 * 4 + 64 * 4 + 12)
                    + T * 64 * 8, n_tst * K * CYL_FLOPS)


def time_kernels(scene, report, errs, plain_b):
    """Kernels A (both instances), B, C and D and their plain versions at
    the camera wave's shapes, with bounds (plain_b: kernel B's plain
    version's time from check_phase_b)."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C, _, K = sw.seg_rows_t.shape
    q = scene.config.tiled_q
    qo = min(max(256, q // 4), q)     # the JAX default stream_qo
    cam = report["camera"]
    r8, tpm = cam["r8"], cam["tpm"]
    T = r8.shape[0]
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    out = []

    def entry(name, src, replaces, err, ms, plain, bound, **more):
        b, by = bound
        log(f"{name}: {ms:.3f} ms at the camera wave (bound {b:.3f} ms, by "
            f"{by}), plain {plain:.1f} ms")
        out.append(dict(name=name, route="cuda", source=src,
                        replaces=replaces, launches=0, max_abs_err=err,
                        ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                        library_ms=None, tiles=T, **more))

    # kernel A on both waves, beside two bounds: the work these inputs
    # need (bound_ms: each live (tile, cluster) tile test, and each live
    # ray against the clusters some ray of its tile enters, against the
    # bytes) and the
    # dense bound (every live tile's 64 rays x every cluster)
    plain_a = cuda_ms(lambda: tk.cull_phase_a_plain(r8, bounds), 1,
                      warm=False)
    for emit in (False, True):
        kname = "cull_phase_a_oct" if emit else "cull_phase_a"
        more = {}
        for wname in ("camera", "bounce"):
            w = report[wname]
            f = w["a"]
            ms = cuda_ms(lambda: tk.cull_phase_a(w["r8"], bounds,
                                                 emit_oct=emit), 5)
            n_bytes = T * 8 * 64 * 4 + 6 * C * 4 + T * 64 * 4 \
                + T * C * (6 if emit else 2)
            work = bound_ms(n_bytes, f["live_tiles"] * C * TILE_TEST_FLOPS
                            + f["ray_tests"] * SLAB_FLOPS)
            dense = bound_ms(n_bytes, f["live_tiles"] * 64 * C * SLAB_FLOPS)
            log(f"{kname}, {wname} wave: {ms:.3f} ms; bound from this "
                f"wave's work {work[0]:.3f} ms by {work[1]} "
                f"({ms / work[0]:.1f}x), dense bound {dense[0]:.3f} ms by "
                f"{dense[1]} ({ms / dense[0]:.2f}x)")
            pre = "" if wname == "camera" else "bounce_"
            more.update({f"{pre}ms": ms, f"{pre}bound_ms": work[0],
                         f"{pre}bound_by": work[1],
                         f"{pre}dense_bound_ms": dense[0],
                         f"{pre}tile_pass_share": f["tile_pass_share"],
                         f"{pre}tile_union_share": f["tile_union_share"]})
        ms = more.pop("ms")
        b = (more.pop("bound_ms"), more.pop("bound_by"))
        entry(kname, "hairpt_torch/csrc/tiled.cu",
              "hairpt/ops/pallas_tiled.py:882",
              errs[kname], ms, cam["a"]["plain_ms"] if emit else plain_a, b,
              bound_basis="bound_ms: the work of this run's camera wave "
              "(live (tile, cluster) tile tests, live-ray tests of the "
              "clusters the tile's rays enter); dense_bound_ms: every live tile's 64 rays "
              "x every cluster", **more)

    ks = itiled.KeySpace(C)
    key = ks.keys(cam["te"])
    slots, cnt, tmin, tscale, _, _, oct_sl = itiled._tile_slots(
        key, ks, q, oct=cam["oct"])
    seg = sw.seg_rows_t
    args = (slots, cnt, tmin, tscale, r8, tpm, seg)
    oargs = (slots, cnt, tmin, tscale, oct_sl, r8, tpm, seg)
    sargs = itiled._octet_streams(key, ks, cam["oct"], q, qo)[:6] \
        + (r8, tpm, seg)
    run = tk.phase_b(*args, bounds, False, True)[2]
    plain = {}
    plain_c = cuda_ms(lambda: plain.update(
        c=tk.phase_b_oct_plain(*oargs, return_work=True)), 1, warm=False)
    plain_d = cuda_ms(lambda: plain.update(
        d=tk.stream_phase_b_plain(*sargs, return_work=True)), 1, warm=False)

    # B, C and D share one bound (bcd_bound)
    n_slots = int(run.long().sum())
    _, _, blocks_c, tests_c = plain["c"]
    _, _, blocks_d, tests_d = plain["d"]
    n_blk, n_tst = int(blocks_d.sum()), int(tests_d.sum())
    b_bcd = bcd_bound(n_blk, min(n_tst, cam["cull_pairs"]), T, K)
    work = dict(bound_blocks=n_blk,
                bound_tests=min(n_tst, cam["cull_pairs"]),
                d_tests=n_tst)
    entry("phase_b", "hairpt_torch/csrc/tiled.cu",
          "hairpt/ops/pallas_tiled.py:396", errs["phase_b"],
          cuda_ms(lambda: tk.phase_b(*args, bounds), 3), plain_b, b_bcd,
          blocks_read=n_slots, ray_cluster_tests=cam["cull_pairs"],
          cull_pass_share=cam["cull_share"], **work)
    entry("phase_b_oct", "hairpt_torch/csrc/octets.cu",
          "hairpt/ops/pallas_tiled.py:286", errs["phase_b_oct"],
          cuda_ms(lambda: tk.phase_b_oct(*oargs), 3), plain_c, b_bcd,
          blocks_read=int(blocks_c.sum()),
          ray_cluster_tests=int(tests_c.sum()), **work)
    entry("stream_phase_b", "hairpt_torch/csrc/octets.cu",
          "hairpt/ops/pallas_tiled.py:621", errs["stream_phase_b"],
          cuda_ms(lambda: tk.stream_phase_b(*sargs), 3), plain_d, b_bcd,
          blocks_read=n_blk, ray_cluster_tests=n_tst, **work)
    return out


def phase_b_variants(scene, report):
    """Kernels B, C and D on the first routing pass of each whole wave:
    their times beside the bound they share (bcd_bound, from kernel D's
    plain version's work on the wave), and how full the octets are. A
    warp of kernel C holds four octets; a slot saves a warp's work only
    when all four of its bits are clear, otherwise only lanes idle."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C, _, K = sw.seg_rows_t.shape
    q = scene.config.tiled_q
    qo = min(max(256, q // 4), q)
    ks = itiled.KeySpace(C)
    seg = sw.seg_rows_t
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    out = {}
    for name, w in report.items():
        key = ks.keys(w["te"])
        slots, cnt, tmin, tscale, _, _, oct_sl = itiled._tile_slots(
            key, ks, q, oct=w["oct"])
        strm = itiled._octet_streams(key, ks, w["oct"], q, qo)[:6]
        args = (slots, cnt, tmin, tscale, w["r8"], w["tpm"], seg, bounds)
        ms_b = cuda_ms(lambda: tk.phase_b(*args), 3)
        run = tk.phase_b(*args, False, True)[2]
        _, _, blocks_d, tests_d = tk.stream_phase_b_plain(
            *strm, w["r8"], w["tpm"], seg, return_work=True)
        n_tst = min(int(tests_d.sum()), w["cull_pairs"])
        b, by = bcd_bound(int(blocks_d.sum()), n_tst, slots.shape[0], K)
        b_d, _ = bcd_bound(int(blocks_d.sum()), int(tests_d.sum()),
                           slots.shape[0], K)
        ms_c = cuda_ms(lambda: tk.phase_b_oct(
            slots, cnt, tmin, tscale, oct_sl, w["r8"], w["tpm"], seg), 3)
        ms_d = cuda_ms(lambda: tk.stream_phase_b(*strm, w["r8"], w["tpm"],
                                                 seg), 3)
        used = torch.arange(q, device=slots.device)[None] < cnt[:, None]
        m8 = oct_sl[used]
        lanes = float(sum(((m8 >> o) & 1).sum() for o in range(8))) \
            / max(1, 8 * m8.numel())
        idle_warps = float(((m8 & 0x0F) == 0).sum() + ((m8 & 0xF0) == 0)
                           .sum()) / max(1, 2 * m8.numel())
        n_slots = int(run.long().sum())
        log(f"{name} wave, first routing pass: kernel B {ms_b:.3f} ms "
            f"({n_slots} slots before the early exits, "
            f"{w['cull_share']:.4f} of their (ray, slot) pairs pass the "
            f"slot cull), kernel C {ms_c:.3f} ms, kernel D {ms_d:.3f} ms; "
            f"shared bound {b:.3f} ms by {by} ({n_tst} tests, "
            f"{int(blocks_d.sum())} blocks; {b_d:.3f} ms from D's "
            f"{int(tests_d.sum())} tests), B {ms_b / b:.1f}x, C "
            f"{ms_c / b:.1f}x, D {ms_d / b:.1f}x; over the {m8.numel()} "
            f"routed slots, octet bits set {lanes:.4f}, warps with all four "
            f"bits clear {idle_warps:.4f}")
        out[name] = dict(b_ms=ms_b, c_ms=ms_c, d_ms=ms_d, bound_ms=b,
                         bound_ms_d=b_d, bound_by=by,
                         cull_share=w["cull_share"],
                         octet_bits=lanes, idle_warps=idle_warps)
    return out


def check_modes(scene, wv):
    """Phase 2b: whole waves through the octet and stream modes against
    the dense query. Returns the octet kernels' launches over these
    queries."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    q = scene.config.tiled_q
    ref = {}
    for name, ray in wv.items():
        itiled.tiled_closest_hit(sw, ray, q_max=q)      # warm
        torch.cuda.synchronize()
        t0 = time.time()
        ref[name] = (itiled.tiled_closest_hit(sw, ray, q_max=q),
                     itiled.tiled_any_hit(sw, ray, q_max=q))
        torch.cuda.synchronize()
        log(f"{name} wave, dense: closest and any-hit queries "
            f"{time.time() - t0:.3f} s")
    torch.cuda.synchronize()
    tk.reset_counts()
    for kw in (dict(octets=True), dict(streams=True)):
        label = "octets" if "octets" in kw else "streams"
        for name, ray in wv.items():
            (t_d, p_d), occ_d = ref[name]
            itiled.STATS.update(max_passes=0, overflow_tiles=0)
            t0 = time.time()
            t_m, p_m = itiled.tiled_closest_hit(sw, ray, q_max=q, **kw)
            occ_m = itiled.tiled_any_hit(sw, ray, q_max=q, **kw)
            torch.cuda.synchronize()
            secs = time.time() - t0
            passes, ovf = (itiled.STATS["max_passes"],
                           itiled.STATS["overflow_tiles"])
            agree, t_rel, _ = compare(t_m, p_m, t_d, p_d)
            hits_equal = bool(torch.equal(p_m >= 0, p_d >= 0))
            occ_equal = bool(torch.equal(occ_m, occ_d))
            log(f"{name} wave, {label}: closest and any-hit queries "
                f"{secs:.3f} s; closest hit flags "
                f"equal {hits_equal}, pid agree {agree:.6f}, max t rel diff "
                f"{t_rel:.3g}; over the two queries at most {passes} "
                f"completion passes, {ovf} overflow tiles; any-hit flags "
                f"equal {occ_equal} "
                f"({int(occ_m.sum())} occluded)")
            require(hits_equal and occ_equal and agree >= PID_MIN_AGREE
                    and t_rel <= T_RTOL,
                    f"{name}/{label}: differs from the dense query")
    torch.cuda.synchronize()
    launches = dict(tk.OCT_LAUNCHES)
    require(all(v > 0 for v in launches.values()),
            f"an octet-mode kernel was not launched: {launches}")
    require(all(v == 0 for v in tk.OCT_PLAIN_ON_CUDA.values()),
            f"plain versions ran on CUDA tensors: {tk.OCT_PLAIN_ON_CUDA}")
    return launches


def check_chunk_kernel(scene, wv):
    """Phase 2c: kernel E against its plain version on >= 8,192 of each
    wave's swept chunks (all the camera wave's chunks for the timing)."""
    import torch
    from hairpt_torch.ops import intersect_swept as iswept
    from hairpt_torch.ops import phaseb_kernels as pk

    sw = scene.arrays.hair_swept
    C, _, K = sw.seg_rows_t.shape
    cfg = scene.config
    err = 0.0
    entry = None
    for name, ray in wv.items():
        slots, _ = iswept._phase_a_dense(sw, ray, cfg.swept_pmax)
        chunk_cl, chunk_ray, _, _ = iswept._route_pairs(slots, C,
                                                        cfg.swept_chunk)
        rays = iswept._chunk_rays(ray, chunk_ray)
        n = chunk_cl.shape[0]
        live = torch.nonzero(chunk_cl >= 0).squeeze(1)
        sel = torch.linspace(0, live.numel() - 1, min(E_SUBSET_CHUNKS,
                                                      live.numel()),
                             device=live.device).round().long()
        idx = torch.unique(torch.cat([live[sel], torch.arange(
            min(n, 64), device=live.device) + n - min(n, 64)]))
        t_k, p_k = pk.phase_b_chunks(chunk_cl, rays, sw.seg_rows_t)
        t_p, p_p = pk.phase_b_chunks_plain(chunk_cl[idx], rays[idx],
                                           sw.seg_rows_t)
        agree, t_rel, t_abs = compare(t_k[idx], p_k[idx], t_p, p_p)
        pid_equal = bool(torch.equal(p_k[idx], p_p))
        hits_equal = bool(torch.equal(p_k[idx] >= 0, p_p >= 0))
        log(f"{name}: kernel E on {n} chunks ({live.numel()} live) vs plain "
            f"on {idx.numel()}: pid equal {pid_equal} (agree {agree:.6f}), "
            f"hit flags equal {hits_equal}, max t rel diff {t_rel:.3g}, "
            f"hits {int((p_k[idx] >= 0).sum())}")
        require(pid_equal and hits_equal and t_rel <= T_RTOL,
                f"{name}: kernel E pid equal {pid_equal} (agreement "
                f"{agree}), hit flags equal {hits_equal}, t rel diff "
                f"{t_rel}")
        err = max(err, t_abs)
        if name == "camera":
            ms = cuda_ms(lambda: pk.phase_b_chunks(chunk_cl, rays,
                                                   sw.seg_rows_t), 3)
            plain_ms = cuda_ms(lambda: pk.phase_b_chunks_plain(
                chunk_cl, rays, sw.seg_rows_t), 1, warm=False)
            ch = cfg.swept_chunk
            n_live = live.numel()
            b, by = bound_ms(n * (4 + 8 * ch * 4 + ch * 8)
                             + n_live * 16 * K * 4,
                             n_live * ch * K * CHUNK_CYL_FLOPS)
            log(f"phase_b_chunks: {ms:.3f} ms at the camera wave ({n} "
                f"chunks, {n_live} live; bound {b:.3f} ms, by {by}), plain "
                f"{plain_ms:.1f} ms")
            entry = dict(name="phase_b_chunks", route="cuda",
                         source="hairpt_torch/csrc/phaseb.cu",
                         replaces="hairpt/ops/pallas_phaseb.py:38",
                         launches=0, max_abs_err=0.0, ms=ms,
                         plain_ms=plain_ms, bound_ms=b, bound_by=by,
                         library_ms=None, chunks=n, live_chunks=n_live)
        del rays
    entry["max_abs_err"] = err
    return entry


def small_reference():
    """Phase 3: a small furball on the card and on the CPU, both
    traversals."""
    from hairpt_torch.integrators import path

    for trav in ("tiled", "swept"):
        means = {}
        for dev in ("cuda", "cpu"):
            s = bench_scene(quality=0.1, res=64, depth=8, spp=1, device=dev,
                            q=64, traversal=trav)
            means[dev] = float(path.render(s, spp=1).mean())
        rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]),
                                                      1e-12)
        log(f"small furball, {trav} (600 fibers, 64^2, depth 8): image mean "
            f"card {means['cuda']:.6f}, CPU {means['cpu']:.6f}, rel diff "
            f"{rel:.3g}")
        require(means["cpu"] > 0 and rel <= MEAN_RTOL,
                f"small {trav} render: card and CPU means differ by {rel}")


def warm_up(scene, label):
    """One warm-up wave. Returns (progress callback, the lists it fills
    with each wave's seconds and rays, the number of waves to time: two,
    or one if the warm-up took over 60 s). The caller resets the counters
    it reads, then renders the timed waves with the callback."""
    import torch
    from hairpt_torch.integrators import path

    times, rays = [], []

    def progress(done, total, secs, n_rays):
        torch.cuda.synchronize()
        times.append(secs)
        rays.append(n_rays)

    path.render(scene, spp=1, seed=0, progress=progress)
    warm = times[0]
    n_timed = 2 if warm <= 60.0 else 1
    log(f"{label}: warm-up wave {warm:.2f}s, {rays[0]:.0f} rays"
        + ("" if n_timed == 2 else "; over 60 s, so ONE timed wave"))
    times.clear()
    rays.clear()
    return progress, times, rays, n_timed


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
    from hairpt_torch.ops import intersect_swept as iswept
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import phaseb_kernels as pk
    from hairpt_torch.ops import tiled_kernels as tk

    def reset_all():
        tk.reset_counts()
        pk.reset_counts()

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

        # ---- 1. builds, all at once ----
        t0 = time.time()
        with ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(f) for f in (tk.lib, tk.oct_lib, pk.lib)]
            f_b = ex.submit(bvh._load_native)
            for f in futs:
                f.result()
            require(f_b.result() is not None, "the BVH builder did not build")
        for name, s in _native.BUILD_SECONDS.items():
            log(f"built {name} in {s:.1f}s")
        for name in ("hairpt_tiled", "hairpt_octets", "hairpt_phaseb"):
            for line in _native.BUILD_LOG.get(name, "").splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        log(f"phase 1 ({time.time() - t0:.1f}s): builds done")

        # ---- 2. kernels against plain versions, octet/stream modes ----
        t0 = time.time()
        scene = bench_scene(quality=14.0, res=1024, depth=65, spp=1,
                            device="cuda")
        sw = scene.arrays.hair_swept
        C, _, K = sw.seg_rows_t.shape
        log(f"scene: {scene.arrays.hair.p0.shape[0]} segments, C={C}, "
            f"K={K}, seg_rows_t {sw.seg_rows_t.numel() * 4 / 1e6:.1f} MB, "
            f"built in {time.time() - t0:.1f}s")
        t1 = time.time()
        wv, hit_frac = waves(scene)
        log(f"waves: camera hit fraction {hit_frac:.4f}")
        report = {}
        errs = check_kernels(scene, wv, report)
        plain_b = check_phase_b(scene, report, errs)
        kernels = time_kernels(scene, report, errs, plain_b)
        waves_b = phase_b_variants(scene, report)
        entry_b = next(k for k in kernels if k["name"] == "phase_b")
        entry_b.update(bounce_ms=waves_b["bounce"]["b_ms"],
                       bounce_bound_ms=waves_b["bounce"]["bound_ms"],
                       bounce_bound_ms_d=waves_b["bounce"]["bound_ms_d"],
                       bounce_cull_pass_share=waves_b["bounce"]["cull_share"])
        del report
        log(f"phase 2a ({time.time() - t1:.1f}s): kernels A-D match their "
            f"plain versions")
        t1 = time.time()
        oct_launches = check_modes(scene, wv)
        log(f"phase 2b ({time.time() - t1:.1f}s): octet and stream modes "
            f"give the dense answer; launches {oct_launches}")
        t1 = time.time()
        kernels.append(check_chunk_kernel(scene, wv))
        del wv
        log(f"phase 2 ({time.time() - t0:.1f}s): kernel E matches its "
            f"plain version ({time.time() - t1:.1f}s)")

        # ---- 3. small renders, card against CPU ----
        t0 = time.time()
        small_reference()
        log(f"phase 3 ({time.time() - t0:.1f}s): small renders agree")

        # ---- 4. the full-width render, tiled ----
        t0 = time.time()
        progress, times, rays, n_timed = warm_up(scene, "tiled")
        reset_all()
        itiled.STATS.update(queries=0, max_passes=0, overflow_tiles=0)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        img = path.render(scene, spp=n_timed, seed=1, progress=progress)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        off_path = dict(tk.OCT_LAUNCHES, **pk.LAUNCHES)
        plain_cuda = dict(tk.PLAIN_ON_CUDA)
        mean_tiled = float(img.mean())
        secs = sum(times) / len(times)
        rays_w = sum(rays) / len(rays)
        log(f"tiled render: {n_timed} timed waves of 1 spp at 1024^2, depth "
            f"65: {rays_w:.0f} rays/wave, {secs:.3f} s/wave, "
            f"{rays_w / secs / 1e6:.4f} Mrays/s")
        log(f"image mean {mean_tiled:.6f}, shape {tuple(img.shape)}; max "
            f"completion passes {itiled.STATS['max_passes']}, queries "
            f"{itiled.STATS['queries']}, overflow tiles "
            f"{itiled.STATS['overflow_tiles']}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"launches over the timed waves: {launches}; kernels off this "
            f"path: {off_path}; plain-version calls on CUDA tensors: "
            f"{plain_cuda}")
        require(np.isfinite(mean_tiled) and mean_tiled > 0,
                f"image mean {mean_tiled}")
        require(bool(torch.isfinite(img).all()), "non-finite pixels")
        require(all(v > 0 for v in launches.values()),
                f"a kernel was not launched on the main path: {launches}")
        require(all(v == 0 for v in off_path.values()),
                f"the tiled render ran an octet or swept kernel: {off_path}")
        require(all(v == 0 for v in plain_cuda.values()),
                f"plain versions ran on CUDA tensors: {plain_cuda}")
        log(f"phase 4 ({time.time() - t0:.1f}s): render ok")
        del img

        # ---- 5. the full-width render, swept ----
        t0 = time.time()
        scene_sw = bench_scene(quality=14.0, res=1024, depth=65, spp=1,
                               device="cuda", traversal="swept")
        del scene
        log(f"swept scene built in {time.time() - t0:.1f}s (p_max "
            f"{scene_sw.config.swept_pmax}, chunk "
            f"{scene_sw.config.swept_chunk})")
        progress, times, rays, n_sw = warm_up(scene_sw, "swept")
        reset_all()
        iswept.STATS.update(queries=0, rays=0, overflow_rays=0)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        img = path.render(scene_sw, spp=n_sw, seed=1, progress=progress)
        torch.cuda.synchronize()
        sw_launches = dict(pk.LAUNCHES)
        sw_off = dict(tk.LAUNCHES, **tk.OCT_LAUNCHES)
        sw_plain = dict(pk.PLAIN_ON_CUDA)
        mean_sw = float(img.mean())
        secs_sw = sum(times) / len(times)
        rays_sw = sum(rays) / len(rays)
        st = iswept.STATS
        log(f"swept render: {n_sw} timed waves of 1 spp at 1024^2, depth "
            f"65: {rays_sw:.0f} rays/wave, {secs_sw:.3f} s/wave, "
            f"{rays_sw / secs_sw / 1e6:.4f} Mrays/s")
        log(f"image mean {mean_sw:.6f} (ratio to the tiled render's "
            f"{mean_sw / mean_tiled:.6f}); {st['queries']} queries, "
            f"{st['overflow_rays']} of {st['rays']} live rays "
            f"({st['overflow_rays'] / max(1, st['rays']):.6f}) entered more "
            f"than p_max boxes; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"launches over the timed waves: {sw_launches}; tiled kernels: "
            f"{sw_off}; plain-version calls on CUDA tensors: {sw_plain}")
        require(np.isfinite(mean_sw) and mean_sw > 0,
                f"swept image mean {mean_sw}")
        require(bool(torch.isfinite(img).all()), "non-finite swept pixels")
        require(all(v > 0 for v in sw_launches.values()),
                f"kernel E was not launched by the swept render: "
                f"{sw_launches}")
        require(all(v == 0 for v in sw_off.values()),
                f"the swept render ran a tiled kernel: {sw_off}")
        require(all(v == 0 for v in sw_plain.values()),
                f"plain versions ran on CUDA tensors: {sw_plain}")
        log(f"phase 5 ({time.time() - t0:.1f}s): swept render ok")

        per_wave = {k: (v, n_timed) for k, v in launches.items()}
        per_wave.update({k: (v, None) for k, v in oct_launches.items()})
        per_wave.update({k: (v, n_sw) for k, v in sw_launches.items()})
        for k in kernels:
            n, waves_n = per_wave[k["name"]]
            k["launches"] = n
            k["launches_per_wave"] = n / waves_n if waves_n else None
            k["launched_by"] = ("the octet and stream queries of phase 2b"
                                if waves_n is None else
                                "the timed waves of phase 5"
                                if k["name"] == "phase_b_chunks" else
                                "the timed waves of phase 4")
        require(all(k["launches"] > 0 for k in kernels),
                "a kernel has no launches")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    log(f"total {time.time() - T_START:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
