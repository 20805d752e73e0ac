#!/usr/bin/env python3
"""Smoke run of hairpt_torch on one CUDA card: the quickest proof that the
port builds, that its kernels agree with their plain versions, and that
the full-width furball forward render runs through them, with the tiled
and with the swept traversal.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each prints one line with its elapsed seconds):
  0. the card (nvidia-smi name and power limit) and torch/CUDA versions;
  1. build the four CUDA libraries (nvcc, sm_90a: tiled.cu with kernels
     A and B, octets.cu with C and D, phaseb.cu with E, swept_cull.cu with
     the swept phase A) and the BVH builder (g++), all in parallel;
  2. build the full-width furball scene (84,000 fibers x 12 segments,
     K = 128), take a real camera wave and a first-bounce wave (uniformly
     random directions at the camera hit points, Morton-sorted as the
     bounce queries are), and
       a. hold kernel A (phase-A cull, with and without its octet output)
          and kernels B, C and D (dense, octet and stream phase B, closest
          and any hit; C and D on the routing of A's octet output, q =
          2048, stream_qo 512) against their plain PyTorch versions on
          EVERY tile of both waves, with the share of (tile, cluster)
          pairs that pass A's tile test (group_cull_plain) and of (ray,
          slot) or (ray, entry) pairs that pass the box cull of B, C and
          D; time A on both whole waves beside its bounds, and B, C and D
          beside the bound of the closest-hit function they share (the
          plain side's pairs and blocks) and beside each one's own work;
       b. run both whole waves through tiled_closest_hit / tiled_any_hit
          with octets=True and with streams=True (q = 2048, the JAX
          default stream_qo = 512) and compare each with
          the dense query; the launches of A's octet variant, C and D are
          counted over these queries;
       c. hold the swept phase-A kernel against _phase_a_dense on EVERY
          ray of the camera wave, the first-bounce wave (in lane order,
          as the swept traversal takes it) and the dead lanes at the
          camera hits (slots, cnt and n_hit equal; on the camera wave
          also with a p_max whose key lists leave shared memory), and
          kernel E (the
          swept traversal's chunk test) against its plain version on
          EVERY live chunk those slots route and a tail of dead chunks
          (t and pid bit for bit); time both on the camera and bounce
          waves beside their bounds, with the shares of padding lanes,
          dead lanes and entered sub-boxes that set kernel E's work;
     and time every kernel and its plain version at the camera wave's
     shapes;
  3. a small furball rendered on the card and with the plain versions on
     the CPU, with the tiled and with the swept traversal: the image means
     must agree, and the swept render on the card must go through both
     swept kernels (the phase-A kernel's lowest-ids branch);
  4. the full-width render (1024^2, depth 65, true Sobol', q = 2048,
     shadow-ray RR 0.01, rough plastic, baked sunsky) through SceneBuilder
     -> build -> render: one warm-up wave and two timed 1-spp waves, with
     kernels A and B's launch counts taken over the timed waves;
  3b. gradients of the small furball's mean radiance with respect to
     diffuse, specular, alpha and eta (the differentiable mode, depth 8)
     on the card and with the plain versions on the CPU: the loss and
     every gradient component must agree; then path-replay backprop
     against the differentiable mode on the card at depths 3 and 5
     (rr_depth 999, nee_rr 0);
  5. the same render with traversal='swept' (p_max 24, chunks of 64): one
     warm-up wave and one or two timed waves, the launches of the swept
     phase-A kernel and kernel E counted over them (no plain version on
     CUDA tensors, no tiled kernel);
  6. bench.py's backward phase on the phase-4 scene at depth 16: the
     gradient of mean(nan_to_num(radiance)) over the 1024^2 film (lanes in
     pixel order) with respect to a 3-vector diffuse broadcast over the
     material table, one warm-up step and two timed fwd+bwd steps; kernels
     A and B must be launched as often over the timed steps as over the
     same steps' forward passes run alone (the backward traces no query);
  7. path-replay backprop at depth 65 (the same scene with nee_rr 0): one
     warm-up step and one timed step; its red diffuse gradient must have
     phase 6's sign.
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
#  kernels C and D: t and pid bit for bit in both modes (the same
#      arithmetic without fused multiply-adds on both sides, the same
#      per-slot or per-entry stop rule, and a tie rule, the largest pid
#      at the minimum t, that no order of the lanes or warps changes)
#  kernel E: t and pid bit for bit (the same arithmetic without fused
#      multiply-adds on both sides, and a tie rule, the largest pid at the
#      minimum t, that no order of the lanes or warps changes)
#  swept phase A: slots, cnt and n_hit exactly (the same slab arithmetic,
#      and a selection by a unique integer key)
#  gradients, card vs CPU (phase 3b): the loss within GRAD_LOSS_RTOL
#      relative and each gradient component within GRAD_REL of the
#      largest |g| of the CPU's gradients (the CPU tests' bounds for the
#      port against the JAX package: the paths that diverge where float32
#      rounding flips a sampling decision move both a little)
GRAD_LOSS_RTOL = 1e-3
GRAD_REL = 1e-2
#  path-replay backprop vs the differentiable mode (phase 3b): the loss
#      within PRB_LOSS_RTOL relative and each parameter's gradient within
#      PRB_REL of its largest |g| (the JAX package's tests/test_prb.py)
PRB_LOSS_RTOL = 1e-4
PRB_REL = 5e-3
#  the diffuse albedo bench.py's backward phase starts from
BENCH_P0 = (0.143016, 0.0156076, 1.80928e-05)
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


def bench_scene(quality, res, depth, spp, device, q=2048, traversal="tiled",
                nee_rr=0.01):
    from hairpt_torch.scene.furball import furball_scene
    return furball_scene(quality=quality, res=res, depth=depth, spp=spp,
                         device=device, q=q, traversal=traversal,
                         nee_rr=nee_rr)


def with_config(scene, **fields):
    import dataclasses
    return scene._replace(config=dataclasses.replace(scene.config, **fields))


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
    """A camera wave and a first-bounce wave of the scene, as Ray, for the
    tiled kernels (the bounce wave Morton-sorted, as the tiled queries sort
    it) and for the swept ones (in lane order, as the swept traversal
    takes its rays, the missed lanes at infinity as the integrator leaves
    them, plus the dead lanes a later bounce parks at the camera hits with
    mint = maxt = 0); and the camera wave's hit fraction."""
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
    v = hit.valid
    nv = int(v.sum())
    dead = Ray(o=hit.p[v], d=d[v], mint=torch.zeros(nv, device=dev),
               maxt=torch.zeros(nv, device=dev))
    # the swept bounce wave's missed lanes start where the integrator puts
    # them: at the miss's hit point o + d * inf (+-inf or NaN components)
    bounce_sw = bounce._replace(o=hit.p + hit.geo_n * cfg.ray_eps)
    swept = {"camera": cam_ray, "bounce": bounce_sw, "dead": dead}
    bounce, _ = itiled._morton_sort_rays(arr.hair_swept, bounce)
    return ({"camera": cam_ray, "bounce": bounce}, swept,
            float(v.float().mean()))


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


def check_octet_kernels(name, kname, kern, plain, T, dev):
    """Phase 2a: kernel C or D against its plain version on EVERY tile of
    a wave, closest and any hit: t and pid bit for bit (the same stop
    rules and the same tie rule on both sides). Logs the share of (ray,
    slot) or (ray, entry) pairs that pass the kernel's cull. Returns the
    closest-hit facts: the kernel's culled pairs, the plain version's
    tests and blocks (its work) and its time, and the largest |t diff|
    where both sides hit, over both modes."""
    import torch
    out = {}
    t_err = 0.0
    for any_hit in (False, True):
        mode = "any" if any_hit else "closest"
        pairs = torch.zeros((T,), dtype=torch.int32, device=dev)
        t_k, p_k = kern(any_hit, pairs)
        res = {}
        ms = cuda_ms(lambda: res.update(p=plain(any_hit)), 1, warm=False)
        t_p, p_p, blocks, tests = res.pop("p")
        n_t = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
        n_p = int((p_k != p_p).sum())
        hits_equal = bool(torch.equal(p_k >= 0, p_p >= 0))
        n_pairs, n_tests = int(pairs.long().sum()), int(tests.sum())
        unit = "slot" if kname == "phase_b_oct" else "entry"
        log(f"{name}: {kname} {mode} on all {T} tiles (plain {ms:.1f} ms): "
            f"t bits differing {n_t}, pid differing {n_p}, hit flags equal "
            f"{hits_equal}, hits {int((p_k >= 0).sum())}; (ray, {unit}) "
            f"pairs the octet bits leave {n_tests}, passing the cull "
            f"{n_pairs} ({n_pairs / max(1, n_tests):.4f}); blocks "
            f"{int(blocks.sum())}")
        require(n_t == 0 and n_p == 0,
                f"{name}/{mode}: {kname} differs from its plain version on "
                f"{n_t} t and {n_p} pid of {64 * T} rays")
        t_err = max(t_err, compare(t_k, p_k, t_p, p_p)[2])
        if not any_hit:
            out = dict(pairs=n_pairs, tests=n_tests,
                       blocks=int(blocks.sum()), plain_ms=ms)
    out["t_err"] = t_err
    return out


def check_kernels(scene, wv, report):
    """Phase 2a: kernel A (both instances) against its plain version on
    every tile of each wave, and kernels C and D on every tile of the
    routing that A's octet instance gives."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C = sw.seg_rows_t.shape[0]
    q = scene.config.tiled_q
    qo = min(max(256, q // 4), q)     # the JAX default stream_qo
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    ks = itiled.KeySpace(C)
    seg = sw.seg_rows_t
    errs = {k: 0.0 for k in ("cull_phase_a", "cull_phase_a_oct", "phase_b",
                             "phase_b_oct", "stream_phase_b")}
    for name, ray in wv.items():
        ray_p, _ = itiled._pad_rays(ray, tk.TILE)
        r8 = itiled.rays8_of(ray_p)
        T = r8.shape[0]
        te_k, tpm_k, oct_k, te_err, facts = check_kernel_a(r8, bounds, name)
        errs["cull_phase_a"] = max(errs["cull_phase_a"], te_err)
        errs["cull_phase_a_oct"] = max(errs["cull_phase_a_oct"], te_err)
        key = ks.keys(te_k)
        oargs = itiled._tile_slots(key, ks, q, oct=oct_k)
        oargs = oargs[:4] + oargs[6:] + (r8, tpm_k, seg, bounds)
        sargs = itiled._octet_streams(key, ks, oct_k, q, qo)[:6] \
            + (r8, tpm_k, seg, bounds)
        w = dict(r8=r8, te=te_k, tpm=tpm_k, oct=oct_k, a=facts,
                 oargs=oargs, sargs=sargs)
        w["c"] = check_octet_kernels(
            name, "phase_b_oct",
            lambda ah, pairs: tk.phase_b_oct(*oargs, ah, pairs_out=pairs),
            lambda ah: tk.phase_b_oct_plain(*oargs[:8], ah,
                                            return_work=True), T, r8.device)
        w["d"] = check_octet_kernels(
            name, "stream_phase_b",
            lambda ah, pairs: tk.stream_phase_b(*sargs, ah,
                                                pairs_out=pairs),
            lambda ah: tk.stream_phase_b_plain(*sargs[:9], ah,
                                               return_work=True), T,
            r8.device)
        errs["phase_b_oct"] = max(errs["phase_b_oct"], w["c"]["t_err"])
        errs["stream_phase_b"] = max(errs["stream_phase_b"], w["d"]["t_err"])
        report[name] = w
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
                w["t_plain"] = t_p
                w["cull_pairs"] = n_pairs
                w["cull_share"] = n_pairs / max(1, 64 * n_run)
    return plain_ms


def bcd_bound(n_blk, n_tst, T, K):
    """The least time of a phase-B kernel (B, C or D) on one routed wave
    that runs n_tst (ray, cluster) tests of K lanes and reads n_blk
    (tile, cluster) segment blocks, each once per tile, with the tiles'
    rays, bounds and results. (ms, 'bytes'/'operations')."""
    return bound_ms(n_blk * (16 * K * 4 + 4) + T * (8 * 64 * 4 + 64 * 4 + 12)
                    + T * 64 * 8, n_tst * K * CYL_FLOPS)


def function_work(r8, slots, cnt, bounds, best):
    """The work the closest-hit function of kernels B, C and D needs on
    one routed wave, from the plain side: each ray against each routed
    slot (s < cnt) whose cluster box, widened by BOX_PAD, it enters before
    its closest hit (slot_cull_plain up to min(maxt, best), best: the
    plain version's t), and the (tile, slot) blocks at least one such ray
    needs. Returns (pairs, blocks)."""
    import torch
    from hairpt_torch.ops import tiled_kernels as tk

    T, q = slots.shape
    maxt_eff = torch.minimum(r8[:, 7], best)
    lo, hi = bounds[:3].T, bounds[3:].T                      # [C, 3]
    used = torch.arange(q, device=slots.device)[None] < cnt[:, None]
    tt, ss = torch.nonzero(used, as_tuple=True)
    n_pairs = n_blk = 0
    for c0 in range(0, tt.numel(), 1 << 16):
        ti = tt[c0:c0 + (1 << 16)]
        cid = (slots[ti, ss[c0:c0 + (1 << 16)]] & tk.CID_MASK).long()
        n = tk.slot_cull_plain(r8[ti], lo[cid], hi[cid], maxt_eff[ti]).sum(1)
        n_pairs += int(n.sum())
        n_blk += int((n > 0).sum())
    return n_pairs, n_blk


def time_kernels(scene, report, errs, times):
    """The kernels line's entries of kernels A (both instances, timed
    here), B, C and D (times: phase_b_times) at the camera wave's shapes,
    with their bounds and plain versions' times."""
    import torch
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C = sw.seg_rows_t.shape[0]
    cam = report["camera"]
    r8 = cam["r8"]
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

    # B, C and D on both waves (phase_b_times)
    for kname, src, line in (("phase_b", "tiled.cu", 396),
                             ("phase_b_oct", "octets.cu", 286),
                             ("stream_phase_b", "octets.cu", 621)):
        c = dict(times["camera"][kname])
        more = {f"bounce_{k}": v for k, v in times["bounce"][kname].items()}
        ms, plain = c.pop("ms"), c.pop("plain_ms")
        bound = (c.pop("bound_ms"), c.pop("bound_by"))
        entry(kname, f"hairpt_torch/csrc/{src}",
              f"hairpt/ops/pallas_tiled.py:{line}", errs[kname], ms, plain,
              bound, bound_basis="bound_ms: the closest-hit function's work "
              "on this run's wave, the same for B, C and D (each ray against "
              "each routed cluster whose widened box it enters before its "
              "closest hit, x K lane tests, from slot_cull_plain on the "
              "plain side; the (tile, cluster) blocks at least one such ray "
              "needs, or D's distinct blocks where fewer); work_bound_ms: "
              "this kernel's own work (the pairs passing its cull, the "
              "blocks it reads)", **c, **more)
    return out


def phase_b_times(scene, report, plain_b):
    """Kernels B, C and D on the first routing pass of each whole wave
    (C and D on the routing of A's octet instance): each one's time beside
    the bound of the function they compute (function_work, the same for
    the three) and beside its own work (the pairs passing its cull, the
    blocks it reads). plain_b: kernel B's plain version's time on the
    camera wave (check_phase_b)."""
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    sw = scene.arrays.hair_swept
    C, _, K = sw.seg_rows_t.shape
    q = scene.config.tiled_q
    ks = itiled.KeySpace(C)
    seg = sw.seg_rows_t
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    out = {}
    for name, w in report.items():
        slots, cnt, tmin, tscale, _, _ = itiled._tile_slots(
            ks.keys(w["te"]), ks, q)
        args = (slots, cnt, tmin, tscale, w["r8"], w["tpm"], seg, bounds)
        T = slots.shape[0]
        run = tk.phase_b(*args, False, True)[2]
        n_slots = int(run.long().sum())
        ms = {"phase_b": cuda_ms(lambda: tk.phase_b(*args), 5),
              "phase_b_oct": cuda_ms(lambda: tk.phase_b_oct(*w["oargs"]), 5),
              "stream_phase_b": cuda_ms(
                  lambda: tk.stream_phase_b(*w["sargs"]), 5)}
        c, d = w["c"], w["d"]
        f_pairs, f_blk = function_work(w["r8"], slots, cnt, bounds,
                                       w["t_plain"])
        n_blk = min(f_blk, d["blocks"])
        b, by = bcd_bound(n_blk, f_pairs, T, K)
        log(f"{name} wave, first routing pass: the function's work "
            f"{f_pairs} (ray, cluster) pairs, {f_blk} blocks they need "
            f"({d['blocks']} distinct blocks of D's walks); bound "
            f"{b:.3f} ms by {by}")
        own = {"phase_b": (n_slots, w["cull_pairs"],
                           plain_b if name == "camera" else None),
               "phase_b_oct": (c["blocks"], c["pairs"], c["plain_ms"]),
               "stream_phase_b": (d["blocks"], d["pairs"], d["plain_ms"])}
        out[name] = {}
        for kname, (k_blk, k_pairs, plain) in own.items():
            wb, wby = bcd_bound(k_blk, k_pairs, T, K)
            log(f"{name} wave, first routing pass: {kname} {ms[kname]:.3f} "
                f"ms, {ms[kname] / b:.1f}x the function's bound; its own "
                f"work {k_pairs} pairs past its cull "
                f"({k_pairs / max(1, f_pairs):.3f}x the function's), "
                f"{k_blk} blocks read: {wb:.3f} ms by {wby} "
                f"({ms[kname] / wb:.1f}x)")
            out[name][kname] = dict(
                ms=ms[kname], plain_ms=plain, bound_ms=b, bound_by=by,
                work_bound_ms=wb, work_bound_by=wby,
                ray_cluster_tests=k_pairs, blocks_read=k_blk,
                function_tests=f_pairs, function_blocks=n_blk)
        out[name]["phase_b"]["cull_pass_share"] = w["cull_share"]
        log(f"{name} wave: of 64 x {n_slots} (ray, slot) pairs B's cull "
            f"passes {w['cull_share']:.4f}; of the pairs the octet bits "
            f"leave C's passes {c['pairs'] / max(1, c['tests']):.4f} "
            f"({c['tests']} left), D's {d['pairs'] / max(1, d['tests']):.4f}"
            f" ({d['tests']} left)")
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


def swept_a_work(sw, ray):
    """The work the swept phase A needs on a wave, from the plain side:
    (tiles, clusters passing the tile test, per-ray tests: each ray the
    kernel tests (not padding, not one never_hits_plain skips) against
    the clusters some ray of its 64-ray tile enters, the (tile, cluster)
    pairs rays enter). The hits are _phase_a_dense's
    (torch.minimum/maximum), in pieces of 64 tiles."""
    import torch
    from hairpt_torch.ops import phaseb_kernels as pk
    from hairpt_torch.ops import tiled_kernels as tk

    N, C = ray.o.shape[0], sw.cl_lo.shape[0]
    T = -(-N // 64)
    dev = ray.o.device
    lo = [sw.cl_lo[None, :, ax] for ax in range(3)]
    hi = [sw.cl_hi[None, :, ax] for ax in range(3)]
    bounds = torch.cat([sw.cl_lo.T, sw.cl_hi.T]).contiguous()
    n_pass = n_union = n_tests = 0
    for t0 in range(0, T, 64):
        r0, r1 = t0 * 64, min(N, (t0 + 64) * 64)
        m = r1 - r0
        o = ray.o[r0:r1]
        inv = tk._inv_dir(ray.d[r0:r1])
        tn, tf = tk._slab([o[:, None, ax] for ax in range(3)],
                          [inv[:, None, ax] for ax in range(3)], lo, hi)
        hit = (tn <= tf) & (tf >= ray.mint[r0:r1, None]) \
            & (tn <= ray.maxt[r0:r1, None])
        pad = -m % 64
        hit = torch.cat([hit, torch.zeros((pad, C), dtype=torch.bool,
                                          device=dev)])
        union = hit.view(-1, 64, C).any(dim=1)                # [t, C]
        tested = ~pk.never_hits_plain(o, inv, ray.mint[r0:r1],
                                      ray.maxt[r0:r1])
        ranged = torch.cat([tested, torch.zeros(pad, dtype=torch.bool,
                                                device=dev)]).view(-1, 64)
        n_union += int(union.sum())
        n_tests += int((union.sum(1) * ranged.sum(1)).sum())
        r8 = torch.zeros((union.shape[0] * 64, 8), device=dev)
        r8[:m, 0:3], r8[:m, 3:6] = o, ray.d[r0:r1]
        r8[:m, 6], r8[:m, 7] = ray.mint[r0:r1], ray.maxt[r0:r1]
        r8 = r8.view(-1, 64, 8).transpose(1, 2).contiguous()
        n_pass += int(tk.group_cull_plain(r8, bounds, ranged).sum())
    return T, n_pass, n_tests, n_union


def check_swept_kernels(scene, wv):
    """Phase 2c: the swept phase-A kernel against _phase_a_dense on EVERY
    ray of the camera, first-bounce and dead-lane waves (slots, cnt and
    n_hit equal), and kernel E against its plain version on EVERY live
    chunk the kernel's slots route, and on a tail of dead chunks (t and
    pid bit for bit); both timed on the camera and bounce waves beside
    their bounds, with the shares that set kernel E's work. Returns the
    two entries of the kernels line."""
    import torch
    from hairpt_torch.core.math import Ray
    from hairpt_torch.ops import intersect_swept as iswept
    from hairpt_torch.ops import phaseb_kernels as pk

    sw = scene.arrays.hair_swept
    C, _, K = sw.seg_rows_t.shape
    NS = K // pk.SUBK
    cfg = scene.config
    p_max, ch = cfg.swept_pmax, cfg.swept_chunk
    ent_a = dict(name="swept_phase_a", route="cuda",
                 source="hairpt_torch/csrc/swept_cull.cu",
                 replaces="hairpt/ops/intersect_swept.py:220 (XLA, no "
                 "Pallas kernel)", launches=0, max_abs_err=0.0,
                 library_ms=None)
    ent_e = dict(name="phase_b_chunks", route="cuda",
                 source="hairpt_torch/csrc/phaseb.cu",
                 replaces="hairpt/ops/pallas_phaseb.py:38", launches=0,
                 max_abs_err=0.0, library_ms=None)
    for name, ray in wv.items():
        N = ray.o.shape[0]
        # -- the phase-A kernel, every ray --
        slots, cnt, n_hit = pk.swept_phase_a(sw, ray, p_max)
        out = {}
        plain_a = cuda_ms(lambda: out.update(p=iswept._phase_a_dense(
            sw, ray, p_max, return_n_hit=True)), 1, warm=False)
        s_p, c_p, n_p = out.pop("p")
        eq = [bool(torch.equal(x, y)) for x, y in
              ((slots, s_p), (cnt, c_p), (n_hit, n_p))]
        del s_p, c_p, n_p
        o_l = pk.tile_order(sw, ray).long()        # the kernel's tiles
        T, n_pass, n_tests, n_union = swept_a_work(
            sw, Ray(ray.o[o_l], ray.d[o_l], ray.mint[o_l], ray.maxt[o_l]))
        log(f"{name}: swept phase A on all {N} rays (plain {plain_a:.1f} "
            f"ms): slots equal {eq[0]}, cnt equal {eq[1]}, n_hit equal "
            f"{eq[2]}; boxes entered per ray "
            f"{float(n_hit.float().mean()):.2f}, rays over p_max "
            f"{int((n_hit > p_max).sum())}; in the kernel's tiles the tile "
            f"test passes {n_pass / (T * C):.5f} of the (tile, cluster) "
            f"pairs, rays enter {n_union / (T * C):.5f}; per-ray tests "
            f"needed {n_tests}")
        require(all(eq), f"{name}: the swept phase-A kernel differs from "
                f"_phase_a_dense (slots, cnt, n_hit equal: {eq})")
        if name == "camera":
            # key lists past the kernel's shared-memory list (SMEM_K): the
            # camera rays enter 45 boxes on average, many over SMEM_K
            pl = pk.SMEM_K + 32
            long_k = pk.swept_phase_a(sw, ray, pl)
            long_p = iswept._phase_a_dense(sw, ray, pl, return_n_hit=True)
            eq_l = [bool(torch.equal(x, y)) for x, y in zip(long_k, long_p)]
            ms_l = cuda_ms(lambda: pk.swept_phase_a(sw, ray, pl), 3)
            log(f"{name}: swept phase A with p_max {pl} (key lists in "
                f"global memory) on all {N} rays: slots, cnt, n_hit equal "
                f"{eq_l}; rays keeping over {pk.SMEM_K} "
                f"{int((long_p[1] > pk.SMEM_K).sum())}; {ms_l:.3f} ms")
            require(all(eq_l) and int((long_p[1] > pk.SMEM_K).sum()) > 0,
                    f"{name}: the swept phase-A kernel with p_max {pl} "
                    f"differs from _phase_a_dense ({eq_l}) or keeps no list "
                    f"past SMEM_K")
            ent_a["long_list_p_max"], ent_a["long_list_ms"] = pl, ms_l
            del long_k, long_p
        # -- kernel E, every live chunk and a tail of dead ones --
        chunk_cl, chunk_ray, _, _ = iswept._route_pairs(slots, C, ch)
        rays = iswept._chunk_rays(ray, chunk_ray)
        n = chunk_cl.shape[0]
        live = torch.nonzero(chunk_cl >= 0).squeeze(1)
        idx = torch.cat([live, torch.arange(n - min(n, 64), n,
                                            device=live.device)]).unique()
        t_k, p_k = pk.phase_b_chunks(chunk_cl, rays, sw.seg_rows_t,
                                     sw.sub_lo, sw.sub_hi)
        out = {}
        plain_e = cuda_ms(lambda: out.update(p=pk.phase_b_chunks_plain(
            chunk_cl[idx], rays[idx], sw.seg_rows_t)), 1, warm=False)
        t_p, p_p = out.pop("p")
        t_bits = bool(torch.equal(t_k[idx].view(torch.int32),
                                  t_p.view(torch.int32)))
        pid_eq = bool(torch.equal(p_k[idx], p_p))
        n_live = live.numel()
        lr = rays[live]                                    # [n_live, 8, ch]
        pad_l = lr[:, 7] < lr[:, 6]
        n_lanes = n_live * ch
        n_valid = n_lanes - int(pad_l.sum())
        dead_l = int(((lr[:, 7] <= lr[:, 6]) & ~pad_l).sum())
        n_enter = 0
        for c0 in range(0, n_live, 16384):
            cl = chunk_cl[live[c0:c0 + 16384]].long()
            n_enter += int(pk.sub_cull_plain(
                lr[c0:c0 + 16384], sw.sub_lo.view(C, NS, 3)[cl],
                sw.sub_hi.view(C, NS, 3)[cl], pad=0.0).sum())
        n_cl = int(torch.unique(chunk_cl[live]).numel())
        log(f"{name}: kernel E on {n} chunks ({n_live} live) vs plain on "
            f"{idx.numel()} (plain {plain_e:.1f} ms): t bits equal {t_bits},"
            f" pid equal {pid_eq}, hits {int((p_k[idx] >= 0).sum())}; of the "
            f"{n_lanes} lanes of live chunks {1 - n_valid / n_lanes:.4f} are "
            f"padding, {dead_l / n_lanes:.4f} dead rays; of the {n_valid} "
            f"(ray, chunk) pairs x {NS} sub-clusters, rays enter "
            f"{n_enter / max(1, n_valid * NS):.4f} of the sub-boxes")
        require(t_bits and pid_eq, f"{name}: kernel E differs from its "
                f"plain version (t bits equal {t_bits}, pid equal {pid_eq})")
        del t_p, p_p, lr
        if name == "dead":
            continue
        # -- times and bounds --
        ms_a = cuda_ms(lambda: pk.swept_phase_a(sw, ray, p_max), 5)
        ms_sort = cuda_ms(lambda: pk.tile_order(sw, ray), 5)
        b_a = bound_ms(N * 32 + C * 24 + N * (p_max * 4 + 12),
                       T * C * TILE_TEST_FLOPS + n_tests * SLAB_FLOPS)
        d_a = bound_ms(N * 32 + C * 24 + N * (p_max * 4 + 12),
                       N * C * SLAB_FLOPS)
        ms_e = cuda_ms(lambda: pk.phase_b_chunks(
            chunk_cl, rays, sw.seg_rows_t, sw.sub_lo, sw.sub_hi), 5)
        e_bytes = n * (4 + ch * 8) + n_live * 8 * ch * 4 \
            + n_cl * (16 * K * 4 + NS * 24)
        b_e = bound_ms(e_bytes, n_enter * pk.SUBK * CHUNK_CYL_FLOPS)
        d_e = bound_ms(n * (4 + 8 * ch * 4 + ch * 8) + n_live * 16 * K * 4,
                       n_live * ch * K * CHUNK_CYL_FLOPS)
        log(f"swept_phase_a, {name} wave: {ms_a:.3f} ms, its ray order "
            f"(tile_order) {ms_sort:.3f} ms of it; bound from this wave's "
            f"work {b_a[0]:.3f} ms by {b_a[1]} "
            f"({ms_a / b_a[0]:.1f}x), dense bound {d_a[0]:.3f} ms; plain "
            f"{plain_a:.1f} ms")
        log(f"phase_b_chunks, {name} wave: {ms_e:.3f} ms; bound from this "
            f"wave's work {b_e[0]:.3f} ms by {b_e[1]} "
            f"({ms_e / b_e[0]:.1f}x), dense bound {d_e[0]:.3f} ms by "
            f"{d_e[1]}; plain {plain_e:.1f} ms")
        pre = "" if name == "camera" else "bounce_"
        ent_a.update({f"{pre}ms": ms_a, f"{pre}plain_ms": plain_a,
                      f"{pre}order_ms": ms_sort,
                      f"{pre}bound_ms": b_a[0], f"{pre}bound_by": b_a[1],
                      f"{pre}dense_bound_ms": d_a[0],
                      f"{pre}tile_pass_share": n_pass / (T * C),
                      f"{pre}tile_union_share": n_union / (T * C),
                      f"{pre}ray_tests": n_tests})
        ent_e.update({f"{pre}ms": ms_e, f"{pre}plain_ms": plain_e,
                      f"{pre}bound_ms": b_e[0], f"{pre}bound_by": b_e[1],
                      f"{pre}dense_bound_ms": d_e[0],
                      f"{pre}chunks": n, f"{pre}live_chunks": n_live,
                      f"{pre}padding_share": 1 - n_valid / n_lanes,
                      f"{pre}dead_share": dead_l / n_lanes,
                      f"{pre}sub_enter_share":
                      n_enter / max(1, n_valid * NS)})
        del rays
    ent_a["bound_basis"] = ("bound_ms: the work of this run's wave in the "
                            "kernel's tiles (every (tile, cluster) tile "
                            "test, each ray against the clusters some ray "
                            "of its tile enters); dense_bound_ms: every "
                            "ray x every cluster; ms: the wrapper, its ray "
                            "order (order_ms) included")
    ent_e["bound_basis"] = ("bound_ms: the work of this run's wave (each "
                            "ray of a live chunk against the 32 segments "
                            "of each sub-cluster box it enters, the "
                            "segment blocks of the clusters used once); "
                            "dense_bound_ms: every lane of every live "
                            "chunk x K segments")
    return [ent_a, ent_e]


def small_reference(reset_all):
    """Phase 3: a small furball on the card and on the CPU, both
    traversals; the swept render on the card goes through both swept
    kernels (the phase-A kernel in its lowest-ids branch: C = 57)."""
    from hairpt_torch.integrators import path
    from hairpt_torch.ops import phaseb_kernels as pk

    for trav in ("tiled", "swept"):
        means = {}
        for dev in ("cuda", "cpu"):
            s = bench_scene(quality=0.1, res=64, depth=8, spp=1, device=dev,
                            q=64, traversal=trav)
            reset_all()
            means[dev] = float(path.render(s, spp=1).mean())
            if trav == "swept" and dev == "cuda":
                launches = dict(pk.LAUNCHES)
                plain = dict(pk.PLAIN_ON_CUDA)
        rel = abs(means["cuda"] - means["cpu"]) / max(abs(means["cpu"]),
                                                      1e-12)
        log(f"small furball, {trav} (600 fibers, 64^2, depth 8): image mean "
            f"card {means['cuda']:.6f}, CPU {means['cpu']:.6f}, rel diff "
            f"{rel:.3g}")
        require(means["cpu"] > 0 and rel <= MEAN_RTOL,
                f"small {trav} render: card and CPU means differ by {rel}")
    log(f"small swept render on the card: launches {launches}, plain "
        f"versions on CUDA tensors {plain}")
    require(all(v > 0 for v in launches.values())
            and all(v == 0 for v in plain.values()),
            f"the small swept render did not go through both swept kernels: "
            f"launches {launches}, plain {plain}")


GRAD_PARAMS = ("diffuse", "specular", "alpha", "eta")


def scan_ad_grad(scene, params, sample=0, backward=True):
    """The differentiable mode's mean(nan_to_num(radiance)) over the film
    (lanes in pixel order, one sample index) and its gradient with
    respect to each tensor of `params` (a material field, or a tensor
    broadcast over it). Returns (loss, {name: grad},
    forward rays); no gradient and no graph when backward is False."""
    import torch
    from hairpt_torch.integrators import inverse, path

    cfg = scene.config
    dev = scene.arrays.hair.p0.device
    n = cfg.width * cfg.height
    leaves = {k: v.detach().clone().requires_grad_(backward)
              for k, v in params.items()}
    mats = scene.arrays.materials
    fields = {k: v.expand_as(getattr(mats, k)) for k, v in leaves.items()}
    li = path.make_li_fn(scene, differentiable=True)
    with torch.set_grad_enabled(backward):
        rad, _, n_rays = li(inverse.apply_params_arrays(scene.arrays,
                                                        fields),
                            torch.arange(n, device=dev),
                            torch.full((n,), sample, dtype=torch.int64,
                                       device=dev))
        loss = torch.nan_to_num(rad, nan=0.0, posinf=0.0,
                                neginf=0.0).mean()
    if backward:
        loss.backward()
    return (float(loss.detach()), {k: v.grad for k, v in leaves.items()},
            float(n_rays))


def small_gradients(reset_all):
    """Phase 3b: the small furball's gradients on the card against the
    plain versions on the CPU, and path-replay backprop against the
    differentiable mode on the card."""
    import torch
    from hairpt_torch.integrators import inverse
    from hairpt_torch.ops import tiled_kernels as tk

    res = {}
    for dev in ("cuda", "cpu"):
        s = bench_scene(quality=0.1, res=64, depth=8, spp=1, device=dev,
                        q=64)
        m = s.arrays.materials
        reset_all()
        t0 = time.time()
        res[dev] = scan_ad_grad(s, {k: getattr(m, k) for k in GRAD_PARAMS})
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(tk.LAUNCHES)
            plain = dict(tk.PLAIN_ON_CUDA)
        log(f"small furball gradients on {dev} (64^2, depth 8): loss "
            f"{res[dev][0]:.6f}, " + ", ".join(
                f"{k} {v.detach().cpu().numpy().ravel()}"
                for k, v in res[dev][1].items())
            + f" ({time.time() - t0:.1f}s)")
    (l_k, g_k, _), (l_p, g_p, _) = res["cuda"], res["cpu"]
    scale = max(float(g.abs().max()) for g in g_p.values())
    err = max(float((g_k[k].cpu() - g_p[k]).abs().max()) for k in g_p)
    rel = abs(l_k - l_p) / max(abs(l_p), 1e-12)
    log(f"card vs CPU: loss rel diff {rel:.3g}, largest gradient diff "
        f"{err:.3g} = {err / scale:.3g} of the largest |g| ({scale:.4g}); "
        f"launches {launches}, plain versions on CUDA tensors {plain}")
    require(rel <= GRAD_LOSS_RTOL and err <= GRAD_REL * scale,
            f"small furball gradients: card and CPU differ (loss {rel}, "
            f"gradient {err / scale} of the largest)")
    require(all(v > 0 for v in launches.values())
            and all(v == 0 for v in plain.values()),
            f"the card's gradients did not go through kernels A and B: "
            f"{launches}, plain {plain}")
    for depth in (3, 5):
        s = with_config(bench_scene(quality=0.1, res=64, depth=depth, spp=1,
                                    device="cuda", q=64, nee_rr=0.0),
                        rr_depth=999)
        m = s.arrays.materials
        params = {k: getattr(m, k) for k in GRAD_PARAMS}
        l_s, g_s, _ = scan_ad_grad(s, params)
        n = s.config.width * s.config.height
        pix = torch.arange(n, device=s.arrays.hair.p0.device)
        l_r, g_r = inverse.make_prb_loss_grad(s)(
            s.arrays, params, pix, torch.zeros_like(pix))
        l_r = float(l_r)
        rels = {k: float((g_r[k] - g_s[k]).abs().max()
                         / g_s[k].abs().max().clamp(min=1e-12))
                for k in params}
        lrel = abs(l_r - l_s) / max(abs(l_s), 1e-12)
        log(f"PRB vs the differentiable mode on the card, depth {depth}: "
            f"loss {l_r:.6f} / {l_s:.6f} (rel {lrel:.3g}), gradient diffs "
            f"over each one's largest |g|: "
            + ", ".join(f"{k} {v:.3g}" for k, v in rels.items()))
        require(lrel <= PRB_LOSS_RTOL and max(rels.values()) <= PRB_REL,
                f"depth {depth}: PRB differs from the differentiable mode "
                f"(loss {lrel}, gradients {rels})")


def bench_backward(scene, reset_all):
    """Phase 6: bench.py's backward phase. Returns its facts."""
    import numpy as np
    import torch
    from hairpt_torch.ops import intersect_tiled as itiled
    from hairpt_torch.ops import tiled_kernels as tk

    s = with_config(scene, max_depth=16)
    p0 = {"diffuse": torch.tensor(BENCH_P0, device=s.arrays.hair.p0.device)}
    t0 = time.time()
    scan_ad_grad(s, p0, sample=0)
    torch.cuda.synchronize()
    log(f"fwd+bwd warm-up step {time.time() - t0:.2f}s")
    reset_all()
    itiled.STATS.update(queries=0)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    steps = [scan_ad_grad(s, p0, sample=i) for i in (1, 2)]
    torch.cuda.synchronize()
    secs = (time.time() - t0) / len(steps)
    launches = dict(tk.LAUNCHES)
    queries = itiled.STATS["queries"]
    plain = dict(tk.PLAIN_ON_CUDA, **tk.OCT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _, g, rays = steps[-1]
    g = g["diffuse"].cpu().numpy()
    # the same steps' forward passes alone
    reset_all()
    itiled.STATS.update(queries=0)
    for i in (1, 2):
        scan_ad_grad(s, p0, sample=i, backward=False)
    torch.cuda.synchronize()
    fwd_launches = dict(tk.LAUNCHES)
    fwd_queries = itiled.STATS["queries"]
    log(f"fwd+bwd train step (1024^2, depth 16): {secs * 1e3:.1f} ms/step "
        f"({rays:.0f} fwd rays) -> {rays / secs / 1e6:.4f} Mrays/s; loss "
        f"{steps[-1][0]:.6f}, gradient {g}, |g| {np.abs(g).sum():.4g}; peak "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"launches over the 2 timed fwd+bwd steps {launches} ({queries} "
        f"queries); over their forward passes alone {fwd_launches} "
        f"({fwd_queries} queries); plain versions on CUDA tensors and "
        f"octet kernels: {plain}")
    require(bool(np.isfinite(g).all()) and bool(np.abs(g).sum() > 0),
            f"fwd+bwd gradient {g}")
    require(all(v > 0 for v in launches.values()),
            f"the fwd+bwd step did not launch kernels A and B: {launches}")
    require(launches == fwd_launches and queries == fwd_queries,
            f"the backward pass traced queries again: {launches} against "
            f"{fwd_launches} for the forward passes alone")
    require(all(v == 0 for v in plain.values()),
            f"plain versions or octet kernels ran: {plain}")
    return dict(ms=secs * 1e3, rays=rays, grad=g, peak=peak,
                launches={k: v / len(steps) for k, v in launches.items()})


def prb_step(scene, reset_all, bwd):
    """Phase 7: path-replay backprop at depth 65 with nee_rr 0. Returns
    its facts."""
    import numpy as np
    import torch
    from hairpt_torch.integrators import inverse
    from hairpt_torch.ops import tiled_kernels as tk

    s = with_config(scene, max_depth=65, nee_rr=0.0)
    cfg = s.config
    n = cfg.width * cfg.height
    dev = s.arrays.hair.p0.device
    pix = torch.arange(n, device=dev)
    params = {"diffuse": torch.tensor(BENCH_P0, device=dev).expand_as(
        s.arrays.materials.diffuse)}
    f = inverse.make_prb_loss_grad(s)
    t0 = time.time()
    f(s.arrays, params, pix, torch.zeros_like(pix))
    torch.cuda.synchronize()
    log(f"PRB warm-up step {time.time() - t0:.2f}s")
    reset_all()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    loss, d = f(s.arrays, params, pix, torch.ones_like(pix))
    torch.cuda.synchronize()
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(tk.LAUNCHES)
    plain = dict(tk.PLAIN_ON_CUDA)
    g = d["diffuse"].sum(0).cpu().numpy()
    log(f"PRB step (1024^2, depth 65, nee_rr 0): {secs * 1e3:.1f} ms/step; "
        f"loss {float(loss):.6f}, gradient {g}, |g| {np.abs(g).sum():.4g}; "
        f"peak memory {peak / 2**30:.2f} GiB (phase 6, depth 16: "
        f"{bwd['peak'] / 2**30:.2f} GiB); launches {launches}")
    require(bool(np.isfinite(g).all()), f"PRB gradient {g}")
    require(np.sign(g[0]) == np.sign(bwd["grad"][0]) and g[0] != 0,
            f"PRB's red diffuse gradient {g[0]} and phase 6's "
            f"{bwd['grad'][0]} differ in sign")
    require(all(v == 0 for v in plain.values()),
            f"plain versions ran on CUDA tensors: {plain}")
    return dict(ms=secs * 1e3, grad=g, peak=peak, launches=launches)


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
        with ThreadPoolExecutor(5) as ex:
            futs = [ex.submit(f) for f in (tk.lib, tk.oct_lib, pk.lib,
                                           pk.cull_lib)]
            f_b = ex.submit(bvh._load_native)
            for f in futs:
                f.result()
            require(f_b.result() is not None, "the BVH builder did not build")
        for name, s in _native.BUILD_SECONDS.items():
            log(f"built {name} in {s:.1f}s")
        for name in ("hairpt_tiled", "hairpt_octets", "hairpt_phaseb",
                     "hairpt_swept_cull"):
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
        wv, wv_sw, hit_frac = waves(scene)
        log(f"waves: camera hit fraction {hit_frac:.4f}")
        report = {}
        errs = check_kernels(scene, wv, report)
        plain_b = check_phase_b(scene, report, errs)
        times = phase_b_times(scene, report, plain_b)
        kernels = time_kernels(scene, report, errs, times)
        del report
        log(f"phase 2a ({time.time() - t1:.1f}s): kernels A-D match their "
            f"plain versions")
        t1 = time.time()
        oct_launches = check_modes(scene, wv)
        log(f"phase 2b ({time.time() - t1:.1f}s): octet and stream modes "
            f"give the dense answer; launches {oct_launches}")
        t1 = time.time()
        kernels += check_swept_kernels(scene, wv_sw)
        del wv, wv_sw
        log(f"phase 2 ({time.time() - t0:.1f}s): the swept phase A and "
            f"kernel E match their plain versions ({time.time() - t1:.1f}s)")

        # ---- 3. small renders, card against CPU ----
        t0 = time.time()
        small_reference(reset_all)
        log(f"phase 3 ({time.time() - t0:.1f}s): small renders agree")
        t0 = time.time()
        small_gradients(reset_all)
        log(f"phase 3b ({time.time() - t0:.1f}s): small gradients agree")

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
        sw_plain = dict(pk.PLAIN_ON_CUDA, **tk.PLAIN_ON_CUDA)
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
                f"a swept kernel was not launched by the swept render: "
                f"{sw_launches}")
        require(all(v == 0 for v in sw_off.values()),
                f"the swept render ran a tiled kernel: {sw_off}")
        require(all(v == 0 for v in sw_plain.values()),
                f"plain versions ran on CUDA tensors: {sw_plain}")
        log(f"phase 5 ({time.time() - t0:.1f}s): swept render ok")
        del scene_sw, img

        # ---- 6. bench.py's backward phase: fwd+bwd at depth 16 ----
        t0 = time.time()
        bwd = bench_backward(scene, reset_all)
        log(f"phase 6 ({time.time() - t0:.1f}s): fwd+bwd step ok")

        # ---- 7. path-replay backprop at depth 65 ----
        t0 = time.time()
        prb = prb_step(scene, reset_all, bwd)
        log(f"phase 7 ({time.time() - t0:.1f}s): PRB step ok")

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
                                if k["name"] in sw_launches else
                                "the timed waves of phase 4")
        for k in kernels:
            if k["name"] in bwd["launches"]:
                k["launches_per_fwd_bwd_step"] = bwd["launches"][k["name"]]
                k["launches_per_prb_step"] = prb["launches"][k["name"]]
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
