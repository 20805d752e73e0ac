"""The Markov chains of hairpt_torch's path-space MLT against hairpt's on
the CPU, step by step, on the mirror box of tests/test_mlt_mutators.py
(torch_mlt_scenes.mirror_box).

hairpt's render_mlt runs its rounds inside one jitted lax.scan and keeps
only the image; _jax_chains drives the same chains from hairpt's own
_record_path and _step_* functions (each jitted once), with the scan
body's accept rule, salts and deposits, and keeps every step. The port's
mlt_chains yields the same per step. A chain amplifies a last-bit
difference where a pool pick or an accept test falls within rounding of
its threshold: at most CHAINS_DIFFER of the chains may start from
another pool lane or differ in an accept flag, and the image of the
others, splatted by the port's film from each package's deposits, is
held by torch_light_scenes.compare. The transcription itself is held to
hairpt's render_mlt at the same size first (the same compare)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.core import rng as jrng
from hairpt.film import film as jfilm
from hairpt.integrators import mlt as jm
from hairpt_torch.film import film as tfilm
from hairpt_torch.integrators import mlt as tm
import torch_light_scenes as tls
import torch_mlt_scenes as tms
from torch_threads import one_thread  # noqa: F401

RES = 16
LANES = 512
N_BOOT = 16
N_MUT = 10          # two rounds of the five phases: both bidir classes
SEED = 1
# the share of chains that may start from another pool lane or differ in
# an accept flag
CHAINS_DIFFER = 0.02


@pytest.fixture(scope="module")
def box():
    return tls.build(tms.mirror_box, res=RES)


def _jax_chains(js, n, n_mut, seed, n_boot=N_BOOT, p_large=0.3,
                lens_sigma=0.03):
    """hairpt's render_mlt, step by step: (b, pick, [(((pix, dep),
    (pix_p, dep_p)), acc) per step])."""
    cfg, arr = js.config, js.arrays
    W, H = cfg.width, cfg.height
    idx = jnp.arange(n, dtype=jnp.uint32)
    ctx = jm._Ctx(scene=js, arr=arr, kinds=js.active_kinds, n=n, idx=idx,
                  cam_o=js.camera.to_world[:3, 3], seed=seed,
                  lens_sigma=lens_sigma)
    phases = ["lens", "caustic", "manifold", "bidir", "mchain"]
    fns = {"lens": lambda s, it: jm._step_lens(ctx, s, it, p_large),
           "caustic": lambda s, it: jm._step_caustic(ctx, s, it),
           "manifold": lambda s, it: jm._step_manifold(ctx, s, it),
           "mchain": lambda s, it: jm._step_mchain(ctx, s, it),
           "bidir0": lambda s, it: jm._step_bidir(ctx, s, it),
           "bidir1": lambda s, it: jm._step_bidir2(ctx, s, it)}
    fns = {k: jax.jit(f) for k, f in fns.items()}
    idx_pool = jnp.arange(n * n_boot, dtype=jnp.uint32)
    u = jrng.uniform_2d(idx_pool, jnp.uint32(seed * 7919 + 5), 0)
    pool = jax.jit(lambda p: jm._record_path(
        js, arr, p, jnp.uint32(seed * 131 + 1)))(
        jnp.stack([u[:, 0] * W, u[:, 1] * H], -1))
    l_pool = jm._lum(jm.traj_w(pool))
    b = jnp.mean(l_pool)
    cdf = jnp.cumsum(l_pool) / jnp.maximum(jnp.sum(l_pool), 1e-20)
    pick = jnp.clip(jnp.searchsorted(
        cdf, jrng.uniform_1d(idx, jnp.uint32(seed + 9), 0)), 0,
        n * n_boot - 1)
    st = jm._lane_gather(pool, pick)
    steps = []
    n_rounds = max(n_mut // len(phases), 1)
    for r in range(n_rounds):
        for ph_i, ph in enumerate(phases):
            it = jnp.uint32(r * len(phases) + ph_i)
            key = ph if ph != "bidir" else f"bidir{r % 2}"
            prop, a = fns[key](st, it)
            w_x = jm.traj_w(st)
            l = jm._lum(w_x)
            w_cur = jnp.where(l > 1e-12, (1.0 - a) / jnp.maximum(l, 1e-12),
                              0.0)
            w_p = jm.traj_w(prop)
            l_p = jm._lum(w_p)
            wp = jnp.where(l_p > 1e-12, a / jnp.maximum(l_p, 1e-12), 0.0)
            acc = jrng.uniform_1d(idx, jnp.uint32(seed + 4 + 13 * ph_i),
                                  it) < a
            steps.append((((st.pix, w_x * w_cur[:, None]),
                           (prop.pix, w_p * wp[:, None])), acc))
            st = jm._lane_select(acc, prop, st)
    return b, pick, steps, n_rounds * len(phases)


def test_chains_match_jax_step_by_step(box):
    js, cs = box
    cfg = js.config
    b_j, pick_j, steps_j, total = _jax_chains(js, LANES, N_MUT, SEED)
    scale_j = float(b_j) * (cfg.width * cfg.height) / (LANES * total)
    # the transcription against hairpt's own render
    ref = np.asarray(jm.render_mlt(js, n_chains=LANES, n_mutations=N_MUT,
                                   seed=SEED, n_boot=N_BOOT))
    img = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    for deps, _ in steps_j:
        for p, w in deps:
            img = jfilm.splat_add_only(js.film, p, w, img)
    tls.compare(np.asarray(img) * scale_j, ref)

    chains = tm.mlt_chains(cs, n_chains=LANES, n_mutations=N_MUT,
                           seed=SEED, n_boot=N_BOOT)
    assert chains.total_steps == total
    steps_t = list(chains.steps)
    assert [s.phase for s in steps_t] == ["lens", "caustic", "manifold",
                                          "bidir", "mchain"] * 2
    acc_t = np.stack([s.acc.numpy() for s in steps_t])
    acc_j = np.stack([np.asarray(a) for _, a in steps_j])
    agree = (chains.pick.numpy() == np.asarray(pick_j)) \
        & (acc_t == acc_j).all(0)
    assert 1.0 - agree.mean() <= CHAINS_DIFFER, agree.mean()
    # the lens steps (0 and 5) move chains; the others rarely match
    assert 0.05 < acc_t[[0, 5]].mean() < 0.95 and acc_t.mean() > 0.01
    np.testing.assert_allclose(float(chains.b), float(b_j), rtol=1e-4)
    keep = torch.as_tensor(agree)[:, None]
    img_t = torch.zeros(cfg.height, cfg.width, 3)
    img_j = torch.zeros(cfg.height, cfg.width, 3)
    for st, (dj, _) in zip(steps_t, steps_j):
        for (p, w), (pj, wj) in zip(st.splats, dj):
            img_t = tfilm.splat_add_only(cs.film, p, w * keep, img_t)
            img_j = tfilm.splat_add_only(
                cs.film, torch.as_tensor(np.array(pj)),
                torch.as_tensor(np.array(wj)) * keep, img_j)
    scale_t = float(chains.b) * (cfg.width * cfg.height) / (LANES * total)
    tls.compare(img_t * scale_t, img_j.numpy() * scale_j)
    # render_mlt is the same sum, scaled
    img_r = tm.render_mlt(cs, n_chains=LANES, n_mutations=N_MUT, seed=SEED,
                          n_boot=N_BOOT)
    img_all = torch.zeros(cfg.height, cfg.width, 3)
    for st in steps_t:
        for p, w in st.splats:
            img_all = tfilm.splat_add_only(cs.film, p, w, img_all)
    np.testing.assert_allclose(img_r.numpy(), (img_all * scale_t).numpy(),
                               rtol=1e-5, atol=1e-7)
