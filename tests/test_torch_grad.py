"""The port's gradient path against the JAX package: the differentiable
mode of make_li_fn (checkpointed bounces, detached sampling, no RR) on
the small furball of tests/torch_furball.py at depth 3, and the
inverse-rendering loop (fit) on a 16^2 film.

The JAX side runs as hairpt's own tests run it (Pallas in interpret mode)
and is compiled once per module: value_and_grad of the mean radiance,
and a forward-mode derivative for alpha. hairpt's reverse-mode alpha
gradient is NaN on this scene: its Beckmann NDF (computed for every lane,
then lane-selected) divides by max(pi a^2 cos^4, 1e-20), and at a lane
whose half vector points below the surface the VJP of that division
under XLA:CPU, which flushes the denormal 1e-40 to zero, is 0 / 0; lax.max
passes the NaN on by multiplying it with its 0 mask. Forward mode selects
the tangent instead, and the port's backward (torch's where and clamp)
does too, so alpha is held to JAX's jvp."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairpt.integrators import inverse as jinv
from hairpt.integrators import path as jpath
from hairpt_torch import convert
from hairpt_torch.core import rng as trng
from hairpt_torch.integrators import inverse as tinv
from hairpt_torch.integrators import path as tpath
from hairpt_torch.ops import intersect_packed as tpk
from hairpt_torch.ops import intersect_tiled as ttl
from hairpt_torch.scene.furball import furball_floor_scene
from torch_furball import GRAD_PARAMS, jax_furball, params_of, torch_scene
from torch_threads import one_thread  # noqa: F401

RES = 32
# the loss (the mean radiance) within 1e-3 relative, as the forward
# render's image mean (tests/test_torch_path.py): a few paths diverge
# where float32 rounding flips a sampling decision. Each gradient
# component within 1e-2 of the largest |g| of the JAX gradient (measured
# here: 7e-4; the diverging paths move the small eta and alpha
# components by 1-2% of their own size)
LOSS_RTOL = 1e-3
GRAD_REL = 1e-2


@pytest.fixture(scope="module")
def grads():
    """Both packages' loss and gradients on one params dict, and the
    port's query counts after its forward and after its backward pass."""
    scene = jax_furball(res=RES, depth=3)
    params = params_of(scene)
    n = RES * RES
    li_j = jpath.make_li_fn(scene, differentiable=True)
    pix_j = jnp.arange(n, dtype=jnp.uint32)
    smp_j = jnp.zeros((n,), jnp.uint32)

    def loss_j(p):
        arrs = jinv.apply_params_arrays(scene.arrays, p, scene.marschner_rows)
        return jnp.mean(li_j(arrs, pix_j, smp_j)[0])

    pj = {k: jnp.asarray(v) for k, v in params.items()}
    l_j, g_j = jax.jit(jax.value_and_grad(loss_j))(pj)
    tangent = {k: jnp.zeros_like(v) for k, v in pj.items()}
    tangent["alpha"] = jnp.ones_like(pj["alpha"])
    _, d_alpha = jax.jit(lambda p, t: jax.jvp(loss_j, (p,), (t,)))(
        pj, tangent)
    g_j = {k: np.asarray(v) for k, v in g_j.items()}
    g_j["alpha"] = np.asarray(d_alpha).reshape(g_j["alpha"].shape)

    ts = torch_scene(scene)
    pt = convert.params_to_torch(params, device="cpu")
    li_t = tpath.make_li_fn(ts, differentiable=True)
    rad, _, _ = li_t(tinv.apply_params_arrays(ts.arrays, pt,
                                              ts.marschner_rows),
                     torch.arange(n), torch.zeros(n, dtype=torch.int64))
    loss_t = rad.mean()
    q_fwd = ttl.STATS["queries"]
    loss_t.backward()
    q_bwd = ttl.STATS["queries"]
    g_t = convert.grads_to_numpy({k: v.grad for k, v in pt.items()})
    return dict(l_j=float(l_j), g_j=g_j, l_t=float(loss_t.detach()),
                g_t=g_t, q_fwd=q_fwd, q_bwd=q_bwd, ts=ts, scene=scene)


def test_scan_ad_loss_matches_jax(grads):
    assert grads["l_j"] > 0
    assert abs(grads["l_t"] - grads["l_j"]) / grads["l_j"] < LOSS_RTOL


@pytest.mark.parametrize("name", GRAD_PARAMS)
def test_scan_ad_gradient_matches_jax(grads, name):
    g_j, g_t = grads["g_j"], grads["g_t"]
    scale = max(np.abs(v).max() for v in g_j.values())
    assert np.isfinite(g_t[name]).all() and np.isfinite(g_j[name]).all()
    assert g_t[name].shape == g_j[name].shape
    np.testing.assert_allclose(g_t[name], g_j[name], rtol=0,
                               atol=GRAD_REL * scale, err_msg=name)


def test_backward_traces_no_query(grads):
    """The checkpointed bounces get their query results back on
    recomputation: the backward pass runs no closest-hit or any-hit
    query, on the furball and on a mesh scene (the furball over a
    checkerboard rectangle), where the packed walk's results are stashed
    with the tiled query's."""
    assert grads["q_fwd"] > 0
    assert grads["q_bwd"] == grads["q_fwd"]
    s = furball_floor_scene(quality=0.1, res=16, depth=3, device="cpu")
    mt = s.arrays.materials
    diffuse = mt.diffuse.clone().requires_grad_()
    arr = s.arrays._replace(materials=mt._replace(diffuse=diffuse))
    n = 16 * 16
    rad, _, _ = tpath.make_li_fn(s, differentiable=True)(
        arr, torch.arange(n), torch.zeros(n, dtype=torch.int64))
    walks, queries = tpk.STATS["walks"], ttl.STATS["queries"]
    assert walks > 0 and queries > 0
    rad.mean().backward()
    assert tpk.STATS["walks"] == walks and ttl.STATS["queries"] == queries
    assert torch.isfinite(diffuse.grad).all()


def test_differentiable_forward_equals_forward_mode(grads):
    """Without RR (and below the staged widths' 4096 lanes) both modes
    trace the same paths: the same radiance bit for bit and the same ray
    count. The differentiable mode re-evaluates a smooth lobe's weight as
    f(wo) / pdf(wo), the value the forward mode's sample returns."""
    ts = grads["ts"]
    ts = ts._replace(config=dataclasses.replace(ts.config, rr_depth=999))
    n = RES * RES
    pix, smp = torch.arange(n), torch.zeros(n, dtype=torch.int64)
    with torch.no_grad():
        l0, p0, r0 = tpath.make_li_fn(ts)(ts.arrays, pix, smp)
        l1, p1, r1 = tpath.make_li_fn(ts, differentiable=True)(ts.arrays,
                                                               pix, smp)
    assert torch.equal(l0, l1) and torch.equal(p0, p1)
    assert float(r0) == float(r1)


def test_antithetic_mirrors_the_bsdf_sample_dims():
    """antithetic=True mirrors (u -> 1 - u) the BSDF sample's two dims of
    every bounce, as the JAX package's _flip; other dims, the camera's
    included, keep the primary stream."""
    n = 64
    smp = trng.Sampler(trng.INDEPENDENT, torch.arange(n),
                       torch.zeros(n, dtype=torch.int64))
    mir = tpath._Mirrored(smp, (tpath.D_BSDF_U2, tpath.D_BSDF_U2 + 1))
    for bounce in (0, 3):
        base = tpath.DIM_BASE + bounce * tpath.DIM_STRIDE
        u = smp.next_2d(base + tpath.D_BSDF_U2)
        assert torch.equal(mir.next_2d(base + tpath.D_BSDF_U2), 1.0 - u)
        for d in (tpath.D_NEE_SEL, tpath.D_BSDF_LOBE, tpath.D_RR):
            assert torch.equal(mir.next_1d(base + d), smp.next_1d(base + d))
        u = smp.next_2d(base + tpath.D_BSDF_U2 + 1)
        m = mir.next_2d(base + tpath.D_BSDF_U2 + 1)
        assert torch.equal(m[:, 0], 1.0 - u[:, 0])
        assert torch.equal(m[:, 1], u[:, 1])
    assert torch.equal(mir.next_2d(tpath.DIM_CAM_POS),
                       smp.next_2d(tpath.DIM_CAM_POS))


@pytest.mark.parametrize("rows", [1, 3, 20])
def test_gather_gradient_equals_plain_indexing(rows):
    """registry.gather's backward for a field that requires grad (_Rows:
    one masked sum per row) gives plain indexing's gradient for each
    field shape of the table ([M], [M, 3], [M, 64]), bit for bit: the
    cotangents are small integers, so every order of summation is
    exact."""
    from hairpt_torch.models.bsdf import registry as reg
    rs = np.random.default_rng(rows)
    table = reg.pack_materials(
        [reg.default_material_row(diffuse=rs.random(3), alpha=rs.random(),
                                  ext_trans=rs.random(reg.N_COS))
         for _ in range(rows)], device="cpu")
    mat_id = torch.as_tensor(rs.integers(-1, rows, 4096), dtype=torch.int32)
    m = mat_id.clamp(min=0).long()
    for name in ("alpha", "diffuse", "ext_trans"):
        field = getattr(table, name)
        g_out = torch.as_tensor(rs.integers(-8, 9, (4096,) + field.shape[1:]),
                                dtype=torch.float32)
        a = field.clone().requires_grad_()
        got = getattr(reg.gather(table._replace(**{name: a}), None,
                                 mat_id), name)
        (got * g_out).sum().backward()
        b = field.clone().requires_grad_()
        (b[m] * g_out).sum().backward()
        assert torch.equal(got, b[m])
        assert torch.equal(a.grad, b.grad)


def test_apply_params_takes_material_fields_only(grads):
    """sigma_a (a float field of the table) replaces its field and
    rebuilds the hair tables of the Marschner rows from it, with a
    gradient to it; the rough-plastic scene has none to rebuild. An
    integer field such as kind raises KeyError."""
    from hairpt_torch.models.bsdf import hair as thair
    from hairpt_torch.models.bsdf import registry as treg
    ts = grads["ts"]
    sa = torch.tensor([[0.9, 0.45, 0.25]], requires_grad=True)
    out = tinv.apply_params_arrays(ts.arrays, {"sigma_a": sa},
                                   ts.marschner_rows)
    assert out.materials.sigma_a is sa and out.hair_tables is None
    mats = ts.arrays.materials._replace(
        kind=torch.full_like(ts.arrays.materials.kind, treg.MARSCHNER_PURE))
    out = tinv.apply_params_arrays(ts.arrays._replace(materials=mats),
                                   {"sigma_a": sa}, (0,))
    ref = thair.precompute_azimuthal(sa[0].detach(), mats.beta_r[0],
                                     mats.eta[0])
    assert torch.equal(out.hair_tables.values[0].detach(), ref)
    assert torch.equal(out.hair_tables.values_quad.detach(),
                       thair.quad_pack(ref[None]))
    assert not out.hair_tables.weights.requires_grad
    out.hair_tables.values.sum().backward()
    assert sa.grad is not None and bool(torch.isfinite(sa.grad).all())
    with pytest.raises(KeyError):
        tinv.apply_params_arrays(ts.arrays, {"kind": torch.zeros(1)},
                                 ts.marschner_rows)


def test_cosine_decay_and_adam_match_optax():
    """fit's learning rate at each step is optax.cosine_decay_schedule(lr,
    horizon, alpha=0.1) at that step, and torch's Adam under it takes
    optax.adam's steps."""
    optax = pytest.importorskip("optax")
    lr, horizon = 0.05, 5
    ours = tinv.cosine_decay(lr, horizon, alpha=0.1)
    theirs = optax.cosine_decay_schedule(lr, horizon, alpha=0.1)
    for i in range(horizon + 3):
        assert ours(i) == pytest.approx(float(theirs(i)), rel=1e-6, abs=0)
    target = np.array([0.3, -0.2, 0.7], np.float32)
    p_t = torch.zeros(3, requires_grad=True)
    opt_t = torch.optim.Adam([p_t], lr=ours(0))
    p_j = jnp.zeros(3)
    opt_j = optax.adam(theirs)
    state = opt_j.init(p_j)
    for i in range(horizon + 2):
        for group in opt_t.param_groups:
            group["lr"] = ours(i)
        opt_t.zero_grad()
        ((p_t - torch.as_tensor(target)) ** 3).sum().backward()
        opt_t.step()
        g = 3.0 * (p_j - target) ** 2
        upd, state = opt_j.update(g, state)
        p_j = p_j + upd
        np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j),
                                   rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """fit on a 16^2 film toward a target rendered at another diffuse:
    four steps in one call, and the same four as two calls of two that
    share a checkpoint directory."""
    ts = torch_scene(jax_furball(res=16, depth=3))
    target_d = torch.tensor([[0.6, 0.5, 0.4]])
    with torch.no_grad():
        target = tinv.render_image(ts, {"diffuse": target_d}, spp=2,
                                   seed=100)
    p0 = {"diffuse": torch.tensor([[0.1, 0.1, 0.1]])}
    kw = dict(lr=0.05, spp=1, decay_steps=4)
    whole = tinv.fit(ts, target, p0, steps=4, **kw)
    ck = str(tmp_path_factory.mktemp("fit_ckpt"))
    first = tinv.fit(ts, target, p0, steps=2, checkpoint_dir=ck,
                     checkpoint_every=1, **kw)
    resumed = tinv.fit(ts, target, p0, steps=4, checkpoint_dir=ck,
                       checkpoint_every=1, **kw)
    return dict(whole=whole, first=first, resumed=resumed, ck=ck, p0=p0,
                target_d=target_d, schedule=tinv.cosine_decay(0.05, 4))


def test_fit_moves_toward_the_target(fits):
    params, losses = fits["whole"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    d0 = (fits["p0"]["diffuse"] - fits["target_d"]).abs()
    d4 = (params["diffuse"] - fits["target_d"]).abs()
    assert bool((d4 < d0).all()), (params["diffuse"], fits["target_d"])


def test_fit_resumes_at_the_step_it_saved(fits):
    """A call that finds a checkpoint resumes after its step with the
    saved params, Adam state, horizon and losses: two calls of two steps
    end where one call of four does, with the same losses."""
    import os
    p_w, l_w = fits["whole"]
    p_f, l_f = fits["first"]
    p_r, l_r = fits["resumed"]
    assert len(l_f) == 2 and len(l_r) == 4
    assert l_r[:2] == l_f and l_r == l_w
    assert torch.equal(p_r["diffuse"], p_w["diffuse"])
    saved = sorted(os.listdir(fits["ck"]))
    assert saved == ["step_2.pt", "step_3.pt"]
    ck = torch.load(os.path.join(fits["ck"], "step_3.pt"),
                    weights_only=True)
    assert ck["step"] == 3 and ck["horizon"] == 4
    assert ck["opt_state"]["param_groups"][0]["lr"] == pytest.approx(
        fits["schedule"](4))
