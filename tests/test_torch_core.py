"""hairpt_torch core against hairpt: the u32 hashes and Sobol' samples
bit for bit, the warps and frames to float32 rounding."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hairpt.core import math as jmath
from hairpt.core import rng as jrng
from hairpt.core import warps as jwarps
from hairpt_torch.core import math as tmath
from hairpt_torch.core import rng as trng
from hairpt_torch.core import warps as twarps
from torch_threads import one_thread  # noqa: F401


def _u32(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n,
                                                dtype=np.uint64) \
        .astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def test_hash_u32_bit_exact():
    x = _u32(4096, 0)
    ref = np.asarray(jrng.hash_u32(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(trng.hash_u32(_t(x)).numpy(), ref)


@pytest.mark.parametrize("dim", [0, 3, 17, 1000])
def test_uniform_pcg_bit_exact(dim):
    pix, smp = _u32(2048, 1), _u32(2048, 2)
    ref1 = np.asarray(jrng.uniform_1d(jnp.asarray(pix), jnp.asarray(smp),
                                      dim))
    ref2 = np.asarray(jrng.next_2d(jrng.INDEPENDENT, jnp.asarray(pix),
                                   jnp.asarray(smp), dim))
    np.testing.assert_array_equal(
        trng.uniform_1d(_t(pix), _t(smp), dim).numpy(), ref1)
    np.testing.assert_array_equal(
        trng.uniform_2d(_t(pix), _t(smp), dim).numpy(), ref2)


@pytest.mark.parametrize("dim", [0, 1, 2, 4, 13, 200, 1043, 1151, 1160])
def test_sobol_qmc_bit_exact(dim):
    """Every component class: the pixel dims 0/1, table dims, generated
    (digitally shifted) dims and the hash fallback past the table."""
    m, width = 5, 32
    rs = np.random.default_rng(3)
    pix = rs.integers(0, width * width, 1024).astype(np.uint32)
    smp = rs.integers(0, 3 * 65536, 1024).astype(np.uint32)
    ref = np.asarray(jrng.sobol_qmc(m, width, jnp.asarray(pix),
                                    jnp.asarray(smp), dim, 2))
    got = trng.sobol_qmc(m, width, _t(pix), _t(smp), dim, 2).numpy()
    np.testing.assert_array_equal(got, ref)


def test_sampler_next_1d_2d_match_jax_modes():
    """The per-wave Sampler (Sobol' index looked up once) gives the same
    samples as the JAX facade, for SOBOL_QMC, the padded Owen-scrambled
    SOBOL and the PCG mode."""
    res = 64
    pix = np.arange(res * res, dtype=np.uint32)
    smp = np.full(res * res, 65536 + 5, np.uint32)
    for jmode, tmode in (((jrng.SOBOL_QMC, 6, res), (trng.SOBOL_QMC, 6, res)),
                         (jrng.SOBOL, trng.SOBOL),
                         (jrng.INDEPENDENT, trng.INDEPENDENT)):
        s = trng.Sampler(tmode, _t(pix), _t(smp))
        for dim in (0, 4, 20, 68):
            np.testing.assert_array_equal(
                s.next_2d(dim).numpy(),
                np.asarray(jrng.next_2d(jmode, jnp.asarray(pix),
                                        jnp.asarray(smp), dim)))
            np.testing.assert_array_equal(
                s.next_1d(dim + 1).numpy(),
                np.asarray(jrng.next_1d(jmode, jnp.asarray(pix),
                                        jnp.asarray(smp), dim + 1)))
        order = torch.as_tensor(np.random.default_rng(0).permutation(
            res * res)[:100])
        np.testing.assert_array_equal(s.take(order).next_2d(9).numpy(),
                                      s.next_2d(9)[order].numpy())


@pytest.mark.parametrize("name", ["square_to_uniform_sphere",
                                  "square_to_uniform_disk_concentric",
                                  "square_to_cosine_hemisphere"])
def test_warps_match_jax(name):
    u = np.random.default_rng(4).random((4096, 2)).astype(np.float32)
    u[0] = 0.5          # the concentric map's centre case
    ref = np.asarray(getattr(jwarps, name)(jnp.asarray(u)))
    got = getattr(twarps, name)(torch.as_tensor(u)).numpy()
    # cos/sin differ by an ulp between the libraries; the hemisphere's
    # z = sqrt(1 - r^2) amplifies that near the rim, hence 1e-5 absolute
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-5)
    w = twarps.square_to_cosine_hemisphere(torch.as_tensor(u))
    np.testing.assert_allclose(
        twarps.square_to_cosine_hemisphere_pdf(w).numpy(),
        np.asarray(jwarps.square_to_cosine_hemisphere_pdf(
            jnp.asarray(w.numpy()))), rtol=1e-6)


def test_frame_and_coordinate_system_match_jax():
    n = np.random.default_rng(5).normal(size=(2048, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    s_j, t_j = jmath.coordinate_system(jnp.asarray(n))
    s_t, t_t = tmath.coordinate_system(torch.as_tensor(n))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-6)
    f = tmath.frame_from_normal(torch.as_tensor(n))
    v = torch.as_tensor(np.random.default_rng(6).normal(size=(2048, 3))
                        .astype(np.float32))
    np.testing.assert_allclose(f.to_world(f.to_local(v)).numpy(), v.numpy(),
                               atol=1e-5)
