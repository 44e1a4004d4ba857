"""The core functions of the Mip-NeRF 360 slice of nerf_hugs_torch against
nerf_hugs_tpu: encodings, the contraction's linearization, cone and
cylinder Gaussians, dilation, inverse-CDF sampling and the safe trig.
Values and the gradients of a fixed random cotangent, both within 1e-5
(float32, reductions in another order); the copied geopoly is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (pins torch threads)
from nerf_hugs_tpu.core import coord as jcoord
from nerf_hugs_tpu.core import geopoly as jgeo
from nerf_hugs_tpu.core import math as jmath
from nerf_hugs_tpu.core import render as jrender
from nerf_hugs_tpu.core import stepfun as jstep
from nerf_hugs_torch.core import coord as tcoord
from nerf_hugs_torch.core import geopoly as tgeo
from nerf_hugs_torch.core import math as tmath
from nerf_hugs_torch.core import render as trender
from nerf_hugs_torch.core import stepfun as tstep

TOL = 1e-5


def close(got, want, tol=TOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=err_msg)


def check_with_grads(jfn, tfn, inputs, seed=0, tol=TOL, grad_tol=TOL):
    """fn(*inputs) -> a tensor or a tuple of them, on both sides: the
    outputs, then the gradients of sum(outputs * a random cotangent) with
    respect to every input, each within its tolerance (the gradient's
    relative to the largest entry of JAX's)."""
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
    outs_j = as_tuple(jfn(*[jnp.asarray(x) for x in inputs]))
    rs = np.random.RandomState(seed)
    cots = [rs.randn(*np.shape(o)).astype(np.float32) for o in outs_j]

    def scalar_j(*xs):
        return sum(jnp.sum(o * c) for o, c in zip(as_tuple(jfn(*xs)), cots))

    grads_j = jax.grad(scalar_j, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(x) for x in inputs])
    xs_t = [torch.tensor(np.asarray(x), requires_grad=True) for x in inputs]
    outs_t = as_tuple(tfn(*xs_t))
    for i, (o_t, o_j) in enumerate(zip(outs_t, outs_j)):
        close(o_t, o_j, tol, f"output {i}")
    sum(torch.sum(o * torch.from_numpy(c))
        for o, c in zip(outs_t, cots)).backward()
    for i, (x, g_j) in enumerate(zip(xs_t, grads_j)):
        g_j = np.asarray(g_j)
        scale = max(float(np.abs(g_j).max()), 1.0)
        got = np.zeros_like(g_j) if x.grad is None else x.grad.numpy()
        np.testing.assert_allclose(got, g_j, rtol=0, atol=grad_tol * scale,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("shape,subdivisions",
                         [("icosahedron", 2), ("icosahedron", 1),
                          ("octahedron", 1), ("octahedron", 2)])
def test_geopoly_copy_is_exact(shape, subdivisions):
    np.testing.assert_array_equal(
        tgeo.generate_basis(shape, subdivisions),
        jgeo.generate_basis(shape, subdivisions))


def gaussians(seed, n=6, s=5, scale=1.0):
    """Means and full SPD covariances [n, s, 3, 3]."""
    rs = np.random.RandomState(seed)
    mean = (scale * rs.randn(n, s, 3)).astype(np.float32)
    a = 0.1 * rs.randn(n, s, 3, 3)
    cov = (a @ np.swapaxes(a, -1, -2) + 1e-3 * np.eye(3)).astype(np.float32)
    return mean, cov


@pytest.mark.parametrize("deg", [(0, 4), (2, 6)])
def test_pos_enc(deg):
    """The form with the input appended, the only one the models use."""
    x = np.random.RandomState(1).randn(7, 3).astype(np.float32)
    check_with_grads(
        lambda v: jcoord.pos_enc(v, *deg, append_identity=True),
        lambda v: tcoord.pos_enc(v, *deg), [x])


def test_integrated_pos_enc_and_expected_sin():
    rs = np.random.RandomState(2)
    mean = (3 * rs.randn(5, 4, 21)).astype(np.float32)
    var = (0.2 * rs.rand(5, 4, 21)).astype(np.float32)
    check_with_grads(lambda m, v: jcoord.integrated_pos_enc(m, v, 0, 12),
                     lambda m, v: tcoord.integrated_pos_enc(m, v, 0, 12),
                     [mean, var], grad_tol=1e-4)
    check_with_grads(jcoord.expected_sin, tcoord.expected_sin, [mean, var])


def test_lift_and_diagonalize_over_the_icosahedron_basis():
    basis = jgeo.generate_basis("icosahedron", 2).T.astype(np.float32)
    assert basis.shape == (3, 21)
    mean, cov = gaussians(3)
    check_with_grads(
        lambda m, c: jcoord.lift_and_diagonalize(m, c, jnp.asarray(basis)),
        lambda m, c: tcoord.lift_and_diagonalize(m, c,
                                                 torch.from_numpy(basis)),
        [mean, cov])


@pytest.mark.parametrize("scale", [0.3, 3.0], ids=["inside", "outside"])
def test_track_linearize_contract(scale):
    """Inside the unit ball the contraction is the identity; outside its
    closed-form Jacobian gives JAX's linearized covariance, and the
    gradient reaches the mean as well as the covariance."""
    mean, cov = gaussians(4, scale=scale)
    check_with_grads(
        lambda m, c: jcoord.track_linearize(jcoord.contract, m, c),
        lambda m, c: tcoord.track_linearize(tcoord.contract, m, c),
        [mean, cov])
    norms = np.linalg.norm(mean, axis=-1)
    assert (norms.max() <= 1.0) if scale < 1 else (norms.min() > 1.0)


def test_track_linearize_straddles_the_unit_ball():
    mean, cov = gaussians(5, n=40)
    mean *= (np.linspace(0.2, 2.5, 40, dtype=np.float32)[:, None, None]
             / np.linalg.norm(mean, axis=-1, keepdims=True))
    check_with_grads(
        lambda m, c: jcoord.track_linearize(jcoord.contract, m, c),
        lambda m, c: tcoord.track_linearize(tcoord.contract, m, c),
        [mean, cov])
    with pytest.raises(ValueError, match="full"):
        tcoord.track_linearize(tcoord.contract, torch.zeros(2, 3),
                               torch.zeros(2, 3))


def test_inv_contract_inverts_contract():
    z = np.random.RandomState(6).randn(50, 3).astype(np.float32)
    z *= (1.9 * np.random.RandomState(7).rand(50, 1)
          / np.linalg.norm(z, axis=-1, keepdims=True)).astype(np.float32)
    check_with_grads(jcoord.inv_contract, tcoord.inv_contract, [z])
    close(tcoord.contract(tcoord.inv_contract(torch.from_numpy(z))), z)


def rays(seed, n=6, s=8):
    rs = np.random.RandomState(seed)
    tdist = np.sort(rs.uniform(0.1, 3.0, (n, s + 1)),
                    axis=-1).astype(np.float32)
    origins = rs.randn(n, 3).astype(np.float32)
    directions = rs.randn(n, 3).astype(np.float32)
    radii = rs.uniform(0.001, 0.01, (n, 1)).astype(np.float32)
    return tdist, origins, directions, radii


@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("ray_shape", ["cone", "cylinder"])
def test_cast_rays(ray_shape, far):
    """Full covariances (JAX's diag=False, the form the model uses); the
    far case puts narrow intervals at t ~ 100, where the cone's moments
    come from the (mid, half-width) form, JAX's stable=True."""
    tdist, origins, directions, radii = rays(8)
    if far:
        tdist = (100.0 + 0.01 * tdist).astype(np.float32)
    check_with_grads(
        lambda t, o, d, r: jrender.cast_rays(t, o, d, r, ray_shape, False),
        lambda t, o, d, r: trender.cast_rays(t, o, d, r, ray_shape),
        [tdist, origins, directions, radii])


def test_cast_rays_rejects_an_unknown_shape():
    with pytest.raises(ValueError, match="ray_shape"):
        trender.cast_rays(*[torch.from_numpy(a) for a in rays(9)], "sphere")


def step_function(seed, rays=6, bins=12, tie=True):
    """Sorted endpoints from 0 to 1 with a repeated (zero-width) bin, and
    weights summing to 1; without `tie`, distinct endpoints inside (0, 1)
    (a clip or sort sends the gradient of a tie to either element)."""
    rs = np.random.RandomState(seed)
    t = np.sort(rs.rand(rays, bins + 1), axis=-1).astype(np.float32)
    if tie:
        t[:, 0], t[:, -1] = 0.0, 1.0
        t[:, 4] = t[:, 3]
    w = rs.rand(rays, bins).astype(np.float32)
    return t, w / w.sum(-1, keepdims=True)


def test_weight_pdf_round_trip():
    t, w = step_function(10)
    check_with_grads(jstep.weight_to_pdf, tstep.weight_to_pdf, [t, w],
                     grad_tol=1e-4)
    check_with_grads(jstep.pdf_to_weight, tstep.pdf_to_weight, [t, w])


@pytest.mark.parametrize("domain", [(0.0, 1.0), (0.1, 0.9),
                                    (-np.inf, np.inf)])
def test_max_dilate_weights(domain):
    """Both outputs, the [rays, 3n + 1] endpoints (clipped to the domain)
    and their renormalized weights, at the dilation of the second proposal
    level; the gradients on endpoints without ties."""
    t, w = step_function(11)
    fn = lambda step, **kw: (lambda t_, w_: step.max_dilate_weights(
        t_, w_, 0.0025 + 0.5 / 64, domain=domain, **kw))
    jfn = fn(jstep, renormalize=True)
    for got, want in zip(fn(tstep)(torch.from_numpy(t), torch.from_numpy(w)),
                         jfn(jnp.asarray(t), jnp.asarray(w))):
        close(got, want)
    t_untied, _ = step_function(11, tie=False)
    check_with_grads(jfn, fn(tstep), [t_untied, w], grad_tol=1e-4)
    t_d, w_d = fn(tstep)(torch.from_numpy(t), torch.from_numpy(w))
    assert t_d.shape == (6, 3 * 12 + 1) and w_d.shape == (6, 3 * 12)
    assert float(t_d.min()) >= max(domain[0], -1)
    close(w_d.sum(-1), np.ones(6))


@pytest.mark.parametrize("use_gpu_resampling", [False, True])
def test_invert_cdf_both_ways(use_gpu_resampling):
    t, w = step_function(12)
    logits = np.log(w + 1e-3).astype(np.float32)
    logits[0] = -np.inf       # an all-masked ray falls back to uniform
    u = np.sort(np.random.RandomState(13).rand(6, 9),
                axis=-1).astype(np.float32)
    got = tstep.invert_cdf(torch.from_numpy(u), torch.from_numpy(t),
                           torch.from_numpy(logits), use_gpu_resampling)
    want = jstep.invert_cdf(jnp.asarray(u), jnp.asarray(t),
                            jnp.asarray(logits), use_gpu_resampling)
    close(got, want)
    got = tstep.sample_intervals(None, torch.from_numpy(t),
                                 torch.from_numpy(logits), 7,
                                 domain=(0.0, 1.0),
                                 use_gpu_resampling=use_gpu_resampling)
    want = jstep.sample_intervals(None, jnp.asarray(t), jnp.asarray(logits),
                                  7, domain=(0.0, 1.0),
                                  use_gpu_resampling=use_gpu_resampling)
    close(got, want)


def test_safe_trig_beyond_the_cap():
    """Arguments past 100 pi are range-reduced (mod 100 pi, the divisor's
    sign), and an overflowing reduction gives sin(0)."""
    x = np.concatenate([np.linspace(-2000, 2000, 101),
                        [99.9 * np.pi, 100 * np.pi, -100 * np.pi, 1e30,
                         -3.4e38, 3.4e38]]).astype(np.float32)
    for jfn, tfn in ((jmath.safe_sin, tmath.safe_sin),
                     (jmath.safe_cos, tmath.safe_cos)):
        check_with_grads(jfn, tfn, [x], tol=1e-6)
    big = tmath.safe_sin(torch.tensor([1e30, 3.4e38]))
    assert torch.all(torch.isfinite(big))


def test_matmul_hp_is_fp32_matmul():
    rs = np.random.RandomState(14)
    a, b = (rs.randn(4, 5, 3).astype(np.float32),
            rs.randn(3, 7).astype(np.float32))
    close(tmath.matmul_hp(torch.from_numpy(a), torch.from_numpy(b)),
          jmath.matmul_hp(jnp.asarray(a), jnp.asarray(b)), tol=1e-6)
