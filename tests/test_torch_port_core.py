"""nerf_hugs_torch core math against nerf_hugs_tpu: step functions, warps,
compositing, the learning-rate schedule and the host ray caster."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (pins torch threads)
from nerf_hugs_tpu.cameras import camera_utils as jcam
from nerf_hugs_tpu.core import coord as jcoord
from nerf_hugs_tpu.core import math as jmath
from nerf_hugs_tpu.core import render as jrender
from nerf_hugs_tpu.core import stepfun as jstep
from nerf_hugs_torch.cameras import camera_utils as tcam
from nerf_hugs_torch.core import coord as tcoord
from nerf_hugs_torch.core import math as tmath
from nerf_hugs_torch.core import render as trender
from nerf_hugs_torch.core import stepfun as tstep
from nerf_hugs_torch.utils import structs as tstructs

# float32 cumsums, softmaxes and exps reduce in another order than XLA's.
TOL = 1e-5

T = lambda a: torch.from_numpy(np.array(a))
J = jnp.asarray


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def step_function(seed, rays=6, bins=12):
    """Sorted endpoints with a repeated (zero-width) bin, and weights."""
    rs = np.random.RandomState(seed)
    t = np.sort(rs.rand(rays, bins + 1), axis=-1).astype(np.float32)
    t[:, 4] = t[:, 3]
    w = rs.rand(rays, bins).astype(np.float32)
    return t, w / w.sum(-1, keepdims=True)


def test_searchsorted_brackets_out_of_range_and_ties():
    t, _ = step_function(0)
    rs = np.random.RandomState(1)
    v = np.concatenate([
        rs.rand(6, 20), np.full((6, 1), -1.0), np.full((6, 1), 2.0),
        t[:, [0, 3, 4, 7, -1]],            # queries tied to endpoints
    ], axis=-1).astype(np.float32)
    lo_j, hi_j = jstep.searchsorted(J(t), J(v))
    lo_t, hi_t = tstep.searchsorted(T(t), T(v))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    # Out of range clamps both indices to the first / last position.
    assert np.all(lo_t.numpy()[:, 20] == 0) and np.all(hi_t.numpy()[:, 20] == 0)
    assert np.all(lo_t.numpy()[:, 21] == 12) and np.all(hi_t.numpy()[:, 21] == 12)


def test_interp_and_sorted_interp():
    t, w = step_function(2)
    cdf = np.asarray(jstep.integrate_weights(J(w)))
    u = np.sort(np.concatenate([np.random.RandomState(3).rand(6, 30),
                                np.zeros((6, 1)), np.ones((6, 1))], -1),
                axis=-1).astype(np.float32)
    close(tmath.sorted_interp(T(u), T(cdf), T(t)),
          jmath.sorted_interp(J(u), J(cdf), J(t)))
    x = np.concatenate([u - 0.1, u + 0.1], -1).astype(np.float32)
    close(tmath.interp(T(x), T(cdf), T(t)), jmath.interp(J(x), J(cdf), J(t)))


def test_integrate_invert_and_sample():
    t, w = step_function(4)
    logits = np.log(w)
    logits[0] = -np.inf                    # all-masked ray: uniform CDF
    close(tstep.integrate_weights(T(w)), jstep.integrate_weights(J(w)))
    u = np.linspace(0, 0.999, 9, dtype=np.float32)[None].repeat(6, 0)
    close(tstep.invert_cdf(T(u), T(t), T(logits)),
          jstep.invert_cdf(J(u), J(t), J(logits)))
    for center in (False, True):
        close(tstep.sample(None, T(t), T(logits), 16,
                           deterministic_center=center),
              jstep.sample(None, J(t), J(logits), 16,
                           deterministic_center=center))
    close(tstep.sample_intervals(None, T(t), T(logits), 16,
                                 domain=(0.0, 1.0)),
          jstep.sample_intervals(None, J(t), J(logits), 16,
                                 domain=(0.0, 1.0)))


def test_jittered_samples_stay_sorted_in_domain():
    t, w = step_function(5)
    gen = torch.Generator().manual_seed(0)
    for single in (False, True):
        s = tstep.sample_intervals(gen, T(t), T(np.log(w)), 32,
                                   single_jitter=single, domain=(0.0, 1.0))
        assert s.shape == (6, 33)
        assert torch.all(s[..., 1:] >= s[..., :-1])
        assert float(s.min()) >= 0.0 and float(s.max()) <= 1.0


def test_interlevel_and_distortion_losses():
    t, w = step_function(6)
    t_env, w_env = step_function(7, bins=20)
    close(tstep.lossfun_outer(T(t), T(w), T(t_env), T(w_env)),
          jstep.lossfun_outer(J(t), J(w), J(t_env), J(w_env)))
    close(tstep.lossfun_distortion(T(t), T(w)),
          jstep.lossfun_distortion(J(t), J(w)))
    close(tstep.weighted_percentile(T(t), T(w), [5, 50, 95]),
          jstep.weighted_percentile(J(t), J(w), [5, 50, 95]))


def test_contract_and_ray_warps():
    x = np.random.RandomState(8).randn(50, 3).astype(np.float32) * 2
    close(tcoord.contract(T(x)), jcoord.contract(J(x)))
    near = np.full((5, 1), 0.2, np.float32)
    far = np.full((5, 1), 6.0, np.float32)
    s = np.linspace(0, 1, 11, dtype=np.float32)[None].repeat(5, 0)
    for tfn, jfn in ((None, None), ("piecewise", "piecewise"),
                     (torch.reciprocal, jnp.reciprocal)):
        t_to_s_t, s_to_t_t = tcoord.construct_ray_warps(tfn, T(near), T(far))
        t_to_s_j, s_to_t_j = jcoord.construct_ray_warps(jfn, J(near), J(far))
        close(s_to_t_t(T(s)), s_to_t_j(J(s)))
        close(t_to_s_t(s_to_t_t(T(s))), t_to_s_j(s_to_t_j(J(s))))


@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("from_first", [False, True])
def test_alpha_weights_and_volumetric_rendering(opaque, from_first):
    rs = np.random.RandomState(9)
    tdist = np.sort(rs.uniform(0.5, 3, (7, 17)), -1).astype(np.float32)
    density = rs.exponential(2.0, (7, 16)).astype(np.float32)
    dirs = rs.randn(7, 3).astype(np.float32)
    got = trender.compute_alpha_weights(T(density), T(tdist), T(dirs),
                                        opaque, from_first)
    want = jrender.compute_alpha_weights(J(density), J(tdist), J(dirs),
                                         opaque, from_first)
    for g, w in zip(got, want):
        close(g, w)
    weights = np.asarray(want[0])
    rgbs = rs.rand(7, 16, 3).astype(np.float32)
    bg = rs.rand(7, 3).astype(np.float32)
    far = np.full((7, 1), 3.0, np.float32)
    r_t = trender.volumetric_rendering(T(rgbs), T(weights), T(tdist), T(bg),
                                       T(far), True)
    r_j = jrender.volumetric_rendering(J(rgbs), J(weights), J(tdist), J(bg),
                                       J(far), True)
    assert set(r_t) == set(r_j)
    for k in r_j:
        close(r_t[k], r_j[k])


def test_safe_exp_and_learning_rate_decay():
    x = np.array([-3.0, 0.0, 10.0, 88.0, 100.0], np.float32)
    xt = T(x).requires_grad_()
    y = tmath.safe_exp(xt)
    y.sum().backward()
    close(y, jmath.safe_exp(J(x)), tol=1e-6)
    close(xt.grad, jax.grad(lambda v: jmath.safe_exp(v).sum())(J(x)),
          tol=1e-6)
    kw = dict(lr_init=0.01, lr_final=0.001, max_steps=25000,
              lr_delay_steps=500, lr_delay_mult=0.01)
    for step in (0, 1, 250, 499, 500, 12000, 25000, 30000):
        np.testing.assert_allclose(tmath.learning_rate_decay(step, **kw),
                                   float(jmath.learning_rate_decay(step, **kw)),
                                   rtol=1e-6)


def test_cast_ray_batch_matches_jax_numpy_path():
    rs = np.random.RandomState(10)
    n_cam, h, w = 3, 6, 8
    c2ws = np.stack([jcam.viewmatrix(rs.randn(3), np.array([0, 0, 1.0]),
                                     rs.randn(3)) for _ in range(n_cam)])
    p2cs = np.stack([jcam.get_pixtocam(7.0 + i, w, h) for i in range(n_cam)])
    np.testing.assert_array_equal(tcam.get_pixtocam(8.0, w, h),
                                  jcam.get_pixtocam(8.0, w, h))
    np.testing.assert_array_equal(
        tcam.viewmatrix(c2ws[0, :, 2], np.array([0, 0, 1.0]), c2ws[0, :, 3]),
        jcam.viewmatrix(c2ws[0, :, 2], np.array([0, 0, 1.0]), c2ws[0, :, 3]))
    n = 40
    fields = dict(
        pix_x_int=rs.randint(0, w, n), pix_y_int=rs.randint(0, h, n),
        lossmult=np.ones((n, 1), np.float32),
        static_mask=np.ones((n, 1), np.float32),
        near=np.full((n, 1), 0.1, np.float32),
        far=np.full((n, 1), 2.0, np.float32),
        embed_idx=np.zeros((n, 1), np.int32),
        cam_idx=rs.randint(0, n_cam, (n, 1)).astype(np.int32))
    from nerf_hugs_tpu.utils import structs as jstructs
    heights, widths = np.full(n_cam, h), np.full(n_cam, w)
    got = tcam.cast_ray_batch((p2cs, c2ws, None), tstructs.Pixels(**fields),
                              heights, widths, None)
    want = jcam.cast_ray_batch((p2cs, c2ws, None), jstructs.Pixels(**fields),
                               heights, widths, None, xnp=np)
    for name in ("pix_coords", "origins", "directions", "viewdirs", "radii"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
