"""Step-function (piecewise-constant 1D) toolkit, the sampler core.

Twin of nerf_hugs_tpu/core/stepfun.py (the multinerf stepfun.py
math, Apache-2.0). Conventions along the last axis: `t` are the n+1 sorted
endpoints, `w` the n bin weights, `logits` unconstrained bin values that
softmax into weights. Where the TPU version counts with a dense
[..., n, m] compare, this one binary-searches: at the fine level that
compare would be 16384 x 257 x 129 entries.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerf_hugs_torch.core import math as nh_math

_EPS = float(np.finfo(np.float32).eps)


def searchsorted(a, v):
    """Bracketing indices of each v inside sorted a.

    Returns (idx_lo, idx_hi) with a[idx_lo] <= v < a[idx_hi]; out-of-range
    queries clamp both indices to the first/last position of a. `v` need
    not be sorted. `searchsorted(right=True)` is the count of endpoints
    <= v, the same count the TPU version sums from its compare mask."""
    n = a.shape[-1]
    count = torch.searchsorted(a.contiguous(), v.contiguous(), right=True)
    return torch.clamp(count - 1, min=0), torch.clamp(count, max=n - 1)


def inner_outer(t0, t1, y1):
    """Inner/outer measures of step fn (t1, y1) resampled onto intervals t0."""
    cum = torch.cat([torch.zeros_like(y1[..., :1]),
                     torch.cumsum(y1, dim=-1)], dim=-1)
    lo, hi = searchsorted(t1, t0)
    cum_lo = torch.gather(cum, -1, lo)
    cum_hi = torch.gather(cum, -1, hi)
    outer = cum_hi[..., 1:] - cum_lo[..., :-1]
    inner = torch.where(hi[..., :-1] <= lo[..., 1:],
                        cum_lo[..., 1:] - cum_hi[..., :-1],
                        torch.zeros_like(outer))
    return inner, outer


def lossfun_outer(t, w, t_env, w_env, eps=_EPS):
    """Interlevel loss: penalize NeRF mass exceeding the proposal envelope."""
    _, w_outer = inner_outer(t, t_env, w_env)
    return torch.clamp(w - w_outer, min=0) ** 2 / (w + eps)


def weight_to_pdf(t, w):
    """Bin weights -> densities (divide by bin width)."""
    return w / torch.clamp(t[..., 1:] - t[..., :-1], min=_EPS ** 2)


def pdf_to_weight(t, p):
    """Bin densities -> weights (multiply by bin width)."""
    return p * (t[..., 1:] - t[..., :-1])


def max_dilate(t, w, dilation, domain):
    """Max-pool a non-negative step function outward by `dilation`: each
    bin [t0, t1) grows to [t0 - d, t1 + d), and the dilated function at a
    point is the max over the grown bins that cover it. Like JAX, this
    builds the [..., 3n + 1, n] coverage mask."""
    lo = t[..., :-1] - dilation
    hi = t[..., 1:] + dilation
    t_d = torch.sort(torch.cat([t, lo, hi], dim=-1), dim=-1).values
    t_d = torch.clamp(t_d, *domain)
    covered = ((lo[..., None, :] <= t_d[..., None])
               & (hi[..., None, :] > t_d[..., None]))
    w_d = torch.amax(torch.where(covered, w[..., None, :],
                                 torch.zeros_like(w[..., None, :])),
                     dim=-1)[..., :-1]
    return t_d, w_d


def max_dilate_weights(t, w, dilation, domain):
    """Dilate weights in density space, so that mass scales with width,
    and renormalize them to sum to 1 (JAX's renormalize=True, the form the
    model uses)."""
    p = weight_to_pdf(t, w)
    t_d, p_d = max_dilate(t, p, dilation, domain=domain)
    w_d = pdf_to_weight(t_d, p_d)
    w_d = w_d / torch.clamp(torch.sum(w_d, dim=-1, keepdim=True),
                            min=_EPS ** 2)
    return t_d, w_d


def integrate_weights(w):
    """CDF endpoints of weights assumed to sum to 1: starts at 0, ends at 1."""
    cdf = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1)
    pad = torch.zeros(cdf.shape[:-1] + (1,), dtype=cdf.dtype,
                      device=cdf.device)
    return torch.cat([pad, cdf, torch.ones_like(pad)], dim=-1)


def invert_cdf(u, t, w_logits, use_gpu_resampling=False):
    """Map u in [0,1) through the inverse CDF of softmax(w_logits) over t,
    with `interp` (use_gpu_resampling) or `sorted_interp`, as JAX picks.

    Rays whose logits are all -inf fall back to a uniform CDF."""
    all_masked = torch.all(torch.isneginf(w_logits), dim=-1, keepdim=True)
    w_logits = torch.where(all_masked, torch.ones_like(w_logits), w_logits)
    w = torch.softmax(w_logits, dim=-1)
    interp_fn = (nh_math.interp if use_gpu_resampling
                 else nh_math.sorted_interp)
    return interp_fn(u, integrate_weights(w), t)


def sample(rng: Optional[torch.Generator], t, w_logits, num_samples,
           single_jitter=False, deterministic_center=False,
           use_gpu_resampling=False):
    """Draw `num_samples` points from the step-function PDF via inverse CDF.

    rng=None gives stratified deterministic samples (linspace of the CDF, or
    interval centers when deterministic_center); with a generator the
    samples are stratified-jittered, one offset per ray under
    single_jitter."""
    dev = t.device
    if rng is None:
        if deterministic_center:
            pad = 1 / (2 * num_samples)
            u = torch.linspace(pad, 1.0 - pad - _EPS, num_samples, device=dev)
        else:
            u = torch.linspace(0, 1.0 - _EPS, num_samples, device=dev)
        u = u.expand(t.shape[:-1] + (num_samples,))
    else:
        u_max = _EPS + (1 - _EPS) / num_samples
        max_jitter = (1 - u_max) / (num_samples - 1) - _EPS
        d = 1 if single_jitter else num_samples
        jitter = torch.rand(t.shape[:-1] + (d,), generator=rng, device=dev)
        u = torch.linspace(0, 1 - u_max, num_samples, device=dev) \
            + jitter * max_jitter
    return invert_cdf(u, t, w_logits, use_gpu_resampling)


def sample_intervals(rng: Optional[torch.Generator], t, w_logits,
                     num_samples, single_jitter=False,
                     domain=(-float("inf"), float("inf")),
                     use_gpu_resampling=False):
    """Sample `num_samples` intervals whose centers follow the PDF; returns
    num_samples+1 sorted endpoints, the outer two reflected around the end
    centers and clamped to `domain`."""
    if num_samples <= 1:
        raise ValueError(f"need num_samples > 1, got {num_samples}")
    centers = sample(rng, t, w_logits, num_samples, single_jitter,
                     deterministic_center=True,
                     use_gpu_resampling=use_gpu_resampling)
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=domain[0])
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=domain[1])
    return torch.cat([first, mid, last], dim=-1)


def lossfun_distortion(t, w):
    """Mip-NeRF 360 distortion: iint w_i w_j |t_i - t_j| + self-term."""
    mids = 0.5 * (t[..., 1:] + t[..., :-1])
    pair = torch.abs(mids[..., :, None] - mids[..., None, :])
    inter = torch.sum(w * torch.sum(w[..., None, :] * pair, dim=-1), dim=-1)
    intra = torch.sum(w ** 2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
    return inter + intra


def weighted_percentile(t, w, ps):
    """Percentiles `ps` (in [0,100]) of the step-function distribution."""
    cdf = integrate_weights(w)
    q = torch.tensor(ps, dtype=cdf.dtype, device=cdf.device) / 100
    return nh_math.interp(q.expand(cdf.shape[:-1] + (len(ps),)), cdf, t)
