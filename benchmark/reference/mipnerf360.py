"""A plain Mip-NeRF 360 (Barron et al. 2022, MultiNeRF's models.py): two
proposal levels and a NeRF level sharing one proposal MLP, each level's
intervals resampled from the previous weights dilated and annealed, cast
as conical-frustum Gaussians, lifted onto a geodesic basis and encoded
by integrated positional encoding, an MLP with a skip connection to
density and (NeRF level) a bottleneck with the view direction's encoding
to colour; alpha compositing, the mean squared error and the interlevel
loss.

In float32 throughout, or with `precision` fp8 for the control. Supports
the configuration's options only (linear ray distances, cone rays, no
warp, no noise, no embeddings); `check` refuses others. Parameter names
are the program's state-dict keys.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch.nn import functional as F

from benchmark.reference import common, geopoly

_CAP = 100.0 * math.pi


def check(v: dict) -> None:
    """Refuse options this reference does not compute."""
    wanted = {"model.raydist_fn": None, "model.ray_shape": "cone",
              "model.disable_integration": False,
              "model.stop_level_grad": True, "model.use_viewdirs": True,
              "model.num_glo_features": 0, "model.num_transient_features": 0,
              "model.near_anneal_rate": None,
              "model.use_gpu_resampling": False,
              "nerf_mlp.warp_fn": None, "prop_mlp.warp_fn": None,
              "nerf_mlp.density_noise": 0.0, "nerf_mlp.bottleneck_noise": 0.0,
              "prop_mlp.density_noise": 0.0, "prop_mlp.disable_rgb": True,
              "nerf_mlp.disable_rgb": False, "transient_type": None,
              "distortion_loss_mult": 0.0, "weight_decay_mults": {}}
    bad = {k: v[k] for k, want in wanted.items() if v[k] != want}
    for m in ("nerf_mlp", "prop_mlp"):
        acts = (v[f"{m}.net_activation"], v[f"{m}.density_activation"],
                v[f"{m}.rgb_activation"])
        if acts != ("relu", "softplus", "sigmoid"):
            bad[m] = acts
    if bad:
        raise ValueError(f"the Mip-NeRF 360 reference does not compute {bad}")


def _basis(v: dict, m: str) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(geopoly.generate_basis(
        v[f"{m}.basis_shape"], v[f"{m}.basis_subdivisions"]).T),
        dtype=torch.float32)


def _stack_dims(d_in: int, width: int, depth: int, skip: int):
    """[(d_in, d_out)] of a stack whose layers i % skip == 0, i > 0 take the
    stack's input again beside their output."""
    dims, d = [], d_in
    for i in range(depth):
        dims.append((d, width))
        d = width + (d_in if i % skip == 0 and i > 0 else 0)
    return dims, d


def mlp_layers(v: dict, m: str):
    """[(role, d_in, d_out)] of MLP `m` (nerf_mlp or prop_mlp) in the
    published construction order (Dense_0, Dense_1, ...)."""
    feat = 2 * _basis(v, m).shape[1] * (v[f"{m}.max_deg_point"]
                                        - v[f"{m}.min_deg_point"])
    trunk, d = _stack_dims(feat, v[f"{m}.net_width"], v[f"{m}.net_depth"],
                           v[f"{m}.skip_layer"])
    layers = [("trunk", a, b) for a, b in trunk] + [("density", d, 1)]
    if not v[f"{m}.disable_rgb"]:
        bw = v[f"{m}.bottleneck_width"]
        layers.append(("bottleneck", d, bw))
        view, d2 = _stack_dims(bw + 3 + 6 * v[f"{m}.deg_view"],
                               v[f"{m}.net_width_viewdirs"],
                               v[f"{m}.net_depth_viewdirs"],
                               v[f"{m}.skip_layer_dir"])
        layers += [("view", a, b) for a, b in view]
        layers.append(("rgb", d2, v[f"{m}.num_rgb_channels"]))
    return layers


_MODULES = (("NerfMLP_0", "nerf_mlp"), ("PropMLP_0", "prop_mlp"))


def param_specs(v: dict) -> list:
    """[(name, shape, half-width of its uniform initial draw)]: he_uniform
    weights and zero biases."""
    check(v)
    specs = []
    for module, m in _MODULES:
        for k, (_, d_in, d_out) in enumerate(mlp_layers(v, m)):
            specs.append((f"{module}.Dense_{k}.weight", (d_out, d_in),
                          math.sqrt(6.0 / d_in)))
            specs.append((f"{module}.Dense_{k}.bias", (d_out,), 0.0))
    return specs


def _safe_sin(x):
    reduced = torch.fmod(x, _CAP)
    reduced = torch.where(reduced < 0, reduced + _CAP, reduced)
    reduced = torch.where(torch.isfinite(reduced), reduced,
                          torch.zeros_like(reduced))
    return torch.sin(torch.where(torch.abs(x) < _CAP, x, reduced))


def conical_gaussians(tdist, origins, d, radii):
    """Means and full covariances of the conical frustums of the intervals
    tdist (mip-NeRF's stable form)."""
    t0, t1 = tdist[..., :-1], tdist[..., 1:]
    mu, hw = (t0 + t1) / 2, (t1 - t0) / 2
    denom = torch.clamp(3 * mu ** 2 + hw ** 2, min=common.EPS)
    t_mean = mu + (2 * mu * hw ** 2) / denom
    t_var = hw ** 2 / 3 - (4 / 15) * hw ** 4 * (12 * mu ** 2 - hw ** 2) \
        / denom ** 2
    r_var = (mu ** 2 / 4 + (5 / 12) * hw ** 2
             - (4 / 15) * hw ** 4 / denom) * radii ** 2
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d ** 2, dim=-1, keepdim=True), min=1e-10)
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    cov = (t_var[..., None, None] * d_outer[..., None, :, :]
           + r_var[..., None, None] * null_outer[..., None, :, :])
    return mean + origins[..., None, :], cov


def ipe(mean, cov, basis, min_deg: int, max_deg: int):
    """Integrated positional encoding of the Gaussians' projections onto
    the basis."""
    lm = torch.matmul(mean, basis)
    lv = torch.sum(basis * torch.matmul(cov, basis), dim=-2)
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=lm.dtype,
                                 device=lm.device)
    shape = lm.shape[:-1] + (-1,)
    sm = torch.reshape(lm[..., None, :] * scales[:, None], shape)
    sv = torch.reshape(lv[..., None, :] * scales[:, None] ** 2, shape)
    damp = torch.exp(-0.5 * sv)
    return torch.cat([damp, damp], -1) * _safe_sin(
        torch.cat([sm, sm + 0.5 * math.pi], -1))


def pos_enc(x, deg: int):
    scales = 2.0 ** torch.arange(0, deg, dtype=x.dtype, device=x.device)
    sx = torch.reshape(x[..., None, :] * scales[:, None],
                       x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(torch.cat([sx, sx + 0.5 * math.pi], -1))],
                     -1)


def mlp(P, module: str, m: str, v: dict, mean, cov, viewdirs, precision):
    """(density, rgb or None) of the samples' Gaussians."""
    basis = _basis(v, m).to(mean.device)
    feats = ipe(mean, cov, basis, v[f"{m}.min_deg_point"],
                v[f"{m}.max_deg_point"])
    layers = mlp_layers(v, m)
    dense = lambda x, k: common.linear(x, P[f"{module}.Dense_{k}.weight"],
                                       P[f"{module}.Dense_{k}.bias"],
                                       precision)
    x, skip = feats, v[f"{m}.skip_layer"]
    trunk = [k for k, (role, _, _) in enumerate(layers) if role == "trunk"]
    for i, k in enumerate(trunk):
        x = torch.relu(dense(x, k))
        if i % skip == 0 and i > 0:
            x = torch.cat([x, feats], -1)
    k = len(trunk)
    density = F.softplus(dense(x, k)[..., 0] + v[f"{m}.density_bias"])
    if v[f"{m}.disable_rgb"]:
        return density, None
    bottleneck = dense(x, k + 1)
    enc = pos_enc(viewdirs, v[f"{m}.deg_view"])
    y = torch.cat([bottleneck, enc[..., None, :].expand(
        bottleneck.shape[:-1] + enc.shape[-1:])], -1)
    view_in, skip_dir = y, v[f"{m}.skip_layer_dir"]
    views = [k for k, (role, _, _) in enumerate(layers) if role == "view"]
    for i, k in enumerate(views):
        y = torch.relu(dense(y, k))
        if i % skip_dir == 0 and i > 0:
            y = torch.cat([y, view_in], -1)
    raw = dense(y, len(layers) - 1)
    pad = v[f"{m}.rgb_padding"]
    rgb = torch.sigmoid(v[f"{m}.rgb_premultiplier"] * raw + v[f"{m}.rgb_bias"])
    return density, rgb * (1 + 2 * pad) - pad


def max_dilate_weights(t, w, dilation: float, domain):
    """Weights dilated in density space by `dilation` (a bin's max over
    the bins it is widened into), renormalised to sum to 1."""
    p = w / torch.clamp(t[..., 1:] - t[..., :-1], min=common.EPS ** 2)
    lo, hi = t[..., :-1] - dilation, t[..., 1:] + dilation
    t_d = torch.sort(torch.cat([t, lo, hi], dim=-1), dim=-1).values
    t_d = torch.clamp(t_d, *domain)
    covered = ((lo[..., None, :] <= t_d[..., None])
               & (hi[..., None, :] > t_d[..., None]))
    p_d = torch.amax(torch.where(covered, p[..., None, :],
                                 torch.zeros_like(p[..., None, :])),
                     dim=-1)[..., :-1]
    w_d = p_d * (t_d[..., 1:] - t_d[..., :-1])
    w_d = w_d / torch.clamp(torch.sum(w_d, dim=-1, keepdim=True),
                            min=common.EPS ** 2)
    return t_d, w_d


def forward(P: Dict[str, torch.Tensor], rays: dict, train_frac: float,
            gen: torch.Generator, v: dict, precision: str):
    """([rgb of each level], [(sdist, weights)] of each level)."""
    near, far = rays["near"], rays["far"]
    s_to_t = lambda s: s * far + (1 - s) * near
    f32 = np.float32
    frac = f32(train_frac)
    if v["model.anneal_slope"] > 0:
        s = f32(v["model.anneal_slope"])
        anneal = float((s * frac) / ((s - f32(1)) * frac + f32(1)))
    else:
        anneal = 1.0
    domain = (0.0, 1.0)
    sdist = torch.cat([torch.zeros_like(near), torch.ones_like(far)], -1)
    weights = torch.ones_like(near)
    prod = 1
    levels = v["model.num_levels"]
    bg_lo, bg_hi = v["model.bg_intensity_range"][:2]
    if bg_lo != bg_hi:
        raise ValueError("the reference composites over a fixed background")
    rgbs, history = [], []
    for level in range(levels):
        is_prop = level < levels - 1
        n = (v["model.num_prop_samples"] if is_prop
             else v["model.num_nerf_samples"])
        dilation = v["model.dilation_bias"] \
            + v["model.dilation_multiplier"] / prod
        prod *= n
        with torch.no_grad():
            if level > 0 and (v["model.dilation_bias"] > 0
                              or v["model.dilation_multiplier"] > 0):
                sdist, weights = max_dilate_weights(sdist, weights, dilation,
                                                    domain)
                sdist, weights = sdist[..., 1:-1], weights[..., 1:-1]
            logits = torch.where(
                sdist[..., 1:] > sdist[..., :-1],
                anneal * torch.log(weights + v["model.resample_padding"]),
                torch.full_like(weights, -float("inf")))
            sdist = common.sample_intervals(gen, sdist, logits, n,
                                            v["model.single_jitter"], domain)
        tdist = s_to_t(sdist)
        mean, cov = conical_gaussians(tdist, rays["origins"],
                                      rays["directions"], rays["radii"])
        module, m = _MODULES[1] if is_prop else _MODULES[0]
        density, rgb = mlp(P, module, m, v, mean, cov, rays["viewdirs"],
                           precision)
        if rgb is None:
            rgb = torch.zeros_like(mean)
        weights = common.alpha_weights(density, tdist, rays["directions"],
                                       v["model.opaque_background"])
        rgbs.append(common.composite(rgb, weights, bg_lo))
        history.append((sdist, weights))
    return rgbs, history


def loss(P, rays, rgb_target, train_frac, gen, v, precision):
    """The data term of the final level (and the others' at
    data_coarse_loss_mult) plus the interlevel term."""
    rgbs, history = forward(P, rays, train_frac, gen, v, precision)
    terms = [common.data_loss(rgb, rgb_target, v["data_loss_type"])
             for rgb in rgbs]
    total = v["data_loss_mult"] * terms[-1]
    if len(terms) > 1:
        total = total + v["data_coarse_loss_mult"] * sum(terms[:-1])
    if v["interlevel_loss_mult"] > 0:
        total = total + common.interlevel_loss(history,
                                               v["interlevel_loss_mult"])
    return total


def step_flops(v: dict) -> float:
    """The model's matrix-product operations in one train step: 2 x the
    multiply-adds of each MLP a sample x its samples for the forward, as
    many for the weight gradients, and as many for the input gradients but
    those of each trunk's first layer (the encoding takes no gradient: the
    samples are drawn without one). The forward counts once: a
    recomputation under remat is no model work."""
    total = 0
    samples = {"nerf_mlp": v["model.num_nerf_samples"],
               "prop_mlp": v["model.num_prop_samples"]
               * (v["model.num_levels"] - 1)}
    for m, n in samples.items():
        layers = mlp_layers(v, m)
        macs = sum(a * b for _, a, b in layers)
        first = layers[0][1] * layers[0][2]
        total += n * (3 * macs - first)
    return 2.0 * v["batch_size"] * total
