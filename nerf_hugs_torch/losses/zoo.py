"""The transient-handling loss zoo and the mip-NeRF 360 regularizers.

Twin of nerf_hugs_tpu/losses/zoo.py (MipNeRF360/internal/train_utils.py:
72-248): the data loss (base and withmask), RobustNeRF's patch-wise inlier
mask with its carried threshold, NeRF-W's uncertainty-weighted loss,
HA-NeRF's implicit-mask loss, and the interlevel and distortion losses.

Under a process group each rank holds its share of JAX's global batch, and
the train step averages the ranks' gradients and stats. A loss that is a
mean over the rays needs nothing more; a weighted one (the data loss and
RobustNeRF's) divides by the global batch's weight over the world size
(_denominator), so that the mean over ranks is JAX's weighted mean, and
RobustNeRF's next threshold is the quantile of every rank's pixel errors.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.nn import functional as F

from nerf_hugs_torch.core import stepfun
from nerf_hugs_torch.parallel import mesh


def _per_level_data_loss(resid_sq, config):
    if config.data_loss_type == "mse":
        return resid_sq
    if config.data_loss_type == "charb":
        return torch.sqrt(resid_sq + config.charb_padding ** 2)
    raise ValueError(f"unknown data_loss_type {config.data_loss_type!r}")


def _combine_levels(data_losses: List[torch.Tensor], config):
    """data_loss_mult x the final level + data_coarse_loss_mult x the sum
    of the others."""
    data = config.data_loss_mult * data_losses[-1]
    if len(data_losses) > 1:
        data = data + config.data_coarse_loss_mult * sum(data_losses[:-1])
    return data


def _denominator(lossmult: torch.Tensor) -> torch.Tensor:
    """max(sum of lossmult over the global batch, eps) / world size: each
    rank's weighted sum over it has JAX's weighted mean as its mean over
    the ranks. One process: max(lossmult.sum(), eps)."""
    total = mesh.all_sum(lossmult.sum().detach())
    return (torch.clamp(total, min=torch.finfo(lossmult.dtype).eps)
            / mesh.process_count())


def target_rgb(batch, rendering):
    """Ground-truth rgb; RGBA targets are composited over the background the
    model rendered this batch with (rendering['bg_rgb'])."""
    rgb = batch.rgb
    if rgb.shape[-1] == 4:
        alpha = rgb[..., 3:]
        return rgb[..., :3] * alpha + rendering["bg_rgb"] * (1.0 - alpha)
    return rgb[..., :3]


def compute_data_loss(batch, rays, renderings: List[dict], config,
                      use_static_mask: bool):
    """lossmult-weighted mse/charb over the renderings; withmask folds the
    HuGS static mask into the per-ray weight."""
    data_losses, mses = [], []
    for rendering in renderings:
        if use_static_mask:
            static_mask = (rays.static_mask >= 0.5).to(batch.rgb.dtype)
            lossmult = (static_mask + (1 - static_mask)
                        * config.withmask_transient_weight)
        else:
            lossmult = rays.lossmult
            if config.disable_multiscale_loss:
                lossmult = torch.ones_like(lossmult)
        lossmult = lossmult.expand(batch.rgb[..., :3].shape)
        resid_sq = (rendering["rgb"] - target_rgb(batch, rendering)) ** 2
        denom = _denominator(lossmult)
        mses.append((lossmult * resid_sq).sum() / denom)
        data_loss = _per_level_data_loss(resid_sq, config)
        data_losses.append((lossmult * data_loss).sum() / denom)
    losses: Dict[str, torch.Tensor] = {"data": _combine_levels(data_losses,
                                                               config)}
    return losses, {"mses": torch.stack(mses)}


def _inner_patch_mask(inner: int, outer: int, device) -> torch.Tensor:
    """[1, outer, outer, 1] bool, true on the centred inner x inner
    square (an odd margin leaves its extra pixel after the square, as
    JAX's pad does)."""
    lo = (outer - inner) // 2
    mask = torch.zeros((1, outer, outer, 1), dtype=torch.bool, device=device)
    mask[:, lo:lo + inner, lo:lo + inner] = True
    return mask


def _box_mean_nhwc(x: torch.Tensor, size: int) -> torch.Tensor:
    """A SAME, zero-padded box sum over the two spatial dims of [n, h, w, 1]
    divided by size^2: XLA's SAME pads size - 1 in all, (size - 1) // 2
    before and the rest after, so an even size pads one more after."""
    lo = (size - 1) // 2
    hi = size - 1 - lo
    padded = F.pad(x.permute(0, 3, 1, 2), (lo, hi, lo, hi))
    return F.avg_pool2d(padded, size, stride=1).permute(0, 2, 3, 1)


def robustnerf_mask(errors: torch.Tensor, inlier_threshold, config):
    """RobustNeRF's inlier mask over [n, p, p, c] patch errors. A pixel
    keeps its loss if any of: (a) its channel-mean error is below the
    threshold carried from the previous step; (b) more than q_s of its
    f x f neighbourhood passes (a); (c) it lies in the centred inner patch
    and more than q_p of its patch passes (a). Returns (mask, stats);
    stats['inlier_threshold'] is the next step's threshold, the
    robustnerf_inlier_quantile of this step's pixel errors over every
    rank (linear interpolation, as jnp.quantile over JAX's global batch).
    The masks stay per rank: each rank's batch holds whole patches."""
    if config.robustnerf_inner_patch_size > config.patch_size:
        raise ValueError("robustnerf_inner_patch_size must be <= patch_size")
    dtype = errors.dtype
    pixel_err = errors.mean(dim=-1, keepdim=True)             # [n, p, p, 1]
    inlier = (pixel_err < inlier_threshold).to(dtype)
    frac = _box_mean_nhwc(inlier, config.robustnerf_smoothed_filter_size)
    neighbor_ok = frac > 1 - config.robustnerf_smoothed_inlier_quantile
    patch_frac = inlier.mean(dim=(1, 2), keepdim=True)         # [n,1,1,1]
    patch_ok = ((patch_frac
                 > 1 - config.robustnerf_inner_patch_inlier_quantile)
                & _inner_patch_mask(config.robustnerf_inner_patch_size,
                                    config.patch_size, errors.device))
    mask = ((inlier > 0) | neighbor_ok | patch_ok).to(dtype)
    stats = {
        "inlier_threshold": torch.quantile(
            mesh.gather_rows(pixel_err.reshape(-1)),
            config.robustnerf_inlier_quantile),
        "is_inlier_loss": inlier.mean(),
        "has_inlier_neighbors": neighbor_ok.to(dtype).mean(),
        "is_inlier_patch": patch_ok.to(dtype).mean(),
        "mask": mask.mean(),
    }
    return mask, stats


def compute_robustnerf_loss(batch, renderings: List[dict],
                            inlier_thresholds: torch.Tensor, config):
    """Per-level data loss under RobustNeRF's mask; the rays' errors are
    read as [n, p, p, 3] patches, so the batch must hold whole patches in
    the sampler's order. inlier_thresholds: [num levels], carried from the
    previous step on the device; the next step's come back as
    stats['robust_inlier_threshold']."""
    p = config.patch_size
    data_losses, mses = [], []
    robust = {}
    for i, rendering in enumerate(renderings):
        resid_sq = (rendering["rgb"] - target_rgb(batch, rendering)) ** 2
        data_loss = _per_level_data_loss(resid_sq, config)
        errors = torch.sqrt(resid_sq.detach()).reshape(-1, p, p, 3)
        mask, robust_stats = robustnerf_mask(errors, inlier_thresholds[i],
                                             config)
        for key, val in robust_stats.items():
            robust.setdefault(f"robust_{key}", []).append(val)
        lossmult = mask.reshape(resid_sq.shape[:-1] + (1,)).expand(
            data_loss.shape)
        denom = _denominator(lossmult)
        mses.append((lossmult * resid_sq).sum() / denom)
        data_losses.append((lossmult * data_loss).sum() / denom)
    stats = {k: torch.stack(v) for k, v in robust.items()}
    stats["mses"] = torch.stack(mses)
    return {"data": _combine_levels(data_losses, config)}, stats


def compute_nerfw_loss(batch, renderings: List[dict],
                       ray_history: List[dict], config):
    """NeRF-W: the combined colour's residual over 2 beta^2 at the final
    level (beta the per-ray uncertainty [n, 1] against the [n, 3]
    residual), plus mult x mean(log beta) + bias and the mean transient
    density x its mult."""
    beta = renderings[-1]["uncertainty"]
    density_t = ray_history[-1]["density_transient"]
    losses: Dict[str, torch.Tensor] = {}
    data_losses, mses = [], []
    for i, rendering in enumerate(renderings):
        pred = rendering.get("rgb_combined", rendering["rgb"])
        resid_sq = (pred - target_rgb(batch, rendering)) ** 2
        data_loss = _per_level_data_loss(resid_sq, config)
        if i == len(renderings) - 1:
            losses["beta"] = (config.nerfw_beta_loss_mult
                              * torch.log(beta).mean()
                              + config.nerfw_beta_loss_bias)
            data_loss = data_loss / (2 * beta ** 2)
            losses["density"] = (config.nerfw_density_loss_mult
                                 * density_t.mean())
        data_losses.append(data_loss.mean())
        mses.append(resid_sq.mean())
    losses["data"] = _combine_levels(data_losses, config)
    return losses, {"mses": torch.stack(mses)}


def hanerf_mask_size_mult(train_frac: float, config) -> float:
    """The mask-size weight: max * exp(-k * step), floored at min, in
    float32 like the jitted JAX arithmetic."""
    f32 = np.float32
    decay = np.exp(-f32(train_frac) * f32(config.max_steps)
                   * f32(config.hanerf_mask_size_loss_mult_k))
    return float(np.maximum(
        f32(config.hanerf_mask_size_loss_mult_min),
        f32(config.hanerf_mask_size_loss_mult_max) * decay))


def compute_hanerf_loss(batch, renderings: List[dict], train_frac: float,
                        config):
    """HA-NeRF: the final level's data loss weighted by (1 - implicit
    mask), plus the decayed mask-size penalty mean(mask^2); earlier levels
    take the detached mask, so only the final level trains it."""
    implicit_mask = renderings[-1]["implicit_mask"]
    losses: Dict[str, torch.Tensor] = {}
    data_losses, mses = [], []
    for i, rendering in enumerate(renderings):
        resid_sq = (rendering["rgb"] - target_rgb(batch, rendering)) ** 2
        data_loss = _per_level_data_loss(resid_sq, config)
        if i == len(renderings) - 1:
            data_loss = (1.0 - implicit_mask) * data_loss
            losses["mask_size"] = (hanerf_mask_size_mult(train_frac, config)
                                   * (implicit_mask ** 2).mean())
        else:
            data_loss = (1.0 - implicit_mask.detach()) * data_loss
        data_losses.append(data_loss.mean())
        mses.append(resid_sq.mean())
    losses["data"] = _combine_levels(data_losses, config)
    return losses, {"mses": torch.stack(mses),
                    "implicit_mask": implicit_mask.mean()}


def interlevel_loss(ray_history: List[dict], config):
    """Proposal-envelope loss; the NeRF-level histogram is detached so only
    the proposals move."""
    c = ray_history[-1]["sdist"].detach()
    w = ray_history[-1]["weights"].detach()
    loss = 0.0
    for ray_results in ray_history[:-1]:
        loss = loss + torch.mean(stepfun.lossfun_outer(
            c, w, ray_results["sdist"], ray_results["weights"]))
    return config.interlevel_loss_mult * loss


def distortion_loss(ray_history: List[dict], config):
    """Mip-NeRF 360 distortion on the final level."""
    return config.distortion_loss_mult * torch.mean(
        stepfun.lossfun_distortion(ray_history[-1]["sdist"],
                                   ray_history[-1]["weights"]))
