"""Data, HA-NeRF, interlevel and distortion losses.

Twin of nerf_hugs_tpu/losses/zoo.py:44-81,200-247 (MipNeRF360/internal/
train_utils.py:72-111,186-248). robustnerf and nerfw wait (ROADMAP.md
Queue 1 item 12).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from nerf_hugs_torch.core import stepfun


def _per_level_data_loss(resid_sq, config):
    if config.data_loss_type == "mse":
        return resid_sq
    if config.data_loss_type == "charb":
        return torch.sqrt(resid_sq + config.charb_padding ** 2)
    raise ValueError(f"unknown data_loss_type {config.data_loss_type!r}")


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
        denom = torch.clamp(lossmult.sum(),
                            min=torch.finfo(lossmult.dtype).eps)
        mses.append((lossmult * resid_sq).sum() / denom)
        data_loss = _per_level_data_loss(resid_sq, config)
        data_losses.append((lossmult * data_loss).sum() / denom)
    data = config.data_loss_mult * data_losses[-1]
    if len(data_losses) > 1:
        data = data + config.data_coarse_loss_mult * sum(data_losses[:-1])
    losses: Dict[str, torch.Tensor] = {"data": data}
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
    data = config.data_loss_mult * data_losses[-1]
    if len(data_losses) > 1:
        data = data + config.data_coarse_loss_mult * sum(data_losses[:-1])
    losses["data"] = data
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
