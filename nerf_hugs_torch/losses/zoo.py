"""Data, interlevel and distortion losses (the main-path part of the zoo).

Twin of nerf_hugs_tpu/losses/zoo.py:44-81,231-247 (MipNeRF360/internal/
train_utils.py:72-111,228-248). robustnerf, nerfw and hanerf wait
(ROADMAP.md Queue 1 item 12).
"""

from __future__ import annotations

from typing import Dict, List

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
