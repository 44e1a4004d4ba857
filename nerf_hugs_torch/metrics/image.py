"""Image metrics and colour processing for evaluation.

Twin of nerf_hugs_tpu/metrics/image.py: alpha compositing of GT images,
PSNR <-> MSE, the area downsample of the blender loader, the iterative
per-channel quadratic colour correction (float64 numpy, as the
reference's eval protocol solves it) and the MetricHarness that eval and
the in-train eval score with (PSNR, SSIM, and LPIPS when a weights file
is given).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from nerf_hugs_torch.configs import config as _config
from nerf_hugs_torch.metrics.ssim import ssim

# The background palette the models' _background draws from.
BACKGROUND_VALUES = _config.BACKGROUND_VALUES


def composite_alpha(image: np.ndarray, background: float) -> np.ndarray:
    """Composite an RGBA image over a constant background; passes 3-channel
    images through."""
    if image.shape[-1] != 4:
        return image[..., :3]
    alpha = image[..., 3:]
    return image[..., :3] * alpha + background * (1.0 - alpha)


def mse_to_psnr(mse) -> torch.Tensor:
    """PSNR for max pixel value 1, in float32."""
    mse = torch.as_tensor(mse, dtype=torch.float32)
    return -10.0 / math.log(10.0) * torch.log(mse)


def psnr_to_mse(psnr) -> torch.Tensor:
    psnr = torch.as_tensor(psnr, dtype=torch.float32)
    return torch.exp(-0.1 * math.log(10.0) * psnr)


def downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Area (box-filter) downsample; factor must divide both spatial
    dims."""
    sh = img.shape
    if sh[0] % factor or sh[1] % factor:
        raise ValueError(
            f"downsample factor {factor} does not divide image shape "
            f"{sh[:2]}")
    img = img.reshape((sh[0] // factor, factor, sh[1] // factor, factor)
                      + sh[2:])
    return img.mean(axis=(1, 3))


def color_correct(img, ref, num_iters: int = 5, eps: float = 0.5 / 255):
    """Per-channel quadratic colour warp fitting img to ref.

    Masked least squares on a quadratic feature expansion, iterated because
    the set of saturated pixels changes as the warp updates; solved in
    float64 numpy."""
    if img.shape[-1] != ref.shape[-1]:
        raise ValueError(
            f"channel mismatch: img {img.shape[-1]} vs ref {ref.shape[-1]}")
    num_channels = img.shape[-1]
    img_mat = np.asarray(img, np.float64).reshape(-1, num_channels)
    ref_mat = np.asarray(ref, np.float64).reshape(-1, num_channels)
    is_unclipped = lambda z: (z >= eps) & (z <= 1 - eps)
    mask0 = is_unclipped(img_mat)
    for _ in range(num_iters):
        feats = [img_mat[:, c:c + 1] * img_mat[:, c:]
                 for c in range(num_channels)]
        feats += [img_mat, np.ones_like(img_mat[:, :1])]
        a_mat = np.concatenate(feats, axis=-1)
        warp = []
        for c in range(num_channels):
            b = ref_mat[:, c]
            mask = mask0[:, c] & is_unclipped(img_mat[:, c]) & is_unclipped(b)
            w = np.linalg.lstsq(np.where(mask[:, None], a_mat, 0),
                                np.where(mask, b, 0), rcond=-1)[0]
            if not np.all(np.isfinite(w)):
                raise FloatingPointError(
                    "color_correct solve produced non-finite warp")
            warp.append(w)
        img_mat = np.clip(a_mat @ np.stack(warp, -1), 0, 1)
    return img_mat.reshape(np.asarray(img).shape).astype(
        np.asarray(img).dtype)


class MetricHarness:
    """PSNR + SSIM of [H, W, 3] images in [0, 1], computed in float32 on
    `device`; LPIPS too when a weights path is given."""

    def __init__(self, lpips_weights_path: Optional[str] = None,
                 device="cpu"):
        self.device = torch.device(device)
        self.lpips_fn = None
        if lpips_weights_path is not None:
            from nerf_hugs_torch.metrics import lpips
            self.lpips_fn = lpips.LPIPS.from_weights(lpips_weights_path,
                                                     self.device)

    @torch.no_grad()
    def __call__(self, rgb_pred, rgb_gt, name_fn=lambda s: s) -> dict:
        pred = torch.as_tensor(np.asarray(rgb_pred), dtype=torch.float32,
                               device=self.device)
        gt = torch.as_tensor(np.asarray(rgb_gt), dtype=torch.float32,
                             device=self.device)
        out = {name_fn("psnr"): float(mse_to_psnr(
                   ((pred - gt) ** 2).mean().cpu())),
               name_fn("ssim"): float(ssim(pred, gt))}
        if self.lpips_fn is not None:
            out[name_fn("lpips")] = float(self.lpips_fn(pred, gt))
        return out
