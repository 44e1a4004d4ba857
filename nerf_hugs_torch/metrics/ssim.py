"""SSIM with the TF/dm_pix defaults, in PyTorch.

Twin of nerf_hugs_tpu/metrics/ssim.py: Wang et al. 2004 with an 11x11
Gaussian window (sigma 1.5), k1 = 0.01, k2 = 0.03, VALID padding, the mean
over space and channels. The window is separable: two depthwise
`F.conv2d` passes. The statistics cancel (sigma = E[x^2] - mu^2), so the
convolutions must run in full float32: TF32 (cuDNN's default on the card)
pushes SSIM above 1 on smooth regions, the fault the JAX package pins
Precision.HIGHEST against.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from nerf_hugs_torch.utils.device import pin_fp32_precision


def _gaussian_kernel(filter_size: int, sigma: float) -> np.ndarray:
    offsets = np.arange(filter_size, dtype=np.float64) - (filter_size - 1) / 2
    g = np.exp(-0.5 * (offsets / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _filter2d(img: torch.Tensor, kernel1d: torch.Tensor) -> torch.Tensor:
    """Separable VALID blur of [H, W, C] -> [H-f+1, W-f+1, C]."""
    c, f = img.shape[-1], kernel1d.shape[0]
    x = img.permute(2, 0, 1)[None]  # NCHW
    x = F.conv2d(x, kernel1d.reshape(1, 1, f, 1).repeat(c, 1, 1, 1),
                 groups=c)
    x = F.conv2d(x, kernel1d.reshape(1, 1, 1, f).repeat(c, 1, 1, 1),
                 groups=c)
    return x[0].permute(1, 2, 0)


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         return_map: bool = False) -> torch.Tensor:
    """SSIM between two [H, W, C] (or [H, W]) images in [0, max_val], on
    the device of img0 when it is a tensor."""
    pin_fp32_precision()
    device = img0.device if isinstance(img0, torch.Tensor) else "cpu"
    img0 = torch.as_tensor(img0, dtype=torch.float32, device=device)
    img1 = torch.as_tensor(img1, dtype=torch.float32, device=device)
    if img0.dim() == 2:
        img0, img1 = img0[..., None], img1[..., None]
    if min(img0.shape[:2]) < filter_size:
        # The JAX twin returns the mean of an empty map (NaN) here.
        raise ValueError(f"SSIM needs images of at least {filter_size} px a "
                         f"side, got {tuple(img0.shape[:2])}")
    kernel = torch.from_numpy(_gaussian_kernel(filter_size, filter_sigma)
                              ).to(device)
    mu0 = _filter2d(img0, kernel)
    mu1 = _filter2d(img1, kernel)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = _filter2d(img0 * img0, kernel) - mu00
    sigma11 = _filter2d(img1 * img1, kernel) - mu11
    sigma01 = _filter2d(img0 * img1, kernel) - mu01

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else ssim_map.mean()
