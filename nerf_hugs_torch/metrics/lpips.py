"""LPIPS (AlexNet backbone) in PyTorch.

Twin of nerf_hugs_tpu/metrics/lpips.py (Zhang et al. 2018, the third
metric of the reference's scoring protocol):
  1. scale inputs from [0, 1] to [-1, 1], normalize by LPIPS shift/scale;
  2. AlexNet conv features at the 5 ReLU taps;
  3. unit-normalize each feature map across channels;
  4. squared difference, 1x1 learned linear head per layer, spatial mean;
  5. sum over layers.

No pretrained weights ship with the repository: `LPIPS.from_weights(path)`
loads an .npz with keys conv{i}_w, conv{i}_b, lin{i}_w (i in 0..4) or a
state_dict of the official `lpips` package; `random_init(seed)` draws the
same weights as the JAX package's from a numpy RandomState, for testing
the pipeline only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.nn import functional as F

from nerf_hugs_torch.utils.device import pin_fp32_precision

# AlexNet conv stack: (out_ch, kernel, stride, pad). A 3x3/2 max-pool sits
# before convs 1 and 2.
_ALEX_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_BEFORE = {1, 2}
# LPIPS input normalization (the 'scaling_layer' of the official repo).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _alexnet_features(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """The feature maps at the 5 taps; fewer where an image is too small
    for a pooling window or a kernel, whose maps would be empty."""
    feats = []
    for i, (_, kernel, stride, pad) in enumerate(_ALEX_CONVS):
        if i in _POOL_BEFORE:
            if min(x.shape[-2:]) < 3:
                break
            x = F.max_pool2d(x, kernel_size=3, stride=2)
        if min(x.shape[-2:]) + 2 * pad < kernel:
            break
        x = F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                     stride=stride, padding=pad)
        x = F.relu(x)
        feats.append(x)
    return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


class LPIPS:
    """Callable LPIPS distance over [H, W, 3] images in [0, 1]."""

    def __init__(self, params: Dict[str, np.ndarray], device="cpu"):
        self.device = torch.device(device)
        self.params = {k: torch.as_tensor(np.asarray(v, np.float32),
                                          device=self.device)
                       for k, v in params.items()}

    @classmethod
    def from_weights(cls, path: str, device="cpu") -> "LPIPS":
        if path.endswith(".npz"):
            params = dict(np.load(path))
        else:
            params = convert_torch_state_dict(path)
        return cls(params, device)

    @classmethod
    def random_init(cls, rng_seed: int = 0, device="cpu") -> "LPIPS":
        """Random weights: pipeline and shape testing only, not a valid
        metric."""
        rng = np.random.RandomState(rng_seed)
        params, in_ch = {}, 3
        for i, (out_ch, k, _, _) in enumerate(_ALEX_CONVS):
            params[f"conv{i}_w"] = rng.randn(out_ch, in_ch, k, k).astype(
                np.float32) * np.sqrt(2.0 / (in_ch * k * k))
            params[f"conv{i}_b"] = np.zeros(out_ch, np.float32)
            params[f"lin{i}_w"] = np.abs(
                rng.randn(out_ch).astype(np.float32)) * 0.01
            in_ch = out_ch
        return cls(params, device)

    def _prep(self, img) -> torch.Tensor:
        x = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        x = 2.0 * x - 1.0
        x = (x - torch.from_numpy(_SHIFT).to(self.device)) / torch.from_numpy(
            _SCALE).to(self.device)
        return x.permute(2, 0, 1)[None]  # NCHW

    @torch.no_grad()
    def __call__(self, img0, img1) -> torch.Tensor:
        pin_fp32_precision()
        f0 = _alexnet_features(self.params, self._prep(img0))
        f1 = _alexnet_features(self.params, self._prep(img1))
        if len(f0) < len(_ALEX_CONVS):
            # An empty map's spatial mean is NaN, and so is the JAX
            # package's distance.
            return torch.tensor(float("nan"), device=self.device)
        total = torch.zeros((), device=self.device)
        for i, (a, b) in enumerate(zip(f0, f1)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            w = self.params[f"lin{i}_w"].reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * w, dim=1))
        return total


def convert_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """An official-lpips (or torchmetrics) AlexNet LPIPS .pt/.pth
    state_dict -> the flat param dict. Conv keys live under
    net.slice{k}.{idx}.weight, linear heads under lin{i}.model.1.weight."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    out: Dict[str, np.ndarray] = {}
    conv_keys = sorted(
        (k for k in state if k.endswith(".weight") and state[k].ndim == 4
         and not k.startswith("lin") and ".lin" not in k),
        key=lambda k: tuple(int(t) for t in k.split(".") if t.isdigit()))
    if len(conv_keys) < 5:
        raise ValueError(f"expected >=5 conv weights in {path}, "
                         f"found {len(conv_keys)}")
    for i, k in enumerate(conv_keys[:5]):
        out[f"conv{i}_w"] = state[k].numpy()
        out[f"conv{i}_b"] = state[k.replace(".weight", ".bias")].numpy()
    lin_keys = sorted(k for k in state if ".lin" in k or k.startswith("lin"))
    lin_w = [k for k in lin_keys if k.endswith("weight")]
    if len(lin_w) < 5:
        raise ValueError(f"expected 5 linear heads in {path}")
    for i, k in enumerate(sorted(lin_w)[:5]):
        out[f"lin{i}_w"] = state[k].numpy().reshape(-1)
    return out
