"""Plain PyTorch pieces the references share: the precision of a matrix
product, interval sampling by inverse CDF, alpha compositing, the
interlevel loss, clipping, optax's Adam and its learning-rate schedule.

The sampling functions repeat the published Mip-NeRF 360 step-function
math (MultiNeRF's stepfun.py) call for call, so that a generator seeded
alike draws the same jitter as the program under test. Nothing here
imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

EPS = float(np.finfo(np.float32).eps)

# The precisions a reference computes its matrix products in (`linear`):
# float32 (the reference itself, TF32 off) and fp8 (the control of a
# bfloat16 configuration: inputs and weights rounded to e4m3, gradients to
# e5m2, each with one scale a tensor, products rounded to bfloat16).
_FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _fp8_round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` under a per-tensor scale that maps its largest
    magnitude onto the format's largest value, and scaled back."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = _FP8[dtype] / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """e4m3 forward, e5m2 backward (the usual fp8 training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           precision: str) -> torch.Tensor:
    """x @ weight.T + bias in `precision`; float32 out."""
    if precision == "float32":
        return F.linear(x.float(), weight, bias)
    if precision == "fp8":
        y = F.linear(_Fp8.apply(x.float()), _Fp8.apply(weight)) + bias
        return y.to(torch.bfloat16).float()
    raise ValueError(f"unknown precision {precision!r}")


def set_exact_float32() -> None:
    """Full float32 matrix products on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- step functions (MultiNeRF stepfun.py / math.py) ----

def _bracket(xp, x):
    return torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)


def sorted_interp(x, xp, fp):
    """Piecewise-linear interpolation of x into ascending (xp, fp): lo is
    the last xp <= x (clamped to 0), hi the next (clamped to n - 1)."""
    n = xp.shape[-1]
    count = _bracket(xp, x)
    lo = torch.clamp(count - 1, min=0)
    hi = torch.clamp(count, max=n - 1)
    xp_lo, xp_hi = torch.gather(xp, -1, lo), torch.gather(xp, -1, hi)
    fp_lo, fp_hi = torch.gather(fp, -1, lo), torch.gather(fp, -1, hi)
    frac = torch.clamp(torch.nan_to_num((x - xp_lo) / (xp_hi - xp_lo),
                                        nan=0.0), 0.0, 1.0)
    return fp_lo + frac * (fp_hi - fp_lo)


def integrate_weights(w):
    """CDF endpoints of bin weights summing to 1: from 0 to 1."""
    cdf = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1)
    pad = torch.zeros(cdf.shape[:-1] + (1,), dtype=cdf.dtype,
                      device=cdf.device)
    return torch.cat([pad, cdf, torch.ones_like(pad)], dim=-1)


def invert_cdf(u, t, w_logits):
    """u in [0, 1) through the inverse CDF of softmax(w_logits) over the
    endpoints t; rays whose logits are all -inf sample uniformly."""
    all_masked = torch.all(torch.isneginf(w_logits), dim=-1, keepdim=True)
    w_logits = torch.where(all_masked, torch.ones_like(w_logits), w_logits)
    w = torch.softmax(w_logits, dim=-1)
    return sorted_interp(u, integrate_weights(w), t)


def sample_intervals(gen: torch.Generator, t, w_logits, num_samples: int,
                     single_jitter: bool, domain):
    """num_samples + 1 sorted endpoints whose interval centres follow the
    step function's PDF, stratified and jittered from `gen` (one offset a
    ray under single_jitter); the outer two reflected about the end
    centres and clamped to `domain`."""
    u_max = EPS + (1 - EPS) / num_samples
    max_jitter = (1 - u_max) / (num_samples - 1) - EPS
    d = 1 if single_jitter else num_samples
    jitter = torch.rand(t.shape[:-1] + (d,), generator=gen, device=t.device)
    u = torch.linspace(0, 1 - u_max, num_samples, device=t.device) \
        + jitter * max_jitter
    centers = invert_cdf(u, t, w_logits)
    mid = 0.5 * (centers[..., 1:] + centers[..., :-1])
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=domain[0])
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=domain[1])
    return torch.cat([first, mid, last], dim=-1)


def lossfun_outer(t, w, t_env, w_env):
    """The NeRF level's mass above the proposal's envelope (the
    interlevel loss of Mip-NeRF 360, Eq. 13)."""
    cum = torch.cat([torch.zeros_like(w_env[..., :1]),
                     torch.cumsum(w_env, dim=-1)], dim=-1)
    n = t_env.shape[-1]
    count = _bracket(t_env, t)
    lo = torch.clamp(count - 1, min=0)
    hi = torch.clamp(count, max=n - 1)
    w_outer = torch.gather(cum, -1, hi)[..., 1:] \
        - torch.gather(cum, -1, lo)[..., :-1]
    return torch.clamp(w - w_outer, min=0) ** 2 / (w + EPS)


def interlevel_loss(history, mult: float):
    """mult x the mean outer loss of each proposal level against the final
    level's detached histogram."""
    c, w = history[-1][0].detach(), history[-1][1].detach()
    loss = 0.0
    for sdist, weights in history[:-1]:
        loss = loss + torch.mean(lossfun_outer(c, w, sdist, weights))
    return mult * loss


# ---- compositing ----

def alpha_weights(density, tdist, dirs, opaque_background: bool):
    """Compositing weights alpha_i T_i of the intervals tdist; with an
    opaque background the last interval is infinitely deep."""
    delta = (tdist[..., 1:] - tdist[..., :-1]) \
        * torch.linalg.norm(dirs[..., None, :], dim=-1)
    dd = density * delta
    if opaque_background:
        dd = torch.cat([dd[..., :-1],
                        torch.full_like(dd[..., -1:], float("inf"))], dim=-1)
    alpha = 1.0 - torch.exp(-dd)
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]),
                                  torch.cumsum(dd[..., :-1], dim=-1)], dim=-1))
    return alpha * trans


def composite(rgbs, weights, bg):
    """The colours over the weights, the background behind what they
    leave."""
    acc = weights.sum(dim=-1)
    bg_w = torch.clamp(1 - acc[..., None], min=0)
    return (weights[..., None] * rgbs).sum(dim=-2) + bg_w * bg


def data_loss(rgb, target, data_type: str) -> torch.Tensor:
    """The mean squared error over the rays and channels (every ray's
    weight is 1)."""
    if data_type != "mse":
        raise ValueError(f"the references compute mse, not {data_type!r}")
    resid_sq = (rgb - target) ** 2
    return resid_sq.sum() / max(float(resid_sq.numel()), EPS)


# ---- optimisation ----

def learning_rate_decay(step, lr_init, lr_final, max_steps,
                        lr_delay_steps=0, lr_delay_mult=1.0) -> float:
    """Log-linear decay from lr_init to lr_final over max_steps, under a
    sine warm-up from lr_delay_mult over lr_delay_steps."""
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(t * (math.log(lr_final) - math.log(lr_init))
                            + math.log(lr_init))


def clip_by_module(grads: Dict[str, torch.Tensor], max_val: float,
                   max_norm: float) -> Dict[str, torch.Tensor]:
    """Value, then norm clipping of each top-level module's gradients (the
    first part of a parameter's name) as one vector."""
    if max_val <= 0 and max_norm <= 0:
        return grads
    out = dict(grads)
    modules = sorted({k.split(".")[0] for k in grads})
    for m in modules:
        keys = [k for k in grads if k.split(".")[0] == m]
        gs = [out[k] for k in keys]
        if max_val > 0:
            gs = [torch.clamp(g, -max_val, max_val) for g in gs]
        if max_norm > 0:
            norm = torch.sqrt(sum(torch.sum(g ** 2) for g in gs))
            mult = torch.clamp(max_norm / (EPS + norm), max=1.0)
            gs = [g * mult for g in gs]
        out.update(zip(keys, gs))
    return out


class Adam:
    """optax.adam in float32: moments mu, nu; bias corrections
    1 - b ** count with b and the power in float32; the update
    -lr * mu_hat / (sqrt(nu_hat) + eps)."""

    def __init__(self, params: Dict[str, torch.Tensor], b1: float, b2: float,
                 eps: float):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads, lr: float) -> None:
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            update = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                           + self.eps)
            p.sub_(lr * update)


def train_fraction(step: int, max_steps: int) -> float:
    """(step - 1) / (max_steps - 1), clipped to [0, 1]; steps from 1."""
    return float(np.clip((step - 1) / max(max_steps - 1, 1), 0, 1))


class Trainer:
    """Plain training of one reference model: its parameters (float32
    leaves named as the program names them), optax's Adam and the
    schedule of `values`; `step` runs one step and returns the loss and
    the gradient Adam took."""

    def __init__(self, model, params: Dict[str, torch.Tensor], values: dict,
                 precision: str = "float32"):
        self.model, self.values, self.precision = model, values, precision
        self.params = {k: p.detach().clone().requires_grad_(True)
                       for k, p in params.items()}
        self.adam = Adam(self.params, values["adam_beta1"],
                         values["adam_beta2"], values["adam_eps"])
        self.steps = 0

    def step(self, rays: dict, rgb: torch.Tensor, gen: torch.Generator):
        v = self.values
        self.steps += 1
        for p in self.params.values():
            p.grad = None
        frac = train_fraction(self.steps, v["max_steps"])
        loss = self.model.loss(self.params, rays, rgb, frac, gen, v,
                               self.precision)
        loss.backward()
        grads = {k: (torch.zeros_like(p) if p.grad is None
                     else torch.nan_to_num(p.grad))
                 for k, p in self.params.items()}
        grads = clip_by_module(grads, v["grad_max_val"], v["grad_max_norm"])
        lr = learning_rate_decay(
            self.steps - 1, v["lr_init"], v["lr_final"], v["max_steps"],
            v["lr_delay_steps"], v["lr_delay_mult"])
        self.adam.step(self.params, grads, lr)
        return loss.detach(), grads


def draw_background(gen: Optional[torch.Generator], shape, device,
                    color) -> torch.Tensor:
    """`random`: uniform draws from `gen`; a number: that grey."""
    if color == "random":
        return torch.rand(shape, generator=gen, device=device)
    return torch.full(shape, float(color), device=device)
