"""Adam, gradient clipping and the train step.

Twin of nerf_hugs_tpu/train/step.py:66-252 for one device: the loss
composition of the JAX `loss_fn`, per-top-level-module clipping,
nan_to_num on the gradients and optax's Adam on the warmup-decay schedule.
The finetune stage waits (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import functools
from collections import defaultdict
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from nerf_hugs_torch.core import math as nh_math
from nerf_hugs_torch.losses import zoo
from nerf_hugs_torch.metrics.image import mse_to_psnr


def create_adam(params: Iterable[torch.nn.Parameter],
                lr_fn: Callable[[int], float], b1: float, b2: float,
                eps: float):
    """optax.adam(learning_rate=lr_fn, b1, b2, eps) as a fused torch Adam
    and a LambdaLR that sets the rate to lr_fn(count), count being the
    number of steps taken before this one (optax's 0-based schedule index).
    Returns (optimizer, scheduler); step both through `apply_gradients`."""
    opt = torch.optim.Adam(params, lr=1.0, betas=(b1, b2), eps=eps,
                           fused=True)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_fn)


def create_optimizer(config, model: torch.nn.Module):
    """Adam over every parameter with the config's betas, eps and the
    learning_rate_decay schedule; returns (optimizer, scheduler)."""
    lr_fn = functools.partial(
        nh_math.learning_rate_decay, lr_init=config.lr_init,
        lr_final=config.lr_final, max_steps=config.max_steps,
        lr_delay_steps=config.lr_delay_steps,
        lr_delay_mult=config.lr_delay_mult)
    return create_adam(model.parameters(), lr_fn, config.adam_beta1,
                       config.adam_beta2, config.adam_eps)


def apply_gradients(optimizer, scheduler,
                    params: Dict[str, torch.nn.Parameter],
                    grads: Dict[str, Optional[torch.Tensor]]) -> None:
    """One Adam step on `grads` after nan_to_num. A parameter without a
    gradient (the proposal net on a step that does not update it) steps
    with a zero gradient, as optax does with the zero cotangent."""
    for k, p in params.items():
        g = grads.get(k)
        p.grad = torch.zeros_like(p) if g is None else torch.nan_to_num(g)
    optimizer.step()
    scheduler.step()


def clip_gradients(grads: Dict[str, Optional[torch.Tensor]], config):
    """Per-top-level-module value + norm clipping (train_utils.py:351-368)."""
    if config.grad_max_val <= 0 and config.grad_max_norm <= 0:
        return grads
    groups = defaultdict(list)
    for k, g in grads.items():
        if g is not None:
            groups[k.split(".")[0]].append(k)
    out = dict(grads)
    for keys in groups.values():
        gs = [out[k] for k in keys]
        if config.grad_max_val > 0:
            gs = [torch.clamp(g, -config.grad_max_val, config.grad_max_val)
                  for g in gs]
        if config.grad_max_norm > 0:
            norm = torch.sqrt(sum(torch.sum(g ** 2) for g in gs))
            mult = torch.clamp(config.grad_max_norm
                               / (np.finfo(np.float32).eps + norm), max=1.0)
            gs = [g * mult for g in gs]
        out.update(zip(keys, gs))
    return out


def compute_loss(model, batch, train_frac: float, config,
                 rng: Optional[torch.Generator]):
    """Forward + loss composition of the JAX loss_fn (step.py:189-233).
    Returns (loss, stats) with stats['losses'] and stats['mses']."""
    rays = batch.rays
    renderings, ray_history = model(
        rays, train_frac, compute_extras=False,
        rng=rng if config.randomized else None)
    if config.transient_type is None:
        losses, stats = zoo.compute_data_loss(batch, rays, renderings,
                                              config, False)
    elif config.transient_type == "withmask":
        losses, stats = zoo.compute_data_loss(batch, rays, renderings,
                                              config, True)
    else:
        raise NotImplementedError(
            f"transient_type {config.transient_type!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 12)")
    if config.interlevel_loss_mult > 0:
        losses["interlevel"] = zoo.interlevel_loss(ray_history, config)
    if config.distortion_loss_mult > 0:
        losses["distortion"] = zoo.distortion_loss(ray_history, config)
    loss = sum(losses.values())
    stats["losses"] = losses
    return loss, stats


def train_step(model, optimizer, scheduler, batch, train_frac: float,
               config, rng: Optional[torch.Generator]) -> dict:
    """One optimization step; returns detached stats (loss, losses, mses,
    psnrs, psnr) as device tensors, without synchronising."""
    for p in model.parameters():
        p.grad = None
    loss, stats = compute_loss(model, batch, train_frac, config, rng)
    loss.backward()
    params = dict(model.named_parameters())
    grads = clip_gradients({k: p.grad for k, p in params.items()}, config)
    apply_gradients(optimizer, scheduler, params, grads)
    mses = stats["mses"].detach()
    psnrs = mse_to_psnr(mses)
    return {"loss": loss.detach(), "mses": mses, "psnrs": psnrs,
            "psnr": psnrs[-1],
            "losses": {k: v.detach() for k, v in stats["losses"].items()}}
