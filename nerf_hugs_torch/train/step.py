"""Adam, gradient clipping, the finetune partition and the train step.

Twin of nerf_hugs_tpu/train/step.py:66-252 for one device: the loss
composition of the JAX `loss_fn` (base, withmask, robustnerf, nerfw and
hanerf; a data-only loss in the finetune stage), per-top-level-module
clipping, nan_to_num on the gradients and optax's Adam on the
warmup-decay schedule, and the weight-decay term of weight_decay_mults
(Mip-NeRF 360). The finetune stage trains the config's finetune_params
groups only (Mip-NeRF 360: its embeddings): the frozen parameters take no
gradient
(requires_grad off), and Adam holds the trainable ones alone, which moves
the same values as optax.multi_transform with set_to_zero on the rest.
Under a process group the step averages the ranks' gradients before
clipping, as JAX clips the gradient of the global batch's loss, and the
stats it returns are means over the ranks.
"""

from __future__ import annotations

import functools
import math
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from nerf_hugs_torch.core import math as nh_math
from nerf_hugs_torch.losses import zoo
from nerf_hugs_torch.metrics.image import mse_to_psnr
from nerf_hugs_torch.parallel import mesh
from nerf_hugs_torch.utils import trace


class OptaxAdam(torch.optim.Adam):
    """torch's fused Adam, stepping as optax.adam does in float32. optax's
    moments decay by (1 - b) rounded from double, as torch's do, but its
    bias corrections are 1 - b ** count in float32 with b rounded to
    float32 first (1 - 0.999f = 0.000999987, not 0.001), where torch's are
    in double: 6.4e-6 relative on the step size at b2 = 0.999. Each step
    folds the difference into the group's rate and eps: with
    r = sqrt(bc2_f32 / bc2), the rate times r * bc1 / bc1_f32 and eps
    times r give optax's lr * mu_hat / (sqrt(nu_hat) + eps). The count
    lives in the param group, so it rides in the optimizer's state_dict."""

    @torch.no_grad()
    def step(self, closure=None):
        saved = []
        for group in self.param_groups:
            group["count"] = t = group.get("count", 0) + 1
            b1, b2 = group["betas"]
            bc_f32 = lambda b: float(np.float32(1)
                                     - np.float32(b) ** np.float32(t))
            r = math.sqrt(bc_f32(b2) / (1 - b2 ** t))
            saved.append((group["lr"], group["eps"]))
            group["lr"] *= r * (1 - b1 ** t) / bc_f32(b1)
            group["eps"] *= r
        loss = super().step(closure)
        for group, (lr, eps) in zip(self.param_groups, saved):
            group["lr"], group["eps"] = lr, eps
        return loss


def create_adam(params: Iterable[torch.nn.Parameter],
                lr_fn: Callable[[int], float], b1: float, b2: float,
                eps: float):
    """optax.adam(learning_rate=lr_fn, b1, b2, eps) as a fused OptaxAdam
    and a LambdaLR that sets the rate to lr_fn(count), count being the
    number of steps taken before this one (optax's 0-based schedule index).
    Returns (optimizer, scheduler); step both through `apply_gradients`.
    Their construction adds its seconds to the counter
    `setup.optimizer_s` (utils/trace.py)."""
    with trace.timed("setup.optimizer_s"):
        opt = OptaxAdam(params, lr=1.0, betas=(b1, b2), eps=eps, fused=True)
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


# Mip-NeRF 360's nn.Embedding modules (flax nn.Embed, leaf 'embedding').
EMBED_MODULES = ("GloEmbed_0", "TransientEmbed_0")
FINETUNE_GROUPS = ("field", "proposal", "appearance_embedding",
                   "transient_embedding", "implicit_mask")


def finetune_partitions(config, names: Iterable[str]) -> Dict[str, str]:
    """{parameter name: 'trainable' | 'frozen'} for the finetune stage, in
    the two dialects of nerf_hugs_tpu/train/step.py:97-154.
    nerfacto and nerf: the trainable set is config.finetune_params, a list
    of the model's param groups (FINETUNE_GROUPS): a group takes the
    parameters of the top-level module of its name, 'proposal' those of
    proposal_0..k-1, vanilla NeRF's 'field' those of coarse and fine, and
    a group that matches no parameter raises.
    mipnerf360: `'embedding' in path`, every nn.Embed leaf of the flax
    tree, i.e. the nn.Embedding tables GloEmbed_0 and TransientEmbed_0."""
    if config.model_type == "mipnerf360":
        return {name: ("trainable" if name.split(".")[0] in EMBED_MODULES
                       else "frozen") for name in names}
    groups = tuple(config.finetune_params or ())
    # Vanilla NeRF's group 'field' is the reference's self.field, which
    # holds both MLPs (nerf.py:228-231): the modules coarse and fine here.
    tops = lambda g: (("coarse", "fine")
                      if g == "field" and config.model_type == "nerf"
                      else (g,))
    matched = set()
    labels = {}
    for name in names:
        top = name.split(".")[0]
        hit = [g for g in groups
               if top in tops(g)
               or (g == "proposal" and top.startswith("proposal"))]
        matched.update(hit)
        labels[name] = "trainable" if hit else "frozen"
    missing = [g for g in groups if g not in matched]
    if missing:
        raise ValueError(
            f"finetune_params groups {missing} match no parameters of "
            f"model_type={config.model_type!r}; valid groups are "
            + " / ".join(FINETUNE_GROUPS) + " (reference get_params_dict "
            "keys)")
    return labels


def create_finetune_optimizer(config, model: torch.nn.Module):
    """Freeze every parameter outside the finetune groups (requires_grad
    off) and return (optimizer, scheduler): Adam over the trainable ones
    with the finetune_* betas, eps and schedule, its count from 0."""
    labels = finetune_partitions(config,
                                 [n for n, _ in model.named_parameters()])
    trainable: List[torch.nn.Parameter] = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "trainable")
        if p.requires_grad:
            trainable.append(p)
    lr_fn = functools.partial(
        nh_math.learning_rate_decay, lr_init=config.finetune_lr_init,
        lr_final=config.finetune_lr_final,
        max_steps=config.finetune_max_steps,
        lr_delay_steps=config.finetune_lr_delay_steps,
        lr_delay_mult=config.finetune_lr_delay_mult)
    return create_adam(trainable, lr_fn, config.finetune_adam_beta1,
                       config.finetune_adam_beta2, config.finetune_adam_eps)


def initial_inlier_thresholds(config, device) -> torch.Tensor:
    """RobustNeRF's carried thresholds before the first step: ones, one
    per ray level (config.num_ray_levels)."""
    return torch.ones(config.num_ray_levels, device=device)


def apply_gradients(optimizer, scheduler,
                    params: Dict[str, torch.nn.Parameter],
                    grads: Dict[str, Optional[torch.Tensor]]) -> None:
    """One Adam step on `grads` after nan_to_num. A parameter without a
    gradient (the proposal net on a step that does not update it) steps
    with a zero gradient, as optax does with the zero cotangent."""
    for k, p in params.items():
        g = grads.get(k)
        # The fused kernel reads a gradient in its parameter's (contiguous)
        # layout, whatever the gradient's own strides.
        p.grad = (torch.zeros_like(p) if g is None
                  else torch.nan_to_num(g).contiguous())
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


def weight_decay_loss(model, mults: Dict[str, float]) -> torch.Tensor:
    """The `weight` term of the JAX loss (step.py:223-229): sum of mult x
    the squared norm of the subtree that each key names, keys being
    summarize_tree's flax paths of depth 1-3 ('NerfMLP_0',
    'NerfMLP_0/Dense_0', 'NerfMLP_0/Dense_0/kernel'); the model maps its
    parameter names onto them (`flax_path`)."""
    paths = {name: model.flax_path(name) for name, _ in
             model.named_parameters()}
    params = dict(model.named_parameters())
    terms = []
    for key, mult in mults.items():
        parts = tuple(key.split("/"))
        hit = [n for n, path in paths.items() if path[:len(parts)] == parts]
        if not hit or len(parts) > 3:
            raise ValueError(f"weight_decay_mults key {key!r} names no "
                             "subtree of the parameters")
        terms.append(mult * sum(torch.sum(params[n] ** 2) for n in hit))
    return torch.stack(terms).sum()


def compute_loss(model, batch, train_frac: float, config,
                 rng: Optional[torch.Generator],
                 inlier_thresholds: Optional[torch.Tensor] = None,
                 is_finetune: bool = False):
    """Forward + loss composition of the JAX loss_fn (step.py:189-233):
    the transient type's data loss (the plain data loss in the finetune
    stage), then, outside the finetune stage, the interlevel and
    distortion terms. inlier_thresholds: RobustNeRF's carried state
    (initial_inlier_thresholds when None). Returns (loss, stats) with
    stats['losses'], stats['mses'] and the loss's own stats."""
    rays = batch.rays
    renderings, ray_history = model(
        rays, train_frac, compute_extras=False,
        rng=rng if config.randomized else None, zero_glo=False,
        zero_tra=False)
    transient_type = None if is_finetune else config.transient_type
    if transient_type in (None, "withmask"):
        losses, stats = zoo.compute_data_loss(batch, rays, renderings,
                                              config,
                                              transient_type == "withmask")
    elif transient_type == "robustnerf":
        if inlier_thresholds is None:
            inlier_thresholds = initial_inlier_thresholds(
                config, renderings[-1]["rgb"].device)
        losses, stats = zoo.compute_robustnerf_loss(
            batch, renderings, inlier_thresholds, config)
    elif transient_type == "nerfw":
        losses, stats = zoo.compute_nerfw_loss(batch, renderings,
                                               ray_history, config)
    elif transient_type == "hanerf":
        losses, stats = zoo.compute_hanerf_loss(batch, renderings,
                                                train_frac, config)
    else:
        raise ValueError(f"unknown transient_type {transient_type!r}")
    if not is_finetune:
        if config.interlevel_loss_mult > 0:
            losses["interlevel"] = zoo.interlevel_loss(ray_history, config)
        if config.distortion_loss_mult > 0:
            losses["distortion"] = zoo.distortion_loss(ray_history, config)
        if config.weight_decay_mults:
            losses["weight"] = weight_decay_loss(model,
                                                 config.weight_decay_mults)
    loss = sum(losses.values())
    stats["losses"] = losses
    return loss, stats


def train_step(model, optimizer, scheduler, batch, train_frac: float,
               config, rng: Optional[torch.Generator],
               inlier_thresholds: Optional[torch.Tensor] = None,
               is_finetune: bool = False) -> dict:
    """One optimization step over the parameters that take a gradient
    (all of them, or the finetune groups); returns detached stats (loss,
    losses, mses, psnrs, psnr, and RobustNeRF's robust_* with the next
    step's robust_inlier_threshold) as device tensors, without
    synchronising. Its spans (utils/trace.py): `step` around the whole,
    `step.forward` (the loss), `step.backward` and `step.update` (the
    gradients' mean over the ranks, clipping and Adam)."""
    with trace.span("step"):
        for p in model.parameters():
            p.grad = None
        with trace.span("step.forward"):
            loss, stats = compute_loss(model, batch, train_frac, config, rng,
                                       inlier_thresholds, is_finetune)
        with trace.span("step.backward"):
            loss.backward()
        with trace.span("step.update"):
            params = {k: p for k, p in model.named_parameters()
                      if p.requires_grad}
            grads = mean_gradients(params)
            grads = clip_gradients(grads, config)
            apply_gradients(optimizer, scheduler, params, grads)
        out = {k: v.detach() for k, v in stats.items()
               if k.startswith("robust_")}
        out.update({"loss": loss.detach(), "mses": stats["mses"].detach(),
                    "losses": {k: v.detach()
                               for k, v in stats["losses"].items()}})
        out = mean_stats(out)
        out["psnrs"] = mse_to_psnr(out["mses"])
        out["psnr"] = out["psnrs"][-1]
        return out


def mean_gradients(params: Dict[str, torch.nn.Parameter]
                   ) -> Dict[str, Optional[torch.Tensor]]:
    """The parameters' gradients, averaged over the ranks under a process
    group (a gradient that is None on a rank enters as zeros on every
    rank, so all ranks reduce the same leaves); one process: the .grad
    fields as they are."""
    if not mesh.is_distributed():
        return {k: p.grad for k, p in params.items()}
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params.values()]
    return dict(zip(params, mesh.mean_over_ranks(grads)))


def mean_stats(stats: dict) -> dict:
    """The step's stats as means over the ranks, in one all-reduce (the
    loss, mses and terms of JAX's global batch); RobustNeRF's next
    threshold is already the same on every rank and stays as it is."""
    keys = [k for k in stats if k != "losses"
            and k != "robust_inlier_threshold"]
    terms = list(stats["losses"])
    means = mesh.mean_over_ranks([stats[k] for k in keys]
                                 + [stats["losses"][k] for k in terms])
    out = dict(stats, **dict(zip(keys, means)))
    out["losses"] = dict(zip(terms, means[len(keys):]))
    return out
