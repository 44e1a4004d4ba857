"""Model registry: one constructor per backbone, one call contract.

Every model is an nn.Module with
  forward(rays, train_frac, compute_extras, rng, zero_glo, zero_tra)
    -> (renderings: list[dict], ray_history: list[dict])
(nerf_hugs_tpu/models/__init__.py), so the train step, the loss zoo and
the chunked renderer do not depend on the backbone.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch


class Backbone(NamedTuple):
    """What the drivers need of a backbone: its model class, the
    transient-type checks it runs first, and the top-level module names
    it builds for a config (the finetune and clipping groups)."""
    model: type
    check_transient_config: Callable[..., None]
    module_names: Callable[..., List[str]]


def backbone(config) -> Backbone:
    """The backbone that config.model_type names; the one place that maps
    model types to modules."""
    if config.model_type == "mipnerf360":
        from nerf_hugs_torch.models import mipnerf360 as module
        model = module.MipNerf360Model
    elif config.model_type == "nerfacto":
        from nerf_hugs_torch.models import nerfacto as module
        model = module.NerfactoModel
    elif config.model_type == "nerf":
        from nerf_hugs_torch.models import vanilla as module
        model = module.VanillaNerfModel
    else:
        raise ValueError(f"unknown model_type {config.model_type!r}")
    return Backbone(model, module.check_transient_config, module.module_names)


def construct_model(config, device, generator: torch.Generator):
    """The config's backbone, its parameters drawn from `generator`."""
    return backbone(config).model(config, device, generator)
