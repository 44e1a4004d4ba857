"""Loader for the reference's nerfacto YAML configs into the unified Config:
the port's copy of nerf_hugs_tpu/configs/yaml_loader.py.

The nerfacto/configs/*.yml files have base:/model: sections
(nerfacto/utils/config_utils.py:69-91). base-section names that differ from
the MipNeRF360 gin names are translated here; model-section fields land in
Config.nerfacto (for model_type nerfacto/nerf).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import yaml

from nerf_hugs_torch.configs.config import Config

# nerfacto base-section name -> unified Config field.
_BASE_RENAMES = {
    "dataset_type": "dataset_loader",
    "downsample_factor": "factor",
    "num_img_per_batch": "image_num_per_batch",
    "num_steps": "max_steps",
    "warmup_steps": "lr_delay_steps",
    "save_weight_every": "checkpoint_every",
    "eval_render_every": "train_render_every",
    "finetune_num_steps": "finetune_max_steps",
    "finetune_num_img_per_batch": "finetune_image_num_per_batch",
    "finetune_warmup_steps": "finetune_lr_delay_steps",
}

# model-section fields that live at the top level of the unified config.
_MODEL_TO_TOP = {
    "rgb_loss_type": "data_loss_type",
    "rgb_loss_mult": "data_loss_mult",
    "fine_rgb_loss_mult": "data_loss_mult",
    "coarse_rgb_loss_mult": "data_coarse_loss_mult",
    "transient_type": "transient_type",
    "distortion_loss_mult": "distortion_loss_mult",
    "interlevel_loss_mult": "interlevel_loss_mult",
    "robustnerf_inlier_quantile": "robustnerf_inlier_quantile",
    "withmask_transient_weight": "withmask_transient_weight",
    "nerfw_beta_loss_mult": "nerfw_beta_loss_mult",
    "nerfw_beta_loss_bias": "nerfw_beta_loss_bias",
    "nerfw_density_loss_mult": "nerfw_density_loss_mult",
    "hanerf_mask_size_loss_mult_min": "hanerf_mask_size_loss_mult_min",
    "hanerf_mask_size_loss_mult_max": "hanerf_mask_size_loss_mult_max",
    "hanerf_mask_size_loss_mult_k": "hanerf_mask_size_loss_mult_k",
}


def _set_known(obj: Any, name: str, value: Any) -> bool:
    if hasattr(obj, name):
        current = getattr(obj, name)
        if isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
        setattr(obj, name, value)
        return True
    return False


def load_yaml_config(path: str, config: Optional[Config] = None) -> Config:
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    config = config if config is not None else Config()
    # nerfacto defaults differ from the gin stack's.
    config.data_loss_type = "mse"
    config.transient_type = None

    base: Dict[str, Any] = raw.get("base", {}) or {}
    model: Dict[str, Any] = raw.get("model", {}) or {}

    for key, value in base.items():
        if key == "opt_betas":
            config.adam_beta1, config.adam_beta2 = value
            continue
        if key == "opt_eps":
            config.adam_eps = float(value)
            continue
        if key == "finetune_opt_betas":
            config.finetune_adam_beta1, config.finetune_adam_beta2 = value
            continue
        if key == "finetune_opt_eps":
            config.finetune_adam_eps = float(value)
            continue
        if key == "finetune_lr_init":
            config.finetune_lr_init = float(value)
            continue
        if key == "finetune_lr_final":
            config.finetune_lr_final = float(value)
            continue
        name = _BASE_RENAMES.get(key, key)
        if not _set_known(config, name, value):
            raise ValueError(f"unknown nerfacto base config field {key!r}")

    for key, value in model.items():
        if key in _MODEL_TO_TOP:
            _set_known(config, _MODEL_TO_TOP[key], value)
            continue
        if key == "proposal_net_args_list":
            config.nerfacto.proposal_net_args_list = tuple(value)
            continue
        if not _set_known(config.nerfacto, key, value):
            raise ValueError(f"unknown nerfacto model config field {key!r}")

    # The gin stack's grad clipping doesn't apply to the nerfacto stack.
    config.grad_max_norm = 0.0
    config.grad_max_val = 0.0
    config.__post_init__()
    if config.nerfacto.enable_tcnn_mlp:
        # The fused MLP's backward recomputes the forward in plain matmuls
        # (ops/fused_mlp.py), so its train steps are slower than the Dense
        # stack's (PERF.md); it is meant for eval and render.
        print("warning: enable_tcnn_mlp=True — the fused MLP wins "
              "forward-only (eval/render); for training the Dense stack is "
              "faster.")
    return config

