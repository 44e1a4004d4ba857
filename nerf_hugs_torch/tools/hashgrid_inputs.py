"""The hash-grid kernels' inputs at kubric_nerfacto_base, for the smoke run
and the hash-grid benchmark: the grids' specs, the main path's sample
shapes, the config on the procedural scene, and the positions and output
gradients the full-width model hands its encoders in one step, captured
with hooks.
"""

from __future__ import annotations

import os

BATCH = 16384              # rays per step of kubric_nerfacto_base
FIELD_N = BATCH * 128      # batch x field samples per ray
PROPOSAL_N = BATCH * 256   # batch x proposal samples per ray
# The hash grids of kubric_nerfacto_base (timed) and kubric_nerfacto_tpu
# (checked only): (name, HashGridSpec keywords, main-path samples or None).
GRIDS = (
    ("field", dict(num_levels=16, log2_hashmap_size=21, base_res=16,
                   max_res=8192), FIELD_N),
    ("proposal", dict(num_levels=7, log2_hashmap_size=17, base_res=16,
                      max_res=2048), PROPOSAL_N),
    ("tpu field", dict(num_levels=12, log2_hashmap_size=19, base_res=16,
                       max_res=4096), None),
    ("tpu proposal", dict(num_levels=5, log2_hashmap_size=17, base_res=16,
                          max_res=512), None),
)
# configs/nerfacto/kubric_nerfacto_base.yml of the checkout holding the
# package.
BASE_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "configs", "nerfacto", "kubric_nerfacto_base.yml")


def fused_overlay(model: dict) -> dict:
    """The model section with enable_tcnn_mlp on for the field and for
    every proposal_net_args_list entry."""
    return {**model, "enable_tcnn_mlp": True, "proposal_net_args_list": [
        {**a, "enable_tcnn_mlp": True}
        for a in model["proposal_net_args_list"]]}


def base_yaml(tmp: str, fused: bool, steps: int = 8) -> str:
    """BASE_CONFIG on the procedural scene, exiting after `steps` steps
    (Dense MLPs, or fused for the field and the proposal); returns the path
    of the yaml written into `tmp`."""
    import yaml
    with open(BASE_CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["base"].update({
        "dataset_type": "synthetic", "early_exit_steps": steps,
        "print_every": 1, "synthetic_num_images": 32,
        "synthetic_height": 512, "synthetic_width": 512,
        # Shrinks the procedural world so the sphere lies inside the
        # config's near/far (0.1/2) and bound (1).
        "synthetic_world_scale": 0.5,
        # Read by the eval phase only: 2 test images.
        "eval_dataset_limit": 2})
    tag = "fused" if fused else "dense"
    if fused:
        raw["model"] = fused_overlay(raw["model"])
    cfg_path = os.path.join(tmp, f"kubric_nerfacto_base_synthetic_{tag}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    return cfg_path


def capture_hashgrid_inputs(cfg_path: str, tmp: str, device) -> dict:
    """One batch of compute_loss + backward through the model of `cfg_path`
    on `device` (the train loop's first step: train_frac 0, its sampling
    generator), with hooks on the field's and the proposal's
    HashGridEncoding; returns {"field"|"proposal": (spec, grid positions,
    output gradient)} as those modules received them."""
    import torch
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.models.nerfacto import NerfactoModel
    from nerf_hugs_torch.train import driver
    from nerf_hugs_torch.train.step import compute_loss
    config = driver.load_config(cfg_path, tmp, os.path.join(tmp, "capture"))
    batch = next(load_dataset("train", tmp, config, is_training=True))
    model = NerfactoModel(config, device,
                          torch.Generator().manual_seed(config.seed))
    captured = {}

    def hook(name):
        def forward_hook(module, inputs, output):
            entry = captured[name] = [module.spec, inputs[0].detach().clone()]
            if output.requires_grad:
                output.register_hook(
                    lambda grad: entry.append(grad.detach().clone()))
        return forward_hook

    handles = [model.field.hashgrid.register_forward_hook(hook("field")),
               model.proposal_0.hashgrid.register_forward_hook(
                   hook("proposal"))]
    rng = torch.Generator(device=device).manual_seed(config.seed + 1)
    try:
        loss, _ = compute_loss(model, batch.to(device), 0.0, config, rng)
        loss.backward()
    finally:
        for h in handles:
            h.remove()
    if sorted(captured) != ["field", "proposal"] \
            or any(len(v) != 3 for v in captured.values()):
        raise RuntimeError("the hooks did not capture both encoders' inputs "
                           "and gradients")
    return {k: tuple(v) for k, v in captured.items()}


def capture_shares(spec, p, g) -> str:
    """The shares of out-of-box samples (collapsed to the origin) and of
    zero-gradient (sample, level) pairs in a captured input."""
    n = p.numel() // spec.num_dims
    out_of_box = float((p.reshape(n, -1) == 0).all(-1).float().mean())
    zero = float((g.reshape(n, spec.num_levels, -1) == 0).all(-1)
                 .float().mean())
    return (f"{out_of_box:.4f} of the samples out of the box (at the "
            f"origin), {zero:.4f} of the (sample, level) pairs with a zero "
            "gradient")
