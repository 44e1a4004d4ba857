"""Import the reference's released vanilla-NeRF checkpoints.

Twin of nerf_hugs_tpu/models/torch_compat.py. The reference's torch MLP
(nerfacto/models/nerf.py:632-860) and the PointMLP of models/vanilla.py
share the architecture; convert_nerf_model_state_dict maps a released
state dict onto the flax-shaped numpy tree of JAX's VanillaNerfModel,
which from_jax.convert_vanilla_params carries onto the port's model.
Dense kernels are the Linear weights transposed. PointMLP names its
layers in call order:
  Dense_0..{D-1}        trunk (torch mlp_base.* Sequential Linears, in order)
  Dense_{D}             density head (torch mlp_density)
  Dense_{D+1}           bottleneck (torch mlp_bottleneck)
  Dense_{D+2}..         viewdir branch (torch mlp_head.*)
  Dense_{..}            rgb head (torch mlp_rgb)
  [transient branch     torch mlp_transient.* + density/rgb/uncertainty]
"""

from __future__ import annotations

import pickle
import warnings
from typing import Any, Dict

import numpy as np
import torch

from nerf_hugs_torch.configs.config import MLPConfig


def _dense(weight, bias) -> Dict[str, np.ndarray]:
    return {"kernel": np.asarray(weight).T, "bias": np.asarray(bias)}


def _sequential_linears(sd: Dict[str, Any], prefix: str):
    """(weight, bias) of every Linear inside an nn.ModuleList of
    Sequentials, in definition order (keys like 'prefix.0.0.weight')."""
    keys = sorted(
        (k for k in sd if k.startswith(prefix) and k.endswith(".weight")),
        key=lambda k: tuple(int(t) for t in k.split(".") if t.isdigit()))
    for k in keys:
        yield sd[k], sd[k.replace(".weight", ".bias")]


def convert_point_mlp(sd: Dict[str, Any], net_depth: int,
                      net_depth_viewdirs: int = 1,
                      transient: bool = False,
                      prefix: str = "") -> Dict[str, Any]:
    """A torch vanilla-NeRF MLP state dict (keys under `prefix`) -> the
    PointMLP's Dense_k tree."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    layers = [_dense(w, b) for w, b in _sequential_linears(sd, "mlp_base.")]
    if len(layers) != net_depth:
        raise ValueError(f"expected {net_depth} trunk Linears, found "
                         f"{len(layers)}")
    head = [_dense(w, b) for w, b in _sequential_linears(sd, "mlp_head.")]
    if len(head) != net_depth_viewdirs:
        raise ValueError(
            f"expected {net_depth_viewdirs} viewdir Linears, got {len(head)}")
    single = lambda name: _dense(sd[f"{name}.weight"], sd[f"{name}.bias"])
    layers += [single("mlp_density"), single("mlp_bottleneck")] + head
    layers.append(single("mlp_rgb"))
    if transient:
        layers += [_dense(w, b)
                   for w, b in _sequential_linears(sd, "mlp_transient.")]
        layers += [single(name) for name in (
            "mlp_density_transient", "mlp_rgb_transient", "mlp_uncertainty")]
    return {f"Dense_{i}": layer for i, layer in enumerate(layers)}


def convert_nerf_model_state_dict(sd: Dict[str, Any], config
                                  ) -> Dict[str, Any]:
    """A released vanilla-NeRF model state dict (nerf.py:119-260:
    field.coarse / field.fine MLPs, the appearance and transient
    embeddings, HA-NeRF's ImplicitMask) -> {'params': ...} in the flax
    layout of JAX's VanillaNerfModel."""
    nc = config.nerfacto
    # vanilla.py builds its MLPConfig with the default viewdir depth.
    params: Dict[str, Any] = {
        name: convert_point_mlp(
            sd, nc.net_depth, MLPConfig().net_depth_viewdirs,
            transient=(config.transient_type == "nerfw" and name == "fine"),
            prefix=f"field.{name}.")
        for name in ("coarse", "fine")}
    for ours, theirs in (("appearance_embedding", "embedding_appearance"),
                         ("transient_embedding", "embedding_transient")):
        if f"{theirs}.weight" in sd:
            params[ours] = {"embedding": np.asarray(
                sd[f"{theirs}.weight"]).astype(np.float32)}
    if "implicit_mask.mlp_base.0.weight" in sd:
        # Sequential [lin, relu] * depth + [lin, sigmoid]: Linears at 2j.
        mask, j = {}, 0
        while f"implicit_mask.mlp_base.{2 * j}.weight" in sd:
            mask[f"Dense_{j}"] = _dense(
                sd[f"implicit_mask.mlp_base.{2 * j}.weight"],
                sd[f"implicit_mask.mlp_base.{2 * j}.bias"])
            j += 1
        params["implicit_mask"] = mask
    return {"params": params}


def torch_load_checkpoint(path: str):
    """torch.load with weights_only=True first (released snapshots are
    tensor state dicts and ints); only if that loader rejects the file,
    a warning and full unpickling. A file that cannot be read raises."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as e:
        # torch raises either for a disallowed global, by version; OSError
        # propagates, where the unsafe retry would fail the same way.
        warnings.warn(
            f"weights_only load of {path} failed ({type(e).__name__}: {e}); "
            "falling back to weights_only=False, which executes pickled "
            "code — only do this for checkpoints you trust.")
        return torch.load(path, map_location="cpu", weights_only=False)


def snapshot_step(ckpt) -> int:
    """The step a released snapshot records in ckpt['state'], else 0."""
    if isinstance(ckpt, dict) and "state" in ckpt:
        return int(ckpt["state"].get("global_step",
                                     ckpt["state"].get("step", 0)))
    return 0


def load_torch_nerf_checkpoint(path: str, config):
    """A released vanilla-NeRF snapshot .pth -> (flax-shaped variables,
    its step)."""
    ckpt = torch_load_checkpoint(path)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    sd = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    return convert_nerf_model_state_dict(sd, config), snapshot_step(ckpt)
