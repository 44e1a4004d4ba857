"""Import the reference's released nerfacto checkpoints.

Twin of nerf_hugs_tpu/models/nerfacto_import.py. The released nerfacto
checkpoints (torch `save_snapshot`, nerfacto/utils/checkpoint_utils.py:
27-47) store `ckpt['model']` state dicts of models built with
`enable_tcnn_mlp: false` (every shipped config sets it): tcnn grid
encoders and plain torch Linears,

  field.mlp_base.0.params                 tcnn HashGrid flat params
  field.mlp_base.{1+2j}.{weight,bias}     base MLP Linears
  field.mlp_head.{2j}.{weight,bias}       color MLP Linears
  field.mlp_transient.{2j}.{weight,bias}  transient MLP Linears (nerfw)
  proposal_networks.{i}.mlp_base.0.params + .{1+2j}.{weight,bias}
  embedding_appearance.weight / embedding_transient.weight
  implicit_mask.grid_encoder.params + implicit_mask.mlp_base.{2j}.*
  field.{base_res,max_res,num_levels,log2_hashmap_size}  int buffers

convert_nerfacto_state_dict makes of them the flax-shaped numpy tree of
JAX's NerfactoModel (per-level tables, Dense kernels [in, out]), which
from_jax.convert_nerfacto_params carries onto the port's model, as it
does for trees from JAX: one converter serves every path. The port's hash
grid is tcnn-exact (ops/hashgrid.py): the same per-level compact table
sizes, so the tcnn flat vector slices into the tables.

Released checkpoints were trained under the reference's cumulative-delta
compositing (ray_utils.py:231): render them with the model key
`legacy_cumulative_deltas: true`, which tools/convert_reference_checkpoint
writes into the config.yml it emits.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from nerf_hugs_torch.ops.hashgrid import HashGridSpec

# torch buffers the conversion reads nothing from.
_IGNORED_SUFFIXES = (".base_res", ".max_res", ".num_levels",
                     ".log2_hashmap_size")


def split_tcnn_grid_params(flat, spec: HashGridSpec) -> Dict[str, np.ndarray]:
    """tcnn Encoding flat params -> {table_l: [T_l * F] float32}.

    tcnn lays the grid out level-major, row-major [T_l, F] within a level,
    with T_l the compact padded sizes of spec.level_sizes: each table is a
    slice of the flat vector (a view), cast to float32 on its own, so the
    fp16 vector of a full-width grid is never copied whole."""
    flat = np.asarray(flat).reshape(-1)
    sizes = spec.level_sizes * spec.features_per_level
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    if flat.shape[0] != offsets[-1]:
        raise ValueError(
            f"tcnn grid params have {flat.shape[0]} values; spec "
            f"{tuple(spec.level_sizes)} x F={spec.features_per_level} "
            f"wants {offsets[-1]}")
    return {f"table_{l}": flat[offsets[l]:offsets[l + 1]].astype(np.float32)
            for l in range(spec.num_levels)}


def _dense(sd, prefix, consumed):
    consumed.update((f"{prefix}.weight", f"{prefix}.bias"))
    return {"kernel": np.asarray(sd[f"{prefix}.weight"]).astype(np.float32).T,
            "bias": np.asarray(sd[f"{prefix}.bias"]).astype(np.float32)}


def _relu_mlp(sd, prefix, num_layers, first_index, consumed):
    """Sequential Linears at indices first_index + 2j -> Dense_j."""
    return {f"Dense_{j}": _dense(sd, f"{prefix}.{first_index + 2 * j}",
                                 consumed)
            for j in range(num_layers)}


def _field_spec(nc) -> HashGridSpec:
    return HashGridSpec(
        num_levels=nc.num_levels, features_per_level=nc.features_per_level,
        log2_hashmap_size=nc.log2_hashmap_size, base_res=nc.base_res,
        max_res=nc.max_res)


def _proposal_spec(args: Dict[str, Any]) -> HashGridSpec:
    return HashGridSpec(
        num_levels=args.get("num_levels", 8),
        features_per_level=args.get("features_per_level", 2),
        log2_hashmap_size=args.get("log2_hashmap_size", 18),
        base_res=args.get("base_res", 16),
        max_res=args.get("max_res", 1024))


_MASK_SPEC = HashGridSpec(num_levels=16, features_per_level=2,
                          log2_hashmap_size=19, base_res=16, max_res=2048,
                          num_dims=2)


def _embedding(sd, key) -> Dict[str, np.ndarray]:
    return {"embedding": np.asarray(sd[key]).astype(np.float32)}


def convert_nerfacto_state_dict(sd: Dict[str, Any], config) -> Dict[str, Any]:
    """torch `ckpt['model']` (numpy leaves) -> {'params': ...} in the flax
    layout of JAX's NerfactoModel.

    Refuses tcnn-MLP checkpoints (`field.mlp_base.params` as one fused
    blob: no shipped config trains that way) and Linear keys the shipped
    layer counts leave behind."""
    if "field.mlp_base.params" in sd:
        raise ValueError(
            "checkpoint was trained with enable_tcnn_mlp=true (fused tcnn "
            "MLP blob); only the shipped enable_tcnn_mlp=false layout is "
            "convertible")
    nc = config.nerfacto
    params: Dict[str, Any] = {}
    consumed: set = set()

    field: Dict[str, Any] = {
        "hashgrid": split_tcnn_grid_params(
            sd["field.mlp_base.0.params"], _field_spec(nc)),
        # mlp_base = [grid_encoder, lin, relu, lin] (nerfacto.py:761-790):
        # Linears at 1 + 2j.
        "mlp_base": _relu_mlp(sd, "field.mlp_base", 2, 1, consumed),
        "mlp_head": _relu_mlp(sd, "field.mlp_head", 3, 0, consumed),
    }
    if "field.mlp_transient.0.weight" in sd:
        field["mlp_transient"] = _relu_mlp(sd, "field.mlp_transient", 3, 0,
                                           consumed)
    params["field"] = field

    i = 0
    while f"proposal_networks.{i}.mlp_base.0.params" in sd:
        args = nc.proposal_net_args_list[min(
            i, len(nc.proposal_net_args_list) - 1)]
        params[f"proposal_{i}"] = {
            "hashgrid": split_tcnn_grid_params(
                sd[f"proposal_networks.{i}.mlp_base.0.params"],
                _proposal_spec(dict(args))),
            "mlp_base": _relu_mlp(sd, f"proposal_networks.{i}.mlp_base",
                                  2, 1, consumed),
        }
        i += 1

    if "embedding_appearance.weight" in sd:
        params["appearance_embedding"] = _embedding(
            sd, "embedding_appearance.weight")
    if "embedding_transient.weight" in sd:
        params["transient_embedding"] = _embedding(
            sd, "embedding_transient.weight")
    if "implicit_mask.grid_encoder.params" in sd:
        params["implicit_mask"] = {
            "hashgrid": split_tcnn_grid_params(
                sd["implicit_mask.grid_encoder.params"], _MASK_SPEC),
            # No encoder in the mask's Sequential (nerfacto.py:1040-1070):
            # Linears at 2j.
            "mlp": _relu_mlp(sd, "implicit_mask.mlp_base", 3, 0, consumed),
        }

    # The layer counts above are the shipped configs': a checkpoint with
    # other counts would leave Linear keys behind and convert in part.
    leftover = [k for k in sd
                if (".weight" in k or ".bias" in k)
                and k.startswith(("field.mlp_", "proposal_networks.",
                                  "implicit_mask.mlp_"))
                and k not in consumed]
    if leftover:
        raise ValueError(
            "unconsumed MLP keys after conversion (checkpoint layer counts "
            f"differ from the shipped configs): {sorted(leftover)[:8]}"
            + ("..." if len(leftover) > 8 else ""))
    return {"params": params}


def load_torch_nerfacto_checkpoint(path: str, config):
    """A released snapshot .pth -> (flax-shaped variables, its step)."""
    from nerf_hugs_torch.models.torch_compat import (snapshot_step,
                                                     torch_load_checkpoint)
    ckpt = torch_load_checkpoint(path)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    sd = {k: (v.numpy() if hasattr(v, "numpy") else v)
          for k, v in sd.items() if not k.endswith(_IGNORED_SUFFIXES)}
    return convert_nerfacto_state_dict(sd, config), snapshot_step(ckpt)
