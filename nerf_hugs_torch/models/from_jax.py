"""Carry flax nerfacto parameters across to the PyTorch model.

Maps the flax tree of nerf_hugs_tpu's NerfactoModel onto
NerfactoModel.state_dict() of this package:
  {field,proposal_i}/hashgrid/table_{l}  -> {..}.hashgrid.table, the
                                            per-level tables concatenated
                                            in level order (tcnn layout)
  {..}/{mlp}/Dense_k/kernel [in, out]    -> {..}.{mlp}.layers.k.weight
                                            [out, in] (the transpose, as
                                            nerf_hugs_tpu/models/
                                            torch_compat.py::_dense)
  {..}/{mlp}/Dense_k/bias                -> {..}.{mlp}.layers.k.bias
  {..}/{mlp}/w_i [in, out]               -> {..}.{mlp}.w_i, as it is (the
                                            bias-free fused MLP keeps the
                                            flax layout); {mlp} is mlp_base,
                                            mlp_head or NeRF-W's
                                            mlp_transient
  {appearance,transient}_embedding/embedding [num, dim]
                                         -> {..}_embedding.weight, as it is
  implicit_mask/{hashgrid,mlp}/...       -> implicit_mask.{hashgrid,mlp}...,
                                            as the field's modules
A module holds Dense_k layers or w_i weights, never both; any other leaf
is refused.

convert_mipnerf360_params maps the flax tree of nerf_hugs_tpu's
MipNerf360Model onto MipNerf360Model.state_dict() of this package:
  {NerfMLP_0,PropMLP_0,ImplicitMask_0}/Dense_k/kernel [in, out]
                                         -> {..}.Dense_k.weight [out, in]
  {..}/Dense_k/bias                      -> {..}.Dense_k.bias
  {GloEmbed_0,TransientEmbed_0}/embedding [num, dim]
                                         -> {..}.weight, as it is

convert_vanilla_params maps the flax tree of nerf_hugs_tpu's
VanillaNerfModel onto VanillaNerfModel.state_dict() of this package by the
same two rules: {coarse,fine,implicit_mask}/Dense_k -> {..}.Dense_k and
{appearance,transient}_embedding/embedding -> {..}.weight.

sam_state_dict maps the flax tree of nerf_hugs_tpu's SAM
(hugs/sam/modeling.py) onto segment-anything's state-dict keys, which the
port's Sam uses (block_i -> blocks.i, layer_i -> layers.i, hyper_mlp_i ->
output_hypernetworks_mlps.i, lin_j -> layers.j, mlp_lin1 -> mlp.lin1,
neck_conv1/ln1/conv2/ln2 -> neck.0-3, upscale_conv1/ln/conv2 ->
output_upscaling.0/1/3, iou_head -> iou_prediction_head), one rule per
leaf kind:
  Dense kernel [in, out]                 -> weight [out, in], transposed
  Conv kernel HWIO                       -> weight OIHW
  ConvTranspose kernel HWIO              -> weight IOHW, flipped in both
                                            spatial axes (flax's
                                            ConvTranspose does not flip
                                            its kernel, torch's does)
  LayerNorm scale                        -> weight
  bias, LayerNorm2d weight, pos_embed, rel_pos_*, the Fourier matrix
                                         -> as they are
  point_embed_i, not_a_point_embed, no_mask_embed, iou_token,
  mask_tokens [n, C]                     -> the embedding's weight
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

_TABLE_RE = re.compile(r"^table_(\d+)$")
_DENSE_RE = re.compile(r"^Dense_(\d+)$")
_FUSED_RE = re.compile(r"^w_(\d+)$")
_EMBEDDINGS = ("appearance_embedding", "transient_embedding")


def convert_nerfacto_params(flax_params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """flax params (nested dicts of numpy arrays, with or without the top
    'params' key) -> a state_dict for nerf_hugs_torch NerfactoModel."""
    params = flax_params.get("params", flax_params)
    state: Dict[str, torch.Tensor] = {}
    as_tensor = lambda a: torch.from_numpy(np.array(a, np.float32))
    for top, modules in params.items():
        if top in _EMBEDDINGS:
            if set(modules) != {"embedding"}:
                raise ValueError(f"unexpected flax leaves {top}/"
                                 f"{sorted(modules)}")
            state[f"{top}.weight"] = as_tensor(modules["embedding"])
            continue
        if not hasattr(modules, "items"):
            raise ValueError(f"unexpected flax leaf {top}")
        for name, leaf in modules.items():
            if not hasattr(leaf, "items"):
                raise ValueError(f"unexpected flax leaf {top}/{name}")
            if name == "hashgrid":
                if not all(_TABLE_RE.match(k) for k in leaf):
                    raise ValueError(f"unexpected flax leaves {top}/hashgrid/"
                                     f"{sorted(leaf)}")
                levels = sorted((int(_TABLE_RE.match(k).group(1)), v)
                                for k, v in leaf.items())
                if [lvl for lvl, _ in levels] != list(range(len(levels))):
                    raise ValueError(f"{top}/hashgrid tables are not "
                                     "table_0..table_{L-1}")
                state[f"{top}.hashgrid.table"] = as_tensor(np.concatenate(
                    [np.asarray(v).reshape(-1) for _, v in levels]))
                continue
            if any(_FUSED_RE.match(k) for k in leaf):
                if not all(_FUSED_RE.match(k) for k in leaf):
                    raise ValueError(f"flax module {top}/{name} mixes fused "
                                     f"w_i weights with {sorted(leaf)}")
                for k, w in leaf.items():
                    state[f"{top}.{name}.{k}"] = as_tensor(w)
                continue
            for dense, p in leaf.items():
                m = _DENSE_RE.match(dense)
                if m is None or not hasattr(p, "items") \
                        or set(p) != {"kernel", "bias"}:
                    raise ValueError(f"unexpected flax module {top}/{name}/"
                                     f"{dense}")
                prefix = f"{top}.{name}.layers.{int(m.group(1))}"
                state[f"{prefix}.weight"] = as_tensor(np.asarray(p["kernel"]).T)
                state[f"{prefix}.bias"] = as_tensor(p["bias"])
    return state


_MIPNERF360_MLPS = ("NerfMLP_0", "PropMLP_0", "ImplicitMask_0")
_MIPNERF360_EMBEDS = ("GloEmbed_0", "TransientEmbed_0")
_VANILLA_MLPS = ("coarse", "fine", "implicit_mask")


def _convert_dense_modules(flax_params: Dict[str, Any], mlps, embeds
                           ) -> Dict[str, torch.Tensor]:
    """A flax tree of top-level modules that each hold Dense_k layers
    (`mlps`) or one embedding table (`embeds`) -> {top}.Dense_k.weight
    (the kernel transposed), {top}.Dense_k.bias and {top}.weight."""
    params = flax_params.get("params", flax_params)
    state: Dict[str, torch.Tensor] = {}
    as_tensor = lambda a: torch.from_numpy(np.array(a, np.float32))
    for top, leaves in params.items():
        if top in embeds and set(leaves) == {"embedding"}:
            state[f"{top}.weight"] = as_tensor(leaves["embedding"])
            continue
        if top not in mlps:
            raise ValueError(f"unexpected flax module {top}")
        for dense, p in leaves.items():
            if (_DENSE_RE.match(dense) is None or not hasattr(p, "items")
                    or set(p) != {"kernel", "bias"}):
                raise ValueError(f"unexpected flax module {top}/{dense}")
            state[f"{top}.{dense}.weight"] = as_tensor(
                np.asarray(p["kernel"]).T)
            state[f"{top}.{dense}.bias"] = as_tensor(p["bias"])
    return state


def convert_mipnerf360_params(flax_params: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """flax params (nested dicts of numpy arrays, with or without the top
    'params' key) -> a state_dict for nerf_hugs_torch MipNerf360Model."""
    return _convert_dense_modules(flax_params, _MIPNERF360_MLPS,
                                  _MIPNERF360_EMBEDS)


def convert_vanilla_params(flax_params: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """flax params (nested dicts of numpy arrays, with or without the top
    'params' key) -> a state_dict for nerf_hugs_torch VanillaNerfModel."""
    return _convert_dense_modules(flax_params, _VANILLA_MLPS, _EMBEDDINGS)


_SAM_SEGMENTS = (
    (re.compile(r"^block_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^layer_(\d+)$"), r"layers.\1"),
    (re.compile(r"^hyper_mlp_(\d+)$"), r"output_hypernetworks_mlps.\1"),
    (re.compile(r"^lin_(\d+)$"), r"layers.\1"),
    (re.compile(r"^point_embed_(\d+)$"), r"point_embeddings.\1"),
)
_SAM_NAMES = {
    "mlp_lin1": "mlp.lin1", "mlp_lin2": "mlp.lin2",
    "patch_embed": "patch_embed.proj",
    "neck_conv1": "neck.0", "neck_ln1": "neck.1", "neck_conv2": "neck.2",
    "neck_ln2": "neck.3", "upscale_conv1": "output_upscaling.0",
    "upscale_ln": "output_upscaling.1", "upscale_conv2": "output_upscaling.3",
    "iou_head": "iou_prediction_head",
}
_SAM_CONV_T = ("upscale_conv1", "upscale_conv2")
_SAM_EMBEDS = re.compile(
    r"^(point_embed_\d+|not_a_point_embed|no_mask_embed|iou_token|"
    r"mask_tokens)$")
_SAM_AS_IS = ("pos_embed", "rel_pos_h", "rel_pos_w",
              "positional_encoding_gaussian_matrix")


def _sam_segment(name: str) -> str:
    for pattern, repl in _SAM_SEGMENTS:
        if pattern.match(name):
            return pattern.sub(repl, name)
    return _SAM_NAMES.get(name, name)


def sam_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax SAM variables (nested dicts of numpy arrays, with or without
    the top 'params' key) -> a state_dict for nerf_hugs_torch's Sam, which
    then computes what the flax model computes."""
    params = variables.get("params", variables)
    state: Dict[str, torch.Tensor] = {}

    def visit(path, tree):
        for name, leaf in tree.items():
            if hasattr(leaf, "items"):
                visit(path + (name,), leaf)
                continue
            a = np.asarray(leaf, np.float32)
            module = ".".join(_sam_segment(p) for p in path)
            owner = path[-1] if path else ""
            if _SAM_EMBEDS.match(name):
                key = f"{module}.{_sam_segment(name)}.weight"
            elif name in _SAM_AS_IS:
                key = f"{module}.{name}"
            elif name == "kernel" and a.ndim == 2:
                key, a = f"{module}.weight", a.T
            elif name == "kernel" and a.ndim == 4 and owner in _SAM_CONV_T:
                key, a = f"{module}.weight", a.transpose(2, 3, 0, 1)[
                    :, :, ::-1, ::-1]
            elif name == "kernel" and a.ndim == 4:
                key, a = f"{module}.weight", a.transpose(3, 2, 0, 1)
            elif name in ("bias", "weight", "scale"):
                key = f"{module}.{'bias' if name == 'bias' else 'weight'}"
            else:
                raise ValueError(
                    f"unexpected flax SAM leaf {'/'.join(path + (name,))}")
            state[key] = torch.from_numpy(np.array(a))

    visit((), params)
    return state
