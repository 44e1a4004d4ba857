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
