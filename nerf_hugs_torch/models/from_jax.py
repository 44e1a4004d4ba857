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
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

_TABLE_RE = re.compile(r"^table_(\d+)$")
_DENSE_RE = re.compile(r"^Dense_(\d+)$")


def convert_nerfacto_params(flax_params: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """flax params (nested dicts of numpy arrays, with or without the top
    'params' key) -> a state_dict for nerf_hugs_torch NerfactoModel."""
    params = flax_params.get("params", flax_params)
    state: Dict[str, torch.Tensor] = {}
    as_tensor = lambda a: torch.from_numpy(np.array(a, np.float32))
    for top, modules in params.items():
        for name, leaf in modules.items():
            if name == "hashgrid":
                levels = sorted((int(_TABLE_RE.match(k).group(1)), v)
                                for k, v in leaf.items())
                if [lvl for lvl, _ in levels] != list(range(len(levels))):
                    raise ValueError(f"{top}/hashgrid tables are not "
                                     "table_0..table_{L-1}")
                state[f"{top}.hashgrid.table"] = as_tensor(np.concatenate(
                    [np.asarray(v).reshape(-1) for _, v in levels]))
                continue
            for dense, p in leaf.items():
                m = _DENSE_RE.match(dense)
                if m is None or set(p) != {"kernel", "bias"}:
                    raise ValueError(f"unexpected flax module {top}/{name}/"
                                     f"{dense}")
                prefix = f"{top}.{name}.layers.{int(m.group(1))}"
                state[f"{prefix}.weight"] = as_tensor(np.asarray(p["kernel"]).T)
                state[f"{prefix}.bias"] = as_tensor(p["bias"])
    return state
