"""Torch snapshots in the layout of the reference's released checkpoints,
made from a seeded numpy generator at the shapes of a port model, for
checking the import of models/nerfacto_import.py and
models/torch_compat.py where no released checkpoint is at hand; and the
flax TrainState tree of a released Mip-NeRF 360 checkpoint, which
utils/flax_msgpack.py::msgpack_serialize writes as the reference's
checkpoint_N file.

Values: tcnn grids in fp16 from U(-1e-4, 1e-4) (tcnn's initialisation),
Linear weights (flax Dense kernels) from N(0, 1 / fan_in), biases and
embeddings from N(0, 0.1). Each snapshot is {'model': state dict of CPU
tensors, 'state': {'global_step': step}}, as the reference's
save_snapshot writes it (nerfacto/utils/checkpoint_utils.py:27-47).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from nerf_hugs_torch.configs.config import MLPConfig

_EMBEDDINGS = {"appearance_embedding.weight": "embedding_appearance.weight",
               "transient_embedding.weight": "embedding_transient.weight"}
# (module, MLP) of the port's nerfacto model -> (the released Sequential,
# the index of its first Linear); proposal_i is filled in below.
_NERFACTO_MLPS = {("field", "mlp_base"): ("field.mlp_base", 1),
                  ("field", "mlp_head"): ("field.mlp_head", 0),
                  ("field", "mlp_transient"): ("field.mlp_transient", 0),
                  ("implicit_mask", "mlp"): ("implicit_mask.mlp_base", 0)}
_NERFACTO_GRIDS = {"field": "field.mlp_base.0.params",
                   "implicit_mask": "implicit_mask.grid_encoder.params"}
_LAYER_RE = re.compile(r"^(\w+)\.(\w+)\.layers\.(\d+)\.(weight|bias)$")
_DENSE_RE = re.compile(r"^(\w+)\.Dense_(\d+)\.(weight|bias)$")


def _values(rng: np.random.Generator, name: str, shape) -> np.ndarray:
    if name.endswith(".params"):
        return rng.uniform(-1e-4, 1e-4, shape).astype(np.float16)
    if name.endswith(".weight") and len(shape) == 2 and \
            not name.startswith("embedding_"):
        return rng.normal(0.0, shape[1] ** -0.5, shape).astype(np.float32)
    return rng.normal(0.0, 0.1, shape).astype(np.float32)


def _snapshot(shapes: Dict[str, tuple], seed: int, step: int,
              buffers: Dict[str, int] = None) -> dict:
    rng = np.random.default_rng(seed)
    sd = {name: torch.from_numpy(_values(rng, name, shape))
          for name, shape in shapes.items()}
    sd.update({k: torch.tensor(v) for k, v in (buffers or {}).items()})
    return {"model": sd, "state": {"global_step": step}}


def nerfacto_snapshot(model: torch.nn.Module, config, seed: int,
                      step: int) -> dict:
    """A released-layout snapshot of the port's NerfactoModel `model`
    (Dense MLPs, enable_tcnn_mlp false, as every shipped config)."""
    shapes = {}
    for name, tensor in model.state_dict().items():
        shape = tuple(tensor.shape)
        top = name.split(".")[0]
        if name.endswith(".hashgrid.table"):
            shapes[_NERFACTO_GRIDS.get(
                top, f"proposal_networks.{top[len('proposal_'):]}"
                     ".mlp_base.0.params")] = shape
        elif name in _EMBEDDINGS:
            shapes[_EMBEDDINGS[name]] = shape
        elif (m := _LAYER_RE.match(name)):
            module, mlp, k, leaf = m.groups()
            prefix, first = _NERFACTO_MLPS.get((module, mlp), (
                f"proposal_networks.{module[len('proposal_'):]}.mlp_base", 1))
            shapes[f"{prefix}.{first + 2 * int(k)}.{leaf}"] = shape
        else:
            raise ValueError(f"no released key for {name}")
    nc = config.nerfacto
    buffers = {"field.base_res": nc.base_res, "field.max_res": nc.max_res,
               "field.num_levels": nc.num_levels,
               "field.log2_hashmap_size": nc.log2_hashmap_size}
    return _snapshot(shapes, seed, step, buffers)


def vanilla_snapshot(model: torch.nn.Module, config, seed: int,
                     step: int) -> dict:
    """A released-layout snapshot of the port's VanillaNerfModel `model`:
    field.{coarse,fine} in the call order of torch_compat's docstring (the
    trunk as Sequentials of four Linears in a ModuleList), the embeddings
    and HA-NeRF's mask."""
    depth = config.nerfacto.net_depth
    viewdirs = MLPConfig().net_depth_viewdirs
    layers: Dict[str, list] = {}
    shapes = {}
    for name, tensor in model.state_dict().items():
        if name in _EMBEDDINGS:
            shapes[_EMBEDDINGS[name]] = tuple(tensor.shape)
            continue
        m = _DENSE_RE.match(name)
        if m is None:
            raise ValueError(f"no released key for {name}")
        layers.setdefault(m.group(1), []).append(
            (int(m.group(2)), m.group(3), tuple(tensor.shape)))
    for module, leaves in layers.items():
        count = max(k for k, _, _ in leaves) + 1
        if module == "implicit_mask":
            names = [f"implicit_mask.mlp_base.{2 * j}" for j in range(count)]
        else:
            names = [f"mlp_base.{k // 4}.{2 * (k % 4)}" for k in range(depth)]
            names += ["mlp_density", "mlp_bottleneck"]
            names += [f"mlp_head.0.{2 * j}" for j in range(viewdirs)]
            names.append("mlp_rgb")
            transient = count - len(names) - 3
            if transient > 0:
                names += [f"mlp_transient.0.{2 * j}" for j in range(transient)]
                names += ["mlp_density_transient", "mlp_rgb_transient",
                          "mlp_uncertainty"]
            names = [f"field.{module}.{n}" for n in names]
        if len(names) != count:
            raise ValueError(f"{module} has {count} layers, the released "
                             f"layout {len(names)}")
        for k, leaf, shape in leaves:
            shapes[f"{names[k]}.{leaf}"] = shape
    return _snapshot(shapes, seed, step)


def mipnerf360_train_state(model: torch.nn.Module, seed: int,
                           step: int) -> dict:
    """A released-layout TrainState of the port's MipNerf360Model `model`:
    {'params': {'params': flax tree}, 'step': step, 'opt_state': {}}, the
    tree models/from_jax.py::convert_mipnerf360_params reads (a Dense
    kernel [in, out], the transpose of the Linear weight; an embedding
    table as it is)."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, dict] = {}
    for name, tensor in model.state_dict().items():
        shape = tuple(tensor.shape)
        if (m := _DENSE_RE.match(name)):
            module, k, leaf = m.groups()
            values = _values(rng, name, shape)
            tree.setdefault(module, {}).setdefault(f"Dense_{k}", {})[
                "kernel" if leaf == "weight" else "bias"] = (
                values.T.copy() if leaf == "weight" else values)
        elif name.count(".") == 1 and name.endswith(".weight"):
            tree[name.split(".")[0]] = {"embedding": rng.normal(
                0.0, 0.1, shape).astype(np.float32)}
        else:
            raise ValueError(f"no flax leaf for {name}")
    return {"params": {"params": tree}, "step": step, "opt_state": {}}
