"""The JAX package's initial nerfacto, vanilla NeRF and Mip-NeRF 360
weights, drawn without JAX.

train.py initializes every run from PRNGKey(20200823), whatever the
config's seed (train.py:105-127): the key is folded with the host index 0
and split, and flax's `init` derives each parameter's key from the first
half by folding in the SHA-1 of the parameter's module path and its
creation counter in that module (flax/core/scope.py: LazyRng,
_fold_in_static). This module reproduces those draws: threefry-2x32 with
jax_threefry_partitionable's counters, jax.random.uniform's mantissa
construction and its fused scale-and-shift, and the initializers the JAX
models use: uniform(-1e-4, 1e-4) hash tables, he_uniform Dense kernels
and fused-MLP weights, zero biases, and nn.Embed's variance-scaled normal
(through torch.erfinv, within 1e-5 of XLA's polynomial).

The nerfacto quality of a run depends on its initial weights far more
than a 1 dB margin allows (PERF.md §2: on an NVIDIA H100, 3000 steps of
kubric_nerfacto_tpu from torch's draws at four seeds land at 21.8-33.6 dB
held-out PSNR, from JAX's at four keys at 33.2-35.1), so the train
driver starts nerfacto from these draws, and a run is the JAX run's twin
up to the sample jitter, the backgrounds and the arithmetic. The batches
are the same numpy draws in both packages. Mip-NeRF 360 starts from them
too: whether NeRF-W's transient branch absorbs the scene can hang on the
draw as well (the distractor gins' held-out runs, PERF.md §2); vanilla
NeRF starts from them as the JAX run does. init_model_ picks the
backbone's function; the quality tool's legacy mode hands it JAX's
PRNGKey(0), the key JAX's tool gives setup_model.
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

TRAIN_PY_KEY = 20200823
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the uint32 counter pairs (x0, x1),
    held in int64 tensors."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in of a uint32."""
    zero = torch.zeros(1, dtype=torch.int64)
    a, b = _threefry2x32(key, zero, zero + (data & _MASK))
    return int(a), int(b)


def split(key: Key, num: int = 2) -> list:
    """jax.random.split under jax_threefry_partitionable."""
    counts = torch.arange(num, dtype=torch.int64)
    a, b = _threefry2x32(key, torch.zeros_like(counts), counts)
    return [(int(x), int(y)) for x, y in zip(a, b)]


def _random_bits(key: Key, n: int, device) -> torch.Tensor:
    counts = torch.arange(n, dtype=torch.int64, device=device)
    a, b = _threefry2x32(key, counts >> 32, counts & _MASK)
    return a ^ b


def uniform(key: Key, shape: Sequence[int], minval: float, maxval: float,
            device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval): 23 random
    mantissa bits in [1, 2), less 1, scaled and shifted in one rounding
    (XLA fuses the multiply-add)."""
    n = math.prod(shape)
    bits = (_random_bits(key, n, device) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    width = float(np.float32(np.float32(maxval) - np.float32(minval)))
    out = (floats.double() * width + lo).float()
    return torch.clamp(out, min=lo).reshape(tuple(shape))


def he_uniform(key: Key, shape: Tuple[int, int], device="cpu"
               ) -> torch.Tensor:
    """jax.nn.initializers.he_uniform() of an [in, out] kernel."""
    variance = np.float32(2.0 / shape[0])
    scale = float(np.sqrt(np.float32(3) * variance, dtype=np.float32))
    return uniform(key, shape, -1.0, 1.0, device) * scale


def embed_normal(key: Key, shape: Tuple[int, int], device="cpu"
                 ) -> torch.Tensor:
    """flax nn.Embed's default init, variance_scaling(1, fan_in, normal,
    out_axis=0): sqrt(2) * erfinv(uniform(-1, 1)) / sqrt(dim)."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = uniform(key, shape, lo, 1.0, device)
    stddev = float(np.sqrt(np.float32(1.0 / shape[1]), dtype=np.float32))
    return (torch.erfinv(u) * float(np.float32(np.sqrt(2)))) * stddev


def param_key(root: Key, path: Sequence[Union[str, int]]) -> Key:
    """The key flax's init gives the parameter created `path[-1]`-th (from
    1) in the module at `path[:-1]`: the root folded with the SHA-1 of the
    path."""
    sha = hashlib.sha1()
    for x in path:
        sha.update(x.encode("utf-8") if isinstance(x, str)
                   else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(sha.digest()[:4], "big"))


def train_py_root(key: int = TRAIN_PY_KEY) -> Key:
    """The key train.py hands setup_model on host 0."""
    return split(fold_in((0, key), 0))[0]


@torch.no_grad()
def init_nerfacto_(model: torch.nn.Module, root: Key = None) -> None:
    """Overwrite a NerfactoModel's parameters with the JAX model's initial
    values under `root` (train.py's by default), parameter by parameter
    along the flax paths that models/from_jax.py maps."""
    root = train_py_root() if root is None else root
    for name, p in model.named_parameters():
        parts = name.split(".")
        dev = p.device
        if parts[-1] == "table":
            # {top}.hashgrid.table: one table_{l} per level, created in
            # level order.
            module = model.get_submodule(".".join(parts[:-1]))
            f = module.spec.features_per_level
            levels = [uniform(param_key(root, parts[:-1] + [lvl + 1]),
                              (int(size) * f,), -1e-4, 1e-4, dev)
                      for lvl, size in enumerate(module.spec.level_sizes)]
            p.copy_(torch.cat(levels))
        elif parts[-1] == "weight" and parts[-2].endswith("_embedding"):
            p.copy_(embed_normal(param_key(root, parts[:-1] + [1]),
                                 tuple(p.shape), dev))
        elif parts[-3] == "layers":
            # {..}.{mlp}.layers.k.{weight,bias}: flax Dense_k's kernel
            # [in, out] (created first), transposed, and its zero bias.
            path = parts[:-3] + [f"Dense_{parts[-2]}", 1]
            if parts[-1] == "bias":
                p.zero_()
            else:
                p.copy_(he_uniform(param_key(root, path),
                                   (p.shape[1], p.shape[0]), dev).T)
        elif parts[-1].startswith("w_"):
            # The fused MLP's w_i [in, out], the (i+1)-th in its module.
            i = int(parts[-1][2:])
            p.copy_(he_uniform(param_key(root, parts[:-1] + [i + 1]),
                               tuple(p.shape), dev))
        else:
            raise ValueError(f"no JAX initializer for {name}")


@torch.no_grad()
def _init_dense_modules_(model: torch.nn.Module, root: Key) -> None:
    """Overwrite the parameters of a model whose flax modules each hold
    Dense_k layers or one embedding table (model.flax_path maps the
    names): every Dense_k is a module of its own whose kernel is created
    first, so a kernel's key is its module path with counter 1, as is a
    table's."""
    for name, p in model.named_parameters():
        path = list(model.flax_path(name))
        key = param_key(root, path[:-1] + [1])
        if path[-1] == "embedding":
            p.copy_(embed_normal(key, tuple(p.shape), p.device))
        elif path[-1] == "bias":
            p.zero_()
        elif path[-1] == "kernel":
            # he_uniform of the [in, out] kernel, transposed.
            p.copy_(he_uniform(key, (p.shape[1], p.shape[0]), p.device).T)
        else:
            raise ValueError(f"no JAX initializer for {name}")


def init_mipnerf360_(model: torch.nn.Module, root: Key = None) -> None:
    """Overwrite a MipNerf360Model's parameters with the JAX model's
    initial values under `root` (train.py's by default). Every flax module
    of that model sits at the top (NerfMLP_0, PropMLP_0, ImplicitMask_0,
    GloEmbed_0, TransientEmbed_0; nerf_hugs_tpu/models/mipnerf360.py:
    60-79), and nn.remat keeps the paths; the proposal levels call one
    PropMLP_0, so its loop adds no parameters."""
    _init_dense_modules_(model, train_py_root() if root is None else root)


def init_vanilla_(model: torch.nn.Module, root: Key = None) -> None:
    """Overwrite a VanillaNerfModel's parameters with the JAX model's
    initial values under `root` (train.py's by default). Its flax modules
    sit at the top (coarse, fine, appearance_embedding,
    transient_embedding, implicit_mask; nerf_hugs_tpu/models/vanilla.py:
    117-134): each PointMLP is called once, its Dense_k in call order with
    the skips' and NeRF-W's transient head's widths, and init touches both
    tables even where the run zeroes them (vanilla.py:137-142)."""
    _init_dense_modules_(model, train_py_root() if root is None else root)


# config.model_type -> the name of its backbone's function in this module.
INITS = {"nerfacto": "init_nerfacto_", "nerf": "init_vanilla_",
         "mipnerf360": "init_mipnerf360_"}


def init_model_(model: torch.nn.Module, config, root: Key = None) -> None:
    """The JAX model's initial values for the backbone config.model_type
    names, under `root` (train.py's by default; JAX's PRNGKey(0) is
    (0, 0)). Each backbone's function is looked up by its name in INITS
    when it is called, so a caller may replace it (tools/quality_ab.py)."""
    if config.model_type not in INITS:
        raise ValueError(f"no JAX initializer for model_type "
                         f"{config.model_type!r}")
    init = globals()[INITS[config.model_type]]
    if root is None:
        init(model)
    else:
        init(model, root)
