"""Shared helpers for the nerf_hugs_torch parity tests (tests/test_torch_port_*).

Importing this module pins torch to 2 threads: Tier-1 runs under xdist
with 6 workers. Inputs are made with numpy from a seed and handed to both
packages as the same arrays.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import yaml

torch.set_num_threads(2)

# A nerfacto config at toy widths: 4 field levels of 2^10 rows, hidden
# width 16, 16 proposal and 8 field samples per ray.
TINY_BASE = {
    "dataset_type": "synthetic", "downsample_factor": 1,
    "model_type": "nerfacto", "batch_size": 64, "patch_size": 4,
    "num_img_per_batch": 2, "num_steps": 10000, "warmup_steps": 500,
    "near": 0.05, "far": 1.2, "bound": 1.5, "enable_amp": False,
    "randomized": False, "train_background_color": "random",
    "test_background_color": "gray", "render_chunk_size": 96,
    "synthetic_num_images": 4, "synthetic_height": 16,
    "synthetic_width": 16, "eval_images_num": 1, "print_every": 1,
}
TINY_MODEL = {
    "num_proposal_iterations": 1, "num_proposal_samples_per_ray": [16],
    "num_nerf_samples_per_ray": 8, "log2_hashmap_size": 10,
    "num_levels": 4, "base_res": 4, "max_res": 32, "hidden_dim": 16,
    "hidden_dim_color": 16, "geo_feat_dim": 15,
    "proposal_net_args_list": [
        {"base_res": 4, "hidden_dim": 16, "log2_hashmap_size": 10,
         "features_per_level": 2, "num_levels": 4, "max_res": 32}],
    "distortion_loss_mult": 0.002,
}


def write_tiny_yaml(directory: str, base=None, model=None) -> str:
    """The tiny config as a yaml file (with overrides); returns its path."""
    raw = {"base": {**TINY_BASE, **(base or {})},
           "model": {**TINY_MODEL, **(model or {})}}
    path = os.path.join(directory, "tiny_nerfacto.yml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def tiny_config(base=None, model=None):
    from nerf_hugs_tpu.configs import yaml_loader
    with tempfile.TemporaryDirectory() as d:
        return yaml_loader.load_yaml_config(write_tiny_yaml(d, base, model))


def ray_arrays(n: int, seed: int) -> dict:
    """Numpy ray fields for n rays starting near the origin."""
    rs = np.random.RandomState(seed)
    dirs = rs.randn(n, 3).astype(np.float32)
    viewdirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    ones = np.ones((n, 1), np.float32)
    return {
        "pix_coords": rs.rand(n, 2).astype(np.float32),
        "origins": rs.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
        "directions": dirs, "viewdirs": viewdirs,
        "radii": 0.01 * ones, "lossmult": ones, "static_mask": ones,
        "near": 0.05 * ones, "far": 1.2 * ones,
        "embed_idx": np.zeros((n, 1), np.int32),
        "cam_idx": np.zeros((n, 1), np.int32),
    }


def flat_params(tree, prefix=()) -> dict:
    """Nested dict of arrays -> {'a/b/c': numpy array}."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat_params(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def unflatten(flat: dict) -> dict:
    out = {}
    for path, v in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out
