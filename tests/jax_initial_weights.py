"""The JAX package's initial nerfacto weights, drawn by JAX, as a
state_dict of the port (models/from_jax.py): the reference that
models/jax_init.py is held to (tests/test_torch_port_quality.py), and the
files of the quality A/B's `--init` runs under other keys.

    JAX_PLATFORMS=cpu python tests/jax_initial_weights.py CONFIG.yml OUT.pt \\
        [--key K]

train.py draws the initial weights from PRNGKey(20200823), whatever
config.seed says: the key is folded with the host index (0) and split, and
setup_model initializes the model from the first half (train.py:105-127).
`--key` replaces 20200823.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TRAIN_PY_KEY = 20200823


def initial_state_dict(config_path: str, key: int = TRAIN_PY_KEY) -> dict:
    """{port parameter name: tensor} of train.py's initial weights."""
    import jax

    import torch_port_util as tu
    from nerf_hugs_tpu import models
    from nerf_hugs_tpu.configs import yaml_loader
    from nerf_hugs_tpu.utils import structs
    from nerf_hugs_torch.models.from_jax import convert_nerfacto_params
    config = yaml_loader.load_yaml_config(config_path)
    rng = jax.random.fold_in(jax.random.PRNGKey(key), 0)
    init_key, _ = jax.random.split(rng)
    _, variables = models.construct_model(init_key, structs.dummy_rays(),
                                          config)
    params = tu.unflatten(tu.flat_params(jax.device_get(variables["params"])))
    return convert_nerfacto_params(params)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config")
    parser.add_argument("out")
    parser.add_argument("--key", type=int, default=TRAIN_PY_KEY)
    args = parser.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.save(initial_state_dict(args.config, args.key), args.out)


if __name__ == "__main__":
    main()
