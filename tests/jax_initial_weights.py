"""The JAX package's initial weights, drawn by JAX, as a state_dict of
the port (models/from_jax.py): the reference that models/jax_init.py is
held to (tests/test_torch_port_quality.py,
tests/test_torch_port_vanilla_init.py), and the files of the quality
A/B's `--init` runs under other keys, for every backbone.

    JAX_PLATFORMS=cpu python tests/jax_initial_weights.py CONFIG OUT.pt \\
        [--key K] [--binding 'Gin.binding = v' ...]

CONFIG is a yaml or a gin. train.py draws the initial weights from
PRNGKey(20200823), whatever config.seed says: the key is folded with the
host index (0) and split, and setup_model initializes the model from the
first half (train.py:105-127). `--key` replaces 20200823.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TRAIN_PY_KEY = 20200823


def to_port(model_type: str, params) -> dict:
    """{port parameter name: tensor} of a JAX model's flax params,
    converted by model_type."""
    import jax

    import torch_port_util as tu
    from nerf_hugs_torch.models import from_jax
    convert = {"nerfacto": from_jax.convert_nerfacto_params,
               "nerf": from_jax.convert_vanilla_params,
               "mipnerf360": from_jax.convert_mipnerf360_params}[model_type]
    return convert(tu.unflatten(tu.flat_params(jax.device_get(params))))


def initial_state_dict(config_path: str, key: int = TRAIN_PY_KEY,
                       bindings=()) -> dict:
    """{port parameter name: tensor} of train.py's initial weights for a
    yaml or a gin (with `bindings`)."""
    import jax

    from nerf_hugs_tpu import models
    from nerf_hugs_tpu.configs import gin_parser, yaml_loader
    from nerf_hugs_tpu.utils import structs
    if config_path.endswith(".gin"):
        config = gin_parser.parse_gin_configs([config_path], list(bindings))
    else:
        config = yaml_loader.load_yaml_config(config_path)
    rng = jax.random.fold_in(jax.random.PRNGKey(key), 0)
    init_key, _ = jax.random.split(rng)
    _, variables = models.construct_model(init_key, structs.dummy_rays(),
                                          config)
    return to_port(config.model_type, variables["params"])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("config")
    parser.add_argument("out")
    parser.add_argument("--key", type=int, default=TRAIN_PY_KEY)
    parser.add_argument("--binding", action="append", default=[],
                        help="a gin binding (repeatable)")
    args = parser.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.save(initial_state_dict(args.config, args.key, args.binding),
               args.out)


if __name__ == "__main__":
    main()
