"""Convert a released NeRF-HuGS checkpoint into a directory of the port.

Twin of tools/convert_reference_checkpoint.py:

    python -m nerf_hugs_torch.tools.convert_reference_checkpoint \\
        --reference_checkpoint /path/to/checkpoint_250000 \\
        --gin_configs configs/mipnerf360/kubric_1024_withmask.gin \\
        --output_dir ./results/kubric_car [--device cuda|cpu]
    python -m nerf_hugs_torch.tools.convert_reference_checkpoint \\
        --reference_checkpoint /path/to/ckpt_25000.pth \\
        --config configs/nerfacto/kubric_nerfacto_base.yml \\
        --output_dir ./results/kubric_car [--step N]

Mip-NeRF 360: a flax msgpack TrainState (MipNeRF360/train.py:232-236),
read by utils/flax_msgpack.py. nerfacto and vanilla NeRF (model_type
nerfacto / nerf and a .pth, .pt or .ckpt file): a torch snapshot, read by
models/nerfacto_import.py and models/torch_compat.py. Either gives the
flax-shaped tree of JAX's model, which models/from_jax.py carries onto the
port's model built from the config on the device; missing, extra and
misshapen parameters are reported before anything is written. The
directory then holds checkpoint_{step}.pt with a fresh optimizer and
schedule, as the train driver builds them, and model_compat.json, so
`python -m nerf_hugs_torch.{eval,render}` (and train, resuming) read it.
Torch snapshots were trained under the reference's cumulative-delta
compositing (ray_utils.py:231): with --config the tool writes config.yml
with `model.legacy_cumulative_deltas: true` beside the checkpoint, to
pass to eval and render; with gin files it prints the key to set. It runs
on the card unless --device cpu is given; without a card that is an error.
"""

from __future__ import annotations

import argparse
import os

import torch

from nerf_hugs_torch.configs import gin_parser, yaml_loader
from nerf_hugs_torch.models import construct_model, from_jax
from nerf_hugs_torch.train import checkpoints
from nerf_hugs_torch.train import step as step_lib
from nerf_hugs_torch.utils.device import resolve_device

_TORCH_SUFFIXES = (".pth", ".pt", ".ckpt")
_CONVERTERS = {"nerfacto": from_jax.convert_nerfacto_params,
               "nerf": from_jax.convert_vanilla_params,
               "mipnerf360": from_jax.convert_mipnerf360_params}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.tools.convert_reference_checkpoint",
        description="Convert a released checkpoint into a directory that "
                    "the port's eval, render and train drivers read.")
    parser.add_argument("--reference_checkpoint", required=True,
                        help="the reference's checkpoint_N file or "
                             "directory, or a torch snapshot")
    parser.add_argument("--gin_configs", action="append", default=[])
    parser.add_argument("--gin_bindings", action="append", default=[])
    parser.add_argument("--config", default=None, help="yaml config path")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--step", type=int, default=None,
                        help="override the checkpoint's step number")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def read_reference(path: str, config):
    """(the flax-shaped variables, the step) of a released checkpoint."""
    if (config.model_type in ("nerfacto", "nerf")
            and path.endswith(_TORCH_SUFFIXES)):
        if config.model_type == "nerfacto":
            from nerf_hugs_torch.models import nerfacto_import
            return nerfacto_import.load_torch_nerfacto_checkpoint(path,
                                                                  config)
        from nerf_hugs_torch.models import torch_compat
        return torch_compat.load_torch_nerf_checkpoint(path, config)
    from nerf_hugs_torch.utils import flax_msgpack
    return flax_msgpack.extract_reference_params(path)


def check_state(state: dict, model: torch.nn.Module) -> None:
    """Raise, naming them, on parameters the converted tree lacks, adds or
    shapes differently from the model the config builds."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(
            "parameter mismatch: is the config the one this checkpoint was "
            f"trained with?\n  missing: {missing[:5]}\n  extra: {extra[:5]}")
    bad = [(k, want[k], got[k]) for k in want if want[k] != got[k]]
    if bad:
        raise ValueError(f"parameter shape mismatches: {bad[:5]}")


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.config:
        config = yaml_loader.load_yaml_config(args.config)
    else:
        config = gin_parser.parse_gin_configs(args.gin_configs,
                                              args.gin_bindings)
    # Released torch checkpoints are tcnn (xor-hash) by construction; an
    # additive-hash config has the same parameters, so a conversion would
    # succeed and render noise.
    if (config.model_type == "nerfacto"
            and config.nerfacto.hash_impl != "xor"):
        raise ValueError(
            "reference checkpoints require hash_impl: xor (tcnn semantics); "
            f"the config sets hash_impl={config.nerfacto.hash_impl!r}. Use "
            "the non-addhash twin.")
    if config.model_type not in _CONVERTERS:
        raise ValueError(f"unknown model_type {config.model_type!r}")

    variables, step = read_reference(args.reference_checkpoint, config)
    step = args.step if args.step is not None else step
    model = construct_model(config, device, torch.Generator().manual_seed(0))
    state = _CONVERTERS[config.model_type](variables)
    check_state(state, model)
    model.load_state_dict(state)
    optimizer, scheduler = step_lib.create_optimizer(config, model)
    checkpoints.save_checkpoint(args.output_dir, model, optimizer, scheduler,
                                step)
    checkpoints.record_model_compat(args.output_dir, config)
    print(f"converted step-{step} checkpoint -> "
          f"{checkpoints.checkpoint_path(args.output_dir, step)}")

    if (config.model_type in ("nerfacto", "nerf")
            and args.reference_checkpoint.endswith(_TORCH_SUFFIXES)):
        if args.config:
            import yaml
            with open(args.config) as f:
                raw = yaml.safe_load(f)
            raw.setdefault("model", {})["legacy_cumulative_deltas"] = True
            emitted = os.path.join(args.output_dir, "config.yml")
            with open(emitted, "w") as f:
                yaml.safe_dump(raw, f)
            print(f"wrote {emitted} with legacy_cumulative_deltas: true — "
                  "pass it as --config to eval and render for these weights")
        else:
            print("NOTE: render and evaluate these weights with the model "
                  "key `legacy_cumulative_deltas: true` (the reference's "
                  "cumulative-delta compositing)")


if __name__ == "__main__":
    main()
