"""Quality A/B of the port: one config through
`python -m nerf_hugs_torch.tools.validate_quality` under several variants,
each in a process of its own, their RESULT lines side by side.

    python -m nerf_hugs_torch.tools.quality_ab \\
        --config configs/nerfacto/kubric_nerfacto_base.yml --steps 1000 \\
        [--seeds 12345678 1 2] [--plain] [--plain-bf16] [--fp32] \\
        [--init W.pt ...] [--init-seeds S ...] [--device cuda|cpu] \\
        [--out JSON]

A variant is a seed (the yaml's base.seed replaced, which draws other
batches and sample jitter; the initial weights are JAX's whatever the
seed) or, at the config's own seed: --plain, the
hash-grid wrappers (ops/hashgrid.py::hashgrid_fwd,
ops/hashgrid_bwd.py::hashgrid_table_grad) routed to their plain PyTorch
versions on the card, so that a whole run through the kernels is held
against one through the plain path; --plain-bf16, the same with each
table-gradient payload rounded to bfloat16; --fp32, enable_amp off;
--init, the train driver starting from saved initial weights in place
of JAX's (models/jax_init.py, the default); --init-seeds, from torch's
draws at other seeds, with the config's batches. --init and --init-seeds
act on every backbone, a gin as well as a yaml.
The spread over the seeds says how far two runs of the same code land
apart.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import yaml

RESULT = re.compile(r"^RESULT config=\S+ steps=\d+ test_psnr=(\S+) "
                    r"test_ssim=(\S+) per_image_psnr=\[(.*)\]$", re.M)
TIMING = re.compile(r"^TIMING .*$", re.M)


def route_to_plain(bf16_payload: bool = False) -> None:
    """Send the hash-grid wrappers' CUDA calls to the plain versions; with
    `bf16_payload`, each table-gradient payload w * dL/dfeat is rounded to
    bfloat16 before it is summed, as the JAX package's table gradient does
    by default (HashGridSpec.bwd_dtype)."""
    import torch

    from nerf_hugs_torch.ops import hashgrid, hashgrid_bwd

    def fwd(table, positions, spec):
        with torch.no_grad():
            return hashgrid.hashgrid_encode_plain(table, positions, spec)

    def table_grad_bf16(positions, grad_out, spec):
        f = spec.features_per_level
        pos = positions.reshape(-1, spec.num_dims)
        g = grad_out.reshape(-1, spec.num_levels, f).float()
        constants = hashgrid.grid_constants(spec)
        out = torch.zeros(constants.num_rows, f, dtype=torch.float32,
                          device=positions.device)
        for lvl in range(spec.num_levels):
            rows, weights = hashgrid.corner_rows_level(spec, pos, lvl)
            vals = (weights[..., None] * g[None, :, lvl, :]).to(
                torch.bfloat16).float()
            out.index_add_(0, (rows + int(constants.level_offsets[lvl]))
                           .reshape(-1), vals.reshape(-1, f))
        return out.reshape(-1)

    hashgrid.hashgrid_fwd = fwd
    hashgrid_bwd.hashgrid_table_grad = (
        table_grad_bf16 if bf16_payload
        else hashgrid_bwd.hashgrid_table_grad_plain)


def start_from(init: str) -> None:
    """Make the train driver start its model, whatever the backbone, from
    the state_dict saved at the path `init` or, where `init` is an
    integer, from the initial weights torch's generator draws at that
    seed, in place of JAX's: every backbone's function that
    models/jax_init.py::init_model_ calls is replaced. The batches keep
    the config's seed."""
    import torch

    from nerf_hugs_torch.models import construct_model, jax_init

    def init_from(model, root=None):
        device = next(model.parameters()).device
        if init.isdigit():
            state = construct_model(model.config, device,
                                    torch.Generator().manual_seed(int(init))
                                    ).state_dict()
        else:
            state = torch.load(init, map_location=device, weights_only=True)
        model.load_state_dict(state)

    for name in jax_init.INITS.values():
        setattr(jax_init, name, init_from)


def child_main(argv: list) -> None:
    """`--child kernels|plain|plain_bf16|init=PT|init=SEED TOOL ARGS...`:
    one variant's run."""
    import runpy
    if argv[0].startswith("init="):
        start_from(argv[0][len("init="):])
    elif argv[0] != "kernels":
        route_to_plain(bf16_payload=argv[0] == "plain_bf16")
    sys.argv = ["validate_quality"] + argv[1:]
    runpy.run_module("nerf_hugs_torch.tools.validate_quality",
                     run_name="__main__", alter_sys=True)


def edited_config(config: str, tmp: str, name: str, **base) -> str:
    """A copy of the yaml with the base-section keys `base` replaced, under
    its own name (the RESULT line's tag) in tmp/name/."""
    with open(config) as f:
        raw = yaml.safe_load(f)
    raw["base"].update(base)
    out = os.path.join(tmp, name, os.path.basename(config))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        yaml.safe_dump(raw, f)
    return out


def run_variant(name: str, route: str, config: str, args, tmp: str) -> dict:
    argv = [sys.executable, "-m", "nerf_hugs_torch.tools.quality_ab",
            "--child", route, "--config", config, "--steps",
            str(args.steps), "--save-dir", os.path.join(tmp, name),
            "--device", args.device]
    out = subprocess.run(argv, capture_output=True, text=True)
    log = out.stdout + out.stderr
    m = RESULT.search(log)
    if out.returncode or m is None:
        raise RuntimeError(f"variant {name} exited with {out.returncode}:\n"
                           f"{log[-4000:]}")
    timing = TIMING.search(log)
    evals = re.findall(r"\[train\] (\d+): eval psnr=(\S+) ssim=(\S+)", log)
    reading = {"variant": name, "psnr": float(m.group(1)),
               "ssim": float(m.group(2)),
               "per_image_psnr": [float(x) for x in m.group(3).split(",")],
               "in_train_eval": [[int(s), float(p), float(q)]
                                 for s, p, q in evals],
               "timing": timing.group(0) if timing else None}
    print(f"AB variant={name} {m.group(0)}", flush=True)
    if timing:
        print(f"AB variant={name} {timing.group(0)}", flush=True)
    print(f"AB variant={name} in-train eval {reading['in_train_eval']}",
          flush=True)
    return reading


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        child_main(argv[1:])
        return []
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.tools.quality_ab",
        description="validate_quality runs of one config under seeds and "
                    "the plain hash-grid path.")
    parser.add_argument("--config", required=True,
                        help="a yaml or a gin (--seeds and --fp32 edit a "
                             "yaml)")
    parser.add_argument("--steps", type=int, required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--plain", action="store_true",
                        help="add a run through the plain hash-grid path")
    parser.add_argument("--plain-bf16", action="store_true",
                        help="add a run through the plain path with the "
                             "table gradient's payloads in bfloat16")
    parser.add_argument("--fp32", action="store_true",
                        help="add a run with enable_amp off (fp32 MLPs)")
    parser.add_argument("--init", nargs="*", default=[],
                        help="add a run from each of these initial weights "
                             "(torch state_dicts, e.g. the JAX package's "
                             "from tests/jax_initial_weights.py)")
    parser.add_argument("--init-seeds", type=int, nargs="*", default=[],
                        help="add a run from the initial weights torch's "
                             "generator draws at each of these seeds, the "
                             "batches and the rest at the config's seed")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--out", help="write the readings here as JSON")
    args = parser.parse_args(argv)
    readings = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in args.seeds:
            readings.append(run_variant(
                f"seed_{seed}", "kernels",
                edited_config(args.config, tmp, f"seed_{seed}", seed=seed),
                args, tmp))
        if args.plain:
            readings.append(run_variant("plain", "plain", args.config, args,
                                        tmp))
        if args.plain_bf16:
            readings.append(run_variant("plain_bf16", "plain_bf16",
                                        args.config, args, tmp))
        for path in args.init:
            readings.append(run_variant(
                "init_" + os.path.splitext(os.path.basename(path))[0],
                "init=" + os.path.abspath(path), args.config, args, tmp))
        for seed in args.init_seeds:
            readings.append(run_variant(f"init_seed_{seed}",
                                        f"init={seed}", args.config, args,
                                        tmp))
        if args.fp32:
            readings.append(run_variant(
                "fp32", "kernels", edited_config(
                    args.config, tmp, "fp32", enable_amp=False), args, tmp))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(readings, f, indent=1)
    return readings


if __name__ == "__main__":
    main()
