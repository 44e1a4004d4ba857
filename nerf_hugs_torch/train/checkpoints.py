"""Step-numbered checkpoints with torch.save, and the model-compat sidecar.

Twin of nerf_hugs_tpu/train/checkpoints.py: {dir}/checkpoint_{step}.pt
holds the step and the state of the model, the Adam optimizer and its
learning-rate schedule; the newest step is restored on resume.
model_compat.json records the model-function choices (hash_impl) that a
restore cannot detect from the parameter shapes.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

_STEP_RE = re.compile(r"^checkpoint_(\d+)\.pt$")
_COMPAT_FILE = "model_compat.json"


def _compat_fields(config) -> Optional[dict]:
    """`hash_impl` changes the hashed-level rows but not the parameter
    shapes, so a checkpoint restores cleanly across the switch and renders
    noise. Recorded for the field and for every proposal-net entry (the JAX
    sidecar records only the top-level value); None for model types with no
    such field."""
    if getattr(config, "model_type", None) != "nerfacto":
        return None
    nc = config.nerfacto
    return {"hash_impl": nc.hash_impl,
            "proposal_hash_impls": [dict(a).get("hash_impl", nc.hash_impl)
                                    for a in nc.proposal_net_args_list]}


def record_model_compat(directory: str, config) -> None:
    """Write the compat sidecar next to the checkpoints, once."""
    fields = _compat_fields(config)
    path = os.path.join(directory, _COMPAT_FILE)
    if fields is None or os.path.exists(path):
        return
    os.makedirs(directory, exist_ok=True)
    with open(path, "w") as f:
        json.dump(fields, f)


def check_model_compat(directory: str, config) -> None:
    """Raise if `config` is model-function-incompatible with the
    checkpoints under `directory` (no-op without a sidecar)."""
    fields = _compat_fields(config)
    path = os.path.join(directory, _COMPAT_FILE)
    if fields is None or not os.path.exists(path):
        return
    with open(path) as f:
        saved = json.load(f)
    for key, want in fields.items():
        have = saved.get(key, "xor" if key == "hash_impl" else want)
        if have != want:
            raise ValueError(
                f"checkpoints under {directory} were trained with "
                f"{key}={have!r} but the config sets {key}={want!r}; "
                f"checkpoints do not transfer between hash_impl modes")


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"checkpoint_{step}.pt")


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def save_checkpoint(directory: str, model: torch.nn.Module, optimizer,
                    scheduler, step: int, keep: int = 100) -> None:
    """Write checkpoint_{step}.pt atomically and drop the oldest beyond
    `keep`."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, step)
    tmp = path + ".tmp"
    torch.save({"step": step, "model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict()}, tmp)
    os.replace(tmp, path)
    steps = sorted(int(m.group(1)) for name in os.listdir(directory)
                   if (m := _STEP_RE.match(name)))
    for old in steps[:-keep]:
        os.remove(checkpoint_path(directory, old))


def restore_checkpoint(directory: str, model: torch.nn.Module, optimizer,
                       scheduler, step: Optional[int] = None) -> int:
    """Load the newest (or the given) checkpoint into model, optimizer and
    scheduler; returns its step, or 0 when there is none."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        return 0
    device = next(model.parameters()).device
    state = torch.load(checkpoint_path(directory, step), map_location=device,
                       weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    return int(state["step"])
