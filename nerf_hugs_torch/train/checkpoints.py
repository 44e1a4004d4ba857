"""Step-numbered checkpoints with torch.save, and the model-compat sidecar.

Twin of nerf_hugs_tpu/train/checkpoints.py: {dir}/checkpoint_{step}.pt
holds the step and the state of the model, the Adam optimizer and its
learning-rate schedule; the newest step is restored on resume, and eval
restores the model alone from the newest checkpoint, preferring the
finetune stage's {dir}/finetune/.
model_compat.json records the model-function choices (hash_impl) that a
restore cannot detect from the parameter shapes.
Under a process group rank 0 alone writes the sidecar and the checkpoints
and prunes them (checkpoints.py:38, 83-97 of the JAX package), every rank
waits at a barrier after each write, and rank 0 picks the step that every
rank restores (agreed_latest_step), so no rank reads a directory that
another sees in another state.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional, Tuple

import torch

from nerf_hugs_torch.parallel import mesh

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
    if fields is None:
        return
    path = os.path.join(directory, _COMPAT_FILE)
    if mesh.process_index() == 0 and not os.path.exists(path):
        os.makedirs(directory, exist_ok=True)
        # Atomic, as the checkpoints: another rank's check_model_compat
        # may read the file while rank 0 writes it.
        with open(path + ".tmp", "w") as f:
            json.dump(fields, f)
        os.replace(path + ".tmp", path)
    mesh.barrier()


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


def agreed_latest_step(directory: str) -> Optional[int]:
    """Rank 0's latest_step(directory), on every rank."""
    step = latest_step(directory) if mesh.process_index() == 0 else None
    (step,) = mesh.broadcast_ints([-1 if step is None else step])
    return None if step < 0 else step


def save_checkpoint(directory: str, model: torch.nn.Module, optimizer,
                    scheduler, step: int, keep: int = 100) -> None:
    """Write checkpoint_{step}.pt atomically and drop the oldest beyond
    `keep` (rank 0; every rank returns after the write)."""
    if mesh.process_index() == 0:
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
    mesh.barrier()


def restore_checkpoint(directory: str, model: torch.nn.Module, optimizer,
                       scheduler, step: Optional[int] = None) -> int:
    """Load the newest (or the given) checkpoint into model, optimizer and
    scheduler; returns its step, or 0 when there is none."""
    if step is None:
        step = agreed_latest_step(directory)
    if step is None:
        return 0
    device = next(model.parameters()).device
    state = torch.load(checkpoint_path(directory, step), map_location=device,
                       weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    return int(state["step"])


def restore_params(directory: str, model: torch.nn.Module,
                   step: Optional[int] = None) -> Optional[int]:
    """Load only the model of the newest (or the given) checkpoint, as the
    eval path needs (no optimizer state); returns its step, or None when
    there is none."""
    if step is None:
        step = agreed_latest_step(directory)
    if step is None:
        return None
    device = next(model.parameters()).device
    state = torch.load(checkpoint_path(directory, step), map_location=device,
                       weights_only=True)
    model.load_state_dict(state["model"])
    return int(state["step"])


def pick_eval_checkpoint(directory: str) -> Tuple[bool, Optional[int]]:
    """(use_finetune, step) of the checkpoint eval restores: the newest
    finetune checkpoint when {directory}/finetune/ has one, else the newest
    train checkpoint (step None when there is none); rank 0 picks, and
    every rank gets its pick (eval.py:95-113 broadcasts it the same way).
    """
    ft_dir = os.path.join(directory, "finetune")
    use_ft, step = 0, -1
    if mesh.process_index() == 0:
        use_ft = int(latest_step(ft_dir) is not None)
        step = latest_step(ft_dir if use_ft else directory)
        step = -1 if step is None else step
    use_ft, step = mesh.broadcast_ints([use_ft, step])
    return bool(use_ft), None if step < 0 else step
