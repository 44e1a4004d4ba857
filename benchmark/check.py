"""Whether the timed path trained correctly: the program's first steps
against the plain reference's, from the same initial parameters, rays and
generator seed.

The reference recasts every ray of the checked batches from the scene's
files (the data layer is judged by its rays, pixel fields and colours),
then trains its own model on its own rays for as many steps. Compared:

    data_gap         largest absolute gap of a ray field (RAY_FIELDS),
                     a pixel field (PIXEL_FIELDS: the pixel's normalised
                     centre, the image's embedding index, the static
                     mask), a colour, or a loss weight from 1
    loss_gap         largest relative gap of a step's loss
    grad_norm_gap    worst leaf: |norm(program's first gradient as Adam
                     took it) - norm(reference's)| over the larger of the
                     reference leaf's norm and the median leaf's
    change_norm_gap  the same of each leaf's change over the checked
                     steps, leaves whose reference gradient is under a
                     thousandth of the median leaf's left out (their
                     change under Adam is round-off)
    grad_norm_gap_median, change_norm_gap_median
                     the median leaf's gap instead of the worst leaf's

A cell compares the numbers its file gives limits for; the others are
recorded beside them.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from benchmark import weights as weights_lib
from benchmark.harness import PIXEL_FIELDS, RAY_FIELDS, norms
from benchmark.reference import cameras, common

NUMBERS = ("data_gap", "loss_gap", "grad_norm_gap", "change_norm_gap",
           "grad_norm_gap_median", "change_norm_gap_median")
# A leaf's change counts when its reference gradient is at least this
# share of the median leaf's.
CHANGE_FLOOR = 1e-3


def pixels(rays: Dict[str, torch.Tensor], width: int, height: int):
    """(camera, x, y) integer arrays of a batch's rays: the nearest pixel
    of each, inside the image (data_gap then reads how far off it was)."""
    pc = rays["pix_coords"].double().numpy()
    x = np.rint(pc[:, 0] * width - 0.5).astype(np.int64).clip(0, width - 1)
    y = np.rint(pc[:, 1] * height - 0.5).astype(np.int64).clip(0, height - 1)
    return rays["cam_idx"].numpy()[:, 0].astype(np.int64), x, y


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(b.device).double() - b.double()).abs().max())


def recast(scene: cameras.KubricScene, entry: dict, device):
    """The reference's rays (RAY_FIELDS and PIXEL_FIELDS) and colours of a
    checked batch, and the data gap of the program's."""
    h, w = scene.images[0].shape[:2]
    cam, x, y = pixels(entry["rays"], w, h)
    ref = scene.rays(cam, x, y, device)
    fields = RAY_FIELDS + PIXEL_FIELDS
    gap = max([_gap(entry["rgb"], ref["rgb"]),
               _gap(entry["rays"]["lossmult"], torch.ones(1))]
              + [_gap(entry["rays"][k], ref[k]) for k in fields])
    return {k: ref[k] for k in fields}, ref["rgb"], gap


def train_reference(module, values: dict, params, batches, seed: int,
                    device, precision: str = "float32") -> dict:
    """Losses, first-gradient norms and change norms of the reference
    trained on `batches` [(rays, rgb)] from `params`."""
    common.set_exact_float32()
    trainer = common.Trainer(module, params, values, precision)
    start = {k: p.detach().clone() for k, p in trainer.params.items()}
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out = {"losses": []}
    for i, (rays, rgb) in enumerate(batches):
        loss, grads = trainer.step(rays, rgb, gen)
        out["losses"].append(float(loss))
        if i == 0:
            out["grad_norms"] = norms(grads)
    out["change_norms"] = norms({k: p.detach() - start[k]
                                 for k, p in trainer.params.items()})
    return out


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> dict:
    """{leaf: its norm gap} over the larger of its and the median leaf's
    reference norm."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def _largest(gaps: dict, n: int = 5) -> list:
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def compare(prog: dict, ref: dict, data_gap: float) -> dict:
    """The numbers compared, with the leaves that set them."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    leaves = list(ref["grad_norms"])
    grad = _gaps(prog["grad_norms"], ref["grad_norms"], leaves)
    med = statistics.median(ref["grad_norms"].values())
    moving = [k for k in leaves if ref["grad_norms"][k] >= CHANGE_FLOOR * med]
    change = _gaps(prog["change_norms"], ref["change_norms"], moving)
    numbers = {"data_gap": data_gap, "loss_gap": max(losses),
               "grad_norm_gap": max(grad.values()),
               "change_norm_gap": max(change.values()),
               "grad_norm_gap_median": statistics.median(grad.values()),
               "change_norm_gap_median": statistics.median(change.values())}
    numbers = {k: (v if np.isfinite(v) else float("inf"))
               for k, v in numbers.items()}
    return {"numbers": numbers, "grad_leaves": _largest(grad),
            "change_leaves": _largest(change),
            "left_out": sorted(set(leaves) - set(moving)),
            "losses": {"program": prog["losses"], "reference": ref["losses"]}}


def program_readings(checked: List[dict]) -> dict:
    return {"losses": [float(e["loss"]) for e in checked],
            "grad_norms": checked[0]["grad_norms"],
            "change_norms": checked[-1]["change_norms"]}


def judge(run, limits: dict, precision: str = "float32") -> dict:
    """Recast the checked batches, train the reference and compare; the
    program's state is freed first."""
    device = run.device
    scene = cameras.KubricScene(run.data_dir, run.traffic["scene"]["factor"])
    batches, data_gap = [], 0.0
    for entry in run.checked:
        rays, rgb, gap = recast(scene, entry, device)
        batches.append((rays, rgb))
        data_gap = max(data_gap, gap)
    params = weights_lib.draw(run.specs, run.seed, device)
    ref = train_reference(run.reference, run.values, params, batches,
                          run.seed, device, precision)
    del params
    out = compare(program_readings(run.checked), ref, data_gap)
    out["checks"] = {k: {"value": out["numbers"][k], "limit": limit}
                     for k, limit in limits.items()}
    out["correct"] = bool(out["checks"]) and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in out["checks"].values())
    return out
