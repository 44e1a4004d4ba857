"""The readings a cell's limits are set from, on the card at the cell's
own size, many seeds in one process:

    python3 benchmark/control.py --workload CELL --mode MODE --seeds S1 S2 ...

MODE program   the program as the window runs it (the lower readings)
     fp8       the control: the plain reference put in the program's place
               with its matrix products in fp8 (one step below the
               configuration's bfloat16)
     half      a fault: the program trained on half of each batch, the mean
               taken over that half
     frozen    a fault: a step that returns the state unchanged

Each seed prints one line `reading {json}` with the numbers of
benchmark/check.py; the last line is `summary {json}` with each number's
largest and smallest reading. Not run by the benchmark's own runs.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__" and sys.path[0] == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT

import torch  # noqa: E402

from benchmark import check, harness  # noqa: E402
from benchmark.reference import common  # noqa: E402


class ReferenceTrainee:
    """The reference in the program's place: it takes the program's
    batches and trains its own parameters in `precision`."""

    def __init__(self, module, values, precision):
        def make(config, device, params, seed):
            self.trainer = common.Trainer(module, params, values, precision)
            self.gen = torch.Generator(device=device).manual_seed(seed + 1)
            self.grads = None
            return self
        self.make = make

    def step(self, batch, train_frac):
        rays = {k: getattr(batch.rays, k)
                for k in harness.RAY_FIELDS + harness.PIXEL_FIELDS}
        loss, grads = self.trainer.step(rays, batch.rgb[..., :3], self.gen)
        if self.grads is None:
            self.grads = grads
        return {"loss": loss}

    def readback(self, buffer):
        torch.stack([s["loss"] for s in buffer]).cpu()

    def params(self):
        return self.trainer.params

    def first_gradients(self):
        return self.grads

    def close(self):
        del self.trainer


class Faulty(harness.ProgramTrainee):
    """The program with a fault planted under the step: `half` trains on
    the first half of each batch; `frozen` computes the loss and returns
    the state unchanged."""

    fault = None

    def step(self, batch, train_frac):
        from nerf_hugs_torch.train import step as step_lib
        if self.fault == "frozen":
            with torch.no_grad():
                loss, _ = step_lib.compute_loss(
                    self.model, batch, train_frac, self.config, self.rng)
            return {"loss": loss, "mses": loss[None], "psnr": loss,
                    "losses": {"data": loss}}
        if self.fault == "half":
            n = batch.rgb.shape[0] // 2
            batch = type(batch)(rays=batch.rays.map(lambda a: a[:n]),
                                rgb=batch.rgb[:n])
        return super().step(batch, train_frac)


def faulty(fault: str):
    return type(f"Faulty_{fault}", (Faulty,), {"fault": fault})


def reading(manifest, cell: str, seed: int, mode: str, device) -> dict:
    run = harness.Run(manifest, cell, seed, device,
                      tmp_root=os.environ.get("TMPDIR"))
    try:
        if mode == "fp8":
            factory = ReferenceTrainee(run.reference, run.values, "fp8").make
        elif mode in ("half", "frozen"):
            factory = faulty(mode)
        else:
            factory = None
        run.setup(factory)
        run.checked_and_warm_steps()
        run.trainee.close()
        run.trainee = run.dataset = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
        verdict = check.judge(run, manifest.limits(run.cell))
        return {"seed": seed, "mode": mode, **verdict["numbers"],
                "grad_leaves": verdict["grad_leaves"],
                "change_leaves": verdict["change_leaves"],
                "losses": verdict["losses"]}
    finally:
        run.close()


def main(argv=None, root: str = ROOT, device=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("program", "fp8", "half", "frozen"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from benchmark.manifest import Manifest
    manifest = Manifest(root)
    if device is None:
        if not torch.cuda.is_available():
            sys.exit("no CUDA device")
        device = torch.device("cuda", 0)
    rows = []
    for seed in args.seeds:
        rows.append(reading(manifest, args.workload, seed, args.mode,
                            device))
        print("reading " + json.dumps(rows[-1]), flush=True)
    summary = {k: {"max": max(r[k] for r in rows),
                   "min": min(r[k] for r in rows)} for k in check.NUMBERS}
    print("summary " + json.dumps({"workload": args.workload,
                                   "mode": args.mode, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
