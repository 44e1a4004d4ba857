"""One run of a train cell: set-up, the checked first steps, the measured
window and the reading of its metrics.

Set-up writes the cell's scene from the seed, loads the configuration
through the program's own loader, draws the initial parameters on the
device from the seed (benchmark/weights.py, the reference's shapes and
laws) and builds the training state the window trains: the program's
model (models.construct_model), its optimizer (train.step.create_optimizer)
and the train split's loader (train.driver.stage_dataset). The first steps
are the window's own loop (a copy of train.driver.run_stage without
checkpoints, evaluation or summaries), the first `checked_steps` of them
recorded for the comparison with the reference; the rest warm up the
cell's shapes. The window then trains for `seconds` of host time and ends
in a synchronise.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import scene as scene_lib
from benchmark import weights as weights_lib
from benchmark.manifest import Manifest

# The batch fields the program's loader fills and the reference recasts:
# the rays, and each ray's pixel centre, image index and static mask.
RAY_FIELDS = ("origins", "directions", "viewdirs", "radii", "near", "far")
PIXEL_FIELDS = ("pix_coords", "embed_idx", "static_mask")


def dotted(config, key: str):
    """The value of a dotted attribute path of the program's config."""
    obj = config
    for part in key.split("."):
        obj = getattr(obj, part)
    return obj


def _plain(x):
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def load_config(doc: dict, tmp: str, data_dir: str, seed: int):
    """The program's config of a configuration file: its yaml or gin text
    through the program's loader, the run's directories and seed; every
    entry of `values` is checked against what the program resolved."""
    from nerf_hugs_torch.configs import gin_parser, yaml_loader
    if doc["dialect"] == "yaml":
        import yaml
        path = os.path.join(tmp, "config.yml")
        with open(path, "w") as f:
            yaml.safe_dump(doc["program"], f)
        config = yaml_loader.load_yaml_config(path)
    elif doc["dialect"] == "gin":
        path = os.path.join(tmp, "config.gin")
        with open(path, "w") as f:
            f.write("\n".join(doc["program"]) + "\n")
        config = gin_parser.parse_gin_configs([path], [])
    else:
        raise ValueError(f"unknown dialect {doc['dialect']!r}")
    config.data_dir = data_dir
    config.checkpoint_dir = os.path.join(tmp, "checkpoints")
    config.seed = seed
    wrong = {k: (v, _plain(dotted(config, k)))
             for k, v in doc["values"].items()
             if _plain(dotted(config, k)) != v}
    if wrong:
        raise ValueError(f"the program resolves {doc['name']} otherwise "
                         f"than its file states (file, program): {wrong}")
    return config


class ProgramTrainee:
    """The program's training state: model, optimizer, schedule and the
    step's generator, stepped by train.step.train_step."""

    def __init__(self, config, device, params: Dict[str, torch.Tensor],
                 seed: int):
        from nerf_hugs_torch.models import construct_model
        from nerf_hugs_torch.train import step as step_lib
        self.config, self.device = config, device
        t0 = time.perf_counter()
        with torch.device(device):
            self.model = construct_model(
                config, device,
                torch.Generator(device=device).manual_seed(seed))
        t1 = time.perf_counter()
        self.model.load_state_dict(params, strict=True)
        t2 = time.perf_counter()
        self.optimizer, self.scheduler = step_lib.create_optimizer(
            config, self.model)
        self.timings = {"construct_s": t1 - t0, "load_s": t2 - t1,
                        "optimizer_s": time.perf_counter() - t2}
        self.rng = torch.Generator(device=device).manual_seed(seed + 1)
        self.thresholds = step_lib.initial_inlier_thresholds(config, device)
        self.robust = config.transient_type == "robustnerf"

    def step(self, batch, train_frac: float) -> dict:
        from nerf_hugs_torch.train import step as step_lib
        stats = step_lib.train_step(self.model, self.optimizer,
                                    self.scheduler, batch, train_frac,
                                    self.config, self.rng, self.thresholds,
                                    False)
        if self.robust:
            self.thresholds = stats["robust_inlier_threshold"]
        return stats

    def readback(self, buffer: List[dict]) -> None:
        """The train driver's print-event read of the buffered stats."""
        from nerf_hugs_torch.train.driver import read_stats
        read_stats(buffer, self.thresholds if self.robust else None)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def first_gradients(self) -> Dict[str, torch.Tensor]:
        """The gradient of the first step as Adam took it: its first
        moment over (1 - b1); zeros for a leaf Adam holds no state of."""
        b1 = self.config.adam_beta1
        out = {}
        for name, p in self.model.named_parameters():
            m = self.optimizer.state.get(p, {}).get("exp_avg")
            out[name] = (torch.zeros_like(p) if m is None
                         else m.detach() / (1 - b1))
        return out

    def close(self) -> None:
        del self.model, self.optimizer, self.scheduler


class Run:
    """A run of one cell from one seed on one device."""

    def __init__(self, manifest: Manifest, cell_name: str, seed: int,
                 device, tmp_root: Optional[str] = None):
        self.manifest = manifest
        self.cell = manifest.cell(cell_name)
        self.doc = manifest.config(self.cell)
        self.traffic = manifest.traffic(self.cell)
        self.reference = manifest.reference(self.doc["reference"])
        self.values = self.doc["values"]
        self.seed, self.device = seed, torch.device(device)
        self.tmp = tempfile.mkdtemp(prefix="bench-", dir=tmp_root)
        self.timings: Dict[str, float] = {}
        self.step_index = 0
        self.buffer: List[dict] = []
        self.spans: List[tuple] = []
        self.losses: List[torch.Tensor] = []
        self.checked: List[dict] = []
        self.trainee = None

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)

    def _timed(self, name: str, fn: Callable):
        t0 = time.perf_counter()
        out = fn()
        self.timings[name] = time.perf_counter() - t0
        return out

    # ---- set-up ----

    def setup(self, trainee_factory=None) -> None:
        from nerf_hugs_torch.train import driver
        from nerf_hugs_torch.utils.device import pin_fp32_precision
        s = self.traffic["scene"]
        self.data_dir = self._timed(
            "scene_s", lambda: scene_lib.write_kubric_scene(
                os.path.join(self.tmp, "scene"), self.seed, s["num_train"],
                s["size"], s["factor"], s["world_scale"],
                s.get("static_masks", False)))
        self.config = load_config(self.doc, self.tmp, self.data_dir,
                                  self.seed)
        if self.config.factor != s["factor"]:
            raise ValueError(f"the scene is written at factor {s['factor']}, "
                             f"the configuration reads {self.config.factor}")
        driver.preflight(self.config)
        pin_fp32_precision()
        self.specs = self.reference.param_specs(self.values)
        self._timed("device_init_s", lambda: (
            torch.zeros(1, device=self.device), self.sync()))
        params = self._timed("weights_s", lambda: weights_lib.draw(
            self.specs, self.seed, self.device))
        factory = trainee_factory or ProgramTrainee
        self.trainee = self._timed("model_s", lambda: factory(
            self.config, self.device, params, self.seed))
        self.timings.update(getattr(self.trainee, "timings", {}))
        del params
        self.dataset = self._timed("data_s", lambda: driver.stage_dataset(
            "train", self.config))
        driver.check_num_embeddings(self.config, self.dataset)
        self.batch_rays = self.config.batch_size

    def checked_and_warm_steps(self) -> None:
        """The first steps: `checked_steps` recorded for the comparison,
        then warm-up to `warmup_steps` in all."""
        t0 = time.perf_counter()
        n_checked = self.traffic["checked_steps"]
        start = {k: p.detach().clone()
                 for k, p in self.trainee.params().items()}

        def record(step, batch, stats):
            entry = {"loss": stats["loss"],
                     "rays": {k: getattr(batch.rays, k).cpu()
                              for k in RAY_FIELDS + PIXEL_FIELDS
                              + ("cam_idx", "lossmult")},
                     "rgb": batch.rgb.cpu()}
            if step == 1:
                entry["grad_norms"] = norms(self.trainee.first_gradients())
            if step == n_checked:
                entry["change_norms"] = norms(
                    {k: p.detach() - start[k]
                     for k, p in self.trainee.params().items()})
            self.checked.append(entry)

        self.steps(count=n_checked, on_step=record)
        del start
        self.steps(count=self.traffic["warmup_steps"] - n_checked)
        self.sync()
        self.timings["first_steps_s"] = time.perf_counter() - t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the loop ----

    def steps(self, count: Optional[int] = None, until: Optional[float] = None,
              on_step=None, events: Optional[list] = None) -> int:
        """The train driver's loop: a batch from the loader's prefetch
        thread to the device, one train step, the stats read back at the
        first step and every print_every steps."""
        done = 0
        max_steps, every = self.config.max_steps, self.config.print_every
        while (count is None or done < count) and \
                (until is None or time.perf_counter() < until):
            self.step_index += 1
            step = self.step_index
            t0 = time.perf_counter()
            batch = next(self.dataset).to(self.device)
            t1 = time.perf_counter()
            frac = float(np.clip((step - 1) / max(max_steps - 1, 1), 0, 1))
            stats = self.trainee.step(batch, frac)
            t2 = time.perf_counter()
            self.buffer.append(stats)
            self.spans += [("data", t0, t1), ("train_step", t1, t2)]
            if step == 1 or step % every == 0:
                self.trainee.readback(self.buffer)
                self.buffer = []
                self.spans.append(("readback", t2, time.perf_counter()))
            self.losses.append(stats["loss"])
            if events is not None:
                events.append(self._event())
            if on_step is not None:
                on_step(step, batch, stats)
            done += 1
        return done

    def _event(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def window(self, seconds: float) -> dict:
        """Train for `seconds` of host time; the window ends when the
        device has finished every step issued in it."""
        self.losses, self.spans = [], []
        events = []
        self.sync()
        start = time.perf_counter()
        events.append(self._event())
        n = self.steps(until=start + seconds, events=events)
        self.sync()
        end = time.perf_counter()
        if self.device.type == "cuda":
            step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        else:
            step_ms = [(b - a) * 1e3 for a, b in zip(events, events[1:])]
        losses = torch.stack(self.losses).float().cpu()
        return {"steps": n, "start": start,
                "end": end, "seconds": end - start, "step_ms": step_ms,
                "rays": n * self.batch_rays,
                "failed": int((~torch.isfinite(losses)).sum()),
                "spans": list(self.spans)}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{leaf: its float64 L2 norm}."""
    return {k: float(torch.linalg.vector_norm(t.detach().double()))
            for k, t in tensors.items()}
