"""The kernels' inputs at kubric_nerfacto_base and
distractor_nerfacto_hanerf, for the smoke run and the benchmarks: the
grids' specs, the main path's sample and fused-MLP shapes, a procedural
scene in the kubric layout, the configs on it, and the positions and output
gradients the full-width model hands its encoders in one step, captured
with hooks.
"""

from __future__ import annotations

import json
import os

BATCH = 16384              # rays per step of kubric_nerfacto_base
FIELD_N = BATCH * 128      # batch x field samples per ray
PROPOSAL_N = BATCH * 256   # batch x proposal samples per ray
# The hash grids of kubric_nerfacto_base (timed) and kubric_nerfacto_tpu
# (checked only): (name, HashGridSpec keywords, main-path samples or None).
GRIDS = (
    ("field", dict(num_levels=16, log2_hashmap_size=21, base_res=16,
                   max_res=8192), FIELD_N),
    ("proposal", dict(num_levels=7, log2_hashmap_size=17, base_res=16,
                      max_res=2048), PROPOSAL_N),
    ("tpu field", dict(num_levels=12, log2_hashmap_size=19, base_res=16,
                       max_res=4096), None),
    ("tpu proposal", dict(num_levels=5, log2_hashmap_size=17, base_res=16,
                          max_res=512), None),
)
# The fused-MLP shapes of kubric_nerfacto_base with enable_tcnn_mlp: (name,
# samples per ray, layer widths); the rows are BATCH times the samples per
# ray.
FUSED_SHAPES = (("proposal mlp_base", 256, (14, 64, 1)),
                ("field mlp_base", 128, (32, 256, 65)),
                ("field mlp_head", 128, (80, 256, 256, 3)))
# The HA-NeRF implicit mask's 2-D grid sees one position per ray.
MASK_N = BATCH
# configs/nerfacto/{kubric_nerfacto_base,distractor_nerfacto_hanerf}.yml of
# the checkout holding the package.
_CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "configs", "nerfacto")
BASE_CONFIG = os.path.join(_CONFIGS, "kubric_nerfacto_base.yml")
HANERF_CONFIG = os.path.join(_CONFIGS, "distractor_nerfacto_hanerf.yml")
# The written kubric scene: its image directories are rgb/{FACTOR}x/.
SCENE_FACTOR = 2
# Its lens: small radial and tangential distortion, one camera for all
# frames.
SCENE_DISTORTION = {"radial_distortion": [-0.02, 0.004, 0.0],
                    "tangential_distortion": [0.001, -0.0005]}


def fused_overlay(model: dict) -> dict:
    """The model section with enable_tcnn_mlp on for the field and for
    every proposal_net_args_list entry."""
    return {**model, "enable_tcnn_mlp": True, "proposal_net_args_list": [
        {**a, "enable_tcnn_mlp": True}
        for a in model["proposal_net_args_list"]]}


# The cadence keys of the smoke runs: exit after `steps`, print every
# step, and (read by the eval phase only) 2 test images.
def _cadence(steps: int) -> dict:
    return {"early_exit_steps": steps, "print_every": 1,
            "eval_dataset_limit": 2}


def base_yaml(tmp: str, fused: bool, steps: int = 8,
              scene: str = "synthetic") -> str:
    """BASE_CONFIG exiting after `steps` steps (Dense MLPs, or fused for
    the field and the proposal), on the procedural scene (`synthetic`) or
    on a scene of write_kubric_scene (`kubric`, the config's own loader);
    returns the path of the yaml written into `tmp`."""
    import yaml
    with open(BASE_CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["base"].update(_cadence(steps))
    if scene == "synthetic":
        raw["base"].update({
            "dataset_type": "synthetic", "synthetic_num_images": 32,
            "synthetic_height": 512, "synthetic_width": 512,
            # Shrinks the procedural world so the sphere lies inside the
            # config's near/far (0.1/2) and bound (1).
            "synthetic_world_scale": 0.5})
    elif scene != "kubric":
        raise ValueError(f"unknown scene {scene!r}")
    tag = "fused" if fused else "dense"
    if fused:
        raw["model"] = fused_overlay(raw["model"])
    cfg_path = os.path.join(tmp, f"kubric_nerfacto_base_{scene}_{tag}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    return cfg_path


def hanerf_yaml(tmp: str, steps: int = 8) -> str:
    """HANERF_CONFIG, model section unchanged, on a scene of
    write_kubric_scene: the kubric loader at the scene's downsample factor,
    exiting after `steps` steps; returns the path of the yaml written into
    `tmp`. (The config's near: null, far: 1000 and rescale_scene are not
    read on this path: the kubric loader takes near and far from
    scene_gt.json.)"""
    import yaml
    with open(HANERF_CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["base"].update({"dataset_type": "kubric",
                        "downsample_factor": SCENE_FACTOR, **_cadence(steps)})
    cfg_path = os.path.join(tmp, "distractor_nerfacto_hanerf_kubric.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    return cfg_path


def write_kubric_scene(root: str, num_train: int = 32, num_test: int = 4,
                       size: int = 256, world_scale: float = 0.5,
                       seed: int = 0) -> str:
    """The procedural sphere world of data/synthetic.py in the kubric
    layout (data/kubric.py) under `root`: scene_gt.json, dataset.json,
    freeze-test/dataset.json, camera-gt/ and freeze-test/camera-gt/ jsons
    of one lens with SCENE_DISTORTION, size x size PNGs in rgb/{F}x/ and
    freeze-test/static-rgb/{F}x/ (F = SCENE_FACTOR) rendered through that
    lens, and an opaque random square pasted into each train frame, as
    SyntheticDistractor does, marked 0 in static_masks/. The cameras ring
    the origin at height 1.2 and radius 2.5 times world_scale; test views
    sit between the train azimuths. near 0.1 and far 2 (after the loader's
    1.2x) hold the sphere. Returns `root`."""
    import numpy as np
    from PIL import Image

    from nerf_hugs_torch.cameras import camera_utils
    from nerf_hugs_torch.data import kubric
    from nerf_hugs_torch.data.synthetic import _sphere_world_color
    rng = np.random.RandomState(seed)
    full = size * SCENE_FACTOR
    _write_json(os.path.join(root, "scene_gt.json"), {
        "center": [0.0, 0.0, 0.0], "scale": 1.0, "near": 0.1,
        "far": 2.0 / 1.2})
    splits = {"train": [f"{i:05d}" for i in range(num_train)],
              "test": [f"{10000 + i:05d}" for i in range(num_test)]}
    _write_json(os.path.join(root, "dataset.json"),
                {"train_ids": splits["train"]})
    _write_json(os.path.join(root, "freeze-test", "dataset.json"),
                {"val_ids": splits["test"]})
    for split, names in splits.items():
        test = split == "test"
        prefix = "freeze-test" if test else ""
        image_dir = os.path.join(root, prefix, "static-rgb" if test else "rgb",
                                 f"{SCENE_FACTOR}x")
        camera_dir = os.path.join(root, prefix, "camera-gt")
        for d in (image_dir, camera_dir):
            os.makedirs(d, exist_ok=True)
        for i, name in enumerate(names):
            theta = 2 * np.pi * (i + 0.5 * test) / len(names)
            z_jitter = 0.0 if test else 0.1 * rng.randn()
            position = world_scale * np.array(
                [2.5 * np.cos(theta), 2.5 * np.sin(theta), 1.2 + z_jitter])
            c2w = camera_utils.viewmatrix(camera_utils.normalize(position),
                                          np.array([0.0, 0, 1]), position)
            # Kubric stores the world-to-camera rotation of an OpenCV
            # camera (right, down, forward).
            orientation = (c2w[:, :3] @ np.diag([1.0, -1.0, -1.0])).T
            camera_path = os.path.join(camera_dir, f"{name}.json")
            _write_json(camera_path, {
                "orientation": orientation.tolist(),
                "position": position.tolist(), "focal_length": 0.9 * full,
                "principal_point": [full / 2, full / 2], "skew": 0.0,
                "pixel_aspect_ratio": 1.0, "image_size": [full, full],
                **SCENE_DISTORTION})
            # Render through the loader's own reading of the camera.
            pixtocam, camtoworld, distortion = kubric._camera_from_json(
                camera_path, SCENE_FACTOR)
            xg, yg = camera_utils.pixel_coordinates(size, size)
            origins, dirs, _, _ = camera_utils.pixels_to_rays(
                xg, yg, pixtocam, camtoworld, distortion)
            image = _sphere_world_color(origins, dirs,
                                        radius=0.5 * world_scale)
            if not test:
                sz = size // 4
                y0, x0 = rng.randint(0, size - sz, 2)
                image[y0:y0 + sz, x0:x0 + sz] = rng.rand(3)
                mask = np.full((size, size), 255, np.uint8)
                mask[y0:y0 + sz, x0:x0 + sz] = 0
                os.makedirs(os.path.join(root, "static_masks"),
                            exist_ok=True)
                Image.fromarray(mask).save(
                    os.path.join(root, "static_masks", f"{name}.png"))
            Image.fromarray(np.round(image * 255).astype(np.uint8)).save(
                os.path.join(image_dir, f"{name}.png"))
    return root


def _write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def capture_hashgrid_inputs(cfg_path: str, tmp: str, device,
                            names=("field", "proposal")) -> dict:
    """One batch of compute_loss + backward through the model of `cfg_path`
    on `device` (the train loop's first step: train_frac 0, its sampling
    generator; data from `tmp`), with hooks on the HashGridEncodings of
    `names` ("field", "proposal" for the first proposal net, "mask" for
    HA-NeRF's implicit mask); returns {name: (spec, grid positions, output
    gradient)} as those modules received them."""
    import torch
    from nerf_hugs_torch.data import load_dataset
    from nerf_hugs_torch.models.nerfacto import NerfactoModel
    from nerf_hugs_torch.train import driver
    from nerf_hugs_torch.train.step import compute_loss
    config = driver.load_config(cfg_path, tmp, os.path.join(tmp, "capture"))
    batch = next(load_dataset("train", tmp, config, is_training=True))
    model = NerfactoModel(config, device,
                          torch.Generator().manual_seed(config.seed))
    captured = {}

    def hook(name):
        def forward_hook(module, inputs, output):
            entry = captured[name] = [module.spec, inputs[0].detach().clone()]
            if output.requires_grad:
                output.register_hook(
                    lambda grad: entry.append(grad.detach().clone()))
        return forward_hook

    encoders = {"field": lambda: model.field.hashgrid,
                "proposal": lambda: model.proposal_0.hashgrid,
                "mask": lambda: model.implicit_mask.hashgrid}
    handles = [encoders[name]().register_forward_hook(hook(name))
               for name in names]
    rng = torch.Generator(device=device).manual_seed(config.seed + 1)
    try:
        loss, _ = compute_loss(model, batch.to(device), 0.0, config, rng)
        loss.backward()
    finally:
        for h in handles:
            h.remove()
    if sorted(captured) != sorted(names) \
            or any(len(v) != 3 for v in captured.values()):
        raise RuntimeError(f"the hooks did not capture the inputs and "
                           f"gradients of {names}")
    return {k: tuple(v) for k, v in captured.items()}


def capture_shares(spec, p, g) -> str:
    """The shares of out-of-box samples (collapsed to the origin) and of
    zero-gradient (sample, level) pairs in a captured input."""
    n = p.numel() // spec.num_dims
    out_of_box = float((p.reshape(n, -1) == 0).all(-1).float().mean())
    zero = float((g.reshape(n, spec.num_levels, -1) == 0).all(-1)
                 .float().mean())
    return (f"{out_of_box:.4f} of the samples out of the box (at the "
            f"origin), {zero:.4f} of the (sample, level) pairs with a zero "
            "gradient")
