"""The kernels' inputs at kubric_nerfacto_base and the shipped transient
configs, for the smoke run and the benchmarks: the grids' specs, the main
path's sample and fused-MLP shapes, procedural scenes in the kubric,
distractor and phototourism layouts, the shipped configs on them, and the
positions and output gradients the full-width model hands its encoders in
one step, captured with hooks.
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
# configs/nerfacto/ of the checkout holding the package.
_CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "configs", "nerfacto")
BASE_CONFIG = os.path.join(_CONFIGS, "kubric_nerfacto_base.yml")
# The written kubric scene: its image directories are rgb/{FACTOR}x/.
SCENE_FACTOR = 2
# Its lens: small radial and tangential distortion, one camera for all
# frames.
SCENE_DISTORTION = {"radial_distortion": [-0.02, 0.004, 0.0],
                    "tangential_distortion": [0.001, -0.0005]}
# The written COLMAP scenes, per layout: the downsample factor of the
# shipped configs (distractor_* 8: images in 0/images_8/ with the COLMAP
# intrinsics at 8x; phototourism_* 2: the loader halves 512x512 images),
# the COLMAP camera model, the world scale (the distractor loader
# normalises the capture into the unit cube; the phototourism loader
# scales by 2 / 24, brandenburg_gate's published radius, so the ring of
# cameras lands at radius 1 of the bound-2 box) and the image size on
# disk.
COLMAP_LAYOUTS = {
    "distractor": {"factor": 8, "model": "OPENCV", "world_scale": 0.5,
                   "disk_size": 256},
    "phototourism": {"factor": 2, "model": "PINHOLE", "world_scale": 4.8,
                     "disk_size": 512},
}
PHOTOTOURISM_SCENE = "brandenburg_gate"
# The OPENCV lens of the distractor layout: k1, k2, p1, p2.
COLMAP_DISTORTION = (-0.02, 0.004, 0.001, -0.0005)


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
              scene: str = "synthetic", **base) -> str:
    """BASE_CONFIG exiting after `steps` steps (Dense MLPs, or fused for
    the field and the proposal), on the procedural scene (`synthetic`) or
    on a scene of write_kubric_scene (`kubric`, the config's own loader),
    with the base-section keys `base` on top (for example enable_amp:
    False, which runs the MLPs in fp32, and an eval_dataset_limit);
    returns the path of the yaml written into `tmp`."""
    import yaml
    with open(BASE_CONFIG) as f:
        raw = yaml.safe_load(f)
    raw["base"].update({**_cadence(steps), **base})
    if scene == "synthetic":
        raw["base"].update({
            "dataset_type": "synthetic", "synthetic_num_images": 32,
            "synthetic_height": 512, "synthetic_width": 512,
            # Shrinks the procedural world so the sphere lies inside the
            # config's near/far (0.1/2) and bound (1).
            "synthetic_world_scale": 0.5})
    elif scene != "kubric":
        raise ValueError(f"unknown scene {scene!r}")
    tag = ("fused" if fused else "dense") + (
        "_fp32" if base.get("enable_amp") is False else "")
    if fused:
        raw["model"] = fused_overlay(raw["model"])
    cfg_path = os.path.join(tmp, f"kubric_nerfacto_base_{scene}_{tag}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    return cfg_path


def shipped_yaml(tmp: str, name: str, steps: int = 8, **base) -> str:
    """configs/nerfacto/{name}.yml, model section unchanged, exiting after
    `steps` train steps, with the base-section keys `base` (for example
    finetune_num_steps) on top; returns the path of the yaml written into
    `tmp`. Its own loader reads a scene of write_colmap_scene in its
    layout."""
    import yaml
    with open(os.path.join(_CONFIGS, f"{name}.yml")) as f:
        raw = yaml.safe_load(f)
    raw["base"].update({**_cadence(steps), **base})
    cfg_path = os.path.join(tmp, f"{name}.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)
    return cfg_path



def write_kubric_scene(root: str, num_train: int = 32, num_test: int = 4,
                       size: int = 256, world_scale: float = 0.5,
                       seed: int = 0, factors=(SCENE_FACTOR,)) -> str:
    """The procedural sphere world of data/synthetic.py in the kubric
    layout (data/kubric.py) under `root`: scene_gt.json, dataset.json,
    freeze-test/dataset.json, camera-gt/ and freeze-test/camera-gt/ jsons
    of one lens with SCENE_DISTORTION, PNGs in rgb/{f}x/ and
    freeze-test/static-rgb/{f}x/ for each f of `factors` (size x size at
    the first; the camera's full resolution is size times that factor)
    rendered through that lens, and an opaque random square pasted into
    each train frame, as SyntheticDistractor does, marked 0 in
    static_masks/ (at the first factor's size). The cameras ring the
    origin at height 1.2 and radius 2.5 times world_scale; test views sit
    between the train azimuths. near 0.1 and far 2 (after the loader's
    1.2x) hold the sphere.

    sparse/0 holds the capture's COLMAP model (write_kubric_sfm), which
    the HuGS stage reads. Returns `root`."""
    import numpy as np
    from PIL import Image

    from nerf_hugs_torch.cameras import camera_utils
    from nerf_hugs_torch.data import kubric
    from nerf_hugs_torch.data.synthetic import _sphere_world_color
    rng = np.random.RandomState(seed)
    full = size * factors[0]
    _write_json(os.path.join(root, "scene_gt.json"), {
        "center": [0.0, 0.0, 0.0], "scale": 1.0, "near": 0.1,
        "far": 2.0 / 1.2})
    splits = {"train": [f"{i:05d}" for i in range(num_train)],
              "test": [f"{10000 + i:05d}" for i in range(num_test)]}
    _write_json(os.path.join(root, "dataset.json"),
                {"train_ids": splits["train"]})
    _write_json(os.path.join(root, "freeze-test", "dataset.json"),
                {"val_ids": splits["test"]})
    views = []
    for split, names in splits.items():
        test = split == "test"
        prefix = "freeze-test" if test else ""
        camera_dir = os.path.join(root, prefix, "camera-gt")
        os.makedirs(camera_dir, exist_ok=True)
        for i, name in enumerate(names):
            theta = 2 * np.pi * (i + 0.5 * test) / len(names)
            z_jitter = 0.0 if test else 0.1 * rng.randn()
            position = world_scale * np.array(
                [2.5 * np.cos(theta), 2.5 * np.sin(theta), 1.2 + z_jitter])
            orientation = _kubric_orientation(position)
            views.append((name, orientation, position))
            camera_path = os.path.join(camera_dir, f"{name}.json")
            _write_json(camera_path, {
                "orientation": orientation.tolist(),
                "position": position.tolist(), "focal_length": 0.9 * full,
                "principal_point": [full / 2, full / 2], "skew": 0.0,
                "pixel_aspect_ratio": 1.0, "image_size": [full, full],
                **SCENE_DISTORTION})
            if not test:
                sz = size // 4
                y0, x0 = rng.randint(0, size - sz, 2)
                color = rng.rand(3)
                mask = np.full((size, size), 255, np.uint8)
                mask[y0:y0 + sz, x0:x0 + sz] = 0
                os.makedirs(os.path.join(root, "static_masks"),
                            exist_ok=True)
                Image.fromarray(mask).save(
                    os.path.join(root, "static_masks", f"{name}.png"))
            for f in factors:
                image_dir = os.path.join(root, prefix,
                                         "static-rgb" if test else "rgb",
                                         f"{f}x")
                os.makedirs(image_dir, exist_ok=True)
                # Render through the loader's own reading of the camera.
                pixtocam, camtoworld, distortion = kubric._camera_from_json(
                    camera_path, f)
                xg, yg = camera_utils.pixel_coordinates(full // f, full // f)
                origins, dirs, _, _ = camera_utils.pixels_to_rays(
                    xg, yg, pixtocam, camtoworld, distortion)
                image = _sphere_world_color(origins, dirs,
                                            radius=0.5 * world_scale)
                if not test:
                    # The square at this factor's scale.
                    k = factors[0] / f
                    ya, yb, xa, xb = (int(round(v * k)) for v in
                                      (y0, y0 + sz, x0, x0 + sz))
                    image[ya:yb, xa:xb] = color
                Image.fromarray(np.round(image * 255).astype(np.uint8)).save(
                    os.path.join(image_dir, f"{name}.png"))
    write_kubric_sfm(os.path.join(root, "sparse", "0"), views, full,
                     world_scale, rng)
    return root


# The written kubric capture's COLMAP model: points on the sphere, and
# frames of the capture's video that neither split uses, so that points
# seen from most of the ring have tracks past the T_SfM of
# configs/hugs/kubric.yml (40 images).
KUBRIC_SFM_POINTS = 4096
KUBRIC_SFM_VIEWS = 64


def _kubric_orientation(position):
    """The world-to-camera rotation of an OpenCV camera (right, down,
    forward) at `position` looking at the origin, as kubric stores it."""
    import numpy as np

    from nerf_hugs_torch.cameras import camera_utils
    c2w = camera_utils.viewmatrix(camera_utils.normalize(position),
                                  np.array([0.0, 0, 1]), position)
    return (c2w[:, :3] @ np.diag([1.0, -1.0, -1.0])).T


def write_kubric_sfm(model_dir: str, views, full: int, world_scale: float,
                     rng) -> None:
    """A COLMAP model (binary cameras/images/points3D) of the capture:
    one OPENCV camera at the full resolution with SCENE_DISTORTION's lens
    (k1, k2, p1, p2), one image per view of `views` ((name, world-to-camera
    rotation, position); the image is {name}.png) plus ring views of the
    same video up to KUBRIC_SFM_VIEWS in all, and KUBRIC_SFM_POINTS points
    on the sphere. A point's track is every image that sees it: the sphere
    faces the camera there and the point projects into the frame, where
    the image holds it as a feature at its distorted pixel position."""
    import numpy as np

    from nerf_hugs_torch.cameras import colmap
    views = list(views)
    for k in range(KUBRIC_SFM_VIEWS - len(views)):
        theta = 2 * np.pi * (k + 0.25) / max(KUBRIC_SFM_VIEWS - len(views), 1)
        position = world_scale * np.array(
            [2.5 * np.cos(theta), 2.5 * np.sin(theta),
             1.2 + 0.1 * rng.randn()])
        views.append((f"{20000 + k:05d}", _kubric_orientation(position),
                      position))
    xyz, rgb = _sphere_points(rng, 0.5 * world_scale, KUBRIC_SFM_POINTS)
    normal = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    (k1, k2, _), (p1, p2) = (SCENE_DISTORTION["radial_distortion"],
                             SCENE_DISTORTION["tangential_distortion"])
    focal, centre = 0.9 * full, full / 2
    cameras = {1: colmap.Camera(1, "OPENCV", full, full, np.array(
        [focal, focal, centre, centre, k1, k2, p1, p2]))}
    images, tracks = {}, [[] for _ in xyz]
    for image_id, (name, rot, position) in enumerate(views, start=1):
        cam = (xyz - position) @ rot.T
        x, y = cam[:, 0] / cam[:, 2], cam[:, 1] / cam[:, 2]
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2
        u = focal * (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)) \
            + centre
        v = focal * (y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y) \
            + centre
        seen = np.where((np.sum(normal * (position - xyz), -1) > 0)
                        & (cam[:, 2] > 0) & (u >= 0) & (u < full)
                        & (v >= 0) & (v < full))[0]
        for j, pid in enumerate(seen):
            tracks[pid].append((image_id, j))
        w2c_t = -rot @ position
        images[image_id] = colmap.Image(
            image_id, colmap.rotmat2qvec(rot), w2c_t, 1, f"{name}.png",
            np.stack([u[seen], v[seen]], -1), seen.astype(np.int64) + 1)
    points = {j + 1: colmap.Point3D(
        j + 1, xyz[j], rgb[j], 0.5,
        np.array([t[0] for t in track], np.int64),
        np.array([t[1] for t in track], np.int64))
        for j, track in enumerate(tracks)}
    os.makedirs(model_dir, exist_ok=True)
    colmap.write_cameras_binary(cameras, os.path.join(model_dir,
                                                      "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(model_dir, "images.bin"))
    colmap.write_points3D_binary(points, os.path.join(model_dir,
                                                      "points3D.bin"))


def pixel_centres(gen, n: int, size: int = 256, patch: int = 16):
    """[n, 2] pix_coords of n // patch^2 random patches of patch x patch
    neighbouring pixels in size x size images, as the patch sampler hands
    them to the implicit mask, on gen's device."""
    import torch
    dev = gen.device
    d = torch.arange(patch, device=dev)
    offs = torch.stack(torch.meshgrid(d, d, indexing="xy"), -1).reshape(
        -1, 2)
    corner = torch.randint(0, size - patch + 1, (n // patch ** 2, 1, 2),
                           generator=gen, device=dev)
    return ((corner + offs).reshape(-1, 2).float() + 0.5) / size


def _sphere_points(rng, radius: float, n: int):
    """n points on the sphere of the procedural world, uniform over its
    surface, with their colours: the SfM points of a generated capture."""
    import numpy as np

    from nerf_hugs_torch.data.synthetic import _sphere_world_color
    normal = rng.randn(n, 3)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    points = radius * normal
    # The colour seen from outside along the normal.
    color = _sphere_world_color(points + normal, -normal, radius=radius)
    return points, np.round(color * 255).astype(np.uint8)


def write_colmap_scene(root: str, layout: str, num_train: int = 32,
                       num_test: int = 4, size: int = None,
                       seed: int = 0) -> str:
    """The procedural sphere world of data/synthetic.py as a COLMAP
    capture in the `distractor` or `phototourism` layout under `root`
    (COLMAP_LAYOUTS); returns the directory to hand the loader as
    --data_dir.

    Cameras at height 1.2 and radius 2.5 times the layout's world scale
    look at the sphere (radius 0.5 times it): a full ring for `distractor`,
    a 120-degree arc in front of it for `phototourism` (a photo collection
    of one facade; a full ring would leave recenter_poses' average pose
    without a viewing direction). Test views sit between the train views.
    The model is written with the port's copy of colmap.py as binary
    cameras/images/points3D, and points3D holds 4096 points on the
    sphere's surface, so the loaders' near/far percentiles come from real
    depths. Every image is rendered through the loader's own reading of
    its camera, and each train frame gets an opaque random square marked 0
    in its static mask. `size` overrides the layout's image size on disk.
      distractor:   {root}/0/sparse/0, 0/images_8/ at 256x256 (one OPENCV
                    camera of 2048x2048 with COLMAP_DISTORTION; the loader
                    scales its intrinsics by 8), 0/data_split.json and
                    0/static_masks/.
      phototourism: {root}/brandenburg_gate/ with dense/sparse/,
                    dense/images/ at 512x512 (one PINHOLE camera per image,
                    focal lengths spread by 2%: per-image intrinsics),
                    dense/static_masks/ and a .tsv split; the loader halves
                    the images (downsample_factor 2)."""
    import numpy as np
    from PIL import Image

    from nerf_hugs_torch.cameras import camera_utils, colmap
    from nerf_hugs_torch.data.synthetic import _sphere_world_color
    spec = COLMAP_LAYOUTS[layout]
    rng = np.random.RandomState(seed)
    scale, size = spec["world_scale"], size or spec["disk_size"]
    if layout == "distractor":
        data_dir = root
        model_dir = os.path.join(root, "0", "sparse", "0")
        image_dir = os.path.join(root, "0", f"images_{spec['factor']}")
        mask_dir = os.path.join(root, "0", "static_masks")
        full = size * spec["factor"]    # the COLMAP camera's own size
        arc = 2 * np.pi
    else:
        data_dir = os.path.join(root, PHOTOTOURISM_SCENE)
        model_dir = os.path.join(data_dir, "dense", "sparse")
        image_dir = os.path.join(data_dir, "dense", "images")
        mask_dir = os.path.join(data_dir, "dense", "static_masks")
        full = size
        arc = 2 * np.pi / 3
    for d in (model_dir, image_dir, mask_dir):
        os.makedirs(d, exist_ok=True)

    names = ([f"{i:05d}.png" for i in range(num_train)]
             + [f"{10000 + i:05d}.png" for i in range(num_test)])
    cameras, images = {}, {}
    for i, name in enumerate(names):
        test = i >= num_train
        k, n = (i - num_train, num_test) if test else (i, num_train)
        theta = arc * ((k + 0.5 * test) / n - 0.5)
        z_jitter = 0.0 if test else 0.1 * rng.randn()
        position = scale * np.array([2.5 * np.cos(theta), 2.5 * np.sin(theta),
                                     1.2 + z_jitter])
        c2w = camera_utils.viewmatrix(camera_utils.normalize(position),
                                      np.array([0.0, 0, 1]), position)
        # COLMAP stores the world-to-camera pose of an OpenCV camera
        # (right, down, forward).
        w2c = np.linalg.inv(camera_utils.pad_poses(
            c2w @ np.diag([1.0, -1.0, -1.0, 1.0])))
        if layout == "distractor":
            cam_id, focal = 1, 0.9 * full
            params = [focal, focal, full / 2, full / 2, *COLMAP_DISTORTION]
            distortion = dict(zip(("k1", "k2", "p1", "p2"),
                                  COLMAP_DISTORTION), k3=0.0)
        else:
            cam_id = i + 1
            focal = 0.9 * full * (1 + 0.02 * rng.uniform(-1, 1))
            params = [focal, focal, full / 2, full / 2]
            distortion = None
        cameras[cam_id] = colmap.Camera(cam_id, spec["model"], full, full,
                                        np.array(params))
        images[i + 1] = colmap.Image(
            i + 1, colmap.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], cam_id, name,
            np.zeros((0, 2)), np.zeros(0, np.int64))
        # Render at the size on disk through the inverse intrinsics at that
        # scale, the lens and the NeRF-frame pose.
        pixtocam = np.linalg.inv(camera_utils.intrinsic_matrix(
            focal, focal, full / 2, full / 2)) @ np.diag(
                [full / size, full / size, 1.0])
        xg, yg = camera_utils.pixel_coordinates(size, size)
        origins, dirs, _, _ = camera_utils.pixels_to_rays(
            xg, yg, pixtocam, c2w, distortion)
        image = _sphere_world_color(origins, dirs, radius=0.5 * scale)
        if not test:
            sz = size // 4
            y0, x0 = rng.randint(0, size - sz, 2)
            image[y0:y0 + sz, x0:x0 + sz] = rng.rand(3)
            mask = np.full((size, size), 255, np.uint8)
            mask[y0:y0 + sz, x0:x0 + sz] = 0
            Image.fromarray(mask).save(
                os.path.join(mask_dir, name.split(".")[0] + ".png"))
        Image.fromarray(np.round(image * 255).astype(np.uint8)).save(
            os.path.join(image_dir, name))

    xyz, rgb = _sphere_points(rng, 0.5 * scale, 4096)
    track = np.arange(1, len(names) + 1)
    points = {j + 1: colmap.Point3D(j + 1, xyz[j], rgb[j], 0.5, track,
                                    np.zeros(len(names), np.int64))
              for j in range(len(xyz))}
    colmap.write_cameras_binary(cameras, os.path.join(model_dir,
                                                      "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(model_dir, "images.bin"))
    colmap.write_points3D_binary(points, os.path.join(model_dir,
                                                      "points3D.bin"))
    if layout == "distractor":
        _write_json(os.path.join(root, "0", "data_split.json"),
                    {"train": names[:num_train], "test": names[num_train:]})
    else:
        with open(os.path.join(data_dir, f"{PHOTOTOURISM_SCENE}.tsv"),
                  "w") as f:
            f.write("filename\tid\tsplit\tdataset\n")
            for i, name in enumerate(names):
                split = "test" if i >= num_train else "train"
                f.write(f"{name}\t{i}\t{split}\t{PHOTOTOURISM_SCENE}\n")
    return data_dir


# The written llff captures (write_llff_scene): frames of images_4/ at this
# size, (width, height), and the COLMAP camera at LLFF_FACTOR times it.
LLFF_SIZE = (1008, 756)
LLFF_FACTOR = 4


def write_llff_scene(root: str, forward_facing: bool, num_images: int = 20,
                     size=LLFF_SIZE) -> str:
    """The procedural sphere world of data/synthetic.py as an llff capture
    under `root` (data/llff.py): sparse/0 (binary COLMAP model: one PINHOLE
    camera at LLFF_FACTOR times `size`, one image per frame, 4096 points
    on the sphere), images_4/ with the frames at `size` (width, height),
    images/ with the same files (the loader reads only their names there,
    to pair them with images_4/), and poses_bounds.npy, whose last two
    columns hold each camera's near and
    far bound on the sphere's depth (the loader reads only those; the
    first 15 are the camera-to-world pose and (height, width, focal), as
    LLFF writes them).

    forward_facing: the cameras sit on a 5 x 4 grid in a plane at distance
    2.5 from the sphere (radius 0.5) and look at it, as an llff_*.gin
    capture; otherwise they ring it at height 1.2, as a 360*.gin capture. Every llffhold-th frame in name order is a test
    frame. Returns `root`."""
    import numpy as np
    from PIL import Image

    from nerf_hugs_torch.cameras import camera_utils, colmap
    from nerf_hugs_torch.data.synthetic import _sphere_world_color
    rng = np.random.RandomState(0)
    factor = LLFF_FACTOR
    width, height = size
    full_w, full_h = width * factor, height * factor
    focal = 0.9 * full_w
    model_dir = os.path.join(root, "sparse", "0")
    image_dirs = [os.path.join(root, "images"),
                  os.path.join(root, f"images_{factor}")]
    for d in [model_dir] + image_dirs:
        os.makedirs(d, exist_ok=True)
    radius = 0.5
    cameras = {1: colmap.Camera(1, "PINHOLE", full_w, full_h, np.array(
        [focal, focal, full_w / 2, full_h / 2]))}
    images, poses_bounds = {}, []
    pixtocam = np.linalg.inv(camera_utils.intrinsic_matrix(
        focal, focal, full_w / 2, full_h / 2)) @ np.diag(
            [factor, factor, 1.0])
    xg, yg = camera_utils.pixel_coordinates(width, height)
    for i in range(num_images):
        if forward_facing:
            gx, gy = i % 5 - 2, i // 5 % 4 - 1.5
            position = np.array([0.15 * gx, 0.15 * gy, 2.5])
            up = np.array([0.0, 1, 0])
        else:
            theta = 2 * np.pi * i / num_images
            position = np.array([2.5 * np.cos(theta), 2.5 * np.sin(theta),
                                 1.2 + 0.1 * rng.randn()])
            up = np.array([0.0, 0, 1])
        c2w = camera_utils.viewmatrix(camera_utils.normalize(position), up,
                                      position)
        w2c = np.linalg.inv(camera_utils.pad_poses(
            c2w @ np.diag([1.0, -1.0, -1.0, 1.0])))
        name = f"IMG_{i:04d}.png"
        images[i + 1] = colmap.Image(
            i + 1, colmap.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
            np.zeros((0, 2)), np.zeros(0, np.int64))
        origins, dirs, _, _ = camera_utils.pixels_to_rays(
            xg, yg, pixtocam, c2w)
        image = _sphere_world_color(origins, dirs, radius=radius)
        for d in image_dirs:
            Image.fromarray(np.round(image * 255).astype(np.uint8)).save(
                os.path.join(d, name))
        dist = np.linalg.norm(position)
        bounds = [0.9 * (dist - radius), 1.1 * (dist + radius)]
        poses_bounds.append(np.concatenate([
            np.concatenate([c2w, np.array([[full_h], [full_w], [focal]])],
                           1).ravel(), bounds]))
    xyz, rgb = _sphere_points(rng, radius, 4096)
    track = np.arange(1, num_images + 1)
    points = {j + 1: colmap.Point3D(j + 1, xyz[j], rgb[j], 0.5, track,
                                    np.zeros(num_images, np.int64))
              for j in range(len(xyz))}
    colmap.write_cameras_binary(cameras, os.path.join(model_dir,
                                                      "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(model_dir, "images.bin"))
    colmap.write_points3D_binary(points, os.path.join(model_dir,
                                                      "points3D.bin"))
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.array(poses_bounds, np.float64))
    return root


def write_blender_scene(root: str, num_train: int = 8, num_test: int = 2,
                        size: int = 800) -> str:
    """The procedural sphere world (radius 1) in the NeRF-synthetic layout
    under `root` (data/blender.py): transforms_{train,test}.json with
    camera_angle_x 0.6911 (the published scenes') and per-frame
    {file_path, transform_matrix}, and RGBA PNGs of size x size in
    train/ and test/, alpha 1 on the sphere and 0 elsewhere. The cameras
    ring the sphere at radius 4 (between blender_*.gin's near 2 and far
    6) and height 1.5; test views sit between the train views. Returns
    `root`."""
    import numpy as np
    from PIL import Image

    from nerf_hugs_torch.cameras import camera_utils
    from nerf_hugs_torch.data.synthetic import _sphere_world_color
    angle_x = 0.6911
    focal = 0.5 * size / np.tan(0.5 * angle_x)
    pixtocam = camera_utils.get_pixtocam(focal, size, size)
    xg, yg = camera_utils.pixel_coordinates(size, size)
    for split, n in (("train", num_train), ("test", num_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            theta = 2 * np.pi * (i + 0.5 * (split == "test")) / n
            position = np.array([4 * np.cos(theta), 4 * np.sin(theta), 1.5])
            c2w = camera_utils.viewmatrix(camera_utils.normalize(position),
                                          np.array([0.0, 0, 1]), position)
            origins, dirs, _, _ = camera_utils.pixels_to_rays(
                xg, yg, pixtocam, c2w)
            d = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
            b = np.sum(origins * d, -1)
            hit = b * b - (np.sum(origins * origins, -1) - 1.0) > 0
            rgba = np.concatenate([
                _sphere_world_color(origins, dirs, radius=1.0)
                * hit[..., None], hit[..., None]], -1)
            Image.fromarray(np.round(rgba * 255).astype(np.uint8),
                            "RGBA").save(os.path.join(root, split,
                                                      f"r_{i}.png"))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": camera_utils.pad_poses(
                               c2w).tolist()})
        _write_json(os.path.join(root, f"transforms_{split}.json"),
                    {"camera_angle_x": angle_x, "frames": frames})
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
