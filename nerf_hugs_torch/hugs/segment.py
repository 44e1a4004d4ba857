"""HuGS: heuristics-guided static-mask generation, the port of the
repository's generate_static_mask.py (run it as `python -m
nerf_hugs_torch.hugs`, hugs/__main__.py).

Per image (reference :223-419):
  1. SAM automatic masks over the GT image, completed by flood-filling
     uncovered pixels into new regions;
  2. color-residual masks from the partially-trained NeRF render
     (base <= mean; upper <= quantile T_CR);
  3. SfM static points (COLMAP track length >= T_SfM), deduplicated,
     optionally outlier-filtered and KMeans-reduced, prompted through SAM in
     batches with IoU + stability filtering;
  4. fuse (sfm OR residual_base) AND residual_upper -> smooth -> intersect
     with SAM regions -> erode; write static_masks/{name}.png and a 2x8
     visualization grid.

SAM runs on the given device (encoder, decoder batches, the filters and
the bit-packing); the heuristics are numpy and cv2 on the host.

Deliberate deviation kept from the JAX package: the reference's
visualization column 4 reuses the BASE residual+SAM mask for the "upper"
panel (generate_static_mask.py:289 passes residual_mask_base_sam into
fill_gap twice — a viz-only slip); the actual upper residual+SAM mask is
rendered there. The saved static_masks/ output is unaffected.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path

import numpy as np

from nerf_hugs_torch.hugs import heuristics


@dataclasses.dataclass
class SegmentConfig:
    """All heuristics knobs (HuGS/generate_static_mask.py:17-59)."""
    sam_points_per_side: int = 64
    sam_pred_iou_thresh: float = 0.8
    sam_stability_score_thresh: float = 0.9
    sam_crop_n_layers: int = 1
    sam_crop_n_points_downscale_factor: int = 2
    sam_min_mask_region_area: int = 50
    sam_points_per_batch: int = 64           # decoder batch size
    # Kept masks moved from the device to the host per decoder batch
    # (amg.SamAutomaticMaskGenerator.max_masks_per_batch). None = all
    # 3*points_per_batch candidates (exact parity); a warning fires if a
    # smaller budget ever drops a passing mask.
    sam_max_masks_per_batch: int | None = None
    sfm_point_count_threshold: int = 5       # T_SfM
    sfm_delete_outlier_points: bool = False
    sfm_cluster_num: int = -1
    sfm_points_per_mask: int = 1
    sfm_seg_batch_size: int = 128
    sfm_use_highest_iou: bool = True
    sfm_pred_iou_thresh: float = 0.8
    sfm_stability_score_offset: float = 1.0
    sfm_stability_score_thresh: float = 0.92
    residual_quantile_upper: float = 0.95    # T_CR
    smooth_kernel_size: int = 7
    erode_kernel_size: int = 5


# The stages NERF_HUGS_HUGS_TIMING=1 reports, in order.
STAGES = ("amg", "regions", "residual", "sfm", "fuse")


def load_image_rgb(path) -> np.ndarray:
    import cv2
    image = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if image.shape[-1] == 4:
        image = cv2.cvtColor(image, cv2.COLOR_BGRA2RGBA)
    else:
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    return image.astype(np.float32) / 255.0


def save_image_rgb(image: np.ndarray, path) -> None:
    import cv2
    image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    if image.shape[-1] == 4:
        image = cv2.cvtColor(image, cv2.COLOR_RGBA2BGRA)
    else:
        image = cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
    cv2.imwrite(str(path), image)


def visualize_mask(image, mask, color=(30 / 255, 144 / 255, 1.0)):
    color = np.array(color).reshape(1, 1, 3)
    return np.clip(mask * (0.35 * color + 0.65 * image)
                   + (1 - mask) * image, 0, 1)


def generate_masks_for_image(pred, gt, feature_points, mask_generator,
                             predictor, config: SegmentConfig,
                             stage_t: dict = None):
    """The full per-image pipeline; returns (static_mask [h,w,1],
    visualization [2h, 8w, 3]). The wall seconds of each of STAGES are
    added into `stage_t` when it is given; NERF_HUGS_HUGS_TIMING=1 prints
    them after the image."""
    timing = os.environ.get("NERF_HUGS_HUGS_TIMING", "0") == "1"
    stage_t = {} if stage_t is None else stage_t
    t_last = time.time()

    def _mark(name):
        nonlocal t_last
        now = time.time()
        stage_t[name] = stage_t.get(name, 0.0) + (now - t_last)
        t_last = now

    height, width = gt.shape[:2]
    vis = np.zeros((height * 2, width * 8, 3), np.float32)
    put = lambda r, c, img: vis.__setitem__(
        (slice(r * height, (r + 1) * height),
         slice(c * width, (c + 1) * width)), img)
    put(0, 0, gt)
    put(0, 1, pred)

    # 1. SAM regions over the GT image, completed to cover every pixel.
    sam_image = (gt * 255).astype(np.uint8)
    sam_results = sorted(mask_generator.generate(sam_image),
                         key=lambda x: x["area"], reverse=True)
    _mark("amg")
    sam_regions = heuristics.complete_sam_regions(
        [r["segmentation"] for r in sam_results], height, width)
    _mark("regions")
    rng = np.random.RandomState(0)
    region_vis = sum(sam_regions[i] * rng.rand(1, 1, 3)
                     for i in range(len(sam_regions)))
    put(0, 2, 0.65 * gt + 0.35 * region_vis)

    # 2. Color-residual masks.
    residual, res_base, res_upper = heuristics.residual_masks(
        pred, gt, config.residual_quantile_upper)
    rmin, rmax = residual.min(), residual.max()
    put(1, 0, np.broadcast_to((residual - rmin) / max(rmax - rmin, 1e-9),
                              gt.shape))
    put(1, 1, np.broadcast_to(res_base, gt.shape))
    put(1, 2, np.broadcast_to(res_upper, gt.shape))
    res_base_sam = heuristics.fill_gap(
        heuristics.intersect_masks(res_base, sam_regions, 0.5), 5)
    put(0, 3, visualize_mask(gt, res_base_sam))
    put(1, 3, np.broadcast_to(res_base_sam, gt.shape))
    res_upper_sam = heuristics.fill_gap(
        heuristics.intersect_masks(res_upper, sam_regions, 0.5), 5)
    put(0, 4, visualize_mask(gt, res_upper_sam))
    put(1, 4, np.broadcast_to(res_upper_sam, gt.shape))
    _mark("residual")

    # 3. SfM static points -> point-prompted SAM masks.
    sfm_mask = np.zeros((height, width), np.float32)
    if len(feature_points) > 0:
        points = heuristics.delete_same_points(feature_points)
        if config.sfm_delete_outlier_points:
            points = heuristics.delete_outlier_points(points)
        anchors = heuristics.kmeans_reduce(points, config.sfm_cluster_num)
        input_points = heuristics.group_points(anchors, points,
                                               config.sfm_points_per_mask)
        input_labels = np.ones(input_points.shape[:-1], np.int32)

        predictor.set_image(sam_image)
        coords = predictor.apply_coords(input_points, (height, width))
        batch = config.sfm_seg_batch_size
        for start in range(0, len(coords), batch):
            chunk = coords[start:start + batch]
            labels = input_labels[start:start + batch]
            n_valid = len(chunk)
            if n_valid < batch:
                pad = batch - n_valid
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:])])
                labels = np.concatenate(
                    [labels, np.zeros((pad,) + labels.shape[1:], np.int32)])
            # Decode + best-IoU selection + IoU/stability filter + threshold
            # + per-pixel count all on device (predictor.predict_count);
            # only the [h, w] count map crosses to the host. Equivalent to
            # the reference's predict -> argmax -> filter -> sum chain.
            sfm_mask += predictor.predict_count(
                chunk, labels, config.sfm_pred_iou_thresh,
                config.sfm_stability_score_thresh,
                config.sfm_stability_score_offset, n_valid=n_valid,
                select_best=config.sfm_use_highest_iou)
        predictor.reset_image()
        sfm_mask = heuristics.fill_gap(
            (sfm_mask[..., None] >= 0.5).astype(np.float32), 5)[..., 0]
    put(0, 5, visualize_mask(gt, sfm_mask[..., None]))
    put(1, 5, np.broadcast_to(sfm_mask[..., None], gt.shape))
    _mark("sfm")

    # 4. Fuse.
    sfm_residual = (((sfm_mask[..., None] + res_base) * res_upper) >= 0.5
                    ).astype(np.float32)
    put(0, 6, visualize_mask(gt, sfm_residual))
    put(1, 6, np.broadcast_to(sfm_residual, gt.shape))
    static_mask = heuristics.fuse_masks(
        sfm_mask[..., None], res_base, res_upper, sam_regions,
        config.smooth_kernel_size, config.erode_kernel_size)
    put(0, 7, visualize_mask(gt, static_mask))
    put(1, 7, np.broadcast_to(static_mask, gt.shape))
    _mark("fuse")
    if timing:
        print("  stages: " + " ".join(f"{k}={v:.1f}s"
                                      for k, v in stage_t.items()),
              flush=True)
    return static_mask, vis


def make_generator(predictor, config: SegmentConfig):
    """The automatic mask generator with the config's SAM knobs."""
    from nerf_hugs_torch.hugs.sam.amg import SamAutomaticMaskGenerator
    return SamAutomaticMaskGenerator(
        predictor=predictor,
        points_per_side=config.sam_points_per_side,
        points_per_batch=config.sam_points_per_batch,
        pred_iou_thresh=config.sam_pred_iou_thresh,
        stability_score_thresh=config.sam_stability_score_thresh,
        crop_n_layers=config.sam_crop_n_layers,
        crop_n_points_downscale_factor=config.sam_crop_n_points_downscale_factor,
        min_mask_region_area=config.sam_min_mask_region_area,
        max_masks_per_batch=config.sam_max_masks_per_batch)


def main(image_path, colmap_path, sam_model_type, sam_checkpoint_path,
         output_path, config: SegmentConfig, sam_overrides=None,
         device="cpu", predictor=None):
    """Write static_masks/{name}.png and visualizations/{name}.png under
    `output_path` for every {name}_gt.png / {name}_color.png pair in
    `image_path`. Returns one record per image: (name, wall seconds,
    {stage: seconds}). A `predictor` built beforehand is used as it is
    (the model type, checkpoint and overrides are then not read)."""
    from nerf_hugs_torch.cameras import colmap as colmap_lib
    from nerf_hugs_torch.hugs.sam.predictor import SamPredictor, build_sam

    if predictor is None:
        predictor = SamPredictor(build_sam(
            sam_model_type, sam_checkpoint_path, device,
            **(sam_overrides or {})))
    mask_generator = make_generator(predictor, config)

    image_dir = Path(image_path)
    gt_paths = sorted(image_dir.glob("*_gt.png"))
    if not gt_paths:
        raise FileNotFoundError(f"no *_gt.png under {image_dir}")

    colmap_dir = Path(colmap_path)
    imgdata = colmap_lib.read_images_binary(str(colmap_dir / "images.bin"))
    ptsdata = colmap_lib.read_points3D_binary(
        str(colmap_dir / "points3D.bin"))
    camdata = colmap_lib.read_cameras_binary(str(colmap_dir / "cameras.bin"))
    name_to_id = {Path(im.name).stem: key for key, im in imgdata.items()}

    out_base = Path(output_path)
    out_vis = out_base / "visualizations"
    out_mask = out_base / "static_masks"
    for d in (out_base, out_vis, out_mask):
        d.mkdir(parents=True, exist_ok=True)

    records = []
    for gt_path in gt_paths:
        t_img = time.time()
        image_name = gt_path.stem[:-3]
        pred = load_image_rgb(image_dir / f"{image_name}_color.png")[..., :3]
        gt = load_image_rgb(gt_path)[..., :3]
        height, width = gt.shape[:2]

        # SfM static points at render resolution (T_SfM track filter).
        colmap_id = name_to_id[image_name]
        im = imgdata[colmap_id]
        cam = camdata[im.camera_id]
        track_lengths = np.array(
            [len(ptsdata[int(pid)].image_ids) if int(pid) in ptsdata else 0
             for pid in im.point3D_ids])
        feature_points = heuristics.filter_sfm_points(
            im.xys, track_lengths, config.sfm_point_count_threshold,
            (width / cam.width, height / cam.height), (width, height))

        stages = {}
        static_mask, vis = generate_masks_for_image(
            pred, gt, feature_points, mask_generator, predictor, config,
            stages)
        save_image_rgb(np.broadcast_to(static_mask, gt.shape),
                       out_mask / f"{image_name}.png")
        save_image_rgb(vis, out_vis / f"{image_name}.png")
        records.append((image_name, time.time() - t_img, stages))
        print(f"{image_name}: static fraction "
              f"{float(static_mask.mean()):.3f} "
              f"({records[-1][1]:.1f}s)", flush=True)
    return records


def parse_args(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m nerf_hugs_torch.hugs",
        description="HuGS static masks from a partially trained NeRF's "
                    "train-split renders, SAM and the COLMAP model.")
    parser.add_argument("--images", type=str, required=True,
                        help="directory of {name}_gt.png / {name}_color.png")
    parser.add_argument("--colmap", type=str, required=True,
                        help="COLMAP model directory (sparse/0)")
    parser.add_argument("--sam_model", type=str,
                        choices=["default", "vit_h", "vit_l", "vit_b",
                                 "vit_t"],
                        default="vit_h")
    parser.add_argument("--sam_checkpoint", type=str, default=None,
                        help="segment-anything .pth (official keys); "
                             "without it SAM has seeded random weights")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--config", type=str, required=True,
                        help="yaml of SegmentConfig fields "
                             "(configs/hugs/*.yml)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return parser.parse_args(argv)


def cli_main(argv=None):
    import yaml

    from nerf_hugs_torch.utils.device import (pin_fp32_precision,
                                              resolve_device)
    args = parse_args(argv)
    device = resolve_device(args.device)
    pin_fp32_precision()
    with open(args.config, "r") as f:
        config = SegmentConfig(**(yaml.safe_load(f.read()) or {}))
    return main(args.images, args.colmap, args.sam_model,
                args.sam_checkpoint, args.output, config, device=device)
