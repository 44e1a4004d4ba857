"""Automatic mask generation: grid prompts -> filtered, deduplicated masks;
the port of nerf_hugs_tpu/hugs/sam/amg.py.

segment-anything's SamAutomaticMaskGenerator as configured by HuGS
(generate_static_mask.py:193-201): points_per_side grid, IoU + stability
filtering, per-crop generation (crop_n_layers), box-NMS dedup, and
min_mask_region_area postprocessing (cv2 connected components). Decoder
calls run batched on the device (SamPredictor.predict_compact);
filtering, NMS and connected components are numpy and cv2 on the host.

One divergence from the JAX package: a max_masks_per_batch below 1 is
refused at construction (JAX reads 0 as "no budget", amg.py:164); None
keeps every candidate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from nerf_hugs_torch.hugs.sam.predictor import SamPredictor


def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n^2, 2] normalized (x, y) grid with half-cell offsets."""
    offset = 1 / (2 * n_per_side)
    side = np.linspace(offset, 1 - offset, n_per_side)
    xs, ys = np.meshgrid(side, side)
    return np.stack([xs.ravel(), ys.ravel()], -1)


def generate_crop_boxes(im_size, n_layers: int, overlap_ratio: float = 512 / 1500):
    """Full image + 2^i x 2^i overlapping crops per layer (amg.py logic)."""
    h, w = im_size
    boxes = [[0, 0, w, h]]
    layer_idxs = [0]
    short_side = min(h, w)
    for layer in range(n_layers):
        n_crops = 2 ** (layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops))
        crop_w = int(np.ceil((overlap * (n_crops - 1) + w) / n_crops))
        crop_h = int(np.ceil((overlap * (n_crops - 1) + h) / n_crops))
        x0s = [int((crop_w - overlap) * i) for i in range(n_crops)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_crops)]
        for x0 in x0s:
            for y0 in y0s:
                boxes.append([x0, y0, min(x0 + crop_w, w),
                              min(y0 + crop_h, h)])
                layer_idxs.append(layer + 1)
    return boxes, layer_idxs


def mask_to_box(mask: np.ndarray) -> np.ndarray:
    """Bool [h, w] -> xyxy box (0-box for empty masks)."""
    ys, xs = np.where(mask)
    if len(xs) == 0:
        return np.zeros(4)
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])


def box_nms(boxes: np.ndarray, scores: np.ndarray,
            iou_threshold: float) -> List[int]:
    """Greedy IoU NMS over xyxy boxes; returns kept indices."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    areas = np.maximum(0, boxes[:, 2] - boxes[:, 0]) * \
        np.maximum(0, boxes[:, 3] - boxes[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        x0 = np.maximum(boxes[i, 0], boxes[:, 0])
        y0 = np.maximum(boxes[i, 1], boxes[:, 1])
        x1 = np.minimum(boxes[i, 2], boxes[:, 2])
        y1 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(0, x1 - x0) * np.maximum(0, y1 - y0)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-9)
        suppressed |= iou > iou_threshold
        suppressed[i] = True
    return keep


@dataclasses.dataclass
class SamAutomaticMaskGenerator:
    predictor: SamPredictor
    points_per_side: int = 32
    points_per_batch: int = 64
    pred_iou_thresh: float = 0.88
    stability_score_thresh: float = 0.95
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    crop_n_layers: int = 0
    crop_nms_thresh: float = 0.7
    crop_n_points_downscale_factor: int = 1
    min_mask_region_area: int = 0
    # Device->host transfer budget: masks per decoder batch (of the
    # 3*points_per_batch candidates) shipped to the host. None = all (no
    # drops, exact parity). Real-weight runs keep ~5-30 of 192 candidates
    # under the default 0.88/0.95 thresholds, so a budget of
    # points_per_batch cuts the bit-packed transfer 3x without loss; a
    # warning fires if the budget ever drops a passing mask.
    max_masks_per_batch: int | None = None

    def __post_init__(self):
        if self.max_masks_per_batch is not None \
                and self.max_masks_per_batch < 1:
            raise ValueError(
                "max_masks_per_batch must be at least 1 (None keeps every "
                f"candidate), got {self.max_masks_per_batch}")

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """image: [H, W, 3] uint8 RGB -> list of {'segmentation', 'area',
        'bbox', 'predicted_iou', 'stability_score'} dicts."""
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(orig_size,
                                                     self.crop_n_layers)
        all_masks, all_ious, all_stab, all_boxes = [], [], [], []
        for crop_box, layer in zip(crop_boxes, layer_idxs):
            x0, y0, x1, y1 = crop_box
            crop = image[y0:y1, x0:x1]
            n_points = max(1, self.points_per_side //
                           (self.crop_n_points_downscale_factor ** layer))
            masks, ious, stabs = self._process_crop(crop, n_points)
            for m, i, s in zip(masks, ious, stabs):
                full = np.zeros(orig_size, bool)
                full[y0:y1, x0:x1] = m
                all_masks.append(full)
                all_ious.append(i)
                all_stab.append(s)
                all_boxes.append(mask_to_box(full))
        if not all_masks:
            return []
        boxes = np.stack(all_boxes)
        ious = np.array(all_ious)
        keep = box_nms(boxes, ious, self.crop_nms_thresh
                       if self.crop_n_layers > 0 else self.box_nms_thresh)
        results = []
        for i in keep:
            seg = all_masks[i]
            if self.min_mask_region_area > 0:
                seg = _remove_small_regions(seg, self.min_mask_region_area)
                if not seg.any():
                    continue
            results.append({
                "segmentation": seg,
                "area": int(seg.sum()),
                "bbox": all_boxes[i].tolist(),
                "predicted_iou": float(ious[i]),
                "stability_score": float(all_stab[i]),
            })
        return results

    def _process_crop(self, crop: np.ndarray, n_per_side: int):
        h, w = crop.shape[:2]
        hw = h * w
        self.predictor.set_image(crop)
        grid = build_point_grid(n_per_side) * np.array([w, h])
        coords_in = self.predictor.apply_coords(grid, (h, w))

        masks_out, ious_out, stabs_out, boxes = [], [], [], []
        for start in range(0, len(coords_in), self.points_per_batch):
            batch = coords_in[start:start + self.points_per_batch]
            n_valid = len(batch)
            # Pad to the fixed batch, as the JAX package does so that its
            # decoder compiles once.
            pad = self.points_per_batch - n_valid
            if pad:
                batch = np.concatenate([batch, np.zeros((pad, 2))])
            pts = batch[:, None, :]
            labels = np.ones(pts.shape[:2])
            # Decode + IoU/stability filter + threshold + box + bit-pack on
            # device; only kept masks are unpacked host-side.
            budget = (3 * self.points_per_batch
                      if self.max_masks_per_batch is None
                      else self.max_masks_per_batch)
            packed, ious, stabs, keep, bxs, n_pass = \
                self.predictor.predict_compact(
                    pts, labels, self.pred_iou_thresh,
                    self.stability_score_thresh,
                    self.stability_score_offset, n_valid=n_valid,
                    max_keep=budget)
            if n_pass > len(keep):
                import warnings
                warnings.warn(
                    f"AMG batch kept {n_pass} masks > budget {len(keep)}; "
                    "lowest-IoU masks dropped (raise max_masks_per_batch "
                    "or set it to None)")
            for i in np.where(keep)[0]:
                seg = np.unpackbits(packed[i], count=hw).reshape(h, w) \
                    .astype(bool)
                masks_out.append(seg)
                ious_out.append(float(ious[i]))
                stabs_out.append(float(stabs[i]))
                boxes.append(bxs[i].astype(np.float64))
        self.predictor.reset_image()
        if masks_out:
            keep = box_nms(np.stack(boxes), np.array(ious_out),
                           self.box_nms_thresh)
            masks_out = [masks_out[i] for i in keep]
            ious_out = [ious_out[i] for i in keep]
            stabs_out = [stabs_out[i] for i in keep]
        return masks_out, ious_out, stabs_out


def _remove_small_regions(mask: np.ndarray, area_thresh: int) -> np.ndarray:
    """Drop connected components (and fill holes) smaller than area_thresh."""
    import cv2
    mask = mask.astype(np.uint8)
    for mode in ["islands", "holes"]:
        working = mask if mode == "islands" else (1 - mask)
        n, regions, stats, _ = cv2.connectedComponentsWithStats(working, 8)
        small = [i for i in range(1, n)
                 if stats[i, cv2.CC_STAT_AREA] < area_thresh]
        for i in small:
            if mode == "islands":
                mask[regions == i] = 0
            else:
                mask[regions == i] = 1
    return mask.astype(bool)
