"""HuGS heuristics: residual masks, SfM point filtering, mask fusion ops.

The port's copy of nerf_hugs_tpu/hugs/heuristics.py (jax-free; the port
imports nothing of the JAX package), held equal to it by
tests/test_torch_port_hugs.py.

Host-side numpy (per-image, O(HW) once each — not worth device round-trips),
matching HuGS/generate_static_mask.py:
  * color-residual masks (mean + quantile thresholds, :268-281)
  * SfM static feature points (track-length filter :293-309, dedup :81-94,
    outlier removal :97-107, KMeans reduction :317-327)
  * mask fusion: fill_gap smooth-union (:110-125), intersect with SAM regions
    (:128-145), erode (:400-407)
  * SAM-region completion: flood-fill unassigned pixels into new regions
    (:236-265)
  * mask stability score (segment_anything.utils.amg.calculate_stability_score)
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


# -- point set utilities -------------------------------------------------------

def delete_same_points(points: np.ndarray,
                       distance_threshold: float = 0.1) -> np.ndarray:
    """Greedy dedup: keep points at least `distance_threshold` from all kept."""
    if len(points) == 0:
        return points
    kept = [points[0]]
    for p in points[1:]:
        if np.min(np.linalg.norm(p - np.stack(kept), axis=-1)) >= \
                distance_threshold:
            kept.append(p)
    return np.stack(kept)


def delete_outlier_points(points: np.ndarray,
                          std_coefficient: float = 3.0) -> np.ndarray:
    """Drop points whose nearest neighbor is beyond mean + k*std of all
    pairwise distances."""
    n = len(points)
    if n < 2:
        return points
    dists = np.linalg.norm(points[:, None] - points[None, :], axis=-1)
    off_diag = dists[~np.eye(n, dtype=bool)].reshape(n, n - 1)
    threshold = off_diag.mean() + std_coefficient * off_diag.std()
    return points[off_diag.min(axis=-1) < threshold]


def kmeans_reduce(points: np.ndarray, n_clusters: int,
                  seed: int = 0) -> np.ndarray:
    """KMeans the points, then snap each center to its nearest input point
    (generate_static_mask.py:317-327). Returns unique selected points."""
    if n_clusters <= 0 or n_clusters >= len(points):
        return points
    from sklearn.cluster import KMeans
    centers = KMeans(n_clusters=n_clusters, n_init="auto",
                     random_state=seed).fit(points).cluster_centers_
    dists = np.linalg.norm(centers[None, :, :] - points[:, None, :], axis=-1)
    selected = np.unique(np.argmin(dists, axis=0))
    return points[selected]


def group_points(anchor_points: np.ndarray, all_points: np.ndarray,
                 points_per_mask: int) -> np.ndarray:
    """Each anchor grabs its `points_per_mask` nearest feature points as one
    prompt group; returns [n_anchors, points_per_mask, 2]."""
    if points_per_mask <= 1:
        return anchor_points[:, None, :]
    dists = np.linalg.norm(
        anchor_points[None, :, :] - all_points[:, None, :], axis=-1)
    selected = np.argsort(dists, axis=0)[:points_per_mask].T
    return all_points[selected]


def filter_sfm_points(xys: np.ndarray, track_lengths: np.ndarray,
                      count_threshold: int, scale_wh: Tuple[float, float],
                      clip_wh: Tuple[float, float]) -> np.ndarray:
    """COLMAP features -> static points: keep matched features whose 3-D
    track spans >= count_threshold images; rescale to render resolution
    (generate_static_mask.py:293-309). track_lengths==0 marks unmatched."""
    if count_threshold == 0:
        keep = np.ones(len(xys), bool)
    else:
        keep = track_lengths >= count_threshold
    pts = xys[keep] * np.array(scale_wh)
    return np.stack([np.clip(pts[:, 0], 0, clip_wh[0]),
                     np.clip(pts[:, 1], 0, clip_wh[1])], -1) \
        if len(pts) else pts.reshape(0, 2)


# -- mask ops ------------------------------------------------------------------

def _box_filter(mask: np.ndarray, kernel_size: int,
                mode: str = "reflect") -> np.ndarray:
    """Mean filter via separable cumulative sums (exact box convolution)."""
    import cv2
    # torch F.pad(mode='reflect') == cv2 BORDER_REFLECT_101 (no edge dup).
    return cv2.blur(mask.astype(np.float32), (kernel_size, kernel_size),
                    borderType={"reflect": cv2.BORDER_REFLECT_101,
                                "same": cv2.BORDER_CONSTANT}[mode])


def fill_gap(mask: np.ndarray, kernel_size: int) -> np.ndarray:
    """Smooth-union: mask OR (box-blurred mask >= threshold); closes small
    holes without shrinking the mask (generate_static_mask.py:110-125)."""
    if kernel_size % 2 == 0:
        kernel_size += 1
    squeeze = mask.ndim == 3
    m = mask[..., 0] if squeeze else mask
    smooth = _box_filter(m, kernel_size, "reflect")
    out = ((smooth + m) >= 0.5).astype(np.float32)
    return out[..., None] if squeeze else out


def smooth_union(mask: np.ndarray, kernel_size: int) -> np.ndarray:
    """Zero-padded variant used on the fused sfm+residual mask (:391-397)."""
    import cv2
    squeeze = mask.ndim == 3
    m = (mask[..., 0] if squeeze else mask).astype(np.float32)
    kernel = np.ones((kernel_size, kernel_size), np.float32) / kernel_size**2
    smooth = cv2.filter2D(m, -1, kernel, borderType=cv2.BORDER_CONSTANT)
    out = ((m + smooth) >= 0.5).astype(np.float32)
    return out[..., None] if squeeze else out


def intersect_masks(coarse_mask: np.ndarray, fine_masks: np.ndarray,
                    intersect_threshold: float) -> np.ndarray:
    """Union of the SAM regions covered >= threshold by the coarse mask
    (generate_static_mask.py:128-145). coarse: [h,w,1]; fine: [n,h,w,1]."""
    denom = np.maximum(fine_masks.sum(axis=(1, 2, 3)), 1e-9)
    coverage = (coarse_mask[None] * fine_masks).sum(axis=(1, 2, 3)) / denom
    selected = coverage >= intersect_threshold
    if not selected.any():
        return np.zeros_like(coarse_mask)
    return (fine_masks[selected].sum(axis=0) >= 0.5).astype(
        coarse_mask.dtype)


def erode_mask(mask: np.ndarray, kernel_size: int) -> np.ndarray:
    """Rectangular erosion (generate_static_mask.py:400-407)."""
    import cv2
    kernel = cv2.getStructuringElement(cv2.MORPH_RECT,
                                       (kernel_size, kernel_size))
    out = cv2.erode(mask.astype(np.float32), kernel)
    return (out.reshape(mask.shape) >= 0.5).astype(np.float32)


def residual_masks(pred: np.ndarray, gt: np.ndarray,
                   quantile_upper: float) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """Color-residual masks: base (<= mean) and upper (<= quantile, unioned
    with base since the mean can exceed the quantile)
    (generate_static_mask.py:268-281)."""
    residual = np.abs(pred - gt).mean(axis=-1, keepdims=True)
    base = (residual <= residual.mean()).astype(np.float32)
    upper = (residual <= np.quantile(residual, quantile_upper)).astype(
        np.float32)
    upper = ((base + upper) >= 0.5).astype(np.float32)
    return residual, base, upper


def complete_sam_regions(seg_masks: List[np.ndarray],
                         height: int, width: int) -> np.ndarray:
    """Assign every pixel to a region: SAM masks (area-descending) first,
    then raster-scan flood-fill of uncovered pixels into connected new
    regions with union-find merging (generate_static_mask.py:236-265).
    Returns [n_regions, h, w, 1] float."""
    index_mask = np.full((height, width), -1, np.int64)
    for index, seg in enumerate(seg_masks):
        index_mask[seg.astype(bool)] = index
    index_end = len(seg_masks)
    next_index = index_end

    # Union-find over provisional region labels.
    parent = {}

    def find(a):
        while parent.get(a, a) != a:
            parent[a] = parent.get(parent[a], parent[a])
            a = parent[a]
        return a

    for i in range(height):
        for j in range(width):
            if index_mask[i, j] != -1:
                continue
            neighbors = set()
            for di, dj in ((-1, 0), (0, -1), (-1, -1)):
                ni, nj = i + di, j + dj
                if ni >= 0 and nj >= 0 and index_mask[ni, nj] >= index_end:
                    neighbors.add(find(int(index_mask[ni, nj])))
            if not neighbors:
                index_mask[i, j] = next_index
                next_index += 1
            else:
                neighbors = sorted(neighbors)
                root = neighbors[0]
                index_mask[i, j] = root
                for other in neighbors[1:]:
                    parent[other] = root
    # Resolve union-find labels.
    if parent:
        flat = index_mask.reshape(-1)
        fill_labels = flat >= index_end
        flat[fill_labels] = np.array([find(int(v))
                                      for v in flat[fill_labels]])
    regions = []
    for label in np.unique(index_mask):
        regions.append((index_mask == label).astype(np.float32)[..., None])
    return np.stack(regions, axis=0)


def calculate_stability_score(mask_logits: np.ndarray, mask_threshold: float,
                              offset: float) -> np.ndarray:
    """IoU between the mask binarized at threshold+offset and threshold-offset
    (segment-anything's stability score). mask_logits: [..., h, w]."""
    high = (mask_logits > mask_threshold + offset).sum(axis=(-1, -2))
    low = (mask_logits > mask_threshold - offset).sum(axis=(-1, -2))
    return high / np.maximum(low, 1e-9)


def fuse_masks(sfm_mask: np.ndarray, residual_base: np.ndarray,
               residual_upper: np.ndarray, sam_regions: np.ndarray,
               smooth_kernel_size: int, erode_kernel_size: int) -> np.ndarray:
    """The HuGS fusion rule (generate_static_mask.py:386-407):
    (sfm OR residual_base) AND residual_upper -> smooth-union -> intersect
    with SAM regions at >= 0.5 coverage -> erode."""
    fused = (((sfm_mask + residual_base) * residual_upper) >= 0.5).astype(
        np.float32)
    if smooth_kernel_size > 0:
        fused = smooth_union(fused, smooth_kernel_size)
    fused = intersect_masks(fused, sam_regions, 0.5)
    if erode_kernel_size > 0:
        fused = erode_mask(fused, erode_kernel_size)
    return fused
