"""SamPredictor: encode an image once, predict masks for batched prompts;
the port of nerf_hugs_tpu/hugs/sam/predictor.py.

API parity with segment-anything's SamPredictor as HuGS uses it
(generate_static_mask.py:202, 338-376): set_image() -> repeated
predict_batched() with point prompts, returning logits at the original
image resolution plus IoU predictions, and the two device-side filtered
paths the mask generator and the SfM heuristic use, predict_compact() and
predict_count(). The host preprocessing (cv2 resize, normalise, pad) is
the JAX package's, bit for bit; everything after it runs on the model's
device, and only bit-packed kept masks or a count map come back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerf_hugs_torch.hugs.sam import modeling

_PACK_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.unpackbits MSB-first


def _f32(x: float) -> float:
    """x rounded to float32, as the JAX package passes every threshold."""
    return float(np.float32(x))


class SamPredictor:
    mask_threshold: float = 0.0

    def __init__(self, sam: modeling.Sam):
        self.sam = sam.eval()
        self.config = sam.config
        self.device = next(sam.parameters()).device
        self._embedding: Optional[torch.Tensor] = None
        self.original_size: Optional[Tuple[int, int]] = None
        self.input_size: Optional[Tuple[int, int]] = None

    # -- preprocessing ---------------------------------------------------------

    def _resize_longest(self, image: np.ndarray) -> np.ndarray:
        import cv2
        h, w = image.shape[:2]
        scale = self.config.image_size / max(h, w)
        new_h, new_w = int(round(h * scale)), int(round(w * scale))
        return cv2.resize(image, (new_w, new_h),
                          interpolation=cv2.INTER_LINEAR)

    def apply_coords(self, coords: np.ndarray,
                     original_size: Tuple[int, int]) -> np.ndarray:
        """Original-pixel coords -> resized-input coords."""
        h, w = original_size
        scale = self.config.image_size / max(h, w)
        return coords * scale

    @torch.inference_mode()
    def set_image(self, image: np.ndarray) -> None:
        """image: [H, W, 3] uint8 RGB."""
        self.original_size = tuple(image.shape[:2])
        resized = self._resize_longest(image.astype(np.float32))
        self.input_size = tuple(resized.shape[:2])
        mean = np.array(self.config.pixel_mean)
        std = np.array(self.config.pixel_std)
        x = (resized - mean) / std
        pad_h = self.config.image_size - x.shape[0]
        pad_w = self.config.image_size - x.shape[1]
        x = np.pad(x, ((0, pad_h), (0, pad_w), (0, 0)))
        x = torch.from_numpy(x.astype(np.float32).transpose(2, 0, 1)[None])
        self._embedding = self.sam.encode_image(x.to(self.device))

    def reset_image(self) -> None:
        self._embedding = None

    def _prompts(self, point_coords, point_labels):
        if self._embedding is None:
            raise RuntimeError("call set_image first")
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                         device=self.device)
        return as_t(point_coords), as_t(point_labels)

    # -- prediction ------------------------------------------------------------

    @torch.inference_mode()
    def predict_batched(self, point_coords: np.ndarray,
                        point_labels: np.ndarray,
                        return_logits: bool = True):
        """point_coords: [B, N, 2] in RESIZED input pixels (apply_coords'd);
        labels: [B, N]. Returns (masks [B, 3, H_orig, W_orig], iou [B, 3])."""
        pts, labels = self._prompts(point_coords, point_labels)
        masks, iou = self.sam.predict_masks(self._embedding, pts, labels,
                                            True)
        masks = self._postprocess_masks(masks)
        if not return_logits:
            masks = masks > self.mask_threshold
        return masks.cpu().numpy(), iou.cpu().numpy()

    def _postprocess_masks(self, masks):
        """Low-res logits -> original resolution: upsample to the padded
        input square, strip the pad, resize to the original size. The
        second resize shrinks (a crop smaller than the input square) and
        antialiases, as jax.image.resize does."""
        size = self.config.image_size
        masks = F.interpolate(masks, (size, size), mode="bilinear",
                              align_corners=False)
        masks = masks[..., : self.input_size[0], : self.input_size[1]]
        return F.interpolate(masks, self.original_size, mode="bilinear",
                             align_corners=False, antialias=True)

    # -- device-side filtered prediction ----------------------------------------
    #
    # predict_batched moves [B, 3, H, W] f32 full-res logits to the host per
    # batch. These paths keep decode -> upsample -> IoU/stability filter ->
    # threshold -> box/bit-pack (or count) on the device in one call and
    # move only bit-packed kept masks or a count map to the host. Filtering
    # math is identical to the predict_batched + numpy path
    # (tests/test_torch_port_hugs.py).

    @torch.inference_mode()
    def predict_compact(self, point_coords, point_labels, pred_iou_thresh,
                        stability_score_thresh, stability_score_offset,
                        n_valid: int, max_keep: int):
        """Batched point prompts -> up to `max_keep` filtered masks, decoded,
        upsampled, thresholded, and bit-packed on device.

        Returns (packed [K, ceil(H*W/8)] uint8, ious [K], stabs [K],
        keep [K] bool, boxes [K, 4] int32 xyxy, n_pass int) where K =
        min(max_keep, B*3); rows with keep=False are padding/filtered.
        Masks unpack with np.unpackbits(packed[i], count=H*W). n_pass is
        the pre-compaction pass count — if it exceeds K, the lowest-IoU
        passing masks were dropped (caller should warn)."""
        out = self._decode_compact(
            *self._prompts(point_coords, point_labels), pred_iou_thresh,
            stability_score_thresh, stability_score_offset, n_valid,
            select_best=False, want_masks=True, max_keep=int(max_keep))
        packed, ious, stabs, keep, boxes, n_pass = out
        return (packed.cpu().numpy(), ious.cpu().numpy(),
                stabs.cpu().numpy(), keep.cpu().numpy(),
                boxes.cpu().numpy(), int(n_pass))

    @torch.inference_mode()
    def predict_count(self, point_coords, point_labels, pred_iou_thresh,
                      stability_score_thresh, stability_score_offset,
                      n_valid: int, select_best: bool) -> np.ndarray:
        """Batched point prompts -> [H, W] float32 count of filtered masks
        covering each pixel (the SfM-heuristic accumulation), computed fully
        on device. select_best keeps only the highest-IoU mask per prompt
        (sfm_use_highest_iou)."""
        counts = self._decode_compact(
            *self._prompts(point_coords, point_labels), pred_iou_thresh,
            stability_score_thresh, stability_score_offset, n_valid,
            select_best=bool(select_best), want_masks=False, max_keep=0)
        return counts.cpu().numpy()

    def _decode_compact(self, pts, labels, iou_thresh, stab_thresh,
                        stab_offset, n_valid, *, select_best, want_masks,
                        max_keep):
        """Device body shared by predict_compact/predict_count
        (nerf_hugs_tpu/hugs/sam/predictor.py::_decode_compact)."""
        masks, iou = self.sam.predict_masks(self._embedding, pts, labels,
                                            True)
        b, m = iou.shape
        if select_best:
            # Selection is per-prompt and pixel-independent: doing it at
            # low res before the upsample is exact and 3x cheaper. argmax
            # takes the first of equal scores, as jnp.argmax does.
            best = iou.argmax(-1)
            rows = torch.arange(b, device=iou.device)
            masks = masks[rows, best][:, None]
            iou = iou[rows, best][:, None]
            m = 1
        masks = self._postprocess_masks(masks)
        h, w = self.original_size
        flat = masks.reshape(b * m, h, w)
        iou = iou.reshape(b * m)

        thr = _f32(self.mask_threshold)
        offset = _f32(stab_offset)
        high = (flat > _f32(np.float32(thr) + np.float32(offset))).sum(
            (-1, -2))
        low = (flat > _f32(np.float32(thr) - np.float32(offset))).sum(
            (-1, -2))
        stab = high.float() / low.float().clamp_min(1e-9)
        seg = flat > thr
        nonempty = seg.any(-1).any(-1)
        # Mask out pad prompts.
        keep = torch.arange(b * m, device=iou.device) // m < n_valid
        if _f32(iou_thresh) > 0:
            keep &= iou > _f32(iou_thresh)
        if _f32(stab_thresh) > 0:
            keep &= stab >= _f32(stab_thresh)
        keep &= nonempty
        n_pass = keep.sum()

        if not want_masks:
            return (seg & keep[:, None, None]).sum(0).float()

        # Boxes (xyxy, [x0, y0, x1+1, y1+1]; zeros for empty — mask_to_box);
        # argmax gives the first true row / column.
        ys = seg.any(-1).to(torch.uint8)
        xs = seg.any(-2).to(torch.uint8)
        y0 = ys.argmax(-1)
        y1 = h - ys.flip(-1).argmax(-1)
        x0 = xs.argmax(-1)
        x1 = w - xs.flip(-1).argmax(-1)
        boxes = (torch.stack([x0, y0, x1, y1], -1)
                 * nonempty[:, None]).to(torch.int32)

        # Bit-pack MSB-first so np.unpackbits round-trips.
        hw = h * w
        segf = seg.reshape(b * m, hw).to(torch.uint8)
        pad = (-hw) % 8
        if pad:
            segf = F.pad(segf, (0, pad))
        w8 = torch.tensor(_PACK_WEIGHTS, dtype=torch.uint8,
                          device=segf.device)
        packed = (segf.view(b * m, -1, 8) * w8).sum(
            -1, dtype=torch.int32).to(torch.uint8)

        k = min(int(max_keep), b * m)
        if k < b * m:
            # Keep-rows first (score +2), then highest IoU; re-sort the
            # chosen indices so the surviving masks stay in prompt order.
            # A stable sort takes the lower index first among equal scores
            # (padded prompts tie exactly), as jax.lax.top_k does.
            score = keep.float() * 2.0 + torch.sigmoid(iou)
            idx = torch.sort(score, descending=True, stable=True
                             ).indices[:k].sort().values
            packed, iou, stab = packed[idx], iou[idx], stab[idx]
            keep, boxes = keep[idx], boxes[idx]
        return packed, iou, stab, keep, boxes, n_pass


def build_sam(model_type: str = "vit_h",
              checkpoint_path: Optional[str] = None, device="cpu",
              rng_seed: int = 0, **config_overrides) -> modeling.Sam:
    """Construct SAM on `device`; load official weights when a checkpoint
    is given (hugs/sam/weights.py), with the input size and window its
    tables were made for (1024 and 14 in every official one), otherwise
    seeded random weights from a torch.Generator on that device
    (modeling.init_sam; shape and pipeline testing only)."""
    from nerf_hugs_torch.hugs.sam import weights
    sd = None
    if checkpoint_path is not None:
        sd = weights.load_torch_checkpoint(checkpoint_path)
        config_overrides = {**weights.checkpoint_sizes(
            sd, modeling.make_sam_config(model_type)), **config_overrides}
    config = modeling.make_sam_config(model_type, **config_overrides)
    device = torch.device(device)
    with torch.device(device):
        sam = modeling.Sam(config)
    if sd is not None:
        weights.load_state_dict(sam, sd)
    else:
        modeling.init_sam(sam, torch.Generator(device=device).manual_seed(
            rng_seed))
    return sam.eval()
