"""Image and file IO (host-side numpy; parity: MipNeRF360/internal/utils.py:99-163).

The port's copy of nerf_hugs_tpu/utils/io.py.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
from PIL import Image


def load_img(path: str) -> np.ndarray:
    """Load an image as float32 (raw values; PNG u8 stays in [0, 255])."""
    with open(path, "rb") as f:
        return np.array(Image.open(f), dtype=np.float32)


def save_img_u8(img: np.ndarray, path: str) -> None:
    """Save [0,1] float image as uint8 PNG (NaNs zeroed, values clipped)."""
    arr = (np.clip(np.nan_to_num(img), 0.0, 1.0) * 255.0).astype(np.uint8)
    with open(path, "wb") as f:
        Image.fromarray(arr).save(f, "PNG")


def save_img_f32(img: np.ndarray, path: str) -> None:
    """Save a float map (e.g. depth) as float32 TIFF."""
    with open(path, "wb") as f:
        Image.fromarray(np.nan_to_num(img).astype(np.float32)).save(f, "TIFF")


def load_json(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return json.load(f)


def makedirs(path: str) -> None:
    os.makedirs(path, exist_ok=True)
