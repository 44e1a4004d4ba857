"""Ray/batch containers shared by the data layer and the models.

Plain dataclasses twinning nerf_hugs_tpu/utils/structs.py (flax struct
dataclasses there). Every field shares the leading batch dims. The data
layer fills them with numpy arrays on the host; `.to(device)` turns every
field into a tensor on the device (a Batch's copy is the span `data.copy`
of utils/trace.py).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from nerf_hugs_torch.utils import trace

Array = Union[np.ndarray, torch.Tensor]


def _to_tensor(x: Array, device, pin: bool = False) -> torch.Tensor:
    """Host array -> device tensor; floats become float32 (the host ray
    caster works in float64, the models in float32, as jax does by
    default). With `pin` the host copy goes through pinned memory first,
    so that the copy to the card does not wait for the host."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.is_floating_point():
        x = x.float()
    if pin:
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


class _Fields:
    """Field-wise map shared by the containers."""

    def map(self, fn: Callable[[Any], Any]):
        return type(self)(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})

    def to(self, device, pin: bool = False):
        return self.map(lambda x: _to_tensor(x, device, pin))


@dataclasses.dataclass
class Pixels(_Fields):
    """Pre-ray pixel batch (image-space sampling, cast to Rays on the host)."""
    pix_x_int: Array
    pix_y_int: Array
    lossmult: Array
    static_mask: Array
    near: Array
    far: Array
    embed_idx: Array
    cam_idx: Array


@dataclasses.dataclass
class Rays(_Fields):
    """Flat ray batch."""
    pix_coords: Array     # [..., 2] normalized (x, y) pixel coords
    origins: Array        # [..., 3]
    directions: Array     # [..., 3] unnormalized (carry pixel-area scaling)
    viewdirs: Array       # [..., 3] unit direction
    radii: Array          # [..., 1] base radius of the pixel cone at t=1
    lossmult: Array       # [..., 1]
    static_mask: Array    # [..., 1] HuGS static mask value in [0, 1]
    near: Array           # [..., 1]
    far: Array            # [..., 1]
    embed_idx: Array      # [..., 1] int32 per-image embedding index
    cam_idx: Array        # [..., 1] int32 camera index


@dataclasses.dataclass
class Batch:
    """One training/eval batch: rays plus (optionally) supervision."""
    rays: Rays
    rgb: Optional[Array] = None

    def to(self, device, pin: bool = False) -> "Batch":
        with trace.span("data.copy"):
            return Batch(rays=self.rays.to(device, pin),
                         rgb=None if self.rgb is None
                         else _to_tensor(self.rgb, device, pin))


class DataSplit(enum.Enum):
    TRAIN = "train"
    TEST = "test"
